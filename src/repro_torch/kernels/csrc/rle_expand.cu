// rle_expand: out[i] = values[#{ends <= i}] for i < total (RLE decode).
//
// Replaces the TPU kernel ``repro/kernels/rle_expand.py::rle_expand`` (body
// ``_rle_kernel``), which copies the whole run table into every output tile
// and counts run ends with a broadcast compare.  On this card the op is
// memory bound: it reads the run table (values and counts) once and writes
// ``total`` values, so its bound is r * (sizeof(T) + 8) + total * sizeof(T)
// bytes over 3.35 TB/s.  One thread per output element binary-searches the
// inclusive run ends (a ``cumsum`` of the counts, taken by the wrapper as
// the TPU wrapper takes it outside its ``pallas_call``); neighbouring
// threads land in the same or adjacent runs, so the searches share L2 lines
// and the writes coalesce.  Zero-length runs are skipped by the search.
#include "common.cuh"

namespace {

template <typename T>
__global__ void rle_expand_kernel(const T* __restrict__ values,
                                  const int64_t* __restrict__ ends, int64_t r,
                                  T* __restrict__ out, int64_t total) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    int64_t k = repro::upper_bound(ends, r, i);
    if (k > r - 1) k = r - 1;
    out[i] = values[k];
  }
}

template <typename T>
int launch(const void* values, const void* ends, int64_t r, void* out,
           int64_t total, void* stream) {
  rle_expand_kernel<T><<<repro::grid_for(total), repro::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(values), static_cast<const int64_t*>(ends), r,
      static_cast<T*>(out), total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_rle_expand_i32(const void* values, const void* ends,
                                    int64_t r, void* out, int64_t total,
                                    void* stream) {
  return launch<int32_t>(values, ends, r, out, total, stream);
}

extern "C" int repro_rle_expand_i64(const void* values, const void* ends,
                                    int64_t r, void* out, int64_t total,
                                    void* stream) {
  return launch<int64_t>(values, ends, r, out, total, stream);
}
