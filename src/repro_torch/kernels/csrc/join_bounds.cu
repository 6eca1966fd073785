// join_bounds: lo[i] = #{r < l[i]}, hi[i] = #{r <= l[i]} over sorted r.
//
// Replaces the TPU kernel ``repro/kernels/join_bounds.py::join_bounds``
// (body ``_bounds_kernel``), which accumulates the two counts blockwise over
// ``r`` with a three-way block prune.  On this card the op is memory bound:
// it reads ``l`` and ``r`` once and writes two int32 spans per left key, so
// its bound is (n + m) * sizeof(T) + 8 * n bytes over 3.35 TB/s.  One thread
// per left key binary-searches the lower bound; the upper bound gallops
// forward from it, so it costs O(log span) reads next to the lower bound's
// line instead of a second search whose probes no two threads share.  The
// spans come out as int32, as on the TPU (the wrapper rejects a right side
// of 2^31 rows or more).
#include "common.cuh"

namespace {

template <typename T>
__global__ void join_bounds_kernel(const T* __restrict__ l, int64_t n,
                                   const T* __restrict__ r, int64_t m,
                                   int32_t* __restrict__ lo,
                                   int32_t* __restrict__ hi) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const T x = l[i];
    const int64_t a = repro::lower_bound(r, m, x);
    const int64_t b = repro::upper_bound_from(r, a, m, x);
    lo[i] = static_cast<int32_t>(a);
    hi[i] = static_cast<int32_t>(b);
  }
}

template <typename T>
int launch(const void* l, int64_t n, const void* r, int64_t m, void* lo,
           void* hi, void* stream) {
  join_bounds_kernel<T><<<repro::grid_for(n), repro::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(l), n, static_cast<const T*>(r), m,
      static_cast<int32_t*>(lo), static_cast<int32_t*>(hi));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_join_bounds_i32(const void* l, int64_t n, const void* r,
                                     int64_t m, void* lo, void* hi,
                                     void* stream) {
  return launch<int32_t>(l, n, r, m, lo, hi, stream);
}

extern "C" int repro_join_bounds_i64(const void* l, int64_t n, const void* r,
                                     int64_t m, void* lo, void* hi,
                                     void* stream) {
  return launch<int64_t>(l, n, r, m, lo, hi, stream);
}
