// sorted_member: out[i] = a[i] in b_sorted.
//
// Replaces the TPU kernel ``repro/kernels/sorted_member.py::sorted_member``
// (body ``_member_kernel``), which compares tiles of ``a`` against blocks of
// ``b`` with a min/max block prune.  On this card the op is memory bound:
// it must read ``a`` and ``b`` once and write one byte per element of ``a``,
// so its bound is (n + m) * sizeof(T) + n bytes over 3.35 TB/s.  The design
// gives each element of ``a`` one thread that binary-searches ``b``: no
// shared memory, no block ordering, coalesced reads of ``a`` and writes of
// ``out``; the upper levels of every search hit the same few lines of ``b``,
// which stay in L2.
#include "common.cuh"

namespace {

template <typename T>
__global__ void sorted_member_kernel(const T* __restrict__ a, int64_t n,
                                     const T* __restrict__ b, int64_t m,
                                     uint8_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const T x = a[i];
    const int64_t k = repro::lower_bound(b, m, x);
    out[i] = (k < m && b[k] == x) ? 1 : 0;
  }
}

template <typename T>
int launch(const void* a, int64_t n, const void* b, int64_t m, void* out,
           void* stream) {
  sorted_member_kernel<T><<<repro::grid_for(n), repro::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), n, static_cast<const T*>(b), m,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_sorted_member_i32(const void* a, int64_t n, const void* b,
                                       int64_t m, void* out, void* stream) {
  return launch<int32_t>(a, n, b, m, out, stream);
}

extern "C" int repro_sorted_member_i64(const void* a, int64_t n, const void* b,
                                       int64_t m, void* out, void* stream) {
  return launch<int64_t>(a, n, b, m, out, stream);
}
