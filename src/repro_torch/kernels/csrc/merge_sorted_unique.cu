// merge_sorted_unique: merge sorted ``fresh`` into the sorted-unique,
// sentinel-padded ``buf``, drop duplicates, cut to ``cap`` = len(buf).
//
// Replaces the TPU kernel ``repro/kernels/fused.py::merge_sorted_unique``
// (``_merge_impl`` / body ``_merge_kernel``), which sorts ``buf ++ fresh``
// in VMEM, masks adjacent duplicates and sorts again to compact, writing
// over ``buf`` (``input_output_aliases``).  On this card the op is memory
// bound: it must read the ``nb`` occupied slots of ``buf`` (the sentinel
// tail is found by one binary search, never read) and ``fresh`` once, and
// write ``cap`` values, so its bound is (nb + f + cap) * sizeof(T) bytes
// over 3.35 TB/s.  No sort is
// needed because both inputs are already sorted: it is a rank merge in two
// launches with a prefix sum between them (``torch.cumsum`` in the
// wrapper):
//
//   1. ``merge_rank``: one thread per fresh element binary-searches ``buf``;
//      it is kept unless it is a sentinel, repeats its predecessor, or is
//      already in ``buf``.  It records keep (0/1) and its rank in ``buf``.
//   2. ``merge_scatter``: each kept fresh element lands at
//      (kept before it) + (its rank in buf); each buf element at
//      (its index) + (kept fresh below it, by a binary search of ``fresh``
//      and a read of the prefix sum).  Slots from the merged total up to
//      ``cap`` get the sentinel.  The output goes to a second buffer, never
//      over ``buf``: threads read ``buf`` while others write.
//
// ``stats`` receives the uncapped unique total and the number of new
// values, as ``_merge_kernel``'s ``count`` and ``n_new``.
#include "common.cuh"

namespace {

template <typename T>
__global__ void merge_rank_kernel(const T* __restrict__ buf, int64_t cap,
                                  const T* __restrict__ fresh, int64_t nf,
                                  int32_t* __restrict__ keep,
                                  int64_t* __restrict__ rank) {
  constexpr T kBig = repro::Sentinel<T>::value;
  __shared__ int64_t s_nb;
  if (threadIdx.x == 0) s_nb = repro::lower_bound(buf, cap, kBig);
  __syncthreads();
  const int64_t nb = s_nb;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < nf; j += stride) {
    const T f = fresh[j];
    int64_t p = 0;
    int32_t k = 0;
    if (f != kBig && (j == 0 || fresh[j - 1] != f)) {
      p = repro::lower_bound(buf, nb, f);
      k = (p < nb && buf[p] == f) ? 0 : 1;
    }
    keep[j] = k;
    rank[j] = p;
  }
}

template <typename T>
__global__ void merge_scatter_kernel(const T* __restrict__ buf, int64_t cap,
                                     const T* __restrict__ fresh, int64_t nf,
                                     const int32_t* __restrict__ keep,
                                     const int64_t* __restrict__ rank,
                                     const int64_t* __restrict__ kcum,
                                     T* __restrict__ out,
                                     int64_t* __restrict__ stats) {
  constexpr T kBig = repro::Sentinel<T>::value;
  __shared__ int64_t s_nb;
  if (threadIdx.x == 0) s_nb = repro::lower_bound(buf, cap, kBig);
  __syncthreads();
  const int64_t nb = s_nb;
  const int64_t n_new = nf > 0 ? kcum[nf - 1] : 0;
  const int64_t total = nb + n_new;
  const int64_t work = cap > nf ? cap : nf;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < work; t += stride) {
    if (t < nb) {
      const T v = buf[t];
      const int64_t p = repro::lower_bound(fresh, nf, v);
      const int64_t d = t + (p > 0 ? kcum[p - 1] : 0);
      if (d < cap) out[d] = v;
    }
    if (t < nf && keep[t]) {
      const int64_t d = (kcum[t] - 1) + rank[t];
      if (d < cap) out[d] = fresh[t];
    }
    if (t < cap && t >= total) out[t] = kBig;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    stats[0] = total;
    stats[1] = n_new;
  }
}

template <typename T>
int launch_rank(const void* buf, int64_t cap, const void* fresh, int64_t nf,
                void* keep, void* rank, void* stream) {
  merge_rank_kernel<T><<<repro::grid_for(nf), repro::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(buf), cap, static_cast<const T*>(fresh), nf,
      static_cast<int32_t*>(keep), static_cast<int64_t*>(rank));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_scatter(const void* buf, int64_t cap, const void* fresh, int64_t nf,
                   const void* keep, const void* rank, const void* kcum,
                   void* out, void* stats, void* stream) {
  const int64_t work = cap > nf ? cap : nf;
  merge_scatter_kernel<T><<<repro::grid_for(work), repro::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(buf), cap, static_cast<const T*>(fresh), nf,
      static_cast<const int32_t*>(keep), static_cast<const int64_t*>(rank),
      static_cast<const int64_t*>(kcum), static_cast<T*>(out),
      static_cast<int64_t*>(stats));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_merge_rank_i32(const void* buf, int64_t cap,
                                    const void* fresh, int64_t nf, void* keep,
                                    void* rank, void* stream) {
  return launch_rank<int32_t>(buf, cap, fresh, nf, keep, rank, stream);
}

extern "C" int repro_merge_rank_i64(const void* buf, int64_t cap,
                                    const void* fresh, int64_t nf, void* keep,
                                    void* rank, void* stream) {
  return launch_rank<int64_t>(buf, cap, fresh, nf, keep, rank, stream);
}

extern "C" int repro_merge_scatter_i32(const void* buf, int64_t cap,
                                       const void* fresh, int64_t nf,
                                       const void* keep, const void* rank,
                                       const void* kcum, void* out, void* stats,
                                       void* stream) {
  return launch_scatter<int32_t>(buf, cap, fresh, nf, keep, rank, kcum, out,
                                 stats, stream);
}

extern "C" int repro_merge_scatter_i64(const void* buf, int64_t cap,
                                       const void* fresh, int64_t nf,
                                       const void* keep, const void* rank,
                                       const void* kcum, void* out, void* stats,
                                       void* stream) {
  return launch_scatter<int64_t>(buf, cap, fresh, nf, keep, rank, kcum, out,
                                 stats, stream);
}
