// sorted_member: out[i] = a[i] in b_sorted.
//
// Replaces the TPU kernel ``repro/kernels/sorted_member.py::sorted_member``
// (body ``_member_kernel``), which compares tiles of ``a`` against blocks of
// ``b`` with a min/max block prune.  Its bytes bound on this card is
// (n + m) * sizeof(T) + n bytes over 3.35 TB/s, but probes arrive in any
// order, so a search per probe is bound by the 32-byte sectors its
// dependent loads fetch from L2, not by bytes: the first design (one thread
// per probe, binary search over ``b``) fetched one per level below the
// levels that stay in L1, and tied ``torch.searchsorted``.
//
// This design finds a probe's place in ``b`` by arithmetic, not by search.
// The span [b[0], b[m - 1]] is cut into T = 2^tbits equal buckets,
// bucket(x) = (x - b[0]) >> s, with T about m / 4 (the wrapper's choice,
// never more than n, so building the table costs no more than the probes).
// Two launches (one, ``empty_b``, when ``b`` is empty):
//
//   1. ``bucket_table``: one thread per key writes where its bucket starts
//      in ``b`` (and the starts of the empty buckets just before it): a
//      coalesced pass over ``b`` with no search.
//   2. ``bucket_probe``: each thread takes four consecutive probes (one 16-
//      or 32-byte load of ``a``, one 4-byte store of ``out``) and handles
//      them interleaved, so their loads overlap: the bucket's two starts
//      (one sector), then the bucket's keys, halved while more than 32
//      bytes remain and then read with aligned 16-byte loads and compared.
//      With keys spread evenly a probe fetches two or three sectors in two
//      dependent steps however long ``b`` is; a bucket that skewed keys
//      fill is halved as a binary search would, never worse.
//
// No special case for the sentinel: padding in ``b`` is its last bucket,
// and a padded probe finds it there or nowhere.  Duplicates in ``b`` fall
// in one bucket.
#include "buckets.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = repro::kThreads;
constexpr int kProbes = 4;  // consecutive probes per thread

// start[t] = #{k : bucket(b[k]) < t} for every bucket t that holds a key
// and for the bucket after it; thread k writes the entries from the bucket
// after b[k - 1]'s to b[k]'s (k = m: up to 2^tbits), at most kGapWrites
// of them and always the last.  The entries it skips belong to empty
// buckets inside a long gap between two keys and hold whatever the memory
// held: a probe there clamps them into b and searches a range that cannot
// hold its key (its bucket holds none), so it finds nothing, as it must.
constexpr int64_t kGapWrites = 64;

template <typename T>
__global__ void bucket_table_kernel(const T* __restrict__ b, int64_t m,
                                    int tbits, int32_t* __restrict__ start) {
  const repro::Buckets<T> bk(b, m, tbits);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       k <= m; k += stride) {
    const int64_t p = k ? bk.of(b[k - 1]) : -1;
    const int64_t q = k < m ? bk.of(b[k]) : int64_t{1} << tbits;
    const int64_t last = min(q, p + kGapWrites);
    for (int64_t t = p + 1; t <= last; ++t) start[t] = static_cast<int32_t>(k);
    if (q > last) start[q] = static_cast<int32_t>(k);
  }
}

// Any of b[lo, hi) equal to x, for hi - lo <= 32 bytes of keys: three
// aligned 16-byte loads cover any such range.  Bytes of the aligned chunks
// outside ``b`` lie in the same 16-byte chunks as its first and last keys.
template <typename T>
__device__ __forceinline__ bool scan_range(const T* __restrict__ b,
                                           int64_t lo, int64_t hi, T x) {
  constexpr int kVec = 16 / sizeof(T);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(b);
  const int4* base = reinterpret_cast<const int4*>(addr & ~uintptr_t{15});
  const int64_t shift = static_cast<int64_t>(addr & 15) / sizeof(T);
  const int64_t c0 = (lo + shift) / kVec;
  bool hit = false;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int64_t first = (c0 + c) * kVec - shift;  // index of lane 0
    if (first < hi) {
      const int4 chunk = __ldg(base + c0 + c);
      const T* v = reinterpret_cast<const T*>(&chunk);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int64_t k = first + e;
        hit |= k >= lo && k < hi && v[e] == x;
      }
    }
  }
  return hit;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bucket_probe_kernel(const T* __restrict__ a, int64_t n,
                    const T* __restrict__ b, int64_t m, int tbits,
                    const int32_t* __restrict__ start, bool a_aligned,
                    uint8_t* __restrict__ out) {
  constexpr T kBig = repro::Sentinel<T>::value;
  constexpr int64_t kScan = 32 / sizeof(T);  // keys left for the scan
  const repro::Buckets<T> bk(b, m, tbits);
  const int64_t groups = (n + kProbes - 1) / kProbes;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       q < groups; q += stride) {
    const int64_t i0 = q * kProbes;
    const bool full = i0 + kProbes <= n;
    __align__(16) T x[kProbes];
    if (full && a_aligned) {
      constexpr int kLoads = kProbes * sizeof(T) / 16;
#pragma unroll
      for (int l = 0; l < kLoads; ++l) {
        reinterpret_cast<int4*>(x)[l] =
            __ldg(reinterpret_cast<const int4*>(a + i0) + l);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kProbes; ++j) x[j] = i0 + j < n ? a[i0 + j] : kBig;
    }
    // the bucket's keys: b[lo, hi) (empty when x lies outside b's span)
    int64_t lo[kProbes], hi[kProbes];
#pragma unroll
    for (int j = 0; j < kProbes; ++j) {
      const bool inside = x[j] >= bk.lo && x[j] <= bk.hi;
      const int64_t t = inside ? bk.of(x[j]) : 0;
      // a bucket a gap skipped holds stale starts: clamp them into b
      lo[j] = inside ? min(max(int64_t{start[t]}, int64_t{0}), m) : 0;
      hi[j] = inside ? min(max(int64_t{start[t + 1]}, lo[j]), m) : 0;
    }
    bool narrowing = true;
    while (narrowing) {
      T y[kProbes];
      int64_t mid[kProbes];
#pragma unroll
      for (int j = 0; j < kProbes; ++j) {
        mid[j] = lo[j] + ((hi[j] - lo[j]) >> 1);
        if (hi[j] - lo[j] > kScan) y[j] = b[mid[j]];
      }
      narrowing = false;
#pragma unroll
      for (int j = 0; j < kProbes; ++j) {
        if (hi[j] - lo[j] > kScan) {
          if (y[j] < x[j]) {
            lo[j] = mid[j] + 1;
          } else {
            hi[j] = mid[j] + 1;  // the first x, if any, is at or before mid
          }
          narrowing |= hi[j] - lo[j] > kScan;
        }
      }
    }
    uint32_t bits = 0;
#pragma unroll
    for (int j = 0; j < kProbes; ++j) {
      const bool in = hi[j] > lo[j] && scan_range(b, lo[j], hi[j], x[j]);
      bits |= static_cast<uint32_t>(in) << (8 * j);
    }
    if (full) {
      *reinterpret_cast<uint32_t*>(out + i0) = bits;
    } else {
      for (int j = 0; i0 + j < n; ++j) out[i0 + j] = (bits >> (8 * j)) & 1;
    }
  }
}

// An empty ``b``: nothing is a member.
__global__ void empty_b_kernel(uint8_t* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = 0;
  }
}

template <typename T>
int launch(const void* a_, int64_t n, const void* b_, int64_t m, void* out,
           void* start_, int64_t tbits, void* stream_) {
  const auto* a = static_cast<const T*>(a_);
  const auto* b = static_cast<const T*>(b_);
  auto* start = static_cast<int32_t*>(start_);
  auto stream = static_cast<cudaStream_t>(stream_);
  if (m == 0) {
    empty_b_kernel<<<repro::grid_for(n), kThreads, 0, stream>>>(
        static_cast<uint8_t*>(out), n);
    return static_cast<int>(cudaGetLastError());
  }
  if (m >= (int64_t{1} << 31) || tbits < 0 || tbits > 30) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bits = static_cast<int>(tbits);
  bucket_table_kernel<T><<<repro::grid_for(m + 1), kThreads, 0, stream>>>(
      b, m, bits, start);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int64_t groups = (n + kProbes - 1) / kProbes;
  bucket_probe_kernel<T><<<repro::grid_for(groups), kThreads, 0, stream>>>(
      a, n, b, m, bits, start, (reinterpret_cast<uintptr_t>(a) & 15) == 0,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ``start`` holds 2^tbits + 1 int32 bucket starts (m < 2^31; unused at
// m = 0).
extern "C" int repro_sorted_member_i32(const void* a, int64_t n, const void* b,
                                       int64_t m, void* out, void* start,
                                       int64_t tbits, void* stream) {
  return launch<int32_t>(a, n, b, m, out, start, tbits, stream);
}

extern "C" int repro_sorted_member_i64(const void* a, int64_t n, const void* b,
                                       int64_t m, void* out, void* start,
                                       int64_t tbits, void* stream) {
  return launch<int64_t>(a, n, b, m, out, start, tbits, stream);
}
