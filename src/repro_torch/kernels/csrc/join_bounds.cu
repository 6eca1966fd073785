// join_bounds: lo[i] = #{r < l[i]}, hi[i] = #{r <= l[i]} over sorted r.
//
// Replaces the TPU kernel ``repro/kernels/join_bounds.py::join_bounds``
// (body ``_bounds_kernel``), which accumulates the two counts blockwise over
// ``r`` with a three-way block prune.  Its bytes bound on this card is
// (n + m) * sizeof(T) + 8 * n bytes over 3.35 TB/s, but left keys arrive in
// any order, so a search per key is bound by the 32-byte sectors its
// dependent loads fetch from L2: the first design (one thread per key, a
// binary search over all of ``r`` and a gallop to the upper bound) fetched
// one per level, 22 levels at m = 4 M, even for a key outside ``r``'s span.
//
// Three paths, chosen by the wrapper.  Many left keys (the bucket path):
// the keys are placed by arithmetic (``buckets.cuh``).  The span
// [r[0], r[m - 1]] is cut into T = 2^tbits buckets (about m / 4 keys
// each, never more buckets than left keys).  All keys equal to x lie in
// bucket(x), so one bucket's range [start[b], start[b + 1]) gives both
// bounds.  Two launches:
//
//   1. ``join_bounds_table``: start[t] = #{k : bucket(r[k]) < t} for every
//      entry, exactly, those of empty buckets inside a long gap too (a key
//      that falls there needs its exact position, not only the fact that
//      its bucket holds nothing).  Each block reads 4,096 keys of ``r``
//      once, coalesced, into shared memory as buckets; key k writes the
//      entries from its predecessor's bucket to its own (its warp or its
//      block together where that gap is long, with 16-byte stores); the
//      entries past the last key's bucket are shared out over the grid.
//      No search.
//   2. ``join_bounds_probe``: each thread takes four consecutive left keys
//      (one 16- or 32-byte load of ``l``, one 16-byte store each of ``lo``
//      and ``hi``) and handles them interleaved.  A key outside the span
//      reads no table entry and no key: its answer follows from the span's
//      ends.  Otherwise it reads its bucket's two starts (one sector); a
//      range of at most 64 bytes of keys is counted with aligned 16-byte
//      loads, once for both bounds.  A longer range reads its two ends
//      first (a bucket that holds only x, as a run of duplicates does, is
//      answered there), then halves two searches, one per bound, together.
//
// Two search paths, one launch each and no table, for fewer left keys,
// where a table pass over all of ``r`` costs more than it saves (the
// wrapper picks by the number of left keys, at limits timed on the card):
//
//   * a thread per key (``join_bounds_thread``, the first design): a
//     binary search, then a gallop to the upper bound; at up to 2^18 keys
//     their dependent loads overlap well enough across the grid;
//   * a warp per key (``join_bounds_warp``), for few keys, whose threads
//     alone would leave the card idle along each chain of some 40
//     dependent loads (22 levels and the gallop at m = 4 M), each a miss
//     when ``r`` is cold: the warp's two halves search the two bounds 16
//     ways at once, 6 steps at m = 4 M.
//
// Sentinel padding at the end of ``r`` (the distributed engine pads its
// sorted keys with it) would stretch the span to the key type's max and
// put every real key in one bucket, so the span ends at the last key below
// it; a key above the span counts the padding only if it is the sentinel.
// The spans come out as int32, as on the TPU (the wrapper rejects a right
// side of 2^31 rows or more, so every position fits an int32).
#include "buckets.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = repro::kThreads;
constexpr int kProbes = 4;         // consecutive left keys per thread
static_assert(kProbes * sizeof(int32_t) == 16, "one 16-byte store each of lo and hi");
constexpr int kScanBytes = 64;     // key bytes counted without a search
constexpr int kScanChunks = 5;     // aligned 16-byte chunks covering them
constexpr int kTableKeys = 4096;   // keys of ``r`` per table block
// a gap of table entries between two keys is filled by its key's thread
// up to kShortGap entries, by its warp up to kWarpGap, else by the block
// (up to kLongGaps such gaps per kTableKeys keys; any more by the warp)
constexpr int kShortGap = 4, kWarpGap = 1024, kLongGaps = 32;
// ``tbits`` values that choose a search path instead of the bucket table
constexpr int64_t kWarpSearch = -1, kThreadSearch = -2;

// start[a .. b] = v by ``size`` threads of rank ``rank`` (``start`` is
// 16-byte aligned): 16-byte stores between a scalar head and tail.
__device__ __forceinline__ void fill_entries(int32_t* __restrict__ start,
                                             int64_t a, int64_t b, int32_t v,
                                             int rank, int size) {
  const int64_t a4 = min((a + 3) & ~int64_t{3}, b + 1);  // first aligned entry
  const int64_t b4 = max(a4, (b + 1) & ~int64_t{3});     // end of the aligned run
  const int4 v4 = make_int4(v, v, v, v);
  for (int64_t t = a + rank; t < a4; t += size) start[t] = v;
  for (int64_t t = a4 + 4 * int64_t{rank}; t < b4; t += 4 * int64_t{size}) {
    *reinterpret_cast<int4*>(start + t) = v4;
  }
  for (int64_t t = b4 + rank; t <= b; t += size) start[t] = v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
join_bounds_table_kernel(const T* __restrict__ r, int64_t m, int tbits,
                         int32_t* __restrict__ start) {
  constexpr T kBig = repro::Sentinel<T>::value;
  __shared__ int64_t span_keys;
  __shared__ int32_t bucket[kTableKeys + 1];
  __shared__ int4 long_gaps[kLongGaps];  // (p, q, k, unused)
  __shared__ int n_long;
  const int lane = threadIdx.x & 31;
  const int64_t nt = int64_t{1} << tbits;
  // the span's keys: those below the sentinel padding, if any
  int64_t ms = m;
  if (r[m - 1] == kBig) {
    if (threadIdx.x < 32) {
      const int64_t s = repro::warp_search(0, m, [&](int64_t k) { return r[k] < kBig; });
      if (threadIdx.x == 0) span_keys = s;
    }
    __syncthreads();
    ms = span_keys;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) start[nt + 1] = static_cast<int32_t>(ms);
  if (ms == 0) return;  // nothing but padding: the probes need no table
  const repro::Buckets<T> bk(r, ms, tbits);
  // past the last key's bucket every key counts: the whole grid fills it
  const int64_t top = bk.of(bk.hi);
  const int64_t share = (nt - top + gridDim.x - 1) / gridDim.x;
  const int64_t from = top + 1 + blockIdx.x * share;
  fill_entries(start, from, min(from + share - 1, nt), static_cast<int32_t>(ms),
               threadIdx.x, kThreads);
  if (threadIdx.x == 0) n_long = 0;
  // key k sets the entries (bucket(r[k - 1]), bucket(r[k])]; a block
  // reads its kTableKeys keys (and the one before) once, coalesced
  for (int64_t k0 = static_cast<int64_t>(blockIdx.x) * kTableKeys; k0 < ms;
       k0 += static_cast<int64_t>(gridDim.x) * kTableKeys) {
    const int count = static_cast<int>(min(int64_t{kTableKeys}, ms - k0));
    // all of a thread's loads first, so that they overlap
    T key[kTableKeys / kThreads + 1];
#pragma unroll
    for (int i = 0; i <= kTableKeys / kThreads; ++i) {
      const int j = threadIdx.x + i * kThreads;
      if (j <= count && k0 + j) key[i] = r[k0 + j - 1];
    }
#pragma unroll
    for (int i = 0; i <= kTableKeys / kThreads; ++i) {
      const int j = threadIdx.x + i * kThreads;
      if (j <= count) bucket[j] = k0 + j ? static_cast<int32_t>(bk.of(key[i])) : -1;
    }
    __syncthreads();
    for (int base = 0; base < count; base += kThreads) {
      const int j = base + threadIdx.x;
      const int p = j < count ? bucket[j] : 0;
      const int q = j < count ? bucket[j + 1] : 0;
      const int32_t k = static_cast<int32_t>(k0 + j);
      bool by_warp = q - p > kShortGap;
      if (!by_warp) {
        for (int t = p + 1; t <= q; ++t) start[t] = k;
      } else if (q - p > kWarpGap) {  // the block fills it below, if there is room
        const int slot = atomicAdd(&n_long, 1);
        if (slot < kLongGaps) {
          long_gaps[slot] = make_int4(p, q, k, 0);
          by_warp = false;
        }
      }
      unsigned gaps = __ballot_sync(0xffffffffu, by_warp);
      while (gaps) {
        const int src = __ffs(gaps) - 1;
        gaps &= gaps - 1;
        fill_entries(start, __shfl_sync(0xffffffffu, p, src) + 1,
                     __shfl_sync(0xffffffffu, q, src), __shfl_sync(0xffffffffu, k, src),
                     lane, 32);
      }
    }
    __syncthreads();
    const int listed = min(n_long, kLongGaps);
    for (int g = 0; g < listed; ++g) {
      const int4 gap = long_gaps[g];
      fill_entries(start, gap.x + 1, gap.y, gap.z, threadIdx.x, kThreads);
    }
    __syncthreads();  // ``bucket`` and the list are free for the next keys
    if (threadIdx.x == 0) n_long = 0;
  }
}

// #{k in [lo, hi) : r[k] < x} and #{... : r[k] <= x}, for a range of at
// most kScanBytes of keys: aligned 16-byte loads, each chunk read holding
// at least one key of the range (bytes outside ``r`` lie in the same
// 16-byte chunks as its first and last keys).
template <typename T>
__device__ __forceinline__ void count_range(const T* __restrict__ r, int lo,
                                            int hi, T x, int& less, int& leq) {
  constexpr int kVec = 16 / sizeof(T);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(r);
  const int4* base = reinterpret_cast<const int4*>(addr & ~uintptr_t{15});
  const int shift = static_cast<int>(addr & 15) / sizeof(T);
  const int64_t c0 = (int64_t{lo} + shift) / kVec;
  int lt = 0, le = 0;
#pragma unroll
  for (int c = 0; c < kScanChunks; ++c) {
    const int64_t first = (c0 + c) * kVec - shift;  // index of lane 0
    if (first < hi) {
      const int4 chunk = __ldg(base + c0 + c);
      const T* v = reinterpret_cast<const T*>(&chunk);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int64_t k = first + e;
        const bool in = k >= lo && k < hi;
        lt += in && v[e] < x;
        le += in && v[e] <= x;
      }
    }
  }
  less = lt;
  leq = le;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
join_bounds_probe_kernel(const T* __restrict__ l, int64_t n,
                         const T* __restrict__ r, int64_t m, int tbits,
                         const int32_t* __restrict__ start,
                         int32_t* __restrict__ lo_out,
                         int32_t* __restrict__ hi_out) {
  constexpr int kScan = kScanBytes / sizeof(T);
  constexpr T kBig = repro::Sentinel<T>::value;
  // the span's keys, below the sentinel padding (the table pass counted
  // them when there is padding); a key above them counts all of them, and
  // the padding too when it is the sentinel
  const int ms = r[m - 1] == kBig ? start[(int64_t{1} << tbits) + 1] : static_cast<int>(m);
  const repro::Buckets<T> bk(r, ms ? ms : 1, tbits);
  const bool l_vec = (reinterpret_cast<uintptr_t>(l) & 15) == 0;
  const bool out_vec =
      ((reinterpret_cast<uintptr_t>(lo_out) | reinterpret_cast<uintptr_t>(hi_out)) & 15) == 0;
  const int padding = static_cast<int>(m) - ms;
  const int64_t groups = (n + kProbes - 1) / kProbes;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       q < groups; q += stride) {
    const int64_t i0 = q * kProbes;
    const bool full = i0 + kProbes <= n;
    __align__(16) T x[kProbes];
    if (full && l_vec) {
      constexpr int kLoads = kProbes * sizeof(T) / 16;
#pragma unroll
      for (int v = 0; v < kLoads; ++v) {
        reinterpret_cast<int4*>(x)[v] =
            __ldg(reinterpret_cast<const int4*>(l + i0) + v);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kProbes; ++j) x[j] = i0 + j < n ? l[i0 + j] : bk.lo;
    }
    // two searches per key: the lower bound lies in [la, lb], the upper
    // in [ha, hb]; keys before the range's start pass the bound's test
    // (< x, <= x), keys from its end on fail it
    int la[kProbes], lb[kProbes], ha[kProbes], hb[kProbes];
#pragma unroll
    for (int j = 0; j < kProbes; ++j) {
      if (ms && x[j] < bk.lo) {
        la[j] = lb[j] = ha[j] = hb[j] = 0;
      } else if (!ms || x[j] > bk.hi) {
        la[j] = lb[j] = ms;
        ha[j] = hb[j] = ms + (x[j] == kBig ? padding : 0);
      } else {
        const int64_t t = bk.of(x[j]);
        la[j] = ha[j] = start[t];
        lb[j] = hb[j] = start[t + 1];
      }
    }
    // a long bucket: its two ends first
    T y0[kProbes], y1[kProbes];
#pragma unroll
    for (int j = 0; j < kProbes; ++j) {
      if (lb[j] - la[j] > kScan) {
        y0[j] = r[la[j]];
        y1[j] = r[lb[j] - 1];
      }
    }
#pragma unroll
    for (int j = 0; j < kProbes; ++j) {
      if (lb[j] - la[j] > kScan) {
        const int a = la[j], b = lb[j];
        if (y0[j] >= x[j]) {
          la[j] = lb[j] = a;
        } else if (y1[j] < x[j]) {
          la[j] = lb[j] = b;
        } else {  // r[a] < x <= r[b - 1]
          la[j] = a + 1;
          lb[j] = b - 1;
        }
        if (y0[j] > x[j]) {
          ha[j] = hb[j] = a;
        } else if (y1[j] <= x[j]) {
          ha[j] = hb[j] = b;
        } else {  // r[a] <= x < r[b - 1]
          ha[j] = a + 1;
          hb[j] = b - 1;
        }
      }
    }
    bool narrowing = true;
    while (narrowing) {
      T yl[kProbes], yh[kProbes];
      int ml[kProbes], mh[kProbes];
#pragma unroll
      for (int j = 0; j < kProbes; ++j) {
        ml[j] = la[j] + ((lb[j] - la[j]) >> 1);
        mh[j] = ha[j] + ((hb[j] - ha[j]) >> 1);
        if (lb[j] - la[j] > kScan) yl[j] = r[ml[j]];
        if (hb[j] - ha[j] > kScan) yh[j] = r[mh[j]];
      }
      narrowing = false;
#pragma unroll
      for (int j = 0; j < kProbes; ++j) {
        if (lb[j] - la[j] > kScan) {
          if (yl[j] < x[j]) {
            la[j] = ml[j] + 1;
          } else {
            lb[j] = ml[j];
          }
          narrowing |= lb[j] - la[j] > kScan;
        }
        if (hb[j] - ha[j] > kScan) {
          if (yh[j] <= x[j]) {
            ha[j] = mh[j] + 1;
          } else {
            hb[j] = mh[j];
          }
          narrowing |= hb[j] - ha[j] > kScan;
        }
      }
    }
    __align__(16) int32_t lo[kProbes], hi[kProbes];
#pragma unroll
    for (int j = 0; j < kProbes; ++j) {
      int less = 0, leq = 0;
      const bool same = la[j] == ha[j] && lb[j] == hb[j];
      if (lb[j] > la[j]) count_range(r, la[j], lb[j], x[j], less, leq);
      lo[j] = la[j] + less;
      if (!same) {
        leq = 0;
        if (hb[j] > ha[j]) count_range(r, ha[j], hb[j], x[j], less, leq);
      }
      hi[j] = ha[j] + leq;
    }
    if (full && out_vec) {
      *reinterpret_cast<int4*>(lo_out + i0) = *reinterpret_cast<const int4*>(lo);
      *reinterpret_cast<int4*>(hi_out + i0) = *reinterpret_cast<const int4*>(hi);
    } else {
      for (int j = 0; j < kProbes && i0 + j < n; ++j) {
        lo_out[i0 + j] = lo[j];
        hi_out[i0 + j] = hi[j];
      }
    }
  }
}

// One thread per left key: a binary search for the lower bound, then a
// gallop forward from it to the upper bound.
template <typename T>
__global__ void __launch_bounds__(kThreads)
join_bounds_thread_kernel(const T* __restrict__ l, int64_t n,
                          const T* __restrict__ r, int64_t m,
                          int32_t* __restrict__ lo_out,
                          int32_t* __restrict__ hi_out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const T x = l[i];
    const int64_t a = repro::lower_bound(r, m, x);
    lo_out[i] = static_cast<int32_t>(a);
    hi_out[i] = static_cast<int32_t>(repro::upper_bound_from(r, a, m, x));
  }
}

// One warp per left key: lanes 0-15 search the lower bound, lanes 16-31
// the upper, each half testing 16 evenly spaced keys of its range a step.
template <typename T>
__global__ void __launch_bounds__(kThreads)
join_bounds_warp_kernel(const T* __restrict__ l, int64_t n,
                          const T* __restrict__ r, int64_t m,
                          int32_t* __restrict__ lo_out,
                          int32_t* __restrict__ hi_out) {
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4, sub = lane & 15;
  const T first = r[0], last = r[m - 1];
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  for (int64_t i = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / 32;
       i < n; i += warps) {
    const T x = l[i];
    // the answer lies in [lo, hi]; positions before lo pass the test
    // (half 0: r[k] < x, half 1: r[k] <= x), hi on fails it
    int64_t lo = x > last ? m : 0;
    int64_t hi = x < first ? 0 : m;
    while (__any_sync(0xffffffffu, lo < hi)) {
      const int64_t step = (hi - lo + 15) >> 4;
      const int64_t p = lo + sub * step;
      bool pass = false;
      if (p < hi) {
        const T v = r[p];
        pass = half ? v <= x : v < x;
      }
      const unsigned mine = (__ballot_sync(0xffffffffu, pass) >> (16 * half)) & 0xffffu;
      if (lo < hi) {
        const int c = __popc(mine);
        if (c == 0) {
          hi = lo;
        } else {
          const int64_t cut = lo + c * step;  // the first position failed
          lo += (c - 1) * step + 1;
          if (cut < hi) hi = cut;
        }
      }
    }
    if (sub == 0) (half ? hi_out : lo_out)[i] = static_cast<int32_t>(lo);
  }
}

template <typename T>
int launch(const void* l_, int64_t n, const void* r_, int64_t m, void* lo_,
           void* hi_, void* start_, int64_t tbits, void* stream_) {
  const auto* l = static_cast<const T*>(l_);
  const auto* r = static_cast<const T*>(r_);
  auto* lo = static_cast<int32_t*>(lo_);
  auto* hi = static_cast<int32_t*>(hi_);
  auto* start = static_cast<int32_t*>(start_);
  auto stream = static_cast<cudaStream_t>(stream_);
  if (n == 0) return 0;
  if (m == 0) {  // nothing below or at any key
    const int err = cudaMemsetAsync(lo, 0, n * sizeof(int32_t), stream);
    return err ? err : cudaMemsetAsync(hi, 0, n * sizeof(int32_t), stream);
  }
  if (m >= (int64_t{1} << 31) || tbits < kThreadSearch || tbits > 30) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tbits == kWarpSearch) {
    join_bounds_warp_kernel<T>
        <<<repro::grid_for(32 * n), kThreads, 0, stream>>>(l, n, r, m, lo, hi);
    return static_cast<int>(cudaGetLastError());
  }
  if (tbits == kThreadSearch) {
    join_bounds_thread_kernel<T>
        <<<repro::grid_for(n), kThreads, 0, stream>>>(l, n, r, m, lo, hi);
    return static_cast<int>(cudaGetLastError());
  }
  const int bits = static_cast<int>(tbits);
  const int64_t blocks = (m + kTableKeys - 1) / kTableKeys;
  join_bounds_table_kernel<T><<<static_cast<unsigned>(min(blocks, repro::kMaxBlocks)),
                                kThreads, 0, stream>>>(r, m, bits, start);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int64_t groups = (n + kProbes - 1) / kProbes;
  join_bounds_probe_kernel<T><<<repro::grid_for(groups), kThreads, 0, stream>>>(
      l, n, r, m, bits, start, lo, hi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ``tbits`` >= 0: the bucket path, ``start`` holding 2^tbits + 2 int32
// words from a 16-byte boundary (the bucket starts, then the number of
// keys below the sentinel padding); -1: a warp per key, -2: a thread per
// key (``start`` unused).  ``lo`` and ``hi`` are best 16-byte aligned.
// m < 2^31.
extern "C" int repro_join_bounds_i32(const void* l, int64_t n, const void* r,
                                     int64_t m, void* lo, void* hi, void* start,
                                     int64_t tbits, void* stream) {
  return launch<int32_t>(l, n, r, m, lo, hi, start, tbits, stream);
}

extern "C" int repro_join_bounds_i64(const void* l, int64_t n, const void* r,
                                     int64_t m, void* lo, void* hi, void* start,
                                     int64_t tbits, void* stream) {
  return launch<int64_t>(l, n, r, m, lo, hi, start, tbits, stream);
}
