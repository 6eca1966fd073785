// fused_join_dedup: join ``l`` against sorted ``r`` on key, pack each
// matching pair as (l_payload << 16) | (r_payload & 0xFFFF), keep the
// first ``capacity`` pairs in left-major order, sort, drop duplicates, pad
// with the int32 sentinel.
//
// Replaces the TPU kernel ``repro/kernels/fused.py::fused_join_dedup``
// (body ``_fused_join_dedup_kernel``), one program that holds everything in
// VMEM: span counts and the pair-to-row map as O(n) and O(capacity x n)
// broadcast compares, then two full sorts of ``capacity`` codes.  On this
// card the function is memory bound: it must read the two keys and two
// payloads once and write ``capacity`` codes, so its bound is
// (2n + 2m + capacity) * 4 bytes over 3.35 TB/s.  The design computes the
// function, not the broadcast, in two host calls with one read of the pair
// total between them (the wrapper needs it to size the sort, and the caller
// to regrow):
//
//   count (``repro_fjd_count``):
//     1. ``span``: one thread per left row; lower bound by binary search,
//        upper bound by the gallop of ``join_bounds.cu``; a left key equal
//        to the sentinel matches nothing, as on the TPU.
//     2. an exclusive scan of the span counts (tile scans with
//        ``cub::BlockScan``, one block scanning the tile sums, a fix-up
//        pass), which also yields the exact pair total.
//   emit (``repro_fjd_emit``), over k = min(total, capacity) pairs:
//     3. ``gather``: one thread per pair slot finds its left row by a binary
//        search of the offsets (as ``rle_expand.cu`` finds its run), so a
//        skewed key costs no thread more than another; packs the code.
//     4. a sort of the k codes: tiles of 2048 sorted in shared memory with
//        ``cub::BlockRadixSort``, then pairwise merge passes that place each
//        code by its rank in the other run (ties: left run first), writing
//        between two buffers.
//     5. adjacent-unique flags (a sentinel code is never kept), the same
//        scan over them, and a compaction that pads the tail with the
//        sentinel and writes the unique count.
//
// Only int32 keys exist: the codes are the TPU's 16-bit-halves contract.
#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

#include "common.cuh"

namespace {

constexpr int32_t kBig = repro::Sentinel<int32_t>::value;
constexpr int kScanItems = 4;
constexpr int64_t kScanTile = repro::kThreads * kScanItems;
constexpr int kSortItems = 8;
constexpr int64_t kSortTile = repro::kThreads * kSortItems;

using BlockScan = cub::BlockScan<int64_t, repro::kThreads>;

#define REPRO_CHECK_LAUNCH()                          \
  do {                                                \
    const cudaError_t err_ = cudaGetLastError();      \
    if (err_ != cudaSuccess) return static_cast<int>(err_); \
  } while (0)

__global__ void span_kernel(const int32_t* __restrict__ l, int64_t n,
                            const int32_t* __restrict__ r, int64_t m,
                            int32_t* __restrict__ lo,
                            int64_t* __restrict__ cnt) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int32_t x = l[i];
    int64_t a = 0, c = 0;
    if (x != kBig) {
      a = repro::lower_bound(r, m, x);
      c = repro::upper_bound_from(r, a, m, x) - a;
    }
    lo[i] = static_cast<int32_t>(a);
    cnt[i] = c;
  }
}

// Exclusive prefix sums of one tile of ``in`` into ``out``; the tile's sum
// goes to ``tile_sums``.
template <typename T>
__global__ void scan_tiles_kernel(const T* __restrict__ in, int64_t n,
                                  int64_t* __restrict__ out,
                                  int64_t* __restrict__ tile_sums) {
  __shared__ typename BlockScan::TempStorage tmp;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScanTile +
                       static_cast<int64_t>(threadIdx.x) * kScanItems;
  int64_t v[kScanItems];
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    v[k] = base + k < n ? static_cast<int64_t>(in[base + k]) : 0;
  }
  int64_t tile_sum;
  BlockScan(tmp).ExclusiveSum(v, v, tile_sum);
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    if (base + k < n) out[base + k] = v[k];
  }
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = tile_sum;
}

// One block: exclusive scan of the tile sums in place, chunk by chunk with
// a carry; the grand total goes to ``total``.
__global__ void scan_sums_kernel(int64_t* __restrict__ sums, int64_t n_tiles,
                                 int64_t* __restrict__ total) {
  __shared__ typename BlockScan::TempStorage tmp;
  int64_t carry = 0;
  for (int64_t base = 0; base < n_tiles; base += repro::kThreads) {
    const int64_t i = base + threadIdx.x;
    int64_t v = i < n_tiles ? sums[i] : 0;
    int64_t chunk_sum;
    BlockScan(tmp).ExclusiveSum(v, v, chunk_sum);
    if (i < n_tiles) sums[i] = v + carry;
    carry += chunk_sum;
    __syncthreads();  // before ``tmp`` is reused
  }
  if (threadIdx.x == 0) *total = carry;
}

__global__ void add_tile_offsets_kernel(int64_t* __restrict__ out, int64_t n,
                                        const int64_t* __restrict__ sums) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] += sums[i / kScanTile];
  }
}

// out = exclusive prefix sums of in[0, n); *total = their sum.  ``sums``
// holds one int64 per tile of kScanTile.
template <typename T>
int exclusive_scan(const T* in, int64_t n, int64_t* out, int64_t* sums,
                   int64_t* total, cudaStream_t stream) {
  const int64_t n_tiles = (n + kScanTile - 1) / kScanTile;
  if (n_tiles > 0) {
    scan_tiles_kernel<T><<<static_cast<unsigned>(n_tiles), repro::kThreads, 0,
                           stream>>>(in, n, out, sums);
    REPRO_CHECK_LAUNCH();
  }
  scan_sums_kernel<<<1, repro::kThreads, 0, stream>>>(sums, n_tiles, total);
  REPRO_CHECK_LAUNCH();
  if (n_tiles > 1) {
    add_tile_offsets_kernel<<<repro::grid_for(n), repro::kThreads, 0,
                              stream>>>(out, n, sums);
    REPRO_CHECK_LAUNCH();
  }
  return 0;
}

__global__ void gather_kernel(const int32_t* __restrict__ lp,
                              const int32_t* __restrict__ rp,
                              const int32_t* __restrict__ lo,
                              const int64_t* __restrict__ offs, int64_t n,
                              int64_t k, int32_t* __restrict__ codes) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < k; t += stride) {
    // the last row whose offset is <= t: rows before it in a run of equal
    // offsets have no pairs, so it is the row that produced pair t
    const int64_t i = repro::upper_bound(offs, n, t) - 1;
    const int64_t j = lo[i] + (t - offs[i]);
    const uint32_t code = (static_cast<uint32_t>(lp[i]) << 16) |
                          (static_cast<uint32_t>(rp[j]) & 0xFFFFu);
    codes[t] = static_cast<int32_t>(code);
  }
}

__global__ void sort_tiles_kernel(int32_t* __restrict__ keys, int64_t k) {
  using Sort = cub::BlockRadixSort<int32_t, repro::kThreads, kSortItems>;
  __shared__ typename Sort::TempStorage tmp;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kSortTile +
                       static_cast<int64_t>(threadIdx.x) * kSortItems;
  int32_t v[kSortItems];
#pragma unroll
  for (int q = 0; q < kSortItems; ++q) v[q] = base + q < k ? keys[base + q] : kBig;
  Sort(tmp).Sort(v);  // blocked: thread t holds ranks [t * items, (t+1) * items)
#pragma unroll
  for (int q = 0; q < kSortItems; ++q) {
    if (base + q < k) keys[base + q] = v[q];
  }
}

// Merge sorted runs of width w pairwise (runs [a0, a0 + w) and
// [a0 + w, a0 + 2w) into [a0, a0 + 2w) of dst).  A code of the left run
// lands after the right run's smaller codes; one of the right run after
// the left run's smaller-or-equal codes, so no two codes share a slot.
__global__ void merge_pass_kernel(const int32_t* __restrict__ src,
                                  int32_t* __restrict__ dst, int64_t k,
                                  int64_t w) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < k; t += stride) {
    const int64_t a0 = (t / (2 * w)) * (2 * w);
    const int64_t b0 = a0 + w;
    const int32_t v = src[t];
    if (b0 >= k) {  // a run with no partner in this pass
      dst[t] = v;
      continue;
    }
    const int64_t b1 = b0 + w < k ? b0 + w : k;
    const int64_t d = t < b0
        ? (t - a0) + repro::lower_bound(src + b0, b1 - b0, v)
        : (t - b0) + repro::upper_bound(src + a0, w, v);
    dst[a0 + d] = v;
  }
}

__global__ void unique_flags_kernel(const int32_t* __restrict__ s, int64_t k,
                                    int32_t* __restrict__ flags) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < k; t += stride) {
    const int32_t v = s[t];
    flags[t] = (v != kBig && (t == 0 || s[t - 1] != v)) ? 1 : 0;
  }
}

__global__ void compact_kernel(const int32_t* __restrict__ s, int64_t k,
                               const int32_t* __restrict__ flags,
                               const int64_t* __restrict__ pos,
                               const int64_t* __restrict__ n_unique,
                               int32_t* __restrict__ out, int64_t capacity,
                               int32_t* __restrict__ count) {
  const int64_t c = *n_unique;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < capacity; t += stride) {
    if (t < k && flags[t]) out[pos[t]] = s[t];
    if (t >= c) out[t] = kBig;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *count = static_cast<int32_t>(c);
}

}  // namespace

// Spans of every left row and the exclusive offsets of their pair counts;
// ``total`` (int64, on the card) receives the exact pair count.  Scratch:
// lo (n int32), cnt and offs (n int64 each), sums (one int64 per 1024 rows).
extern "C" int repro_fjd_count_i32(const void* l, int64_t n, const void* r,
                                   int64_t m, void* lo, void* cnt, void* offs,
                                   void* sums, void* total, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  span_kernel<<<repro::grid_for(n), repro::kThreads, 0, s>>>(
      static_cast<const int32_t*>(l), n, static_cast<const int32_t*>(r), m,
      static_cast<int32_t*>(lo), static_cast<int64_t*>(cnt));
  REPRO_CHECK_LAUNCH();
  return exclusive_scan(static_cast<const int64_t*>(cnt), n,
                        static_cast<int64_t*>(offs),
                        static_cast<int64_t*>(sums),
                        static_cast<int64_t*>(total), s);
}

// The first k = min(total, capacity) pairs, packed, sorted, deduplicated
// into ``out`` (capacity int32) with the unique count in ``count`` (one
// int32).  Scratch: keys and tmp (k int32 each), flags (k int32), pos (k
// int64), sums (one int64 per 1024 pairs), n_unique (one int64).
extern "C" int repro_fjd_emit_i32(const void* lp, const void* rp,
                                  const void* lo, const void* offs, int64_t n,
                                  int64_t k, void* keys, void* tmp,
                                  void* flags, void* pos, void* sums,
                                  void* n_unique, void* out, int64_t capacity,
                                  void* count, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  auto* a = static_cast<int32_t*>(keys);
  auto* b = static_cast<int32_t*>(tmp);
  if (k > 0) {
    gather_kernel<<<repro::grid_for(k), repro::kThreads, 0, s>>>(
        static_cast<const int32_t*>(lp), static_cast<const int32_t*>(rp),
        static_cast<const int32_t*>(lo), static_cast<const int64_t*>(offs), n,
        k, a);
    REPRO_CHECK_LAUNCH();
    const int64_t n_tiles = (k + kSortTile - 1) / kSortTile;
    sort_tiles_kernel<<<static_cast<unsigned>(n_tiles), repro::kThreads, 0,
                        s>>>(a, k);
    REPRO_CHECK_LAUNCH();
    for (int64_t w = kSortTile; w < k; w *= 2) {
      merge_pass_kernel<<<repro::grid_for(k), repro::kThreads, 0, s>>>(a, b,
                                                                       k, w);
      REPRO_CHECK_LAUNCH();
      int32_t* t = a;
      a = b;
      b = t;
    }
    unique_flags_kernel<<<repro::grid_for(k), repro::kThreads, 0, s>>>(
        a, k, static_cast<int32_t*>(flags));
    REPRO_CHECK_LAUNCH();
  }
  const int rc = exclusive_scan(static_cast<const int32_t*>(flags), k,
                                static_cast<int64_t*>(pos),
                                static_cast<int64_t*>(sums),
                                static_cast<int64_t*>(n_unique), s);
  if (rc) return rc;
  compact_kernel<<<repro::grid_for(capacity), repro::kThreads, 0, s>>>(
      a, k, static_cast<const int32_t*>(flags),
      static_cast<const int64_t*>(pos),
      static_cast<const int64_t*>(n_unique), static_cast<int32_t*>(out),
      capacity, static_cast<int32_t*>(count));
  REPRO_CHECK_LAUNCH();
  return 0;
}
