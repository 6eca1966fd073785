// merge_sorted_unique: merge sorted ``fresh`` into the sorted-unique,
// sentinel-padded ``buf``, drop duplicates, cut to ``cap`` = len(buf).
//
// Replaces the TPU kernel ``repro/kernels/fused.py::merge_sorted_unique``
// (``_merge_impl`` / body ``_merge_kernel``), which sorts ``buf ++ fresh``
// in VMEM, masks adjacent duplicates and sorts again to compact, writing
// over ``buf`` (``input_output_aliases``).  On this card the op is memory
// bound: it must read the ``nb`` occupied slots of ``buf`` and ``fresh``
// once and write ``cap`` values, so its bound is (nb + f + cap) * sizeof(T)
// bytes over 3.35 TB/s.  No sort is needed because both inputs are sorted.
// The first design ranked every element by a binary search, moved about
// 45 bytes of scratch per fresh element through three launches and a
// ``torch.cumsum``, and searched ``buf`` for its length in every block.
//
// This design is one merge-path pass over the inputs (``merge_path``):
//
//   * The merged sequence of A = buf[:nb] and B = fresh (ties: A first) is
//     cut into tiles of kTile positions.  A block finds a tile's two
//     splits along the merge path by 32-way warp searches (none when one
//     side is empty), copies both segments into shared memory as aligned
//     16-byte chunks (asynchronous copies, all in flight at once), and
//     each thread merges kItems of them (an odd count, so a warp's reads
//     hit distinct banks).
//   * An item is kept when it is not the sentinel and differs from its
//     predecessor in merged order (for a tile's first item, the larger of
//     the elements just before the two splits).  With ties ordered A
//     first, this one rule drops repeats inside ``fresh`` and values
//     already in ``buf``.
//   * ``cub::BlockScan`` places each kept item within the tile; a
//     decoupled look-back over per-tile status words (aggregate, then
//     inclusive prefix; one warp reads 128 predecessors a step) gives the
//     tile's global offset.  The kept items are compacted in shared memory
//     and stored coalesced, cut at ``cap``.
//   * The grid is persistent and launched cooperatively (every block
//     resident), each block taking tiles in increasing order, so a
//     look-back waits only on tiles that are running or done.  Slots past
//     nb + f get the sentinel at once; the hole [total, nb + f) that
//     dropped items leave is known only when the last tile is placed, so
//     after one grid barrier every block fills its share of it.
//
// ``scratch`` (int64 words, zeroed by the entry with a memset on the same
// stream): [0] the uncapped unique total and [1] the number of new values
// (``_merge_kernel``'s ``count`` and ``n_new``), [2] ``nb`` when the caller
// did not give it (found by ``merge_count``, one warp, the only other
// launch), [3] barrier arrivals, [4 ..) one status word per tile.  The
// output goes to a second buffer, never over ``buf``.  The look-back, the
// grid barrier and the residency query are ``coop.cuh``'s.
#include <cuda_pipeline.h>

#include <cub/block/block_scan.cuh>

#include "common.cuh"
#include "coop.cuh"

namespace {

constexpr int kThreads = repro::kThreads;

template <typename T>
struct Tile;
template <>
struct Tile<int32_t> {
  static constexpr int kItems = 31;  // 31 KB of keys per tile
};
template <>
struct Tile<int64_t> {
  static constexpr int kItems = 15;  // 30 KB of keys per tile
};

constexpr int kTotal = 0, kNew = 1, kNb = 2, kArrive = 3, kStatus = 4;

// The number of A's among the first d items of the merge of A and B
// (ties: A first).
template <typename T>
__device__ __forceinline__ int64_t warp_merge_path(const T* __restrict__ a,
                                                   int64_t na,
                                                   const T* __restrict__ b,
                                                   int64_t nb, int64_t d) {
  return repro::warp_search(max(int64_t{0}, d - nb), min(d, na),
                            [=](int64_t i) { return a[i] <= b[d - 1 - i]; });
}

// The aligned 16-byte chunks that hold a[0, na) and then b[0, nb) copied
// into ``raw`` by the block with asynchronous copies (no registers, all in
// flight together); returns where a's and b's items start in ``raw``.
// Bytes outside ``a`` or ``b`` lie in the same chunks as their first and
// last items.
template <typename T>
__device__ __forceinline__ int2 load_tile(T* __restrict__ raw,
                                          const T* __restrict__ a, int na,
                                          const T* __restrict__ b, int nb) {
  constexpr int kVec = 16 / sizeof(T);
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a);
  const uintptr_t pb = reinterpret_cast<uintptr_t>(b);
  const int head_a = static_cast<int>(pa & 15) / sizeof(T);
  const int head_b = static_cast<int>(pb & 15) / sizeof(T);
  const int ca = na ? (head_a + na + kVec - 1) / kVec : 0;
  const int cb = nb ? (head_b + nb + kVec - 1) / kVec : 0;
  const int4* base_a = reinterpret_cast<const int4*>(pa & ~uintptr_t{15});
  const int4* base_b = reinterpret_cast<const int4*>(pb & ~uintptr_t{15});
  int4* dst = reinterpret_cast<int4*>(raw);
  for (int c = threadIdx.x; c < ca + cb; c += kThreads) {
    __pipeline_memcpy_async(dst + c, c < ca ? base_a + c : base_b + (c - ca), 16);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  return make_int2(head_a, ca * kVec + head_b);
}

// out[begin, end) = sentinel, by the whole grid
template <typename T>
__device__ __forceinline__ void fill_sentinel(T* __restrict__ out,
                                              int64_t begin, int64_t end) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t p = begin + static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       p < end; p += stride) {
    out[p] = repro::Sentinel<T>::value;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
merge_path_kernel(const T* __restrict__ buf, int64_t cap, int64_t nb_given,
                  const T* __restrict__ fresh, int64_t nf, T* __restrict__ out,
                  int64_t* __restrict__ scratch) {
  constexpr T kBig = repro::Sentinel<T>::value;
  constexpr int kItems = Tile<T>::kItems;
  constexpr int kTile = kThreads * kItems;
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ typename Scan::TempStorage scan_tmp;
  // the tile's inputs as 16-byte chunks (a span of n items starting
  // anywhere covers at most n / kVec + 2 of them), later its kept items
  __shared__ __align__(16) T items[kTile + 3 * (16 / sizeof(T))];
  __shared__ int64_t split[2];
  __shared__ int64_t offset;
  __shared__ T tile_prev;
  __shared__ bool tile_has_prev;

  auto* words = reinterpret_cast<uint64_t*>(scratch);
  const int64_t nb = nb_given >= 0 ? nb_given : scratch[kNb];
  const int64_t n_in = nb + nf;
  const int64_t tiles = (n_in + kTile - 1) / kTile;
  const int warp = threadIdx.x >> 5;

  // no tile writes past the inputs' length: the sentinel goes there now
  fill_sentinel(out, min(n_in, cap), cap);

  for (int64_t g = blockIdx.x; g < tiles; g += gridDim.x) {
    const int64_t d0 = g * kTile;
    const int64_t d1 = min(d0 + kTile, n_in);
    if (warp < 2) {
      const int64_t i = warp_merge_path(buf, nb, fresh, nf, warp ? d1 : d0);
      if ((threadIdx.x & 31) == 0) split[warp] = i;
    }
    __syncthreads();
    const int64_t i0 = split[0], j0 = d0 - split[0];
    const int na = static_cast<int>(split[1] - i0);
    const int len = static_cast<int>(d1 - d0);
    const int nbt = len - na;
    const int2 at = load_tile(items, buf + i0, na, fresh + j0, nbt);
    const T* sa = items + at.x;
    const T* sb = items + at.y;
    if (threadIdx.x == 0) {
      // the tile's first item follows the larger of A[i0 - 1], B[j0 - 1]
      T p = kBig;
      bool has = false;
      if (i0 > 0) {
        p = buf[i0 - 1];
        has = true;
      }
      if (j0 > 0) {
        const T q = fresh[j0 - 1];
        p = has ? max(p, q) : q;
        has = true;
      }
      tile_prev = p;
      tile_has_prev = has;
    }
    __syncthreads();

    // this thread's items: tile positions [diag, diag + kItems)
    const int diag = min(static_cast<int>(threadIdx.x) * kItems, len);
    int lo = max(0, diag - nbt), hi = min(diag, na);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sa[mid] <= sb[diag - 1 - mid]) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int ai = lo, bi = diag - lo;
    T prev;
    bool has;
    if (diag == 0) {
      prev = tile_prev;
      has = tile_has_prev;
    } else {
      has = true;
      prev = ai > 0 ? sa[ai - 1] : sb[bi - 1];
      if (ai > 0 && bi > 0) prev = max(prev, sb[bi - 1]);
    }
    T v[kItems];
    unsigned keep = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (diag + k < len) {
        const bool take_a = ai < na && (bi >= nbt || sa[ai] <= sb[bi]);
        const T x = take_a ? sa[ai++] : sb[bi++];
        keep |= static_cast<unsigned>(x != kBig && (!has || x != prev)) << k;
        v[k] = x;
        prev = x;
        has = true;
      }
    }
    int rank, kept;
    Scan(scan_tmp).ExclusiveSum(__popc(keep), rank, kept);
    __syncthreads();  // every merge read of ``items`` is done
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if ((keep >> k) & 1) items[rank++] = v[k];
    }
    if (warp == 0) {
      const int64_t before = repro::look_back(words + kStatus, g, kept);
      if (threadIdx.x == 0) {
        offset = before;
        if (g == tiles - 1) scratch[kTotal] = before + kept;
      }
    }
    __syncthreads();
    const int64_t off = offset;
    for (int k = threadIdx.x; k < kept && off + k < cap; k += kThreads) {
      out[off + k] = items[k];
    }
    __syncthreads();  // ``items`` and ``split`` are free for the next tile
  }

  repro::grid_barrier(words + kArrive, gridDim.x);
  const int64_t total = static_cast<int64_t>(repro::load_acquire(words + kTotal));
  // the hole that dropped items leave before the inputs' length
  fill_sentinel(out, min(total, cap), min(n_in, cap));
  if (blockIdx.x == 0 && threadIdx.x == 0) scratch[kNew] = total - nb;
}

// scratch[kNb] = #{k < cap : buf[k] != sentinel}, by one warp
template <typename T>
__global__ void merge_count_kernel(const T* __restrict__ buf, int64_t cap,
                                   int64_t* __restrict__ scratch) {
  constexpr T kBig = repro::Sentinel<T>::value;
  const int64_t nb =
      repro::warp_search(0, cap, [=](int64_t i) { return buf[i] < kBig; });
  if (threadIdx.x == 0) scratch[kNb] = nb;
}

template <typename T>
int launch(const void* buf_, int64_t cap, int64_t nb, const void* fresh_,
           int64_t nf, void* out_, void* scratch_, int64_t scratch_words,
           void* stream_) {
  constexpr int kTile = kThreads * Tile<T>::kItems;
  const auto* buf = static_cast<const T*>(buf_);
  const auto* fresh = static_cast<const T*>(fresh_);
  auto* out = static_cast<T*>(out_);
  auto* scratch = static_cast<int64_t*>(scratch_);
  auto stream = static_cast<cudaStream_t>(stream_);
  // tiles cover at most cap + nf inputs; the grid never has more blocks
  const int64_t max_tiles = (cap + nf + kTile - 1) / kTile;
  if (nb < -1 || nb > cap || scratch_words < kStatus + max_tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = cudaMemsetAsync(scratch, 0, scratch_words * sizeof(int64_t), stream);
  if (err) return err;
  if (nb < 0) {
    merge_count_kernel<T><<<1, 32, 0, stream>>>(buf, cap, scratch);
    err = cudaGetLastError();
    if (err) return err;
  }
  static int cache[64] = {};
  int resident = 0;
  err = repro::resident_blocks(merge_path_kernel<T>, kThreads, 0, cache, &resident);
  if (err) return err;
  const unsigned grid =
      static_cast<unsigned>(max(int64_t{1}, min(max_tiles, int64_t{resident})));
  void* args[] = {&buf, &cap, &nb, &fresh, &nf, &out, &scratch};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&merge_path_kernel<T>), dim3(grid),
      dim3(kThreads), args, 0, stream));
}

}  // namespace

// ``count`` is the number of codes ``buf`` holds, or -1 when the caller
// does not know it; ``scratch`` holds at least 4 + ceil((cap + nf) /
// tile) int64 words (tile: 7,936 int32 or 3,840 int64 positions).
extern "C" int repro_merge_sorted_unique_i32(const void* buf, int64_t cap,
                                             int64_t count, const void* fresh,
                                             int64_t nf, void* out,
                                             void* scratch,
                                             int64_t scratch_words,
                                             void* stream) {
  return launch<int32_t>(buf, cap, count, fresh, nf, out, scratch,
                         scratch_words, stream);
}

extern "C" int repro_merge_sorted_unique_i64(const void* buf, int64_t cap,
                                             int64_t count, const void* fresh,
                                             int64_t nf, void* out,
                                             void* scratch,
                                             int64_t scratch_words,
                                             void* stream) {
  return launch<int64_t>(buf, cap, count, fresh, nf, out, scratch,
                         scratch_words, stream);
}
