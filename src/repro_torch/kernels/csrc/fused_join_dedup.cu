// fused_join_dedup: join ``l`` against sorted ``r`` on key, pack each
// matching pair as (l_payload << 16) | (r_payload & 0xFFFF), keep the
// first ``capacity`` pairs in left-major order, sort, drop duplicates, pad
// with the int32 sentinel.
//
// Replaces the TPU kernel ``repro/kernels/fused.py::fused_join_dedup``
// (body ``_fused_join_dedup_kernel``), one program that holds everything in
// VMEM: span counts and the pair-to-row map as O(n) and O(capacity x n)
// broadcast compares, then two full sorts of ``capacity`` codes.  On this
// card the function is memory bound: it must read every left key, the keys
// of ``r`` that decide the spans and the payloads of the pairs it keeps,
// and write ``capacity`` codes, at most (2n + 2m + capacity) * 4 bytes over
// 3.35 TB/s.  At the sizes the closure runs (about 10^5 codes, a few
// hundred KB) that bound is well under a microsecond, and what costs is
// the chain of dependent steps: launches,
// host reads, barriers between passes, and loads that wait on loads.  So
// the whole function is one launch of a persistent grid, launched
// cooperatively (every block resident, so blocks may wait on each other),
// with one memset of its status words before it and one read of the pair
// total after it (the regrow contract's one host sync, from mapped host
// memory the kernel writes); each thread issues its independent loads
// together:
//
//   1. span, scan and emit: a row tile spans its left rows in ``r`` (kept
//      in shared memory when it fits, else a sample of every s-th key there
//      and one s-key stretch of ``r``), both bounds of every row by
//      branchless searches run in lockstep; a left key equal to the
//      sentinel matches nothing, as on the TPU.  ``cub::BlockScan`` and a
//      decoupled look-back (``coop.cuh``) give the tile its first pair slot
//      and the last tile the exact total.  The tile then emits its own
//      pairs below ``capacity`` (left-major order): each slot finds its row
//      by a search of the tile's offsets in shared memory and packs its
//      code; neighbouring slots are neighbouring threads.  The output is
//      filled with the sentinel meanwhile.  A tile's emit work is its pair
//      count, so a key matched by very many rows loads its tile alone.
//   2. sort: an LSD radix sort of the k = min(total, capacity) codes, 8
//      bits a pass (four passes) on the code with its top bit flipped
//      (int32 order, the sentinel largest), one grid barrier a pass.  Units
//      of 4,096 positions, dealt round-robin to the blocks, rank their codes
//      stably: warp-striped in position order, matched within a warp by bit
//      masks in shared memory (``__match_any_sync`` is several times slower
//      on this card), counted per warp.  A unit publishes its digit counts
//      (as count + 1, 0 meaning not yet) and, from every unit's counts,
//      places its codes of digit d at (codes of smaller digits) + (codes of
//      digit d in earlier units) + rank.  It stages them in digit order in
//      shared memory and writes each digit's run out, neighbouring threads
//      to neighbouring positions: scattered one-word stores would cost a
//      memory transaction each.  When the capacity fits one unit (a
//      regrow's cut first call among them), a second instance of the
//      kernel has block 0 sort alone from its own counts, with block
//      barriers, and the other blocks end after the emit.
//   3. unique and compaction: a code is kept when it differs from its
//      predecessor (the sentinel never); each unit places its kept codes by
//      a look-back over the units, and the last unit writes ``count``.
//
// ``scratch`` (int64 words, laid out by ``layout``; the wrapper's
// ``scratch_words`` mirrors it): [0] the pair total, [1] barrier arrivals,
// a look-back status word per row tile and per unit (these zeroed by the
// entry), each pass's digit counts per unit (zeroed by the kernel), two
// code buffers.  Only int32 keys exist: the codes are the TPU's
// 16-bit-halves contract.
#include <cub/block/block_scan.cuh>

#include "common.cuh"
#include "coop.cuh"

namespace {

constexpr int32_t kBig = repro::Sentinel<int32_t>::value;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTotalWord = 0, kArriveWord = 1, kHeaderWords = 4;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBits = 8;
constexpr int kBins = 1 << kBits;
constexpr int kPasses = 32 / kBits;
constexpr int kRowItems = 4;  // rows a thread spans
constexpr int kRowTile = kThreads * kRowItems;
constexpr int kEmitItems = 4;  // slots a thread emits at once
constexpr int kSortItems = 8;  // codes a thread ranks in a unit
constexpr int kUnitShift = 12;
constexpr int64_t kUnit = int64_t{1} << kUnitShift;  // positions per unit
constexpr int kRCache = 4096;  // shared-memory ints for ``r`` or its sample
// positions are int32 in the sort
constexpr int64_t kMaxCapacity = int64_t{1} << 30;
static_assert(kUnit == kThreads * kSortItems, "a unit is one ranked chunk");
static_assert(kUnit >= kRCache, "the staging buffer holds r's cache");
static_assert(kBins <= kThreads, "a thread per digit");

struct Params {
  const int32_t* l;
  const int32_t* lp;
  const int32_t* r;
  const int32_t* rp;
  int32_t* out;
  int32_t* count;
  int64_t* scratch;
  int64_t* total;  // page-locked host memory, mapped: the caller's copy
  int64_t n, m, cap;
};

struct Layout {
  int64_t row_status, unit_status, hist, a, b, bytes;  // byte offsets
  int64_t units;  // units of the capacity
};

__host__ __device__ inline int64_t align16(int64_t x) { return (x + 15) & ~int64_t{15}; }

__host__ __device__ inline Layout layout(int64_t n, int64_t cap) {
  Layout s;
  s.units = (cap + kUnit - 1) / kUnit;
  s.row_status = 8 * kHeaderWords;
  s.unit_status = s.row_status + 8 * ((n + kRowTile - 1) / kRowTile);
  s.hist = align16(s.unit_status + 8 * s.units);
  s.a = align16(s.hist + 4 * int64_t{kPasses} * kBins * s.units);
  s.b = align16(s.a + 4 * cap);
  s.bytes = s.b + 4 * cap;
  return s;
}

// dynamic shared memory: the unit's digit counts, their starts and its
// bases; the row tile's offsets, span starts and payloads; the staging
// buffer (``r`` or its sample in the span); the per-warp counters and
// match masks
constexpr size_t kSmem = 12 * kBins + 12 * kRowTile + 4 * kUnit + 6 * kWarps * kBins;

// *p once it is nonzero (a count published as count + 1); the clock is
// read once every 1,024 polls
__device__ __forceinline__ int wait_nonzero(const int* p) {
  int v = *reinterpret_cast<const volatile int*>(p);
  if (v) return v;
  const uint64_t t0 = repro::now_ns();
  for (unsigned i = 1; !(v = *reinterpret_cast<const volatile int*>(p)); ++i) {
    if (!(i & 1023) && repro::now_ns() - t0 > repro::kSpinLimitNs) __trap();
  }
  return v;
}

// Sorted a[0, limit) and Q probes, each searching [from, from + len]:
// #{a < x} there for probes below kUpperFrom, #{a <= x} for the others
// (probe q searches for x[q % X]), by branchless searches in lockstep, so
// the probes' loads of a step go out together.  Reads at or past ``limit``
// see int32 max.
template <int kUpperFrom, int Q, int X>
__device__ __forceinline__ void bounds(const int32_t* a, int64_t limit, const int64_t (&from)[Q],
                                       int64_t len, const int32_t (&x)[X], int64_t (&res)[Q]) {
  int64_t b[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) b[q] = from[q];
  auto less = [&](int64_t i, int q) {
    const int32_t y = i < limit ? a[i] : kBig;
    return q >= kUpperFrom ? y <= x[q % X] : y < x[q % X];
  };
  for (int64_t w = len; w > 1; w -= w >> 1) {
    const int64_t half = w >> 1;
#pragma unroll
    for (int q = 0; q < Q; ++q) b[q] = less(b[q] + half, q) ? b[q] + half : b[q];
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) res[q] = len > 0 ? b[q] + less(b[q], q) : from[q];
}

// #{r < x} (res[q]) and #{r <= x} (res[R + q]) of each probe x[q]: in
// ``cache`` when it holds all of r (stride 1), else from its sample (r[0],
// r[s], ...) and one search of the s-key stretch of r that holds each
template <int R>
__device__ __forceinline__ void span_bounds(const int32_t* __restrict__ r, int64_t m,
                                            const int32_t* cache, int64_t ns, int64_t stride,
                                            const int32_t (&x)[R], int64_t (&res)[2 * R]) {
  int64_t zero[2 * R];
#pragma unroll
  for (int q = 0; q < 2 * R; ++q) zero[q] = 0;
  if (stride == 1) {
    bounds<R>(cache, m, zero, m, x, res);
    return;
  }
  int64_t j[2 * R], from[2 * R];
  bounds<R>(cache, ns, zero, ns, x, j);  // samples below (or at) x
  // when j > 0 the answer lies in [(j - 1) s + 1, min(j s, m)]
#pragma unroll
  for (int q = 0; q < 2 * R; ++q) from[q] = j[q] ? (j[q] - 1) * stride + 1 : 0;
  bounds<R>(r, m, from, stride - 1, x, res);
#pragma unroll
  for (int q = 0; q < 2 * R; ++q) res[q] = j[q] ? res[q] : 0;
}

__device__ __forceinline__ int digit(int32_t v, int shift) {
  return static_cast<int>((static_cast<uint32_t>(v) ^ 0x80000000u) >> shift) & (kBins - 1);
}

template <bool kSolo>
__global__ void __launch_bounds__(kThreads) fjd_kernel(const Params p) {
  using Scan64 = cub::BlockScan<int64_t, kThreads>;
  using Scan32 = cub::BlockScan<int, kThreads>;
  __shared__ union {
    typename Scan64::TempStorage s64;
    typename Scan32::TempStorage s32;
  } tmp;
  __shared__ int64_t s_word;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blk = blockIdx.x, nblk = gridDim.x;
  const int64_t n = p.n, m = p.m, cap = p.cap;
  const Layout lay = layout(n, cap);
  auto* raw = reinterpret_cast<unsigned char*>(p.scratch);
  auto* words = reinterpret_cast<uint64_t*>(p.scratch);
  // per pass, per unit, per digit: the unit's codes of that digit
  auto* hist = reinterpret_cast<int*>(raw + lay.hist);
  const int64_t hist_stride = lay.units * kBins;
  int* ctot = reinterpret_cast<int*>(smem);  // the unit's counts
  int* cstart = ctot + kBins;  // where each digit starts in the staged unit
  int* base = cstart + kBins;  // where the unit's codes of each digit go
  int32_t* t_off = base + kBins;
  int32_t* t_lo = t_off + kRowTile;
  int32_t* t_lp = t_lo + kRowTile;
  int32_t* stage = t_lp + kRowTile;
  auto* wcnt = reinterpret_cast<uint16_t*>(stage + kUnit);
  auto* masks = reinterpret_cast<unsigned*>(wcnt + kWarps * kBins);
  int32_t* rcache = stage;  // the span's, before any unit is staged
  int32_t* src = reinterpret_cast<int32_t*>(raw + lay.a);
  int32_t* dst = reinterpret_cast<int32_t*>(raw + lay.b);

  uint64_t arrivals = 0;
  auto sync = [&]() {
    arrivals += static_cast<uint64_t>(nblk);
    repro::grid_barrier(words + kArriveWord, arrivals);
  };

  // ---- set-up: fill the output, zero the match masks and digit counts ---
  for (int64_t i = static_cast<int64_t>(blk) * kThreads + tid; i < cap;
       i += static_cast<int64_t>(nblk) * kThreads) {
    p.out[i] = kBig;
  }
  for (int i = tid; i < kWarps * kBins; i += kThreads) masks[i] = 0;
  for (int64_t i = static_cast<int64_t>(blk) * kThreads + tid; i < kPasses * hist_stride;
       i += static_cast<int64_t>(nblk) * kThreads) {
    hist[i] = 0;
  }

  // ---- 1. span, scan and emit ------------------------------------------
  const int64_t stride = m <= kRCache ? 1 : (m + kRCache - 1) / kRCache;
  const int64_t ns = (m + stride - 1) / stride;
  const int64_t row_tiles = (n + kRowTile - 1) / kRowTile;
  int32_t x[kRowItems], lp[kRowItems];
  auto load_rows = [&](int64_t g) {
    const int64_t i0 = g * kRowTile + static_cast<int64_t>(tid) * kRowItems;
#pragma unroll
    for (int q = 0; q < kRowItems; ++q) {
      const bool ok = g < row_tiles && i0 + q < n;
      x[q] = ok ? p.l[i0 + q] : kBig;
      lp[q] = ok ? p.lp[i0 + q] : 0;
    }
  };
  load_rows(blk);  // in flight with the cache's loads
  for (int64_t j = tid; j < ns; j += kThreads) rcache[j] = p.r[j * stride];
  __syncthreads();
  for (int64_t g = blk; g < row_tiles; g += nblk) {
    int64_t lohi[2 * kRowItems], lo[kRowItems], cnt[kRowItems];
    if (m > 0) span_bounds(p.r, m, rcache, ns, stride, x, lohi);
#pragma unroll
    for (int q = 0; q < kRowItems; ++q) {
      const bool hit = m > 0 && x[q] != kBig;
      lo[q] = hit ? lohi[q] : 0;
      cnt[q] = hit ? lohi[kRowItems + q] - lohi[q] : 0;
    }
    int64_t tile_sum;
    Scan64(tmp.s64).ExclusiveSum(cnt, cnt, tile_sum);
    // the tile's rows for its emit: offsets (cut at the capacity), span
    // starts, left payloads
#pragma unroll
    for (int q = 0; q < kRowItems; ++q) {
      const int e = tid * kRowItems + q;
      t_off[e] = static_cast<int32_t>(cnt[q] < cap ? cnt[q] : cap);
      t_lo[e] = static_cast<int32_t>(lo[q]);
      t_lp[e] = lp[q];
    }
    if (warp == 0) {
      const int64_t before = repro::look_back(words + lay.row_status / 8, g, tile_sum);
      if (lane == 0) {
        s_word = before;
        if (g == row_tiles - 1) {
          p.scratch[kTotalWord] = before + tile_sum;
          *reinterpret_cast<volatile int64_t*>(p.total) = before + tile_sum;
        }
      }
    }
    __syncthreads();
    const int64_t first = s_word;
    const int64_t room = first < cap ? cap - first : 0;
    const int64_t emit = tile_sum < room ? tile_sum : room;
    for (int64_t s0 = 0; s0 < emit; s0 += static_cast<int64_t>(kThreads) * kEmitItems) {
      int32_t sv[kEmitItems];
      int64_t row[kEmitItems], zero[kEmitItems];
#pragma unroll
      for (int q = 0; q < kEmitItems; ++q) {
        const int64_t s = s0 + q * kThreads + tid;
        sv[q] = static_cast<int32_t>(s < emit ? s : emit - 1);
        zero[q] = 0;
      }
      // the last row whose offset is <= s: rows before it in a run of equal
      // offsets have no pairs, so it is the row of slot s
      bounds<0>(t_off, kRowTile, zero, kRowTile, sv, row);
      int32_t rpv[kEmitItems];
#pragma unroll
      for (int q = 0; q < kEmitItems; ++q) {
        const int e = static_cast<int>(row[q]) - 1;
        rpv[q] = p.rp[t_lo[e] + (sv[q] - t_off[e])];
      }
#pragma unroll
      for (int q = 0; q < kEmitItems; ++q) {
        const int64_t s = s0 + q * kThreads + tid;
        if (s < emit) {
          const int e = static_cast<int>(row[q]) - 1;
          src[first + s] = static_cast<int32_t>((static_cast<uint32_t>(t_lp[e]) << 16) |
                                                (static_cast<uint32_t>(rpv[q]) & 0xFFFFu));
        }
      }
    }
    __syncthreads();  // ``s_word``, ``tmp`` and the tile's rows are reused
    load_rows(g + nblk);
  }
  sync();
  const int64_t total = *reinterpret_cast<volatile int64_t*>(p.scratch + kTotalWord);
  const int64_t k = total < cap ? total : cap;
  if (k == 0) {  // the output is all sentinel already
    if (blk == 0 && tid == 0) *p.count = 0;
    return;
  }
  // unit u holds positions [u * kUnit, min((u + 1) * kUnit, k))
  const int64_t units = (k + kUnit - 1) / kUnit;
  // a capacity within one unit (the regrow's cut first calls among them):
  // block 0 sorts alone, with block barriers and its own counts
  if (kSolo && blk != 0) return;
  auto unit_len = [&](int64_t u) {
    return static_cast<int>(((u + 1) * kUnit < k ? (u + 1) * kUnit : k) - u * kUnit);
  };

  // ---- 2. radix sort ---------------------------------------------------
  // Rank unit u's codes on the digit at ``shift``: ``key``, ``dig`` (kBins
  // past the unit's end) and ``rank`` (among the earlier codes of its digit
  // and warp), the per-warp counts made exclusive over the warps, and the
  // unit's counts in ``ctot``.  Warp-striped: item i of a lane is position
  // warp * 32 * kSortItems + i * 32 + lane of the unit.
  int32_t key[kSortItems];
  int dig[kSortItems], rank[kSortItems];
  auto rank_unit = [&](int64_t u, int shift) {
    const int64_t c0 = u * kUnit;
    const int len = unit_len(u);
    for (int i = tid; i < kWarps * kBins; i += kThreads) wcnt[i] = 0;
#pragma unroll
    for (int i = 0; i < kSortItems; ++i) {
      const int pos = warp * 32 * kSortItems + i * 32 + lane;
      key[i] = pos < len ? src[c0 + pos] : 0;
    }
#pragma unroll
    for (int i = 0; i < kSortItems; ++i) {
      const int pos = warp * 32 * kSortItems + i * 32 + lane;
      dig[i] = pos < len ? digit(key[i], shift) : kBins;
    }
    __syncthreads();  // the counters are zero
    uint16_t* mine = wcnt + warp * kBins;
    unsigned* mask = masks + warp * kBins;
    const unsigned below = (1u << lane) - 1;
#pragma unroll
    for (int i = 0; i < kSortItems; ++i) {
      const int d = dig[i];
      if (d < kBins) atomicOr(mask + d, 1u << lane);
      __syncwarp();
      const unsigned peers = d < kBins ? mask[d] : 0u;
      __syncwarp();
      const int leader = peers ? __ffs(peers) - 1 : lane;
      int old = 0;
      if (lane == leader && d < kBins) {
        old = mine[d];
        mine[d] = static_cast<uint16_t>(old + __popc(peers));
        mask[d] = 0;
      }
      rank[i] = __shfl_sync(kFull, old, leader) + __popc(peers & below);
      __syncwarp();
    }
    __syncthreads();
    // per digit (kPer threads each): the counts of earlier warps, and the
    // unit's count
    constexpr int kPer = kThreads / kBins;
    constexpr int kSpan = kWarps / kPer;  // warps each of them sums
    const int d = tid / kPer, part = tid % kPer;
    int c[kSpan];
    int s = 0;
#pragma unroll
    for (int w = 0; w < kSpan; ++w) c[w] = wcnt[(part * kSpan + w) * kBins + d];
#pragma unroll
    for (int w = 0; w < kSpan; ++w) s += c[w];
    int incl = s;
#pragma unroll
    for (int o = 1; o < kPer; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o, kPer);
      if (part >= o) incl += y;
    }
    int run = incl - s;
#pragma unroll
    for (int w = 0; w < kSpan; ++w) {
      wcnt[(part * kSpan + w) * kBins + d] = static_cast<uint16_t>(run);
      run += c[w];
    }
    if (part == kPer - 1) ctot[d] = incl;
    __syncthreads();
  };
  auto counts_of = [&](int pass, int64_t u) { return hist + pass * hist_stride + u * kBins; };
  // every unit is ranked before any waits on the others' counts; a block
  // that holds one unit keeps its ranks, one that holds several ranks again
  const bool hold = units <= nblk;
  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = pass * kBits;
    for (int64_t u = blk; u < units; u += nblk) {
      rank_unit(u, shift);
      if (kSolo) break;
      int* row = counts_of(pass, u);
      for (int d = tid; d < kBins; d += kThreads) {
        *reinterpret_cast<volatile int*>(row + d) = ctot[d] + 1;
      }
      if (!hold) __syncthreads();  // ``ctot`` and the counters are ranked again
    }
    for (int64_t u = blk; u < units; u += nblk) {
      if (!hold) rank_unit(u, shift);
      // every unit's published counts, four digits a load: groups of
      // threads take every kGroups-th unit, their sums meet in ``stage``
      constexpr int kQuads = kBins / 4;  // loads per unit
      constexpr int kGroups = kThreads / kQuads;
      static_assert(2 * kGroups * kBins <= kUnit, "the group sums fit the staging buffer");
      if (!kSolo) {
        const int grp = tid / kQuads, quad = tid % kQuads;
        int4 t4 = make_int4(0, 0, 0, 0), b4 = make_int4(0, 0, 0, 0);
#pragma unroll 4
        for (int64_t v = grp; v < units; v += kGroups) {
          const int* row = counts_of(pass, v) + 4 * quad;
          int4 c = __ldcg(reinterpret_cast<const int4*>(row));  // through L2, where they went
          if (!c.x) c.x = wait_nonzero(row);
          if (!c.y) c.y = wait_nonzero(row + 1);
          if (!c.z) c.z = wait_nonzero(row + 2);
          if (!c.w) c.w = wait_nonzero(row + 3);
          t4 = make_int4(t4.x + c.x - 1, t4.y + c.y - 1, t4.z + c.z - 1, t4.w + c.w - 1);
          if (v < u) b4 = make_int4(b4.x + c.x - 1, b4.y + c.y - 1, b4.z + c.z - 1, b4.w + c.w - 1);
        }
        reinterpret_cast<int4*>(stage + grp * kBins)[quad] = t4;
        reinterpret_cast<int4*>(stage + (kGroups + grp) * kBins)[quad] = b4;
      }
      __syncthreads();
      // base[d]: codes of smaller digits, plus codes of digit d in earlier
      // units; cstart[d]: the unit's codes of smaller digits.  Both
      // exclusive sums in one scan: the total over every unit in the high
      // half, the unit's own count (at most kUnit) in the low
      int64_t packed = 0, before = 0;
      if (tid < kBins) {
        int64_t tot = kSolo ? ctot[tid] : 0;
        if (!kSolo) {
#pragma unroll
          for (int grp = 0; grp < kGroups; ++grp) {
            tot += stage[grp * kBins + tid];
            before += stage[(kGroups + grp) * kBins + tid];
          }
        }
        packed = (tot << 32) | ctot[tid];
      }
      Scan64(tmp.s64).ExclusiveSum(packed, packed);
      if (tid < kBins) {
        base[tid] = static_cast<int>((packed >> 32) + before);
        cstart[tid] = static_cast<int>(packed & 0xffffffff);
      }
      __syncthreads();
      // stage the unit in digit order, then write each digit's run to its
      // place: neighbouring threads write neighbouring positions
#pragma unroll
      for (int i = 0; i < kSortItems; ++i) {
        if (dig[i] < kBins) stage[cstart[dig[i]] + wcnt[warp * kBins + dig[i]] + rank[i]] = key[i];
      }
      __syncthreads();
      const int len = unit_len(u);
      for (int j = tid; j < len; j += kThreads) {
        const int32_t v = stage[j];
        const int d = digit(v, shift);
        dst[base[d] + (j - cstart[d])] = v;
      }
      __syncthreads();  // ``stage``, ``base`` and ``cstart`` are reused
    }
    if (!kSolo) sync();  // a block sees its own writes after its barrier
    int32_t* t = src;
    src = dst;
    dst = t;
  }

  // ---- 3. unique and compaction -----------------------------------------
  // each unit's kept codes placed by a look-back over the units
  auto* status = words + lay.unit_status / 8;
  for (int64_t u = blk; u < units; u += nblk) {
    const int64_t t0 = u * kUnit + static_cast<int64_t>(tid) * kSortItems;
    const int64_t t1 = u * kUnit + unit_len(u);
    int32_t v[kSortItems];
    unsigned keep = 0;
#pragma unroll
    for (int q = 0; q < kSortItems; ++q) v[q] = t0 + q < t1 ? src[t0 + q] : kBig;
    const int32_t head = t0 > 0 && t0 < t1 ? src[t0 - 1] : kBig;
#pragma unroll
    for (int q = 0; q < kSortItems; ++q) {
      const bool first = t0 + q == 0 || (q ? v[q - 1] : head) != v[q];
      keep |= static_cast<unsigned>(v[q] != kBig && first) << q;
    }
    int at, kept;
    Scan32(tmp.s32).ExclusiveSum(static_cast<int>(__popc(keep)), at, kept);
    if (warp == 0) {
      const int64_t before = repro::look_back(status, u, kept);
      if (lane == 0) {
        s_word = before;
        if (u == units - 1) *p.count = static_cast<int32_t>(before + kept);
      }
    }
    __syncthreads();
    int32_t* out = p.out + s_word + at;
#pragma unroll
    for (int q = 0; q < kSortItems; ++q) {
      if ((keep >> q) & 1) *out++ = v[q];
    }
    __syncthreads();  // ``s_word`` and ``tmp`` are reused
  }
}

template <bool kSolo>
int launch_as(Params p, cudaStream_t stream) {
  static int cache[64] = {};
  static bool sized = false;
  int err = 0;
  if (!sized) {
    err = cudaFuncSetAttribute(fjd_kernel<kSolo>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmem));
    if (err) return err;
    sized = true;
  }
  int resident = 0;
  err = repro::resident_blocks(fjd_kernel<kSolo>, kThreads, kSmem, cache, &resident);
  if (err) return err;
  // a block per row tile or per unit of the capacity, whichever is more,
  // as far as the card holds them all at once
  const int64_t row_tiles = (p.n + kRowTile - 1) / kRowTile;
  const int64_t units = (p.cap + kUnit - 1) / kUnit;
  int64_t blocks = row_tiles > units ? row_tiles : units;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  void* args[] = {&p};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&fjd_kernel<kSolo>), dim3(static_cast<unsigned>(blocks)),
      dim3(kThreads), args, kSmem, stream));
}

// a capacity within one unit is sorted by one block (``kSolo``)
int launch(Params p, cudaStream_t stream) {
  return p.cap <= kUnit ? launch_as<true>(p, stream) : launch_as<false>(p, stream);
}

}  // namespace

// The whole function in one launch: ``out`` (capacity int32) gets the
// sorted unique codes and the sentinel, ``count`` (one int32) their
// number, ``*total`` (a host int64) the exact pair count, read once the
// launch is queued: the kernel writes it to mapped page-locked memory (one
// slot per host thread), the entry waits for the stream and copies it.
// ``scratch`` holds at least ``layout(n, capacity)`` bytes (``words`` int64
// words).  Returns the first CUDA error, if any.
extern "C" int repro_fused_join_dedup_i32(const void* l, const void* lp,
                                          int64_t n, const void* r,
                                          const void* rp, int64_t m,
                                          int64_t capacity, void* out,
                                          void* count, void* scratch,
                                          int64_t words, void* total,
                                          void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (n < 0 || m < 0 || m > INT32_MAX || capacity <= 0 || capacity > kMaxCapacity) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout lay = layout(n, capacity);
  if (words * 8 < lay.bytes) return static_cast<int>(cudaErrorInvalidValue);
  static thread_local int64_t* slot = nullptr;
  static thread_local int64_t* slot_dev = nullptr;
  int err = 0;
  if (!slot) {
    if ((err = cudaHostAlloc(&slot, sizeof(int64_t), cudaHostAllocMapped))) return err;
    if ((err = cudaHostGetDevicePointer(&slot_dev, slot, 0))) return err;
  }
  *reinterpret_cast<volatile int64_t*>(slot) = 0;  // no row tile, no pairs
  // the header and the look-back status words
  if ((err = cudaMemsetAsync(scratch, 0, static_cast<size_t>(lay.hist), s))) return err;
  const Params p{static_cast<const int32_t*>(l), static_cast<const int32_t*>(lp),
                 static_cast<const int32_t*>(r), static_cast<const int32_t*>(rp),
                 static_cast<int32_t*>(out), static_cast<int32_t*>(count),
                 static_cast<int64_t*>(scratch), slot_dev, n, m, capacity};
  if ((err = launch(p, s))) return err;
  if ((err = cudaStreamSynchronize(s))) return err;
  *static_cast<int64_t*>(total) = *reinterpret_cast<volatile int64_t*>(slot);
  return 0;
}
