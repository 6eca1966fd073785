// Cooperation across the blocks of one persistent grid: acquire and
// release accesses, a bounded spin wait, a decoupled look-back over
// per-tile status words, a grid barrier, and the number of blocks a card
// holds at once (the most a cooperative launch may have).
//
// ``merge_sorted_unique`` and ``fused_join_dedup`` share these.  Both
// launch their grids cooperatively (every block resident), so a block may
// wait on another without deadlock; both take tiles in increasing order
// per block, so a look-back waits only on tiles that are running or done.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

// a tile's status word: its count, flagged as the tile's own (aggregate)
// or as everything up to and including it (inclusive); 0 = not yet known
constexpr uint64_t kAggregate = uint64_t{1} << 62;
constexpr uint64_t kInclusive = uint64_t{1} << 63;
constexpr uint64_t kValue = kAggregate - 1;
// a wait longer than this is a fault: trap rather than hang the card
constexpr uint64_t kSpinLimitNs = 2000000000ull;

__device__ __forceinline__ uint64_t load_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// *p once it is at least ``least``; the clock is read once every 1,024
// polls (a read of it costs more than a poll)
__device__ inline uint64_t wait_for(const uint64_t* p, uint64_t least) {
  uint64_t v = load_acquire(p);
  if (v >= least) return v;
  const uint64_t t0 = now_ns();
  for (unsigned i = 1; (v = load_acquire(p)) < least; ++i) {
    if (!(i & 1023) && now_ns() - t0 > kSpinLimitNs) __trap();
  }
  return v;
}

// Tile g's exclusive prefix, by warp 0 of its block (every lane returns
// it); publishes the tile's aggregate first and its inclusive prefix last.
// Each step reads kWindows windows of 32 predecessors at once, so a tile
// far from the nearest inclusive prefix (as in the first wave, when every
// tile starts together) waits for few round trips.
__device__ inline int64_t look_back(uint64_t* __restrict__ status, int64_t g,
                                    int64_t count) {
  constexpr int kWindows = 4;
  const int lane = threadIdx.x & 31;
  if (g == 0) {
    if (lane == 0) store_release(status, kInclusive | count);
    return 0;
  }
  if (lane == 0) store_release(status + g, kAggregate | count);
  int64_t before = 0;
  for (int64_t top = g - 1;; top -= 32 * kWindows) {
    // every status word before a published one is published (nonzero);
    // those before tile 0 read as an inclusive 0
    uint64_t s[kWindows];
#pragma unroll
    for (int w = 0; w < kWindows; ++w) {
      const int64_t k = top - 32 * w - lane;
      s[w] = k >= 0 ? load_acquire(status + k) : kInclusive;
    }
#pragma unroll
    for (int w = 0; w < kWindows; ++w) {
      if (!s[w]) s[w] = wait_for(status + (top - 32 * w - lane), 1);
    }
#pragma unroll
    for (int w = 0; w < kWindows; ++w) {
      const unsigned incl = __ballot_sync(0xffffffffu, (s[w] & kInclusive) != 0);
      const int stop = incl ? __ffs(incl) - 1 : 31;
      int64_t v = lane <= stop ? static_cast<int64_t>(s[w] & kValue) : 0;
#pragma unroll
      for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      before += v;
      if (incl) {
        if (lane == 0) store_release(status + g, kInclusive | (before + count));
        return before;
      }
    }
  }
}

// Every block of the grid waits here until ``*arrive`` reaches ``target``;
// each block adds one on arrival.  The counter only grows, so the n-th
// barrier of a grid of g blocks waits for n * g (``arrive`` zeroed before
// the launch).  Writes before the barrier are visible after it: the block's
// barrier orders them before its release-add, which the others' acquire
// loads see (a release-add costs less than a full fence and an add).
__device__ inline void grid_barrier(uint64_t* arrive, uint64_t target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u64 [%0], 1;" ::"l"(arrive) : "memory");
    wait_for(arrive, target);
  }
  __syncthreads();
}

// Blocks of ``kernel`` that the current card holds at once, with
// ``threads`` threads and ``smem`` bytes of dynamic shared memory each;
// ``cache`` (zeroed, one entry per device) keeps the answer, so a caller
// whose block shape never changes queries once per device.
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, size_t smem, int (&cache)[64],
                    int* out) {
  int dev = 0;
  int err = cudaGetDevice(&dev);
  if (err) return err;
  if (dev < 64 && cache[dev]) {
    *out = cache[dev];
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err) return err;
  *out = sms * per_sm;
  if (dev < 64) cache[dev] = *out;
  return 0;
}

}  // namespace repro
