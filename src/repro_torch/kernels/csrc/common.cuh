// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel is templated on its key type: int32_t reproduces the TPU
// kernels' contract (int32 max is the pad sentinel), int64_t is what the
// engine uses for packed ``(a << 32) | b`` row codes (int64 max is the
// sentinel).  Each ``extern "C"`` entry launches on the stream it is given
// and returns ``cudaGetLastError()`` right after the launch; the Python
// wrapper raises on anything but 0.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

template <typename T>
struct Sentinel;

template <>
struct Sentinel<int32_t> {
  static constexpr int32_t value = 0x7fffffff;
};

template <>
struct Sentinel<int64_t> {
  static constexpr int64_t value = 0x7fffffffffffffffLL;
};

// #{k < n : x[k] < v} for ascending x.
template <typename T>
__device__ __forceinline__ int64_t lower_bound(const T* __restrict__ x,
                                               int64_t n, T v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = lo + ((hi - lo) >> 1);
    if (x[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// #{k < n : x[k] <= v} for ascending x.
template <typename T>
__device__ __forceinline__ int64_t upper_bound(const T* __restrict__ x,
                                               int64_t n, T v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = lo + ((hi - lo) >> 1);
    if (x[mid] <= v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// #{k < n : x[k] <= v} for ascending x, given that every x[k] with
// k < start is <= v (start = the lower bound of v).  Gallops forward from
// start, so the probes stay next to the lower bound's own line; a search
// over [start, n) from its midpoint instead would send every thread to a
// different line.
template <typename T>
__device__ __forceinline__ int64_t upper_bound_from(const T* __restrict__ x,
                                                    int64_t start, int64_t n,
                                                    T v) {
  int64_t lo = start;  // every x[k] with k < lo is <= v
  int64_t step = 1;
  while (lo + step <= n && x[lo + step - 1] <= v) {
    lo += step;
    step <<= 1;
  }
  const int64_t hi = (lo + step - 1 < n) ? lo + step - 1 : n;  // x[hi] > v
  return lo + upper_bound(x + lo, hi - lo, v);
}

// The smallest i in [lo, hi] at which ``pred`` is false, ``pred`` being
// true then false over [lo, hi), by one whole warp: each step every lane
// tests one of 32 evenly spaced positions and a ballot keeps the stretch
// where the answer lies.  Every lane returns it.
template <typename Pred>
__device__ __forceinline__ int64_t warp_search(int64_t lo, int64_t hi,
                                               Pred pred) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) >> 5;
    const int64_t p = lo + lane * step;
    const int c = __popc(__ballot_sync(0xffffffffu, p < hi && pred(p)));
    if (c == 0) break;
    const int64_t cut = lo + c * step;  // the first position tested false
    lo += (c - 1) * step + 1;
    if (cut < hi) hi = cut;
  }
  return lo;
}

constexpr int kThreads = 256;
// grid-stride loops cover any length with at most this many blocks
constexpr int64_t kMaxBlocks = 1 << 16;

inline unsigned grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks);
}

}  // namespace repro

// Message for a code an entry point returned (each library carries its own
// copy, so the wrapper can name a failure without linking the runtime).
extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
