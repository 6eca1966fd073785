// The bucket arithmetic that ``sorted_member`` and ``join_bounds`` share.
//
// A sorted key array's span [keys[0], keys[m - 1]] is cut into 2^tbits
// equal buckets, bucket(x) = (x - keys[0]) >> shift, computed in the
// unsigned type of the key so that any span, negative keys and the
// sentinel included, fits.  All keys equal to x lie in bucket(x), and the
// buckets are ordered as the keys are, so a table of where each bucket
// starts in the array places any key of the span by arithmetic.  Each
// kernel builds its own table.
#pragma once

#include <cstdint>

namespace repro {

template <typename T>
struct Unsigned;
template <>
struct Unsigned<int32_t> {
  using type = uint32_t;
};
template <>
struct Unsigned<int64_t> {
  using type = uint64_t;
};

// The key span of ``keys``, [keys[0], keys[m - 1]], cut into 2^tbits
// buckets (m >= 1); every thread reads the two ends (the same two lines
// for all).
template <typename T>
struct Buckets {
  using U = typename Unsigned<T>::type;
  T lo, hi;
  int shift;

  __device__ Buckets(const T* __restrict__ keys, int64_t m, int tbits)
      : lo(keys[0]), hi(keys[m - 1]) {
    const U range = static_cast<U>(hi) - static_cast<U>(lo);
    const int bits = range ? 8 * static_cast<int>(sizeof(U)) - clz(range) : 0;
    shift = bits > tbits ? bits - tbits : 0;
  }
  __device__ static int clz(uint32_t v) { return __clz(v); }
  __device__ static int clz(uint64_t v) { return __clzll(v); }
  // distance of lo <= x from lo, in the unsigned type (order-preserving)
  __device__ U offset(T x) const {
    return static_cast<U>(x) - static_cast<U>(lo);
  }
  // bucket of lo <= x <= hi, in [0, 2^tbits)
  __device__ int64_t of(T x) const {
    return static_cast<int64_t>(offset(x) >> shift);
  }
};

}  // namespace repro
