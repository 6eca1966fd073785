// rle_expand: out[i] = values[min(#{ends <= i}, r - 1)] for i < total
// (RLE decode; ``ends`` is the inclusive prefix sum of the run counts).
//
// Replaces the TPU kernel ``repro/kernels/rle_expand.py::rle_expand`` (body
// ``_rle_kernel``), which copies the whole run table into every output tile
// and counts run ends with a broadcast compare.  On this card the op is
// memory bound: it reads the run table (values and counts) once and writes
// ``total`` values, so its bound is r * (sizeof(T) + sizeof(count)) +
// total * sizeof(T) bytes over 3.35 TB/s.
//
// The first design gave every output element a binary search over ``ends``:
// about log2(r) dependent loads per 8 bytes written, so the searches, not
// the writes, set the pace.  This design tiles the output instead:
//
//   1. Each block owns a tile of 16 KB of consecutive outputs (256
//      threads x four 16-byte vectors).  Two warps find the runs covering
//      the tile's first and last outputs at once, each with a 32-way warp
//      search (every lane probes one of 32 evenly spaced ends, a ballot
//      narrows the range): log32(r) dependent loads per tile, not log2(r)
//      per output.
//   2. Every run that starts inside the tile writes its index (relative to
//      the first run) at its start position in a shared-memory slot array
//      with atomicMax.  Zero-length runs share the start of the next run;
//      the largest index there is the one #{ends <= i} names.  The loop
//      over the tile's runs strides by the block, so any number of
//      zero-length runs fits; a run longer than the tile writes nothing
//      in the tiles it covers past its first.
//   3. A max-scan over the slots gives every output its run.  Each warp
//      owns an eighth of the tile and walks it in four steps of 32
//      consecutive 16-byte vectors (one per lane, read from shared memory
//      without bank conflicts): a running max inside the vector, a
//      shuffle max-scan across the lanes, a carry across the steps, and
//      one shared word per warp carries across the warps.
//   4. Each lane gathers the values of its four vectors and writes them
//      with 16-byte stores, warp-contiguous (512 bytes per warp and
//      store); the tail tile stores element by element up to ``total``.
//
// Every tile costs the same whatever the run lengths, so one run holding
// almost all of ``total`` is spread over many blocks.  The ``ends`` scan is
// a ``torch.cumsum`` in the wrapper, as the TPU wrapper takes it outside
// its ``pallas_call``.
#include "common.cuh"

namespace {

constexpr int kThreads = repro::kThreads;
constexpr int kVectors = 4;  // 16-byte vectors per thread
constexpr int kTileBytes = kThreads * kVectors * 16;

template <typename T>
struct Tile {
  static constexpr int kVec = 16 / sizeof(T);        // elements per vector
  static constexpr int kItems = kVectors * kVec;     // outputs per thread
  static constexpr int kSize = kThreads * kItems;    // outputs per tile
};

// A vector of run indices (one per output of a 16-byte output vector),
// kept in registers: int2 for int64 outputs, int4 for int32.
__device__ __forceinline__ int32_t get(const int2& v, int j) {
  return j ? v.y : v.x;
}
__device__ __forceinline__ int32_t get(const int4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}
// running maximum inside the vector, each element also at least c
__device__ __forceinline__ int2 scan_max(int2 v, int32_t c) {
  v.x = max(v.x, c);
  v.y = max(v.y, v.x);
  return v;
}
__device__ __forceinline__ int4 scan_max(int4 v, int32_t c) {
  v.x = max(v.x, c);
  v.y = max(v.y, v.x);
  v.z = max(v.z, v.y);
  v.w = max(v.w, v.z);
  return v;
}
__device__ __forceinline__ int32_t last_of(const int2& v) { return v.y; }
__device__ __forceinline__ int32_t last_of(const int4& v) { return v.w; }

template <typename T>
struct Vec;
template <>
struct Vec<int64_t> {
  using Runs = int2;
  // the values of runs k0 + min(run, last), one 16-byte store
  __device__ static void store(int64_t* p, const int64_t* __restrict__ values,
                               int64_t k0, int64_t last, Runs run) {
    *reinterpret_cast<longlong2*>(p) =
        make_longlong2(values[k0 + min(int64_t{run.x}, last)],
                       values[k0 + min(int64_t{run.y}, last)]);
  }
};
template <>
struct Vec<int32_t> {
  using Runs = int4;
  __device__ static void store(int32_t* p, const int32_t* __restrict__ values,
                               int64_t k0, int64_t last, Runs run) {
    *reinterpret_cast<int4*>(p) =
        make_int4(values[k0 + min(int64_t{run.x}, last)],
                  values[k0 + min(int64_t{run.y}, last)],
                  values[k0 + min(int64_t{run.z}, last)],
                  values[k0 + min(int64_t{run.w}, last)]);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
rle_expand_kernel(const T* __restrict__ values,
                  const int64_t* __restrict__ ends, int64_t r,
                  T* __restrict__ out, int64_t total) {
  constexpr int kVec = Tile<T>::kVec;
  constexpr int kWarpSpan = 32 * kVectors * kVec;  // outputs per warp
  using Runs = typename Vec<T>::Runs;              // kVec int32 slots
  __shared__ __align__(16) int32_t slot[Tile<T>::kSize];
  __shared__ int64_t bounds[2];
  __shared__ int32_t warp_max[kThreads / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * Tile<T>::kSize;
  const int64_t e = min(s + Tile<T>::kSize, total);

  // 1. the runs covering the tile's first and last outputs
  if (warp < 2) {
    const int64_t v = warp == 0 ? s : e - 1;
    // #{k < r : ends[k] <= v}
    const int64_t k =
        repro::warp_search(0, r, [=](int64_t i) { return ends[i] <= v; });
    if (lane == 0) bounds[warp] = k;
  }
  for (int i = tid * 4; i < Tile<T>::kSize; i += kThreads * 4) {
    *reinterpret_cast<int4*>(slot + i) = make_int4(0, 0, 0, 0);
  }
  __syncthreads();
  const int64_t k0 = bounds[0], k1 = bounds[1];

  // 2. the runs that start inside the tile mark their start positions
  for (int64_t k = k0 + 1 + tid; k <= k1; k += kThreads) {
    atomicMax(&slot[ends[k - 1] - s], static_cast<int32_t>(k - k0));
  }
  __syncthreads();

  // 3. max-scan: within each vector, across the warp's lanes (32
  //    consecutive vectors per step; written back in place), then across
  //    the block's warps
  int32_t carry = 0;  // maximum over the warp's earlier vectors
#pragma unroll
  for (int v = 0; v < kVectors; ++v) {
    Runs* at = reinterpret_cast<Runs*>(slot + warp * kWarpSpan +
                                       (v * 32 + lane) * kVec);
    const Runs own = scan_max(*at, 0);
    int32_t acc = last_of(own);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t up = __shfl_up_sync(0xffffffffu, acc, d);
      if (lane >= d) acc = max(acc, up);
    }
    const int32_t before = __shfl_up_sync(0xffffffffu, acc, 1);
    *at = scan_max(own, max(lane ? before : 0, carry));
    carry = max(carry, __shfl_sync(0xffffffffu, acc, 31));
  }
  if (lane == 0) warp_max[warp] = carry;
  __syncthreads();
  int32_t block_carry = 0;
  for (int w = 0; w < warp; ++w) block_carry = max(block_carry, warp_max[w]);

  // 4. gather and store, one warp-contiguous 16-byte vector at a time
  const int64_t last = r - 1 - k0;  // the clamp to r - 1, relative to k0
#pragma unroll
  for (int v = 0; v < kVectors; ++v) {
    const int pos = warp * kWarpSpan + (v * 32 + lane) * kVec;
    const int64_t i0 = s + pos;
    if (i0 >= e) break;
    const Runs run =
        scan_max(*reinterpret_cast<const Runs*>(slot + pos), block_carry);
    if (i0 + kVec <= e) {
      Vec<T>::store(out + i0, values, k0, last, run);
    } else {
      for (int j = 0; i0 + j < e; ++j) {
        out[i0 + j] = values[k0 + min(int64_t{get(run, j)}, last)];
      }
    }
  }
}

template <typename T>
int launch(const void* values, const void* ends, int64_t r, void* out,
           int64_t total, void* stream) {
  static_assert(Tile<T>::kSize * sizeof(T) == kTileBytes, "tile size");
  const int64_t tiles = (total + Tile<T>::kSize - 1) / Tile<T>::kSize;
  rle_expand_kernel<T><<<static_cast<unsigned>(tiles), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(values), static_cast<const int64_t*>(ends), r,
      static_cast<T*>(out), total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_rle_expand_i32(const void* values, const void* ends,
                                    int64_t r, void* out, int64_t total,
                                    void* stream) {
  return launch<int32_t>(values, ends, r, out, total, stream);
}

extern "C" int repro_rle_expand_i64(const void* values, const void* ends,
                                    int64_t r, void* out, int64_t total,
                                    void* stream) {
  return launch<int64_t>(values, ends, r, out, total, stream);
}
