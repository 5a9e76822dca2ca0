// y[b] = inv[b] v[b] for nb diagonal blocks of size bs (block-Jacobi apply).
//
// Replaces: src/repro/kernels/block_jacobi/kernel.py::block_jacobi_apply
// (Pallas TPU).
//
// Bound: bytes.  One call must read the inverted blocks once (nb bs^2 s
// bytes in their storage type: 8 for f64, 4 for f32, 2 for bf16/fp16), v
// once and write y once (nb bs t each, t the vector's 4 or 8 bytes); it does
// 2 bs flops an output, far below the card's ridge.  Reduced storage shrinks
// the dominant term, which is the point of the adaptive selection.  Storage
// is up-cast to the vector's type inside the kernel and the sum is kept in
// that type, as in the JAX kernel's body: f32 vectors take f32, bf16 or fp16
// blocks, f64 vectors f64, bf16 or fp16 blocks.
//
// Design, to move those bytes at the memory system's rate:
//   * a warp takes a tile of whole blocks, 32 / L rows (L lanes a row), and
//     the tile's rows are one contiguous stretch of `inv`;
//   * with bs a template constant (4 and 8, the paths' sizes) each lane loads
//     its part of a row as one aligned pack of 16 bytes (8 where a row of 4
//     16-bit values has only 8): a row of 8 f32 is two lanes' packs, a row
//     of 8 f64 four; a warp's load instruction covers 512 contiguous bytes
//     and uses every byte of every sector it fetches;
//   * each lane loads one element of v, its own row's, so every block's
//     segment is read once, coalesced, and handed to the lanes of the block
//     by __shfl_sync; where L > 1 the L partial sums meet in a fixed xor tree
//     (subgroup_sum), so the result is the same on every run;
//   * a warp sums one tile and a block holds block_threads / 32 tiles: the
//     grid covers every tile at once and the block scheduler refills each
//     SM as warps retire;
//   * loads are evict-first, stores plain.
// Any other bs up to 32 (Ginkgo's largest Jacobi block) takes the same
// kernel with bs read at run time and one storage element a load: the
// general route, for block sizes no path uses and for `inv` not 16-byte
// aligned.  A block above 32 (the JAX kernel takes any) spreads its rows
// over ceil(bs / 32) warps, each warp 32 rows of one block, and hands v's
// segment out 32 values at a time: the wide route.  Measured with forms of
// this kernel not kept (PERF.md §6): a persistent one-wave grid (each warp
// walking tiles with the next tile's loads issued first) was slower at
// every path shape but a serve lane's, whose tiles fit one wave anyway;
// evict-first loads beat plain ones at every path shape but the batched
// CG's 2,097,152 blocks, where they tie, and evict-first stores gained
// nothing; a cp.async ring in shared memory lost at the main shape.
#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kWarp = 32;

__device__ __forceinline__ float upcast(float v) { return v; }
__device__ __forceinline__ float upcast(__half v) { return __half2float(v); }
__device__ __forceinline__ float upcast(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ double upcast(double v) { return v; }

template <int BYTES> struct PackWord;
template <> struct PackWord<16> { using type = uint4; };
template <> struct PackWord<8> { using type = uint2; };

// The lanes of a row and the values a lane loads, for storage S at block
// size BS (0: read at run time, one value a load).
template <typename S, int BS>
struct RowSplit {
  static constexpr int kRowBytes = BS * static_cast<int>(sizeof(S));
  static constexpr int kLanes = (BS == 0 || kRowBytes <= 16) ? 1 : kRowBytes / 16;
  static constexpr int kVec = BS == 0 ? 1 : BS / kLanes;
  static constexpr int kRows = kWarp / kLanes;  // rows a warp's tile spans
};

// The packed routes take at most 32 registers a thread, so that 2,048
// threads fit on each SM at any block size (ptxas gave 36-40 unbounded);
// the general route would spill there and is left unbounded.  The packs and
// v are loaded evict-first (ld.global.cs: read once, so L2 keeps the lines
// other kernels left there); y is stored plainly, for the kernel that reads
// it next.
template <typename T, typename S, int BS>
__global__ void __launch_bounds__(1024, BS ? 2 : 1)
    block_jacobi_kernel(const S* __restrict__ inv, const T* __restrict__ v,
                        T* __restrict__ y, long long nb, int bs_rt) {
  using R = RowSplit<S, BS>;
  const int bs = BS ? BS : bs_rt;
  const int lane = threadIdx.x & (kWarp - 1);
  const int r = lane / R::kLanes;  // row of the tile
  const int q = lane % R::kLanes;  // pack of the row
  const int bpt = R::kRows / bs;   // blocks a tile
  const int lb = r / bs;           // block of the tile
  const int i = r - lb * bs;       // row of the block
  // the warp's tile
  const long long t = static_cast<long long>(blockIdx.x) *
                          (blockDim.x / kWarp) + threadIdx.x / kWarp;
  const long long b = t * bpt + lb;
  const long long row = b * bs + i;
  const bool active = lb < bpt && b < nb;
  const T vr = active ? __ldcs(v + row) : T(0);  // this lane's row's v
  T acc = T(0);
  if constexpr (BS == 0) {
    const S* arow = inv + row * bs;
    for (int c = 0; c < bs; ++c) {
      const T vc = __shfl_sync(0xffffffffu, vr, lb * bs + c);
      if (active) acc += static_cast<T>(upcast(arow[c])) * vc;
    }
  } else {
    using W = typename PackWord<R::kVec * sizeof(S)>::type;
    W w = {};
    if (active)
      w = __ldcs(reinterpret_cast<const W*>(inv + row * BS + q * R::kVec));
    S a[R::kVec];
    memcpy(a, &w, sizeof(W));
#pragma unroll
    for (int e = 0; e < R::kVec; ++e) {
      const int c = q * R::kVec + e;
      const T vc = __shfl_sync(0xffffffffu, vr, (lb * BS + c) * R::kLanes);
      acc += static_cast<T>(upcast(a[e])) * vc;
    }
    if constexpr (R::kLanes > 1)
      acc = subgroup_sum<R::kLanes>(acc, 0xffffffffu);
  }
  if (active && q == 0) y[row] = acc;
}

// bs above a warp: warp t takes rows 32 (t % tpb) + lane of block t / tpb
// (tpb = ceil(bs / 32) warps a block); in each 32-column chunk lane c loads
// v's value c of the chunk, which __shfl_sync hands to the warp's rows.
template <typename T, typename S>
__global__ void block_jacobi_wide_kernel(const S* __restrict__ inv,
                                         const T* __restrict__ v,
                                         T* __restrict__ y, long long nb,
                                         int bs) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long t = static_cast<long long>(blockIdx.x) *
                          (blockDim.x / kWarp) + threadIdx.x / kWarp;
  const long long tpb = (bs + kWarp - 1) / kWarp;
  const long long b = t / tpb;
  if (b >= nb) return;  // the whole warp
  const int i = static_cast<int>(t - b * tpb) * kWarp + lane;
  const bool active = i < bs;
  const S* arow = inv + (b * bs + i) * bs;
  const T* seg = v + b * bs;
  T acc = T(0);
  for (int c0 = 0; c0 < bs; c0 += kWarp) {
    const T vv = c0 + lane < bs ? seg[c0 + lane] : T(0);
    const int n = min(kWarp, bs - c0);
    for (int c = 0; c < n; ++c) {
      const T vc = __shfl_sync(0xffffffffu, vv, c);
      if (active) acc += static_cast<T>(upcast(arow[c0 + c])) * vc;
    }
  }
  if (active) y[b * bs + i] = acc;
}

// The grid for `warps` warps of block_threads / 32 a block.
int grid_of(long long warps, int block_threads, unsigned* grid) {
  const long long warps_per_block = block_threads / kWarp;
  const long long g = (warps + warps_per_block - 1) / warps_per_block;
  if (g >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  *grid = static_cast<unsigned>(g);
  return 0;
}

template <typename T, typename S, int BS>
int launch(const S* inv, const T* v, T* y, long long nb, int bs,
           int block_threads, cudaStream_t stream) {
  using R = RowSplit<S, BS>;
  const long long bpt = R::kRows / bs;
  unsigned grid = 0;
  if (int err = grid_of((nb + bpt - 1) / bpt, block_threads, &grid))
    return err;
  block_jacobi_kernel<T, S, BS>
      <<<grid, block_threads, 0, stream>>>(inv, v, y, nb, bs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S>
int launch_wide(const S* inv, const T* v, T* y, long long nb, int bs,
                int block_threads, cudaStream_t stream) {
  unsigned grid = 0;
  if (int err = grid_of(nb * ((bs + kWarp - 1) / kWarp), block_threads, &grid))
    return err;
  block_jacobi_wide_kernel<T, S>
      <<<grid, block_threads, 0, stream>>>(inv, v, y, nb, bs);
  return static_cast<int>(cudaGetLastError());
}

// The route: bs 8 or 4 with `inv` 16-byte aligned loads packs, bs above 32
// takes the wide route, every other case the general route.
template <typename T, typename S>
int dispatch(const S* inv, const T* v, T* y, long long nb, int bs,
             int block_threads, void* stream) {
  if (nb <= 0) return 0;
  if (bs < 1 || block_threads < kWarp || block_threads > 1024 ||
      block_threads % kWarp != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool packs = reinterpret_cast<std::uintptr_t>(inv) % 16 == 0;
  if (packs && bs == 8)
    return launch<T, S, 8>(inv, v, y, nb, bs, block_threads, s);
  if (packs && bs == 4)
    return launch<T, S, 4>(inv, v, y, nb, bs, block_threads, s);
  if (bs > kWarp)
    return launch_wide<T, S>(inv, v, y, nb, bs, block_threads, s);
  return launch<T, S, 0>(inv, v, y, nb, bs, block_threads, s);
}

}  // namespace

#define REPRO_BLOCK_JACOBI_ENTRY(NAME, T, S)                                  \
  extern "C" int NAME(const S* inv, const T* v, T* y, long long nb, int bs,   \
                      int block_threads, void* stream) {                      \
    return dispatch<T, S>(inv, v, y, nb, bs, block_threads, stream);          \
  }

REPRO_BLOCK_JACOBI_ENTRY(repro_block_jacobi_f32_f32, float, float)
REPRO_BLOCK_JACOBI_ENTRY(repro_block_jacobi_f32_bf16, float, __nv_bfloat16)
REPRO_BLOCK_JACOBI_ENTRY(repro_block_jacobi_f32_f16, float, __half)
REPRO_BLOCK_JACOBI_ENTRY(repro_block_jacobi_f64_f64, double, double)
REPRO_BLOCK_JACOBI_ENTRY(repro_block_jacobi_f64_bf16, double, __nv_bfloat16)
REPRO_BLOCK_JACOBI_ENTRY(repro_block_jacobi_f64_f16, double, __half)
