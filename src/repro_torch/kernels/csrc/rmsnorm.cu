// y = x * rsqrt(mean(x^2) + eps) * w over the last axis of x (rows, d).
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py::rmsnorm (Pallas TPU).
//
// Bound: bytes.  One call must read x once and write y once (2*rows*d*s
// bytes for s-byte elements) and read w (d*s_w); it does about 4 flops per
// element, far below the card's ridge point.
//
// Design: the TPU kernel kept a (block_rows, d) tile resident in VMEM and
// reduced it along lanes.  Here a row belongs to `tpr` threads (one warp
// for d up to 8 vectors a lane, with several rows a block; else one block
// of up to 1,024 threads), each of which reads its share of the row in
// 16-byte vectors (8 bf16/fp16 or 4 f32; 1 element when d or the base is
// not aligned) into registers, so x is read once.  The sum of squares is
// taken in f32 in a fixed tree: a thread's vectors in index order, a
// butterfly within each warp, then the warp partials in a butterfly of
// warp 0.  The order depends only on the geometry, so a call repeats bit
// for bit, with no atomics.  A second pass over the registers scales by
// rsqrt(var + eps) * w and writes y in x's type.  Row offsets are 64-bit.
#include "common.cuh"

namespace {

constexpr int kVecPerThread = 8;  // register budget: 8 vectors a thread

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* out) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = to_f32(e[k]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = to_f32(p[k]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float* v) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < VEC; ++k) e[k] = from_f32<T>(v[k]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = from_f32<T>(v[k]);
  }
}

// blockDim = (tpr, rows per block); tpr is 32 (a warp per row, several rows
// a block) or a multiple of 32 with one row a block.
template <typename T, typename TW, int VEC>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const TW* __restrict__ w, T* __restrict__ y,
                               long long rows, int d, float eps) {
  __shared__ float warp_sums[32];
  const int tpr = blockDim.x;
  const long long row =
      static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  const bool live = row < rows;
  const int nvec = d / VEC;
  const long long base = row * static_cast<long long>(d);

  float v[kVecPerThread][VEC];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kVecPerThread; ++i) {
    const int j = threadIdx.x + i * tpr;
    if (live && j < nvec) {
      load_vec<T, VEC>(x + base + static_cast<long long>(j) * VEC, v[i]);
#pragma unroll
      for (int k = 0; k < VEC; ++k) ss += v[i][k] * v[i][k];
    }
  }
  ss = subgroup_sum<32>(ss, 0xffffffffu);
  if (tpr > 32) {  // one row a block: add the warp partials in warp 0
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    if (lane == 0) warp_sums[warp] = ss;
    __syncthreads();
    if (warp == 0) {
      float t = lane < (tpr >> 5) ? warp_sums[lane] : 0.f;
      t = subgroup_sum<32>(t, 0xffffffffu);
      if (lane == 0) warp_sums[0] = t;
    }
    __syncthreads();
    ss = warp_sums[0];
  }
  if (!live) return;
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
#pragma unroll
  for (int i = 0; i < kVecPerThread; ++i) {
    const int j = threadIdx.x + i * tpr;
    if (j < nvec) {
      float o[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        o[k] = v[i][k] * inv * to_f32(w[j * VEC + k]);
      }
      store_vec<T, VEC>(y + base + static_cast<long long>(j) * VEC, o);
    }
  }
}

template <typename T, typename TW>
int launch(const T* x, const TW* w, T* y, long long rows, int d, float eps,
           int vectorized, int tpr, int rows_per_block, cudaStream_t stream) {
  const dim3 block(tpr, rows_per_block);
  const long long grid = (rows + rows_per_block - 1) / rows_per_block;
  constexpr int kVec = 16 / sizeof(T);
  if (vectorized) {
    rmsnorm_kernel<T, TW, kVec><<<static_cast<unsigned>(grid), block, 0,
                                  stream>>>(x, w, y, rows, d, eps);
  } else {
    rmsnorm_kernel<T, TW, 1><<<static_cast<unsigned>(grid), block, 0,
                               stream>>>(x, w, y, rows, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define REPRO_RMSNORM_ENTRY(NAME, T, TW)                                    \
  extern "C" int NAME(const void* x, const void* w, void* y,                \
                      long long rows, int d, float eps, int vectorized,     \
                      int tpr, int rows_per_block, void* stream) {          \
    return launch(static_cast<const T*>(x), static_cast<const TW*>(w),      \
                  static_cast<T*>(y), rows, d, eps, vectorized, tpr,        \
                  rows_per_block, static_cast<cudaStream_t>(stream));       \
  }

REPRO_RMSNORM_ENTRY(repro_rmsnorm_f32_f32, float, float)
REPRO_RMSNORM_ENTRY(repro_rmsnorm_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
REPRO_RMSNORM_ENTRY(repro_rmsnorm_bf16_f32, __nv_bfloat16, float)
REPRO_RMSNORM_ENTRY(repro_rmsnorm_f16_f16, __half, __half)
REPRO_RMSNORM_ENTRY(repro_rmsnorm_f16_f32, __half, float)
