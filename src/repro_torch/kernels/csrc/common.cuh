// Shared device helpers of the port's CUDA kernels (sm_90a).
//
// Reductions here are written so that their order depends only on the launch
// geometry, never on scheduling: a butterfly within a subgroup, a fixed tree
// across the warps of a block, and, across blocks, one partial per block that
// a second single-block launch sums in index order.  The same inputs and
// geometry therefore give the same bits on every run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

// Mask of the SG lanes (SG a power of two <= 32) of this thread's subgroup.
template <int SG>
__device__ __forceinline__ unsigned subgroup_mask() {
  if constexpr (SG == 32) {
    return 0xffffffffu;
  } else {
    const unsigned lane = threadIdx.x & 31u;
    return ((1u << SG) - 1u) << (lane & ~static_cast<unsigned>(SG - 1));
  }
}

// Butterfly sum over the SG lanes of one subgroup: the __shfl_xor_sync form
// of the JAX package's coop.subgroup(...).sum().  Every lane gets the sum.
template <int SG, typename T>
__device__ __forceinline__ T subgroup_sum(T v, unsigned mask) {
#pragma unroll
  for (int off = SG / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(mask, v, off, SG);
  }
  return v;
}

// Sum of v over the block, valid in thread 0.  blockDim.x is a multiple of
// 32 and at most 1024; every thread of the block must call it.
template <typename T>
__device__ T block_sum(T v) {
  __shared__ T warp_sums[32];
  v = subgroup_sum<32>(v, 0xffffffffu);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  v = (threadIdx.x < nwarps) ? warp_sums[threadIdx.x] : T(0);
  if (warp == 0) v = subgroup_sum<32>(v, 0xffffffffu);
  return v;
}

// One row of a row-major (m, k) ELL matrix times x, summed over the SG lanes
// of the calling subgroup (Ginkgo's subwarp-per-row ELL strategy): lane j
// takes entries j, j + SG, ...; the butterfly adds the lane partials.
// Padding entries (column 0, value 0) add nothing.
template <int SG, typename T>
__device__ __forceinline__ T ell_row_dot(const int* __restrict__ cols,
                                         const T* __restrict__ vals,
                                         const T* __restrict__ x,
                                         long long row, int k, int lane,
                                         unsigned mask) {
  const long long base = row * k;
  T sum = T(0);
  for (int j = lane; j < k; j += SG) sum += vals[base + j] * x[cols[base + j]];
  return subgroup_sum<SG>(sum, mask);
}

// Second stage of a two-stage reduction: one block sums `count` partials
// in a fixed order and writes the total to *out.
template <typename T>
__global__ void sum_partials_kernel(const T* __restrict__ partials, int count,
                                    T* __restrict__ out) {
  T acc = T(0);
  for (int i = threadIdx.x; i < count; i += blockDim.x) acc += partials[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) *out = acc;
}

// Element conversions of the LM kernels: storage type <-> f32 arithmetic.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as PyTorch's cast
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);
}

}  // namespace
