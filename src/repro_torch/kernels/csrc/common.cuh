// Shared device helpers of the port's CUDA kernels (sm_90a).
//
// Reductions here are written so that their order depends only on the launch
// geometry, never on scheduling: a butterfly within a subgroup, a fixed tree
// across the warps of a block, and, across blocks, one partial per block in
// its own slot, which the block that finishes last sums in a fixed tree
// (`finish_sum`: one launch, an atomic only on the ticket that elects that
// block, never on a value).  The same inputs and geometry therefore give the
// same bits on every run.
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

// Sum of `count` partials that other blocks of this launch wrote, valid in
// thread 0, in a fixed tree: thread t adds partials t, t + blockDim.x, ... in
// index order, then block_sum.  The loads go out eight at a time (a slot past
// `count` reads as 0) and bypass L1 (__ldcg), which is not coherent across
// SMs.
template <typename T>
__device__ T sum_partials(const T* partials, int count) {
  constexpr int kInFlight = 8;
  const int step = blockDim.x;
  T acc = T(0);
  for (int base = threadIdx.x; base < count; base += kInFlight * step) {
    T v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = base + u * step;
      v[u] = i < count ? __ldcg(partials + i) : T(0);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) acc += v[u];
  }
  return block_sum(acc);
}

// The single pass of a sum over the `count` blocks of one reduction: every
// thread of each of them calls it after block_sum, with the block's partial
// in thread 0.  Thread 0 writes the partial to partials[slot] and takes a
// ticket from *ticket with one acquire-release atomic (the release publishes
// the partial, the acquire makes the other blocks' partials visible to this
// block after the barrier); the block that draws the last ticket sums all
// partials with sum_partials, writes *out and sets *ticket back to 0 for the
// next launch (the wrapper zeroes it once, when it allocates it).  The sum's
// order depends only on `count`, never on which block finishes last.
template <typename T>
__device__ void finish_sum(T partial, T* partials, int slot, int count,
                           unsigned* ticket, T* out) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[slot] = partial;
    unsigned drawn;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(drawn)
                 : "l"(ticket)
                 : "memory");
    last = drawn == static_cast<unsigned>(count - 1);
  }
  __syncthreads();
  if (!last) return;
  const T total = sum_partials(partials, count);
  if (threadIdx.x == 0) {
    *out = total;
    *ticket = 0u;
  }
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
