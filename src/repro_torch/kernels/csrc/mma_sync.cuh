// Warp-level tensor-core helpers of the scan kernels (sm_90a): mma.sync
// m16n8k16 with bf16 operands and f32 accumulation, ldmatrix, cp.async, the
// split of an f32 operand into bf16 hi + lo, and 2^x on the SFU.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (lane = 4 g + q):
//   A (16 x 16): a0 = (row g, cols 2q, 2q+1), a1 = (row g+8, the same cols),
//                a2 = (row g, cols 2q+8, 2q+9), a3 = (row g+8, cols 2q+8..)
//   B (16 x 8):  b0 = (rows 2q, 2q+1, col g), b1 = (rows 2q+8, 2q+9, col g)
//   D (16 x 8):  d0, d1 = (row g, cols 2q, 2q+1), d2, d3 = (row g+8, ...)
// so the accumulators of two neighbouring 16 x 8 tiles are, packed in
// pairs, the A fragment of one 16 x 16 tile (FlashAttention-2's reuse of P).
// A bf16x2 register holds the lower column (or row) in its low half.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a b, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the 16-byte rows of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// (a, b) ~ hi + lo with hi = bf16(x) and lo = bf16(x - hi): the pair keeps
// 16 significant bits, |x - hi - lo| <= 2^-16 |x| (bf16's exponent range is
// f32's, so neither part overflows where x does not).
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 fills zeros and
// reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// 2^x on the SFU (ex2.approx: about 2^-22 relative; a result below 2^-126
// flushes to 0, where the true factor is smaller still).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace
