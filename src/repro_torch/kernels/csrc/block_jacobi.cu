// y[b] = inv[b] v[b] for nb diagonal blocks of size bs (block-Jacobi apply).
//
// Replaces: src/repro/kernels/block_jacobi/kernel.py::block_jacobi_apply
// (Pallas TPU).
//
// Bound: bytes.  One call must read the inverted blocks (nb*bs*bs*s bytes in
// their storage type: 4 for f32, 2 for bf16/fp16), v (nb*bs*4) and write y
// (nb*bs*4); 2*bs flops per output element.  Reduced-precision storage
// halves the dominant term, which is the point of the adaptive selection.
//
// Design: one thread per output row.  Thread t computes row t % bs of block
// t / bs, reading that row of the block (bs contiguous values, up-cast to the
// vector's type with __bfloat162float / __half2float) and the block's bs-long
// segment of v, which the bs threads of the block share through L1.  A warp
// covers 32 consecutive rows, i.e. 32*bs contiguous storage values.  No
// shared memory and no cross-block state, so there is no budget to check and
// no fallback (the TPU binding fell back to XLA when a tile missed VMEM).
#include "common.cuh"

namespace {

__device__ __forceinline__ float upcast(float v) { return v; }
__device__ __forceinline__ float upcast(__half v) { return __half2float(v); }
__device__ __forceinline__ float upcast(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ double upcast(double v) { return v; }

template <typename T, typename S>
__global__ void block_jacobi_kernel(const S* __restrict__ inv,
                                    const T* __restrict__ v,
                                    T* __restrict__ y, long long rows, int bs) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= rows) return;
  const S* row = inv + t * bs;
  const T* seg = v + (t / bs) * bs;
  T acc = T(0);
  for (int j = 0; j < bs; ++j) acc += static_cast<T>(upcast(row[j])) * seg[j];
  y[t] = acc;
}

template <typename T, typename S>
int launch(const S* inv, const T* v, T* y, long long nb, int bs,
           int block_threads, cudaStream_t stream) {
  const long long rows = nb * bs;
  const unsigned grid =
      static_cast<unsigned>((rows + block_threads - 1) / block_threads);
  block_jacobi_kernel<T, S><<<grid, block_threads, 0, stream>>>(inv, v, y,
                                                                rows, bs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_block_jacobi_f32_f32(const float* inv, const float* v,
                                          float* y, long long nb, int bs,
                                          int block_threads, void* stream) {
  return launch(inv, v, y, nb, bs, block_threads,
                static_cast<cudaStream_t>(stream));
}

extern "C" int repro_block_jacobi_f32_bf16(const __nv_bfloat16* inv,
                                           const float* v, float* y,
                                           long long nb, int bs,
                                           int block_threads, void* stream) {
  return launch(inv, v, y, nb, bs, block_threads,
                static_cast<cudaStream_t>(stream));
}

extern "C" int repro_block_jacobi_f32_f16(const __half* inv, const float* v,
                                          float* y, long long nb, int bs,
                                          int block_threads, void* stream) {
  return launch(inv, v, y, nb, bs, block_threads,
                static_cast<cudaStream_t>(stream));
}

extern "C" int repro_block_jacobi_f64_f64(const double* inv, const double* v,
                                          double* y, long long nb, int bs,
                                          int block_threads, void* stream) {
  return launch(inv, v, y, nb, bs, block_threads,
                static_cast<cudaStream_t>(stream));
}
