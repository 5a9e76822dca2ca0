// The first design of csrc/block_jacobi.cu, kept as the yardstick that
// kernels/block_jacobi_probe.py and chip_smoke.py time the kernel against,
// and built by them alone, never into the port's library: one thread an
// output row (bs scalar loads of its row, the block's segment of v read by
// each of its bs threads), a grid of rows / block_threads blocks; f32
// vectors with f32, bf16 and fp16 blocks and f64 with f64, the pairs it had.
#include "common.cuh"

namespace {

__device__ __forceinline__ float upcast(float v) { return v; }
__device__ __forceinline__ float upcast(__half v) { return __half2float(v); }
__device__ __forceinline__ float upcast(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ double upcast(double v) { return v; }

template <typename T, typename S>
__global__ void rowwise_kernel(const S* __restrict__ inv,
                               const T* __restrict__ v, T* __restrict__ y,
                               long long rows, int bs) {
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
int rowwise(const S* inv, const T* v, T* y, long long nb, int bs,
            int block_threads, void* stream) {
  const long long rows = nb * bs;
  const unsigned grid =
      static_cast<unsigned>((rows + block_threads - 1) / block_threads);
  rowwise_kernel<T, S><<<grid, block_threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(inv, v, y, rows,
                                                              bs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ROWWISE(NAME, T, S)                                                    \
  extern "C" int NAME(const S* inv, const T* v, T* y, long long nb, int bs,    \
                      int block_threads, void* stream) {                       \
    return rowwise<T, S>(inv, v, y, nb, bs, block_threads, stream);            \
  }

ROWWISE(repro_bj_rowwise_f32_f32, float, float)
ROWWISE(repro_bj_rowwise_f32_bf16, float, __nv_bfloat16)
ROWWISE(repro_bj_rowwise_f32_f16, float, __half)
ROWWISE(repro_bj_rowwise_f64_f64, double, double)
