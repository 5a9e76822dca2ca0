// (z, z.z) with z = alpha*x + y, in one pass over the vectors.
//
// Replaces: src/repro/kernels/axpy_norm/kernel.py::axpy_norm (Pallas TPU).
//
// Bound: bytes.  One call must read x and y (2*n*s bytes) and write z (n*s);
// 4 flops per element.  Fused, z is squared while it is still in a register
// instead of being read back by a separate norm launch.
//
// Design: alpha is read on the device from a 0-d tensor, so a solver loop
// never waits on the host for it.  A fixed grid of blocks walks the vectors
// with a grid stride (neighbouring threads on neighbouring elements); each
// block reduces its threads' z.z in a fixed tree into one partial, and a
// second single-block launch sums the partials in index order.  The TPU
// kernel instead added into one revisited scalar, which needs an ordered
// grid; the two-stage form is deterministic without one.
#include "common.cuh"

namespace {

template <typename T>
__global__ void axpy_norm_kernel(const T* __restrict__ alpha,
                                 const T* __restrict__ x,
                                 const T* __restrict__ y, T* __restrict__ z,
                                 T* __restrict__ partials, long long n) {
  const T a = *alpha;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  T acc = T(0);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const T v = a * x[i] + y[i];
    z[i] = v;
    acc += v * v;
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

template <typename T>
int launch(const T* alpha, const T* x, const T* y, T* z, T* partials, T* ss,
           long long n, int block_threads, int grid, cudaStream_t stream) {
  axpy_norm_kernel<T><<<grid, block_threads, 0, stream>>>(alpha, x, y, z,
                                                          partials, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<T><<<1, block_threads, 0, stream>>>(partials, grid, ss);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_axpy_norm_f32(const float* alpha, const float* x,
                                   const float* y, float* z, float* partials,
                                   float* ss, long long n, int block_threads,
                                   int grid, void* stream) {
  return launch(alpha, x, y, z, partials, ss, n, block_threads, grid,
                static_cast<cudaStream_t>(stream));
}

extern "C" int repro_axpy_norm_f64(const double* alpha, const double* x,
                                   const double* y, double* z,
                                   double* partials, double* ss, long long n,
                                   int block_threads, int grid, void* stream) {
  return launch(alpha, x, y, z, partials, ss, n, block_threads, grid,
                static_cast<cudaStream_t>(stream));
}
