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
//
// Row-batched form, for the batched solvers' (nb, n) operands (the JAX
// package sends these to its XLA formulation): Z[b] = alpha[b] X[b] + Y[b]
// and one ||Z[b]||^2 per row.  Bound: bytes, as above, plus nb alphas and
// nb sums.  Each row is cut into `chunks` pieces, one block each (blocks
// numbered row-major), striding over its piece; a block reduces its threads'
// sums in a fixed tree.  With one chunk that sum is the row's; otherwise a
// second launch, one block per row, sums the row's partials in index order.
// No atomics, so a batched solve repeats bit for bit.
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

template <typename T>
__global__ void axpy_norm_rows_kernel(const T* __restrict__ alpha,
                                      const T* __restrict__ x,
                                      const T* __restrict__ y,
                                      T* __restrict__ z, T* __restrict__ out,
                                      long long n, int chunks) {
  const long long row = blockIdx.x / chunks;
  const int chunk = static_cast<int>(blockIdx.x - row * chunks);
  const T a = alpha[row];
  const long long base = row * n;
  const long long stride = static_cast<long long>(chunks) * blockDim.x;
  T acc = T(0);
  for (long long i = static_cast<long long>(chunk) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const T v = a * x[base + i] + y[base + i];
    z[base + i] = v;
    acc += v * v;
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

// One block per row: the row's `chunks` partials summed in a fixed order.
template <typename T>
__global__ void sum_row_partials_kernel(const T* __restrict__ partials,
                                        int chunks, T* __restrict__ ss) {
  const long long row = blockIdx.x;
  T acc = T(0);
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
    acc += partials[row * chunks + i];
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) ss[row] = acc;
}

template <typename T>
int launch_rows(const T* alpha, const T* x, const T* y, T* z, T* partials,
                T* ss, long long nb, long long n, int block_threads, int chunks,
                cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(nb * chunks);
  T* out = chunks == 1 ? ss : partials;
  axpy_norm_rows_kernel<T><<<grid, block_threads, 0, stream>>>(
      alpha, x, y, z, out, n, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  sum_row_partials_kernel<T><<<static_cast<unsigned>(nb), 32, 0, stream>>>(
      partials, chunks, ss);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_axpy_norm_rows_f32(const float* alpha, const float* x,
                                        const float* y, float* z,
                                        float* partials, float* ss,
                                        long long nb, long long n,
                                        int block_threads, int chunks,
                                        void* stream) {
  return launch_rows(alpha, x, y, z, partials, ss, nb, n, block_threads,
                     chunks, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_axpy_norm_rows_f64(const double* alpha, const double* x,
                                        const double* y, double* z,
                                        double* partials, double* ss,
                                        long long nb, long long n,
                                        int block_threads, int chunks,
                                        void* stream) {
  return launch_rows(alpha, x, y, z, partials, ss, nb, n, block_threads,
                     chunks, static_cast<cudaStream_t>(stream));
}

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
