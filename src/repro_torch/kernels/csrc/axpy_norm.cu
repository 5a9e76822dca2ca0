// (z, z.z) with z = alpha*x + y, in one pass over the vectors.
//
// Replaces: src/repro/kernels/axpy_norm/kernel.py::axpy_norm (Pallas TPU).
//
// Bound: bytes.  One call must read x and y (2*n*s bytes) and write z (n*s);
// 4 flops per element.  Fused, z is squared while it is still in a register
// instead of being read back by a separate norm launch.
//
// Design: one launch a call.  alpha is read on the device from a 0-d tensor,
// so a solver loop never waits on the host for it.  A persistent grid of one
// wave (the spec sets it from the SM count) walks the vectors in W-element
// packs (W = 16 / s, float4 or double2, where the wrapper finds x, y and z
// 16-byte aligned; W = 1, single elements, otherwise), neighbouring threads
// on neighbouring packs.  Each thread issues all its loads of x and y for a
// pass (kLoads packs of each) before it stores any z, so the loads are in
// flight together, and squares each z while it is in a register.  The
// n mod W elements past the last whole pack are a scalar tail of the same
// launch.  Each block reduces its threads' z.z in a fixed tree, and the
// block that finishes last sums the blocks' partials in a fixed tree
// (`finish_sum`, common.cuh): the result is the same bits on every run.  The
// TPU kernel instead added into one revisited scalar, which needs an ordered
// grid.
//
// Row-batched form, for the batched solvers' (nb, n) operands (the JAX
// package sends these to its XLA formulation): Z[b] = alpha[b] X[b] + Y[b]
// and one ||Z[b]||^2 per row.  Bound: bytes, as above, plus nb alphas and
// nb sums.  Each row is cut into `chunks` contiguous pieces (a multiple of W
// long), one block each (blocks numbered row-major), walked in packs as
// above.  With one piece the block's sum is the row's; otherwise each row
// has its own ticket, and the row's last block sums the row's partials in a
// fixed tree.  The pack route needs n to be a multiple of W, so that every
// row starts aligned.
#include "common.cuh"

namespace {

// W elements of T moved by one load.
template <typename T, int W>
struct Pack;
template <>
struct Pack<float, 4> { using type = float4; };
template <>
struct Pack<double, 2> { using type = double2; };
template <>
struct Pack<float, 1> { using type = float; };
template <>
struct Pack<double, 1> { using type = double; };

// elements of T in 16 bytes: the pack route's W
template <typename T>
constexpr int kPack = 16 / static_cast<int>(sizeof(T));

// packs of x and of y a thread of the vector form loads before it stores
// (the row form's rows, 1,024 elements on the batched path, give a thread
// one pack: it loads one at a time)
template <int W>
constexpr int kLoads = W == 1 ? 4 : 2;

// Both kernels keep to 32 registers a thread (__launch_bounds__(1024, 2)), so
// 2,048 threads of any block size sit on an SM and the grid of one wave is
// resident at once.
constexpr int kMaxThreads = 1024;
constexpr int kMinBlocks = 2;

// z = a x + y over the W elements of one pack; acc += z.z in element order.
template <int W, typename T, typename P>
__device__ __forceinline__ T axpy_pack(T a, const P& xp, const P& yp, P& zp,
                                       T acc) {
  const T* xe = reinterpret_cast<const T*>(&xp);
  const T* ye = reinterpret_cast<const T*>(&yp);
  T* ze = reinterpret_cast<T*>(&zp);
#pragma unroll
  for (int e = 0; e < W; ++e) {
    ze[e] = a * xe[e] + ye[e];
    acc += ze[e] * ze[e];
  }
  return acc;
}

// Packs t, t + stride, ... below np of x, y -> z; returns acc plus their z.z
// in that order.  32-bit pack indices (the wrapper holds n below 2^31) keep
// the kernels within their 32 registers without spills.
template <int W, int U, typename T>
__device__ __forceinline__ T axpy_packs(T a, const T* __restrict__ x,
                                        const T* __restrict__ y,
                                        T* __restrict__ z, unsigned np,
                                        unsigned t, unsigned stride, T acc) {
  using P = typename Pack<T, W>::type;
  const P* xp = reinterpret_cast<const P*>(x);
  const P* yp = reinterpret_cast<const P*>(y);
  P* zp = reinterpret_cast<P*>(z);
  for (unsigned base = t; base < np; base += U * stride) {
    P xv[U], yv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned i = base + u * stride;
      if (i < np) {
        xv[u] = __ldg(xp + i);
        yv[u] = __ldg(yp + i);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned i = base + u * stride;
      if (i < np) {
        P zv;
        acc = axpy_pack<W>(a, xv[u], yv[u], zv, acc);
        zp[i] = zv;
      }
    }
  }
  return acc;
}

template <int W, typename T>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    axpy_norm_kernel(const T* __restrict__ alpha,
                                 const T* __restrict__ x,
                                 const T* __restrict__ y, T* __restrict__ z,
                                 T* __restrict__ partials,
                                 unsigned* __restrict__ ticket,
                                 T* __restrict__ ss, long long n) {
  const T a = *alpha;
  const unsigned stride = gridDim.x * blockDim.x;
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned np = static_cast<unsigned>(n / W);
  T acc = axpy_packs<W, kLoads<W>>(a, x, y, z, np, t, stride, T(0));
  if (W > 1) {  // the tail past the last whole pack: fewer than W elements
    const long long i = static_cast<long long>(np) * W + t;
    if (i < n) {
      const T v = a * x[i] + y[i];
      z[i] = v;
      acc += v * v;
    }
  }
  acc = block_sum(acc);
  finish_sum(acc, partials, blockIdx.x, gridDim.x, ticket, ss);
}

template <int W, typename T>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    axpy_norm_rows_kernel(const T* __restrict__ alpha,
                                      const T* __restrict__ x,
                                      const T* __restrict__ y,
                                      T* __restrict__ z,
                                      T* __restrict__ partials,
                                      unsigned* __restrict__ tickets,
                                      T* __restrict__ ss, long long n,
                                      int chunks) {
  const unsigned row = blockIdx.x / chunks;
  const int chunk = static_cast<int>(blockIdx.x - row * chunks);
  const unsigned len = static_cast<unsigned>(n);
  const unsigned piece = ((len + chunks - 1) / chunks + W - 1) / W * W;
  const unsigned lo = min(len, chunk * piece);
  const unsigned hi = min(len, lo + piece);
  const long long base = static_cast<long long>(row) * len + lo;
  T acc = axpy_packs<W, 1>(alpha[row], x + base, y + base, z + base,
                           (hi - lo) / W, threadIdx.x, blockDim.x, T(0));
  acc = block_sum(acc);
  if (chunks == 1) {
    if (threadIdx.x == 0) ss[row] = acc;
    return;
  }
  finish_sum(acc, partials + row * chunks, chunk, chunks, tickets + row,
             ss + row);
}

template <typename T>
int launch(const T* alpha, const T* x, const T* y, T* z, T* partials,
           unsigned* ticket, T* ss, long long n, int block_threads, int grid,
           int width, cudaStream_t stream) {
  if (grid < 1 || n >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (width == 1) {
    axpy_norm_kernel<1, T><<<grid, block_threads, 0, stream>>>(
        alpha, x, y, z, partials, ticket, ss, n);
  } else if (width == kPack<T>) {
    axpy_norm_kernel<kPack<T>, T><<<grid, block_threads, 0, stream>>>(
        alpha, x, y, z, partials, ticket, ss, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(const T* alpha, const T* x, const T* y, T* z, T* partials,
                unsigned* tickets, T* ss, long long nb, long long n,
                int block_threads, int chunks, int width, cudaStream_t stream) {
  if (chunks < 1 || n >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(nb * chunks);
  if (width == 1) {
    axpy_norm_rows_kernel<1, T><<<grid, block_threads, 0, stream>>>(
        alpha, x, y, z, partials, tickets, ss, n, chunks);
  } else if (width == kPack<T> && n % width == 0) {
    axpy_norm_rows_kernel<kPack<T>, T>
        <<<grid, block_threads, 0, stream>>>(alpha, x, y, z, partials,
                                             tickets, ss, n, chunks);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_axpy_norm_rows_f32(const float* alpha, const float* x,
                                        const float* y, float* z,
                                        float* partials, unsigned* tickets,
                                        float* ss, long long nb, long long n,
                                        int block_threads, int chunks,
                                        int width, void* stream) {
  return launch_rows(alpha, x, y, z, partials, tickets, ss, nb, n,
                     block_threads, chunks, width,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int repro_axpy_norm_rows_f64(const double* alpha, const double* x,
                                        const double* y, double* z,
                                        double* partials, unsigned* tickets,
                                        double* ss, long long nb, long long n,
                                        int block_threads, int chunks,
                                        int width, void* stream) {
  return launch_rows(alpha, x, y, z, partials, tickets, ss, nb, n,
                     block_threads, chunks, width,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int repro_axpy_norm_f32(const float* alpha, const float* x,
                                   const float* y, float* z, float* partials,
                                   unsigned* ticket, float* ss, long long n,
                                   int block_threads, int grid, int width,
                                   void* stream) {
  return launch(alpha, x, y, z, partials, ticket, ss, n, block_threads, grid,
                width, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_axpy_norm_f64(const double* alpha, const double* x,
                                   const double* y, double* z,
                                   double* partials, unsigned* ticket,
                                   double* ss, long long n, int block_threads,
                                   int grid, int width, void* stream) {
  return launch(alpha, x, y, z, partials, ticket, ss, n, block_threads, grid,
                width, static_cast<cudaStream_t>(stream));
}
