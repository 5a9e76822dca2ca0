// y = A x for a SELL-P matrix (slices of C rows, column-major in a slice).
//
// Replaces: src/repro/kernels/spmv_sellp/kernel.py::spmv_sellp (Pallas TPU).
//
// Bound: bytes.  Each call must read the stored entries once (total*(4 + s)
// bytes for s-byte values: padding included, the kernel streams it),
// slice_sets, x (n*s) and write y (m*s); at 2 flops per stored entry the work
// is ~0.25 flop/byte, far below the card's ridge point.
//
// Design: a block owns blockDim/C consecutive slices and walks them in two
// steps.
//  * Narrow slices (at most `wide_cols` columns): one thread per row.  The
//    thread of row i = s*C + r walks exactly the slice's width, entry j at
//    slice_sets[s]*C + j*C + r, so the C threads of one slice read C
//    consecutive entries of each column: one coalesced segment per column.
//    The TPU kernel ran a (slices, max blocks) grid, switched off the blocks
//    past a slice's width and clamped their loads into the next slice; here a
//    thread's loop simply stops at its slice's width, and the only guard is
//    row < m.  With C = 8 a warp spans four slices and runs as long as the
//    widest of them.
//  * Wide slices (a power-law matrix's hub rows: one thread's serial walk of
//    thousands of columns would be the whole kernel's time): the whole block,
//    one slice at a time.  Thread t takes row t % C and every G-th column from
//    column t / C (G = blockDim/C groups), so a warp still reads consecutive
//    entries; the G partials of each row are then added in group order from
//    shared memory.  The order is fixed by the geometry, with no atomics, so
//    a solve repeats bit for bit.
// The offset slice_sets[s]*C is taken in 64 bits (the flat buffer passes 2^31
// entries before the column count does).  x is gathered through the
// read-only path; there is no staging and no size limit (the TPU kept x in
// VMEM).
#include "common.cuh"

namespace {

template <typename T>
__global__ void spmv_sellp_kernel(const int* __restrict__ cols,
                                  const T* __restrict__ vals,
                                  const int* __restrict__ slice_sets,
                                  const T* __restrict__ x, T* __restrict__ y,
                                  long long m, int C, int wide_cols) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* part = reinterpret_cast<T*>(smem_raw);  // groups * C partials
  const int bt = blockDim.x;
  const int groups = bt / C;  // below 2: every slice is walked per row
  const int per_block = groups > 1 ? groups : 1;  // slices of this block
  const long long num_slices = (m + C - 1) / C;
  const long long s0 = static_cast<long long>(blockIdx.x) * per_block;

  for (int t = threadIdx.x; t < per_block * C; t += bt) {
    const long long row = s0 * C + t;
    if (row >= m) break;
    const long long s = s0 + t / C;
    const int lo = slice_sets[s];
    const int width = slice_sets[s + 1] - lo;
    if (groups > 1 && width > wide_cols) continue;
    const long long base = static_cast<long long>(lo) * C + t % C;
    T sum = T(0);
    for (int j = 0; j < width; ++j) {
      const long long e = base + static_cast<long long>(j) * C;
      sum += vals[e] * x[cols[e]];
    }
    y[row] = sum;
  }
  if (groups < 2) return;

  const int g = threadIdx.x / C;
  const int r = threadIdx.x - g * C;
  for (int i = 0; i < per_block && s0 + i < num_slices; ++i) {
    const long long s = s0 + i;
    const int lo = slice_sets[s];
    const int width = slice_sets[s + 1] - lo;  // uniform over the block
    if (width <= wide_cols) continue;
    if (g < groups) {
      const long long base = static_cast<long long>(lo) * C + r;
      T sum = T(0);
      for (int j = g; j < width; j += groups) {
        const long long e = base + static_cast<long long>(j) * C;
        sum += vals[e] * x[cols[e]];
      }
      part[threadIdx.x] = sum;
    }
    __syncthreads();
    if (threadIdx.x < C && s * C + threadIdx.x < m) {
      T acc = T(0);
      for (int q = 0; q < groups; ++q) acc += part[q * C + threadIdx.x];
      y[s * C + threadIdx.x] = acc;
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const int* cols, const T* vals, const int* slice_sets, const T* x,
           T* y, long long m, int C, int block_threads, int wide_cols,
           cudaStream_t stream) {
  const int groups = block_threads / C;
  const long long per_block = groups > 1 ? groups : 1;
  const long long num_slices = (m + C - 1) / C;
  const unsigned grid =
      static_cast<unsigned>((num_slices + per_block - 1) / per_block);
  const size_t smem = groups > 1 ? groups * C * sizeof(T) : 0;
  spmv_sellp_kernel<T><<<grid, block_threads, smem, stream>>>(
      cols, vals, slice_sets, x, y, m, C, wide_cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_spmv_sellp_f32(const int* cols, const float* vals,
                                    const int* slice_sets, const float* x,
                                    float* y, long long m, int C,
                                    int block_threads, int wide_cols,
                                    void* stream) {
  return launch(cols, vals, slice_sets, x, y, m, C, block_threads, wide_cols,
                static_cast<cudaStream_t>(stream));
}

extern "C" int repro_spmv_sellp_f64(const int* cols, const double* vals,
                                    const int* slice_sets, const double* x,
                                    double* y, long long m, int C,
                                    int block_threads, int wide_cols,
                                    void* stream) {
  return launch(cols, vals, slice_sets, x, y, m, C, block_threads, wide_cols,
                static_cast<cudaStream_t>(stream));
}
