// (y, w.y) = (A x, dot) for a row-major (m, k) ELL matrix, in one pass over A.
//
// Replaces: src/repro/kernels/spmv_dot/kernel.py::spmv_dot_ell (Pallas TPU).
//
// Bound: bytes.  One call must read col_idx and values (m*k*(4 + s) bytes),
// x (n*s) and w (m*s), and write y (m*s); the dot adds 2 flops per row.
// Fusing the dot saves re-reading y and w in a separate launch.
//
// Design: the row work is spmv_ell's (a subgroup per row, butterfly row
// sum).  Each subgroup takes ROWS rows, one block-width of rows apart, so a
// warp's loads stay coalesced and it has ROWS independent rows' loads in
// flight.  The TPU kernel added every tile's w.y into one revisited scalar,
// which relies on its grid running in order; blocks here run in no order.
// So the dot is a two-stage reduction: each block reduces its rows' w.y
// shares in a fixed tree and writes one partial; a second, single-block
// launch sums the partials in index order.  The result is deterministic (the
// same bits every run for the same inputs and geometry), so a CG solve
// repeats its iteration count exactly.  History on the H100: a grid capped
// at 8 blocks per SM with a grid stride ran in 1.3 waves (40 registers a
// thread leave room for 6 blocks) and took 2x spmv_ell; one row per subgroup
// left 65,536 partials, and the profiler put the single-block partial sums
// (with axpy_norm's) at 25 us per CG iteration.
#include "common.cuh"

namespace {

// rows per subgroup
constexpr int ROWS = 4;

// blocks of the row kernel for m rows, one partial each
long long num_blocks(long long m, int block_threads, int subgroup) {
  const long long rows_per_block =
      static_cast<long long>(block_threads) / subgroup * ROWS;
  return (m + rows_per_block - 1) / rows_per_block;
}

template <int SG, typename T>
__global__ void spmv_dot_ell_kernel(const int* __restrict__ cols,
                                    const T* __restrict__ vals,
                                    const T* __restrict__ x,
                                    const T* __restrict__ w, T* __restrict__ y,
                                    T* __restrict__ partials, long long m,
                                    int k) {
  const int lane = threadIdx.x & (SG - 1);
  const unsigned mask = subgroup_mask<SG>();
  const long long width = blockDim.x / SG;  // rows one pass of the block covers
  const long long first =
      static_cast<long long>(blockIdx.x) * width * ROWS + threadIdx.x / SG;
  T share = T(0);  // this subgroup's w.y, held by lane 0
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const long long row = first + r * width;
    if (row < m) {  // uniform across the subgroup; no return: block_sum below
      const T sum = ell_row_dot<SG>(cols, vals, x, row, k, lane, mask);
      if (lane == 0) {
        y[row] = sum;
        share += w[row] * sum;
      }
    }
  }
  share = block_sum(share);
  if (threadIdx.x == 0) partials[blockIdx.x] = share;
}

template <typename T>
int launch(const int* cols, const T* vals, const T* x, const T* w, T* y,
           T* partials, int num_partials, T* dot, long long m, int k,
           int block_threads, int subgroup, cudaStream_t stream) {
  if (subgroup < 1 || block_threads < subgroup ||
      num_blocks(m, block_threads, subgroup) != num_partials)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (subgroup) {
#define CASE(SG)                                                       \
  case SG:                                                             \
    spmv_dot_ell_kernel<SG, T><<<num_partials, block_threads, 0,       \
                                 stream>>>(                            \
        cols, vals, x, w, y, partials, m, k);                          \
    break;
    CASE(1) CASE(2) CASE(4) CASE(8) CASE(16) CASE(32)
#undef CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<T><<<1, 1024, 0, stream>>>(partials, num_partials, dot);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the partials buffer the entries below need: the wrapper sizes it with this
extern "C" int repro_spmv_dot_ell_partials(long long m, int block_threads,
                                           int subgroup) {
  return static_cast<int>(num_blocks(m, block_threads, subgroup));
}

extern "C" int repro_spmv_dot_ell_f32(const int* cols, const float* vals,
                                      const float* x, const float* w, float* y,
                                      float* partials, int num_partials,
                                      float* dot, long long m, int k,
                                      int block_threads, int subgroup,
                                      void* stream) {
  return launch(cols, vals, x, w, y, partials, num_partials, dot, m, k,
                block_threads, subgroup, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_spmv_dot_ell_f64(const int* cols, const double* vals,
                                      const double* x, const double* w,
                                      double* y, double* partials,
                                      int num_partials, double* dot,
                                      long long m, int k, int block_threads,
                                      int subgroup, void* stream) {
  return launch(cols, vals, x, w, y, partials, num_partials, dot, m, k,
                block_threads, subgroup, static_cast<cudaStream_t>(stream));
}
