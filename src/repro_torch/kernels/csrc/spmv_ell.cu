// y = A x for a row-major (m, k) ELL matrix.
//
// Replaces: src/repro/kernels/spmv_ell/kernel.py::spmv_ell (Pallas TPU).
//
// Bound: bytes.  Each call must read col_idx and values once (m*k*(4 + s)
// bytes for s-byte values), x (n*s) and write y (m*s); at 2 flops per stored
// entry the work is ~0.25 flop/byte, far below the card's ridge point.
//
// Design: one subgroup of SG lanes per row (SG = the power of two covering k,
// at most 32), so the lanes of a warp read SG consecutive entries of each of
// 32/SG consecutive rows: row-major rows are contiguous, so a warp's loads of
// col_idx and values are coalesced.  The row sum is a __shfl_xor_sync
// butterfly inside the subgroup.  x is gathered through the read-only path;
// there is no shared-memory staging of x (the TPU kept all of x in VMEM and
// fell back when it did not fit; here the 50 MB L2 caches the gather and no
// size limit exists).  Each row is written by one lane, so no block depends
// on another and the TPU grid's revisited-output accumulation is not needed.
#include "common.cuh"

namespace {

template <int SG, typename T>
__global__ void spmv_ell_kernel(const int* __restrict__ cols,
                                const T* __restrict__ vals,
                                const T* __restrict__ x, T* __restrict__ y,
                                long long m, int k) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / SG;
  if (row >= m) return;  // uniform across the subgroup
  const int lane = threadIdx.x & (SG - 1);
  const T sum = ell_row_dot<SG>(cols, vals, x, row, k, lane, subgroup_mask<SG>());
  if (lane == 0) y[row] = sum;
}

template <typename T>
int launch(const int* cols, const T* vals, const T* x, T* y, long long m, int k,
           int block_threads, int subgroup, cudaStream_t stream) {
  const long long rows_per_block = block_threads / subgroup;
  const unsigned grid =
      static_cast<unsigned>((m + rows_per_block - 1) / rows_per_block);
  switch (subgroup) {
#define CASE(SG)                                                              \
  case SG:                                                                    \
    spmv_ell_kernel<SG, T><<<grid, block_threads, 0, stream>>>(cols, vals, x, \
                                                               y, m, k);      \
    break;
    CASE(1) CASE(2) CASE(4) CASE(8) CASE(16) CASE(32)
#undef CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_spmv_ell_f32(const int* cols, const float* vals,
                                  const float* x, float* y, long long m, int k,
                                  int block_threads, int subgroup,
                                  void* stream) {
  return launch(cols, vals, x, y, m, k, block_threads, subgroup,
                static_cast<cudaStream_t>(stream));
}

extern "C" int repro_spmv_ell_f64(const int* cols, const double* vals,
                                  const double* x, double* y, long long m,
                                  int k, int block_threads, int subgroup,
                                  void* stream) {
  return launch(cols, vals, x, y, m, k, block_threads, subgroup,
                static_cast<cudaStream_t>(stream));
}
