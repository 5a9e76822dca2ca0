// y = A x for a row-major (m, k) ELL matrix.
//
// Replaces: src/repro/kernels/spmv_ell/kernel.py::spmv_ell (Pallas TPU).
//
// Bound: bytes.  Each call must read col_idx and values once (m*k*(4 + s)
// bytes for s-byte values), x (n*s) and write y (m*s); at 2 flops per stored
// entry the work is ~0.25 flop/byte, far below the card's ridge point.
//
// Design: two walks; the wrapper picks one from k (the tuning spec).
//
//   - Narrow rows (subgroup = 1, k <= 32; the spec takes it for k <= 16):
//     one thread a row, a warp's 32 rows staged in shared memory from
//     16-byte loads (`ell_rows_warp` in ell_rows.cuh, which spmv_dot.cu's
//     fused kernel runs too, so the two y agree bit for bit).
//   - Wider rows (the coarse AMG operators, k up to about 100): a subgroup
//     of SG lanes per row (`ell_row_dot`; the spec gives 8 lanes up to
//     k = 32 and a whole warp beyond), whose loads of col_idx and values
//     are coalesced along the row; the row sum is a __shfl_xor_sync
//     butterfly.
//
// x is gathered through the read-only path; the 50 MB L2 caches the gather
// (the TPU kept all of x in VMEM and fell back when it did not fit; here no
// size limit exists).  Each row is written by one lane and summed in an
// order fixed by the walk, so a call repeats bit for bit and the TPU grid's
// revisited-output accumulation is not needed.
#include "ell_rows.cuh"

namespace {

// Thread per row: warp w of block b takes the 32 rows from 32 (b W + w),
// W warps a block.
template <int KMAX, typename T>
__global__ void __launch_bounds__(kRowsWalkThreads)
    spmv_ell_rows_kernel(const int* __restrict__ cols,
                         const T* __restrict__ vals, const T* __restrict__ x,
                         T* __restrict__ y, long long m, int k, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) +
       threadIdx.x / kWarp) * kWarp;
  if (row0 >= m) return;  // uniform across the warp
  ell_rows_warp<KMAX>(cols, vals, x, y, m, k, vec, row0, smem_raw);
}

// A subgroup of SG lanes per row.
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

template <int KMAX, typename T>
int launch_rows(const int* cols, const T* vals, const T* x, T* y, long long m,
                int k, int block_threads, cudaStream_t stream) {
  const unsigned grid =
      static_cast<unsigned>((m + block_threads - 1) / block_threads);
  return launch_rows_walk<T>(spmv_ell_rows_kernel<KMAX, T>, grid,
                             block_threads, k, stream, cols, vals, x, y, m, k,
                             ell_rows_vec(cols, vals));
}

template <typename T>
int launch(const int* cols, const T* vals, const T* x, T* y, long long m, int k,
           int block_threads, int subgroup, cudaStream_t stream) {
  if (subgroup == 1) {
    if (k <= 4) return launch_rows<4>(cols, vals, x, y, m, k, block_threads, stream);
    if (k <= 8) return launch_rows<8>(cols, vals, x, y, m, k, block_threads, stream);
    if (k <= 16) return launch_rows<16>(cols, vals, x, y, m, k, block_threads, stream);
    if (k <= 32) return launch_rows<32>(cols, vals, x, y, m, k, block_threads, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows_per_block = block_threads / subgroup;
  const unsigned grid =
      static_cast<unsigned>((m + rows_per_block - 1) / rows_per_block);
  switch (subgroup) {
#define CASE(SG)                                                              \
  case SG:                                                                    \
    spmv_ell_kernel<SG, T><<<grid, block_threads, 0, stream>>>(cols, vals, x, \
                                                               y, m, k);      \
    break;
    CASE(2) CASE(4) CASE(8) CASE(16) CASE(32)
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
