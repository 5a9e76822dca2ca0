// Y[b] = A[b] X[b] for a batch of ELL matrices sharing one (m, k) col_idx.
//
// Replaces: src/repro/kernels/spmv_batch_ell/kernel.py::spmv_batch_ell
// (Pallas TPU).
//
// Bound: bytes.  Each call must read every system's values once
// (nb*m*k*s bytes for s-byte values), the shared col_idx (m*k*4), X
// (nb*n*s) and write Y (nb*m*s); 2 flops per stored entry.  The values
// dominate: the shared index block is read from L2 by every system.
//
// Design: one subgroup of SG lanes per (system, row) pair, SG a power of
// two chosen so that each lane takes a few entries (one thread per pair for
// narrow k, as in the batch's tridiagonal systems).  A 2-D grid: x runs over
// the rows of one system, neighbouring subgroups on neighbouring rows, so
// their values are contiguous and a warp's loads coalesce; y runs over the
// systems (striding by gridDim.y past 65,535), so no thread divides a 64-bit
// pair index.  Each lane carries its part of the row's k-sum in a register
// and a __shfl_xor_sync butterfly adds the lanes (common.cuh's ell_row_dot,
// given the system's values block).  The TPU kernel swept the grid
// (systems, row tiles, k tiles) in order, adding into the output tile
// across k tiles and keeping the shared column tile resident in VMEM; Hopper
// runs blocks in no order, so no output is revisited: each pair is summed by
// one subgroup and written once.  The ragged edge (the last rows, k not a
// multiple of SG) is masked by the row guard and the lane loop, with no
// padding of m or k.
#include "common.cuh"

namespace {

template <int SG, typename T>
__global__ void spmv_batch_ell_kernel(const int* __restrict__ cols,
                                      const T* __restrict__ vals,
                                      const T* __restrict__ x,
                                      T* __restrict__ y, long long nb,
                                      long long m, int k, long long n) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / SG;
  if (row >= m) return;  // uniform across the subgroup
  const int lane = threadIdx.x & (SG - 1);
  const unsigned mask = subgroup_mask<SG>();
  for (long long b = blockIdx.y; b < nb; b += gridDim.y) {
    // system b's values are an (m, k) block laid out as the shared col_idx
    const T sum =
        ell_row_dot<SG>(cols, vals + b * m * k, x + b * n, row, k, lane, mask);
    if (lane == 0) y[b * m + row] = sum;
  }
}

template <typename T>
int launch(const int* cols, const T* vals, const T* x, T* y, long long nb,
           long long m, int k, long long n, int block_threads, int subgroup,
           cudaStream_t stream) {
  const long long per_block = block_threads / subgroup;
  const dim3 grid(static_cast<unsigned>((m + per_block - 1) / per_block),
                  static_cast<unsigned>(nb < 65535 ? nb : 65535));
  switch (subgroup) {
#define CASE(SG)                                                            \
  case SG:                                                                  \
    spmv_batch_ell_kernel<SG, T><<<grid, block_threads, 0, stream>>>(       \
        cols, vals, x, y, nb, m, k, n);                                     \
    break;
    CASE(1) CASE(2) CASE(4) CASE(8) CASE(16) CASE(32)
#undef CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_spmv_batch_ell_f32(const int* cols, const float* vals,
                                        const float* x, float* y, long long nb,
                                        long long m, int k, long long n,
                                        int block_threads, int subgroup,
                                        void* stream) {
  return launch(cols, vals, x, y, nb, m, k, n, block_threads, subgroup,
                static_cast<cudaStream_t>(stream));
}

extern "C" int repro_spmv_batch_ell_f64(const int* cols, const double* vals,
                                        const double* x, double* y,
                                        long long nb, long long m, int k,
                                        long long n, int block_threads,
                                        int subgroup, void* stream) {
  return launch(cols, vals, x, y, nb, m, k, n, block_threads, subgroup,
                static_cast<cudaStream_t>(stream));
}
