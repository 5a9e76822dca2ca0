// (y, w.y) = (A x, dot) for a row-major (m, k) ELL matrix, in one pass over A.
//
// Replaces: src/repro/kernels/spmv_dot/kernel.py::spmv_dot_ell (Pallas TPU).
//
// Bound: bytes.  One call must read col_idx and values (m*k*(4 + s) bytes),
// x (n*s) and w (m*s), and write y (m*s); the dot adds 2 flops per row.
// Fusing the dot saves re-reading y and w in a separate launch.
//
// Design: one launch a call, with spmv_ell's two walks for y; the wrapper
// picks the walk from k (the tuning spec, as spmv_ell's).
//
//   - Narrow rows (subgroup = 1, k <= 32; the spec takes it for k <= 16):
//     the thread-per-row walk of ell_rows.cuh, the very function spmv_ell
//     runs, so y is spmv_ell's bit for bit.  Each lane then adds
//     w[row] y[row] to its share.  A persistent grid of one wave (the
//     blocks the SMs hold at once, from the occupancy API, or fewer where m
//     needs fewer) walks the warps' 32-row spans with a grid stride, so the
//     last block reads one
//     partial per resident block (660 at k = 7 in f32) rather than one per
//     256 rows (8,192 on the ELL path).  On the H100 the persistent grid
//     took 0.064 ms at k = 7 against 0.081 ms for a block per 256 rows.
//   - Wider rows: a subgroup of SG lanes per row (`ell_row_dot`), ROWS rows
//     a subgroup, one block-width of rows apart, so a warp's loads stay
//     coalesced and it has ROWS independent rows' loads in flight; lane 0 of
//     the subgroup forms the row's w.y share.
//
// The TPU kernel added every tile's w.y into one revisited scalar, which
// relies on its grid running in order; blocks here run in no order.  So each
// block reduces its w.y shares in a fixed tree into one partial, and the
// block that finishes last sums the partials in a fixed tree (`finish_sum`,
// common.cuh).  The result is the same bits every run for the same inputs
// and geometry, so a CG solve repeats its iteration count exactly.  History
// on the H100: the first kernel ran the subgroup walk at 8 lanes a row for
// k = 7 and summed the partials in a second, single-block launch after a
// fill of the result (three device operations a call, 0.118 ms); its grid
// capped at 8 blocks per SM with a grid stride ran in 1.3 waves at 40
// registers a thread and took 2x spmv_ell.
#include "ell_rows.cuh"

namespace {

// rows per subgroup of the subgroup walk
constexpr int ROWS = 4;

// Blocks of 256 threads the thread-per-row walk keeps on an SM: as many as
// spmv_ell's copy of the walk holds at its register count (ptxas: 32, 48,
// 64 and 126 registers for KMAX 4 to 32 in f32; 40, 54, 80 and 184 in f64).
// The fused kernel's loop and sum would take about twice those registers
// unbounded (102 at KMAX 8, f32), and half the blocks.  These are copied
// from the compiler's output: chip_smoke.py's build phase fails where this
// kernel gets fewer blocks an SM than spmv_ell_rows_kernel at the same KMAX
// and type, or spills past its stated limit.
template <int KMAX, typename T>
constexpr int kWalkBlocks =
    sizeof(T) == 4 ? (KMAX <= 4 ? 8 : KMAX <= 8 ? 5 : KMAX <= 16 ? 4 : 2)
                   : (KMAX <= 4 ? 6 : KMAX <= 8 ? 4 : KMAX <= 16 ? 3 : 1);

template <int KMAX, typename T>
__global__ void __launch_bounds__(kRowsWalkThreads, (kWalkBlocks<KMAX, T>))
    spmv_dot_ell_rows_kernel(const int* __restrict__ cols,
                             const T* __restrict__ vals,
                             const T* __restrict__ x, const T* __restrict__ w,
                             T* __restrict__ y, T* __restrict__ partials,
                             unsigned* __restrict__ ticket, T* __restrict__ dot,
                             long long m, int k, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & (kWarp - 1);
  const long long warps = blockDim.x / kWarp;
  T share = T(0);  // this lane's w.y, over its rows in walk order
#pragma unroll 1
  for (long long row0 = (blockIdx.x * warps + threadIdx.x / kWarp) * kWarp;
       row0 < m; row0 += gridDim.x * warps * kWarp) {
    const T sum = ell_rows_warp<KMAX>(cols, vals, x, y, m, k, vec, row0,
                                      smem_raw);
    if (row0 + lane < m) share += w[row0 + lane] * sum;
    __syncwarp();  // the next span reuses this warp's rows of shared memory
  }
  share = block_sum(share);
  finish_sum(share, partials, blockIdx.x, gridDim.x, ticket, dot);
}

// The thread-per-row kernel for k (KMAX the power of two covering it, up
// to 32), or null.
template <typename T>
auto rows_kernel(int k) -> decltype(&spmv_dot_ell_rows_kernel<4, T>) {
  if (k <= 4) return spmv_dot_ell_rows_kernel<4, T>;
  if (k <= 8) return spmv_dot_ell_rows_kernel<8, T>;
  if (k <= 16) return spmv_dot_ell_rows_kernel<16, T>;
  if (k <= 32) return spmv_dot_ell_rows_kernel<32, T>;
  return nullptr;
}

// Blocks of a launch, one partial each, or -1 for a geometry no kernel
// takes.  The thread-per-row walk (subgroup 1): a persistent grid of one
// wave (the blocks the SMs hold at once, from the occupancy API), never more
// than m needs at a row a thread.  The subgroup walk: block_threads /
// subgroup * ROWS rows a block.
template <typename T>
long long num_blocks(long long m, int k, int block_threads, int subgroup) {
  if (subgroup != 1) {
    const long long rows_per_block =
        static_cast<long long>(block_threads) / subgroup * ROWS;
    return (m + rows_per_block - 1) / rows_per_block;
  }
  const auto kernel = rows_kernel<T>(k);
  if (kernel == nullptr || block_threads > kRowsWalkThreads)
    return -1;
  const size_t smem = ell_rows_smem<T>(block_threads, k);
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return -1;
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    block_threads, smem) !=
          cudaSuccess)
    return -1;
  const long long blocks = (m + block_threads - 1) / block_threads;
  const long long wave = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  return blocks < wave ? blocks : wave;
}

template <int SG, typename T>
__global__ void spmv_dot_ell_kernel(const int* __restrict__ cols,
                                    const T* __restrict__ vals,
                                    const T* __restrict__ x,
                                    const T* __restrict__ w, T* __restrict__ y,
                                    T* __restrict__ partials,
                                    unsigned* __restrict__ ticket,
                                    T* __restrict__ dot, long long m, int k) {
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
  finish_sum(share, partials, blockIdx.x, gridDim.x, ticket, dot);
}

template <typename T>
int launch(const int* cols, const T* vals, const T* x, const T* w, T* y,
           T* partials, unsigned* ticket, int num_partials, T* dot,
           long long m, int k, int block_threads, int subgroup,
           cudaStream_t stream) {
  // the persistent walk covers m at any grid; the subgroup walk's grid is
  // fixed by its rows a block
  if (subgroup < 1 || block_threads < subgroup || num_partials < 1 ||
      (subgroup > 1 &&
       num_blocks<T>(m, k, block_threads, subgroup) != num_partials))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(num_partials);
  if (subgroup == 1)
    return launch_rows_walk<T>(rows_kernel<T>(k), grid, block_threads, k,
                               stream, cols, vals, x, w, y, partials, ticket,
                               dot, m, k, ell_rows_vec(cols, vals));
  switch (subgroup) {
#define CASE(SG)                                                           \
  case SG:                                                                 \
    spmv_dot_ell_kernel<SG, T><<<grid, block_threads, 0, stream>>>(        \
        cols, vals, x, w, y, partials, ticket, dot, m, k);                 \
    break;
    CASE(2) CASE(4) CASE(8) CASE(16) CASE(32)
#undef CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the partials the entries below need (-1 for a geometry no kernel takes):
// the wrapper sizes its workspace by it
extern "C" int repro_spmv_dot_ell_partials(long long m, int k,
                                           int block_threads, int subgroup,
                                           int itemsize) {
  return static_cast<int>(
      itemsize == 8 ? num_blocks<double>(m, k, block_threads, subgroup)
                    : num_blocks<float>(m, k, block_threads, subgroup));
}

extern "C" int repro_spmv_dot_ell_f32(const int* cols, const float* vals,
                                      const float* x, const float* w, float* y,
                                      float* partials, unsigned* ticket,
                                      int num_partials, float* dot,
                                      long long m, int k, int block_threads,
                                      int subgroup, void* stream) {
  return launch(cols, vals, x, w, y, partials, ticket, num_partials, dot, m,
                k, block_threads, subgroup, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_spmv_dot_ell_f64(const int* cols, const double* vals,
                                      const double* x, const double* w,
                                      double* y, double* partials,
                                      unsigned* ticket, int num_partials,
                                      double* dot, long long m, int k,
                                      int block_threads, int subgroup,
                                      void* stream) {
  return launch(cols, vals, x, w, y, partials, ticket, num_partials, dot, m,
                k, block_threads, subgroup, static_cast<cudaStream_t>(stream));
}
