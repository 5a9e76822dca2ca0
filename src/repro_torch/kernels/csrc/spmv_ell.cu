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
//     Ginkgo's thread per row, on the row-major storage the port shares
//     with the JAX package (a subgroup of 8 lanes a row would leave a lane
//     idle at k = 7, cover only 4 rows a warp, pay a 3-step butterfly a
//     row, store from one lane in 8 and keep one gather of x in flight a
//     lane).  A warp owns 32 consecutive rows, whose 32 k column indices
//     and values are one contiguous span of each array: the warp reads both
//     spans in coalesced 16-byte loads, all of a lane's loads in flight
//     together, and stages them in shared memory (blocks of at most 256
//     threads), each row at an odd stride kp (k, or k + 1 when k is even,
//     so lane r reading entry j of row r meets no bank conflict; an odd k
//     keeps the layout, and the 16-byte vectors are stored as they came).
//     Each lane then issues its row's k gathers of x at once (KMAX
//     registers, the power of two covering k), sums the k products in index
//     order and stores y[row]: the warp's 32 stores are one coalesced line.
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
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarp = 32;

// Entry e = r k + j of a warp's span goes to dst[r kp + j].
template <typename E>
__device__ __forceinline__ void put(E* dst, int e, int k, int kp, E v) {
  const int r = e / k;
  dst[r * kp + (e - r * k)] = v;
}

// Stores the 16-byte vectors lane + 32 q (q < NV, below nv) of a warp's span
// to shared memory: as they came when kp = k, else entry by entry.
template <int NV, typename E>
__device__ __forceinline__ void put_vectors(const uint4 (&buf)[NV], E* dst,
                                            int nv, int k, int kp, int lane) {
  constexpr int kPer = 16 / sizeof(E);
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    const int i = lane + q * kWarp;
    if (i >= nv) continue;
    if (kp == k) {
      reinterpret_cast<uint4*>(dst)[i] = buf[q];
    } else {
      const E* e = reinterpret_cast<const E*>(&buf[q]);
      int r = i * kPer / k;
      int j = i * kPer - r * k;
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        dst[r * kp + j] = e[t];
        if (++j == k) {
          j = 0;
          ++r;
        }
      }
    }
  }
}

// Thread per row.  Dynamic shared memory: blockDim.x * kp values, then as
// many column indices; warp w uses rows [32 w, 32 w + 32) of each.  A lane
// issues all its loads of the warp's two spans (16-byte vectors, or single
// entries where the spans are not aligned) before it stores any of them, so
// they are in flight together.
template <int KMAX, typename T>
__global__ void __launch_bounds__(256)
    spmv_ell_rows_kernel(const int* __restrict__ cols,
                         const T* __restrict__ vals, const T* __restrict__ x,
                         T* __restrict__ y, long long m, int k, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kPerT = 16 / sizeof(T);
  constexpr int kVecC = (KMAX + 3) / 4;  // column vectors a lane, at most
  constexpr int kVecT = (KMAX + kPerT - 1) / kPerT;
  const int kp = k | 1;
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) + warp) * kWarp;
  if (row0 >= m) return;  // uniform across the warp
  T* sv = reinterpret_cast<T*>(smem_raw) + warp * kWarp * kp;
  int* sc = reinterpret_cast<int*>(reinterpret_cast<T*>(smem_raw) +
                                   blockDim.x * kp) + warp * kWarp * kp;
  const int nrows = m - row0 < kWarp ? static_cast<int>(m - row0) : kWarp;
  const int n = nrows * k;  // entries of the span, at most 32 KMAX
  const int* cb = cols + row0 * k;
  const T* vb = vals + row0 * k;
  if (vec) {
    const int nvc = n / 4, nvt = n / kPerT;
    uint4 cbuf[kVecC], vbuf[kVecT];
#pragma unroll
    for (int q = 0; q < kVecC; ++q) {
      const int i = lane + q * kWarp;
      if (i < nvc) cbuf[q] = __ldg(reinterpret_cast<const uint4*>(cb) + i);
    }
#pragma unroll
    for (int q = 0; q < kVecT; ++q) {
      const int i = lane + q * kWarp;
      if (i < nvt) vbuf[q] = __ldg(reinterpret_cast<const uint4*>(vb) + i);
    }
    // the last span's entries past its whole vectors: fewer than 4
    const int tc = nvc * 4 + lane, tt = nvt * kPerT + lane;
    int ctail = 0;
    T vtail = T(0);
    if (tc < n) ctail = __ldg(cb + tc);
    if (tt < n) vtail = __ldg(vb + tt);
    put_vectors(cbuf, sc, nvc, k, kp, lane);
    put_vectors(vbuf, sv, nvt, k, kp, lane);
    if (tc < n) put(sc, tc, k, kp, ctail);
    if (tt < n) put(sv, tt, k, kp, vtail);
  } else {
    int cs[KMAX];
    T vs[KMAX];
#pragma unroll
    for (int q = 0; q < KMAX; ++q) {
      const int e = lane + q * kWarp;
      if (e < n) {
        cs[q] = __ldg(cb + e);
        vs[q] = __ldg(vb + e);
      }
    }
#pragma unroll
    for (int q = 0; q < KMAX; ++q) {
      const int e = lane + q * kWarp;
      if (e < n) {
        put(sc, e, k, kp, cs[q]);
        put(sv, e, k, kp, vs[q]);
      }
    }
  }
  __syncwarp();
  if (lane < nrows) {
    const int* rc = sc + lane * kp;
    const T* rv = sv + lane * kp;
    T xv[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) xv[j] = __ldg(x + rc[j]);
    }
    T sum = T(0);
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) sum += rv[j] * xv[j];
    }
    y[row0 + lane] = sum;
  }
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
  const auto kernel = spmv_ell_rows_kernel<KMAX, T>;
  const size_t smem =
      static_cast<size_t>(block_threads) * (k | 1) * (sizeof(T) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (block_threads > 256) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = reinterpret_cast<uintptr_t>(cols) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  const unsigned grid =
      static_cast<unsigned>((m + block_threads - 1) / block_threads);
  kernel<<<grid, block_threads, smem, stream>>>(cols, vals, x, y, m, k, vec);
  return static_cast<int>(cudaGetLastError());
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
