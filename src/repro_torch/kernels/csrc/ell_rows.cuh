// The thread-per-row walk of a row-major (m, k) ELL matrix, shared by
// spmv_ell.cu and spmv_dot.cu: both kernels compute y by this one function,
// so with the same walk their y agree bit for bit.
//
// Ginkgo's thread per row, on the row-major storage the port shares with the
// JAX package (a subgroup of 8 lanes a row would leave a lane idle at k = 7,
// cover only 4 rows a warp, pay a 3-step butterfly a row, store from one
// lane in 8 and keep one gather of x in flight a lane).  A warp owns 32
// consecutive rows, whose 32 k column indices and values are one contiguous
// span of each array: the warp reads both spans in coalesced 16-byte loads,
// all of a lane's loads in flight together, and stages them in shared memory
// (blocks of at most 256 threads), each row at an odd stride kp (k, or k + 1
// when k is even, so lane r reading entry j of row r meets no bank conflict;
// an odd k keeps the layout, and the 16-byte vectors are stored as they
// came).  Each lane then issues its row's k gathers of x at once (KMAX
// registers, the power of two covering k), sums the k products in index
// order and stores y[row]: the warp's 32 stores are one coalesced line.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarp = 32;

// Most threads a block of the walk has (its kernels' __launch_bounds__).
constexpr int kRowsWalkThreads = 256;

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

// Bytes of dynamic shared memory a block of `block_threads` needs: each
// thread's row of values, then as many column indices, at stride k | 1.
template <typename T>
size_t ell_rows_smem(int block_threads, int k) {
  return static_cast<size_t>(block_threads) * (k | 1) * (sizeof(T) + sizeof(int));
}

// Rows [row0, row0 + 32) (row0 < m) of y = A x by the calling warp; lane r
// stores y[row0 + r] and returns it (0 past m).  `smem` is the block's
// dynamic shared memory (ell_rows_smem bytes); the warp uses its own rows of
// it, so warps need no block barrier.  A lane issues all its loads of the
// warp's two spans (16-byte vectors when `vec`, i.e. both arrays 16-byte
// aligned, else single entries) before it stores any of them, so they are in
// flight together.  The caller puts a __syncwarp() between two calls that
// reuse the same rows of `smem`.
template <int KMAX, typename T>
__device__ __forceinline__ T ell_rows_warp(const int* __restrict__ cols,
                                           const T* __restrict__ vals,
                                           const T* __restrict__ x,
                                           T* __restrict__ y, long long m,
                                           int k, bool vec, long long row0,
                                           unsigned char* smem) {
  constexpr int kPerT = 16 / sizeof(T);
  constexpr int kVecC = (KMAX + 3) / 4;  // column vectors a lane, at most
  constexpr int kVecT = (KMAX + kPerT - 1) / kPerT;
  const int kp = k | 1;
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  T* sv = reinterpret_cast<T*>(smem) + warp * kWarp * kp;
  int* sc = reinterpret_cast<int*>(reinterpret_cast<T*>(smem) +
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
  T sum = T(0);
  if (lane < nrows) {
    const int* rc = sc + lane * kp;
    const T* rv = sv + lane * kp;
    T xv[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) xv[j] = __ldg(x + rc[j]);
    }
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) sum += rv[j] * xv[j];
    }
    y[row0 + lane] = sum;
  }
  return sum;
}

// Launches `kernel(args...)` over `grid` blocks of `block_threads` with the
// walk's dynamic shared memory (opting in above 48 KB); refuses more than
// kRowsWalkThreads threads a block.
template <typename T, typename Kernel, typename... Args>
int launch_rows_walk(Kernel kernel, unsigned grid, int block_threads, int k,
                     cudaStream_t stream, Args... args) {
  if (block_threads > kRowsWalkThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ell_rows_smem<T>(block_threads, k);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, block_threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Whether the walk may take 16-byte loads of both arrays.
inline bool ell_rows_vec(const void* cols, const void* vals) {
  return reinterpret_cast<uintptr_t>(cols) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(vals) % 16 == 0;
}

}  // namespace
