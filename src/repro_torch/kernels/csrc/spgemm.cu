// The numeric passes of SpGEMM and of the sparse transpose.
//
// Replaces: src/repro/kernels/spgemm/kernel.py::spgemm_expand and
// ::csr_permute (Pallas TPU); spgemm_merge replaces the host merge of
// src/repro/sparse/ops.py::_coalesce_host (np.add.reduceat), which has no
// TPU kernel.
//
// spgemm_expand: out[t, q] = a_vals[t] * b_pad[idx[t, q]] over a row-major
// (T, K) gather map.  idx is +1-shifted into b_pad, whose slot 0 holds 0, so
// a padding slot (idx 0) gives exactly 0.  Bound: bytes.  One call must read
// idx (4TK bytes for int32) and a_vals (4T), write out (4TK), and gather the
// b_pad values the map reaches (at most 4(nnzB + 1) bytes); one flop per
// output element, far below the card's ridge point.
//
// Design: one thread per output element over the flat T*K range, with a
// 64-bit flat index (T*K passes 2^31 at full-size Galerkin products).  A
// warp's 32 threads read 32 consecutive idx entries and write 32 consecutive
// outputs, so both streams are coalesced; a_vals[t] is shared by the K
// threads of row t and comes through the read-only path (__ldg); b_pad is
// gathered through L2, and the entries of one row of B are contiguous, so
// neighbouring threads gather neighbouring values.  The TPU padded T and K up
// to block multiples and kept b_pad resident in VMEM (falling back to XLA
// when it did not fit); here the ragged tail is guarded and b_pad stays in
// device memory, so no size limit and no fallback exist.  The product is one
// f32 multiply, so the result is bitwise equal to a_vals[:, None] * b_pad[idx].
//
// csr_permute: out[t] = values[order[t]], the value shuffle of a transpose.
// Bound: bytes, 12 bytes per entry for f32 (order read, value gathered,
// output written; 16 for f64).  Design: a persistent grid of one wave (the
// occupancy API; fewer blocks where a pack a thread needs fewer),
// grid-stride over packs of 4 entries.  A thread loads kPermuteLoads packs
// of order as int4 (16-byte) loads, issues all of their gathers of values
// (through L2, which holds the gathered array), and only then stores each
// pack's 4 values as 16-byte vectors (one float4, or two double2).  order
// and out are streamed once, so their loads and stores are marked
// evict-first (__ldcs / __stcs) and leave L2 to the gathered values.  The
// kernel decides its edges from the pointers: a scalar head up to order's
// first 16-byte boundary and a scalar tail past the last whole pack; where
// out is not 16-byte aligned at that boundary (order and out offset
// differently), every entry takes the scalar route.  A copy of a value:
// bitwise equal to values[order].  4 packs in flight a thread instead of 2
// gained nothing on the H100 (0.0181 against 0.0183 ms at nnz =
// 2,619,476).
//
// spgemm_merge: out[s] = the sum of values[starts[s] .. starts[s + 1]) (the
// last run ends at nnz), the merge of a product's duplicate coordinates
// after its expansion is sorted by (row, column).  The sum is the one the
// host coalesce takes, numpy's np.add.reduceat: the run's first value plus
// the pairwise sum of the rest (fewer than 8 terms in order from -0.0; up to
// 128 in 8 strided accumulators combined as ((0+1)+(2+3))+((4+5)+(6+7)),
// then the remainder in order; longer runs split at half, rounded down to a
// multiple of 8, and the halves added), so the result is bitwise the host
// coalesce's, every run the same bits.  Bound: bytes (the values read once,
// the starts, the sums written); one thread a run, since a run holds a few
// terms (1 to about 30 on an AMG hierarchy).  Runs past 129 terms take an
// out-of-line walk with an explicit stack in place of numpy's recursion.
#include <cstdint>

#include "common.cuh"

namespace {

template <typename T>
__global__ void spgemm_expand_kernel(const T* __restrict__ a_vals,
                                     const int* __restrict__ idx,
                                     const T* __restrict__ b_pad,
                                     T* __restrict__ out, long long total,
                                     long long k) {
  const long long e =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  out[e] = __ldg(a_vals + e / k) * b_pad[idx[e]];
}

// packs of 4 entries a thread of csr_permute has in flight
constexpr int kPermuteLoads = 2;

// the 4 values of one pack, stored as 16-byte vectors
__device__ __forceinline__ void store_pack(float* dst, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store_pack(double* dst, const double (&v)[4]) {
  __stcs(reinterpret_cast<double2*>(dst), make_double2(v[0], v[1]));
  __stcs(reinterpret_cast<double2*>(dst) + 1, make_double2(v[2], v[3]));
}

template <typename T>
__global__ void csr_permute_kernel(const T* __restrict__ values,
                                   const int* __restrict__ order,
                                   T* __restrict__ out, long long nnz) {
  // entries before order's first 16-byte boundary; all of them when out is
  // not 16-byte aligned there (32-bit counts: the wrapper holds nnz < 2^31)
  const unsigned total = static_cast<unsigned>(nnz);
  unsigned head = static_cast<unsigned>(
      (16u - reinterpret_cast<uintptr_t>(order) % 16u) % 16u / 4u);
  if (head > total ||
      reinterpret_cast<uintptr_t>(out + head) % 16u != 0u)
    head = total;
  const unsigned packs = (total - head) / 4u;
  const unsigned stride = gridDim.x * blockDim.x;
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  const int4* op = reinterpret_cast<const int4*>(order + head);
  T* outp = out + head;
  for (unsigned base = t; base < packs; base += kPermuteLoads * stride) {
    int4 o[kPermuteLoads];
#pragma unroll
    for (int u = 0; u < kPermuteLoads; ++u) {
      const unsigned i = base + u * stride;
      if (i < packs) o[u] = __ldcs(op + i);
    }
    T v[kPermuteLoads][4];
#pragma unroll
    for (int u = 0; u < kPermuteLoads; ++u) {
      if (base + u * stride < packs) {
        v[u][0] = __ldg(values + o[u].x);
        v[u][1] = __ldg(values + o[u].y);
        v[u][2] = __ldg(values + o[u].z);
        v[u][3] = __ldg(values + o[u].w);
      }
    }
#pragma unroll
    for (int u = 0; u < kPermuteLoads; ++u) {
      const unsigned i = base + u * stride;
      if (i < packs) store_pack(outp + 4u * i, v[u]);
    }
  }
  // the scalar edges: the head, and the fewer than 4 entries past the packs
  const unsigned tail = head + 4u * packs;
  for (unsigned i = t; i < head; i += stride) out[i] = values[order[i]];
  if (t < total - tail) out[tail + t] = values[order[tail + t]];
}

// numpy's pairwise block: fewer than 8 terms in order from -0.0, else 8
// strided accumulators, their tree, then the remainder in order (n <= 128)
template <typename T>
__device__ __forceinline__ T pairwise_block(const T* __restrict__ a,
                                            long long n) {
  if (n < 8) {
    T res = T(-0.0);
    for (long long i = 0; i < n; ++i) res += a[i];
    return res;
  }
  T r[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = a[j];
  long long i = 8;
  for (; i < n - n % 8; i += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] += a[i + j];
  }
  T res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
  for (; i < n; ++i) res += a[i];
  return res;
}

// numpy's recursion (split at n / 2 rounded down to a multiple of 8, left
// sum plus right sum) walked on an explicit stack: stage 0 a range not yet
// entered, 1 its left half summed (in ret), 2 both halves summed
template <typename T>
__device__ __noinline__ T pairwise_long(const T* __restrict__ a, long long n) {
  constexpr int kDepth = 64;  // a run of n terms nests log2(n / 128) + 1
  long long off[kDepth], len[kDepth];
  T left[kDepth];
  unsigned char stage[kDepth];
  int sp = 0;
  off[0] = 0;
  len[0] = n;
  stage[0] = 0;
  T ret = T(0);
  for (;;) {
    const long long half = len[sp] / 2 - (len[sp] / 2) % 8;
    if (stage[sp] == 0 && len[sp] > 128) {
      stage[sp] = 1;
      off[sp + 1] = off[sp];
      len[sp + 1] = half;
      stage[sp + 1] = 0;
      ++sp;
      continue;
    }
    if (stage[sp] == 0) {
      ret = pairwise_block(a + off[sp], len[sp]);
    } else if (stage[sp] == 1) {
      left[sp] = ret;
      stage[sp] = 2;
      off[sp + 1] = off[sp] + half;
      len[sp + 1] = len[sp] - half;
      stage[sp + 1] = 0;
      ++sp;
      continue;
    } else {
      ret = left[sp] + ret;
    }
    if (sp == 0) return ret;
    --sp;
  }
}

template <typename T>
__global__ void spgemm_merge_kernel(const T* __restrict__ values,
                                    const long long* __restrict__ starts,
                                    T* __restrict__ out, long long runs,
                                    long long nnz) {
  const long long s =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= runs) return;
  const long long lo = starts[s];
  const long long n = (s + 1 < runs ? starts[s + 1] : nnz) - lo - 1;
  T sum = values[lo];
  if (n > 128)
    sum += pairwise_long(values + lo + 1, n);
  else if (n > 0)
    sum += pairwise_block(values + lo + 1, n);
  out[s] = sum;
}

unsigned grid_for(long long n, int block_threads) {
  return static_cast<unsigned>((n + block_threads - 1) / block_threads);
}

template <typename T>
int launch_expand(const T* a_vals, const int* idx, const T* b_pad, T* out,
                  long long t, long long k, int block_threads,
                  cudaStream_t stream) {
  const long long total = t * k;
  spgemm_expand_kernel<T><<<grid_for(total, block_threads), block_threads, 0,
                            stream>>>(a_vals, idx, b_pad, out, total, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_permute(const T* values, const int* order, T* out, long long nnz,
                   int block_threads, cudaStream_t stream) {
  const auto kernel = csr_permute_kernel<T>;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        block_threads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // one wave, or a pack a thread where that needs fewer blocks
  const long long need = (nnz / 4 + block_threads) / block_threads;
  const long long wave = static_cast<long long>(sms) * per_sm;
  const unsigned grid = static_cast<unsigned>(need < wave ? need : wave);
  kernel<<<grid, block_threads, 0, stream>>>(values, order, out, nnz);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_merge(const T* values, const long long* starts, T* out,
                 long long runs, long long nnz, int block_threads,
                 cudaStream_t stream) {
  spgemm_merge_kernel<T><<<grid_for(runs, block_threads), block_threads, 0,
                           stream>>>(values, starts, out, runs, nnz);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_spgemm_merge_f32(const float* values,
                                      const long long* starts, float* out,
                                      long long runs, long long nnz,
                                      int block_threads, void* stream) {
  return launch_merge(values, starts, out, runs, nnz, block_threads,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int repro_spgemm_merge_f64(const double* values,
                                      const long long* starts, double* out,
                                      long long runs, long long nnz,
                                      int block_threads, void* stream) {
  return launch_merge(values, starts, out, runs, nnz, block_threads,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int repro_spgemm_expand_f32(const float* a_vals, const int* idx,
                                       const float* b_pad, float* out,
                                       long long t, long long k,
                                       int block_threads, void* stream) {
  return launch_expand(a_vals, idx, b_pad, out, t, k, block_threads,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int repro_spgemm_expand_f64(const double* a_vals, const int* idx,
                                       const double* b_pad, double* out,
                                       long long t, long long k,
                                       int block_threads, void* stream) {
  return launch_expand(a_vals, idx, b_pad, out, t, k, block_threads,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int repro_csr_permute_f32(const float* values, const int* order,
                                     float* out, long long nnz,
                                     int block_threads, void* stream) {
  return launch_permute(values, order, out, nnz, block_threads,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int repro_csr_permute_f64(const double* values, const int* order,
                                     double* out, long long nnz,
                                     int block_threads, void* stream) {
  return launch_permute(values, order, out, nnz, block_threads,
                        static_cast<cudaStream_t>(stream));
}
