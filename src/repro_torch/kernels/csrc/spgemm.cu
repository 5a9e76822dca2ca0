// The numeric passes of SpGEMM and of the sparse transpose.
//
// Replaces: src/repro/kernels/spgemm/kernel.py::spgemm_expand and
// ::csr_permute (Pallas TPU).
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
// output written).  Design: one thread per entry; order and out are
// coalesced, the gather goes through L2.  A copy of a value: bitwise equal to
// values[order].
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

template <typename T>
__global__ void csr_permute_kernel(const T* __restrict__ values,
                                   const int* __restrict__ order,
                                   T* __restrict__ out, long long nnz) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= nnz) return;
  out[t] = values[order[t]];
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
  csr_permute_kernel<T><<<grid_for(nnz, block_threads), block_threads, 0,
                          stream>>>(values, order, out, nnz);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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
