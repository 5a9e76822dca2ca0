// y = x * rsqrt(mean(x^2) + eps) * w over the last axis of x (rows, d).
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py::rmsnorm (Pallas TPU).
//
// Bound: bytes.  One call must read x once and write y once (2*rows*d*s
// bytes for s-byte elements) and read w (d*s_w); it does about 4 flops per
// element, far below the card's ridge point.
//
// Design: the TPU kernel kept a (block_rows, d) tile resident in VMEM and
// reduced it along lanes.  Here a team of `tpr` threads owns a row: one warp
// (several teams a block) for narrow rows, else the whole block.  Thread t of
// a team holds V 16-byte vectors of the row (8 bf16/fp16 or 4 f32; one
// element when d or the base is not aligned): vectors t, t + tpr, ...  The
// wrapper picks the smallest V in {1, 2, 4, 8} that keeps a row within a few
// warps (160 threads at the serving path's d = 5,120 and 2,560), so many
// teams are resident on an SM; a block has at most 256 threads (1,024 with
// single elements).  At these widths the time goes to memory latency, so:
//   - a thread's V vectors sit at the same columns in every row: it reads
//     their scale once, as 16-byte vectors, and keeps it in registers across
//     rows (a scalar load of w per element would cost 8 loads a vector of x);
//   - the grid is persistent (one full wave of resident blocks), a team
//     walks rows blockIdx.x * R + ty, + gridDim.x * R, ..., and issues the
//     next row's loads before it reduces, scales and stores the current one,
//     so the reduction, the barrier and the store run under the next row's
//     memory latency.  One barrier a row remains for tpr > 32; the warp
//     partials alternate between two shared buffers, so no second barrier
//     guards their reuse.
// The sum of squares is taken in f32 in a fixed tree: a thread's vectors in
// index order, a butterfly within each warp, then the warp partials in warp
// order (every thread adds them itself).  The order depends only on the
// geometry, not on the grid or the schedule, so a call repeats bit for bit,
// with no atomics.  x is read and y written with streaming (evict-first)
// accesses.  Row offsets are 64-bit.  The rows of x may sit `ldx` elements
// apart (ldx >= d: a view of wider rows, such as MLA's latent columns of the
// kv projection); y is written contiguous.
#include <cstdint>

#include "common.cuh"

namespace {

// VEC elements of T: one 16-byte vector, or one element.
template <typename T, int VEC>
struct alignas(VEC * sizeof(T)) Chunk {
  T e[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Chunk<T, VEC> load_chunk(const T* __restrict__ p) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(p));
    return *reinterpret_cast<const Chunk<T, VEC>*>(&raw);
  } else {
    Chunk<T, VEC> c;
#pragma unroll
    for (int k = 0; k < VEC; ++k) c.e[k] = p[k];
    return c;
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_chunk(T* __restrict__ p,
                                            const float* v) {
  Chunk<T, VEC> c;
#pragma unroll
  for (int k = 0; k < VEC; ++k) c.e[k] = from_f32<T>(v[k]);
  if constexpr (VEC * sizeof(T) == 16) {
    __stcs(reinterpret_cast<uint4*>(p), *reinterpret_cast<const uint4*>(&c));
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = c.e[k];
  }
}

// The scale of columns [j0, j0 + VEC) as f32, in 16-byte loads (through the
// read-only path: every block reads w) where VEC scale elements fill whole
// vectors and w is aligned.
template <typename TW, int VEC>
__device__ __forceinline__ void load_scale(const TW* __restrict__ w, int j0,
                                           bool aligned, float* out) {
  constexpr int kPer = 16 / sizeof(TW);  // scale elements in 16 bytes
  if constexpr (VEC % kPer == 0) {
    if (aligned) {
#pragma unroll
      for (int q = 0; q < VEC / kPer; ++q) {
        const uint4 raw =
            __ldg(reinterpret_cast<const uint4*>(w + j0 + q * kPer));
        const Chunk<TW, kPer> c = *reinterpret_cast<const Chunk<TW, kPer>*>(&raw);
#pragma unroll
        for (int k = 0; k < kPer; ++k) out[q * kPer + k] = to_f32(c.e[k]);
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) out[k] = to_f32(w[j0 + k]);
}

// Threads a block may have: 256 with 16-byte vectors (the scale of 8 vectors
// takes 64 registers), 1,024 with single elements.
template <int VEC>
constexpr int max_threads() {
  return VEC == 1 ? 1024 : 256;
}

// blockDim = (tpr, R): R teams of one warp each (tpr = 32), or one team of
// the whole block (R = 1).  V vectors of VEC elements a thread.
template <typename T, typename TW, int VEC, int V>
__global__ void __launch_bounds__(max_threads<VEC>())
    rmsnorm_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                   T* __restrict__ y, long long rows, long long ldx, int d,
                   float eps, bool w_aligned) {
  __shared__ float partials[2][32];  // warp partials of the block's team
  const int tpr = blockDim.x;
  const int tx = threadIdx.x;
  const int nvec = d / VEC;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.y;
  long long row = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;

  Chunk<T, VEC> cur[V], nxt[V];
  // the first row's vectors are in flight while the scale is read
  if (row < rows) {
    const T* p = x + row * ldx;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int j = tx + i * tpr;
      if (j < nvec) cur[i] = load_chunk<T, VEC>(p + j * VEC);
    }
  }
  float ws[V][VEC];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int j = tx + i * tpr;
    if (j < nvec) load_scale<TW, VEC>(w, j * VEC, w_aligned, ws[i]);
  }

  int parity = 0;
  // uniform over a team: over the block when R = 1, over the warp else
  for (; row < rows; row += stride) {
    const long long next = row + stride;
    if (next < rows) {  // the next row's loads go out before this row's work
      const T* p = x + next * ldx;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int j = tx + i * tpr;
        if (j < nvec) nxt[i] = load_chunk<T, VEC>(p + j * VEC);
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (tx + i * tpr < nvec) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float v = to_f32(cur[i].e[k]);
          ss += v * v;
        }
      }
    }
    ss = subgroup_sum<32>(ss, 0xffffffffu);
    if (tpr > 32) {
      if ((tx & 31) == 0) partials[parity][tx >> 5] = ss;
      __syncthreads();
      ss = 0.f;
      for (int q = 0; q < (tpr >> 5); ++q) ss += partials[parity][q];
      parity ^= 1;
    }
    const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
    T* q = y + row * static_cast<long long>(d);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int j = tx + i * tpr;
      if (j < nvec) {
        float o[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          o[k] = to_f32(cur[i].e[k]) * inv * ws[i][k];
        }
        store_chunk<T, VEC>(q + j * VEC, o);
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) cur[i] = nxt[i];
  }
}

template <typename T, typename TW, int VEC, int V>
int launch_v(const T* x, const TW* w, T* y, long long rows, long long ldx,
             int d, float eps, bool w_aligned, int tpr, int rows_per_block,
             cudaStream_t stream) {
  const auto kernel = rmsnorm_kernel<T, TW, VEC, V>;
  const int threads = tpr * rows_per_block;
  if (tpr % 32 != 0 || rows_per_block < 1 || threads > max_threads<VEC>() ||
      (tpr > 32 && rows_per_block != 1) || ldx < d || ldx % VEC != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, sms = 0, fit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, threads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident = static_cast<long long>(sms) * fit;
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  const unsigned grid =
      static_cast<unsigned>(blocks < resident ? blocks : resident);
  kernel<<<grid, dim3(tpr, rows_per_block), 0, stream>>>(x, w, y, rows, ldx,
                                                         d, eps, w_aligned);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TW, int VEC>
int launch_vec(const T* x, const TW* w, T* y, long long rows, long long ldx,
               int d, float eps, bool w_aligned, int vec_per_thread, int tpr,
               int rows_per_block, cudaStream_t stream) {
  switch (vec_per_thread) {
#define CASE(V)                                                           \
  case V:                                                                 \
    return launch_v<T, TW, VEC, V>(x, w, y, rows, ldx, d, eps, w_aligned, \
                                   tpr, rows_per_block, stream);
    CASE(1) CASE(2) CASE(4) CASE(8)
#undef CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename TW>
int launch(const T* x, const TW* w, T* y, long long rows, long long ldx, int d,
           float eps, int vectorized, int vec_per_thread, int tpr,
           int rows_per_block, cudaStream_t stream) {
  const bool w_aligned = reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (vectorized) {
    return launch_vec<T, TW, 16 / sizeof(T)>(x, w, y, rows, ldx, d, eps,
                                             w_aligned, vec_per_thread, tpr,
                                             rows_per_block, stream);
  }
  return launch_vec<T, TW, 1>(x, w, y, rows, ldx, d, eps, w_aligned,
                              vec_per_thread, tpr, rows_per_block, stream);
}

}  // namespace

#define REPRO_RMSNORM_ENTRY(NAME, T, TW)                                    \
  extern "C" int NAME(const void* x, const void* w, void* y,                \
                      long long rows, long long ldx, int d, float eps,      \
                      int vectorized, int vec_per_thread, int tpr,          \
                      int rows_per_block, void* stream) {                   \
    return launch(static_cast<const T*>(x), static_cast<const TW*>(w),      \
                  static_cast<T*>(y), rows, ldx, d, eps, vectorized,        \
                  vec_per_thread, tpr, rows_per_block,                      \
                  static_cast<cudaStream_t>(stream));                       \
  }

REPRO_RMSNORM_ENTRY(repro_rmsnorm_f32_f32, float, float)
REPRO_RMSNORM_ENTRY(repro_rmsnorm_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
REPRO_RMSNORM_ENTRY(repro_rmsnorm_bf16_f32, __nv_bfloat16, float)
REPRO_RMSNORM_ENTRY(repro_rmsnorm_f16_f16, __half, __half)
REPRO_RMSNORM_ENTRY(repro_rmsnorm_f16_f32, __half, float)
