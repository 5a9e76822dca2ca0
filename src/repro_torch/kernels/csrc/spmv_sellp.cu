// y = A x for a SELL-P matrix (slices of C rows, column-major in a slice).
//
// Replaces: src/repro/kernels/spmv_sellp/kernel.py::spmv_sellp (Pallas TPU).
//
// Bound: bytes.  Each call must read the stored entries once (total*(4 + s)
// bytes for s-byte values: padding included, the kernel streams it),
// slice_sets, x (n*s) and write y (m*s); at 2 flops per stored entry the work
// is ~0.25 flop/byte, far below the card's ridge point.  What keeps a kernel
// from that bound is how many loads it has in flight: most slices of the
// power-law path matrix are 8 columns (two warp steps), so a slice's walk is
// short and its latency is hidden only by many warps; and a hub slice
// (11,160 columns) is one long walk that must start early.
//
// Design: a persistent grid, one full wave of blocks (as many as the SMs
// hold at once); block b owns the chunks of blockDim/32 slices (a thread-
// per-row walk: blockDim/C) b, b + gridDim, ...
//  * Wide slices first (more than `wide_cols` columns: a power-law matrix's
//    hub rows, where one warp's walk would be the whole kernel's time).  The
//    block finds its wide slices a round of blockDim slices at a time (one
//    ballot a warp) and walks each with the whole block: thread t takes row
//    t % C and every G-th column from column t / C (G = blockDim/C groups),
//    so the block reads blockDim consecutive entries a step (C dividing
//    blockDim), sixteen steps loaded before any x is gathered; the G
//    partials of each row are then added in group order from shared memory.
//    Every block starts at once, so the hubs start at once.
//  * Then the narrow slices, chosen statically by geometry (`warp_walk`):
//    - C dividing 32 (the path's C = 8): a warp per slice, each warp walking
//      its chunks' slices without waiting for the others.  The 32/C lanes of
//      a row split its columns: lane l takes row l % C and columns l / C,
//      l / C + 32 / C, ...  A slice is column-major, so lane l reads entries
//      l, l + 32, l + 64, ... of the slice: every warp step reads 32
//      consecutive stored entries, one 128-byte line of values and one of
//      column indices, and the warp runs exactly as long as its own slice
//      (the one-thread-per-row walk it replaces ran a warp over four slices
//      as long as the widest).  Two steps are loaded before x is gathered.
//      The lanes' partials of a row are added by a butterfly of shuffles over
//      lane distances C, 2C, ..., 16.
//    - C not dividing 32 (the format allows any C): one thread per row, the
//      thread of row s*C + r walking entry slice_sets[s]*C + j*C + r for j
//      below the slice's width: the C threads of a slice read C consecutive
//      entries a column.
// Every order is fixed by the geometry, never by the grid's size or the
// schedule, with no atomics, so a solve repeats bit for bit.  The TPU kernel
// ran a (slices, max blocks) grid, switched off the blocks past a slice's
// width and clamped their loads into the next slice; here each walk stops at
// its slice's width, and the only guard is row < m.  The offset
// slice_sets[s]*C is taken in 64 bits (the flat buffer passes 2^31 entries
// before the column count does).  x is gathered through the read-only path;
// there is no staging and no size limit (the TPU kept x in VMEM).
#include "common.cuh"

namespace {

constexpr int kWarp = 32;
// steps whose loads are issued before any gather: a narrow slice of the
// path matrix is mostly 2 warp steps (8 columns of 8 rows), a wide one up to
// 175 block steps (11,160 columns at 512 threads)
constexpr int kNarrowUnroll = 2;
constexpr int kWideUnroll = 16;

// Sum of vals[base + e] * x[cols[base + e]] over e = lane, lane + stride,
// ... below n, U steps loaded at a time.
template <int U, typename T>
__device__ __forceinline__ T strided_dot(const int* __restrict__ cols,
                                         const T* __restrict__ vals,
                                         const T* __restrict__ x,
                                         long long base, long long n,
                                         int lane, int stride) {
  T sum = T(0);
  long long e = lane;
  for (; e + (U - 1) * stride < n; e += U * stride) {
    T v[U];
    int c[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      v[u] = vals[base + e + u * stride];
      c[u] = cols[base + e + u * stride];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) sum += v[u] * __ldg(x + c[u]);
  }
  for (; e < n; e += stride) sum += vals[base + e] * __ldg(x + cols[base + e]);
  return sum;
}

// The whole block walks wide slice s: thread (g, r) takes row r and entries
// g*C + r + groups*C*j, so the block reads blockDim consecutive entries a
// step (C dividing blockDim); the groups' partials of a row are then added
// in group order.  Every thread of the block must call it.
template <typename T>
__device__ void wide_slice(const int* __restrict__ cols,
                           const T* __restrict__ vals,
                           const int* __restrict__ slice_sets,
                           const T* __restrict__ x, T* __restrict__ y,
                           T* part, long long s, long long m, int C,
                           int groups) {
  const int g = threadIdx.x / C;
  const int r = threadIdx.x - g * C;
  const int lo = slice_sets[s];
  const int width = slice_sets[s + 1] - lo;
  if (g < groups) {
    part[threadIdx.x] = strided_dot<kWideUnroll>(
        cols, vals, x, static_cast<long long>(lo) * C + r,
        static_cast<long long>(width) * C - r, g * C, groups * C);
  }
  __syncthreads();
  if (threadIdx.x < C && s * C + threadIdx.x < m) {
    T acc = T(0);
    for (int q = 0; q < groups; ++q) acc += part[q * C + threadIdx.x];
    y[s * C + threadIdx.x] = acc;
  }
  __syncthreads();
}

// A persistent grid: block b owns the chunks of `per_block` slices b,
// b + gridDim.x, ...  It first walks its wide slices (found a round of
// blockDim slices at a time, one ballot a warp), then every warp (or
// thread, per row) walks the narrow slices of the block's chunks without
// waiting for the others.
template <typename T>
__global__ void __launch_bounds__(1024)
spmv_sellp_kernel(const int* __restrict__ cols, const T* __restrict__ vals,
                  const int* __restrict__ slice_sets, const T* __restrict__ x,
                  T* __restrict__ y, long long m, int C, int wide_cols) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* part = reinterpret_cast<T*>(smem_raw);  // groups * C partials
  __shared__ unsigned wide_mask[32];         // a round's wide slices, by warp
  const int bt = blockDim.x;
  const int groups = bt / C;  // below 2: no slice is walked by the block
  const bool warp_walk = kWarp % C == 0;
  const int per_block = warp_walk ? bt / kWarp : (groups > 1 ? groups : 1);
  const long long num_slices = (m + C - 1) / C;
  const long long chunks = (num_slices + per_block - 1) / per_block;
  const long long my_chunks =
      blockIdx.x < chunks ? (chunks - blockIdx.x + gridDim.x - 1) / gridDim.x
                          : 0;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  // the j-th slice of this block's chunks
  auto slice_of = [&](long long j) {
    return (blockIdx.x + (j / per_block) * gridDim.x) * per_block +
           j % per_block;
  };

  if (groups >= 2) {
    const long long my_slices = my_chunks * per_block;
    for (long long j0 = 0; j0 < my_slices; j0 += bt) {
      const long long j = j0 + threadIdx.x;
      bool wide = false;
      if (j < my_slices) {
        const long long s = slice_of(j);
        wide = s < num_slices && slice_sets[s + 1] - slice_sets[s] > wide_cols;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, wide);
      if (lane == 0) wide_mask[warp] = mask;
      __syncthreads();
      for (int w = 0; w < bt / kWarp; ++w) {
        for (unsigned mm = wide_mask[w]; mm != 0; mm &= mm - 1) {
          const long long s = slice_of(j0 + w * kWarp + __ffs(mm) - 1);
          wide_slice(cols, vals, slice_sets, x, y, part, s, m, C, groups);
        }
      }
      __syncthreads();  // wide_mask is rewritten next round
    }
  }

  if (warp_walk) {
    // the warp's slices s, s + G, ... (G = gridDim.x * per_block) in a
    // three-stage pipeline: the bounds of the slice after next, the first
    // two steps' entries of the next, x gathered for the current
    const long long step_s = static_cast<long long>(gridDim.x) * per_block;
    auto bounds = [&](long long ss, int& lo, int& w) {
      lo = 0;
      w = 0;
      if (ss < num_slices) {
        lo = slice_sets[ss];
        w = slice_sets[ss + 1] - lo;
      }
    };
    auto narrow = [&](int w) { return groups < 2 || w <= wide_cols; };
    auto head = [&](int lo, int w, T (&v)[2], int (&c)[2]) {
      const long long n = narrow(w) ? static_cast<long long>(w) * C : 0;
      const long long base = static_cast<long long>(lo) * C;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const bool in = lane + u * kWarp < n;
        v[u] = in ? vals[base + lane + u * kWarp] : T(0);
        c[u] = in ? cols[base + lane + u * kWarp] : -1;
      }
    };
    long long s = static_cast<long long>(blockIdx.x) * per_block + warp;
    int lo0, w0, lo1, w1;
    bounds(s, lo0, w0);
    bounds(s + step_s, lo1, w1);
    T v0[2];
    int c0[2];
    head(lo0, w0, v0, c0);
    for (; s < num_slices; s += step_s) {
      int lo2, w2;
      bounds(s + 2 * step_s, lo2, w2);
      T v1[2];
      int c1[2];
      head(lo1, w1, v1, c1);
      if (narrow(w0)) {
        T sum = T(0);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (c0[u] >= 0) sum += v0[u] * __ldg(x + c0[u]);
        }
        const long long n = static_cast<long long>(w0) * C;
        if (n > 2 * kWarp) {
          sum += strided_dot<kNarrowUnroll>(
              cols, vals, x, static_cast<long long>(lo0) * C + 2 * kWarp,
              n - 2 * kWarp, lane, kWarp);
        }
        for (int off = kWarp / 2; off >= C; off >>= 1) {
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        }
        if (lane < C && s * C + lane < m) y[s * C + lane] = sum;
      }
      lo0 = lo1;
      w0 = w1;
      lo1 = lo2;
      w1 = w2;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        v0[u] = v1[u];
        c0[u] = c1[u];
      }
    }
    return;
  }
  for (long long k = 0; k < my_chunks; ++k) {
    const long long s0 = (blockIdx.x + k * gridDim.x) * per_block;
    for (int t = threadIdx.x; t < per_block * C; t += bt) {
      const long long row = s0 * C + t;
      if (row >= m) break;
      const long long s = s0 + t / C;
      const int lo = slice_sets[s];
      const int width = slice_sets[s + 1] - lo;
      if (groups >= 2 && width > wide_cols) continue;
      const long long base = static_cast<long long>(lo) * C + t % C;
      T sum = T(0);
      for (int jj = 0; jj < width; ++jj) {
        const long long e = base + static_cast<long long>(jj) * C;
        sum += vals[e] * __ldg(x + cols[e]);
      }
      y[row] = sum;
    }
  }
}

template <typename T>
int launch(const int* cols, const T* vals, const int* slice_sets, const T* x,
           T* y, long long m, int C, int block_threads, int wide_cols,
           cudaStream_t stream) {
  const int groups = block_threads / C;
  const long long per_block =
      kWarp % C == 0 ? block_threads / kWarp : (groups > 1 ? groups : 1);
  const long long num_slices = (m + C - 1) / C;
  const long long chunks = (num_slices + per_block - 1) / per_block;
  const size_t smem = groups > 1 ? groups * C * sizeof(T) : 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  int fit = 0;  // blocks an SM holds at once: the grid is one full wave
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fit, spmv_sellp_kernel<T>, block_threads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident = static_cast<long long>(sms) * fit;
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const unsigned grid = static_cast<unsigned>(chunks < resident ? chunks : resident);
  spmv_sellp_kernel<T><<<grid, block_threads, smem, stream>>>(
      cols, vals, slice_sets, x, y, m, C, wide_cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_spmv_sellp_f32(const int* cols, const float* vals,
                                    const int* slice_sets, const float* x,
                                    float* y, long long m, int C,
                                    int block_threads, int wide_cols,
                                    void* stream) {
  return launch(cols, vals, slice_sets, x, y, m, C, block_threads, wide_cols,
                static_cast<cudaStream_t>(stream));
}

extern "C" int repro_spmv_sellp_f64(const int* cols, const double* vals,
                                    const int* slice_sets, const double* x,
                                    double* y, long long m, int C,
                                    int block_threads, int wide_cols,
                                    void* stream) {
  return launch(cols, vals, slice_sets, x, y, m, C, block_threads, wide_cols,
                static_cast<cudaStream_t>(stream));
}
