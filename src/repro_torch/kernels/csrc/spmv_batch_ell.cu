// Y[b] = A[b] X[b] for a batch of ELL matrices sharing one (m, k) col_idx.
//
// Replaces: src/repro/kernels/spmv_batch_ell/kernel.py::spmv_batch_ell
// (Pallas TPU).
//
// Bound: bytes.  Each call must read every system's values once
// (nb*m*k*s bytes for s-byte values), the shared col_idx (m*k*4), X
// (nb*n*s) and write Y (nb*m*s); 2 flops per stored entry.  The values
// dominate; the TPU kernel's point (its docstring) is that the shared index
// block is loaded once and kept, not re-read with every system.
//
// Design: two routes; the wrapper picks one from k and the value type (the
// tuning spec), never from nb.
//
//   - Narrow rows (subgroup = 1, k <= 32; the spec takes it for k <= 16,
//     the batched CG's tridiagonal k = 3): one thread a row, as spmv_ell's
//     narrow walk, but over S systems (kRowsSystems: 4 at k <= 4).  The
//     thread loads its row's k column indices once, into registers, then
//     issues every value load and every gather of x of its S rows before
//     it forms any product, and sums each row in index order.  A block per
//     (S systems, block_threads rows) pair, systems outer, so a warp's
//     loads of one entry are 32 rows of one system, k entries apart, which
//     L1 coalesces.  ell_rows.cuh's staged walk (16-byte span loads staged
//     in shared memory, then the gathers) ran this shape at 0.158 ms against
//     0.1229 for one thread a row of one system (H100): staging the values
//     puts their load and the gathers of x in series, two trips to memory
//     where this route needs one (the column indices stay in L1 and L2:
//     12 KB for all systems).
//     The loads are single entries (a row of k = 3 is 12 bytes), so there
//     is no vector edge.
//   - Wide rows (subgroup = G > 1; the spec takes it for k > 16, BiCGSTAB's
//     dense 64 x 64 systems): a persistent grid of one wave (occupancy API).
//     A row is cut into packs of W = 16 / s entries, and G lanes share a
//     row, lane j holding pack j (the spec's G covers the row's packs; a
//     warp a row, G = 32, holds up to kWidePacks packs a lane: j, j + 32,
//     ...).  Each thread has kWidePacks pack slots, fixed per row tile, so a
//     warp's load of one slot is 32 consecutive packs (512 contiguous bytes
//     when G is a row's packs) and a block's tile is blockDim / 32 warps of
//     kWidePacks / L passes of 32 / G rows (L = packs a lane takes of a
//     row).  The block walks the (tile, system) items w = blockIdx.x, +=
//     gridDim.x, tile-major, and for each:
//       * the column indices of its slots are loaded into registers when
//         the tile changes and kept for every system of that tile: the
//         TPU kernel's resident column tile, with no reads of shared memory;
//       * x[b] is staged in shared memory by cp.async (two buffers: the next
//         item's x is copied while this one is summed; past kWideXBytes the
//         gathers go to global memory instead);
//       * the next item's values are loaded into a second set of registers
//         (16-byte loads when the rows are 16-byte aligned, else single
//         entries) before this item's products are formed, so the HBM
//         stream does not wait on the arithmetic;
//       * each lane sums its entries in index order, a __shfl_xor_sync
//         butterfly adds the G lanes, and the warp's rows, which are
//         consecutive, are stored from consecutive lanes.
//     Rows of more than 32 kWidePacks packs (k > 512 in f32, 256 in f64)
//     take the long walk: a warp a (row, system) item, each lane walking
//     its packs j, j + 32, ... in groups of kWidePacks (column indices and
//     values of a group loaded together, then its gathers of x from global
//     memory), summing them in pack order into one accumulator across the
//     groups, then the same butterfly.  So a lane's first kWidePacks packs
//     are added as the tile kernel adds them, and the order stays a
//     function of k and the type alone.
//
// Summation order: a row's k products are added in an order that depends
// only on k, the type and the route (one thread in index order; or each
// lane's packs in index order, then the butterfly), never on nb, the grid
// or the chunk, so a batched solve advanced in chunks repeats the
// monolithic one bit for bit.  The TPU kernel swept (systems, row tiles,
// k tiles) in order and added into the revisited output tile; here no
// output is revisited: each row is summed by one thread or one subgroup
// and written once.
#include "ell_rows.cuh"  // kWarp, kRowsWalkThreads
#include "mma_sync.cuh"

namespace {

// pack slots a thread of the wide route holds; a row of at most 32
// kWidePacks packs (k <= 512 in f32, 256 in f64) takes the tile kernel,
// a longer one the long walk in groups of kWidePacks packs; 2 slots ran the
// BiCGSTAB shape no faster (11.20 against 11.36 us of kernel time, H100)
constexpr int kWidePacks = 4;
// most threads a block of the wide route has
constexpr int kWideThreads = 256;
// x is staged in shared memory (two buffers of n values) up to this size
constexpr size_t kWideXBytes = 48 * 1024;

// ---- narrow route --------------------------------------------------------

// Systems a thread of the narrow route walks: its row's column indices are
// loaded once, into registers, for all of them, and the S KMAX values and
// gathers of x are in flight together (16 a thread: on the H100 the CG
// shape, k = 3, took 0.1243 / 0.1201 / 0.1183 / 0.1203 ms at S = 1 / 2 / 4
// / 8; more registers at KMAX 16 and 32 spill).
template <int KMAX>
constexpr int kRowsSystems = KMAX <= 4 ? 4 : KMAX <= 8 ? 2 : 1;

template <int KMAX, typename T>
__global__ void __launch_bounds__(kRowsWalkThreads)
    spmv_batch_ell_rows_kernel(const int* __restrict__ cols,
                               const T* __restrict__ vals,
                               const T* __restrict__ x, T* __restrict__ y,
                               long long nb, long long m, int k, long long n,
                               unsigned row_blocks) {
  constexpr int S = kRowsSystems<KMAX>;
  const unsigned group = blockIdx.x / row_blocks;  // systems S g, ...
  const long long row =
      static_cast<long long>(blockIdx.x - group * row_blocks) * blockDim.x +
      threadIdx.x;
  if (row >= m) return;
  int c[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j)
    if (j < k) c[j] = __ldg(cols + row * k + j);
  // every load of the S systems' rows, then the sums in index order
  T v[S][KMAX], xv[S][KMAX];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const long long b = static_cast<long long>(group) * S + s;
    if (b < nb) {
      const T* vr = vals + (b * m + row) * k;
      const T* xb = x + b * n;
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j < k) {
          v[s][j] = __ldg(vr + j);
          xv[s][j] = __ldg(xb + c[j]);
        }
      }
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const long long b = static_cast<long long>(group) * S + s;
    T sum = T(0);
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < k) sum += v[s][j] * xv[s][j];
    if (b < nb) y[b * m + row] = sum;
  }
}

template <int KMAX, typename T>
int launch_rows(const int* cols, const T* vals, const T* x, T* y, long long nb,
                long long m, int k, long long n, int block_threads,
                cudaStream_t stream) {
  // one block a (S systems, block_threads rows) pair
  constexpr int S = kRowsSystems<KMAX>;
  const long long row_blocks = (m + block_threads - 1) / block_threads;
  const long long groups = (nb + S - 1) / S;
  if (block_threads > kRowsWalkThreads || groups * row_blocks >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  spmv_batch_ell_rows_kernel<KMAX, T>
      <<<static_cast<unsigned>(groups * row_blocks), block_threads, 0,
         stream>>>(cols, vals, x, y, nb, m, k, n,
                   static_cast<unsigned>(row_blocks));
  return static_cast<int>(cudaGetLastError());
}

// ---- wide route ----------------------------------------------------------

// one element global -> shared, asynchronously
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  if constexpr (sizeof(T) == 4) {
    cp_async4(dst, src, 4);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(smem_u32(dst)), "l"(src));
  }
}

// A thread of the wide route: lane j of subgroup `sub` holds, in its slot
// q = p L + i, pack j + i G of row p RPW + sub of its warp's RW consecutive
// rows of a tile (p < kWidePacks / L passes).
template <int G, int L, bool XS, typename T>
__global__ void __launch_bounds__(kWideThreads)
    spmv_batch_ell_wide_kernel(const int* __restrict__ cols,
                               const T* __restrict__ vals,
                               const T* __restrict__ x, T* __restrict__ y,
                               unsigned nb, unsigned items, int m, int k,
                               int n, bool vec) {
  constexpr int W = 16 / static_cast<int>(sizeof(T));
  constexpr int NP = kWidePacks;
  constexpr int RPW = kWarp / G;        // subgroups (rows at once) of a warp
  constexpr int PASSES = NP / L;        // rows of a subgroup in a tile
  constexpr int RW = PASSES * RPW;      // rows of a warp in a tile
  // stores a lane makes: the warp's RW rows, 32 at a time
  constexpr int kChunks = (RW + kWarp - 1) / kWarp;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sx = reinterpret_cast<T*>(smem_raw);  // XS: two buffers of n values
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int j = lane % G, sub = lane / G;
  const int R = static_cast<int>(blockDim.x / kWarp) * RW;  // rows a tile

  // slot q: row lr[q] of the tile (-1: unused), entries e0[q] .. + cnt[q]
  int lr[NP], e0[NP], cnt[NP];
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    e0[q] = (j + (q % L) * G) * W;
    const bool used = q / L < PASSES && e0[q] < k;
    lr[q] = used ? warp * RW + (q / L) * RPW + sub : -1;
    cnt[q] = used ? min(W, k - e0[q]) : 0;
  }

  // values of item (tile t, system b)'s slots into v (0 where a slot is
  // unused or its row lies past m)
  auto load_vals = [&](unsigned t, unsigned b, T (&v)[NP][W]) {
    const T* base = vals + static_cast<long long>(b) * m * k;
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int row = static_cast<int>(t) * R + lr[q];
      const bool live = lr[q] >= 0 && row < m;
      const T* src = base + static_cast<long long>(row) * k + e0[q];
      if (vec) {
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (live) u = __ldg(reinterpret_cast<const uint4*>(src));
        *reinterpret_cast<uint4*>(&v[q][0]) = u;
      } else {
#pragma unroll
        for (int e = 0; e < W; ++e)
          v[q][e] = live && e < cnt[q] ? __ldg(src + e) : T(0);
      }
    }
  };
  // x of system b into shared buffer `buf` (asynchronously)
  auto stage_x = [&](unsigned b, int buf) {
    if constexpr (XS) {
      const T* src = x + static_cast<long long>(b) * n;
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        cp_async_elem(sx + buf * n + i, src + i);
    }
  };

  unsigned w = blockIdx.x;
  if (w >= items) return;  // uniform across the block
  T va[NP][W], vb[NP][W];
  int c[NP][W];
  unsigned t = w / nb, b = w - t * nb;  // item w: tile-major
  unsigned tile = ~0u;
  int buf = 0;
  stage_x(b, 0);
  cp_async_commit();
  load_vals(t, b, va);
#pragma unroll 1
  for (; w < items; w += gridDim.x) {
    const unsigned wn = w + gridDim.x;
    const unsigned tn = wn / nb, bn = wn - tn * nb;
    __syncthreads();  // every thread is done with the buffer refilled below
    if (wn < items) {
      stage_x(bn, buf ^ 1);
      load_vals(tn, bn, vb);
    }
    cp_async_commit();
    if (t != tile) {  // uniform: the tile's column indices, kept in registers
      tile = t;
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        const int row = static_cast<int>(tile) * R + lr[q];
        const bool live = lr[q] >= 0 && row < m;
        const int* src = cols + static_cast<long long>(row) * k + e0[q];
#pragma unroll
        for (int e = 0; e < W; ++e)
          c[q][e] = live && e < cnt[q] ? __ldg(src + e) : 0;
      }
    }
    cp_async_wait<1>();
    __syncthreads();  // x of item w is in sx[buf] for every thread
    const T* xb = XS ? sx + buf * n : x + static_cast<long long>(b) * n;

    // each lane's share of a row, its entries in index order; the butterfly
    // on the row's last slot; lane l takes the warp's rows l, l + 32, ...
    T acc = T(0), out[kChunks];
#pragma unroll
    for (int h = 0; h < kChunks; ++h) out[h] = T(0);
#pragma unroll
    for (int q = 0; q < PASSES * L; ++q) {
      if (q % L == 0) acc = T(0);
#pragma unroll
      for (int e = 0; e < W; ++e)
        if (e < cnt[q]) acc += va[q][e] * xb[c[q][e]];
      if (q % L == L - 1) {
        const T sum = subgroup_sum<G>(acc, 0xffffffffu);
        const T got = __shfl_sync(0xffffffffu, sum, (lane % RPW) * G);
#pragma unroll
        for (int h = 0; h < kChunks; ++h)
          if ((h * kWarp + lane) / RPW == q / L) out[h] = got;
      }
    }
    const long long ybase = static_cast<long long>(b) * m;
#pragma unroll
    for (int h = 0; h < kChunks; ++h) {
      const int r = h * kWarp + lane;
      const int row = static_cast<int>(tile) * R + warp * RW + r;
      if (r < RW && row < m) y[ybase + row] = out[h];
    }

    if (wn < items) {
#pragma unroll
      for (int q = 0; q < NP; ++q)
#pragma unroll
        for (int e = 0; e < W; ++e) va[q][e] = vb[q][e];
    }
    t = tn;
    b = bn;
    buf ^= 1;
  }
}

template <int G, int L, bool XS, typename T>
int launch_wide_xs(const int* cols, const T* vals, const T* x, T* y,
                   long long nb, long long m, int k, long long n,
                   int block_threads, bool vec, cudaStream_t stream) {
  const auto kernel = spmv_batch_ell_wide_kernel<G, L, XS, T>;
  const size_t smem = XS ? 2 * static_cast<size_t>(n) * sizeof(T) : 0;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        block_threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // items: (tile, system) pairs, R = (block_threads / 32) (NP / L) (32 / G)
  // rows a tile
  const long long rows = static_cast<long long>(block_threads / kWarp) *
                         (kWidePacks / L) * (kWarp / G);
  const long long items = (m + rows - 1) / rows * nb;
  if (items >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const long long wave = static_cast<long long>(sms) * per_sm;
  const unsigned grid = static_cast<unsigned>(items < wave ? items : wave);
  kernel<<<grid, block_threads, smem, stream>>>(
      cols, vals, x, y, static_cast<unsigned>(nb),
      static_cast<unsigned>(items), static_cast<int>(m), k,
      static_cast<int>(n), vec);
  return static_cast<int>(cudaGetLastError());
}

template <int G, int L, typename T>
int launch_wide(const int* cols, const T* vals, const T* x, T* y, long long nb,
                long long m, int k, long long n, int block_threads, bool vec,
                cudaStream_t stream) {
  if (block_threads > kWideThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (2 * static_cast<size_t>(n) * sizeof(T) <= kWideXBytes)
    return launch_wide_xs<G, L, true>(cols, vals, x, y, nb, m, k, n,
                                      block_threads, vec, stream);
  return launch_wide_xs<G, L, false>(cols, vals, x, y, nb, m, k, n,
                                     block_threads, vec, stream);
}

// The long walk: warp `gw` of the grid takes the (row, system) items
// gw, gw + warps, ... (system-minor, so the warps of one row share its
// column indices in L1).  Lane j sums its packs j, j + 32, ... in order:
// kWidePacks at a time, each group's column indices and values loaded
// before its gathers of x; then the butterfly, and lane 0 stores the row.
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    spmv_batch_ell_long_kernel(const int* __restrict__ cols,
                               const T* __restrict__ vals,
                               const T* __restrict__ x, T* __restrict__ y,
                               long long nb, long long m, int k, long long n,
                               bool vec) {
  constexpr int W = 16 / static_cast<int>(sizeof(T));
  constexpr int NP = kWidePacks;
  const int lane = threadIdx.x & (kWarp - 1);
  const long long warps =
      static_cast<long long>(gridDim.x) * (blockDim.x / kWarp);
  const long long items = m * nb;
  const int packs = (k + W - 1) / W;
#pragma unroll 1
  for (long long w = static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) +
                     threadIdx.x / kWarp;
       w < items; w += warps) {
    const long long row = w / nb, b = w - row * nb;
    const int* crow = cols + row * k;
    const T* vrow = vals + (b * m + row) * k;
    const T* xb = x + b * n;
    T acc = T(0);
#pragma unroll 1
    for (int p0 = lane; p0 < packs; p0 += NP * kWarp) {
      T v[NP][W];
      int c[NP][W];
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int e0 = (p0 + i * kWarp) * W;
        const int cnt = e0 < k ? min(W, k - e0) : 0;
        if (vec && cnt == W) {
          *reinterpret_cast<uint4*>(&v[i][0]) =
              __ldg(reinterpret_cast<const uint4*>(vrow + e0));
        } else {
#pragma unroll
          for (int e = 0; e < W; ++e)
            v[i][e] = e < cnt ? __ldg(vrow + e0 + e) : T(0);
        }
#pragma unroll
        for (int e = 0; e < W; ++e) c[i][e] = e < cnt ? __ldg(crow + e0 + e) : -1;
      }
#pragma unroll
      for (int i = 0; i < NP; ++i)
#pragma unroll
        for (int e = 0; e < W; ++e)
          if (c[i][e] >= 0) acc += v[i][e] * __ldg(xb + c[i][e]);
    }
    const T sum = subgroup_sum<kWarp>(acc, 0xffffffffu);
    if (lane == 0) y[b * m + row] = sum;
  }
}

template <typename T>
int launch_long(const int* cols, const T* vals, const T* x, T* y, long long nb,
                long long m, int k, long long n, int block_threads, bool vec,
                cudaStream_t stream) {
  // a persistent grid of one wave (occupancy API), a warp an item
  const auto kernel = spmv_batch_ell_long_kernel<T>;
  if (block_threads > kWideThreads || block_threads % kWarp)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        block_threads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long per_block = block_threads / kWarp;
  const long long blocks = (m * nb + per_block - 1) / per_block;
  const long long wave = static_cast<long long>(sms) * per_sm;
  kernel<<<static_cast<unsigned>(blocks < wave ? blocks : wave), block_threads,
           0, stream>>>(cols, vals, x, y, nb, m, k, n, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const int* cols, const T* vals, const T* x, T* y, long long nb,
           long long m, int k, long long n, int block_threads, int subgroup,
           bool vec, cudaStream_t stream) {
  // packs of a row a lane of the wide route takes
  constexpr int W = 16 / static_cast<int>(sizeof(T));
  const int lane_packs = subgroup > 1 ? ((k + W - 1) / W + subgroup - 1) / subgroup : 0;
  switch (subgroup) {
    case 1:
      if (k <= 4) return launch_rows<4>(cols, vals, x, y, nb, m, k, n, block_threads, stream);
      if (k <= 8) return launch_rows<8>(cols, vals, x, y, nb, m, k, n, block_threads, stream);
      if (k <= 16) return launch_rows<16>(cols, vals, x, y, nb, m, k, n, block_threads, stream);
      if (k <= 32) return launch_rows<32>(cols, vals, x, y, nb, m, k, n, block_threads, stream);
      return static_cast<int>(cudaErrorInvalidValue);
#define CASE(SG)                                                           \
  case SG:                                                                 \
    if (lane_packs == 1)                                                   \
      return launch_wide<SG, 1>(cols, vals, x, y, nb, m, k, n,             \
                                block_threads, vec, stream);               \
    break;
    CASE(2) CASE(4) CASE(8) CASE(16)
#undef CASE
    case 32:  // a warp a row: the tile kernel up to kWidePacks packs a
              // lane, the long walk past that
      if (lane_packs > kWidePacks)
        return launch_long(cols, vals, x, y, nb, m, k, n, block_threads, vec,
                           stream);
      switch (lane_packs) {
        case 1: return launch_wide<32, 1>(cols, vals, x, y, nb, m, k, n, block_threads, vec, stream);
        case 2: return launch_wide<32, 2>(cols, vals, x, y, nb, m, k, n, block_threads, vec, stream);
        case 3: return launch_wide<32, 3>(cols, vals, x, y, nb, m, k, n, block_threads, vec, stream);
        case 4: return launch_wide<32, 4>(cols, vals, x, y, nb, m, k, n, block_threads, vec, stream);
      }
      break;
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int repro_spmv_batch_ell_f32(const int* cols, const float* vals,
                                        const float* x, float* y, long long nb,
                                        long long m, int k, long long n,
                                        int block_threads, int subgroup,
                                        int vec, void* stream) {
  return launch(cols, vals, x, y, nb, m, k, n, block_threads, subgroup,
                vec != 0, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_spmv_batch_ell_f64(const int* cols, const double* vals,
                                        const double* x, double* y,
                                        long long nb, long long m, int k,
                                        long long n, int block_threads,
                                        int subgroup, int vec, void* stream) {
  return launch(cols, vals, x, y, nb, m, k, n, block_threads, subgroup,
                vec != 0, static_cast<cudaStream_t>(stream));
}
