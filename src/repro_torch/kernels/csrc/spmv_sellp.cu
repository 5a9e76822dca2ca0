// y = A x for a SELL-P matrix (slices of C rows, column-major in a slice).
//
// Replaces: src/repro/kernels/spmv_sellp/kernel.py::spmv_sellp (Pallas TPU).
//
// Bound: bytes.  Each call must stream every stored slot once, padding
// included, at this layout: total*(4 + s) bytes for s-byte values (on the
// Graph 500 matrix at scale 23, 14.4 GB for 2.1 GB of true nonzeros), then
// slice_sets, x (gathered) and y.  At 2 flops a slot the work is ~0.25
// flop/byte, far below the card's ridge point, so the kernel is as fast as
// it keeps HBM streaming: how many bytes it has in flight, whatever the
// slices' widths, and what the gathers of x cost beside the stream.  A
// power-law matrix makes that hard for a walk by slices: most slices are a
// few columns, while a Graph 500 hub slice runs to 257,281 columns.
//
// Design: one walk, balanced by stored slots, over the flat buffer.
//  * The stored columns are cut into ranges of R columns (C slots each),
//    whatever the slice boundaries.  A persistent grid, one full wave of
//    blocks, gives each warp the ranges w, w + warps, ...  R is set by the
//    wrapper from the stored columns and the warps a wave holds
//    (repro_spmv_sellp_resident_warps): a few ranges a warp, so a small
//    matrix keeps every warp busy and a large one walks long ranges, with no
//    test of the matrix.  The warp finds the
//    slice holding its range's first column by a 32-way search of
//    slice_sets, as a merge path does.  A hub slice and a run of one-column
//    slices cost the same per slot.
//  * A warp step is cols_per_step consecutive columns: lane l takes slots
//    V*(l % lanes) .. + V - 1 of column l / lanes of the step (lanes = C / V
//    lane-loads a column; with more than 32, one column a step in passes of
//    32 lanes).  V = 4 when C is a multiple of 4 and the buffers 16-byte
//    aligned (16-byte copies of column indices and values), else V = 1.
//  * The stream runs kStages - 1 steps ahead of the sums through a ring in
//    shared memory (cp.async, evict-first in L2, not in L1), so the bytes in
//    flight cost no registers; x is gathered one step ahead through L1,
//    which caches it (gathers that skip L1 took twice as long).  At most 64
//    registers a thread (f32) let two blocks of 512 threads fit an SM: a
//    first form that held the stream in registers spilled at that bound and
//    ran at 1.6 TB/s.
//  * Each lane keeps a partial of its V rows for the slice in progress.
//    Where a slice ends inside a step, the lanes' partials go through the
//    warp's [cols_per_step][C] tile: lane (r, g) adds row r at positions g,
//    g + G, ... (G = 32 / C parts) and a fixed shuffle tree adds the parts.
//    A step inside a slice costs no exchange at all.
//  * A slice cut by a range boundary: each range it spans stores its share
//    in a slot of its own (the range that opens the slice its "own" slot,
//    each later one its "head" slot), then takes a ticket of the slice's
//    first range; the warp that draws the last ticket adds the shares in
//    range order and writes the rows (as finish_sum in common.cuh: an atomic
//    on the ticket only, never on a value; one launch an apply).
// Every sum's order is fixed by C, R and the slice boundaries, never by the
// grid's size or the schedule, so a repeat is bitwise equal.  Every stored
// slot is read and its product added.  Slices of no column (the format
// stores at least one) are written as zeros where the walk passes them.
// Offsets into the flat buffer are 64-bit (it passes 2^31 slots before the
// column count does).
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

// The stream goes through a ring of kStages warp steps in shared memory:
// each lane copies its V slots of a step into its own part of the warp's
// ring by cp.async and reads back only what it copied itself, so waiting on
// its own copies (cp.async.wait_group) is all the order it needs.  The
// copies skip L1 (16-byte .cg; smaller ones .ca), which is left to cache the
// gathered x, and are marked evict-first in L2.
constexpr int kStages = 4;

// Bytes of one warp's ring.
template <typename T, int V>
__host__ __device__ constexpr int ring_bytes() {
  return kStages * kWarp * V * static_cast<int>(sizeof(int) + sizeof(T));
}

// Registers: at most 64 for f32, so 1,024 threads fit an SM's 65,536 (at 98
// a thread the Graph 500 matrix ran 2 % slower), 128 for f64.
template <typename T>
__host__ __device__ constexpr int min_blocks() {
  return sizeof(T) == 4 ? 2 : 1;
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

template <int Bytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           uint64_t policy) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (Bytes == 16) {
    asm volatile(
        "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;"
        ::"r"(d), "l"(src), "l"(policy) : "memory");
  } else {
    asm volatile(
        "cp.async.ca.shared.global.L2::cache_hint [%0], [%1], %2, %3;"
        ::"r"(d), "l"(src), "n"(Bytes), "l"(policy) : "memory");
  }
}

// V slots of one array: 16-byte copies where they fill one, else one a slot.
template <int V, typename E>
__device__ __forceinline__ void copy_slots(E* dst, const E* src,
                                           uint64_t policy) {
  constexpr int kBytes = V * static_cast<int>(sizeof(E));
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int o = 0; o < kBytes / 16; ++o) {
      copy_async<16>(dst + o * (16 / sizeof(E)), src + o * (16 / sizeof(E)),
                     policy);
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      copy_async<static_cast<int>(sizeof(E))>(dst + i, src + i, policy);
    }
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The number of slices that end at or before column c (slice_sets[s + 1]
// <= c), i.e. the first slice holding a column past c: a 32-way search, one
// round of loads per factor of 32.  Every lane of the warp must call it.
__device__ int slices_ended_by(const int* __restrict__ slice_sets, int ns,
                               int c, int lane) {
  long long lo = 0, hi = ns;  // ends <= c below lo, > c from hi on
  while (hi > lo) {
    const long long step = (hi - lo + kWarp - 1) / kWarp;
    const long long i = lo + (lane + 1) * step - 1;
    const bool le = i < hi && __ldg(slice_sets + 1 + i) <= c;
    const int below = __popc(__ballot_sync(kFull, le));
    hi = min(hi, lo + (below + 1) * step - 1);
    lo += below * step;
  }
  return static_cast<int>(lo);
}

// A persistent grid of warps over ranges of R stored columns (see the
// header).  slots holds a head and an own share of C rows per range; tickets
// one counter per range, zero between launches.
template <typename T, int V>
__global__ void __launch_bounds__(512, min_blocks<T>())
spmv_sellp_kernel(const int* __restrict__ cols, const T* __restrict__ vals,
                  const int* __restrict__ slice_sets, const T* __restrict__ x,
                  T* __restrict__ y, T* __restrict__ slots,
                  unsigned* __restrict__ tickets, long long m, int C, int ns,
                  int total, int R) {
  const int lane = threadIdx.x % kWarp;
  const int lanes_col = C / V;  // lane-loads of a column
  const int lpw = lanes_col < kWarp ? lanes_col : kWarp;
  const int cps = kWarp / lpw;  // columns a step
  const int passes = (lanes_col + kWarp - 1) / kWarp;
  const int p = lane / lpw;        // the lane's column of a step
  const int q0 = lane - p * lpw;   // its lane-load of the column, first pass
  const long long ranges = (static_cast<long long>(total) + R - 1) / R;
  const long long warps =
      static_cast<long long>(gridDim.x) * (blockDim.x / kWarp);
  T* const head_slots = slots;
  T* const own_slots = slots + ranges * C;
  // this warp's ring of kStages steps, then its tile of partials (32 * V
  // values, used when cps > 1)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / kWarp;
  const int warp_bytes =
      ring_bytes<T, V>() +
      (cps > 1 ? kWarp * V * static_cast<int>(sizeof(T)) : 0);
  int* const ring_cols =
      reinterpret_cast<int*>(smem_raw + static_cast<size_t>(warp) * warp_bytes);
  T* const ring_vals = reinterpret_cast<T*>(ring_cols + kStages * kWarp * V);
  T* const red = ring_vals + kStages * kWarp * V;
  const uint64_t policy = evict_first_policy();

  for (long long k = static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) +
                     threadIdx.x / kWarp;
       k < ranges; k += warps) {
    const int c_lo = static_cast<int>(k * R);
    const int c_hi = static_cast<int>(
        min(static_cast<long long>(c_lo) + R, static_cast<long long>(total)));
    // the slice holding c_lo; range 0 also walks slices of no column at 0
    const int s0 = k == 0 ? 0 : slices_ended_by(slice_sets, ns, c_lo, lane);
    const int s0_lo = __ldg(slice_sets + s0);
    const int s0_hi = __ldg(slice_sets + s0 + 1);
    const bool head = s0_lo < c_lo;  // s0 began in an earlier range
    // the slice open at c_hi (begun before it, ending after), and its end
    int s_end = s0, e_end = s0_hi;
    bool open = false;

    for (int pass = 0; pass < passes; ++pass) {
      const int q = q0 + pass * kWarp;
      const bool lane_on = p < cps && q < lanes_col;
      // slice_sets[base + lane], to read slice ends by shuffle
      int s = s0, base = s0;
      int win = base + lane <= ns ? __ldg(slice_sets + base + lane) : INT_MAX;
      int start = s0_lo;                     // slice s's first column
      int e = __shfl_sync(kFull, win, 1);  // and its end
      T acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = T(0);

      // Add the lanes' partials of slice s over the step's column positions,
      // store its rows where they belong, and clear the partials.  With
      // several columns a step the partials go through the warp's [cps][C]
      // shared tile: lane (r, g) adds row r at positions g, g + G, ... (G =
      // 32 / C parts), the parts are added by a fixed shuffle tree.
      auto flush = [&]() {
        T* dst;
        long long rows;
        if (s == s0 && head) {
          dst = head_slots + k * C;
          rows = C;
        } else if (e <= c_hi) {
          dst = y + static_cast<long long>(s) * C;
          rows = m - static_cast<long long>(s) * C;
        } else {
          dst = own_slots + k * C;
          rows = C;
        }
        if (cps == 1) {
          // lanes past the column's (p = 1 when 32 / lanes_col is 1 with a
          // remainder) hold no partial and must not store
          if (p < cps && q < lanes_col) {
#pragma unroll
            for (int i = 0; i < V; ++i) {
              if (q * V + i < rows) dst[q * V + i] = acc[i];
            }
          }
        } else {
          if (p < cps) {
#pragma unroll
            for (int i = 0; i < V; ++i) red[p * C + q * V + i] = acc[i];
          }
          __syncwarp();
          const int parts = C <= kWarp ? kWarp / C : 1;
          const int g = C <= kWarp ? lane / C : 0;
          for (int r = C <= kWarp ? lane - g * C : lane; r < C; r += kWarp) {
            T sum = T(0);
            if (g < parts) {
              for (int pos = g; pos < cps; pos += parts) {
                sum += red[pos * C + r];
              }
            }
            for (int d = 1; d < parts; d <<= 1) {
              const T o = __shfl_down_sync(kFull, sum, d * C);
              if ((g & (2 * d - 1)) == 0 && g + d < parts) sum += o;
            }
            if (g == 0 && r < rows) dst[r] = sum;
          }
          __syncwarp();
        }
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = T(0);
      };
      auto next_slice = [&]() {
        ++s;
        start = e;
        if (s + 1 - base >= kWarp) {
          base = s;
          win = base + lane <= ns ? __ldg(slice_sets + base + lane) : INT_MAX;
        }
        e = __shfl_sync(kFull, win, s + 1 - base);
      };

      // step t: columns c_lo + t * cps + p, in ring slot t % kStages
      const int steps = static_cast<int>((c_hi - c_lo + cps - 1) / cps);
      auto issue = [&](int t) {
        const long long j = c_lo + static_cast<long long>(t) * cps + p;
        if (t < steps && lane_on && j < c_hi) {
          const long long off = j * C + q * V;
          const int slot = ((t % kStages) * kWarp + lane) * V;
          copy_slots<V>(ring_cols + slot, cols + off, policy);
          copy_slots<V>(ring_vals + slot, vals + off, policy);
        }
        copy_commit();  // an empty group past the range keeps the count
      };
      // step t's column indices from the ring, and the x they gather
      auto gather = [&](int t, T (&xv)[V]) {
        const long long j = c_lo + static_cast<long long>(t) * cps + p;
        const bool on = t < steps && lane_on && j < c_hi;
        const int slot = ((t % kStages) * kWarp + lane) * V;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          xv[i] = on ? __ldg(x + ring_cols[slot + i]) : T(0);
        }
      };
#pragma unroll
      for (int t = 0; t < kStages - 1; ++t) issue(t);
      copy_wait<kStages - 2>();  // this lane's copies of step 0 are in
      T xv[V];
      gather(0, xv);

      for (int t = 0; t < steps; ++t) {
        // keep the ring full, and gather step t + 1 while t is added up
        issue(t + kStages - 1);
        copy_wait<kStages - 2>();
        T xn[V];
        gather(t + 1, xn);
        if (s - base >= kWarp / 2) {  // refill beside the gathers
          base = s;
          win = base + lane <= ns ? __ldg(slice_sets + base + lane) : INT_MAX;
        }
        const long long bu = c_lo + static_cast<long long>(t) * cps;
        const bool on = lane_on && bu + p < c_hi;
        const int slot = ((t % kStages) * kWarp + lane) * V;
        T pr[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          pr[i] = on ? ring_vals[slot + i] * xv[i] : T(0);
          xv[i] = xn[i];
        }
        const int nv =
            static_cast<int>(min(static_cast<long long>(cps), c_hi - bu));
        int lo = 0;  // first column of the step in slice s
        while (s < ns && e <= bu + nv) {  // slice s ends in this step
          const int hi = static_cast<int>(e - bu);
          if (on && p >= lo && p < hi) {
#pragma unroll
            for (int i = 0; i < V; ++i) acc[i] += pr[i];
          }
          flush();
          lo = hi;
          next_slice();
        }
        if (on && p >= lo) {
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] += pr[i];
        }
      }
      // slice s, if begun before c_hi, runs past it: its share to a slot
      open = s < ns && start < c_hi;
      if (open) flush();
      s_end = s;
      e_end = e;
    }

    // The slices this range shares: the one it began inside (head), and the
    // one it opened that runs past c_hi.  Each range of such a slice takes a
    // ticket of the slice's first range k0 once its share is stored; the
    // last adds own[k0] + head[k0 + 1] + ... + head[k1] and writes the rows.
    auto settle = [&](int s, long long k0, long long k1) {
      k1 = min(k1, ranges - 1);
      __threadfence();
      __syncwarp();
      unsigned last = 0;
      if (lane == 0) {
        unsigned drawn;
        asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                     : "=r"(drawn)
                     : "l"(tickets + k0)
                     : "memory");
        last = drawn == static_cast<unsigned>(k1 - k0);
      }
      last = __shfl_sync(kFull, last, 0);
      if (!last) return;
      __syncwarp();
      for (int r = lane; r < C; r += kWarp) {
        T sum = __ldcg(own_slots + k0 * C + r);
        for (long long kk = k0 + 1; kk <= k1; ++kk) {
          sum += __ldcg(head_slots + kk * C + r);
        }
        const long long row = static_cast<long long>(s) * C + r;
        if (row < m) y[row] = sum;
      }
      if (lane == 0) tickets[k0] = 0u;
    };
    if (head) settle(s0, s0_lo / R, (s0_hi - 1) / R);
    if (open && !(s_end == s0 && head)) settle(s_end, k, (e_end - 1) / R);
  }
}

// The shared memory a block of block_threads takes (each warp's ring, and
// its tile of 32 * V partials for slices ending inside a step) and the
// blocks of one full wave (the SMs times the blocks an SM holds at once).
template <typename T, int V>
int wave(int C, int block_threads, size_t* smem, long long* blocks) {
  const size_t tile = C / V <= kWarp / 2 ? kWarp * V * sizeof(T) : 0;
  *smem = static_cast<size_t>(block_threads / kWarp) *
          (ring_bytes<T, V>() + tile);
  auto kernel = spmv_sellp_kernel<T, V>;
  int device = 0, sms = 0, fit = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(*smem));
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel,
                                                        block_threads, *smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = static_cast<long long>(sms) * fit;
  if (*blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  return 0;
}

template <typename T, int V>
int launch_walk(const int* cols, const T* vals, const int* slice_sets,
                const T* x, T* y, T* slots, unsigned* tickets, long long m,
                int C, int ns, int total, int R, int block_threads,
                cudaStream_t stream) {
  size_t smem = 0;
  long long resident = 0;
  const int err = wave<T, V>(C, block_threads, &smem, &resident);
  if (err != 0) return err;
  const long long ranges = (static_cast<long long>(total) + R - 1) / R;
  const long long warps_per_block = block_threads / kWarp;
  const long long need = (ranges + warps_per_block - 1) / warps_per_block;
  const unsigned grid =
      static_cast<unsigned>(need < resident ? need : resident);
  spmv_sellp_kernel<T, V><<<grid, block_threads, smem, stream>>>(
      cols, vals, slice_sets, x, y, slots, tickets, m, C, ns, total, R);
  return static_cast<int>(cudaGetLastError());
}

// The warps of one full wave of the walk for V-slot lane-loads.
template <typename T>
int resident_warps(int C, int vec, int block_threads, long long* warps) {
  size_t smem = 0;
  long long blocks = 0;
  const int err = vec == 4 ? wave<T, 4>(C, block_threads, &smem, &blocks)
                           : wave<T, 1>(C, block_threads, &smem, &blocks);
  *warps = blocks * (block_threads / kWarp);
  return err;
}

template <typename T>
int launch(const int* cols, const T* vals, const int* slice_sets, const T* x,
           T* y, T* slots, unsigned* tickets, long long m, int C, int total,
           int R, int block_threads, cudaStream_t stream) {
  const long long ns = (m + C - 1) / C;
  if (C < 1 || R < 1 || total < 1 || ns >= INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool aligned = (reinterpret_cast<uintptr_t>(cols) |
                        reinterpret_cast<uintptr_t>(vals)) % 16 == 0;
  if (C % 4 == 0 && aligned) {
    return launch_walk<T, 4>(cols, vals, slice_sets, x, y, slots, tickets, m,
                             C, static_cast<int>(ns), total, R, block_threads,
                             stream);
  }
  return launch_walk<T, 1>(cols, vals, slice_sets, x, y, slots, tickets, m, C,
                           static_cast<int>(ns), total, R, block_threads,
                           stream);
}

}  // namespace

extern "C" int repro_spmv_sellp_f32(const int* cols, const float* vals,
                                    const int* slice_sets, const float* x,
                                    float* y, float* slots, unsigned* tickets,
                                    long long m, int C, int total_cols,
                                    int range_cols, int block_threads,
                                    void* stream) {
  return launch(cols, vals, slice_sets, x, y, slots, tickets, m, C, total_cols,
                range_cols, block_threads, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_spmv_sellp_f64(const int* cols, const double* vals,
                                    const int* slice_sets, const double* x,
                                    double* y, double* slots,
                                    unsigned* tickets, long long m, int C,
                                    int total_cols, int range_cols,
                                    int block_threads, void* stream) {
  return launch(cols, vals, slice_sets, x, y, slots, tickets, m, C, total_cols,
                range_cols, block_threads, static_cast<cudaStream_t>(stream));
}

// The warps one full wave of the walk holds, for values of itemsize bytes
// (4 or 8), slice size C, vec slots a lane-load (4 or 1, as launch picks)
// and blocks of block_threads: the wrapper sets the range size from it.
extern "C" int repro_spmv_sellp_resident_warps(int itemsize, int C, int vec,
                                               int block_threads,
                                               long long* warps) {
  if (C < 1 || (itemsize != 4 && itemsize != 8) ||
      (vec != 1 && (vec != 4 || C % 4 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return itemsize == 8 ? resident_warps<double>(C, vec, block_threads, warps)
                       : resident_warps<float>(C, vec, block_threads, warps);
}
