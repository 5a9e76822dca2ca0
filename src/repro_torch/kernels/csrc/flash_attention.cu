// Causal GQA softmax attention with an online softmax (flash attention).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_attention
// (Pallas TPU).
//
// q (B, Hq, S, D), k and v (B, Hkv, Skv, D), Hkv dividing Hq; out (B, Hq,
// S, D) in q's type.  Query row i sits at absolute position i + Skv - S
// (kv_offset), so with Skv > S the queries are the last S of the stream and
// with Skv < S the first S - Skv rows see nothing and come out 0.
//
// Bound: operations at the path's shapes (S = Skv = 2,048, D = 160): the
// causal products take about 2*B*Hq*S*Skv*D flops against 4*B*Hq*S*D
// elements moved, far past the card's ridge point.  Only the tensor cores'
// warpgroup product (wgmma) reaches their full rate, and only if the tiles
// reach shared memory while the previous ones are multiplied.
//
// Design (bf16 / fp16): the TPU kernel walked a 4-D grid whose innermost kv
// axis ran in order, keeping (m, l, acc) in VMEM scratch across grid steps.
// Blocks run in no order here, so one block owns (b, hq, a tile of BQ = 128
// queries, the TPU kernel's block_q) and loops over kv tiles of BKV = 64
// itself, only up to the causal limit q_last + kv_offset; heavy (late)
// query tiles start first.  The block is warp-specialised: one producer
// warpgroup (one thread issues) and two consumer warpgroups of 64 query rows
// each; setmaxnreg moves the producer's registers to the consumers (24 and
// 240 of the 168 a thread starts with).
//  * The producer loads Q once, then K and V tiles into a ring of stages
//    (three, two when D > 192, as shared memory allows) with TMA
//    (cp.async.bulk.tensor, 3-D maps over (D, rows, batch * heads), so rows
//    past S or Skv of a head are zero-filled by the hardware), each stage
//    with a full and an empty mbarrier.  A row of D = 160 is 320 bytes and a
//    128-byte-swizzled box is at most 128 bytes wide, so every tile comes in
//    column slabs of 64 (the last one zero-filled past D), each slab its own
//    row-major, 128B-swizzled, 1024-byte-aligned array: one swizzle atom
//    wide, 8 rows an atom.
//  * S = Q K^T is wgmma m64n64k16 with both operands K-major in shared
//    memory (D / 16 k-steps, stepping 32 bytes inside a slab and to the next
//    slab every four).  The online softmax runs in registers on the
//    accumulator layout (a thread holds two rows; the row max and sum close
//    over the four lanes of a quad), in base 2 with the scale folded into
//    log2(e), the exponentials on the special-function unit (ex2.approx).  Only tiles that cross the causal diagonal or the end of the kv
//    rows are masked; the guards of the TPU kernel carry over: m_safe = 0
//    where a row's max is -inf, p = 0 where s = -inf, l = 0 -> 1, so a fully
//    masked row writes 0.  A warpgroup whose rows all end before a tile skips
//    it.
//  * O += P V is wgmma with A = P from registers (the S accumulators are
//    already in the A-fragment layout) and B = the V tile as it was loaded:
//    V is MN-major (rows are kv, the product's K; columns are D, its N), the
//    transposed-B form wgmma allows for 16-bit types, so V is never
//    transposed by hand.  One instruction of N = D a k-step, its leading
//    byte offset stepping from slab to slab (D = 160 spans 2.5 atoms):
//    nothing is padded in any product.
//  * A consumer issues S(t) and then P(t-1) V(t-1), and runs the softmax of
//    tile t while the second product is on the tensor cores.
//  * P keeps f32-level accuracy: it is split into hi = P rounded to the
//    input type and lo = P - hi, and both are multiplied (the TPU kernel
//    rounds P once to the input type, which the f32 plain version's
//    tolerance does not admit).  The tensor work is therefore 1.5x the
//    function's operations.
//  * The epilogue writes O (in the input type) into the warpgroup's own rows
//    of the Q slabs, which it no longer reads, and stores them with TMA,
//    which drops rows past S and columns past D.
// A consumer thread holds D / 2 f32 of O, 32 of S and 32 packed registers of
// P (hi and lo); ptxas -v reports no spills at any D.  BKV = 64:
// at D = 160 two stages of 128-row K and V tiles (98,304 bytes each) and Q
// would not fit a block's shared memory.  Each D (a multiple of 16 up to
// 256) has its own instantiation, chosen by a switch on D in the launcher,
// so O holds exactly D / 2 registers.
//
// f32 inputs run the products on the CUDA cores (FMA): K/V are staged as
// f32 in shared memory (rows padded to D + 1 floats so that the 16 threads
// reading 16 rows hit 16 banks), the running max and denominator per row in
// shared memory and 4 x (D / 16) accumulators a thread in registers.
#include <cuda.h>  // CUtensorMap and the driver API's types (no link to it)
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBQ = 64;         // f32: query rows a block
constexpr int kThreads = 256;   // f32: 16 x 16, rows ty + 16 i, columns tx + 16 j
constexpr int kFmaBKV = 32;     // f32: kv rows a tile (two blocks an SM at D = 160)
constexpr int kMaxD = 256;

template <typename T, int BKV>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Hq,
                       int Hkv, int S, int Skv, int D, float scale,
                       int causal) {
  constexpr int NI = kBQ / 16;
  constexpr int NJ = BKV / 16;
  constexpr int MAXJ = kMaxD / 16;
  extern __shared__ float smem[];
  const int ldq = D + 1, ldk = D + 1, ldv = D, ldp = BKV + 1;
  float* q_s = smem;                 // (BQ, D + 1)
  float* k_s = q_s + kBQ * ldq;      // (BKV, D + 1)
  float* v_s = k_s + BKV * ldk;      // (BKV, D)
  float* p_s = v_s + BKV * ldv;      // (BQ, BKV + 1) scores, then p
  float* m_s = p_s + kBQ * ldp;      // (BQ,) running max
  float* l_s = m_s + kBQ;            // (BQ,) running denominator
  float* c_s = l_s + kBQ;            // (BQ,) this tile's correction

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int kv_offset = Skv - S;
  const int nd = D / 16;
  const long long qrow0 = (static_cast<long long>(b) * Hq + hq) * S;
  const long long krow0 = (static_cast<long long>(b) * Hkv + hk) * Skv;

  for (int r = warp; r < kBQ; r += kThreads / 32) {
    const int qr = q0 + r;
    for (int d = lane; d < D; d += 32) {
      q_s[r * ldq + d] = qr < S ? to_f32(q[(qrow0 + qr) * D + d]) : 0.f;
    }
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  float acc[NI][MAXJ];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  const int kv_end = causal ? min(Skv, q_last + kv_offset + 1) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // the previous tile's readers are done
    for (int c = warp; c < BKV; c += kThreads / 32) {
      const int kc = k0 + c;
      const bool in = kc < Skv;
      for (int d = lane; d < D; d += 32) {
        k_s[c * ldk + d] = in ? to_f32(k[(krow0 + kc) * D + d]) : 0.f;
        v_s[c * ldv + d] = in ? to_f32(v[(krow0 + kc) * D + d]) : 0.f;
      }
    }
    __syncthreads();

    // s = scale * q k^T on this tile, masked
    float s[NI][NJ];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
    }
    for (int d = 0; d < D; ++d) {
      float qv[NI], kv[NJ];
#pragma unroll
      for (int i = 0; i < NI; ++i) qv[i] = q_s[(ty + 16 * i) * ldq + d];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = k_s[(tx + 16 * j) * ldk + d];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        const int kc = k0 + c;
        const bool masked = kc >= Skv || (causal && kc > q0 + r + kv_offset);
        p_s[r * ldp + c] = masked ? -INFINITY : s[i][j] * scale;
      }
    }
    __syncthreads();

    // online softmax update, one warp a row
    for (int r = warp; r < kBQ; r += kThreads / 32) {
      float mx = -INFINITY;
      for (int c = lane; c < BKV; c += 32) mx = fmaxf(mx, p_s[r * ldp + c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      for (int c = lane; c < BKV; c += 32) {
        const float sv = p_s[r * ldp + c];
        const float p = sv == -INFINITY ? 0.f : expf(sv - m_safe);
        p_s[r * ldp + c] = p;
        sum += p;
      }
      sum = subgroup_sum<32>(sum, 0xffffffffu);
      if (lane == 0) {
        const float corr = m_prev == -INFINITY ? 0.f : expf(m_prev - m_safe);
        m_s[r] = m_new;
        l_s[r] = corr * l_s[r] + sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p v
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        if (j < nd) acc[i][j] *= corr;
      }
    }
    for (int c = 0; c < BKV; ++c) {
      float pv[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) pv[i] = p_s[(ty + 16 * i) * ldp + c];
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        if (j < nd) {
          const float vv = v_s[c * ldv + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < NI; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();  // l_s is final (and initialised when no tile ran)

#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int r = ty + 16 * i;
    const int qr = q0 + r;
    if (qr < S) {
      float l = l_s[r];
      l = l == 0.f ? 1.f : l;
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        if (j < nd) {
          o[(qrow0 + qr) * D + tx + 16 * j] = from_f32<T>(acc[i][j] / l);
        }
      }
    }
  }
}

// -- bf16 / fp16: warp-specialised TMA + wgmma -----------------------------

constexpr int kWgBQ = 128;      // query rows a block: two warpgroups of 64
constexpr int kWgBKV = 64;      // kv rows a tile
constexpr int kSlab = 64;       // columns of one 128-byte swizzled slab
constexpr int kSlabRow = 128;   // bytes of a slab row
constexpr int kConsumers = 256; // two consumer warpgroups
constexpr int kWgThreads = kConsumers + 128;  // and one producer warpgroup
// setmaxnreg: the block starts at 168 registers a thread (65,536 / 384);
// the producer gives back all but 24, the consumers take 240
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr int kBarBytes = 128;  // the mbarriers: Q full, then full/empty a stage

// Shared memory of one block at head dim D: Q, then the stages of K and V,
// then the barriers, plus 1,024 bytes to align the base for the swizzle.
template <int D>
struct WgGeom {
  static constexpr int kSlabs = (D + kSlab - 1) / kSlab;
  static constexpr int kQBytes = kSlabs * kWgBQ * kSlabRow;
  static constexpr int kTileBytes = kSlabs * kWgBKV * kSlabRow;  // K or V
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kStages =
      kQBytes + 3 * kStageBytes + kBarBytes + 1024 <= kSmemLimit ? 3 : 2;
  static constexpr int kSmem =
      kQBytes + kStages * kStageBytes + kBarBytes + 1024;
  static_assert(kSmem <= kSmemLimit, "tiles exceed a block's shared memory");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma operand in a 128B-swizzled layout: start address, leading and
// stride byte offsets (the descriptor keeps each in 16-byte units), layout
// type 1 (128B swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from touching accumulators across an async wgmma.
template <int N>
__device__ __forceinline__ void reg_fence(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The two values of a packed pair back in f32 (exact).
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t v);
template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}
template <>
__device__ __forceinline__ float2 unpack2<__half>(uint32_t v) {
  return __half22float2(*reinterpret_cast<__half2*>(&v));
}

// 2^x on the special-function unit (relative error about 2^-22; 0 for -inf)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T for one kv tile: k-step kk is 16 columns, 32 bytes into slab
// kk / 4 of Q (this warpgroup's rows) and of K.  Issued, not waited for.
template <typename T, int D>
__device__ __forceinline__ void issue_qk(float (&s)[kWgBKV / 2], uint32_t q_wg,
                                         uint32_t k_s) {
  constexpr int kQSlab = kWgBQ * kSlabRow, kKvSlab = kWgBKV * kSlabRow;
  reg_fence<kWgBKV / 2>(s);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    Wg<T>::ss64(s, sw128_desc(q_wg + (kk / 4) * kQSlab + off, 16, 1024),
                sw128_desc(k_s + (kk / 4) * kKvSlab + off, 16, 1024), kk > 0);
  }
  wg_commit();
}

// O += P V for one kv tile, P = hi + lo: one instruction of N = D a k-step
// and term.  V's k-step kk starts 16 rows (2,048 bytes) on; the leading byte
// offset steps across the 64-column slabs (swizzle atoms) along N, the
// stride byte offset across 8-row groups along K.  Issued, not waited for.
template <typename T, int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&p_hi)[kWgBKV / 16][4],
                                         const uint32_t (&p_lo)[kWgBKV / 16][4],
                                         uint32_t v_s) {
  constexpr int kKvSlab = kWgBKV * kSlabRow;
  reg_fence<D / 2>(o);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kWgBKV / 16; ++kk) {
    const uint64_t dv = sw128_desc(v_s + kk * 16 * kSlabRow, kKvSlab, 1024);
    Wg<T>::template rs<D>(o, p_hi[kk], dv, 1);
    Wg<T>::template rs<D>(o, p_lo[kk], dv, 1);
  }
  wg_commit();
}

// One block: (b, hq, 128 queries).  Threads 0-255 are the two consumer
// warpgroups (warpgroup w owns query rows 64 w .. 64 w + 63 of the tile),
// warpgroup 2 the producer (one thread issues).  In a consumer warpgroup,
// warp i's lane (g = lane / 4, t = lane % 4) holds rows 16 i + g and
// 16 i + g + 8, columns 8 j + 2 t and 8 j + 2 t + 1 of every 8-wide block j
// of S and of O.
//
// A consumer overlaps the softmax of tile t with the P V product of tile
// t - 1: it issues S(t) = Q K(t)^T, then P(t-1) V(t-1), waits for S(t)
// alone (wgmma groups complete in order), runs the softmax on S(t) while
// P(t-1) V(t-1) is on the tensor cores, then waits for it, releases tile
// t - 1's stage, rescales O and packs P(t).  P(t-1) stays in its registers
// until its product is done.
template <typename T, int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const __grid_constant__ CUtensorMap o_map,
                             int Hq, int Hkv, int S, int Skv,
                             float scale_log2, int causal) {
  using G = WgGeom<D>;
  constexpr int NS = G::kSlabs;
  constexpr int NO = D / 2;        // O accumulators a thread
  constexpr int NSC = kWgBKV / 2;  // S accumulators a thread
  constexpr int NP = kWgBKV / 16;  // k-steps of P V
  constexpr int kQSlab = kWgBQ * kSlabRow;    // bytes of a Q slab
  constexpr int kKvSlab = kWgBKV * kSlabRow;  // bytes of a K or V slab
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + G::kQBytes;
  const uint32_t bars = kv_s + G::kStages * G::kStageBytes;
  const uint32_t q_full = bars;
  auto full = [&](int t) { return bars + 8u * (1 + t % G::kStages); };
  auto empty = [&](int t) {
    return bars + 8u * (1 + G::kStages + t % G::kStages);
  };
  auto parity = [&](int t) {
    return static_cast<uint32_t>(t / G::kStages) & 1u;
  };
  auto k_tile = [&](int t) { return kv_s + (t % G::kStages) * G::kStageBytes; };

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWgBQ;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int kv_offset = Skv - S;
  const int q_last = min(q0 + kWgBQ, S) - 1;
  const int kv_end = causal ? min(Skv, q_last + kv_offset + 1) : Skv;
  const int n_tiles = kv_end > 0 ? (kv_end + kWgBKV - 1) / kWgBKV : 0;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < G::kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warpgroup: one thread issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kConsumers) {
      mbar_expect_tx(q_full, G::kQBytes);
      for (int j = 0; j < NS; ++j) {
        tma_load(q_s + j * kQSlab, &q_map, q_full, j * kSlab, q0, b * Hq + hq);
      }
      for (int t = 0; t < n_tiles; ++t) {
        mbar_wait(empty(t), parity(t) ^ 1);
        mbar_expect_tx(full(t), G::kStageBytes);
        const uint32_t k_s = k_tile(t), v_s = k_s + G::kTileBytes;
        for (int j = 0; j < NS; ++j) {
          tma_load(k_s + j * kKvSlab, &k_map, full(t), j * kSlab, t * kWgBKV,
                   b * Hkv + hk);
          tma_load(v_s + j * kKvSlab, &v_map, full(t), j * kSlab, t * kWgBKV,
                   b * Hkv + hk);
        }
      }
    }
    return;
  }

  // -- consumers ------------------------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wg_first = q0 + wg * 64;
  const int row = wg_first + warp * 16 + g;  // and row + 8
  const int wg_last = min(wg_first + 63, S - 1);
  const int wg_kv_end = wg_first >= S ? 0
                        : causal      ? min(Skv, wg_last + kv_offset + 1)
                                      : Skv;
  // tiles this warpgroup multiplies; it only releases the block's others
  const int n_wg = wg_kv_end > 0 ? (wg_kv_end + kWgBKV - 1) / kWgBKV : 0;
  const uint32_t q_wg = q_s + wg * 64 * kSlabRow;  // this warpgroup's Q rows

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};
  float s[NSC];
  uint32_t p_hi[NP][4], p_lo[NP][4];

  // scale (base 2), mask a tile that needs it, online softmax: s becomes P,
  // m and l move on; returns O's correction through corr
  auto softmax = [&](int t, float (&corr)[2]) {
    const int k0 = t * kWgBKV;
    const bool edge = k0 + kWgBKV > Skv ||
                      (causal && k0 + kWgBKV - 1 > wg_first + kv_offset);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < NSC; ++e) {
      const int h = (e >> 1) & 1;
      float x = s[e] * scale_log2;
      if (edge) {
        const int col = k0 + (e >> 2) * 8 + t4 * 2 + (e & 1);
        if (col >= Skv || (causal && col > row + 8 * h + kv_offset)) {
          x = -INFINITY;
        }
      }
      s[e] = x;
      mx[h] = fmaxf(mx[h], x);
    }
    float m_safe[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h]);
      m_safe[h] = m_new == -INFINITY ? 0.f : m_new;
      corr[h] = fast_exp2(m_r[h] - m_safe[h]);  // 0 while m was -inf
      m_r[h] = m_new;
    }
#pragma unroll
    for (int e = 0; e < NSC; ++e) {
      const int h = (e >> 1) & 1;
      const float p = fast_exp2(s[e] - m_safe[h]);  // 0 where s = -inf
      s[e] = p;
      rs[h] += p;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      l_r[h] = corr[h] * l_r[h] + rs[h];
    }
  };
  // O *= corr, then P as A fragments, hi + lo: k-step kk takes S blocks
  // 2 kk and 2 kk + 1
  auto rescale_and_pack = [&](const float (&corr)[2]) {
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < NP; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = s[8 * kk + 2 * r], c = s[8 * kk + 2 * r + 1];
        p_hi[kk][r] = pack2<T>(a, c);
        const float2 h = unpack2<T>(p_hi[kk][r]);
        p_lo[kk][r] = pack2<T>(a - h.x, c - h.y);
      }
    }
  };

  mbar_wait(q_full, 0);
  if (n_wg > 0) {
    float corr[2];
    mbar_wait(full(0), parity(0));
    issue_qk<T, D>(s, q_wg, k_tile(0));
    wg_wait_all();
    reg_fence<NSC>(s);
    softmax(0, corr);
    rescale_and_pack(corr);
    for (int t = 1; t < n_wg; ++t) {
      mbar_wait(full(t), parity(t));
      issue_qk<T, D>(s, q_wg, k_tile(t));
      issue_pv<T, D>(o, p_hi, p_lo, k_tile(t - 1) + G::kTileBytes);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      reg_fence<NSC>(s);
      softmax(t, corr);
      wg_wait_all();
      reg_fence<NO>(o);
      mbar_arrive(empty(t - 1));
      rescale_and_pack(corr);
    }
    issue_pv<T, D>(o, p_hi, p_lo, k_tile(n_wg - 1) + G::kTileBytes);
    wg_wait_all();
    reg_fence<NO>(o);
    mbar_arrive(empty(n_wg - 1));
  }
  for (int t = n_wg; t < n_tiles; ++t) {  // tiles past this warpgroup's rows
    mbar_wait(full(t), parity(t));
    mbar_arrive(empty(t));
  }
  if (wg_first >= S) return;

  // epilogue: O / l in T into this warpgroup's Q rows (swizzled as TMA
  // lays them out: 16-byte chunk c of row r sits at chunk c ^ (r % 8)),
  // then one TMA store a slab
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) inv[h] = 1.f / (l_r[h] == 0.f ? 1.f : l_r[h]);
#pragma unroll
  for (int i = 0; i < NO / 4; ++i) {
    const int col = 8 * i + 2 * t4;
    const int slab = col / kSlab, cc = col % kSlab;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + g + 8 * h;
      const uint32_t addr = q_wg + slab * kQSlab + r * kSlabRow +
                            (((cc / 8) ^ (r % 8)) * 16) + (cc % 8) * 2;
      const uint32_t val =
          pack2<T>(o[4 * i + 2 * h] * inv[h], o[4 * i + 2 * h + 1] * inv[h]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(val)
                   : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  if (tid % 128 == 0) {
    for (int j = 0; j < NS; ++j) {
      tma_store(&o_map, q_wg + j * kQSlab, j * kSlab, wg_first, b * Hq + hq);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call: its entry point comes from the
// runtime PyTorch loaded, so the library links no libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D map over (D, rows, heads) of a contiguous (heads, rows, D) tensor,
// boxes of 64 columns x box_rows rows, 128B swizzle, zero fill out of bounds.
bool encode_map(EncodeTiled fn, CUtensorMap* map, CUtensorMapDataType type,
                const void* ptr, int D, int rows, int heads, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {kSlab, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D>
int launch_wgmma(const T* q, const T* k, const T* v, T* o, int B, int Hq,
                 int Hkv, int S, int Skv, float scale, int causal,
                 cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap qm, km, vm, om;
  if (!encode_map(fn, &qm, type, q, D, S, B * Hq, kWgBQ) ||
      !encode_map(fn, &km, type, k, D, Skv, B * Hkv, kWgBKV) ||
      !encode_map(fn, &vm, type, v, D, Skv, B * Hkv, kWgBKV) ||
      !encode_map(fn, &om, type, o, D, S, B * Hq, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int smem = WgGeom<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kWgBQ - 1) / kWgBQ, Hq, B);
  const float log2e = 1.4426950408889634f;
  flash_attention_wgmma_kernel<T, D><<<grid, kWgThreads, smem, stream>>>(
      qm, km, vm, om, Hq, Hkv, S, Skv, scale * log2e, causal);
  return static_cast<int>(cudaGetLastError());
}

// Each head dim the wrapper accepts (a multiple of 16 in [16, 256]) is its
// own instantiation: O holds exactly D / 2 accumulators a thread.
template <typename T>
int launch_wgmma_d(const T* q, const T* k, const T* v, T* o, int B, int Hq,
                   int Hkv, int S, int Skv, int D, float scale, int causal,
                   cudaStream_t stream) {
  switch (D) {
#define REPRO_FLASH_D(DD)                                                   \
  case DD:                                                                  \
    return launch_wgmma<T, DD>(q, k, v, o, B, Hq, Hkv, S, Skv, scale,       \
                               causal, stream);
    REPRO_FLASH_D(16) REPRO_FLASH_D(32) REPRO_FLASH_D(48) REPRO_FLASH_D(64)
    REPRO_FLASH_D(80) REPRO_FLASH_D(96) REPRO_FLASH_D(112) REPRO_FLASH_D(128)
    REPRO_FLASH_D(144) REPRO_FLASH_D(160) REPRO_FLASH_D(176)
    REPRO_FLASH_D(192) REPRO_FLASH_D(208) REPRO_FLASH_D(224)
    REPRO_FLASH_D(240) REPRO_FLASH_D(256)
#undef REPRO_FLASH_D
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int BKV>
size_t smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (D + 1) +
                          static_cast<size_t>(BKV) * (D + 1) +
                          static_cast<size_t>(BKV) * D +
                          static_cast<size_t>(kBQ) * (BKV + 1) + 3 * kBQ);
}

template <typename T, int BKV>
int launch_tile(const T* q, const T* k, const T* v, T* o, int B, int Hq,
                int Hkv, int S, int Skv, int D, float scale, int causal,
                cudaStream_t stream) {
  const size_t smem = smem_bytes<BKV>(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, BKV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<T, BKV><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, Hq, Hkv, S, Skv, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int S, int Skv, int D, float scale, int causal,
           cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  if constexpr (!std::is_same<T, float>::value) {  // tensor cores
    return launch_wgmma_d<T>(qt, kt, vt, ot, B, Hq, Hkv, S, Skv, D, scale,
                             causal, stream);
  } else {  // f32: the CUDA cores
    return launch_tile<T, kFmaBKV>(qt, kt, vt, ot, B, Hq, Hkv, S, Skv, D,
                                   scale, causal, stream);
  }
}

}  // namespace

#define REPRO_FLASH_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o, \
                      int B, int Hq, int Hkv, int S, int Skv, int D,        \
                      float scale, int causal, void* stream) {              \
    return launch<T>(q, k, v, o, B, Hq, Hkv, S, Skv, D, scale, causal,      \
                     static_cast<cudaStream_t>(stream));                    \
  }

REPRO_FLASH_ENTRY(repro_flash_attention_f32, float)
REPRO_FLASH_ENTRY(repro_flash_attention_bf16, __nv_bfloat16)
REPRO_FLASH_ENTRY(repro_flash_attention_f16, __half)
