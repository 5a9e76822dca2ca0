// Mamba2 SSD chunked scan: y and the final state of
//     h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,   y_t = C_t^T h_t
// from h_0 = 0, per (batch, head), with B and C shared by the H / G heads
// of a group.
//
// Replaces: src/repro/kernels/ssd/kernel.py::ssd_scan (Pallas TPU).
//
// x (Bsz, S, H, P) and B, C (Bsz, S, G, N) in the model's type, each with
// a unit-stride last dimension and the other strides given (the serving
// path hands over views cut from one conv output, rows of 5,376 elements);
// dt (Bsz, S, H) and A (H,) f32, contiguous; y (Bsz, S, H, P) in x's type
// and the final state (Bsz, H, N, P) f32, contiguous.  N and P are at most
// 64; the chunk is L = 64.
//
// Bound: at the path's shapes (Bsz 8, S 2,048, H 80, P = N = 64, G 2, bf16)
// the bytes are x and y (2 x 167,772,160), dt (5,242,880), B and C (2 x
// 4,194,304) and the state (10,485,760): 0.107 ms at 3.35 TB/s.  The chunk
// products are about 4.3e10 flops, 0.044 ms on the bf16 tensor cores, so
// bytes bound the work, not operations, once the products leave the CUDA
// cores (there they took 0.65 ms at the f32 FMA rate alone).
//
// Design (bf16): the TPU kernel's grid was (Bsz * H, chunks) with the chunk
// axis in order, carrying the (N, P) state in VMEM scratch.  Here a block
// of four warps owns one (batch, head) and walks the chunks in order; three
// blocks fit an SM (76,288 bytes of shared memory,
// at most 168 registers a thread), so the 640 blocks of the path take two
// waves on 132 SMs.  Per chunk:
//   * x, B and C arrive as bf16 (rows padded to 16-byte multiples so that
//     ldmatrix is free of bank conflicts) and dt as f32, by 16-byte (dt:
//     4-byte) cp.async into one of two stages: chunk c + 1 is in flight
//     while chunk c computes.  Rows past S and columns past N or P are
//     zero-filled by the copy (dt = 0 there leaves the state as it was):
//     the tail chunk is masked, not padded.
//   * after the chunk's first __syncthreads each warp writes its rows of the
//     carried state to shared memory as bf16 hi and lo; a second one makes
//     them visible to every warp's C h (one buffer, no double-buffering).
//   * each warp forms acum = the prefix sum of dt A log2(e) itself (a
//     shuffle scan, the same on every warp) and wdt_s = 2^(acum_{L-1} -
//     acum_s) dt_s.  Exponentials are base 2 on the SFU (ex2.approx, about
//     2^-22 relative; a result below 2^-126 flushes to 0, where the true
//     factor is smaller still); every exponent is <= 0.
//   * warp w owns rows t in [16 w, 16 w + 16) of y.  Every product is
//     mma.sync m16n8k16 (bf16 in, f32 accumulators), operands by ldmatrix:
//       y   = 2^acum_t (C h)              C exact; h split hi + lo: 2 products
//       G   = (C B^T) 2^(acum_t - acum_s) dt_s for s <= t
//                                          C, B exact: 1 product, over the
//                                          key tiles s < 16 (w + 1) only
//       y  += G x                          G split hi + lo (formed from the
//                                          C B^T accumulators in registers
//                                          and fed back as the A fragment,
//                                          no round trip through shared
//                                          memory), x exact: 2 products
//     The decay exponent acum_t - acum_s is positive for s > t and can
//     overflow (inf * 0 is NaN): it is masked before the exp.
//   * warp w owns state rows n in [16 w, 16 w + 16), held in its f32
//     accumulators for the whole sequence:
//       h <- 2^acum_{L-1} h + (B wdt)^T x
//     (B wdt)^T comes from B by ldmatrix.trans, scaled by wdt in registers
//     and split hi + lo: 2 products.
// A split operand keeps 16 significant bits (|x - hi - lo| <= 2^-16 |x|),
// so each product is within about 2^-16 of its f32 value, far inside the
// plain version's tolerance (one bf16 ulp of y plus 1e-4 of max |y|, 1e-4
// of the state's max); TF32 (2^-11) would not hold the state's 1e-4.
// Every sum runs in a fixed order and there are no atomics, so a repeat is
// bitwise equal.  Splitting P over two blocks (1,280 blocks) recomputed
// C B^T and G per half and measured slower (PERF.md), as did two state
// buffers at two blocks an SM and accurate expf.
//
// Needs P and N multiples of 8 and 16-byte aligned rows (x, B and C base
// pointers and strides); the wrapper checks that and calls
// repro_ssd_scan_bf16_mma.  Other bf16 inputs, and f32 and fp16, run the
// CUDA-core kernel below (f32 FMA products from shared memory, one block of
// 256 threads per (batch, head), 4 x 4 outputs a thread): f32 keeps f32
// products, which a bf16 split would not, and fp16 has not bf16's exponent
// range for a split operand.
#include <math.h>

#include "common.cuh"
#include "mma_sync.cuh"

namespace {

constexpr int kL = 64;          // chunk length
constexpr int kW = 64;          // largest N and P

// -- bf16: tensor cores --------------------------------------------------------

constexpr int kMmaThreads = 128;   // four warps, 16 rows of a chunk each
constexpr int kLd = kW + 8;        // row of the x, B, C and state tiles (bf16)

struct Strides {
  long long xb, xs, xh;   // x (batch, step, head)
  long long bb, bs, bg;   // B (batch, step, group)
  long long cb, cs, cg;   // C
};

struct SsdSmem {
  static constexpr int kStage = 2 * 3 * kL * kLd + 4 * kL;  // x, B, C, dt
  static constexpr int kState = 2 * 2 * kW * kLd;           // state hi + lo
  static constexpr int kWarp = 4 * 2 * kL;                  // acum + wdt
  static constexpr int kBytes = 2 * kStage + kState + 4 * kWarp;
};

__global__ void __launch_bounds__(kMmaThreads, 3)
ssd_scan_mma_kernel(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ dt, const float* __restrict__ A,
                    const __nv_bfloat16* __restrict__ Bm,
                    const __nv_bfloat16* __restrict__ Cm,
                    __nv_bfloat16* __restrict__ y, float* __restrict__ state,
                    int S, int H, int P, int G, int N, Strides st) {
  using Sm = SsdSmem;
  constexpr int kNT = kW / 8;  // n-tiles of 8 columns over P
  extern __shared__ __align__(16) unsigned char smem[];
  // stage i: x, B, C (L, kLd) bf16, then dt (L) f32
  auto x_st = [&](int i) {
    return reinterpret_cast<__nv_bfloat16*>(smem + i * Sm::kStage);
  };
  auto b_st = [&](int i) { return x_st(i) + kL * kLd; };
  auto c_st = [&](int i) { return b_st(i) + kL * kLd; };
  auto dt_st = [&](int i) {
    return reinterpret_cast<float*>(c_st(i) + kL * kLd);
  };
  // the state before the current chunk: hi (64, kLd) then lo (64, kLd)
  __nv_bfloat16* hhi = reinterpret_cast<__nv_bfloat16*>(smem + 2 * Sm::kStage);
  __nv_bfloat16* hlo = hhi + kW * kLd;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, q = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int grp = h / (H / G);
  const float a_h = A[h] * 1.4426950408889634f;
  float* acum_w = reinterpret_cast<float*>(smem + 2 * Sm::kStage +
                                           Sm::kState) + warp * 2 * kL;
  float* wdt_w = acum_w + kL;

  const __nv_bfloat16* xg = x + b * st.xb + h * st.xh;
  const __nv_bfloat16* bg = Bm + b * st.bb + grp * st.bg;
  const __nv_bfloat16* cg = Cm + b * st.cb + grp * st.cg;
  const float* dtg = dt + static_cast<long long>(b) * S * H + h;

  auto load_chunk = [&](int ch, int i) {
    const int t0 = ch * kL;
    __nv_bfloat16* xs = x_st(i);
    __nv_bfloat16* bs = b_st(i);
    __nv_bfloat16* cs = c_st(i);
    for (int e = tid; e < kL * 8; e += kMmaThreads) {
      const int t = e >> 3, v = e & 7;
      const bool xin = t0 + t < S && 8 * v < P, bin = t0 + t < S && 8 * v < N;
      cp_async16(xs + t * kLd + 8 * v,
                 xin ? xg + (t0 + t) * st.xs + 8 * v : x, xin ? 16 : 0);
      cp_async16(bs + t * kLd + 8 * v,
                 bin ? bg + (t0 + t) * st.bs + 8 * v : Bm, bin ? 16 : 0);
      cp_async16(cs + t * kLd + 8 * v,
                 bin ? cg + (t0 + t) * st.cs + 8 * v : Cm, bin ? 16 : 0);
    }
    if (tid < kL) {
      const bool in = t0 + tid < S;
      cp_async4(dt_st(i) + tid,
                in ? dtg + static_cast<long long>(t0 + tid) * H : dt,
                in ? 4 : 0);
    }
  };

  float hacc[kNT][4];  // state rows 16 warp + (g8, g8 + 8)
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) hacc[j][i] = 0.f;
  }

  const int chunks = (S + kL - 1) / kL;
  load_chunk(0, 0);
  cp_async_commit();
  const int r0 = 16 * warp;  // this warp's rows of y and of the state
  for (int ch = 0; ch < chunks; ++ch) {
    const int cur = ch & 1;
    cp_async_wait<0>();
    __syncthreads();  // chunk ch has landed; chunk ch - 1's readers are done
    if (ch + 1 < chunks) load_chunk(ch + 1, cur ^ 1);
    cp_async_commit();
    // the state before this chunk, as bf16 hi + lo, for every warp's C h
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = 8 * j + 2 * q;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + g8 + 8 * half;
        uint32_t hi, lo;
        split_bf16x2(hacc[j][2 * half], hacc[j][2 * half + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(hhi + row * kLd + col) = hi;
        *reinterpret_cast<uint32_t*>(hlo + row * kLd + col) = lo;
      }
    }
    __syncthreads();

    const __nv_bfloat16* xs = x_st(cur);
    const __nv_bfloat16* bs = b_st(cur);
    const __nv_bfloat16* cs = c_st(cur);
    const float* dts = dt_st(cur);

    // acum: inclusive prefix sum of dt A log2(e), two steps a lane (every
    // warp); the exponentials below are base 2
    {
      const float a0 = dts[2 * lane] * a_h, a1 = dts[2 * lane + 1] * a_h;
      const float pair = a0 + a1;
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      const float excl = incl - pair;
      const float c0 = excl + a0, c1 = excl + pair;
      const float last = __shfl_sync(0xffffffffu, c1, 31);
      acum_w[2 * lane] = c0;
      acum_w[2 * lane + 1] = c1;
      wdt_w[2 * lane] = ex2(last - c0) * dts[2 * lane];
      wdt_w[2 * lane + 1] = ex2(last - c1) * dts[2 * lane + 1];
    }
    __syncwarp();

    // C fragments of this warp's rows (A operand, all of N)
    uint32_t cf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      ldsm_x4(cf[kk], cs + (r0 + (lane & 15)) * kLd + 16 * kk + 8 * (lane >> 4));
    }

    // y = 2^acum_t (C h), h the state before this chunk (hi + lo)
    float yacc[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) yacc[j][i] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int kr = 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        const int col = 16 * np + 8 * (lane >> 4);
        uint32_t bh[4], bl[4];
        ldsm_x4_t(bh, hhi + kr * kLd + col);
        ldsm_x4_t(bl, hlo + kr * kLd + col);
        mma_bf16(yacc[2 * np], cf[kk], bh[0], bh[1]);
        mma_bf16(yacc[2 * np + 1], cf[kk], bh[2], bh[3]);
        mma_bf16(yacc[2 * np], cf[kk], bl[0], bl[1]);
        mma_bf16(yacc[2 * np + 1], cf[kk], bl[2], bl[3]);
      }
    }
    const int ta = r0 + g8, tb = ta + 8;  // this thread's two rows
    const float acum_a = acum_w[ta], acum_b = acum_w[tb];
    {
      const float da = ex2(acum_a), db = ex2(acum_b);  // exponents <= 0
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        yacc[j][0] *= da;
        yacc[j][1] *= da;
        yacc[j][2] *= db;
        yacc[j][3] *= db;
      }
    }

    // G = (C B^T) 2^(acum_t - acum_s) dt_s, s <= t, over key tiles s < 16 (warp + 1)
    float gacc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) gacc[j][i] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int sp = 0; sp < 4; ++sp) {
        if (sp <= warp) {
          uint32_t bf[4];
          ldsm_x4(bf, bs + (16 * sp + (lane & 7) + 8 * (lane >> 4)) * kLd +
                          16 * kk + 8 * ((lane >> 3) & 1));
          mma_bf16(gacc[2 * sp], cf[kk], bf[0], bf[1]);
          mma_bf16(gacc[2 * sp + 1], cf[kk], bf[2], bf[3]);
        }
      }
    }
    uint32_t ghi[4][4], glo[4][4];  // G as A fragments, key tiles of 16
#pragma unroll
    for (int sp = 0; sp < 4; ++sp) {
      if (sp <= warp) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 2 * sp + half;
          const int s = 8 * j + 2 * q;
          const float as0 = acum_w[s], as1 = acum_w[s + 1];
          const float d0 = dts[s], d1 = dts[s + 1];
          // masked before the exp: acum_t - acum_s > 0 for s > t
          const float w00 = s <= ta ? ex2(acum_a - as0) * d0 : 0.f;
          const float w01 = s + 1 <= ta ? ex2(acum_a - as1) * d1 : 0.f;
          const float w10 = s <= tb ? ex2(acum_b - as0) * d0 : 0.f;
          const float w11 = s + 1 <= tb ? ex2(acum_b - as1) * d1 : 0.f;
          split_bf16x2(gacc[j][0] * w00, gacc[j][1] * w01,
                       ghi[sp][2 * half], glo[sp][2 * half]);
          split_bf16x2(gacc[j][2] * w10, gacc[j][3] * w11,
                       ghi[sp][2 * half + 1], glo[sp][2 * half + 1]);
        }
      }
    }

    // y += G x (G hi + lo)
#pragma unroll
    for (int sp = 0; sp < 4; ++sp) {
      if (sp <= warp) {
        const int kr = 16 * sp + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t xf[4];
          ldsm_x4_t(xf, xs + kr * kLd + 16 * np + 8 * (lane >> 4));
          mma_bf16(yacc[2 * np], ghi[sp], xf[0], xf[1]);
          mma_bf16(yacc[2 * np + 1], ghi[sp], xf[2], xf[3]);
          mma_bf16(yacc[2 * np], glo[sp], xf[0], xf[1]);
          mma_bf16(yacc[2 * np + 1], glo[sp], xf[2], xf[3]);
        }
      }
    }
    {
      const int t0 = ch * kL;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int tt = t0 + (half ? tb : ta);
        if (tt < S) {
          __nv_bfloat16* yrow =
              y + ((static_cast<long long>(b) * S + tt) * H + h) * P;
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            const int p = 8 * j + 2 * q;
            if (p < P) {
              *reinterpret_cast<__nv_bfloat162*>(yrow + p) =
                  __floats2bfloat162_rn(yacc[j][2 * half], yacc[j][2 * half + 1]);
            }
          }
        }
      }
    }

    // h <- 2^acum_{L-1} h + (B wdt)^T x, this warp's state rows
    {
      const float decay = ex2(acum_w[kL - 1]);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) hacc[j][i] *= decay;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t bt[4], ahi[4], alo[4];
        ldsm_x4_t(bt, bs + (16 * kk + (lane & 7) + 8 * (lane >> 4)) * kLd +
                          r0 + 8 * ((lane >> 3) & 1));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int s = 16 * kk + 2 * q + 8 * (i >> 1);
          const float2 v = unpack_bf16x2(bt[i]);
          split_bf16x2(v.x * wdt_w[s], v.y * wdt_w[s + 1], ahi[i], alo[i]);
        }
        const int kr = 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t xf[4];
          ldsm_x4_t(xf, xs + kr * kLd + 16 * np + 8 * (lane >> 4));
          mma_bf16(hacc[2 * np], ahi, xf[0], xf[1]);
          mma_bf16(hacc[2 * np + 1], ahi, xf[2], xf[3]);
          mma_bf16(hacc[2 * np], alo, xf[0], xf[1]);
          mma_bf16(hacc[2 * np + 1], alo, xf[2], xf[3]);
        }
      }
    }
  }

  float* out = state + (static_cast<long long>(b) * H + h) * N * P;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int p = 8 * j + 2 * q;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = r0 + g8 + 8 * half;
      if (n < N && p < P) {
        *reinterpret_cast<float2*>(out + n * P + p) =
            make_float2(hacc[j][2 * half], hacc[j][2 * half + 1]);
      }
    }
  }
}

// -- f32, fp16 and unaligned bf16: CUDA cores -------------------------------------

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ state, int S, int H, int P, int G,
                int N, Strides st) {
  extern __shared__ float smem_f[];
  constexpr int ldx = kW, ldb = kW + 1, ldg = kL + 1, ldh = kW;
  float* x_s = smem_f;                // (L, 64)   chunk of x
  float* b_s = x_s + kL * ldx;        // (L, 65)   chunk of B
  float* c_s = b_s + kL * ldb;        // (L, 65)   chunk of C
  float* g_s = c_s + kL * ldb;        // (L, 65)   decay-weighted scores
  float* h_s = g_s + kL * ldg;        // (64, 64)  carried state (N, P)
  float* acum_s = h_s + kW * ldh;     // (L,)
  float* wdt_s = acum_s + kL;         // (L,) exp(acum_{L-1} - acum_s) dt_s
  float* dt_s = wdt_s + kL;           // (L,)

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const float a_h = A[h];

  for (int e = tid; e < kW * ldh; e += kThreads) h_s[e] = 0.f;

  const int chunks = (S + kL - 1) / kL;
  for (int ch = 0; ch < chunks; ++ch) {
    const int t0 = ch * kL;
    __syncthreads();  // the previous chunk's readers are done
    for (int t = warp; t < kL; t += kThreads / 32) {
      const int tt = t0 + t;
      const bool in = tt < S;
      const long long row = static_cast<long long>(b) * S + tt;
      const T* xr = x + b * st.xb + tt * st.xs + h * st.xh;
      const T* br = Bm + b * st.bb + tt * st.bs + g * st.bg;
      const T* cr = Cm + b * st.cb + tt * st.cs + g * st.cg;
      for (int c = lane; c < kW; c += 32) {
        x_s[t * ldx + c] = in && c < P ? to_f32(xr[c]) : 0.f;
        b_s[t * ldb + c] = in && c < N ? to_f32(br[c]) : 0.f;
        c_s[t * ldb + c] = in && c < N ? to_f32(cr[c]) : 0.f;
      }
      if (lane == 0) dt_s[t] = in ? dt[row * H + h] : 0.f;
    }
    __syncthreads();
    if (warp == 0) {  // inclusive prefix sum of dt A, two steps a lane
      const float a0 = dt_s[2 * lane] * a_h;
      const float a1 = dt_s[2 * lane + 1] * a_h;
      const float pair = a0 + a1;
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      const float excl = incl - pair;
      acum_s[2 * lane] = excl + a0;
      acum_s[2 * lane + 1] = excl + pair;
    }
    __syncthreads();
    if (tid < kL) {
      wdt_s[tid] = expf(acum_s[kL - 1] - acum_s[tid]) * dt_s[tid];
    }

    // g[t][s] = (C_t . B_s) exp(acum_t - acum_s) dt_s for s <= t
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = c_s[(ty + 16 * i) * ldb + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = b_s[(tx + 16 * j) * ldb + n];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tx + 16 * j;
          // masked before the exp: acum_t - acum_s > 0 for s > t
          const float w = s <= t ? expf(acum_s[t] - acum_s[s]) * dt_s[s] : 0.f;
          g_s[t * ldg + s] = acc[i][j] * w;
        }
      }
    }
    __syncthreads();

    // y = g x + exp(acum) (C h), with h the state before this chunk
    {
      float intra[4][4], inter[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) intra[i][j] = inter[i][j] = 0.f;
      }
      for (int s = 0; s < kL; ++s) {
        float gv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) gv[i] = g_s[(ty + 16 * i) * ldg + s];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = x_s[s * ldx + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) intra[i][j] = fmaf(gv[i], xv[j], intra[i][j]);
        }
      }
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = c_s[(ty + 16 * i) * ldb + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) hv[j] = h_s[n * ldh + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) inter[i][j] = fmaf(cv[i], hv[j], inter[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        const int tt = t0 + t;
        const float decay = expf(acum_s[t]);
        if (tt < S) {
          const long long row = static_cast<long long>(b) * S + tt;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = tx + 16 * j;
            if (p < P) {
              y[(row * H + h) * P + p] =
                  from_f32<T>(intra[i][j] + decay * inter[i][j]);
            }
          }
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // h <- exp(acum_{L-1}) h + (B wdt)^T x; a thread owns its 4 x 4 entries
    {
      const float chunk_decay = expf(acum_s[kL - 1]);
      float dh[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) dh[i][j] = 0.f;
      }
      for (int s = 0; s < kL; ++s) {
        const float w = wdt_s[s];
        float bv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) bv[i] = b_s[s * ldb + ty + 16 * i] * w;
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = x_s[s * ldx + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) dh[i][j] = fmaf(bv[i], xv[j], dh[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = (ty + 16 * i) * ldh + tx + 16 * j;
          h_s[e] = chunk_decay * h_s[e] + dh[i][j];
        }
      }
    }
  }
  __syncthreads();
  float* out = state + (static_cast<long long>(b) * H + h) * N * P;
  for (int e = tid; e < N * P; e += kThreads) {
    out[e] = h_s[(e / P) * ldh + e % P];
  }
}

size_t fma_smem_bytes() {
  return sizeof(float) * (kL * kW + 2 * kL * (kW + 1) + kL * (kL + 1) +
                          kW * kW + 3 * kL);
}

template <typename T>
int launch_fma(const void* x, const float* dt, const float* A, const void* Bm,
               const void* Cm, void* y, float* state, int Bsz, int S, int H,
               int P, int G, int N, const Strides& st, cudaStream_t stream) {
  const size_t smem = fma_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, Bsz);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), state, S, H, P, G, N, st);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma(const void* x, const float* dt, const float* A, const void* Bm,
               const void* Cm, void* y, float* state, int Bsz, int S, int H,
               int P, int G, int N, const Strides& st, cudaStream_t stream) {
  const int smem = SsdSmem::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, Bsz);
  ssd_scan_mma_kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), dt, A,
      static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), static_cast<__nv_bfloat16*>(y),
      state, S, H, P, G, N, st);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core kernel's conditions: P, N multiples of 8, rows of x, B
// and C 16-byte aligned.
bool mma_fits(const void* x, const void* Bm, const void* Cm, int P, int N,
              const Strides& st) {
  auto al = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  };
  auto al8 = [](long long s) { return s % 8 == 0; };
  return P % 8 == 0 && N % 8 == 0 && al(x) && al(Bm) && al(Cm) &&
         al8(st.xb) && al8(st.xs) && al8(st.xh) && al8(st.bb) && al8(st.bs) &&
         al8(st.bg) && al8(st.cb) && al8(st.cs) && al8(st.cg);
}

}  // namespace

#define REPRO_SSD_ARGS                                                        \
  const void *x, const float *dt, const float *A, const void *Bm,           \
      const void *Cm, void *y, float *state, int Bsz, int S, int H, int P,  \
      int G, int N, long long sxb, long long sxs, long long sxh,            \
      long long sbb, long long sbs, long long sbg, long long scb,           \
      long long scs, long long scg, void *stream

#define REPRO_SSD_STRIDES                                                     \
  const Strides st{sxb, sxs, sxh, sbb, sbs, sbg, scb, scs, scg};            \
  cudaStream_t s = static_cast<cudaStream_t>(stream);

// The wrapper picks the entry (ssd_tensor_cores in kernels/ssd/kernel.py);
// the tensor-core one refuses inputs that do not meet its conditions.
extern "C" int repro_ssd_scan_bf16_mma(REPRO_SSD_ARGS) {
  REPRO_SSD_STRIDES
  if (!mma_fits(x, Bm, Cm, P, N, st)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_mma(x, dt, A, Bm, Cm, y, state, Bsz, S, H, P, G, N, st, s);
}

extern "C" int repro_ssd_scan_bf16(REPRO_SSD_ARGS) {
  REPRO_SSD_STRIDES
  return launch_fma<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, Bsz, S, H, P,
                                   G, N, st, s);
}

extern "C" int repro_ssd_scan_f32(REPRO_SSD_ARGS) {
  REPRO_SSD_STRIDES
  return launch_fma<float>(x, dt, A, Bm, Cm, y, state, Bsz, S, H, P, G, N, st,
                           s);
}

extern "C" int repro_ssd_scan_f16(REPRO_SSD_ARGS) {
  REPRO_SSD_STRIDES
  return launch_fma<__half>(x, dt, A, Bm, Cm, y, state, Bsz, S, H, P, G, N,
                            st, s);
}
