// RWKV6 (Finch) WKV chunked scan with log-space decay and the u bonus:
// y and the final state of
//     S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T
//     y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
// from S_0 = 0, per (batch, head).
//
// Replaces: src/repro/kernels/rwkv6/kernel.py::rwkv6_scan_log (Pallas TPU;
// its linear-decay wrapper rwkv6_scan calls it).
//
// r, k (Bsz, S, H, K) and v (Bsz, S, H, V) in the model's type, logw
// (Bsz, S, H, K) f32, finite and <= 0, u (H, K) in the model's type read as
// f32; y (Bsz, S, H, V) in r's type, the final state (Bsz, H, K, V) f32.
// K and V are at most 64.
//
// Bound: at the path's shape (Bsz 8, S 2,048, H 40, K = V = 64, bf16) the
// bytes are r, k, v and y in bf16 (4 x 83,886,080), logw in f32
// (167,772,160) and the f32 state (5,242,880): 508.6 MB, 0.152 ms at
// 3.35 TB/s.  The chunk products (about 1.5e10 flops) are far below the
// tensor-core line, so bytes bound the work.  The pairwise decays are what
// the CUDA cores would otherwise spend their time on: the first version
// formed one accurate expf per (t, s < t, channel) of each 32-row chunk,
// 6.5e8 a call, and replacing them by a constant took its time from 1.560
// to 1.280 ms on an H100 (kernels/scan_probe.py --lib, PERF.md).
//
// Design (bf16): the TPU kernel's grid was (Bsz * H, chunks) with the chunk
// axis in order, carrying the (K, V) state in VMEM scratch.  Here a block
// of four warps owns one (batch, head) and walks chunks of L = 64 in order;
// three blocks fit an SM (68,368 bytes of shared
// memory, at most 168 registers a thread), so the path's 320 blocks run in
// one wave on 132 SMs.  Warp w owns rows t in [16 w, 16 w + 16) of y (the
// sub-chunks 2 w and 2 w + 1 of eight rows) and rows c in [16 w, 16 w + 16)
// of the state, which stays in its f32 accumulators for the whole
// sequence.  Exponents are taken in base 2 (W = the prefix sum of logw
// log2(e) down the chunk, Wprev[t] = W[t - 1], W[-1] = 0) on the SFU
// (ex2.approx, about 2^-22 relative; a result below 2^-126 flushes to 0,
// where the true factor is smaller still): with every held tolerance
// unchanged this replaced accurate expf.  Per chunk:
//   1. after the first __syncthreads each warp writes its state rows to
//      shared memory as bf16 hi and lo (one buffer: every reader of the
//      previous state is past that barrier); r, k, v (bf16) and logw (f32)
//      arrive by 16-byte cp.async, rows past S and channels past K / V
//      zero-filled (r = k = v = 0 and logw = 0 add nothing and leave the
//      state as it was: the tail is masked, not padded);
//   2. W, two threads a channel (32 rows each, the second adding the
//      first's total);
//   3. the sub-chunk factorisation (as the public flash-linear-attention
//      RWKV6 kernels do): for a query row t and a key s <= ref < t,
//          exp(Wprev[t] - W[s]) = exp(Wprev[t] - W[ref]) exp(W[ref] - W[s])
//      with both exponents <= 0, so G's blocks off the diagonal are
//      tensor-core products of (r exp(Wprev - W[ref])) and
//      (k exp(W[ref] - W))^T.  Warp w's keys s < 16 w take ref = 16 w - 1
//      (the row before its sub-chunk 2 w); its sub-chunk 2 w + 1 against the
//      keys of sub-chunk 2 w takes ref = 16 w + 7.  Only the two diagonal
//      8 x 8 blocks keep the ratio form exp(Wprev[t] - W[s]) per (t, s < t,
//      channel), on the CUDA cores, masked before the exp as before (28
//      pairs a block, one a lane); the bonus r_t . (u k_t) sits on the
//      diagonal.  No exponent above 0 is ever formed.  One pass per 16
//      channels forms this warp's A operand and runs the inter-chunk and
//      factored products with it;
//   4. y = (r exp(Wprev)) S + G v and S <- exp(W[L-1]) S
//      + (k exp(W[L-1] - W))^T v, all mma.sync m16n8k16 (bf16 in, f32
//      accumulators; operands by ldmatrix).  G is formed in the
//      accumulators and fed back as the A fragment without a trip through
//      shared memory.
// Precision: v is exact in bf16; an f32 operand is split into bf16 hi + lo
// (|x - hi - lo| <= 2^-16 |x|): G and the state update's operand take two
// products (hi, lo against v), the products of two f32 operands (the
// inter-chunk term against the state, the factored blocks of G) three
// (hi hi + hi lo + lo hi), about 2^-15 of each product, well inside the
// plain version's tolerance (one bf16 ulp of y plus 1e-4 of max |y|, 1e-4
// of the state's max).  Every sum runs in a fixed order and there are no
// atomics, so a repeat is bitwise equal.  Splitting V over two blocks (640
// blocks) recomputed G per half and measured slower (PERF.md), as did a
// shared table of k exp(W[e(s)] - W[s]) at two blocks an SM.
//
// Needs K and V multiples of 8 and 16-byte aligned rows; the wrapper checks
// that and calls repro_rwkv6_scan_bf16_mma.  Other bf16 inputs, and f32 and
// fp16, run the CUDA-core kernel below (chunks of 32, one block
// of 256 threads per (batch, head), the ratio form for every pair, accurate
// expf, f32 FMA products): f32 keeps f32 products, which a bf16 split would
// not, and fp16 has not bf16's exponent range for a split operand.
#include <math.h>

#include "common.cuh"
#include "mma_sync.cuh"

namespace {

// -- f32, fp16 and unaligned bf16: CUDA cores ---------------------------------------

constexpr int kFL = 32;         // chunk length of the CUDA-core kernel
constexpr int kW = 64;          // largest K and V
constexpr int kLd = kW + 1;     // padded row of the (L, 64) tiles
constexpr int kLg = kFL + 1;    // padded row of G
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
rwkv6_scan_fma_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ logw,
                      const T* __restrict__ u, T* __restrict__ y,
                      float* __restrict__ state, int S, int H, int K, int V) {
  extern __shared__ float smem_f[];
  float* r_s = smem_f;               // (L, 65) r, then r exp(Wprev)
  float* k_s = r_s + kFL * kLd;      // (L, 65) k, then k exp(W[L-1] - W)
  float* v_s = k_s + kFL * kLd;      // (L, 65) v
  float* w_s = v_s + kFL * kLd;      // (L, 65) logw, then W
  float* wp_s = w_s + kFL * kLd;     // (L, 65) Wprev = W - logw
  float* s_s = wp_s + kFL * kLd;     // (64, 64) carried state (K, V)
  float* g_s = s_s + kW * kW;        // (L, 33) scores, bonus on the diagonal
  float* u_s = g_s + kFL * kLg;      // (64,)
  float* cd_s = u_s + kW;            // (64,) exp(W[L-1])

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, b = blockIdx.y;

  for (int e = tid; e < kW * kW; e += kThreads) s_s[e] = 0.f;
  if (tid < kW) u_s[tid] = tid < K ? to_f32(u[h * K + tid]) : 0.f;

  const int chunks = (S + kFL - 1) / kFL;
  for (int ch = 0; ch < chunks; ++ch) {
    const int t0 = ch * kFL;
    __syncthreads();  // the previous chunk's readers are done

    // 1. stage the chunk; rows past S and channels past K / V read as 0
    for (int t = warp; t < kFL; t += kThreads / 32) {
      const int tt = t0 + t;
      const bool in = tt < S;
      const long long row = (static_cast<long long>(b) * S + tt) * H + h;
      for (int c = lane; c < kW; c += 32) {
        const bool ck = in && c < K, cv = in && c < V;
        r_s[t * kLd + c] = ck ? to_f32(r[row * K + c]) : 0.f;
        k_s[t * kLd + c] = ck ? to_f32(k[row * K + c]) : 0.f;
        w_s[t * kLd + c] = ck ? logw[row * K + c] : 0.f;
        v_s[t * kLd + c] = cv ? to_f32(v[row * V + c]) : 0.f;
      }
    }
    __syncthreads();

    // 2. W = inclusive prefix sum of logw, Wprev = W - logw
    if (tid < kW) {
      float acc = 0.f;
      for (int t = 0; t < kFL; ++t) {
        const float lw = w_s[t * kLd + tid];
        acc += lw;
        w_s[t * kLd + tid] = acc;
        wp_s[t * kLd + tid] = acc - lw;
      }
    }
    __syncthreads();

    // 3. G: warp w takes the row pairs p = w + 1 and p = w + 9, i.e. rows
    // (p, 32 - p), whose p + (32 - p) entries below the diagonal are one a
    // lane (p = 16 is row 16 alone, 16 lanes)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = warp + 1 + 8 * half;
      if (p == kFL / 2 && lane >= p) continue;
      const int t = lane < p ? p : kFL - p;
      const int s = lane < p ? lane : lane - p;
      const float* rt = r_s + t * kLd;
      const float* wpt = wp_s + t * kLd;
      const float* ks = k_s + s * kLd;
      const float* ws = w_s + s * kLd;
      float acc = 0.f;
#pragma unroll 8
      for (int c = 0; c < K; ++c) {
        acc = fmaf(rt[c] * ks[c], expf(wpt[c] - ws[c]), acc);
      }
      g_s[t * kLg + s] = acc;
    }
    if (warp == 0) {  // the bonus r_t . (u * k_t) on the diagonal
      float acc = 0.f;
      for (int c = 0; c < K; ++c) {
        acc = fmaf(r_s[lane * kLd + c] * u_s[c], k_s[lane * kLd + c], acc);
      }
      g_s[lane * kLg + lane] = acc;
    }
    for (int e = tid; e < kFL * kFL; e += kThreads) {
      const int t = e / kFL, s = e % kFL;
      if (s > t) g_s[t * kLg + s] = 0.f;
    }
    __syncthreads();

    // 4. the decays of the inter-chunk and state terms (exponents <= 0)
    const float* wlast = w_s + (kFL - 1) * kLd;
    for (int e = tid; e < kFL * kW; e += kThreads) {
      const int i = (e / kW) * kLd + e % kW;
      r_s[i] *= expf(wp_s[i]);
      k_s[i] *= expf(wlast[e % kW] - w_s[i]);
    }
    if (tid < kW) cd_s[tid] = expf(wlast[tid]);
    __syncthreads();

    // 5. y = (r exp(Wprev)) S + G v, with S the state before this chunk;
    // a thread owns rows ty, ty + 16 and columns tx + 16 j
    {
      float inter[2][4], intra[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) inter[i][j] = intra[i][j] = 0.f;
      }
      for (int c = 0; c < K; ++c) {
        const float a0 = r_s[ty * kLd + c], a1 = r_s[(ty + 16) * kLd + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float sv = s_s[c * kW + tx + 16 * j];
          inter[0][j] = fmaf(a0, sv, inter[0][j]);
          inter[1][j] = fmaf(a1, sv, inter[1][j]);
        }
      }
      for (int s = 0; s < kFL; ++s) {
        const float g0 = g_s[ty * kLg + s], g1 = g_s[(ty + 16) * kLg + s];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float vv = v_s[s * kLd + tx + 16 * j];
          intra[0][j] = fmaf(g0, vv, intra[0][j]);
          intra[1][j] = fmaf(g1, vv, intra[1][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int tt = t0 + ty + 16 * i;
        if (tt < S) {
          const long long row = (static_cast<long long>(b) * S + tt) * H + h;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = tx + 16 * j;
            if (c < V) y[row * V + c] = from_f32<T>(inter[i][j] + intra[i][j]);
          }
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // 6. S <- exp(W[L-1]) S + (k exp(W[L-1] - W))^T v; a thread owns its
    // 4 x 4 entries (rows ty + 16 i, columns tx + 16 j)
    {
      float ds[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) ds[i][j] = 0.f;
      }
      for (int s = 0; s < kFL; ++s) {
        float kv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) kv[i] = k_s[s * kLd + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) vv[j] = v_s[s * kLd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) ds[i][j] = fmaf(kv[i], vv[j], ds[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dec = cd_s[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = (ty + 16 * i) * kW + tx + 16 * j;
          s_s[e] = dec * s_s[e] + ds[i][j];
        }
      }
    }
  }
  __syncthreads();
  float* out = state + (static_cast<long long>(b) * H + h) * K * V;
  for (int e = tid; e < K * V; e += kThreads) {
    out[e] = s_s[(e / V) * kW + e % V];
  }
}

// -- bf16: tensor cores ----------------------------------------------------------

constexpr int kL = 64;             // chunk length
constexpr int kMmaThreads = 128;   // four warps, 16 rows of a chunk each
constexpr int kLdT = kW + 8;       // row of the r, k, v and state tiles (bf16)
constexpr int kLdW = kW + 4;       // row of the W tile (f32)
constexpr int kLdG = 17;           // row of a warp's diagonal scores (f32)
constexpr float kLog2e = 1.4426950408889634f;

struct RwkvSmem {
  static constexpr int kR = 0;                              // r (L, kLdT)
  static constexpr int kK = kR + 2 * kL * kLdT;              // k (L, kLdT)
  static constexpr int kV = kK + 2 * kL * kLdT;              // v (L, kLdT)
  static constexpr int kWt = kV + 2 * kL * kLdT;             // W (L + 1, kLdW)
  static constexpr int kU = kWt + 4 * (kL + 1) * kLdW;      // u (64)
  static constexpr int kG = kU + 4 * kW;                    // 4 x (16, 17)
  static constexpr int kSt = kG + 4 * 4 * 16 * kLdG;        // state hi, lo
  static constexpr int kBytes = kSt + 2 * 2 * kW * kLdT;
};

// d += a b with both operands f32 split hi + lo: hi hi + hi lo + lo hi.
__device__ __forceinline__ void mma3(float* d, const uint32_t* ahi,
                                     const uint32_t* alo, uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_bf16(d, ahi, bh0, bh1);
  mma_bf16(d, ahi, bl0, bl1);
  mma_bf16(d, alo, bh0, bh1);
}

__device__ __forceinline__ float2 ld_bf16x2(const __nv_bfloat16* p) {
  return unpack_bf16x2(*reinterpret_cast<const uint32_t*>(p));
}

__device__ __forceinline__ float2 ld_f32x2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__global__ void __launch_bounds__(kMmaThreads, 3)
rwkv6_scan_mma_kernel(const __nv_bfloat16* __restrict__ r,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const float* __restrict__ logw,
                      const __nv_bfloat16* __restrict__ u,
                      __nv_bfloat16* __restrict__ y, float* __restrict__ state,
                      int S, int H, int K, int V) {
  using Sm = RwkvSmem;
  constexpr int kNT = kW / 8;  // n-tiles of 8 columns over V
  extern __shared__ __align__(16) unsigned char smem[];
  auto* r_s = reinterpret_cast<__nv_bfloat16*>(smem + Sm::kR);
  auto* k_s = reinterpret_cast<__nv_bfloat16*>(smem + Sm::kK);
  auto* v_s = reinterpret_cast<__nv_bfloat16*>(smem + Sm::kV);
  auto* w_s = reinterpret_cast<float*>(smem + Sm::kWt);  // row 0: W[-1] = 0
  auto* u_s = reinterpret_cast<float*>(smem + Sm::kU);
  auto* shi = reinterpret_cast<__nv_bfloat16*>(smem + Sm::kSt);
  __nv_bfloat16* slo = shi + kW * kLdT;
  auto wrow = [&](int t) { return w_s + (t + 1) * kLdW; };  // W[t], t >= -1

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, q = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  float* gs = reinterpret_cast<float*>(smem + Sm::kG) + warp * 16 * kLdG;

  for (int e = tid; e < kLdW; e += kMmaThreads) w_s[e] = 0.f;
  if (tid < kW) u_s[tid] = tid < K ? __bfloat162float(u[h * K + tid]) : 0.f;

  float hacc[kNT][4];  // state rows 16 warp + (g8, g8 + 8), this block's V
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) hacc[j][i] = 0.f;
  }

  const int r0 = 16 * warp;             // this warp's rows of y and the state
  const int ta = r0 + g8, tb = ta + 8;  // this thread's two rows
  const int chunks = (S + kL - 1) / kL;
  for (int ch = 0; ch < chunks; ++ch) {
    const int t0 = ch * kL;
    __syncthreads();  // the previous chunk's readers are done

    // the state before this chunk, as bf16 hi + lo, for the inter-chunk term
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = 8 * j + 2 * q;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = half ? tb : ta;
        uint32_t hi, lo;
        split_bf16x2(hacc[j][2 * half], hacc[j][2 * half + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(shi + row * kLdT + col) = hi;
        *reinterpret_cast<uint32_t*>(slo + row * kLdT + col) = lo;
      }
    }

    // stage the chunk
    for (int e = tid; e < kL * 8; e += kMmaThreads) {
      const int t = e >> 3, c8 = e & 7;
      const bool in = t0 + t < S && 8 * c8 < K;
      const long long row = (static_cast<long long>(b) * S + t0 + t) * H + h;
      cp_async16(r_s + t * kLdT + 8 * c8, in ? r + row * K + 8 * c8 : r,
                 in ? 16 : 0);
      cp_async16(k_s + t * kLdT + 8 * c8, in ? k + row * K + 8 * c8 : k,
                 in ? 16 : 0);
    }
    for (int e = tid; e < kL * 16; e += kMmaThreads) {
      const int t = e >> 4, c4 = e & 15;
      const bool in = t0 + t < S && 4 * c4 < K;
      const long long row = (static_cast<long long>(b) * S + t0 + t) * H + h;
      cp_async16(wrow(t) + 4 * c4, in ? logw + row * K + 4 * c4 : logw,
                 in ? 16 : 0);
    }
    for (int e = tid; e < kL * 8; e += kMmaThreads) {
      const int t = e >> 3, c8 = e & 7;
      const bool in = t0 + t < S && 8 * c8 < V;
      const long long row = (static_cast<long long>(b) * S + t0 + t) * H + h;
      cp_async16(v_s + t * kLdT + 8 * c8, in ? v + row * V + 8 * c8 : v,
                 in ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // 2. W = prefix sum of logw log2(e): channel tid / 2, rows 32 (tid & 1);
    // the second half adds the first half's total
    {
      const int c = tid >> 1, half = tid & 1;
      float* col = wrow(32 * half) + c;
      float total = 0.f;
#pragma unroll 8
      for (int i = 0; i < 32; ++i) total += col[i * kLdW] * kLog2e;
      const float first = __shfl_sync(0xffffffffu, total, lane & ~1);
      float acc = half ? first : 0.f;
#pragma unroll 8
      for (int i = 0; i < 32; ++i) {
        acc += col[i * kLdW] * kLog2e;
        col[i * kLdW] = acc;
      }
    }
    __syncthreads();

    // 3. per 16 channels kk: this warp's A operand ra = r exp(Wprev - W[ref]),
    // ref = r0 - 1, then
    //   y  = (r exp(Wprev)) S: ra exp(W[ref]) against the state (hi + lo);
    //   G  = ra (k exp(W[ref] - W))^T over the keys s < 16 warp;
    //   G += (r exp(Wprev - W[r0 + 7])) (k exp(W[r0 + 7] - W))^T for the rows
    //        of sub-chunk 2 warp + 1 (A rows g8 + 8 only) against the keys of
    //        sub-chunk 2 warp
    const float* wref = wrow(r0 - 1);
    const float* wb = wrow(r0 + 7);
    float yacc[kNT][4], gacc[8][4];
    float gin[4] = {0.f, 0.f, 0.f, 0.f};  // G's block of sub-chunk 2 warp + 1
                                          // against sub-chunk 2 warp
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) yacc[j][i] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) gacc[j][i] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c = 16 * kk + 2 * q;
      uint32_t ahi[4], alo[4], ihi[4], ilo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = (i & 1) ? tb : ta;
        const int cc = c + 8 * (i >> 1);
        const float2 rr = ld_bf16x2(r_s + t * kLdT + cc);
        const float2 wt = ld_f32x2(wrow(t - 1) + cc);
        const float2 wr = ld_f32x2(wref + cc);
        const float ra0 = rr.x * ex2(wt.x - wr.x), ra1 = rr.y * ex2(wt.y - wr.y);
        split_bf16x2(ra0, ra1, ahi[i], alo[i]);
        split_bf16x2(ra0 * ex2(wr.x), ra1 * ex2(wr.y), ihi[i], ilo[i]);
      }
      const int kr = 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        const int col = 16 * np + 8 * (lane >> 4);
        uint32_t bh[4], bl[4];
        ldsm_x4_t(bh, shi + kr * kLdT + col);
        ldsm_x4_t(bl, slo + kr * kLdT + col);
        mma3(yacc[2 * np], ihi, ilo, bh[0], bh[1], bl[0], bl[1]);
        mma3(yacc[2 * np + 1], ihi, ilo, bh[2], bh[3], bl[2], bl[3]);
      }
      const float2 wr0 = ld_f32x2(wref + c), wr1 = ld_f32x2(wref + c + 8);
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        if (j < 2 * warp) {
          const int s = 8 * j + g8;
          const float2 k0 = ld_bf16x2(k_s + s * kLdT + c);
          const float2 k1 = ld_bf16x2(k_s + s * kLdT + c + 8);
          const float2 w0 = ld_f32x2(wrow(s) + c), w1 = ld_f32x2(wrow(s) + c + 8);
          uint32_t bh0, bl0, bh1, bl1;
          split_bf16x2(k0.x * ex2(wr0.x - w0.x), k0.y * ex2(wr0.y - w0.y), bh0, bl0);
          split_bf16x2(k1.x * ex2(wr1.x - w1.x), k1.y * ex2(wr1.y - w1.y), bh1, bl1);
          mma3(gacc[j], ahi, alo, bh0, bh1, bl0, bl1);
        }
      }
      uint32_t rhi[4] = {0u, 0u, 0u, 0u}, rlo[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 1; i < 4; i += 2) {
        const int cc = c + 8 * (i >> 1);
        const float2 rr = ld_bf16x2(r_s + tb * kLdT + cc);
        const float2 wt = ld_f32x2(wrow(tb - 1) + cc);
        const float2 wr = ld_f32x2(wb + cc);
        split_bf16x2(rr.x * ex2(wt.x - wr.x), rr.y * ex2(wt.y - wr.y),
                     rhi[i], rlo[i]);
      }
      const int s = r0 + g8;
      const float2 k0 = ld_bf16x2(k_s + s * kLdT + c);
      const float2 k1 = ld_bf16x2(k_s + s * kLdT + c + 8);
      const float2 w0 = ld_f32x2(wrow(s) + c), w1 = ld_f32x2(wrow(s) + c + 8);
      const float2 wb0 = ld_f32x2(wb + c), wb1 = ld_f32x2(wb + c + 8);
      uint32_t bh0, bl0, bh1, bl1;
      split_bf16x2(k0.x * ex2(wb0.x - w0.x), k0.y * ex2(wb0.y - w0.y), bh0, bl0);
      split_bf16x2(k1.x * ex2(wb1.x - w1.x), k1.y * ex2(wb1.y - w1.y), bh1, bl1);
      mma3(gin, rhi, rlo, bh0, bh1, bl0, bl1);
    }

    // 3b. the two diagonal 8 x 8 blocks in the ratio form, one (t, s < t)
    // pair a lane, masked before the exp; the bonus r_t . (u k_t)
    for (int e = lane; e < 16 * kLdG; e += 32) gs[e] = 0.f;
    __syncwarp();
#pragma unroll
    for (int sub = 0; sub < 2; ++sub) {
      if (lane < 28) {
        int ti = 1, si = lane;
        while (si >= ti) {
          si -= ti;
          ++ti;
        }
        const int t = r0 + 8 * sub + ti, s = r0 + 8 * sub + si;
        const __nv_bfloat16* rt = r_s + t * kLdT;
        const __nv_bfloat16* ks = k_s + s * kLdT;
        const float* wt = wrow(t - 1);
        const float* wsr = wrow(s);
        float acc = 0.f;
#pragma unroll 2
        for (int c = 0; c < kW; c += 8) {
          const uint4 rv = *reinterpret_cast<const uint4*>(rt + c);
          const uint4 kv = *reinterpret_cast<const uint4*>(ks + c);
          const float4 wt0 = *reinterpret_cast<const float4*>(wt + c);
          const float4 wt1 = *reinterpret_cast<const float4*>(wt + c + 4);
          const float4 ws0 = *reinterpret_cast<const float4*>(wsr + c);
          const float4 ws1 = *reinterpret_cast<const float4*>(wsr + c + 4);
          const float2 r01 = unpack_bf16x2(rv.x), r23 = unpack_bf16x2(rv.y);
          const float2 r45 = unpack_bf16x2(rv.z), r67 = unpack_bf16x2(rv.w);
          const float2 k01 = unpack_bf16x2(kv.x), k23 = unpack_bf16x2(kv.y);
          const float2 k45 = unpack_bf16x2(kv.z), k67 = unpack_bf16x2(kv.w);
          acc = fmaf(r01.x * k01.x, ex2(wt0.x - ws0.x), acc);
          acc = fmaf(r01.y * k01.y, ex2(wt0.y - ws0.y), acc);
          acc = fmaf(r23.x * k23.x, ex2(wt0.z - ws0.z), acc);
          acc = fmaf(r23.y * k23.y, ex2(wt0.w - ws0.w), acc);
          acc = fmaf(r45.x * k45.x, ex2(wt1.x - ws1.x), acc);
          acc = fmaf(r45.y * k45.y, ex2(wt1.y - ws1.y), acc);
          acc = fmaf(r67.x * k67.x, ex2(wt1.z - ws1.z), acc);
          acc = fmaf(r67.y * k67.y, ex2(wt1.w - ws1.w), acc);
        }
        gs[(8 * sub + ti) * kLdG + 8 * sub + si] = acc;
      }
    }
    {
      const int tl = lane & 15, c0 = 32 * (lane >> 4);
      const __nv_bfloat16* rt = r_s + (r0 + tl) * kLdT + c0;
      const __nv_bfloat16* kt = k_s + (r0 + tl) * kLdT + c0;
      float acc = 0.f;
#pragma unroll 4
      for (int c = 0; c < 32; c += 2) {
        const float2 rr = ld_bf16x2(rt + c), kk2 = ld_bf16x2(kt + c);
        acc = fmaf(rr.x * u_s[c0 + c], kk2.x, acc);
        acc = fmaf(rr.y * u_s[c0 + c + 1], kk2.y, acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 16);
      if (lane < 16) gs[tl * kLdG + tl] = acc;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if ((j >> 1) == warp) {
        const int col = 8 * (j & 1) + 2 * q;
        const bool in = (j & 1) == 0;
        gacc[j][0] = gs[g8 * kLdG + col];
        gacc[j][1] = gs[g8 * kLdG + col + 1];
        gacc[j][2] = gs[(g8 + 8) * kLdG + col] + (in ? gin[2] : 0.f);
        gacc[j][3] = gs[(g8 + 8) * kLdG + col + 1] + (in ? gin[3] : 0.f);
      }
    }

    // 4a. y += G v, G split hi + lo as the A operand, key tiles s < 16 (warp + 1)
#pragma unroll
    for (int sp = 0; sp < 4; ++sp) {
      if (sp <= warp) {
        uint32_t ghi[4], glo[4];
        split_bf16x2(gacc[2 * sp][0], gacc[2 * sp][1], ghi[0], glo[0]);
        split_bf16x2(gacc[2 * sp][2], gacc[2 * sp][3], ghi[1], glo[1]);
        split_bf16x2(gacc[2 * sp + 1][0], gacc[2 * sp + 1][1], ghi[2], glo[2]);
        split_bf16x2(gacc[2 * sp + 1][2], gacc[2 * sp + 1][3], ghi[3], glo[3]);
        const int kr = 16 * sp + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t vf[4];
          ldsm_x4_t(vf, v_s + kr * kLdT + 16 * np + 8 * (lane >> 4));
          mma_bf16(yacc[2 * np], ghi, vf[0], vf[1]);
          mma_bf16(yacc[2 * np + 1], ghi, vf[2], vf[3]);
          mma_bf16(yacc[2 * np], glo, vf[0], vf[1]);
          mma_bf16(yacc[2 * np + 1], glo, vf[2], vf[3]);
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int tt = t0 + (half ? tb : ta);
      if (tt < S) {
        __nv_bfloat16* yrow =
            y + ((static_cast<long long>(b) * S + tt) * H + h) * V;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int c = 8 * j + 2 * q;
          if (c < V) {
            *reinterpret_cast<__nv_bfloat162*>(yrow + c) =
                __floats2bfloat162_rn(yacc[j][2 * half], yacc[j][2 * half + 1]);
          }
        }
      }
    }

    // 4b. S <- exp(W[L-1]) S + (k exp(W[L-1] - W))^T v, this warp's state
    // rows c = r0 + (g8, g8 + 8)
    {
      const float* wl = wrow(kL - 1);
      const float la = wl[ta], lb = wl[tb];
      const float da = ex2(la), db = ex2(lb);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        hacc[j][0] *= da;
        hacc[j][1] *= da;
        hacc[j][2] *= db;
        hacc[j][3] *= db;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = (i & 1) ? tb : ta;
          const float lc = (i & 1) ? lb : la;
          const int s = 16 * kk + 2 * q + 8 * (i >> 1);
          const float k0 = __bfloat162float(k_s[s * kLdT + c]);
          const float k1 = __bfloat162float(k_s[(s + 1) * kLdT + c]);
          split_bf16x2(k0 * ex2(lc - wrow(s)[c]), k1 * ex2(lc - wrow(s + 1)[c]),
                       ahi[i], alo[i]);
        }
        const int kr = 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t vf[4];
          ldsm_x4_t(vf, v_s + kr * kLdT + 16 * np + 8 * (lane >> 4));
          mma_bf16(hacc[2 * np], ahi, vf[0], vf[1]);
          mma_bf16(hacc[2 * np + 1], ahi, vf[2], vf[3]);
          mma_bf16(hacc[2 * np], alo, vf[0], vf[1]);
          mma_bf16(hacc[2 * np + 1], alo, vf[2], vf[3]);
        }
      }
    }
  }

  float* out = state + (static_cast<long long>(b) * H + h) * K * V;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int c = 8 * j + 2 * q;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? tb : ta;
      if (row < K && c < V) {
        *reinterpret_cast<float2*>(out + row * V + c) =
            make_float2(hacc[j][2 * half], hacc[j][2 * half + 1]);
      }
    }
  }
}

size_t fma_smem_bytes() {
  return sizeof(float) *
         (5 * kFL * kLdT + kW * kW + kFL * kLg + 2 * kW);
}

template <typename T>
int launch_fma(const void* r, const void* k, const void* v, const float* logw,
               const void* u, void* y, float* state, int Bsz, int S, int H,
               int K, int V, cudaStream_t stream) {
  const size_t smem = fma_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_fma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, Bsz);
  rwkv6_scan_fma_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, static_cast<const T*>(u),
      static_cast<T*>(y), state, S, H, K, V);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma(const void* r, const void* k, const void* v, const float* logw,
               const void* u, void* y, float* state, int Bsz, int S, int H,
               int K, int V, cudaStream_t stream) {
  const int smem = RwkvSmem::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, Bsz);
  rwkv6_scan_mma_kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(r), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), logw,
      static_cast<const __nv_bfloat16*>(u), static_cast<__nv_bfloat16*>(y),
      state, S, H, K, V);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core kernel's conditions: K, V multiples of 8 and 16-byte
// aligned bases (the tensors are contiguous, so every row is aligned too).
bool mma_fits(const void* r, const void* k, const void* v, const float* logw,
              int K, int V) {
  auto al = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  };
  return K % 8 == 0 && V % 8 == 0 && al(r) && al(k) && al(v) && al(logw);
}

}  // namespace

#define REPRO_RWKV6_ARGS                                                      \
  const void *r, const void *k, const void *v, const float *logw,           \
      const void *u, void *y, float *state, int Bsz, int S, int H, int K,   \
      int V, void *stream

// The wrapper picks the entry (rwkv6_tensor_cores in kernels/rwkv6/kernel.py);
// the tensor-core one refuses inputs that do not meet its conditions.
extern "C" int repro_rwkv6_scan_bf16_mma(REPRO_RWKV6_ARGS) {
  if (!mma_fits(r, k, v, logw, K, V)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_mma(r, k, v, logw, u, y, state, Bsz, S, H, K, V,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int repro_rwkv6_scan_bf16(REPRO_RWKV6_ARGS) {
  return launch_fma<__nv_bfloat16>(r, k, v, logw, u, y, state, Bsz, S, H, K,
                                   V, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_rwkv6_scan_f32(REPRO_RWKV6_ARGS) {
  return launch_fma<float>(r, k, v, logw, u, y, state, Bsz, S, H, K, V,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int repro_rwkv6_scan_f16(REPRO_RWKV6_ARGS) {
  return launch_fma<__half>(r, k, v, logw, u, y, state, Bsz, S, H, K, V,
                            static_cast<cudaStream_t>(stream));
}
