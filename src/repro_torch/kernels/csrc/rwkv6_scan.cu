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
// K and V are at most 64; the chunk is L = 32.
//
// Bound: at the path's shape (Bsz 8, S 2,048, H 40, K = V = 64, bf16) the
// bytes are r, k, v and y in bf16 (4 x 83,886,080), logw in f32
// (167,772,160) and the f32 state (5,242,880): 508.6 MB, 0.152 ms at
// 3.35 TB/s.  The chunk products (about 1.5e10 flops) are far below the
// tensor-core line.  The ratio form needs one exponential per (t, s < t, c)
// of a chunk: 496 x 64 per (batch, head, chunk), 6.5e8 a call (1.34e9 if
// the whole L x L x K tile were formed), which on the SFU (16 a clock per
// SM) takes about as long as the bytes: it is what the ratio form costs on
// this card.
//
// Design: the TPU kernel's grid was (Bsz * H, chunks) with the chunk axis
// in order, carrying the (K, V) state in VMEM scratch.  Here one block owns
// one (batch, head) and loops over the chunks itself (320 blocks at the
// path's shape, three fit an SM); the 64 x 64 f32 state stays in shared
// memory for the whole sequence.  Per chunk:
//   1. stage r, k, v (as f32) and logw, 32 x 64 each;
//   2. W = prefix sum of logw down the chunk, one channel a thread, in
//      order; Wprev = W - logw;
//   3. G[t][s] = sum_c r[t,c] k[s,c] exp(Wprev[t,c] - W[s,c]) for s < t
//      only: the exponent is <= 0 there, and above the diagonal (where it is
//      positive and overflows) it is never formed, so the mask comes before
//      the exp.  Rows t and 32 - t together hold 32 such entries, one warp's
//      worth; G[t][t] = r_t . (u * k_t) carries the bonus, G[t][s > t] = 0;
//   4. r <- r exp(Wprev), k <- k exp(W[L-1] - W) (exponents <= 0);
//   5. y = (r exp(Wprev)) S + G v;
//   6. S <- exp(W[L-1]) S + (k exp(W[L-1] - W))^T v.
// The tail chunk is masked, not padded: rows past S read r = k = v = 0 and
// logw = 0, which adds nothing and leaves the state as it was (the JAX
// package's zero padding), and write no y.  Every sum runs in a fixed order
// and there are no atomics, so a repeat is bitwise equal.  expf, not
// __expf.  The products run on the CUDA cores in f32 (FMA); tensor-core
// tiles are later work.  Threads map 16 x 16 over the y and state tiles.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kL = 32;          // chunk length
constexpr int kW = 64;          // largest K and V
constexpr int kLd = kW + 1;     // padded row of the (L, 64) tiles
constexpr int kLg = kL + 1;     // padded row of G
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ logw,
                  const T* __restrict__ u, T* __restrict__ y,
                  float* __restrict__ state, int S, int H, int K, int V) {
  extern __shared__ float smem[];
  float* r_s = smem;                 // (L, 65) r, then r exp(Wprev)
  float* k_s = r_s + kL * kLd;       // (L, 65) k, then k exp(W[L-1] - W)
  float* v_s = k_s + kL * kLd;       // (L, 65) v
  float* w_s = v_s + kL * kLd;       // (L, 65) logw, then W
  float* wp_s = w_s + kL * kLd;      // (L, 65) Wprev = W - logw
  float* s_s = wp_s + kL * kLd;      // (64, 64) carried state (K, V)
  float* g_s = s_s + kW * kW;        // (L, 33) scores, bonus on the diagonal
  float* u_s = g_s + kL * kLg;       // (64,)
  float* cd_s = u_s + kW;            // (64,) exp(W[L-1])

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, b = blockIdx.y;

  for (int e = tid; e < kW * kW; e += kThreads) s_s[e] = 0.f;
  if (tid < kW) u_s[tid] = tid < K ? to_f32(u[h * K + tid]) : 0.f;

  const int chunks = (S + kL - 1) / kL;
  for (int ch = 0; ch < chunks; ++ch) {
    const int t0 = ch * kL;
    __syncthreads();  // the previous chunk's readers are done

    // 1. stage the chunk; rows past S and channels past K / V read as 0
    for (int t = warp; t < kL; t += kThreads / 32) {
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
      for (int t = 0; t < kL; ++t) {
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
      if (p == kL / 2 && lane >= p) continue;
      const int t = lane < p ? p : kL - p;
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
    for (int e = tid; e < kL * kL; e += kThreads) {
      const int t = e / kL, s = e % kL;
      if (s > t) g_s[t * kLg + s] = 0.f;
    }
    __syncthreads();

    // 4. the decays of the inter-chunk and state terms (exponents <= 0)
    const float* wlast = w_s + (kL - 1) * kLd;
    for (int e = tid; e < kL * kW; e += kThreads) {
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
      for (int s = 0; s < kL; ++s) {
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
      for (int s = 0; s < kL; ++s) {
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

size_t smem_bytes() {
  return sizeof(float) *
         (5 * kL * kLd + kW * kW + kL * kLg + 2 * kW);
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* logw,
           const void* u, void* y, float* state, int Bsz, int S, int H, int K,
           int V, cudaStream_t stream) {
  const size_t smem = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, Bsz);
  rwkv6_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, static_cast<const T*>(u),
      static_cast<T*>(y), state, S, H, K, V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define REPRO_RWKV6_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* r, const void* k, const void* v,           \
                      const float* logw, const void* u, void* y,             \
                      float* state, int Bsz, int S, int H, int K, int V,     \
                      void* stream) {                                        \
    return launch<T>(r, k, v, logw, u, y, state, Bsz, S, H, K, V,            \
                     static_cast<cudaStream_t>(stream));                     \
  }

REPRO_RWKV6_ENTRY(repro_rwkv6_scan_f32, float)
REPRO_RWKV6_ENTRY(repro_rwkv6_scan_bf16, __nv_bfloat16)
REPRO_RWKV6_ENTRY(repro_rwkv6_scan_f16, __half)
