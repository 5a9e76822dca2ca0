// Mamba2 SSD chunked scan: y and the final state of
//     h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,   y_t = C_t^T h_t
// from h_0 = 0, per (batch, head), with B and C shared by the H / G heads
// of a group.
//
// Replaces: src/repro/kernels/ssd/kernel.py::ssd_scan (Pallas TPU).
//
// x (Bsz, S, H, P) and B, C (Bsz, S, G, N) in the model's type, dt
// (Bsz, S, H) and A (H,) f32; y (Bsz, S, H, P) in x's type, the final state
// (Bsz, H, N, P) f32.  N and P are at most 64; the chunk is L = 64.
//
// Bound: at the path's shapes (S = 2,048, H = 80, P = N = 64) the chunk
// products (C B^T, G x, C h, B^T x: about 8 L N P flops a chunk and head)
// against the bytes of x, dt, B, C, y and the state put the work near the
// card's ridge point; this first version runs the products on the CUDA
// cores in f32 (FMA), so operations bound it.  Tensor-core tiles are later
// work.
//
// Design: the TPU kernel's grid was (Bsz * H, chunks) with the chunk axis
// innermost and in order, carrying the (N, P) state in VMEM scratch.  Here
// one block owns one (batch, head) and loops over the chunks itself; the
// carried state (64 x 64 f32, 16 KB) stays in shared memory, beside the
// chunk's x, B, C (as f32) and the (L, L) decay-weighted scores.  B and C
// are read from group h / (H / G), as the TPU kernel's index maps did.  Per
// chunk: acum = prefix sum of dt A (one warp, a fixed shuffle scan);
// G[t][s] = (C_t . B_s) exp(acum_t - acum_s) dt_s for s <= t, else 0;
// y = G x + exp(acum) (C h); h <- exp(acum_{L-1}) h
// + (B exp(acum_{L-1} - acum) dt)^T x.  Two traps of the TPU kernel are
// closed: the decay exponent acum_t - acum_s is positive for s > t and can
// overflow to inf (inf * 0 is NaN), so it is masked before the exp; and the
// tail chunk is masked (dt, x, B, C read as 0 past S, which leaves the
// state as it was) instead of padded in a copy.  Threads map 16 x 16 over
// each 64 x 64 product, 4 x 4 outputs a thread.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kL = 64;          // chunk length
constexpr int kW = 64;          // largest N and P
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ state, int S, int H, int P, int G,
                int N) {
  extern __shared__ float smem[];
  constexpr int ldx = kW, ldb = kW + 1, ldg = kL + 1, ldh = kW;
  float* x_s = smem;                  // (L, 64)   chunk of x
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
      for (int c = lane; c < kW; c += 32) {
        x_s[t * ldx + c] =
            in && c < P ? to_f32(x[(row * H + h) * P + c]) : 0.f;
        b_s[t * ldb + c] =
            in && c < N ? to_f32(Bm[(row * G + g) * N + c]) : 0.f;
        c_s[t * ldb + c] =
            in && c < N ? to_f32(Cm[(row * G + g) * N + c]) : 0.f;
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

size_t smem_bytes() {
  return sizeof(float) * (kL * kW + 2 * kL * (kW + 1) + kL * (kL + 1) +
                          kW * kW + 3 * kL);
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, float* state, int Bsz, int S, int H,
           int P, int G, int N, cudaStream_t stream) {
  const size_t smem = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, Bsz);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), state, S, H, P, G, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define REPRO_SSD_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* x, const float* dt, const float* A,       \
                      const void* Bm, const void* Cm, void* y, float* state, \
                      int Bsz, int S, int H, int P, int G, int N,           \
                      void* stream) {                                       \
    return launch<T>(x, dt, A, Bm, Cm, y, state, Bsz, S, H, P, G, N,        \
                     static_cast<cudaStream_t>(stream));                    \
  }

REPRO_SSD_ENTRY(repro_ssd_scan_f32, float)
REPRO_SSD_ENTRY(repro_ssd_scan_bf16, __nv_bfloat16)
REPRO_SSD_ENTRY(repro_ssd_scan_f16, __half)
