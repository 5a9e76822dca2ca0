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
// elements moved.  bf16 / fp16 run the products on the tensor cores with
// mma.sync (m16n8k16, f32 accumulation) from shared-memory tiles, without
// TMA, wgmma or a load pipeline (later work); f32 inputs run them on the
// CUDA cores (FMA), far from any tensor-core bound.
//
// Design: the TPU kernel walked a 4-D grid whose innermost kv axis ran in
// order, keeping (m, l, acc) in VMEM scratch across grid steps.  Blocks run
// in no order here, so one block owns (b, hq, a tile of BQ = 64 queries)
// and loops over kv tiles itself, only up to the causal limit
// q_last + kv_offset; K/V tiles come from kv head hq / (Hq / Hkv).  The
// tensor-core kernel keeps each warp's 16 rows of S, running max,
// denominator and output accumulators in registers (the mma fragments);
// the f32 kernel stages K/V as f32 in shared memory (rows padded to D + 1
// floats so that the 16 threads reading 16 rows hit 16 banks), keeps the
// running max and denominator per row in shared memory and 4 x (D / 16)
// accumulators a thread in registers.  Probabilities keep f32 accuracy on
// both (the TPU kernel cast them to v's type before PV).  Ragged edges are
// masked, never padded: query rows past S are computed but not stored, kv
// rows past Skv are zero-filled and masked.  The guards of the TPU kernel
// carry over: m_safe = 0 where a row's max is -inf, p = 0 where s = -inf,
// l = 0 -> 1, so a fully masked row writes 0.  Heavy (late, causal) query
// tiles start first.
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;         // query rows a block
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

// -- bf16 / fp16: tensor cores (mma.sync m16n8k16, f32 accumulation) -----------

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float* c, const unsigned* a,
                                             unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // (lo, hi) -> one register, the lower column in the lower half
  static __device__ __forceinline__ unsigned pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<unsigned*>(&v);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float* c, const unsigned* a,
                                             unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ unsigned pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<unsigned*>(&v);
  }
  static __device__ __forceinline__ float round(float x) {
    return __half2float(__float2half_rn(x));
  }
};

template <typename T>
__device__ __forceinline__ unsigned ld32(const T* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

constexpr int kMmaThreads = 128;  // 4 warps, 16 query rows each
constexpr int kMmaBKV = 64;

// One block: (b, hq, 64 queries); warp w owns rows 16 w .. 16 w + 15 and
// keeps their S tile (16 x 64), running max / denominator and output
// accumulators (16 x D) in registers, in the mma fragment layout: lane
// (g = lane / 4, t = lane % 4) holds rows g and g + 8, columns 2 t, 2 t + 1
// of each 8-wide tile.  Q and K tiles sit in shared memory row-major (rows
// padded by 8 elements, so the 8 x 4 lanes of a fragment load hit 32
// banks), V transposed, so every fragment is 32-bit loads.  P leaves the
// S fragments as the A fragments of the PV product without a trip through
// shared memory; it is split into two terms of the input type, hi = P
// rounded and lo = P - hi, and both are multiplied, so P keeps about 16
// bits (the f32 plain version's accuracy; the TPU kernel rounded P to the
// input type).  MAXND bounds D / 8 at compile time.
template <typename T, int MAXND>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int Hq, int Hkv, int S, int Skv, int D, float scale,
                           int causal) {
  constexpr int NT = kMmaBKV / 8;  // 8-wide tiles of S
  constexpr int ldvt = kMmaBKV + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = D + 8;
  T* q_s = reinterpret_cast<T*>(smem_raw);  // (BQ, D + 8)
  T* k_s = q_s + kBQ * ld;                   // (BKV, D + 8)
  T* vt_s = k_s + kMmaBKV * ld;              // (D, BKV + 8): V transposed

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int kv_offset = Skv - S;
  const int nk = D / 16, nd = D / 8, vrow = D / 8;
  const long long qrow0 = (static_cast<long long>(b) * Hq + hq) * S;
  const long long krow0 = (static_cast<long long>(b) * Hkv + hk) * Skv;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  for (int e = tid; e < kBQ * vrow; e += kMmaThreads) {
    const int r = e / vrow, c = (e - r * vrow) * 8;
    uint4 val = zero4;
    if (q0 + r < S) {
      val = *reinterpret_cast<const uint4*>(q + (qrow0 + q0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(q_s + r * ld + c) = val;
  }

  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};
  float acc[MAXND][4];
#pragma unroll
  for (int dn = 0; dn < MAXND; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  }
  const int qa = q0 + warp * 16 + g;  // absolute query of row g (g + 8: +8)

  const int q_last = min(q0 + kBQ, S) - 1;
  const int kv_end = causal ? min(Skv, q_last + kv_offset + 1) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += kMmaBKV) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kMmaBKV * vrow; e += kMmaThreads) {
      const int r = e / vrow, c = (e - r * vrow) * 8;
      uint4 val = zero4;
      if (k0 + r < Skv) {
        val = *reinterpret_cast<const uint4*>(k + (krow0 + k0 + r) * D + c);
      }
      *reinterpret_cast<uint4*>(k_s + r * ld + c) = val;
    }
    // V: neighbouring lanes take neighbouring rows, so the transposed
    // stores of a warp fall in distinct banks
    for (int e = tid; e < kMmaBKV * vrow; e += kMmaThreads) {
      const int r = e % kMmaBKV, c = (e / kMmaBKV) * 8;
      uint4 val = zero4;
      if (k0 + r < Skv) {
        val = *reinterpret_cast<const uint4*>(v + (krow0 + k0 + r) * D + c);
      }
      const T* ve = reinterpret_cast<const T*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt_s[(c + i) * ldvt + r] = ve[i];
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    }
    for (int kk = 0; kk < nk; ++kk) {
      const T* qb = q_s + (warp * 16 + g) * ld + kk * 16 + t4 * 2;
      const unsigned a[4] = {ld32(qb), ld32(qb + 8 * ld), ld32(qb + 8),
                             ld32(qb + 8 * ld + 8)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const T* kb = k_s + (j * 8 + g) * ld + kk * 16 + t4 * 2;
        Mma<T>::run(s[j], a, ld32(kb), ld32(kb + 8));
      }
    }

    // scale and mask; row max over the 4 lanes of a row group
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = k0 + j * 8 + t4 * 2 + (e & 1);
        const bool masked =
            col >= Skv || (causal && col > qa + 8 * h + kv_offset);
        s[j][e] = masked ? -INFINITY : s[j][e] * scale;
        mx[h] = fmaxf(mx[h], s[j][e]);
      }
    }
    float m_safe[2], corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h]);
      m_safe[h] = m_new == -INFINITY ? 0.f : m_new;
      corr[h] = m_r[h] == -INFINITY ? 0.f : expf(m_r[h] - m_safe[h]);
      m_r[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            s[j][e] == -INFINITY ? 0.f : expf(s[j][e] - m_safe[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      l_r[h] = corr[h] * l_r[h] + rs[h];
    }
#pragma unroll
    for (int dn = 0; dn < MAXND; ++dn) {
      if (dn < nd) {
        acc[dn][0] *= corr[0];
        acc[dn][1] *= corr[0];
        acc[dn][2] *= corr[1];
        acc[dn][3] *= corr[1];
      }
    }

    // acc += P V, with P = hi + lo in the input type
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      // A fragment of P for kv columns 16 kk .. 16 kk + 15: S tiles 2 kk
      // (registers 0, 1) and 2 kk + 1 (registers 2, 3)
      float ph[8], pl[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ph[e] = Mma<T>::round(s[2 * kk][e]);
        pl[e] = s[2 * kk][e] - ph[e];
        ph[4 + e] = Mma<T>::round(s[2 * kk + 1][e]);
        pl[4 + e] = s[2 * kk + 1][e] - ph[4 + e];
      }
      const unsigned hi[4] = {Mma<T>::pack(ph[0], ph[1]), Mma<T>::pack(ph[2], ph[3]),
                              Mma<T>::pack(ph[4], ph[5]), Mma<T>::pack(ph[6], ph[7])};
      const unsigned lo[4] = {Mma<T>::pack(pl[0], pl[1]), Mma<T>::pack(pl[2], pl[3]),
                              Mma<T>::pack(pl[4], pl[5]), Mma<T>::pack(pl[6], pl[7])};
#pragma unroll
      for (int dn = 0; dn < MAXND; ++dn) {
        if (dn < nd) {
          const T* vb = vt_s + (dn * 8 + g) * ldvt + kk * 16 + t4 * 2;
          const unsigned b0 = ld32(vb), b1 = ld32(vb + 8);
          Mma<T>::run(acc[dn], hi, b0, b1);
          Mma<T>::run(acc[dn], lo, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qa + 8 * h;
    if (qi < S) {
      const float l = l_r[h] == 0.f ? 1.f : l_r[h];
      T* orow = o + (qrow0 + qi) * D + t4 * 2;
#pragma unroll
      for (int dn = 0; dn < MAXND; ++dn) {
        if (dn < nd) {
          *reinterpret_cast<unsigned*>(orow + dn * 8) =
              Mma<T>::pack(acc[dn][2 * h] / l, acc[dn][2 * h + 1] / l);
        }
      }
    }
  }
}

size_t mma_smem_bytes(int D) {
  return 2 * (static_cast<size_t>(kBQ + kMmaBKV) * (D + 8) +
              static_cast<size_t>(D) * (kMmaBKV + 8));
}

template <typename T, int MAXND>
int launch_mma(const T* q, const T* k, const T* v, T* o, int B, int Hq,
               int Hkv, int S, int Skv, int D, float scale, int causal,
               cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_mma_kernel<T, MAXND>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_attention_mma_kernel<T, MAXND><<<grid, kMmaThreads, smem, stream>>>(
      q, k, v, o, Hq, Hkv, S, Skv, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// D / 8 rounded up to a register budget of 64, 128, 192 or 256 columns
template <typename T>
int launch_mma_d(const T* q, const T* k, const T* v, T* o, int B, int Hq,
                 int Hkv, int S, int Skv, int D, float scale, int causal,
                 cudaStream_t stream) {
  if (D <= 64) return launch_mma<T, 8>(q, k, v, o, B, Hq, Hkv, S, Skv, D, scale, causal, stream);
  if (D <= 128) return launch_mma<T, 16>(q, k, v, o, B, Hq, Hkv, S, Skv, D, scale, causal, stream);
  if (D <= 192) return launch_mma<T, 24>(q, k, v, o, B, Hq, Hkv, S, Skv, D, scale, causal, stream);
  return launch_mma<T, 32>(q, k, v, o, B, Hq, Hkv, S, Skv, D, scale, causal, stream);
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
    return launch_mma_d<T>(qt, kt, vt, ot, B, Hq, Hkv, S, Skv, D, scale,
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
