// Flash attention forward (dense, causal or not): returns out and lse.
//
// Replaces paddle_tpu/kernels/flash_attention.py `_fwd_kernel` (pallas_call
// in `_core_fwd`) for the case with no mask, no segments and no dropout.
// Layout is the reference's public one, q/out [B, Sq, H, D] and k/v
// [B, Sk, Hkv, D] with H % Hkv == 0 (query head h reads kv head
// h / (H / Hkv), so GQA needs no repeated copy of K/V); lse is
// [B, H, Sq] f32. Causal means query i sees key j iff j <= i + (Sk - Sq),
// the reference's sdpa_ref convention (equal to the Pallas kernel's
// q_ids >= k_ids at Sq == Sk).
//
// Bound on the H100: at long S, flops (4 * S^2 * D per head, halved by
// causality) against 989 TFLOP/s in bf16. Two kernels share the tiling:
// one thread block per (64-row query tile, batch*head), 64-key tiles of K
// and V through shared memory, online softmax (m, l, acc) in f32; the
// causal case stops the key loop at the diagonal, as the reference's `hi`
// bound does, and the kernel masks the ragged edge of S itself (any S, not
// only multiples of the tile; the TPU version halved its block until it
// divided S).
// - bf16 (the model's type): tensor cores through mma.sync m16n8k16 with
//   f32 accumulation. Four warps own 16 query rows each; Q stays in
//   registers as A fragments, K is read from padded shared memory as B
//   fragments, V is stored transposed so P.V's B fragments are 32-bit
//   loads, and the score tile's accumulators are re-packed in registers as
//   bf16 A fragments of P (FlashAttention-2's scheme). wgmma and TMA, the
//   way to the card's full rate, are later work.
// - f32: the same tiling on the CUDA cores, 256 threads as 16 x 16, each
//   owning 4 query rows and 4 keys of a tile, with padded f32 tiles and
//   probabilities through shared memory.
#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64, BK = 64, NT = 256;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((BQ + 2 * BK) * (D + 1) + BQ * (BK + 1));
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int H, int Hkv, int Sq, int Sk,
                     float scale, int causal) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int LD = D + 1, LP = BK + 1, ND = D / 16;
  extern __shared__ float smem[];
  float* Q_s = smem;             // [BQ, LD]
  float* K_s = Q_s + BQ * LD;    // [BK, LD]
  float* V_s = K_s + BK * LD;    // [BK, LD]
  float* P_s = V_s + BK * LD;    // [BQ, LP]

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t qs = static_cast<size_t>(H) * D;    // row stride of q/out
  const size_t ks = static_cast<size_t>(Hkv) * D;  // row stride of k/v
  const T* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const T* kb = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;
  const T* vb = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;
  const int off = Sk - Sq;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, d = e - r * D, qi = q0 + r;
    Q_s[r * LD + d] = qi < Sq ? to_f(qb[qi * qs + d]) * scale : 0.f;
  }

  float m[4], l[4], o[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < ND; ++c) o[i][c] = 0.f;
  }

  int n_kt = (Sk + BK - 1) / BK;
  if (causal) {
    const int last = min(q0 + BQ - 1, Sq - 1) + off;  // last visible key
    n_kt = min(n_kt, last / BK + 1);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q_s written / last tile's K_s, V_s, P_s consumed
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, d = e - r * D, kj = k0 + r;
      const bool ok = kj < Sk;
      K_s[r * LD + d] = ok ? to_f(kb[kj * ks + d]) : 0.f;
      V_s[r * LD + d] = ok ? to_f(vb[kj * ks + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Q_s[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = K_s[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += a[i] * bb[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj < Sk && (!causal || kj <= qi + off);
        if (!ok) sc[i][j] = NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int o_ = 8; o_ > 0; o_ >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o_));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        P_s[(ty + 16 * i) * LP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int o_ = 8; o_ > 0; o_ >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o_);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < ND; ++c) o[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = P_s[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        const float vv = V_s[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][c] += p[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / ls;
    T* orow = out + (static_cast<size_t>(b) * Sq + qi) * qs + static_cast<size_t>(h) * D;
#pragma unroll
    for (int c = 0; c < ND; ++c) orow[tx + 16 * c] = from_f<T>(o[i][c] * inv);
    if (tx == 0) lse[(static_cast<size_t>(b) * H + h) * Sq + qi] = m[i] + logf(ls);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulate)
// ---------------------------------------------------------------------------
constexpr int MMA_NT = 128;   // 4 warps, 16 query rows each

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * ((BQ + BK) * (D + 8) + D * (BK + 8));
}

// Fragment layouts are PTX's for m16n8k16 (g = lane / 4, t = lane % 4):
// A rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9; B columns g,
// rows 2t, 2t + 1 and 2t + 8, 2t + 9; C rows g (c0, c1) and g + 8 (c2,
// c3), columns 2t, 2t + 1. The score tile's C fragments are re-packed in
// registers as the A fragments of P for the P.V product.
template <int D>
__global__ void __launch_bounds__(MMA_NT)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ lse, int H, int Hkv, int Sq,
                         int Sk, float scale, int causal) {
  constexpr int LDK = D + 8, LDV = BK + 8;   // padded rows: no bank conflicts
  constexpr int KS = D / 16, NO = D / 8, NS = BK / 8, CH = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ, LDK]
  __nv_bfloat16* K_s = Q_s + BQ * LDK;                               // [BK, LDK]
  __nv_bfloat16* Vt_s = K_s + BK * LDK;                              // [D, LDV]

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t qs = static_cast<size_t>(H) * D;
  const size_t ks = static_cast<size_t>(Hkv) * D;
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;
  const int off = Sk - Sq;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int e = tid; e < BQ * CH; e += MMA_NT) {
    const int r = e / CH, c = e - r * CH, qi = q0 + r;
    *reinterpret_cast<uint4*>(Q_s + r * LDK + c * 8) =
        qi < Sq ? *reinterpret_cast<const uint4*>(qb + qi * qs + c * 8) : zero;
  }
  __syncthreads();
  uint32_t qa[KS][4];
  const int wr = warp * 16;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const __nv_bfloat16* p = Q_s + (wr + g) * LDK + kk * 16 + 2 * t;
    qa[kk][0] = ld32(p);
    qa[kk][1] = ld32(p + 8 * LDK);
    qa[kk][2] = ld32(p + 8);
    qa[kk][3] = ld32(p + 8 * LDK + 8);
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  int n_kt = (Sk + BK - 1) / BK;
  if (causal) {
    const int last = min(q0 + BQ - 1, Sq - 1) + off;
    n_kt = min(n_kt, last / BK + 1);
  }
  const int qrow[2] = {q0 + wr + g, q0 + wr + g + 8};

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // last tile's K_s / Vt_s consumed
    for (int e = tid; e < BK * CH; e += MMA_NT) {
      const int r = e / CH, c = e - r * CH, kj = k0 + r;
      *reinterpret_cast<uint4*>(K_s + r * LDK + c * 8) =
          kj < Sk ? *reinterpret_cast<const uint4*>(kb + kj * ks + c * 8)
                  : zero;
    }
    // V transposed into Vt_s[d][key]; keys run fastest across threads so
    // the 2-byte stores of a warp fall in distinct banks
    for (int e = tid; e < BK * CH; e += MMA_NT) {
      const int r = e % BK, c = e / BK, kj = k0 + r;
      uint4 u = kj < Sk ? *reinterpret_cast<const uint4*>(vb + kj * ks + c * 8)
                        : zero;
      const __nv_bfloat16* hv = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt_s[(c * 8 + i) * LDV + r] = hv[i];
    }
    __syncthreads();

    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const __nv_bfloat16* p = K_s + (n * 8 + g) * LDK + kk * 16 + 2 * t;
        mma_bf16(sc[n], qa[kk], ld32(p), ld32(p + 8));
      }
    }

    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + n * 8 + 2 * t + (e & 1);
        const int hi = e >> 1;
        float val = sc[n][e] * scale;
        if (kj >= Sk || (causal && kj > qrow[hi] + off)) val = NEG_INF;
        sc[n][e] = val;
        mx[hi] = fmaxf(mx[hi], val);
      }
    }
    float alpha[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 1));
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 2));
      const float m_new = fmaxf(m[hi], mx[hi]);
      alpha[hi] = expf(m[hi] - m_new);
      m[hi] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[n][e] - m[e >> 1]);
        sc[n][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      rs[hi] += __shfl_xor_sync(0xffffffffu, rs[hi], 1);
      rs[hi] += __shfl_xor_sync(0xffffffffu, rs[hi], 2);
      l[hi] = alpha[hi] * l[hi] + rs[hi];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * j][0], sc[2 * j][1]),
                              pack_bf16(sc[2 * j][2], sc[2 * j][3]),
                              pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]),
                              pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* p = Vt_s + (n * 8 + g) * LDV + j * 16 + 2 * t;
        mma_bf16(o[n], pa, ld32(p), ld32(p + 8));
      }
    }
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int qi = qrow[hi];
    if (qi >= Sq) continue;
    const float ls = fmaxf(l[hi], 1e-30f);
    const float inv = 1.f / ls;
    __nv_bfloat16* orow =
        out + (static_cast<size_t>(b) * Sq + qi) * qs + static_cast<size_t>(h) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * hi] * inv, o[n][2 * hi + 1] * inv);
    if (t == 0)
      lse[(static_cast<size_t>(b) * H + h) * Sq + qi] = m[hi] + logf(ls);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int H, int Hkv, int Sq, int Sk, float scale,
               int causal, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_mma_kernel<D><<<grid, MMA_NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), H, Hkv, Sq, Sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int H, int Hkv, int Sq, int Sk, float scale, int causal,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), H, Hkv, Sq, Sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int H, int Hkv, int Sq, int Sk, int D,
               float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<float, 64>(q, k, v, out, lse, B, H, Hkv, Sq, Sk, scale,
                               causal, stream);
    case 128:
      return launch<float, 128>(q, k, v, out, lse, B, H, Hkv, Sq, Sk, scale,
                                causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

PTT_EXPORT_ERROR_STRING

// q/out [B, Sq, H, D], k/v [B, Sk, Hkv, D] contiguous; lse [B, H, Sq] f32.
// D is 64 or 128.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse, int B,
                                   int H, int Hkv, int Sq, int Sk, int D,
                                   float scale, int causal, int dtype,
                                   void* stream) {
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == PTT_F32)
    return launch_f32(q, k, v, out, lse, B, H, Hkv, Sq, Sk, D, scale, causal,
                      st);
  if (dtype == PTT_BF16) {
    if (D == 64)
      return launch_mma<64>(q, k, v, out, lse, B, H, Hkv, Sq, Sk, scale,
                            causal, st);
    if (D == 128)
      return launch_mma<128>(q, k, v, out, lse, B, H, Hkv, Sq, Sk, scale,
                             causal, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
