// Flash attention forward (dense, causal or not): returns out and lse.
//
// Replaces paddle_tpu/kernels/flash_attention.py `_fwd_kernel` (pallas_call
// in `_core_fwd`) for the case with no mask and no segments, with or without
// dropout on the probabilities (`_drop_mask` there). With dropout, l sums
// the un-dropped p while p * z / (1 - p) feeds P.V, as in the reference; the
// keep bit z of score (b * H + h, i, j) comes from drop_row_key/drop_bits
// (common.cuh), a function of the element alone, so the backward kernels,
// which tile differently, regenerate the same mask. Each kernel is a
// template on DROP: p = 0 runs the DROP = false instantiation, the code
// without dropout.
// Layout is the reference's public one, q/out [B, Sq, H, D] and k/v
// [B, Sk, Hkv, D] with H % Hkv == 0 (query head h reads kv head
// h / (H / Hkv), so GQA needs no repeated copy of K/V); lse is
// [B, H, Sq] f32. Causal means query i sees key j iff j <= i + (Sk - Sq),
// the reference's sdpa_ref convention (equal to the Pallas kernel's
// q_ids >= k_ids at Sq == Sk). Head widths are 36 (the Conformer's), 64 and
// 128: 36 rides zero-padded to 48 in shared memory (pad16, BfChunk in
// common.cuh), with 8-byte loads (a row starts 72-byte aligned) and stores
// of the 36 real columns only; 64 and 128 compile as before.
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
  return sizeof(float) * ((BQ + 2 * BK) * (pad16<D>() + 1) + BQ * (BK + 1));
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int H, int Hkv, int Sq, int Sk,
                     float scale, int causal, Drop dr) {
  constexpr int DP = pad16<D>();   // the tiles' width; columns >= D are 0
  constexpr int LD = DP + 1, LP = BK + 1, ND = DP / 16;
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

  for (int e = tid; e < BQ * DP; e += NT) {
    const int r = e / DP, d = e - r * DP, qi = q0 + r;
    Q_s[r * LD + d] =
        qi < Sq && (DP == D || d < D) ? to_f(qb[qi * qs + d]) * scale : 0.f;
  }

  float m[4], l[4], o[4][ND];
  uint32_t krow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < ND; ++c) o[i][c] = 0.f;
    if constexpr (DROP) krow[i] = drop_row_key(dr.seed, bh, q0 + ty + 16 * i);
  }

  int n_kt = (Sk + BK - 1) / BK;
  if (causal) {
    const int last = min(q0 + BQ - 1, Sq - 1) + off;  // last visible key
    n_kt = min(n_kt, last / BK + 1);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q_s written / last tile's K_s, V_s, P_s consumed
    for (int e = tid; e < BK * DP; e += NT) {
      const int r = e / DP, d = e - r * DP, kj = k0 + r;
      const bool ok = kj < Sk && (DP == D || d < D);
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
        rs += p;   // l sums the un-dropped p
        float pv = p;
        if constexpr (DROP)
          pv = drop_apply(p, krow[i], k0 + tx + 16 * j, dr.thresh, dr.rp);
        P_s[(ty + 16 * i) * LP + tx + 16 * j] = pv;
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
    for (int c = 0; c < ND; ++c)
      if (DP == D || tx + 16 * c < D) orow[tx + 16 * c] = from_f<T>(o[i][c] * inv);
    if (tx == 0) lse[(static_cast<size_t>(b) * H + h) * Sq + qi] = m[i] + logf(ls);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulate)
// ---------------------------------------------------------------------------
constexpr int MMA_NT = 128;   // 4 warps, 16 query rows each

template <int D>
constexpr size_t mma_smem_bytes() {
  constexpr int DP = pad16<D>();
  return sizeof(__nv_bfloat16) * ((BQ + BK) * (DP + 8) + DP * (BK + 8));
}

// Fragment layouts: see mma_bf16 in common.cuh. The score tile's C
// fragments are re-packed in registers as the A fragments of P for the
// P.V product.
template <int D, bool DROP>
__global__ void __launch_bounds__(MMA_NT)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ lse, int H, int Hkv, int Sq,
                         int Sk, float scale, int causal, Drop dr) {
  constexpr int DP = pad16<D>();   // the tiles' width; columns >= D are 0
  constexpr int LDK = DP + 8, LDV = BK + 8;  // padded rows: no bank conflicts
  constexpr int KS = DP / 16, NO = DP / 8, NS = BK / 8;
  using V = typename BfChunk<D>::V;
  constexpr int CW = BfChunk<D>::W, CH = D / CW;   // chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ, LDK]
  __nv_bfloat16* K_s = Q_s + BQ * LDK;                               // [BK, LDK]
  __nv_bfloat16* Vt_s = K_s + BK * LDK;                              // [DP, LDV]

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
  const V zero{};

  if constexpr (DP != D) {   // zero padding, never overwritten
    const __nv_bfloat16 z = __float2bfloat16(0.f);
    for (int e = tid; e < (BQ + BK) * (DP - D); e += MMA_NT)
      Q_s[(e / (DP - D)) * LDK + D + e % (DP - D)] = z;   // Q_s, then K_s
    for (int e = tid; e < (DP - D) * LDV; e += MMA_NT) Vt_s[D * LDV + e] = z;
  }
  for (int e = tid; e < BQ * CH; e += MMA_NT) {
    const int r = e / CH, c = e - r * CH, qi = q0 + r;
    *reinterpret_cast<V*>(Q_s + r * LDK + c * CW) =
        qi < Sq ? *reinterpret_cast<const V*>(qb + qi * qs + c * CW) : zero;
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
  uint32_t krow[2];
  if constexpr (DROP) {
    krow[0] = drop_row_key(dr.seed, bh, qrow[0]);
    krow[1] = drop_row_key(dr.seed, bh, qrow[1]);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // last tile's K_s / Vt_s consumed
    for (int e = tid; e < BK * CH; e += MMA_NT) {
      const int r = e / CH, c = e - r * CH, kj = k0 + r;
      *reinterpret_cast<V*>(K_s + r * LDK + c * CW) =
          kj < Sk ? *reinterpret_cast<const V*>(kb + kj * ks + c * CW) : zero;
    }
    // V transposed into Vt_s[d][key]; keys run fastest across threads so
    // the 2-byte stores of a warp fall in distinct banks
    for (int e = tid; e < BK * CH; e += MMA_NT) {
      const int r = e % BK, c = e / BK, kj = k0 + r;
      V u = kj < Sk ? *reinterpret_cast<const V*>(vb + kj * ks + c * CW) : zero;
      const __nv_bfloat16* hv = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
      for (int i = 0; i < CW; ++i) Vt_s[(c * CW + i) * LDV + r] = hv[i];
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
    if constexpr (DROP) {   // after l took the un-dropped sum
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[n][e] = drop_apply(sc[n][e], krow[e >> 1],
                                k0 + n * 8 + 2 * t + (e & 1), dr.thresh, dr.rp);
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
      if (DP == D || n * 8 + 2 * t < D)   // D is even: pairs never straddle
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
            __floats2bfloat162_rn(o[n][2 * hi] * inv, o[n][2 * hi + 1] * inv);
    if (t == 0)
      lse[(static_cast<size_t>(b) * H + h) * Sq + qi] = m[hi] + logf(ls);
  }
}

struct Args {
  const void *q, *k, *v;
  void *out, *lse;
  int B, H, Hkv, Sq, Sk;
  float scale;
  int causal;
  Drop dr;
};

template <int D, bool DROP>
int launch_mma(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.H);
  flash_fwd_mma_kernel<D, DROP><<<grid, MMA_NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<__nv_bfloat16*>(a.out), static_cast<float*>(a.lse), a.H,
      a.Hkv, a.Sq, a.Sk, a.scale, a.causal, a.dr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool DROP>
int launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.H);
  flash_fwd_kernel<T, D, DROP><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out),
      static_cast<float*>(a.lse), a.H, a.Hkv, a.Sq, a.Sk, a.scale, a.causal,
      a.dr);
  return static_cast<int>(cudaGetLastError());
}

template <bool DROP>
int dispatch(const Args& a, int D, int dtype, cudaStream_t st) {
  if (dtype == PTT_F32 && D == 36) return launch<float, 36, DROP>(a, st);
  if (dtype == PTT_BF16 && D == 36) return launch_mma<36, DROP>(a, st);
  if (dtype == PTT_F32 && D == 64) return launch<float, 64, DROP>(a, st);
  if (dtype == PTT_F32 && D == 128) return launch<float, 128, DROP>(a, st);
  if (dtype == PTT_BF16 && D == 64) return launch_mma<64, DROP>(a, st);
  if (dtype == PTT_BF16 && D == 128) return launch_mma<128, DROP>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// bits[bh, i, j] = drop_bits(drop_row_key(seed, bh, i), j), the raw 32 bits
// every flash kernel compares with its threshold (a check of the mask
// function against its plain version; no kernel of the model path).
__global__ void dropout_bits_kernel(uint32_t* __restrict__ bits,
                                    uint32_t seed, int Sq, int Sk) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y, bh = blockIdx.z;
  if (j >= Sk) return;
  bits[(static_cast<size_t>(bh) * Sq + i) * Sk + j] =
      drop_bits(drop_row_key(seed, bh, i), j);
}

}  // namespace

PTT_EXPORT_ERROR_STRING

// q/out [B, Sq, H, D], k/v [B, Sk, Hkv, D] contiguous; lse [B, H, Sq] f32.
// D is 36, 64 or 128. dropout != 0 applies dropout with keep threshold
// `thresh` and rp = 1 / (1 - p) from the 32-bit `seed`.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse, int B,
                                   int H, int Hkv, int Sq, int Sk, int D,
                                   float scale, int causal, int dtype,
                                   int dropout, uint32_t seed,
                                   uint32_t thresh, float rp, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, out, lse, B, H, Hkv, Sq, Sk, scale, causal,
               Drop{seed, thresh, rp}};
  return dropout ? dispatch<true>(a, D, dtype, st)
                 : dispatch<false>(a, D, dtype, st);
}

// bits [BH, Sq, Sk] uint32 (see dropout_bits_kernel)
extern "C" int flash_dropout_bits(void* bits, uint32_t seed, int BH, int Sq,
                                  int Sk, void* stream) {
  if (BH == 0 || Sq == 0 || Sk == 0) return 0;
  dim3 grid((Sk + 255) / 256, Sq, BH);
  dropout_bits_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(bits), seed, Sq, Sk);
  return static_cast<int>(cudaGetLastError());
}
