// Flash attention backward (dense, causal or not): dQ, dK, dV.
//
// Replaces paddle_tpu/kernels/flash_attention.py `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` (pallas_calls in `_flash_core_bwd`) for the case with
// no mask and no segments, with or without dropout. FlashAttention-2's recomputation
// scheme: nothing of the forward is kept but out's lse; the caller also
// passes dg = delta - g_lse per query row, with delta = rowsum(dO * O), so
// that with p = exp(scale * q.k - lse)
//   ds = p * (dO.v - delta + g_lse)          (the lse cotangent folds in)
//   dQ = scale * ds.K,  dK = scale * ds^T.Q,  dV = p^T.dO.
// With dropout (the reference's `_drop_mask` regenerated at :222 and :277)
// the keep bit z of (b * H + h, i, j), with h the QUERY head also in the
// GQA dK/dV kernel, is regenerated from drop_row_key/drop_bits (common.cuh)
// exactly as the forward drew it, and
//   dV = (p * z / (1 - p))^T.dO,   ds = p * (dO.v * z / (1 - p) - dg),
// while delta = rowsum(dO * O) is unchanged. Each kernel is a template on
// DROP; p = 0 runs the DROP = false instantiation, the code without it.
// Layout is the forward's: q/dout/dq [B, Sq, H, D], k/v/dk/dv
// [B, Sk, Hkv, D], lse/dg [B, H, Sq] f32, H % Hkv == 0; causal means
// query i sees key j iff j <= i + (Sk - Sq), and the kernels mask the
// ragged edges of Sq and Sk themselves (the TPU version halved its block
// until it divided S). Head widths 36, 64 and 128; 36 is zero-padded to 48
// in shared memory as in the forward (common.cuh pad16, BfChunk).
//
// Bound on the H100: flops, five products of the forward's size (QK^T and
// dO.V^T are recomputed, then dQ, dK, dV), halved by causality. Two
// kernels, as in FlashAttention-2 and the reference:
// - dQ: one thread block per (64-query tile, batch * head); it walks the
//   key tiles up to the diagonal and accumulates dQ in f32.
// - dK/dV: one thread block per (64-key tile, batch * KV head); it walks
//   the H / Hkv query heads of its group and, for each, the query tiles
//   from the diagonal on, accumulating dK and dV in f32 and writing them
//   once. GQA needs no atomics and no repeated K/V, and two runs give the
//   same bits (the reference repeats K/V heads and lets autodiff sum).
// bf16 (the model's type) runs the products on the tensor cores
// (mma.sync m16n8k16, f32 accumulation; p and ds are rounded to bf16 as
// the A operand of the second products, as FlashAttention-2 does); f32
// runs the same tiling on the CUDA cores.
#include "common.cuh"

namespace {

constexpr int BQ = 64, BK = 64, NT = 256;

// ---------------------------------------------------------------------------
// f32: CUDA cores. 256 threads as 16 x 16; a thread owns 4 rows (ty + 16 i)
// and 4 columns (tx + 16 j) of each 64 x 64 tile, and 4 rows x D/16
// columns of the f32 accumulators.
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * 64 * (pad16<D>() + 1) + 64 * (BK + 1));
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) *
         (4 * 64 * (pad16<D>() + 1) + 2 * BK * (BQ + 1) + 3 * BQ);
}

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(NT)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dg, T* __restrict__ dq,
                        int H, int Hkv, int Sq, int Sk, float scale,
                        int causal, Drop dr) {
  constexpr int DP = pad16<D>();   // the tiles' width; columns >= D are 0
  constexpr int LD = DP + 1, LP = BK + 1, ND = DP / 16;
  extern __shared__ float smem[];
  float* Q_s = smem;             // [BQ, LD]
  float* dO_s = Q_s + BQ * LD;   // [BQ, LD]
  float* K_s = dO_s + BQ * LD;   // [BK, LD]
  float* V_s = K_s + BK * LD;    // [BK, LD]
  float* dS_s = V_s + BK * LD;   // [BQ, LP]

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t qs = static_cast<size_t>(H) * D;
  const size_t ks = static_cast<size_t>(Hkv) * D;
  const T* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const T* ob = dout + (static_cast<size_t>(b) * Sq * H + h) * D;
  const T* kb = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;
  const T* vb = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;
  const float* lb = lse + static_cast<size_t>(bh) * Sq;
  const float* gb = dg + static_cast<size_t>(bh) * Sq;
  const int off = Sk - Sq;

  for (int e = tid; e < BQ * DP; e += NT) {
    const int r = e / DP, d = e - r * DP, qi = q0 + r;
    const bool ok = qi < Sq && (DP == D || d < D);
    Q_s[r * LD + d] = ok ? to_f(qb[qi * qs + d]) : 0.f;
    dO_s[r * LD + d] = ok ? to_f(ob[qi * qs + d]) : 0.f;
  }
  float lr[4], gr[4], acc[4][ND];
  uint32_t rk[4];   // dropout row keys
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    lr[i] = qi < Sq ? lb[qi] : 0.f;
    gr[i] = qi < Sq ? gb[qi] : 0.f;
    if constexpr (DROP) rk[i] = drop_row_key(dr.seed, bh, qi);
#pragma unroll
    for (int c = 0; c < ND; ++c) acc[i][c] = 0.f;
  }

  int n_kt = (Sk + BK - 1) / BK;
  if (causal) {
    const int last = min(q0 + BQ - 1, Sq - 1) + off;  // last visible key
    n_kt = min(n_kt, last / BK + 1);
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q_s, dO_s written / last tile's K_s, V_s, dS_s read
    for (int e = tid; e < BK * DP; e += NT) {
      const int r = e / DP, d = e - r * DP, kj = k0 + r;
      const bool ok = kj < Sk && (DP == D || d < D);
      K_s[r * LD + d] = ok ? to_f(kb[kj * ks + d]) : 0.f;
      V_s[r * LD + d] = ok ? to_f(vb[kj * ks + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], o[4], kk[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Q_s[(ty + 16 * i) * LD + d];
        o[i] = dO_s[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = K_s[(tx + 16 * j) * LD + d];
        vv[j] = V_s[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += a[i] * kk[j];
          dp[i][j] += o[i] * vv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = qi < Sq && kj < Sk && (!causal || kj <= qi + off);
        const float p = ok ? expf(s[i][j] * scale - lr[i]) : 0.f;
        float dpv = dp[i][j];
        if constexpr (DROP) dpv = drop_apply(dpv, rk[i], kj, dr.thresh, dr.rp);
        dS_s[(ty + 16 * i) * LP + tx + 16 * j] = p * (dpv - gr[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dS_s[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        const float kv = K_s[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += ds[i] * kv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    T* row = dq + (static_cast<size_t>(b) * Sq + qi) * qs +
             static_cast<size_t>(h) * D;
#pragma unroll
    for (int c = 0; c < ND; ++c)
      if (DP == D || tx + 16 * c < D)
        row[tx + 16 * c] = from_f<T>(acc[i][c] * scale);
  }
}

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(NT)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dg, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int Hkv, int Sq, int Sk,
                         float scale, int causal, Drop dr) {
  constexpr int DP = pad16<D>();   // the tiles' width; columns >= D are 0
  constexpr int LD = DP + 1, LP = BQ + 1, ND = DP / 16;
  extern __shared__ float smem[];
  float* K_s = smem;             // [BK, LD]
  float* V_s = K_s + BK * LD;    // [BK, LD]
  float* Q_s = V_s + BK * LD;    // [BQ, LD]
  float* dO_s = Q_s + BQ * LD;   // [BQ, LD]
  float* P_s = dO_s + BQ * LD;   // [BK, LP]  p^T
  float* dS_s = P_s + BK * LP;   // [BK, LP]  ds^T
  float* L_s = dS_s + BK * LP;   // [BQ]      lse of the query tile
  float* G_s = L_s + BQ;         // [BQ]      dg of the query tile
  uint32_t* R_s = reinterpret_cast<uint32_t*>(G_s + BQ);  // [BQ] row keys

  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y, b = bh / Hkv, hk = bh - b * Hkv;
  const int rep = H / Hkv;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t qs = static_cast<size_t>(H) * D;
  const size_t ks = static_cast<size_t>(Hkv) * D;
  const T* kb = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;
  const T* vb = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;
  const int off = Sk - Sq;

  for (int e = tid; e < BK * DP; e += NT) {
    const int r = e / DP, d = e - r * DP, kj = k0 + r;
    const bool ok = kj < Sk && (DP == D || d < D);
    K_s[r * LD + d] = ok ? to_f(kb[kj * ks + d]) : 0.f;
    V_s[r * LD + d] = ok ? to_f(vb[kj * ks + d]) : 0.f;
  }
  float ak[4][ND], av[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < ND; ++c) ak[i][c] = av[i][c] = 0.f;

  // the first query that sees key k0 is k0 - off
  const int qt_lo = causal ? max(0, k0 - off) / BQ : 0;
  const int n_qt = (Sq + BQ - 1) / BQ;
  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    const T* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
    const T* ob = dout + (static_cast<size_t>(b) * Sq * H + h) * D;
    const float* lb = lse + (static_cast<size_t>(b) * H + h) * Sq;
    const float* gb = dg + (static_cast<size_t>(b) * H + h) * Sq;
    for (int qt = qt_lo; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // K_s, V_s written / last tile's smem read
      for (int e = tid; e < BQ * DP; e += NT) {
        const int r = e / DP, d = e - r * DP, qi = q0 + r;
        const bool ok = qi < Sq && (DP == D || d < D);
        Q_s[r * LD + d] = ok ? to_f(qb[qi * qs + d]) : 0.f;
        dO_s[r * LD + d] = ok ? to_f(ob[qi * qs + d]) : 0.f;
      }
      if (tid < BQ) {
        const int qi = q0 + tid;
        L_s[tid] = qi < Sq ? lb[qi] : 0.f;
        G_s[tid] = qi < Sq ? gb[qi] : 0.f;
        if constexpr (DROP) R_s[tid] = drop_row_key(dr.seed, b * H + h, qi);
      }
      __syncthreads();

      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kk[4], vv[4], a[4], o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kk[i] = K_s[(ty + 16 * i) * LD + d];
          vv[i] = V_s[(ty + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a[j] = Q_s[(tx + 16 * j) * LD + d];
          o[j] = dO_s[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] += kk[i] * a[j];
            dpt[i][j] += vv[i] * o[j];
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kj = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j, qi = q0 + c;
          const bool ok = kj < Sk && qi < Sq && (!causal || kj <= qi + off);
          const float p = ok ? expf(st[i][j] * scale - L_s[c]) : 0.f;
          float pv = p, dpv = dpt[i][j];
          if constexpr (DROP) {
            const bool keep = drop_keep(R_s[c], kj, dr.thresh);
            pv = keep ? p * dr.rp : 0.f;
            dpv = keep ? dpv * dr.rp : 0.f;
          }
          P_s[(ty + 16 * i) * LP + c] = pv;
          dS_s[(ty + 16 * i) * LP + c] = p * (dpv - G_s[c]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < BQ; ++jj) {
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = P_s[(ty + 16 * i) * LP + jj];
          ds[i] = dS_s[(ty + 16 * i) * LP + jj];
        }
#pragma unroll
        for (int c = 0; c < ND; ++c) {
          const float o = dO_s[jj * LD + tx + 16 * c];
          const float a = Q_s[jj * LD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            av[i][c] += p[i] * o;
            ak[i][c] += ds[i] * a;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= Sk) continue;
    const size_t o = (static_cast<size_t>(b) * Sk + kj) * ks +
                     static_cast<size_t>(hk) * D;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      if (DP != D && tx + 16 * c >= D) continue;
      dk[o + tx + 16 * c] = from_f<T>(ak[i][c] * scale);
      dv[o + tx + 16 * c] = from_f<T>(av[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulate), 4 warps of 16
// rows each. Operands that a product reads as B ([n][k] in shared memory,
// see mma_bf16) are also stored transposed where the next product needs
// them the other way round.
// ---------------------------------------------------------------------------
constexpr int MMA_NT = 128;
constexpr int BQ2 = 32;   // query tile of the dK/dV kernel (register budget)

template <int D>
constexpr size_t dq_mma_smem_bytes() {
  constexpr int DP = pad16<D>();
  return sizeof(__nv_bfloat16) * ((2 * BQ + 2 * BK) * (DP + 8) + DP * (BK + 8));
}

template <int D>
constexpr size_t dkv_mma_smem_bytes() {
  constexpr int DP = pad16<D>();
  return sizeof(__nv_bfloat16) *
             ((2 * BK + 2 * BQ2) * (DP + 8) + 2 * DP * (BQ2 + 8)) +
         sizeof(float) * 3 * BQ2;
}

// Zero the padding columns [D, DP) of `rows` rows of stride `ld` from `s`
// (several tiles at once where they lie back to back with one stride).
template <int D, int DP>
__device__ __forceinline__ void zero_pad_cols(__nv_bfloat16* s, int rows,
                                              int ld, int tid, int nt) {
  const __nv_bfloat16 z = __float2bfloat16(0.f);
  for (int e = tid; e < rows * (DP - D); e += nt)
    s[(e / (DP - D)) * ld + D + e % (DP - D)] = z;
}

__device__ __forceinline__ void a_frag(uint32_t* a, const __nv_bfloat16* s,
                                       int ld, int row, int col) {
  const __nv_bfloat16* p = s + row * ld + col;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// dQ: S = Q.K^T (B = K_s [key][d]), dP = dO.V^T (B = V_s [key][d]),
// dQ += dS.K (B = Kt_s [d][key]).
template <int D, bool DROP>
__global__ void __launch_bounds__(MMA_NT)
    flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ dg,
                            __nv_bfloat16* __restrict__ dq, int H, int Hkv,
                            int Sq, int Sk, float scale, int causal,
                            Drop dr) {
  constexpr int DP = pad16<D>();   // the tiles' width; columns >= D are 0
  constexpr int LDK = DP + 8, LDT = BK + 8;
  constexpr int KS = DP / 16, NO = DP / 8, NS = BK / 8;
  using V = typename BfChunk<D>::V;
  constexpr int CW = BfChunk<D>::W, CH = D / CW;   // chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ, LDK]
  __nv_bfloat16* dO_s = Q_s + BQ * LDK;                              // [BQ, LDK]
  __nv_bfloat16* K_s = dO_s + BQ * LDK;                              // [BK, LDK]
  __nv_bfloat16* V_s = K_s + BK * LDK;                               // [BK, LDK]
  __nv_bfloat16* Kt_s = V_s + BK * LDK;                              // [DP, LDT]

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const size_t qs = static_cast<size_t>(H) * D;
  const size_t ks = static_cast<size_t>(Hkv) * D;
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const __nv_bfloat16* ob = dout + (static_cast<size_t>(b) * Sq * H + h) * D;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;
  const int off = Sk - Sq;
  const V zero{};

  if constexpr (DP != D) {   // zero padding, never overwritten
    zero_pad_cols<D, DP>(Q_s, 2 * BQ + 2 * BK, LDK, tid, MMA_NT);
    for (int e = tid; e < (DP - D) * LDT; e += MMA_NT)
      Kt_s[D * LDT + e] = __float2bfloat16(0.f);
  }
  for (int e = tid; e < BQ * CH; e += MMA_NT) {
    const int r = e / CH, c = e - r * CH, qi = q0 + r;
    const bool ok = qi < Sq;
    *reinterpret_cast<V*>(Q_s + r * LDK + c * CW) =
        ok ? *reinterpret_cast<const V*>(qb + qi * qs + c * CW) : zero;
    *reinterpret_cast<V*>(dO_s + r * LDK + c * CW) =
        ok ? *reinterpret_cast<const V*>(ob + qi * qs + c * CW) : zero;
  }
  const int qrow[2] = {q0 + wr + g, q0 + wr + g + 8};
  float lr[2], gr[2];
  uint32_t rk[2];   // dropout row keys
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const size_t o = static_cast<size_t>(bh) * Sq + qrow[hi];
    lr[hi] = qrow[hi] < Sq ? lse[o] : 0.f;
    gr[hi] = qrow[hi] < Sq ? dg[o] : 0.f;
    if constexpr (DROP) rk[hi] = drop_row_key(dr.seed, bh, qrow[hi]);
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int n_kt = (Sk + BK - 1) / BK;
  if (causal) {
    const int last = min(q0 + BQ - 1, Sq - 1) + off;
    n_kt = min(n_kt, last / BK + 1);
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q_s, dO_s written / last tile's K_s, V_s, Kt_s read
    // keys run fastest across threads, so the transposed 2-byte stores of
    // a warp fall in distinct banks
    for (int e = tid; e < BK * CH; e += MMA_NT) {
      const int r = e % BK, c = e / BK, kj = k0 + r;
      const bool ok = kj < Sk;
      const V uk = ok ? *reinterpret_cast<const V*>(kb + kj * ks + c * CW) : zero;
      *reinterpret_cast<V*>(K_s + r * LDK + c * CW) = uk;
      *reinterpret_cast<V*>(V_s + r * LDK + c * CW) =
          ok ? *reinterpret_cast<const V*>(vb + kj * ks + c * CW) : zero;
      const __nv_bfloat16* hv = reinterpret_cast<const __nv_bfloat16*>(&uk);
#pragma unroll
      for (int i = 0; i < CW; ++i) Kt_s[(c * CW + i) * LDT + r] = hv[i];
    }
    __syncthreads();

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], oa[4];
      a_frag(qa, Q_s, LDK, wr + g, kk * 16 + 2 * t);
      a_frag(oa, dO_s, LDK, wr + g, kk * 16 + 2 * t);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int o = (n * 8 + g) * LDK + kk * 16 + 2 * t;
        mma_bf16(s[n], qa, ld32(K_s + o), ld32(K_s + o + 8));
        mma_bf16(dp[n], oa, ld32(V_s + o), ld32(V_s + o + 8));
      }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + n * 8 + 2 * t + (e & 1), hi = e >> 1;
        const int qi = qrow[hi];
        const bool ok = qi < Sq && kj < Sk && (!causal || kj <= qi + off);
        const float p = ok ? __expf(s[n][e] * scale - lr[hi]) : 0.f;
        float dpv = dp[n][e];
        if constexpr (DROP) dpv = drop_apply(dpv, rk[hi], kj, dr.thresh, dr.rp);
        s[n][e] = p * (dpv - gr[hi]);   // ds
      }
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t da[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* p = Kt_s + (n * 8 + g) * LDT + j * 16 + 2 * t;
        mma_bf16(acc[n], da, ld32(p), ld32(p + 8));
      }
    }
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int qi = qrow[hi];
    if (qi >= Sq) continue;
    __nv_bfloat16* row = dq + (static_cast<size_t>(b) * Sq + qi) * qs +
                         static_cast<size_t>(h) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      if (DP == D || n * 8 + 2 * t < D)   // D is even: pairs never straddle
        *reinterpret_cast<__nv_bfloat162*>(row + n * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[n][2 * hi] * scale,
                                  acc[n][2 * hi + 1] * scale);
  }
}

// dK/dV: S^T = K.Q^T (B = Q_s [query][d]), dP^T = V.dO^T (B = dO_s),
// dV += P^T.dO (B = dOt_s [d][query]), dK += dS^T.Q (B = Qt_s [d][query]).
template <int D, bool DROP>
__global__ void __launch_bounds__(MMA_NT)
    flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ dg,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, int H, int Hkv,
                             int Sq, int Sk, float scale, int causal,
                             Drop dr) {
  constexpr int DP = pad16<D>();   // the tiles' width; columns >= D are 0
  constexpr int LDK = DP + 8, LDQ = BQ2 + 8;
  constexpr int KS = DP / 16, NO = DP / 8, NQ = BQ2 / 8;
  using V = typename BfChunk<D>::V;
  constexpr int CW = BfChunk<D>::W, CH = D / CW;   // chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* K_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BK, LDK]
  __nv_bfloat16* V_s = K_s + BK * LDK;                               // [BK, LDK]
  __nv_bfloat16* Q_s = V_s + BK * LDK;                               // [BQ2, LDK]
  __nv_bfloat16* dO_s = Q_s + BQ2 * LDK;                             // [BQ2, LDK]
  __nv_bfloat16* Qt_s = dO_s + BQ2 * LDK;                            // [DP, LDQ]
  __nv_bfloat16* dOt_s = Qt_s + DP * LDQ;                            // [DP, LDQ]
  float* L_s = reinterpret_cast<float*>(dOt_s + DP * LDQ);           // [BQ2]
  float* G_s = L_s + BQ2;                                            // [BQ2]
  uint32_t* R_s = reinterpret_cast<uint32_t*>(G_s + BQ2);            // [BQ2]

  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y, b = bh / Hkv, hk = bh - b * Hkv;
  const int rep = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const size_t qs = static_cast<size_t>(H) * D;
  const size_t ks = static_cast<size_t>(Hkv) * D;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * Sk * Hkv + hk) * D;
  const int off = Sk - Sq;
  const V zero{};

  if constexpr (DP != D) {   // zero padding, never overwritten
    zero_pad_cols<D, DP>(K_s, 2 * BK + 2 * BQ2, LDK, tid, MMA_NT);
    for (int e = tid; e < (DP - D) * LDQ; e += MMA_NT) {
      Qt_s[D * LDQ + e] = __float2bfloat16(0.f);
      dOt_s[D * LDQ + e] = __float2bfloat16(0.f);
    }
  }
  for (int e = tid; e < BK * CH; e += MMA_NT) {
    const int r = e / CH, c = e - r * CH, kj = k0 + r;
    const bool ok = kj < Sk;
    *reinterpret_cast<V*>(K_s + r * LDK + c * CW) =
        ok ? *reinterpret_cast<const V*>(kb + kj * ks + c * CW) : zero;
    *reinterpret_cast<V*>(V_s + r * LDK + c * CW) =
        ok ? *reinterpret_cast<const V*>(vb + kj * ks + c * CW) : zero;
  }
  const int krow[2] = {k0 + wr + g, k0 + wr + g + 8};
  float ak[NO][4], av[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[n][e] = av[n][e] = 0.f;

  const int qt_lo = causal ? max(0, k0 - off) / BQ2 : 0;
  const int n_qt = (Sq + BQ2 - 1) / BQ2;
  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
    const __nv_bfloat16* ob = dout + (static_cast<size_t>(b) * Sq * H + h) * D;
    const float* lb = lse + (static_cast<size_t>(b) * H + h) * Sq;
    const float* gb = dg + (static_cast<size_t>(b) * H + h) * Sq;
    for (int qt = qt_lo; qt < n_qt; ++qt) {
      const int q0 = qt * BQ2;
      __syncthreads();  // K_s, V_s written / last tile's smem read
      for (int e = tid; e < BQ2 * CH; e += MMA_NT) {
        const int r = e % BQ2, c = e / BQ2, qi = q0 + r;
        const bool ok = qi < Sq;
        const V uq = ok ? *reinterpret_cast<const V*>(qb + qi * qs + c * CW) : zero;
        const V uo = ok ? *reinterpret_cast<const V*>(ob + qi * qs + c * CW) : zero;
        *reinterpret_cast<V*>(Q_s + r * LDK + c * CW) = uq;
        *reinterpret_cast<V*>(dO_s + r * LDK + c * CW) = uo;
        const __nv_bfloat16* hq = reinterpret_cast<const __nv_bfloat16*>(&uq);
        const __nv_bfloat16* ho = reinterpret_cast<const __nv_bfloat16*>(&uo);
#pragma unroll
        for (int i = 0; i < CW; ++i) {
          Qt_s[(c * CW + i) * LDQ + r] = hq[i];
          dOt_s[(c * CW + i) * LDQ + r] = ho[i];
        }
      }
      if (tid < BQ2) {
        const int qi = q0 + tid;
        L_s[tid] = qi < Sq ? lb[qi] : 0.f;
        G_s[tid] = qi < Sq ? gb[qi] : 0.f;
        if constexpr (DROP) R_s[tid] = drop_row_key(dr.seed, b * H + h, qi);
      }
      __syncthreads();

      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        a_frag(ka, K_s, LDK, wr + g, kk * 16 + 2 * t);
        a_frag(va, V_s, LDK, wr + g, kk * 16 + 2 * t);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          const int o = (n * 8 + g) * LDK + kk * 16 + 2 * t;
          mma_bf16(st[n], ka, ld32(Q_s + o), ld32(Q_s + o + 8));
          mma_bf16(dpt[n], va, ld32(dO_s + o), ld32(dO_s + o + 8));
        }
      }
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t + (e & 1), qi = q0 + c;
          const int kj = krow[e >> 1];
          const bool ok = kj < Sk && qi < Sq && (!causal || kj <= qi + off);
          const float p = ok ? __expf(st[n][e] * scale - L_s[c]) : 0.f;
          float pv = p, dpv = dpt[n][e];
          if constexpr (DROP) {
            const bool keep = drop_keep(R_s[c], kj, dr.thresh);
            pv = keep ? p * dr.rp : 0.f;
            dpv = keep ? dpv * dr.rp : 0.f;
          }
          dpt[n][e] = p * (dpv - G_s[c]);   // ds^T
          st[n][e] = pv;                    // (p z / (1 - p))^T
        }
#pragma unroll
      for (int j = 0; j < BQ2 / 16; ++j) {
        const uint32_t pa[4] = {pack_bf16(st[2 * j][0], st[2 * j][1]),
                                pack_bf16(st[2 * j][2], st[2 * j][3]),
                                pack_bf16(st[2 * j + 1][0], st[2 * j + 1][1]),
                                pack_bf16(st[2 * j + 1][2], st[2 * j + 1][3])};
        const uint32_t da[4] = {pack_bf16(dpt[2 * j][0], dpt[2 * j][1]),
                                pack_bf16(dpt[2 * j][2], dpt[2 * j][3]),
                                pack_bf16(dpt[2 * j + 1][0], dpt[2 * j + 1][1]),
                                pack_bf16(dpt[2 * j + 1][2], dpt[2 * j + 1][3])};
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const int o = (n * 8 + g) * LDQ + j * 16 + 2 * t;
          mma_bf16(av[n], pa, ld32(dOt_s + o), ld32(dOt_s + o + 8));
          mma_bf16(ak[n], da, ld32(Qt_s + o), ld32(Qt_s + o + 8));
        }
      }
    }
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int kj = krow[hi];
    if (kj >= Sk) continue;
    const size_t o = (static_cast<size_t>(b) * Sk + kj) * ks +
                     static_cast<size_t>(hk) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (DP != D && n * 8 + 2 * t >= D) continue;   // D even: no straddle
      *reinterpret_cast<__nv_bfloat162*>(dk + o + n * 8 + 2 * t) =
          __floats2bfloat162_rn(ak[n][2 * hi] * scale, ak[n][2 * hi + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + o + n * 8 + 2 * t) =
          __floats2bfloat162_rn(av[n][2 * hi], av[n][2 * hi + 1]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *dg;
  void *dq, *dk, *dv;
  int B, H, Hkv, Sq, Sk;
  float scale;
  int causal;
  Drop dr;
};

template <typename Kern>
cudaError_t set_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D, bool DROP>
int launch_simt(const Args& a, cudaStream_t st) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* o = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* dg = static_cast<const float*>(a.dg);
  cudaError_t e =
      set_smem(flash_bwd_dq_kernel<T, D, DROP>, dq_smem_bytes<D>());
  if (e == cudaSuccess)
    e = set_smem(flash_bwd_dkv_kernel<T, D, DROP>, dkv_smem_bytes<D>());
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_kernel<T, D, DROP>
      <<<dim3((a.Sq + BQ - 1) / BQ, a.B * a.H), NT, dq_smem_bytes<D>(), st>>>(
          q, k, v, o, lse, dg, static_cast<T*>(a.dq), a.H, a.Hkv, a.Sq, a.Sk,
          a.scale, a.causal, a.dr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkv_kernel<T, D, DROP>
      <<<dim3((a.Sk + BK - 1) / BK, a.B * a.Hkv), NT, dkv_smem_bytes<D>(), st>>>(
          q, k, v, o, lse, dg, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
          a.H, a.Hkv, a.Sq, a.Sk, a.scale, a.causal, a.dr);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool DROP>
int launch_mma(const Args& a, cudaStream_t st) {
  using bf = __nv_bfloat16;
  const bf* q = static_cast<const bf*>(a.q);
  const bf* k = static_cast<const bf*>(a.k);
  const bf* v = static_cast<const bf*>(a.v);
  const bf* o = static_cast<const bf*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* dg = static_cast<const float*>(a.dg);
  cudaError_t e =
      set_smem(flash_bwd_dq_mma_kernel<D, DROP>, dq_mma_smem_bytes<D>());
  if (e == cudaSuccess)
    e = set_smem(flash_bwd_dkv_mma_kernel<D, DROP>, dkv_mma_smem_bytes<D>());
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_mma_kernel<D, DROP>
      <<<dim3((a.Sq + BQ - 1) / BQ, a.B * a.H), MMA_NT,
          dq_mma_smem_bytes<D>(), st>>>(
          q, k, v, o, lse, dg, static_cast<bf*>(a.dq), a.H, a.Hkv, a.Sq,
          a.Sk, a.scale, a.causal, a.dr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkv_mma_kernel<D, DROP>
      <<<dim3((a.Sk + BK - 1) / BK, a.B * a.Hkv), MMA_NT,
          dkv_mma_smem_bytes<D>(), st>>>(
          q, k, v, o, lse, dg, static_cast<bf*>(a.dk), static_cast<bf*>(a.dv),
          a.H, a.Hkv, a.Sq, a.Sk, a.scale, a.causal, a.dr);
  return static_cast<int>(cudaGetLastError());
}

template <bool DROP>
int dispatch(const Args& a, int D, int dtype, cudaStream_t st) {
  if (dtype == PTT_F32 && D == 36) return launch_simt<float, 36, DROP>(a, st);
  if (dtype == PTT_BF16 && D == 36) return launch_mma<36, DROP>(a, st);
  if (dtype == PTT_F32 && D == 64) return launch_simt<float, 64, DROP>(a, st);
  if (dtype == PTT_F32 && D == 128) return launch_simt<float, 128, DROP>(a, st);
  if (dtype == PTT_BF16 && D == 64) return launch_mma<64, DROP>(a, st);
  if (dtype == PTT_BF16 && D == 128) return launch_mma<128, DROP>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

PTT_EXPORT_ERROR_STRING

// q/dout/dq [B, Sq, H, D], k/v/dk/dv [B, Sk, Hkv, D], all contiguous and
// 16-byte aligned; lse and dg [B, H, Sq] f32. D is 36, 64 or 128. dropout != 0
// regenerates the forward's mask from (seed, thresh) and scales kept
// entries by rp = 1 / (1 - p). Launches the dQ kernel, then the dK/dV
// kernel, on `stream`; returns the first CUDA error (0 when both launched).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* dg, void* dq,
                                   void* dk, void* dv, int B, int H, int Hkv,
                                   int Sq, int Sk, int D, float scale,
                                   int causal, int dtype, int dropout,
                                   uint32_t seed, uint32_t thresh, float rp,
                                   void* stream) {
  if (B == 0 || Sq == 0 || Sk == 0) return 0;
  const Args a{q, k, v, dout, lse, dg, dq, dk, dv,
               B, H, Hkv, Sq, Sk, scale, causal, Drop{seed, thresh, rp}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dropout ? dispatch<true>(a, D, dtype, st)
                 : dispatch<false>(a, D, dtype, st);
}
