// Flash attention backward: dQ, dK, dV.
//
// Replaces paddle_tpu/kernels/flash_attention.py `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` (pallas_calls in `_flash_core_bwd`) with all their
// options, as the forward (flash_attention.cu): causal or not, dropout, a
// dense bool mask, varlen segments and any head width 1..256.
// FlashAttention-2's recomputation scheme: nothing of the forward is kept
// but out's lse; the caller also passes dg = delta - g_lse per query row,
// with delta = rowsum(dO * O), so that with p = exp(logit - lse), the logit
// being the mirror's (flash_logits: scale * q.k, masked, hidden)
//   ds = p * (dO.v - delta + g_lse)          (the lse cotangent folds in)
//   dQ = scale * ds.K,  dK = scale * ds^T.Q,  dV = p^T.dO.
// With dropout (the reference's `_drop_mask` regenerated at :222 and :277)
// the keep bit z of (bh, i, j), with h the QUERY head also in the GQA dK/dV
// kernel, is regenerated from drop_row_key/drop_bits (common.cuh) exactly
// as the forward drew it, and
//   dV = (p * z / (1 - p))^T.dO,   ds = p * (dO.v * z / (1 - p) - dg),
// while delta = rowsum(dO * O) is unchanged. Each kernel is a template on
// DROP; p = 0 runs the DROP = false instantiation, the code without it.
// The mask has no gradient (a constant, as in the reference's kernels). A
// row whose every visible key is masked has lse <= -1e30 and, as in the
// mirror, p = 1 on the causally hidden keys, so with a mask and causality
// the dQ kernel walks past the diagonal for a tile holding such a row and
// the dK/dV kernel visits the query tiles above the diagonal that hold one.
// Layout is the forward's: q/dout/dq [B, Sq, H, D], k/v/dk/dv
// [B, Sk, Hkv, D], lse/dg [B, H, Sq] f32, H % Hkv == 0 (varlen: [Tq, H, D],
// [Tk, Hkv, D], [H, Tq], one block per sequence and tile); causal means
// query i sees key j iff j <= i + (Sk - Sq), and the kernels mask the
// ragged edges of Sq and Sk themselves (the TPU version halved its block
// until it divided S). Head widths ride zero-padded to their class in
// shared memory as in the forward (flash_common.cuh).
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
// runs the same tiling on the CUDA cores. Above DP 128 the dQ kernel's key
// tile is 32 wide and the dK/dV kernel runs 8 warps, two to each 16 key
// rows, each accumulating half of dK's and dV's columns (both recompute
// the tile's scores), so no thread holds more than 128 f32 accumulators.
#include "flash_common.cuh"

namespace {

constexpr int NT = 256;

// ---------------------------------------------------------------------------
// f32: CUDA cores. 256 threads as 16 x 16; a thread owns R rows (ty + 16 i)
// and R columns (tx + 16 j) of each T x T tile (T = 16 R: 64, or 32 above
// DP 128 for shared memory), and R rows x DP/16 columns of the f32
// accumulators.
// ---------------------------------------------------------------------------
template <int DP>
__host__ __device__ constexpr int simt_rows() {
  return DP <= 128 ? 4 : 2;
}

template <int DP>
constexpr size_t dq_smem_bytes() {
  constexpr int T = 16 * simt_rows<DP>();
  return sizeof(float) * (4 * T * (DP + 1) + T * (T + 1));
}

template <int DP>
constexpr size_t dkv_smem_bytes() {
  constexpr int T = 16 * simt_rows<DP>();
  return sizeof(float) * (4 * T * (DP + 1) + 2 * T * (T + 1) + 3 * T);
}

template <int DP, bool DROP>
__global__ void __launch_bounds__(NT)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dg, float* __restrict__ dq,
                        FlashArgs a) {
  constexpr int R = simt_rows<DP>(), T = 16 * R;
  constexpr int LD = DP + 1, LP = T + 1, ND = DP / 16;
  extern __shared__ float smem[];
  float* Q_s = smem;            // [T, LD]
  float* dO_s = Q_s + T * LD;   // [T, LD]
  float* K_s = dO_s + T * LD;   // [T, LD]
  float* V_s = K_s + T * LD;    // [T, LD]
  float* dS_s = V_s + T * LD;   // [T, LP]

  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const FlashRows rw = flash_rows(a, b, h);
  const int q0 = blockIdx.x * T;
  if (q0 >= rw.Lq) return;    // varlen: past this sequence
  const int hk = h / (a.H / a.Hkv), D = a.D;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t qs = static_cast<size_t>(a.H) * D;
  const size_t ks = static_cast<size_t>(a.Hkv) * D;
  const size_t qoff = (static_cast<size_t>(rw.qbase) * a.H + h) * D;
  const float* qb = q + qoff;
  const float* ob = dout + qoff;
  const float* kb = k + (static_cast<size_t>(rw.kbase) * a.Hkv + hk) * D;
  const float* vb = v + (static_cast<size_t>(rw.kbase) * a.Hkv + hk) * D;

  for (int e = tid; e < T * DP; e += NT) {
    const int r = e / DP, d = e - r * DP, qi = q0 + r;
    const bool ok = qi < rw.Lq && d < D;
    Q_s[r * LD + d] = ok ? qb[qi * qs + d] : 0.f;
    dO_s[r * LD + d] = ok ? ob[qi * qs + d] : 0.f;
  }
  float lr[R], gr[R], acc[R][ND];
  uint32_t rk[R];   // dropout row keys
  int need = 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
    lr[i] = qi < rw.Lq ? lse[rw.lse0 + qi] : INFINITY;   // padding: p = 0
    gr[i] = qi < rw.Lq ? dg[rw.lse0 + qi] : 0.f;
    need |= flash_needs_hidden(lr[i]);
    if constexpr (DROP) rk[i] = drop_row_key(drop_seed(a.dr), rw.dbh, rw.di0 + qi);
#pragma unroll
    for (int c = 0; c < ND; ++c) acc[i][c] = 0.f;
  }

  int n_kt = (rw.Lk + T - 1) / T;
  if (a.causal) {
    const int last = min(q0 + T - 1, rw.Lq - 1) + rw.off;  // last visible key
    const int n_vis = min(n_kt, last / T + 1);
    if (a.mask == nullptr || !__syncthreads_or(need)) n_kt = n_vis;
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * T;
    __syncthreads();  // Q_s, dO_s written / last tile's K_s, V_s, dS_s read
    for (int e = tid; e < T * DP; e += NT) {
      const int r = e / DP, d = e - r * DP, kj = k0 + r;
      const bool ok = kj < rw.Lk && d < D;
      K_s[r * LD + d] = ok ? kb[kj * ks + d] : 0.f;
      V_s[r * LD + d] = ok ? vb[kj * ks + d] : 0.f;
    }
    __syncthreads();

    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qv[R], o[R], kk[R], vv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qv[i] = Q_s[(ty + 16 * i) * LD + d];
        o[i] = dO_s[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        kk[j] = K_s[(tx + 16 * j) * LD + d];
        vv[j] = V_s[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] += qv[i] * kk[j];
          dp[i][j] += o[i] * vv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] *= a.scale;
    flash_logits<R * R, true>(&s[0][0], a, rw, [&](int e, int& i, int& j) {
      i = q0 + ty + 16 * (e / R);
      j = k0 + tx + 16 * (e % R);
    });
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kj = k0 + tx + 16 * j;
        const float p = expf(s[i][j] - lr[i]);
        float dpv = dp[i][j];
        if constexpr (DROP)
          dpv = drop_apply(dpv, rk[i], rw.dj0 + kj, a.dr.thresh, a.dr.rp);
        dS_s[(ty + 16 * i) * LP + tx + 16 * j] = p * (dpv - gr[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < T; ++kk) {
      float ds[R];
#pragma unroll
      for (int i = 0; i < R; ++i) ds[i] = dS_s[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        const float kv = K_s[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][c] += ds[i] * kv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= rw.Lq) continue;
    float* row = dq + (static_cast<size_t>(rw.qbase) + qi) * qs +
                 static_cast<size_t>(h) * D;
#pragma unroll
    for (int c = 0; c < ND; ++c)
      if (tx + 16 * c < D) row[tx + 16 * c] = acc[i][c] * a.scale;
  }
}

template <int DP, bool DROP>
__global__ void __launch_bounds__(NT)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dg, float* __restrict__ dk,
                         float* __restrict__ dv, FlashArgs a) {
  constexpr int R = simt_rows<DP>(), T = 16 * R;
  constexpr int LD = DP + 1, LP = T + 1, ND = DP / 16;
  extern __shared__ float smem[];
  float* K_s = smem;            // [T, LD]
  float* V_s = K_s + T * LD;    // [T, LD]
  float* Q_s = V_s + T * LD;    // [T, LD]
  float* dO_s = Q_s + T * LD;   // [T, LD]
  float* P_s = dO_s + T * LD;   // [T, LP]  p^T
  float* dS_s = P_s + T * LP;   // [T, LP]  ds^T
  float* L_s = dS_s + T * LP;   // [T]      lse of the query tile
  float* G_s = L_s + T;         // [T]      dg of the query tile
  uint32_t* R_s = reinterpret_cast<uint32_t*>(G_s + T);  // [T] row keys

  const int k0 = blockIdx.x * T;
  const int bh = blockIdx.y, b = bh / a.Hkv, hk = bh - b * a.Hkv;
  const int rep = a.H / a.Hkv, D = a.D;
  const FlashRows r0 = flash_rows(a, b, hk * rep);
  if (k0 >= r0.Lk) return;    // varlen: past this sequence
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t qs = static_cast<size_t>(a.H) * D;
  const size_t ks = static_cast<size_t>(a.Hkv) * D;
  const float* kb = k + (static_cast<size_t>(r0.kbase) * a.Hkv + hk) * D;
  const float* vb = v + (static_cast<size_t>(r0.kbase) * a.Hkv + hk) * D;

  for (int e = tid; e < T * DP; e += NT) {
    const int r = e / DP, d = e - r * DP, kj = k0 + r;
    const bool ok = kj < r0.Lk && d < D;
    K_s[r * LD + d] = ok ? kb[kj * ks + d] : 0.f;
    V_s[r * LD + d] = ok ? vb[kj * ks + d] : 0.f;
  }
  float ak[R][ND], av[R][ND];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < ND; ++c) ak[i][c] = av[i][c] = 0.f;

  // the first query that sees key k0 is k0 - off
  const int qt_lo = a.causal ? max(0, k0 - r0.off) / T : 0;
  const int n_qt = (r0.Lq + T - 1) / T;
  const bool hidden = a.causal && a.mask != nullptr;
  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    const FlashRows rw = flash_rows(a, b, h);
    const size_t qoff = (static_cast<size_t>(rw.qbase) * a.H + h) * D;
    const float* qb = q + qoff;
    const float* ob = dout + qoff;
    const float* lb = lse + rw.lse0;
    const float* gb = dg + rw.lse0;
    for (int qt = hidden ? 0 : qt_lo; qt < n_qt; ++qt) {
      const int q0 = qt * T;
      if (qt < qt_lo) {   // every key here is hidden from every query row
        const int qi = q0 + tid;
        if (!__syncthreads_or(tid < T && qi < rw.Lq &&
                              flash_needs_hidden(lb[qi])))
          continue;
      }
      __syncthreads();  // K_s, V_s written / last tile's smem read
      for (int e = tid; e < T * DP; e += NT) {
        const int r = e / DP, d = e - r * DP, qi = q0 + r;
        const bool ok = qi < rw.Lq && d < D;
        Q_s[r * LD + d] = ok ? qb[qi * qs + d] : 0.f;
        dO_s[r * LD + d] = ok ? ob[qi * qs + d] : 0.f;
      }
      if (tid < T) {
        const int qi = q0 + tid;
        L_s[tid] = qi < rw.Lq ? lb[qi] : INFINITY;   // padding: p = 0
        G_s[tid] = qi < rw.Lq ? gb[qi] : 0.f;
        if constexpr (DROP)
          R_s[tid] = drop_row_key(drop_seed(a.dr), rw.dbh, rw.di0 + qi);
      }
      __syncthreads();

      float st[R][R], dpt[R][R];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DP; ++d) {
        float kk[R], vv[R], qv[R], o[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          kk[i] = K_s[(ty + 16 * i) * LD + d];
          vv[i] = V_s[(ty + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
          qv[j] = Q_s[(tx + 16 * j) * LD + d];
          o[j] = dO_s[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) {
            st[i][j] += kk[i] * qv[j];
            dpt[i][j] += vv[i] * o[j];
          }
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) st[i][j] *= a.scale;
      flash_logits<R * R, true>(&st[0][0], a, rw, [&](int e, int& i, int& j) {
        i = q0 + tx + 16 * (e % R);
        j = k0 + ty + 16 * (e / R);
      });
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int kj = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int c = tx + 16 * j;
          const float p = expf(st[i][j] - L_s[c]);
          float pv = p, dpv = dpt[i][j];
          if constexpr (DROP) {
            const bool keep = drop_keep(R_s[c], rw.dj0 + kj, a.dr.thresh);
            pv = keep ? p * a.dr.rp : 0.f;
            dpv = keep ? dpv * a.dr.rp : 0.f;
          }
          P_s[(ty + 16 * i) * LP + c] = pv;
          dS_s[(ty + 16 * i) * LP + c] = p * (dpv - G_s[c]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < T; ++jj) {
        float p[R], ds[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          p[i] = P_s[(ty + 16 * i) * LP + jj];
          ds[i] = dS_s[(ty + 16 * i) * LP + jj];
        }
#pragma unroll
        for (int c = 0; c < ND; ++c) {
          const float o = dO_s[jj * LD + tx + 16 * c];
          const float qv = Q_s[jj * LD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            av[i][c] += p[i] * o;
            ak[i][c] += ds[i] * qv;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= r0.Lk) continue;
    const size_t o = (static_cast<size_t>(r0.kbase) + kj) * ks +
                     static_cast<size_t>(hk) * D;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      if (tx + 16 * c >= D) continue;
      dk[o + tx + 16 * c] = ak[i][c] * a.scale;
      dv[o + tx + 16 * c] = av[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulate), 4 warps of 16
// rows each (8 in the dK/dV kernel above DP 128). Operands that a product
// reads as B ([n][k] in shared memory, see mma_bf16) are also stored
// transposed where the next product needs them the other way round.
// ---------------------------------------------------------------------------
constexpr int MMA_NT = 128;
constexpr int BQ = 64;    // query tile of the dQ kernel
constexpr int BK = 64;    // key tile of the dK/dV kernel
constexpr int BQ2 = 32;   // query tile of the dK/dV kernel (register budget)

template <int DP>
__host__ __device__ constexpr int dq_bk() {   // the dQ kernel's key tile
  return DP <= 128 ? 64 : 32;
}

template <int DP>
__host__ __device__ constexpr int dkv_split() {   // dK/dV warps a 16-key row
  return DP <= 128 ? 1 : 2;
}

template <int DP>
constexpr size_t dq_mma_smem_bytes() {
  constexpr int BKd = dq_bk<DP>();
  return sizeof(__nv_bfloat16) *
         ((2 * BQ + 2 * BKd) * (DP + 8) + DP * (BKd + 8));
}

template <int DP>
constexpr size_t dkv_mma_smem_bytes() {
  return sizeof(__nv_bfloat16) *
             ((2 * BK + 2 * BQ2) * (DP + 8) + 2 * DP * (BQ2 + 8)) +
         sizeof(float) * 3 * BQ2;
}

// dQ: S = Q.K^T (B = K_s [key][d]), dP = dO.V^T (B = V_s [key][d]),
// dQ += dS.K (B = Kt_s [d][key]).
template <int DP, int W, bool DROP, bool MASK>
__global__ void __launch_bounds__(MMA_NT)
    flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ dg,
                            __nv_bfloat16* __restrict__ dq, FlashArgs a) {
  constexpr int BKd = dq_bk<DP>();
  constexpr int LDK = DP + 8, LDT = BKd + 8;
  constexpr int KS = DP / 16, NO = DP / 8, NS = BKd / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ, LDK]
  __nv_bfloat16* dO_s = Q_s + BQ * LDK;                              // [BQ, LDK]
  __nv_bfloat16* K_s = dO_s + BQ * LDK;                              // [BKd, LDK]
  __nv_bfloat16* V_s = K_s + BKd * LDK;                              // [BKd, LDK]
  __nv_bfloat16* Kt_s = V_s + BKd * LDK;                             // [DP, LDT]

  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const FlashRows rw = flash_rows(a, b, h);
  const int q0 = blockIdx.x * BQ;
  if (q0 >= rw.Lq) return;    // varlen: past this sequence
  const int hk = h / (a.H / a.Hkv), D = a.D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const size_t qs = static_cast<size_t>(a.H) * D;
  const size_t ks = static_cast<size_t>(a.Hkv) * D;
  const size_t qoff = (static_cast<size_t>(rw.qbase) * a.H + h) * D;
  const __nv_bfloat16* qb = q + qoff;
  const __nv_bfloat16* ob = dout + qoff;
  const __nv_bfloat16* kb =
      k + (static_cast<size_t>(rw.kbase) * a.Hkv + hk) * D;
  const __nv_bfloat16* vb =
      v + (static_cast<size_t>(rw.kbase) * a.Hkv + hk) * D;

  load_rows<BQ, MMA_NT, DP, W>(Q_s, LDK, qb + q0 * qs, qs, rw.Lq - q0, D, a.chunk);
  load_rows<BQ, MMA_NT, DP, W>(dO_s, LDK, ob + q0 * qs, qs, rw.Lq - q0, D, a.chunk);
  const int qrow[2] = {q0 + wr + g, q0 + wr + g + 8};
  float lr[2], gr[2];
  uint32_t rk[2];   // dropout row keys
  int need = 0;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const bool ok = qrow[hi] < rw.Lq;
    lr[hi] = ok ? lse[rw.lse0 + qrow[hi]] : INFINITY;   // padding: p = 0
    gr[hi] = ok ? dg[rw.lse0 + qrow[hi]] : 0.f;
    need |= flash_needs_hidden(lr[hi]);
    if constexpr (DROP)
      rk[hi] = drop_row_key(drop_seed(a.dr), rw.dbh, rw.di0 + qrow[hi]);
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int n_kt = (rw.Lk + BKd - 1) / BKd;
  if (a.causal) {
    const int last = min(q0 + BQ - 1, rw.Lq - 1) + rw.off;
    const int n_vis = min(n_kt, last / BKd + 1);
    if (!MASK || a.mask == nullptr || !__syncthreads_or(need)) n_kt = n_vis;
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BKd;
    __syncthreads();  // Q_s, dO_s written / last tile's K_s, V_s, Kt_s read
    load_rows_t<BKd, MMA_NT, DP, W, true>(Kt_s, LDT, K_s, LDK, kb + k0 * ks,
                                          ks, rw.Lk - k0, D, a.chunk);
    load_rows<BKd, MMA_NT, DP, W>(V_s, LDK, vb + k0 * ks, ks, rw.Lk - k0, D, a.chunk);
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
      for (int e = 0; e < 4; ++e) s[n][e] *= a.scale;
    flash_logits<NS * 4, MASK>(&s[0][0], a, rw, [&](int x, int& i, int& j) {
      i = qrow[(x & 3) >> 1];
      j = k0 + (x >> 2) * 8 + 2 * t + (x & 1);
    });
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + n * 8 + 2 * t + (e & 1), hi = e >> 1;
        const float p = __expf(s[n][e] - lr[hi]);
        float dpv = dp[n][e];
        if constexpr (DROP)
          dpv = drop_apply(dpv, rk[hi], rw.dj0 + kj, a.dr.thresh, a.dr.rp);
        s[n][e] = p * (dpv - gr[hi]);   // ds
      }
#pragma unroll
    for (int j = 0; j < BKd / 16; ++j) {
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
    if (qi >= rw.Lq) continue;
    __nv_bfloat16* row = dq + (static_cast<size_t>(rw.qbase) + qi) * qs +
                         static_cast<size_t>(h) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      store_pair<W>(row, n * 8 + 2 * t, D, acc[n][2 * hi] * a.scale,
                 acc[n][2 * hi + 1] * a.scale);
  }
}

// dK/dV: S^T = K.Q^T (B = Q_s [query][d]), dP^T = V.dO^T (B = dO_s),
// dV += P^T.dO (B = dOt_s [d][query]), dK += dS^T.Q (B = Qt_s [d][query]).
// WN warps share each 16 key rows; warp w takes rows 16 (w % 4) and
// columns [cg DP / WN, (cg + 1) DP / WN) of dK and dV, cg = w / 4.
template <int DP, int W, bool DROP, bool MASK>
__global__ void __launch_bounds__(MMA_NT * dkv_split<DP>())
    flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ dg,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, FlashArgs a) {
  constexpr int WN = dkv_split<DP>(), NTH = MMA_NT * WN;
  constexpr int LDK = DP + 8, LDQ = BQ2 + 8;
  constexpr int KS = DP / 16, NO = DP / WN / 8, NQ = BQ2 / 8;
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
  const int bh = blockIdx.y, b = bh / a.Hkv, hk = bh - b * a.Hkv;
  const int rep = a.H / a.Hkv, D = a.D;
  const FlashRows r0 = flash_rows(a, b, hk * rep);
  if (k0 >= r0.Lk) return;    // varlen: past this sequence
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wr = (warp & 3) * 16;
  const int c0 = (warp >> 2) * (DP / WN);   // this warp's dK / dV columns
  const size_t qs = static_cast<size_t>(a.H) * D;
  const size_t ks = static_cast<size_t>(a.Hkv) * D;
  const __nv_bfloat16* kb =
      k + (static_cast<size_t>(r0.kbase) * a.Hkv + hk) * D;
  const __nv_bfloat16* vb =
      v + (static_cast<size_t>(r0.kbase) * a.Hkv + hk) * D;

  load_rows<BK, NTH, DP, W>(K_s, LDK, kb + k0 * ks, ks, r0.Lk - k0, D, a.chunk);
  load_rows<BK, NTH, DP, W>(V_s, LDK, vb + k0 * ks, ks, r0.Lk - k0, D, a.chunk);
  const int krow[2] = {k0 + wr + g, k0 + wr + g + 8};
  float ak[NO][4], av[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[n][e] = av[n][e] = 0.f;

  const int qt_lo = a.causal ? max(0, k0 - r0.off) / BQ2 : 0;
  const int n_qt = (r0.Lq + BQ2 - 1) / BQ2;
  const bool hidden = MASK && a.causal && a.mask != nullptr;
  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    const FlashRows rw = flash_rows(a, b, h);
    const size_t qoff = (static_cast<size_t>(rw.qbase) * a.H + h) * D;
    const __nv_bfloat16* qb = q + qoff;
    const __nv_bfloat16* ob = dout + qoff;
    const float* lb = lse + rw.lse0;
    const float* gb = dg + rw.lse0;
    for (int qt = hidden ? 0 : qt_lo; qt < n_qt; ++qt) {
      const int q0 = qt * BQ2;
      if (qt < qt_lo) {   // every key here is hidden from every query row
        const int qi = q0 + tid;
        if (!__syncthreads_or(tid < BQ2 && qi < rw.Lq &&
                              flash_needs_hidden(lb[qi])))
          continue;
      }
      __syncthreads();  // K_s, V_s written / last tile's smem read
      load_rows_t<BQ2, NTH, DP, W, true>(Qt_s, LDQ, Q_s, LDK, qb + q0 * qs,
                                         qs, rw.Lq - q0, D, a.chunk);
      load_rows_t<BQ2, NTH, DP, W, true>(dOt_s, LDQ, dO_s, LDK, ob + q0 * qs,
                                         qs, rw.Lq - q0, D, a.chunk);
      if (tid < BQ2) {
        const int qi = q0 + tid;
        L_s[tid] = qi < rw.Lq ? lb[qi] : INFINITY;   // padding: p = 0
        G_s[tid] = qi < rw.Lq ? gb[qi] : 0.f;
        if constexpr (DROP)
          R_s[tid] = drop_row_key(drop_seed(a.dr), rw.dbh, rw.di0 + qi);
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
        for (int e = 0; e < 4; ++e) st[n][e] *= a.scale;
      flash_logits<NQ * 4, MASK>(&st[0][0], a, rw, [&](int x, int& i, int& j) {
        i = q0 + (x >> 2) * 8 + 2 * t + (x & 1);
        j = krow[(x & 3) >> 1];
      });
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t + (e & 1);
          const int kj = krow[e >> 1];
          const float p = __expf(st[n][e] - L_s[c]);
          float pv = p, dpv = dpt[n][e];
          if constexpr (DROP) {
            const bool keep = drop_keep(R_s[c], rw.dj0 + kj, a.dr.thresh);
            pv = keep ? p * a.dr.rp : 0.f;
            dpv = keep ? dpv * a.dr.rp : 0.f;
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
          const int o = (c0 + n * 8 + g) * LDQ + j * 16 + 2 * t;
          mma_bf16(av[n], pa, ld32(dOt_s + o), ld32(dOt_s + o + 8));
          mma_bf16(ak[n], da, ld32(Qt_s + o), ld32(Qt_s + o + 8));
        }
      }
    }
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int kj = krow[hi];
    if (kj >= r0.Lk) continue;
    const size_t o = (static_cast<size_t>(r0.kbase) + kj) * ks +
                     static_cast<size_t>(hk) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = c0 + n * 8 + 2 * t;
      store_pair<W>(dk + o, col, D, ak[n][2 * hi] * a.scale,
                 ak[n][2 * hi + 1] * a.scale);
      store_pair<W>(dv + o, col, D, av[n][2 * hi], av[n][2 * hi + 1]);
    }
  }
}

struct Tensors {
  const void *q, *k, *v, *dout, *lse, *dg;
  void *dq, *dk, *dv;
};

template <typename Kern>
cudaError_t set_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// dQ kernel, then dK/dV kernel, on `st`
template <typename T, typename DqKern, typename DkvKern>
int launch(DqKern dq_kern, int q_tile, int dq_threads, size_t dq_smem,
           DkvKern dkv_kern, int k_tile, int dkv_threads, size_t dkv_smem,
           const Tensors& x, const FlashArgs& a, cudaStream_t st) {
  const T* q = static_cast<const T*>(x.q);
  const T* k = static_cast<const T*>(x.k);
  const T* v = static_cast<const T*>(x.v);
  const T* o = static_cast<const T*>(x.dout);
  const float* lse = static_cast<const float*>(x.lse);
  const float* dg = static_cast<const float*>(x.dg);
  cudaError_t e = set_smem(dq_kern, dq_smem);
  if (e == cudaSuccess) e = set_smem(dkv_kern, dkv_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_kern<<<dim3((a.Sq + q_tile - 1) / q_tile, a.B * a.H), dq_threads,
            dq_smem, st>>>(q, k, v, o, lse, dg, static_cast<T*>(x.dq), a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dkv_kern<<<dim3((a.Sk + k_tile - 1) / k_tile, a.B * a.Hkv), dkv_threads,
             dkv_smem, st>>>(q, k, v, o, lse, dg, static_cast<T*>(x.dk),
                             static_cast<T*>(x.dv), a);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, int W, bool DROP, bool MASK>
int launch_mma(const Tensors& x, const FlashArgs& a, cudaStream_t st) {
  return launch<__nv_bfloat16>(
      flash_bwd_dq_mma_kernel<DP, W, DROP, MASK>, BQ, MMA_NT,
      dq_mma_smem_bytes<DP>(), flash_bwd_dkv_mma_kernel<DP, W, DROP, MASK>,
      BK, MMA_NT * dkv_split<DP>(), dkv_mma_smem_bytes<DP>(), x, a, st);
}

template <int DP, bool DROP>
int launch_width(const Tensors& x, const FlashArgs& a, int dtype,
                 cudaStream_t st) {
  if (dtype == PTT_F32) {
    constexpr int T = 16 * simt_rows<DP>();
    return launch<float>(flash_bwd_dq_kernel<DP, DROP>, T, NT,
                         dq_smem_bytes<DP>(), flash_bwd_dkv_kernel<DP, DROP>,
                         T, NT, dkv_smem_bytes<DP>(), x, a, st);
  }
  // bf16: the rows' chunk width, and the mask compiled in or out (one
  // instantiation takes the narrow chunks, for odd or misaligned rows: it
  // reads their width and tests the mask at run time)
  const bool m = a.mask != nullptr;
  switch (a.chunk) {
    case 16:
      return m ? launch_mma<DP, 16, DROP, true>(x, a, st)
               : launch_mma<DP, 16, DROP, false>(x, a, st);
    case 8:
      return m ? launch_mma<DP, 8, DROP, true>(x, a, st)
               : launch_mma<DP, 8, DROP, false>(x, a, st);
    default:   // 4 or 2, read at run time
      return launch_mma<DP, 0, DROP, true>(x, a, st);
  }
}

template <bool DROP>
int dispatch(const Tensors& x, const FlashArgs& a, int dtype,
             cudaStream_t st) {
  switch (flash_width(a.D)) {
#define PTT_CASE(DP) \
  case DP:           \
    return launch_width<DP, DROP>(x, a, dtype, st);
    PTT_FLASH_WIDTHS(PTT_CASE)
#undef PTT_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

PTT_EXPORT_ERROR_STRING

// q/dout/dq [B, Sq, H, D], k/v/dk/dv [B, Sk, Hkv, D], all contiguous; lse
// and dg [B, H, Sq] f32 (varlen: [Tq, H, D], [Tk, Hkv, D], [H, Tq], as the
// forward's entry). D in 1..256. dropout != 0 regenerates the forward's mask
// from (seed, thresh) and scales kept entries by rp = 1 / (1 - p); mask and
// its strides as the forward's. Launches the dQ kernel, then the dK/dV
// kernel, on `stream`; returns the first CUDA error (0 when both launched).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dg, void* dq, void* dk, void* dv, int B,
    int H, int Hkv, int Sq, int Sk, int D, float scale, int causal, int dtype,
    int dropout, uint32_t seed, const void* seed_ptr, uint32_t thresh,
    float rp, const void* mask,
    long long m_sb, long long m_sh, long long m_sq, long long m_sk,
    const void* cu_q, const void* cu_k, int Tq, int chunk, void* stream) {
  if (B == 0 || Sq == 0 || Sk == 0) return 0;
  if (D < 1 || D > 256) return static_cast<int>(cudaErrorInvalidValue);
  const FlashArgs a{B, H, Hkv, Sq, Sk, D, scale, causal,
                    Drop{seed, thresh, rp,
                         static_cast<const long long*>(seed_ptr)},
                    static_cast<const uint8_t*>(mask), m_sb, m_sh, m_sq, m_sk,
                    static_cast<const int*>(cu_q),
                    static_cast<const int*>(cu_k), Tq, chunk};
  const Tensors x{q, k, v, dout, lse, dg, dq, dk, dv};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dropout ? dispatch<true>(x, a, dtype, st)
                 : dispatch<false>(x, a, dtype, st);
}
