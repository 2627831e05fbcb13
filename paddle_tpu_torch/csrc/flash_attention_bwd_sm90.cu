// Flash attention backward for Hopper: dQ, dK, dV in bf16 at the
// head-width classes 64 and 128, rows and base addresses 16-byte aligned
// (kernels/flash_attention.py `_flash_design`). The other bf16 widths TMA
// reads run the classes of flash_attention_bwd_sm90.cuh; f32 and narrower
// bf16 rows keep flash_attention_bwd.cu. These two classes keep their own
// kernels, as the forward's do (flash_attention_sm90.cu).
//
// Replaces paddle_tpu/kernels/flash_attention.py `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` (pallas_calls in `_flash_core_bwd`) for those inputs,
// with every option of flash_attention_bwd.cu and the same function (its
// source note states the recomputation, the dropout rule and the hidden
// rows), differing only in summation order.
//
// Bound on the H100: the flops of five products of the forward's size (S
// and dP recomputed, then dQ, dK, dV), about half of it causal, against
// 989 TFLOP/s bf16. flash_attention_bwd.cu runs mma.sync on tiles that
// threads load and transpose into shared memory (Q, K, dO each stored
// twice), with 32-query tiles in the dK/dV kernel for its registers. This
// design
// keeps FlashAttention-2's two kernels, each now on wgmma fed by TMA, in
// the forward's pipeline (flash_attention_sm90.cu: one producer warp, a
// ring of stages with full and empty mbarriers, two consumer warpgroups,
// setmaxnreg):
// - dQ: one block per (128-query tile, batch * head); Q and dO load once,
//   key tiles of 64 (K and V) stream. S = Q.K^T and dP = dO.V^T (wgmma,
//   both operands K-major in shared memory), ds = p * (dp - dg) in
//   registers, dQ += ds.K with ds as the register A operand and K read
//   MN-major (the transpose bit), so nothing is transposed by a thread.
// - dK/dV: one block per (key tile, batch * KV head); K and V load once,
//   then for each query head of the KV group the query tiles of 64 from
//   the diagonal on stream: Q, dO, and the rows' lse, dg and dropout keys,
//   which the producer warp stages beside them. S^T = K.Q^T and
//   dP^T = V.dO^T, then dV += (p z / (1 - p))^T.dO and dK += ds^T.Q with
//   the transposed probabilities and ds as register A operands, Q and dO
//   read MN-major; dK and dV stay in f32 registers and are stored once.
//   The consumer warpgroups split a block by keys at head_dim 64 and by
//   output at 128 (dkv_by_keys: the key split spilled there).
// Seven products (eight a tile at head_dim 128) where FlashAttention-3's
// single pass does five: it adds dQ's partial sums across key blocks with
// atomics. The two kernels were kept because they add no atomics, so two
// runs still give the same bits, and both reuse the forward's pipeline and
// fragments.
// The mask, causality and the ragged ends are applied only on the tiles
// that need them, as in the forward. A row whose every visible key is
// masked (lse <= -1e30, flash_needs_hidden) takes p = 1 on the causally
// hidden keys: with a mask and causality the dQ warpgroup holding such a
// row walks past its diagonal, and the dK/dV producer loads a query tile
// above the diagonal only when lse says one of its rows needs it (a flag
// beside the stage tells the consumers). Rows past a sequence's end are
// loaded but never stored; dQ, dK and dV are stored per row, predicated.
#include "flash_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int NTH = 384;
constexpr int S = 2;   // stages of the dQ ring
constexpr int BQ = 128, BKQ = 64;   // dQ kernel: query tile, key tile
constexpr int BQK = 64;   // dK/dV kernel: query tile
constexpr int SK = 3;     // stages of the dK/dV ring

// How the dK/dV kernel's two consumer warpgroups share a block. At head_dim
// 64 by keys: 128 keys a block, each warpgroup 64 of them with both dK and
// dV (2 x 32 f32 accumulators a thread). At 128 by output: 64 keys a block,
// both warpgroups on all of them, warpgroup 0 accumulating dV, 1 dK (64
// accumulators each): a split by keys would hold 128 beside the score
// tiles and spilled there (ptxas keeps these consumers near 168
// registers). The output split recomputes S^T in both warpgroups, five
// products a tile where the key split runs four.
template <int D>
__host__ __device__ constexpr bool dkv_by_keys() {
  return D == 64;
}

template <int D>
__host__ __device__ constexpr int dkv_bk() {   // the dK/dV key tile
  return dkv_by_keys<D>() ? 128 : 64;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return 1024 + 2 * (2 * BQ * D + 2 * S * BKQ * D) + 8 * 16;
}

// per stage of the dK/dV ring, beside the Q and dO tiles: the rows' lse,
// dg and dropout keys, and whether the tile is computed at all
struct alignas(16) RowStage {
  float lse[BQK];
  float dg[BQK];
  uint32_t krow[BQK];
  int need;
};

template <int D>
constexpr size_t dkv_smem_bytes() {
  return 1024 + 2 * (2 * dkv_bk<D>() * D + 2 * SK * BQK * D) +
         SK * sizeof(RowStage) +
         8 * 16;
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------
template <int D, bool DROP, bool MASK>
__global__ void __launch_bounds__(NTH, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tdo,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const float* __restrict__ lse,
                             const float* __restrict__ dg,
                             bf16* __restrict__ dq, FlashArgs a) {
  constexpr int NH = D / 64, NS = BKQ / 2, NO = D / 2;
  extern __shared__ unsigned char smem_raw[];
  bf16* Q_s = reinterpret_cast<bf16*>(sm90::align1024(smem_raw));  // [NH][BQ][64]
  bf16* dO_s = Q_s + BQ * D;                                 // [NH][BQ][64]
  bf16* K_s = dO_s + BQ * D;                                 // [S][NH][BKQ][64]
  bf16* V_s = K_s + S * BKQ * D;                             // [S][NH][BKQ][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(V_s + S * BKQ * D);
  uint64_t* empty = full + S;
  uint64_t* qbar = empty + S;

  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const FlashRows rw = flash_rows(a, b, h);
  const int q0 = (a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BQ;
  if (q0 >= rw.Lq) return;    // varlen: past this sequence
  const bool varlen = a.cu_q != nullptr;
  const int n_kt = (rw.Lk + BKQ - 1) / BKQ;
  int n_vis = n_kt;
  if (a.causal)
    n_vis = min(n_kt, (min(q0 + BQ - 1, rw.Lq - 1) + rw.off) / BKQ + 1);
  const int n_load = MASK && a.causal ? n_kt : n_vis;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);
    }
    sm90::mbar_init(qbar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = sm90::warpgroup();
  if (wg == 0) {   // producer warpgroup
    sm90::reg_dealloc<24>();
    if (tid == 0) {
      const int hk = h / (a.H / a.Hkv);
      const int qr = varlen ? rw.qbase + q0 : q0, kr = varlen ? rw.kbase : 0;
      const int bb = varlen ? 0 : b;
      sm90::mbar_arrive_tx(qbar, 2 * BQ * D * 2);
      for (int hf = 0; hf < NH; ++hf) {
        sm90::tma_load(Q_s + hf * BQ * 64, &tq, qbar, hf * 64, h, qr, bb);
        sm90::tma_load(dO_s + hf * BQ * 64, &tdo, qbar, hf * 64, h, qr, bb);
      }
      for (int it = 0; it < n_load; ++it) {
        const int s = it % S;
        sm90::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        sm90::mbar_arrive_tx(&full[s], 2 * BKQ * D * 2);
        for (int hf = 0; hf < NH; ++hf) {
          const int off = (s * NH + hf) * BKQ * 64;
          sm90::tma_load(K_s + off, &tk, &full[s], hf * 64, hk,
                         kr + it * BKQ, bb);
          sm90::tma_load(V_s + off, &tv, &full[s], hf * 64, hk,
                         kr + it * BKQ, bb);
        }
      }
    }
    return;
  }

  sm90::reg_alloc<240>();
  const int w = wg - 1, t = tid % 128, tq4 = t & 3;
  const int r0 = q0 + 64 * w;
  const int row[2] = {r0 + sm90::acc_row(t, 0), r0 + sm90::acc_row(t, 2)};
  float lr[2], gr[2], lb[2];
  uint32_t rk[2] = {0, 0};
  int need = 0;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const bool ok = row[hi] < rw.Lq;
    lr[hi] = ok ? lse[rw.lse0 + row[hi]] : INFINITY;   // padding: p = 0
    gr[hi] = ok ? dg[rw.lse0 + row[hi]] : 0.f;
    lb[hi] = lr[hi] * sm90::LOG2E;
    need |= flash_needs_hidden(lr[hi]);
    if constexpr (DROP)
      rk[hi] = drop_row_key(drop_seed(a.dr), rw.dbh, rw.di0 + row[hi]);
  }
  int n_own = 0;
  if (r0 < rw.Lq)
    n_own = a.causal
                ? min(n_kt, (min(r0 + 63, rw.Lq - 1) + rw.off) / BKQ + 1)
                : n_kt;
  const bool walk = MASK && a.causal && sm90::bar_or(1 + w, 128, need);
  const float sl2 = a.scale * sm90::LOG2E;
  float acc[NO];
#pragma unroll
  for (int x = 0; x < NO; ++x) acc[x] = 0.f;

  sm90::mbar_wait(qbar, 0);
  const bf16* Qw = Q_s + 64 * w * 64;
  const bf16* Ow = dO_s + 64 * w * 64;
  for (int it = 0; it < n_load; ++it) {
    const int s = it % S;
    sm90::mbar_wait(&full[s], (it / S) & 1);
    if (it < n_own || walk) {
      const bf16* Ks = K_s + s * BKQ * D;
      const bf16* Vs = V_s + s * BKQ * D;
      const uint64_t qd = sm90::opaque(sm90::desc(Qw, 16, 1024));
      const uint64_t od = sm90::opaque(sm90::desc(Ow, 16, 1024));
      const uint64_t kd = sm90::desc(Ks, 16, 1024);
      const uint64_t vd = sm90::desc(Vs, 16, 1024);
      float sc[NS], dp[NS];
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int hf = kk / 4, c = (kk % 4) * 16;
        sm90::wgmma_ss<BKQ>(sc, sm90::desc_add(qd, hf * BQ * 64 + c),
                            sm90::desc_add(kd, hf * BKQ * 64 + c), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int hf = kk / 4, c = (kk % 4) * 16;
        sm90::wgmma_ss<BKQ>(dp, sm90::desc_add(od, hf * BQ * 64 + c),
                            sm90::desc_add(vd, hf * BKQ * 64 + c), kk > 0);
      }
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_regs<NS>(sc);
      sm90::fence_regs<NS>(dp);

      const int k0 = it * BKQ;
      const bool edge = MASK || k0 + BKQ > rw.Lk ||
                        (a.causal && k0 + BKQ - 1 > r0 + rw.off);
      if (edge) {
#pragma unroll
        for (int x = 0; x < NS; ++x) sc[x] *= a.scale;
        flash_logits<NS, MASK>(sc, a, rw, [&](int x, int& i, int& j) {
          i = row[(x >> 1) & 1];
          j = k0 + sm90::acc_col(t, x);
        });
      }
      if (edge) {   // subtract first: exact for the mask's constants
#pragma unroll
        for (int x = 0; x < NS; ++x)
          sc[x] = exp2f((sc[x] - lr[(x >> 1) & 1]) * sm90::LOG2E);
      } else {
#pragma unroll
        for (int x = 0; x < NS; ++x)
          sc[x] = exp2f(fmaf(sc[x], sl2, -lb[(x >> 1) & 1]));
      }
#pragma unroll
      for (int x = 0; x < NS; ++x) {
        const int hi = (x >> 1) & 1;
        const float p = sc[x];
        float dpv = dp[x];
        if constexpr (DROP)
          dpv = drop_apply(dpv, rk[hi], rw.dj0 + k0 + sm90::acc_col(t, x),
                           a.dr.thresh, a.dr.rp);
        sc[x] = p * (dpv - gr[hi]);   // ds
      }
      uint32_t da[BKQ / 16][4];
#pragma unroll
      for (int j = 0; j < BKQ / 16; ++j) sm90::acc_to_a(da[j], sc, j);
      const uint64_t kdt = sm90::desc(Ks, BKQ * 128, 1024);   // MN-major
      sm90::wg_fence();
#pragma unroll
      for (int j = 0; j < BKQ / 16; ++j)
        sm90::wgmma_rs<D>(acc, da[j], sm90::desc_add(kdt, j * 16 * 64), 1);
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_regs<NO>(acc);
    }
    __syncwarp();   // every lane is done with the stage
    if ((t & 31) == 0) sm90::mbar_arrive(&empty[s]);
  }

  const size_t qs = static_cast<size_t>(a.H) * a.D;   // a.D <= D
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int qi = row[hi];
    if (qi >= rw.Lq) continue;
    bf16* orow = dq + (static_cast<size_t>(rw.qbase) + qi) * qs +
                 static_cast<size_t>(h) * a.D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store_pair<16>(orow, n * 8 + 2 * tq4, a.D, acc[4 * n + 2 * hi] * a.scale,
                     acc[4 * n + 2 * hi + 1] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// dK / dV
// ---------------------------------------------------------------------------
// One block per (key tile, batch * KV head); its consumer warpgroups split
// the work as dkv_by_keys says.
template <int D, bool DROP, bool MASK>
__global__ void __launch_bounds__(NTH, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const float* __restrict__ lse,
                              const float* __restrict__ dg,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              FlashArgs a) {
  constexpr int S = SK, NH = D / 64, NS = BQK / 2, NO = D / 2;
  constexpr bool BYKEYS = dkv_by_keys<D>();
  constexpr int BK = dkv_bk<D>();
  extern __shared__ unsigned char smem_raw[];
  bf16* K_s = reinterpret_cast<bf16*>(sm90::align1024(smem_raw));  // [NH][BK][64]
  bf16* V_s = K_s + BK * D;                                  // [NH][BK][64]
  bf16* Q_s = V_s + BK * D;                                  // [S][NH][BQK][64]
  bf16* dO_s = Q_s + S * BQK * D;                            // [S][NH][BQK][64]
  RowStage* R_s = reinterpret_cast<RowStage*>(dO_s + S * BQK * D);
  uint64_t* full = reinterpret_cast<uint64_t*>(R_s + S);
  uint64_t* empty = full + S;
  uint64_t* kvbar = empty + S;

  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y, b = bh / a.Hkv, hk = bh - b * a.Hkv;
  const int rep = a.H / a.Hkv;
  const FlashRows r0 = flash_rows(a, b, hk * rep);
  if (k0 >= r0.Lk) return;    // varlen: past this sequence
  const bool varlen = a.cu_q != nullptr;
  // query tiles from the diagonal on; with a mask and causality every tile,
  // those above it computed only where a row needs its hidden keys
  const int qt_lo = a.causal ? max(0, k0 - r0.off) / BQK : 0;
  const int n_qt = (r0.Lq + BQK - 1) / BQK;
  const int qt_first = MASK && a.causal ? 0 : qt_lo;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 32);   // the producer warp's lanes
      sm90::mbar_init(&empty[s], 8);   // one arrival a consumer warp
    }
    sm90::mbar_init(kvbar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = sm90::warpgroup();
  if (wg == 0) {   // producer warpgroup: its first warp
    sm90::reg_dealloc<40>();
    if (tid < 32) {
      const int lane = tid;
      const int kr = varlen ? r0.kbase + k0 : k0, bb = varlen ? 0 : b;
      if (lane == 0) {
        sm90::mbar_arrive_tx(kvbar, 2 * BK * D * 2);
        for (int hf = 0; hf < NH; ++hf) {
          sm90::tma_load(K_s + hf * BK * 64, &tk, kvbar, hf * 64, hk, kr, bb);
          sm90::tma_load(V_s + hf * BK * 64, &tv, kvbar, hf * 64, hk, kr, bb);
        }
      }
      int it = 0;
      for (int hh = 0; hh < rep; ++hh) {
        const int h = hk * rep + hh;
        const FlashRows rw = flash_rows(a, b, h);
        for (int qt = qt_first; qt < n_qt; ++qt, ++it) {
          const int s = it % S, q0 = qt * BQK;
          sm90::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          RowStage& rs = R_s[s];
          int hidden = 0;
#pragma unroll
          for (int u = 0; u < BQK / 32; ++u) {
            const int r = lane + 32 * u, qi = q0 + r;
            const bool ok = qi < rw.Lq;
            const float x = ok ? lse[rw.lse0 + qi] : INFINITY;  // p = 0
            rs.lse[r] = x;
            rs.dg[r] = ok ? dg[rw.lse0 + qi] : 0.f;
            if constexpr (DROP)
              rs.krow[r] = drop_row_key(drop_seed(a.dr), rw.dbh, rw.di0 + qi);
            hidden |= flash_needs_hidden(x);
          }
          const int need = qt >= qt_lo || __any_sync(0xffffffffu, hidden);
          if (lane == 0) {
            rs.need = need;
            if (need) {
              const int qr = varlen ? rw.qbase + q0 : q0;
              sm90::mbar_arrive_tx(&full[s], 2 * BQK * D * 2);
              for (int hf = 0; hf < NH; ++hf) {
                const int off = (s * NH + hf) * BQK * 64;
                sm90::tma_load(Q_s + off, &tq, &full[s], hf * 64, h, qr, bb);
                sm90::tma_load(dO_s + off, &tdo, &full[s], hf * 64, h, qr,
                               bb);
              }
            } else {
              sm90::mbar_arrive(&full[s]);
            }
          } else {
            sm90::mbar_arrive(&full[s]);   // after this lane's rows
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup wg - 1: by keys, keys [j0, j0 + 64) with dV in acc
  // and dK in acc2; by output, the block's keys with dV (warpgroup 0) or
  // dK (1) in acc
  sm90::reg_alloc<232>();
  const bool is_dk = wg == 2;
  const bool want_dp = BYKEYS || is_dk;   // dP^T, for ds
  const int t = tid % 128, tq4 = t & 3;
  const int j0 = k0 + (BYKEYS ? 64 * (wg - 1) : 0);
  const int key[2] = {j0 + sm90::acc_row(t, 0), j0 + sm90::acc_row(t, 2)};
  const float sl2 = a.scale * sm90::LOG2E;
  float acc[NO], acc2[BYKEYS ? NO : 1];
#pragma unroll
  for (int x = 0; x < NO; ++x) acc[x] = 0.f;
#pragma unroll
  for (int x = 0; x < (BYKEYS ? NO : 1); ++x) acc2[x] = 0.f;
  const bf16* Kw = K_s + (j0 - k0) * 64;
  const bf16* Vw = V_s + (j0 - k0) * 64;

  sm90::mbar_wait(kvbar, 0);
  int it = 0;
  for (int hh = 0; hh < rep; ++hh) {
    const FlashRows rw = flash_rows(a, b, hk * rep + hh);
    for (int qt = qt_first; qt < n_qt; ++qt, ++it) {
      const int s = it % S, q0 = qt * BQK;
      sm90::mbar_wait(&full[s], (it / S) & 1);
      const RowStage& rs = R_s[s];
      if (rs.need && j0 < rw.Lk) {
        const bf16* Qs = Q_s + s * BQK * D;
        const bf16* Os = dO_s + s * BQK * D;
        const uint64_t kd = sm90::opaque(sm90::desc(Kw, 16, 1024));
        const uint64_t qd = sm90::desc(Qs, 16, 1024);
        float st[NS], dpt[NS];
        sm90::wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int hf = kk / 4, c = (kk % 4) * 16;
          sm90::wgmma_ss<BQK>(st, sm90::desc_add(kd, hf * BK * 64 + c),
                              sm90::desc_add(qd, hf * BQK * 64 + c), kk > 0);
        }
        if (want_dp) {
          const uint64_t vd = sm90::opaque(sm90::desc(Vw, 16, 1024));
          const uint64_t od = sm90::desc(Os, 16, 1024);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const int hf = kk / 4, c = (kk % 4) * 16;
            sm90::wgmma_ss<BQK>(dpt, sm90::desc_add(vd, hf * BK * 64 + c),
                                sm90::desc_add(od, hf * BQK * 64 + c),
                                kk > 0);
          }
        }
        sm90::wg_commit();
        sm90::wg_wait<0>();
        sm90::fence_regs<NS>(st);
        if (want_dp) sm90::fence_regs<NS>(dpt);

        const bool edge = MASK || j0 + 64 > rw.Lk ||
                          (a.causal && j0 + 63 > q0 + rw.off);
        if (edge) {
#pragma unroll
          for (int x = 0; x < NS; ++x) st[x] *= a.scale;
          flash_logits<NS, MASK>(st, a, rw, [&](int x, int& i, int& j) {
            i = q0 + sm90::acc_col(t, x);
            j = key[(x >> 1) & 1];
          });
        }
        // p^T, column c's lse from the stage (subtract first on the tiles
        // the mask's constants reach)
        if (edge) {
#pragma unroll
          for (int x = 0; x < NS; ++x)
            st[x] = exp2f((st[x] - rs.lse[sm90::acc_col(t, x)]) *
                          sm90::LOG2E);
        } else {
#pragma unroll
          for (int x = 0; x < NS; ++x)
            st[x] = exp2f(fmaf(st[x], sl2,
                               -rs.lse[sm90::acc_col(t, x)] * sm90::LOG2E));
        }
        // ds^T = p (dp z / (1 - p) - dg) and (p z / (1 - p))^T, packed as
        // the A operands of dK += ds^T.Q and dV += p^T.dO
        auto pack_ds = [&](uint32_t (*f)[4]) {
#pragma unroll
          for (int x = 0; x < NS; ++x) {
            const int c = sm90::acc_col(t, x);
            float dpv = dpt[x];
            if constexpr (DROP)
              dpv = drop_apply(dpv, rs.krow[c], rw.dj0 + key[(x >> 1) & 1],
                               a.dr.thresh, a.dr.rp);
            dpt[x] = st[x] * (dpv - rs.dg[c]);
          }
#pragma unroll
          for (int j = 0; j < BQK / 16; ++j) sm90::acc_to_a(f[j], dpt, j);
        };
        auto pack_p = [&](uint32_t (*f)[4]) {
          if constexpr (DROP) {
#pragma unroll
            for (int x = 0; x < NS; ++x)
              st[x] = drop_apply(st[x], rs.krow[sm90::acc_col(t, x)],
                                 rw.dj0 + key[(x >> 1) & 1], a.dr.thresh,
                                 a.dr.rp);
          }
#pragma unroll
          for (int j = 0; j < BQK / 16; ++j) sm90::acc_to_a(f[j], st, j);
        };
        uint32_t fa[BQK / 16][4];
        if constexpr (BYKEYS) {
          uint32_t fb[BQK / 16][4];
          pack_ds(fb);   // before pack_p rescales p in place
          pack_p(fa);
          const uint64_t odt = sm90::desc(Os, BQK * 128, 1024);   // MN-major
          const uint64_t qdt = sm90::desc(Qs, BQK * 128, 1024);
          sm90::fence_regs<NO>(acc);
          sm90::fence_regs<NO>(acc2);
          sm90::wg_fence();
#pragma unroll
          for (int j = 0; j < BQK / 16; ++j) {
            sm90::wgmma_rs<D>(acc, fa[j], sm90::desc_add(odt, j * 16 * 64), 1);
            sm90::wgmma_rs<D>(acc2, fb[j], sm90::desc_add(qdt, j * 16 * 64),
                              1);
          }
        } else {
          if (is_dk)
            pack_ds(fa);
          else
            pack_p(fa);
          const uint64_t bd = sm90::desc(is_dk ? Qs : Os, BQK * 128, 1024);
          sm90::fence_regs<NO>(acc);
          sm90::wg_fence();
#pragma unroll
          for (int j = 0; j < BQK / 16; ++j)
            sm90::wgmma_rs<D>(acc, fa[j], sm90::desc_add(bd, j * 16 * 64), 1);
        }
        sm90::wg_commit();
        sm90::wg_wait<0>();
        sm90::fence_regs<NO>(acc);
        if constexpr (BYKEYS) sm90::fence_regs<NO>(acc2);
      }
      __syncwarp();   // every lane is done with the stage
      if ((t & 31) == 0) sm90::mbar_arrive(&empty[s]);
    }
  }

  const size_t ks = static_cast<size_t>(a.Hkv) * a.D;   // a.D <= D
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int kj = key[hi];
    if (kj >= r0.Lk) continue;
    const size_t o = (static_cast<size_t>(r0.kbase) + kj) * ks +
                     static_cast<size_t>(hk) * a.D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + 2 * tq4;
      const float x0 = acc[4 * n + 2 * hi], x1 = acc[4 * n + 2 * hi + 1];
      if constexpr (BYKEYS) {
        store_pair<16>(dv + o, col, a.D, x0, x1);
        store_pair<16>(dk + o, col, a.D, acc2[4 * n + 2 * hi] * a.scale,
                       acc2[4 * n + 2 * hi + 1] * a.scale);
      } else if (is_dk) {
        store_pair<16>(dk + o, col, a.D, x0 * a.scale, x1 * a.scale);
      } else {
        store_pair<16>(dv + o, col, a.D, x0, x1);
      }
    }
  }
}

struct Tensors {
  const float *lse, *dg;
  bf16 *dq, *dk, *dv;
};

template <typename Kern>
cudaError_t set_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// maps: q, dO (128-row boxes), k, v (64) for dQ; k, v (dkv_bk rows), q,
// dO (64) for dK/dV
template <int D, bool DROP, bool MASK>
int launch(const CUtensorMap* m, const Tensors& x, const FlashArgs& a,
           cudaStream_t st) {
  auto dq_kern = flash_bwd_dq_sm90_kernel<D, DROP, MASK>;
  auto dkv_kern = flash_bwd_dkv_sm90_kernel<D, DROP, MASK>;
  constexpr size_t dq_smem = dq_smem_bytes<D>(), dkv_smem = dkv_smem_bytes<D>();
  cudaError_t e = set_smem(dq_kern, dq_smem);
  if (e == cudaSuccess) e = set_smem(dkv_kern, dkv_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_kern<<<dim3((a.Sq + BQ - 1) / BQ, a.B * a.H), NTH, dq_smem, st>>>(
      m[0], m[1], m[2], m[3], x.lse, x.dg, x.dq, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int BK = dkv_bk<D>();
  dkv_kern<<<dim3((a.Sk + BK - 1) / BK, a.B * a.Hkv), NTH, dkv_smem, st>>>(
      m[6], m[7], m[4], m[5], x.lse, x.dg, x.dk, x.dv, a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch(const CUtensorMap* m, const Tensors& x, const FlashArgs& a,
             int dropout, cudaStream_t st) {
  const bool mk = a.mask != nullptr;
  if (dropout)
    return mk ? launch<D, true, true>(m, x, a, st)
              : launch<D, true, false>(m, x, a, st);
  return mk ? launch<D, false, true>(m, x, a, st)
            : launch<D, false, false>(m, x, a, st);
}

}  // namespace

PTT_EXPORT_ERROR_STRING

// The arguments of flash_attention_bwd.cu's flash_attention_bwd without
// dtype (bf16), chunk 16 (16-byte rows), plus geo: eight tensor maps'
// geometry (sm90::GEO values each, kernels/flash_attention.py
// `tma_geometry`): q, dout with 128-row boxes and k, v with 64-row boxes
// (the dQ kernel), then k, v with dkv_bk-row and q, dout with 64-row
// boxes (the dK/dV kernel). D is 64 or 128. Launches the dQ kernel, then the
// dK/dV kernel, on `stream`; returns the first CUDA error.
extern "C" int flash_attention_sm90_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dg, void* dq, void* dk, void* dv, int B,
    int H, int Hkv, int Sq, int Sk, int D, float scale, int causal,
    int dropout, uint32_t seed, const void* seed_ptr, uint32_t thresh,
    float rp, const void* mask,
    long long m_sb, long long m_sh, long long m_sq, long long m_sk,
    const void* cu_q, const void* cu_k, int Tq, int chunk,
    const long long* geo, void* stream) {
  if (B == 0 || Sq == 0 || Sk == 0) return 0;
  const int DP = sm90::flash_class(D);   // 64 or 128: D 49..64, 97..128
  if ((DP != 64 && DP != 128) || chunk != 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[8];
  const void* bases[8] = {q, dout, k, v, k, v, q, dout};
  for (int i = 0; i < 8; ++i) {
    const int e = sm90::encode_map(&maps[i], bases[i], geo + i * sm90::GEO);
    if (e) return e;
  }
  const FlashArgs a{B, H, Hkv, Sq, Sk, D, scale, causal,
                    Drop{seed, thresh, rp,
                         static_cast<const long long*>(seed_ptr)},
                    static_cast<const uint8_t*>(mask), m_sb, m_sh, m_sq, m_sk,
                    static_cast<const int*>(cu_q),
                    static_cast<const int*>(cu_k), Tq, 16};
  const Tensors x{static_cast<const float*>(lse),
                  static_cast<const float*>(dg), static_cast<bf16*>(dq),
                  static_cast<bf16*>(dk), static_cast<bf16*>(dv)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return DP == 64 ? dispatch<64>(maps, x, a, dropout, st)
                  : dispatch<128>(maps, x, a, dropout, st);
}

// the dynamic shared memory a dQ (dkv 0) or dK/dV (1) block of head_dim D
// takes (chip_smoke.py prints it), 0 for another D
extern "C" int flash_attention_sm90_bwd_smem(int D, int dkv) {
  if (D == 64)
    return static_cast<int>(dkv ? dkv_smem_bytes<64>() : dq_smem_bytes<64>());
  if (D == 128)
    return static_cast<int>(dkv ? dkv_smem_bytes<128>()
                                : dq_smem_bytes<128>());
  return 0;
}
