// Flash attention backward for Hopper: dQ, dK, dV in bf16 at every head
// width the forward's template takes (flash_attention_sm90.cuh: 16-byte
// head rows, or 8-byte ones inside 16-byte token rows through the
// flattened maps), the classes 64 and 128 keeping their own kernels
// (flash_attention_bwd_sm90.cu); f32 and narrower bf16 rows keep
// flash_attention_bwd.cu. The kernel templates are instantiated per
// head-width class by flash_attention_bwd_sm90_narrow.cu (16, 32, 48),
// flash_attention_bwd_sm90_wide.cu (96, 160) and
// flash_attention_bwd_sm90_wider.cu (192, 224, 256), one nvcc each.
//
// Replaces paddle_tpu/kernels/flash_attention.py `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` (pallas_calls in `_flash_core_bwd`) for those inputs,
// with every option of flash_attention_bwd.cu and the same function (its
// source note states the recomputation, the dropout rule and the hidden
// rows), differing only in summation order.
//
// Bound on the H100: the flops of five products of the forward's size (S
// and dP recomputed, then dQ, dK, dV), about half of it causal, against
// 989 TFLOP/s bf16; at small D the exponentials (one a score, as in the
// forward). flash_attention_bwd.cu runs mma.sync on tiles that threads
// load and transpose into shared memory (Q, K, dO each stored twice), with
// 32-query tiles in the dK/dV kernel for its registers. This design keeps
// FlashAttention-2's two kernels, each now on wgmma fed by TMA, in the
// forward's pipeline (one producer warp, a ring of stages with full and
// empty mbarriers, two consumer warpgroups, setmaxnreg):
// - dQ: a block takes (128-query tile, batch * head) tiles; Q and dO load
//   once a tile, key tiles (K and V) stream: 64 keys, 32 up to class 48
//   (two blocks an SM, consumers in 104 registers) and from class 192 on,
//   so that dQ's accumulator (DP / 2 registers a thread, 128 at 256) and
//   the score and dP tiles fit without spills. S = Q.K^T and dP = dO.V^T
//   (wgmma, both operands K-major in shared memory), ds = p * (dp - dg) in
//   registers, dQ += ds.K with ds as the register A operand and K read
//   MN-major (the transpose bit), so nothing is transposed by a thread.
// - dK/dV: a block takes (key tile, batch * KV head) tiles; K and V load
//   once a tile, then for each query head of the KV group the query tiles
//   from the diagonal on stream: Q, dO, and the rows' lse, dg and dropout
//   keys, which the producer warp stages beside them. S^T = K.Q^T and
//   dP^T = V.dO^T, then dV += (p z / (1 - p))^T.dO and dK += ds^T.Q with
//   the transposed probabilities and ds as register A operands, Q and dO
//   read MN-major; dK and dV stay in f32 registers and are stored once.
//   The consumer warpgroups split a block by keys up to class 96 and by
//   output above it (dkv_by_keys: the key split holds both accumulators and
//   spilled at 128; at 96 it measured faster than the output split);
//   query tiles of 64 rows, 32 from class 192 on (the accumulator is 128
//   registers a thread at 256). The keep bits of a tile are hashed once
//   for p and ds.
// - As in the forward, the launches hold as many blocks as are resident,
//   each looping over tiles, with two buffers of what a tile keeps (dQ: Q
//   and dO, where they fit; dK/dV: K and V), so a block's next tile loads
//   under its current one.
// Seven products (eight a tile with the output split) where
// FlashAttention-3's single pass does five: it adds dQ's partial sums
// across key blocks with atomics. The two kernels were kept because they
// add no atomics, so two runs still give the same bits, and both reuse the
// forward's pipeline and fragments.
// The mask, causality and the ragged ends are applied only on the tiles
// that need them, as in the forward. A row whose every visible key is
// masked (lse <= -1e30, flash_needs_hidden) takes p = 1 on the causally
// hidden keys: with a mask and causality the dQ warpgroup holding such a
// row walks past its diagonal, and the dK/dV producer loads a query tile
// above the diagonal only when lse says one of its rows needs it (a flag
// beside the stage tells the consumers). Rows past a sequence's end are
// loaded but never stored; dQ, dK and dV are stored per row, predicated.
// Flattened maps (8-byte head rows, a.chunk 8, H == Hkv): as in the
// forward, a head sits at tile columns [sh, sh + D) (flat_shift), and every
// tile a product reads at depth D has its other columns zeroed by each
// consumer warpgroup before the product: Q and dO once and K and V as they
// stream in the dQ kernel, K and V once and Q and dO as they stream in the
// dK/dV kernel. Those columns reach only output columns outside
// [sh, sh + D) otherwise, which are never stored.
#pragma once

#include "flash_sm90.cuh"

namespace sm90bwd {

using bf16 = __nv_bfloat16;
constexpr int NTH = 384;
constexpr int S = 2;     // stages of the dQ ring
constexpr int BQ = 128;  // dQ kernel: query tile
constexpr size_t SMEM_MAX = 232448;   // 227 KB a block

// Thread blocks of the dQ kernel resident on an SM: 2 for the classes up to
// 48 (consumers in 104 registers, 32-key tiles), else 1.
template <int DP>
__host__ __device__ constexpr int dq_ctas() {
  return DP <= 48 ? 2 : 1;
}

template <int DP>
__host__ __device__ constexpr int dq_bk() {   // the dQ kernel's key tile
  return DP <= 48 || DP >= 192 ? 32 : 64;
}

// How the dK/dV kernel's two consumer warpgroups share a block. Up to
// class 96 by keys: 128 keys a block, each warpgroup 64 of them with both dK
// and dV (2 x DP / 2 f32 accumulators a thread). Above, by output: 64 keys a
// block, both warpgroups on all of them, warpgroup 0 accumulating dV, 1 dK
// (DP / 2 accumulators each): a split by keys would hold both beside the
// score tiles and spilled at 128. The output split recomputes S^T in both
// warpgroups, five products a tile where the key split runs four.
template <int DP>
__host__ __device__ constexpr bool dkv_by_keys() {
  return DP <= 96;
}

template <int DP>
__host__ __device__ constexpr int dkv_bk() {   // the dK/dV key tile
  return dkv_by_keys<DP>() ? 128 : 64;
}

template <int DP>
__host__ __device__ constexpr int dkv_bq() {   // the dK/dV query tile
  return DP >= 192 ? 32 : 64;
}

template <int DP>
__host__ __device__ constexpr size_t dq_bytes(int qbufs) {
  return 1024 + 2 * (2 * qbufs * BQ * DP + 2 * S * dq_bk<DP>() * DP) + 8 * 16;
}

// Q and dO buffers of the dQ kernel: 2 where they fit, so a block's next
// tile loads under its current one
template <int DP>
__host__ __device__ constexpr int dq_qbufs() {
  return dq_bytes<DP>(2) * dq_ctas<DP>() <= SMEM_MAX ? 2 : 1;
}

template <int DP>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  return dq_bytes<DP>(dq_qbufs<DP>());
}

// per stage of the dK/dV ring, beside the Q and dO tiles: the rows' lse,
// dg and dropout keys, and whether the tile is computed at all
template <int BQK>
struct alignas(16) RowStage {
  float lse[BQK];
  float dg[BQK];
  uint32_t krow[BQK];
  int need;
};

template <int DP>
__host__ __device__ constexpr size_t dkv_bytes(int stages, int kvbufs) {
  return 1024 +
         2 * (2 * static_cast<size_t>(kvbufs) * dkv_bk<DP>() * DP +
              2 * static_cast<size_t>(stages) * dkv_bq<DP>() * DP) +
         stages * sizeof(RowStage<dkv_bq<DP>()>) + 8 * 16;
}

// K and V buffers of the dK/dV kernel: 2, so a block's next tile loads
// under its current one
template <int DP>
__host__ __device__ constexpr int dkv_kvbufs() {
  return 2;
}

template <int DP>
__host__ __device__ constexpr int dkv_stages() {   // 3, or 2 where 3 do not fit
  return dkv_bytes<DP>(3, dkv_kvbufs<DP>()) <= SMEM_MAX ? 3 : 2;
}

template <int DP>
__host__ __device__ constexpr size_t dkv_smem_bytes() {
  return dkv_bytes<DP>(dkv_stages<DP>(), dkv_kvbufs<DP>());
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------
template <int DP, bool DROP, bool MASK>
__global__ void __launch_bounds__(NTH, dq_ctas<DP>())
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tdo,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const float* __restrict__ lse,
                             const float* __restrict__ dg,
                             bf16* __restrict__ dq, FlashArgs a) {
  constexpr int W = sm90::block_cols(DP), NB = DP / W, BKQ = dq_bk<DP>();
  constexpr int NS = BKQ / 2, NO = DP / 2, QB = dq_qbufs<DP>();
  extern __shared__ unsigned char smem_raw[];
  bf16* Q_s = reinterpret_cast<bf16*>(sm90::align1024(smem_raw));  // [QB][NB][BQ][W]
  bf16* dO_s = Q_s + QB * BQ * DP;                           // [QB][NB][BQ][W]
  bf16* K_s = dO_s + QB * BQ * DP;                           // [S][NB][BKQ][W]
  bf16* V_s = K_s + S * BKQ * DP;                            // [S][NB][BKQ][W]
  uint64_t* full = reinterpret_cast<uint64_t*>(V_s + S * BKQ * DP);
  uint64_t* empty = full + S;
  uint64_t* qbar = empty + S;    // [QB] Q and dO have landed
  uint64_t* qfree = qbar + QB;   // [QB] the consumers are done with them

  const bool varlen = a.cu_q != nullptr;
  // 8-byte head rows: the flattened maps
  const bool flat = sm90::flat_class(DP) && a.chunk == 8;
  // the tiles this block takes: blockIdx.x on, gridDim.x apart
  const int nqt = (a.Sq + BQ - 1) / BQ, n_tiles = nqt * a.B * a.H;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);
    }
    for (int q = 0; q < QB; ++q) {
      sm90::mbar_init(&qbar[q], 1);
      sm90::mbar_init(&qfree[q], 8);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // tile -> (q0, b, h): the query tile fastest, heaviest first under
  // causality
  auto decode = [&](int tile, int& q0, int& b, int& h) {
    const int bh = tile / nqt, qt = tile - bh * nqt;
    b = bh / a.H;
    h = bh - b * a.H;
    q0 = (a.causal ? nqt - 1 - qt : qt) * BQ;
  };

  const int wg = sm90::warpgroup();
  if (wg == 0) {   // producer warpgroup
    sm90::reg_dealloc<24>();
    if (tid == 0) {
      int it = 0, nt = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        int q0, b, h;
        decode(tile, q0, b, h);
        const FlashRows rw = flash_rows(a, b, h);
        if (q0 >= rw.Lq) continue;    // varlen: past this sequence
        const int n_kt = (rw.Lk + BKQ - 1) / BKQ;
        int n_vis = n_kt;
        if (a.causal)
          n_vis = min(n_kt, (min(q0 + BQ - 1, rw.Lq - 1) + rw.off) / BKQ + 1);
        const int n_load = MASK && a.causal ? n_kt : n_vis;
        const int hk = h / (a.H / a.Hkv);
        const int qr = varlen ? rw.qbase + q0 : q0;
        const int kr = varlen ? rw.kbase : 0, bb = varlen ? 0 : b;
        const int qc = flat ? h * a.D - sm90::flat_shift(flat, h, a.D) : 0;
        const int kc = flat ? hk * a.D - sm90::flat_shift(flat, hk, a.D) : 0;
        const int qh = flat ? 0 : h, kh = flat ? 0 : hk;
        const int qb = nt % QB;
        sm90::mbar_wait(&qfree[qb], ((nt / QB) & 1) ^ 1);
        sm90::mbar_arrive_tx(&qbar[qb], 2 * BQ * DP * 2);
        for (int j = 0; j < NB; ++j) {
          const int off = (qb * NB + j) * BQ * W;
          sm90::tma_load(Q_s + off, &tq, &qbar[qb], qc + j * W, qh, qr, bb);
          sm90::tma_load(dO_s + off, &tdo, &qbar[qb], qc + j * W, qh, qr,
                         bb);
        }
        ++nt;
        for (int i = 0; i < n_load; ++i, ++it) {
          const int s = it % S;
          sm90::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          sm90::mbar_arrive_tx(&full[s], 2 * BKQ * DP * 2);
          for (int j = 0; j < NB; ++j) {
            const int off = (s * NB + j) * BKQ * W;
            sm90::tma_load(K_s + off, &tk, &full[s], kc + j * W, kh,
                           kr + i * BKQ, bb);
            sm90::tma_load(V_s + off, &tv, &full[s], kc + j * W, kh,
                           kr + i * BKQ, bb);
          }
        }
      }
    }
    return;
  }

  sm90::reg_alloc<dq_ctas<DP>() == 2 ? 104 : 240>();
  const int w = wg - 1, t = tid % 128, tq4 = t & 3;
  const float sl2 = a.scale * sm90::LOG2E;
  int it = 0, nt = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int q0, b, h;
    decode(tile, q0, b, h);
    const FlashRows rw = flash_rows(a, b, h);
    if (q0 >= rw.Lq) continue;    // varlen: past this sequence
    const int n_kt = (rw.Lk + BKQ - 1) / BKQ;
    int n_vis = n_kt;
    if (a.causal)
      n_vis = min(n_kt, (min(q0 + BQ - 1, rw.Lq - 1) + rw.off) / BKQ + 1);
    const int n_load = MASK && a.causal ? n_kt : n_vis;
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
    float acc[NO];
#pragma unroll
    for (int x = 0; x < NO; ++x) acc[x] = 0.f;

    // the head's columns in the tiles: [sh, sh + D) (flat: H == Hkv)
    const int sh = sm90::flat_shift(flat, h, a.D);
    const int qb = nt % QB;
    sm90::mbar_wait(&qbar[qb], (nt / QB) & 1);
    bf16* Qw = Q_s + qb * BQ * DP + 64 * w * W;
    bf16* Ow = dO_s + qb * BQ * DP + 64 * w * W;
    if (flat) {   // this warpgroup's Q and dO rows: the neighbours' columns
      sm90::zero_pad<W, DP>(Qw, BQ, 64, sh, sh + a.D, t, 128);
      sm90::zero_pad<W, DP>(Ow, BQ, 64, sh, sh + a.D, t, 128);
      sm90::fence_proxy_async();
      sm90::bar_sync(1 + w, 128);
    }
    for (int i = 0; i < n_load; ++i, ++it) {
      const int s = it % S;
      sm90::mbar_wait(&full[s], (it / S) & 1);
      if (i < n_own || walk) {
        bf16* Ks = K_s + s * BKQ * DP;
        bf16* Vs = V_s + s * BKQ * DP;
        if (flat) {   // both warpgroups write the same zeros
          sm90::zero_pad<W, DP>(Ks, BKQ, BKQ, sh, sh + a.D, t, 128);
          sm90::zero_pad<W, DP>(Vs, BKQ, BKQ, sh, sh + a.D, t, 128);
          sm90::fence_proxy_async();
          sm90::bar_sync(1 + w, 128);
        }
        const uint64_t qd = sm90::opaque(sm90::desc<W>(Qw, 16));
        const uint64_t od = sm90::opaque(sm90::desc<W>(Ow, 16));
        const uint64_t kd = sm90::desc<W>(Ks, 16);
        const uint64_t vd = sm90::desc<W>(Vs, 16);
        float sc[NS], dp[NS];
        sm90::wg_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          sm90::wgmma_ss<BKQ>(sc, sm90::desc_add(qd, sm90::kstep<W>(kk, BQ)),
                              sm90::desc_add(kd, sm90::kstep<W>(kk, BKQ)),
                              kk > 0);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          sm90::wgmma_ss<BKQ>(dp, sm90::desc_add(od, sm90::kstep<W>(kk, BQ)),
                              sm90::desc_add(vd, sm90::kstep<W>(kk, BKQ)),
                              kk > 0);
        sm90::wg_commit();
        sm90::wg_wait<0>();
        sm90::fence_regs<NS>(sc);
        sm90::fence_regs<NS>(dp);

        const int k0 = i * BKQ;
        const bool edge = MASK || k0 + BKQ > rw.Lk ||
                          (a.causal && k0 + BKQ - 1 > r0 + rw.off);
        if (edge) {
#pragma unroll
          for (int x = 0; x < NS; ++x) sc[x] *= a.scale;
          flash_logits<NS, MASK>(sc, a, rw, [&](int x, int& ii, int& jj) {
            ii = row[(x >> 1) & 1];
            jj = k0 + sm90::acc_col(t, x);
          });
        }
        if (edge) {   // subtract first: exact for the mask's constants
#pragma unroll
          for (int x = 0; x < NS; ++x)
            sc[x] = sm90::ex2((sc[x] - lr[(x >> 1) & 1]) * sm90::LOG2E);
        } else {
#pragma unroll
          for (int x = 0; x < NS; ++x)
            sc[x] = sm90::ex2(fmaf(sc[x], sl2, -lb[(x >> 1) & 1]));
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
        const uint64_t kdt = sm90::desc<W>(Ks, BKQ * W * 2);   // MN-major
        sm90::wg_fence();
#pragma unroll
        for (int j = 0; j < BKQ / 16; ++j)
          sm90::wgmma_rs<DP>(acc, da[j], sm90::desc_add(kdt, j * 16 * W), 1);
        sm90::wg_commit();
        sm90::wg_wait<0>();
        sm90::fence_regs<NO>(acc);
      }
      __syncwarp();   // every lane is done with the stage
      if ((t & 31) == 0) sm90::mbar_arrive(&empty[s]);
    }
    // Q and dO are read no more: the producer may load the next tile's
    __syncwarp();
    if ((t & 31) == 0) sm90::mbar_arrive(&qfree[qb]);
    ++nt;

    const size_t qs = static_cast<size_t>(a.H) * a.D;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int qi = row[hi];
      if (qi >= rw.Lq) continue;
      bf16* orow = dq + (static_cast<size_t>(rw.qbase) + qi) * qs +
                   static_cast<size_t>(h) * a.D;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int col = n * 8 + 2 * tq4 - sh;
        if (col >= 0)
          store_pair<16>(orow, col, a.D, acc[4 * n + 2 * hi] * a.scale,
                         acc[4 * n + 2 * hi + 1] * a.scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dK / dV
// ---------------------------------------------------------------------------
// A block loops over (key tile, batch * KV head) tiles; its consumer
// warpgroups split the work as dkv_by_keys says.
template <int DP, bool DROP, bool MASK>
__global__ void __launch_bounds__(NTH, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const float* __restrict__ lse,
                              const float* __restrict__ dg,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              FlashArgs a) {
  constexpr int SK = dkv_stages<DP>(), W = sm90::block_cols(DP), NB = DP / W;
  constexpr int BQK = dkv_bq<DP>(), NS = BQK / 2, NO = DP / 2;
  static_assert(NS <= 32, "a keep bit an accumulator in one word");
  constexpr bool BYKEYS = dkv_by_keys<DP>();
  constexpr int BK = dkv_bk<DP>(), KB = dkv_kvbufs<DP>();
  using Rows = RowStage<BQK>;
  extern __shared__ unsigned char smem_raw[];
  bf16* K_s = reinterpret_cast<bf16*>(sm90::align1024(smem_raw));  // [KB][NB][BK][W]
  bf16* V_s = K_s + KB * BK * DP;                            // [KB][NB][BK][W]
  bf16* Q_s = V_s + KB * BK * DP;                            // [SK][NB][BQK][W]
  bf16* dO_s = Q_s + SK * BQK * DP;                          // [SK][NB][BQK][W]
  Rows* R_s = reinterpret_cast<Rows*>(dO_s + SK * BQK * DP);
  uint64_t* full = reinterpret_cast<uint64_t*>(R_s + SK);
  uint64_t* empty = full + SK;
  uint64_t* kvbar = empty + SK;   // [KB] K and V have landed
  uint64_t* kvfree = kvbar + KB;  // [KB] the consumers are done with them

  const int rep = a.H / a.Hkv;
  const bool varlen = a.cu_q != nullptr;
  // 8-byte head rows: the flattened maps
  const bool flat = sm90::flat_class(DP) && a.chunk == 8;
  const int nkt = (a.Sk + BK - 1) / BK, n_tiles = nkt * a.B * a.Hkv;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < SK; ++s) {
      sm90::mbar_init(&full[s], 32);   // the producer warp's lanes
      sm90::mbar_init(&empty[s], 8);   // one arrival a consumer warp
    }
    for (int q = 0; q < KB; ++q) {
      sm90::mbar_init(&kvbar[q], 1);
      sm90::mbar_init(&kvfree[q], 8);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // tile -> (k0, b, hk): the key tile fastest
  auto decode = [&](int tile, int& k0, int& b, int& hk) {
    const int bh = tile / nkt;
    k0 = (tile - bh * nkt) * BK;
    b = bh / a.Hkv;
    hk = bh - b * a.Hkv;
  };

  const int wg = sm90::warpgroup();
  if (wg == 0) {   // producer warpgroup: its first warp
    sm90::reg_dealloc<40>();
    if (tid < 32) {
      const int lane = tid;
      int it = 0, nt = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        int k0, b, hk;
        decode(tile, k0, b, hk);
        const FlashRows r0 = flash_rows(a, b, hk * rep);
        if (k0 >= r0.Lk) continue;    // varlen: past this sequence
        // query tiles from the diagonal on; with a mask and causality
        // every tile, those above it computed only where a row needs its
        // hidden keys
        const int qt_lo = a.causal ? max(0, k0 - r0.off) / BQK : 0;
        const int n_qt = (r0.Lq + BQK - 1) / BQK;
        const int qt_first = MASK && a.causal ? 0 : qt_lo;
        const int kr = varlen ? r0.kbase + k0 : k0, bb = varlen ? 0 : b;
        const int kc = flat ? hk * a.D - sm90::flat_shift(flat, hk, a.D) : 0;
        const int kh = flat ? 0 : hk;
        if (lane == 0) {
          const int kb = nt % KB;
          sm90::mbar_wait(&kvfree[kb], ((nt / KB) & 1) ^ 1);
          sm90::mbar_arrive_tx(&kvbar[kb], 2 * BK * DP * 2);
          for (int j = 0; j < NB; ++j) {
            const int off = (kb * NB + j) * BK * W;
            sm90::tma_load(K_s + off, &tk, &kvbar[kb], kc + j * W, kh, kr,
                           bb);
            sm90::tma_load(V_s + off, &tv, &kvbar[kb], kc + j * W, kh, kr,
                           bb);
          }
        }
        ++nt;
        for (int hh = 0; hh < rep; ++hh) {
          const int h = hk * rep + hh;
          const int qc = flat ? h * a.D - sm90::flat_shift(flat, h, a.D) : 0;
          const int qh = flat ? 0 : h;
          const FlashRows rw = flash_rows(a, b, h);
          for (int qt = qt_first; qt < n_qt; ++qt, ++it) {
            const int s = it % SK, q0 = qt * BQK;
            sm90::mbar_wait(&empty[s], ((it / SK) & 1) ^ 1);
            Rows& rs = R_s[s];
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
                sm90::mbar_arrive_tx(&full[s], 2 * BQK * DP * 2);
                for (int j = 0; j < NB; ++j) {
                  const int off = (s * NB + j) * BQK * W;
                  sm90::tma_load(Q_s + off, &tq, &full[s], qc + j * W, qh,
                                 qr, bb);
                  sm90::tma_load(dO_s + off, &tdo, &full[s], qc + j * W, qh,
                                 qr, bb);
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
    }
    return;
  }

  // consumer warpgroup wg - 1: by keys, keys [j0, j0 + 64) with dV in acc
  // and dK in acc2; by output, the block's keys with dV (warpgroup 0) or
  // dK (1) in acc
  sm90::reg_alloc<232>();
  const int w = wg - 1;
  const bool is_dk = wg == 2;
  const bool want_dp = BYKEYS || is_dk;   // dP^T, for ds
  const int t = tid % 128, tq4 = t & 3;
  const float sl2 = a.scale * sm90::LOG2E;
  int it = 0, nt = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int k0, b, hk;
    decode(tile, k0, b, hk);
    const FlashRows r0 = flash_rows(a, b, hk * rep);
    if (k0 >= r0.Lk) continue;    // varlen: past this sequence
    const int qt_lo = a.causal ? max(0, k0 - r0.off) / BQK : 0;
    const int n_qt = (r0.Lq + BQK - 1) / BQK;
    const int qt_first = MASK && a.causal ? 0 : qt_lo;
    const int j0 = k0 + (BYKEYS ? 64 * w : 0);
    const int key[2] = {j0 + sm90::acc_row(t, 0), j0 + sm90::acc_row(t, 2)};
    float acc[NO], acc2[BYKEYS ? NO : 1];
#pragma unroll
    for (int x = 0; x < NO; ++x) acc[x] = 0.f;
#pragma unroll
    for (int x = 0; x < (BYKEYS ? NO : 1); ++x) acc2[x] = 0.f;
    const int kb = nt % KB;
    bf16* Kb = K_s + kb * BK * DP;
    bf16* Vb = V_s + kb * BK * DP;
    const bf16* Kw = Kb + (j0 - k0) * W;
    const bf16* Vw = Vb + (j0 - k0) * W;

    // the head's columns in the tiles: [sh, sh + D) (flat: H == Hkv, the
    // query heads of the group are the one KV head)
    const int sh = sm90::flat_shift(flat, hk, a.D);
    sm90::mbar_wait(&kvbar[kb], (nt / KB) & 1);
    if (flat) {   // K and V: the neighbours' columns (both warpgroups)
      sm90::zero_pad<W, DP>(Kb, BK, BK, sh, sh + a.D, t, 128);
      sm90::zero_pad<W, DP>(Vb, BK, BK, sh, sh + a.D, t, 128);
      sm90::fence_proxy_async();
      sm90::bar_sync(1 + w, 128);
    }
    for (int hh = 0; hh < rep; ++hh) {
      const FlashRows rw = flash_rows(a, b, hk * rep + hh);
      for (int qt = qt_first; qt < n_qt; ++qt, ++it) {
        const int s = it % SK, q0 = qt * BQK;
        sm90::mbar_wait(&full[s], (it / SK) & 1);
        const Rows& rs = R_s[s];
        if (rs.need && j0 < rw.Lk) {
          bf16* Qs = Q_s + s * BQK * DP;
          bf16* Os = dO_s + s * BQK * DP;
          if (flat) {   // both warpgroups write the same zeros
            sm90::zero_pad<W, DP>(Qs, BQK, BQK, sh, sh + a.D, t, 128);
            sm90::zero_pad<W, DP>(Os, BQK, BQK, sh, sh + a.D, t, 128);
            sm90::fence_proxy_async();
            sm90::bar_sync(1 + w, 128);
          }
          const uint64_t kd = sm90::opaque(sm90::desc<W>(Kw, 16));
          const uint64_t qd = sm90::desc<W>(Qs, 16);
          float st[NS], dpt[NS];
          sm90::wg_fence();
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk)
            sm90::wgmma_ss<BQK>(st,
                                sm90::desc_add(kd, sm90::kstep<W>(kk, BK)),
                                sm90::desc_add(qd, sm90::kstep<W>(kk, BQK)),
                                kk > 0);
          if (want_dp) {
            const uint64_t vd = sm90::opaque(sm90::desc<W>(Vw, 16));
            const uint64_t od = sm90::desc<W>(Os, 16);
#pragma unroll
            for (int kk = 0; kk < DP / 16; ++kk)
              sm90::wgmma_ss<BQK>(dpt,
                                  sm90::desc_add(vd, sm90::kstep<W>(kk, BK)),
                                  sm90::desc_add(od, sm90::kstep<W>(kk, BQK)),
                                  kk > 0);
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
            flash_logits<NS, MASK>(st, a, rw, [&](int x, int& ii, int& jj) {
              ii = q0 + sm90::acc_col(t, x);
              jj = key[(x >> 1) & 1];
            });
          }
          // p^T, column c's lse from the stage (subtract first on the tiles
          // the mask's constants reach)
          if (edge) {
#pragma unroll
            for (int x = 0; x < NS; ++x)
              st[x] = sm90::ex2((st[x] - rs.lse[sm90::acc_col(t, x)]) *
                            sm90::LOG2E);
          } else {
#pragma unroll
            for (int x = 0; x < NS; ++x)
              st[x] = sm90::ex2(fmaf(st[x], sl2,
                                 -rs.lse[sm90::acc_col(t, x)] * sm90::LOG2E));
          }
          // the keep bits of the tile's scores, bit x for accumulator x
          // (NS <= 32), hashed once for ds and p alike
          uint32_t keep = 0;
          if constexpr (DROP) {
#pragma unroll
            for (int x = 0; x < NS; ++x)
              keep |= static_cast<uint32_t>(drop_keep(
                          rs.krow[sm90::acc_col(t, x)],
                          rw.dj0 + key[(x >> 1) & 1], a.dr.thresh))
                      << x;
          }
          auto dropped = [&](float v, int x) {   // v z / (1 - p)
            return DROP ? ((keep >> x) & 1u ? v * a.dr.rp : 0.f) : v;
          };
          // ds^T = p (dp z / (1 - p) - dg) and (p z / (1 - p))^T, packed
          // as the A operands of dK += ds^T.Q and dV += p^T.dO
          auto pack_ds = [&](uint32_t (*f)[4]) {
#pragma unroll
            for (int x = 0; x < NS; ++x)
              dpt[x] = st[x] * (dropped(dpt[x], x) -
                                rs.dg[sm90::acc_col(t, x)]);
#pragma unroll
            for (int j = 0; j < BQK / 16; ++j) sm90::acc_to_a(f[j], dpt, j);
          };
          auto pack_p = [&](uint32_t (*f)[4]) {
#pragma unroll
            for (int x = 0; x < NS; ++x) st[x] = dropped(st[x], x);
#pragma unroll
            for (int j = 0; j < BQK / 16; ++j) sm90::acc_to_a(f[j], st, j);
          };
          uint32_t fa[BQK / 16][4];
          if constexpr (BYKEYS) {
            uint32_t fb[BQK / 16][4];
            pack_ds(fb);   // before pack_p rescales p in place
            pack_p(fa);
            const uint64_t odt = sm90::desc<W>(Os, BQK * W * 2);  // MN-major
            const uint64_t qdt = sm90::desc<W>(Qs, BQK * W * 2);
            sm90::fence_regs<NO>(acc);
            sm90::fence_regs<NO>(acc2);
            sm90::wg_fence();
#pragma unroll
            for (int j = 0; j < BQK / 16; ++j) {
              sm90::wgmma_rs<DP>(acc, fa[j],
                                 sm90::desc_add(odt, j * 16 * W), 1);
              sm90::wgmma_rs<DP>(acc2, fb[j],
                                 sm90::desc_add(qdt, j * 16 * W), 1);
            }
          } else {
            if (is_dk)
              pack_ds(fa);
            else
              pack_p(fa);
            const uint64_t bd = sm90::desc<W>(is_dk ? Qs : Os, BQK * W * 2);
            sm90::fence_regs<NO>(acc);
            sm90::wg_fence();
#pragma unroll
            for (int j = 0; j < BQK / 16; ++j)
              sm90::wgmma_rs<DP>(acc, fa[j], sm90::desc_add(bd, j * 16 * W),
                                 1);
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
    // K and V are read no more: the producer may load the next tile's
    __syncwarp();
    if ((t & 31) == 0) sm90::mbar_arrive(&kvfree[kb]);
    ++nt;

    const size_t ks = static_cast<size_t>(a.Hkv) * a.D;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int kj = key[hi];
      if (kj >= r0.Lk) continue;
      const size_t o = (static_cast<size_t>(r0.kbase) + kj) * ks +
                       static_cast<size_t>(hk) * a.D;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int col = n * 8 + 2 * tq4 - sh;
        if (col < 0) continue;
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

// maps: q, dO (BQ-row boxes), k, v (dq_bk) for dQ; k, v (dkv_bk rows), q,
// dO (dkv_bq) for dK/dV
template <int DP, bool DROP, bool MASK>
int launch(const CUtensorMap* m, const Tensors& x, const FlashArgs& a,
           cudaStream_t st) {
  auto dq_kern = flash_bwd_dq_sm90_kernel<DP, DROP, MASK>;
  auto dkv_kern = flash_bwd_dkv_sm90_kernel<DP, DROP, MASK>;
  constexpr size_t dq_smem = dq_smem_bytes<DP>();
  constexpr size_t dkv_smem = dkv_smem_bytes<DP>();
  static_assert(dq_smem * dq_ctas<DP>() <= SMEM_MAX &&
                    dkv_smem <= SMEM_MAX,
                "shared memory of a class");
  cudaError_t e = set_smem(dq_kern, dq_smem);
  if (e == cudaSuccess) e = set_smem(dkv_kern, dkv_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int q_tiles = (a.Sq + BQ - 1) / BQ * a.B * a.H;
  const int k_tiles = (a.Sk + dkv_bk<DP>() - 1) / dkv_bk<DP>() * a.B * a.Hkv;
  const int slots = sm90::sm_count();
  const int dq_grid = min(q_tiles, dq_ctas<DP>() * slots);
  const int dkv_grid = min(k_tiles, slots);
  dq_kern<<<dq_grid, NTH, dq_smem, st>>>(m[0], m[1], m[2], m[3], x.lse, x.dg,
                                         x.dq, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dkv_kern<<<dkv_grid, NTH, dkv_smem, st>>>(m[6], m[7], m[4], m[5], x.lse,
                                            x.dg, x.dk, x.dv, a);
  return static_cast<int>(cudaGetLastError());
}

// The eight maps' boxes are what the class's tiles take.
template <int DP>
bool boxes_fit(const long long* geo) {
  const int rows[8] = {BQ, BQ, dq_bk<DP>(), dq_bk<DP>(), dkv_bk<DP>(),
                       dkv_bk<DP>(), dkv_bq<DP>(), dkv_bq<DP>()};
  for (int i = 0; i < 8; ++i)
    if (geo[i * sm90::GEO + 7] != sm90::block_cols(DP) ||
        geo[i * sm90::GEO + 9] != rows[i])
      return false;
  return true;
}

template <int DP>
int dispatch(const long long* geo, const CUtensorMap* m, const Tensors& x,
             const FlashArgs& a, int dropout, cudaStream_t st) {
  if (!boxes_fit<DP>(geo)) return static_cast<int>(cudaErrorInvalidValue);
  const bool mk = a.mask != nullptr;
  if (dropout)
    return mk ? launch<DP, true, true>(m, x, a, st)
              : launch<DP, true, false>(m, x, a, st);
  return mk ? launch<DP, false, true>(m, x, a, st)
            : launch<DP, false, false>(m, x, a, st);
}

}  // namespace sm90bwd

// The body of each class group's C entry flash_attention_sm90_bwd: the
// arguments of flash_attention_bwd.cu's flash_attention_bwd without dtype
// (bf16), chunk 16 (head maps) or 8 (flattened maps), plus geo: eight
// tensor maps' geometry (sm90::GEO values each, kernels/flash_attention.py
// `tma_geometry`): q, dout with 128-row boxes and k, v with dq_bk-row boxes
// (the dQ kernel), then k, v with dkv_bk-row and q, dout with dkv_bq-row
// boxes (the dK/dV kernel). Launches the dQ kernel, then the dK/dV kernel,
// on `stream`; returns the first CUDA error. CLASSES(X) lists the group's
// classes; a D of another class returns cudaErrorInvalidValue.
#define PTT_FLASH_SM90_BWD(CLASSES)                                          \
  PTT_EXPORT_ERROR_STRING                                                    \
  extern "C" int flash_attention_sm90_bwd(                                   \
      const void* q, const void* k, const void* v, const void* dout,         \
      const void* lse, const void* dg, void* dq, void* dk, void* dv, int B,  \
      int H, int Hkv, int Sq, int Sk, int D, float scale, int causal,        \
      int dropout, uint32_t seed, const void* seed_ptr, uint32_t thresh,    \
      float rp,                                                              \
      const void* mask, long long m_sb, long long m_sh, long long m_sq,      \
      long long m_sk, const void* cu_q, const void* cu_k, int Tq,            \
      int chunk, const long long* geo, void* stream) {                       \
    if (B == 0 || Sq == 0 || Sk == 0) return 0;                              \
    if (chunk != 16 && !(chunk == 8 && D % 8 == 4 && H == Hkv &&           \
                         sm90::flat_class(sm90::flash_class(D))))           \
      return static_cast<int>(cudaErrorInvalidValue);                        \
    CUtensorMap maps[8];                                                     \
    const void* bases[8] = {q, dout, k, v, k, v, q, dout};                   \
    for (int i = 0; i < 8; ++i) {                                            \
      const int e =                                                          \
          sm90::encode_map(&maps[i], bases[i], geo + i * sm90::GEO);         \
      if (e) return e;                                                       \
    }                                                                        \
    const FlashArgs a{B, H, Hkv, Sq, Sk, D, scale, causal,                   \
                      Drop{seed, thresh, rp,                                 \
                           static_cast<const long long*>(seed_ptr)},         \
                      static_cast<const uint8_t*>(mask), m_sb, m_sh, m_sq,   \
                      m_sk, static_cast<const int*>(cu_q),                   \
                      static_cast<const int*>(cu_k), Tq, chunk};             \
    const sm90bwd::Tensors x{                                                \
        static_cast<const float*>(lse), static_cast<const float*>(dg),       \
        static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),    \
        static_cast<__nv_bfloat16*>(dv)};                                    \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                     \
    switch (sm90::flash_class(D)) {                                          \
      CLASSES(PTT_FLASH_SM90_BWD_CASE)                                       \
      default: return static_cast<int>(cudaErrorInvalidValue);               \
    }                                                                        \
  }                                                                          \
  /* the dynamic shared memory a dQ (dkv 0) or dK/dV (1) block of class  */ \
  /* flash_class(D) takes, 0 for a class of another group                */ \
  extern "C" int flash_attention_sm90_bwd_smem(int D, int dkv) {             \
    switch (sm90::flash_class(D)) {                                          \
      CLASSES(PTT_FLASH_SM90_BWD_SMEM)                                       \
      default: return 0;                                                     \
    }                                                                        \
  }
#define PTT_FLASH_SM90_BWD_CASE(DP) \
  case DP: return sm90bwd::dispatch<DP>(geo, maps, x, a, dropout, st);
#define PTT_FLASH_SM90_BWD_SMEM(DP)                                         \
  case DP:                                                                  \
    return static_cast<int>(dkv ? sm90bwd::dkv_smem_bytes<DP>()             \
                                : sm90bwd::dq_smem_bytes<DP>());
