// Flash attention forward for Hopper: bf16 at every head width 1..256
// whose rows TMA can read (kernels/flash_attention.py `_flash_design`):
// 16-byte head rows, or 8-byte ones inside 16-byte token rows (the
// Conformer's 4 heads of 36), but the classes 64 and 128, which keep their
// own kernel (flash_attention_sm90.cu: this template, instantiated there,
// ran their masked rows slower, its masked variants spilling). f32 and
// narrower bf16 rows keep
// flash_attention.cu. The template is instantiated per head-width class by
// flash_attention_sm90_narrow.cu (16, 32, 48) and
// flash_attention_sm90_wide.cu (96, 160, 192, 224, 256), one nvcc each.
//
// Replaces paddle_tpu/kernels/flash_attention.py `_fwd_kernel` (pallas_call
// in `_core_fwd`) for those inputs, with every option of flash_attention.cu
// and the same function, differing only in summation order: causal (the
// bottom-right diagonal, j <= i + (Sk - Sq)), GQA, dropout (the keep bit of
// score (bh, i, j) from drop_row_key/drop_bits, l summing the un-dropped
// p), a bool mask read per score through its strides, the mirror's rows
// whose every visible key is masked (they average V over the hidden keys),
// varlen sequences from cu_q/cu_k, and out = 0, lse = -1e30 for a row that
// sees no key.
//
// Bound on the H100: the flops, 4 * Sq * Sk * D a head (about half of it
// causal), against 989 TFLOP/s bf16; only wgmma reaches that rate, and only
// when its operands arrive without stalling it. At small D the
// exponentials bound it instead (one exp2 a score against the
// special-function units, 16 a clock an SM: at D 16 three times the bytes'
// bound). flash_attention.cu runs mma.sync m16n8k16 on tiles that threads
// load and transpose into shared memory between two barriers, at 7-12 % of
// its bound at D 16 / 96 / 256. This design:
// - a thread block takes (128-query tile, batch * head) tiles, 384
//   threads: a producer warpgroup, of which one thread issues TMA loads of
//   Q and of K and V tiles into a ring of stages with full and empty
//   mbarriers, and two consumer warpgroups of 64 query rows each;
//   setmaxnreg moves registers from the producer (24) to the consumers
//   (240, or 104 with two blocks an SM);
// - the launch holds as many blocks as are resident, each looping over
//   tiles, with two Q buffers where they fit (all but 256), so a block's
//   next Q and first K / V tiles load under its current tile (at
//   [16, 512, 8, 96] the loop alone did not move the forward's time, the
//   second Q buffer did);
// - tiles per class (FwdTiles): up to 48, two blocks an SM with 64-key
//   tiles (the softmax's and the dropout's per-score work, not the
//   products, bound these widths, and gets 16 warps an SM to hide its
//   latencies); 128-key tiles at 96; above, 64-key tiles (a 64 x 256 f32
//   accumulator is 128 registers a thread beside the scores, and the
//   shared memory holds two Q buffers); 3 stages where they fit, else 2;
//   padded share (DP - D) / DP: 0 at the classes' own widths, 25 % at the
//   Conformer's 36 in 48;
// - S = Q.K^T by wgmma m64nBKk16, A and B from swizzled shared memory (the
//   head in DP / W blocks); O += P.V by wgmma m64nDPk16 with P in registers
//   (the RS form: the score accumulators packed to bf16) and V read
//   MN-major through the descriptor's transpose bit, so no thread moves or
//   transposes a tile;
// - the softmax in f32 with ex2.approx (sm90::ex2), log2(e) folded into
//   the scale; the mask, causality and the ragged end of the keys are
//   applied only on the key tiles that need them (a uniform branch per
//   tile: the diagonal tiles, the last partial tile, and every tile of a
//   masked call, whose mask is read per score after the product). The two
//   consumer warpgroups run unsynchronised, so while one waits on its
//   products the other's exponentials issue: the special-function units
//   and the tensor cores overlap across warpgroups, not within one. A
//   version issuing each tile's P.V with the next tile's S
//   (FlashAttention-3's overlap within a warpgroup) measured no faster at
//   96 and slower at 256, where holding the pending P.V's stage starves a
//   2-stage ring; it was taken out. o is rescaled only when a row of the
//   warp raised its maximum;
// - causal: the producer stops at the block's diagonal, a consumer
//   warpgroup skips the tiles past its own; with a mask too, the producer
//   loads every key tile and a warpgroup walks past its diagonal only when
//   one of its rows has seen no unmasked key (flash_needs_hidden, voted
//   over the warpgroup, as flash_attention.cu votes over its block);
// - query tiles run heaviest first under causality; rows past a sequence's
//   end are loaded (TMA zero-fills past the tensor, or reads the next
//   sequence's rows) but never stored: the epilogue stores each row itself,
//   predicated, so a varlen tile never overwrites its neighbour's output.
// Layout as flash_attention.cu: q/out [B, Sq, H, D], k/v [B, Sk, Hkv, D],
// lse [B, H, Sq] f32 (varlen [Tq, H, D], [Tk, Hkv, D], [H, Tq]). The
// tensor maps view each as {D, heads, rows, batches} (varlen: batches 1)
// with boxes of {W, 1, tile rows, 1}.
//
// 8-byte head rows (a.chunk 8: D % 8 == 4, e.g. 36; H == Hkv; the classes
// up to 48, flat_class: the wider ones carry none of this code): TMA needs
// 16-byte strides, and a head row of 72 bytes is not one. The maps then
// view each tensor as {heads * D, 1, rows, batches} (token rows of 288
// bytes at 4 heads). TMA also starts a box only on a 16-byte boundary, so
// head h's box starts at column h D - sh, sh = (h D) mod 8 (0 or 4,
// flat_shift): the head sits at tile columns [sh, sh + D), beside 4
// columns of the previous head (odd h) and the next head's first ones (or
// zeros past the last). q and k of one head share the shift, hence H ==
// Hkv. Chosen over a producer of 8-byte cp.async copies because the TMA
// pipeline stays as it is and the producer keeps its 24 registers. Each
// consumer warpgroup zeroes the columns outside [sh, sh + D) (zero_pad) in
// the tiles whose depth is D before its products read them: Q once, every
// K tile as it arrives. Zeroing the streamed tile too, not only the one
// kept, keeps an inf or NaN of a neighbouring head out of this head's
// scores (0 * inf is NaN). V's extra columns reach only output columns
// outside [sh, sh + D), which are never stored; the epilogue stores tile
// column c as the head's column c - sh.
#pragma once

#include "flash_sm90.cuh"

namespace sm90fwd {

using bf16 = __nv_bfloat16;
constexpr int BQ = 128, NTH = 384;
constexpr size_t SMEM_MAX = 232448;   // 227 KB a block

// Thread blocks resident on an SM: 2 for the classes up to 48, whose
// consumers fit 104 registers (the softmax's and dropout's per-score work
// then has 16 warps an SM to hide its latencies), else 1.
template <int DP>
__host__ __device__ constexpr int fwd_ctas() {
  return DP <= 48 ? 2 : 1;
}

// The key tile: 128 at 96, else 64 (up to 48 for the registers of two
// blocks an SM, above 128 for two Q buffers and two stages; 32 at 256
// measured slower than one Q buffer).
template <int DP>
__host__ __device__ constexpr int fwd_bk() {
  return DP == 96 ? 128 : 64;
}

template <int DP>
__host__ __device__ constexpr size_t fwd_bytes(int stages, int qbufs) {
  return 1024 + 2 * (static_cast<size_t>(qbufs) * BQ * DP +
                     2 * static_cast<size_t>(stages) * fwd_bk<DP>() * DP) +
         8 * 16;
}

template <int DP>
struct FwdTiles {
  static constexpr int W = sm90::block_cols(DP);
  static constexpr int BK = fwd_bk<DP>();
  static constexpr int CTAS = fwd_ctas<DP>();
  // the consumers' registers after setmaxnreg: the block's launch share
  // (65536 / (384 CTAS), in steps of 8) less the producer's 24 a thread
  static constexpr int REGS = CTAS == 2 ? 104 : 240;
  // Q buffers: 2 where they fit beside two stages (all but 256), so the
  // producer loads a block's next Q while its consumers still read the
  // current one
  static constexpr int QB = fwd_bytes<DP>(2, 2) * CTAS <= SMEM_MAX ? 2 : 1;
  // stages of the K / V ring: 3 where they fit, else 2
  static constexpr int S = fwd_bytes<DP>(3, QB) * CTAS <= SMEM_MAX ? 3 : 2;
  static constexpr size_t SMEM = fwd_bytes<DP>(S, QB);
  static_assert(SMEM * CTAS <= SMEM_MAX, "shared memory of a class");
};

// The tile a block takes at step `tile` of its loop: the query tile (the
// fastest index; heaviest first under causality) and the batch * head.
struct FwdTile {
  int q0, b, h;
};

__device__ __forceinline__ FwdTile fwd_tile(const FlashArgs& a, int tile,
                                            int nqt) {
  const int bh = tile / nqt, qt = tile - bh * nqt;
  const int b = bh / a.H;
  return {(a.causal ? nqt - 1 - qt : qt) * BQ, b, bh - b * a.H};
}

template <int DP, bool DROP, bool MASK>
__global__ void __launch_bounds__(NTH, FwdTiles<DP>::CTAS)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          bf16* __restrict__ out, float* __restrict__ lse,
                          FlashArgs a) {
  using T = FwdTiles<DP>;
  constexpr int S = T::S, W = T::W, BK = T::BK, NB = DP / W;
  constexpr int NS = BK / 2, NO = DP / 2;   // accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  constexpr int QB = T::QB;
  bf16* Q_s = reinterpret_cast<bf16*>(sm90::align1024(smem_raw));  // [QB][NB][BQ][W]
  bf16* K_s = Q_s + QB * BQ * DP;                            // [S][NB][BK][W]
  bf16* V_s = K_s + S * BK * DP;                             // [S][NB][BK][W]
  uint64_t* full = reinterpret_cast<uint64_t*>(V_s + S * BK * DP);
  uint64_t* empty = full + S;
  uint64_t* qbar = empty + S;    // [QB] Q has landed
  uint64_t* qfree = qbar + QB;   // [QB] the consumers are done with Q

  const bool varlen = a.cu_q != nullptr;
  // 8-byte head rows: the flattened maps
  const bool flat = sm90::flat_class(DP) && a.chunk == 8;
  // the tiles this block takes: blockIdx.x on, gridDim.x apart
  const int nqt = (a.Sq + BQ - 1) / BQ, n_tiles = nqt * a.B * a.H;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);   // one arrival a consumer warp
    }
    for (int q = 0; q < QB; ++q) {
      sm90::mbar_init(&qbar[q], 1);
      sm90::mbar_init(&qfree[q], 8);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = sm90::warpgroup();
  if (wg == 0) {   // producer warpgroup
    sm90::reg_dealloc<24>();
    if (tid == 0) {
      int it = 0, nt = 0;   // key tiles and query tiles loaded so far
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const FwdTile tl = fwd_tile(a, tile, nqt);
        const FlashRows rw = flash_rows(a, tl.b, tl.h);
        const int q0 = tl.q0;
        if (q0 >= rw.Lq) continue;    // varlen: past this sequence
        const int n_kt = (rw.Lk + BK - 1) / BK;
        int n_vis = n_kt;
        if (a.causal)
          n_vis = min(n_kt, (min(q0 + BQ - 1, rw.Lq - 1) + rw.off) / BK + 1);
        const int n_load = MASK && a.causal ? n_kt : n_vis;
        const int hk = tl.h / (a.H / a.Hkv);
        const int qr = varlen ? rw.qbase + q0 : q0;
        const int kr = varlen ? rw.kbase : 0, bb = varlen ? 0 : tl.b;
        // a head's box: column c of head x at (c, x), or flat at
        // (x D - sh + c, 0), 16-byte aligned (flat_shift)
        const int qc =
            flat ? tl.h * a.D - sm90::flat_shift(flat, tl.h, a.D) : 0;
        const int kc = flat ? hk * a.D - sm90::flat_shift(flat, hk, a.D) : 0;
        const int qh = flat ? 0 : tl.h, kh = flat ? 0 : hk;
        const int qb = nt % QB;
        bf16* Qb = Q_s + qb * BQ * DP;
        sm90::mbar_wait(&qfree[qb], ((nt / QB) & 1) ^ 1);
        sm90::mbar_arrive_tx(&qbar[qb], BQ * DP * 2);
        for (int j = 0; j < NB; ++j)
          sm90::tma_load(Qb + j * BQ * W, &tq, &qbar[qb], qc + j * W, qh, qr,
                         bb);
        ++nt;
        for (int i = 0; i < n_load; ++i, ++it) {
          const int s = it % S;
          sm90::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          sm90::mbar_arrive_tx(&full[s], 2 * BK * DP * 2);
          for (int j = 0; j < NB; ++j) {
            const int off = (s * NB + j) * BK * W;
            sm90::tma_load(K_s + off, &tk, &full[s], kc + j * W, kh,
                           kr + i * BK, bb);
            sm90::tma_load(V_s + off, &tv, &full[s], kc + j * W, kh,
                           kr + i * BK, bb);
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup w: query rows [q0 + 64 w, q0 + 64 w + 64) of each
  // tile
  sm90::reg_alloc<T::REGS>();
  const int w = wg - 1, t = tid % 128, tq4 = t & 3;
  const float sl2 = a.scale * sm90::LOG2E;
  int it = 0, nt = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const FwdTile tl = fwd_tile(a, tile, nqt);
    const int h = tl.h;
    const FlashRows rw = flash_rows(a, tl.b, h);
    const int q0 = tl.q0;
    if (q0 >= rw.Lq) continue;    // varlen: past this sequence
    const int n_kt = (rw.Lk + BK - 1) / BK;
    int n_vis = n_kt;
    if (a.causal)
      n_vis = min(n_kt, (min(q0 + BQ - 1, rw.Lq - 1) + rw.off) / BK + 1);
    const int n_load = MASK && a.causal ? n_kt : n_vis;
    const int r0 = q0 + 64 * w;
    const int row[2] = {r0 + sm90::acc_row(t, 0), r0 + sm90::acc_row(t, 2)};
    int n_own = 0;   // key tiles this warpgroup computes before any vote
    if (r0 < rw.Lq)
      n_own = a.causal
                  ? min(n_kt, (min(r0 + 63, rw.Lq - 1) + rw.off) / BK + 1)
                  : n_kt;
    uint32_t krow[2] = {0, 0};
    if constexpr (DROP) {
      krow[0] = drop_row_key(drop_seed(a.dr), rw.dbh, rw.di0 + row[0]);
      krow[1] = drop_row_key(drop_seed(a.dr), rw.dbh, rw.di0 + row[1]);
    }
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float o[NO];
#pragma unroll
    for (int x = 0; x < NO; ++x) o[x] = 0.f;
    bool walk = false;   // past the diagonal: see flash_needs_hidden

    // the head's columns in the tiles: [sh, sh + D) (flat: q and k are one
    // head, H == Hkv), else [0, D)
    const int sh = sm90::flat_shift(flat, h, a.D);
    const int qb = nt % QB;
    sm90::mbar_wait(&qbar[qb], (nt / QB) & 1);
    bf16* Qw = Q_s + qb * BQ * DP + 64 * w * W;
    if (flat) {   // this warpgroup's Q rows: the neighbours' columns to 0
      sm90::zero_pad<W, DP>(Qw, BQ, 64, sh, sh + a.D, t, 128);
      sm90::fence_proxy_async();
      sm90::bar_sync(1 + w, 128);
    }
    for (int i = 0; i < n_load; ++i, ++it) {
      const int s = it % S;
      if (MASK && a.causal && i == n_own) {
        int need = 0;
#pragma unroll
        for (int hi = 0; hi < 2; ++hi)
          need |= row[hi] < rw.Lq && flash_needs_hidden(m[hi]);
        walk = sm90::bar_or(1 + w, 128, need);
      }
      sm90::mbar_wait(&full[s], (it / S) & 1);
      if (i < n_own || walk) {
        bf16* Ks = K_s + s * BK * DP;
        const bf16* Vs = V_s + s * BK * DP;
        if (flat) {   // both warpgroups write the same zeros
          sm90::zero_pad<W, DP>(Ks, BK, BK, sh, sh + a.D, t, 128);
          sm90::fence_proxy_async();
          sm90::bar_sync(1 + w, 128);
        }
        const uint64_t qd = sm90::opaque(sm90::desc<W>(Qw, 16));
        const uint64_t kd = sm90::desc<W>(Ks, 16);
        float sc[NS];
        sm90::wg_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          sm90::wgmma_ss<BK>(sc, sm90::desc_add(qd, sm90::kstep<W>(kk, BQ)),
                             sm90::desc_add(kd, sm90::kstep<W>(kk, BK)),
                             kk > 0);
        sm90::wg_commit();
        sm90::wg_wait<0>();
        sm90::fence_regs<NS>(sc);

        const int k0 = i * BK;
        const bool edge = MASK || k0 + BK > rw.Lk ||
                          (a.causal && k0 + BK - 1 > r0 + rw.off);
        if (edge) {   // the mirror's logits, in natural units
#pragma unroll
          for (int x = 0; x < NS; ++x) sc[x] *= a.scale;
          flash_logits<NS, MASK>(sc, a, rw, [&](int x, int& ii, int& jj) {
            ii = row[(x >> 1) & 1];
            jj = k0 + sm90::acc_col(t, x);
          });
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int x = 0; x < NS; ++x)
          mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], sc[x]);
        float alpha[2], mb[2];
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 1));
          mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 2));
          const float m_new = fmaxf(m[hi], edge ? mx[hi] : mx[hi] * a.scale);
          alpha[hi] = sm90::ex2((m[hi] - m_new) * sm90::LOG2E);
          m[hi] = m_new;
          mb[hi] = m_new * sm90::LOG2E;
        }
        float rs[2] = {0.f, 0.f};
        if (edge) {   // subtract first: exact for the mask's constants
#pragma unroll
          for (int x = 0; x < NS; ++x) {
            const int hi = (x >> 1) & 1;
            sc[x] = sm90::ex2((sc[x] - m[hi]) * sm90::LOG2E);
            rs[hi] += sc[x];
          }
        } else {
#pragma unroll
          for (int x = 0; x < NS; ++x) {
            const int hi = (x >> 1) & 1;
            sc[x] = sm90::ex2(fmaf(sc[x], sl2, -mb[hi]));
            rs[hi] += sc[x];
          }
        }
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          rs[hi] += __shfl_xor_sync(0xffffffffu, rs[hi], 1);
          rs[hi] += __shfl_xor_sync(0xffffffffu, rs[hi], 2);
          l[hi] = alpha[hi] * l[hi] + rs[hi];   // the un-dropped sum
        }
        // o *= alpha, skipped where every row of the warp kept its maximum
        // (alpha exactly 1), as it mostly does after the first key tiles
        if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
          for (int x = 0; x < NO; ++x) o[x] *= alpha[(x >> 1) & 1];
        }
        if constexpr (DROP) {
#pragma unroll
          for (int x = 0; x < NS; ++x)
            sc[x] = drop_apply(sc[x], krow[(x >> 1) & 1],
                               rw.dj0 + k0 + sm90::acc_col(t, x),
                               a.dr.thresh, a.dr.rp);
        }
        uint32_t pa[BK / 16][4];
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) sm90::acc_to_a(pa[j], sc, j);
        sm90::fence_regs<NO>(o);
        sm90::wg_fence();
        const uint64_t vd = sm90::desc<W>(Vs, BK * W * 2);   // MN-major
#pragma unroll
        for (int j = 0; j < BK / 16; ++j)
          sm90::wgmma_rs<DP>(o, pa[j], sm90::desc_add(vd, j * 16 * W), 1);
        sm90::wg_commit();
        sm90::wg_wait<0>();
        sm90::fence_regs<NO>(o);
      }
      __syncwarp();   // every lane is done with the stage
      if ((t & 31) == 0) sm90::mbar_arrive(&empty[s]);
    }
    // Q is read no more: the producer may load the next tile's under this
    // epilogue
    __syncwarp();
    if ((t & 31) == 0) sm90::mbar_arrive(&qfree[qb]);
    ++nt;

    const size_t qs = static_cast<size_t>(a.H) * a.D;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int qi = row[hi];
      if (qi >= rw.Lq) continue;
      const float ls = fmaxf(l[hi], 1e-30f);
      const float inv = 1.f / ls;
      const float mm = m[hi] == -INFINITY ? FLASH_NEG_INF : m[hi];  // no key
      bf16* orow = out + (static_cast<size_t>(rw.qbase) + qi) * qs +
                   static_cast<size_t>(h) * a.D;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int col = n * 8 + 2 * tq4 - sh;
        if (col >= 0)
          store_pair<16>(orow, col, a.D, o[4 * n + 2 * hi] * inv,
                         o[4 * n + 2 * hi + 1] * inv);
      }
      if (tq4 == 0) lse[rw.lse0 + qi] = mm + logf(ls);
    }
  }
}

template <int DP, bool DROP, bool MASK>
int launch(const CUtensorMap* maps, void* out, void* lse, const FlashArgs& a,
           cudaStream_t st) {
  using T = FwdTiles<DP>;
  auto kern = flash_fwd_sm90_kernel<DP, DROP, MASK>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (a.Sq + BQ - 1) / BQ * a.B * a.H;
  const int grid = min(tiles, T::CTAS * sm90::sm_count());
  kern<<<grid, NTH, T::SMEM, st>>>(maps[0], maps[1], maps[2],
                                   static_cast<bf16*>(out),
                                   static_cast<float*>(lse), a);
  return static_cast<int>(cudaGetLastError());
}

// The maps' boxes are what the class's tiles take: {W, 1, BQ | BK, 1}.
template <int DP>
bool boxes_fit(const long long* geo) {
  using T = FwdTiles<DP>;
  const int rows[3] = {BQ, T::BK, T::BK};
  for (int i = 0; i < 3; ++i)
    if (geo[i * sm90::GEO + 7] != T::W || geo[i * sm90::GEO + 9] != rows[i])
      return false;
  return true;
}

template <int DP>
int dispatch(const long long* geo, const CUtensorMap* maps, void* out,
             void* lse, const FlashArgs& a, int dropout, cudaStream_t st) {
  if (!boxes_fit<DP>(geo)) return static_cast<int>(cudaErrorInvalidValue);
  const bool m = a.mask != nullptr;
  if (dropout)
    return m ? launch<DP, true, true>(maps, out, lse, a, st)
             : launch<DP, true, false>(maps, out, lse, a, st);
  return m ? launch<DP, false, true>(maps, out, lse, a, st)
           : launch<DP, false, false>(maps, out, lse, a, st);
}

}  // namespace sm90fwd

// The body of each class group's C entry flash_attention_sm90_fwd: the
// arguments of flash_attention.cu's flash_attention_fwd without dtype
// (bf16), chunk 16 (head maps) or 8 (flattened maps), plus geo: the three
// tensor maps' geometry (q, k, v; sm90::GEO values each,
// kernels/flash_attention.py `tma_geometry`). CLASSES(X) lists the group's
// classes; a D of another class returns cudaErrorInvalidValue.
#define PTT_FLASH_SM90_FWD(CLASSES)                                          \
  PTT_EXPORT_ERROR_STRING                                                    \
  extern "C" int flash_attention_sm90_fwd(                                   \
      const void* q, const void* k, const void* v, void* out, void* lse,     \
      int B, int H, int Hkv, int Sq, int Sk, int D, float scale, int causal, \
      int dropout, uint32_t seed, const void* seed_ptr, uint32_t thresh,    \
      float rp,                                                              \
      const void* mask, long long m_sb, long long m_sh, long long m_sq,      \
      long long m_sk, const void* cu_q, const void* cu_k, int Tq,            \
      int chunk, const long long* geo, void* stream) {                       \
    if (B == 0 || Sq == 0) return 0;                                         \
    if (chunk != 16 && !(chunk == 8 && D % 8 == 4 && H == Hkv &&           \
                         sm90::flat_class(sm90::flash_class(D))))           \
      return static_cast<int>(cudaErrorInvalidValue);                        \
    CUtensorMap maps[3];                                                     \
    const void* bases[3] = {q, k, v};                                        \
    for (int i = 0; i < 3; ++i) {                                            \
      const int e = sm90::encode_map(&maps[i], bases[i], geo + i * sm90::GEO); \
      if (e) return e;                                                       \
    }                                                                        \
    const FlashArgs a{B, H, Hkv, Sq, Sk, D, scale, causal,                   \
                      Drop{seed, thresh, rp,                                 \
                           static_cast<const long long*>(seed_ptr)},         \
                      static_cast<const uint8_t*>(mask), m_sb, m_sh, m_sq,   \
                      m_sk, static_cast<const int*>(cu_q),                   \
                      static_cast<const int*>(cu_k), Tq, chunk};             \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                     \
    switch (sm90::flash_class(D)) {                                          \
      CLASSES(PTT_FLASH_SM90_FWD_CASE)                                       \
      default: return static_cast<int>(cudaErrorInvalidValue);               \
    }                                                                        \
  }                                                                          \
  /* the dynamic shared memory a block of class flash_class(D) takes, 0  */ \
  /* for a class of another group (chip_smoke.py prints it)              */ \
  extern "C" int flash_attention_sm90_fwd_smem(int D) {                      \
    switch (sm90::flash_class(D)) {                                          \
      CLASSES(PTT_FLASH_SM90_FWD_SMEM)                                       \
      default: return 0;                                                     \
    }                                                                        \
  }
#define PTT_FLASH_SM90_FWD_CASE(DP) \
  case DP: return sm90fwd::dispatch<DP>(geo, maps, out, lse, a, dropout, st);
#define PTT_FLASH_SM90_FWD_SMEM(DP) \
  case DP: return static_cast<int>(sm90fwd::FwdTiles<DP>::SMEM);
