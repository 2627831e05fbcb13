// Flash attention forward for Hopper: bf16 at head_dim 49..64 and 97..128
// (the head-width classes 64 and 128), rows and base addresses 16-byte
// aligned (kernels/flash_attention.py `_flash_design`): the widths of the
// Llama, ERNIE, encoder and Whisper paths. The other bf16 widths TMA reads
// run the classes of flash_attention_sm90.cuh; f32 and narrower bf16 rows
// keep flash_attention.cu. These two classes keep their own kernel: the
// class template of flash_attention_sm90.cuh, instantiated at 64 and 128,
// ran their masked rows slower, its masked variants spilling.
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
// when its operands arrive without stalling it. flash_attention.cu runs
// mma.sync m16n8k16 on tiles that threads load and transpose into shared
// memory between two barriers, at 9 % of the peak on this row. This
// design:
// - one thread block per (128-query tile, batch * head), 384 threads: a
//   producer warpgroup, of which one thread issues TMA loads of Q (once)
//   and of K and V tiles (128 keys) into a ring of stages (3 at head_dim
//   64, 2 at 128) with full and empty mbarriers, and two consumer
//   warpgroups of 64 query rows each; setmaxnreg moves registers from the
//   producer (24) to the consumers (240), though ptxas still fits the
//   consumers' code near 168 (a thread holds S and O, 64 + 64 at D 128);
// - S = Q.K^T by wgmma m64n128k16, A and B from 128-byte-swizzled shared
//   memory (a 128-wide head is two 64-column TMA boxes); O += P.V by wgmma
//   with P in registers (the RS form: the score accumulators packed to
//   bf16) and V read MN-major through the descriptor's transpose bit, so no
//   thread moves or transposes a tile;
// - the softmax in f32 with exp2f, log2(e) folded into the scale; the
//   mask, causality and the ragged end of the keys are applied only on the
//   key tiles that need them (a uniform branch per tile: the diagonal tiles,
//   the last partial tile, and every tile of a masked call, whose mask is
//   read per score after the product);
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
// with boxes of {64, 1, tile rows, 1}.
#include "flash_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int BQ = 128, BK = 128, NTH = 384;

template <int D>
__host__ __device__ constexpr int stages() {
  return D == 64 ? 3 : 2;
}

template <int D>
constexpr size_t smem_bytes() {
  return 1024 + 2 * (BQ * D + 2 * stages<D>() * BK * D) + 8 * 16;
}

template <int D, bool DROP, bool MASK>
__global__ void __launch_bounds__(NTH, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          bf16* __restrict__ out, float* __restrict__ lse,
                          FlashArgs a) {
  constexpr int S = stages<D>(), NH = D / 64;
  constexpr int NS = BK / 2, NO = D / 2;   // accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  bf16* Q_s = reinterpret_cast<bf16*>(sm90::align1024(smem_raw));  // [NH][BQ][64]
  bf16* K_s = Q_s + BQ * D;                                  // [S][NH][BK][64]
  bf16* V_s = K_s + S * BK * D;                              // [S][NH][BK][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(V_s + S * BK * D);
  uint64_t* empty = full + S;
  uint64_t* qbar = empty + S;

  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const FlashRows rw = flash_rows(a, b, h);
  const int q0 = (a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BQ;
  if (q0 >= rw.Lq) return;    // varlen: past this sequence
  const bool varlen = a.cu_q != nullptr;
  const int n_kt = (rw.Lk + BK - 1) / BK;
  int n_vis = n_kt;   // key tiles holding a visible key of some row
  if (a.causal)
    n_vis = min(n_kt, (min(q0 + BQ - 1, rw.Lq - 1) + rw.off) / BK + 1);
  const int n_load = MASK && a.causal ? n_kt : n_vis;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);   // one arrival a consumer warp
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
      sm90::mbar_arrive_tx(qbar, BQ * D * 2);
      for (int hf = 0; hf < NH; ++hf)
        sm90::tma_load(Q_s + hf * BQ * 64, &tq, qbar, hf * 64, h, qr, bb);
      for (int it = 0; it < n_load; ++it) {
        const int s = it % S;
        sm90::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        sm90::mbar_arrive_tx(&full[s], 2 * BK * D * 2);
        for (int hf = 0; hf < NH; ++hf) {
          const int off = (s * NH + hf) * BK * 64;
          sm90::tma_load(K_s + off, &tk, &full[s], hf * 64, hk, kr + it * BK,
                         bb);
          sm90::tma_load(V_s + off, &tv, &full[s], hf * 64, hk, kr + it * BK,
                         bb);
        }
      }
    }
    return;
  }

  // consumer warpgroup w: query rows [q0 + 64 w, q0 + 64 w + 64)
  sm90::reg_alloc<240>();
  const int w = wg - 1, t = tid % 128, tq4 = t & 3;
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
  const float sl2 = a.scale * sm90::LOG2E;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NO];
#pragma unroll
  for (int x = 0; x < NO; ++x) o[x] = 0.f;
  bool walk = false;   // past the diagonal: see flash_needs_hidden

  sm90::mbar_wait(qbar, 0);
  const bf16* Qw = Q_s + 64 * w * 64;
  for (int it = 0; it < n_load; ++it) {
    const int s = it % S;
    if (MASK && a.causal && it == n_own) {
      int need = 0;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
        need |= row[hi] < rw.Lq && flash_needs_hidden(m[hi]);
      walk = sm90::bar_or(1 + w, 128, need);
    }
    sm90::mbar_wait(&full[s], (it / S) & 1);
    if (it < n_own || walk) {
      const bf16* Ks = K_s + s * BK * D;
      const bf16* Vs = V_s + s * BK * D;
      const uint64_t qd = sm90::opaque(sm90::desc(Qw, 16, 1024));
      const uint64_t kd = sm90::desc(Ks, 16, 1024);
      float sc[NS];
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int hf = kk / 4, c = (kk % 4) * 16;
        sm90::wgmma_ss<BK>(sc, sm90::desc_add(qd, hf * BQ * 64 + c),
                           sm90::desc_add(kd, hf * BK * 64 + c), kk > 0);
      }
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_regs<NS>(sc);

      const int k0 = it * BK;
      const bool edge = MASK || k0 + BK > rw.Lk ||
                        (a.causal && k0 + BK - 1 > r0 + rw.off);
      if (edge) {   // the mirror's logits, in natural units
#pragma unroll
        for (int x = 0; x < NS; ++x) sc[x] *= a.scale;
        flash_logits<NS, MASK>(sc, a, rw, [&](int x, int& i, int& j) {
          i = row[(x >> 1) & 1];
          j = k0 + sm90::acc_col(t, x);
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
        alpha[hi] = exp2f((m[hi] - m_new) * sm90::LOG2E);
        m[hi] = m_new;
        mb[hi] = m_new * sm90::LOG2E;
      }
      float rs[2] = {0.f, 0.f};
      if (edge) {   // subtract first: exact for the mask's constants
#pragma unroll
        for (int x = 0; x < NS; ++x) {
          const int hi = (x >> 1) & 1;
          sc[x] = exp2f((sc[x] - m[hi]) * sm90::LOG2E);
          rs[hi] += sc[x];
        }
      } else {
#pragma unroll
        for (int x = 0; x < NS; ++x) {
          const int hi = (x >> 1) & 1;
          sc[x] = exp2f(fmaf(sc[x], sl2, -mb[hi]));
          rs[hi] += sc[x];
        }
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        rs[hi] += __shfl_xor_sync(0xffffffffu, rs[hi], 1);
        rs[hi] += __shfl_xor_sync(0xffffffffu, rs[hi], 2);
        l[hi] = alpha[hi] * l[hi] + rs[hi];   // the un-dropped sum
      }
#pragma unroll
      for (int x = 0; x < NO; ++x) o[x] *= alpha[(x >> 1) & 1];
      if constexpr (DROP) {
#pragma unroll
        for (int x = 0; x < NS; ++x)
          sc[x] = drop_apply(sc[x], krow[(x >> 1) & 1],
                             rw.dj0 + k0 + sm90::acc_col(t, x), a.dr.thresh,
                             a.dr.rp);
      }
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) sm90::acc_to_a(pa[j], sc, j);
      sm90::fence_regs<NO>(o);
      sm90::wg_fence();
      const uint64_t vd = sm90::desc(Vs, BK * 128, 1024);   // MN-major
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        sm90::wgmma_rs<D>(o, pa[j], sm90::desc_add(vd, j * 16 * 64), 1);
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_regs<NO>(o);
    }
    __syncwarp();   // every lane is done with the stage
    if ((t & 31) == 0) sm90::mbar_arrive(&empty[s]);
  }

  const size_t qs = static_cast<size_t>(a.H) * a.D;   // a.D <= D
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
    for (int n = 0; n < D / 8; ++n)
      store_pair<16>(orow, n * 8 + 2 * tq4, a.D, o[4 * n + 2 * hi] * inv,
                     o[4 * n + 2 * hi + 1] * inv);
    if (tq4 == 0) lse[rw.lse0 + qi] = mm + logf(ls);
  }
}

template <int D, bool DROP, bool MASK>
int launch(const CUtensorMap* maps, void* out, void* lse, const FlashArgs& a,
           cudaStream_t st) {
  auto kern = flash_fwd_sm90_kernel<D, DROP, MASK>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.H);
  kern<<<grid, NTH, smem, st>>>(maps[0], maps[1], maps[2],
                                static_cast<bf16*>(out),
                                static_cast<float*>(lse), a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch(const CUtensorMap* maps, void* out, void* lse,
             const FlashArgs& a, int dropout, cudaStream_t st) {
  const bool m = a.mask != nullptr;
  if (dropout)
    return m ? launch<D, true, true>(maps, out, lse, a, st)
             : launch<D, true, false>(maps, out, lse, a, st);
  return m ? launch<D, false, true>(maps, out, lse, a, st)
           : launch<D, false, false>(maps, out, lse, a, st);
}

}  // namespace

PTT_EXPORT_ERROR_STRING

// The arguments of flash_attention.cu's flash_attention_fwd without dtype
// (bf16), chunk 16 (16-byte rows), plus geo: the three tensor maps'
// geometry (q, k, v; sm90::GEO values each, kernels/flash_attention.py
// `tma_geometry`). D is 64 or 128 (the class 64: D 49..64 pads to 64).
extern "C" int flash_attention_sm90_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int H, int Hkv, int Sq, int Sk, int D, float scale, int causal,
    int dropout, uint32_t seed, const void* seed_ptr, uint32_t thresh,
    float rp, const void* mask,
    long long m_sb, long long m_sh, long long m_sq, long long m_sk,
    const void* cu_q, const void* cu_k, int Tq, int chunk,
    const long long* geo, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  const int DP = sm90::flash_class(D);   // 64 or 128: D 49..64, 97..128
  if ((DP != 64 && DP != 128) || chunk != 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int e = sm90::encode_map(&maps[i], bases[i], geo + i * sm90::GEO);
    if (e) return e;
  }
  const FlashArgs a{B, H, Hkv, Sq, Sk, D, scale, causal,
                    Drop{seed, thresh, rp,
                         static_cast<const long long*>(seed_ptr)},
                    static_cast<const uint8_t*>(mask), m_sb, m_sh, m_sq, m_sk,
                    static_cast<const int*>(cu_q),
                    static_cast<const int*>(cu_k), Tq, 16};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return DP == 64 ? dispatch<64>(maps, out, lse, a, dropout, st)
                  : dispatch<128>(maps, out, lse, a, dropout, st);
}

// the dynamic shared memory a block of head_dim D takes (chip_smoke.py
// prints it), 0 for another D
extern "C" int flash_attention_sm90_fwd_smem(int D) {
  return D == 64 ? static_cast<int>(smem_bytes<64>())
                 : D == 128 ? static_cast<int>(smem_bytes<128>()) : 0;
}

// A timing probe, not a kernel of any model path: each of 256 threads a
// block runs 8 independent chains of `iters` exponentials (x <- 2^-x by
// sm90::ex2, the flash templates' instruction; bounded in (0, 1]), so the
// special-function units are the limit. chip_smoke.py divides the
// exponentials by its time into the card's exp2 rate: the flash kernels'
// bound at small head widths, where one exponential a score costs more
// than the products.
__global__ void __launch_bounds__(256)
    flash_exp2_probe_kernel(float* __restrict__ out, int iters) {
  float x[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = 0.125f * (threadIdx.x % 5 + i);
  for (int n = 0; n < iters; ++n) {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = sm90::ex2(-x[i]);
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += x[i];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

extern "C" int flash_exp2_probe(void* out, int blocks, int iters,
                                void* stream) {
  flash_exp2_probe_kernel<<<blocks, 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
