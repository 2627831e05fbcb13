// Flash attention forward: returns out and lse.
//
// Replaces paddle_tpu/kernels/flash_attention.py `_fwd_kernel` (pallas_call
// in `_core_fwd`) with all its options: causal or not, dropout on the
// probabilities (`_drop_mask` there), a dense bool mask streamed per score
// (`_tile_mask`, shapes of `_canon_mask`), segments for varlen / packed
// batches (`flash_attn_varlen_pallas`), and any head width 1..256.
// - Dropout: l sums the un-dropped p while p * z / (1 - p) feeds P.V, as in
//   the reference; the keep bit z of score (bh, i, j) comes from
//   drop_row_key/drop_bits (common.cuh), a function of the element alone, so
//   the backward kernels, which tile differently, regenerate the same mask.
//   Each kernel is a template on DROP: p = 0 runs the code without dropout.
// - Mask: the bool mask (uint8, read where each score is formed, never
//   turned into a float [B, H, Sq, Sk]) of any shape broadcastable to
//   [B, H, Sq, Sk] through its strides (flash_common.cuh); a masked score is
//   bf16(-1e30) as in the mirror. With causality too, a row whose every
//   visible key is masked averages V over the hidden keys in the mirror, so
//   the key loop goes past the diagonal while any row of the block needs it.
// - Varlen: one thread block per (sequence, 64-query tile, head), the
//   sequence's rows taken from cu_q / cu_k, so keys of other sequences are
//   never read (what the reference's [lo, hi) tables buy); tiles past a
//   sequence's end exit at once. Causality is positional in the packed
//   rows; a row with no key (an empty key sequence) gets out 0, lse -1e30.
// - Head widths: D rides zero-padded to its class DP (flash_common.cuh) in
//   shared memory; D is a runtime argument for the loads, the stores and the
//   scale, so one instantiation serves each class. Rows move in the widest
//   chunk their alignment allows (16, 8, 4 or 2 bytes). The bf16 kernel is
//   a template on (DP, chunk width, dropout, mask): the 16- and 8-byte
//   widths make the tile loads constant loops whose loads are all in flight
//   before the first store, and an unmasked launch runs code without the
//   mask's; one instantiation (width 0) takes the narrow chunks, for odd or
//   misaligned rows, reading their width and testing the mask at run time.
// Layout is the reference's public one, q/out [B, Sq, H, D] and k/v
// [B, Sk, Hkv, D] with H % Hkv == 0 (query head h reads kv head
// h / (H / Hkv), so GQA needs no repeated copy of K/V); lse [B, H, Sq] f32.
// Varlen: q/out [Tq, H, D], k/v [Tk, Hkv, D], lse [H, Tq]. Causal means
// query i sees key j iff j <= i + (Sk - Sq), the reference's sdpa_ref
// convention (equal to the Pallas kernel's q_ids >= k_ids at Sq == Sk).
//
// Bound on the H100: at long S, flops (4 * S^2 * D per head, halved by
// causality) against 989 TFLOP/s in bf16. Two kernels share the tiling:
// one thread block per (64-row query tile, batch*head), key tiles of K and
// V through shared memory, online softmax (m, l, acc) in f32; the causal
// case stops the key loop at the diagonal, as the reference's `hi` bound
// does, and the kernel masks the ragged edge of S itself (any S, not only
// multiples of the tile; the TPU version halved its block until it divided
// S).
// - bf16 (the model's type): tensor cores through mma.sync m16n8k16 with
//   f32 accumulation. Four warps own 16 query rows each; Q stays in
//   registers as A fragments up to DP 128 (above, it is re-read from shared
//   memory and the key tile is 32 wide, to stay within 255 registers with
//   a 16 x DP f32 accumulator a warp), K is read from padded shared memory
//   as B fragments, V is stored transposed so P.V's B fragments are 32-bit
//   loads, and the score tile's accumulators are re-packed in registers as
//   bf16 A fragments of P (FlashAttention-2's scheme). wgmma and TMA, the
//   way to the card's full rate, are later work.
// - f32: the same tiling on the CUDA cores, 256 threads as 16 x 16, each
//   owning 4 query rows and 4 keys of a 64 x 64 tile (2 and 2 of a 32 x 32
//   tile above DP 128, for shared memory), with padded f32 tiles and
//   probabilities through shared memory.
#include "flash_common.cuh"

namespace {

constexpr int NT = 256;

// f32 tiles: R rows (and keys) a thread, T = 16 R a tile
template <int DP>
__host__ __device__ constexpr int simt_rows() {
  return DP <= 128 ? 4 : 2;
}

template <int DP>
constexpr size_t smem_bytes() {
  constexpr int T = 16 * simt_rows<DP>();
  return sizeof(float) * (3 * T * (DP + 1) + T * (T + 1));
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
template <int DP, bool DROP>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, FlashArgs a) {
  constexpr int R = simt_rows<DP>(), T = 16 * R;
  constexpr int LD = DP + 1, LP = T + 1, ND = DP / 16;
  extern __shared__ float smem[];
  float* Q_s = smem;            // [T, LD]
  float* K_s = Q_s + T * LD;    // [T, LD]
  float* V_s = K_s + T * LD;    // [T, LD]
  float* P_s = V_s + T * LD;    // [T, LP]

  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const FlashRows rw = flash_rows(a, b, h);
  const int q0 = blockIdx.x * T;
  if (q0 >= rw.Lq) return;    // varlen: past this sequence
  const int hk = h / (a.H / a.Hkv), D = a.D;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t qs = static_cast<size_t>(a.H) * D;    // row stride of q/out
  const size_t ks = static_cast<size_t>(a.Hkv) * D;  // row stride of k/v
  const float* qb = q + (static_cast<size_t>(rw.qbase) * a.H + h) * D;
  const float* kb = k + (static_cast<size_t>(rw.kbase) * a.Hkv + hk) * D;
  const float* vb = v + (static_cast<size_t>(rw.kbase) * a.Hkv + hk) * D;

  for (int e = tid; e < T * DP; e += NT) {
    const int r = e / DP, d = e - r * DP, qi = q0 + r;
    Q_s[r * LD + d] = qi < rw.Lq && d < D ? qb[qi * qs + d] * a.scale : 0.f;
  }

  float m[R], l[R], o[R][ND];
  uint32_t krow[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < ND; ++c) o[i][c] = 0.f;
    if constexpr (DROP)
      krow[i] = drop_row_key(drop_seed(a.dr), rw.dbh, rw.di0 + q0 + ty + 16 * i);
  }

  const int n_kt = (rw.Lk + T - 1) / T;
  int n_vis = n_kt;   // tiles holding a visible key of some row
  if (a.causal) {
    const int last = min(q0 + T - 1, rw.Lq - 1) + rw.off;
    n_vis = min(n_kt, last / T + 1);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt == n_vis) {   // past the diagonal: see flash_needs_hidden
      if (a.mask == nullptr) break;
      int need = 0;
#pragma unroll
      for (int i = 0; i < R; ++i)
        need |= q0 + ty + 16 * i < rw.Lq && flash_needs_hidden(m[i]);
      if (!__syncthreads_or(need)) break;
    }
    const int k0 = kt * T;
    __syncthreads();  // Q_s written / last tile's K_s, V_s, P_s consumed
    for (int e = tid; e < T * DP; e += NT) {
      const int r = e / DP, d = e - r * DP, kj = k0 + r;
      const bool ok = kj < rw.Lk && d < D;
      K_s[r * LD + d] = ok ? kb[kj * ks + d] : 0.f;
      V_s[r * LD + d] = ok ? vb[kj * ks + d] : 0.f;
    }
    __syncthreads();

    float sc[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float av[R], bv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) av[i] = Q_s[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < R; ++j) bv[j] = K_s[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) sc[i][j] += av[i] * bv[j];
    }

    flash_logits<R * R, true>(&sc[0][0], a, rw, [&](int e, int& i, int& j) {
      i = q0 + ty + 16 * (e / R);
      j = k0 + tx + 16 * (e % R);
    });
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < R; ++j) mx = fmaxf(mx, sc[i][j]);
#pragma unroll
      for (int o_ = 8; o_ > 0; o_ >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o_));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;   // l sums the un-dropped p
        float pv = p;
        if constexpr (DROP)
          pv = drop_apply(p, krow[i], rw.dj0 + k0 + tx + 16 * j, a.dr.thresh,
                          a.dr.rp);
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
    for (int kk = 0; kk < T; ++kk) {
      float p[R];
#pragma unroll
      for (int i = 0; i < R; ++i) p[i] = P_s[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        const float vv = V_s[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < R; ++i) o[i][c] += p[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= rw.Lq) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / ls;
    const float mm = m[i] == -INFINITY ? FLASH_NEG_INF : m[i];  // no key
    float* orow = out + (static_cast<size_t>(rw.qbase) + qi) * qs +
                  static_cast<size_t>(h) * D;
#pragma unroll
    for (int c = 0; c < ND; ++c)
      if (tx + 16 * c < D) orow[tx + 16 * c] = o[i][c] * inv;
    if (tx == 0) lse[rw.lse0 + qi] = mm + logf(ls);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulate)
// ---------------------------------------------------------------------------
constexpr int MMA_NT = 128;   // 4 warps, 16 query rows each
constexpr int BQ = 64;

template <int DP>
__host__ __device__ constexpr int mma_bk() {   // the key tile
  return DP <= 128 ? 64 : 32;
}

// blocks an SM must hold, for latency hiding: four up to DP 64 (at most
// 128 registers a thread), three up to DP 128 (170)
template <int DP>
__host__ __device__ constexpr int mma_min_blocks() {
  return DP <= 64 ? 4 : DP <= 128 ? 3 : 1;
}

template <int DP>
constexpr size_t mma_smem_bytes() {
  constexpr int BK = mma_bk<DP>();
  return sizeof(__nv_bfloat16) * ((BQ + BK) * (DP + 8) + DP * (BK + 8));
}

// Fragment layouts: see mma_bf16 in common.cuh. The score tile's C
// fragments are re-packed in registers as the A fragments of P for the
// P.V product.
template <int DP, int W, bool DROP, bool MASK>
__global__ void __launch_bounds__(MMA_NT, mma_min_blocks<DP>())
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ lse, FlashArgs a) {
  constexpr int BK = mma_bk<DP>();
  constexpr int LDK = DP + 8, LDV = BK + 8;  // padded rows: no bank conflicts
  constexpr int KS = DP / 16, NO = DP / 8, NS = BK / 8;
  constexpr bool QREG = DP <= 128;           // Q's fragments in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ, LDK]
  __nv_bfloat16* K_s = Q_s + BQ * LDK;                               // [BK, LDK]
  __nv_bfloat16* Vt_s = K_s + BK * LDK;                              // [DP, LDV]

  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const FlashRows rw = flash_rows(a, b, h);
  const int q0 = blockIdx.x * BQ;
  if (q0 >= rw.Lq) return;    // varlen: past this sequence
  const int hk = h / (a.H / a.Hkv), D = a.D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const size_t qs = static_cast<size_t>(a.H) * D;
  const size_t ks = static_cast<size_t>(a.Hkv) * D;
  const __nv_bfloat16* qb = q + (static_cast<size_t>(rw.qbase) * a.H + h) * D;
  const __nv_bfloat16* kb =
      k + (static_cast<size_t>(rw.kbase) * a.Hkv + hk) * D;
  const __nv_bfloat16* vb =
      v + (static_cast<size_t>(rw.kbase) * a.Hkv + hk) * D;

  load_rows<BQ, MMA_NT, DP, W>(Q_s, LDK, qb + q0 * qs, qs, rw.Lq - q0, D, a.chunk);
  __syncthreads();
  uint32_t qa[QREG ? KS : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      a_frag(qa[kk], Q_s, LDK, wr + g, kk * 16 + 2 * t);
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  const int n_kt = (rw.Lk + BK - 1) / BK;
  int n_vis = n_kt;
  if (a.causal) {
    const int last = min(q0 + BQ - 1, rw.Lq - 1) + rw.off;
    n_vis = min(n_kt, last / BK + 1);
  }
  const int qrow[2] = {q0 + wr + g, q0 + wr + g + 8};
  uint32_t krow[2];
  if constexpr (DROP) {
    krow[0] = drop_row_key(drop_seed(a.dr), rw.dbh, rw.di0 + qrow[0]);
    krow[1] = drop_row_key(drop_seed(a.dr), rw.dbh, rw.di0 + qrow[1]);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt == n_vis) {   // past the diagonal: see flash_needs_hidden
      if (!MASK || a.mask == nullptr) break;
      int need = 0;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
        need |= qrow[hi] < rw.Lq && flash_needs_hidden(m[hi]);
      if (!__syncthreads_or(need)) break;
    }
    const int k0 = kt * BK;
    __syncthreads();  // last tile's K_s / Vt_s consumed
    load_rows<BK, MMA_NT, DP, W>(K_s, LDK, kb + k0 * ks, ks, rw.Lk - k0, D, a.chunk);
    load_rows_t<BK, MMA_NT, DP, W, false>(Vt_s, LDV, nullptr, 0,
                                          vb + k0 * ks, ks, rw.Lk - k0, D, a.chunk);
    __syncthreads();

    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t af[4];
      if constexpr (QREG) {
        af[0] = qa[kk][0];
        af[1] = qa[kk][1];
        af[2] = qa[kk][2];
        af[3] = qa[kk][3];
      } else {
        a_frag(af, Q_s, LDK, wr + g, kk * 16 + 2 * t);
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const __nv_bfloat16* p = K_s + (n * 8 + g) * LDK + kk * 16 + 2 * t;
        mma_bf16(sc[n], af, ld32(p), ld32(p + 8));
      }
    }

#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] *= a.scale;
    flash_logits<NS * 4, MASK>(&sc[0][0], a, rw, [&](int x, int& i, int& j) {
      i = qrow[(x & 3) >> 1];
      j = k0 + (x >> 2) * 8 + 2 * t + (x & 1);
    });
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
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
                                rw.dj0 + k0 + n * 8 + 2 * t + (e & 1),
                                a.dr.thresh, a.dr.rp);
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
    if (qi >= rw.Lq) continue;
    const float ls = fmaxf(l[hi], 1e-30f);
    const float inv = 1.f / ls;
    const float mm = m[hi] == -INFINITY ? FLASH_NEG_INF : m[hi];  // no key
    __nv_bfloat16* orow = out + (static_cast<size_t>(rw.qbase) + qi) * qs +
                          static_cast<size_t>(h) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      store_pair<W>(orow, n * 8 + 2 * t, D, o[n][2 * hi] * inv,
                 o[n][2 * hi + 1] * inv);
    if (t == 0) lse[rw.lse0 + qi] = mm + logf(ls);
  }
}

struct Tensors {
  const void *q, *k, *v;
  void *out, *lse;
};

template <typename T, typename Kern>
int launch(Kern kern, int tile, int threads, size_t smem, const Tensors& x,
           const FlashArgs& a, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.Sq + tile - 1) / tile, a.B * a.H);
  kern<<<grid, threads, smem, st>>>(
      static_cast<const T*>(x.q), static_cast<const T*>(x.k),
      static_cast<const T*>(x.v), static_cast<T*>(x.out),
      static_cast<float*>(x.lse), a);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, int W, bool DROP, bool MASK>
int launch_mma(const Tensors& x, const FlashArgs& a, cudaStream_t st) {
  return launch<__nv_bfloat16>(flash_fwd_mma_kernel<DP, W, DROP, MASK>, BQ,
                               MMA_NT, mma_smem_bytes<DP>(), x, a, st);
}

template <int DP, bool DROP>
int launch_width(const Tensors& x, const FlashArgs& a, int dtype,
                 cudaStream_t st) {
  if (dtype == PTT_F32)
    return launch<float>(flash_fwd_kernel<DP, DROP>, 16 * simt_rows<DP>(), NT,
                         smem_bytes<DP>(), x, a, st);
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

// Dense: q/out [B, Sq, H, D], k/v [B, Sk, Hkv, D] contiguous, lse [B, H, Sq]
// f32. Varlen (cu_q, cu_k int32 [B + 1] on the card): q/out [Tq, H, D], k/v
// [Tk, Hkv, D], lse [H, Tq], Sq / Sk the longest sequence's lengths. D in
// 1..256; chunk the bytes a bf16 row moves in. dropout != 0 applies dropout
// with keep threshold `thresh` and rp = 1 / (1 - p) from the 32-bit `seed`,
// or from the int64 at `seed_ptr` on the card where that is not null.
// mask (uint8, or null) with element strides m_sb, m_sh, m_sq, m_sk over
// (batch, query head, query, key); 0 on broadcast dims.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int H, int Hkv, int Sq, int Sk, int D, float scale, int causal, int dtype,
    int dropout, uint32_t seed, const void* seed_ptr, uint32_t thresh,
    float rp, const void* mask,
    long long m_sb, long long m_sh, long long m_sq, long long m_sk,
    const void* cu_q, const void* cu_k, int Tq, int chunk, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (D < 1 || D > 256) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FlashArgs a{B, H, Hkv, Sq, Sk, D, scale, causal,
                    Drop{seed, thresh, rp,
                         static_cast<const long long*>(seed_ptr)},
                    static_cast<const uint8_t*>(mask), m_sb, m_sh, m_sq, m_sk,
                    static_cast<const int*>(cu_q),
                    static_cast<const int*>(cu_k), Tq, chunk};
  const Tensors x{q, k, v, out, lse};
  return dropout ? dispatch<true>(x, a, dtype, st)
                 : dispatch<false>(x, a, dtype, st);
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
