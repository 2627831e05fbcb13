// Shared by the flash forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu) kernels: the arguments of a launch, the rows a
// thread block covers (dense batches or varlen sequences), the mirror's
// masking of one score, the head-width classes and the row copies.
//
// Masking follows the reference's `_mirror_logits` in its order: the bool
// mask first (a masked entry is bf16(-1e30) added to the score, and in f32
// the sum is that constant, FLASH_MASKED, whatever the score), then
// causality (-1e30), then segments (keys of another sequence are never
// read here). Keys past the end of the sequence are -inf, so they never
// tie with a masked or hidden key: a row whose every visible key is masked
// then averages V exactly as the mirror does (over the causally hidden keys,
// else over all keys), instead of giving zeros.
#pragma once

#include "common.cuh"

constexpr float FLASH_NEG_INF = -1e30f;
constexpr float FLASH_MASKED = -0x1.94p+99f;   // bf16(-1e30) = -1.00026e30

// What every flash launch takes besides its tensors.
// - Dense: B batches of Sq queries and Sk keys.
// - Varlen (cu_q != nullptr): B sequences; sequence s holds the packed rows
//   [cu_q[s], cu_q[s + 1]) of q and [cu_k[s], cu_k[s + 1]) of k and v;
//   Sq, Sk are the longest sequence's lengths (they size the grid only),
//   Tq the packed query rows (lse and dg are [H, Tq]).
// - The bool mask (uint8, nullptr for none) of query head h: element
//   (b, h, i, j) at mask[b * m_sb + h * m_sh + i * m_sq + j * m_sk], stride
//   0 on a broadcast dim.
// - D is the real head width (1..256); the tiles are DP wide (a template
//   argument), zero-padded. chunk is the bytes a bf16 row moves in (16, 8,
//   4 or 2: what the row length and the base pointers allow); the kernels
//   read it only for the narrow widths 4 and 2.
struct FlashArgs {
  int B, H, Hkv, Sq, Sk, D;
  float scale;
  int causal;
  Drop dr;
  const uint8_t* mask;
  long long m_sb, m_sh, m_sq, m_sk;
  const int* cu_q;
  const int* cu_k;
  int Tq;
  int chunk;
};

// The rows of one (batch or sequence b, query head h): packed row bases
// and lengths, the causal offset (key j is visible to query i iff
// j <= i + off, local indices), the lse / dg index of local row 0, the
// dropout key (bh and the offsets of i and j: varlen keys its bits on
// packed positions with bh = h, as the reference's batch-1 varlen call)
// and the mask's offset.
struct FlashRows {
  int qbase, Lq, kbase, Lk, off;
  size_t lse0;
  uint32_t dbh;
  int di0, dj0;
  long long mbase;
};

__device__ __forceinline__ FlashRows flash_rows(const FlashArgs& a, int b,
                                                int h) {
  FlashRows r;
  if (a.cu_q != nullptr) {
    r.qbase = a.cu_q[b];
    r.Lq = a.cu_q[b + 1] - r.qbase;
    r.kbase = a.cu_k[b];
    r.Lk = a.cu_k[b + 1] - r.kbase;
    r.off = r.qbase - r.kbase;   // positional causality in the packed rows
    r.lse0 = static_cast<size_t>(h) * a.Tq + r.qbase;
    r.dbh = static_cast<uint32_t>(h);
    r.di0 = r.qbase;
    r.dj0 = r.kbase;
  } else {
    r.qbase = b * a.Sq;
    r.Lq = a.Sq;
    r.kbase = b * a.Sk;
    r.Lk = a.Sk;
    r.off = a.Sk - a.Sq;
    r.lse0 = (static_cast<size_t>(b) * a.H + h) * a.Sq;
    r.dbh = static_cast<uint32_t>(b * a.H + h);
    r.di0 = 0;
    r.dj0 = 0;
  }
  r.mbase = b * a.m_sb + h * a.m_sh;
  return r;
}

// The mirror's logits of a register tile of N scaled scores in place:
// coord(k, i, j) gives element k's local (query i, key j). The bool mask
// first (the loads predicated on a valid address), then causality and the
// sequence's end as selects, so the tile loop stays branch-free and
// unrolled. MASK = false compiles the mask out: the bf16 kernels take it
// as a template argument, so the unmasked kernels carry none of its code
// (its address arithmetic would otherwise be hoisted into every tile).
template <int N, bool MASK, typename Coord>
__device__ __forceinline__ void flash_logits(float* s, const FlashArgs& a,
                                             const FlashRows& r,
                                             Coord coord) {
  if (MASK && a.mask != nullptr) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      int i, j;
      coord(k, i, j);
      const bool in = i < r.Lq && j < r.Lk;
      const uint8_t keep =
          a.mask[in ? r.mbase + i * a.m_sq + j * a.m_sk : r.mbase];
      s[k] = !in || keep ? s[k] : FLASH_MASKED;
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    int i, j;
    coord(k, i, j);
    const float x = a.causal && j > i + r.off ? FLASH_NEG_INF : s[k];
    s[k] = j >= r.Lk ? -INFINITY : x;
  }
}

// Does a row with running maximum (forward) or lse (backward) `x` take p > 0
// from a causally hidden key? Only when no visible key is unmasked (x at or
// below -1e30): then the mirror averages over the hidden keys, so the kernels
// walk past the diagonal for such rows (a mask and causality together).
__device__ __forceinline__ bool flash_needs_hidden(float x) {
  return x <= FLASH_NEG_INF;
}

// Head-width classes: D rides zero-padded to a multiple of 16 up to 128
// (the depth step of m16n8k16) and of 32 up to 256.
__host__ __device__ constexpr int flash_width(int D) {
  return D <= 128 ? (D + 15) / 16 * 16 : (D + 31) / 32 * 32;
}

#define PTT_FLASH_WIDTHS(X) \
  X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(160) X(192) X(224) X(256)

// ---------------------------------------------------------------------------
// bf16 tile loads in W-byte chunks (16, 8, 4 or 2: what the row length and
// the base pointers allow). The chunk width is a template argument of the
// bf16 kernels, so for the common 16- and 8-byte chunks each loop has a
// constant trip count and unrolls with its global loads in flight; W = 0
// takes the narrow widths (4 or 2), passed as w at run time, in one
// instantiation. The shared rows are 16-byte aligned.
// ---------------------------------------------------------------------------
template <int W>
struct Chunk;
template <>
struct Chunk<16> {
  using T = uint4;
};
template <>
struct Chunk<8> {
  using T = uint2;
};
template <>
struct Chunk<4> {
  using T = uint32_t;
};
template <>
struct Chunk<2> {
  using T = uint16_t;
};

// Rows [0, ROWS) of a DP-wide tile into shared memory (row stride ld):
// tile row r is the global row at src + r * gs (elements) when r < valid,
// else zeros, and the columns from D on are zeros (the tile's padding).
// Chunks run fastest across threads, so a warp reads contiguous bytes.
// The 16- and 8-byte widths load every chunk of a thread into registers
// first (predicated loads, all in flight at once), then store them: a load
// and its store under one guard would make each load wait for the last.
template <int ROWS, int NTH, int DP, int W>
__device__ __forceinline__ void load_rows_w(__nv_bfloat16* dst, int ld,
                                            const __nv_bfloat16* src,
                                            size_t gs, int valid, int D) {
  using V = typename Chunk<W>::T;
  constexpr int EW = W / 2, CH = DP / EW;   // elements a chunk, chunks a row
  constexpr int N = ROWS * CH, IT = (N + NTH - 1) / NTH;
  constexpr bool EXACT = N % NTH == 0;   // no thread runs past the tile
  auto get = [&](int e) {
    const int r = e / CH, c = e - r * CH;
    return (EXACT || e < N) && r < valid && c * EW < D
               ? *reinterpret_cast<const V*>(src + r * gs + c * EW)
               : V{};
  };
  auto put = [&](int e, V u) {
    const int r = e / CH, c = e - r * CH;
    if (EXACT || e < N) *reinterpret_cast<V*>(dst + r * ld + c * EW) = u;
  };
  if constexpr (W >= 8) {
    V u[IT];
#pragma unroll
    for (int i = 0; i < IT; ++i) u[i] = get(threadIdx.x + i * NTH);
#pragma unroll
    for (int i = 0; i < IT; ++i) put(threadIdx.x + i * NTH, u[i]);
  } else {   // odd or misaligned rows: small code
#pragma unroll 1
    for (int i = 0; i < IT; ++i)
      put(threadIdx.x + i * NTH, get(threadIdx.x + i * NTH));
  }
}

// The same rows stored transposed, dst[d * ld + r]; rows run fastest
// across threads so a warp's 2-byte stores fall in distinct banks. With
// COPY, also the row-major copy into `copy` (row stride ldc).
template <int ROWS, int NTH, int DP, int W, bool COPY>
__device__ __forceinline__ void load_rows_t_w(__nv_bfloat16* dst, int ld,
                                              __nv_bfloat16* copy, int ldc,
                                              const __nv_bfloat16* src,
                                              size_t gs, int valid, int D) {
  using V = typename Chunk<W>::T;
  constexpr int EW = W / 2, CH = DP / EW;
  constexpr int N = ROWS * CH, IT = (N + NTH - 1) / NTH;
  constexpr bool EXACT = N % NTH == 0;
  auto put = [&](int e, V u) {
    if (!EXACT && e >= N) return;
    const int r = e % ROWS, c = e / ROWS;
    if constexpr (COPY) *reinterpret_cast<V*>(copy + r * ldc + c * EW) = u;
    const __nv_bfloat16* hv = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < EW; ++i) dst[(c * EW + i) * ld + r] = hv[i];
  };
  auto get = [&](int e) {
    const int r = e % ROWS, c = e / ROWS;
    return (EXACT || e < N) && r < valid && c * EW < D
               ? *reinterpret_cast<const V*>(src + r * gs + c * EW)
               : V{};
  };
  if constexpr (W >= 8) {
    V u[IT];
#pragma unroll
    for (int i = 0; i < IT; ++i) u[i] = get(threadIdx.x + i * NTH);
#pragma unroll
    for (int i = 0; i < IT; ++i) put(threadIdx.x + i * NTH, u[i]);
  } else {
#pragma unroll 1
    for (int i = 0; i < IT; ++i)
      put(threadIdx.x + i * NTH, get(threadIdx.x + i * NTH));
  }
}

// The loaders the kernels call: W-byte chunks, or with W = 0 the narrow
// width w (4 or 2 bytes).
template <int ROWS, int NTH, int DP, int W>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src,
                                          size_t gs, int valid, int D, int w) {
  if constexpr (W != 0)
    load_rows_w<ROWS, NTH, DP, W>(dst, ld, src, gs, valid, D);
  else if (w == 4)
    load_rows_w<ROWS, NTH, DP, 4>(dst, ld, src, gs, valid, D);
  else
    load_rows_w<ROWS, NTH, DP, 2>(dst, ld, src, gs, valid, D);
}

template <int ROWS, int NTH, int DP, int W, bool COPY>
__device__ __forceinline__ void load_rows_t(__nv_bfloat16* dst, int ld,
                                            __nv_bfloat16* copy, int ldc,
                                            const __nv_bfloat16* src,
                                            size_t gs, int valid, int D,
                                            int w) {
  if constexpr (W != 0)
    load_rows_t_w<ROWS, NTH, DP, W, COPY>(dst, ld, copy, ldc, src, gs, valid,
                                          D);
  else if (w == 4)
    load_rows_t_w<ROWS, NTH, DP, 4, COPY>(dst, ld, copy, ldc, src, gs, valid,
                                          D);
  else
    load_rows_t_w<ROWS, NTH, DP, 2, COPY>(dst, ld, copy, ldc, src, gs, valid,
                                          D);
}

// Store columns (col, col + 1) of a row: a bf16 pair where the row allows
// 4-byte stores (W >= 8: D is even), else (the narrow rows, W = 0) one
// element at a time.
template <int W>
__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int col, int D,
                                           float x0, float x1) {
  if (col >= D) return;
  if constexpr (W >= 4) {
    *reinterpret_cast<__nv_bfloat162*>(row + col) =
        __floats2bfloat162_rn(x0, x1);
  } else {
    row[col] = __float2bfloat16(x0);
    if (col + 1 < D) row[col + 1] = __float2bfloat16(x1);
  }
}

// The A fragment (m16n8k16) of rows [row, row + 16) and columns
// [col, col + 16) of a row-major bf16 tile in shared memory (see mma_bf16
// in common.cuh for the layout; row = tile row + g, col = k step + 2t).
__device__ __forceinline__ void a_frag(uint32_t* a, const __nv_bfloat16* s,
                                       int ld, int row, int col) {
  const __nv_bfloat16* p = s + row * ld + col;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}
