// RNN-Transducer loss lattice: the alpha (forward) recursion, and the beta
// recursion with the blank and emit posteriors (the gradient) in one pass.
//
// Replaces paddle_tpu/kernels/rnnt.py `_alpha_kernel` (pallas_call in
// `_run_alpha`) and `_beta_grad_kernel` (pallas_call in `_bwd`). Inputs are
// the log-prob lattices blank[b, t, u] and emit[b, t, u], f32 [B, T, U + 1]
// (emit column U and the columns >= u_len hold the -1e30 sentinel), and the
// lengths t_len, u_len [B]. The arithmetic is the reference's: -1e30 is the
// log-space -inf, `lse2` keeps its guard (a sum whose larger term is below
// -5e29 stays exactly -1e30),
//   alpha[t, u] = lse2(alpha[t-1, u] + blank[t-1, u],
//                      alpha[t, u-1] + emit[t, u-1]),   alpha[0, 0] = 0,
//   ll = alpha[t_len-1, u_len] + blank[t_len-1, u_len],
//   bhat[t, u] = lse2(blank[t, u] + bhat[t+1, u], emit[t, u] + bhat[t, u+1])
// from the virtual terminal row bhat[t_len, u] = (u == u_len ? 0 : -1e30),
//   gb[t, u] = exp(min(alpha + blank + bhat[t+1, u] - ll, 0)),
//   ge[t, u] = exp(min(alpha + emit + bhat[t, u+1] - ll, 0)).
// Only the cells t < t_len, u <= u_len are live; the kernels write -1e30
// (alpha, bhat) and 0 (gb, ge) everywhere else, so the plain versions in
// kernels/rnnt.py agree with them cell for cell.
//
// Bound on the H100: a dependent chain. Diagonal d = t + u needs all of
// diagonal d - 1 (d + 1 for beta), so a lattice is max(t_len + u_len)
// dependent steps, each a shuffle, an add, `lse2` (fmaxf, expf, logf) and
// a select; bytes (~2-6 MB) and flops are far below it. `rnnt_chain_probe`
// times one such step in registers; chip_smoke.py reports steps x that
// latency as the chain bound beside the byte bound.
//
// Design for this card. The TPU kernel removes the u-dependence of a time
// row analytically (alpha[t] = E + logcumsumexp(base - E), a lane scan over
// 128-lane rows). Here the lattice runs as an anti-diagonal wavefront, one
// thread block per utterance, and everything but the arithmetic is taken
// off the chain:
// - compute warps hold the diagonal: lanes over u, C = 2 adjacent cells a
//   lane (4 above U + 1 = 1792, 8 above 3584), so a diagonal's step is C
//   independent lse2s. The left (alpha) or right (beta) neighbour of a
//   lane's edge cell comes from the next lane by __shfl_up_sync /
//   __shfl_down_sync. At U + 1 <= 64 one compute warp holds the whole
//   diagonal (route "warp": no barrier on the chain); wider lattices
//   (route "block") take ceil((U + 1) / 32C) compute warps that pass their
//   edge cells through shared memory, one named barrier a diagonal;
// - helper warps (7 beside one compute warp; as many as the compute warps,
//   at least 4, in the block route) stage the inputs and write the
//   results, so the compute warps issue nothing but the recursion. The
//   lattice is cut into bands of G consecutive diagonals; a band crosses
//   each row in a run of G adjacent cells, so the helpers copy a band's
//   inputs row run by row run (consecutive threads on consecutive
//   addresses; 4-byte cp.async, so any alignment, odd T x (U + 1)
//   utterance bases included) into a ring of 3 bands in shared memory,
//   diagonal-major ([G][U1s]: a lane's cells adjacent, one 8-byte load a
//   cell pair), two bands ahead of the wavefront, copying only cells whose
//   destination is live. The compute warps write each diagonal's results
//   into an output band (double-buffered), which the helpers write out as
//   row runs with the dead cells' fill folded in, while the next band
//   runs; the diagonals past the last band are one row-suffix pass and
//   one flat pass. One barrier a band hands a band of inputs in and a band
//   of results out; no per-cell divide anywhere;
// - the compute loop is branch-free: a dead cell's inputs (never copied)
//   are selected away and its value clamped by fminf, so two cells' chains
//   interleave; each diagonal's inputs are loaded from shared memory under
//   the previous diagonal's chain;
// - the launch plan (cells, compute and helper warps, band G, ring stages)
//   comes from U + 1 alone (`plan_for`; kernels/rnnt.py `launch_plan`
//   mirrors it), so the launch needs no length on the host. G is the
//   largest power of two <= 32 whose ring and bands fit 227 KB of shared
//   memory (32 at the slice's U + 1 = 49; 1, with a ring of 2, at 4096);
// - lse2 as m + logf(1 + expf(-|a - b|)): one of the reference's two
//   exponentials is exp(0) = 1 exactly and b - a = -(a - b) in IEEE
//   arithmetic, so this is the reference's value bit for bit with one
//   expf on the chain instead of two.
#include "common.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 1024, MAX_STATES = 4096, MAX_BAND_LOG2 = 5;
constexpr int COMPUTE_WARPS_MAX = 28;   // + 4 helper warps <= 32
constexpr int HELPERS_WARP = 7;
constexpr float KEEP = 3e38f;   // fminf(x, KEEP) == x for a live cell
constexpr size_t SMEM_LIMIT = 232448;   // 227 KB a block on the H100

// log(e^a + e^b), -1e30 when the larger term is below -5e29 (the
// reference's `_lse2`, with its exp(0) = 1 term folded in). Branch-free:
// the guard is a select, so a warp whose lanes differ takes one path.
__device__ __forceinline__ float lse2(float a, float b) {
  const float m = fmaxf(a, b);
  const float r = m + logf(1.f + expf(-fabsf(a - b)));
  return m <= NEG / 2 ? NEG : r;
}

// the compute warps alone, once a diagonal (named barrier 1)
__device__ __forceinline__ void compute_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// every warp, once a band: the compute warps hand a finished band of
// results to the helpers, the helpers the next band of inputs to the
// compute warps (named barrier 2; the two sides call it from their own
// loops, the same number of times)
__device__ __forceinline__ void handoff() {
  asm volatile("bar.sync 2, %0;\n" ::"r"(blockDim.x) : "memory");
}

template <int C>
__device__ __forceinline__ void load_cells(const float* p, float* x) {
  if constexpr (C == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < C; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      x[i] = v.x;
      x[i + 1] = v.y;
      x[i + 2] = v.z;
      x[i + 3] = v.w;
    }
  }
}

template <int C>
__device__ __forceinline__ void store_cells(float* p, const float* x) {
  if constexpr (C == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int i = 0; i < C; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  }
}

__device__ __forceinline__ bool live(int t, int u, int tl, int ul) {
  return t >= 0 && t < tl && u <= ul;
}

// The band of diagonals [d0, d0 + G) of one output [T, U1]: each row t it
// crosses holds the run u = d0 - t .. d0 + G - 1 - t, written as G
// consecutive addresses (t * (U1 - 1) + d0 + k) by consecutive threads;
// live cells from the band in shared memory, os[k * U1s + u], dead ones
// `fill`. Threads `id` of `n`.
__device__ __forceinline__ void write_band(float* out, const float* os,
                                           int d0, int lg, int T, int U1,
                                           int U1s, int tl, int ul, float fill,
                                           int id, int nt) {
  // nt is a multiple of 32 >= G: each thread keeps one k, rows step by nt/G
  const int k = id & ((1 << lg) - 1), step = nt >> lg;
  const int t_hi = min(T - 1, d0 + (1 << lg) - 1);
  for (int t = max(0, d0 - U1 + 1) + (id >> lg); t <= t_hi; t += step) {
    const int u = d0 + k - t;
    if (u >= 0 && u < U1)
      out[static_cast<size_t>(t) * U1 + u] =
          live(t, u, tl, ul) ? os[k * U1s + u] : fill;
  }
}

// every cell on a diagonal >= end (all dead: end is past t_len - 1 +
// u_len): a suffix of the rows t < end, then rows end.. as one flat run
// (16-byte stores where the address allows)
__device__ __forceinline__ void fill_tail(float* out, int end, int T, int U1,
                                          float fill, int id, int nt) {
  const int lane = id & 31, w = id >> 5, nw = nt >> 5;
  for (int t = max(0, end - U1 + 1) + w; t < min(T, end); t += nw)
    for (int u = end - t + lane; u < U1; u += 32)
      out[static_cast<size_t>(t) * U1 + u] = fill;
  if (end >= T) return;
  float* p = out + static_cast<size_t>(end) * U1;
  const size_t n = static_cast<size_t>(T - end) * U1;
  size_t head = (16 - reinterpret_cast<uintptr_t>(p) % 16) % 16 / 4;
  if (head > n) head = n;
  if (static_cast<size_t>(id) < head) p[id] = fill;
  float4* v = reinterpret_cast<float4*>(p + head);
  const size_t nv = (n - head) / 4;
  const float4 f = make_float4(fill, fill, fill, fill);
  for (size_t i = id; i < nv; i += nt) v[i] = f;
  for (size_t i = head + 4 * nv + id; i < n; i += nt) p[i] = fill;
}

// Stage one input for the band of diagonals [s0 + dt + du, ... + G): the
// source cells (t, u) on the source's diagonals [s0, s0 + G) whose
// destination (t + dt, u + du) is live, into st[k * U1s + u + du]. As in
// write_band, each row t the band crosses gives a run of G adjacent cells,
// so consecutive threads copy consecutive addresses (a warp's 4-byte
// copies fall in one or two 128-byte lines). Threads `id` of `nt`.
__device__ __forceinline__ void stage_band(float* st, const float* src,
                                           int s0, int lg, int U1, int U1s,
                                           int tl, int ul, int dt, int du,
                                           int id, int nt) {
  const int k = id & ((1 << lg) - 1), step = nt >> lg;
  // rows with a live destination: t + dt < tl, u + du <= ul
  const int t_hi = min(tl - 1 - dt, s0 + (1 << lg) - 1);
  for (int t = max(0, s0 - ul + du) + (id >> lg); t <= t_hi; t += step) {
    const int u = s0 + k - t;
    if (u >= 0 && u + du <= ul)
      cp_async4(st + k * U1s + u + du, src + static_cast<size_t>(t) * U1 + u);
  }
}

// The launch plan, from U + 1 alone: C cells a lane, the compute warps,
// the helper warps, log2 of the band G, the ring's stages, the
// shared-memory bytes. nin / nout: the f32 planes staged / banded.
struct Plan {
  int cells, warps, helpers, lg, stages;
  size_t smem;
};

Plan plan_for(int U1, int nin, int nout) {
  Plan p;
  p.cells = U1 <= COMPUTE_WARPS_MAX * 64 ? 2
            : U1 <= COMPUTE_WARPS_MAX * 128 ? 4 : 8;
  p.warps = (U1 + 32 * p.cells - 1) / (32 * p.cells);
  // as many helper warps as compute warps (at least 4, at most 32 warps a
  // block; 20 at eight cells a lane, whose compute warps need more
  // registers)
  p.helpers = p.warps == 1 ? HELPERS_WARP
                           : min(max(4, p.warps), (p.cells == 8 ? 20 : 32) -
                                                      p.warps);
  const size_t plane = static_cast<size_t>(p.warps) * 32 * p.cells * 4;
  const size_t edge = 2 * p.warps * sizeof(float);
  for (p.stages = 3; p.stages >= 2; --p.stages) {
    const size_t per_diag = (p.stages * nin + 2 * nout) * plane;
    for (p.lg = MAX_BAND_LOG2; p.lg >= 0; --p.lg) {
      p.smem = (per_diag << p.lg) + edge;
      if (p.smem <= SMEM_LIMIT) return p;
    }
  }
  p.smem = 0;   // never at U1 <= MAX_STATES
  return p;
}

// One block per utterance: `nw` compute warps run the wavefront; the
// helper warps behind them stage the inputs and write the results.
// Shared memory: the input ring [stages][2][G][U1s] (blank[t-1, u],
// emit[t, u-1] at cell (t, u)), the output bands [2][G][U1s] (the band the
// compute warps fill, the one the helpers write out), the compute warps'
// edge cells [2][nw]. One barrier a band (handoff) hands both over.
template <int C, bool ONE_WARP>
__global__ void __launch_bounds__(ONE_WARP ? 32 * (1 + HELPERS_WARP)
                                           : C == 8 ? 20 * 32 : MAX_THREADS)
    rnnt_alpha_kernel(const float* __restrict__ blank,
                      const float* __restrict__ emit,
                      const int* __restrict__ t_len,
                      const int* __restrict__ u_len,
                      float* __restrict__ alphas, float* __restrict__ ll,
                      int T, int U1, int nw, int lg, int stages) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int U1s = nw * 32 * C, G = 1 << lg, plane = G * U1s;
  const int tl = min(max(t_len[b], 1), T), ul = min(max(u_len[b], 0), U1 - 1);
  const size_t off = static_cast<size_t>(b) * T * U1;
  const float* bl = blank + off;
  const float* em = emit + off;
  float* al = alphas + off;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                        // [stages][2][G][U1s]
  float* outb = ring + stages * 2 * plane;   // [2][G][U1s]
  float* edge = outb + 2 * plane;            // [2][nw]
  const int last = tl - 1 + ul;   // the diagonal of (t_len - 1, u_len)
  const int bands = (last >> lg) + 1;

  if (warp >= nw) {   // helpers
    const int id = threadIdx.x - nw * 32, nt = blockDim.x - nw * 32;
    for (int i = id; i < 2 * nw; i += nt) edge[i] = NEG;
    // band j: both sources' diagonals [jG - 1, jG + G - 1)
    auto stage = [&](int j) {
      float* st = ring + (j % stages) * 2 * plane;
      stage_band(st, bl, (j << lg) - 1, lg, U1, U1s, tl, ul, 1, 0, id, nt);
      stage_band(st + plane, em, (j << lg) - 1, lg, U1, U1s, tl, ul, 0, 1, id,
                 nt);
    };
    for (int j = 0; j < stages - 1; ++j) {
      if (j < bands) stage(j);
      cp_async_commit();
    }
    cp_async_wait(stages - 2);   // band 0
    handoff();
    for (int j = 0; j < bands; ++j) {   // while the compute warps run band j
      if (j > 0)
        write_band(al, outb + ((j - 1) & 1) * plane, (j - 1) << lg, lg, T, U1,
                   U1s, tl, ul, NEG, id, nt);
      if (j + stages - 1 < bands) stage(j + stages - 1);
      cp_async_commit();
      cp_async_wait(stages - 2);   // band j + 1
      handoff();
    }
    write_band(al, outb + ((bands - 1) & 1) * plane, (bands - 1) << lg, lg, T,
               U1, U1s, tl, ul, NEG, id, nt);
    fill_tail(al, bands << lg, T, U1, NEG, id, nt);
    return;
  }

  const int u0 = threadIdx.x * C;
  // blank[t_len - 1, u_len] for ll, loaded under the whole wavefront
  float bl_end = 0.f;
  if (ul >= u0 && ul < u0 + C)
    bl_end = bl[static_cast<size_t>(tl - 1) * U1 + ul];
  float v[C];       // this lane's cells on the previous diagonal
  unsigned lim[C];  // cell c is live on diagonals u0 + c + [0, lim)
#pragma unroll
  for (int c = 0; c < C; ++c) {
    v[c] = NEG;
    lim[c] = u0 + c <= ul ? tl : 0;
  }
  handoff();
  for (int j = 0; j < bands; ++j) {
    const float* sb = ring + (j % stages) * 2 * plane;
    float* ob = outb + (j & 1) * plane;
    const int kend = min(G, last + 1 - (j << lg));
    float cb[C], ce[C];
    load_cells<C>(sb + u0, cb);
    load_cells<C>(sb + plane + u0, ce);
    for (int k = 0; k < kend; ++k) {
      const int d = (j << lg) + k;
      // the next diagonal's inputs, loaded under this one's chain (k + 1
      // = G reads the next plane: in bounds, unused)
      float nb[C], ne[C], nv[C];
      load_cells<C>(sb + (k + 1) * U1s + u0, nb);
      load_cells<C>(sb + plane + (k + 1) * U1s + u0, ne);
      // alpha[t, u0 - 1] (lane 0 of warp 0 holds u = 0: no left term)
      float left = __shfl_up_sync(FULL, v[C - 1], 1);
      if constexpr (!ONE_WARP)
        if (lane == 0 && warp > 0) left = edge[((d + 1) & 1) * nw + warp - 1];
      const float first = d == 0 ? 0.f : NEG;   // alpha[0, 0] = 0
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int t = d - u0 - c;
        // inputs of cells that are not live were never copied; they are
        // selected away, and a dead cell's value clamped to -1e30 by fminf,
        // so no branch splits the two cells' chains
        const float a = t > 0 ? v[c] + cb[c] : NEG;
        const float e =
            u0 + c > 0 ? (c == 0 ? left : v[c - 1]) + ce[c] : NEG;
        const float cap = static_cast<unsigned>(t) < lim[c] ? KEEP : NEG;
        nv[c] = fminf(fmaxf(lse2(a, e), first), cap);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        v[c] = nv[c];
        cb[c] = nb[c];
        ce[c] = ne[c];
      }
      store_cells<C>(ob + k * U1s + u0, v);
      if constexpr (!ONE_WARP) {
        if (lane == 31) edge[(d & 1) * nw + warp] = v[C - 1];
        compute_sync(nw * 32);
      }
    }
    handoff();   // band j to the helpers, band j + 1 in
  }
#pragma unroll
  for (int c = 0; c < C; ++c)   // alpha[t_len - 1, u_len]: the last diagonal
    if (u0 + c == ul) ll[b] = v[c] + bl_end;
}

// As rnnt_alpha_kernel: the input ring [stages][3][G][U1s] (blank, emit,
// alpha at (t, u)), the output bands [2][3][G][U1s] (gb, ge, bhat), walked
// from the last band down.
template <int C, bool ONE_WARP>
__global__ void __launch_bounds__(ONE_WARP ? 32 * (1 + HELPERS_WARP)
                                           : C == 8 ? 20 * 32 : MAX_THREADS)
    rnnt_beta_grad_kernel(const float* __restrict__ blank,
                          const float* __restrict__ emit,
                          const float* __restrict__ alphas,
                          const int* __restrict__ t_len,
                          const int* __restrict__ u_len,
                          const float* __restrict__ ll,
                          float* __restrict__ gb, float* __restrict__ ge,
                          float* __restrict__ betas, int T, int U1, int nw,
                          int lg, int stages) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int U1s = nw * 32 * C, G = 1 << lg, plane = G * U1s;
  const int tl = min(max(t_len[b], 1), T), ul = min(max(u_len[b], 0), U1 - 1);
  const size_t off = static_cast<size_t>(b) * T * U1;
  const float* bl = blank + off;
  const float* em = emit + off;
  const float* al = alphas + off;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                        // [stages][3][G][U1s]
  float* outb = ring + stages * 3 * plane;   // [2][3][G][U1s]
  float* edge = outb + 6 * plane;            // [2][nw]
  const int last = tl - 1 + ul;
  const int bands = (last >> lg) + 1;   // walked from band bands - 1 down

  if (warp >= nw) {   // helpers
    const int id = threadIdx.x - nw * 32, nt = blockDim.x - nw * 32;
    float* outs[3] = {gb + off, ge + off, betas == nullptr ? nullptr
                                                           : betas + off};
    const float fills[3] = {0.f, 0.f, NEG};
    for (int i = id; i < 2 * nw; i += nt) edge[i] = NEG;
    // the s-th band walked (band bands - 1 - s) into slot s % stages
    auto stage = [&](int s) {
      float* st = ring + (s % stages) * 3 * plane;
      const int d0 = (bands - 1 - s) << lg;
      stage_band(st, bl, d0, lg, U1, U1s, tl, ul, 0, 0, id, nt);
      stage_band(st + plane, em, d0, lg, U1, U1s, tl, ul, 0, 0, id, nt);
      stage_band(st + 2 * plane, al, d0, lg, U1, U1s, tl, ul, 0, 0, id, nt);
    };
    auto write = [&](int s) {
      const float* ob = outb + (s & 1) * 3 * plane;
      for (int o = 0; o < 3; ++o)
        if (outs[o] != nullptr)
          write_band(outs[o], ob + o * plane, (bands - 1 - s) << lg, lg, T,
                     U1, U1s, tl, ul, fills[o], id, nt);
    };
    for (int s = 0; s < stages - 1; ++s) {
      if (s < bands) stage(s);
      cp_async_commit();
    }
    cp_async_wait(stages - 2);
    handoff();
    for (int s = 0; s < bands; ++s) {
      if (s > 0) write(s - 1);
      if (s + stages - 1 < bands) stage(s + stages - 1);
      cp_async_commit();
      cp_async_wait(stages - 2);
      handoff();
    }
    write(bands - 1);
    for (int o = 0; o < 3; ++o)
      if (outs[o] != nullptr)
        fill_tail(outs[o], bands << lg, T, U1, fills[o], id, nt);
    return;
  }

  const int u0 = threadIdx.x * C;
  const float llb = ll[b];
  float v[C];       // bhat on the previous (higher) diagonal
  unsigned lim[C];  // cell c is live on diagonals u0 + c + [0, lim)
  float term[C];    // the virtual terminal row bhat[t_len, u0 + c]
#pragma unroll
  for (int c = 0; c < C; ++c) {
    v[c] = NEG;
    lim[c] = u0 + c <= ul ? tl : 0;
    term[c] = u0 + c == ul ? 0.f : NEG;
  }
  handoff();
  for (int s = 0; s < bands; ++s) {
    const int j = bands - 1 - s;
    const float* sb = ring + (s % stages) * 3 * plane;
    float* ob = outb + (s & 1) * 3 * plane;
    const int ktop = min(G - 1, last - (j << lg));
    float cb[C], ce[C], ca[C];
    load_cells<C>(sb + ktop * U1s + u0, cb);
    load_cells<C>(sb + plane + ktop * U1s + u0, ce);
    load_cells<C>(sb + 2 * plane + ktop * U1s + u0, ca);
    for (int k = ktop; k >= 0; --k) {
      const int d = (j << lg) + k;
      // the next (lower) diagonal's inputs, loaded under this one's chain
      const int kn = max(k - 1, 0);
      float nb[C], ne[C], na[C], nv[C], pb[C], pe[C];
      load_cells<C>(sb + kn * U1s + u0, nb);
      load_cells<C>(sb + plane + kn * U1s + u0, ne);
      load_cells<C>(sb + 2 * plane + kn * U1s + u0, na);
      float right = __shfl_down_sync(FULL, v[0], 1);   // bhat[t, u0 + C]
      if (lane == 31) {
        right = NEG;   // past the last column
        if constexpr (!ONE_WARP)
          if (warp + 1 < nw) right = edge[((d + 1) & 1) * nw + warp + 1];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int t = d - u0 - c;
        // bhat[t + 1, u]: the virtual terminal row below t_len - 1
        const float bn = t == tl - 1 ? term[c] : v[c];
        const float r = c == C - 1 ? right : v[c + 1];   // bhat[t, u + 1]
        // computed on every lane; a dead cell's values clamped by fminf
        // (-1e30, 0), so no branch splits the two cells' chains
        const bool lv = static_cast<unsigned>(t) < lim[c];
        nv[c] = fminf(lse2(cb[c] + bn, ce[c] + r), lv ? KEEP : NEG);
        pb[c] = fminf(expf(fminf(ca[c] + cb[c] + bn - llb, 0.f)),
                      lv ? KEEP : 0.f);
        pe[c] = fminf(expf(fminf(ca[c] + ce[c] + r - llb, 0.f)),
                      lv ? KEEP : 0.f);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        v[c] = nv[c];
        cb[c] = nb[c];
        ce[c] = ne[c];
        ca[c] = na[c];
      }
      store_cells<C>(ob + k * U1s + u0, pb);
      store_cells<C>(ob + plane + k * U1s + u0, pe);
      store_cells<C>(ob + 2 * plane + k * U1s + u0, v);
      if constexpr (!ONE_WARP) {
        if (lane == 0) edge[(d & 1) * nw + warp] = v[0];
        compute_sync(nw * 32);
      }
    }
    handoff();
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int C, bool ONE_WARP>
int launch_alpha(const Plan& p, const void* blank, const void* emit,
                 const void* t_len, const void* u_len, void* alphas, void* ll,
                 int B, int T, int U1, cudaStream_t st) {
  auto kernel = rnnt_alpha_kernel<C, ONE_WARP>;
  const cudaError_t e = allow_smem(kernel, p.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<B, (p.warps + p.helpers) * 32, p.smem, st>>>(
      static_cast<const float*>(blank), static_cast<const float*>(emit),
      static_cast<const int*>(t_len), static_cast<const int*>(u_len),
      static_cast<float*>(alphas), static_cast<float*>(ll), T, U1, p.warps,
      p.lg, p.stages);
  return static_cast<int>(cudaGetLastError());
}

template <int C, bool ONE_WARP>
int launch_beta(const Plan& p, const void* blank, const void* emit,
                const void* alphas, const void* t_len, const void* u_len,
                const void* ll, void* gb, void* ge, void* betas, int B, int T,
                int U1, cudaStream_t st) {
  auto kernel = rnnt_beta_grad_kernel<C, ONE_WARP>;
  const cudaError_t e = allow_smem(kernel, p.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<B, (p.warps + p.helpers) * 32, p.smem, st>>>(
      static_cast<const float*>(blank), static_cast<const float*>(emit),
      static_cast<const float*>(alphas), static_cast<const int*>(t_len),
      static_cast<const int*>(u_len), static_cast<const float*>(ll),
      static_cast<float*>(gb), static_cast<float*>(ge),
      static_cast<float*>(betas), T, U1, p.warps, p.lg, p.stages);
  return static_cast<int>(cudaGetLastError());
}

// log(e^a + e^b) as the reference writes it: fmaxf, two expf, logf
__device__ __forceinline__ float lse2_ref(float a, float b) {
  const float m = fmaxf(a, b);
  if (m <= NEG / 2) return NEG;
  return m + logf(expf(a - m) + expf(b - m));
}

// One warp runs `steps` dependent steps of the RNN-T recursion in
// registers: a shuffle, two adds, lse2. No memory on the chain. (The CTC
// step's probe is ctc.cu's `ctc_chain_probe`.)
__global__ void chain_probe_kernel(float* out, const float* w, int steps) {
  const int lane = threadIdx.x;
  const float w0 = w[0], w1 = w[1];
  float x = -0.5f * lane;
  for (int i = 0; i < steps; ++i) {
    const float l = __shfl_up_sync(FULL, x, 1);
    x = lse2_ref(x + w0, l + w1);
  }
  out[lane] = x;
}

}  // namespace

PTT_EXPORT_ERROR_STRING

extern "C" int rnnt_max_states() { return MAX_STATES; }

// the launch plan of rnnt_alpha (beta 0) or rnnt_beta_grad (beta 1) at
// U + 1 = U1: out[0..5] = cells a lane, compute warps, helper warps, band
// diagonals, ring stages, smem bytes
extern "C" int rnnt_launch_plan(int U1, int beta, void* out) {
  if (U1 < 1 || U1 > MAX_STATES)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = beta ? plan_for(U1, 3, 3) : plan_for(U1, 2, 1);
  int* o = static_cast<int*>(out);
  o[0] = p.cells;
  o[1] = p.warps;
  o[2] = p.helpers;
  o[3] = 1 << p.lg;
  o[4] = p.stages;
  o[5] = static_cast<int>(p.smem);
  return 0;
}

// blank, emit [B, T, U1] f32, t_len and u_len [B] i32, all contiguous;
// writes alphas [B, T, U1] f32 and ll [B] f32.
extern "C" int rnnt_alpha(const void* blank, const void* emit,
                          const void* t_len, const void* u_len, void* alphas,
                          void* ll, int B, int T, int U1, void* stream) {
  if (U1 < 1 || U1 > MAX_STATES)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0 || B == 0) return 0;
  const Plan p = plan_for(U1, 2, 1);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (p.warps == 1 ? 1 : p.cells) {
    case 1: return launch_alpha<2, true>(p, blank, emit, t_len, u_len, alphas,
                                         ll, B, T, U1, st);
    case 2: return launch_alpha<2, false>(p, blank, emit, t_len, u_len, alphas,
                                          ll, B, T, U1, st);
    case 4: return launch_alpha<4, false>(p, blank, emit, t_len, u_len, alphas,
                                          ll, B, T, U1, st);
    default: return launch_alpha<8, false>(p, blank, emit, t_len, u_len,
                                           alphas, ll, B, T, U1, st);
  }
}

// the same lattices and lengths, alphas and ll from rnnt_alpha; writes gb
// and ge [B, T, U1] f32, and bhat [B, T, U1] f32 when betas is not null.
extern "C" int rnnt_beta_grad(const void* blank, const void* emit,
                              const void* alphas, const void* t_len,
                              const void* u_len, const void* ll, void* gb,
                              void* ge, void* betas, int B, int T, int U1,
                              void* stream) {
  if (U1 < 1 || U1 > MAX_STATES)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0 || B == 0) return 0;
  const Plan p = plan_for(U1, 3, 3);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (p.warps == 1 ? 1 : p.cells) {
    case 1: return launch_beta<2, true>(p, blank, emit, alphas, t_len, u_len,
                                        ll, gb, ge, betas, B, T, U1, st);
    case 2: return launch_beta<2, false>(p, blank, emit, alphas, t_len, u_len,
                                         ll, gb, ge, betas, B, T, U1, st);
    case 4: return launch_beta<4, false>(p, blank, emit, alphas, t_len, u_len,
                                         ll, gb, ge, betas, B, T, U1, st);
    default: return launch_beta<8, false>(p, blank, emit, alphas, t_len, u_len,
                                          ll, gb, ge, betas, B, T, U1, st);
  }
}

// `steps` dependent RNN-T lattice steps on one warp (terms must be 2, the
// RNN-T step); out [32] f32, w [3] f32 (the constants the chain adds).
extern "C" int rnnt_chain_probe(void* out, const void* w, int steps,
                                int terms, void* stream) {
  if (terms != 2) return static_cast<int>(cudaErrorInvalidValue);
  chain_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), static_cast<const float*>(w), steps);
  return static_cast<int>(cudaGetLastError());
}
