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
// Design for this card. The TPU kernel removes the u-dependence of a time
// row analytically (alpha[t] = E + logcumsumexp(base - E), an O(log U)
// lane scan over 128-lane rows, 8 utterances on sublanes). Here the
// lattice runs as an anti-diagonal wavefront instead:
// - one thread block per utterance, threads over u (strided, up to
//   MAX_PER_THREAD positions a thread, so any U + 1 <= MAX_STATES);
// - at diagonal d = t + u, position u combines its own previous value
//   (alpha[t-1, u], in a register) with its left neighbour's (alpha[t, u-1],
//   from the previous diagonal, double-buffered in shared memory); one
//   __syncthreads a diagonal, t_len + u_len diagonals;
// - one exp/log pair a cell, and no large exclusive emit sum E to cancel
//   against base in f32;
// - the next diagonal's inputs are prefetched into registers while the
//   current one computes; the beta kernel runs the mirrored wavefront from
//   (t_len - 1, u_len) and writes gb and ge as it goes (and bhat itself
//   when asked, for the checks).
//
// Bound on the H100: neither bytes nor flops. t_len + u_len dependent
// steps, each a shared-memory exchange and an exp/log pair, on B thread
// blocks (16 of 132 SMs at the Conformer's batch): latency times steps.
#include "common.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr int MAX_THREADS = 1024, MAX_PER_THREAD = 4;
constexpr int MAX_STATES = MAX_THREADS * MAX_PER_THREAD;

// log(e^a + e^b), -1e30 when the larger term is below -5e29 (the
// reference's `_lse2`)
__device__ __forceinline__ float lse2(float a, float b) {
  const float m = fmaxf(a, b);
  if (m <= NEG / 2) return NEG;
  return m + logf(expf(a - m) + expf(b - m));
}

// the cells outside t < tl, u <= ul get `fill` (the live ones are written
// by the wavefront, so no two threads write one cell)
__device__ __forceinline__ void fill_dead(float* out, int T, int U1, int tl,
                                          int ul, float fill) {
  const size_t n = static_cast<size_t>(T) * U1;
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) {
    const int t = static_cast<int>(i / U1), u = static_cast<int>(i % U1);
    if (t >= tl || u > ul) out[i] = fill;
  }
}

__device__ __forceinline__ bool live(int t, int u, int tl, int ul) {
  return t >= 0 && t < tl && u <= ul;
}

__global__ void __launch_bounds__(MAX_THREADS)
    rnnt_alpha_kernel(const float* __restrict__ blank,
                      const float* __restrict__ emit,
                      const int* __restrict__ t_len,
                      const int* __restrict__ u_len,
                      float* __restrict__ alphas, float* __restrict__ ll,
                      int T, int U1) {
  const int b = blockIdx.x, nt = blockDim.x;
  const int tl = min(max(t_len[b], 1), T), ul = min(max(u_len[b], 0), U1 - 1);
  const size_t off = static_cast<size_t>(b) * T * U1;
  const float* bl = blank + off;
  const float* em = emit + off;
  float* al = alphas + off;
  extern __shared__ __align__(16) float diag[];   // [2, U1]
  fill_dead(al, T, U1, tl, ul, NEG);
  for (int i = threadIdx.x; i < 2 * U1; i += nt) diag[i] = NEG;
  __syncthreads();

  const int last = tl - 1 + ul;   // the diagonal of (t_len - 1, u_len)
  float prev[MAX_PER_THREAD], nb[MAX_PER_THREAD], ne[MAX_PER_THREAD];
#pragma unroll
  for (int k = 0; k < MAX_PER_THREAD; ++k) {
    prev[k] = NEG;   // alpha[t - 1, u]: this column's last value
    nb[k] = ne[k] = 0.f;   // diagonal 0 holds (0, 0) alone: no inputs
  }
  for (int d = 0; d <= last; ++d) {
    float cb[MAX_PER_THREAD], ce[MAX_PER_THREAD];
#pragma unroll
    for (int k = 0; k < MAX_PER_THREAD; ++k) {
      cb[k] = nb[k];
      ce[k] = ne[k];
    }
    if (d < last) {   // the next diagonal's inputs, loaded under this one
#pragma unroll
      for (int k = 0; k < MAX_PER_THREAD; ++k) {
        const int u = threadIdx.x + k * nt, t = d + 1 - u;
        if (u < U1 && live(t, u, tl, ul)) {
          nb[k] = t > 0 ? bl[static_cast<size_t>(t - 1) * U1 + u] : 0.f;
          ne[k] = u > 0 ? em[static_cast<size_t>(t) * U1 + u - 1] : 0.f;
        }
      }
    }
    const float* left = diag + ((d + 1) & 1) * U1;   // diagonal d - 1
    float* cur = diag + (d & 1) * U1;
#pragma unroll
    for (int k = 0; k < MAX_PER_THREAD; ++k) {
      const int u = threadIdx.x + k * nt, t = d - u;
      if (u >= U1) break;
      float v = NEG;
      if (live(t, u, tl, ul)) {
        if (t == 0 && u == 0) {
          v = 0.f;
        } else {
          const float a = t > 0 ? prev[k] + cb[k] : NEG;
          const float e = u > 0 ? left[u - 1] + ce[k] : NEG;
          v = lse2(a, e);
        }
        al[static_cast<size_t>(t) * U1 + u] = v;
      }
      prev[k] = v;
      cur[u] = v;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0)   // alpha[t_len - 1, u_len] is on the last diagonal
    ll[b] = diag[(last & 1) * U1 + ul] +
            bl[static_cast<size_t>(tl - 1) * U1 + ul];
}

__global__ void __launch_bounds__(MAX_THREADS)
    rnnt_beta_grad_kernel(const float* __restrict__ blank,
                          const float* __restrict__ emit,
                          const float* __restrict__ alphas,
                          const int* __restrict__ t_len,
                          const int* __restrict__ u_len,
                          const float* __restrict__ ll,
                          float* __restrict__ gb, float* __restrict__ ge,
                          float* __restrict__ betas, int T, int U1) {
  const int b = blockIdx.x, nt = blockDim.x;
  const int tl = min(max(t_len[b], 1), T), ul = min(max(u_len[b], 0), U1 - 1);
  const size_t off = static_cast<size_t>(b) * T * U1;
  const float* bl = blank + off;
  const float* em = emit + off;
  const float* al = alphas + off;
  float* gbo = gb + off;
  float* geo = ge + off;
  float* bo = betas == nullptr ? nullptr : betas + off;
  extern __shared__ __align__(16) float diag[];   // [2, U1]
  fill_dead(gbo, T, U1, tl, ul, 0.f);
  fill_dead(geo, T, U1, tl, ul, 0.f);
  if (bo != nullptr) fill_dead(bo, T, U1, tl, ul, NEG);
  for (int i = threadIdx.x; i < 2 * U1; i += nt) diag[i] = NEG;
  __syncthreads();

  const int last = tl - 1 + ul;
  const float llb = ll[b];
  float nxt[MAX_PER_THREAD];   // bhat[t + 1, u]: this column's last value
  float nb[MAX_PER_THREAD], ne[MAX_PER_THREAD], na[MAX_PER_THREAD];
#pragma unroll
  for (int k = 0; k < MAX_PER_THREAD; ++k) {
    nxt[k] = NEG;
    nb[k] = ne[k] = na[k] = 0.f;
    const int u = threadIdx.x + k * nt, t = last - u;
    if (u < U1 && live(t, u, tl, ul)) {
      const size_t i = static_cast<size_t>(t) * U1 + u;
      nb[k] = bl[i];
      ne[k] = em[i];
      na[k] = al[i];
    }
  }
  for (int d = last; d >= 0; --d) {
    float cb[MAX_PER_THREAD], ce[MAX_PER_THREAD], ca[MAX_PER_THREAD];
#pragma unroll
    for (int k = 0; k < MAX_PER_THREAD; ++k) {
      cb[k] = nb[k];
      ce[k] = ne[k];
      ca[k] = na[k];
    }
    if (d > 0) {
#pragma unroll
      for (int k = 0; k < MAX_PER_THREAD; ++k) {
        const int u = threadIdx.x + k * nt, t = d - 1 - u;
        if (u < U1 && live(t, u, tl, ul)) {
          const size_t i = static_cast<size_t>(t) * U1 + u;
          nb[k] = bl[i];
          ne[k] = em[i];
          na[k] = al[i];
        }
      }
    }
    const float* right = diag + ((d + 1) & 1) * U1;   // diagonal d + 1
    float* cur = diag + (d & 1) * U1;
#pragma unroll
    for (int k = 0; k < MAX_PER_THREAD; ++k) {
      const int u = threadIdx.x + k * nt, t = d - u;
      if (u >= U1) break;
      float v = NEG;
      if (live(t, u, tl, ul)) {
        // bhat[t + 1, u]: the virtual terminal row below t_len - 1
        const float bn = t == tl - 1 ? (u == ul ? 0.f : NEG) : nxt[k];
        const float r = u + 1 < U1 ? right[u + 1] : NEG;   // bhat[t, u + 1]
        v = lse2(cb[k] + bn, ce[k] + r);
        const size_t i = static_cast<size_t>(t) * U1 + u;
        gbo[i] = expf(fminf(ca[k] + cb[k] + bn - llb, 0.f));
        geo[i] = expf(fminf(ca[k] + ce[k] + r - llb, 0.f));
        if (bo != nullptr) bo[i] = v;
      }
      nxt[k] = v;
      cur[u] = v;
    }
    __syncthreads();
  }
}

int threads_for(int U1) { return min(MAX_THREADS, (U1 + 31) / 32 * 32); }

size_t smem_bytes(int U1) {
  return 2 * static_cast<size_t>(U1) * sizeof(float);
}

}  // namespace

PTT_EXPORT_ERROR_STRING

extern "C" int rnnt_max_states() { return MAX_STATES; }

// blank, emit [B, T, U1] f32, t_len and u_len [B] i32, all contiguous;
// writes alphas [B, T, U1] f32 and ll [B] f32.
extern "C" int rnnt_alpha(const void* blank, const void* emit,
                          const void* t_len, const void* u_len, void* alphas,
                          void* ll, int B, int T, int U1, void* stream) {
  if (U1 < 1 || U1 > MAX_STATES)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0 || B == 0) return 0;
  rnnt_alpha_kernel<<<B, threads_for(U1), smem_bytes(U1),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blank), static_cast<const float*>(emit),
      static_cast<const int*>(t_len), static_cast<const int*>(u_len),
      static_cast<float*>(alphas), static_cast<float*>(ll), T, U1);
  return static_cast<int>(cudaGetLastError());
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
  rnnt_beta_grad_kernel<<<B, threads_for(U1), smem_bytes(U1),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blank), static_cast<const float*>(emit),
      static_cast<const float*>(alphas), static_cast<const int*>(t_len),
      static_cast<const int*>(u_len), static_cast<const float*>(ll),
      static_cast<float*>(gb), static_cast<float*>(ge),
      static_cast<float*>(betas), T, U1);
  return static_cast<int>(cudaGetLastError());
}
