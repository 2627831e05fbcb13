// Ragged paged attention for decode: one query token per slot, K/V
// gathered through the slot's block table.
//
// Replaces paddle_tpu/kernels/paged_attention.py `_paged_kernel`
// (pallas_call in `paged_attention_pallas`). For slot s and query head
// hq (kv head h = hq / rep):
//   out[s, hq] = softmax(q[s, hq] . K[s, :ctx[s]]^T * scale) . V[s, :ctx[s]]
// where token t of slot s lives in pool block bt[s, t / bs] at row t % bs.
//
// Bound on the H100: bytes. Every live K/V row is read once and used for
// `rep` dot products, so at rep <= 8 the work is a few flops per byte.
// Design (a first, simple kernel):
// - one thread block of 256 threads per (slot, kv head); the TPU grid
//   carried the softmax state across its sequential block axis, which a GPU
//   grid cannot do, so the loop over the context lives inside the thread
//   block;
// - each step of that loop covers 64 tokens (several KV blocks): the block
//   reads the table entries itself (no scalar prefetch), loads the tokens'
//   K and V rows with 16-byte vector loads into shared memory as f32, scores
//   all `rep` query rows of its kv head against them (one warp per dot
//   product), updates the online-softmax state (m, l, acc) in f32 (one warp
//   per query row) and accumulates P.V;
// - only tokens below ctx are read; the rest of the last step is masked to
//   -1e30, as in the reference.
// Split-K over the context (flash-decoding), to fill the card when
// slots * kv_heads is below the SM count, is later work.
#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TOK = 64;   // tokens per step of the context loop
constexpr int NT = 256;   // threads per block

size_t smem_floats(int rep, int D) {
  return 2 * rep * D + 2 * TOK * (D + 1) + rep * TOK + 3 * rep;
}

template <typename T>
__global__ void __launch_bounds__(NT)
    paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ pool,
                           const int* __restrict__ bt,
                           const int* __restrict__ ctx, T* __restrict__ out,
                           int hq, int hkv, int bs, int D, int max_blocks,
                           float scale) {
  constexpr int VEC = Vec16<T>::N;
  extern __shared__ float smem[];
  const int s = blockIdx.x, h = blockIdx.y;
  const int rep = hq / hkv, LD = D + 1;
  float* q_s = smem;                // [rep, D]
  float* acc = q_s + rep * D;       // [rep, D]
  float* k_s = acc + rep * D;       // [TOK, LD]
  float* v_s = k_s + TOK * LD;      // [TOK, LD]
  float* sc = v_s + TOK * LD;       // [rep, TOK] scores, then probabilities
  float* m_s = sc + rep * TOK;      // [rep] running max
  float* l_s = m_s + rep;           // [rep] running sum
  float* a_s = l_s + rep;           // [rep] rescale of this step
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = NT >> 5;
  const int c = ctx[s];

  const T* qp = q + (static_cast<size_t>(s) * hq + static_cast<size_t>(h) * rep) * D;
  for (int i = tid; i < rep * D; i += NT) {
    q_s[i] = to_f(qp[i]) * scale;
    acc[i] = 0.f;
  }
  for (int r = tid; r < rep; r += NT) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  const int* btr = bt + static_cast<size_t>(s) * max_blocks;
  const size_t blk_elems = static_cast<size_t>(bs) * D;
  const int vpr = D / VEC;          // vectors per K/V row
  for (int c0 = 0; c0 < c; c0 += TOK) {
    __syncthreads();  // q_s ready / last step's k_s, v_s, sc consumed
    for (int i = tid; i < TOK * vpr; i += NT) {
      const int t = i / vpr, part = i - t * vpr, tok = c0 + t;
      float kv[VEC], vv[VEC];
      if (tok < c) {
        const size_t b = static_cast<size_t>(btr[tok / bs]);
        const size_t row = static_cast<size_t>(tok % bs) * D + part * VEC;
        load16(pool + ((b * 2 + 0) * hkv + h) * blk_elems + row, kv);
        load16(pool + ((b * 2 + 1) * hkv + h) * blk_elems + row, vv);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kv[e] = vv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        k_s[t * LD + part * VEC + e] = kv[e];
        v_s[t * LD + part * VEC + e] = vv[e];
      }
    }
    __syncthreads();
    for (int p = warp; p < rep * TOK; p += nw) {
      const int r = p / TOK, t = p - r * TOK;
      float d = 0.f;
      for (int e = lane; e < D; e += 32) d += q_s[r * D + e] * k_s[t * LD + e];
      d = warp_sum(d);
      if (lane == 0) sc[p] = (c0 + t < c) ? d : NEG_INF;
    }
    __syncthreads();
    for (int r = warp; r < rep; r += nw) {
      const float s0 = sc[r * TOK + lane], s1 = sc[r * TOK + lane + 32];
      const float m_prev = m_s[r], l_prev = l_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      sc[r * TOK + lane] = p0;
      sc[r * TOK + lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        m_s[r] = m_new;
        l_s[r] = alpha * l_prev + sum;
      }
    }
    __syncthreads();
    for (int i = tid; i < rep * D; i += NT) {
      const int r = i / D, e = i - r * D;
      const float* pr = sc + r * TOK;
      float a = acc[i] * a_s[r];
#pragma unroll 8
      for (int t = 0; t < TOK; ++t) a += pr[t] * v_s[t * LD + e];
      acc[i] = a;
    }
  }
  __syncthreads();

  T* op = out + (static_cast<size_t>(s) * hq + static_cast<size_t>(h) * rep) * D;
  for (int i = tid; i < rep * D; i += NT)
    op[i] = from_f<T>(acc[i] / fmaxf(l_s[i / D], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* pool, const int* bt, const int* ctx,
           void* out, int slots, int hq, int hkv, int bs, int D,
           int max_blocks, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(hq / hkv, D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(slots, hkv);
  paged_attention_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool), bt, ctx,
      static_cast<T*>(out), hq, hkv, bs, D, max_blocks, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

PTT_EXPORT_ERROR_STRING

// q [slots, hq, D]; pool [N, 2, hkv, bs, D] (one layer); bt int32
// [slots, max_blocks]; ctx int32 [slots]; out [slots, hq, D]. D * sizeof(T)
// must be a multiple of 16 and the pointers 16-byte aligned.
extern "C" int paged_attention_fwd(const void* q, const void* pool,
                                   const void* bt, const void* ctx,
                                   void* out, int slots, int hq, int hkv,
                                   int bs, int D, int max_blocks, float scale,
                                   int dtype, void* stream) {
  if (slots == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* b = static_cast<const int*>(bt);
  const int* c = static_cast<const int*>(ctx);
  if (dtype == PTT_F32)
    return launch<float>(q, pool, b, c, out, slots, hq, hkv, bs, D,
                         max_blocks, scale, st);
  if (dtype == PTT_BF16)
    return launch<__nv_bfloat16>(q, pool, b, c, out, slots, hq, hkv, bs, D,
                                 max_blocks, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
