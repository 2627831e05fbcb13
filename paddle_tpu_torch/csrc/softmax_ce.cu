// Softmax cross-entropy over the last dim, forward and backward.
//
// Replaces paddle_tpu/kernels/softmax_ce.py `_fwd_kernel` (pallas_call in
// `_fwd`) and `_bwd_kernel` (pallas_call in `_core_bwd`). Per row of the
// logits x [N, V] with an integer label:
//   forward:  lse = log(sum exp(x)) in f32, loss = lse - x[label]
//   backward: dx = g * (exp(x - lse) - onehot(label)) in x's type
// Only lse ([N] f32) is kept between the two, never the [N, V] softmax.
//
// Bound on the H100: bytes. The forward reads the logits once (a
// 32000-wide bf16 row is 64 KB), the backward reads them once and writes
// dx; a few flops and one exp per element are far below the card's ratio.
// Design: one thread block per row; 16-byte loads and stores over the
// aligned body of the row, scalar ones over the head before the first
// 16-byte boundary and the tail after the last (an odd V leaves every row
// but the first misaligned); the forward keeps a running (max, sum of
// exp) per thread in f32 and merges them across the block once; it reads
// the label's logit by index. A label outside [0, V) gives a NaN loss and
// NaN gradients instead of reading out of bounds.
#include "common.cuh"

namespace {

constexpr int NT = 256;

// Block-wide (max, sum of exp) merge for an online softmax: every thread
// gets the block's (m, s) with s = sum exp(x - m). -inf m means "empty".
// `scratch` holds 66 floats.
__device__ __forceinline__ void merge_max_sum(float& m, float& s, float m2,
                                              float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // both empty
  s = (m == -INFINITY ? 0.f : s * __expf(m - mn)) +
      (m2 == -INFINITY ? 0.f : s2 * __expf(m2 - mn));
  m = mn;
}

__device__ __forceinline__ void block_max_sum(float& m, float& s,
                                              float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge_max_sum(m, s, m2, s2);
  }
  if (lane == 0) {
    scratch[warp] = m;
    scratch[32 + warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    float mm = lane < nwarps ? scratch[lane] : -INFINITY;
    float ss = lane < nwarps ? scratch[32 + lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, mm, o);
      const float s2 = __shfl_xor_sync(0xffffffffu, ss, o);
      merge_max_sum(mm, ss, m2, s2);
    }
    if (lane == 0) {
      scratch[64] = mm;
      scratch[65] = ss;
    }
  }
  __syncthreads();
  m = scratch[64];
  s = scratch[65];
}

template <typename T>
__device__ __forceinline__ int head_elems(const T* row, int V) {
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
  return min(V, ((16 - mis) & 15) / static_cast<int>(sizeof(T)));
}

__device__ __forceinline__ void online_add(float& m, float& s, float v) {
  if (v > m) {
    s = (m == -INFINITY ? 0.f : s * __expf(m - v)) + 1.f;
    m = v;
  } else {
    s += __expf(v - m);
  }
}

template <typename T, typename L>
__global__ void __launch_bounds__(NT)
    softmax_ce_fwd_kernel(const T* __restrict__ x, const L* __restrict__ lab,
                          float* __restrict__ loss, float* __restrict__ lse,
                          int V) {
  constexpr int VEC = Vec16<T>::N;
  __shared__ float scratch[66];
  const T* xr = x + static_cast<size_t>(blockIdx.x) * V;
  const int head = head_elems(xr, V);
  const int nvec = (V - head) / VEC;
  const int tail = head + nvec * VEC;
  float m = -INFINITY, s = 0.f;
  for (int i = threadIdx.x; i < head; i += NT) online_add(m, s, to_f(xr[i]));
  for (int i = threadIdx.x; i < nvec; i += NT) {
    float v[VEC];
    load16(xr + head + i * VEC, v);
    float vm = v[0];
#pragma unroll
    for (int e = 1; e < VEC; ++e) vm = fmaxf(vm, v[e]);
    const float mn = fmaxf(m, vm);
    float acc = m == -INFINITY ? 0.f : s * __expf(m - mn);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc += __expf(v[e] - mn);
    m = mn;
    s = acc;
  }
  for (int i = tail + threadIdx.x; i < V; i += NT) online_add(m, s, to_f(xr[i]));
  block_max_sum(m, s, scratch);
  if (threadIdx.x == 0) {
    const float l = m + logf(s);
    const long long y = static_cast<long long>(lab[blockIdx.x]);
    loss[blockIdx.x] = (y >= 0 && y < V) ? l - to_f(xr[y]) : NAN;
    lse[blockIdx.x] = l;
  }
}

template <typename T, typename L>
__global__ void __launch_bounds__(NT)
    softmax_ce_bwd_kernel(const T* __restrict__ x, const L* __restrict__ lab,
                          const float* __restrict__ lse,
                          const float* __restrict__ g, T* __restrict__ dx,
                          int V) {
  constexpr int VEC = Vec16<T>::N;
  const size_t base = static_cast<size_t>(blockIdx.x) * V;
  const T* xr = x + base;
  T* dr = dx + base;
  const int head = head_elems(xr, V);
  const int nvec = (V - head) / VEC;
  const int tail = head + nvec * VEC;
  const long long y = static_cast<long long>(lab[blockIdx.x]);
  const float l = lse[blockIdx.x];
  const float gr = (y >= 0 && y < V) ? g[blockIdx.x] : NAN;
  for (int i = threadIdx.x; i < head; i += NT)
    dr[i] = from_f<T>(gr * (__expf(to_f(xr[i]) - l) - (i == y ? 1.f : 0.f)));
  for (int i = threadIdx.x; i < nvec; i += NT) {
    const int c0 = head + i * VEC;
    float v[VEC];
    load16(xr + c0, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      v[e] = gr * (__expf(v[e] - l) - (c0 + e == y ? 1.f : 0.f));
    store16(dr + c0, v);
  }
  for (int i = tail + threadIdx.x; i < V; i += NT)
    dr[i] = from_f<T>(gr * (__expf(to_f(xr[i]) - l) - (i == y ? 1.f : 0.f)));
}

template <typename T, typename L>
int launch_fwd(const void* x, const void* lab, void* loss, void* lse, int N,
               int V, cudaStream_t s) {
  softmax_ce_fwd_kernel<T, L><<<N, NT, 0, s>>>(
      static_cast<const T*>(x), static_cast<const L*>(lab),
      static_cast<float*>(loss), static_cast<float*>(lse), V);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename L>
int launch_bwd(const void* x, const void* lab, const void* lse, const void* g,
               void* dx, int N, int V, cudaStream_t s) {
  softmax_ce_bwd_kernel<T, L><<<N, NT, 0, s>>>(
      static_cast<const T*>(x), static_cast<const L*>(lab),
      static_cast<const float*>(lse), static_cast<const float*>(g),
      static_cast<T*>(dx), V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

PTT_EXPORT_ERROR_STRING

// x [N, V] contiguous, f32 or bf16, 16-byte aligned at its start (rows may
// then start anywhere); labels [N] int32 (label_i64 = 0) or int64 (1);
// loss, lse [N] f32. Returns cudaGetLastError() after the launch.
extern "C" int softmax_ce_fwd(const void* x, const void* labels, void* loss,
                              void* lse, int N, int V, int dtype,
                              int label_i64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N == 0) return 0;
  if (dtype == PTT_F32)
    return label_i64 ? launch_fwd<float, long long>(x, labels, loss, lse, N, V, s)
                     : launch_fwd<float, int>(x, labels, loss, lse, N, V, s);
  if (dtype == PTT_BF16)
    return label_i64
               ? launch_fwd<__nv_bfloat16, long long>(x, labels, loss, lse, N, V, s)
               : launch_fwd<__nv_bfloat16, int>(x, labels, loss, lse, N, V, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, labels and lse as in softmax_ce_fwd; g [N] f32 (the loss's gradient);
// dx [N, V] in x's type, allocated like x (the same alignment per row).
extern "C" int softmax_ce_bwd(const void* x, const void* labels,
                              const void* lse, const void* g, void* dx, int N,
                              int V, int dtype, int label_i64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N == 0) return 0;
  if (dtype == PTT_F32)
    return label_i64
               ? launch_bwd<float, long long>(x, labels, lse, g, dx, N, V, s)
               : launch_bwd<float, int>(x, labels, lse, g, dx, N, V, s);
  if (dtype == PTT_BF16)
    return label_i64
               ? launch_bwd<__nv_bfloat16, long long>(x, labels, lse, g, dx, N, V, s)
               : launch_bwd<__nv_bfloat16, int>(x, labels, lse, g, dx, N, V, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
