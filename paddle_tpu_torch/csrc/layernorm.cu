// LayerNorm forward over the last dim, with mean and rstd per row.
//
// Replaces paddle_tpu/kernels/layernorm.py `_fwd_kernel` (pallas_call in
// `_fwd`). Per row of x [rows, F], in f32:
//   mean = sum(x) / F
//   var  = sum((x - mean)^2) / F          (two passes, as the reference)
//   rstd = rsqrt(var + eps)
//   out  = (x - mean) * rstd * w + b      (cast to out's type)
// and mean, rstd are written as f32 [rows]. x is f32 or bf16; w and b share
// one type, f32 or bf16; out's type is the promotion of x's and w's (bf16
// only when both are), as the reference promotes xn * w + b. The backward
// is a PyTorch composition over the saved mean and rstd
// (kernels/layernorm.py), as the reference's is jnp.
//
// Bound on the H100: bytes. A few flops per element against 2-8 bytes
// moved; at [8192, 768] f32 the least time is 50.3 MB over 3.35 TB/s. So
// device memory must see x once and out once: one thread block per row
// holds the row in registers (K chunks of VEC elements per thread) through
// both reductions and the output pass. Each chunk is one 16-byte load when
// the row, w, b and out are 16-byte aligned and F is a multiple of VEC
// (16 / sizeof(x)); otherwise the scalar instantiation (VEC = 1) reads one
// element at a time. The reductions are warp shuffles plus one
// shared-memory step (block_sum).
#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 1024;

// N consecutive elements to f32 (N a multiple of 4; 8-byte bf16 loads for
// N = 4, 16-byte loads otherwise), and back.
template <int N>
__device__ __forceinline__ void loadv(const float* p, float* d) {
  if constexpr (N == 1) {
    d[0] = p[0];
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) load16(p + i, d + i);
  }
}

template <int N>
__device__ __forceinline__ void loadv(const __nv_bfloat16* p, float* d) {
  if constexpr (N == 1) {
    d[0] = __bfloat162float(p[0]);
  } else if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    d[0] = a.x;
    d[1] = a.y;
    d[2] = b.x;
    d[3] = b.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 8) load16(p + i, d + i);
  }
}

template <int N>
__device__ __forceinline__ void storev(float* p, const float* s) {
  if constexpr (N == 1) {
    p[0] = s[0];
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) store16(p + i, s + i);
  }
}

template <int N>
__device__ __forceinline__ void storev(__nv_bfloat16* p, const float* s) {
  if constexpr (N == 1) {
    p[0] = __float2bfloat16(s[0]);
  } else {
    static_assert(N % 8 == 0, "bf16 output chunks are 16-byte stores");
#pragma unroll
    for (int i = 0; i < N; i += 8) store16(p + i, s + i);
  }
}

// One thread block per row; thread t owns chunks t, t + blockDim, ...
// (K of them) of VEC elements each.
template <typename T, typename W, typename O, int VEC, int K>
__global__ void layernorm_fwd_kernel(const T* __restrict__ x,
                                     const W* __restrict__ w,
                                     const W* __restrict__ b,
                                     O* __restrict__ out,
                                     float* __restrict__ mean,
                                     float* __restrict__ rstd, int cols,
                                     float eps) {
  __shared__ float scratch[33];
  const size_t base = static_cast<size_t>(blockIdx.x) * cols;
  const T* xr = x + base;
  float v[K][VEC];
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const int col = (threadIdx.x + c * blockDim.x) * VEC;
    if (col < cols) {
      loadv<VEC>(xr + col, v[c]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) s += v[c][e];
    }
  }
  const float inv_cols = 1.f / static_cast<float>(cols);
  const float mu = block_sum(s, scratch) * inv_cols;
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const int col = (threadIdx.x + c * blockDim.x) * VEC;
    if (col < cols) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = v[c][e] - mu;
        ss += d * d;
      }
    }
  }
  const float rs = rsqrtf(block_sum(ss, scratch) * inv_cols + eps);
  if (threadIdx.x == 0) {
    mean[blockIdx.x] = mu;
    rstd[blockIdx.x] = rs;
  }
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const int col = (threadIdx.x + c * blockDim.x) * VEC;
    if (col < cols) {
      float wv[VEC], bv[VEC], o[VEC];
      loadv<VEC>(w + col, wv);
      loadv<VEC>(b + col, bv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[e] = (v[c][e] - mu) * rs * wv[e] + bv[e];
      storev<VEC>(out + base + col, o);
    }
  }
}

template <typename T, typename W, typename O, int VEC>
int launch(const void* x, const void* w, const void* b, void* out,
           void* mean, void* rstd, int rows, int cols, float eps,
           cudaStream_t st) {
  const int chunks = (cols + VEC - 1) / VEC;
  int k = 1;
  while (k < 8 && (chunks + k - 1) / k > MAX_THREADS) k *= 2;
  const int per = (chunks + k - 1) / k;
  if (per > MAX_THREADS) return static_cast<int>(cudaErrorInvalidValue);
  const int nt = (per + 31) / 32 * 32;
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  const W* bp = static_cast<const W*>(b);
  O* op = static_cast<O*>(out);
  float* mp = static_cast<float*>(mean);
  float* rp = static_cast<float*>(rstd);
  switch (k) {
    case 1:
      layernorm_fwd_kernel<T, W, O, VEC, 1>
          <<<rows, nt, 0, st>>>(xp, wp, bp, op, mp, rp, cols, eps);
      break;
    case 2:
      layernorm_fwd_kernel<T, W, O, VEC, 2>
          <<<rows, nt, 0, st>>>(xp, wp, bp, op, mp, rp, cols, eps);
      break;
    case 4:
      layernorm_fwd_kernel<T, W, O, VEC, 4>
          <<<rows, nt, 0, st>>>(xp, wp, bp, op, mp, rp, cols, eps);
      break;
    default:
      layernorm_fwd_kernel<T, W, O, VEC, 8>
          <<<rows, nt, 0, st>>>(xp, wp, bp, op, mp, rp, cols, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// the vector or the scalar instantiation of one (x, w, out) type triple
template <typename T, typename W, typename O>
int launch_path(int vec, const void* x, const void* w, const void* b,
                void* out, void* mean, void* rstd, int rows, int cols,
                float eps, cudaStream_t st) {
  if (vec)
    return launch<T, W, O, Vec16<T>::N>(x, w, b, out, mean, rstd, rows,
                                        cols, eps, st);
  return launch<T, W, O, 1>(x, w, b, out, mean, rstd, rows, cols, eps, st);
}

}  // namespace

PTT_EXPORT_ERROR_STRING

// x [rows, cols] (dtype code xdtype), w and b [cols] (wdtype), out
// [rows, cols] f32 unless both are bf16, mean and rstd [rows] f32; all
// contiguous. vec != 0 takes the 16-byte path: the caller guarantees that
// cols is a multiple of 16 / sizeof(x) and that x, w, b and out are 16-byte
// aligned. Rows up to 8 * 1024 chunks (32768 f32 or 65536 bf16 elements on
// the vector path, 8192 on the scalar path).
extern "C" int layernorm_fwd(const void* x, const void* w, const void* b,
                             void* out, void* mean, void* rstd, int rows,
                             int cols, float eps, int xdtype, int wdtype,
                             int vec, void* stream) {
  if (rows == 0) return 0;
  if (cols == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (xdtype == PTT_F32 && wdtype == PTT_F32)
    return launch_path<float, float, float>(vec, x, w, b, out, mean, rstd,
                                            rows, cols, eps, st);
  if (xdtype == PTT_F32 && wdtype == PTT_BF16)
    return launch_path<float, bf, float>(vec, x, w, b, out, mean, rstd,
                                         rows, cols, eps, st);
  if (xdtype == PTT_BF16 && wdtype == PTT_F32)
    return launch_path<bf, float, float>(vec, x, w, b, out, mean, rstd,
                                         rows, cols, eps, st);
  if (xdtype == PTT_BF16 && wdtype == PTT_BF16)
    return launch_path<bf, bf, bf>(vec, x, w, b, out, mean, rstd, rows,
                                   cols, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
