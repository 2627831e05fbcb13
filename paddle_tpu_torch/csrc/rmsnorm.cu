// RMSNorm forward, optionally fused with a residual add.
//
// Replaces paddle_tpu/kernels/rmsnorm.py `_fwd_kernel` (pallas_call in
// `_fwd`). Computes, per row of x [rows, F]:
//   s    = x (+ r)                       (f32)
//   rstd = rsqrt(mean(s^2) + eps)        (f32, written per row)
//   out  = (s * rstd * w) cast to x's type
//   h    = s cast to x's type            (only with a residual, optional)
//
// Bound on the H100: bytes. Each element is read once or twice and
// written once with a handful of flops, far below the ~295 flop/byte the
// card needs before compute limits. Design: one thread block per row, so
// the row stays in L1 between the sum-of-squares pass and the scaling
// pass (a 4096-wide bf16 row is 8 KB) and device memory sees each input
// once; every access is a 16-byte vector; the reduction is warp shuffles
// plus one shared-memory step.
#include "common.cuh"

namespace {

template <typename T>
__global__ void rmsnorm_fwd_kernel(const T* __restrict__ x,
                                   const T* __restrict__ r,
                                   const T* __restrict__ w,
                                   T* __restrict__ out, T* __restrict__ h,
                                   float* __restrict__ rstd, int cols,
                                   float eps) {
  constexpr int VEC = Vec16<T>::N;
  __shared__ float scratch[33];
  const size_t base = static_cast<size_t>(blockIdx.x) * cols;
  const T* xr = x + base;
  const T* rr = r ? r + base : nullptr;
  const int nvec = cols / VEC;
  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float v[VEC];
    load16(xr + i * VEC, v);
    if (rr) {
      float b[VEC];
      load16(rr + i * VEC, b);
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] += b[e];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) ss += v[e] * v[e];
  }
  ss = block_sum(ss, scratch);
  const float rs = rsqrtf(ss / static_cast<float>(cols) + eps);
  if (threadIdx.x == 0) rstd[blockIdx.x] = rs;
  // second pass: the row is re-read from L1/L2, not device memory
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float v[VEC], wv[VEC], o[VEC];
    load16(xr + i * VEC, v);
    if (rr) {
      float b[VEC];
      load16(rr + i * VEC, b);
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] += b[e];
      store16(h + base + i * VEC, v);
    }
    load16(w + i * VEC, wv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) o[e] = v[e] * rs * wv[e];
    store16(out + base + i * VEC, o);
  }
}

template <typename T>
void launch(const void* x, const void* r, const void* w, void* out, void* h,
            void* rstd, int rows, int cols, float eps, cudaStream_t stream) {
  rmsnorm_fwd_kernel<T><<<rows, 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(w), static_cast<T*>(out), static_cast<T*>(h),
      static_cast<float*>(rstd), cols, eps);
}

}  // namespace

PTT_EXPORT_ERROR_STRING

// r and h may be null (no residual / sum not wanted). cols * sizeof(T) must
// be a multiple of 16 and the pointers 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int rmsnorm_fwd(const void* x, const void* r, const void* w,
                           void* out, void* h, void* rstd, int rows, int cols,
                           float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return 0;
  if (dtype == PTT_F32)
    launch<float>(x, r, w, out, h, rstd, rows, cols, eps, s);
  else if (dtype == PTT_BF16)
    launch<__nv_bfloat16>(x, r, w, out, h, rstd, rows, cols, eps, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
