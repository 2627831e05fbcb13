// RMSNorm forward and backward, optionally fused with a residual add.
//
// Forward: replaces paddle_tpu/kernels/rmsnorm.py `_fwd_kernel`
// (pallas_call in `_fwd`). Computes, per row of x [rows, F]:
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
//
// Backward: replaces `_bwd_kernel` (pallas_call in `_core_bwd`). From the
// saved rstd and the output gradient g, per row:
//   dx = rstd * g*w - s * rstd^3 * mean(s * g*w)   (x's type; = dresid)
// and dw = sum over rows of s * rstd * g. Bound: bytes (read x, g, and r
// with a residual; write dx). One thread block owns a chunk of rows: it
// walks them one at a time (a block-wide sum for mean(s*g*w), then the dx
// pass, which re-reads the row from L1), and keeps its dw partial for
// every column in shared memory (each thread owns fixed columns, so no
// atomics). The chunk's partial row goes to dw_part[chunk, F]; the caller
// sums the partials in a fixed order, as the reference sums its per-block
// partials outside the kernel, so two runs give the same bits.
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

template <typename T>
__global__ void rmsnorm_bwd_kernel(const T* __restrict__ x,
                                   const T* __restrict__ r,
                                   const T* __restrict__ w,
                                   const float* __restrict__ rstd,
                                   const T* __restrict__ g,
                                   T* __restrict__ dx,
                                   float* __restrict__ dw_part, int rows,
                                   int cols, int rows_per_block) {
  constexpr int VEC = Vec16<T>::N;
  extern __shared__ float bwd_smem[];
  float* dwp = bwd_smem;             // [cols] this chunk's dw partial
  float* scratch = bwd_smem + cols;  // [33] block_sum
  const int nvec = cols / VEC;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x)
#pragma unroll
    for (int e = 0; e < VEC; ++e) dwp[i * VEC + e] = 0.f;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  const float inv_cols = 1.f / static_cast<float>(cols);
  for (int row = r0; row < r1; ++row) {
    const size_t base = static_cast<size_t>(row) * cols;
    const float rs = rstd[row];
    float dot = 0.f;
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      float v[VEC], gv[VEC], wv[VEC];
      load16(x + base + i * VEC, v);
      if (r) {
        float b[VEC];
        load16(r + base + i * VEC, b);
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[e] += b[e];
      }
      load16(g + base + i * VEC, gv);
      load16(w + i * VEC, wv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) dot += v[e] * (gv[e] * wv[e]);
    }
    dot = block_sum(dot, scratch) * inv_cols;
    const float c3 = rs * rs * rs * dot;
    // second pass: the row is re-read from L1/L2, not device memory
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      float v[VEC], gv[VEC], wv[VEC], o[VEC];
      load16(x + base + i * VEC, v);
      if (r) {
        float b[VEC];
        load16(r + base + i * VEC, b);
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[e] += b[e];
      }
      load16(g + base + i * VEC, gv);
      load16(w + i * VEC, wv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        o[e] = rs * (gv[e] * wv[e]) - v[e] * c3;
        dwp[i * VEC + e] += v[e] * rs * gv[e];
      }
      store16(dx + base + i * VEC, o);
    }
  }
  // each thread writes the columns it owns (4 f32 per 16-byte store)
  float* out = dw_part + static_cast<size_t>(blockIdx.x) * cols;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x)
#pragma unroll
    for (int e = 0; e < VEC; e += 4) store16(out + i * VEC + e, dwp + i * VEC + e);
}

template <typename T>
int launch_bwd(const void* x, const void* r, const void* w, const void* rstd,
               const void* g, void* dx, void* dw_part, int rows, int cols,
               int rows_per_block, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (cols + 33);
  cudaError_t e = cudaFuncSetAttribute(
      rmsnorm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  rmsnorm_bwd_kernel<T><<<blocks, 256, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(w), static_cast<const float*>(rstd),
      static_cast<const T*>(g), static_cast<T*>(dx),
      static_cast<float*>(dw_part), rows, cols, rows_per_block);
  return static_cast<int>(cudaGetLastError());
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

// r may be null (no residual). dw_part is [ceil(rows / rows_per_block),
// cols] f32, every row of it written. Same size and alignment rules as
// rmsnorm_fwd; cols * 4 + 132 bytes of shared memory must fit (cols up to
// ~58000).
extern "C" int rmsnorm_bwd(const void* x, const void* r, const void* w,
                           const void* rstd, const void* g, void* dx,
                           void* dw_part, int rows, int cols,
                           int rows_per_block, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return 0;
  if (rows_per_block < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == PTT_F32)
    return launch_bwd<float>(x, r, w, rstd, g, dx, dw_part, rows, cols,
                             rows_per_block, s);
  if (dtype == PTT_BF16)
    return launch_bwd<__nv_bfloat16>(x, r, w, rstd, g, dx, dw_part, rows,
                                     cols, rows_per_block, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
