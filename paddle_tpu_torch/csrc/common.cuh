// Shared helpers of the port's kernels: element types, conversions,
// reductions and the C error hook every library exports.
#pragma once

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes of the C interface (kernels/_build.py callers pass these)
enum PttDtype : int { PTT_F32 = 0, PTT_BF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch rounds
}

// 16-byte vectors: VEC<T> elements per load. The caller guarantees 16-byte
// alignment (torch allocations are 256-byte aligned; rows are multiples of
// 16 bytes long).
template <typename T>
struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
};

__device__ __forceinline__ void load16(const float* p, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store16(float* p, const float* src) {
  *reinterpret_cast<float4*>(p) = make_float4(src[0], src[1], src[2], src[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* src) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(src[2 * i], src[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the whole thread block; every thread gets the total.
// blockDim.x must be a multiple of 32. `scratch` holds 33 floats.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < nwarps ? scratch[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) scratch[32] = t;
  }
  __syncthreads();
  return scratch[32];
}

// 4-byte asynchronous copies from device to shared memory (any
// alignment), committed and waited for in groups
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies of all but its newest `pending` (0 or 1) bands
// have landed
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Tensor-core product D = A.B + D, m16n8k16, bf16 in, f32 accumulate.
// Fragment layouts are PTX's (g = lane / 4, t = lane % 4): A (16 x 16,
// row-major) a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1], a2 = A[g][2t+8,
// 2t+9], a3 = A[g+8][2t+8, 2t+9]; B (16 x 8) b0 = B[2t, 2t+1][g], b1 =
// B[2t+8, 2t+9][g], so B is read from shared memory stored as [n][k]; C
// (16 x 8) c0, c1 = C[g][2t, 2t+1] and c2, c3 = C[g+8][2t, 2t+1]. Two
// adjacent C tiles, packed to bf16 pairwise, are the A fragment of the next
// product (FlashAttention-2's register re-use).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// Attention dropout: the keep bit of score (bh = b * H + h, query i, key j)
// is a pure function of (seed, bh, i, j), shared by the flash forward, dQ
// and dK/dV kernels (and the bit dump of flash_attention.cu), so backward
// regenerates exactly the forward's mask whatever tile each kernel walks.
// h is always the QUERY head (also in the GQA dK/dV kernel). The bits are
// murmur3's 32-bit finaliser over three chained keys:
//   kbh  = fmix32(seed ^ fmix32(bh * 0x9E3779B9 + 0x7F4A7C15))
//   krow = fmix32(kbh ^ (i * 0x85EBCA77 + 0x165667B1))
//   bits = fmix32(krow + j * 0x9E3779B9)              (all mod 2^32)
// and the score is kept iff bits >= thresh, thresh = floor(p * 2^32)
// (capped at 2^32 - 1), so P(keep) = 1 - p to within 2^-32. A kernel
// computes krow once per query row and one fmix32 per score.
// kernels/flash_attention.py `dropout_bits_plain` is the same function in
// torch.int64 ops.
// ---------------------------------------------------------------------------
__host__ __device__ __forceinline__ uint32_t ptt_fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__host__ __device__ __forceinline__ uint32_t drop_row_key(uint32_t seed,
                                                          uint32_t bh,
                                                          uint32_t i) {
  const uint32_t kbh =
      ptt_fmix32(seed ^ ptt_fmix32(bh * 0x9E3779B9u + 0x7F4A7C15u));
  return ptt_fmix32(kbh ^ (i * 0x85EBCA77u + 0x165667B1u));
}

__host__ __device__ __forceinline__ uint32_t drop_bits(uint32_t krow,
                                                       uint32_t j) {
  return ptt_fmix32(krow + j * 0x9E3779B9u);
}

__device__ __forceinline__ bool drop_keep(uint32_t krow, int j,
                                          uint32_t thresh) {
  return drop_bits(krow, static_cast<uint32_t>(j)) >= thresh;
}

// x * z / (1 - p): z the keep bit of (krow, j), rp = 1 / (1 - p)
__device__ __forceinline__ float drop_apply(float x, uint32_t krow, int j,
                                            uint32_t thresh, float rp) {
  return drop_keep(krow, j, thresh) ? x * rp : 0.f;
}

// the dropout arguments every flash kernel takes (unused when p = 0). The
// seed is `seed`, or the low 32 bits of the int64 at `seed_ptr` in device
// memory where that is not null: a compiled program draws its seed on the
// card each call, and the kernels read it there without a host sync.
struct Drop {
  uint32_t seed, thresh;
  float rp;
  const long long* seed_ptr;
};

__device__ __forceinline__ uint32_t drop_seed(const Drop& d) {
  return d.seed_ptr ? static_cast<uint32_t>(*d.seed_ptr) : d.seed;
}

#define PTT_EXPORT_ERROR_STRING                                \
  extern "C" const char* ptt_error_string(int e) {               \
    return cudaGetErrorString(static_cast<cudaError_t>(e));      \
  }
