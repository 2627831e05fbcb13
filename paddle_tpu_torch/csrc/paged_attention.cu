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
// `rep` dot products: 4 * rep * D flops on 4 * D bytes (bf16), 1-8 flops a
// byte, far below the ~20 a byte of the f32 CUDA cores and the ~295 of the
// tensor cores. So the design is about the memory path, with no tensor
// cores; probabilities stay f32 on the CUDA cores, as in the plain version.
// Design (flash-decoding on Hopper):
// - Split over the context. The grid is (splits, kv head x query group,
//   slot); split i owns the run of `pps` table entries [i * pps, (i + 1) *
//   pps) of its slot. kernels/paged_attention.py `split_plan` takes splits
//   and pps from the shapes alone (slots, kv heads, table width), so the
//   launch needs no host sync and a CUDA graph can capture it; a block whose
//   run starts at or past ctx[s] exits at once.
// - Pages by bulk asynchronous copy. K (or V) of one head in one pool block,
//   pool[b, 0|1, h], is one contiguous bs x D tile; a stage holds `ch` rows
//   of it (ch divides bs, 2 * ch * D * sizeof(T) <= 8 KB). Each of the 4
//   warps owns 2 stages of the block's 8-stage ring (64 KB in flight, 3
//   blocks an SM): its lane 0 issues `cp.async.bulk` copies of its stage's K
//   and V rows, completing on the stage's mbarrier, and re-fills a stage as
//   soon as the warp has read it. No tensor map: a one-block launch is its
//   own cluster. Only rows below ctx are copied; table entries at or past
//   ceil(ctx / bs) are never read.
// - Every warp busy at any rep: warps take the stages in turn, lanes split
//   D in 16-byte vectors (`lpr` lanes a row, 32 / lpr rows at once, up to 4
//   vectors a lane), and each lane group keeps its own online softmax
//   (m, l, acc in f32, exp2 domain) in registers over the R query rows of
//   its group, reusing each K/V row from shared memory for all R. Query
//   heads beyond R = 8 (fewer for wide heads) go to more query groups.
// - A deterministic merge. Lane groups merge by a fixed shuffle butterfly,
//   warps in shared memory in warp order. A slot whose context fits in one
//   split writes its output directly; otherwise each live split writes f32
//   (acc, m, l) to scratch, and the last block to arrive (a per-(slot,
//   group) counter that it resets to 0) merges the splits by an online
//   softmax in split order, so two calls give the same bits.
// - ctx <= 0 gives zeros (the reference's mirror would average V over every
//   masked position); no decode path passes 0, since the engine passes
//   ctx_lens + 1.
#include "flash_sm90.cuh"

namespace {

using sm90::fence_barrier_init;
using sm90::mbar_arrive_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;

constexpr int NW = 4;                 // warps a block
constexpr int NT = NW * 32;
constexpr int SPW = 2;                // ring stages a warp owns
constexpr int STAGES = NW * SPW;
constexpr int STAGE_BYTES = 8192;     // K rows + V rows of one stage
constexpr int PPS_MAX = 256;          // table entries a block caches
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* pool;
  const int* bt;
  const int* ctx;
  void* out;
  float* part;  // acc [slots, hq, splits, D], then (m, l) [.., splits, 2]
  int* sem;     // [slots, gridDim.y] arrivals, 0 between launches
  int hq, hkv, bs, D, M, rep, qg, lpr, ch, pps, splits;
  float scale;
};

// copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory, completing them on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the warp's reads of a stage are ordered before the async proxy's writes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the lane's NC 16-byte vectors of a row (chunk c at vector c * lpr + lig),
// zeros past the row's nvec vectors
template <typename T, int NC>
__device__ __forceinline__ void load_row(const T* row, int lig, int lpr,
                                         int nvec, float (*x)[Vec16<T>::N]) {
  constexpr int VEC = Vec16<T>::N;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int v = c * lpr + lig;
    if (v < nvec) {
      load16(row + v * VEC, x[c]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) x[c][e] = 0.f;
    }
  }
}

// NC vectors a lane, R query rows a block
template <typename T, int NC, int R>
__global__ void __launch_bounds__(NT)
    paged_split_kernel(const Args a) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int TB = R >= 4 ? 2 : 8 / R;   // rows a lane group scores at once
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last_block;
  const int sp = blockIdx.x, hg = blockIdx.y, s = blockIdx.z;
  const int h = hg / a.qg, g0 = (hg - h * a.qg) * R;   // first row in head h
  const int D = a.D, nvec = D / VEC, lpr = a.lpr, rpw = 32 / lpr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane / lpr, lig = lane - grp * lpr;
  const int span = a.pps * a.bs;            // tokens a split
  const size_t row0 = static_cast<size_t>(s) * a.hq + h * a.rep + g0;
  T* out = static_cast<T*>(a.out) + row0 * D;
  const int nrow = min(R, a.rep - g0);      // live query rows of the group

  const int tok0 = sp * span;
  unsigned char* stage = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  int* pages = reinterpret_cast<int*>(full + STAGES);

  // the query rows, ctx and the run's table entries load together (a run
  // lies inside the table; entries past ctx are read but never copied from)
  float q[R][NC][VEC];
  const T* qp = static_cast<const T*>(a.q) + row0 * D;
#pragma unroll
  for (int r = 0; r < R; ++r)
    load_row<T, NC>(qp + r * D, lig, lpr, r < nrow ? nvec : 0, q[r]);
  const int c = min(a.ctx[s], a.M * a.bs);  // the table holds M * bs tokens
  const int* btr = a.bt + static_cast<size_t>(s) * a.M + sp * a.pps;
  for (int i = tid; i < min(a.pps, a.M - sp * a.pps); i += NT)
    pages[i] = btr[i];

  if (c <= 0) {                             // no context: zeros
    if (sp == 0)
      for (int i = tid; i < nrow * D; i += NT) out[i] = from_f<T>(0.f);
    return;
  }
  if (tok0 >= c) return;                    // the split lies past ctx
  const int ntok = min(c, tok0 + span) - tok0;
  const int n_live = (c + span - 1) / span;
  const int nu = (ntok + a.ch - 1) / a.ch;  // stage loads of the split
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i], 1);
    fence_barrier_init();
  }
#pragma unroll
  for (int r = 0; r < R; ++r)               // into the exp2 domain
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int e = 0; e < VEC; ++e) q[r][cc][e] *= a.scale * LOG2E;
  __syncthreads();

  const T* pool = static_cast<const T*>(a.pool);
  const size_t tile = static_cast<size_t>(a.bs) * D;
  const uint32_t vbytes = a.ch * D * sizeof(T);   // V rows' offset in a stage
  // stage load j of the split (rows [j * ch, j * ch + n) of one page) into
  // ring stage st
  auto issue = [&](int j, int st) {
    const int t = j * a.ch, n = min(a.ch, ntok - t);
    const size_t b = static_cast<size_t>(pages[t / a.bs]);
    const T* k = pool + (b * 2 * a.hkv + h) * tile +
                 static_cast<size_t>(t % a.bs) * D;
    const uint32_t bytes = n * D * sizeof(T);
    unsigned char* dst = stage + st * STAGE_BYTES;
    mbar_arrive_tx(&full[st], 2 * bytes);
    bulk_load(dst, k, bytes, &full[st]);
    bulk_load(dst + vbytes, k + a.hkv * tile, bytes, &full[st]);
  };
  if (lane == 0)
    for (int k = 0; k < SPW && warp + k * NW < nu; ++k)
      issue(warp + k * NW, warp * SPW + k);

  float m[R], l[R], acc[R][NC][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][cc][e] = 0.f;
  }

  for (int k = 0;; ++k) {
    const int j = warp + k * NW;
    if (j >= nu) break;
    const int st = warp * SPW + k % SPW;
    mbar_wait(&full[st], (k / SPW) & 1);
    const T* ks = reinterpret_cast<const T*>(stage + st * STAGE_BYTES);
    const T* vs = reinterpret_cast<const T*>(stage + st * STAGE_BYTES + vbytes);
    const int n = min(a.ch, ntok - j * a.ch);
    for (int i0 = 0; i0 < n; i0 += rpw * TB) {
      // the lane's partial dot products of TB rows, then their sums over
      // the row group, every shuffle level over all R * TB at once
      float sc[R][TB];
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        float x[NC][VEC];
        load_row<T, NC>(ks + (i0 + b * rpw + grp) * D, lig, lpr,
                        i0 + b * rpw + grp < n ? nvec : 0, x);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float d = 0.f;
#pragma unroll
          for (int cc = 0; cc < NC; ++cc)
#pragma unroll
            for (int e = 0; e < VEC; ++e) d = fmaf(q[r][cc][e], x[cc][e], d);
          sc[r][b] = d;
        }
      }
      for (int o = lpr >> 1; o > 0; o >>= 1)
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int b = 0; b < TB; ++b)
            sc[r][b] += __shfl_xor_sync(0xffffffffu, sc[r][b], o);
#pragma unroll
      for (int b = 0; b < TB; ++b)
        if (i0 + b * rpw + grp >= n)
#pragma unroll
          for (int r = 0; r < R; ++r) sc[r][b] = NEG_INF;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float mx = m[r];
#pragma unroll
        for (int b = 0; b < TB; ++b) mx = fmaxf(mx, sc[r][b]);
        const float alpha = exp2f(m[r] - mx);
        m[r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int b = 0; b < TB; ++b) {
          const float p = i0 + b * rpw + grp < n ? exp2f(sc[r][b] - mx) : 0.f;
          sc[r][b] = p;
          sum += p;
        }
        l[r] = l[r] * alpha + sum;
#pragma unroll
        for (int cc = 0; cc < NC; ++cc)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r][cc][e] *= alpha;
      }
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        const int i = i0 + b * rpw + grp;
        if (i < n) {
          float x[NC][VEC];
          load_row<T, NC>(vs + i * D, lig, lpr, nvec, x);
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int cc = 0; cc < NC; ++cc)
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                acc[r][cc][e] = fmaf(sc[r][b], x[cc][e], acc[r][cc][e]);
        }
      }
    }
    __syncwarp();
    const int jn = j + SPW * NW;
    if (lane == 0 && jn < nu) {
      fence_proxy_async();
      issue(jn, st);
    }
  }

  // lane groups of the warp, by a fixed butterfly
  for (int o = lpr; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float mx = fmaxf(m[r], mo);
      const float a0 = exp2f(m[r] - mx), a1 = exp2f(mo - mx);
      m[r] = mx;
      l[r] = l[r] * a0 + lo * a1;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[r][cc][e], o);
          acc[r][cc][e] = acc[r][cc][e] * a0 + ao * a1;
        }
    }
  }

  // warps, in warp order, through shared memory (the ring is drained)
  __syncthreads();
  float* red = reinterpret_cast<float*>(stage);   // [NW][R][D]
  float* red_m = red + NW * R * D;                // [NW][R]
  float* red_l = red_m + NW * R;                  // [NW][R]
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int v = cc * lpr + lig;
        if (v < nvec)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            red[(warp * R + r) * D + v * VEC + e] = acc[r][cc][e];
      }
      if (lane == 0) {
        red_m[warp * R + r] = m[r];
        red_l[warp * R + r] = l[r];
      }
    }
  }
  __syncthreads();
  // this block's rows of the splits' acc and (m, l)
  const size_t nsplit = static_cast<size_t>(gridDim.z) * a.hq * a.splits;
  float* pacc = a.part + row0 * a.splits * D;
  float2* pml =
      reinterpret_cast<float2*>(a.part + nsplit * D) + row0 * a.splits;
  for (int i = tid; i < nrow * D; i += NT) {
    const int r = i / D, d = i - r * D;
    float mx = NEG_INF;
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, red_m[w * R + r]);
    float lsum = 0.f, o = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float f = exp2f(red_m[w * R + r] - mx);
      lsum += red_l[w * R + r] * f;
      o += red[(w * R + r) * D + d] * f;
    }
    if (n_live == 1) {
      out[i] = from_f<T>(o / lsum);
    } else {
      pacc[(static_cast<size_t>(r) * a.splits + sp) * D + d] = o;
      if (d == 0) pml[r * a.splits + sp] = make_float2(mx, lsum);
    }
  }
  if (n_live == 1) return;

  // the last split to arrive merges all of them, in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* sem = a.sem + static_cast<size_t>(s) * gridDim.y + hg;
    const int last = atomicAdd(sem, 1) == n_live - 1;
    if (last) atomicExch(sem, 0);   // ready for the next launch
    last_block = last;
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  // an online softmax over the splits, in split order: a thread takes 4
  // columns of a row, loading their acc and (m, l) of 8 splits at once
  for (int i = tid; i < nrow * D / 4; i += NT) {
    const int r = i / (D / 4), d = (i - r * (D / 4)) * 4;
    const float* pa = pacc + static_cast<size_t>(r) * a.splits * D + d;
    const float2* pm = pml + r * a.splits;
    float mx = NEG_INF, lsum = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < n_live; k0 += 8) {
      float4 x[8];
      float2 ml[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool live = k0 + j < n_live;
        x[j] = live ? __ldcg(reinterpret_cast<const float4*>(
                          pa + static_cast<size_t>(k0 + j) * D))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
        ml[j] = live ? __ldcg(pm + k0 + j) : make_float2(NEG_INF, 0.f);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float m2 = fmaxf(mx, ml[j].x);
        const float a0 = exp2f(mx - m2), a1 = exp2f(ml[j].x - m2);
        lsum = lsum * a0 + ml[j].y * a1;
        o[0] = o[0] * a0 + x[j].x * a1;
        o[1] = o[1] * a0 + x[j].y * a1;
        o[2] = o[2] * a0 + x[j].z * a1;
        o[3] = o[3] * a0 + x[j].w * a1;
        mx = m2;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) out[r * D + d + e] = from_f<T>(o[e] / lsum);
  }
}

template <typename T, int NC, int R>
int launch(const Args& a, int slots, cudaStream_t stream) {
  constexpr int VEC = Vec16<T>::N;
  if constexpr (R * NC * VEC > 64) {
    return static_cast<int>(cudaErrorInvalidValue);   // too many registers
  } else {
    const size_t smem = STAGES * STAGE_BYTES + STAGES * sizeof(uint64_t) +
                        a.pps * sizeof(int);
    cudaError_t e = cudaFuncSetAttribute(
        paged_split_kernel<T, NC, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(a.splits, a.hkv * a.qg, slots);
    paged_split_kernel<T, NC, R><<<grid, NT, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int NC>
int launch_r(const Args& a, int R, int slots, cudaStream_t st) {
  switch (R) {
    case 1: return launch<T, NC, 1>(a, slots, st);
    case 2: return launch<T, NC, 2>(a, slots, st);
    case 4: return launch<T, NC, 4>(a, slots, st);
    case 8: return launch<T, NC, 8>(a, slots, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_nc(const Args& a, int NC, int R, int slots, cudaStream_t st) {
  switch (NC) {
    case 1: return launch_r<T, 1>(a, R, slots, st);
    case 2: return launch_r<T, 2>(a, R, slots, st);
    case 4: return launch_r<T, 4>(a, R, slots, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

PTT_EXPORT_ERROR_STRING

// q [slots, hq, D]; pool [N, 2, hkv, bs, D] (one layer); bt int32
// [slots, M]; ctx int32 [slots]; out [slots, hq, D]; part f32 [slots * hq
// * splits * (D + 2)] (acc, then (m, l); unused when splits == 1); sem
// int32 [slots, hkv * qg], zeros. The layout (kernels/paged_attention.py
// `launch_plan`): R query rows a block in qg groups a kv head, NC 16-byte
// vectors over lpr lanes a row, ch rows a stage, splits runs of pps table
// entries. D * sizeof(T) must be a multiple of 16 and q, pool 16-byte
// aligned.
extern "C" int paged_attention_fwd(const void* q, const void* pool,
                                   const void* bt, const void* ctx,
                                   void* out, void* part, void* sem,
                                   int slots, int hq, int hkv, int bs, int D,
                                   int M, int qg, int R, int NC, int lpr,
                                   int ch, int splits, int pps, float scale,
                                   int dtype, void* stream) {
  if (slots == 0) return 0;
  const int elem = dtype == PTT_BF16 ? 2 : 4;
  const int nvec = D * elem / 16;
  if ((dtype != PTT_F32 && dtype != PTT_BF16) || (D * elem) % 16 ||
      hq % hkv || lpr < 1 || lpr > 32 || (lpr & (lpr - 1)) ||
      NC * lpr < nvec || ch < 1 || bs % ch ||
      2 * ch * D * elem > STAGE_BYTES || pps < 1 || pps > PPS_MAX ||
      splits * pps < M || (splits - 1) * pps >= M ||
      qg * R < hq / hkv || (splits > 1 && (part == nullptr || sem == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, pool, static_cast<const int*>(bt),
               static_cast<const int*>(ctx), out,
               static_cast<float*>(part), static_cast<int*>(sem), hq, hkv,
               bs, D, M, hq / hkv, qg, lpr, ch, pps, splits, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == PTT_F32) return launch_nc<float>(a, NC, R, slots, st);
  return launch_nc<__nv_bfloat16>(a, NC, R, slots, st);
}
