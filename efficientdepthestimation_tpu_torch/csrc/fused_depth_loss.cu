// Fused Sobel + 4-term depth loss: per-image sums (forward) and dL/dpred
// (backward), each one kernel launch that needs no scratch memory.
//
// Replaces the Pallas kernel efficientdepthestimation_tpu/ops/pallas/
// fused_loss.py:126 `fused_depth_loss` (forward body `_loss_kernel`,
// :69-93; custom VJP `_bwd`, :146-189, which JAX runs as XLA). For pred and
// target (N, H, W), gx/gy their zero-padded 3x3 Sobel gradients, per image:
//
//     sums[n] = ( sum log(|p - t| + 0.5),
//                 sum log(|gx_p - gx_t| + 0.5),
//                 sum log(|gy_p - gy_t| + 0.5),
//                 sum |1 - cos(n_p, n_t)| ),     n = (-gx, -gy, 1)
//
// The masked mean over num_valid images and the total stay in PyTorch, as
// they stay in XLA in the JAX package (fused_loss.py:111-115). The
// backward writes
//
//     dp = (d_depth + corr(A, kx_flip) + corr(B, ky_flip)) * mask[n] * coef
//
// with A = ddx + dn/dgx, B = ddy + dn/dgy (factors of fused_loss.py:156-
// 172), zero outside the image (the correlation's zero padding), and coef
// = g / (sum(mask) * H * W) read from device memory.
//
// What bounds it on the H100. At the training shape (64, 114, 152) with
// bf16 pred and f32 target the forward must read 6 bytes a pixel and the
// backward read 6 and write 2: 6.65 MB and 8.87 MB, 1.99 us and 2.65 us
// at 3.35 TB/s. Counted in the SASS of the per-pixel loops (cuobjdump
// -sass of the built library; chip_smoke.py phase 1 recounts them and
// fails if they change),
// the forward does 4 MUFU operations a pixel (3 lg2, 1 rsq) and 45 f32
// operations (an FFMA counts 2), the backward 5 MUFU (3 rcp, 2 rsq) and
// 66 f32: 1.06 us and 1.33 us on the special-function units (16 results
// a clock an SM, 4.18e12/s at 1.98 GHz), 0.74 us and 1.09 us at the CUDA
// cores' 67 TFLOP/s. So bytes bound both, at about twice the ~1 us that
// an empty kernel costs in a CUDA graph on this card; what such a short
// kernel pays beyond its bound is the launch, one load round trip and
// the instruction rate of its busiest SM, so the design keeps each of
// them to one: one device operation, every input read in one wave of
// 16-byte loads, and the pixels spread evenly over the SMs.
//
// Design. Each image is `cluster` blocks (at most 8, Hopper's portable
// cluster size); in the forward they form a thread-block cluster, in the
// backward, whose blocks share nothing, a plain grid. Block b takes the
// band of rows [b * band, (b + 1) * band), in chunks of `strips * rows`
// rows (one chunk at the training shape). A chunk's rows and their halo
// (1 row above and below for the forward, 2 for the backward) are staged
// in shared memory as f32 with 16-byte loads, 8 pixels a step and 4 rows
// in flight a thread
// (the vector path: W a multiple of 8 and 16-byte aligned pointers;
// otherwise the same steps with predicated scalar loads), so every input
// byte is read from device memory once, the band halos twice. A thread
// then owns a quad of 4 columns over `rows` rows and slides a 3-row window
// of staged rows down them, three rows a pass so that the window turns
// without copies; the Sobel pairs of a quad come from shared column sums;
// no division or modulo runs per element. The forward sums the four terms
// in registers and by warp shuffles, then across warps in a fixed order;
// each block of the cluster stores its four partials into block 0's
// shared memory (st.async, counted by an mbarrier there), and block 0 adds
// them in block order and writes sums[n]. No atomics, no counters, no
// fill: the same bits from run to run, on any stream and in a graph. The
// backward computes A and B once for each pixel of the chunk and its
// 1-row ring into shared memory, then dp a quad at a time, reads mask[n] *
// coef once a block and stores dp in 16-byte (f32) or 8-byte (bf16)
// vectors. choose_config picks band, strips, rows, block size and cluster
// size per shape: the cluster that leaves the busiest SM the fewest rows
// to stage (64 images of 114 rows: clusters of 2, 128 blocks, one an SM).
// A thread owns one quad of a row, so a row is at most kMaxWidth (2048)
// pixels; a wider call is refused (cudaErrorInvalidValue, a ValueError in
// the wrapper), never cut.
//
// Functions: PTX's lg2.approx.ftz (its argument is >= 0.5, where its
// absolute error is at most 2^-22.6) with each sum scaled by ln 2 once;
// rsqrt.approx.ftz for the cosine's 1/sqrt(a*b) and, in the backward,
// 1/|n_p| and 1/|n_t|; rcp.approx.ftz for sign(e) / (|e| + 0.5). Each is
// one MUFU operation, where logf, sqrtf and a division add refinements and
// subnormal guards that these arguments (>= 0.5) never need; the
// kernel-versus-plain tolerances (chip_smoke.LOSS_TOL, the card tests) and
// the f32 step against the JAX step hold with them. sign(0) is 0, as
// jnp.sign: flat regions, and pixels whose normals coincide, give an
// exactly zero gradient.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <algorithm>

#include "launch_cache.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 8;
constexpr int kMaxWidth = 2048;   // a row's quads fit one block
constexpr int kTerms = 4;
constexpr int kOct = 8;           // pixels a staging step moves
constexpr int kStageBatch = 4;    // staged rows a thread has in flight
constexpr int kSmemBudget = 200 * 1024;
constexpr int kTargetThreads = 384;  // threads a block, about
constexpr float kLn2 = 0.693147180559945309f;
constexpr int kMaxPolls = 1 << 20;  // of the reduction's mbarrier: then trap

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// Floats a staged row takes: a zero column, then the row's pixels from a
// 16-byte boundary (index 4), rounded up to whole 8-pixel steps, then 4
// zeros on the right.
int row_floats(int W) { return cdiv(W, kOct) * kOct + 8; }

int smem_bytes(bool backward, int chunk, int ld) {
  const int rows = backward ? 2 * (chunk + 4) + 2 * (chunk + 2)
                            : 2 * (chunk + 2);
  return rows * ld * static_cast<int>(sizeof(float));
}

struct Geometry {
  int H, W;
  int quads;   // 4-pixel column groups a row: threads a strip
  int octs;    // 8-pixel staging steps a row
  int ld;      // row_floats(W)
  int band;    // rows a block
  int strips;  // strips of threads a block
  int rows;    // rows a strip takes in a chunk
};

__device__ __forceinline__ float sign0(float v) {  // jnp.sign
  return static_cast<float>(v > 0.f) - static_cast<float>(v < 0.f);
}

// One MUFU operation each: PTX's approximate functions without the
// subnormal guards (.ftz), since every argument here is at least 0.5.
__device__ __forceinline__ float lg2_approx(float x) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float rsqrt_approx(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// d log(|e| + 0.5) / de = sign(e) / (|e| + 0.5), 0 at e = 0 (jnp.sign).
__device__ __forceinline__ float dlog_l1(float e) {
  return e == 0.f ? 0.f : copysignf(rcp_approx(fabsf(e) + 0.5f), e);
}

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// Pixels x .. x + 7 of image row `at` (the row's first element) as f32,
// zeros where `ok` is false or past the row's end.
template <bool kVec>
__device__ __forceinline__ void load8(const float* __restrict__ src,
                                      size_t at, int x, int W, bool ok,
                                      float* v) {
  if (kVec) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (ok) {
      a = __ldg(reinterpret_cast<const float4*>(src + at + x));
      b = __ldg(reinterpret_cast<const float4*>(src + at + x + 4));
    }
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < kOct; ++e)
      v[e] = ok && x + e < W ? __ldg(src + at + x + e) : 0.f;
  }
}

template <bool kVec>
__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ src,
                                      size_t at, int x, int W, bool ok,
                                      float* v) {
  if (kVec) {
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (ok) u = __ldg(reinterpret_cast<const uint4*>(src + at + x));
    v[0] = bf16_lo(u.x), v[1] = bf16_hi(u.x);
    v[2] = bf16_lo(u.y), v[3] = bf16_hi(u.y);
    v[4] = bf16_lo(u.z), v[5] = bf16_hi(u.z);
    v[6] = bf16_lo(u.w), v[7] = bf16_hi(u.w);
  } else {
#pragma unroll
    for (int e = 0; e < kOct; ++e)
      v[e] = ok && x + e < W ? __bfloat162float(src[at + x + e]) : 0.f;
  }
}

__device__ __forceinline__ void store8(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Zero the columns of `nrows` staged rows that no staging step writes: the
// one left of the row and those from `from` to the row's end.
__device__ __forceinline__ void zero_pads(float* s, int nrows, int from,
                                          int ld) {
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    float* row = s + r * ld;
    row[3] = 0.f;
    for (int c = from; c < ld; ++c) row[c] = 0.f;
  }
}

// Image rows y0 .. y0 + nrows - 1 of pred and target into staged rows
// 0 .. nrows - 1 of sp and st, zeros outside the image. Thread i stages
// octet i % octs of rows i / octs, i / octs + lanes, ... (lanes: rows
// staged at once), two rows in flight before it stores.
template <typename T, bool kVec>
__device__ __forceinline__ void stage(const T* __restrict__ pred,
                                      const float* __restrict__ target,
                                      float* sp, float* st, size_t img,
                                      const Geometry& g, int y0, int nrows) {
  const int lanes = blockDim.x / g.octs;
  const int first = threadIdx.x / g.octs;
  const int x = (threadIdx.x - first * g.octs) * kOct;
  if (first >= lanes) return;  // the block's spare threads
  for (int r = first; r < nrows; r += kStageBatch * lanes) {
    float pv[kStageBatch][kOct], tv[kStageBatch][kOct];
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int y = y0 + r + k * lanes;
      const bool ok = r + k * lanes < nrows && y >= 0 && y < g.H;
      const size_t at = img + static_cast<size_t>(ok ? y : 0) * g.W;
      load8<kVec>(pred, at, x, g.W, ok, pv[k]);
      load8<kVec>(target, at, x, g.W, ok, tv[k]);
    }
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      if (r + k * lanes < nrows) {
        const int at = (r + k * lanes) * g.ld + 4 + x;
        store8(sp + at, pv[k]);
        store8(st + at, tv[k]);
      }
    }
  }
}

// Columns x - 1 .. x + 4 of a staged row, `row` pointing at column x (a
// 16-byte boundary).
__device__ __forceinline__ void read6(const float* row, float* v) {
  const float4 c = *reinterpret_cast<const float4*>(row);
  v[0] = row[-1];
  v[1] = c.x, v[2] = c.y, v[3] = c.z, v[4] = c.w;
  v[5] = row[4];
}

// Cluster primitives (PTX). The barrier's halves: a relaxed arrival and the
// wait, which acquires what was released before the arrivals.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// The address of the same shared variable in block `rank` of the cluster.
__device__ __forceinline__ uint32_t remote_addr(uint32_t local,
                                                unsigned rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(local), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               "fence.mbarrier_init.release.cluster;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ bool mbar_done(uint64_t* bar) {  // phase 0
  uint32_t done;
  asm volatile("{\n .reg .pred p;\n"
               " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
               " selp.u32 %0, 1, 0, p;\n}"
               : "=r"(done) : "r"(smem_addr(bar)) : "memory");
  return done != 0;
}
// Store v into `dst` of block 0 and count its 16 bytes on block 0's
// mbarrier `bar` (both shared::cluster addresses).
__device__ __forceinline__ void store_to_block0(uint32_t dst, uint32_t bar,
                                                float4 v) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32"
               " [%0], {%1, %2, %3, %4}, [%5];"
               :: "r"(dst), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
               : "memory");
}

// Sobel gx of the quad's 4 columns from 3 window rows of 6 columns, in
// separable form: gx[k] = V[k] - V[k + 2] with V = a + 2b + c.
__device__ __forceinline__ void sobel_x4(const float* a, const float* b,
                                        const float* c, float* gx) {
  float v[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) v[j] = fmaf(2.0f, b[j], a[j]) + c[j];
#pragma unroll
  for (int k = 0; k < 4; ++k) gx[k] = v[k] - v[k + 2];
}

// Sobel gy likewise: gy[k] = D[k] + 2 D[k + 1] + D[k + 2] with D = a - c.
__device__ __forceinline__ void sobel_y4(const float* a, const float* c,
                                        float* gy) {
  float d[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) d[j] = a[j] - c[j];
#pragma unroll
  for (int k = 0; k < 4; ++k) gy[k] = fmaf(2.0f, d[k + 1], d[k]) + d[k + 2];
}

// Slide a 3-row window of two staged arrays (x, y: columns x0 - 1 ..
// x0 + 4, `xs`/`ys` pointing at column x0 of staged row 0) down rows
// r0 .. r1 - 1, calling f(x rows r .. r + 2, y rows r .. r + 2, r). Three
// rows a pass, so that the window turns without register copies.
template <typename F>
__device__ __forceinline__ void slide(const float* xs, const float* ys,
                                      int ld, int r0, int r1, F f) {
  float x0[6], x1[6], x2[6], y0[6], y1[6], y2[6];
  read6(xs + r0 * ld, x0);
  read6(ys + r0 * ld, y0);
  read6(xs + (r0 + 1) * ld, x1);
  read6(ys + (r0 + 1) * ld, y1);
#pragma unroll 1
  for (int r = r0; r < r1; r += 3) {
    read6(xs + (r + 2) * ld, x2);
    read6(ys + (r + 2) * ld, y2);
    f(x0, x1, x2, y0, y1, y2, r);
    if (r + 1 >= r1) break;
    read6(xs + (r + 3) * ld, x0);
    read6(ys + (r + 3) * ld, y0);
    f(x1, x2, x0, y1, y2, y0, r + 1);
    if (r + 2 >= r1) break;
    read6(xs + (r + 4) * ld, x1);
    read6(ys + (r + 4) * ld, y1);
    f(x2, x0, x1, y2, y0, y1, r + 2);
  }
}

// The forward's terms over output rows r0 .. r1 - 1 of a chunk (staged row
// r + 1) in the quad at column x0, added to acc (the logs in base 2). On
// the 16-byte path every quad lies inside the row, so no pixel branches.
template <bool kVec>
__device__ __forceinline__ void fwd_rows(const float* sp, const float* st,
                                         const Geometry& g, int x0, int r0,
                                         int r1, float* acc) {
  slide(sp + 4 + x0, st + 4 + x0, g.ld, r0, r1,
        [&](const float* pa, const float* pb, const float* pc,
            const float* ta, const float* tb, const float* tc, int) {
          float gxo[4], gyo[4], gxd[4], gyd[4];
          sobel_x4(pa, pb, pc, gxo);
          sobel_y4(pa, pc, gyo);
          sobel_x4(ta, tb, tc, gxd);
          sobel_y4(ta, tc, gyd);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (kVec || x0 + k < g.W) {
              acc[0] += lg2_approx(fabsf(pb[k + 1] - tb[k + 1]) + 0.5f);
              acc[1] += lg2_approx(fabsf(gxo[k] - gxd[k]) + 0.5f);
              acc[2] += lg2_approx(fabsf(gyo[k] - gyd[k]) + 0.5f);
              const float dot = gxo[k] * gxd[k] + gyo[k] * gyd[k] + 1.0f;
              const float q = (gxo[k] * gxo[k] + gyo[k] * gyo[k] + 1.0f) *
                              (gxd[k] * gxd[k] + gyd[k] * gyd[k] + 1.0f);
              acc[3] += fabsf(1.0f - dot * rsqrt_approx(q));
            }
          }
        });
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
loss_fwd_kernel(const T* __restrict__ pred, const float* __restrict__ target,
                float* __restrict__ sums, Geometry g) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float4 warp_sums[kMaxThreads / 32];
  __shared__ float4 cluster_sums[kMaxCluster];  // block 0's: a row a block
  __shared__ uint64_t reduce_bar;               // block 0's: their arrival

  const int tid = threadIdx.x;
  const unsigned rank = gridDim.x > 1 ? cluster_rank() : 0;
  // Block 0 sets up its mbarrier before the cluster barrier whose wait,
  // before the other blocks store into it, proves that it is ready.
  if (gridDim.x > 1) {
    if (rank == 0 && tid == 0) mbar_init(&reduce_bar, 1);
    cluster_arrive_relaxed();
  }
  const int n = blockIdx.y;
  const size_t img = static_cast<size_t>(n) * g.H * g.W;
  const int chunk = g.strips * g.rows;
  float* sp = smem;
  float* st = smem + (chunk + 2) * g.ld;
  const int data_end = 4 + g.octs * kOct;
  zero_pads(sp, chunk + 2, data_end, g.ld);
  zero_pads(st, chunk + 2, data_end, g.ld);

  const int strip = tid / g.quads;  // >= g.strips: the block's spare lanes
  const int x0 = (tid - strip * g.quads) * 4;
  float acc[kTerms] = {0.f, 0.f, 0.f, 0.f};
  const int band0 = static_cast<int>(blockIdx.x) * g.band;
  const int band_end = min(g.H, band0 + g.band);
  for (int y = band0; y < band_end; y += chunk) {
    const int rows = min(chunk, band_end - y);
    stage<T, kVec>(pred, target, sp, st, img, g, y - 1, rows + 2);
    __syncthreads();
    if (strip < g.strips) {
      const int r0 = strip * g.rows;
      fwd_rows<kVec>(sp, st, g, x0, r0, min(rows, r0 + g.rows), acc);
    }
    __syncthreads();  // the next chunk overwrites the staged rows
  }

#pragma unroll
  for (int j = 0; j < kTerms; ++j)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[j] += __shfl_down_sync(0xffffffffu, acc[j], off);
  if ((tid & 31) == 0)
    warp_sums[tid >> 5] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  if (gridDim.x > 1) cluster_wait();  // block 0's mbarrier is ready
  if (tid != 0) return;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    const float4 v = warp_sums[w];
    s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
  }
  if (gridDim.x > 1) {
    // The image's blocks form one cluster: each stores its partials into
    // block 0's shared memory, which adds them in block order once its
    // mbarrier has counted their bytes.
    if (rank != 0) {
      store_to_block0(remote_addr(smem_addr(&cluster_sums[rank]), 0),
                      remote_addr(smem_addr(&reduce_bar), 0), s);
      return;
    }
    cluster_sums[0] = s;
    mbar_expect(&reduce_bar, (gridDim.x - 1) * sizeof(float4));
    bool done = false;
    for (int i = 0; i < kMaxPolls && !done; ++i) done = mbar_done(&reduce_bar);
    // A lost store fails the launch (an error the wrapper raises), rather
    // than hang or leave block 0 while stores may still target it.
    if (!done) __trap();
    s = cluster_sums[0];
    for (unsigned b = 1; b < gridDim.x; ++b) {
      const float4 v = cluster_sums[b];
      s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
    }
  }
  // log2 sums to natural logs
  reinterpret_cast<float4*>(sums)[n] =
      make_float4(s.x * kLn2, s.y * kLn2, s.z * kLn2, s.w);
}

// A = ddx + dn/dgx and B = ddy + dn/dgy (fused_loss.py:156-172) of one
// pixel from its Sobel gradients of pred (o) and target (d).
__device__ __forceinline__ void ab_pixel(float gxo, float gyo, float gxd,
                                         float gyd, float* a, float* b) {
  const float ddx = dlog_l1(gxo - gxd);
  const float ddy = dlog_l1(gyo - gyd);
  const float dot = gxo * gxd + gyo * gyd + 1.0f;
  const float rno = rsqrt_approx(gxo * gxo + gyo * gyo + 1.0f);
  const float rnd = rsqrt_approx(gxd * gxd + gyd * gyd + 1.0f);
  const float rnn = rno * rnd;   // 1 / (|n_p| |n_t|)
  const float rno2 = rno * rno;  // 1 / |n_p|^2
  const float cs = dot * rnn;
  // d|1-c|/dc. Where the normals coincide c is exactly 1 and sign(1 - c)
  // is 0, whatever the rounding of rsqrt.
  const float s = gxo == gxd && gyo == gyd ? 0.f : -sign0(1.0f - cs);
  const float k1 = s * rnn;        // s / (|n_p| |n_t|)
  const float k2 = s * cs * rno2;  // s c / |n_p|^2
  *a = fmaf(k1, gxd, fmaf(-k2, gxo, ddx));
  *b = fmaf(k1, gyd, fmaf(-k2, gyo, ddy));
}

// A and B rows a0 .. a1 - 1 of the chunk (A/B row a is image row y0 + a,
// from staged rows a .. a + 2) in the quad at column x0, into sa and sb;
// zero outside the image.
template <bool kVec>
__device__ __forceinline__ void ab_rows(const float* sp, const float* st,
                                        float* sa, float* sb,
                                        const Geometry& g, int x0, int y0,
                                        int a0, int a1) {
  slide(sp + 4 + x0, st + 4 + x0, g.ld, a0, a1,
        [&](const float* pa, const float* pb, const float* pc,
            const float* ta, const float* tb, const float* tc, int a) {
          float va[4] = {0.f, 0.f, 0.f, 0.f}, vb[4] = {0.f, 0.f, 0.f, 0.f};
          if (y0 + a >= 0 && y0 + a < g.H) {
            float gxo[4], gyo[4], gxd[4], gyd[4];
            sobel_x4(pa, pb, pc, gxo);
            sobel_y4(pa, pc, gyo);
            sobel_x4(ta, tb, tc, gxd);
            sobel_y4(ta, tc, gyd);
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (kVec || x0 + k < g.W)
                ab_pixel(gxo[k], gyo[k], gxd[k], gyd[k], &va[k], &vb[k]);
          }
          *reinterpret_cast<float4*>(sa + a * g.ld + 4 + x0) =
              make_float4(va[0], va[1], va[2], va[3]);
          *reinterpret_cast<float4*>(sb + a * g.ld + 4 + x0) =
              make_float4(vb[0], vb[1], vb[2], vb[3]);
        });
}

template <bool kVec>
__device__ __forceinline__ void store4(float* dst, int x, int W,
                                       const float* v) {
  if (kVec) {
    *reinterpret_cast<float4*>(dst + x) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (x + k < W) dst[x + k] = v[k];
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(__nv_bfloat16* dst, int x, int W,
                                       const float* v) {
  if (kVec) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst + x) = u;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (x + k < W) dst[x + k] = __float2bfloat16(v[k]);
  }
}

// dp over output rows r0 .. r1 - 1 of a chunk starting at image row y (A/B
// rows r .. r + 2, staged row r + 2) in the quad at column x0: d_depth
// plus the correlations of A with kx_flip = [[-1,0,1],[-2,0,2],[-1,0,1]]
// and of B with ky_flip = [[-1,-2,-1],[0,0,0],[1,2,1]], which are minus
// the Sobel gx of A and minus the Sobel gy of B.
template <typename T, bool kVec>
__device__ __forceinline__ void dp_rows(const float* sp, const float* st,
                                        const float* sa, const float* sb,
                                        T* __restrict__ dp,
                                        const Geometry& g, int x0, int y,
                                        int r0, int r1, float scale) {
  slide(sa + 4 + x0, sb + 4 + x0, g.ld, r0, r1,
        [&](const float* aa, const float* ab, const float* ac,
            const float* ba, const float*, const float* bc, int r) {
          const float4 p4 =
              *reinterpret_cast<const float4*>(sp + (r + 2) * g.ld + 4 + x0);
          const float4 t4 =
              *reinterpret_cast<const float4*>(st + (r + 2) * g.ld + 4 + x0);
          const float d[4] = {p4.x - t4.x, p4.y - t4.y, p4.z - t4.z,
                              p4.w - t4.w};
          float gxa[4], gyb[4], out[4];
          sobel_x4(aa, ab, ac, gxa);
          sobel_y4(ba, bc, gyb);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            out[k] = (dlog_l1(d[k]) - gxa[k] - gyb[k]) * scale;
          store4<kVec>(dp + static_cast<size_t>(y + r) * g.W, x0, g.W, out);
        });
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
loss_bwd_kernel(const T* __restrict__ pred, const float* __restrict__ target,
                const float* __restrict__ mask, const float* __restrict__ coef,
                T* __restrict__ dp, Geometry g) {
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const size_t img = static_cast<size_t>(n) * g.H * g.W;
  const int chunk = g.strips * g.rows;
  float* sp = smem;
  float* st = sp + (chunk + 4) * g.ld;
  float* sa = st + (chunk + 4) * g.ld;
  float* sb = sa + (chunk + 2) * g.ld;
  const int data_end = 4 + g.octs * kOct;
  zero_pads(sp, chunk + 4, data_end, g.ld);
  zero_pads(st, chunk + 4, data_end, g.ld);
  zero_pads(sa, chunk + 2, 4 + g.quads * 4, g.ld);
  zero_pads(sb, chunk + 2, 4 + g.quads * 4, g.ld);

  const float scale = mask[n] * coef[0];
  const int strip = tid / g.quads;  // >= g.strips: the block's spare lanes
  const int x0 = (tid - strip * g.quads) * 4;
  const int band0 = static_cast<int>(blockIdx.x) * g.band;
  const int band_end = min(g.H, band0 + g.band);
  for (int y = band0; y < band_end; y += chunk) {
    const int rows = min(chunk, band_end - y);
    stage<T, kVec>(pred, target, sp, st, img, g, y - 2, rows + 4);
    __syncthreads();
    // A and B on image rows y - 1 .. y + rows, each pixel once.
    const int ab = cdiv(rows + 2, g.strips);
    if (strip < g.strips) {
      const int a0 = strip * ab;
      const int a1 = min(rows + 2, a0 + ab);
      if (a0 < a1) ab_rows<kVec>(sp, st, sa, sb, g, x0, y - 1, a0, a1);
    }
    __syncthreads();
    if (strip < g.strips) {
      const int r0 = strip * g.rows;
      const int r1 = min(rows, r0 + g.rows);
      if (r0 < r1)
        dp_rows<T, kVec>(sp, st, sa, sb, dp + img, g, x0, y, r0, r1, scale);
    }
    __syncthreads();  // the next chunk overwrites the staged rows
  }
}

// The launch shape of one call.
struct Config {
  int cluster, band, strips, rows, threads, smem;
};

cudaError_t max_active_clusters(const void* kernel, const Config& c, int N,
                                int* clusters) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c.cluster, N);
  cfg.blockDim = dim3(c.threads);
  cfg.dynamicSmemBytes = c.smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// The launch for an (N, H, W) call of `kernel` on the current device.
//
// c blocks are one image (a cluster in the forward); block b takes rows
// [b * band, (b + 1) * band), band = ceil(H / c). A block has `strips`
// strips of ceil(W / 4) threads, about kTargetThreads in all; a strip
// takes `rows` rows of a chunk of strips * rows rows, one chunk a band
// where the band and its halo fit kSmemBudget. The block scheduler
// spreads the N * c blocks over the SMs, so the busiest SM stages
// ceil(N * c / SMs) bands
// with their halos: c (1 to 8, each block with rows) is the one with the
// fewest such rows, the smallest on a tie (c = 1 needs no cluster), among
// those whose cluster the device can hold (the forward's). False if W is
// too wide.
bool choose_config(bool backward, const void* kernel, int N, int H, int W,
                   Config* out, cudaError_t* err) {
  *err = cudaSuccess;
  if (N <= 0 || H <= 0 || W <= 0 || W > kMaxWidth) return false;
  int sms;
  *err = ede::sm_count(&sms);
  if (*err != cudaSuccess) return false;
  const int quads = cdiv(W, 4);
  const int ld = row_floats(W);
  const int halo = backward ? 2 : 1;
  const int fixed = smem_bytes(backward, 0, ld);
  const int per_row = smem_bytes(backward, 1, ld) - fixed;
  const int max_chunk = std::max(1, (kSmemBudget - fixed) / per_row);
  long long best = -1;
  for (int c = 1; c <= std::min(kMaxCluster, H); ++c) {
    const int band = cdiv(H, c);
    if (cdiv(H, band) != c) continue;  // a block would have no rows
    int strips = std::min({std::max(1, (kTargetThreads + quads / 2) / quads),
                           kMaxThreads / quads, band, max_chunk});
    const int rows = std::min(cdiv(band, strips), max_chunk / strips);
    strips = std::min(strips, cdiv(band, rows));
    const int chunks = cdiv(band, strips * rows);
    const long long cost = static_cast<long long>(cdiv(N * c, sms)) *
                           (band + 2 * halo * chunks);
    if (best >= 0 && cost >= best) continue;
    const Config cfg{c, band, strips, rows, cdiv(quads * strips, 32) * 32,
                     smem_bytes(backward, strips * rows, ld)};
    *err = ede::allow_smem(kernel, cfg.smem);
    if (*err != cudaSuccess) return false;
    if (c > 1 && !backward) {
      int clusters = 0;
      *err = max_active_clusters(kernel, cfg, N, &clusters);
      if (*err != cudaSuccess) return false;
      if (clusters < 1) continue;
    }
    best = cost;
    *out = cfg;
  }
  return best >= 0;
}

// A grid of (c.cluster, N) blocks, as clusters of c.cluster where
// `clustered` (the forward).
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel* kernel, bool clustered, const Config& c, int N,
                   cudaStream_t stream, Args... args) {
  cudaError_t err =
      ede::allow_smem(reinterpret_cast<const void*>(kernel), c.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c.cluster, N);
  cfg.blockDim = dim3(c.threads);
  cfg.dynamicSmemBytes = c.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = clustered && c.cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Checks a launch shape against the call (the wrapper passes
// ede_fused_depth_loss_config's) and fills the kernel's geometry.
bool geometry(bool backward, int N, int H, int W, const Config& c,
              Geometry* g) {
  if (N <= 0 || N > 65535 || H <= 0 || W <= 0 || W > kMaxWidth ||
      c.cluster < 1 || c.cluster > kMaxCluster || c.band < 1 ||
      static_cast<long long>(c.band) * c.cluster < H || c.strips < 1 ||
      c.rows < 1 || c.threads > kMaxThreads || c.threads % 32 != 0 ||
      cdiv(W, 4) * c.strips > c.threads ||
      c.smem < smem_bytes(backward, c.strips * c.rows, row_floats(W)))
    return false;
  *g = Geometry{H, W, cdiv(W, 4), cdiv(W, kOct), row_floats(W),
                c.band, c.strips, c.rows};
  return true;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, bool kVec>
const void* fwd_kernel() {
  return reinterpret_cast<const void*>(loss_fwd_kernel<T, kVec>);
}
template <typename T, bool kVec>
const void* bwd_kernel() {
  return reinterpret_cast<const void*>(loss_bwd_kernel<T, kVec>);
}

const void* kernel_of(bool backward, int dtype, bool vec) {
  if (dtype == 0)
    return backward ? (vec ? bwd_kernel<float, true>()
                           : bwd_kernel<float, false>())
                    : (vec ? fwd_kernel<float, true>()
                           : fwd_kernel<float, false>());
  return backward ? (vec ? bwd_kernel<__nv_bfloat16, true>()
                         : bwd_kernel<__nv_bfloat16, false>())
                  : (vec ? fwd_kernel<__nv_bfloat16, true>()
                         : fwd_kernel<__nv_bfloat16, false>());
}

template <typename T>
cudaError_t launch_fwd(bool vec, const void* pred, const void* target,
                       void* sums, int N, const Config& c, const Geometry& g,
                       cudaStream_t s) {
  const T* p = static_cast<const T*>(pred);
  const float* t = static_cast<const float*>(target);
  float* out = static_cast<float*>(sums);
  if (vec) return launch(loss_fwd_kernel<T, true>, true, c, N, s, p, t, out, g);
  return launch(loss_fwd_kernel<T, false>, true, c, N, s, p, t, out, g);
}

template <typename T>
cudaError_t launch_bwd(bool vec, const void* pred, const void* target,
                       const void* mask, const void* coef, void* dp, int N,
                       const Config& c, const Geometry& g, cudaStream_t s) {
  const T* p = static_cast<const T*>(pred);
  const float* t = static_cast<const float*>(target);
  const float* m = static_cast<const float*>(mask);
  const float* k = static_cast<const float*>(coef);
  T* out = static_cast<T*>(dp);
  if (vec)
    return launch(loss_bwd_kernel<T, true>, false, c, N, s, p, t, m, k, out,
                  g);
  return launch(loss_bwd_kernel<T, false>, false, c, N, s, p, t, m, k, out,
                g);
}

}  // namespace

extern "C" {

// The launch shape of an (N, H, W) call of the forward (backward = 0) or
// the backward (1) on the current device, dtype of pred 0 = float32,
// 1 = bfloat16, vec: the 16-byte path (W % 8 == 0, pred, target and dp
// 16-byte aligned). out[0..5] = cluster, band, strips, rows, threads,
// smem bytes (see choose_config). Returns a cudaError_t; an unsupported
// shape (W above 2048) gives cudaErrorInvalidValue.
int ede_fused_depth_loss_config(int backward, int dtype, int vec, int N,
                                int H, int W, int* out) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  Config c;
  cudaError_t err;
  if (!choose_config(backward != 0, kernel_of(backward != 0, dtype, vec != 0),
                     N, H, W, &c, &err))
    return err != cudaSuccess ? err : cudaErrorInvalidValue;
  out[0] = c.cluster, out[1] = c.band, out[2] = c.strips, out[3] = c.rows;
  out[4] = c.threads, out[5] = c.smem;
  return cudaSuccess;
}

// sums: (N, 4) f32, 16-byte aligned, written by block 0 of each image's
// cluster. The launch
// shape (cluster .. smem) is ede_fused_depth_loss_config's. Returns a
// cudaError_t (0 on success).
int ede_fused_depth_loss_fwd(int dtype, int vec, const void* pred,
                             const void* target, void* sums, int N, int H,
                             int W, int cluster, int band, int strips,
                             int rows, int threads, int smem, void* stream) {
  const Config c{cluster, band, strips, rows, threads, smem};
  Geometry g;
  if (!geometry(false, N, H, W, c, &g) || !aligned16(sums) ||
      (vec && (W % kOct != 0 || !aligned16(pred) || !aligned16(target))))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(vec, pred, target, sums, N, c, g, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(vec, pred, target, sums, N, c, g, s);
  return cudaErrorInvalidValue;
}

// dp: (N, H, W) in pred's dtype; mask (N,) f32; coef one f32.
int ede_fused_depth_loss_bwd(int dtype, int vec, const void* pred,
                             const void* target, const void* mask,
                             const void* coef, void* dp, int N, int H, int W,
                             int cluster, int band, int strips, int rows,
                             int threads, int smem, void* stream) {
  const Config c{cluster, band, strips, rows, threads, smem};
  Geometry g;
  if (!geometry(true, N, H, W, c, &g) ||
      (vec && (W % kOct != 0 || !aligned16(pred) || !aligned16(target) ||
               !aligned16(dp))))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(vec, pred, target, mask, coef, dp, N, c, g, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(vec, pred, target, mask, coef, dp, N, c,
                                     g, s);
  return cudaErrorInvalidValue;
}

const char* ede_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
