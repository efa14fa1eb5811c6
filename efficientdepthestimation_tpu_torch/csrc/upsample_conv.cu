// conv5x5(align-corners bilinear upsample(x)) without the upsampled tensor.
//
// Replaces the Pallas kernel efficientdepthestimation_tpu/ops/pallas/
// upproj.py:171 `upsample_conv_pallas` (body `_kernel`, :67-108):
//
//     U = resize_bilinear_align_corners(x, (H, W))     rounded to x's type
//     y[n,P,Q,o] = sum_{dp,dq,c} U[n, P+dp-2, Q+dq-2, c] * K[dp,dq,c,o]
//
// with U zero outside [0,H)x[0,W) (the conv's zero padding). x is NHWC
// (N,hs,ws,C), K is HWIO (5,5,C,O) with the two UpProjection branches
// stacked on O, y is (N,H,W,O) in x's type, bf16 or f32, summed in f32.
//
// What bounds it on the H100: operations. At the Hu decoder's direct sites
// it does 25*C multiply-adds per output value on C <= 112 input channels
// that were read once, hundreds of operations per byte moved; the bound is
// taken at the bf16 tensor-core rate (989 TFLOP/s dense).
//
// bf16: an implicit GEMM on the tensor cores (`upsample_conv_mma`). A block
// owns a tile of th x tw output pixels (th*tw <= 256, the rows M of the
// GEMM, in row-major order) of one image and up to 128 output channels (N,
// 8*NT of them); K runs over (tap, 8-channel group) pairs. The block
// interpolates the (th+4) x (tw+4) halo patch of U from x once per chunk of
// up to 128 input channels, in bf16, into shared memory laid out
// [row][col][channel], zeros outside the image (the role `_padded_matrix`
// plays in the Pallas kernel), reading x in the widest loads C allows (8, 4
// or 2 channels); U never reaches device memory. For a tap
// (dp, dq) the A fragment of an output pixel is an `ldmatrix` of the patch
// at the pixel shifted by (dp, dq): no im2col copy. Because every 8-row
// piece of an ldmatrix has its own address, a k16 step may take its two
// 8-channel groups from two different taps, so C = 20 or 40 wastes nothing
// beyond the rounding to 8. K goes to shared memory by cp.async in slices
// of 16 groups (128 rows), zero-filled past C and O. Where C <= 128 and all
// of K fits beside the patch (D.up3, D.up4, MFF.up1 of ENB0-HU), it stays
// there: as many blocks as the card holds at once each load K once and
// walk output tiles of every image, so K is read once a block and not once
// a tile. Where it does not fit (D.up2: 25*80*80*2 B = 320 KB), a block owns
// one tile and K streams through a 3-slot ring, the next slice's copy
// overlapped with the MMAs of the one before. 8 warps each own 32 pixels x
// all N, so one B fragment serves two m16n8k16 MMAs (bf16 in, f32
// accumulators). Pixel and weight rows are padded to an odd number of
// 16-byte units, so ldmatrix reads are free of bank conflicts. The epilogue
// rounds to bf16 in shared memory and stores rows of O with 16-byte stores
// where O % 8 == 0.
//
// f32: exact f32 on the CUDA cores (`upsample_conv_f32`; TF32 would not
// hold the f32 checks): a block owns a 32x16 tile x 16 output channels,
// input channels in chunks of 8 through a shared 36x20 patch.
//
// Interpolation weights come from float64 arithmetic, as the host matrices
// of the JAX and PyTorch versions do, and U is formed rows first, then
// columns, in f32 before the one rounding to x's type.
//
// A row window (spatial serving, where each rank computes a band of rows):
// y holds rows [row0, row0 + rows) of the (H, W) output, and x holds rows
// [src0, src0 + hl) of a source of hs rows, which must include every source
// row those output rows read. The interpolation and the conv's padding are
// the whole image's: coordinates are global, and only the addressing of x
// and y moves. The whole image is the window (0, hs, 0, H), whose arithmetic
// is the same instruction for instruction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "launch_cache.cuh"

namespace {

constexpr int kTaps = 5;
constexpr int kHalo = kTaps / 2;

// Source index pair and weights of align-corners output coordinate `i`.
__device__ __forceinline__ void source(int i, double step, int in_size,
                                       int* lo, int* hi, float* w_lo,
                                       float* w_hi) {
  const double src = i * step;
  int l = static_cast<int>(floor(src));
  l = min(max(l, 0), in_size - 1);
  const double frac = src - l;
  *lo = l;
  *hi = min(l + 1, in_size - 1);
  *w_lo = static_cast<float>(1.0 - frac);
  *w_hi = static_cast<float>(frac);
}

__host__ __device__ inline double align_step(int in_size, int out_size) {
  return out_size > 1 ? double(in_size - 1) / double(out_size - 1) : 0.0;
}

// ---------------------------------------------------------------- f32 ----

constexpr int kTileW = 16;
constexpr int kThreadRows = 16;          // threads per tile column
constexpr int kRowsPerThread = 2;
constexpr int kTileH = kThreadRows * kRowsPerThread;
constexpr int kPatchH = kTileH + 2 * kHalo;
constexpr int kPatchW = kTileW + 2 * kHalo;
constexpr int kChunkC = 8;
constexpr int kTileO = 16;
constexpr int kThreads = kTileW * kThreadRows;

__global__ void __launch_bounds__(kThreads)
upsample_conv_f32(const float* __restrict__ x, const float* __restrict__ kern,
                  float* __restrict__ y, int hl, int src0, int hs, int ws,
                  int C, int H, int W, int O, int row0, int rows,
                  int o_tiles) {
  __shared__ float patch[kChunkC][kPatchH][kPatchW];
  __shared__ __align__(16) float wts[kChunkC][kTaps * kTaps][kTileO];

  const int tid = threadIdx.x;
  const int tx = tid % kTileW;
  const int ty = tid / kTileW;
  const int n = blockIdx.z / o_tiles;
  const int o0 = (blockIdx.z % o_tiles) * kTileO;
  const int P0 = row0 + blockIdx.y * kTileH;
  const int Q0 = blockIdx.x * kTileW;
  const double step_h = align_step(hs, H);
  const double step_w = align_step(ws, W);
  const float* xn = x + (size_t)n * hl * ws * C;
  // U rows past the window's reach feed no row of y: zero, never read
  const int r_end = min(H, row0 + rows + kHalo);

  float acc[kRowsPerThread][kTileO];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int j = 0; j < kTileO; ++j) acc[r][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kChunkC) {
    __syncthreads();  // the previous chunk's reads are done
    for (int i = tid; i < kChunkC * kPatchH * kPatchW; i += kThreads) {
      const int cl = i % kChunkC;  // channel fastest: neighbouring addresses
      const int rc = i / kChunkC;
      const int pr = rc / kPatchW;
      const int pc = rc % kPatchW;
      const int c = c0 + cl;
      const int R = P0 - kHalo + pr;
      const int Q = Q0 - kHalo + pc;
      float v = 0.f;
      if (c < C && R >= 0 && R < r_end && Q >= 0 && Q < W) {
        int r0, r1, q0, q1;
        float wr0, wr1, wq0, wq1;
        source(R, step_h, hs, &r0, &r1, &wr0, &wr1);
        source(Q, step_w, ws, &q0, &q1, &wq0, &wq1);
        r0 -= src0, r1 -= src0;
        // rows first, then columns, as the separable matrix form does
        const float t0 = wr0 * xn[((size_t)r0 * ws + q0) * C + c] +
                         wr1 * xn[((size_t)r1 * ws + q0) * C + c];
        const float t1 = wr0 * xn[((size_t)r0 * ws + q1) * C + c] +
                         wr1 * xn[((size_t)r1 * ws + q1) * C + c];
        v = wq0 * t0 + wq1 * t1;
      }
      patch[cl][pr][pc] = v;
    }
    for (int i = tid; i < kChunkC * kTaps * kTaps * kTileO; i += kThreads) {
      const int ol = i % kTileO;
      const int rest = i / kTileO;
      const int tap = rest % (kTaps * kTaps);
      const int cl = rest / (kTaps * kTaps);
      const int c = c0 + cl;
      const int o = o0 + ol;
      wts[cl][tap][ol] =
          (c < C && o < O) ? kern[((size_t)tap * C + c) * O + o] : 0.f;
    }
    __syncthreads();

    for (int cl = 0; cl < kChunkC; ++cl) {
#pragma unroll
      for (int dp = 0; dp < kTaps; ++dp) {
#pragma unroll
        for (int dq = 0; dq < kTaps; ++dq) {
          float u[kRowsPerThread];
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r)
            u[r] = patch[cl][ty + r * kThreadRows + dp][tx + dq];
          const float4* w4 =
              reinterpret_cast<const float4*>(&wts[cl][dp * kTaps + dq][0]);
#pragma unroll
          for (int j = 0; j < kTileO / 4; ++j) {
            const float4 w = w4[j];
#pragma unroll
            for (int r = 0; r < kRowsPerThread; ++r) {
              acc[r][4 * j + 0] += u[r] * w.x;
              acc[r][4 * j + 1] += u[r] * w.y;
              acc[r][4 * j + 2] += u[r] * w.z;
              acc[r][4 * j + 3] += u[r] * w.w;
            }
          }
        }
      }
    }
  }

  const int Q = Q0 + tx;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int P = P0 + ty + r * kThreadRows;
    if (P < row0 + rows && Q < W) {
      float* yp = y + (((size_t)n * rows + (P - row0)) * W + Q) * O + o0;
#pragma unroll
      for (int j = 0; j < kTileO; ++j)
        if (o0 + j < O) yp[j] = acc[r][j];
    }
  }
}

cudaError_t launch_f32(const void* x, const void* kern, void* y, int N,
                       int hl, int src0, int hs, int ws, int C, int H, int W,
                       int O, int row0, int rows, cudaStream_t stream) {
  const int o_tiles = (O + kTileO - 1) / kTileO;
  const dim3 grid((W + kTileW - 1) / kTileW, (rows + kTileH - 1) / kTileH,
                  N * o_tiles);
  upsample_conv_f32<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(kern),
      static_cast<float*>(y), hl, src0, hs, ws, C, H, W, O, row0, rows,
      o_tiles);
  return cudaGetLastError();
}

// --------------------------------------------------------------- bf16 ----

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kMmaThreads = kWarps * 32;
constexpr int kWarpM = 32;                    // two m16 tiles a warp
constexpr int kBlockM = kWarps * kWarpM;      // output pixels a block
constexpr int kChunkGroups = 16;              // 8-channel groups a patch fill
constexpr int kChunkTaps = kTaps * kTaps;     // stages of a full chunk
constexpr int kStageGroups = 16;              // K rows a stage: 16 x 8
constexpr int kStageRows = kStageGroups * 8;
constexpr int kStages = 3;
constexpr int kMaxNT = 16;                    // n8 tiles a block: O <= 128
constexpr int kGoffLen = kChunkTaps * kChunkGroups + kStageGroups;
constexpr int kMaxSmem = 232448;              // a block's 227 KB

// A row's padded length in elements: an odd number of 16-byte units, so the
// 8 rows an ldmatrix reads fall in 8 different bank quads.
__host__ __device__ inline int odd_units(int groups) {
  return 8 * (groups % 2 == 0 ? groups + 1 : groups);
}

struct Src {  // one row or column of the patch: lo < 0 means outside
  int lo, hi;
  float w_lo, w_hi;
};

struct MmaParams {
  const bf16* x;
  const bf16* k;
  bf16* y;
  int N, hs, ws, C, H, W, O;
  int hl, src0;          // x's rows and the first one's source row
  int row0, rows;        // y's rows of the output: [row0, row0 + rows)
  int th, tw, tiles_x;   // output tile and tiles along W
  int tiles;             // tiles an image
  int n_block;           // output channels a block (8 * NT)
  int resident;          // 1: all of K stays in shared memory, tiles loop
  int vec_x;             // elements per load of x: 8, 4, 2 or 1
  int vec_k;             // elements per cp.async of K: 8, 4, 2 or 1
  int vec_y;             // elements per store of y: 8, 2 or 1
};

struct Layout {
  int ph, pw, pitch, cp, bs;  // patch rows/cols/pitch, row strides
  int resident;               // 1: a slot for every stage of K
  int stages, slots;          // stages of K; slots of the ring
  int patch, ring, out, goff, where, rows, cols, total;  // bytes
};

// Stages of K: 25 a full chunk of 128 channels, then the last chunk's.
__host__ __device__ inline int k_stages(int C) {
  const int chunks = (C + 8 * kChunkGroups - 1) / (8 * kChunkGroups);
  const int last_groups = (C - (chunks - 1) * 8 * kChunkGroups + 7) / 8;
  return (chunks - 1) * kChunkTaps +
         (kChunkTaps * last_groups + kStageGroups - 1) / kStageGroups;
}

// Resident: every stage of K has its own slot, and the epilogue's tile its
// own place; else a ring of kStages slots, the epilogue over patch and ring.
__host__ __device__ inline Layout mma_layout(int th, int tw, int C,
                                             int n_block, bool resident) {
  Layout L;
  const int groups = min((C + 7) / 8, kChunkGroups);
  L.ph = th + 2 * kHalo;
  L.pw = tw + 2 * kHalo;
  // Patch rows are tw + 8 pixels apart: 8 consecutive GEMM rows that wrap
  // to the next tile row then still fall in 8 different bank quads.
  L.pitch = tw + 8;
  L.cp = odd_units(groups);
  L.bs = odd_units(n_block / 8);
  L.resident = resident;
  L.stages = k_stages(C);
  L.slots = resident ? L.stages : kStages;
  const int patch = L.ph * L.pitch * L.cp * 2;
  const int ring = L.slots * kStageRows * L.bs * 2;
  const int out = kBlockM * (n_block + 8) * 2;
  L.patch = 0;
  L.ring = patch;
  L.out = resident ? patch + ring : 0;
  L.goff = resident ? L.out + out : max(patch + ring, out);
  L.where = L.goff + kGoffLen * 4;
  L.rows = L.where + kBlockM * 4;
  L.cols = L.rows + L.ph * (int)sizeof(Src);
  L.total = L.cols + L.pw * (int)sizeof(Src);
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// d += a * b: m16n8k16, bf16 in, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy `vec` bf16 (16, 8 or 4 bytes) to shared memory, zeros if !valid.
__device__ __forceinline__ void cp_async(bf16* dst, const bf16* src,
                                         bool valid, int vec) {
  const uint32_t d = smem_u32(dst);
  const int bytes = valid ? 2 * vec : 0;
  if (vec == 8)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
  else if (vec == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float lo_f32(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f32(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// 8 bf16 from p, zeros from element n on, in loads of vec elements (8, 4,
// 2 or 1; vec divides C, so a load is wholly inside or past the channels).
__device__ __forceinline__ uint4 load8(const bf16* p, int n, int vec) {
  if (vec == 8) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (vec == 4) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (4 * h < n) {
        const uint2 v = reinterpret_cast<const uint2*>(p)[h];
        w[2 * h] = v.x, w[2 * h + 1] = v.y;
      }
  } else if (vec == 2) {
#pragma unroll
    for (int h = 0; h < 4; ++h)
      if (2 * h < n) w[h] = reinterpret_cast<const uint32_t*>(p)[h];
  } else {
    const unsigned short* e = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < n) w[j / 2] |= static_cast<uint32_t>(e[j]) << (16 * (j % 2));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// U at one patch position for 8 channels from c, rows first, then columns.
__device__ __forceinline__ uint4 interpolate8(const bf16* __restrict__ xn,
                                              const Src& r, const Src& q,
                                              int ws, int C, int c,
                                              int vec) {
  if (r.lo < 0 || q.lo < 0) return make_uint4(0, 0, 0, 0);
  const int n = min(8, C - c);
  const uint4 a = load8(xn + ((size_t)r.lo * ws + q.lo) * C + c, n, vec);
  const uint4 b = load8(xn + ((size_t)r.hi * ws + q.lo) * C + c, n, vec);
  const uint4 e = load8(xn + ((size_t)r.lo * ws + q.hi) * C + c, n, vec);
  const uint4 f = load8(xn + ((size_t)r.hi * ws + q.hi) * C + c, n, vec);
  const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
  const uint32_t ew[4] = {e.x, e.y, e.z, e.w}, fw[4] = {f.x, f.y, f.z, f.w};
  float u[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float t0l = r.w_lo * lo_f32(aw[j]) + r.w_hi * lo_f32(bw[j]);
    const float t1l = r.w_lo * lo_f32(ew[j]) + r.w_hi * lo_f32(fw[j]);
    const float t0h = r.w_lo * hi_f32(aw[j]) + r.w_hi * hi_f32(bw[j]);
    const float t1h = r.w_lo * hi_f32(ew[j]) + r.w_hi * hi_f32(fw[j]);
    u[2 * j] = q.w_lo * t0l + q.w_hi * t1l;
    u[2 * j + 1] = q.w_lo * t0h + q.w_hi * t1h;
  }
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(u[2 * j], u[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int NT>
__global__ void __launch_bounds__(kMmaThreads, 1)
upsample_conv_mma(const MmaParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = mma_layout(p.th, p.tw, p.C, p.n_block, p.resident);
  bf16* patch = reinterpret_cast<bf16*>(smem + L.patch);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  bf16* out = reinterpret_cast<bf16*>(smem + L.out);
  int* goff = reinterpret_cast<int*>(smem + L.goff);
  int* where = reinterpret_cast<int*>(smem + L.where);
  Src* rows = reinterpret_cast<Src*>(smem + L.rows);
  Src* cols = reinterpret_cast<Src*>(smem + L.cols);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int o0 = blockIdx.y * p.n_block;
  const int C = p.C;
  const int chunks = (C + 8 * kChunkGroups - 1) / (8 * kChunkGroups);
  const int last_groups =
      (C - (chunks - 1) * 8 * kChunkGroups + 7) / 8;  // groups a tap, last
  const int total = L.stages;
  const double step_h = align_step(p.hs, p.H);
  const double step_w = align_step(p.ws, p.W);

  // Each lane's ldmatrix row of A: pixel m of the tile, patch offset.
  int a_base[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int m = warp * kWarpM + mt * 16 + (lane & 15);
    int r = m / p.tw, c = m % p.tw;
    if (r >= p.th) r = c = 0;  // a padding row: any finite data
    a_base[mt] = (r * L.pitch + c) * L.cp;
  }
  // ldmatrix.trans lane addresses of B within a k16 step: rows k, cols n.
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_col = (lane >> 4) * 8;

  // Stage s of K (rows of one chunk's (tap, group) pairs) into its slot.
  auto stage_k = [&](int s) {
    if (s >= total) return;
    const int ch = min(s / kChunkTaps, chunks - 1);
    const int groups = ch == chunks - 1 ? last_groups : kChunkGroups;
    const int g0 = (s - ch * kChunkTaps) * kStageGroups;
    bf16* dst = ring + (s % L.slots) * kStageRows * L.bs;
    const int vec = p.vec_k;
    const int units = p.n_block / vec;
    for (int i = tid; i < kStageRows * units; i += kMmaThreads) {
      const int row = i / units;
      const int col = (i - row * units) * vec;
      const int g = g0 + row / 8;
      const int tap = g / groups;
      const int c = ch * 8 * kChunkGroups + (g - tap * groups) * 8 + row % 8;
      const bool valid =
          g < kChunkTaps * groups && c < C && o0 + col < p.O;
      const bf16* src =
          valid ? p.k + ((size_t)tap * C + c) * p.O + o0 + col : p.k;
      if (vec == 1)
        dst[row * L.bs + col] = valid ? *src : __float2bfloat16(0.f);
      else
        cp_async(dst + row * L.bs + col, src, valid, vec);
    }
  };

  // Each group's offset in the patch, for chunk ch.
  auto fill_goff = [&](int ch) {
    const int groups = ch == chunks - 1 ? last_groups : kChunkGroups;
    for (int g = tid; g < kGoffLen; g += kMmaThreads) {
      int off = 0;  // a padding group: B is zero there, A any finite data
      if (g < kChunkTaps * groups) {
        const int tap = g / groups;
        off = ((tap / kTaps) * L.pitch + tap % kTaps) * L.cp +
              (g - tap * groups) * 8;
      }
      goff[g] = off;
    }
  };

  // The interpolation sources of tile (P0, Q0)'s patch rows and columns,
  // and where each GEMM row's pixel lies in the image (-1: none).
  auto fill_sources = [&](int P0, int Q0) {
    for (int i = tid; i < L.ph + L.pw; i += kMmaThreads) {
      const bool is_row = i < L.ph;
      const int at = is_row ? P0 - kHalo + i : Q0 - kHalo + (i - L.ph);
      Src s = {-1, -1, 0.f, 0.f};
      // U rows past the window's reach feed no row of y: zero, never read
      const int end = is_row ? min(p.H, p.row0 + p.rows + kHalo) : p.W;
      if (at >= 0 && at < end)
        source(at, is_row ? step_h : step_w, is_row ? p.hs : p.ws, &s.lo,
               &s.hi, &s.w_lo, &s.w_hi);
      if (is_row) {
        if (s.lo >= 0) s.lo -= p.src0, s.hi -= p.src0;
        rows[i] = s;
      }
      if (!is_row) cols[i - L.ph] = s;
    }
    static_assert(kMmaThreads == kBlockM, "a thread a GEMM row");
    const int r = tid / p.tw;
    const int P = P0 + r;
    const int Q = Q0 + tid - r * p.tw;
    where[tid] =
        r < p.th && P < p.row0 + p.rows && Q < p.W ? (P - p.row0) * p.W + Q
                                                   : -1;
  };

  // U of chunk ch on the patch (the sources filled and visible).
  auto fill_patch = [&](const bf16* xn, int ch) {
    const int groups = ch == chunks - 1 ? last_groups : kChunkGroups;
    const int c0 = ch * 8 * kChunkGroups;
    for (int i = tid; i < L.ph * L.pw * groups; i += kMmaThreads) {
      const int g = i % groups;
      const int pix = i / groups;
      const int pr = pix / L.pw;
      const int pc = pix - pr * L.pw;
      bf16* dst = patch + (pr * L.pitch + pc) * L.cp + g * 8;
      *reinterpret_cast<uint4*>(dst) = interpolate8(
          xn, rows[pr], cols[pc], p.ws, C, c0 + g * 8, p.vec_x);
    }
  };

  float acc[2][NT][4];
  // The MMAs of stage s, from its slot of the ring.
  auto mma_stage = [&](int s) {
    const int ch = min(s / kChunkTaps, chunks - 1);
    const bf16* B = ring + (s % L.slots) * kStageRows * L.bs;
    const int g0 = (s - ch * kChunkTaps) * kStageGroups;
#pragma unroll
    for (int j = 0; j < kStageGroups / 2; ++j) {
      // All of the k16 step's fragments first, then its MMAs.
      const int off = goff[g0 + 2 * j + (lane >> 4)];
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], patch + a_base[mt] + off);
      const bf16* Bj = B + (16 * j + b_row) * L.bs;
      uint32_t b[(NT + 1) / 2][4];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        ldmatrix_x4_trans(b[np], Bj + b_col + 16 * np);
      if constexpr (NT % 2 == 1)
        ldmatrix_x2_trans(b[NT / 2], Bj + 8 * (NT - 1));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[np][0], b[np][1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[np][2], b[np][3]);
        }
      if constexpr (NT % 2 == 1)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_bf16(acc[mt][NT - 1], a[mt], b[NT / 2][0], b[NT / 2][1]);
    }
  };

  // Round the accumulators to bf16 through shared memory (`out`, free for
  // writing), then store image n's pixels in whole rows of O.
  auto epilogue = [&](int n) {
    const int os = p.n_block + 8;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int m = warp * kWarpM + mt * 16 + (lane >> 2);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = nt * 8 + (lane & 3) * 2;
        *reinterpret_cast<__nv_bfloat162*>(out + m * os + col) =
            __floats2bfloat162_rn(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<__nv_bfloat162*>(out + (m + 8) * os + col) =
            __floats2bfloat162_rn(acc[mt][nt][2], acc[mt][nt][3]);
      }
    }
    __syncthreads();
    bf16* yn = p.y + (size_t)n * p.rows * p.W * p.O + o0;
    // A fixed unit of O for each thread, pixels in steps.
    const int vec = p.vec_y;
    const int units = p.n_block / vec;
    const int col = (tid % units) * vec;
    const int step = kMmaThreads / units;
    if (tid / units >= step || o0 + col >= p.O) return;
    for (int m = tid / units; m < kBlockM; m += step) {
      if (where[m] < 0) continue;
      bf16* dst = yn + (size_t)where[m] * p.O + col;
      const bf16* src = out + m * os + col;
      if (vec == 8)
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      else if (vec == 2)
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            *reinterpret_cast<const __nv_bfloat162*>(src);
      else
        *dst = *src;
    }
  };

  auto zero_acc = [&] {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;
  };

  if (p.resident) {
    // One chunk of channels; all of K lands once, then the block walks
    // tiles (of every image) with stride gridDim.x.
    for (int s = 0; s < total; ++s) stage_k(s);
    cp_async_commit();
    fill_goff(0);
    for (int t = blockIdx.x; t < p.N * p.tiles; t += gridDim.x) {
      const int n = t / p.tiles;
      const int tile = t - n * p.tiles;
      zero_acc();
      __syncthreads();  // the last tile's epilogue is done
      fill_sources(p.row0 + (tile / p.tiles_x) * p.th,
                   (tile % p.tiles_x) * p.tw);
      __syncthreads();
      fill_patch(p.x + (size_t)n * p.hl * p.ws * C, 0);
      cp_async_wait<0>();
      __syncthreads();  // the patch (and, the first time, K) landed
      for (int s = 0; s < total; ++s) mma_stage(s);
      epilogue(n);
    }
    return;
  }

  // Streaming: one tile; K through the ring, a stage ahead.
  const int n = blockIdx.z;
  const bf16* xn = p.x + (size_t)n * p.hl * p.ws * C;
  zero_acc();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    stage_k(s);
    cp_async_commit();
  }
  fill_sources(p.row0 + (blockIdx.x / p.tiles_x) * p.th,
               (blockIdx.x % p.tiles_x) * p.tw);
  int ch_now = -1;
  for (int s = 0; s < total; ++s) {
    const int ch = min(s / kChunkTaps, chunks - 1);
    if (ch != ch_now) {
      __syncthreads();  // the sources, or the last chunk's patch reads
      fill_patch(xn, ch);
      fill_goff(ch);
      ch_now = ch;
    }
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slot s landed for all; slot s-1 is free
    stage_k(s + kStages - 1);
    cp_async_commit();
    mma_stage(s);
  }
  cp_async_wait<0>();
  __syncthreads();  // the epilogue's tile overlaps the patch and the ring
  epilogue(n);
}

template <int NT>
cudaError_t launch_mma_nt(const MmaParams& p, dim3 grid, int smem,
                          cudaStream_t stream) {
  const void* kernel = reinterpret_cast<const void*>(upsample_conv_mma<NT>);
  cudaError_t err = ede::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (p.resident) {
    // As many blocks as the card holds at once, each walking tiles.
    int blocks;
    err = ede::resident_blocks(kernel, kMmaThreads, smem, &blocks);
    if (err != cudaSuccess) return err;
    grid.x = min((int)grid.x, blocks);
  }
  upsample_conv_mma<NT><<<grid, kMmaThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Resident when there is one chunk of channels and all of K fits beside the
// patch.
inline Layout choose_layout(int th, int tw, int C, int n_block) {
  const Layout resident = mma_layout(th, tw, C, n_block, true);
  if (C <= 8 * kChunkGroups && resident.total <= kMaxSmem) return resident;
  return mma_layout(th, tw, C, n_block, false);
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// n8 tiles a block: O split evenly into blocks of at most 8 * kMaxNT.
inline int n_tiles(int O) { return cdiv(cdiv(O, 8), cdiv(O, 8 * kMaxNT)); }

// The output tile (th, tw) for an (H, W) output. A block's GEMM rows are
// th * tw <= 256 pixels in row-major order, so tw need not divide W. Among
// the tiles that fit shared memory it takes the one with the least work
// summed over blocks: 256 rows of MMAs a block (padding rows included), the
// halo patch it interpolates, and a fixed cost a block. False if none fits.
bool choose_tile(int H, int W, int C, int O, int* th_out, int* tw_out) {
  const int groups = cdiv(C, 8);
  const int n_block = 8 * n_tiles(O);
  const double mma =
      static_cast<double>(1LL * kBlockM * cdiv(kTaps * kTaps * groups, 2) *
                          (n_block / 8)) /
      8;
  bool found = false;
  double best = 0;
  for (int tw = 1; tw <= std::min(W, kBlockM); ++tw) {
    int th = std::min(kBlockM / tw, H);
    while (th > 1 && choose_layout(th, tw, C, n_block).total > kMaxSmem) --th;
    if (choose_layout(th, tw, C, n_block).total > kMaxSmem) continue;
    const int patch = (th + 4) * (tw + 4) * groups;
    const double cost =
        static_cast<double>(1LL * cdiv(H, th) * cdiv(W, tw)) *
        (mma + patch + 1000);
    if (!found || cost < best) {
      found = true, best = cost;
      *th_out = th, *tw_out = tw;
    }
  }
  return found;
}

cudaError_t launch_bf16(const void* x, const void* kern, void* y, int N,
                        int hl, int src0, int hs, int ws, int C, int H, int W,
                        int O, int row0, int rows, int th, int tw,
                        cudaStream_t stream) {
  if (th <= 0 || tw <= 0 || th * tw > kBlockM) return cudaErrorInvalidValue;
  const int o_chunks = cdiv(O, 8 * kMaxNT);
  const int nt = n_tiles(O);
  MmaParams p;
  p.x = static_cast<const bf16*>(x);
  p.k = static_cast<const bf16*>(kern);
  p.y = static_cast<bf16*>(y);
  p.N = N, p.hs = hs, p.ws = ws, p.C = C, p.H = H, p.W = W, p.O = O;
  p.hl = hl, p.src0 = src0, p.row0 = row0, p.rows = rows;
  p.th = th, p.tw = tw, p.tiles_x = (W + tw - 1) / tw;
  p.tiles = p.tiles_x * ((rows + th - 1) / th);
  p.n_block = 8 * nt;
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  p.vec_x = C % 8 == 0 && xa % 16 == 0  ? 8
            : C % 4 == 0 && xa % 8 == 0 ? 4
            : C % 2 == 0 && xa % 4 == 0 ? 2
                                        : 1;
  p.vec_k = !aligned(kern) ? (O % 2 == 0 ? 2 : 1)
            : O % 8 == 0   ? 8
            : O % 4 == 0   ? 4
            : O % 2 == 0   ? 2
                           : 1;
  p.vec_y = O % 8 == 0 && aligned(y) ? 8 : O % 2 == 0 ? 2 : 1;
  if (p.vec_k == 2 && reinterpret_cast<uintptr_t>(kern) % 4 != 0) p.vec_k = 1;
  const Layout L = choose_layout(th, tw, C, p.n_block);
  if (L.total > kMaxSmem) return cudaErrorInvalidValue;
  p.resident = L.resident;
  const dim3 grid = p.resident ? dim3(N * p.tiles, o_chunks, 1)
                               : dim3(p.tiles, o_chunks, N);
  switch (nt) {
#define EDE_NT(k) \
  case k:         \
    return launch_mma_nt<k>(p, grid, L.total, stream);
    EDE_NT(1) EDE_NT(2) EDE_NT(3) EDE_NT(4) EDE_NT(5) EDE_NT(6) EDE_NT(7)
    EDE_NT(8) EDE_NT(9) EDE_NT(10) EDE_NT(11) EDE_NT(12) EDE_NT(13)
    EDE_NT(14) EDE_NT(15) EDE_NT(16)
#undef EDE_NT
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. (th, tw): the bf16 kernel's output tile
// (th * tw <= 256), ede_upsample_conv_tile's for (rows, W); the f32 kernel
// ignores it. x holds source rows [src0, src0 + hl) of hs, y output rows
// [row0, row0 + rows) of H (the row window above). Returns a cudaError_t
// (0 on success).
int ede_upsample_conv_window(int dtype, const void* x, const void* kern,
                             void* y, int N, int hl, int src0, int hs, int ws,
                             int C, int H, int W, int O, int row0, int rows,
                             int th, int tw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src0 < 0 || hl <= 0 || src0 + hl > hs || row0 < 0 || rows <= 0 ||
      row0 + rows > H)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_f32(x, kern, y, N, hl, src0, hs, ws, C, H, W, O, row0,
                      rows, s);
  if (dtype == 1)
    return launch_bf16(x, kern, y, N, hl, src0, hs, ws, C, H, W, O, row0,
                       rows, th, tw, s);
  return cudaErrorInvalidValue;
}

// The whole image: the window (0, hs, 0, H).
int ede_upsample_conv(int dtype, const void* x, const void* kern, void* y,
                      int N, int hs, int ws, int C, int H, int W, int O,
                      int th, int tw, void* stream) {
  return ede_upsample_conv_window(dtype, x, kern, y, N, hs, 0, hs, ws, C, H,
                                  W, O, 0, H, th, tw, stream);
}

// The bf16 kernel's output tile for an (H, W) output of C -> O channels
// into tile[0] = th, tile[1] = tw (see choose_tile). Returns a cudaError_t
// (0 on success).
int ede_upsample_conv_tile(int H, int W, int C, int O, int* tile) {
  if (H <= 0 || W <= 0 || C <= 0 || O <= 0) return cudaErrorInvalidValue;
  return choose_tile(H, W, C, O, &tile[0], &tile[1]) ? cudaSuccess
                                                      : cudaErrorInvalidValue;
}

const char* ede_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
