// Fused Sobel + 4-term depth loss: per-image sums (forward) and dL/dpred
// (backward), each in one pass over pred and target.
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
// What bounds it on the H100: bytes. The forward reads 6 bytes a pixel
// (bf16 pred, f32 target) and the backward 6 and writes 2 (bf16 dp); the
// arithmetic, about 60 flops, 3 logs and a sqrt a pixel, is far below the
// card's rate. At the training batch (64 x 114 x 152) that is ~2 us and
// ~2.6 us of memory time, less than a launch costs. The design therefore
// reads each input once: a block stages a 32x16 tile of pred and target
// with its halo in shared memory (1 pixel for the forward, 2 for the
// backward), computes both Sobel pairs there, and the gradients, the
// terms and the A/B fields never reach device memory. The forward reduces
// a block's terms with warp shuffles into one (4,) partial; the last block
// of an image to finish (an atomic counter per image) adds the image's
// partials in tile order, so the sums do not change from run to run.
// logf and sqrtf are the full-precision functions (no --use_fast_math).
// sign(0) is 0, as jnp.sign: flat regions give an exactly zero gradient.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kThreads = 256;
constexpr int kThreadRows = kThreads / kTileW;        // 8
constexpr int kRowsPerThread = kTileH / kThreadRows;  // 2
constexpr int kWarps = kThreads / 32;
constexpr int kTerms = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// jnp.sign: -1, 0 or 1 (copysignf would give +-1 at zero).
__device__ __forceinline__ float sign0(float v) {
  return static_cast<float>(v > 0.f) - static_cast<float>(v < 0.f);
}

// Sobel (gx, gy) at (r, c) of a zero-padded shared tile, in the order of
// fused_loss.py:_sobel2d.
template <int kW>
__device__ __forceinline__ void sobel(float (*s)[kW], int r, int c, float* gx,
                                      float* gy) {
  const float tl = s[r - 1][c - 1], tc = s[r - 1][c], tr = s[r - 1][c + 1];
  const float ml = s[r][c - 1], mr = s[r][c + 1];
  const float bl = s[r + 1][c - 1], bc = s[r + 1][c], br = s[r + 1][c + 1];
  *gx = (tl - tr) + 2.0f * (ml - mr) + (bl - br);
  *gy = (tl + 2.0f * tc + tr) - (bl + 2.0f * bc + br);
}

// Stage the tile at (y0, x0) with a `halo`-pixel ring, zeros outside the
// image, pred converted to f32.
template <typename T, int kH, int kW>
__device__ __forceinline__ void load_tile(const T* __restrict__ pred,
                                          const float* __restrict__ target,
                                          float (*sp)[kW], float (*st)[kW],
                                          size_t img, int H, int W, int y0,
                                          int x0, int halo) {
  for (int i = threadIdx.x; i < kH * kW; i += kThreads) {
    const int r = i / kW;
    const int c = i % kW;
    const int y = y0 - halo + r;
    const int x = x0 - halo + c;
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    const size_t at = img + (size_t)y * W + x;
    sp[r][c] = in ? to_f32(pred[at]) : 0.f;
    st[r][c] = in ? target[at] : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
loss_fwd_kernel(const T* __restrict__ pred, const float* __restrict__ target,
                float* __restrict__ partials,
                unsigned int* __restrict__ counters, float* __restrict__ sums,
                int H, int W, int tiles_x, int tiles) {
  constexpr int kPH = kTileH + 2;
  constexpr int kPW = kTileW + 2;
  __shared__ float sp[kPH][kPW];
  __shared__ float st[kPH][kPW];
  __shared__ float warp_sums[kWarps][kTerms];
  __shared__ bool is_last;

  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int tile = blockIdx.x;
  const int y0 = (tile / tiles_x) * kTileH;
  const int x0 = (tile % tiles_x) * kTileW;
  load_tile<T, kPH, kPW>(pred, target, sp, st, (size_t)n * H * W, H, W, y0,
                         x0, 1);
  __syncthreads();

  float acc[kTerms] = {0.f, 0.f, 0.f, 0.f};
  const int tx = tid % kTileW;
  const int ty = tid / kTileW;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = ty + k * kThreadRows;
    if (y0 + r < H && x0 + tx < W) {
      float gxo, gyo, gxd, gyd;
      sobel<kPW>(sp, r + 1, tx + 1, &gxo, &gyo);
      sobel<kPW>(st, r + 1, tx + 1, &gxd, &gyd);
      const float p = sp[r + 1][tx + 1];
      const float t = st[r + 1][tx + 1];
      acc[0] += logf(fabsf(p - t) + 0.5f);
      acc[1] += logf(fabsf(gxo - gxd) + 0.5f);
      acc[2] += logf(fabsf(gyo - gyd) + 0.5f);
      const float dot = gxo * gxd + gyo * gyd + 1.0f;
      const float norm = sqrtf((gxo * gxo + gyo * gyo + 1.0f) *
                               (gxd * gxd + gyd * gyd + 1.0f));
      acc[3] += fabsf(1.0f - dot / norm);
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int j = 0; j < kTerms; ++j)
      acc[j] += __shfl_down_sync(0xffffffffu, acc[j], off);
  if ((tid & 31) == 0)
#pragma unroll
    for (int j = 0; j < kTerms; ++j) warp_sums[tid >> 5][j] = acc[j];
  __syncthreads();

  float* part = partials + (size_t)n * tiles * kTerms;
  if (tid < kTerms) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w][tid];
    part[tile * kTerms + tid] = s;
    __threadfence();  // the partial is visible before the count below
  }
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(&counters[n], 1u) == static_cast<unsigned>(tiles - 1);
  __syncthreads();
  if (is_last && tid < kTerms) {
    // Every partial of image n is written; add them in tile order.
    const volatile float* vpart = part;
    float s = 0.f;
    for (int t = 0; t < tiles; ++t) s += vpart[t * kTerms + tid];
    sums[n * kTerms + tid] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
loss_bwd_kernel(const T* __restrict__ pred, const float* __restrict__ target,
                const float* __restrict__ mask, const float* __restrict__ coef,
                T* __restrict__ dp, int H, int W, int tiles_x) {
  constexpr int kLH = kTileH + 4;  // 2-pixel halo of the inputs
  constexpr int kLW = kTileW + 4;
  constexpr int kAH = kTileH + 2;  // 1-pixel ring of A and B
  constexpr int kAW = kTileW + 2;
  __shared__ float sp[kLH][kLW];
  __shared__ float st[kLH][kLW];
  __shared__ float sa[kAH][kAW];
  __shared__ float sb[kAH][kAW];

  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int tile = blockIdx.x;
  const int y0 = (tile / tiles_x) * kTileH;
  const int x0 = (tile % tiles_x) * kTileW;
  const size_t img = (size_t)n * H * W;
  load_tile<T, kLH, kLW>(pred, target, sp, st, img, H, W, y0, x0, 2);
  __syncthreads();

  // A and B on the tile and its ring; 0 outside the image.
  for (int i = tid; i < kAH * kAW; i += kThreads) {
    const int r = i / kAW;
    const int c = i % kAW;
    const int y = y0 - 1 + r;
    const int x = x0 - 1 + c;
    float a = 0.f, b = 0.f;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      float gxo, gyo, gxd, gyd;
      sobel<kLW>(sp, r + 1, c + 1, &gxo, &gyo);
      sobel<kLW>(st, r + 1, c + 1, &gxd, &gyd);
      const float ex = gxo - gxd;
      const float ey = gyo - gyd;
      const float ddx = sign0(ex) / (fabsf(ex) + 0.5f);
      const float ddy = sign0(ey) / (fabsf(ey) + 0.5f);
      const float dot = gxo * gxd + gyo * gyd + 1.0f;
      const float no2 = gxo * gxo + gyo * gyo + 1.0f;
      const float no = sqrtf(no2);
      const float nd = sqrtf(gxd * gxd + gyd * gyd + 1.0f);
      const float cs = dot / (no * nd);
      const float s = -sign0(1.0f - cs);  // d|1-c|/dc
      a = ddx + s * (gxd / (no * nd) - cs * gxo / no2);
      b = ddy + s * (gyd / (no * nd) - cs * gyo / no2);
    }
    sa[r][c] = a;
    sb[r][c] = b;
  }
  __syncthreads();

  const float scale = mask[n] * coef[0];
  const int tx = tid % kTileW;
  const int ty = tid / kTileW;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = ty + k * kThreadRows;
    const int y = y0 + r;
    const int x = x0 + tx;
    if (y < H && x < W) {
      const int ar = r + 1;
      const int ac = tx + 1;
      // correlation with kx_flip = [[-1,0,1],[-2,0,2],[-1,0,1]]
      const float gfx = (sa[ar - 1][ac + 1] - sa[ar - 1][ac - 1]) +
                        2.0f * (sa[ar][ac + 1] - sa[ar][ac - 1]) +
                        (sa[ar + 1][ac + 1] - sa[ar + 1][ac - 1]);
      // correlation with ky_flip = [[-1,-2,-1],[0,0,0],[1,2,1]]
      const float gfy =
          (sb[ar + 1][ac - 1] + 2.0f * sb[ar + 1][ac] + sb[ar + 1][ac + 1]) -
          (sb[ar - 1][ac - 1] + 2.0f * sb[ar - 1][ac] + sb[ar - 1][ac + 1]);
      const float d = sp[r + 2][tx + 2] - st[r + 2][tx + 2];
      const float d_depth = sign0(d) / (fabsf(d) + 0.5f);
      dp[img + (size_t)y * W + x] =
          from_f32<T>((d_depth + gfx + gfy) * scale);
    }
  }
}

int tiles_x_of(int W) { return (W + kTileW - 1) / kTileW; }
int tiles_of(int H, int W) {
  return tiles_x_of(W) * ((H + kTileH - 1) / kTileH);
}

template <typename T>
cudaError_t launch_fwd(const void* pred, const void* target, void* partials,
                       void* counters, void* sums, int N, int H, int W,
                       cudaStream_t stream) {
  const dim3 grid(tiles_of(H, W), N);
  loss_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(pred), static_cast<const float*>(target),
      static_cast<float*>(partials), static_cast<unsigned int*>(counters),
      static_cast<float*>(sums), H, W, tiles_x_of(W), tiles_of(H, W));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* pred, const void* target, const void* mask,
                       const void* coef, void* dp, int N, int H, int W,
                       cudaStream_t stream) {
  const dim3 grid(tiles_of(H, W), N);
  loss_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(pred), static_cast<const float*>(target),
      static_cast<const float*>(mask), static_cast<const float*>(coef),
      static_cast<T*>(dp), H, W, tiles_x_of(W));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tiles per image: the forward's `partials` hold N * tiles * 4 floats.
int ede_fused_depth_loss_tiles(int H, int W) { return tiles_of(H, W); }

// dtype (of pred and dp): 0 = float32, 1 = bfloat16; target is float32.
// counters: N zeroed uint32. Returns a cudaError_t (0 on success).
int ede_fused_depth_loss_fwd(int dtype, const void* pred, const void* target,
                             void* partials, void* counters, void* sums,
                             int N, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(pred, target, partials, counters, sums, N, H, W,
                             s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(pred, target, partials, counters, sums,
                                     N, H, W, s);
  return cudaErrorInvalidValue;
}

int ede_fused_depth_loss_bwd(int dtype, const void* pred, const void* target,
                             const void* mask, const void* coef, void* dp,
                             int N, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(pred, target, mask, coef, dp, N, H, W, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(pred, target, mask, coef, dp, N, H, W,
                                     s);
  return cudaErrorInvalidValue;
}

const char* ede_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
