// Fused depthwise conv + folded eval BatchNorm + swish + SE spatial sums.
//
// Replaces the Pallas kernel efficientdepthestimation_tpu/ops/pallas/
// depthwise.py:120 `depthwise_bn_swish` (body `_kernel`, :86-117):
//
//     y[b,oy,ox,c] = swish(sum_{di,dj} x[b, oy*s-pt+di, ox*s-pl+dj, c]
//                                      * taps[di,dj,c] * scale[c] + bias[c])
//     sums[b,c]    = sum_{oy,ox} y[b,oy,ox,c]     (f32, before the cast)
//
// x is NHWC in bf16 or f32, zero-padded asymmetrically (top/left given;
// bottom/right implied by the output size), any stride, k = 3 or 5.
// Products are accumulated in f32; y is rounded to x's type once.
//
// What bounds it on the H100: memory. Each output element costs k*k FMAs
// (9 or 25) on inputs that neighbouring outputs share, so the work per byte
// moved is far below the ~20 FLOP/byte at which the CUDA cores (67 TFLOP/s
// f32) would become the limit at 3.35 TB/s. ENB0's 16 depthwise sites move
// about 2.1 GB per 128-frame bf16 forward, about 0.64 ms at the memory rate.
//
// Design: threads run along C (threadIdx.x, 32 channel lanes) so each load
// and store of a warp covers 32 neighbouring channels of one pixel, which
// are neighbouring addresses in NHWC. threadIdx.y (8 pixel lanes) walks a
// tile of 256 output pixels; a block is (channel slice, pixel tile, batch
// element). The k*k taps of a thread's channel stay in registers. The
// input window is read from device memory through L1; neighbouring pixels
// of the tile reuse it from there. The SE sums leave the tile through a
// shared-memory reduction over the pixel lanes and then one f32 atomicAdd
// per (block, b, c) into a (B, C) buffer that the launch zeroes first on
// the same stream. The order of those atomics varies between runs, so the
// sums are not bitwise deterministic (differences are f32 rounding only).
// Stride-2 sites and every spatial size run here too: the Pallas version
// sent them to XLA, a block on this card has no reason to.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChannelLanes = 32;
constexpr int kPixelLanes = 8;
constexpr int kPixelsPerBlock = 256;

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

template <typename T, int K>
__global__ void __launch_bounds__(kChannelLanes * kPixelLanes)
depthwise_bn_swish_kernel(const T* __restrict__ x, const T* __restrict__ taps,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias, T* __restrict__ y,
                          float* __restrict__ sums, int H, int W, int C,
                          int OH, int OW, int stride, int pad_top,
                          int pad_left) {
  const int c = blockIdx.x * kChannelLanes + threadIdx.x;
  const int b = blockIdx.z;
  const int npix = OH * OW;
  const int p0 = blockIdx.y * kPixelsPerBlock;
  const int p_end = min(p0 + kPixelsPerBlock, npix);

  float partial = 0.f;
  if (c < C) {
    float w[K * K];
#pragma unroll
    for (int t = 0; t < K * K; ++t) w[t] = to_f32(taps[(size_t)t * C + c]);
    const float sc = scale[c];
    const float bi = bias[c];
    const T* xb = x + (size_t)b * H * W * C + c;
    T* yb = y + (size_t)b * npix * C + c;
    for (int p = p0 + threadIdx.y; p < p_end; p += kPixelLanes) {
      const int oy = p / OW;
      const int ox = p - oy * OW;
      const int iy0 = oy * stride - pad_top;
      const int ix0 = ox * stride - pad_left;
      float acc = 0.f;
#pragma unroll
      for (int di = 0; di < K; ++di) {
        const int iy = iy0 + di;
        if (iy < 0 || iy >= H) continue;
#pragma unroll
        for (int dj = 0; dj < K; ++dj) {
          const int ix = ix0 + dj;
          if (ix < 0 || ix >= W) continue;
          acc += to_f32(xb[((size_t)iy * W + ix) * C]) * w[di * K + dj];
        }
      }
      float v = acc * sc + bi;
      v = v / (1.f + expf(-v));
      yb[(size_t)p * C] = from_f32<T>(v);
      partial += v;
    }
  }

  __shared__ float red[kPixelLanes][kChannelLanes];
  red[threadIdx.y][threadIdx.x] = partial;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kPixelLanes; ++i) s += red[i][threadIdx.x];
    atomicAdd(&sums[(size_t)b * C + c], s);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* taps, const float* scale,
                   const float* bias, void* y, float* sums, int B, int H,
                   int W, int C, int OH, int OW, int K, int stride,
                   int pad_top, int pad_left, cudaStream_t stream) {
  const dim3 block(kChannelLanes, kPixelLanes);
  const dim3 grid((C + kChannelLanes - 1) / kChannelLanes,
                  (OH * OW + kPixelsPerBlock - 1) / kPixelsPerBlock, B);
  const T* xt = static_cast<const T*>(x);
  const T* tt = static_cast<const T*>(taps);
  T* yt = static_cast<T*>(y);
  if (K == 3) {
    depthwise_bn_swish_kernel<T, 3><<<grid, block, 0, stream>>>(
        xt, tt, scale, bias, yt, sums, H, W, C, OH, OW, stride, pad_top,
        pad_left);
  } else if (K == 5) {
    depthwise_bn_swish_kernel<T, 5><<<grid, block, 0, stream>>>(
        xt, tt, scale, bias, yt, sums, H, W, C, OH, OW, stride, pad_top,
        pad_left);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
int ede_depthwise_bn_swish(int dtype, const void* x, const void* taps,
                           const float* scale, const float* bias, void* y,
                           float* sums, int B, int H, int W, int C, int OH,
                           int OW, int K, int stride, int pad_top,
                           int pad_left, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(sums, 0, sizeof(float) * (size_t)B * C, s);
  if (err != cudaSuccess) return err;
  if (dtype == 0)
    return launch<float>(x, taps, scale, bias, y, sums, B, H, W, C, OH, OW,
                         K, stride, pad_top, pad_left, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, taps, scale, bias, y, sums, B, H, W, C,
                                 OH, OW, K, stride, pad_top, pad_left, s);
  return cudaErrorInvalidValue;
}

const char* ede_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
