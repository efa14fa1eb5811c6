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
// it does 25*C multiply-adds per output value on C <= 80 input channels that
// were read once, hundreds of operations per byte moved. This first version
// runs them on the CUDA cores (67 TFLOP/s f32 at best), not the tensor
// cores (989 TFLOP/s bf16) that the bound is taken against; moving the
// inner product to wgmma is later work.
//
// Design: a block owns a 32x16 tile of output pixels and 16 output
// channels of one image; each of its 256 threads owns two pixels (rows ty
// and ty+16) x 16 channels in registers. Input channels go through in
// chunks of 8. For each chunk the block interpolates its (32+4)x(16+4)
// halo patch of U straight from x into shared memory, writing zeros where
// the patch leaves the image; this is the role `_padded_matrix` plays in
// the Pallas kernel, and U never reaches device memory. The chunk's 25x8x16
// weights go to shared memory beside it. Every thread then reads each
// weight as a broadcast float4 and each patch value once per tap, so a
// tap costs 2 patch loads and 4 weight loads for 32 FMAs. The weight
// tensor of the widest site (80x80x25 bf16 = 320 KB) would not fit a
// block's 227 KB of shared memory; chunking over C and tiling O keeps the
// block at 36 KB of static shared memory, so several blocks share an SM.
// The interpolation weights come from float64 arithmetic, as the host
// matrices of the JAX and PyTorch versions do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 5;
constexpr int kHalo = kTaps / 2;
constexpr int kTileW = 16;
constexpr int kThreadRows = 16;          // threads per tile column
constexpr int kRowsPerThread = 2;
constexpr int kTileH = kThreadRows * kRowsPerThread;
constexpr int kPatchH = kTileH + 2 * kHalo;
constexpr int kPatchW = kTileW + 2 * kHalo;
constexpr int kChunkC = 8;
constexpr int kTileO = 16;
constexpr int kThreads = kTileW * kThreadRows;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample_conv_kernel(const T* __restrict__ x, const T* __restrict__ kern,
                     T* __restrict__ y, int hs, int ws, int C, int H, int W,
                     int O, int o_tiles) {
  __shared__ float patch[kChunkC][kPatchH][kPatchW];
  __shared__ __align__(16) float wts[kChunkC][kTaps * kTaps][kTileO];

  const int tid = threadIdx.x;
  const int tx = tid % kTileW;
  const int ty = tid / kTileW;
  const int n = blockIdx.z / o_tiles;
  const int o0 = (blockIdx.z % o_tiles) * kTileO;
  const int P0 = blockIdx.y * kTileH;
  const int Q0 = blockIdx.x * kTileW;
  const double step_h = H > 1 ? double(hs - 1) / double(H - 1) : 0.0;
  const double step_w = W > 1 ? double(ws - 1) / double(W - 1) : 0.0;
  const T* xn = x + (size_t)n * hs * ws * C;

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
      if (c < C && R >= 0 && R < H && Q >= 0 && Q < W) {
        int r0, r1, q0, q1;
        float wr0, wr1, wq0, wq1;
        source(R, step_h, hs, &r0, &r1, &wr0, &wr1);
        source(Q, step_w, ws, &q0, &q1, &wq0, &wq1);
        // rows first, then columns, as the separable matrix form does
        const float t0 = wr0 * to_f32(xn[((size_t)r0 * ws + q0) * C + c]) +
                         wr1 * to_f32(xn[((size_t)r1 * ws + q0) * C + c]);
        const float t1 = wr0 * to_f32(xn[((size_t)r0 * ws + q1) * C + c]) +
                         wr1 * to_f32(xn[((size_t)r1 * ws + q1) * C + c]);
        v = to_f32(from_f32<T>(wq0 * t0 + wq1 * t1));
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
      wts[cl][tap][ol] = (c < C && o < O)
                             ? to_f32(kern[((size_t)tap * C + c) * O + o])
                             : 0.f;
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
    if (P < H && Q < W) {
      T* yp = y + (((size_t)n * H + P) * W + Q) * O + o0;
#pragma unroll
      for (int j = 0; j < kTileO; ++j)
        if (o0 + j < O) yp[j] = from_f32<T>(acc[r][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* kern, void* y, int N, int hs,
                   int ws, int C, int H, int W, int O, cudaStream_t stream) {
  const int o_tiles = (O + kTileO - 1) / kTileO;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH,
                  N * o_tiles);
  upsample_conv_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(kern),
      static_cast<T*>(y), hs, ws, C, H, W, O, o_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
int ede_upsample_conv(int dtype, const void* x, const void* kern, void* y,
                      int N, int hs, int ws, int C, int H, int W, int O,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, kern, y, N, hs, ws, C, H, W, O, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, kern, y, N, hs, ws, C, H, W, O, s);
  return cudaErrorInvalidValue;
}

const char* ede_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
