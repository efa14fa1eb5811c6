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
// Design: a block walks tpb output tiles (tr x tc pixels) of one image and
// one slice of channels, all chosen on the host from the shape alone
// (choose_config, which the wrapper asks once a shape); the next
// tile's input (with halo, zeros for the padding) is in flight by cp.async
// into a second shared-memory buffer while it computes one, so each input
// vector leaves device memory once per block. Each thread owns V channels
// as one 16-byte vector (8 bf16 or 4 f32; V = 1 where C is not a multiple
// of that or x is not 16-byte aligned), and computes a run of R outputs
// along a tile row: for each kernel row it loads the row's (R-1)*S + K
// input vectors once, with all loads in flight, unpacks each once, and
// does all K * R products from registers (taps from shared memory, unpacked
// once a row), into R x V f32 accumulators. The launch spaces pixels in
// shared memory so that each quarter-warp's 16-byte reads fall in 8
// different bank quads. swish takes the SFU's ex2 and rcp (a few ulp of
// f32). y leaves in 16-byte stores. The SE sums are deterministic: each
// block reduces its per-channel sums in a fixed order into a partial; the
// last block of an image to finish (an atomic counter per image, after a
// __threadfence) adds the image's partials in block order and resets the
// counter to 0 for the next launch, as csrc/fused_depth_loss.cu does for
// the loss. Stride 1 and 2, the function's domain, are compiled apart.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "launch_cache.cuh"

namespace {

constexpr int kMaxThreads = 256;
// Outputs of a row a thread computes at a time: 2 where a stride-2 k5 row's
// 7 input vectors already take the registers.
__host__ __device__ constexpr int run_length(int k, int stride) {
  return stride == 2 && k == 5 ? 2 : 4;
}
// Blocks an SM: three for stride-1 k5, whose long tap loop wants the warps
// more than the registers, else two; shared memory a block then has.
__host__ __device__ constexpr int min_blocks(int k, int s) {
  return k == 5 && s == 1 ? 3 : 2;
}
__host__ __device__ constexpr int max_smem(int k, int s) {
  return min_blocks(k, s) == 3 ? 72 * 1024 : 100 * 1024;
}

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

// V consecutive elements of T (16 bytes when V > 1): loaded raw, unpacked
// to f32, and packed back.
template <typename T, int V>
struct Vec {
  static_assert(V * sizeof(T) == 16 || V == 1, "a 16-byte vector or one");
  using Raw = typename std::conditional<V == 1, T, uint4>::type;
  __device__ __forceinline__ static Raw load(const T* p) {
    return *reinterpret_cast<const Raw*>(p);
  }
  __device__ __forceinline__ static void unpack(const Raw& raw,
                                                float (&f)[V]) {
    if constexpr (V == 1) {
      f[0] = to_f32(raw);
    } else if constexpr (sizeof(T) == 2) {
      // bf16 pairs: the low one shifted up, the high one masked, one
      // integer op each.
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f[2 * j] = __uint_as_float(w[j] << 16);
        f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
      }
    } else {
      f[0] = __uint_as_float(raw.x), f[1] = __uint_as_float(raw.y);
      f[2] = __uint_as_float(raw.z), f[3] = __uint_as_float(raw.w);
    }
  }
  __device__ __forceinline__ static void pack(T* p, const float (&f)[V]) {
    if constexpr (V == 1) {
      *p = from_f32<T>(f[0]);
    } else {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int v = 0; v < V; ++v) e[v] = from_f32<T>(f[v]);
      *reinterpret_cast<uint4*>(p) = raw;
    }
  }
};

// z * sigmoid(z) = z / (1 + 2^(-z log2(e))) by the SFU's ex2 and rcp
// (each within a few ulp of f32; flushed to 0 where z < -88, where swish is
// -0).
__device__ __forceinline__ float swish(float z) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(-1.44269504f * z));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));
  return z * r;
}

// V f32 from shared memory (16-byte aligned where V > 1).
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = *p;
  } else {
#pragma unroll
    for (int j = 0; j < V / 4; ++j) {
      const float4 q = reinterpret_cast<const float4*>(p)[j];
      f[4 * j] = q.x, f[4 * j + 1] = q.y, f[4 * j + 2] = q.z;
      f[4 * j + 3] = q.w;
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0));
}

struct Params {
  const void* x;
  const void* taps;
  const float* scale;
  const float* bias;
  void* y;
  float* sums;
  float* partials;          // (B, groups, C)
  unsigned int* counters;   // (B,), 0 between launches
  int H, W, C, OH, OW, stride, pad_top, pad_left;
  int tr, tc, tiles_x, tiles;  // output tile, tiles along OW, per image
  int tpb, groups;             // tiles a block, blocks an image and slice
  int cv, slices;              // vector lanes a block, channel slices
  int ps;                      // elements between staged pixels
};

// Shared memory: a ring of kStages input tiles (the one computed on and the
// next one in flight), which the sums' reduction reuses at the end; then
// the slice's taps, scale and bias.
constexpr int kStages = 2;

struct Smem {
  int tile, buffers, taps, total;  // bytes
};

__host__ __device__ inline Smem dw_smem(int tr, int tc, int stride, int k,
                                        int cv, int v, int ps, int itemsize,
                                        int threads) {
  Smem m;
  const int ir = (tr - 1) * stride + k;
  const int ic = (tc - 1) * stride + k;
  m.tile = (ir * ic * ps * itemsize + 15) & ~15;
  m.buffers = max(kStages * m.tile, threads * v * 4);
  m.taps = k * k * cv * v * 4;  // f32
  m.total = m.buffers + m.taps + 2 * cv * v * 4;
  return m;
}

template <typename T, int V, int K, int S>
__global__ void __launch_bounds__(kMaxThreads, min_blocks(K, S))
depthwise_bn_swish_kernel(const Params p) {
  constexpr int R = run_length(K, S);
  constexpr int kIn = (R - 1) * S + K;  // input vectors of a run's row
  using V_ = Vec<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool is_last;
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int cv = p.cv;
  const int lanes = nthreads / cv;  // lanes of row runs
  const int lv = tid % cv;
  const int lp = tid / cv;
  const int b = blockIdx.z;
  const int cb = cv * V;
  const int c0 = blockIdx.y * cb;
  const int C = p.C;
  const int ir = (p.tr - 1) * S + K;
  const int ic = (p.tc - 1) * S + K;
  const int ps = p.ps;
  const Smem m = dw_smem(p.tr, p.tc, S, K, cv, V, ps, sizeof(T), nthreads);
  float* taps_s = reinterpret_cast<float*>(smem + m.buffers);
  float* scale_s = reinterpret_cast<float*>(smem + m.buffers + m.taps);
  float* bias_s = scale_s + cb;
  const T* x = static_cast<const T*>(p.x) + (size_t)b * p.H * p.W * C;

  // Stage tile t's input with its halo into buffer `buf`, zeros outside
  // the image: cp.async or, for V = 1, plain copies.
  auto stage = [&](int t, int buf) {
    T* in_s = reinterpret_cast<T*>(smem + buf * m.tile);
    const int iy0 = (t / p.tiles_x) * p.tr * S - p.pad_top;
    const int ix0 = (t % p.tiles_x) * p.tc * S - p.pad_left;
    for (int i = tid; i < ir * ic * cv; i += nthreads) {
      const int u = i % cv;
      const int pix = i / cv;
      const int r = pix / ic;
      const int iy = iy0 + r;
      const int ix = ix0 + pix - r * ic;
      const int c = c0 + u * V;
      const bool valid =
          iy >= 0 && iy < p.H && ix >= 0 && ix < p.W && c < C;
      const T* src = valid ? x + ((size_t)iy * p.W + ix) * C + c : x;
      T* dst = in_s + pix * ps + u * V;
      if constexpr (V > 1)
        cp_async16(dst, src, valid);
      else
        *dst = valid ? *src : from_f32<T>(0.f);
    }
  };
  // One commit group a tile (empty past the block's last), so that "all
  // but the newest kStages - 2 groups" is always the tile computed next.
  auto commit = [] {
    if constexpr (V > 1) asm volatile("cp.async.commit_group;\n" ::);
  };

  const int t0 = blockIdx.x * p.tpb;
  const int t1 = min(t0 + p.tpb, p.tiles);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (t0 + i < t1) stage(t0 + i, i);
    commit();
  }
  const T* taps = static_cast<const T*>(p.taps);
  for (int i = tid; i < K * K * cb; i += nthreads) {
    const int t = i / cb;
    const int c = c0 + i - t * cb;
    taps_s[i] = c < C ? to_f32(taps[(size_t)t * C + c]) : 0.f;
  }
  for (int i = tid; i < cb; i += nthreads) {
    scale_s[i] = c0 + i < C ? p.scale[c0 + i] : 0.f;
    bias_s[i] = c0 + i < C ? p.bias[c0 + i] : 0.f;
  }

  const int c = c0 + lv * V;
  T* y = static_cast<T*>(p.y);
  float part[V];
#pragma unroll
  for (int v = 0; v < V; ++v) part[v] = 0.f;
  for (int t = t0; t < t1; ++t) {
    const int buf = (t - t0) % kStages;
    if constexpr (V > 1)
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();  // tile t (and the taps) landed; tile t - 1 is read
    if (t + kStages - 1 < t1)
      stage(t + kStages - 1, (buf + kStages - 1) % kStages);
    commit();
    const T* in_s = reinterpret_cast<const T*>(smem + buf * m.tile);
    const int oy0 = (t / p.tiles_x) * p.tr;
    const int ox0 = (t % p.tiles_x) * p.tc;
    // Runs of R outputs along a tile row; a warp's lanes are the cv
    // channel vectors of one run, then of the next run along the row.
    const int rpr = p.tc / R;
    for (int q = lp; q < p.tr * rpr; q += lanes) {
      const int ty = q / rpr;
      const int tx = (q - ty * rpr) * R;
      const T* row = in_s + (ty * S * ic + tx * S) * ps + lv * V;
      float acc[R][V];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[r][v] = 0.f;
#pragma unroll 1
      for (int di = 0; di < K; ++di, row += ic * ps) {
        // The row's inputs first, all loads in flight, then the products.
        typename V_::Raw in_raw[kIn];
#pragma unroll
        for (int j = 0; j < kIn; ++j) in_raw[j] = V_::load(row + j * ps);
        float w[K][V];
#pragma unroll
        for (int dj = 0; dj < K; ++dj)
          load_f32(taps_s + (di * K + dj) * cb + lv * V, w[dj]);
#pragma unroll
        for (int j = 0; j < kIn; ++j) {
          float in[V];
          V_::unpack(in_raw[j], in);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int dj = j - r * S;
            if (dj < 0 || dj >= K) continue;  // resolved at compile time
#pragma unroll
            for (int v = 0; v < V; ++v) acc[r][v] += in[v] * w[dj][v];
          }
        }
      }
      const int oy = oy0 + ty;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int ox = ox0 + tx + r;
        if (oy >= p.OH || ox >= p.OW || c >= C) continue;
        float out[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int cl = lv * V + v;
          const float z = acc[r][v] * scale_s[cl] + bias_s[cl];
          out[v] = swish(z);
          part[v] += out[v];
        }
        T* dst = y + (((size_t)b * p.OH + oy) * p.OW + ox) * C + c;
        V_::pack(dst, out);
      }
    }
  }

  // The block's per-channel sums, lanes added in order.
  __syncthreads();  // the last tile is read
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int v = 0; v < V; ++v) red[lp * cb + lv * V + v] = part[v];
  __syncthreads();
  float* partials = p.partials + (size_t)b * p.groups * C;
  for (int cl = tid; cl < cb; cl += nthreads) {
    if (c0 + cl >= C) continue;
    float sum = 0.f;
    for (int q = 0; q < lanes; ++q) sum += red[q * cb + cl];
    partials[(size_t)blockIdx.x * C + c0 + cl] = sum;
    __threadfence();  // the partial is visible before the count below
  }
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(&p.counters[b], 1u) ==
              static_cast<unsigned>(p.groups * p.slices - 1);
  __syncthreads();
  if (is_last) {
    // Every partial of image b is written; add them in block order.
    const volatile float* vpart = partials;
    for (int ch = tid; ch < C; ch += nthreads) {
      float sum = 0.f;
      for (int g = 0; g < p.groups; ++g) sum += vpart[(size_t)g * C + ch];
      p.sums[(size_t)b * C + ch] = sum;
    }
    if (tid == 0) p.counters[b] = 0;
  }
}

template <typename T, int V, int K, int S>
cudaError_t launch_k(const Params& p, dim3 grid, int threads, int smem,
                     cudaStream_t stream) {
  const cudaError_t err = ede::allow_smem(
      reinterpret_cast<const void*>(depthwise_bn_swish_kernel<T, V, K, S>),
      smem);
  if (err != cudaSuccess) return err;
  depthwise_bn_swish_kernel<T, V, K, S><<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_v(const Params& p, int B, int K, int lanes,
                     cudaStream_t stream) {
  const int threads = p.cv * lanes;
  if (threads > kMaxThreads) return cudaErrorInvalidValue;
  const int smem = dw_smem(p.tr, p.tc, p.stride, K, p.cv, V, p.ps,
                          sizeof(T), threads).total;
  if (smem > max_smem(K, p.stride) || p.tc % run_length(K, p.stride) != 0)
    return cudaErrorInvalidValue;
  const dim3 grid(p.groups, p.slices, B);
  const int ks = K * 10 + p.stride;
  if (ks == 31) return launch_k<T, V, 3, 1>(p, grid, threads, smem, stream);
  if (ks == 32) return launch_k<T, V, 3, 2>(p, grid, threads, smem, stream);
  if (ks == 51) return launch_k<T, V, 5, 1>(p, grid, threads, smem, stream);
  if (ks == 52) return launch_k<T, V, 5, 2>(p, grid, threads, smem, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(const Params& p, int B, int K, int vec, int lanes,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec) return launch_v<T, kVec>(p, B, K, lanes, stream);
  if (vec == 1) return launch_v<T, 1>(p, B, K, lanes, stream);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------- launch shape ----

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The most 16-byte reads of one quarter-warp that share a bank quad: lanes
// are cv channel vectors of a run, then of the next run, whose input starts
// `step` pixels on, pixels `units` 16-byte units apart.
int bank_ways(int cv, int units, int step) {
  int ways = 1;
  for (int q = 0; q < 32; q += 8) {
    int quad[8];
    for (int i = 0; i < 8; ++i)
      quad[i] = ((q + i) / cv * step * units + (q + i) % cv) % 8;
    for (int i = 0; i < 8; ++i)
      ways = std::max(ways, static_cast<int>(std::count(quad, quad + 8,
                                                        quad[i])));
  }
  return ways;
}

// Elements between neighbouring pixels of the staged input tile: the least
// number of 16-byte units >= cv that leaves the fewest bank conflict ways
// (returned in *ways). Scalar lanes (vec 1) read 2 or 4 bytes: no padding.
int pixel_stride(int cv, int vec, int step, int* ways) {
  *ways = 1;
  if (vec == 1) return cv;
  int best = cv;
  *ways = bank_ways(cv, cv, step);
  for (int u = cv + 1; u < cv + 8; ++u) {
    const int w = bank_ways(cv, u, step);
    if (w < *ways) best = u, *ways = w;
  }
  return best * vec;
}

struct Config {
  int vec, cv, lanes, ps, tr, tc, tpb;
};

// The launch for a (B, OH, OW, C) output on a card of `sms` SMs.
//
// vec: channels a thread (16 bytes' worth where C and x's alignment allow,
// else 1); cv: vector lanes a block, so a block covers cv * vec channels;
// lanes: lanes of row runs, at most 256 / cv and no more than the tile has
// runs, so that no warp of the block idles; ps: pixel_stride; tr x tc: the
// output tile, tc a multiple of run_length; tpb: tiles of one image a block
// walks. Among the tiles whose two input buffers, halo and taps fit the
// shared memory a block may take (max_smem), it takes the one with the
// least warp work summed over tiles: staged input vectors (weighted by 4:
// they come from device memory; by 8 where a block's slice of a pixel is
// under a 32-byte sector), the tap products of all the block's warps in
// every round of runs (a last, partial round keeps the others waiting;
// times 1 + half the extra bank conflict ways, which slow the reads but not
// the products), and a fixed cost a warp and tile. tpb is as large as
// leaves two waves of blocks on the card. False if no tile fits.
bool choose_config(int B, int OH, int OW, int C, int K, int S, int itemsize,
                   bool vec_ok, int sms, Config* out) {
  const int full = 16 / itemsize;
  const int vec = vec_ok && C % full == 0 ? full : 1;
  const int nv = cdiv(C, vec);
  const int run = run_length(K, S);
  bool lane_count[33] = {};
  for (int d = 1; d <= 32; d *= 2) lane_count[d] = d <= nv;
  for (int d = 16; d <= 32; ++d) lane_count[d] |= nv % d == 0;
  if (nv <= 32) lane_count[nv] = true;
  bool found = false;
  double best = 0;
  int best_slices = 0;
  for (int cv = 1; cv <= 32; ++cv) {
    if (!lane_count[cv]) continue;
    const int slices = cdiv(nv, cv);
    const int load = cv < nv && cv * vec * itemsize < 32 ? 8 : 4;
    int ways;
    const int ps = pixel_stride(cv, vec, run * S, &ways);
    for (int tc = run; tc <= cdiv(OW, run) * run; tc += run) {
      for (int tr = 1; tr <= OH; ++tr) {
        const int runs = tr * tc / run;
        const int lanes = std::min(kMaxThreads / cv, runs);
        if (dw_smem(tr, tc, S, K, cv, vec, ps, itemsize, cv * lanes).total >
            max_smem(K, S))
          break;
        const int ir = (tr - 1) * S + K, ic = (tc - 1) * S + K;
        const int warps = cdiv(cv * lanes, 32);
        const double per_tile =
            static_cast<double>(load * ir * ic * cv) / 32 +
            static_cast<double>(1LL * cdiv(runs, lanes) * warps * run * K *
                                K) *
                (1 + (ways - 1) / 2.0) +
            10 * warps;
        const double cost =
            static_cast<double>(1LL * slices * cdiv(OH, tr) * cdiv(OW, tc)) *
            per_tile;
        if (!found || cost < best) {
          found = true, best = cost, best_slices = slices;
          *out = Config{vec, cv, lanes, ps, tr, tc, 0};
        }
      }
    }
  }
  if (!found) return false;
  const long long tiles = 1LL * cdiv(OH, out->tr) * cdiv(OW, out->tc);
  const long long waves = 2LL * min_blocks(K, S) * sms;
  out->tpb = static_cast<int>(
      std::max(1LL, std::min(tiles, 1LL * B * best_slices * tiles / waves)));
  return true;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. The launch is ede_depthwise_config's: vec
// (channels a thread: 16 bytes' worth, or 1), cv (vector lanes a block),
// lanes (row-run lanes a block: cv * lanes <= 256 threads), ps (elements
// between staged pixels, >= cv * vec), the output tile tr x tc (tc a
// multiple of run_length), tpb (tiles a block); stride 1 or 2. partials:
// (B, groups, C) f32 scratch, groups = ceil(tiles / tpb);
// counters: (B,) uint32, zero before the launch and left zero by it, so
// launches that run in order (on one stream) may share them. Returns a
// cudaError_t (0 on success).
int ede_depthwise_bn_swish(int dtype, const void* x, const void* taps,
                           const float* scale, const float* bias, void* y,
                           float* sums, float* partials, void* counters,
                           int B, int H, int W, int C, int OH, int OW, int K,
                           int stride, int pad_top, int pad_left, int vec,
                           int cv, int lanes, int ps, int tr, int tc,
                           int tpb, void* stream) {
  if (cv <= 0 || lanes <= 0 || ps < cv * vec || tr <= 0 || tc <= 0 ||
      tpb <= 0)
    return cudaErrorInvalidValue;
  Params p;
  p.x = x, p.taps = taps, p.scale = scale, p.bias = bias, p.y = y;
  p.sums = sums, p.partials = partials;
  p.counters = static_cast<unsigned int*>(counters);
  p.H = H, p.W = W, p.C = C, p.OH = OH, p.OW = OW, p.stride = stride;
  p.pad_top = pad_top, p.pad_left = pad_left;
  p.tr = tr, p.tc = tc;
  p.tiles_x = (OW + tc - 1) / tc;
  p.tiles = p.tiles_x * ((OH + tr - 1) / tr);
  p.cv = cv;
  p.slices = ((C + vec - 1) / vec + cv - 1) / cv;
  p.tpb = tpb;
  p.groups = (p.tiles + tpb - 1) / tpb;
  p.ps = ps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, B, K, vec, lanes, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, B, K, vec, lanes, s);
  return cudaErrorInvalidValue;
}

// The launch (vec, cv, lanes, ps, tr, tc, tpb) into out[0..6] for a
// (B, OH, OW, C) output of a k x k, stride `stride` call with x of
// `itemsize` bytes an element, 16-byte aligned if x_aligned, on a card of
// `sms` SMs (see choose_config). Returns a cudaError_t (0 on success).
int ede_depthwise_config(int B, int OH, int OW, int C, int K, int stride,
                         int itemsize, int x_aligned, int sms, int* out) {
  if ((K != 3 && K != 5) || (stride != 1 && stride != 2) ||
      (itemsize != 2 && itemsize != 4) || B <= 0 || OH <= 0 || OW <= 0 ||
      C <= 0 || sms <= 0)
    return cudaErrorInvalidValue;
  Config cfg;
  if (!choose_config(B, OH, OW, C, K, stride, itemsize, x_aligned != 0, sms,
                     &cfg))
    return cudaErrorInvalidValue;
  out[0] = cfg.vec, out[1] = cfg.cv, out[2] = cfg.lanes, out[3] = cfg.ps;
  out[4] = cfg.tr, out[5] = cfg.tc, out[6] = cfg.tpb;
  return cudaSuccess;
}

const char* ede_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
