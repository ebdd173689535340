// Fused augmentation for Hopper (sm_90a): BYOL's on-device recipe in one pass.
//
// For each image [H, W, C] uint8 and its draws (u0, u1, u2) in [0, 1):
//
//     x     = u8 * (1/255)
//     sigma = smin + (smax - smin) u0;  blur = u1 < blur_prob;  sol = u2 < solarize_prob
//     blur: separable gaussian over |d| <= taps / 2, weights exp(-(d / max(sigma, 1e-3))^2 / 2),
//           each output position divided by the sum of its in-bounds taps (rows, then
//           columns; a horizontal neighbour is C elements away, same channel)
//     sol:  x >= thr ? 1 - x : x
//     out   = (x - mean[c]) * (1 / std[c]) as bf16
//
// Replaces passl_tpu/ops/pallas/augment_kernel.py::_augment_kernel, which
// draws on the TPU's core PRNG and does the taps as two dense banded matrix
// products on the MXU (about 270 MFLOP per 224^2 image). Here the draws come
// in (the wrapper takes them from a seeded torch.Generator) and the taps run
// directly: 2 taps flops per element and pass, about 92 per element at 23 taps.
//
// Bound at [128, 224, 224, 3], every image blurred: bytes read once and
// written once are N H W C (1 + 2) = 57.8 MB, 17 us at 3.35 TB/s; the taps
// are N H W C 4 taps = 1.77 GFLOP, 26 us at the 67 TFLOP/s of f32.
//
// Design. One block per (image, band of rows). A blurred image's block
// stages its band's uint8 rows with a taps / 2 halo in shared memory, takes
// the vertical pass into an f32 shared tile, then the horizontal pass from
// that tile; an image whose blur coin is off reads its pixels straight from
// device memory (the branch is uniform across the block). Taps' weights and
// the per-position edge denominators come from sigma once per block. Stores
// are bf16 pairs where the row width W C is even.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBand = 16;
constexpr size_t kMaxSmem = 200 * 1024;
constexpr float kInv255 = 1.0f / 255.0f;

struct Params {
  const uint8_t* img;
  const float* draws;  // [N, 3]
  const float* chan;   // [2, C]: mean, 1 / std
  __nv_bfloat16* out;
  int H, W, C, band, n_bands, r;
  float blur_prob, solarize_prob, smin, span, thr;
};

// floats ahead of the tile: weights [2r + 1], 1/den of the columns [W] and of
// the band's rows [band], mean [C], 1/std [C]
__host__ __device__ inline size_t head_floats(int r, int W, int band, int C) {
  return (size_t)(2 * r + 1) + W + band + 2 * C;
}

__host__ inline size_t smem_bytes(int r, int W, int C, int band) {
  const size_t wc = (size_t)W * C;
  return head_floats(r, W, band, C) * sizeof(float) + (size_t)band * wc * sizeof(float) +
         (size_t)(band + 2 * r) * wc;
}

__device__ __forceinline__ float finish(float x, int c, bool sol, float thr, const float* mean,
                                        const float* inv_std) {
  if (sol && x >= thr) x = 1.0f - x;
  return (x - mean[c]) * inv_std[c];
}

// f(i, col) for row i of the band and column col of the row, stored at
// dst[i * wc + col]
template <typename F>
__device__ __forceinline__ void store_band(F f, __nv_bfloat16* dst, int rows, int wc) {
  if ((wc & 1) == 0) {
    const int pairs = rows * wc / 2;
    __nv_bfloat162* dst2 = reinterpret_cast<__nv_bfloat162*>(dst);
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      const int e = 2 * p;
      const int i = e / wc;
      const int col = e - i * wc;
      dst2[p] = __floats2bfloat162_rn(f(i, col), f(i, col + 1));
    }
  } else {
    for (int e = threadIdx.x; e < rows * wc; e += blockDim.x) {
      const int i = e / wc;
      dst[e] = __float2bfloat16_rn(f(i, e - i * wc));
    }
  }
}

__global__ void __launch_bounds__(kThreads) augment_kernel(Params p) {
  extern __shared__ float smem[];
  const int n = blockIdx.x / p.n_bands;
  const int y0 = (blockIdx.x - n * p.n_bands) * p.band;
  const int rows = min(p.band, p.H - y0);
  const int W = p.W, C = p.C, H = p.H, r = p.r, taps = 2 * r + 1;
  const int wc = W * C;

  float* wts = smem;
  float* inv_den_w = wts + taps;
  float* inv_den_h = inv_den_w + W;
  float* mean = inv_den_h + p.band;
  float* inv_std = mean + C;
  float* tile = smem + head_floats(r, W, p.band, C);  // [band, wc] f32
  uint8_t* stage = reinterpret_cast<uint8_t*>(tile + (size_t)p.band * wc);  // [band + 2r, wc]

  const float u0 = p.draws[3 * n], u1 = p.draws[3 * n + 1], u2 = p.draws[3 * n + 2];
  const float sigma = p.smin + p.span * u0;
  const bool blur = u1 < p.blur_prob;
  const bool sol = u2 < p.solarize_prob;
  const float thr = p.thr;
  const uint8_t* src = p.img + ((int64_t)n * H + y0) * wc;
  __nv_bfloat16* dst = p.out + ((int64_t)n * H + y0) * wc;

  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    mean[c] = p.chan[c];
    inv_std[c] = p.chan[C + c];
  }
  if (!blur) {
    __syncthreads();
    store_band([&](int i, int col) {
      return finish((float)src[i * wc + col] * kInv255, col % C, sol, thr, mean, inv_std);
    }, dst, rows, wc);
    return;
  }

  const float s = fmaxf(sigma, 1e-3f);
  for (int t = threadIdx.x; t < taps; t += blockDim.x) {
    const float d = (float)(t - r) / s;
    wts[t] = expf(-0.5f * (d * d));
  }
  // the band's rows and their halo, clipped to the image
  const int ylo = max(y0 - r, 0), yhi = min(y0 + rows + r, H);
  const uint8_t* src_lo = p.img + ((int64_t)n * H + ylo) * wc;
  uint8_t* stage_lo = stage + (size_t)(ylo - (y0 - r)) * wc;
  for (int e = threadIdx.x; e < (yhi - ylo) * wc; e += blockDim.x) stage_lo[e] = src_lo[e];
  __syncthreads();

  // edge denominators: the in-bounds taps of each column and of each band row
  for (int x = threadIdx.x; x < W + rows; x += blockDim.x) {
    const int pos = x < W ? x : y0 + (x - W);
    const int lim = x < W ? W : H;
    float den = 0.0f;
    for (int t = max(0, r - pos); t < min(taps, lim - pos + r); ++t) den += wts[t];
    if (x < W) inv_den_w[x] = 1.0f / den;
    else inv_den_h[x - W] = 1.0f / den;
  }
  __syncthreads();

  // vertical pass: tile[i, col] over the rows y0 + i + d in [0, H)
  for (int e = threadIdx.x; e < rows * wc; e += blockDim.x) {
    const int i = e / wc;
    const int col = e - i * wc;
    const int y = y0 + i;
    float acc = 0.0f;
    for (int t = max(0, r - y); t < min(taps, H - y + r); ++t)
      acc += wts[t] * ((float)stage[(size_t)(i + t) * wc + col] * kInv255);
    tile[e] = acc * inv_den_h[i];
  }
  __syncthreads();

  // horizontal pass over the columns x + d in [0, W) of the same channel
  store_band([&](int i, int col) {
    const int x = col / C;
    const int c = col - x * C;
    const float* row = tile + (size_t)i * wc + c;
    float acc = 0.0f;
    for (int t = max(0, r - x); t < min(taps, W - x + r); ++t) acc += wts[t] * row[(x + t - r) * C];
    return finish(acc * inv_den_w[x], c, sol, thr, mean, inv_std);
  }, dst, rows, wc);
}

}  // namespace

// The rows per block for an image of width W, C channels at `taps` taps
// (0 when not even one row fits in shared memory).
extern "C" int passl_fused_augment_band(int H, int W, int C, int taps) {
  const int r = taps / 2;
  for (int band = H < kMaxBand ? H : kMaxBand; band > 0; --band)
    if (smem_bytes(r, W, C, band) <= kMaxSmem) return band;
  return 0;
}

// img [N, H, W, C] uint8, draws [N, 3] f32, chan [2, C] f32 (mean, 1 / std),
// out [N, H, W, C] bf16, all contiguous on `device`; sigma = smin + span u0. Launches on `stream`;
// returns cudaGetLastError() after the launch.
extern "C" int passl_fused_augment(const void* img, const void* draws, const void* chan, void* out,
                                   int N, int H, int W, int C, int taps, float blur_prob,
                                   float solarize_prob, float smin, float span, float thr,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int band = passl_fused_augment_band(H, W, C, taps);
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || taps <= 0 || band == 0)
    return (int)cudaErrorInvalidValue;
  const int n_bands = (H + band - 1) / band;
  if ((int64_t)N * n_bands >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  Params p{static_cast<const uint8_t*>(img), static_cast<const float*>(draws),
           static_cast<const float*>(chan), static_cast<__nv_bfloat16*>(out), H, W, C, band,
           n_bands, taps / 2, blur_prob, solarize_prob, smin, span, thr};
  const size_t smem = smem_bytes(p.r, W, C, band);
  err = cudaFuncSetAttribute(augment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  augment_kernel<<<(unsigned)(N * n_bands), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
