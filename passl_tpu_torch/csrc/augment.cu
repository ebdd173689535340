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
// are N H W C 4 taps = 1.77 GFLOP, 26 us at the 67 TFLOP/s of f32. So the
// CUDA cores' issue bounds it, and the design spends as few instructions an
// element beside the 46 FFMA as it can.
//
// Design (`augment_fast_kernel<R, C>`, radius R = taps / 2 and C channels
// known at compile time). One block of 192 threads per (image, band of 16
// rows); the branch on the image's blur coin is uniform across the block.
//   - Staging: the band's uint8 rows and their R-row halo go to shared
//     memory with cp.async, 16 bytes a copy where every row starts 16-byte
//     aligned (4 bytes, or 1, where not), rows outside the image zero-filled
//     (src-size 0), so the passes below have no edge branches.
//   - Vertical pass: a thread owns one 32-bit word (4 interleaved columns)
//     and all 16 rows of the band. It converts each of the 16 + 2R input
//     words once (a byte permute and a subtraction) and runs a fully unrolled
//     FFMA nest into 64 independent accumulators, the weights (with 1/255
//     folded in) in registers; the row's 1/den scales the result, written to
//     an f32 tile whose rows are padded by R C zero floats on each side.
//   - Horizontal pass: a thread owns 4 pixels x C channels, contiguous in the
//     row; it reads its (4 + 2R) C window with 16-byte shared loads and runs
//     an unrolled FFMA nest with no edge branches; the epilogue does 1/den,
//     solarize, normalize and bf16 packing, and stores 8 bytes at a time.
//   - An unblurred image streams: 16-byte loads, 16-byte stores, no shared
//     memory; each thread's first chunk is loaded beside the coins' load.
// Any other (taps, C), and rows too wide for the tile, take
// `augment_generic_kernel`, the first design: the same bands with runtime
// tap loops, one element a thread. No shape is refused that fits its tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // generic kernel
constexpr int kMaxBand = 16;   // generic kernel: rows a block at most
constexpr size_t kMaxSmem = 200 * 1024;
constexpr float kInv255 = 1.0f / 255.0f;
constexpr int kMaxDevices = 64;

constexpr int kFastThreads = 192;
constexpr int kFastBlocks = 3;  // blocks an SM the launch bound asks registers for
constexpr int kBand = 16;  // fast kernel: rows a block, and rows of a thread's vertical run
constexpr int kPix = 4;    // fast kernel: pixels of a thread's horizontal run

// Params::vec bits, set by the host from the pointers and the row width
constexpr int kStage16 = 1;   // every row starts 16-byte aligned: 16-byte cp.async
constexpr int kStage4 = 2;    // every row starts 4-byte aligned: 4-byte cp.async
constexpr int kStore8 = 4;    // every output row starts 8-byte aligned: 8-byte stores
constexpr int kStream16 = 8;  // every image starts 16-byte aligned, in and out: 16-byte streaming

struct Params {
  const uint8_t* img;
  const float* draws;  // [N, 3]
  const float* chan;   // [2, C]: mean, 1 / std
  __nv_bfloat16* out;
  int H, W, C, band, n_bands, r;
  float blur_prob, solarize_prob, smin, span, thr;
  int vec;
};

struct Draws {
  float sigma;
  bool blur, sol;
};

__device__ __forceinline__ Draws image_draws(const Params& p, int n) {
  const float u0 = p.draws[3 * n], u1 = p.draws[3 * n + 1], u2 = p.draws[3 * n + 2];
  return {__fadd_rn(p.smin, __fmul_rn(p.span, u0)), u1 < p.blur_prob, u2 < p.solarize_prob};
}

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// ----------------------------------------------------------------- generic

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

__global__ void __launch_bounds__(kThreads)
augment_generic_kernel(Params p) {
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

  const Draws d = image_draws(p, n);
  const float thr = p.thr;
  const bool sol = d.sol;
  const uint8_t* src = p.img + ((int64_t)n * H + y0) * wc;
  __nv_bfloat16* dst = p.out + ((int64_t)n * H + y0) * wc;

  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    mean[c] = p.chan[c];
    inv_std[c] = p.chan[C + c];
  }
  if (!d.blur) {
    __syncthreads();
    store_band([&](int i, int col) {
      return finish((float)src[i * wc + col] * kInv255, col % C, sol, thr, mean, inv_std);
    }, dst, rows, wc);
    return;
  }

  const float s = fmaxf(d.sigma, 1e-3f);
  for (int t = threadIdx.x; t < taps; t += blockDim.x) {
    const float dd = (float)(t - r) / s;
    wts[t] = expf(-0.5f * (dd * dd));
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

// -------------------------------------------------------------------- fast

// Shared-memory layout of augment_fast_kernel<R, C> at width W, in bytes
// from the start: weights exp(-(d/s)^2/2) for d = 0..R, 1/den of the band's
// rows and of the columns; the f32 tile [kBand][ts], each row
// [left zeros][W C values][zeros]; the uint8 stage [kBand + 2R][wcp].
struct FastLayout {
  int wcp, ts, den_h, den_w;
  int tile, stage, bytes;
};

template <int R, int C>
struct Fast {
  static constexpr int kLeft = round_up(R * C, 4);      // zero floats ahead of a tile row
  static constexpr int kShift = kLeft - R * C;          // the window's start in its aligned read
  static constexpr int kWin4 = (kShift + (kPix + 2 * R) * C + 3) / 4;  // float4 a window
  static constexpr int kRows = kBand + 2 * R;           // staged rows

  __host__ __device__ static FastLayout layout(int W) {
    const int wc = W * C;
    const int groups = (W + kPix - 1) / kPix;
    const int read_end = (groups - 1) * kPix * C + 4 * kWin4;  // past the last group's read
    FastLayout l;
    l.wcp = round_up(wc, 4);
    l.ts = round_up(kLeft + wc + R * C > read_end ? kLeft + wc + R * C : read_end, 4);
    l.den_h = round_up(R + 1, 4);
    l.den_w = l.den_h + kBand;
    l.tile = 4 * (l.den_w + round_up(W, kPix));
    l.stage = l.tile + 4 * kBand * l.ts;
    l.bytes = l.stage + kRows * l.wcp;
    return l;
  }
};

__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool valid, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_size = valid ? bytes : 0;  // 0: no read, the destination zero-filled
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(src_size));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(src_size));
}

// The four bytes of `word` as exact floats: 2^23 + b, as bits, less 2^23
__device__ __forceinline__ void unpack4(uint32_t word, float (&x)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    x[e] = __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440 + e)) - 8388608.0f;
}

template <int N>
__device__ __forceinline__ float lane(const float4 (&v)[N], int k) {
  const float4& q = v[k >> 2];
  return (k & 3) == 0 ? q.x : (k & 3) == 1 ? q.y : (k & 3) == 2 ? q.z : q.w;
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float finish1(float x, float mean, float inv_std, bool sol, float thr) {
  if (sol && x >= thr) x = 1.0f - x;
  return __fmul_rn(x - mean, inv_std);
}

// The band's rows y0 - R .. y0 + kBand + R - 1 into stage [kRows][wcp], rows
// and bytes outside the image zero. Where rows start 16- or 4-byte aligned,
// wcp is wc and the staged rows are one contiguous run of the image, copied
// by cp.async in chunks that never straddle the image's top or bottom.
template <int R>
__device__ __forceinline__ void stage_rows(uint8_t* stage, const uint8_t* src, int y0, int H,
                                           int wc, int wcp, int vec) {
  constexpr int rows = kBand + 2 * R;
  if (vec & (kStage16 | kStage4)) {
    const int step = (vec & kStage16) ? 16 : 4;
    const int64_t first = (int64_t)(y0 - R) * wc, end = (int64_t)H * wc;
    for (int e = threadIdx.x * step; e < rows * wc; e += blockDim.x * step) {
      const int64_t g = first + e;
      const bool valid = g >= 0 && g < end;
      cp_async(stage + e, valid ? src + g : src, valid, step);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    for (int e = threadIdx.x; e < rows * wcp; e += blockDim.x) {
      const int j = e / wcp;
      const int k = e - j * wcp;
      const int y = y0 - R + j;
      stage[e] = (y >= 0 && y < H && k < wc) ? src[(int64_t)y * wc + k] : 0;
    }
  }
}

// acc[i][e] = sum over d in [-R, R] of wv[|d|] * column byte e of stage row i + R + d
template <int R>
__device__ __forceinline__ void vertical_pass(const uint8_t* col, int wcp,
                                              const float (&wv)[R + 1], float (&acc)[kBand][4]) {
#pragma unroll
  for (int j = 0; j < kBand + 2 * R; ++j) {
    float x[4];
    unpack4(*reinterpret_cast<const uint32_t*>(col + j * wcp), x);
#pragma unroll
    for (int i = (j > 2 * R ? j - 2 * R : 0); i <= (j < kBand - 1 ? j : kBand - 1); ++i) {
      const int d = j - i - R;
      const float w = wv[d < 0 ? -d : d];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(w, x[e], acc[i][e]);
    }
  }
}

// acc[p C + c] = sum over d in [-R, R] of wh[|d|] * the window's pixel p + R + d, channel c
template <int R, int C>
__device__ __forceinline__ void horz_taps(const float4 (&in)[Fast<R, C>::kWin4],
                                          const float (&wh)[R + 1], float (&acc)[kPix * C]) {
  constexpr int S = Fast<R, C>::kShift;
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float a = 0.0f;
#pragma unroll
      for (int t = 0; t <= 2 * R; ++t)
        a = fmaf(wh[t < R ? R - t : t - R], lane(in, S + (p + t) * C + c), a);
      acc[p * C + c] = a;
    }
  }
}

__device__ __forceinline__ uint4 load_nc(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// An unblurred band: `count` bytes from src to bf16 at dst, both starting on
// a multiple of the row width (so element e has channel e % C). With `vec`,
// chunks of 16 C bytes (C 16-byte loads, 2 C 16-byte stores); `first` is the
// thread's first chunk, loaded before the image's coins were read.
template <int C>
__device__ __forceinline__ void stream_band(const uint8_t* src, __nv_bfloat16* dst, int count,
                                            bool vec, const uint4 (&first)[C], bool sol,
                                            float thr, const float (&mean)[C],
                                            const float (&inv_std)[C], const float* chan) {
  constexpr int K = 16 * C;
  int done = 0;
  if (vec) {
    const int chunks = count / K;
    for (int k = threadIdx.x; k < chunks; k += blockDim.x) {
      uint4 in[C];
#pragma unroll
      for (int q = 0; q < C; ++q)
        in[q] = k == (int)threadIdx.x ? first[q] : load_nc(src + k * K + 16 * q);
      uint32_t out[8 * C];
#pragma unroll
      for (int w = 0; w < 4 * C; ++w) {
        const uint4& q = in[w / 4];
        float x[4];
        unpack4(w % 4 == 0 ? q.x : w % 4 == 1 ? q.y : w % 4 == 2 ? q.z : q.w, x);
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int c0 = (4 * w + e) % C, c1 = (4 * w + e + 1) % C;
          out[2 * w + e / 2] =
              pack2(finish1(__fmul_rn(x[e], kInv255), mean[c0], inv_std[c0], sol, thr),
                    finish1(__fmul_rn(x[e + 1], kInv255), mean[c1], inv_std[c1], sol, thr));
        }
      }
      uint4* o = reinterpret_cast<uint4*>(dst + k * K);
#pragma unroll
      for (int q = 0; q < 2 * C; ++q)
        o[q] = make_uint4(out[4 * q], out[4 * q + 1], out[4 * q + 2], out[4 * q + 3]);
    }
    done = chunks * K;
  }
  for (int e = done + threadIdx.x; e < count; e += blockDim.x) {
    const int c = e % C;
    dst[e] = __float2bfloat16_rn(finish1(__fmul_rn((float)src[e], kInv255), __ldg(chan + c),
                                         __ldg(chan + C + c), sol, thr));
  }
}

template <int R, int C>
__global__ void __launch_bounds__(kFastThreads, kFastBlocks)
augment_fast_kernel(Params p) {
  using F = Fast<R, C>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = p.H, W = p.W, wc = W * C;
  const FastLayout L = F::layout(W);
  float* wd = reinterpret_cast<float*>(smem_raw);
  float* inv_den_h = wd + L.den_h;
  float* inv_den_w = wd + L.den_w;
  float* tile = reinterpret_cast<float*>(smem_raw + L.tile);
  uint8_t* stage = smem_raw + L.stage;

  const int n = blockIdx.x / p.n_bands;
  const int y0 = (blockIdx.x - n * p.n_bands) * kBand;
  const int rows = min(kBand, H - y0);
  const int64_t image = (int64_t)n * H * wc;
  const uint8_t* src = p.img + image;
  __nv_bfloat16* dst = p.out + image + (int64_t)y0 * wc;
  // an unblurred band's first chunk a thread, in flight beside the draws' load
  const bool stream16 = p.vec & kStream16;
  uint4 first[C];
  if (stream16 && (int)threadIdx.x < rows * wc / (16 * C)) {
#pragma unroll
    for (int q = 0; q < C; ++q)
      first[q] = load_nc(src + (int64_t)y0 * wc + 16 * (C * threadIdx.x + q));
  }
  const Draws d = image_draws(p, n);
  float mean[C], inv_std[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    mean[c] = __ldg(p.chan + c);
    inv_std[c] = __ldg(p.chan + C + c);
  }

  if (!d.blur) {
    stream_band<C>(src + (int64_t)y0 * wc, dst, rows * wc, stream16, first, d.sol, p.thr, mean,
                   inv_std, p.chan);
    return;
  }

  stage_rows<R>(stage, src, y0, H, wc, L.wcp, p.vec);
  if (threadIdx.x <= R) {
    const float x = (float)threadIdx.x / fmaxf(d.sigma, 1e-3f);
    wd[threadIdx.x] = expf(-0.5f * (x * x));
  }
  const int pad = L.ts - wc;  // each tile row's zeros: F::kLeft ahead, the rest behind
  for (int e = threadIdx.x; e < kBand * pad; e += blockDim.x) {
    const int i = e / pad;
    const int k = e - i * pad;
    tile[i * L.ts + (k < F::kLeft ? k : wc + k)] = 0.0f;
  }
  __syncthreads();

  float wh[R + 1], wv[R + 1];  // the taps' weights, without and with 1/255
#pragma unroll
  for (int t = 0; t <= R; ++t) {
    wh[t] = wd[t];
    wv[t] = wh[t] * kInv255;
  }
  // 1/den of each column (0 past W) and of each band row (0 past H): all
  // taps' weights less those that fall off the image at either edge
  float total = wh[0];
#pragma unroll
  for (int t = 1; t <= R; ++t) total += 2.0f * wh[t];
  const int wp = round_up(W, kPix);
  for (int x = threadIdx.x; x < wp + kBand; x += blockDim.x) {
    const bool col = x < wp;
    const int pos = col ? x : y0 + (x - wp);
    const int lim = col ? W : H;
    float den = total;
    for (int t = pos + 1; t <= R; ++t) den -= wd[t];
    for (int t = max(lim - pos, 1); t <= R; ++t) den -= wd[t];
    const float inv = pos < lim ? 1.0f / den : 0.0f;
    if (col) inv_den_w[x] = inv;
    else inv_den_h[x - wp] = inv;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // vertical pass: a word of 4 columns, all kBand rows, into the tile
  const int words = (wc + 3) / 4;
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    float acc[kBand][4] = {};
    vertical_pass<R>(stage + 4 * w, L.wcp, wv, acc);
    float* t = tile + F::kLeft + 4 * w;
    if (4 * w + 4 <= wc) {
#pragma unroll
      for (int i = 0; i < kBand; ++i) {
        const float s = inv_den_h[i];
        *reinterpret_cast<float4*>(t + i * L.ts) =
            make_float4(__fmul_rn(acc[i][0], s), __fmul_rn(acc[i][1], s),
                        __fmul_rn(acc[i][2], s), __fmul_rn(acc[i][3], s));
      }
    } else {  // the last word of a row whose width is not a multiple of 4
#pragma unroll
      for (int i = 0; i < kBand; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * w + e < wc) t[i * L.ts + e] = __fmul_rn(acc[i][e], inv_den_h[i]);
    }
  }
  __syncthreads();

  // horizontal pass: kPix pixels x C channels of a row, then the epilogue;
  // the run (i, g) steps by the block's size without a division
  float neg_mean_std[C];  // the unsolarized epilogue's one FFMA: acc (den / std) - mean / std
#pragma unroll
  for (int c = 0; c < C; ++c) neg_mean_std[c] = -mean[c] * inv_std[c];
  const int groups = wp / kPix;
  const int di = blockDim.x / groups, dg = blockDim.x - di * groups;
  for (int i = threadIdx.x / groups, g = threadIdx.x - i * groups; i < rows;) {
    const int x0 = g * kPix;
    float4 in[F::kWin4];
    const float4* row = reinterpret_cast<const float4*>(tile + i * L.ts + x0 * C);
#pragma unroll
    for (int q = 0; q < F::kWin4; ++q) in[q] = row[q];
    float acc[kPix * C] = {};
    horz_taps<R, C>(in, wh, acc);
    const float4 dn = *reinterpret_cast<const float4*>(inv_den_w + x0);
    const float den[kPix] = {dn.x, dn.y, dn.z, dn.w};
    float v[kPix * C];
    if (d.sol) {
#pragma unroll
      for (int q = 0; q < kPix; ++q)
#pragma unroll
        for (int c = 0; c < C; ++c)
          v[q * C + c] = finish1(__fmul_rn(acc[q * C + c], den[q]), mean[c], inv_std[c], true,
                                 p.thr);
    } else {
#pragma unroll
      for (int q = 0; q < kPix; ++q)
#pragma unroll
        for (int c = 0; c < C; ++c)
          v[q * C + c] = fmaf(acc[q * C + c], den[q] * inv_std[c], neg_mean_std[c]);
    }
    __nv_bfloat16* o = dst + (int64_t)i * wc + x0 * C;
    if ((p.vec & kStore8) && x0 + kPix <= W) {
#pragma unroll
      for (int q = 0; q < C; ++q)
        reinterpret_cast<uint2*>(o)[q] =
            make_uint2(pack2(v[4 * q], v[4 * q + 1]), pack2(v[4 * q + 2], v[4 * q + 3]));
    } else {
#pragma unroll
      for (int j = 0; j < kPix * C; ++j)
        if (x0 + j / C < W) o[j] = __float2bfloat16_rn(v[j]);
    }
    g += dg;
    i += di;
    if (g >= groups) {
      g -= groups;
      ++i;
    }
  }
}

// ------------------------------------------------------------------ host

// Set a kernel's dynamic shared-memory limit once per device.
template <typename K>
cudaError_t allow_smem(K kernel, bool (&done)[kMaxDevices], int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (err == cudaSuccess) done[device] = true;
  return err;
}

// registers a thread, dynamic shared memory a block, blocks an SM, spilled
// bytes a thread, threads a block
template <typename K>
cudaError_t resources(K kernel, int threads, size_t smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)smem;
  out[2] = per_sm;
  out[3] = (int)attr.localSizeBytes;
  out[4] = threads;
  return cudaSuccess;
}

// One call per (R, C): the bytes of shared memory at width W into `bytes`
// when it is set, else the resources into `res` when it is set, else launch.
template <int R, int C>
cudaError_t fast_rc(const Params* p, int W, int device, cudaStream_t stream, int* res,
                    size_t* bytes, unsigned blocks) {
  const size_t smem = (size_t)Fast<R, C>::layout(W).bytes;
  if (bytes) {
    *bytes = smem;
    return cudaSuccess;
  }
  static bool done[kMaxDevices];
  cudaError_t err = allow_smem(augment_fast_kernel<R, C>, done, device);
  if (err != cudaSuccess) return err;
  if (res) return resources(augment_fast_kernel<R, C>, kFastThreads, smem, res);
  augment_fast_kernel<R, C><<<blocks, kFastThreads, smem, stream>>>(*p);
  return cudaGetLastError();
}

template <int C>
cudaError_t fast_c(int r, const Params* p, int W, int device, cudaStream_t stream, int* res,
                   size_t* bytes, unsigned blocks) {
  switch (r) {
    case 0: return fast_rc<0, C>(p, W, device, stream, res, bytes, blocks);
    case 1: return fast_rc<1, C>(p, W, device, stream, res, bytes, blocks);
    case 2: return fast_rc<2, C>(p, W, device, stream, res, bytes, blocks);
    case 4: return fast_rc<4, C>(p, W, device, stream, res, bytes, blocks);
    case 11: return fast_rc<11, C>(p, W, device, stream, res, bytes, blocks);
    case 12: return fast_rc<12, C>(p, W, device, stream, res, bytes, blocks);
    default: return cudaErrorInvalidValue;
  }
}

// The fast kernel's compiled (taps / 2, C): BYOL's 23 taps, and the tests'
cudaError_t fast(int r, int C, const Params* p, int W, int device, cudaStream_t stream, int* res,
                 size_t* bytes, unsigned blocks) {
  switch (C) {
    case 1: return fast_c<1>(r, p, W, device, stream, res, bytes, blocks);
    case 3: return fast_c<3>(r, p, W, device, stream, res, bytes, blocks);
    default: return cudaErrorInvalidValue;
  }
}

bool fast_takes(int W, int C, int taps) {
  size_t bytes = 0;
  return fast(taps / 2, C, nullptr, W, 0, nullptr, nullptr, &bytes, 0) == cudaSuccess &&
         bytes <= kMaxSmem;
}

cudaError_t allow_generic_smem(int device) {
  static bool done[kMaxDevices];
  return allow_smem(augment_generic_kernel, done, device);
}

int generic_band(int H, int W, int C, int taps) {
  const int r = taps / 2;
  for (int band = H < kMaxBand ? H : kMaxBand; band > 0; --band)
    if (smem_bytes(r, W, C, band) <= kMaxSmem) return band;
  return 0;
}

}  // namespace

// Which kernel takes [*, H, W, C] at `taps` taps: 2 the fast kernel, 1 the
// generic kernel, 0 none (a row too wide for shared memory).
extern "C" int passl_fused_augment_path(int H, int W, int C, int taps) {
  if (H <= 0 || W <= 0 || C <= 0 || taps <= 0) return 0;
  if (fast_takes(W, C, taps)) return 2;
  return generic_band(H, W, C, taps) > 0 ? 1 : 0;
}

// The resources of the kernel that takes the shape, into out[5]: registers a
// thread, dynamic shared memory a block, blocks an SM, spilled bytes a
// thread, threads a block.
extern "C" int passl_fused_augment_resources(int H, int W, int C, int taps, int device,
                                             int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (passl_fused_augment_path(H, W, C, taps)) {
    case 2: return (int)fast(taps / 2, C, nullptr, W, device, nullptr, out, nullptr, 0);
    case 1: {
      err = allow_generic_smem(device);
      if (err != cudaSuccess) return (int)err;
      return (int)resources(augment_generic_kernel, kThreads,
                            smem_bytes(taps / 2, W, C, generic_band(H, W, C, taps)), out);
    }
    default: return (int)cudaErrorInvalidValue;
  }
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
  const int path = passl_fused_augment_path(H, W, C, taps);
  if (N <= 0 || path == 0) return (int)cudaErrorInvalidValue;
  const int band = path == 2 ? (H < kBand ? H : kBand) : generic_band(H, W, C, taps);
  const int n_bands = (H + band - 1) / band;
  if ((int64_t)N * n_bands >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  const int64_t wc = (int64_t)W * C;
  const uintptr_t a = reinterpret_cast<uintptr_t>(img), o = reinterpret_cast<uintptr_t>(out);
  int vec = 0;
  if (a % 16 == 0 && wc % 16 == 0) vec |= kStage16;
  else if (a % 4 == 0 && wc % 4 == 0) vec |= kStage4;
  if (o % 8 == 0 && wc % 4 == 0) vec |= kStore8;
  if (a % 16 == 0 && o % 16 == 0 && H * wc % 16 == 0) vec |= kStream16;
  Params p{static_cast<const uint8_t*>(img), static_cast<const float*>(draws),
           static_cast<const float*>(chan), static_cast<__nv_bfloat16*>(out), H, W, C, band,
           n_bands, taps / 2, blur_prob, solarize_prob, smin, span, thr, vec};
  const unsigned blocks = (unsigned)(N * n_bands);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 2) return (int)fast(taps / 2, C, &p, W, device, s, nullptr, nullptr, blocks);
  err = allow_generic_smem(device);
  if (err != cudaSuccess) return (int)err;
  augment_generic_kernel<<<blocks, kThreads, smem_bytes(p.r, W, C, band), s>>>(p);
  return (int)cudaGetLastError();
}
