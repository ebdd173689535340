// Talking-heads softmax backward for Hopper (sm_90a): the gradient of
// CaiT's p[g] = sum_i ww[i, g] * softmax_k( sum_j wl[j, i] * s[j] ).
//
// Replaces passl_tpu/ops/pallas/talking_heads.py::_bwd_kernel. Given the
// scores s and the incoming gradient dp (both [n, h, q, k]) it recomputes
// the forward's p_mid from s and computes, in f32,
//
//     dp_mid[i] = sum_g ww[i, g] * dp[g]
//     ds_mid[g] = p_mid[g] * (dp_mid[g] - sum_k dp_mid[g] * p_mid[g])
//     ds[j]     = sum_g wl[j, g] * ds_mid[g]                (stored at s's type)
//     dwl[i, g] = sum over (n, q, k) of s[i] * ds_mid[g]
//     dww[i, g] = sum over (n, q, k) of p_mid[i] * dp[g]
//
// Only s is kept from the forward, as in the JAX package's custom VJP.
//
// Bound: device-memory bytes. It must read s and dp once and write ds once,
// 3 * n * h * q * k * sizeof(T) bytes (118 MB for CaiT-S24's
// [64, 8, 196, 196] in bf16: 35 us at 3.35 TB/s). The per-element work is
// three h-wide mixes plus the 2 * h weight-gradient products.
//
// Design. The TPU kernel summed dwl and dww as SMEM scalars across its
// sequential grid; a CUDA grid runs in no order, so the sums go in two
// stages, both in a fixed order and with no atomics, which makes the weight
// gradients bitwise the same on every launch:
//   1. talking_heads_bwd_kernel: a fixed grid of G blocks, each taking a run
//      of consecutive (n, q) rows. Per row, threads run across k as in the
//      forward (h scores per column in registers; max, sum and the
//      sum_k dp_mid * p_mid dot as block reductions). p_mid and ds_mid of
//      the row go to shared memory; then each warp takes one head row of s
//      (for a row of dwl) or of dp (for a column of dww), its lanes split k,
//      and lane 0 adds the warp's h sums into the block's accumulators in
//      shared memory. At the end the block writes its 2 h^2 partial sums.
//   2. talking_heads_wgrad_reduce: sums the G partials of each of the 2 h^2
//      outputs in block order.
// Registers hold the forward's h x C mixed scores per thread and nothing
// h x h: the accumulators live in shared memory.

#include "talking_heads.cuh"

namespace {

using namespace passl_th;

constexpr int kRowsPerBlockTarget = 1024;  // G = ceil(rows / ceil(rows / 1024)) blocks
constexpr int kReduceWarps = 32;           // stage 2: warps splitting the G partials

template <typename T, int H, int C>
__global__ void __launch_bounds__(kMaxThreads)
talking_heads_bwd_kernel(const T* __restrict__ s, const T* __restrict__ dp,
                         const float* __restrict__ proj_l, const float* __restrict__ proj_w,
                         T* __restrict__ ds, float* __restrict__ partials, int q_len, int k_len,
                         int64_t rows, int rows_per_block) {
  __shared__ float wl[H * H];
  __shared__ float ww[H * H];
  __shared__ float acc[2 * H * H];  // this block's dwl (first h^2) and dww sums
  __shared__ float red_max[H * kMaxWarps];
  __shared__ float red_sum[H * kMaxWarps];
  __shared__ float red_dot[H * kMaxWarps];
  extern __shared__ float dyn[];    // p_mid [H][k_len], then dp_mid / ds_mid [H][k_len]
  float* pm = dyn;
  float* dsm = dyn + (size_t)H * k_len;

  for (int i = threadIdx.x; i < H * H; i += blockDim.x) {
    wl[i] = proj_l[i];
    ww[i] = proj_w[i];
  }
  for (int i = threadIdx.x; i < 2 * H * H; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int64_t head_stride = (int64_t)q_len * k_len;
  const int64_t row0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t row_end = row0 + rows_per_block < rows ? row0 + rows_per_block : rows;

  for (int64_t row = row0; row < row_end; ++row) {
    const int64_t n = row / q_len;
    const int64_t qi = row - n * q_len;
    const int64_t base = n * H * head_stride + qi * k_len;

    // recompute the forward: mix 1 in registers, row max, exp, row sum
    float mixed[C][H];
    float row_max[H];
#pragma unroll
    for (int g = 0; g < H; ++g) row_max[g] = -INFINITY;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = threadIdx.x + c * blockDim.x;
      const bool valid = col < k_len;
      float x[H];
#pragma unroll
      for (int i = 0; i < H; ++i) x[i] = valid ? to_f32(s[base + i * head_stride + col]) : 0.f;
#pragma unroll
      for (int g = 0; g < H; ++g) {
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < H; ++i) a = fmaf(x[i], wl[i * H + g], a);
        mixed[c][g] = valid ? a : -INFINITY;
        row_max[g] = fmaxf(row_max[g], mixed[c][g]);
      }
    }
    block_reduce<H, true>(row_max, red_max);

    float row_sum[H];
#pragma unroll
    for (int g = 0; g < H; ++g) row_sum[g] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int g = 0; g < H; ++g) {
        mixed[c][g] = expf(mixed[c][g] - row_max[g]);  // masked columns: exp(-inf) = 0
        row_sum[g] += mixed[c][g];
      }
    }
    block_reduce<H, false>(row_sum, red_sum);

    // p_mid to registers and shared memory; dp_mid = ww-mix of dp; the dot
    float dot[H];
#pragma unroll
    for (int g = 0; g < H; ++g) dot[g] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = threadIdx.x + c * blockDim.x;
      if (col >= k_len) continue;
      float d[H];
#pragma unroll
      for (int g = 0; g < H; ++g) {
        mixed[c][g] = mixed[c][g] / row_sum[g];
        pm[g * k_len + col] = mixed[c][g];
        d[g] = to_f32(dp[base + g * head_stride + col]);
      }
#pragma unroll
      for (int i = 0; i < H; ++i) {
        float m = 0.f;
#pragma unroll
        for (int g = 0; g < H; ++g) m = fmaf(ww[i * H + g], d[g], m);
        dsm[i * k_len + col] = m;  // dp_mid for now; each thread owns its columns
        dot[i] = fmaf(m, mixed[c][i], dot[i]);
      }
    }
    block_reduce<H, false>(dot, red_dot);

    // ds_mid in place of dp_mid; ds = wl-mix of ds_mid, stored once
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = threadIdx.x + c * blockDim.x;
      if (col >= k_len) continue;
      float dm[H];
#pragma unroll
      for (int g = 0; g < H; ++g) {
        dm[g] = mixed[c][g] * (dsm[g * k_len + col] - dot[g]);
        dsm[g * k_len + col] = dm[g];
      }
#pragma unroll
      for (int j = 0; j < H; ++j) {
        float v = 0.f;
#pragma unroll
        for (int g = 0; g < H; ++g) v = fmaf(wl[j * H + g], dm[g], v);
        ds[base + j * head_stride + col] = from_f32<T>(v);
      }
    }
    __syncthreads();  // pm and dsm of the row are complete

    // weight gradients of the row. Task t = (matrix, j) reads one head row
    // of s or dp from device memory (L1-hot) once and the shared-memory rows
    // against it: m = 0 gives row j of dwl (s[j] against ds_mid[g], all g),
    // m = 1 column j of dww (dp[j] against p_mid[i], all i). Warp w owns
    // tasks w, w + nwarps, ..., so every sum has one fixed owner
    for (int t = warp; t < 2 * H; t += nwarps) {
      const int m = t / H;
      const int j = t - m * H;
      const T* src = (m == 0 ? s : dp) + base + j * head_stride;
      const float* against = m == 0 ? dsm : pm;
      float part[H];
#pragma unroll
      for (int r = 0; r < H; ++r) part[r] = 0.f;
      for (int col = lane; col < k_len; col += 32) {
        const float a = to_f32(src[col]);
#pragma unroll
        for (int r = 0; r < H; ++r) part[r] = fmaf(a, against[r * k_len + col], part[r]);
      }
#pragma unroll
      for (int r = 0; r < H; ++r) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) part[r] += __shfl_xor_sync(0xffffffffu, part[r], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < H; ++r) {
          // dwl[j][r] = sum s[j] ds_mid[r]; dww[r][j] = sum p_mid[r] dp[j]
          acc[m == 0 ? j * H + r : H * H + r * H + j] += part[r];
        }
      }
    }
    __syncthreads();  // the next row overwrites pm and dsm; red_* reads are done
  }

  float* out = partials + (int64_t)blockIdx.x * 2 * H * H;
  for (int i = threadIdx.x; i < 2 * H * H; i += blockDim.x) out[i] = acc[i];
}

// dwl and dww from the G per-block partials: block b of 32 lanes x 32 warps
// covers outputs [32 b, 32 b + 32); warp w sums partials w, w + 32, ... in
// order, then warp 0 sums the 32 warp results in order.
__global__ void __launch_bounds__(32 * kReduceWarps)
talking_heads_wgrad_reduce(const float* __restrict__ partials, int num_partials, int hh,
                           float* __restrict__ dwl, float* __restrict__ dww) {
  __shared__ float red[kReduceWarps][33];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int o = blockIdx.x * 32 + lane;
  const int outputs = 2 * hh;
  float v = 0.f;
  if (o < outputs) {
    for (int b = warp; b < num_partials; b += kReduceWarps) v += partials[(int64_t)b * outputs + o];
  }
  red[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && o < outputs) {
    float r = red[0][lane];
    for (int w = 1; w < kReduceWarps; ++w) r += red[w][lane];
    if (o < hh) dwl[o] = r; else dww[o - hh] = r;
  }
}

int64_t rows_per_block(int64_t rows) {
  return (rows + kRowsPerBlockTarget - 1) / kRowsPerBlockTarget;
}

int64_t num_blocks(int64_t rows) {
  const int64_t rpb = rows_per_block(rows);
  return (rows + rpb - 1) / rpb;
}

template <typename T, int H, int C>
cudaError_t launch_c(const void* s, const void* dp, const float* wl, const float* ww, void* ds,
                     float* partials, int n, int q, int k, cudaStream_t stream) {
  const int64_t rows = (int64_t)n * q;
  const size_t smem = 2 * (size_t)H * k * sizeof(float);
  auto kernel = talking_heads_bwd_kernel<T, H, C>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)num_blocks(rows), threads_for(k, C), smem, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(dp), wl, ww, static_cast<T*>(ds), partials,
      q, k, rows, (int)rows_per_block(rows));
  return cudaGetLastError();
}

template <typename T, int H>
cudaError_t launch_h(const void* s, const void* dp, const float* wl, const float* ww, void* ds,
                     float* partials, int n, int q, int k, cudaStream_t stream) {
  switch (cols_per_thread(k)) {
    case 1: return launch_c<T, H, 1>(s, dp, wl, ww, ds, partials, n, q, k, stream);
    case 2: return launch_c<T, H, 2>(s, dp, wl, ww, ds, partials, n, q, k, stream);
    case 4: return launch_c<T, H, 4>(s, dp, wl, ww, ds, partials, n, q, k, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(const void* s, const void* dp, const float* wl, const float* ww, void* ds,
                     float* partials, int n, int h, int q, int k, cudaStream_t stream) {
  switch (h) {
    case 4: return launch_h<T, 4>(s, dp, wl, ww, ds, partials, n, q, k, stream);
    case 6: return launch_h<T, 6>(s, dp, wl, ww, ds, partials, n, q, k, stream);
    case 8: return launch_h<T, 8>(s, dp, wl, ww, ds, partials, n, q, k, stream);
    case 16: return launch_h<T, 16>(s, dp, wl, ww, ds, partials, n, q, k, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Number of per-block partials the backward writes for n * q rows: the
// wrapper allocates `partials` as [this, 2 * h * h] float32.
extern "C" long long passl_talking_heads_bwd_blocks(int n, int q) {
  return (long long)num_blocks((int64_t)n * q);
}

// dtype: 0 float32, 1 bfloat16, 2 float16. Shapes: s, dp and ds [n, h, q, k]
// contiguous at `dtype`; proj_l, proj_w, dproj_l, dproj_w [h, h] float32;
// partials [passl_talking_heads_bwd_blocks(n, q), 2 h h] float32 scratch; all
// on `device`. Launches both stages on `stream`; returns cudaGetLastError()
// after them (0 on success).
extern "C" int passl_talking_heads_bwd(const void* s, const void* dp, const void* proj_l,
                                       const void* proj_w, void* ds, void* partials,
                                       void* dproj_l, void* dproj_w, int n, int h, int q, int k,
                                       int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || q <= 0 || k <= 0 || k > kMaxCols * kMaxThreads) return (int)cudaErrorInvalidValue;
  const float* wl = static_cast<const float*>(proj_l);
  const float* ww = static_cast<const float*>(proj_w);
  float* part = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = launch_t<float>(s, dp, wl, ww, ds, part, n, h, q, k, st); break;
    case 1: err = launch_t<__nv_bfloat16>(s, dp, wl, ww, ds, part, n, h, q, k, st); break;
    case 2: err = launch_t<__half>(s, dp, wl, ww, ds, part, n, h, q, k, st); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int outputs = 2 * h * h;
  talking_heads_wgrad_reduce<<<(outputs + 31) / 32, 32 * kReduceWarps, 0, st>>>(
      part, (int)num_blocks((int64_t)n * q), h * h, static_cast<float*>(dproj_l),
      static_cast<float*>(dproj_w));
  return (int)cudaGetLastError();
}
