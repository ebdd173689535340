// Talking-heads softmax forward for Hopper (sm_90a): CaiT's hot path.
//
// Replaces passl_tpu/ops/pallas/talking_heads.py::_fwd_kernel. For every
// (n, q) row of the [n, h, q, k] score tensor s it computes
//
//     p[g] = sum_i ww[i, g] * softmax_k( sum_j wl[j, i] * s[j] )
//
// with both head mixes and the softmax in f32, and stores p at s's type.
//
// Bound: device-memory bytes. Per call the kernel must read s once and write
// p once, 2 * n * h * q * k * sizeof(T) bytes (79 MB for CaiT-S24's
// [64, 8, 196, 196] in bf16: 23.5 us at 3.35 TB/s); the h^2 FMAs per element are far
// below the card's compute rate. Done as three separate ops (mix, softmax,
// mix), the scores would make three round trips through device memory.
//
// Design: one block per (n, q) row, threads across k. Each thread loads its
// columns' h scores into registers once, does mix 1 there (weights from
// shared memory), takes the per-head row max and sum through warp shuffles
// and one pass over shared memory, normalizes, does mix 2 in registers and
// stores once. The h x k row never leaves registers, so s is read once and
// p written once. H (heads) and C (columns per thread) are template
// parameters so the per-thread arrays stay in registers.
//
// No q padding: the TPU kernel padded q to its VMEM tile; here a row is a
// block and the ragged k edge is masked per thread.

#include "talking_heads.cuh"

namespace {

using namespace passl_th;

template <typename T, int H, int C>
__global__ void __launch_bounds__(kMaxThreads)
talking_heads_fwd_kernel(const T* __restrict__ s, const float* __restrict__ proj_l,
                         const float* __restrict__ proj_w, T* __restrict__ out,
                         int q_len, int k_len) {
  __shared__ float wl[H * H];
  __shared__ float ww[H * H];
  __shared__ float red_max[H * kMaxWarps];
  __shared__ float red_sum[H * kMaxWarps];

  for (int i = threadIdx.x; i < H * H; i += blockDim.x) {
    wl[i] = proj_l[i];
    ww[i] = proj_w[i];
  }
  __syncthreads();

  // row = n * q_len + qi; head i of the row starts at s + base + i * head_stride
  const int64_t row = blockIdx.x;
  const int64_t n = row / q_len;
  const int64_t qi = row - n * q_len;
  const int64_t head_stride = (int64_t)q_len * k_len;
  const int64_t base = n * H * head_stride + qi * k_len;

  // mix 1 in registers: mixed[c][g] = sum_i wl[i, g] * s[i] at column c
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
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < H; ++i) acc = fmaf(x[i], wl[i * H + g], acc);
      mixed[c][g] = valid ? acc : -INFINITY;
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

  // normalize, then mix 2 in registers: p[g] = sum_i ww[i, g] * p_mid[i]
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = threadIdx.x + c * blockDim.x;
    if (col >= k_len) continue;
    float p_mid[H];
#pragma unroll
    for (int i = 0; i < H; ++i) p_mid[i] = mixed[c][i] / row_sum[i];
#pragma unroll
    for (int g = 0; g < H; ++g) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < H; ++i) acc = fmaf(p_mid[i], ww[i * H + g], acc);
      out[base + g * head_stride + col] = from_f32<T>(acc);
    }
  }
}

template <typename T, int H>
cudaError_t launch_h(const void* s, const float* wl, const float* ww, void* out, int n, int q,
                     int k, cudaStream_t stream) {
  const int64_t rows = (int64_t)n * q;
#define PASSL_TH_LAUNCH(C)                                                                  \
  {                                                                                         \
    talking_heads_fwd_kernel<T, H, C><<<(unsigned)rows, threads_for(k, C), 0, stream>>>(    \
        static_cast<const T*>(s), wl, ww, static_cast<T*>(out), q, k);                      \
    return cudaGetLastError();                                                              \
  }
  switch (cols_per_thread(k)) {
    case 1: PASSL_TH_LAUNCH(1)
    case 2: PASSL_TH_LAUNCH(2)
    case 4: PASSL_TH_LAUNCH(4)
    default: return cudaErrorInvalidValue;
  }
#undef PASSL_TH_LAUNCH
}

template <typename T>
cudaError_t launch_t(const void* s, const float* wl, const float* ww, void* out, int n, int h,
                     int q, int k, cudaStream_t stream) {
  switch (h) {
    case 4: return launch_h<T, 4>(s, wl, ww, out, n, q, k, stream);
    case 6: return launch_h<T, 6>(s, wl, ww, out, n, q, k, stream);
    case 8: return launch_h<T, 8>(s, wl, ww, out, n, q, k, stream);
    case 16: return launch_h<T, 16>(s, wl, ww, out, n, q, k, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. Shapes: s and out [n, h, q, k]
// contiguous; proj_l and proj_w [h, h] float32 contiguous, all on `device`.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int passl_talking_heads_fwd(const void* s, const void* proj_l, const void* proj_w,
                                       void* out, int n, int h, int q, int k, int dtype,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || q <= 0 || k <= 0 || k > passl_th::kMaxCols * passl_th::kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const float* wl = static_cast<const float*>(proj_l);
  const float* ww = static_cast<const float*>(proj_w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = launch_t<float>(s, wl, ww, out, n, h, q, k, st); break;
    case 1: err = launch_t<__nv_bfloat16>(s, wl, ww, out, n, h, q, k, st); break;
    case 2: err = launch_t<__half>(s, wl, ww, out, n, h, q, k, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// Largest k the kernel takes (columns per thread times threads per block).
extern "C" int passl_talking_heads_max_k() { return passl_th::kMaxCols * passl_th::kMaxThreads; }
