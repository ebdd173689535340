// Fused window attention forward for Hopper (sm_90a): Swin's
//
//     out = softmax(q k^T * scale + bias[h] + mask[b % nWm]) v
//
// over B window groups of L tokens (L = pack * ws^2: 98 or 49 in Swin-T).
// Replaces passl_tpu/ops/pallas/window_attention.py::_fwd_kernel: the same
// f32 scores and softmax, p rounded to q's type before p v, f32 sums, out at
// q's type. Scores and probabilities never reach device memory.
//
// Bound. Device-memory bytes are q, k, v read once and out written once:
// 4 B h L d sizeof(T), 308 MB at Swin-T's stage 1 with 128 images (B =
// 4096, h = 3, L = 98, d = 32, bf16), 92 us at 3.35 TB/s. The work is
// 4 B h L^2 d flops (15 GFLOP there) on the CUDA cores in f32, about
// 0.23 ms at their 67 TFLOP/s, so this design is bound by its arithmetic
// and the shared-memory reads that feed it, not by bytes.
//
// Design. One block per (group, head): q, k and v go to shared memory as
// f32 (zero-padded, see window_attention.cuh), the 16 x 16 threads compute
// the scores as register tiles of R x R, take the row softmax over half
// warps, write p (at q's type) to shared memory, and compute p v as R x RD
// register tiles, stored at q's type. The TPU kernel's window tiling
// (`_pick_w`, `_UNROLL`) budgeted VMEM and does not carry over.

#include "window_attention.cuh"

namespace {

using namespace passl_wa;

template <typename T, int R, int RD>
__global__ void __launch_bounds__(kThreads)
window_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const float* __restrict__ bias,
                            const float* __restrict__ mask, T* __restrict__ out, int h, int L,
                            int d, int n_mask, float scale) {
  constexpr int LP = kGrid * R;   // padded rows of every tile
  constexpr int LD = kGrid * RD + 1;
  constexpr int LDP = LP + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + LP * LD;
  float* Vs = Ks + LP * LD;
  float* Ps = Vs + LP * LD;  // [LP, LDP], every entry written below

  const int bh = blockIdx.x;
  const int b = bh / h;
  const int head = bh - b * h;
  const int64_t base = (int64_t)bh * L * d;
  const int tx = threadIdx.x % kGrid;
  const int ty = threadIdx.x / kGrid;

  zero_shared(smem, 3 * LP * LD);
  __syncthreads();
  stage(Qs, q + base, L, d, LD);
  stage(Ks, k + base, L, d, LD);
  stage(Vs, v + base, L, d, LD);
  __syncthreads();

  float p[R][R];
  const float* mask_b = mask != nullptr ? mask + (int64_t)(b % n_mask) * L * L : nullptr;
  softmax_tile<R>(p, Qs, Ks, LD, d, bias + (int64_t)head * L * L, mask_b, L, scale, ty, tx);
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int c = 0; c < R; ++c) Ps[(ty + kGrid * a) * LDP + tx + kGrid * c] = round_to<T>(p[a][c]);
  }
  __syncthreads();

  float o[R][RD];
  zero(o);
  gemm<R, RD, false, float>(o, Ps, LDP, 1, Vs, LD, 1, L, ty, tx);
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int i = ty + kGrid * a;
#pragma unroll
    for (int c = 0; c < RD; ++c) {
      const int col = tx + kGrid * c;
      if (i < L && col < d) out[base + i * d + col] = from_f32<T>(o[a][c]);
    }
  }
}

template <typename T, int R, int RD>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   const float* mask, void* out, int B, int h, int L, int d, int n_mask,
                   float scale, cudaStream_t stream) {
  constexpr int LP = kGrid * R;
  const size_t smem = (3 * (size_t)LP * (kGrid * RD + 1) + (size_t)LP * (LP + 1)) * sizeof(float);
  auto kernel = window_attention_fwd_kernel<T, R, RD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)((int64_t)B * h), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias, mask,
      static_cast<T*>(out), h, L, d, n_mask, scale);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_r(const void* q, const void* k, const void* v, const float* bias,
                     const float* mask, void* out, int B, int h, int L, int d, int n_mask,
                     float scale, cudaStream_t stream) {
  switch (cols_per_thread(d)) {
    case 2: return launch<T, R, 2>(q, k, v, bias, mask, out, B, h, L, d, n_mask, scale, stream);
    case 4: return launch<T, R, 4>(q, k, v, bias, mask, out, B, h, L, d, n_mask, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, const float* bias,
                     const float* mask, void* out, int B, int h, int L, int d, int n_mask,
                     float scale, cudaStream_t stream) {
  switch (rows_per_thread(L)) {
    case 2: return launch_r<T, 2>(q, k, v, bias, mask, out, B, h, L, d, n_mask, scale, stream);
    case 4: return launch_r<T, 4>(q, k, v, bias, mask, out, B, h, L, d, n_mask, scale, stream);
    case 7: return launch_r<T, 7>(q, k, v, bias, mask, out, B, h, L, d, n_mask, scale, stream);
    case 8: return launch_r<T, 8>(q, k, v, bias, mask, out, B, h, L, d, n_mask, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. q, k, v, out [B, h, L, d]
// contiguous at `dtype`; bias [h, L, L] float32; mask [n_mask, L, L] float32
// with n_mask dividing B, or null (n_mask ignored); all on `device`. L <= 128,
// d <= 64. Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int passl_window_attention_fwd(const void* q, const void* k, const void* v,
                                          const void* bias, const void* mask, void* out, int B,
                                          int h, int L, int d, int n_mask, float scale, int dtype,
                                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || h <= 0 || L <= 0 || d <= 0 || rows_per_thread(L) == 0 ||
      cols_per_thread(d) == 0 || (mask != nullptr && (n_mask <= 0 || B % n_mask != 0)))
    return (int)cudaErrorInvalidValue;
  const float* b32 = static_cast<const float*>(bias);
  const float* m32 = static_cast<const float*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_t<float>(q, k, v, b32, m32, out, B, h, L, d, n_mask, scale, st);
    case 1:
      return (int)launch_t<__nv_bfloat16>(q, k, v, b32, m32, out, B, h, L, d, n_mask, scale, st);
    case 2: return (int)launch_t<__half>(q, k, v, b32, m32, out, B, h, L, d, n_mask, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
