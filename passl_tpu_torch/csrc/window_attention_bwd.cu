// Fused window attention backward for Hopper (sm_90a): the gradient of
// out = softmax(q k^T * scale + bias[h] + mask[b % nWm]) v.
//
// Replaces passl_tpu/ops/pallas/window_attention.py::_bwd_kernel. Given q,
// k, v, bias, mask and the incoming gradient do it recomputes p (as the
// forward does) and computes, with pd = p at q's type,
//
//     dv    = pd^T do                       (f32 sums, stored at q's type)
//     dp    = do v^T                        (f32)
//     ds    = p (dp - sum_k dp p)           (f32)
//     dsd   = (ds * scale) at q's type
//     dq    = dsd k,  dk = dsd^T q          (f32 sums, stored at q's type)
//     dbias = sum over the B groups of ds   (f32, unscaled)
//
// Only q, k, v, bias and mask are kept from the forward, as in the JAX
// package's custom VJP.
//
// Bound. Device-memory bytes are q, k, v, do read and dq, dk, dv written
// once: 7 B h L d sizeof(T), 539 MB at Swin-T's stage 1 with 128 images
// (B = 4096, h = 3, L = 98, d = 32, bf16), 161 us at 3.35 TB/s. The five
// products (s, dv, dp, dq, dk) are 10 B h L^2 d flops, 38 GFLOP there, on
// the CUDA cores in f32: the arithmetic, not the bytes, bounds this design.
//
// Design. dk sums over the queries, so a block needs the whole [L, L] tile
// of ds of a (group, head) in shared memory. A block owns one head and a
// fixed run of consecutive groups. Per group it stages q, k, v and do as
// f32 (4 * 16R * (16RD + 1) floats) and uses one [16R, 16R + 1] f32 tile
// for p, then, in place, for dsd: 110 KB at L = 98, d = 32, and 199 KB at
// the limits L = 128, d = 64 (opted in beyond 48 KB with
// cudaFuncAttributeMaxDynamicSharedMemorySize). The row sums of dp p are
// half-warp shuffles over the register tiles of dp. The TPU kernel added
// dbias into one VMEM-resident block over its sequential grid; a CUDA grid
// has no order, so dbias is summed in two fixed-order stages with no
// atomics, which makes it bitwise the same on every launch:
//   1. window_attention_bwd_kernel: each thread keeps the ds entries it owns
//      (the same R x R entries for every group) summed in registers over
//      the block's groups, in group order, and writes them to the block's
//      [L, L] partial at the end.
//   2. window_attention_dbias_reduce: each output adds the partials of its
//      head's blocks in block order.

#include "window_attention.cuh"

namespace {

using namespace passl_wa;

constexpr int kTargetBlocks = 4 * 132;  // blocks per launch that stage 1 aims at: 4 per H100 SM

template <typename T, int R, int RD>
__global__ void __launch_bounds__(kThreads, 1)
window_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const float* __restrict__ bias,
                            const float* __restrict__ mask, const T* __restrict__ dout,
                            T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                            float* __restrict__ partials, int B, int h, int L, int d, int n_mask,
                            float scale, int groups_per_block, int blocks_per_head) {
  constexpr int LP = kGrid * R;
  constexpr int LD = kGrid * RD + 1;
  constexpr int LDP = LP + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + LP * LD;
  float* Vs = Ks + LP * LD;
  float* DOs = Vs + LP * LD;
  float* Ps = DOs + LP * LD;  // [LP, LDP]: p, then dsd

  const int head = blockIdx.x / blocks_per_head;
  const int g0 = (blockIdx.x - head * blocks_per_head) * groups_per_block;
  const int g1 = min(g0 + groups_per_block, B);
  const float* bias_h = bias + (int64_t)head * L * L;
  const int tx = threadIdx.x % kGrid;
  const int ty = threadIdx.x / kGrid;

  float dbias[R][R];
  zero(dbias);
  zero_shared(smem, 4 * LP * LD);

  for (int g = g0; g < g1; ++g) {
    __syncthreads();  // the zero fill, or the last group's reads, are done
    const int64_t base = ((int64_t)g * h + head) * L * d;
    stage(Qs, q + base, L, d, LD);
    stage(Ks, k + base, L, d, LD);
    stage(Vs, v + base, L, d, LD);
    stage(DOs, dout + base, L, d, LD);
    __syncthreads();

    {
      float p[R][R];
      const float* mask_b = mask != nullptr ? mask + (int64_t)(g % n_mask) * L * L : nullptr;
      softmax_tile<R>(p, Qs, Ks, LD, d, bias_h, mask_b, L, scale, ty, tx);
#pragma unroll
      for (int a = 0; a < R; ++a) {
#pragma unroll
        for (int c = 0; c < R; ++c) Ps[(ty + kGrid * a) * LDP + tx + kGrid * c] = p[a][c];
      }
    }
    __syncthreads();

    {  // dv[j] = sum_i pd[i, j] do[i]: rows of this tile are keys
      float t[R][RD];
      zero(t);
      gemm<R, RD, true, T>(t, Ps, 1, LDP, DOs, LD, 1, L, ty, tx);
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const int j = ty + kGrid * a;
#pragma unroll
        for (int c = 0; c < RD; ++c) {
          const int col = tx + kGrid * c;
          if (j < L && col < d) dv[base + j * d + col] = from_f32<T>(t[a][c]);
        }
      }
    }

    float dp[R][R];
    zero(dp);
    gemm<R, R, false, float>(dp, DOs, LD, 1, Vs, 1, LD, d, ty, tx);
    __syncthreads();  // every thread is done reading p as pd

    // ds = p (dp - sum_k dp p), over the entries this thread owns; dsd in place of p
#pragma unroll
    for (int a = 0; a < R; ++a) {
      float* prow = Ps + (ty + kGrid * a) * LDP + tx;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < R; ++c) dot = fmaf(dp[a][c], prow[kGrid * c], dot);
      dot = half_warp_reduce<false>(dot);
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const float ds = prow[kGrid * c] * (dp[a][c] - dot);
        dbias[a][c] += ds;
        prow[kGrid * c] = round_to<T>(__fmul_rn(ds, scale));
      }
    }
    __syncthreads();

    {  // dq[i] = sum_j dsd[i, j] k[j]
      float t[R][RD];
      zero(t);
      gemm<R, RD, false, float>(t, Ps, LDP, 1, Ks, LD, 1, L, ty, tx);
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const int i = ty + kGrid * a;
#pragma unroll
        for (int c = 0; c < RD; ++c) {
          const int col = tx + kGrid * c;
          if (i < L && col < d) dq[base + i * d + col] = from_f32<T>(t[a][c]);
        }
      }
    }
    {  // dk[j] = sum_i dsd[i, j] q[i]
      float t[R][RD];
      zero(t);
      gemm<R, RD, false, float>(t, Ps, 1, LDP, Qs, LD, 1, L, ty, tx);
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const int j = ty + kGrid * a;
#pragma unroll
        for (int c = 0; c < RD; ++c) {
          const int col = tx + kGrid * c;
          if (j < L && col < d) dk[base + j * d + col] = from_f32<T>(t[a][c]);
        }
      }
    }
  }

  float* part = partials + (int64_t)blockIdx.x * L * L;
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int i = ty + kGrid * a;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int j = tx + kGrid * c;
      if (i < L && j < L) part[i * L + j] = dbias[a][c];
    }
  }
}

// dbias[head, i, j] = the sum over the head's blocks, in block order, of
// their partials; one thread per output.
__global__ void window_attention_dbias_reduce(const float* __restrict__ partials,
                                              int blocks_per_head, int LL, int h,
                                              float* __restrict__ dbias) {
  const int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= (int64_t)h * LL) return;
  const int64_t head = o / LL;
  const float* p = partials + head * blocks_per_head * LL + (o - head * LL);
  float r = 0.f;
  for (int c = 0; c < blocks_per_head; ++c) r += p[(int64_t)c * LL];
  dbias[o] = r;
}

// Groups per block and blocks per head: a fixed function of (B, h), so that
// the dbias sums run in the same order on every launch.
void split(int B, int h, int* groups_per_block, int* blocks_per_head) {
  int per_head = (kTargetBlocks + h - 1) / h;
  if (per_head > B) per_head = B;
  *groups_per_block = (B + per_head - 1) / per_head;
  *blocks_per_head = (B + *groups_per_block - 1) / *groups_per_block;
}

template <typename T, int R, int RD>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   const float* mask, const void* dout, void* dq, void* dk, void* dv,
                   float* partials, int B, int h, int L, int d, int n_mask, float scale,
                   cudaStream_t stream) {
  constexpr int LP = kGrid * R;
  const size_t smem = (4 * (size_t)LP * (kGrid * RD + 1) + (size_t)LP * (LP + 1)) * sizeof(float);
  auto kernel = window_attention_bwd_kernel<T, R, RD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int gpb, bph;
  split(B, h, &gpb, &bph);
  kernel<<<(unsigned)(h * bph), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias, mask,
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
      partials, B, h, L, d, n_mask, scale, gpb, bph);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_r(const void* q, const void* k, const void* v, const float* bias,
                     const float* mask, const void* dout, void* dq, void* dk, void* dv,
                     float* partials, int B, int h, int L, int d, int n_mask, float scale,
                     cudaStream_t stream) {
  switch (cols_per_thread(d)) {
    case 2:
      return launch<T, R, 2>(q, k, v, bias, mask, dout, dq, dk, dv, partials, B, h, L, d, n_mask,
                             scale, stream);
    case 4:
      return launch<T, R, 4>(q, k, v, bias, mask, dout, dq, dk, dv, partials, B, h, L, d, n_mask,
                             scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, const float* bias,
                     const float* mask, const void* dout, void* dq, void* dk, void* dv,
                     float* partials, int B, int h, int L, int d, int n_mask, float scale,
                     cudaStream_t stream) {
#define PASSL_WA_BWD_R(r)                                                                     \
  case r:                                                                                     \
    return launch_r<T, r>(q, k, v, bias, mask, dout, dq, dk, dv, partials, B, h, L, d, n_mask, \
                          scale, stream)
  switch (rows_per_thread(L)) {
    PASSL_WA_BWD_R(2);
    PASSL_WA_BWD_R(4);
    PASSL_WA_BWD_R(7);
    PASSL_WA_BWD_R(8);
    default: return cudaErrorInvalidValue;
  }
#undef PASSL_WA_BWD_R
}

}  // namespace

// Blocks the backward launches for B groups of h heads: the wrapper
// allocates `partials` as [this, L, L] float32.
extern "C" long long passl_window_attention_bwd_blocks(int B, int h) {
  int gpb, bph;
  split(B, h, &gpb, &bph);
  return (long long)h * bph;
}

// dtype: 0 float32, 1 bfloat16, 2 float16. q, k, v, dout, dq, dk, dv
// [B, h, L, d] contiguous at `dtype`; bias [h, L, L] float32; mask
// [n_mask, L, L] float32 with n_mask dividing B, or null; partials
// [passl_window_attention_bwd_blocks(B, h), L, L] float32 scratch; dbias
// [h, L, L] float32; all on `device`. L <= 128, d <= 64. Launches both
// stages on `stream`; returns cudaGetLastError() after them (0 on success).
extern "C" int passl_window_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* bias, const void* mask, const void* dout,
                                          void* dq, void* dk, void* dv, void* partials,
                                          void* dbias, int B, int h, int L, int d, int n_mask,
                                          float scale, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || h <= 0 || L <= 0 || d <= 0 || rows_per_thread(L) == 0 ||
      cols_per_thread(d) == 0 || (mask != nullptr && (n_mask <= 0 || B % n_mask != 0)))
    return (int)cudaErrorInvalidValue;
  const float* b32 = static_cast<const float*>(bias);
  const float* m32 = static_cast<const float*>(mask);
  float* part = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = launch_t<float>(q, k, v, b32, m32, dout, dq, dk, dv, part, B, h, L, d, n_mask, scale,
                            st);
      break;
    case 1:
      err = launch_t<__nv_bfloat16>(q, k, v, b32, m32, dout, dq, dk, dv, part, B, h, L, d, n_mask,
                                    scale, st);
      break;
    case 2:
      err = launch_t<__half>(q, k, v, b32, m32, dout, dq, dk, dv, part, B, h, L, d, n_mask, scale,
                             st);
      break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  int gpb, bph;
  split(B, h, &gpb, &bph);
  const int64_t outputs = (int64_t)h * L * L;
  window_attention_dbias_reduce<<<(unsigned)((outputs + 255) / 256), 256, 0, st>>>(
      part, bph, L * L, h, static_cast<float*>(dbias));
  return (int)cudaGetLastError();
}
