// Helpers shared by the window-attention forward and backward kernels
// (window_attention.cu, window_attention_bwd.cu).
//
// Both kernels work on one (window group, head) tile at a time: q, k, v (and
// do) [L, d] staged in shared memory as f32, and the [L, L] scores. The
// block's 256 threads form a 16 x 16 grid (tx = threadIdx.x % 16, ty =
// threadIdx.x / 16); every product is an output tile of which thread
// (ty, tx) owns rows ty + 16 a and columns tx + 16 b, summed in registers
// over the shared operands (`gemm`). A row of an [L, L] tile is thus spread
// over the 16 threads of one half warp, which reduce it with shuffles.
// Operands are padded to 16 R rows and 16 RD columns with zeros, so no
// product needs a bound check; row strides are odd (16 RD + 1, 16 R + 1),
// so the threads of a half warp that read one column of a tile hit 16
// different banks.
#pragma once

#include "talking_heads.cuh"  // to_f32 / from_f32

namespace passl_wa {

using passl_th::from_f32;
using passl_th::to_f32;

constexpr int kGrid = 16;                // the block is a kGrid x kGrid grid of threads
constexpr int kThreads = kGrid * kGrid;  // 256

// x as stored at T and read back (what `p.astype(q.dtype)` gives in f32)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// acc[a][b] += sum_{k < K} A(m0 + 16 a, k) * B(k, n0 + 16 b) in f32, in k
// order, with A(m, k) = A[m * a_m + k * a_k] and B(k, n) = B[k * b_k + n * b_n]
// in shared memory. ROUND_A rounds each A value to T first.
template <int TM, int TN, bool ROUND_A, typename T>
__device__ __forceinline__ void gemm(float (&acc)[TM][TN], const float* A, int a_m, int a_k,
                                     const float* B, int b_k, int b_n, int K, int m0, int n0) {
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      a[i] = A[(m0 + kGrid * i) * a_m + k * a_k];
      if (ROUND_A) a[i] = round_to<T>(a[i]);
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = B[k * b_k + (n0 + kGrid * j) * b_n];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
}

__device__ __forceinline__ void zero_shared(float* p, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = 0.f;
}

// The [L, d] tile at src (contiguous, type T) into shared rows of stride ld,
// as f32; the padding is left as it is.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int L, int d, int ld) {
  for (int idx = threadIdx.x; idx < L * d; idx += blockDim.x) {
    const int i = idx / d;
    dst[i * ld + idx - i * d] = to_f32(src[idx]);
  }
}

// Sum (or max) of v over the 16 threads of this half warp, in a fixed order.
template <bool IS_MAX>
__device__ __forceinline__ float half_warp_reduce(float v) {
#pragma unroll
  for (int off = kGrid / 2; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = IS_MAX ? fmaxf(v, o) : v + o;
  }
  return v;
}

// This thread's R x R tile of p = softmax_k(s), s = (q k^T) * scale + (bias +
// mask), as the Pallas `_attend` computes it: the f32 product, then the
// scale, then the additive term, softmax in f32 with a division. Qs and Ks
// are the staged [16 R, ld] tiles, bias_h the head's [L, L] bias and mask_b
// the group's [L, L] mask or null. p is 0 in the padding (rows or columns
// >= L), so the products that follow need no bound checks.
template <int R>
__device__ __forceinline__ void softmax_tile(float (&p)[R][R], const float* Qs, const float* Ks,
                                             int ld, int d, const float* __restrict__ bias_h,
                                             const float* __restrict__ mask_b, int L, float scale,
                                             int ty, int tx) {
  zero(p);
  gemm<R, R, false, float>(p, Qs, ld, 1, Ks, 1, ld, d, ty, tx);
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int i = ty + kGrid * a;
    float mx = -INFINITY;
#pragma unroll
    for (int b = 0; b < R; ++b) {
      const int j = tx + kGrid * b;
      if (j >= L) {
        p[a][b] = -INFINITY;
      } else if (i < L) {
        const float add = bias_h[i * L + j] + (mask_b != nullptr ? mask_b[i * L + j] : 0.f);
        p[a][b] = __fadd_rn(__fmul_rn(p[a][b], scale), add);  // no contraction into an fma
      }  // padding rows keep their 0 scores: finite, and zeroed below
      mx = fmaxf(mx, p[a][b]);
    }
    mx = half_warp_reduce<true>(mx);
    float sum = 0.f;
#pragma unroll
    for (int b = 0; b < R; ++b) {
      p[a][b] = expf(p[a][b] - mx);  // exp(-inf) = 0 past the row's end
      sum += p[a][b];
    }
    sum = half_warp_reduce<false>(sum);
#pragma unroll
    for (int b = 0; b < R; ++b) p[a][b] = i < L ? p[a][b] / sum : 0.f;
  }
}

// Rows of the padded [L, L] tile per thread (L <= 16 R), 0 when L > 128.
inline int rows_per_thread(int L) {
  if (L <= 32) return 2;
  if (L <= 64) return 4;
  if (L <= 112) return 7;
  if (L <= 128) return 8;
  return 0;
}

// Columns of the padded [L, d] tiles per thread (d <= 16 RD), 0 when d > 64.
inline int cols_per_thread(int d) {
  if (d <= 32) return 2;
  if (d <= 64) return 4;
  return 0;
}

}  // namespace passl_wa
