// Helpers shared by the window-attention forward and backward kernels
// (window_attention.cu, window_attention_bwd.cu), which have two paths.
//
// f32 inputs: the CUDA-core path. Both kernels work on one (window group,
// head) tile at a time: q, k, v (and do) [L, d] staged in shared memory as
// f32, and the [L, L] scores. The block's 256 threads form a 16 x 16 grid
// (tx = threadIdx.x % 16, ty = threadIdx.x / 16); every product is an
// output tile of which thread (ty, tx) owns rows ty + 16 a and columns
// tx + 16 b, summed in registers over the shared operands (`gemm`). A row
// of an [L, L] tile is thus spread over the 16 threads of one half warp,
// which reduce it with shuffles. Operands are padded to 16 R rows and 16 RD
// columns with zeros, so no product needs a bound check; row strides are
// odd (16 RD + 1, 16 R + 1), so the threads of a half warp that read one
// column of a tile hit 16 different banks. The flash kernels' f32 path
// (flash_attention.cuh) uses `gemm`, `zero`, `half_warp_reduce` and the
// 16 x 16 grid too.
//
// bf16 / f16 inputs: the tensor-core path (mma.sync m16n8k16, f32
// accumulation; tensor_core.cuh). Tiles stay at the input type in shared
// memory, [LP, DP + 8] with LP = 16 R rows and DP = 16 RD columns, zeros
// past L and d; the 8 extra elements put the eight rows a fragment load
// touches on different banks. A warp owns rows 16 w .. 16 w + 15 of a
// [LP, LP] score tile (all of its columns in the forward, half of them in
// the backward), which it keeps in registers as accumulator chunks of
// 16 x 8: thread (g = lane / 4, t = lane % 4) holds rows 16 w + g and
// 16 w + g + 8, columns 8 j + 2t and 8 j + 2t + 1 of chunk j. Row
// statistics reduce over the 4 threads of a quad. A block owns one head and
// a run of that head's groups; the next group's tiles are copied in
// (cp.async) while the current one is computed.
#pragma once

#include "talking_heads.cuh"  // to_f32 / from_f32
#include "tensor_core.cuh"    // mma.sync, fragment loads, cp.async

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

// ------------------------------------------------------------ tensor cores

using passl_tc::cp_async16;
using passl_tc::load_a;
using passl_tc::load_a_trans;
using passl_tc::load_b;
using passl_tc::load_b_trans;
using passl_tc::mma;
using passl_tc::pack;
using passl_tc::quad_reduce;
using passl_tc::zero_acc;

// Groups per block and blocks per head for a launch of about `target`
// blocks: a fixed function of (B, h, target).
inline void split(int B, int h, int target, int* groups_per_block, int* blocks_per_head) {
  int per_head = (target + h - 1) / h;
  if (per_head > B) per_head = B;
  if (per_head < 1) per_head = 1;
  *groups_per_block = (B + per_head - 1) / per_head;
  *blocks_per_head = (B + *groups_per_block - 1) / *groups_per_block;
}

// The u-th group of a head in mask-major order: the B / n_mask groups that
// take mask m (group b takes mask b % n_mask) come one after another, so a
// block's run of groups crosses few masks. n_mask is 1 without a mask.
__device__ __forceinline__ int group_of(int u, int n_mask, int per_mask) {
  const int m = u / per_mask;
  return (u - m * per_mask) * n_mask + m;
}

// One [L, d] tile (contiguous at src) into dst [LP, DP + 8] at T, zeros
// past L and past d. vec: 16-byte cp.async copies, in flight until
// cp_async_wait (d % 8 == 0 and src 16-byte aligned); else element by
// element through registers (d = 59: rows of 118 bytes).
template <typename T, int LP, int DP>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ src, int L, int d,
                                           bool vec) {
  constexpr int LD = DP + 8;
  if (vec) {
    constexpr int V = DP / 8;
    for (int idx = threadIdx.x; idx < LP * V; idx += blockDim.x) {
      const int i = idx / V;
      const int c = (idx - i * V) * 8;
      const bool ok = i < L && c < d;
      cp_async16(dst + i * LD + c, ok ? src + i * d + c : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < LP * DP; idx += blockDim.x) {
      const int i = idx / DP;
      const int c = idx - i * DP;
      dst[i * LD + c] = (i < L && c < d) ? src[i * d + c] : from_f32<T>(0.f);
    }
  }
}

// exps below this are taken as 0: 2^-60. A masked score (-100) gives e ~
// 1e-44, a denormal, which sends expf and an IEEE division down their slow
// paths (10x the kernel's time at Swin's masked stages); with every e and
// p = e / sum (sum <= 128) far inside the normal range, the division below
// needs no range check. The TPU, which has no denormals, flushes the
// smallest of them too; a p below 2^-60 is far below one unit in the last
// place of any sum it enters.
constexpr float kMinExp = 8.67361737988403547e-19f;

// x / d correctly rounded, as the IEEE division, for x in [2^-60, 128] and
// d in [1, 128] given rd = 1 / d correctly rounded: Markstein's correction
// of the quotient x rd by its exact residual. Branch-free, where the
// division carries a range check and a slow path that keeps the compiler
// from interleaving the 56 divisions of a thread's rows.
__device__ __forceinline__ float div_normal(float x, float d, float rd) {
  const float q = __fmul_rn(x, rd);
  const float r = fmaf(-q, d, x);
  return fmaf(r, rd, q);
}

// Rows r0 .. r0 + 15 (those below L) of the warp's [16, 8 ND] accumulator
// tile at T into columns col0 .. of out [L, d] (contiguous): two values a
// store where d is even, one where it is odd (rows then lose 4-byte
// alignment).
template <typename T, int ND>
__device__ __forceinline__ void store_rows_mma(T* __restrict__ out, const float (&acc)[ND][4],
                                               int r0, int L, int d, int lane, int col0 = 0) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + g + 8 * r;
    if (i >= L) continue;
    T* row = out + i * d;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) {
      const int col = col0 + 8 * jd + 2 * t;
      if ((d & 1) == 0) {
        if (col < d) *reinterpret_cast<uint32_t*>(row + col) = pack<T>(acc[jd][2 * r], acc[jd][2 * r + 1]);
      } else {
        if (col < d) row[col] = from_f32<T>(acc[jd][2 * r]);
        if (col + 1 < d) row[col + 1] = from_f32<T>(acc[jd][2 * r + 1]);
      }
    }
  }
}

// cp.async staging needs d % 8 == 0 and 16-byte aligned tiles.
inline bool vec_ok(int d, const void* const* ptrs, int n) {
  if (d % 8 != 0) return false;
  for (int i = 0; i < n; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  }
  return true;
}

}  // namespace passl_wa
