// Helpers shared by the flash-attention forward and backward kernels
// (flash_attention.cu, flash_attention_bwd.cu), which have two paths.
//
// Every kernel works on 64-row tiles of q, k, v (and do) for one (image,
// head) (the tensor-core forward and dQ on 128-row q tiles) and on the tiles of
// scores between a q tile and a k tile.
// q, k and v are [n, L, h, d] at the caller's strides (s_b, s_l, s_h; the
// last dim contiguous): views of the projection qkv [n, L, 3, h, d] are
// read in place. Rows past L are staged as zeros and their scores masked,
// so the ragged last tile needs no padding in device memory.
//
// f32 inputs: the CUDA-core path. Tiles are staged in shared memory as f32
// with rows of DP + 1 floats (DP = d padded to 16 RD; the odd stride puts
// the 16 rows a half warp reads at one column on 16 different banks). The
// block's 256 threads form the same 16 x 16 grid as the window-attention
// kernels (window_attention.cuh): thread (ty, tx) owns rows ty + 16 a and
// columns tx + 16 c of every product tile, summed in registers over shared
// operands by `gemm`. The row statistics of a score tile reduce over the 16
// threads of a half warp.
//
// bf16 / f16 inputs: the tensor-core path. Tiles stay at the input type in
// shared memory, rows padded by 8 elements (16 bytes, so that the eight
// rows a fragment load touches fall on different banks); a B operand that
// a product reads down its rows comes through `ldmatrix.trans`. Each warp
// owns 16 rows of a tile, and every product is
// `mma.sync.m16n8k16` with f32 accumulation: a 16 x 8 score chunk's
// accumulator holds, for thread (g = lane / 4, t = lane % 4), rows g and
// g + 8 and columns 2t, 2t + 1, which is also the layout of an A operand
// of the next product, so p and ds go from one product to the next in
// registers, rounded to the input type as the library rounds them. Row
// statistics reduce over the 4 threads of a quad.
#pragma once

#include "tensor_core.cuh"       // mma, pack, fragment loads, quad_reduce, zero_acc
#include "window_attention.cuh"  // gemm, zero, half_warp_reduce, round_to, to_f32 / from_f32

namespace passl_fa {

using passl_wa::from_f32;
using passl_wa::gemm;
using passl_wa::half_warp_reduce;
using passl_wa::kGrid;
using passl_wa::kThreads;
using passl_wa::round_to;
using passl_wa::to_f32;
using passl_wa::zero;
using passl_tc::cp_async16;
using passl_tc::cp_async_commit;
using passl_tc::cp_async_wait;
using passl_tc::load_a;
using passl_tc::load_b_trans_x4;
using passl_tc::load_b_x4;
using passl_tc::mma;
using passl_tc::pack;
using passl_tc::quad_reduce;
using passl_tc::zero_acc;

constexpr int kTile = 64;            // rows of every q and k tile
constexpr int kRows = kTile / kGrid; // rows of a tile per thread: 4
constexpr int kLdP = kTile + 1;      // row stride of a [64, 64] score tile in shared memory

// Rows row0 .. row0 + 63 of one (image, head) of an [n, L, h, d] tensor (src
// points at its row 0; rows are row_stride apart) into dst [64, DP + 1] as
// f32: zeros past row L and past column d.
template <typename T, int DP>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ src,
                                           int64_t row_stride, int row0, int L, int d) {
  for (int idx = threadIdx.x; idx < kTile * DP; idx += blockDim.x) {
    const int i = idx / DP;
    const int c = idx - i * DP;
    const int r = row0 + i;
    dst[i * (DP + 1) + c] = (r < L && c < d) ? to_f32(src[(int64_t)r * row_stride + c]) : 0.f;
  }
}

// s[a][c] = (q_i . k_j in f32) * scale for this thread's rows i = ty + 16 a
// of the staged q tile Qs and columns j = tx + 16 c of the staged k tile Ks,
// as the library kernels take it: the f32 product, then the scale.
template <int LD>
__device__ __forceinline__ void scores(float (&s)[kRows][kRows], const float* Qs, const float* Ks,
                                       int d, float scale, int ty, int tx) {
  zero(s);
  gemm<kRows, kRows, false, float>(s, Qs, LD, 1, Ks, 1, LD, d, ty, tx);
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
#pragma unroll
    for (int c = 0; c < kRows; ++c) s[a][c] = __fmul_rn(s[a][c], scale);
  }
}

// Columns of the padded [64, d] tiles per thread (d <= 16 RD), 0 when d > 128
// or d is not a multiple of 8.
inline int cols_per_thread(int d) {
  if (d <= 0 || d % 8 != 0) return 0;
  if (d <= 32) return 2;
  if (d <= 64) return 4;
  if (d <= 96) return 6;
  if (d <= 128) return 8;
  return 0;
}

// Shared memory of a kernel with `tiles` staged [64, DP + 1] tiles, one
// [64, 65] score tile and `extra` floats.
inline size_t smem_bytes(int tiles, int rd, int extra) {
  return ((size_t)tiles * kTile * (kGrid * rd + 1) + (size_t)kTile * kLdP + extra) * sizeof(float);
}

// ------------------------------------------------------------ tensor cores

constexpr int kWarps = 4;                // dK/dV: 4 warps of 16 rows each
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kChunks = kTile / 8;       // 8-column chunks of a [16, 64] score tile per warp

// The padded head dim of the tensor-core kernels (a multiple of 16), 0 when
// d > 128 or d is not a multiple of 8.
inline int mma_head_dim(int d) {
  if (d <= 0 || d % 8 != 0 || d > 128) return 0;
  if (d <= 32) return 32;
  if (d <= 64) return 64;
  if (d <= 96) return 96;
  return 128;
}

// Shared memory of a tensor-core kernel: `tiles` [64, DP + 8] tiles at 2
// bytes and `extra` floats.
inline size_t mma_smem_bytes(int tiles, int dp, int extra) {
  return (size_t)tiles * kTile * (dp + 8) * 2 + (size_t)extra * 4;
}

// The A operand over 16 columns (chunks 2 kk and 2 kk + 1) of a [16, 8 N]
// accumulator tile, rounded to T.
template <typename T, int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c)[N][4], int kk) {
  a[0] = pack<T>(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack<T>(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack<T>(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack<T>(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Rows row0 .. row0 + ROWS - 1 of one (image, head) of an [n, L, h, d]
// tensor at type T (src points at its row 0, rows row_stride apart, 16-byte
// aligned) into dst [ROWS, DP + 8] at T, in 16-byte vectors, by a block of
// THREADS threads, with cp.async: the copies are in flight until
// cp_async_wait, and rows past L and columns past d are zero-filled without a
// read. Where THREADS is a multiple of the DP / 8 vectors of a row, each
// thread keeps one column for every row it copies.
template <typename T, int DP, int ROWS, int THREADS>
__device__ __forceinline__ void stage_rows_async(T* dst, const T* __restrict__ src,
                                                 int64_t row_stride, int row0, int L, int d) {
  constexpr int V = DP / 8;
  if constexpr (THREADS % V == 0) {
    const int c = (threadIdx.x % V) * 8;
    const bool col_ok = c < d;
#pragma unroll
    for (int i = threadIdx.x / V; i < ROWS; i += THREADS / V) {
      const int r = row0 + i;
      const bool ok = col_ok && r < L;
      cp_async16(dst + i * (DP + 8) + c, ok ? src + (int64_t)r * row_stride + c : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * V; idx += THREADS) {
      const int i = idx / V;
      const int c = (idx - i * V) * 8;
      const int r = row0 + i;
      const bool ok = r < L && c < d;
      cp_async16(dst + i * (DP + 8) + c, ok ? src + (int64_t)r * row_stride + c : src, ok);
    }
  }
}

// Blocks of the forward, dK/dV and dQ grids: n h q (or k) tiles of `rows` rows,
// tile index fastest, so that the tiles of one (image, head) run side by side.
// 0 past the grid's 2^31 - 1 blocks.
inline int64_t linear_blocks(int n, int L, int h, int rows = kTile) {
  const int64_t blocks = (int64_t)n * h * ((L + rows - 1) / rows);
  return blocks < 2147483648LL ? blocks : 0;
}

// A kernel's registers a thread, shared memory a block (dynamic `smem` plus
// static), blocks an SM at `threads` a block, local-memory bytes a thread
// (spills) and warps a block, into out[0..4].
template <typename K>
cudaError_t kernel_resources(K kernel, int threads, size_t smem, int* out) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)(smem + attr.sharedSizeBytes);
  out[2] = per_sm;
  out[3] = (int)attr.localSizeBytes;
  out[4] = threads / 32;
  return cudaSuccess;
}

}  // namespace passl_fa
