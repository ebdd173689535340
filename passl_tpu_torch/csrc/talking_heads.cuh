// Helpers shared by the talking-heads forward and backward kernels
// (talking_heads.cu, talking_heads_bwd.cu): type conversions and a block
// reduction over per-head values.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace passl_th {

constexpr int kMaxThreads = 256;  // per block; C columns per thread cover k
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCols = 4;       // columns per thread: k <= kMaxCols * kMaxThreads

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }

// Reduces v[0..H) over the block (max when IS_MAX, else sum). Every thread
// gets the results, summed in the same order on every launch. `red` holds
// H * kMaxWarps floats. There is no barrier after the final reads of `red`:
// a caller that reduces into the same buffer again must pass a
// __syncthreads() in between.
template <int H, bool IS_MAX>
__device__ __forceinline__ void block_reduce(float (&v)[H], float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int g = 0; g < H; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v[g], off);
      v[g] = IS_MAX ? fmaxf(v[g], o) : v[g] + o;
    }
    if (lane == 0) red[g * kMaxWarps + warp] = v[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < H; ++g) {
    float r = red[g * kMaxWarps];
    for (int w = 1; w < nwarps; ++w) {
      const float o = red[g * kMaxWarps + w];
      r = IS_MAX ? fmaxf(r, o) : r + o;
    }
    v[g] = r;
  }
}

// Fewest columns per thread (1, 2 or 4) that keep a block of k columns
// within kMaxThreads; 0 when k is too long.
inline int cols_per_thread(int k) {
  const int cols = (k + kMaxThreads - 1) / kMaxThreads;
  if (cols <= 1) return 1;
  if (cols <= 2) return 2;
  if (cols <= 4) return 4;
  return 0;
}

// Threads of a block that covers k columns at C per thread (whole warps).
inline int threads_for(int k, int c) { return ((k + c - 1) / c + 31) / 32 * 32; }

}  // namespace passl_th
