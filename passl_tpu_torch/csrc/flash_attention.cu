// Flash-attention forward for Hopper (sm_90a):
//
//     o = softmax(q k^T * scale) v      over [n, L, h, d] q, k, v
//
// Replaces the forward Pallas kernel of the JAX library flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py,
// `_flash_attention_kernel`) that passl_tpu/ops/attention.py:111 calls: the
// same online softmax over k tiles, s = (q k^T in f32) * scale, p = exp(s - m)
// rounded to v's type for p v, f32 sums, o at q's type, and the row
// statistics m (max) and l (sum of exp(s - m)) kept in f32 for the backward.
// The scores never reach device memory. The library pads L to a multiple of
// 128 and masks the padding with segment ids; this kernel masks the ragged
// last tile itself, which is the same function.
//
// Bound. Device-memory bytes are q, k, v read once and o written once, plus
// the two f32 statistics: 4 n L h d sizeof(T) + 8 n h L, 157 MB at ViT-B/16
// with 128 images (n = 128, L = 197, h = 12, d = 64, bf16), 47 us at
// 3.35 TB/s. The work is 4 n h L^2 d flops (15 GFLOP there): 15 us on the
// tensor cores at 989 TFLOP/s, so the function is bound by bytes. In f32
// the products take 0.23 ms at the CUDA cores' 67 TFLOP/s: bound by them.
//
// Design. One block per (image x head, q tile), looping over 64-row k tiles:
// each tile's k and v are staged in shared memory, the scores formed, each
// row's running max and sum updated, the running output rescaled, and p v
// added. Every block owns its outputs: no atomics, the same bits on every
// launch.
// - bf16 / f16: 128-row q tiles, 8 warps of 16 rows; the products are
//   mma.sync m16n8k16 with f32 accumulation, q held as A operands in
//   registers, p passed from the scores' accumulators to the A operand of
//   p v in registers (rounded to v's type), k and v read through ldmatrix.
//   The 1-D grid runs the tiles of one head side by side, so each head's k
//   and v come from device memory about once and from L2 after; k and v
//   tiles are double-buffered with cp.async; warps whose rows lie past L
//   and 8-key chunks past L do no work, and full tiles take a body with no
//   branch (fwd_tile<FULL>). At d = 64: 128 registers, no spills, 55,296 B
//   of shared memory, 2 blocks (16 warps) an SM. What bounds it now: the
//   latency of each warp's chain of products, reductions and exps a tile,
//   with 16 warps an SM to hide it, and the staging from L2.
// - f32: 256 threads as a 16 x 16 grid of 4 x 4 register tiles, products
//   on the CUDA cores in f32 from shared memory, p through shared memory;
//   bound by the shared loads that feed the fmas.

#include "flash_attention.cuh"

namespace {

using namespace passl_fa;

// The CUDA-core forward, instantiated for f32 (bf16 and f16 take the
// tensor-core kernel below); T marks where the library rounds.
template <typename T, int RD>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, float* __restrict__ m_out,
                           float* __restrict__ l_out, int L, int h, int d, int64_t s_b,
                           int64_t s_l, int64_t s_h, float scale) {
  constexpr int DP = kGrid * RD;
  constexpr int LD = DP + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;  // [64, kLdP]

  const int bh = blockIdx.x;
  const int b = bh / h;
  const int head = bh - b * h;
  const int q0 = blockIdx.y * kTile;
  const int64_t base = (int64_t)b * s_b + (int64_t)head * s_h;
  const int tx = threadIdx.x % kGrid;
  const int ty = threadIdx.x / kGrid;

  stage_rows<T, DP>(Qs, q + base, s_l, q0, L, d);

  float m_run[kRows], l_run[kRows], acc[kRows][RD];
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    m_run[a] = -INFINITY;
    l_run[a] = 0.f;
  }
  zero(acc);

  for (int k0 = 0; k0 < L; k0 += kTile) {
    __syncthreads();  // the last tile's reads of Ks, Vs and Ps are done
    stage_rows<T, DP>(Ks, k + base, s_l, k0, L, d);
    stage_rows<T, DP>(Vs, v + base, s_l, k0, L, d);
    __syncthreads();

    float s[kRows][kRows];
    scores<LD>(s, Qs, Ks, d, scale, ty, tx);
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kRows; ++c) {
        if (k0 + tx + kGrid * c >= L) s[a][c] = -INFINITY;  // past the last token
        mx = fmaxf(mx, s[a][c]);
      }
      // every k tile holds a token, so the new max is finite; on the first
      // tile alpha = exp(-inf) = 0
      const float m_new = fmaxf(m_run[a], half_warp_reduce<true>(mx));
      const float alpha = expf(m_run[a] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kRows; ++c) {
        s[a][c] = expf(s[a][c] - m_new);  // 0 past the last token
        sum += s[a][c];
      }
      l_run[a] = half_warp_reduce<false>(sum) + alpha * l_run[a];
      m_run[a] = m_new;
#pragma unroll
      for (int c = 0; c < RD; ++c) acc[a][c] *= alpha;
#pragma unroll
      for (int c = 0; c < kRows; ++c) Ps[(ty + kGrid * a) * kLdP + tx + kGrid * c] = round_to<T>(s[a][c]);
    }
    __syncthreads();
    gemm<kRows, RD, false, float>(acc, Ps, kLdP, 1, Vs, LD, 1, min(kTile, L - k0), ty, tx);
  }

#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int i = q0 + ty + kGrid * a;
    if (i >= L) continue;
    const float inv = 1.f / l_run[a];
    T* orow = o + (((int64_t)b * L + i) * h + head) * d;
#pragma unroll
    for (int c = 0; c < RD; ++c) {
      const int col = tx + kGrid * c;
      if (col < d) orow[col] = from_f32<T>(acc[a][c] * inv);
    }
    if (tx == 0) {
      m_out[(int64_t)bh * L + i] = m_run[a];
      l_out[(int64_t)bh * L + i] = l_run[a];
    }
  }
}

// Warps of a tensor-core forward block: its q tile has 16 kFwdWarps rows.
constexpr int kFwdWarps = 8;
constexpr int kFwdRows = 16 * kFwdWarps;

// One k tile of the forward for one warp's 16 q rows (A operands qa): s = q
// k^T over the tile's 8-key chunks that hold a key, scaled, masked past L,
// the running max m_run and sum l_run of the thread's two rows updated, acc
// rescaled, and acc += (p at T) v over the 16-key steps that hold a key.
// FULL: all 64 keys lie before L, so no chunk is skipped or masked and the
// code has no branch.
template <typename T, int DP, bool FULL>
__device__ __forceinline__ void fwd_tile(float (&acc)[DP / 8][4], float (&m_run)[2],
                                         float (&l_run)[2], const uint32_t (&qa)[DP / 16][4],
                                         const T* Ks, const T* Vs, int k0, int L, float scale,
                                         int lane) {
  constexpr int LD = DP + 8;
  const int t = lane & 3;
  const int nc = FULL ? kChunks : min(kChunks, (L - k0 + 7) / 8);  // chunks that hold a key

  float s[kChunks][4];
  zero_acc(s);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < kChunks; j += 2) {
      if (FULL || j < nc) {
        uint32_t b0[2], b1[2];
        load_b_x4(b0, b1, Ks, LD, j * 8, kk * 16, lane);
        mma<T>(s[j], qa[kk], b0);
        if (FULL || j + 1 < nc) mma<T>(s[j + 1], qa[kk], b1);
      }
    }
  }
  // four partial maxima and sums a row (chunk parity x column parity),
  // combined in a fixed order: chains of 4 instead of 16
  float mx[2][4], sum[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) mx[r][c] = -INFINITY, sum[r][c] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    if (FULL || j < nc) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __fmul_rn(s[j][e], scale);
        if (!FULL && k0 + j * 8 + 2 * t + (e & 1) >= L) s[j][e] = -INFINITY;  // past the last token
        float& x = mx[e >> 1][2 * (j & 1) + (e & 1)];
        x = fmaxf(x, s[j][e]);
      }
    }
  }
  float m_new[2], alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // every k tile holds a token, so the new max is finite; on the first
    // tile alpha = exp(-inf) = 0
    const float m4 = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    m_new[r] = fmaxf(m_run[r], quad_reduce<true>(m4));
    alpha[r] = expf(m_run[r] - m_new[r]);
  }
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    if (FULL || j < nc) {  // chunks past the last token stay 0
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_new[e >> 1]);
        sum[e >> 1][2 * (j & 1) + (e & 1)] += s[j][e];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float s4 = (sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]);
    l_run[r] = quad_reduce<false>(s4) + alpha[r] * l_run[r];
    m_run[r] = m_new[r];
  }
#pragma unroll
  for (int jd = 0; jd < DP / 8; ++jd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jd][e] *= alpha[e >> 1];
  }
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    if (FULL || 2 * kk < nc) {
      uint32_t a[4];
      acc_to_a<T>(a, s, kk);
#pragma unroll
      for (int jd = 0; jd < DP / 8; jd += 2) {
        uint32_t b0[2], b1[2];
        load_b_trans_x4(b0, b1, Vs, LD, kk * 16, jd * 8, lane);
        mma<T>(acc[jd], a, b0);
        mma<T>(acc[jd + 1], a, b1);
      }
    }
  }
}

// The tensor-core forward (bf16 / f16). Block x of the 1-D grid takes q tile
// x % n_tiles of (image x head) x / n_tiles, so the tiles of one head run side
// by side and read its k and v from L2 after the first. kFwdWarps warps,
// warp w owning q rows 16 w .. 16 w + 15 of the tile; a warp whose rows all
// lie past L only helps stage. k and v tiles are double-buffered with
// cp.async, so tile it + 1 is in flight while tile it is multiplied, behind
// one barrier a tile. The warp's q rows are read once from shared memory
// into A operands; each k tile's k rows are the B operands of q k^T and its
// v rows (through `ldmatrix.x4.trans`) those of p v. Each thread keeps the
// running max and sum of its two rows.
template <typename T, int DP>
__global__ void __launch_bounds__(32 * kFwdWarps, (DP <= 64 ? 16 : 8) / kFwdWarps)
flash_attention_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, T* __restrict__ o,
                               float* __restrict__ m_out, float* __restrict__ l_out, int L, int h,
                               int d, int64_t s_b, int64_t s_l, int64_t s_h, float scale,
                               int n_tiles) {
  constexpr int LD = DP + 8;
  constexpr int TILE = kTile * LD;
  constexpr int THREADS = 32 * kFwdWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [kFwdRows, LD]
  T* KVs = Qs + kFwdRows * LD;             // [2 buffers][k, v][64, LD]

  const int bh = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x - bh * n_tiles) * kFwdRows;
  const int b = bh / h;
  const int head = bh - b * h;
  const int64_t base = (int64_t)b * s_b + (int64_t)head * s_h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool active = q0 + warp * 16 < L;
  const int nk = (L + kTile - 1) / kTile;

  stage_rows_async<T, DP, kFwdRows, THREADS>(Qs, q + base, s_l, q0, L, d);
  stage_rows_async<T, DP, kTile, THREADS>(KVs, k + base, s_l, 0, L, d);
  stage_rows_async<T, DP, kTile, THREADS>(KVs + TILE, v + base, s_l, 0, L, d);
  cp_async_commit();

  uint32_t qa[DP / 16][4];
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[DP / 8][4];
  zero_acc(acc);

  for (int it = 0; it < nk; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it has landed, and every read of the other buffer is done
    const int k0 = it * kTile;
    if (it + 1 < nk) {
      T* nxt = KVs + ((it + 1) & 1) * 2 * TILE;
      stage_rows_async<T, DP, kTile, THREADS>(nxt, k + base, s_l, k0 + kTile, L, d);
      stage_rows_async<T, DP, kTile, THREADS>(nxt + TILE, v + base, s_l, k0 + kTile, L, d);
      cp_async_commit();
    }
    if (!active) continue;
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) load_a(qa[kk], Qs, LD, warp * 16, kk * 16, lane);
    }
    const T* Ks = KVs + (it & 1) * 2 * TILE;
    if (k0 + kTile <= L)
      fwd_tile<T, DP, true>(acc, m_run, l_run, qa, Ks, Ks + TILE, k0, L, scale, lane);
    else
      fwd_tile<T, DP, false>(acc, m_run, l_run, qa, Ks, Ks + TILE, k0, L, scale, lane);
  }

  if (!active) return;
  const int t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + warp * 16 + (lane >> 2) + 8 * r;
    if (i >= L) continue;
    const float inv = 1.f / l_run[r];
    T* orow = o + (((int64_t)b * L + i) * h + head) * d;
#pragma unroll
    for (int jd = 0; jd < DP / 8; ++jd) {
      const int col = jd * 8 + 2 * t;
      if (col < d) {
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack<T>(acc[jd][2 * r] * inv, acc[jd][2 * r + 1] * inv);
      }
    }
    if (t == 0) {
      m_out[(int64_t)bh * L + i] = m_run[r];
      l_out[(int64_t)bh * L + i] = l_run[r];
    }
  }
}

// Shared memory of the tensor-core forward: the q tile and two buffers of k
// and v tiles.
inline size_t fwd_mma_smem(int dp) {
  return mma_smem_bytes(4, dp, 0) + (size_t)kFwdRows * (dp + 8) * 2;
}

template <typename T, int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* m, float* l,
                       int n, int L, int h, int d, int64_t s_b, int64_t s_l, int64_t s_h,
                       float scale, cudaStream_t stream) {
  const size_t smem = fwd_mma_smem(DP);
  auto kernel = flash_attention_fwd_mma_kernel<T, DP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)linear_blocks(n, L, h, kFwdRows), 32 * kFwdWarps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), m, l, L, h, d, s_b, s_l, s_h, scale, (L + kFwdRows - 1) / kFwdRows);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t mma_resources_dp(int* out) {
  return kernel_resources(flash_attention_fwd_mma_kernel<T, DP>, 32 * kFwdWarps, fwd_mma_smem(DP),
                          out);
}

template <typename T>
cudaError_t mma_resources(int d, int* out) {
  switch (mma_head_dim(d)) {
    case 32: return mma_resources_dp<T, 32>(out);
    case 64: return mma_resources_dp<T, 64>(out);
    case 96: return mma_resources_dp<T, 96>(out);
    case 128: return mma_resources_dp<T, 128>(out);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_mma_t(const void* q, const void* k, const void* v, void* o, float* m, float* l,
                         int n, int L, int h, int d, int64_t s_b, int64_t s_l, int64_t s_h,
                         float scale, cudaStream_t st) {
  switch (mma_head_dim(d)) {
    case 32: return launch_mma<T, 32>(q, k, v, o, m, l, n, L, h, d, s_b, s_l, s_h, scale, st);
    case 64: return launch_mma<T, 64>(q, k, v, o, m, l, n, L, h, d, s_b, s_l, s_h, scale, st);
    case 96: return launch_mma<T, 96>(q, k, v, o, m, l, n, L, h, d, s_b, s_l, s_h, scale, st);
    case 128: return launch_mma<T, 128>(q, k, v, o, m, l, n, L, h, d, s_b, s_l, s_h, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int RD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* m, float* l,
                   int n, int L, int h, int d, int64_t s_b, int64_t s_l, int64_t s_h, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(3, RD, 0);
  auto kernel = flash_attention_fwd_kernel<T, RD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((int64_t)n * h), (unsigned)((L + kTile - 1) / kTile));
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(o), m, l, L,
                                           h, d, s_b, s_l, s_h, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* o, float* m, float* l,
                     int n, int L, int h, int d, int64_t s_b, int64_t s_l, int64_t s_h,
                     float scale, cudaStream_t st) {
  switch (cols_per_thread(d)) {
    case 2: return launch<T, 2>(q, k, v, o, m, l, n, L, h, d, s_b, s_l, s_h, scale, st);
    case 4: return launch<T, 4>(q, k, v, o, m, l, n, L, h, d, s_b, s_l, s_h, scale, st);
    case 6: return launch<T, 6>(q, k, v, o, m, l, n, L, h, d, s_b, s_l, s_h, scale, st);
    case 8: return launch<T, 8>(q, k, v, o, m, l, n, L, h, d, s_b, s_l, s_h, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. q, k, v [n, L, h, d] at `dtype`
// with element strides s_b, s_l, s_h (shared by the three; last dim
// contiguous); o [n, L, h, d] contiguous at `dtype`; m, l [n, h, L] float32;
// all on `device`. d <= 128, d % 8 == 0. Launches on `stream`; returns
// cudaGetLastError() after the launch.
extern "C" int passl_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         void* m, void* l, int n, int L, int h, int d,
                                         long long s_b, long long s_l, long long s_h, float scale,
                                         int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || L <= 0 || h <= 0 || cols_per_thread(d) == 0 || (L + kTile - 1) / kTile > 65535 ||
      linear_blocks(n, L, h) == 0)
    return (int)cudaErrorInvalidValue;
  float* m32 = static_cast<float*>(m);
  float* l32 = static_cast<float*>(l);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_t<float>(q, k, v, o, m32, l32, n, L, h, d, s_b, s_l, s_h, scale, st);
    case 1:
      return (int)launch_mma_t<__nv_bfloat16>(q, k, v, o, m32, l32, n, L, h, d, s_b, s_l, s_h,
                                              scale, st);
    case 2:
      return (int)launch_mma_t<__half>(q, k, v, o, m32, l32, n, L, h, d, s_b, s_l, s_h, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tensor-core forward's resources at `dtype` (1 bfloat16, 2 float16) and
// head dim d on `device`: registers a thread, shared memory a block, blocks
// an SM, spilled bytes a thread and warps a block, into out[0..4].
extern "C" int passl_flash_attention_fwd_resources(int dtype, int d, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (dtype) {
    case 1: return (int)mma_resources<__nv_bfloat16>(d, out);
    case 2: return (int)mma_resources<__half>(d, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
