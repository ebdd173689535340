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
// Design. One block per (image x head, 64-row q tile), looping over 64-row
// k tiles: each tile's k and v are staged in shared memory, the [64, 64]
// scores formed, each row's running max and sum updated, the running
// output rescaled, and p v added. Every block owns its outputs.
// - bf16 / f16: 4 warps, each owning 16 q rows; the products are
//   mma.sync m16n8k16 with f32 accumulation, q held as A operands in
//   registers, p passed from the scores' accumulators to the A operand of
//   p v in registers (rounded to v's type), v read through ldmatrix.trans.
//   What bounds it now: one synchronous staging per k tile (no copy in
//   flight while the tensor cores work) and the exps.
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

// The tensor-core forward (bf16 / f16): one block of 4 warps per (image x
// head, 64-row q tile); warp w owns rows 16 w .. 16 w + 15. The warp's q
// rows are read once from shared memory into A operands; each k tile's k
// and v rows are staged once and read as the B operands of q k^T and (through
// `ldmatrix.trans`) p v. Each thread keeps the running max and sum of its
// two rows.
template <typename T, int DP>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, T* __restrict__ o,
                               float* __restrict__ m_out, float* __restrict__ l_out, int L, int h,
                               int d, int64_t s_b, int64_t s_l, int64_t s_h, float scale) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [64, LD]
  T* Ks = Qs + kTile * LD;                 // [64, LD]
  T* Vs = Ks + kTile * LD;                 // [64, LD]

  const int bh = blockIdx.x;
  const int b = bh / h;
  const int head = bh - b * h;
  const int q0 = blockIdx.y * kTile;
  const int64_t base = (int64_t)b * s_b + (int64_t)head * s_h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;

  stage_rows16<T, DP>(Qs, q + base, s_l, q0, L, d);
  __syncthreads();
  uint32_t qa[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) load_a(qa[kk], Qs, LD, warp * 16, kk * 16, lane);

  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int jd = 0; jd < DP / 8; ++jd) acc[jd][0] = acc[jd][1] = acc[jd][2] = acc[jd][3] = 0.f;

  for (int k0 = 0; k0 < L; k0 += kTile) {
    __syncthreads();  // the last tile's reads of Ks and Vs are done
    stage_rows16<T, DP>(Ks, k + base, s_l, k0, L, d);
    stage_rows16<T, DP>(Vs, v + base, s_l, k0, L, d);
    __syncthreads();

    float s[kChunks][4];
#pragma unroll
    for (int j = 0; j < kChunks; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        uint32_t bf[2];
        load_b(bf, Ks, LD, j * 8, kk * 16, lane);
        mma<T>(s[j], qa[kk], bf);
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = k0 + j * 8 + 2 * t + (e & 1) < L;  // past the last token: -inf
        s[j][e] = in ? __fmul_rn(s[j][e], scale) : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float m_new[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // every k tile holds a token, so the new max is finite; on the first
      // tile alpha = exp(-inf) = 0
      m_new[r] = fmaxf(m_run[r], quad_reduce<true>(mx[r]));
      alpha[r] = expf(m_run[r] - m_new[r]);
    }
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_new[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] = quad_reduce<false>(sum[r]) + alpha[r] * l_run[r];
      m_run[r] = m_new[r];
    }
#pragma unroll
    for (int jd = 0; jd < DP / 8; ++jd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jd][e] *= alpha[e >> 1];
    }
    acc_product<T, DP>(acc, s, Vs, lane);  // o += (p at v's type) v
  }

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

template <typename T, int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* m, float* l,
                       int n, int L, int h, int d, int64_t s_b, int64_t s_l, int64_t s_h,
                       float scale, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(3, DP, 0);
  auto kernel = flash_attention_fwd_mma_kernel<T, DP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((int64_t)n * h), (unsigned)((L + kTile - 1) / kTile));
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), m, l, L, h, d, s_b, s_l, s_h, scale);
  return cudaGetLastError();
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
  if (n <= 0 || L <= 0 || h <= 0 || cols_per_thread(d) == 0 || (L + kTile - 1) / kTile > 65535)
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
