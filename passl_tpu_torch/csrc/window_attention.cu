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
// 4 B h L^2 d flops (15 GFLOP there): 15 us on the tensor cores at
// 989 TFLOP/s, so in bf16 / f16 the function is bound by bytes; in f32
// (0.23 ms at the CUDA cores' 67 TFLOP/s) by the products.
//
// bf16 / f16: the tensor-core kernel. The first design (the CUDA-core
// kernel below, which f32 still takes) ran the products on the CUDA cores
// from f32 tiles, staged each (group, head) synchronously and reached 3.9%
// of the bytes bound in bf16. Now a block of LP / 16 warps owns one head and a
// run of its groups, in mask-major order (window_attention.cuh), and
// - copies the next group's q, k and v into the second of two buffers with
//   cp.async while it computes the current one, so the copy is in flight
//   during the products (d = 59, rows of 118 bytes, is staged element by
//   element instead);
// - keeps bias[h] + mask[m] in shared memory in the accumulator layout
//   (each thread its own entries) and reloads them only when the run
//   reaches the next mask, so the f32 terms come from L2 about once per
//   block rather than once per group;
// - computes each warp's 16 rows of q k^T with mma.sync m16n8k16 (f32
//   accumulation), takes the row softmax with quad shuffles, and passes p,
//   rounded to T, from the accumulators to the A operand of p v in
//   registers, v read through ldmatrix.trans: p never touches shared
//   memory.
// mma.sync and not wgmma: wgmma's tiles are 64 rows, which would pad
// Swin's L = 98 to 128 (1.67x the work) and L = 49 to 64, while m16n8k16
// pads 98 to 112 and 49 to 64 at 16-row granularity; at 15 GFLOP the
// tensor cores are not the limit either way. The softmax flushes exps
// below 2^-60 and divides without a range check (window_attention.cuh):
// denormals from the masks had sent expf and the division down their slow
// paths. What bounds it now: latency, with two blocks of 7 warps an SM
// (the launch bounds hold a thread to 144 registers at L = 98; 104 KB of
// shared memory a block), and the exps of the softmax.
//
// f32: one block per (group, head): q, k and v go to shared memory as f32
// (zero-padded, see window_attention.cuh), the 16 x 16 threads compute the
// scores as register tiles of R x R, take the row softmax over half warps,
// write p to shared memory, and compute p v as R x RD register tiles. The
// TPU kernel's window tiling (`_pick_w`, `_UNROLL`) budgeted VMEM and does
// not carry over.

#include "window_attention.cuh"

namespace {

using namespace passl_wa;

// The CUDA-core forward, instantiated for f32 (bf16 and f16 take the
// tensor-core kernel below).
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

// c = A B^T for the warp's 16 rows: a holds the A operands (16 x 16 per kk)
// of [16, 16 KD], bt is an [LP, DP + 8] tile whose rows are B's columns.
// Chunks of columns at or past L are left 0.
template <typename T, int NC, int KD>
__device__ __forceinline__ void warp_product(float (&c)[NC][4], const uint32_t (&a)[KD][4],
                                             const T* bt, int ld, int L, int lane) {
  zero_acc(c);
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      if (j * 8 < L) {
        uint32_t b[2];
        load_b(b, bt, ld, j * 8, kk * 16, lane);
        mma<T>(c[j], a[kk], b);
      }
    }
  }
}

// acc += (c at T) v: the warp's [16, LP] accumulator tile c as A operands
// over the rows of the [LP, DP + 8] tile v (read through ldmatrix.trans).
// Rows of v at or past L meet p = 0 and are skipped 16 at a time.
template <typename T, int NC, int ND>
__device__ __forceinline__ void acc_times_tile(float (&acc)[ND][4], const float (&c)[NC][4],
                                               const T* v, int ld, int L, int lane) {
#pragma unroll
  for (int kk = 0; kk < NC / 2; ++kk) {
    if (kk * 16 < L) {
      uint32_t a[4];
      a[0] = pack<T>(c[2 * kk][0], c[2 * kk][1]);
      a[1] = pack<T>(c[2 * kk][2], c[2 * kk][3]);
      a[2] = pack<T>(c[2 * kk + 1][0], c[2 * kk + 1][1]);
      a[3] = pack<T>(c[2 * kk + 1][2], c[2 * kk + 1][3]);
#pragma unroll
      for (int jd = 0; jd < ND; ++jd) {
        uint32_t b[2];
        load_b_trans(b, v, ld, kk * 16, jd * 8, lane);
        mma<T>(acc[jd], a, b);
      }
    }
  }
}

// bias_h + mask_m (mask_m may be null) at this thread's entries of the
// warp's rows r0 .. r0 + 15, in the accumulator layout; 0 past L.
template <int NC>
__device__ __forceinline__ void load_add(float (&add)[NC][4], const float* __restrict__ bias_h,
                                         const float* __restrict__ mask_m, int r0, int L,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + g + 8 * (e >> 1);
      const int c = 8 * j + 2 * t + (e & 1);
      float a = 0.f;
      if (i < L && c < L) {
        a = __ldg(bias_h + i * L + c) + (mask_m != nullptr ? __ldg(mask_m + i * L + c) : 0.f);
      }
      add[j][e] = a;
    }
  }
}

// s = (q k^T in f32) * scale + add, then p = softmax over each row, in
// place, as the Pallas `_attend` computes it (no fma contraction, a
// correctly rounded division): -inf past column L (p = 0 there), p = 0 on
// rows past L, and exps below kMinExp taken as 0.
template <int NC>
__device__ __forceinline__ void softmax_rows(float (&s)[NC][4], const float (&add)[NC][4], int r0,
                                             int L, float scale, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    if (j * 8 >= L) continue;  // a chunk wholly past the row's end
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + g + 8 * (e >> 1);
      const int c = 8 * j + 2 * t + (e & 1);
      if (c >= L) {
        s[j][e] = -INFINITY;
      } else if (i < L) {
        s[j][e] = __fadd_rn(__fmul_rn(s[j][e], scale), add[j][e]);
      }  // padding rows keep their 0 scores: finite, and zeroed below
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) mx[r] = quad_reduce<true>(mx[r]);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (j * 8 >= L) {
        s[j][e] = 0.f;
        continue;
      }
      // exp(-inf) = 0 past the row's end; the argument held above -87 keeps
      // expf off denormal results, which it takes slowly
      const float x = expf(fmaxf(s[j][e] - mx[e >> 1], -87.f));
      s[j][e] = x < kMinExp ? 0.f : x;
      sum[e >> 1] += s[j][e];
    }
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] = quad_reduce<false>(sum[r]);
    inv[r] = __frcp_rn(sum[r]);
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    if (j * 8 >= L) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + g + 8 * (e >> 1);
      const float x = s[j][e];  // 0 / sum is 0
      s[j][e] = (i < L && x != 0.f) ? div_normal(x, sum[e >> 1], inv[e >> 1]) : 0.f;
    }
  }
}

// The tensor-core forward (bf16 / f16), LP = 16 R padded rows and DP = 16 RD
// padded head dim: LP / 16 warps, warp w owning query rows 16 w ..
// 16 w + 15. Block (head, p) takes the groups u = p * groups_per_block ..
// of the head in mask-major order.
template <typename T, int LP, int DP>
__global__ void __launch_bounds__(2 * LP, LP <= 112 ? 2 : 1)
window_attention_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const float* __restrict__ bias,
                                const float* __restrict__ mask, T* __restrict__ out, int B, int h,
                                int L, int d, int n_mask, float scale, int groups_per_block,
                                int blocks_per_head, bool vec) {
  constexpr int NC = LP / 8;   // 8-column chunks of a warp's score rows
  constexpr int KD = DP / 16;  // 16-deep steps over the head dim
  constexpr int ND = DP / 8;   // 8-column chunks of a warp's output rows
  constexpr int LD = DP + 8;
  constexpr int TILE = LP * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);  // [2 buffers][q, k, v][LP][LD]
  // bias[h] + mask[m] in the accumulator layout, [warp][chunk][lane] float4:
  // each thread writes and reads only its own entries, so no barrier guards it
  float4* add_s = reinterpret_cast<float4*>(sm + 6 * TILE) + (threadIdx.x >> 5) * NC * 32 +
                  (threadIdx.x & 31);

  const int head = blockIdx.x / blocks_per_head;
  const int u0 = (blockIdx.x - head * blocks_per_head) * groups_per_block;
  const int u1 = min(u0 + groups_per_block, B);
  const int nm = mask != nullptr ? n_mask : 1;
  const int per_mask = B / nm;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5);
  const int64_t tile_elems = (int64_t)L * d;
  const float* bias_h = bias + (int64_t)head * L * L;

  if (u0 < u1) {
    const int64_t base = ((int64_t)group_of(u0, nm, per_mask) * h + head) * tile_elems;
    stage_tile<T, LP, DP>(sm, q + base, L, d, vec);
    stage_tile<T, LP, DP>(sm + TILE, k + base, L, d, vec);
    stage_tile<T, LP, DP>(sm + 2 * TILE, v + base, L, d, vec);
  }
  passl_tc::cp_async_commit();

  int add_mask = -1;  // the mask whose terms add_s holds
  for (int u = u0, it = 0; u < u1; ++u, ++it) {
    const T* Qs = sm + (it & 1) * 3 * TILE;
    const T* Ks = Qs + TILE;
    const T* Vs = Qs + 2 * TILE;
    if (u + 1 < u1) {  // the next group into the other buffer, read last in the previous group
      T* nxt = sm + ((it + 1) & 1) * 3 * TILE;
      const int64_t base = ((int64_t)group_of(u + 1, nm, per_mask) * h + head) * tile_elems;
      stage_tile<T, LP, DP>(nxt, q + base, L, d, vec);
      stage_tile<T, LP, DP>(nxt + TILE, k + base, L, d, vec);
      stage_tile<T, LP, DP>(nxt + 2 * TILE, v + base, L, d, vec);
    }
    passl_tc::cp_async_commit();
    passl_tc::cp_async_wait<1>();  // this group's copies (all but the newest group) are done
    __syncthreads();

    const int m = u / per_mask;
    if (m != add_mask) {  // the run has reached the next mask
      float a[NC][4];
      load_add(a, bias_h, mask != nullptr ? mask + (int64_t)m * L * L : nullptr, r0, L, lane);
#pragma unroll
      for (int j = 0; j < NC; ++j) add_s[j * 32] = make_float4(a[j][0], a[j][1], a[j][2], a[j][3]);
      add_mask = m;
    }
    float s[NC][4];
    {
      uint32_t qa[KD][4];
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) load_a(qa[kk], Qs, LD, r0, kk * 16, lane);
      warp_product<T, NC, KD>(s, qa, Ks, LD, L, lane);
    }
    {
      float a[NC][4];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float4 v4 = add_s[j * 32];
        a[j][0] = v4.x, a[j][1] = v4.y, a[j][2] = v4.z, a[j][3] = v4.w;
      }
      softmax_rows(s, a, r0, L, scale, lane);
    }
    float o[ND][4];
    zero_acc(o);
    acc_times_tile<T, NC, ND>(o, s, Vs, LD, L, lane);  // o = (p at T) v
    const int64_t base = ((int64_t)group_of(u, nm, per_mask) * h + head) * tile_elems;
    store_rows_mma<T, ND>(out + base, o, r0, L, d, lane);
    __syncthreads();  // every read of this buffer is done before it is refilled
  }
}

template <typename T, int LP, int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const float* bias,
                       const float* mask, void* out, int B, int h, int L, int d, int n_mask,
                       float scale, bool vec, cudaStream_t stream) {
  const size_t smem = 2 * 3 * (size_t)LP * (DP + 8) * sizeof(T) + (size_t)LP * LP * sizeof(float);
  auto kernel = window_attention_fwd_mma_kernel<T, LP, DP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // as many blocks as the card holds at once: each loops over its run
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 2 * LP, smem);
  if (err != cudaSuccess) return err;
  int gpb, bph;
  split(B, h, sms * (per_sm > 0 ? per_sm : 1), &gpb, &bph);
  kernel<<<(unsigned)(h * bph), 2 * LP, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias, mask,
      static_cast<T*>(out), B, h, L, d, n_mask, scale, gpb, bph, vec);
  return cudaGetLastError();
}

template <typename T, int LP>
cudaError_t launch_mma_r(const void* q, const void* k, const void* v, const float* bias,
                         const float* mask, void* out, int B, int h, int L, int d, int n_mask,
                         float scale, bool vec, cudaStream_t st) {
  switch (cols_per_thread(d)) {
    case 2: return launch_mma<T, LP, 32>(q, k, v, bias, mask, out, B, h, L, d, n_mask, scale, vec, st);
    case 4: return launch_mma<T, LP, 64>(q, k, v, bias, mask, out, B, h, L, d, n_mask, scale, vec, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_mma_t(const void* q, const void* k, const void* v, const float* bias,
                         const float* mask, void* out, int B, int h, int L, int d, int n_mask,
                         float scale, bool vec, cudaStream_t st) {
  switch (rows_per_thread(L)) {
    case 2: return launch_mma_r<T, 32>(q, k, v, bias, mask, out, B, h, L, d, n_mask, scale, vec, st);
    case 4: return launch_mma_r<T, 64>(q, k, v, bias, mask, out, B, h, L, d, n_mask, scale, vec, st);
    case 7: return launch_mma_r<T, 112>(q, k, v, bias, mask, out, B, h, L, d, n_mask, scale, vec, st);
    case 8: return launch_mma_r<T, 128>(q, k, v, bias, mask, out, B, h, L, d, n_mask, scale, vec, st);
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
  const void* tiles[] = {q, k, v};
  const bool vec = vec_ok(d, tiles, 3);
  switch (dtype) {
    case 0: return (int)launch_t<float>(q, k, v, b32, m32, out, B, h, L, d, n_mask, scale, st);
    case 1:
      return (int)launch_mma_t<__nv_bfloat16>(q, k, v, b32, m32, out, B, h, L, d, n_mask, scale,
                                              vec, st);
    case 2:
      return (int)launch_mma_t<__half>(q, k, v, b32, m32, out, B, h, L, d, n_mask, scale, vec, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
