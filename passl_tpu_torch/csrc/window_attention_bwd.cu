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
// products (s, dv, dp, dq, dk) are 10 B h L^2 d flops, 38 GFLOP there:
// 38 us on the tensor cores at 989 TFLOP/s, so in bf16 / f16 the function
// is bound by bytes; in f32 (0.57 ms at the CUDA cores' 67 TFLOP/s) by the
// products.
//
// dk and dv sum over the queries, so a block needs the whole [L, L] tile of
// a (group, head). A block owns one head and a fixed run of its groups. The
// TPU kernel added dbias into one VMEM-resident block over its sequential
// grid; a CUDA grid has no order, so dbias is summed in two fixed-order
// stages with no atomics, which makes it bitwise the same on every launch:
//   1. the backward kernel: each thread keeps the ds entries it owns (the
//      same entries for every group) summed in registers over the block's
//      groups, in the run's order, and writes them to the block's [L, L]
//      partial at the end;
//   2. window_attention_dbias_reduce: each output adds the partials of its
//      head's blocks in block order.
//
// bf16 / f16: the tensor-core kernel. The first design (the CUDA-core
// kernel below, which f32 still takes) ran the five products on the CUDA
// cores in f32 from shared memory, with six barriers a group and no copy
// in flight, at 2.4% of the bytes bound in bf16 and slower than its own
// plain version in f32. Now a block of 2 LP / 16 warps, over the head's
// groups in mask-major order (window_attention.cuh):
// - copies the next group's q, k, v and do into the second of two buffers
//   with cp.async while the current group is computed;
// - gives each 16 query rows two warps, one per half of the key columns,
//   which compute s = q k^T, the softmax, dp = do v^T and ds in registers
//   (mma.sync m16n8k16, f32 accumulation) and add ds into their dbias
//   entries; the row max, the row sum and sum_k dp p are combined between
//   the two through shared memory under a named barrier, half 0 first, so
//   the sums keep one order; pd and dsd go to shared memory at T;
// - after one barrier, gives each warp 16 key rows of dv = pd^T do (the
//   first half of the warps) or dk = dsd^T q (the second), the transposed
//   A operands read with ldmatrix.x4.trans, and 16 query rows of half of
//   dq's columns, dq = dsd k, k through ldmatrix.trans.
// Splitting the key columns halves the registers a thread holds (p, dp and
// the dbias entries: 3 x LP / 4 floats) and doubles the warps an SM runs:
// one block of 14 warps at L = 98, where one of 7 held 218 registers.
// bias[h] + mask[m] stay in shared memory, reloaded when the run reaches
// the next mask (all shapes but L > 112 with d > 32, where shared memory is
// full and they come from L2 for every group). mma.sync, not wgmma:
// wgmma's 64-row tiles would pad L = 98 to 128 (1.67x the work). What
// bounds it now: one block an SM (178 KB of shared memory at L = 98), whose
// warps wait on each other at three barriers and three pair exchanges a
// group with no other block to fill the gaps, and the exps of the softmax.
//
// f32: per group, q, k, v and do are staged as f32 (4 * 16R * (16RD + 1)
// floats) with one [16R, 16R + 1] f32 tile for p, then, in place, for dsd:
// 110 KB at L = 98, d = 32, and 199 KB at the limits L = 128, d = 64
// (opted in beyond 48 KB with cudaFuncAttributeMaxDynamicSharedMemorySize).
// The row sums of dp p are half-warp shuffles over the register tiles of
// dp; the groups of a block's run come in natural order.

#include "window_attention.cuh"

namespace {

using namespace passl_wa;

constexpr int kTargetBlocks = 4 * 132;  // blocks per launch that stage 1 aims at: 4 per H100 SM

// The CUDA-core backward, instantiated for f32 (bf16 and f16 take the
// tensor-core kernel below).
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
void split_bwd(int B, int h, int* groups_per_block, int* blocks_per_head) {
  split(B, h, kTargetBlocks, groups_per_block, blocks_per_head);
}

constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may opt in to on sm_90

// Shared memory of the tensor-core backward: two buffers of q, k, v and do,
// pd and dsd, the row statistics the two warps of a row block exchange, and
// bias + mask in the accumulator layout where it fits (every shape but
// L > 112 with d > 32, which reads them from L2 for every group).
template <typename T, int LP, int DP>
__host__ __device__ constexpr size_t bwd_tiles_bytes() {
  return (8 * (size_t)LP * (DP + 8) + 2 * (size_t)LP * (LP + 8)) * sizeof(T) +
         3 * (size_t)(LP / 16) * 2 * 16 * sizeof(float);
}
template <typename T, int LP, int DP>
__host__ __device__ constexpr bool bwd_add_shared() {
  return bwd_tiles_bytes<T, LP, DP>() + (size_t)LP * LP * sizeof(float) <= kMaxSmem;
}
template <typename T, int LP, int DP>
__host__ __device__ constexpr size_t bwd_smem_bytes() {
  return bwd_tiles_bytes<T, LP, DP>() +
         (bwd_add_shared<T, LP, DP>() ? (size_t)LP * LP * sizeof(float) : 0);
}

// The chunks (8 columns each) of the first half of a row: an even number,
// so that both halves are whole 16-key steps (LP = 112: 8 and 6).
template <int NC>
__host__ __device__ constexpr int first_half() {
  return (NC / 2 + 1) / 2 * 2;
}

// The tensor-core backward (bf16 / f16), LP = 16 R padded rows and DP =
// 16 RD padded head dim: 2 LP / 16 warps. In the first part of a group,
// warps w and w + LP / 16 own query rows 16 w .. 16 w + 15 and the first
// and second half of the key columns; the row max, sum and sum_k dp p are
// combined between the two through shared memory under a named barrier,
// half 0 first. In the second part, warp w owns key rows 16 w .. 16 w + 15
// for dv (w < LP / 16) or dk, and query rows 16 w .. for half of dq's
// columns. Block (head, p) takes the groups u = p * groups_per_block .. of
// the head in mask-major order and sums its dbias partial in that order.
template <typename T, int LP, int DP>
__global__ void __launch_bounds__(4 * LP)
window_attention_bwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const float* __restrict__ bias,
                                const float* __restrict__ mask, const T* __restrict__ dout,
                                T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                                float* __restrict__ partials, int B, int h, int L, int d,
                                int n_mask, float scale, int groups_per_block,
                                int blocks_per_head, bool vec) {
  constexpr int NC = LP / 8;            // 8-column chunks of a row block's [16, LP] tiles
  constexpr int H0 = first_half<NC>();  // chunks of half 0; half 1 has NC - H0 <= H0
  constexpr int NW = LP / 16;           // row blocks
  constexpr int KD = DP / 16;           // 16-deep steps over the head dim
  constexpr int ND = DP / 8;            // 8-column chunks of a [16, DP] tile
  constexpr int NDH = ND / 2;           // ... of half of it (dq's share of a warp)
  constexpr int LD = DP + 8;
  constexpr int LDP = LP + 8;
  constexpr int TILE = LP * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);  // [2 buffers][q, k, v, do][LP][LD]
  T* PD = sm + 8 * TILE;                   // [LP, LDP]: pd, rows are queries
  T* DS = PD + LP * LDP;                   // [LP, LDP]: dsd
  float* red = reinterpret_cast<float*>(DS + LP * LDP);  // [max, sum, dot][NW][half][16 rows]
  // bias[h] + mask[m] as the forward keeps them, [row block][chunk][lane]
  // float4: each thread's own entries (no barrier guards them)
  constexpr bool kAddShared = bwd_add_shared<T, LP, DP>();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp % NW;
  const int half = warp / NW;
  const int r0 = 16 * wrow;
  const int c0 = half ? H0 : 0;       // first chunk of this warp's half
  const int nch = half ? NC - H0 : H0;
  float4* add_s = reinterpret_cast<float4*>(red + 3 * NW * 2 * 16) + wrow * NC * 32 + lane;
  int add_mask = -1;  // the mask whose terms add_s holds

  const int head = blockIdx.x / blocks_per_head;
  const int u0 = (blockIdx.x - head * blocks_per_head) * groups_per_block;
  const int u1 = min(u0 + groups_per_block, B);
  const int nm = mask != nullptr ? n_mask : 1;
  const int per_mask = B / nm;
  const int64_t tile_elems = (int64_t)L * d;
  const float* bias_h = bias + (int64_t)head * L * L;

  // the two halves' values of this thread's rows (g, g + 8) combined, half 0
  // first, the same in both warps of the row block
  auto combine = [&](float* buf, float v0, float v1, bool is_max, float& o0, float& o1) {
    float* mine = buf + (wrow * 2 + half) * 16;
    if (t == 0) {
      mine[g] = v0;
      mine[g + 8] = v1;
    }
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + wrow));  // the row block's two warps
    const float* a = buf + wrow * 2 * 16;
    const float* b = a + 16;
    o0 = is_max ? fmaxf(a[g], b[g]) : a[g] + b[g];
    o1 = is_max ? fmaxf(a[g + 8], b[g + 8]) : a[g + 8] + b[g + 8];
  };

  float dbias[H0][4];  // this thread's ds entries summed over the run
  zero_acc(dbias);
  if (u0 < u1) {
    const int64_t base = ((int64_t)group_of(u0, nm, per_mask) * h + head) * tile_elems;
    stage_tile<T, LP, DP>(sm, q + base, L, d, vec);
    stage_tile<T, LP, DP>(sm + TILE, k + base, L, d, vec);
    stage_tile<T, LP, DP>(sm + 2 * TILE, v + base, L, d, vec);
    stage_tile<T, LP, DP>(sm + 3 * TILE, dout + base, L, d, vec);
  }
  passl_tc::cp_async_commit();

  for (int u = u0, it = 0; u < u1; ++u, ++it) {
    const T* Qs = sm + (it & 1) * 4 * TILE;
    const T* Ks = Qs + TILE;
    const T* Vs = Qs + 2 * TILE;
    const T* DOs = Qs + 3 * TILE;
    if (u + 1 < u1) {  // the next group into the other buffer, read last in the previous group
      T* nxt = sm + ((it + 1) & 1) * 4 * TILE;
      const int64_t base = ((int64_t)group_of(u + 1, nm, per_mask) * h + head) * tile_elems;
      stage_tile<T, LP, DP>(nxt, q + base, L, d, vec);
      stage_tile<T, LP, DP>(nxt + TILE, k + base, L, d, vec);
      stage_tile<T, LP, DP>(nxt + 2 * TILE, v + base, L, d, vec);
      stage_tile<T, LP, DP>(nxt + 3 * TILE, dout + base, L, d, vec);
    }
    passl_tc::cp_async_commit();
    passl_tc::cp_async_wait<1>();  // this group's copies (all but the newest group) are done
    __syncthreads();
    const int64_t base = ((int64_t)group_of(u, nm, per_mask) * h + head) * tile_elems;

    // ---- query rows r0 .., this half's columns: p, then dp and ds
    float p[H0][4], ds[H0][4];
    zero_acc(p);
    zero_acc(ds);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], da[4];
      load_a(qa, Qs, LD, r0, kk * 16, lane);
      load_a(da, DOs, LD, r0, kk * 16, lane);
#pragma unroll
      for (int jj = 0; jj < H0; ++jj) {
        const int j = c0 + jj;
        if (jj < nch && j * 8 < L) {
          uint32_t b[2];
          load_b(b, Ks, LD, j * 8, kk * 16, lane);
          mma<T>(p[jj], qa, b);  // s = q k^T
          load_b(b, Vs, LD, j * 8, kk * 16, lane);
          mma<T>(ds[jj], da, b);  // dp = do v^T
        }
      }
    }
    const int m = u / per_mask;
    const bool reload = !kAddShared || m != add_mask;
    const float* mask_m = mask != nullptr ? mask + (int64_t)m * L * L : nullptr;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jj = 0; jj < H0; ++jj) {
      const int j = c0 + jj;
      if (jj >= nch || j * 8 >= L) continue;
      float a[4];
      if (reload) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = r0 + g + 8 * (e >> 1);
          const int c = 8 * j + 2 * t + (e & 1);
          a[e] = 0.f;
          if (i < L && c < L)
            a[e] = __ldg(bias_h + i * L + c) + (mask_m != nullptr ? __ldg(mask_m + i * L + c) : 0.f);
        }
        if (kAddShared) add_s[j * 32] = make_float4(a[0], a[1], a[2], a[3]);
      } else {
        const float4 v4 = add_s[j * 32];
        a[0] = v4.x, a[1] = v4.y, a[2] = v4.z, a[3] = v4.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = r0 + g + 8 * (e >> 1);
        const int c = 8 * j + 2 * t + (e & 1);
        if (c >= L) {
          p[jj][e] = -INFINITY;
        } else if (i < L) {
          p[jj][e] = __fadd_rn(__fmul_rn(p[jj][e], scale), a[e]);
        }  // padding rows keep their 0 scores: finite, and zeroed below
        mx[e >> 1] = fmaxf(mx[e >> 1], p[jj][e]);
      }
    }
    add_mask = m;
    float row0, row1;
    combine(red, quad_reduce<true>(mx[0]), quad_reduce<true>(mx[1]), true, row0, row1);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int jj = 0; jj < H0; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (jj >= nch || (c0 + jj) * 8 >= L) {
          p[jj][e] = 0.f;
          continue;
        }
        const float x = expf(fmaxf(p[jj][e] - ((e >> 1) ? row1 : row0), -87.f));
        p[jj][e] = x < kMinExp ? 0.f : x;
        sum[e >> 1] += p[jj][e];
      }
    }
    float tot0, tot1;
    combine(red + NW * 2 * 16, quad_reduce<false>(sum[0]), quad_reduce<false>(sum[1]), false, tot0,
            tot1);
    const float inv0 = __frcp_rn(tot0), inv1 = __frcp_rn(tot1);
    float dot[2] = {0.f, 0.f};
#pragma unroll
    for (int jj = 0; jj < H0; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = r0 + g + 8 * (e >> 1);
        const float x = p[jj][e];  // 0 / sum is 0
        p[jj][e] = (i < L && x != 0.f)
                       ? div_normal(x, (e >> 1) ? tot1 : tot0, (e >> 1) ? inv1 : inv0)
                       : 0.f;
        dot[e >> 1] = fmaf(ds[jj][e], p[jj][e], dot[e >> 1]);
      }
    }
    float dot0, dot1;
    combine(red + 2 * NW * 2 * 16, quad_reduce<false>(dot[0]), quad_reduce<false>(dot[1]), false,
            dot0, dot1);
#pragma unroll
    for (int jj = 0; jj < H0; ++jj) {
      if (jj >= nch) continue;
      const int col = 8 * (c0 + jj) + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float gs = p[jj][e] * (ds[jj][e] - ((e >> 1) ? dot1 : dot0));  // ds = p (dp - sum)
        dbias[jj][e] += gs;
        ds[jj][e] = __fmul_rn(gs, scale);  // dsd, rounded to T where it is packed
      }
      *reinterpret_cast<uint32_t*>(PD + (r0 + g) * LDP + col) = pack<T>(p[jj][0], p[jj][1]);
      *reinterpret_cast<uint32_t*>(PD + (r0 + g + 8) * LDP + col) = pack<T>(p[jj][2], p[jj][3]);
      *reinterpret_cast<uint32_t*>(DS + (r0 + g) * LDP + col) = pack<T>(ds[jj][0], ds[jj][1]);
      *reinterpret_cast<uint32_t*>(DS + (r0 + g + 8) * LDP + col) = pack<T>(ds[jj][2], ds[jj][3]);
    }
    __syncthreads();  // pd and dsd are whole

    // ---- key rows r0 ..: dv = pd^T do (half 0) or dk = dsd^T q (half 1);
    // query rows r0 ..: dq = dsd k over this half's columns of dq
    {
      const T* At = half ? DS : PD;
      const T* Bt = half ? Qs : DOs;
      float acc[ND][4], dqa[NDH][4];
      zero_acc(acc);
      zero_acc(dqa);
#pragma unroll
      for (int kk = 0; kk < NC / 2; ++kk) {
        if (kk * 16 < L) {  // rows and columns at or past L have pd = dsd = 0
          uint32_t a[4], sa[4];
          load_a_trans(a, At, LDP, kk * 16, r0, lane);
          load_a(sa, DS, LDP, r0, kk * 16, lane);
#pragma unroll
          for (int jd = 0; jd < ND; ++jd) {
            uint32_t b[2];
            load_b_trans(b, Bt, LD, kk * 16, jd * 8, lane);
            mma<T>(acc[jd], a, b);
          }
#pragma unroll
          for (int jd = 0; jd < NDH; ++jd) {
            uint32_t b[2];
            load_b_trans(b, Ks, LD, kk * 16, (half * NDH + jd) * 8, lane);
            mma<T>(dqa[jd], sa, b);
          }
        }
      }
      store_rows_mma<T, ND>((half ? dk : dv) + base, acc, r0, L, d, lane);
      store_rows_mma<T, NDH>(dq + base, dqa, r0, L, d, lane, half * NDH * 8);
    }
    __syncthreads();  // every read of this buffer, pd and dsd is done before they are refilled
  }

  float* part = partials + (int64_t)blockIdx.x * L * L;
#pragma unroll
  for (int jj = 0; jj < H0; ++jj) {
    if (jj >= nch) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + g + 8 * (e >> 1);
      const int c = 8 * (c0 + jj) + 2 * t + (e & 1);
      if (i < L && c < L) part[i * L + c] = dbias[jj][e];
    }
  }
}

template <typename T, int LP, int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const float* bias,
                       const float* mask, const void* dout, void* dq, void* dk, void* dv,
                       float* partials, int B, int h, int L, int d, int n_mask, float scale,
                       bool vec, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<T, LP, DP>();
  auto kernel = window_attention_bwd_mma_kernel<T, LP, DP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int gpb, bph;
  split_bwd(B, h, &gpb, &bph);
  kernel<<<(unsigned)(h * bph), 4 * LP, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias, mask,
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
      partials, B, h, L, d, n_mask, scale, gpb, bph, vec);
  return cudaGetLastError();
}

template <typename T, int LP>
cudaError_t launch_mma_r(const void* q, const void* k, const void* v, const float* bias,
                         const float* mask, const void* dout, void* dq, void* dk, void* dv,
                         float* partials, int B, int h, int L, int d, int n_mask, float scale,
                         bool vec, cudaStream_t stream) {
  switch (cols_per_thread(d)) {
    case 2:
      return launch_mma<T, LP, 32>(q, k, v, bias, mask, dout, dq, dk, dv, partials, B, h, L, d,
                                   n_mask, scale, vec, stream);
    case 4:
      return launch_mma<T, LP, 64>(q, k, v, bias, mask, dout, dq, dk, dv, partials, B, h, L, d,
                                   n_mask, scale, vec, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_mma_t(const void* q, const void* k, const void* v, const float* bias,
                         const float* mask, const void* dout, void* dq, void* dk, void* dv,
                         float* partials, int B, int h, int L, int d, int n_mask, float scale,
                         bool vec, cudaStream_t stream) {
#define PASSL_WA_BWD_LP(r, lp)                                                                \
  case r:                                                                                     \
    return launch_mma_r<T, lp>(q, k, v, bias, mask, dout, dq, dk, dv, partials, B, h, L, d,   \
                               n_mask, scale, vec, stream)
  switch (rows_per_thread(L)) {
    PASSL_WA_BWD_LP(2, 32);
    PASSL_WA_BWD_LP(4, 64);
    PASSL_WA_BWD_LP(7, 112);
    PASSL_WA_BWD_LP(8, 128);
    default: return cudaErrorInvalidValue;
  }
#undef PASSL_WA_BWD_LP
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
  split_bwd(B, h, &gpb, &bph);
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
  split_bwd(B, h, &gpb, &bph);
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
  const void* tiles[] = {q, k, v, dout};
  const bool vec = vec_ok(d, tiles, 4);
  switch (dtype) {
    case 0:
      err = launch_t<float>(q, k, v, b32, m32, dout, dq, dk, dv, part, B, h, L, d, n_mask, scale,
                            st);
      break;
    case 1:
      err = launch_mma_t<__nv_bfloat16>(q, k, v, b32, m32, dout, dq, dk, dv, part, B, h, L, d,
                                        n_mask, scale, vec, st);
      break;
    case 2:
      err = launch_mma_t<__half>(q, k, v, b32, m32, dout, dq, dk, dv, part, B, h, L, d, n_mask,
                                 scale, vec, st);
      break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  int gpb, bph;
  split_bwd(B, h, &gpb, &bph);
  const int64_t outputs = (int64_t)h * L * L;
  window_attention_dbias_reduce<<<(unsigned)((outputs + 255) / 256), 256, 0, st>>>(
      part, bph, L * L, h, static_cast<float*>(dbias));
  return (int)cudaGetLastError();
}
