// Flash-attention backward for Hopper (sm_90a): two kernels, dK/dV and dQ.
//
// Replace the two backward Pallas kernels of the JAX library flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py,
// `_flash_attention_dkv_kernel` and `_flash_attention_dq_kernel`) that the
// custom VJP of passl_tpu/ops/attention.py:111 runs. Both recompute, from
// q, k and the forward's f32 row statistics m and l, the library's
//
//     p  = exp(s - m) * (1 / l),          s = (q k^T in f32) * scale
//     ds = ((do v^T in f32) - di) * p * scale,   di = sum_d o * do (f32, given)
//
// and then dK/dV: dv = (p at do's type)^T do, dk = (ds at do's type)^T q;
// dQ: dq = (ds at k's type) k; f32 sums, outputs at q's type. Rows past L
// are masked in the kernels, as the library's segment ids mask its padding.
//
// Bound. Device-memory bytes at ViT-B/16 with 128 images (n = 128, L = 197,
// h = 12, d = 64, bf16), each input read once and each output written once:
// dK/dV reads q, k, v, do and m, l, di and writes dk, dv, 236 MB, 70 us at
// 3.35 TB/s; dQ reads the same and writes dq, 197 MB, 59 us. The work is
// 8 and 6 n h L^2 d flops (31 and 23 us on the tensor cores at
// 989 TFLOP/s), so both are bound by bytes; in f32 (0.46 and 0.34 ms at the
// CUDA cores' 67 TFLOP/s) by the products.
//
// Design. dK/dV: one block per (image x head, 64-row k tile), k and v
// staged once; a loop over 64-row q tiles stages q and do, recomputes p,
// adds p^T do to dv, forms ds from do v^T, and adds ds^T q to dk, in
// registers. dQ: one block per (image x head, q tile of 64 rows in f32,
// 128 in bf16 / f16), q and do staged once; a loop over 64-row k tiles
// stages k and v and adds ds k to dq.
// Every block owns its outputs: there are no atomics, so both are bitwise
// the same on every launch. The split into two kernels is the library's:
// it spends the recompute of p twice to need no reduction across blocks.
// bf16 / f16 run the products on the tensor cores (mma.sync m16n8k16, f32
// accumulation, p and ds kept in registers between products; see
// flash_attention.cuh), f32 on the CUDA cores from shared memory.
// - dK/dV (bf16 / f16): a 1-D grid runs the k tiles of one head side by
//   side, so each head's q and do come from device memory about once and
//   from L2 after; q and do tiles are double-buffered with cp.async and the
//   rows' statistics prefetched in registers; each warp holds its 16 keys'
//   k and v rows as A operands and takes the q tile in 16-row slabs (p and
//   ds in 16 registers a thread); warps past L and slabs past L do no work,
//   and full tiles take a body with no branch (dkv_tile<FULL>). At d = 64:
//   168 registers (32 bytes spilled), 38,400 B of shared memory, 3 blocks
//   (12 warps) an SM. What bounds it now: the latency of each warp's chain
//   of four products a slab, with 12 warps an SM to hide it.
// - dQ (bf16 / f16): the forward's skeleton. A 1-D grid runs the 128-row q
//   tiles of one head side by side, so each head's k and v come from device
//   memory about once and from L2 after; each of the 8 warps holds its 16
//   rows' q and do as A operands and their m, 1 / l and di in registers for
//   the whole run; k and v tiles are double-buffered with cp.async; each k
//   tile is taken in 32-key slabs (s and dp in 16 registers a thread each);
//   warps past L and 8-key chunks past L do no work, and full k tiles take
//   a body with no branch (dq_tile<FULL>). At d = 64: 128 registers (16
//   bytes spilled), 73,728 B of shared memory, 2 blocks (16 warps) an SM.
//   What bounds it now: as in the other two, the latency of each warp's
//   chain of products, exps and products a slab, with 16 warps an SM to
//   hide it; 128-key tiles and wgmma are the next step.

#include "flash_attention.cuh"

namespace {

using namespace passl_fa;

// This thread's p and ds tiles (rows q = q0 + ty + 16 a, columns k = k0 + tx
// + 16 c) from the staged q, k, v, do tiles and the rows' m, 1 / l and di:
// p and ds are 0 past the last token, so sums over the padding add nothing.
template <int LD>
__device__ __forceinline__ void p_and_ds(float (&p)[kRows][kRows], float (&ds)[kRows][kRows],
                                         const float* Qs, const float* Ks, const float* Vs,
                                         const float* dOs, const float (&m)[kRows],
                                         const float (&inv_l)[kRows], const float (&di)[kRows],
                                         int q0, int k0, int L, int d, float scale, int ty,
                                         int tx) {
  scores<LD>(p, Qs, Ks, d, scale, ty, tx);
  zero(ds);
  gemm<kRows, kRows, false, float>(ds, dOs, LD, 1, Vs, 1, LD, d, ty, tx);  // dp = do v^T
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const bool row_ok = q0 + ty + kGrid * a < L;
#pragma unroll
    for (int c = 0; c < kRows; ++c) {
      const bool ok = row_ok && k0 + tx + kGrid * c < L;
      p[a][c] = ok ? __fmul_rn(expf(__fsub_rn(p[a][c], m[a])), inv_l[a]) : 0.f;
      ds[a][c] = __fmul_rn(__fmul_rn(__fsub_rn(ds[a][c], di[a]), p[a][c]), scale);
    }
  }
}

// m, 1 / l and di of this thread's rows q0 + ty + 16 a (0, 1, 0 past L).
__device__ __forceinline__ void row_stats(float (&m)[kRows], float (&inv_l)[kRows],
                                          float (&di)[kRows], const float* __restrict__ m_in,
                                          const float* __restrict__ l_in,
                                          const float* __restrict__ di_in, int q0, int L, int ty) {
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int i = q0 + ty + kGrid * a;
    m[a] = i < L ? m_in[i] : 0.f;
    inv_l[a] = i < L ? 1.f / l_in[i] : 1.f;
    di[a] = i < L ? di_in[i] : 0.f;
  }
}

template <int TM, int TN, typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ out, const float (&acc)[TM][TN], int b,
                                           int head, int row0, int L, int h, int d, int ty,
                                           int tx) {
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int i = row0 + ty + kGrid * a;
    if (i >= L) continue;
    T* row = out + (((int64_t)b * L + i) * h + head) * d;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int col = tx + kGrid * c;
      if (col < d) row[col] = from_f32<T>(acc[a][c]);
    }
  }
}

// The CUDA-core dK/dV and dQ, instantiated for f32 (bf16 and f16 take the
// tensor-core kernels below); T marks where the library rounds.
template <typename T, int RD>
__global__ void __launch_bounds__(kThreads)
flash_attention_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ m_in, const float* __restrict__ l_in,
                           const float* __restrict__ di_in, T* __restrict__ dk,
                           T* __restrict__ dv, int L, int h, int d, int64_t s_b, int64_t s_l,
                           int64_t s_h, float scale) {
  constexpr int DP = kGrid * RD;
  constexpr int LD = DP + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* dOs = Qs + kTile * LD;
  float* Ps = dOs + kTile * LD;  // [64 q, kLdP]: p, then ds, at T's precision

  const int bh = blockIdx.x;
  const int b = bh / h;
  const int head = bh - b * h;
  const int k0 = blockIdx.y * kTile;
  const int64_t base = (int64_t)b * s_b + (int64_t)head * s_h;
  const int64_t do_base = (int64_t)b * L * h * d + (int64_t)head * d;  // do is contiguous
  const int64_t row_base = (int64_t)bh * L;
  const int tx = threadIdx.x % kGrid;
  const int ty = threadIdx.x / kGrid;

  stage_rows<T, DP>(Ks, k + base, s_l, k0, L, d);
  stage_rows<T, DP>(Vs, v + base, s_l, k0, L, d);

  float dk_acc[kRows][RD], dv_acc[kRows][RD];  // rows k0 + ty + 16 a
  zero(dk_acc);
  zero(dv_acc);
  for (int q0 = 0; q0 < L; q0 += kTile) {
    __syncthreads();  // the last tile's reads of Qs, dOs and Ps are done
    stage_rows<T, DP>(Qs, q + base, s_l, q0, L, d);
    stage_rows<T, DP>(dOs, dout + do_base, (int64_t)h * d, q0, L, d);
    float m[kRows], inv_l[kRows], di[kRows];
    row_stats(m, inv_l, di, m_in + row_base, l_in + row_base, di_in + row_base, q0, L, ty);
    __syncthreads();

    float p[kRows][kRows], ds[kRows][kRows];
    p_and_ds<LD>(p, ds, Qs, Ks, Vs, dOs, m, inv_l, di, q0, k0, L, d, scale, ty, tx);
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
#pragma unroll
      for (int c = 0; c < kRows; ++c) Ps[(ty + kGrid * a) * kLdP + tx + kGrid * c] = round_to<T>(p[a][c]);
    }
    __syncthreads();
    const int nq = min(kTile, L - q0);
    // dv[j][col] += sum_i p[i][j] do[i][col]
    gemm<kRows, RD, false, float>(dv_acc, Ps, 1, kLdP, dOs, LD, 1, nq, ty, tx);
    __syncthreads();  // every read of p is done
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
#pragma unroll
      for (int c = 0; c < kRows; ++c) Ps[(ty + kGrid * a) * kLdP + tx + kGrid * c] = round_to<T>(ds[a][c]);
    }
    __syncthreads();
    // dk[j][col] += sum_i ds[i][j] q[i][col]
    gemm<kRows, RD, false, float>(dk_acc, Ps, 1, kLdP, Qs, LD, 1, nq, ty, tx);
  }
  store_rows(dk, dk_acc, b, head, k0, L, h, d, ty, tx);
  store_rows(dv, dv_acc, b, head, k0, L, h, d, ty, tx);
}

template <typename T, int RD>
__global__ void __launch_bounds__(kThreads)
flash_attention_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ m_in, const float* __restrict__ l_in,
                          const float* __restrict__ di_in, T* __restrict__ dq, int L, int h,
                          int d, int64_t s_b, int64_t s_l, int64_t s_h, float scale) {
  constexpr int DP = kGrid * RD;
  constexpr int LD = DP + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * LD;
  float* Ks = dOs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;  // [64 q, kLdP]: ds at T's precision

  const int bh = blockIdx.x;
  const int b = bh / h;
  const int head = bh - b * h;
  const int q0 = blockIdx.y * kTile;
  const int64_t base = (int64_t)b * s_b + (int64_t)head * s_h;
  const int64_t do_base = (int64_t)b * L * h * d + (int64_t)head * d;
  const int64_t row_base = (int64_t)bh * L;
  const int tx = threadIdx.x % kGrid;
  const int ty = threadIdx.x / kGrid;

  stage_rows<T, DP>(Qs, q + base, s_l, q0, L, d);
  stage_rows<T, DP>(dOs, dout + do_base, (int64_t)h * d, q0, L, d);
  float m[kRows], inv_l[kRows], di[kRows];
  row_stats(m, inv_l, di, m_in + row_base, l_in + row_base, di_in + row_base, q0, L, ty);

  float dq_acc[kRows][RD];  // rows q0 + ty + 16 a
  zero(dq_acc);
  for (int k0 = 0; k0 < L; k0 += kTile) {
    __syncthreads();  // the last tile's reads of Ks and Ps are done
    stage_rows<T, DP>(Ks, k + base, s_l, k0, L, d);
    stage_rows<T, DP>(Vs, v + base, s_l, k0, L, d);
    __syncthreads();

    float p[kRows][kRows], ds[kRows][kRows];
    p_and_ds<LD>(p, ds, Qs, Ks, Vs, dOs, m, inv_l, di, q0, k0, L, d, scale, ty, tx);
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
#pragma unroll
      for (int c = 0; c < kRows; ++c) Ps[(ty + kGrid * a) * kLdP + tx + kGrid * c] = round_to<T>(ds[a][c]);
    }
    __syncthreads();
    // dq[i][col] += sum_j ds[i][j] k[j][col]
    gemm<kRows, RD, false, float>(dq_acc, Ps, kLdP, 1, Ks, LD, 1, min(kTile, L - k0), ty, tx);
  }
  store_rows(dq, dq_acc, b, head, q0, L, h, d, ty, tx);
}

// ------------------------------------------------------------ tensor cores
//
// The tensor-core backward (bf16 / f16), blocks of 4 warps, warp w owning
// rows 16 w .. 16 w + 15 of the block's tile. dK/dV computes the transposed
// tiles s^T = k q^T and dp^T = v do^T (rows: the block's keys), so that p^T
// and ds^T are A operands of dv += p^T do and dk += ds^T q as they stand;
// dQ computes s = q k^T and dp = do v^T and adds ds k. Each tile is staged
// once, as rows; the B operands read down its rows (q and do for dK/dV, k
// for dQ) come through `ldmatrix.trans`.

// p and ds of one accumulator entry: p = exp(s * scale - m) * (1 / l) and
// ds = ((dp - di) * p) * scale, or 0 and 0 where `ok` is false.
__device__ __forceinline__ void p_ds(float& s, float& dp, bool ok, float m, float inv_l, float di,
                                     float scale) {
  const float p = ok ? __fmul_rn(expf(__fsub_rn(__fmul_rn(s, scale), m)), inv_l) : 0.f;
  dp = __fmul_rn(__fmul_rn(__fsub_rn(dp, di), p), scale);
  s = p;
}

template <typename T, int DP>
__device__ __forceinline__ void store_rows_mma(T* __restrict__ out, const float (&acc)[DP / 8][4],
                                               int b, int head, int row0, int L, int h, int d,
                                               int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + (lane >> 2) + 8 * r;
    if (i >= L) continue;
    T* row = out + (((int64_t)b * L + i) * h + head) * d;
#pragma unroll
    for (int jd = 0; jd < DP / 8; ++jd) {
      const int col = jd * 8 + 2 * (lane & 3);
      if (col < d) *reinterpret_cast<uint32_t*>(row + col) = pack<T>(acc[jd][2 * r], acc[jd][2 * r + 1]);
    }
  }
}

// One q tile of dK/dV for one warp's 16 keys (k and v rows as A operands kf,
// vf), in 16-row slabs of queries, those that hold a query only: s^T and dp^T
// of the slab (two 8-column chunks each), p and ds from the rows' m, 1 / l
// and di (ms: [m, 1 / l, di][64]), then dv += p^T do and dk += ds^T q, so
// that p and ds live in 16 registers a thread, not 64. FULL: all 64 queries
// and all 16 keys lie before L, so nothing is skipped or masked and the code
// has no branch.
template <typename T, int DP, bool FULL>
__device__ __forceinline__ void dkv_tile(float (&dk_acc)[DP / 8][4], float (&dv_acc)[DP / 8][4],
                                         const uint32_t (&kf)[DP / 16][4],
                                         const uint32_t (&vf)[DP / 16][4], const T* Qs,
                                         const T* dOs, const float* ms, int q0, int key0, int L,
                                         float scale, int lane) {
  constexpr int LD = DP + 8;
  const int t = lane & 3;
  const int n16 = FULL ? kTile / 16 : (min(kTile, L - q0) + 15) / 16;  // slabs holding a query
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    if (!FULL && kk >= n16) break;
    float p[2][4], ds[2][4];  // rows: the warp's keys; columns: queries 16 kk + 8 c ..
    zero_acc(p);
    zero_acc(ds);
#pragma unroll
    for (int dd = 0; dd < DP / 16; ++dd) {
      uint32_t b0[2], b1[2];
      load_b_x4(b0, b1, Qs, LD, kk * 16, dd * 16, lane);
      mma<T>(p[0], kf[dd], b0);
      mma<T>(p[1], kf[dd], b1);
      load_b_x4(b0, b1, dOs, LD, kk * 16, dd * 16, lane);
      mma<T>(ds[0], vf[dd], b0);
      mma<T>(ds[1], vf[dd], b1);
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int qi = kk * 16 + c * 8 + 2 * t;  // this thread's columns qi, qi + 1
      const float2 mq = *reinterpret_cast<const float2*>(ms + qi);
      const float2 ilq = *reinterpret_cast<const float2*>(ms + kTile + qi);
      const float2 diq = *reinterpret_cast<const float2*>(ms + 2 * kTile + qi);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e & 1;
        const bool ok = FULL || (key0 + (lane >> 2) + 8 * (e >> 1) < L && q0 + qi + hi < L);
        p_ds(p[c][e], ds[c][e], ok, hi ? mq.y : mq.x, hi ? ilq.y : ilq.x, hi ? diq.y : diq.x,
             scale);
      }
    }
    uint32_t pa[4], da[4];  // p^T and ds^T at do's type: A operands over the slab
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      pa[2 * c] = pack<T>(p[c][0], p[c][1]);
      pa[2 * c + 1] = pack<T>(p[c][2], p[c][3]);
      da[2 * c] = pack<T>(ds[c][0], ds[c][1]);
      da[2 * c + 1] = pack<T>(ds[c][2], ds[c][3]);
    }
#pragma unroll
    for (int jd = 0; jd < DP / 8; jd += 2) {
      uint32_t b0[2], b1[2];
      load_b_trans_x4(b0, b1, dOs, LD, kk * 16, jd * 8, lane);  // dv += p^T do
      mma<T>(dv_acc[jd], pa, b0);
      mma<T>(dv_acc[jd + 1], pa, b1);
      load_b_trans_x4(b0, b1, Qs, LD, kk * 16, jd * 8, lane);  // dk += ds^T q
      mma<T>(dk_acc[jd], da, b0);
      mma<T>(dk_acc[jd + 1], da, b1);
    }
  }
}

// The tensor-core dK/dV. Block x of the 1-D grid takes k tile x % n_tiles of
// (image x head) x / n_tiles, so the k tiles of one head run side by side and
// read its q and do from L2 after the first. 4 warps, warp w owning keys
// 16 w .. 16 w + 15 of the tile (a warp whose 16 keys all lie past L only
// helps stage), their k and v rows held as A operands in registers for the
// whole run. The q side streams in 64-row tiles (dkv_tile): q and do
// double-buffered with cp.async, the rows' m, 1 / l and di loaded into
// registers one tile ahead and stored to shared memory after the tile's
// products, behind one barrier a tile.
template <typename T, int DP>
__global__ void __launch_bounds__(kMmaThreads, DP <= 64 ? 3 : 2)
flash_attention_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ dout,
                               const float* __restrict__ m_in, const float* __restrict__ l_in,
                               const float* __restrict__ di_in, T* __restrict__ dk,
                               T* __restrict__ dv, int L, int h, int d, int64_t s_b, int64_t s_l,
                               int64_t s_h, float scale, int n_tiles) {
  constexpr int LD = DP + 8;
  constexpr int TILE = kTile * LD;
  constexpr int KD = DP / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* QDs = reinterpret_cast<T*>(smem_raw);  // [2 buffers][q, do][64, LD]; k, v first in buffer 1
  float* stats = reinterpret_cast<float*>(QDs + 4 * TILE);  // [2 buffers][m, 1 / l, di][64]

  const int bh = blockIdx.x / n_tiles;
  const int k0 = (blockIdx.x - bh * n_tiles) * kTile;
  const int b = bh / h;
  const int head = bh - b * h;
  const int64_t base = (int64_t)b * s_b + (int64_t)head * s_h;
  const int64_t do_base = (int64_t)b * L * h * d + (int64_t)head * d;  // do is contiguous
  const int64_t do_stride = (int64_t)h * d;
  const float* m_row = m_in + (int64_t)bh * L;
  const float* l_row = l_in + (int64_t)bh * L;
  const float* di_row = di_in + (int64_t)bh * L;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int key0 = k0 + warp * 16;  // the warp's first key
  const bool active = key0 < L;
  const int nq = (L + kTile - 1) / kTile;

  stage_rows_async<T, DP, kTile, kMmaThreads>(QDs + 2 * TILE, k + base, s_l, k0, L, d);
  stage_rows_async<T, DP, kTile, kMmaThreads>(QDs + 3 * TILE, v + base, s_l, k0, L, d);
  cp_async_commit();
  stage_rows_async<T, DP, kTile, kMmaThreads>(QDs, q + base, s_l, 0, L, d);
  stage_rows_async<T, DP, kTile, kMmaThreads>(QDs + TILE, dout + do_base, do_stride, 0, L, d);
  cp_async_commit();
  if (threadIdx.x < kTile) {  // q tile 0's row statistics (0, 1, 0 past L)
    const int i = threadIdx.x;
    stats[i] = i < L ? m_row[i] : 0.f;
    stats[kTile + i] = i < L ? 1.f / l_row[i] : 1.f;
    stats[2 * kTile + i] = i < L ? di_row[i] : 0.f;
  }
  cp_async_wait<1>();  // k and v have landed
  __syncthreads();
  uint32_t kf[KD][4], vf[KD][4];  // the warp's keys: A operands of s^T = k q^T and dp^T = v do^T
  if (active) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      load_a(kf[kk], QDs + 2 * TILE, LD, warp * 16, kk * 16, lane);
      load_a(vf[kk], QDs + 3 * TILE, LD, warp * 16, kk * 16, lane);
    }
  }

  float dk_acc[DP / 8][4], dv_acc[DP / 8][4];  // keys key0 + lane / 4 (+ 8)
  zero_acc(dk_acc);
  zero_acc(dv_acc);
  for (int it = 0; it < nq; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it has landed, and every read of the other buffer is done
    const int q0 = it * kTile;
    float nm = 0.f, nil = 1.f, ndi = 0.f;  // the next tile's statistics, row q0 + 64 + threadIdx.x
    if (it + 1 < nq) {
      T* nxt = QDs + ((it + 1) & 1) * 2 * TILE;
      stage_rows_async<T, DP, kTile, kMmaThreads>(nxt, q + base, s_l, q0 + kTile, L, d);
      stage_rows_async<T, DP, kTile, kMmaThreads>(nxt + TILE, dout + do_base, do_stride,
                                                  q0 + kTile, L, d);
      cp_async_commit();
      const int i = q0 + kTile + threadIdx.x;
      if (threadIdx.x < kTile && i < L) {
        nm = m_row[i];
        nil = 1.f / l_row[i];
        ndi = di_row[i];
      }
    }
    if (active) {
      const T* Qs = QDs + (it & 1) * 2 * TILE;
      const float* ms = stats + (it & 1) * 3 * kTile;
      if (q0 + kTile <= L && key0 + 16 <= L)
        dkv_tile<T, DP, true>(dk_acc, dv_acc, kf, vf, Qs, Qs + TILE, ms, q0, key0, L, scale, lane);
      else
        dkv_tile<T, DP, false>(dk_acc, dv_acc, kf, vf, Qs, Qs + TILE, ms, q0, key0, L, scale,
                               lane);
    }
    if (it + 1 < nq && threadIdx.x < kTile) {  // read at tile it + 1, after its barrier
      float* nxt = stats + ((it + 1) & 1) * 3 * kTile;
      nxt[threadIdx.x] = nm;
      nxt[kTile + threadIdx.x] = nil;
      nxt[2 * kTile + threadIdx.x] = ndi;
    }
  }
  if (!active) return;
  store_rows_mma<T, DP>(dk, dk_acc, b, head, key0, L, h, d, lane);
  store_rows_mma<T, DP>(dv, dv_acc, b, head, key0, L, h, d, lane);
}

// Shared memory of the tensor-core dK/dV: two buffers of q and do tiles and
// two of the q rows' m, 1 / l, di.
inline size_t dkv_mma_smem(int dp) { return mma_smem_bytes(4, dp, 6 * kTile); }

// Warps of a tensor-core dQ block: its q tile has 16 kDqWarps rows, and each
// k tile is taken in slabs of kDqSlab keys.
constexpr int kDqWarps = 8;
constexpr int kDqRows = 16 * kDqWarps;
constexpr int kDqSlab = 32;

// One k tile of dQ for one warp's 16 q rows (q and do rows as A operands qa,
// da; the rows' m, 1 / l and di in registers), in slabs of kDqSlab keys, those
// that hold a key only: s = q k^T and dp = do v^T over the slab's 8-key chunks
// that hold a key, p and ds from them, then dq += (ds at k's type) k over its
// 16-key steps that hold a key, so that s and dp live in 2 kDqSlab / 8
// registers a thread, not 16. FULL: all 64 keys lie before L, so nothing is
// skipped or masked and the code has no branch. Rows past L need no mask:
// their q and do are zeros, so their ds is 0, and their dq is not stored.
template <typename T, int DP, bool FULL>
__device__ __forceinline__ void dq_tile(float (&dq_acc)[DP / 8][4], const uint32_t (&qa)[DP / 16][4],
                                        const uint32_t (&da)[DP / 16][4], const T* Ks,
                                        const T* Vs, const float (&m)[2], const float (&inv_l)[2],
                                        const float (&di)[2], int k0, int L, float scale,
                                        int lane) {
  constexpr int LD = DP + 8;
  constexpr int SC = kDqSlab / 8;  // 8-key chunks a slab
  const int t = lane & 3;
  const int nc = FULL ? kChunks : min(kChunks, (L - k0 + 7) / 8);  // chunks that hold a key
#pragma unroll
  for (int sl = 0; sl < kTile / kDqSlab; ++sl) {
    if (!FULL && sl * SC >= nc) break;
    float s[SC][4], dp[SC][4];  // rows: the warp's queries; columns: the slab's keys
    zero_acc(s);
    zero_acc(dp);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < SC; j += 2) {
        const int jc = sl * SC + j;  // the chunk's index in the tile
        if (FULL || jc < nc) {
          uint32_t b0[2], b1[2];
          load_b_x4(b0, b1, Ks, LD, jc * 8, kk * 16, lane);
          mma<T>(s[j], qa[kk], b0);
          if (FULL || jc + 1 < nc) mma<T>(s[j + 1], qa[kk], b1);
          load_b_x4(b0, b1, Vs, LD, jc * 8, kk * 16, lane);
          mma<T>(dp[j], da[kk], b0);
          if (FULL || jc + 1 < nc) mma<T>(dp[j + 1], da[kk], b1);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < SC; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = FULL || k0 + (sl * SC + j) * 8 + 2 * t + (e & 1) < L;  // 0 past L
        p_ds(s[j][e], dp[j][e], ok, m[e >> 1], inv_l[e >> 1], di[e >> 1], scale);
      }
    }
#pragma unroll
    for (int kk = 0; kk < SC / 2; ++kk) {
      const int ks = sl * SC / 2 + kk;  // the 16-key step's index in the tile
      if (FULL || 2 * ks < nc) {
        uint32_t a[4];
        acc_to_a<T>(a, dp, kk);
#pragma unroll
        for (int jd = 0; jd < DP / 8; jd += 2) {
          uint32_t b0[2], b1[2];
          load_b_trans_x4(b0, b1, Ks, LD, ks * 16, jd * 8, lane);
          mma<T>(dq_acc[jd], a, b0);
          mma<T>(dq_acc[jd + 1], a, b1);
        }
      }
    }
  }
}

// The tensor-core dQ, the forward's skeleton with dQ's products. Block x of
// the 1-D grid takes q tile x % n_tiles of (image x head) x / n_tiles, so the
// q tiles of one head run side by side and read its k and v from L2 after
// the first. kDqWarps warps, warp w owning q rows 16 w .. 16 w + 15 of the
// tile (a warp whose rows all lie past L only helps stage); its q and do rows
// are read once from shared memory into A operands and its rows' m, 1 / l
// and di into registers, for the whole run. k and v tiles are
// double-buffered with cp.async, so tile it + 1 is in flight while tile it
// is multiplied (dq_tile), behind one barrier a tile.
template <typename T, int DP>
__global__ void __launch_bounds__(32 * kDqWarps, (DP <= 64 ? 16 : 8) / kDqWarps)
flash_attention_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ dout,
                              const float* __restrict__ m_in, const float* __restrict__ l_in,
                              const float* __restrict__ di_in, T* __restrict__ dq, int L, int h,
                              int d, int64_t s_b, int64_t s_l, int64_t s_h, float scale,
                              int n_tiles) {
  constexpr int LD = DP + 8;
  constexpr int TILE = kTile * LD;
  constexpr int THREADS = 32 * kDqWarps;
  constexpr int KD = DP / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [kDqRows, LD]
  T* dOs = Qs + kDqRows * LD;              // [kDqRows, LD]
  T* KVs = dOs + kDqRows * LD;             // [2 buffers][k, v][64, LD]

  const int bh = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x - bh * n_tiles) * kDqRows;
  const int b = bh / h;
  const int head = bh - b * h;
  const int64_t base = (int64_t)b * s_b + (int64_t)head * s_h;
  const int64_t do_base = (int64_t)b * L * h * d + (int64_t)head * d;  // do is contiguous
  const int64_t row_base = (int64_t)bh * L;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = q0 + warp * 16;  // the warp's first q row
  const bool active = row0 < L;
  const int nk = (L + kTile - 1) / kTile;

  stage_rows_async<T, DP, kDqRows, THREADS>(Qs, q + base, s_l, q0, L, d);
  stage_rows_async<T, DP, kDqRows, THREADS>(dOs, dout + do_base, (int64_t)h * d, q0, L, d);
  stage_rows_async<T, DP, kTile, THREADS>(KVs, k + base, s_l, 0, L, d);
  stage_rows_async<T, DP, kTile, THREADS>(KVs + TILE, v + base, s_l, 0, L, d);
  cp_async_commit();
  float m[2], inv_l[2], di[2];  // this thread's rows row0 + lane / 4 (+ 8): 0, 1, 0 past L
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + (lane >> 2) + 8 * r;
    m[r] = i < L ? m_in[row_base + i] : 0.f;
    inv_l[r] = i < L ? 1.f / l_in[row_base + i] : 1.f;
    di[r] = i < L ? di_in[row_base + i] : 0.f;
  }

  uint32_t qa[KD][4], da[KD][4];  // the warp's q and do rows: A operands of q k^T and do v^T
  float dq_acc[DP / 8][4];
  zero_acc(dq_acc);
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
      for (int kk = 0; kk < KD; ++kk) {
        load_a(qa[kk], Qs, LD, warp * 16, kk * 16, lane);
        load_a(da[kk], dOs, LD, warp * 16, kk * 16, lane);
      }
    }
    const T* Ks = KVs + (it & 1) * 2 * TILE;
    if (k0 + kTile <= L)
      dq_tile<T, DP, true>(dq_acc, qa, da, Ks, Ks + TILE, m, inv_l, di, k0, L, scale, lane);
    else
      dq_tile<T, DP, false>(dq_acc, qa, da, Ks, Ks + TILE, m, inv_l, di, k0, L, scale, lane);
  }
  if (!active) return;
  store_rows_mma<T, DP>(dq, dq_acc, b, head, row0, L, h, d, lane);
}

// Shared memory of the tensor-core dQ: the q and do tiles and two buffers of
// k and v tiles.
inline size_t dq_mma_smem(int dp) {
  return mma_smem_bytes(4, dp, 0) + (size_t)2 * kDqRows * (dp + 8) * 2;
}

enum class Which { kDkv, kDq };

template <Which W, typename T, int RD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, const float* m,
                   const float* l, const float* di, void* g0, void* g1, int n, int L, int h, int d,
                   int64_t s_b, int64_t s_l, int64_t s_h, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(4, RD, 0);
  const dim3 grid((unsigned)((int64_t)n * h), (unsigned)((L + kTile - 1) / kTile));
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  if constexpr (W == Which::kDkv) {
    auto kernel = flash_attention_dkv_kernel<T, RD>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(qt, kt, vt, dot, m, l, di, static_cast<T*>(g0),
                                             static_cast<T*>(g1), L, h, d, s_b, s_l, s_h, scale);
  } else {
    auto kernel = flash_attention_dq_kernel<T, RD>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(qt, kt, vt, dot, m, l, di, static_cast<T*>(g0), L, h,
                                             d, s_b, s_l, s_h, scale);
  }
  return cudaGetLastError();
}

template <Which W, typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, const void* dout,
                     const float* m, const float* l, const float* di, void* g0, void* g1, int n,
                     int L, int h, int d, int64_t s_b, int64_t s_l, int64_t s_h, float scale,
                     cudaStream_t st) {
  switch (cols_per_thread(d)) {
    case 2: return launch<W, T, 2>(q, k, v, dout, m, l, di, g0, g1, n, L, h, d, s_b, s_l, s_h, scale, st);
    case 4: return launch<W, T, 4>(q, k, v, dout, m, l, di, g0, g1, n, L, h, d, s_b, s_l, s_h, scale, st);
    case 6: return launch<W, T, 6>(q, k, v, dout, m, l, di, g0, g1, n, L, h, d, s_b, s_l, s_h, scale, st);
    case 8: return launch<W, T, 8>(q, k, v, dout, m, l, di, g0, g1, n, L, h, d, s_b, s_l, s_h, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <Which W, typename T, int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* dout,
                       const float* m, const float* l, const float* di, void* g0, void* g1, int n,
                       int L, int h, int d, int64_t s_b, int64_t s_l, int64_t s_h, float scale,
                       cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  if constexpr (W == Which::kDkv) {
    const size_t smem = dkv_mma_smem(DP);
    auto kernel = flash_attention_dkv_mma_kernel<T, DP>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)linear_blocks(n, L, h), kMmaThreads, smem, stream>>>(
        qt, kt, vt, dot, m, l, di, static_cast<T*>(g0), static_cast<T*>(g1), L, h, d, s_b, s_l,
        s_h, scale, (L + kTile - 1) / kTile);
  } else {
    const size_t smem = dq_mma_smem(DP);
    auto kernel = flash_attention_dq_mma_kernel<T, DP>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)linear_blocks(n, L, h, kDqRows), 32 * kDqWarps, smem, stream>>>(
        qt, kt, vt, dot, m, l, di, static_cast<T*>(g0), L, h, d, s_b, s_l, s_h, scale,
        (L + kDqRows - 1) / kDqRows);
  }
  return cudaGetLastError();
}

template <Which W, typename T>
cudaError_t launch_mma_t(const void* q, const void* k, const void* v, const void* dout,
                         const float* m, const float* l, const float* di, void* g0, void* g1,
                         int n, int L, int h, int d, int64_t s_b, int64_t s_l, int64_t s_h,
                         float scale, cudaStream_t st) {
  switch (mma_head_dim(d)) {
    case 32: return launch_mma<W, T, 32>(q, k, v, dout, m, l, di, g0, g1, n, L, h, d, s_b, s_l, s_h, scale, st);
    case 64: return launch_mma<W, T, 64>(q, k, v, dout, m, l, di, g0, g1, n, L, h, d, s_b, s_l, s_h, scale, st);
    case 96: return launch_mma<W, T, 96>(q, k, v, dout, m, l, di, g0, g1, n, L, h, d, s_b, s_l, s_h, scale, st);
    case 128: return launch_mma<W, T, 128>(q, k, v, dout, m, l, di, g0, g1, n, L, h, d, s_b, s_l, s_h, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <Which W, typename T, int DP>
cudaError_t mma_resources_dp(int* out) {
  if constexpr (W == Which::kDkv)
    return kernel_resources(flash_attention_dkv_mma_kernel<T, DP>, kMmaThreads, dkv_mma_smem(DP),
                            out);
  else
    return kernel_resources(flash_attention_dq_mma_kernel<T, DP>, 32 * kDqWarps, dq_mma_smem(DP),
                            out);
}

template <Which W, typename T>
cudaError_t mma_resources(int d, int* out) {
  switch (mma_head_dim(d)) {
    case 32: return mma_resources_dp<W, T, 32>(out);
    case 64: return mma_resources_dp<W, T, 64>(out);
    case 96: return mma_resources_dp<W, T, 96>(out);
    case 128: return mma_resources_dp<W, T, 128>(out);
    default: return cudaErrorInvalidValue;
  }
}

template <Which W>
int launch_any(const void* q, const void* k, const void* v, const void* dout, const void* m,
               const void* l, const void* di, void* g0, void* g1, int n, int L, int h, int d,
               long long s_b, long long s_l, long long s_h, float scale, int dtype, int device,
               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || L <= 0 || h <= 0 || cols_per_thread(d) == 0 || (L + kTile - 1) / kTile > 65535 ||
      linear_blocks(n, L, h) == 0)
    return (int)cudaErrorInvalidValue;
  const float* m32 = static_cast<const float*>(m);
  const float* l32 = static_cast<const float*>(l);
  const float* di32 = static_cast<const float*>(di);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_t<W, float>(q, k, v, dout, m32, l32, di32, g0, g1, n, L, h, d, s_b, s_l,
                                     s_h, scale, st);
    case 1:
      return (int)launch_mma_t<W, __nv_bfloat16>(q, k, v, dout, m32, l32, di32, g0, g1, n, L, h,
                                                 d, s_b, s_l, s_h, scale, st);
    case 2:
      return (int)launch_mma_t<W, __half>(q, k, v, dout, m32, l32, di32, g0, g1, n, L, h, d, s_b,
                                          s_l, s_h, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. q, k, v [n, L, h, d] at `dtype`
// with element strides s_b, s_l, s_h (shared by the three; last dim
// contiguous); dout, dk, dv, dq [n, L, h, d] contiguous at `dtype`; m, l, di
// [n, h, L] float32 (the forward's row max and sum, and sum_d o * do); all
// on `device`. d <= 128, d % 8 == 0. Each launches one kernel on `stream`
// and returns cudaGetLastError() after the launch.
extern "C" int passl_flash_attention_dkv(const void* q, const void* k, const void* v,
                                         const void* dout, const void* m, const void* l,
                                         const void* di, void* dk, void* dv, int n, int L, int h,
                                         int d, long long s_b, long long s_l, long long s_h,
                                         float scale, int dtype, int device, void* stream) {
  return launch_any<Which::kDkv>(q, k, v, dout, m, l, di, dk, dv, n, L, h, d, s_b, s_l, s_h,
                                 scale, dtype, device, stream);
}

extern "C" int passl_flash_attention_dq(const void* q, const void* k, const void* v,
                                        const void* dout, const void* m, const void* l,
                                        const void* di, void* dq, int n, int L, int h, int d,
                                        long long s_b, long long s_l, long long s_h, float scale,
                                        int dtype, int device, void* stream) {
  return launch_any<Which::kDq>(q, k, v, dout, m, l, di, dq, nullptr, n, L, h, d, s_b, s_l, s_h,
                                scale, dtype, device, stream);
}

// The tensor-core dK/dV (which 0) or dQ (which 1) kernel's resources at
// `dtype` (1 bfloat16, 2 float16) and head dim d on `device`: registers a
// thread, shared memory a block, blocks an SM, spilled bytes a thread and
// warps a block, into out[0..4].
extern "C" int passl_flash_attention_bwd_resources(int which, int dtype, int d, int device,
                                                   int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (which != 0 && which != 1) return (int)cudaErrorInvalidValue;
  const bool dkv = which == 0;
  switch (dtype) {
    case 1:
      return (int)(dkv ? mma_resources<Which::kDkv, __nv_bfloat16>(d, out)
                       : mma_resources<Which::kDq, __nv_bfloat16>(d, out));
    case 2:
      return (int)(dkv ? mma_resources<Which::kDkv, __half>(d, out)
                       : mma_resources<Which::kDq, __half>(d, out));
    default: return (int)cudaErrorInvalidValue;
  }
}
