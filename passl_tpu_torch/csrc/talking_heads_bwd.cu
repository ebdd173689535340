// Talking-heads softmax backward for Hopper (sm_90a): the gradient of
// CaiT's p[g] = sum_i ww[i, g] * softmax_k( sum_j wl[j, i] * s[j] ).
//
// Replaces passl_tpu/ops/pallas/talking_heads.py::_bwd_kernel. Given the
// scores s and the incoming gradient dp (both [n, h, q, k]) it recomputes
// the forward's p_mid from s and computes, in f32,
//
//     dp_mid[i] = sum_g ww[i, g] * dp[g]
//     ds_mid[g] = p_mid[g] * (dp_mid[g] - sum_k dp_mid[g] * p_mid[g])
//     ds[j]     = sum_g wl[j, g] * ds_mid[g]                (stored at s's type)
//     dwl[i, g] = sum over (n, q, k) of s[i] * ds_mid[g]
//     dww[i, g] = sum over (n, q, k) of p_mid[i] * dp[g]
//
// Only s is kept from the forward, as in the JAX package's custom VJP.
//
// Bound: device-memory bytes. It must read s and dp once and write ds once,
// 3 * n * h * q * k * sizeof(T) bytes (118 MB for CaiT-S24's
// [64, 8, 196, 196] in bf16: 35 us at 3.35 TB/s). The per-column work is
// 5 h^2 f32 multiply-adds (three h-wide mixes and the two h x h outer
// products): 787 M at that shape, 23.5 us on the CUDA cores alone, so the
// kernel can reach its bound only by overlapping arithmetic and loads.
//
// Two kernels; the C entry point picks one by shape and type:
//
// talking_heads_bwd_row_kernel (bf16 / f16, h <= 8, k <= 256: CaiT at 224):
//   one warp owns a row (n, q) at a time, lane l the columns l + 32 c, with
//   no block barrier on the row path. The warp stages the row's s and dp in
//   its own shared-memory tiles (all 2 h C loads of a lane in flight at
//   once; the other warps of the SM compute meanwhile), then mixes heads on
//   the CUDA cores with each weight, read from shared memory, feeding the
//   C columns of the lane; max, sum and the dp_mid . p_mid dot are xor
//   shuffles (every lane gets the same bits). The weight gradients are off
//   the CUDA cores: dwl = S . DS_mid^T and dww^T = DP . P_mid^T are
//   mma.sync.m16n8k16 products over the row's columns (heads as M, padded
//   to 16, and as N), from the tiles, accumulated in registers over all the
//   warp's rows. s and dp are exact at their type; the f32 p_mid and ds_mid
//   go in as hi + lo (lo = (x - hi) * 2^11, its own accumulator scaled back
//   at the end), which keeps about 2^-19 of each term and leaves f16 no
//   underflow. Each warp writes its partials once.
// talking_heads_bwd_kernel (f32, h = 16, k > 256): a fixed grid of blocks,
//   each taking a run of consecutive rows; per row, threads run across k
//   as in the forward (h scores per column in registers; max, sum and the
//   dot as block reductions), p_mid and ds_mid of the row go to shared
//   memory, each warp takes one head row of s (a row of dwl) or of dp (a
//   column of dww) and adds its h sums into the block's accumulators.
//
// The TPU kernel summed dwl and dww as SMEM scalars across its sequential
// grid; a CUDA grid runs in no order, so both kernels sum in two stages,
// each in a fixed order and with no atomics, which makes the weight
// gradients bitwise the same on every launch: fixed partials (a warp's or a
// block's, over a fixed set of rows), then talking_heads_wgrad_reduce sums
// the partials of each of the 2 h^2 outputs in order.

#include "talking_heads.cuh"
#include "tensor_core.cuh"

namespace {

using namespace passl_th;

constexpr int kRowsPerBlockTarget = 1024;  // G = ceil(rows / ceil(rows / 1024)) blocks
constexpr int kReduceWarps = 32;           // stage 2: warps splitting the G partials

template <typename T, int H, int C>
__global__ void __launch_bounds__(kMaxThreads)
talking_heads_bwd_kernel(const T* __restrict__ s, const T* __restrict__ dp,
                         const float* __restrict__ proj_l, const float* __restrict__ proj_w,
                         T* __restrict__ ds, float* __restrict__ partials, int q_len, int k_len,
                         int64_t rows, int rows_per_block) {
  __shared__ float wl[H * H];
  __shared__ float ww[H * H];
  __shared__ float acc[2 * H * H];  // this block's dwl (first h^2) and dww sums
  __shared__ float red_max[H * kMaxWarps];
  __shared__ float red_sum[H * kMaxWarps];
  __shared__ float red_dot[H * kMaxWarps];
  extern __shared__ float dyn[];    // p_mid [H][k_len], then dp_mid / ds_mid [H][k_len]
  float* pm = dyn;
  float* dsm = dyn + (size_t)H * k_len;

  for (int i = threadIdx.x; i < H * H; i += blockDim.x) {
    wl[i] = proj_l[i];
    ww[i] = proj_w[i];
  }
  for (int i = threadIdx.x; i < 2 * H * H; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int64_t head_stride = (int64_t)q_len * k_len;
  const int64_t row0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t row_end = row0 + rows_per_block < rows ? row0 + rows_per_block : rows;

  for (int64_t row = row0; row < row_end; ++row) {
    const int64_t n = row / q_len;
    const int64_t qi = row - n * q_len;
    const int64_t base = n * H * head_stride + qi * k_len;

    // recompute the forward: mix 1 in registers, row max, exp, row sum
    float mixed[C][H];
    float row_max[H];
#pragma unroll
    for (int g = 0; g < H; ++g) row_max[g] = -INFINITY;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = threadIdx.x + c * blockDim.x;
      const bool valid = col < k_len;
      float x[H];
#pragma unroll
      for (int i = 0; i < H; ++i) x[i] = valid ? to_f32(s[base + i * head_stride + col]) : 0.f;
#pragma unroll
      for (int g = 0; g < H; ++g) {
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < H; ++i) a = fmaf(x[i], wl[i * H + g], a);
        mixed[c][g] = valid ? a : -INFINITY;
        row_max[g] = fmaxf(row_max[g], mixed[c][g]);
      }
    }
    block_reduce<H, true>(row_max, red_max);

    float row_sum[H];
#pragma unroll
    for (int g = 0; g < H; ++g) row_sum[g] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int g = 0; g < H; ++g) {
        mixed[c][g] = expf(mixed[c][g] - row_max[g]);  // masked columns: exp(-inf) = 0
        row_sum[g] += mixed[c][g];
      }
    }
    block_reduce<H, false>(row_sum, red_sum);

    // p_mid to registers and shared memory; dp_mid = ww-mix of dp; the dot
    float dot[H];
#pragma unroll
    for (int g = 0; g < H; ++g) dot[g] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = threadIdx.x + c * blockDim.x;
      if (col >= k_len) continue;
      float d[H];
#pragma unroll
      for (int g = 0; g < H; ++g) {
        mixed[c][g] = mixed[c][g] / row_sum[g];
        pm[g * k_len + col] = mixed[c][g];
        d[g] = to_f32(dp[base + g * head_stride + col]);
      }
#pragma unroll
      for (int i = 0; i < H; ++i) {
        float m = 0.f;
#pragma unroll
        for (int g = 0; g < H; ++g) m = fmaf(ww[i * H + g], d[g], m);
        dsm[i * k_len + col] = m;  // dp_mid for now; each thread owns its columns
        dot[i] = fmaf(m, mixed[c][i], dot[i]);
      }
    }
    block_reduce<H, false>(dot, red_dot);

    // ds_mid in place of dp_mid; ds = wl-mix of ds_mid, stored once
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = threadIdx.x + c * blockDim.x;
      if (col >= k_len) continue;
      float dm[H];
#pragma unroll
      for (int g = 0; g < H; ++g) {
        dm[g] = mixed[c][g] * (dsm[g * k_len + col] - dot[g]);
        dsm[g * k_len + col] = dm[g];
      }
#pragma unroll
      for (int j = 0; j < H; ++j) {
        float v = 0.f;
#pragma unroll
        for (int g = 0; g < H; ++g) v = fmaf(wl[j * H + g], dm[g], v);
        ds[base + j * head_stride + col] = from_f32<T>(v);
      }
    }
    __syncthreads();  // pm and dsm of the row are complete

    // weight gradients of the row. Task t = (matrix, j) reads one head row
    // of s or dp from device memory (L1-hot) once and the shared-memory rows
    // against it: m = 0 gives row j of dwl (s[j] against ds_mid[g], all g),
    // m = 1 column j of dww (dp[j] against p_mid[i], all i). Warp w owns
    // tasks w, w + nwarps, ..., so every sum has one fixed owner
    for (int t = warp; t < 2 * H; t += nwarps) {
      const int m = t / H;
      const int j = t - m * H;
      const T* src = (m == 0 ? s : dp) + base + j * head_stride;
      const float* against = m == 0 ? dsm : pm;
      float part[H];
#pragma unroll
      for (int r = 0; r < H; ++r) part[r] = 0.f;
      for (int col = lane; col < k_len; col += 32) {
        const float a = to_f32(src[col]);
#pragma unroll
        for (int r = 0; r < H; ++r) part[r] = fmaf(a, against[r * k_len + col], part[r]);
      }
#pragma unroll
      for (int r = 0; r < H; ++r) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) part[r] += __shfl_xor_sync(0xffffffffu, part[r], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < H; ++r) {
          // dwl[j][r] = sum s[j] ds_mid[r]; dww[r][j] = sum p_mid[r] dp[j]
          acc[m == 0 ? j * H + r : H * H + r * H + j] += part[r];
        }
      }
    }
    __syncthreads();  // the next row overwrites pm and dsm; red_* reads are done
  }

  float* out = partials + (int64_t)blockIdx.x * 2 * H * H;
  for (int i = threadIdx.x; i < 2 * H * H; i += blockDim.x) out[i] = acc[i];
}

// dwl and dww from the G per-block partials: block b of 32 lanes x 32 warps
// covers outputs [32 b, 32 b + 32); warp w sums partials w, w + 32, ... in
// order, then warp 0 sums the 32 warp results in order.
__global__ void __launch_bounds__(32 * kReduceWarps)
talking_heads_wgrad_reduce(const float* __restrict__ partials, int num_partials, int hh,
                           float* __restrict__ dwl, float* __restrict__ dww) {
  __shared__ float red[kReduceWarps][33];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int o = blockIdx.x * 32 + lane;
  const int outputs = 2 * hh;
  float v = 0.f;
  if (o < outputs) {
    for (int b = warp; b < num_partials; b += kReduceWarps) v += partials[(int64_t)b * outputs + o];
  }
  red[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && o < outputs) {
    float r = red[0][lane];
    for (int w = 1; w < kReduceWarps; ++w) r += red[w][lane];
    if (o < hh) dwl[o] = r; else dww[o - hh] = r;
  }
}

// ---------------------------------------------------------------- warp-row kernel

constexpr int kRowWarps = 4;         // warps of a block of the warp-row kernel
constexpr int kRowBlocksPerSm = 3;   // its launch bound: 168 registers a thread
// The grid's warps, and so its partials: one wave on an H100 (132 SMs x 3
// blocks x 4 warps), fixed so that the row -> warp assignment, and with it
// every sum, is the same on every launch and every card
constexpr int kRowMaxWarps = 132 * kRowBlocksPerSm * kRowWarps;
constexpr int kRowMaxK = 256;        // k <= 32 C with C <= 8 columns a lane
constexpr int kRowMaxHeads = 8;      // the tiles' 8 rows are the products' M (and N) rows 0-7
constexpr float kLoScale = 2048.f;   // lo = (x - hi) * 2^11

// Columns a lane takes for k columns (1, 2, 4, 7 or 8), the template's C.
int row_cols(int k) {
  const int c = (k + 31) / 32;
  return c <= 2 ? c : c <= 4 ? 4 : c <= 7 ? 7 : 8;
}

// Row stride of a warp's tiles, in elements: 32 C columns and 8 of padding,
// which puts the 8 rows a fragment load touches on distinct banks.
template <int C>
__host__ __device__ constexpr int row_ld() { return 32 * C + 8; }

// A block's tiles: per warp S and DP ([8][row_ld]) and XH and XL ([32 C][8]).
template <int C>
constexpr size_t row_smem(size_t elem) {
  return (size_t)kRowWarps * 2 * 8 * (row_ld<C>() + 32 * C) * elem;
}

// A column's h values x at T as hi and (x - hi) * 2^11 as lo, each as 8
// entries (zero past h) in one 16-byte store into the [column][8] tiles:
// hi + lo / 2^11 keeps about 19 bits of x, and lo stays in T's normal range
// wherever x does.
template <typename T, int H>
__device__ __forceinline__ void split_store(T* hi, T* lo, const float (&x)[H]) {
  __align__(16) T h[8], l[8];
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    h[g] = from_f32<T>(g < H ? x[g] : 0.f);
    l[g] = from_f32<T>(g < H ? (x[g] - to_f32(h[g])) * kLoScale : 0.f);
  }
  *reinterpret_cast<uint4*>(hi) = *reinterpret_cast<const uint4*>(h);
  *reinterpret_cast<uint4*>(lo) = *reinterpret_cast<const uint4*>(l);
}

// The row's s and dp into the warp's [8][LD] tiles S and DP at columns
// lane + 32 c (zero past k): every load of the lane is issued before the
// first store, so the warp has 2 h C loads in flight.
template <typename T, int H, int C>
__device__ __forceinline__ void stage_row(T* S, T* DP, const T* __restrict__ s,
                                          const T* __restrict__ dp, int64_t hs, int k, int lane) {
  constexpr int LD = row_ld<C>();
  const T zero = from_f32<T>(0.f);
  T a[H][C], b[H][C];
#pragma unroll
  for (int i = 0; i < H; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = lane + 32 * c;
      a[i][c] = col < k ? s[i * hs + col] : zero;
      b[i][c] = col < k ? dp[i * hs + col] : zero;
    }
  }
#pragma unroll
  for (int i = 0; i < H; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      S[i * LD + lane + 32 * c] = a[i][c];
      DP[i * LD + lane + 32 * c] = b[i][c];
    }
  }
}

// hi += X . Yhi^T and lo += X . Ylo^T over columns [0, kp), as m16n8k16
// products: X ([8][LD], head-major) gives A's rows 0-7 (8-15 are zero), Yhi
// and Ylo ([column][8], column-major) B's columns, both B operands of a
// 16-column step in one ldmatrix.x4.trans (lanes 0-15 address Yhi's rows,
// 16-31 Ylo's). The accumulators: thread (g, t) holds entries (g, 2t),
// (g, 2t + 1) in [0], [1] ([2], [3] are the zero rows 8-15).
template <typename T, int LD>
__device__ __forceinline__ void outer_mma(float (&hi)[4], float (&lo)[4], const T* X, const T* Yhi,
                                          const T* Ylo, int kp, int lane) {
  using passl_tc::ld32;
  const int off = (lane >> 2) * LD + 2 * (lane & 3);
  const unsigned brow = static_cast<unsigned>(
      __cvta_generic_to_shared((lane < 16 ? Yhi : Ylo) + (lane & 15) * 8));
  for (int k0 = 0; k0 < kp; k0 += 16) {
    const uint32_t a[4] = {ld32(X + off + k0), 0u, ld32(X + off + k0 + 8), 0u};
    uint32_t bh[2], bl[2];
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(bh[0]), "=r"(bh[1]), "=r"(bl[0]), "=r"(bl[1])
                 : "r"(brow + k0 * 8 * (unsigned)sizeof(T)));
    passl_tc::mma<T>(hi, a, bh);
    passl_tc::mma<T>(lo, a, bl);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Every lane gets the same bits: at each step both lanes of a pair add the same two values.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int H, int C>
__global__ void __launch_bounds__(32 * kRowWarps, kRowBlocksPerSm)
talking_heads_bwd_row_kernel(const T* __restrict__ s, const T* __restrict__ dp,
                             const float* __restrict__ proj_l, const float* __restrict__ proj_w,
                             T* __restrict__ ds, float* __restrict__ partials, int q_len,
                             int k_len, int64_t rows) {
  constexpr int LD = row_ld<C>();
  constexpr int TILE = 8 * LD;  // S and DP: [8][LD], head-major
  constexpr int XTILE = 32 * C * 8;  // XH and XL: [32 C][8], column-major
  __shared__ __align__(16) float wl[H * H];
  __shared__ __align__(16) float wwt[H * H];  // proj_w transposed: wwt[g][i] = ww[i][g]
  extern __shared__ __align__(16) unsigned char row_tiles[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the warp's tiles: s, dp, and hi / lo of p_mid, then of ds_mid
  T* S = reinterpret_cast<T*>(row_tiles) + (size_t)warp * (2 * TILE + 2 * XTILE);
  T* DP = S + TILE;
  T* XH = DP + TILE;
  T* XL = XH + XTILE;
  for (int i = threadIdx.x; i < H * H; i += blockDim.x) {
    wl[i] = proj_l[i];
    wwt[(i % H) * H + i / H] = proj_w[i];
  }
  for (int i = lane; i < 2 * TILE; i += 32) S[i] = from_f32<T>(0.f);  // rows h..7 stay zero
  __syncthreads();

  const int64_t hs = (int64_t)q_len * k_len;
  const int kp = (k_len + 15) & ~15;  // the products' columns; the tiles are zero past k
  const int64_t stride = (int64_t)gridDim.x * kRowWarps;
  const int64_t first = (int64_t)blockIdx.x * kRowWarps + warp;
  float lh[4] = {0.f, 0.f, 0.f, 0.f}, ll[4] = {0.f, 0.f, 0.f, 0.f};  // dwl, hi and lo
  float wh[4] = {0.f, 0.f, 0.f, 0.f}, wo[4] = {0.f, 0.f, 0.f, 0.f};  // dww^T, hi and lo

  for (int64_t row = first; row < rows; row += stride) {
    const int64_t n = row / q_len;
    const int64_t base = n * H * hs + (row - n * q_len) * k_len;
    stage_row<T, H, C>(S, DP, s + base, dp + base, hs, k_len, lane);
    __syncwarp();

    // recompute the forward: p[c][g] = softmax_k(sum_i s[i] wl[i][g])
    float p[C][H];
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int g = 0; g < H; ++g) p[c][g] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < H; ++i) {
      float x[C];
#pragma unroll
      for (int c = 0; c < C; ++c) x[c] = to_f32(S[i * LD + lane + 32 * c]);
#pragma unroll
      for (int g = 0; g < H; ++g) {
        const float w = wl[i * H + g];
#pragma unroll
        for (int c = 0; c < C; ++c) p[c][g] = fmaf(x[c], w, p[c][g]);
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (lane + 32 * c >= k_len) {
#pragma unroll
        for (int g = 0; g < H; ++g) p[c][g] = -INFINITY;  // exp gives 0
      }
    }
#pragma unroll
    for (int g = 0; g < H; ++g) {
      float mx = p[0][g];
#pragma unroll
      for (int c = 1; c < C; ++c) mx = fmaxf(mx, p[c][g]);
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        p[c][g] = __expf(p[c][g] - mx);
        sum += p[c][g];
      }
      const float inv = 1.f / warp_sum(sum);
#pragma unroll
      for (int c = 0; c < C; ++c) p[c][g] *= inv;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int o = (lane + 32 * c) * 8;
      split_store<T, H>(XH + o, XL + o, p[c]);
    }
    __syncwarp();
    outer_mma<T, LD>(wh, wo, DP, XH, XL, kp, lane);  // dww^T += dp . p_mid^T

    // dp_mid[c][i] = sum_g ww[i][g] dp[g]; the dot; ds_mid in its place
    float d[C][H];
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int i = 0; i < H; ++i) d[c][i] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < H; ++g) {
      float x[C];
#pragma unroll
      for (int c = 0; c < C; ++c) x[c] = to_f32(DP[g * LD + lane + 32 * c]);
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float w = wwt[g * H + i];
#pragma unroll
        for (int c = 0; c < C; ++c) d[c][i] = fmaf(w, x[c], d[c][i]);
      }
    }
#pragma unroll
    for (int g = 0; g < H; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) dot = fmaf(d[c][g], p[c][g], dot);
      dot = warp_sum(dot);
#pragma unroll
      for (int c = 0; c < C; ++c) d[c][g] = p[c][g] * (d[c][g] - dot);
    }
    __syncwarp();  // every lane's fragment reads of p_mid are done
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int o = (lane + 32 * c) * 8;
      split_store<T, H>(XH + o, XL + o, d[c]);
    }
    __syncwarp();
    outer_mma<T, LD>(lh, ll, S, XH, XL, kp, lane);  // dwl += s . ds_mid^T

    // ds[j] = sum_g wl[j][g] ds_mid[g], stored once at T
#pragma unroll
    for (int j = 0; j < H; ++j) {
      float v[C];
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = 0.f;
#pragma unroll
      for (int g = 0; g < H; ++g) {
        const float w = wl[j * H + g];
#pragma unroll
        for (int c = 0; c < C; ++c) v[c] = fmaf(w, d[c][g], v[c]);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = lane + 32 * c;
        if (col < k_len) ds[base + j * hs + col] = from_f32<T>(v[c]);
      }
    }
    __syncwarp();  // the next row's staging overwrites the tiles
  }

  // this warp's partials: thread (r, t) holds dwl[r][2t + e] and dww[2t + e][r]
  float* out = partials + ((int64_t)blockIdx.x * kRowWarps + warp) * 2 * H * H;
  const int r = lane >> 2;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int g = 2 * (lane & 3) + e;
    if (r < H && g < H) {
      out[r * H + g] = lh[e] + ll[e] / kLoScale;
      out[H * H + g * H + r] = wh[e] + wo[e] / kLoScale;
    }
  }
}

// Warps (and partials) of the warp-row kernel's grid for `rows` rows.
int64_t row_warps(int64_t rows) {
  const int64_t w = rows < kRowMaxWarps ? rows : kRowMaxWarps;
  return (w + kRowWarps - 1) / kRowWarps * kRowWarps;
}

bool row_kernel_takes(int h, int k, int dtype) {
  return dtype != 0 && h <= kRowMaxHeads && k <= kRowMaxK;
}

template <typename T, int H, int C>
cudaError_t row_prepare(size_t* smem) {
  *smem = row_smem<C>(sizeof(T));
  return cudaFuncSetAttribute(talking_heads_bwd_row_kernel<T, H, C>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

template <typename T, int H, int C>
cudaError_t launch_row_c(const void* s, const void* dp, const float* wl, const float* ww, void* ds,
                         float* partials, int n, int q, int k, cudaStream_t stream) {
  const int64_t rows = (int64_t)n * q;
  size_t smem = 0;
  cudaError_t err = row_prepare<T, H, C>(&smem);
  if (err != cudaSuccess) return err;
  talking_heads_bwd_row_kernel<T, H, C><<<(unsigned)(row_warps(rows) / kRowWarps),
                                          32 * kRowWarps, smem, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(dp), wl, ww, static_cast<T*>(ds), partials,
      q, k, rows);
  return cudaGetLastError();
}

// registers a thread, shared memory a block, blocks an SM, spilled bytes a
// thread, warps a block
template <typename T, int H, int C>
cudaError_t row_resources_c(int* out) {
  size_t smem = 0;
  cudaError_t err = row_prepare<T, H, C>(&smem);
  if (err != cudaSuccess) return err;
  auto kernel = talking_heads_bwd_row_kernel<T, H, C>;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * kRowWarps, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)(smem + attr.sharedSizeBytes);
  out[2] = per_sm;
  out[3] = (int)attr.localSizeBytes;
  out[4] = kRowWarps;
  return cudaSuccess;
}

// One call per (T, H, C): launch the warp-row kernel, or read its resources when `out` is set.
template <typename T, int H, int C>
cudaError_t row_c(const void* s, const void* dp, const float* wl, const float* ww, void* ds,
                  float* partials, int n, int q, int k, cudaStream_t stream, int* out) {
  if (out) return row_resources_c<T, H, C>(out);
  return launch_row_c<T, H, C>(s, dp, wl, ww, ds, partials, n, q, k, stream);
}

template <typename T, int H>
cudaError_t row_h(const void* s, const void* dp, const float* wl, const float* ww, void* ds,
                  float* partials, int n, int q, int k, cudaStream_t stream, int* out) {
  switch (row_cols(k)) {
    case 1: return row_c<T, H, 1>(s, dp, wl, ww, ds, partials, n, q, k, stream, out);
    case 2: return row_c<T, H, 2>(s, dp, wl, ww, ds, partials, n, q, k, stream, out);
    case 4: return row_c<T, H, 4>(s, dp, wl, ww, ds, partials, n, q, k, stream, out);
    case 7: return row_c<T, H, 7>(s, dp, wl, ww, ds, partials, n, q, k, stream, out);
    case 8: return row_c<T, H, 8>(s, dp, wl, ww, ds, partials, n, q, k, stream, out);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t row_t(const void* s, const void* dp, const float* wl, const float* ww, void* ds,
                  float* partials, int n, int h, int q, int k, cudaStream_t stream, int* out) {
  switch (h) {
    case 4: return row_h<T, 4>(s, dp, wl, ww, ds, partials, n, q, k, stream, out);
    case 6: return row_h<T, 6>(s, dp, wl, ww, ds, partials, n, q, k, stream, out);
    case 8: return row_h<T, 8>(s, dp, wl, ww, ds, partials, n, q, k, stream, out);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t row_dispatch(const void* s, const void* dp, const float* wl, const float* ww, void* ds,
                         float* partials, int n, int h, int q, int k, int dtype,
                         cudaStream_t stream, int* out) {
  switch (dtype) {
    case 1: return row_t<__nv_bfloat16>(s, dp, wl, ww, ds, partials, n, h, q, k, stream, out);
    case 2: return row_t<__half>(s, dp, wl, ww, ds, partials, n, h, q, k, stream, out);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- block-row kernel's launch

int64_t rows_per_block(int64_t rows) {
  return (rows + kRowsPerBlockTarget - 1) / kRowsPerBlockTarget;
}

int64_t num_blocks(int64_t rows) {
  const int64_t rpb = rows_per_block(rows);
  return (rows + rpb - 1) / rpb;
}

template <typename T, int H, int C>
cudaError_t launch_c(const void* s, const void* dp, const float* wl, const float* ww, void* ds,
                     float* partials, int n, int q, int k, cudaStream_t stream) {
  const int64_t rows = (int64_t)n * q;
  const size_t smem = 2 * (size_t)H * k * sizeof(float);
  auto kernel = talking_heads_bwd_kernel<T, H, C>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)num_blocks(rows), threads_for(k, C), smem, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(dp), wl, ww, static_cast<T*>(ds), partials,
      q, k, rows, (int)rows_per_block(rows));
  return cudaGetLastError();
}

template <typename T, int H>
cudaError_t launch_h(const void* s, const void* dp, const float* wl, const float* ww, void* ds,
                     float* partials, int n, int q, int k, cudaStream_t stream) {
  switch (cols_per_thread(k)) {
    case 1: return launch_c<T, H, 1>(s, dp, wl, ww, ds, partials, n, q, k, stream);
    case 2: return launch_c<T, H, 2>(s, dp, wl, ww, ds, partials, n, q, k, stream);
    case 4: return launch_c<T, H, 4>(s, dp, wl, ww, ds, partials, n, q, k, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(const void* s, const void* dp, const float* wl, const float* ww, void* ds,
                     float* partials, int n, int h, int q, int k, cudaStream_t stream) {
  switch (h) {
    case 4: return launch_h<T, 4>(s, dp, wl, ww, ds, partials, n, q, k, stream);
    case 6: return launch_h<T, 6>(s, dp, wl, ww, ds, partials, n, q, k, stream);
    case 8: return launch_h<T, 8>(s, dp, wl, ww, ds, partials, n, q, k, stream);
    case 16: return launch_h<T, 16>(s, dp, wl, ww, ds, partials, n, q, k, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Number of partials the backward writes for n * q rows, whichever kernel
// takes the shape: the wrapper allocates `partials` as [this, 2 * h * h] float32.
extern "C" long long passl_talking_heads_bwd_blocks(int n, int q) {
  const int64_t rows = (int64_t)n * q;
  const int64_t blocks = num_blocks(rows), warps = row_warps(rows);
  return (long long)(blocks > warps ? blocks : warps);
}

// 1 when the warp-row kernel takes [., h, ., k] at `dtype` (0 float32, 1
// bfloat16, 2 float16), 0 when the block-row kernel does.
extern "C" int passl_talking_heads_bwd_row_kernel(int h, int k, int dtype) {
  return row_kernel_takes(h, k, dtype) ? 1 : 0;
}

// The warp-row kernel's resources at `dtype`, h and k on `device`: registers
// a thread, shared memory a block, blocks an SM, spilled bytes a thread and
// warps a block, into out[0..4].
extern "C" int passl_talking_heads_bwd_row_resources(int dtype, int h, int k, int device,
                                                     int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!row_kernel_takes(h, k, dtype) || k <= 0) return (int)cudaErrorInvalidValue;
  return (int)row_dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, h, 0, k,
                           dtype, nullptr, out);
}

// dtype: 0 float32, 1 bfloat16, 2 float16. Shapes: s, dp and ds [n, h, q, k]
// contiguous at `dtype`; proj_l, proj_w, dproj_l, dproj_w [h, h] float32;
// partials [passl_talking_heads_bwd_blocks(n, q), 2 h h] float32 scratch; all
// on `device`. Launches the kernel the shape takes (warp-row for bf16 / f16
// with h <= 8 and k <= 256, else block-row) and the fixed-order reduction of
// its partials on `stream`; returns cudaGetLastError() after them (0 on
// success).
extern "C" int passl_talking_heads_bwd(const void* s, const void* dp, const void* proj_l,
                                       const void* proj_w, void* ds, void* partials,
                                       void* dproj_l, void* dproj_w, int n, int h, int q, int k,
                                       int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || q <= 0 || k <= 0 || k > kMaxCols * kMaxThreads) return (int)cudaErrorInvalidValue;
  const float* wl = static_cast<const float*>(proj_l);
  const float* ww = static_cast<const float*>(proj_w);
  float* part = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t rows = (int64_t)n * q;
  int64_t num_partials = num_blocks(rows);
  if (row_kernel_takes(h, k, dtype)) {
    err = row_dispatch(s, dp, wl, ww, ds, part, n, h, q, k, dtype, st, nullptr);
    num_partials = row_warps(rows);
  } else {
    switch (dtype) {
      case 0: err = launch_t<float>(s, dp, wl, ww, ds, part, n, h, q, k, st); break;
      case 1: err = launch_t<__nv_bfloat16>(s, dp, wl, ww, ds, part, n, h, q, k, st); break;
      case 2: err = launch_t<__half>(s, dp, wl, ww, ds, part, n, h, q, k, st); break;
      default: err = cudaErrorInvalidValue;
    }
  }
  if (err != cudaSuccess) return (int)err;
  const int outputs = 2 * h * h;
  talking_heads_wgrad_reduce<<<(outputs + 31) / 32, 32 * kReduceWarps, 0, st>>>(
      part, (int)num_partials, h * h, static_cast<float*>(dproj_l),
      static_cast<float*>(dproj_w));
  return (int)cudaGetLastError();
}
