// Talking-heads softmax forward for Hopper (sm_90a): CaiT's hot path.
//
// Replaces passl_tpu/ops/pallas/talking_heads.py::_fwd_kernel. For every
// (n, q) row of the [n, h, q, k] score tensor s it computes
//
//     p[g] = sum_i ww[i, g] * softmax_k( sum_j wl[j, i] * s[j] )
//
// with both head mixes and the softmax in f32, and stores p at s's type.
//
// Bound: device-memory bytes. Per call the kernel must read s once and write
// p once, 2 * n * h * q * k * sizeof(T) bytes (79 MB for CaiT-S24's
// [64, 8, 196, 196] in bf16: 23.5 us at 3.35 TB/s). Its 2 h^2 multiply-adds a
// column (315 M at that shape) take 9.4 us on the CUDA cores at the f32 peak,
// so the bytes bound it only if loads, arithmetic and stores overlap. Done as
// three separate ops (mix, softmax, mix), the scores would make three round
// trips through device memory.
//
// Two kernels; the C entry point picks one by shape and type:
//
// talking_heads_fwd_row_kernel (bf16 / f16, h <= 8, k <= 256: CaiT at 224,
//   the shapes the backward's warp-row kernel takes): one warp owns a row at
//   a time, lane l the columns 4 (l + 32 j) + e (j < V, e < 4), with no
//   block barrier on the row path; a fixed grid of 2,112 warps (16 an SM,
//   one wave on an H100) strides over the rows. Where k % 4 == 0 a lane's
//   four columns of a head are one 8-byte load and one 8-byte store (CaiT's
//   rows start at multiples of 392 bytes); other rows take 2-byte accesses.
//   The row's raw scores sit in registers; once mix 1 has read them the
//   warp issues the next row's loads into the same registers, so they are
//   in flight while the current row takes its softmax, mix 2 and stores:
//   16 rows (50 KB) in flight an SM against the ~20 KB that cover device
//   memory's latency at its rate. Both mixes run on the CUDA cores, each
//   weight read once from shared memory for the lane's 4 V columns; the
//   softmax is the backward's recompute (max and sum as xor shuffles that
//   give every lane the same bits, __expf(x - max), one reciprocal a head).
//   No sum crosses rows, so every launch gives the same bits.
// talking_heads_fwd_kernel (f32, h = 16, k > 256): one block per row, threads
//   across k. Each thread loads its columns' h scores into registers once,
//   does mix 1 there (weights from shared memory), takes the per-head row
//   max and sum through warp shuffles and one pass over shared memory,
//   normalizes (IEEE expf and division, for f32's 1e-5), does mix 2 in
//   registers and stores once. H (heads) and C (columns per thread) are
//   template parameters so the per-thread arrays stay in registers.
//
// Neither pads q: the TPU kernel padded q to its VMEM tile; here a row is a
// block or a warp's turn, and the ragged k edge is masked per lane.

#include "talking_heads.cuh"
#include "tensor_core.cuh"

namespace {

using namespace passl_th;

template <typename T, int H, int C>
__global__ void __launch_bounds__(kMaxThreads)
talking_heads_fwd_kernel(const T* __restrict__ s, const float* __restrict__ proj_l,
                         const float* __restrict__ proj_w, T* __restrict__ out,
                         int q_len, int k_len) {
  __shared__ float wl[H * H];
  __shared__ float ww[H * H];
  __shared__ float red_max[H * kMaxWarps];
  __shared__ float red_sum[H * kMaxWarps];

  for (int i = threadIdx.x; i < H * H; i += blockDim.x) {
    wl[i] = proj_l[i];
    ww[i] = proj_w[i];
  }
  __syncthreads();

  // row = n * q_len + qi; head i of the row starts at s + base + i * head_stride
  const int64_t row = blockIdx.x;
  const int64_t n = row / q_len;
  const int64_t qi = row - n * q_len;
  const int64_t head_stride = (int64_t)q_len * k_len;
  const int64_t base = n * H * head_stride + qi * k_len;

  // mix 1 in registers: mixed[c][g] = sum_i wl[i, g] * s[i] at column c
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
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < H; ++i) acc = fmaf(x[i], wl[i * H + g], acc);
      mixed[c][g] = valid ? acc : -INFINITY;
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

  // normalize, then mix 2 in registers: p[g] = sum_i ww[i, g] * p_mid[i]
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = threadIdx.x + c * blockDim.x;
    if (col >= k_len) continue;
    float p_mid[H];
#pragma unroll
    for (int i = 0; i < H; ++i) p_mid[i] = mixed[c][i] / row_sum[i];
#pragma unroll
    for (int g = 0; g < H; ++g) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < H; ++i) acc = fmaf(p_mid[i], ww[i * H + g], acc);
      out[base + g * head_stride + col] = from_f32<T>(acc);
    }
  }
}

// ---------------------------------------------------------------- warp-row kernel

constexpr int kRowWarps = 4;         // warps of a block of the warp-row kernel
constexpr int kRowBlocksPerSm = 4;   // its launch bound: 128 registers a thread, 16 warps an SM
// The grid's warps: one wave on an H100 (132 SMs x 4 blocks x 4 warps)
constexpr int kRowMaxWarps = 132 * kRowBlocksPerSm * kRowWarps;
constexpr int kRowMaxK = 256;        // k <= 128 V with V <= 2 groups of four columns a lane
constexpr int kRowMaxHeads = 8;

// Head i of row `row` starts at s + row_base(...) + i * hs (rows < 2^31: the wrapper checks)
template <int H>
__device__ __forceinline__ int64_t row_base(int64_t row, int q_len, int k_len, int64_t hs) {
  const int n = (int)row / q_len;
  return (int64_t)n * H * hs + ((int)row - n * q_len) * (int64_t)k_len;
}

// Four values of T (8 bytes, the first in the low half of x) as floats
__device__ __forceinline__ void unpack4(uint2 r, float (&x)[4], __nv_bfloat16) {
  x[0] = __uint_as_float(r.x << 16);
  x[1] = __uint_as_float(r.x & 0xffff0000u);
  x[2] = __uint_as_float(r.y << 16);
  x[3] = __uint_as_float(r.y & 0xffff0000u);
}
__device__ __forceinline__ void unpack4(uint2 r, float (&x)[4], __half) {
  x[0] = __half2float(__ushort_as_half((unsigned short)(r.x & 0xffffu)));
  x[1] = __half2float(__ushort_as_half((unsigned short)(r.x >> 16)));
  x[2] = __half2float(__ushort_as_half((unsigned short)(r.y & 0xffffu)));
  x[3] = __half2float(__ushort_as_half((unsigned short)(r.y >> 16)));
}

// The four values of T at columns col.. col + 3 of src, zero past k: one
// 8-byte load when `vec` (k % 4 == 0 and an 8-byte aligned row), else four
// 2-byte loads.
template <typename T>
__device__ __forceinline__ uint2 load_group(const T* __restrict__ src, int col, int k, bool vec) {
  if (vec) return col < k ? *reinterpret_cast<const uint2*>(src + col) : make_uint2(0u, 0u);
  const unsigned short* p = reinterpret_cast<const unsigned short*>(src) + col;
  uint32_t v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = col + e < k ? p[e] : 0u;
  return make_uint2(v[0] | (v[1] << 16), v[2] | (v[3] << 16));
}

// v rounded to T and stored at columns col.. col + 3 of dst, none past k
template <typename T>
__device__ __forceinline__ void store_group(T* __restrict__ dst, int col, int k, bool vec,
                                            const float* v) {
  const uint2 r = make_uint2(passl_tc::pack<T>(v[0], v[1]), passl_tc::pack<T>(v[2], v[3]));
  if (vec) {
    if (col < k) *reinterpret_cast<uint2*>(dst + col) = r;
    return;
  }
  unsigned short* p = reinterpret_cast<unsigned short*>(dst) + col;
  const uint32_t w[4] = {r.x & 0xffffu, r.x >> 16, r.y & 0xffffu, r.y >> 16};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (col + e < k) p[e] = (unsigned short)w[e];
  }
}

// The row's h x 4 V scores of this lane into raw[i][j] (head i, columns 4 (lane + 32 j) ..)
template <typename T, int H, int V>
__device__ __forceinline__ void load_row(uint2 (&raw)[H][V], const T* __restrict__ s, int64_t hs,
                                         int k, int lane, bool vec) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
#pragma unroll
    for (int j = 0; j < V; ++j) raw[i][j] = load_group<T>(s + i * hs, 4 * (lane + 32 * j), k, vec);
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

template <typename T, int H, int V>
__global__ void __launch_bounds__(32 * kRowWarps, kRowBlocksPerSm)
talking_heads_fwd_row_kernel(const T* __restrict__ s, const float* __restrict__ proj_l,
                             const float* __restrict__ proj_w, T* __restrict__ out, int q_len,
                             int k_len, int64_t rows, bool vec) {
  constexpr int C = 4 * V;  // columns a lane: c = 4 j + e is column 4 (lane + 32 j) + e
  __shared__ __align__(16) float wl[H * H];
  __shared__ __align__(16) float wwt[H * H];  // proj_w transposed: wwt[g][i] = ww[i][g]
  for (int i = threadIdx.x; i < H * H; i += blockDim.x) {
    wl[i] = proj_l[i];
    wwt[(i % H) * H + i / H] = proj_w[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t hs = (int64_t)q_len * k_len;
  const int64_t stride = (int64_t)gridDim.x * kRowWarps;
  const int64_t first = (int64_t)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  // columns of the last group may lie past k; earlier groups' never do (V = ceil(k / 128))
  const bool ragged = 4 * (lane + 32 * (V - 1)) + 3 >= k_len;
  int64_t base = row_base<H>(first, q_len, k_len, hs);
  uint2 raw[H][V];  // the row's scores as loaded
  if (first < rows) load_row<T, H, V>(raw, s + base, hs, k_len, lane, vec);

  for (int64_t row = first; row < rows; row += stride) {
    // mix 1: p[c][g] = sum_i s[i] wl[i][g]
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
      for (int j = 0; j < V; ++j) {
        float q4[4];
        unpack4(raw[i][j], q4, T());
#pragma unroll
        for (int e = 0; e < 4; ++e) x[4 * j + e] = q4[e];
      }
#pragma unroll
      for (int g = 0; g < H; ++g) {
        const float w = wl[i * H + g];
#pragma unroll
        for (int c = 0; c < C; ++c) p[c][g] = fmaf(x[c], w, p[c][g]);
      }
    }

    // raw is read: the next row's loads are in flight from here to its mix 1
    const int64_t next = row + stride;
    const int64_t next_base = row_base<H>(next < rows ? next : row, q_len, k_len, hs);
    if (next < rows) load_row<T, H, V>(raw, s + next_base, hs, k_len, lane, vec);

    if (ragged) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (4 * (lane + 32 * (V - 1)) + e >= k_len) {
#pragma unroll
          for (int g = 0; g < H; ++g) p[4 * (V - 1) + e][g] = -INFINITY;  // exp gives 0
        }
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

    // mix 2: out[g] = sum_i ww[i][g] p_mid[i], stored once at T
#pragma unroll
    for (int g = 0; g < H; ++g) {
      float v[C];
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = 0.f;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float w = wwt[g * H + i];
#pragma unroll
        for (int c = 0; c < C; ++c) v[c] = fmaf(w, p[c][i], v[c]);
      }
#pragma unroll
      for (int j = 0; j < V; ++j)
        store_group<T>(out + base + g * hs, 4 * (lane + 32 * j), k_len, vec, v + 4 * j);
    }
    base = next_base;
  }
}

bool row_kernel_takes(int h, int k, int dtype) {
  return dtype != 0 && h <= kRowMaxHeads && k <= kRowMaxK;
}

// Warps of the warp-row kernel's grid for `rows` rows (whole blocks)
int64_t row_warps(int64_t rows) {
  const int64_t w = rows < kRowMaxWarps ? rows : kRowMaxWarps;
  return (w + kRowWarps - 1) / kRowWarps * kRowWarps;
}

// registers a thread, shared memory a block, blocks an SM, spilled bytes a
// thread, warps a block
template <typename T, int H, int V>
cudaError_t row_resources_v(int* out) {
  auto kernel = talking_heads_fwd_row_kernel<T, H, V>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * kRowWarps, 0);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = per_sm;
  out[3] = (int)attr.localSizeBytes;
  out[4] = kRowWarps;
  return cudaSuccess;
}

// One call per (T, H, V): launch the warp-row kernel, or read its resources when `out` is set.
template <typename T, int H, int V>
cudaError_t row_v(const void* s, const float* wl, const float* ww, void* out, int n, int q, int k,
                  cudaStream_t stream, int* res) {
  if (res) return row_resources_v<T, H, V>(res);
  const int64_t rows = (int64_t)n * q;
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(s) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 8 == 0;
  talking_heads_fwd_row_kernel<T, H, V><<<(unsigned)(row_warps(rows) / kRowWarps),
                                          32 * kRowWarps, 0, stream>>>(
      static_cast<const T*>(s), wl, ww, static_cast<T*>(out), q, k, rows, vec);
  return cudaGetLastError();
}

template <typename T, int H>
cudaError_t row_h(const void* s, const float* wl, const float* ww, void* out, int n, int q, int k,
                  cudaStream_t stream, int* res) {
  switch ((k + 127) / 128) {
    case 1: return row_v<T, H, 1>(s, wl, ww, out, n, q, k, stream, res);
    case 2: return row_v<T, H, 2>(s, wl, ww, out, n, q, k, stream, res);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t row_t(const void* s, const float* wl, const float* ww, void* out, int n, int h, int q,
                  int k, cudaStream_t stream, int* res) {
  switch (h) {
    case 4: return row_h<T, 4>(s, wl, ww, out, n, q, k, stream, res);
    case 6: return row_h<T, 6>(s, wl, ww, out, n, q, k, stream, res);
    case 8: return row_h<T, 8>(s, wl, ww, out, n, q, k, stream, res);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t row_dispatch(const void* s, const float* wl, const float* ww, void* out, int n, int h,
                         int q, int k, int dtype, cudaStream_t stream, int* res) {
  switch (dtype) {
    case 1: return row_t<__nv_bfloat16>(s, wl, ww, out, n, h, q, k, stream, res);
    case 2: return row_t<__half>(s, wl, ww, out, n, h, q, k, stream, res);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- block-row kernel's launch

template <typename T, int H>
cudaError_t launch_h(const void* s, const float* wl, const float* ww, void* out, int n, int q,
                     int k, cudaStream_t stream) {
  const int64_t rows = (int64_t)n * q;
#define PASSL_TH_LAUNCH(C)                                                                  \
  {                                                                                         \
    talking_heads_fwd_kernel<T, H, C><<<(unsigned)rows, threads_for(k, C), 0, stream>>>(    \
        static_cast<const T*>(s), wl, ww, static_cast<T*>(out), q, k);                      \
    return cudaGetLastError();                                                              \
  }
  switch (cols_per_thread(k)) {
    case 1: PASSL_TH_LAUNCH(1)
    case 2: PASSL_TH_LAUNCH(2)
    case 4: PASSL_TH_LAUNCH(4)
    default: return cudaErrorInvalidValue;
  }
#undef PASSL_TH_LAUNCH
}

template <typename T>
cudaError_t launch_t(const void* s, const float* wl, const float* ww, void* out, int n, int h,
                     int q, int k, cudaStream_t stream) {
  switch (h) {
    case 4: return launch_h<T, 4>(s, wl, ww, out, n, q, k, stream);
    case 6: return launch_h<T, 6>(s, wl, ww, out, n, q, k, stream);
    case 8: return launch_h<T, 8>(s, wl, ww, out, n, q, k, stream);
    case 16: return launch_h<T, 16>(s, wl, ww, out, n, q, k, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// 1 when the warp-row kernel takes [., h, ., k] at `dtype` (0 float32, 1
// bfloat16, 2 float16), 0 when the block-row kernel does.
extern "C" int passl_talking_heads_fwd_row_kernel(int h, int k, int dtype) {
  return row_kernel_takes(h, k, dtype) ? 1 : 0;
}

// The warp-row kernel's resources at `dtype`, h and k on `device`: registers
// a thread, shared memory a block, blocks an SM, spilled bytes a thread and
// warps a block, into out[0..4].
extern "C" int passl_talking_heads_fwd_row_resources(int dtype, int h, int k, int device,
                                                     int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!row_kernel_takes(h, k, dtype) || k <= 0) return (int)cudaErrorInvalidValue;
  return (int)row_dispatch(nullptr, nullptr, nullptr, nullptr, 0, h, 0, k, dtype, nullptr, out);
}

// dtype: 0 float32, 1 bfloat16, 2 float16. Shapes: s and out [n, h, q, k]
// contiguous; proj_l and proj_w [h, h] float32 contiguous, all on `device`.
// Launches the kernel the shape takes (warp-row for bf16 / f16 with h <= 8
// and k <= 256, else block-row) on `stream` and returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int passl_talking_heads_fwd(const void* s, const void* proj_l, const void* proj_w,
                                       void* out, int n, int h, int q, int k, int dtype,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || q <= 0 || k <= 0 || k > passl_th::kMaxCols * passl_th::kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const float* wl = static_cast<const float*>(proj_l);
  const float* ww = static_cast<const float*>(proj_w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (row_kernel_takes(h, k, dtype))
    return (int)row_dispatch(s, wl, ww, out, n, h, q, k, dtype, st, nullptr);
  switch (dtype) {
    case 0: err = launch_t<float>(s, wl, ww, out, n, h, q, k, st); break;
    case 1: err = launch_t<__nv_bfloat16>(s, wl, ww, out, n, h, q, k, st); break;
    case 2: err = launch_t<__half>(s, wl, ww, out, n, h, q, k, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// Largest k the kernels take (the block-row kernel's columns per thread times threads per block).
extern "C" int passl_talking_heads_max_k() { return passl_th::kMaxCols * passl_th::kMaxThreads; }
