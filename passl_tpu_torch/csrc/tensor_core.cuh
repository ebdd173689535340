// Tensor-core and asynchronous-copy primitives shared by the flash-attention
// kernels (flash_attention.cuh) and the window-attention kernels
// (window_attention.cuh): mma.sync.m16n8k16 with f32 accumulation on bf16 or
// f16 operands, the fragment loads that feed it from shared memory, and
// cp.async 16-byte copies from device memory into shared memory.
//
// Fragment layout of m16n8k16 (thread g = lane / 4, t = lane % 4): the A
// operand (16 x 16, row-major) holds rows g and g + 8 and columns 2t, 2t + 1
// and 2t + 8, 2t + 9; the B operand (16 x 8) rows 2t, 2t + 1 and 2t + 8,
// 2t + 9 of column g; the accumulator (16 x 8) rows g and g + 8, columns 2t
// and 2t + 1. So an accumulator tile of 16 rows is, chunk pair by chunk
// pair, the A operand of the next product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace passl_tc {

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2], __nv_bfloat16) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2], __half) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b for one m16n8k16 step at T's precision
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  mma_16816(c, a, b, T());
}

// (x, y) rounded to T and packed, x in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack(float x, float y);
template <>
__device__ __forceinline__ uint32_t pack<__nv_bfloat16>(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack<__half>(float x, float y) {
  __half2 v = __floats2half2_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A operand (16 x 16) at (row0, col0) of a row-major tile s with row stride ld.
template <typename T>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const T* s, int ld, int row0, int col0,
                                       int lane) {
  const T* p = s + (row0 + (lane >> 2)) * ld + col0 + 2 * (lane & 3);
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// The B operand (16 x 8: k0.. along k, n0.. along n) of a product whose B is
// held transposed, s[n][k], with row stride ld.
template <typename T>
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const T* s, int ld, int n0, int k0,
                                       int lane) {
  const T* p = s + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// The B operand (16 x 8) at (k0, n0) of a product whose B is held as it
// stands, s[k][n], row-major with row stride ld (16-byte aligned rows):
// lanes 0-15 give the addresses of rows k0 .. k0 + 15, and `.trans` hands
// each thread the column entries the fragment wants.
template <typename T>
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[2], const T* s, int ld, int k0, int n0,
                                             int lane) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(s + (k0 + (lane & 15)) * ld + n0));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(addr));
}

// The B operands of two neighbouring 8-column chunks, n0.. (b0) and n0 + 8..
// (b1), over k0 .. k0 + 15 of a product whose B is held transposed, s[n][k]
// (16-byte aligned rows), in one `ldmatrix.x4`: lanes 8 q .. 8 q + 7 give the
// rows of the q-th 8 x 8 matrix (rows n0 + 8 (q / 2) .., columns k0 + 8 (q % 2)).
// The same fragments as two pairs of load_b calls.
template <typename T>
__device__ __forceinline__ void load_b_x4(uint32_t (&b0)[2], uint32_t (&b1)[2], const T* s, int ld,
                                          int n0, int k0, int lane) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(
      s + (n0 + (lane & 7) + 8 * (lane >> 4)) * ld + k0 + 8 * ((lane >> 3) & 1)));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b0[0]), "=r"(b0[1]), "=r"(b1[0]), "=r"(b1[1])
               : "r"(addr));
}

// The B operands (16 x 8 each) at (k0, n0) (b0) and (k0, n0 + 8) (b1) of a
// product whose B is held as it stands, s[k][n] (16-byte aligned rows), in
// one `ldmatrix.x4.trans`: the same fragments as two load_b_trans calls.
template <typename T>
__device__ __forceinline__ void load_b_trans_x4(uint32_t (&b0)[2], uint32_t (&b1)[2], const T* s,
                                                int ld, int k0, int n0, int lane) {
  const unsigned addr = static_cast<unsigned>(
      __cvta_generic_to_shared(s + (k0 + (lane & 15)) * ld + n0 + 8 * (lane >> 4)));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b0[0]), "=r"(b0[1]), "=r"(b1[0]), "=r"(b1[1])
               : "r"(addr));
}

// The A operand (16 x 16: m0.. along m, k0.. along k) of a product whose A
// is held transposed, s[k][m], row-major with row stride ld (16-byte aligned
// rows): A(m, k) = s[k0 + k][m0 + m]. Lanes 8 q .. 8 q + 7 give the rows of
// the q-th 8 x 8 matrix (k0 + 8 (q / 2) .., columns m0 + 8 (q % 2) ..), and
// `.trans` hands thread (g, t) the entries (2t, g) and (2t + 1, g) of each,
// which are a[q] of the fragment.
template <typename T>
__device__ __forceinline__ void load_a_trans(uint32_t (&a)[4], const T* s, int ld, int k0, int m0,
                                             int lane) {
  const int q = lane >> 3;
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(
      s + (k0 + (lane & 7) + 8 * (q >> 1)) * ld + m0 + 8 * (q & 1)));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// max (or sum) of v over the 4 threads of a quad, in a fixed order
template <bool IS_MAX>
__device__ __forceinline__ float quad_reduce(float v) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = IS_MAX ? fmaxf(v, o) : v + o;
  }
  return v;
}

// 16 bytes from device memory at src into shared memory at dst, both
// 16-byte aligned, without passing through registers; with valid false the
// 16 bytes are zero-filled and nothing is read (src must still be a valid
// address). Completes at cp_async_wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

// Closes the group of cp.async copies this thread issued since the last commit.
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Waits until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace passl_tc
