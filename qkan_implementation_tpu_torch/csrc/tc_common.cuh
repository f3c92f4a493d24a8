// Tensor-core helpers shared by the kernels that contract a Chebyshev basis
// on the tensor cores: the train step's fused_step_kernel_tc
// (fused_dw_bwd.cu), the layer forward's fused_dw_fwd_kernel_tc
// (fused_dw_fwd.cu) and the layer backward's fused_dw_bwd_kernel_tc
// (fused_dw_bwd_tc.cu).  FP32-class products from TF32 units (3xTF32), the
// mma.sync tile, its fragments, and cp.async copies into shared memory.
#pragma once

#include <cuda_runtime.h>

namespace qkan {

// v = hi + lo exactly: hi is v with its 13 low mantissa bits cleared (a
// TF32 value), lo = v - hi, exact in FP32.  The tensor core reads lo as
// TF32 too, dropping its low bits: |error| <= 2^-20 |v| a product with
// the lo*lo pass left out, against 2^-24 for an FP32 product.
__device__ __forceinline__ float2 split_tf32(float v) {
  const float hi = __uint_as_float(__float_as_uint(v) & 0xffffe000u);
  return make_float2(hi, v - hi);
}

// the {b0 hi, b1 hi, b0 lo, b1 lo} of a B fragment {b0, b1}; EXACT: its
// values are TF32 already (lo = 0, never read)
template <bool EXACT>
__device__ __forceinline__ float4 b_frag(float2 v) {
  if (EXACT) return make_float4(v.x, v.y, 0.f, 0.f);
  const float2 p = split_tf32(v.x), q = split_tf32(v.y);
  return make_float4(p.x, q.x, p.y, q.y);
}

// c += a @ b on one 16x8x8 TF32 tile, FP32 sums
__device__ __forceinline__ void mma_tf32(float (&c)[4], unsigned a0,
                                         unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the three passes of 3xTF32, a = {hi, lo} fragments, b = {b0 hi, b1 hi,
// b0 lo, b1 lo}: big += a_hi b_hi, s1 += a_lo b_hi, s2 += a_hi b_lo.  The
// accumulators may be one array or three: three make three shorter chains
// of dependent mma.  A pass whose operand is exact in TF32 (EXACT_A /
// EXACT_B: its lo is 0) is skipped.
template <bool EXACT_A, bool EXACT_B>
__device__ __forceinline__ void mma_3x(float (&big)[4], float (&s1)[4],
                                       float (&s2)[4], const float2 (&a)[4],
                                       float4 b) {
#define QKAN_U(v) __float_as_uint(v)
  if (!EXACT_A) {
    mma_tf32(s1, QKAN_U(a[0].y), QKAN_U(a[1].y), QKAN_U(a[2].y),
             QKAN_U(a[3].y), QKAN_U(b.x), QKAN_U(b.y));
  }
  if (!EXACT_B) {
    mma_tf32(s2, QKAN_U(a[0].x), QKAN_U(a[1].x), QKAN_U(a[2].x),
             QKAN_U(a[3].x), QKAN_U(b.z), QKAN_U(b.w));
  }
  mma_tf32(big, QKAN_U(a[0].x), QKAN_U(a[1].x), QKAN_U(a[2].x),
           QKAN_U(a[3].x), QKAN_U(b.x), QKAN_U(b.y));
#undef QKAN_U
}

// accumulator sets a thread keeps for `pairs` (m16, n8) tiles within 32
// registers: 3 (big, s1, s2), 2 (s1 takes both small passes) or 1
__host__ __device__ constexpr int acc_sets(int pairs) {
  return pairs <= 2 ? 3 : pairs <= 4 ? 2 : 1;
}

// big + s1 + s2 of one accumulator element, as acc_sets keeps them
template <int SETS>
__device__ __forceinline__ float acc_total(float big, float s1, float s2) {
  return SETS == 3 ? big + (s1 + s2) : SETS == 2 ? big + s1 : big;
}

// the {hi, lo} pairs of four basis values (EXACT: TF32 already)
template <bool EXACT>
__device__ __forceinline__ void a_frag(float2 (&a)[4], float v0, float v1,
                                       float v2, float v3) {
  const float v[4] = {v0, v1, v2, v3};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    a[q] = EXACT ? make_float2(v[q], 0.f) : split_tf32(v[q]);
  }
}

// 16 bytes (src_bytes of them read, the rest zero-filled) into shared
// memory, bypassing L1
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
// 8 and 4 bytes (as many read, the rest zero-filled), for a source off
// 16 bytes
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace qkan
