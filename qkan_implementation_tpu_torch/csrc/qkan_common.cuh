// Helpers shared by the package's kernels: for the fused-layer kernels
// (fused_dw_fwd.cu, fused_dw_bwd.cu) bf16 rounding, loads and stores in x's
// dtype, and one step of the Chebyshev recurrence rounded as torch rounds
// it; for the streaming kernels (statevector.cu) the grid of a
// grid-stride pass.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace qkan {

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load_as_float(const float* p) { return *p; }
__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_float(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// (2t * c) - p, each op rounded as torch rounds it for x's dtype (bf16 when
// XBF16): no contraction into one FMA.  Serves T_{d+1} = 2t T_d - T_{d-1}
// and U_{d+1} = 2t U_d - U_{d-1} alike.
template <bool XBF16>
__device__ __forceinline__ float cheb_next(float two_t, float c, float p) {
  if (XBF16) return bf16_round(__fsub_rn(bf16_round(__fmul_rn(two_t, c)), p));
  return __fsub_rn(__fmul_rn(two_t, c), p);
}

// T padded to the register tile: 4, 8, 12, 16, 32 or 64.
inline int pad_t(int T) {
  return T <= 4 ? 4 : T <= 8 ? 8 : T <= 12 ? 12 : T <= 16 ? 16 : T <= 32 ? 32 : 64;
}

// Blocks of `threads` for a grid-stride pass over `total` items: one item a
// thread up to `per_sm` resident blocks on every SM of the current device,
// then each thread loops.
inline int stream_grid(long long total, int threads, int per_sm = 8) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    sms = 132;
  }
  const long long want = (total + threads - 1) / threads;
  const long long cap = (long long)sms * per_sm;
  return (int)(want < cap ? want : cap);
}

}  // namespace qkan
