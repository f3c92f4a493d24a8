// The tensor-core route of the batched QKAN layer over M3: the plan that
// qkan_layer_m3.cu's entries read (its rule is tc_plan there, mirrored by
// experimental/pallas_layer.py's m3_tc_plan) and the launches of the
// kernels of qkan_layer_m3_tc.cu: K12's forward, K13's backward with dx
// and K14's weight-only backward.  Every number of a plan is a function of
// the sizes alone, never of the card, so every card gives the same bits.
#pragma once

#include <cuda_runtime.h>

#ifndef QKAN_M3_TC
#define QKAN_M3_TC 1  // 0: every shape takes the CUDA-core kernels (tools/)
#endif

namespace qkan {

constexpr int M3T_THREADS = 256;  // 8 warps
constexpr int M3T_GRID = 264;     // forward blocks at most (2 x 132)
constexpr int M3T_CHUNK = 32;     // backward: rows of a ring stage
constexpr int M3T_GS = 24;        // backward: g stage row stride (16 + 8)
constexpr int M3T_DPG = 8;        // backward: degrees a warp at most
constexpr int M3T_RING = 2;       // stages of a warp's cp.async ring
constexpr long long M3T_SMEM_SM = 233472;  // shared memory of an H100 SM
constexpr long long M3T_SMEM_RESERVED = 1024;  // the system's, a block

// The tiling of one call.  s: k-steps of 8 features a degree (N padded to
// 8 s); xs: the x stage's row stride.  Forward: mt m16-tiles (16 rows) a
// warp's task, ntw n8-tiles of K a warp, ng groups of them.  Backward (K13
// and K14): mg m16-tiles of K (16 columns of g a warp), dgn groups of dpg
// degrees, wr warps (row splits) a group in a block, gy the grid's second
// dimension.
// smem: the dynamic shared memory of a block.
struct M3TcPlan {
  int ok, s, xs, mt, ntw, ng, mg, dgn, dpg, wr, gy;
  long long smem;
};

// K12 over all of x [B, N] (f32), m3 [dp1, N, K], out [B, K] (f32).
cudaError_t m3_fwd_tc(const float* x, const float* m3, float* out,
                      long long B, int N, int dp1, int K, const M3TcPlan& p,
                      cudaStream_t stream);

// K14 over all of x [B, N] and g [B, K] (f32): the per-block dM partials
// part [nblk][dp1][N][K], `rows` rows a block.
cudaError_t m3_bwd_dw_tc(const float* x, const float* g, float* part,
                         long long B, int N, int dp1, int K, int rows,
                         int nblk, const M3TcPlan& p, cudaStream_t stream);

// K13 over all of x [B, N], g [B, K] and m3 [dp1, N, K] (f32): K14's dM
// partials, the same bits, and dx [B, N] (f32).
cudaError_t m3_bwd_tc(const float* x, const float* g, const float* m3,
                      float* dx, float* part, long long B, int N, int dp1,
                      int K, int rows, int nblk, const M3TcPlan& p,
                      cudaStream_t stream);

}  // namespace qkan
