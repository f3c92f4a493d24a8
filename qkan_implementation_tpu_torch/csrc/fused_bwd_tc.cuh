// The route and plan of the fused-layer backward's tensor-core kernel
// (fused_dw_bwd_tc.cu), read by the backward's entries in fused_dw_bwd.cu.
// Every number here is a function of the sizes alone (and of x's dtype and
// the precision mode, which pick the route), never of the card, so every
// card gives the same bits.  ops/fused_layer.py's fused_bwd_plan mirrors
// bwd_tc_plan and bwd_tc_rows.
#pragma once

#include <cstddef>

#include <cuda_runtime.h>

#ifndef QKAN_BWD_TC
#define QKAN_BWD_TC 1  // 0: every shape takes the CUDA-core kernel (tools/)
#endif

namespace qkan {

constexpr int BT_ROWS = 64;        // rows of a tile
constexpr int BT_FC = 16;          // input features a block (a chunk)
constexpr int BT_THREADS = 256;    // 8 warps
constexpr int BT_GRID = 264;       // blocks the row split aims at (2 x 132)
constexpr long long BT_BUDGET = 8LL << 20;  // bytes of dW partials
constexpr size_t BT_SMEM_MAX = 232448;      // a block's shared memory, sm_90

// degrees (dp1 - 1) whose dW^T a warp holds in registers, 4 floats a
// (degree, m16-tile of T): 12, 6 or 3 at T padded to 16, 32 or 64 columns
__host__ __device__ constexpr int bt_degrees_max(int nt) {
  return 24 / nt;
}
// row stride of the g tile [64][.] at tn = 16, 32, 64 columns: the dW
// product's A fragments (rows t4, columns g8) fall on 32 distinct banks
__host__ __device__ constexpr int bt_g_stride(int tn) {
  return tn == 16 ? 24 : tn + 8;
}

struct BwdTcPlan {
  bool ok;      // the backward at these sizes takes the tensor-core kernel
  int fc;       // features a chunk: BT_FC
  int nt;       // n8-tiles of T padded: 2, 4 or 8 (T <= 64)
  int nfc;      // feature chunks, the grid's second dimension
  int kb;       // basis columns of a chunk, 16 (dp1 - 1)
  int bs;       // basis row stride: kb rounded up to 32, + 8
  size_t smem;  // dynamic shared memory bytes
};

// The route: f32 x, 'high' / 'default' (round_bf16 = 0), dp1 >= 2 and
// T <= 64, where a warp's dW^T fits its registers (dp1 - 1 at most
// bt_degrees_max) and a block's tiles its shared memory: the basis [64][bs], x and g, each in two stages, or
// the row splits' dW^T where that is more, and W_chunk [kb][T padded].  A
// bf16 x, the 'bf16' mode, dp1 = 1, T > 64 and more degrees keep the
// CUDA-core kernel.
inline BwdTcPlan bwd_tc_plan(int in, int dp1, int T, int x_is_bf16,
                             int round_bf16) {
  BwdTcPlan p{};
  if (!QKAN_BWD_TC || x_is_bf16 || round_bf16 || in < 1 || dp1 < 2 ||
      T < 1 || T > 64) {
    return p;
  }
  // T padded to whole m16 tiles of dW^T: 16, 32 or 64 columns
  const int n8 = (T + 7) / 8;
  p.nt = n8 <= 2 ? 2 : n8 <= 4 ? 4 : 8;
  const int tn = 8 * p.nt;
  const long long d = dp1 - 1;
  if (d > bt_degrees_max(p.nt)) return p;
  const long long kb = d * BT_FC;
  const long long bs = (kb + 31) / 32 * 32 + 8;
  const long long tiles = 2LL * BT_ROWS * (bs + BT_FC + bt_g_stride(tn));
  const long long red = 8 * 128 * d * (p.nt / 2);
  const size_t smem = 4 * (size_t)((tiles > red ? tiles : red) + 2 * kb * tn);
  if (smem > BT_SMEM_MAX) return p;
  p.ok = true;
  p.fc = BT_FC;
  p.nfc = (in + BT_FC - 1) / BT_FC;
  p.kb = (int)kb;
  p.bs = (int)bs;
  p.smem = smem;
  return p;
}

struct BwdTcRows {
  int rows;  // batch rows a block, whole 64-row tiles
  int nrb;   // row blocks, the grid's first dimension
};

// Row blocks: about BT_GRID / nfc of them (so about BT_GRID blocks in
// all), no more than the 64-row tiles, and fewer where the dW partials
// [nrb][dp1-1][in][T] would pass BT_BUDGET; a block's rows contiguous.
inline BwdTcRows bwd_tc_rows(int B, int in, int dp1, int T,
                             const BwdTcPlan& p) {
  const long long tiles = ((long long)B + BT_ROWS - 1) / BT_ROWS;
  const long long per_rb = (long long)(dp1 - 1) * in * T * 4;
  long long nrb = BT_GRID / p.nfc;
  if (nrb > BT_BUDGET / per_rb) nrb = BT_BUDGET / per_rb;
  if (nrb > tiles) nrb = tiles;
  if (nrb < 1) nrb = 1;
  const long long rows = (tiles + nrb - 1) / nrb * BT_ROWS;
  return BwdTcRows{(int)rows, (int)(((long long)B + rows - 1) / rows)};
}

// One launch of the tensor-core kernel on `stream` over the plan's grid
// (nrb x nfc blocks): dx (want_dx), the dW partials part [nrb][dp1-1][in][T]
// and the colsum(g) partials gpart [nrb][T].  Returns its launch error.
cudaError_t fused_bwd_tc(const float* x, const float* w2, const float* g,
                         float* dx, float* part, float* gpart, int B, int in,
                         int dp1, int T, const BwdTcPlan& p,
                         const BwdTcRows& r, int apply_tanh, int want_dx,
                         cudaStream_t stream);

}  // namespace qkan
