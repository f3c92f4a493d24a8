// The fused FixedKAN layer backward on the tensor cores (sm_90a):
// fused_dw_bwd_kernel_tc, launched by the backward's entries
// (qkan_fused_dw_bwd, qkan_fused_bwd in fused_dw_bwd.cu) wherever
// bwd_tc_plan (fused_bwd_tc.cuh) takes the sizes: an f32 x, 'high' or
// 'default', dp1 >= 2, T <= 64 and dp1 - 1 <= 12, 6 or 3 at T padded to
// 16, 32 or 64.  The rest (a bf16 x, 'bf16', dp1 = 1, T > 64, more
// degrees) keeps fused_dw_bwd.cu's CUDA-core kernel.
//
// Replaces, with that kernel, two TPU kernels of
// qkan_implementation_tpu/ops/fused_layer.py: _bwd_kernel_degreewise (the
// backward of kan_layer_fused_dw) and _bwd_kernel (of the v1
// kan_layer_fused; at an f32 x the two compute the same).  With t =
// tanh(x) (or raw x) and g [B, T] f32:
//
//     dW_0[i, c] = sum_b g[b, c]
//     dW_d       = T_d(t)^T @ g                            (d >= 1)
//     dx         = (1 - t^2) * sum_{d>=1} d U_{d-1}(t) * (g @ W_d^T)
//
// What bounds it on an H100 (bytes: x and g read, dx written, w2 read and
// dW written, once each, over 3.35 TB/s; operations: the two contractions,
// 2 x 2 B in (dp1-1) T flops, as three TF32 passes over 495 TFLOP/s, FP32
// CUDA cores at 67 TFLOP/s beside).  At dp1 = 6:
//   784 -> 10, B 4096: 26.2 MB, 7.83 us; 0.64 GFLOP, 3.89 us (FP32 9.59):
//                      bytes;
//   784 -> 32, B 4096: 27.4 MB, 8.18 us; 2.06 GFLOP, 12.46 us (FP32
//                      30.67): operations;
//   784 -> 10, B 64:   0.78 MB, 0.23 us: bytes, and the launch sets the
//                      pace, as at every narrow layer (10 -> 10: 0.004 us).
// So at the flagship's layer 0 the kernel should stream x in and dx out
// at close to the memory's rate with the products hidden under the
// copies, and at batch 64 spread one 64-row tile over as many blocks as
// there are feature chunks.
//
// Design.  The CUDA-core kernel gave a block up to 128 features, one
// thread each, walking its rows one after another with W and dW in 217
// registers; its grid, capped by a 4 MB partial budget, was 2 blocks at
// 10 -> 10, B 64 and 56 at 784 -> 32, B 4096, and at T 16 / 32 it ran 2 /
// 3 launches, each reading x and running the recurrences again.  Here:
//   - the grid is (row blocks) x (chunks of 16 input features)
//     (bwd_tc_rows: about 264 blocks where the rows allow it; 49 at the
//     flagship's B 64).  A feature's dW rows and dx column depend on that
//     feature's degrees alone, so the features split with no reduction;
//     the row blocks leave dW partials [nrb][dp1-1][in][T] and colsum(g)
//     [nrb][T] (chunk-0 blocks) to the fixed-order pass of partial_sum.cu,
//     launched by the same entry, in the form the CUDA-core kernel leaves;
//   - a block walks its rows in 64-row tiles, x and g of the next tile
//     arriving by cp.async into the other stage of a two-stage ring while
//     this tile is worked (16-byte copies where in, T and the pointers
//     allow, else 4-byte ones; zero-filled past B, in and T).  Each thread
//     copies the x quad (one row, four features) whose basis it builds,
//     and the basis is double-buffered, so a tile needs one barrier: a
//     warp done with tile j's products builds tile j+1 while others
//     finish theirs;
//   - t and the basis T_1..T_D of a tile are built once (the recurrences
//     here and in the epilogue as FMAs: one rounding a step, not torch's
//     two), into shared memory [64][16 D] (column (d-1)*16 + f), and feed
//     both products, each on the tensor cores (mma.sync m16n8k8, 3xTF32:
//     a = hi + lo, hi*hi + lo*hi + hi*lo summed in f32, FP32-class as
//     K1/K3 and K5):
//       dW^T[T, 16 D] += g^T @ basis  warp (fg, ks): 8 features x every
//                                     degree x every column, over the
//                                     tile's rows 16 ks .. +16; g's
//                                     fragments loaded once a k-step for
//                                     every degree; in registers across
//                                     the block's tiles, the row splits
//                                     added in order at the end;
//       gm[64, 16 D] = g @ W_chunk^T  warp w: 16 rows x 8 features, every
//                                     degree; W_chunk staged once a block
//                                     in the B-fragment order and split
//                                     into hi and lo there (one 16-byte
//                                     load a fragment, no split in the
//                                     loop);
//   - the dx epilogue runs in gm's fragment layout: a thread holds every
//     degree of its 2 rows x 2 features, so dt = sum_d d U_{d-1}(t) gm_d
//     (U by its recurrence, in registers, d ascending) and dx = (1 - t^2)
//     dt need no exchange; each row's four lanes write 32 contiguous bytes;
//   - every warp does the same work in each phase (no guard at the fast
//     path's compile-time dp1 = 6); colsum(g) is summed by 4 T threads,
//     each a quarter of a tile's rows in row order, the quarters added in
//     order at the end, so the chunk-0 blocks carry no long serial chain.
// On an H100 80GB HBM3 at 700 W (tools/bwd_vs_old.py) the kernel takes
// about 3.7-3.9 us at every narrow layer and at 784 -> 10, B 64 (the
// CUDA-core kernel 18-42 and 19.9), 34.6 at 784 -> 10, B 4096 (99.6) and
// 47.2 at 784 -> 32, B 4096 (949): the dx product and its epilogue take a
// third of it, the barrier's skew a quarter.
// No float atomics: the same bits on every run.  A row's dx depends on the
// row, the chunk width and the mma order alone, all functions of (in, dp1,
// T): its bits are the same at every batch size.  dW depends on B through
// the row blocks, as the CUDA-core kernel's does.

#include <cstdint>

#include "fused_bwd_tc.cuh"
#include "qkan_common.cuh"
#include "tc_common.cuh"

namespace {

using qkan::a_frag;
using qkan::b_frag;
using qkan::BT_FC;
using qkan::BT_ROWS;
using qkan::BT_THREADS;
using qkan::mma_3x;

// This thread's x quad of a tile, rows [r0, r0 + 64) x features [i0, i0 +
// 16): row tid / 4, features 4 (tid % 4) .. +4, into the same place of a
// stage [64][16]; the thread builds the basis of exactly these four, so
// its own cp.async.wait makes them visible to it with no barrier
__device__ __forceinline__ void stage_xq(float* dst, const float* __restrict__ x,
                                         int r0, int r_end, int in, int i0,
                                         int xvec) {
  const int r = threadIdx.x >> 2, f0 = (threadIdx.x & 3) * 4;
  const int b = r0 + r, i = i0 + f0;
  float* d = dst + r * BT_FC + f0;
  if (xvec) {  // one 16-byte copy: in % 4 == 0, x 16-byte aligned
    const bool live = b < r_end && i < in;
    qkan::cp_async16(d, live ? x + (size_t)b * in + i : x, live ? 16 : 0);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool live = b < r_end && i + k < in;
      qkan::cp_async4(d + k, live ? x + (size_t)b * in + i + k : x,
                      live ? 4 : 0);
    }
  }
}

// g rows [r0, r0 + 64) x columns [0, TN) into a stage [64][GS]
template <int TN, int GS>
__device__ __forceinline__ void stage_g(float* dst, const float* __restrict__ g,
                                        int r0, int r_end, int T, int gvec) {
  if (gvec) {  // 16-byte copies: T % 4 == 0, g 16-byte aligned
    constexpr int PER = TN / 4;
    for (int e = threadIdx.x; e < BT_ROWS * PER; e += BT_THREADS) {
      const int r = e / PER, c = (e % PER) * 4;
      const int b = r0 + r;
      const bool live = b < r_end && c < T;
      qkan::cp_async16(dst + r * GS + c, live ? g + (size_t)b * T + c : g,
                       live ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < BT_ROWS * TN; e += BT_THREADS) {
      const int r = e / TN, c = e % TN;
      const int b = r0 + r;
      const bool live = b < r_end && c < T;
      qkan::cp_async4(dst + r * GS + c, live ? g + (size_t)b * T + c : g,
                      live ? 4 : 0);
    }
  }
}

// A debug build (-DQKAN_BWD_TIMING, as tools/bwd_vs_old.py builds it) adds
// thread 0's clock64() cycles of each phase of a tile, summed over the
// blocks, to qkan_bwd_cycles: 0 waiting for the tile (its copies and the
// barrier), 1 the basis, 2 the dW product (with colsum(g)), 3 the dx
// product and its epilogue, 4 the block's start and end.  The package's
// build has none of it.
#ifdef QKAN_BWD_TIMING
__device__ unsigned long long qkan_bwd_cycles[5];
#define QKAN_BWD_MARK(i)                       \
  if (tid == 0) {                              \
    const long long now = clock64();           \
    cyc[i] += (unsigned long long)(now - last); \
    last = now;                                \
  }
#else
#define QKAN_BWD_MARK(i)
#endif

// NT: n8-tiles of T padded (2, 4, 8); DT: the degrees dp1 - 1 as a
// compile-time constant (the fast path, at the flagship's dp1 6), or 0
// where they come at run time (guarded loops over at most DM degrees).
template <int NT, int DT>
__global__ void __launch_bounds__(BT_THREADS, NT == 8 ? 1 : 2)
fused_dw_bwd_kernel_tc(const float* __restrict__ x,
                       const float* __restrict__ w2,
                       const float* __restrict__ g, float* __restrict__ dx,
                       float* __restrict__ part, float* __restrict__ gpart,
                       int B, int in, int dp1, int T, int rows, int bs,
                       int xvec, int gvec, int apply_tanh, int want_dx) {
  constexpr int FC = BT_FC;
  constexpr int TN = 8 * NT;
  constexpr int MT = NT / 2;                  // m16-tiles of T (dW^T rows)
  constexpr int GS = qkan::bt_g_stride(TN);
  constexpr int DM = DT ? DT : qkan::bt_degrees_max(NT);
  constexpr int DG = DT ? DT : 5;             // dx: degrees a pass
  const int D = DT ? DT : dp1 - 1;
  const int kb = FC * D;
  extern __shared__ __align__(16) float smem[];
  float* basis = smem;                        // 2 x [64][bs]
  float* xs = basis + 2 * BT_ROWS * bs;       // 2 x [64][16]
  float* gs = xs + 2 * BT_ROWS * FC;          // 2 x [64][GS]
  // W_chunk in the dx product's B-fragment order, split once a block:
  // [kb/8][NT][32 lanes] float4 {hi W[n][c], hi W[n][c + 4], lo .., lo ..},
  // one 16-byte load a fragment; past the tiles (or the dW reduction,
  // which reuses the tiles' area)
  const int tiles_floats = 2 * BT_ROWS * (bs + FC + GS);
  const int red_floats = 8 * D * MT * 128;
  float4* wf = reinterpret_cast<float4*>(
      smem + (tiles_floats > red_floats ? tiles_floats : red_floats));
  // colsum(g)'s quarters [4][T] at the end, in W's place (dx is done)
  float* cred = reinterpret_cast<float*>(wf);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int rb = blockIdx.x;
  const int i0 = blockIdx.y * FC;
  const int r_begin = rb * rows;
  const int r_end = min(B, r_begin + rows);
  const int ntiles = (r_end - r_begin + BT_ROWS - 1) / BT_ROWS;
  // colsum(g) (chunk-0 blocks): thread tid < 4 T sums column tid % T
  // over rows 16 (tid / T) .. +16 of each tile, in row order; the four
  // quarters are added in order at the end
  const bool colsum = blockIdx.y == 0 && tid < 4 * T;
  const int cq = colsum ? tid / T : 0, cc = colsum ? tid - cq * T : 0;
  // dW: warp (feature group fg, row split ks): basis columns (d-1)*16 +
  // 8 fg .. +8 of every degree, every column of T, rows 16 ks .. +16 of
  // each tile; dx: warp (rows 16 (w & 3) .. +16, features 8 (w >> 2) ..
  // +8), every degree
  const int fg = warp & 1, ks = warp >> 1;
  const int ra = (warp & 3) * 16 + g8, fx = warp >> 2;
#ifdef QKAN_BWD_TIMING
  unsigned long long cyc[5] = {0, 0, 0, 0, 0};
  long long last = clock64();
#endif

  // the first tile's x and g, and W_chunk (row (d-1)*16 + f is W_d[i0 +
  // f, :], zeros past in and T), all in flight at once
  stage_xq(xs, x, r_begin, r_end, in, i0, xvec);
  stage_g<TN, GS>(gs, g, r_begin, r_end, T, gvec);
  for (int e = tid; e < kb * TN; e += BT_THREADS) {
    const int k = e / TN, c = e % TN;
    const int i = i0 + (k & (FC - 1));
    const bool live = i < in && c < T;
    const int slot = ((((k >> 3) * NT + (c >> 3)) * 32 + (k & 7) * 4 +
                       (c & 3)) << 2) + ((c >> 2) & 1);
    qkan::cp_async4(
        reinterpret_cast<float*>(wf) + slot,
        live ? w2 + ((size_t)(k / FC + 1) * in + i) * T + c : w2,
        live ? 4 : 0);
  }
  qkan::cp_async_commit();

  float acc[DM][MT][4];
#pragma unroll
  for (int d = 0; d < DM; ++d)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[d][m][q] = 0.f;
  float csum = 0.f;  // this thread's quarter of colsum(g)[cc]
  QKAN_BWD_MARK(4)

  // One barrier a tile: the basis is double-buffered and each thread
  // builds from the x it copied itself, so a warp done with tile j's
  // products goes on to build tile j+1 while the others finish theirs.
  for (int j = 0; j < ntiles; ++j) {
    const int r0 = r_begin + j * BT_ROWS;
    float* bj = basis + (j & 1) * BT_ROWS * bs;
    const float* gj = gs + (j & 1) * BT_ROWS * GS;
    qkan::cp_async_wait<0>();  // this thread's copies of tile j
    QKAN_BWD_MARK(0)

    // t and the basis of this thread's quad, once: T_d of (row r, feature
    // f) at column (d-1)*16 + f, T_1 = t; the recurrence as FMAs
    {
      const int r = tid >> 2, f0 = (tid & 3) * 4;
      float4 cur = *reinterpret_cast<const float4*>(
          xs + (j & 1) * BT_ROWS * FC + r * FC + f0);
      if (apply_tanh) {
        cur.x = tanhf(cur.x);
        cur.y = tanhf(cur.y);
        cur.z = tanhf(cur.z);
        cur.w = tanhf(cur.w);
      }
      float* row = bj + r * bs + f0;
      *reinterpret_cast<float4*>(row) = cur;
      const float4 two_t = make_float4(2.f * cur.x, 2.f * cur.y, 2.f * cur.z,
                                       2.f * cur.w);
      float4 prev = make_float4(1.f, 1.f, 1.f, 1.f);
#pragma unroll
      for (int d = 1; d < DM; ++d) {
        if (DT || d < D) {
          const float4 nxt = make_float4(fmaf(two_t.x, cur.x, -prev.x),
                                         fmaf(two_t.y, cur.y, -prev.y),
                                         fmaf(two_t.z, cur.z, -prev.z),
                                         fmaf(two_t.w, cur.w, -prev.w));
          prev = cur;
          cur = nxt;
          *reinterpret_cast<float4*>(row + d * FC) = cur;
        }
      }
    }
    QKAN_BWD_MARK(1)
    __syncthreads();  // tile j's basis, g (and W) are in; tile j-1's
                      // products are done, so stage (j+1) & 1 is free
    if (j + 1 < ntiles) {
      stage_xq(xs + ((j + 1) & 1) * BT_ROWS * FC, x, r0 + BT_ROWS, r_end, in,
               i0, xvec);
      stage_g<TN, GS>(gs + ((j + 1) & 1) * BT_ROWS * GS, g, r0 + BT_ROWS,
                      r_end, T, gvec);
      qkan::cp_async_commit();
    }
    if (j == 0) {  // W_chunk is in: split each fragment into hi and lo
      for (int e = tid; e < kb * TN / 2; e += BT_THREADS) {
        const float4 v = wf[e];
        wf[e] = b_frag<false>(make_float2(v.x, v.y));
      }
      __syncthreads();
    }
    QKAN_BWD_MARK(0)

    if (colsum) {  // rows 16 cq .. +16 in order (zeros past B)
#pragma unroll
      for (int r = 0; r < 16; ++r) csum += gj[(16 * cq + r) * GS + cc];
    }

    // dW^T += g^T @ basis over the warp's rows: A = g^T (m = column c,
    // k = row), B = basis (k = row, n = basis column); g's fragments are
    // loaded once a k-step for every degree, a basis fragment is two loads
#pragma unroll
    for (int kk = 0; kk < FC; kk += 8) {
      const int r = ks * FC + kk + t4;
      const float* g0 = gj + r * GS + g8;
      const float* g4 = g0 + 4 * GS;
      float2 a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        a_frag<false>(a[m], g0[16 * m], g0[16 * m + 8], g4[16 * m],
                      g4[16 * m + 8]);
      }
      const float* b0 = bj + r * bs + fg * 8 + g8;
      const float* b4 = b0 + 4 * bs;
#pragma unroll
      for (int d = 0; d < DM; ++d) {
        if (DT || d < D) {
          const float4 b = b_frag<false>(make_float2(b0[d * FC], b4[d * FC]));
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma_3x<false, false>(acc[d][m], acc[d][m], acc[d][m], a[m], b);
          }
        }
      }
    }
    QKAN_BWD_MARK(2)

    // dx: gm = g @ W_chunk^T (A = g, B = W^T: k = column c, n = basis
    // column), then the epilogue in gm's fragments
    if (want_dx) {
      const float* ga = gj + ra * GS + t4;
      float tv[4], um1[4], um2[4], dt[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        tv[q] = bj[(ra + (q >> 1) * 8) * bs + fx * 8 + 2 * t4 + (q & 1)];
        um2[q] = 0.f;  // U_{-1}
        um1[q] = 1.f;  // U_0
        dt[q] = 0.f;
      }
      for (int d0 = 0; d0 < D; d0 += DG) {
        float gm[DG][4];
#pragma unroll
        for (int jd = 0; jd < DG; ++jd)
#pragma unroll
          for (int q = 0; q < 4; ++q) gm[jd][q] = 0.f;
#pragma unroll
        for (int k0 = 0; k0 < TN; k0 += 8) {
          float2 a[4];
          a_frag<false>(a, ga[k0], ga[8 * GS + k0], ga[k0 + 4],
                        ga[8 * GS + k0 + 4]);
#pragma unroll
          for (int jd = 0; jd < DG; ++jd) {
            if (DT || d0 + jd < D) {
              mma_3x<false, false>(
                  gm[jd], gm[jd], gm[jd], a,
                  wf[(((d0 + jd) * 2 + fx) * NT + (k0 >> 3)) * 32 + lane]);
            }
          }
        }
        // dt += d U_{d-1}(t) gm_d, d ascending
#pragma unroll
        for (int jd = 0; jd < DG; ++jd) {
          if (DT || d0 + jd < D) {
            const float dd = (float)(d0 + jd + 1);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              dt[q] = fmaf(dd * um1[q], gm[jd][q], dt[q]);
              const float un = fmaf(2.f * tv[q], um1[q], -um2[q]);
              um2[q] = um1[q];
              um1[q] = un;
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int b = r0 + ra + (q >> 1) * 8;
        const int i = i0 + fx * 8 + 2 * t4 + (q & 1);
        if (b < r_end && i < in) {
          dx[(size_t)b * in + i] =
              apply_tanh ? (1.f - tv[q] * tv[q]) * dt[q] : dt[q];
        }
      }
    }
    QKAN_BWD_MARK(3)
  }

  // the row splits' dW^T, added in split order through shared memory (the
  // tiles' area), each element of the block's partial written once:
  // element q of (degree d, m-tile m) is dW^T[column 16 m + g8 + 8 (q>>1)]
  // [basis column (d-1)*16 + 8 fg + 2 t4 + (q & 1)]
  __syncthreads();  // every warp is done with the tiles
  float* red = smem;  // [8 warps][D][MT][4][32 lanes]
#pragma unroll
  for (int d = 0; d < DM; ++d) {
    if (DT || d < D) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          red[(((warp * D + d) * MT + m) * 4 + q) * 32 + lane] = acc[d][m][q];
        }
    }
  }
  __syncthreads();
  if (ks == 0) {
#pragma unroll
    for (int d = 0; d < DM; ++d) {
      if (DT || d < D) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float v = acc[d][m][q];
#pragma unroll
            for (int s = 1; s < 4; ++s) {
              v += red[((((2 * s + fg) * D + d) * MT + m) * 4 + q) * 32 +
                       lane];
            }
            const int c = 16 * m + g8 + (q >> 1) * 8;
            const int i = i0 + fg * 8 + 2 * t4 + (q & 1);
            if (i < in && c < T) {
              part[(((size_t)rb * D + d) * in + i) * T + c] = v;
            }
          }
      }
    }
  }
  if (colsum) cred[tid] = csum;
  __syncthreads();
  if (colsum && cq == 0) {
    gpart[(size_t)rb * T + cc] =
        ((csum + cred[T + cc]) + cred[2 * T + cc]) + cred[3 * T + cc];
  }
#ifdef QKAN_BWD_TIMING
  QKAN_BWD_MARK(4)
  if (tid == 0) {
    for (int e = 0; e < 5; ++e) atomicAdd(&qkan_bwd_cycles[e], cyc[e]);
  }
#endif
}

template <int NT, int DT>
cudaError_t launch(const float* x, const float* w2, const float* g, float* dx,
                   float* part, float* gpart, int B, int in, int dp1, int T,
                   const qkan::BwdTcPlan& p, const qkan::BwdTcRows& r,
                   int apply_tanh, int want_dx, cudaStream_t s) {
  auto kernel = fused_dw_bwd_kernel_tc<NT, DT>;
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return err;
  }
  const int xvec =
      in % 4 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  const int gvec =
      T % 4 == 0 && reinterpret_cast<std::uintptr_t>(g) % 16 == 0;
  const dim3 grid(r.nrb, p.nfc);
  kernel<<<grid, BT_THREADS, p.smem, s>>>(x, w2, g, dx, part, gpart, B, in,
                                          dp1, T, r.rows, p.bs, xvec, gvec,
                                          apply_tanh, want_dx);
  return cudaGetLastError();
}

}  // namespace

cudaError_t qkan::fused_bwd_tc(const float* x, const float* w2,
                               const float* g, float* dx, float* part,
                               float* gpart, int B, int in, int dp1, int T,
                               const BwdTcPlan& p, const BwdTcRows& r,
                               int apply_tanh, int want_dx,
                               cudaStream_t stream) {
#define QKAN_BT(NT, DT) \
  return launch<NT, DT>(x, w2, g, dx, part, gpart, B, in, dp1, T, p, r, \
                        apply_tanh, want_dx, stream)
  // the fast path: the flagship's dp1 = 6 at T <= 32
  if (dp1 == 6 && p.nt == 2) QKAN_BT(2, 5);
  if (dp1 == 6 && p.nt == 4) QKAN_BT(4, 5);
  switch (p.nt) {
    case 2: QKAN_BT(2, 0);
    case 4: QKAN_BT(4, 0);
    default: QKAN_BT(8, 0);
  }
#undef QKAN_BT
}

#ifdef QKAN_BWD_TIMING
// The debug build's phase cycles (see QKAN_BWD_MARK), read and reset.
extern "C" int qkan_bwd_phase_cycles(unsigned long long* out) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, qkan_bwd_cycles, sizeof(qkan_bwd_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[5] = {0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(qkan_bwd_cycles, zero, sizeof(zero));
}
#endif
