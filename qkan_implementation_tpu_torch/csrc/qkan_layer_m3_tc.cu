// The batched QKAN layer over M3 on the tensor cores (sm_90a): K12's
// forward m3_fwd_kernel_tc, K13's backward with dx m3_bwd_kernel_tc and
// K14's weight-only backward m3_bwd_dw_kernel_tc, launched by qkan_m3_fwd /
// qkan_m3_bwd (want_dx = 1 / 0) in qkan_layer_m3.cu wherever its tc_plan
// takes the sizes: an f32 x and an M3 that one launch takes whole.  A bf16
// x and the rest keep qkan_layer_m3.cu's CUDA-core kernels.
//
// Replaces, with those kernels, _fwd_kernel, _bwd_kernel and
// _bwd_dw_kernel of qkan_implementation_tpu/experimental/pallas_layer.py:
//
//     out[b, k]   = sum_{d, n} T_d(x[b, n]) M3[d, n, k]
//     dM[d, n, k] = sum_b T_d(x[b, n]) g[b, k]      (dM[0, n, :] = colsum(g))
//     dx[b, n]    = sum_{d>=1} d U_{d-1}(x[b, n]) (g @ M3[d]^T)[b, n]
//
// What bounds them on an H100: at the headline (B = 262144, N = K = 16,
// dp1 = 8) K12 and K14 each move 33.6 MB (x and out, or x and g), 10.0 us
// at 3.35 TB/s; their 0.94 GFLOP take 5.7 us as three TF32 passes at 495
// TFLOP/s (14.0 on the FP32 CUDA cores).  K13 moves x, g and dx, 50.3 MB
// in 15.0 us, for twice the products (11.4 us as 3xTF32, 28.0 on the CUDA
// cores).  Bytes: the kernels should stream x and g (and out or dx) at
// close to the memory's rate with the products hidden.
//
// Design.  The CUDA-core kernels run on the FP32 cores (a thread a row, M3
// from shared memory as broadcasts; a thread a (feature, 4 columns, 8
// degrees) item that runs its own recurrence), so they cannot pass 14 us,
// and they stage x and g between two barriers with no overlap.  Here the
// products run on the tensor cores (mma.sync m16n8k8, 3xTF32: v = hi + lo,
// hi*hi + lo*hi + hi*lo summed in f32, as K1-K5), and no basis tile
// exists: each thread computes exactly the basis values its own mma
// fragments hold, in registers, from x values it reads itself, and uses
// each once.  Each warp streams its own rows through its own cp.async ring
// of M3T_RING stages in shared memory (16-byte copies where N, K and the
// pointers allow, else 4-byte ones; zero-filled past B, N and K), so a
// warp waits only for its own copies (cp.async.wait_group, __syncwarp):
// no block barrier in the loop.  Two stages measured faster than three
// (tools/m3_vs_old.py --ablate times one).
//
//   K12, out = basis(x) @ M3: a warp's task is mt m16-tiles (16 mt rows) x
//     ntw n8-tiles of K.  A k-step is (degree d >= 1, features 8 s .. +8),
//     its A column j standing for feature 8 s + 2 (j & 3) + (j >> 2): the
//     thread of quad lane t holds features 8 s + 2 t, +1 of rows g and
//     g + 8 (one 8-byte shared load a row), runs T_d by its recurrence in
//     registers, and the values are its A fragments, d ascending.  M3 is
//     staged once a block in that row order as B fragments split into
//     {hi, lo} (one 16-byte load a fragment, each feeding mt x 3 mma).
//     T_0 = 1 is colsum(M3[0]), added once in the epilogue.  out leaves
//     from the C fragments: 8-byte stores of columns (2t, 2t+1) at rows g
//     and g + 8.  A persistent grid of at most M3T_GRID blocks, a function
//     of the sizes alone.
//   K14, dM^T = g^T @ basis: a k-step is 8 batch rows.  A warp owns a
//     group (16 columns of g, features 8 h .. +8, up to M3T_DPG degrees)
//     and keeps its dM^T in registers over a row split of its block's rows
//     (chunks of 32 rows dealt in turn).  Its A fragment is g^T (rows t,
//     t+4 x columns g, g+8), split once a k-step for every degree; the B
//     fragment of degree d is T_d(x[rows t, t+4][feature 8h + g]) from the
//     recurrence in registers.  Degree 0's B fragment is exact ones, taken
//     once for every feature (EXACT_B: no lo pass).  The row splits' sums
//     meet in shared memory in split order and the block writes its
//     partial [dp1][N][K] once; the fixed-order pass of partial_sum.cu sums
//     the partials, launched by the same entry, in the layout (rows a
//     block, blocks) of the CUDA-core kernel.
//   K13 = K14's warps (one device function, the same dM bits) + dx from
//     the chunk each warp already holds: per m16-tile of its 32 rows and
//     degree d of its group, C_d = g[rows, its 16 columns] @ M3[d]^T[., its
//     8 features] (A = g, split once for every degree; B = M3[d]^T, staged
//     once a block as {hi, lo} fragments), and dx += d U_{d-1}(x) C_d in
//     the C fragment's places (rows g, g + 8 x features 2t, 2t + 1), U by
//     its recurrence in registers, d ascending.  Where one warp holds all
//     of K and every degree (the headline) dx leaves from the fragment;
//     else the p = mg dgn warps of a feature group (one block: K13 deals
//     the groups by whole feature groups) add their partials through
//     shared memory in group order, one named barrier a chunk.
//
// On an H100 80GB HBM3 at 700 W (tools/m3_vs_old.py) K12 takes about 19.9
// us at the headline (the CUDA-core kernel 63.4) and 11.7 at N 16 / K 128
// (76.9); K14 22.5 (90.3) and 13.0 (111.9); K13 44.2 (163.8) and 29.1
// (213.7).  With no memory traffic at all K12 and K14 take about 19.5 us
// at the headline: the mma.sync products (143 TFLOP/s of TF32) and the
// basis's ALU set the pace; wgmma is the next step.  K13's dx products
// add 11-12 us at the headline rather than hide under the copies; at N 16
// / K 128 its 32 blocks (16 row blocks x 2 feature groups, K14's layout)
// run 8 chunks each in sequence, and dx's ALU, barrier and 8-way sum add
// about 8 us to its products' 4.
//
// Bits: no float atomics, the same bits on every run.  A row of out or dx
// depends on its x (and g), M3 and the plan (sizes alone): the same bits
// at every B.  dM depends on B through the row blocks, as the CUDA-core
// kernel's does; K13's dM partials are K14's wherever the two block
// layouts (m3_bwd_layout) agree.

#include <cstdint>

#include "m3_tc.cuh"
#include "tc_common.cuh"

namespace {

using qkan::M3T_CHUNK;
using qkan::M3T_DPG;
using qkan::M3T_GRID;
using qkan::M3T_GS;
using qkan::M3T_RING;
using qkan::M3T_THREADS;
using qkan::a_frag;
using qkan::acc_sets;
using qkan::acc_total;
using qkan::b_frag;
using qkan::cp_async16;
using qkan::cp_async4;
using qkan::cp_async_commit;
using qkan::cp_async_wait;
using qkan::mma_3x;

// 16 bytes (src_bytes of them read, the rest zero-filled) into shared
// memory through L1: K14's h-warps of a block copy the same rows of g
__device__ __forceinline__ void cp_async16_l1(void* dst, const void* src,
                                              int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

// -- K12 ----------------------------------------------------------------------

// MT m16-tiles a task, NTW n8-tiles a warp; DT, ST and NGT: the degrees D
// = dp1 - 1, S and NG as compile-time constants (the headline's 7, 2 and
// 1 or 2), or 0 (at run time); S k-steps a degree, XS the x stage's row
// stride (8 or 24 mod 32: a quad's 8-byte reads of rows g .. g + 3 fall on
// distinct banks), NG groups of NTW n-tiles.
template <int MT, int NTW, int DT, int ST, int NGT>
__global__ void __launch_bounds__(M3T_THREADS, NTW >= 8 ? 1 : 2)
m3_fwd_kernel_tc(const float* __restrict__ x, const float* __restrict__ m3,
                 float* __restrict__ out, long long B, int N, int dp1, int K,
                 int S_, int XS, int NG_, long long tasks, int xvec,
                 int ovec) {
  constexpr int SETS = acc_sets(MT * NTW);
  constexpr int ROWS = 16 * MT;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int D = DT ? DT : dp1 - 1;
  const int S = ST ? ST : S_, NG = NGT ? NGT : NG_;
  const int NTP = NG * NTW;  // n8-tiles of K, padded to whole groups
  const int NP = 8 * S;      // features, padded to whole k-steps
  // B fragments [D S][NTP][32 lanes] {hi b0, hi b1, lo b0, lo b1}, then
  // colsum(M3[0]) [8 NTP], then each warp's ring
  float4* bf = reinterpret_cast<float4*>(smem);
  float* csum = smem + (size_t)4 * D * S * NTP * 32;
  const int stage = ROWS * XS;
  float* ring = csum + 8 * NTP + (size_t)warp * M3T_RING * stage;

  // a warp's tasks: wid, wid + nw, ..; task tau is rows (tau / NG) ROWS ..
  // + ROWS, n-tiles (tau % NG) NTW .. + NTW
  const long long wid = (long long)blockIdx.x * 8 + warp;
  const long long nw = (long long)gridDim.x * 8;
  const int ntask = wid < tasks ? (int)((tasks - wid + nw - 1) / nw) : 0;

  // x rows [r0, r0 + ROWS) x features [0, NP) of task j into its stage
  auto stage_task = [&](int j) {
    const long long r0 = (wid + (long long)j * nw) / NG * ROWS;
    float* dst = ring + (j % M3T_RING) * stage;
    if (xvec) {  // N % 4 == 0, x 16-byte aligned
      const int per = NP / 4;
      for (int e = lane; e < ROWS * per; e += 32) {
        const int r = e / per, f = (e - r * per) * 4;
        const long long row = r0 + r;
        const bool ok = row < B && f < N;
        cp_async16(dst + r * XS + f, ok ? x + row * N + f : x, ok ? 16 : 0);
      }
    } else {
      for (int e = lane; e < ROWS * NP; e += 32) {
        const int r = e / NP, f = e - r * NP;
        const long long row = r0 + r;
        const bool ok = row < B && f < N;
        cp_async4(dst + r * XS + f, ok ? x + row * N + f : x, ok ? 4 : 0);
      }
    }
  };

  // the first tasks' x is on its way while M3 is staged
  for (int j = 0; j < M3T_RING - 1; ++j) {
    if (j < ntask) stage_task(j);
    cp_async_commit();
  }
  // colsum(M3[0]) of column c, n ascending: the loads of column tid's
  // first 16 rows go out first, in flight with the fragments' below
  float cv[16];
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    cv[u] = tid < K && u < N ? m3[(size_t)u * K + tid] : 0.f;
  }
  // fragment e = ((d-1) S + s) NTP + n-tile) 32 + lane: {M3[d][f][c],
  // M3[d][f+1][c]}, f = 8s + 2 (lane & 3), c = 8 n-tile + lane / 4; four a
  // thread at once, so their loads are in flight together
  const int nfrag = D * S * NTP * 32;
  for (int e0 = tid; e0 < nfrag; e0 += 4 * M3T_THREADS) {
    float2 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * M3T_THREADS;
      const int ln = e & 31, rest = e >> 5;
      const int nt = rest % NTP, ks = rest / NTP;
      const int d = 1 + ks / S, s = ks - (ks / S) * S;
      const int c = nt * 8 + (ln >> 2), f = 8 * s + 2 * (ln & 3);
      const float* md = m3 + ((size_t)d * N + f) * K + c;
      const bool ok = e < nfrag && c < K;
      v[u] = make_float2(ok && f < N ? md[0] : 0.f,
                         ok && f + 1 < N ? md[K] : 0.f);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (e0 + u * M3T_THREADS < nfrag) {
        bf[e0 + u * M3T_THREADS] = b_frag<false>(v[u]);
      }
    }
  }
  for (int c = tid; c < 8 * NTP; c += M3T_THREADS) {
    float sum = 0.f;
    if (c == tid) {
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        if (u < N) sum += cv[u];
      }
    }
    for (int n = c == tid ? 16 : 0; n < N && c < K; ++n) {
      sum += m3[(size_t)n * K + c];
    }
    csum[c] = sum;
  }
  __syncthreads();

  for (int j = 0; j < ntask; ++j) {
    if (j + M3T_RING - 1 < ntask) stage_task(j + M3T_RING - 1);
    cp_async_commit();
    cp_async_wait<M3T_RING - 1>();
    __syncwarp();  // the warp's copies of task j are in
    const long long tau = wid + (long long)j * nw;
    const int ng = (int)(tau % NG);
    const long long r0 = tau / NG * ROWS;
    const float* xs = ring + (j % M3T_RING) * stage;

    float acc[SETS][MT][NTW][4];
#pragma unroll
    for (int a = 0; a < SETS; ++a)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NTW; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[a][m][n][q] = 0.f;

#pragma unroll
    for (int s = 0; s < (ST ? ST : S); ++s) {
      // T_1 = x of this thread's A slots {row g, row g+8} x {8s+2t, +1}
      float cur[MT][4], prv[MT][4], two[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float2 lo = *reinterpret_cast<const float2*>(
            xs + (m * 16 + g8) * XS + 8 * s + 2 * t4);
        const float2 hi = *reinterpret_cast<const float2*>(
            xs + (m * 16 + g8 + 8) * XS + 8 * s + 2 * t4);
        cur[m][0] = lo.x;
        cur[m][1] = hi.x;
        cur[m][2] = lo.y;
        cur[m][3] = hi.y;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          prv[m][q] = 1.f;
          two[m][q] = 2.f * cur[m][q];
        }
      }
      const float4* bs = bf + ((size_t)s * NTP + ng * NTW) * 32 + lane;
#pragma unroll
      for (int d = 0; d < (DT ? DT : D); ++d) {
        float2 a[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          a_frag<false>(a[m], cur[m][0], cur[m][1], cur[m][2], cur[m][3]);
        }
#pragma unroll
        for (int n = 0; n < NTW; ++n) {
          const float4 b = bs[((size_t)d * S * NTP + n) * 32];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma_3x<false, false>(acc[0][m][n], acc[SETS > 1 ? 1 : 0][m][n],
                                 acc[SETS - 1][m][n], a[m], b);
          }
        }
        // T_{d+2} = 2x T_{d+1} - T_d
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float nx = fmaf(two[m][q], cur[m][q], -prv[m][q]);
            prv[m][q] = cur[m][q];
            cur[m][q] = nx;
          }
      }
    }

    // out = colsum(M3[0]) + the products, from the C fragments
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const int c0 = (ng * NTW + n) * 8 + 2 * t4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long row = r0 + m * 16 + g8 + 8 * half;
          const int q = 2 * half;
          const float v0 =
              csum[c0] + acc_total<SETS>(acc[0][m][n][q],
                                         acc[SETS > 1 ? 1 : 0][m][n][q],
                                         acc[SETS - 1][m][n][q]);
          const float v1 =
              csum[c0 + 1] + acc_total<SETS>(acc[0][m][n][q + 1],
                                             acc[SETS > 1 ? 1 : 0][m][n][q + 1],
                                             acc[SETS - 1][m][n][q + 1]);
          if (row < B && c0 < K) {
            float* o = out + row * K + c0;
            if (ovec) {  // K even, out 8-byte aligned
              *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
            } else {
              o[0] = v0;
              if (c0 + 1 < K) o[1] = v1;
            }
          }
        }
      }
    __syncwarp();  // every lane is done with the stage before it refills
  }
}

// -- K13 and K14 ---------------------------------------------------------------

// K13: the block barrier its warps reach at different places once M3^T
// is staged (barrier 9, as the row splits take 1-8; the form without
// .aligned, which allows that)
__device__ __forceinline__ void staged_barrier() {
  asm volatile("barrier.sync 9;\n" ::: "memory");
}

// The backward's warps, K14's (DX false) and K13's (DX true), one body.  DG:
// degrees a warp at most (its dM^T registers), ONE: one group of exactly
// DG degrees (the headline's 7; else the degrees are checked at run time);
// S feature groups of 8, MG m16-tiles of K, DGN degree groups of DPG, WR
// row splits a group.  K14 deals the groups to blocks of 8, (mg, h, dg)
// with dg innermost; K13 deals them (h, mg, dg) so that a block holds
// whole feature groups, the P = MG DGN groups whose dx partials add up
// (GPB = 8 / P feature groups of them a block).  Each group's dM is the
// same computation on both: K13's dM partials are K14's bits in the same
// block layout.
template <int DG, bool ONE, bool DX>
__device__ __forceinline__ void m3_bwd_tc_body(
    const float* __restrict__ x, const float* __restrict__ g,
    const float* __restrict__ m3, float* __restrict__ dx,
    float* __restrict__ part, long long B, int N, int dp1, int K, int rows,
    int S, int MG, int DGN, int DPG, int WR, int xvec, int gvec, int dvec) {
  constexpr int STAGE = M3T_CHUNK * (8 + M3T_GS);  // x [32][8], g [32][GS]
  constexpr int NA = 4 * (DG + 1);                 // dM^T registers a lane
  // floats of the 8 rings, or of the row splits' sums that reuse them
  constexpr int RINGS = 8 * M3T_RING * STAGE > 8 * 32 * 4 * (M3T_DPG + 1)
                            ? 8 * M3T_RING * STAGE
                            : 8 * 32 * 4 * (M3T_DPG + 1);
  static_assert(DG <= M3T_DPG, "a warp holds at most M3T_DPG degrees");
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  // warp -> (group gl of the block's WG, row split wr); group gamma ->
  // (m-tile mg of K, features 8 h .., degrees d_lo .. d_lo + nd)
  const int groups = MG * S * DGN;
  const int P = MG * DGN;  // K13: the groups of one feature group
  const int GPB = DX ? 8 / P * P : 8;
  const int WG = groups < GPB ? groups : GPB;
  const int gl = warp % WG, wr = warp / WG;
  const int gamma = blockIdx.y * GPB + gl;
  const bool live = wr < WR && gamma < groups;
  const int dg = gamma % DGN;
  const int h = DX ? gamma / P : gamma / DGN % S;
  const int mg = DX ? gamma / DGN % MG : gamma / (DGN * S);
  const int d_lo = 1 + dg * DPG;
  int nd = dp1 - d_lo < DPG ? dp1 - d_lo : DPG;
  if (!live || nd < 0) nd = 0;
  const bool do0 = live && h == 0 && dg == 0;  // dM[0] = colsum(g)
  const int f0 = 8 * h, k0 = 16 * mg;
  const long long r_begin = (long long)blockIdx.x * rows;
  const long long r_end = B < r_begin + rows ? B : r_begin + rows;
  const int nch = (int)((r_end - r_begin + M3T_CHUNK - 1) / M3T_CHUNK);
  const int nmine = live && nch > wr ? (nch - wr + WR - 1) / WR : 0;
  float* ring = smem + (size_t)warp * M3T_RING * STAGE;

  // chunk wr + j WR of the block's rows: x [32][features f0 .. +8] and g
  // [32][columns k0 .. +16] into stage j
  auto stage_chunk = [&](int j) {
    const long long rc = r_begin + (long long)(wr + j * WR) * M3T_CHUNK;
    float* xs = ring + (j % M3T_RING) * STAGE;
    float* gs = xs + M3T_CHUNK * 8;
    if (xvec) {  // N % 4 == 0, x 16-byte aligned
      for (int e = lane; e < M3T_CHUNK * 2; e += 32) {
        const int r = e >> 1, f = (e & 1) * 4;
        const long long row = rc + r;
        const bool ok = row < r_end && f0 + f < N;
        cp_async16(xs + r * 8 + f, ok ? x + row * N + f0 + f : x,
                   ok ? 16 : 0);
      }
    } else {
      for (int e = lane; e < M3T_CHUNK * 8; e += 32) {
        const int r = e >> 3, f = e & 7;
        const long long row = rc + r;
        const bool ok = row < r_end && f0 + f < N;
        cp_async4(xs + r * 8 + f, ok ? x + row * N + f0 + f : x, ok ? 4 : 0);
      }
    }
    if (gvec) {  // K % 4 == 0, g 16-byte aligned
      for (int e = lane; e < M3T_CHUNK * 4; e += 32) {
        const int r = e >> 2, c = (e & 3) * 4;
        const long long row = rc + r;
        const bool ok = row < r_end && k0 + c < K;
        cp_async16_l1(gs + r * M3T_GS + c, ok ? g + row * K + k0 + c : g,
                   ok ? 16 : 0);
      }
    } else {
      for (int e = lane; e < M3T_CHUNK * 16; e += 32) {
        const int r = e >> 4, c = e & 15;
        const long long row = rc + r;
        const bool ok = row < r_end && k0 + c < K;
        cp_async4(gs + r * M3T_GS + c, ok ? g + row * K + k0 + c : g,
                  ok ? 4 : 0);
      }
    }
  };

  float acc[DG][4], acc0[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    acc0[q] = 0.f;
#pragma unroll
    for (int j = 0; j < DG; ++j) acc[j][q] = 0.f;
  }
  for (int j = 0; j < M3T_RING - 1; ++j) {
    if (j < nmine) stage_chunk(j);
    cp_async_commit();
  }

  // K13: M3[d]^T's B fragments of the block's groups, {hi, lo}, staged
  // once while the first chunks are on their way: fragment ((gl DPG + jd)
  // 2 + ks) 32 + lane = {M3[d][f][c], M3[d][f][c + 4]}, d = d_lo + jd, f =
  // 8 h + lane / 4, c = 16 mg + 8 ks + (lane & 3); zero past N, K and D.
  // A warp waits for them (staged_barrier) before its first dx, or after
  // the loop where it has no chunk: the first chunk's dM runs meanwhile.
  // Then each warp's dx partials [2 buffers][8 warps][32 rows][8
  // features] where P > 1.
  const float4* bfr = reinterpret_cast<const float4*>(smem + RINGS);
  float* slots = smem + RINGS + (size_t)4 * WG * DPG * 2 * 32;
  if (DX) {
    // eight fragments a thread at once, so their loads are in flight
    // together
    float4* dst = reinterpret_cast<float4*>(smem + RINGS);
    const int nfr = WG * DPG * 2 * 32;
    for (int e0 = tid; e0 < nfr; e0 += 8 * M3T_THREADS) {
      float2 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * M3T_THREADS;
        const int ln = e & 31, ks = (e >> 5) & 1, r = e >> 6;
        const int jd = r % DPG, gm = blockIdx.y * GPB + r / DPG;
        const int d = 1 + gm % DGN * DPG + jd;
        const int f = 8 * (gm / P) + (ln >> 2);
        const int c = 16 * (gm / DGN % MG) + 8 * ks + (ln & 3);
        v[u] = make_float2(0.f, 0.f);
        if (e < nfr && gm < groups && d < dp1 && f < N) {
          const float* md = m3 + ((size_t)d * N + f) * K;
          v[u] = make_float2(c < K ? md[c] : 0.f,
                             c + 4 < K ? md[c + 4] : 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (e0 + u * M3T_THREADS < nfr) {
          dst[e0 + u * M3T_THREADS] = b_frag<false>(v[u]);
        }
      }
    }
  }
  // K13: the warps of this row split, which meet at named barrier 1 + wr
  // where P > 1 (the block's last feature groups may be fewer)
  const int in_blk = groups - (int)blockIdx.y * GPB;
  const int nsplit = in_blk < WG ? in_blk : WG;

  for (int j = 0; j < nmine; ++j) {
    if (j + M3T_RING - 1 < nmine) stage_chunk(j + M3T_RING - 1);
    cp_async_commit();
    cp_async_wait<M3T_RING - 1>();
    __syncwarp();  // the warp's copies of chunk j are in
    const float* xs = ring + (j % M3T_RING) * STAGE;
    const float* gs = xs + M3T_CHUNK * 8;
#pragma unroll
    for (int kk = 0; kk < M3T_CHUNK; kk += 8) {
      const int r = kk + t4;
      // A = g^T: m = column k0 + g (+8), k = row r (+4)
      const float* ga = gs + r * M3T_GS + g8;
      float2 a[4];
      a_frag<false>(a, ga[0], ga[8], ga[4 * M3T_GS], ga[4 * M3T_GS + 8]);
      if (do0) {
        mma_3x<false, true>(acc0, acc0, acc0, a,
                            make_float4(1.f, 1.f, 0.f, 0.f));
      }
      // B = T_d(x[rows r, r+4][feature f0 + g]), from T_1 = x
      float c0 = xs[r * 8 + g8], c1 = xs[(r + 4) * 8 + g8];
      const float w0 = 2.f * c0, w1 = 2.f * c1;
      float p0 = 1.f, p1 = 1.f;
      for (int d = 1; !ONE && d < d_lo; ++d) {
        const float n0 = fmaf(w0, c0, -p0), n1 = fmaf(w1, c1, -p1);
        p0 = c0;
        p1 = c1;
        c0 = n0;
        c1 = n1;
      }
#pragma unroll
      for (int jd = 0; jd < DG; ++jd) {
        if (ONE || jd < nd) {
          mma_3x<false, false>(acc[jd], acc[jd], acc[jd], a,
                               b_frag<false>(make_float2(c0, c1)));
          const float n0 = fmaf(w0, c0, -p0), n1 = fmaf(w1, c1, -p1);
          p0 = c0;
          p1 = c1;
          c0 = n0;
          c1 = n1;
        }
      }
    }

    if (DX && j == 0) staged_barrier();
    if (DX) {
      // dx of the chunk's rows x features f0 .. +8, from this group's
      // columns and degrees: per m16-tile of rows, C_d = g @ M3[d]^T (A =
      // g: rows g, g+8 x columns t, t+4, split once for every degree),
      // then dx += d U_{d-1}(x) C_d in the C fragment's places (rows g,
      // g+8 x features 2t, 2t+1), d ascending
      const long long rc = r_begin + (long long)(wr + j * WR) * M3T_CHUNK;
      float* slot = slots + ((j & 1) * 8 + warp) * (M3T_CHUNK * 8);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        float2 a[2][4];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const float* gr = gs + (m * 16 + g8) * M3T_GS + 8 * ks + t4;
          a_frag<false>(a[ks], gr[0], gr[8 * M3T_GS], gr[4],
                        gr[8 * M3T_GS + 4]);
        }
        const float2 xa = *reinterpret_cast<const float2*>(
            xs + (m * 16 + g8) * 8 + 2 * t4);
        const float2 xb = *reinterpret_cast<const float2*>(
            xs + (m * 16 + g8 + 8) * 8 + 2 * t4);
        const float xv[4] = {xa.x, xa.y, xb.x, xb.y};
        float um[4], uc[4], dt[4];  // U_{d-2}, U_{d-1}, dx
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          um[q] = 0.f;
          uc[q] = 1.f;
          dt[q] = 0.f;
        }
        for (int d = 1; !ONE && d < d_lo; ++d) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float un = fmaf(2.f * xv[q], uc[q], -um[q]);
            um[q] = uc[q];
            uc[q] = un;
          }
        }
        const float4* bq = bfr + (size_t)gl * DPG * 64 + lane;
#pragma unroll
        for (int jd = 0; jd < DG; ++jd) {
          if (ONE || jd < nd) {
            float cd[4] = {0.f, 0.f, 0.f, 0.f};
            mma_3x<false, false>(cd, cd, cd, a[0], bq[jd * 64]);
            mma_3x<false, false>(cd, cd, cd, a[1], bq[jd * 64 + 32]);
            const float dd = (float)(d_lo + jd);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              dt[q] = fmaf(dd * uc[q], cd[q], dt[q]);
              const float un = fmaf(2.f * xv[q], uc[q], -um[q]);
              um[q] = uc[q];
              uc[q] = un;
            }
          }
        }
        if (P == 1) {  // the whole sum: out from the C fragment
          const int f = f0 + 2 * t4;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const long long row = rc + m * 16 + g8 + 8 * half;
            if (row < r_end && f < N) {
              float* o = dx + row * N + f;
              if (dvec) {  // N even, dx 8-byte aligned
                *reinterpret_cast<float2*>(o) =
                    make_float2(dt[2 * half], dt[2 * half + 1]);
              } else {
                o[0] = dt[2 * half];
                if (f + 1 < N) o[1] = dt[2 * half + 1];
              }
            }
          }
        } else {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            *reinterpret_cast<float2*>(
                slot + (m * 16 + g8 + 8 * half) * 8 + 2 * t4) =
                make_float2(dt[2 * half], dt[2 * half + 1]);
          }
        }
      }
      if (P > 1) {
        // the P partials of each (row, feature) added in group order (mg,
        // then dg), the P warps of the feature group sharing the 256 sums;
        // two buffers, so one barrier a chunk
        asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wr), "r"(32 * nsplit)
                     : "memory");
        const int p = gl % P;
        const float* first = slots + ((j & 1) * 8 + warp - p) *
                                         (M3T_CHUNK * 8);
        for (int e = p * 32 + lane; e < M3T_CHUNK * 8; e += 32 * P) {
          float sum = first[e];
          for (int q = 1; q < P; ++q) sum += first[q * (M3T_CHUNK * 8) + e];
          const long long row = rc + (e >> 3);
          const int f = f0 + (e & 7);
          if (row < r_end && f < N) dx[row * N + f] = sum;
        }
      }
    }
    __syncwarp();  // every lane is done with the stage before it refills
  }
  if (DX && nmine == 0) staged_barrier();

  // the row splits' dM^T added in split order through shared memory (the
  // rings' area); each element of the block's partial written once
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring
  float* red = smem;  // [8 warps][NA][32 lanes]
  if (live && wr > 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int j = 0; j < DG; ++j) red[(warp * NA + 4 * j + q) * 32 + lane] = acc[j][q];
      red[(warp * NA + 4 * DG + q) * 32 + lane] = acc0[q];
    }
  }
  __syncthreads();
  if (live && wr == 0) {
    for (int w = 1; w < WR; ++w) {
      const float* o = red + (gl + w * WG) * NA * 32 + lane;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int j = 0; j < DG; ++j) acc[j][q] += o[(4 * j + q) * 32];
        acc0[q] += o[(4 * DG + q) * 32];
      }
    }
    float* pb = part + (size_t)blockIdx.x * dp1 * N * K;
    // element q of degree d: dM[d][f0 + 2t + (q & 1)][k0 + g + 8 (q >> 1)]
#pragma unroll
    for (int j = 0; j < DG; ++j) {
      if (j < nd) {
        const int d = d_lo + j;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = f0 + 2 * t4 + (q & 1), k = k0 + g8 + 8 * (q >> 1);
          if (n < N && k < K) pb[((size_t)d * N + n) * K + k] = acc[j][q];
        }
      }
    }
    if (do0) {  // colsum(g), the same in every column: features t, t+4, ..
#pragma unroll
      for (int q = 0; q < 4; q += 2) {
        const int k = k0 + g8 + 8 * (q >> 1);
        if (k < K) {
          for (int n = t4; n < N; n += 4) pb[(size_t)n * K + k] = acc0[q];
        }
      }
    }
  }
}

// K14: the dM partials alone
template <int DG, bool ONE>
__global__ void __launch_bounds__(M3T_THREADS, 2)
m3_bwd_dw_kernel_tc(const float* __restrict__ x, const float* __restrict__ g,
                    float* __restrict__ part, long long B, int N, int dp1,
                    int K, int rows, int S, int MG, int DGN, int DPG, int WR,
                    int xvec, int gvec) {
  m3_bwd_tc_body<DG, ONE, false>(x, g, nullptr, nullptr, part, B, N, dp1, K,
                                 rows, S, MG, DGN, DPG, WR, xvec, gvec, 0);
}

// K13: K14's dM partials and dx.  BLKS: the blocks an SM holds, 2, or 1
// where the block's shared memory leaves room for no second one: then the
// registers are not capped at 128, which measured 3.5 us faster at N 16 /
// K 128 (tools/m3_vs_old.py's ablations) and cost nothing.
template <int DG, bool ONE, int BLKS>
__global__ void __launch_bounds__(M3T_THREADS, BLKS)
m3_bwd_kernel_tc(const float* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ m3, float* __restrict__ dx,
                 float* __restrict__ part, long long B, int N, int dp1, int K,
                 int rows, int S, int MG, int DGN, int DPG, int WR, int xvec,
                 int gvec, int dvec) {
  m3_bwd_tc_body<DG, ONE, true>(x, g, m3, dx, part, B, N, dp1, K, rows, S,
                                MG, DGN, DPG, WR, xvec, gvec, dvec);
}

template <typename F>
cudaError_t allow_smem(F kernel, long long bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int MT, int NTW, int DT, int ST, int NGT>
cudaError_t launch_fwd(const float* x, const float* m3, float* out,
                       long long B, int N, int dp1, int K,
                       const qkan::M3TcPlan& p, cudaStream_t s) {
  auto kernel = m3_fwd_kernel_tc<MT, NTW, DT, ST, NGT>;
  cudaError_t err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return err;
  const long long tasks = (B + 16 * MT - 1) / (16 * MT) * p.ng;
  long long blocks = (tasks + 7) / 8;
  if (blocks > M3T_GRID) blocks = M3T_GRID;
  const int xvec =
      N % 4 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  const int ovec =
      K % 2 == 0 && reinterpret_cast<std::uintptr_t>(out) % 8 == 0;
  kernel<<<(int)blocks, M3T_THREADS, (size_t)p.smem, s>>>(
      x, m3, out, B, N, dp1, K, p.s, p.xs, p.ng, tasks, xvec, ovec);
  return cudaGetLastError();
}

// K13 (DX) or K14 in the block layout (rows a block, nblk blocks) of the
// CUDA-core kernel
template <int DG, bool ONE, bool DX, int BLKS = 2>
cudaError_t launch_bwd(const float* x, const float* g, const float* m3,
                       float* dx, float* part, long long B, int N, int dp1,
                       int K, int rows, int nblk, const qkan::M3TcPlan& p,
                       cudaStream_t s) {
  const int xvec =
      N % 4 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  const int gvec =
      K % 4 == 0 && reinterpret_cast<std::uintptr_t>(g) % 16 == 0;
  const dim3 grid(nblk, p.gy);
  if constexpr (DX) {
    auto kernel = m3_bwd_kernel_tc<DG, ONE, BLKS>;
    const cudaError_t err = allow_smem(kernel, p.smem);
    if (err != cudaSuccess) return err;
    const int dvec =
        N % 2 == 0 && reinterpret_cast<std::uintptr_t>(dx) % 8 == 0;
    kernel<<<grid, M3T_THREADS, (size_t)p.smem, s>>>(
        x, g, m3, dx, part, B, N, dp1, K, rows, p.s, p.mg, p.dgn, p.dpg,
        p.wr, xvec, gvec, dvec);
  } else {
    auto kernel = m3_bwd_dw_kernel_tc<DG, ONE>;
    const cudaError_t err = allow_smem(kernel, p.smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, M3T_THREADS, (size_t)p.smem, s>>>(
        x, g, part, B, N, dp1, K, rows, p.s, p.mg, p.dgn, p.dpg, p.wr, xvec,
        gvec);
  }
  return cudaGetLastError();
}

template <bool DX>
cudaError_t run_bwd_tc(const float* x, const float* g, const float* m3,
                       float* dx, float* part, long long B, int N, int dp1,
                       int K, int rows, int nblk, const qkan::M3TcPlan& p,
                       cudaStream_t stream) {
#define QKAN_M3B(DG, ONE, BLKS)                                          \
  return launch_bwd<DG, ONE, DX, BLKS>(x, g, m3, dx, part, B, N, dp1, K, \
                                       rows, nblk, p, stream)
  // K13 where one block fills an SM's shared memory (only past 4 degrees
  // a group: at 4, 8 groups' M3^T, the rings and the dx partials take 112
  // KB) runs with its registers uncapped
  const bool one = DX && 2 * (p.smem + qkan::M3T_SMEM_RESERVED) >
                             qkan::M3T_SMEM_SM;
  // the fast path: the headline's 7 degrees in one group
  if (dp1 == 8 && p.dgn == 1) {
    if (one) QKAN_M3B(7, true, 1);
    QKAN_M3B(7, true, 2);
  }
  if (p.dpg <= 1) QKAN_M3B(1, false, 2);
  if (p.dpg <= 2) QKAN_M3B(2, false, 2);
  if (p.dpg <= 4) QKAN_M3B(4, false, 2);
  if (one) QKAN_M3B(8, false, 1);
  QKAN_M3B(8, false, 2);
#undef QKAN_M3B
}

}  // namespace

cudaError_t qkan::m3_fwd_tc(const float* x, const float* m3, float* out,
                            long long B, int N, int dp1, int K,
                            const M3TcPlan& p, cudaStream_t stream) {
#define QKAN_M3F(MT, NTW, DT, ST, NGT)                                    \
  return launch_fwd<MT, NTW, DT, ST, NGT>(x, m3, out, B, N, dp1, K, p, \
                                          stream)
  // the fast paths: the headline's widths (N 9-16, dp1 8) at K 9-16 and
  // at K 65-128
  if (dp1 == 8 && p.s == 2 && p.ntw == 2 && p.ng == 1) {
    QKAN_M3F(2, 2, 7, 2, 1);
  }
  if (dp1 == 8 && p.s == 2 && p.ntw == 8 && p.ng == 2) {
    QKAN_M3F(2, 8, 7, 2, 2);
  }
  switch (p.ntw) {
    case 1: QKAN_M3F(4, 1, 0, 0, 0);
    case 2: QKAN_M3F(2, 2, 0, 0, 0);
    case 4: QKAN_M3F(2, 4, 0, 0, 0);
    default: QKAN_M3F(2, 8, 0, 0, 0);
  }
#undef QKAN_M3F
}

cudaError_t qkan::m3_bwd_dw_tc(const float* x, const float* g, float* part,
                               long long B, int N, int dp1, int K, int rows,
                               int nblk, const M3TcPlan& p,
                               cudaStream_t stream) {
  return run_bwd_tc<false>(x, g, nullptr, nullptr, part, B, N, dp1, K, rows,
                           nblk, p, stream);
}

cudaError_t qkan::m3_bwd_tc(const float* x, const float* g, const float* m3,
                            float* dx, float* part, long long B, int N,
                            int dp1, int K, int rows, int nblk,
                            const M3TcPlan& p, cudaStream_t stream) {
  return run_bwd_tc<true>(x, g, m3, dx, part, B, N, dp1, K, rows, nblk, p,
                          stream);
}
