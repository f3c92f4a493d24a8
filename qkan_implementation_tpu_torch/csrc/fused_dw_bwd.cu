// Fused FixedKAN layer backward for Hopper (sm_90a), and the fused
// single-layer train step built on its workspace (entry qkan_fused_step,
// described where it starts below).  The backward's entries launch one of
// two kernels, chosen by the sizes, x's dtype and the mode alone
// (bwd_tc_plan in fused_bwd_tc.cuh, C entry qkan_fused_bwd_tensor_cores):
// fused_dw_bwd_kernel_tc (fused_dw_bwd_tc.cu: 3xTF32 on the tensor cores,
// features split over the grid, one launch) at an f32 x in 'high' /
// 'default' with dp1 >= 2, T <= 64 and few enough degrees (every layer of
// the main path), and the CUDA-core kernel below for the rest (a bf16 x,
// 'bf16', dp1 = 1, T > 64, more degrees).  -DQKAN_BWD_TC=0 sends every shape to the CUDA-core kernel
// (tools/bwd_vs_old.py builds it so).
//
// Replaces two TPU kernels of qkan_implementation_tpu/ops/fused_layer.py:
// _bwd_kernel_degreewise (entry qkan_fused_dw_bwd, the backward of
// kan_layer_fused_dw) and _bwd_kernel (entry qkan_fused_bwd, the backward
// of the v1 kan_layer_fused).  With t = tanh(x) (or raw x) and the output
// cotangent g [B, T] f32:
//
//     dW_0[i, c] = sum_b g[b, c]                  (T_0 = 1: no products)
//     dW_d       = T_d(t)^T @ g                   (d >= 1, over the batch)
//     dx         = (1 - t^2) * sum_{d>=1} d U_{d-1}(t) * (g @ W_d^T)
//
// U_{d-1} runs by the same 2t recurrence as T_d, with U_{-1} = 0, U_0 = 1.
// dx comes back in x's dtype, dW in f32.  The two TPU kernels compute the
// same function; where x is bf16 they round at the same points too (the
// v1 kernel keeps g and w2 in f32, as the degree-wise one does outside
// 'bf16'), so the v1 entry is this kernel without the 'bf16' mode.
//
// What bounds it on an H100: at the flagship layer 0 (B=4096, in=784,
// dp1=6, T=10) one call reads x (12.8 MB) and writes dx (12.8 MB) and does
// about 0.64 GFLOP of FP32 FMAs (two [B, in] x [in, T] products for each
// of 5 degrees, plus the recurrences): about 8 us of bytes at 3.35 TB/s
// against 10 us of FP32 work at 67 TFLOP/s.  At the training batch of 64
// it is under 1 us, and launch overhead sets the pace.
//
// The CUDA-core kernel.  The TPU grid runs in order, so its dW
// accumulator carries from one step to the next; CUDA blocks run in
// parallel.  Here a block owns
// `rows` batch rows and up to 128 input features, one thread each.  A
// thread keeps its feature's W_d row and its dW_d accumulators for a chunk
// of DC degrees in registers (DC * TP of each, TP = T padded).  The block
// stages g and x for 32 rows at a time in shared memory (x with 32
// independent loads a thread, coalesced along `in`, so their latency
// overlaps), reads g as a broadcast, runs the T and U recurrences in
// registers and writes dx[r, i] coalesced along `in`.  The g.W_d dot is
// split into four partial sums to shorten its dependency chain.  Each
// block writes its dW partial to a workspace; the fixed-order pass of
// partial_sum.cu sums the partials over row blocks (launched by the entry
// itself when given dw, or by qkan_fused_bwd_partial_sum).  No float
// atomics, so a run gives the same bits every time.  Rows per block are
// chosen so that the partials stay under 4 MB.  Any dp1 and T: past DC
// degrees the degree chunks run as successive launches, and past 64
// outputs the columns run in slices of COL_SLICE, each slice's chunks in
// turn.  The dW slices are disjoint; dx is linear in g's columns, so the
// launches carry dt through a [B, in] f32 workspace and add to it in launch
// order (the last one writes dx).  want_dx = 0 skips dx (an input that
// needs no gradient).
//
// Precision.  round_bf16=0: FP32 products and sums.  round_bf16=1
// (degree-wise 'bf16'): g, W_d and T_d are rounded to bf16 before each
// product, sums in f32; colsum(g) stays f32.  With a bf16 x, tanh, the
// recurrences, d * U_{d-1} and (1 - t*t) round to bf16 one op at a time,
// as torch does for a bf16 tensor; only the products with the f32 sums
// widen to f32.

#include <type_traits>

#include "fused_bwd_tc.cuh"
#include "qkan_common.cuh"
#include "tc_common.cuh"

namespace {

using qkan::bf16_round;

constexpr int MAX_FEAT = 128;  // threads of a block: one input feature each
constexpr int GROWS = 32;      // rows of g staged in shared memory at a time
constexpr size_t PARTIAL_BUDGET = size_t(4) << 20;  // bytes of dW partials
constexpr int COL_SLICE = 64;  // output columns a backward launch takes

// degrees a thread holds in registers at once: DC * TP <= 64
__host__ __device__ constexpr int degree_chunk(int tp) {
  return tp >= 64 ? 1 : 64 / tp;
}

// launches of the per-block kernel for one column slice: one per chunk of
// dc degrees of the dp1 - 1 that have products (one when dp1 = 1)
int degree_chunks(int dp1, int dc) {
  return dp1 > 1 ? (dp1 - 1 + dc - 1) / dc : 1;
}

// column slices of a backward: COL_SLICE columns each, the last the rest
int col_slices(int T) { return (T + COL_SLICE - 1) / COL_SLICE; }

// launches of the per-block kernel in one backward call: each column
// slice's degree chunks, at the slice's padded width
int bwd_launches(int dp1, int T) {
  int n = 0;
  for (int c0 = 0; c0 < T; c0 += COL_SLICE) {
    const int w = T - c0 < COL_SLICE ? T - c0 : COL_SLICE;
    n += degree_chunks(dp1, degree_chunk(qkan::pad_t(w)));
  }
  return n;
}

struct Layout {
  int rows;            // batch rows per block, a multiple of GROWS
  int nrb;             // row blocks
  size_t part_floats;  // dW partials [nrb][dp1-1][in][T]
  size_t gpart_floats; // colsum(g) partials [nrb][T]
  size_t dt_floats;    // dt carried across degree chunks [B][in]
};

Layout layout(int B, int in, int dp1, int T, int want_dx,
              size_t budget = PARTIAL_BUDGET) {
  Layout L;
  const size_t per_rb = (size_t)(dp1 - 1) * in * T * sizeof(float);
  size_t max_nrb = per_rb ? budget / per_rb : (size_t)B;
  if (max_nrb < 1) max_nrb = 1;
  size_t rows = ((size_t)B + max_nrb - 1) / max_nrb;
  rows = (rows + GROWS - 1) / GROWS * GROWS;
  L.rows = (int)rows;
  L.nrb = (int)(((size_t)B + rows - 1) / rows);
  L.part_floats = (size_t)L.nrb * (dp1 - 1) * in * T;
  L.gpart_floats = (size_t)L.nrb * T;
  L.dt_floats = (want_dx && bwd_launches(dp1, T) > 1) ? (size_t)B * in : 0;
  return L;
}

// The layout of a backward on its route: the tensor-core kernel's row
// blocks (bwd_tc_rows) where bwd_tc_plan takes the sizes, else layout().
// Either way the workspace holds dW partials [nrb][dp1-1][in][T], then
// colsum(g) partials [nrb][T], then (the CUDA-core kernel past one launch)
// the carried dt.
Layout bwd_layout(int B, int in, int dp1, int T, int want_dx, int x_is_bf16,
                  int round_bf16) {
  const qkan::BwdTcPlan p = qkan::bwd_tc_plan(in, dp1, T, x_is_bf16,
                                              round_bf16);
  if (!p.ok) return layout(B, in, dp1, T, want_dx);
  const qkan::BwdTcRows r = qkan::bwd_tc_rows(B, in, dp1, T, p);
  Layout L;
  L.rows = r.rows;
  L.nrb = r.nrb;
  L.part_floats = (size_t)L.nrb * (dp1 - 1) * in * T;
  L.gpart_floats = (size_t)L.nrb * T;
  L.dt_floats = 0;
  return L;
}

// One degree chunk [d_begin, d_begin + DC) of the column slice [c0, c0 +
// T) over one block's rows; ldt is the full width of w2, g and the
// partials.  first: the launch that starts dt; last: the launch that
// writes dx; csum_chunk: the slice's chunk that takes colsum(g).
template <typename XT, int TP, int DC, bool ROUND>
__global__ void __launch_bounds__(MAX_FEAT)
fused_dw_bwd_kernel(const XT* __restrict__ x, const float* __restrict__ w2,
                    const float* __restrict__ g, XT* __restrict__ dx,
                    float* __restrict__ dt_acc, float* __restrict__ part,
                    float* __restrict__ gpart, int B, int in, int dp1, int T,
                    int ldt, int c0, int rows, int d_begin, int apply_tanh,
                    int want_dx, int first, int last, int csum_chunk) {
  constexpr bool XBF16 = !std::is_same<XT, float>::value;
  __shared__ __align__(16) float g_s[GROWS * TP];  // g as given (f32)
  __shared__ float x_s[GROWS * MAX_FEAT];          // x in f32

  const int tid = threadIdx.x;
  const int rb = blockIdx.x;
  const int i = blockIdx.y * blockDim.x + tid;
  const bool active = i < in;
  const int r_begin = rb * rows;
  const int r_end = min(B, r_begin + rows);
  const int nd = min(DC, dp1 - d_begin);  // degrees of this chunk

  float w[DC][TP];
  float acc[DC][TP];
#pragma unroll
  for (int j = 0; j < DC; ++j) {
#pragma unroll
    for (int c = 0; c < TP; ++c) {
      float v = 0.f;
      if (active && j < nd && c < T) {
        v = w2[((size_t)(d_begin + j) * in + i) * ldt + c0 + c];
        if (ROUND) v = bf16_round(v);
      }
      w[j][c] = v;
      acc[j][c] = 0.f;
    }
  }

  // dW_0 = colsum(g), unrounded: this row block's share, in row order, of
  // columns tid and tid + blockDim.x (T <= 64 <= 2 * blockDim.x)
  const bool colsum = csum_chunk && blockIdx.y == 0;
  float csum0 = 0.f, csum1 = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += GROWS) {
    const int nr = min(GROWS, r_end - r0);
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < GROWS * TP; idx += blockDim.x) {
      const int rr = idx / TP, c = idx - rr * TP;
      g_s[idx] = (rr < nr && c < T) ? g[(size_t)(r0 + rr) * ldt + c0 + c]
                                    : 0.f;
    }
#pragma unroll
    for (int rr = 0; rr < GROWS; ++rr) {
      float v = 0.f;
      if (active && rr < nr) {
        v = qkan::load_as_float(x + (size_t)(r0 + rr) * in + i);
      }
      x_s[rr * blockDim.x + tid] = v;
    }
    __syncthreads();
    if (colsum) {
      for (int rr = 0; rr < nr; ++rr) {
        if (tid < T) csum0 += g_s[rr * TP + tid];
        if (tid + (int)blockDim.x < T) {
          csum1 += g_s[rr * TP + tid + blockDim.x];
        }
      }
    }
    if (!active) continue;

    for (int rr = 0; rr < nr; ++rr) {
      const size_t off = (size_t)(r0 + rr) * in + i;
      float t = x_s[rr * blockDim.x + tid];
      if (apply_tanh) {
        t = tanhf(t);
        if (XBF16) t = bf16_round(t);
      }
      const float two_t = 2.f * t;
      float prev = 1.f, cur = t;   // T_{d-1}, T_d
      float um2 = 0.f, um1 = 1.f;  // U_{d-2}, U_{d-1}
      for (int d = 1; d < d_begin; ++d) {
        const float tn = qkan::cheb_next<XBF16>(two_t, cur, prev);
        prev = cur;
        cur = tn;
        const float un = qkan::cheb_next<XBF16>(two_t, um1, um2);
        um2 = um1;
        um1 = un;
      }
      float dt = 0.f;
      const float4* g4 = reinterpret_cast<const float4*>(g_s + rr * TP);
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        if (j < nd) {
          const float a = ROUND ? bf16_round(cur) : cur;
          float gm0 = 0.f, gm1 = 0.f, gm2 = 0.f, gm3 = 0.f;
#pragma unroll
          for (int q = 0; q < TP / 4; ++q) {
            float4 gv = g4[q];
            if (ROUND) {
              gv.x = bf16_round(gv.x);
              gv.y = bf16_round(gv.y);
              gv.z = bf16_round(gv.z);
              gv.w = bf16_round(gv.w);
            }
            acc[j][4 * q + 0] = fmaf(a, gv.x, acc[j][4 * q + 0]);
            acc[j][4 * q + 1] = fmaf(a, gv.y, acc[j][4 * q + 1]);
            acc[j][4 * q + 2] = fmaf(a, gv.z, acc[j][4 * q + 2]);
            acc[j][4 * q + 3] = fmaf(a, gv.w, acc[j][4 * q + 3]);
            gm0 = fmaf(gv.x, w[j][4 * q + 0], gm0);
            gm1 = fmaf(gv.y, w[j][4 * q + 1], gm1);
            gm2 = fmaf(gv.z, w[j][4 * q + 2], gm2);
            gm3 = fmaf(gv.w, w[j][4 * q + 3], gm3);
          }
          const float gm = (gm0 + gm1) + (gm2 + gm3);
          if (want_dx) {
            // d * U_{d-1} in x's dtype, then the f32 product and sum
            float du = __fmul_rn((float)(d_begin + j), um1);
            if (XBF16) du = bf16_round(du);
            dt = __fadd_rn(dt, __fmul_rn(du, gm));
          }
          const float tn = qkan::cheb_next<XBF16>(two_t, cur, prev);
          prev = cur;
          cur = tn;
          const float un = qkan::cheb_next<XBF16>(two_t, um1, um2);
          um2 = um1;
          um1 = un;
        }
      }
      if (want_dx) {
        if (!first) dt = __fadd_rn(dt_acc[off], dt);
        if (last) {
          float v = dt;
          if (apply_tanh) {
            float s = __fmul_rn(t, t);
            if (XBF16) s = bf16_round(s);
            s = __fsub_rn(1.f, s);
            if (XBF16) s = bf16_round(s);
            v = __fmul_rn(s, dt);
          }
          qkan::store_float(dx + off, v);
        } else {
          dt_acc[off] = dt;
        }
      }
    }
  }

  if (colsum) {
    if (tid < T) gpart[(size_t)rb * ldt + c0 + tid] = csum0;
    if (tid + (int)blockDim.x < T) {
      gpart[(size_t)rb * ldt + c0 + tid + blockDim.x] = csum1;
    }
  }
  if (!active) return;
#pragma unroll
  for (int j = 0; j < DC; ++j) {
    if (j < nd) {
      float* dst =
          part + (((size_t)rb * (dp1 - 1) + (d_begin - 1 + j)) * in + i) * ldt +
          c0;
#pragma unroll
      for (int c = 0; c < TP; ++c) {
        if (c < T) dst[c] = acc[j][c];
      }
    }
  }
}

// -- the fused single-layer train step (entry qkan_fused_step) ---------------
//
// Two kernels serve it, chosen by the shapes alone (tc_shape, below):
// fused_step_kernel_tc on the tensor cores wherever a block's registers
// hold all of dW (the headline step and narrow layers), and this one,
// the CUDA-core one, at the wide layers (the flagship's in = 784) and
// dp1 = 1.
//
// Replaces _step_kernel of qkan_implementation_tpu/ops/fused_layer.py (the
// kernel of kan_train_step_fused).  With t = tanh(x) (or raw x) and w2
// degree-major:
//
//     out  = basis(t) @ w2                  [B, T], never written out
//     err  = out ('sumsq')  |  out - y ('mse')
//     g    = g_scale * err                  2, or 2 / (B*T)
//     loss = loss_scale * sum err^2         1, or 1 / (B*T)
//     dW   = basis(t)^T @ g                 dW_0 = colsum(g), since T_0 = 1
//
// at the rounding points of the v1 pair: a bf16 x runs tanh and the
// recurrence in bf16, and the forward rounds all of w2 to bf16 (as
// _step_kernel casts w2 to the basis dtype); g and every sum stay f32.
//
// What bounds it on an H100: two contractions of 2*B*in*(dp1-1)*T flops
// each against one read of x.  At the headline step (B=262144, in=16,
// dp1=8, T=16) that is 1.88 GFLOP of FP32 FMAs (28 us at 67 TFLOP/s)
// against 16.8 MB of x (5 us): operations.  At the flagship layer 0
// (B=4096, in=784, dp1=6, T=10) 0.64 GFLOP (9.6 us) against 12.9 MB.
// The design keeps the basis, out and g on chip (the one lever over the
// K3 + K4 pair, which builds the basis twice and writes out and reads g).
//
// Schedule.  A block owns `rows` batch rows, from K2's layout() with
// want_dx = 0 under K5's own partial budget (step_layout), so the
// workspace has K2's form and the same fixed-order pass turns it into dW
// unchanged.  A block must own whole rows: g[r, :] needs
// out[r, :], which needs every feature, so features are not split across
// blocks.  The rows go in super-tiles of up to 8192 / TP rows, whose g
// sits in shared memory:
//   1. out for 32 rows at a time, as K3 computes it: lane = row, warps
//      take the features of a W chunk staged in shared memory (all of w2
//      once per block where it fits), per-warp partials summed in a fixed
//      order;
//   2. err, g and err^2 for each (row, column): g into the super-tile's
//      shared [rows][TP] tile, err^2 into a per-thread sum; rows past B
//      give 0 to both;
//   3. dW over the super-tile, as K2 does it: a thread owns (feature,
//      degree chunk) with DC x TP sums in registers, reloads x, reruns
//      tanh and the recurrence (cheaper on CUDA cores than keeping a
//      basis tile) and adds T_d(t[r, i]) g[r, c] over the rows.  Where
//      in x (degree chunks) is below the block's threads, the rows are
//      dealt to row groups whose sums are added in shared memory, in
//      order.  The block's dW partial is written at its first super-tile
//      and added to after, always by the same thread.
// The block writes colsum(g) into K2's gpart slot and its loss partial
// into an [nrb] tail of the workspace; a one-block kernel sums those in a
// fixed order.  No float atomics: a run gives the same bits every time.
// Where T or dp1 passes what one launch stages (step_cols), the kernel
// runs once a column slice [c0, c0 + T) of the width-ldt w2, y and
// partials, in order; each slice adds its loss partial to the previous
// slices' in place.

constexpr int STEP_WARPS = 8;
constexpr int STEP_THREADS = 32 * STEP_WARPS;
constexpr int STEP_G_FLOATS = 8192;            // the super-tile's g: 32 KB
constexpr int STEP_STAGE_BYTES = 96 * 1024;    // t and W chunk staging

// shared floats for the per-warp partials of step 1, reused by the row
// groups of step 3
template <int TP>
__host__ __device__ constexpr int step_red_floats() {
  return STEP_WARPS * GROWS * (TP + 1) > STEP_THREADS * degree_chunk(TP) * TP
             ? STEP_WARPS * GROWS * (TP + 1)
             : STEP_THREADS * degree_chunk(TP) * TP;
}

template <typename XT, int TP>
__global__ void __launch_bounds__(STEP_THREADS)
fused_step_kernel(const XT* __restrict__ x, const float* __restrict__ w2,
                  const float* __restrict__ y, float* __restrict__ part,
                  float* __restrict__ gpart, float* __restrict__ lpart,
                  int B, int in, int dp1, int T, int ldt, int c0, int rows,
                  int chunk, int super_rows, int apply_tanh, float g_scale) {
  constexpr bool XBF16 = !std::is_same<XT, float>::value;
  constexpr int DC = degree_chunk(TP);
  constexpr int RED = step_red_floats<TP>();
  extern __shared__ __align__(16) float smem[];
  const int ts_stride = chunk + 1;               // odd: distinct banks
  float* t_s = smem;                             // [GROWS][chunk + 1]
  float* w_s = t_s + GROWS * ts_stride;          // [dp1][chunk][TP]
  float* red_s = w_s + dp1 * chunk * TP;         // [RED]
  float* g_s = red_s + RED;                      // [super_rows][TP]
  float* csum_s = g_s + super_rows * TP;         // [TP]
  float* l_s = csum_s + TP;                      // [STEP_THREADS]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rb = blockIdx.x;
  const int r_begin = rb * rows;
  const int r_end = min(B, r_begin + rows);
  const bool w_once = chunk >= in;  // all of w2 stays staged
  const int nch = dp1 > 1 ? (dp1 - 1 + DC - 1) / DC : 0;
  const int items = in * nch;       // (feature, degree chunk) pairs
  const int rg = items >= STEP_THREADS ? 1
                 : items > 0          ? STEP_THREADS / items
                                      : 1;

  float csum = 0.f;  // colsum(W_0)[tid], the T_0 term (tid < T)
  float gsum = 0.f;  // colsum(g)[tid] over the block's rows (tid < T)
  float lsum = 0.f;  // this thread's share of sum err^2

  for (int s0 = r_begin; s0 < r_end; s0 += super_rows) {
    const int s_end = min(r_end, s0 + super_rows);
    const bool first_super = s0 == r_begin;

    // steps 1 and 2, one 32-row tile at a time
    for (int r0 = s0; r0 < s_end; r0 += GROWS) {
      const bool first_tile = r0 == r_begin;
      float acc[TP];
#pragma unroll
      for (int c = 0; c < TP; ++c) acc[c] = 0.f;
      for (int i0 = 0; i0 < in; i0 += chunk) {
        for (int idx = tid; idx < GROWS * chunk; idx += STEP_THREADS) {
          const int r = idx / chunk, k = idx - r * chunk;
          const int b = r0 + r, i = i0 + k;
          float t = 0.f;
          if (b < r_end && i < in) {
            t = qkan::load_as_float(x + (size_t)b * in + i);
            if (apply_tanh) {
              t = tanhf(t);
              if (XBF16) t = bf16_round(t);
            }
          }
          t_s[r * ts_stride + k] = t;
        }
        if (!w_once || first_tile) {
          for (int idx = tid; idx < dp1 * chunk * TP; idx += STEP_THREADS) {
            const int d = idx / (chunk * TP);
            const int rem = idx - d * chunk * TP;
            const int k = rem / TP, c = rem - k * TP;
            const int i = i0 + k;
            float w = 0.f;
            if (i < in && c < T) {
              w = w2[((size_t)d * in + i) * ldt + c0 + c];
              if (XBF16) w = bf16_round(w);
            }
            w_s[idx] = w;
          }
        }
        __syncthreads();
        if (first_tile && tid < T) {
          for (int k = 0; k < chunk; ++k) csum += w_s[k * TP + tid];
        }
        for (int k = warp; k < chunk; k += STEP_WARPS) {
          const float t = t_s[lane * ts_stride + k];
          float prev = 1.f, cur = t;
          for (int d = 1; d < dp1; ++d) {
            const float4* w4 =
                reinterpret_cast<const float4*>(w_s + (d * chunk + k) * TP);
#pragma unroll
            for (int q = 0; q < TP / 4; ++q) {
              const float4 w = w4[q];
              acc[4 * q + 0] = fmaf(cur, w.x, acc[4 * q + 0]);
              acc[4 * q + 1] = fmaf(cur, w.y, acc[4 * q + 1]);
              acc[4 * q + 2] = fmaf(cur, w.z, acc[4 * q + 2]);
              acc[4 * q + 3] = fmaf(cur, w.w, acc[4 * q + 3]);
            }
            const float nxt = qkan::cheb_next<XBF16>(2.f * t, cur, prev);
            prev = cur;
            cur = nxt;
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int c = 0; c < TP; ++c) {
        red_s[(warp * GROWS + lane) * (TP + 1) + c] = acc[c];
      }
      if (first_tile && tid < T) csum_s[tid] = csum;
      __syncthreads();
      // step 2: out in a fixed order, then err, g and err^2
      for (int idx = tid; idx < GROWS * TP; idx += STEP_THREADS) {
        const int r = idx / TP, c = idx - r * TP;
        const int b = r0 + r;
        float gv = 0.f;
        if (c < T && b < s_end) {
          float o = csum_s[c];
#pragma unroll
          for (int w = 0; w < STEP_WARPS; ++w) {
            o += red_s[(w * GROWS + r) * (TP + 1) + c];
          }
          const float e =
              y != nullptr ? o - y[(size_t)b * ldt + c0 + c] : o;
          lsum = fmaf(e, e, lsum);
          gv = g_scale * e;
        }
        g_s[(b - s0) * TP + c] = gv;
      }
      __syncthreads();
      if (tid < T) {
        for (int b = r0; b < min(s_end, r0 + GROWS); ++b) {
          gsum += g_s[(b - s0) * TP + tid];
        }
      }
    }

    // step 3: this super-tile's share of dW_d, d >= 1
    const int srows = s_end - s0;
    for (int base = 0; base < items * rg; base += STEP_THREADS) {
      const int id = base + tid;
      const bool act = id < items * rg;
      const int q = act ? id / items : 0;  // row group
      const int it = act ? id - q * items : 0;
      const int i = it % in;
      const int d0 = 1 + (it / in) * DC;
      const int nd = min(DC, dp1 - d0);
      float acc[DC][TP];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
#pragma unroll
        for (int c = 0; c < TP; ++c) acc[j][c] = 0.f;
      }
      if (act) {
        for (int r = q; r < srows; r += rg) {
          float t = qkan::load_as_float(x + (size_t)(s0 + r) * in + i);
          if (apply_tanh) {
            t = tanhf(t);
            if (XBF16) t = bf16_round(t);
          }
          const float two_t = 2.f * t;
          float prev = 1.f, cur = t;
          for (int d = 1; d < d0; ++d) {
            const float nxt = qkan::cheb_next<XBF16>(two_t, cur, prev);
            prev = cur;
            cur = nxt;
          }
          const float4* g4 = reinterpret_cast<const float4*>(g_s + r * TP);
#pragma unroll
          for (int j = 0; j < DC; ++j) {
            if (j < nd) {
#pragma unroll
              for (int q4 = 0; q4 < TP / 4; ++q4) {
                const float4 gv = g4[q4];
                acc[j][4 * q4 + 0] = fmaf(cur, gv.x, acc[j][4 * q4 + 0]);
                acc[j][4 * q4 + 1] = fmaf(cur, gv.y, acc[j][4 * q4 + 1]);
                acc[j][4 * q4 + 2] = fmaf(cur, gv.z, acc[j][4 * q4 + 2]);
                acc[j][4 * q4 + 3] = fmaf(cur, gv.w, acc[j][4 * q4 + 3]);
              }
              const float nxt = qkan::cheb_next<XBF16>(two_t, cur, prev);
              prev = cur;
              cur = nxt;
            }
          }
        }
      }
      if (rg == 1) {
        if (act) {
#pragma unroll
          for (int j = 0; j < DC; ++j) {
            if (j < nd) {
              float* dst =
                  part + (((size_t)rb * (dp1 - 1) + (d0 - 1 + j)) * in + i) * ldt +
                  c0;
#pragma unroll
              for (int c = 0; c < TP; ++c) {
                if (c < T) dst[c] = first_super ? acc[j][c] : dst[c] + acc[j][c];
              }
            }
          }
        }
      } else {
        // one pass (items * rg <= threads): the row groups' sums, added
        // in row-group order
        float* mine = red_s + (size_t)tid * (DC * TP);
#pragma unroll
        for (int j = 0; j < DC; ++j) {
#pragma unroll
          for (int c = 0; c < TP; ++c) mine[j * TP + c] = acc[j][c];
        }
        __syncthreads();
        for (int e = tid; e < items * DC * TP; e += STEP_THREADS) {
          const int it2 = e / (DC * TP);
          const int rem = e - it2 * (DC * TP);
          const int j = rem / TP, c = rem - j * TP;
          const int d = 1 + (it2 / in) * DC + j;
          if (c < T && d < dp1) {
            float s = 0.f;
            for (int q2 = 0; q2 < rg; ++q2) {
              s += red_s[(size_t)(q2 * items + it2) * (DC * TP) + rem];
            }
            float* dst = part +
                         (((size_t)rb * (dp1 - 1) + (d - 1)) * in + it2 % in) *
                             ldt +
                         c0 + c;
            *dst = first_super ? s : *dst + s;
          }
        }
      }
      __syncthreads();
    }
  }

  if (tid < T) gpart[(size_t)rb * ldt + c0 + tid] = gsum;
  l_s[tid] = lsum;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int k = 0; k < STEP_THREADS; ++k) s += l_s[k];
    lpart[rb] = c0 == 0 ? s : lpart[rb] + s;  // slices add in order
  }
}

// loss = loss_scale * sum of the row blocks' partials, in a fixed order
__global__ void __launch_bounds__(256)
fused_step_loss_kernel(const float* __restrict__ lpart, int nrb,
                       float loss_scale, float* __restrict__ loss) {
  __shared__ float s[256];
  float v = 0.f;
  for (int k = threadIdx.x; k < nrb; k += 256) v += lpart[k];
  s[threadIdx.x] = v;
  __syncthreads();
  for (int w = 128; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) *loss = loss_scale * s[0];
}

// -- K5 on the tensor cores: the step kernel of narrow layers ----------------
//
// The CUDA-core kernel above runs both contractions on the FP32 cores, one
// shared-memory float4 a 4 FMAs, builds the basis twice (reloading x for
// step 3) and keeps K2's layout: 547 row blocks of 480 rows at the
// headline, 3 waves, 235 us against a 28 us FP32 bound.  This kernel
// (fused_step_kernel_tc) takes every shape whose whole dW fits a block's
// registers (the rule is tc_shape below; the others keep the kernel
// above, and the rule and each path are stated in PERF.md):
//
//   - a persistent grid: at most TC_GRID row blocks, a function of the
//     shapes alone (never of the card's SM count, so every card gives the
//     same bits), each walking its rows in 64-row tiles; its dW_d stays in
//     registers across the tiles and is written once, at the end;
//   - x tiles arrive by cp.async into a two-stage ring: the next tile
//     loads while this one computes (16-byte copies, zero-filled past B;
//     an x off 16 bytes is copied by plain loads instead);
//   - the basis T_1..T_D of a tile is built once, in x's dtype, into
//     shared memory [64][S] (column k = (d-1)*in + i; the row of w2 that
//     multiplies it is in + k), and feeds both contractions:
//       out[64 x T] = basis @ W   (warp: a 16-row m-tile, every n-tile,
//                                  half the k-steps; the halves meet in
//                                  shared memory in a fixed order)
//       dW[K x T]  += basis^T @ g (warp: m-tiles w, w+8, .. of K)
//   - both on the tensor cores with mma.sync.m16n8k8 TF32 at FP32-class
//     accuracy, 3xTF32: a = a_hi + a_lo (split_tf32), and a_lo*b_hi +
//     a_hi*b_lo + a_hi*b_hi summed in FP32 (the counterpart of the TPU
//     kernel's bf16x3 _dot_x3); the three passes go to separate
//     accumulators where registers allow, for shorter chains of dependent
//     mma.  A bf16 x needs no split where the operand is the basis or the
//     bf16-rounded w2: both are exact in TF32, so the forward is one pass
//     and dW two (g stays f32);
//   - W and g sit in shared memory in mma's B-fragment order, one 8-byte
//     load a lane.  The basis, W and g are kept as f32 and split into
//     {hi, lo} in registers as they are loaded (two ALU ops a value): half
//     the shared-memory bytes of keeping the pairs;
//   - out, err, g and the loss stay on chip: err^2 and colsum(g) go to
//     per-thread sums added in a fixed order at the end.
//
// The basis is swizzled (column k of row r at k ^ swz(r)) so that both
// the forward's A fragments (8 rows x 4 columns) and dW's transposed ones
// (4 rows x 8 columns) fall on distinct banks.  Rows past B read a
// zero-filled x and get g = 0 and err = 0.  Bounds at the headline: 1.88
// GFLOP as 3 TF32 passes on the tensor cores (495 TFLOP/s) is 11.4 us,
// x's 16.8 MB 5.0 us, the same work on the FP32 CUDA cores 28.0 us.  On
// an H100 80GB HBM3 at 700 W the kernel takes about 82 us there, the
// CUDA-core kernel 235 us (tools/step_diag_vs_old.py, which also reads
// the debug build's phase split: about a quarter each for the basis and
// dW, a third for the forward and g).  mma.sync, shared-memory bytes and
// the four barriers a tile set that pace; wgmma on TMA-fed tiles is the
// next step.

#ifndef QKAN_STEP_TC
#define QKAN_STEP_TC 1  // 0: every shape takes the CUDA-core kernel (tools/)
#endif

constexpr int TC_ROWS = 64;       // rows of a tile
constexpr int TC_THREADS = 256;   // 8 warps
constexpr int TC_GRID = 264;      // row blocks at most (2 x 132, a constant)
constexpr int TC_ACC = 8;         // (m-tile, n-tile) dW pairs a warp holds
constexpr size_t TC_SMEM_MAX = 232448;  // a block's shared memory on sm_90

struct TcShape {
  bool ok;       // the shape takes fused_step_kernel_tc
  int nt;        // n8-tiles of T: 1, 2, 4 or 8
  int mpw;       // dW m16-tiles a warp: 1, 2, 4 or 8, mpw * nt <= TC_ACC
  int kp;        // K = in * (dp1 - 1) rounded up to 16
  int s;         // basis row stride, K rounded up to 32
  int xstage;    // bytes of one x stage (4 bytes an element, any dtype)
  size_t smem;   // dynamic shared memory bytes
};

TcShape tc_shape(int in, int dp1, int T) {
  TcShape sh{};
  const int n8 = (T + 7) / 8;
  sh.nt = n8 <= 1 ? 1 : n8 <= 2 ? 2 : n8 <= 4 ? 4 : 8;
  const int tn = 8 * sh.nt;
  const long long k = (long long)in * (dp1 - 1);
  sh.kp = (int)((k + 15) / 16 * 16);
  sh.s = (int)((k + 31) / 32 * 32);
  const int need = (sh.kp / 16 + 7) / 8;  // m16-tiles of K over 8 warps
  sh.mpw = need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : 8;
  sh.xstage = (int)(((long long)TC_ROWS * in * 4 + 15) / 16 * 16);
  // basis [64][s]; W and g fragments [kp or 64][8 nt]; colsum(W_0), the
  // colsum(g) and err^2 sums, the odd k-half's out; two x stages
  sh.smem = 4 * ((size_t)TC_ROWS * sh.s + (size_t)sh.kp * tn +
                 (size_t)TC_ROWS * tn + tn + 32 * tn + TC_THREADS +
                 64 * tn) +
            2 * (size_t)sh.xstage;
  sh.ok = QKAN_STEP_TC && dp1 >= 2 && T <= COL_SLICE && k <= 1024 &&
          sh.mpw * sh.nt <= TC_ACC && sh.smem <= TC_SMEM_MAX;
  return sh;
}

// bytes of t and W that the CUDA-core step kernel stages at `chunk`
// features (its budget: STEP_STAGE_BYTES)
size_t step_stage_bytes(int dp1, int TP, int chunk) {
  return ((size_t)GROWS * (chunk + 1) + (size_t)dp1 * chunk * TP) * 4;
}

// Columns of one launch of a train step: all T where the tensor-core
// kernel takes the shape, else the widest of T (up to 64), 64, 32, 16,
// 12, 8, 4 whose CUDA-core staging fits at a chunk of STEP_WARPS
// features; failing that, at a chunk of 1 (dp1 past 759 at 4 columns);
// 0 where nothing fits.  Past one slice, qkan_fused_step launches the
// CUDA-core kernel a slice: out, err and g are elementwise in the
// columns, so the slices' dW are disjoint columns of one workspace and
// their loss partials add in slice order.
int step_cols(int in, int dp1, int T) {
  if (tc_shape(in, dp1, T).ok) return T;
  const int widths[7] = {T < COL_SLICE ? T : COL_SLICE, 64, 32, 16, 12, 8, 4};
  for (int chunk = STEP_WARPS; chunk >= 1; chunk = chunk > 1 ? 1 : 0) {
    for (int w : widths) {
      if (w <= widths[0] &&
          step_stage_bytes(dp1, qkan::pad_t(w), chunk) <= STEP_STAGE_BYTES) {
        return w;
      }
    }
  }
  return 0;
}

bool bad_step(int B, int in, int dp1, int T) {
  return B < 1 || in < 1 || dp1 < 1 || T < 1 || step_cols(in, dp1, T) == 0;
}

// K5's layout: on the tensor-core path up to TC_GRID row blocks of whole
// 64-row tiles (fewer where the dW partials would pass the 4 MB budget);
// else K2's layout with want_dx = 0 under a budget of STEP_WIDE_BUDGET,
// as the CUDA-core kernel takes it: at the flagship's layer 0 (156.8 KB
// of dW a block) 4 MB left 26 row blocks for 132 SMs, 32 MB gives 128.
// With QKAN_STEP_TC = 0 the step is as it was: K2's layout, 4 MB.
constexpr size_t STEP_WIDE_BUDGET = size_t(32) << 20;

Layout step_layout(int B, int in, int dp1, int T) {
  if (!tc_shape(in, dp1, T).ok) {
    return layout(B, in, dp1, T, 0,
                  QKAN_STEP_TC ? STEP_WIDE_BUDGET : PARTIAL_BUDGET);
  }
  Layout L;
  const long long tiles = ((long long)B + TC_ROWS - 1) / TC_ROWS;
  const size_t per_rb = (size_t)(dp1 - 1) * in * T * sizeof(float);
  long long nrb = (long long)(PARTIAL_BUDGET / per_rb);
  if (nrb > TC_GRID) nrb = TC_GRID;
  if (nrb > tiles) nrb = tiles;
  if (nrb < 1) nrb = 1;
  const long long rows = (tiles + nrb - 1) / nrb * TC_ROWS;
  L.rows = (int)rows;
  L.nrb = (int)(((long long)B + rows - 1) / rows);
  L.part_floats = (size_t)L.nrb * (dp1 - 1) * in * T;
  L.gpart_floats = (size_t)L.nrb * T;
  L.dt_floats = 0;
  return L;
}

// the fragment, mma and cp.async helpers of tc_common.cuh
using qkan::a_frag;
using qkan::acc_sets;
using qkan::acc_total;
using qkan::b_frag;
using qkan::cp_async16;
using qkan::cp_async_commit;
using qkan::cp_async_wait;
using qkan::mma_3x;

// column k of basis row r lives at k ^ swz(r): the forward's A fragments
// (8 rows x 4 columns) and dW's transposed ones (4 rows x 8 columns) both
// fall on 32 distinct banks (row stride a multiple of 32)
__device__ __forceinline__ int swz(int r) { return ((r & 3) << 3) | (r & 4); }

// the float of B-fragment element (k, n) in a [k-steps][n-tiles][32 lanes]
// float2 array {b0, b1}: one 8-byte load a lane
__device__ __forceinline__ int frag_slot(int k, int n, int nt) {
  const int lane = (n & 7) * 4 + (k & 3);
  return ((((k >> 3) * nt + (n >> 3)) * 32 + lane) << 1) + ((k >> 2) & 1);
}

// the x rows [r0, r0 + 64) into a stage, zeros past r_end
template <typename XT>
__device__ __forceinline__ void load_x_tile(const XT* __restrict__ x,
                                            unsigned char* stage, int r0,
                                            int r_end, int in, int xvec) {
  const int nrows = max(0, min(TC_ROWS, r_end - r0));
  const long long valid = (long long)nrows * in * sizeof(XT);
  const long long total = (long long)TC_ROWS * in * sizeof(XT);
  const unsigned char* src =
      reinterpret_cast<const unsigned char*>(x + (size_t)r0 * in);
  if (xvec) {
    for (long long o = (long long)threadIdx.x * 16; o < total;
         o += TC_THREADS * 16) {
      const long long left = valid - o;
      const int n = left >= 16 ? 16 : left > 0 ? (int)left : 0;
      cp_async16(stage + o, n ? src + o : reinterpret_cast<const void*>(x),
                 n);
    }
  } else {
    XT* dst = reinterpret_cast<XT*>(stage);
    const int elems = TC_ROWS * in, nvalid = nrows * in;
    for (int e = threadIdx.x; e < elems; e += TC_THREADS) {
      dst[e] = e < nvalid ? x[(size_t)r0 * in + e] : XT(0.f);
    }
  }
}

// A debug build (-DQKAN_STEP_TIMING, as tools/step_diag_vs_old.py builds
// it) adds thread 0's clock64() cycles of each phase of a tile, summed over
// the blocks, to qkan_step_cycles: 0 waiting for x, 1 the basis, 2 the
// forward and g, 3 dW, 4 the block's start and end.  The package's build
// has none of it.
#ifdef QKAN_STEP_TIMING
__device__ unsigned long long qkan_step_cycles[5];
#define QKAN_STEP_MARK(i)                      \
  if (tid == 0) {                              \
    const long long now = clock64();           \
    cyc[i] += (unsigned long long)(now - last); \
    last = now;                                \
  }
#else
#define QKAN_STEP_MARK(i)
#endif

template <typename XT, int NT, int MPW>
__global__ void __launch_bounds__(TC_THREADS, 2)
fused_step_kernel_tc(const XT* __restrict__ x, const float* __restrict__ w2,
                     const float* __restrict__ y, float* __restrict__ part,
                     float* __restrict__ gpart, float* __restrict__ lpart,
                     int B, int in, int dp1, int T, int rows, int kp, int S,
                     int xstage, int xvec, int apply_tanh, float g_scale) {
  constexpr bool XBF16 = !std::is_same<XT, float>::value;
  constexpr int TN = 8 * NT;
  // separate accumulators for the small passes where registers allow:
  // shorter chains of dependent mma
  constexpr int FSETS = acc_sets(NT);
  constexpr int DSETS = acc_sets(MPW * NT);
  extern __shared__ __align__(16) float smem[];
  float* basis = smem;                                   // [64][S]
  float2* wfrag = reinterpret_cast<float2*>(basis + TC_ROWS * S);
  float2* gfrag = wfrag + (kp / 8) * NT * 32;            // [8][NT][32]
  float* csum = reinterpret_cast<float*>(gfrag + 8 * NT * 32);  // [TN]
  float* gred = csum + TN;                     // [4][8][TN]
  float* lred = gred + 32 * TN;                // [256]
  float* ored = lred + TC_THREADS;             // [4][32][4 NT]
  unsigned char* xring = reinterpret_cast<unsigned char*>(ored + 512 * NT);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int K = in * (dp1 - 1);
  const int mtiles = kp / 16;
  const int rb = blockIdx.x;
  const int r_begin = rb * rows;
  const int r_end = min(B, r_begin + rows);
  const int ntiles = (r_end - r_begin + TC_ROWS - 1) / TC_ROWS;
#ifdef QKAN_STEP_TIMING
  unsigned long long cyc[5] = {0, 0, 0, 0, 0};
  long long last = clock64();
#endif

  // the first tile's x is on its way while W is staged
  load_x_tile(x, xring, r_begin, r_end, in, xvec);
  cp_async_commit();
  for (int e = tid; e < TC_ROWS * S; e += TC_THREADS) basis[e] = 0.f;
  {
    float* wf = reinterpret_cast<float*>(wfrag);
    for (int e = tid; e < kp * TN; e += TC_THREADS) {
      const int k = e / TN, c = e - k * TN;
      float w = 0.f;
      if (k < K && c < T) {
        w = w2[(size_t)(in + k) * T + c];
        if (XBF16) w = bf16_round(w);
      }
      wf[frag_slot(k, c, NT)] = w;
    }
  }
  if (tid < TN) {
    float s = 0.f;
    if (tid < T) {
      for (int i = 0; i < in; ++i) {
        float w = w2[(size_t)i * T + tid];
        if (XBF16) w = bf16_round(w);
        s += w;
      }
    }
    csum[tid] = s;
  }

  // forward: warp -> m-tile (warp & 3), every n-tile, the k-steps of
  // parity warp >> 2; the even half adds the odd half's out and makes g
  const int fm = warp & 3, kh = warp >> 2;
  // this thread's first basis item (row, feature) and its stride
  const int step_r = TC_THREADS / in, step_i = TC_THREADS - step_r * in;
  float gs[NT][2];  // colsum(g) of this thread's columns
  float lsum = 0.f;
  float acc[DSETS][MPW][NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) gs[j][0] = gs[j][1] = 0.f;
#pragma unroll
  for (int a = 0; a < DSETS; ++a)
#pragma unroll
    for (int m = 0; m < MPW; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][m][n][q] = 0.f;
  QKAN_STEP_MARK(4)

  for (int j = 0; j < ntiles; ++j) {
    const int r0 = r_begin + j * TC_ROWS;
    if (j + 1 < ntiles) {
      load_x_tile(x, xring + ((j + 1) & 1) * xstage, r0 + TC_ROWS, r_end,
                  in, xvec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // x of tile j is in; tile j-1's readers are done
    QKAN_STEP_MARK(0)

    // the basis, once: T_1 .. T_{dp1-1} of every (row, feature)
    {
      const XT* xs = reinterpret_cast<const XT*>(xring + (j & 1) * xstage);
      int r = tid / in, i = tid - (tid / in) * in;
      for (int e = tid; e < TC_ROWS * in; e += TC_THREADS) {
        float t = qkan::load_as_float(xs + e);
        if (apply_tanh) {
          t = tanhf(t);
          if (XBF16) t = bf16_round(t);
        }
        float* row = basis + r * S;
        const int sz = swz(r);
        const float two_t = 2.f * t;
        float prev = 1.f, cur = t;
        row[i ^ sz] = cur;
        for (int d = 2; d < dp1; ++d) {
          const float nxt = qkan::cheb_next<XBF16>(two_t, cur, prev);
          prev = cur;
          cur = nxt;
          row[((d - 1) * in + i) ^ sz] = cur;
        }
        r += step_r;
        i += step_i;
        if (i >= in) {
          i -= in;
          ++r;
        }
      }
    }
    __syncthreads();
    QKAN_STEP_MARK(1)

    // out = basis @ W, then err, g and err^2 from the fragments
    {
      float o[FSETS][NT][4];
#pragma unroll
      for (int a = 0; a < FSETS; ++a)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) o[a][n][q] = 0.f;
      const int ra = fm * 16 + g8;
      const float* rowa = basis + ra * S;
      const float* rowb = rowa + 8 * S;
      const int sz = swz(ra);  // rows ra and ra + 8 share it
#pragma unroll 2
      for (int k0 = 8 * kh; k0 < kp; k0 += 16) {
        float2 a[4];
        a_frag<XBF16>(a, rowa[(k0 + t4) ^ sz], rowb[(k0 + t4) ^ sz],
                      rowa[(k0 + t4 + 4) ^ sz], rowb[(k0 + t4 + 4) ^ sz]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float4 b =
              b_frag<XBF16>(wfrag[((k0 >> 3) * NT + n) * 32 + lane]);
          mma_3x<XBF16, XBF16>(o[0][n], o[FSETS > 1 ? 1 : 0][n],
                               o[FSETS - 1][n], a, b);
        }
      }
      float* mine = ored + (fm * 32 + lane) * 4 * NT;
      if (kh == 1) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            mine[n * 4 + q] = acc_total<FSETS>(o[0][n][q],
                                               o[FSETS > 1 ? 1 : 0][n][q],
                                               o[FSETS - 1][n][q]);
          }
      }
      __syncthreads();
      if (kh == 0) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int c0 = n * 8 + 2 * t4;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = ra + (q >> 1) * 8, c = c0 + (q & 1);
            const int b = r0 + r;
            float gv = 0.f;
            if (b < r_end && c < T) {
              const float prod =
                  acc_total<FSETS>(o[0][n][q], o[FSETS > 1 ? 1 : 0][n][q],
                                   o[FSETS - 1][n][q]) +
                  mine[n * 4 + q];
              const float out = csum[c] + prod;
              const float err =
                  y != nullptr ? out - y[(size_t)b * T + c] : out;
              lsum = fmaf(err, err, lsum);
              gv = g_scale * err;
              gs[n][q & 1] += gv;
            }
            reinterpret_cast<float*>(gfrag)[frag_slot(r, c, NT)] = gv;
          }
        }
      }
    }
    __syncthreads();
    QKAN_STEP_MARK(2)

    // dW_d += basis^T @ g over the tile's 64 rows
#pragma unroll
    for (int k0 = 0; k0 < TC_ROWS; k0 += 8) {
      float4 b[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        b[n] = b_frag<false>(gfrag[((k0 >> 3) * NT + n) * 32 + lane]);
      }
      const float* row0 = basis + (k0 + t4) * S;
      const float* row4 = row0 + 4 * S;
      const int sz0 = swz(t4), sz4 = swz(t4 + 4);  // rows k0+t4, k0+t4+4
#pragma unroll
      for (int m = 0; m < MPW; ++m) {
        const int mt = warp + 8 * m;
        if (mt < mtiles) {
          const int col = mt * 16 + g8;
          float2 a[4];
          a_frag<XBF16>(a, row0[col ^ sz0], row0[(col + 8) ^ sz0],
                        row4[col ^ sz4], row4[(col + 8) ^ sz4]);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            mma_3x<XBF16, false>(acc[0][m][n], acc[DSETS > 1 ? 1 : 0][m][n],
                                 acc[DSETS - 1][m][n], a, b[n]);
          }
        }
      }
    }
    QKAN_STEP_MARK(3)
  }

  // the block's partials, each written once
#pragma unroll
  for (int m = 0; m < MPW; ++m) {
    const int mt = warp + 8 * m;
    if (mt < mtiles) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = mt * 16 + g8 + (q >> 1) * 8;
          const int c = n * 8 + 2 * t4 + (q & 1);
          if (k < K && c < T) {
            part[((size_t)rb * K + k) * T + c] = acc_total<DSETS>(
                acc[0][m][n][q], acc[DSETS > 1 ? 1 : 0][m][n][q],
                acc[DSETS - 1][m][n][q]);
          }
        }
      }
    }
  }
  if (kh == 0) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c0 = n * 8 + 2 * t4;
      gred[(fm * 8 + g8) * TN + c0] = gs[n][0];
      gred[(fm * 8 + g8) * TN + c0 + 1] = gs[n][1];
    }
  }
  lred[tid] = lsum;
  __syncthreads();
  if (tid < T) {
    float s = 0.f;
    for (int e = 0; e < 32; ++e) s += gred[e * TN + tid];
    gpart[(size_t)rb * T + tid] = s;
  }
  if (tid == 0) {
    float s = 0.f;
    for (int e = 0; e < TC_THREADS; ++e) s += lred[e];
    lpart[rb] = s;
  }
#ifdef QKAN_STEP_TIMING
  QKAN_STEP_MARK(4)
  if (tid == 0) {
    for (int e = 0; e < 5; ++e) atomicAdd(&qkan_step_cycles[e], cyc[e]);
  }
#endif
}

template <typename XT, int NT, int MPW>
cudaError_t launch_step_tc(const void* x, const float* w2, const float* y,
                           float* loss, float* ws, const Layout& L,
                           const TcShape& sh, int B, int in, int dp1, int T,
                           int apply_tanh, float g_scale, float loss_scale,
                           cudaStream_t s) {
  auto kernel = fused_step_kernel_tc<XT, NT, MPW>;
  if (sh.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
    if (err != cudaSuccess) return err;
  }
  float* part = ws;
  float* gpart = part + L.part_floats;
  float* lpart = gpart + L.gpart_floats;
  const int xvec = (reinterpret_cast<unsigned long long>(x) & 15) == 0;
  kernel<<<L.nrb, TC_THREADS, sh.smem, s>>>(
      static_cast<const XT*>(x), w2, y, part, gpart, lpart, B, in, dp1, T,
      L.rows, sh.kp, sh.s, sh.xstage, xvec, apply_tanh, g_scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused_step_loss_kernel<<<1, 256, 0, s>>>(lpart, L.nrb, loss_scale, loss);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t dispatch_step_tc(const void* x, const float* w2, const float* y,
                             float* loss, float* ws, const Layout& L,
                             const TcShape& sh, int B, int in, int dp1,
                             int T, int apply_tanh, float g_scale,
                             float loss_scale, cudaStream_t s) {
#define QKAN_TC(NT, MPW)                                                   \
  if (sh.nt == NT && sh.mpw == MPW) {                                      \
    return launch_step_tc<XT, NT, MPW>(x, w2, y, loss, ws, L, sh, B, in,   \
                                       dp1, T, apply_tanh, g_scale,        \
                                       loss_scale, s);                     \
  }
  QKAN_TC(1, 1) QKAN_TC(1, 2) QKAN_TC(1, 4) QKAN_TC(1, 8)
  QKAN_TC(2, 1) QKAN_TC(2, 2) QKAN_TC(2, 4)
  QKAN_TC(4, 1) QKAN_TC(4, 2)
  QKAN_TC(8, 1)
#undef QKAN_TC
  return cudaErrorInvalidValue;
}

// The column slice [c0, c0 + T) of a width-ldt step; the loss sum after
// the last slice.
template <typename XT, int TP>
cudaError_t launch_step(const void* x, const float* w2, const float* y,
                        float* loss, float* ws, const Layout& L, int B,
                        int in, int dp1, int T, int ldt, int c0,
                        int apply_tanh, float g_scale, float loss_scale,
                        cudaStream_t s) {
  // widest chunk of features whose t and W staging fits its budget (below
  // STEP_WARPS only at dp1 past what a slice of 4 columns stages at 8)
  int chunk = 64;
  while (chunk > 1 && step_stage_bytes(dp1, TP, chunk) > STEP_STAGE_BYTES) {
    chunk /= 2;
  }
  const int in_pad = (in + STEP_WARPS - 1) / STEP_WARPS * STEP_WARPS;
  if (chunk > in_pad) chunk = in_pad;
  const int super_rows = STEP_G_FLOATS / TP / GROWS * GROWS;
  const size_t floats = (size_t)GROWS * (chunk + 1) +
                        (size_t)dp1 * chunk * TP + step_red_floats<TP>() +
                        (size_t)super_rows * TP + TP + STEP_THREADS;
  const size_t bytes = floats * sizeof(float);
  auto kernel = fused_step_kernel<XT, TP>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  float* part = ws;
  float* gpart = part + L.part_floats;
  float* lpart = gpart + L.gpart_floats;
  kernel<<<L.nrb, STEP_THREADS, bytes, s>>>(
      static_cast<const XT*>(x), w2, y, part, gpart, lpart, B, in, dp1, T,
      ldt, c0, L.rows, chunk, super_rows, apply_tanh, g_scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || c0 + T < ldt) return err;
  fused_step_loss_kernel<<<1, 256, 0, s>>>(lpart, L.nrb, loss_scale, loss);
  return cudaGetLastError();
}

// every column slice of a step (step_cols wide), in order
template <typename XT>
cudaError_t dispatch_step(const void* x, const float* w2, const float* y,
                          float* loss, float* ws, const Layout& L, int B,
                          int in, int dp1, int T, int apply_tanh,
                          float g_scale, float loss_scale, cudaStream_t s) {
  const int width = step_cols(in, dp1, T);
  for (int c0 = 0; c0 < T; c0 += width) {
    const int w = T - c0 < width ? T - c0 : width;
    cudaError_t err;
    switch (qkan::pad_t(w)) {
      case 4: err = launch_step<XT, 4>(x, w2, y, loss, ws, L, B, in, dp1, w, T, c0, apply_tanh, g_scale, loss_scale, s); break;
      case 8: err = launch_step<XT, 8>(x, w2, y, loss, ws, L, B, in, dp1, w, T, c0, apply_tanh, g_scale, loss_scale, s); break;
      case 12: err = launch_step<XT, 12>(x, w2, y, loss, ws, L, B, in, dp1, w, T, c0, apply_tanh, g_scale, loss_scale, s); break;
      case 16: err = launch_step<XT, 16>(x, w2, y, loss, ws, L, B, in, dp1, w, T, c0, apply_tanh, g_scale, loss_scale, s); break;
      case 32: err = launch_step<XT, 32>(x, w2, y, loss, ws, L, B, in, dp1, w, T, c0, apply_tanh, g_scale, loss_scale, s); break;
      default: err = launch_step<XT, 64>(x, w2, y, loss, ws, L, B, in, dp1, w, T, c0, apply_tanh, g_scale, loss_scale, s); break;
    }
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The degree chunks of the column slice [c0, c0 + T) of a width-ldt
// backward; first / last: the slice is the call's first / last.
template <typename XT, int TP, bool ROUND>
cudaError_t launch(const void* x, const float* w2, const float* g, void* dx,
                   float* ws, const Layout& L, int B, int in,
                   int dp1, int T, int ldt, int c0, int apply_tanh,
                   int want_dx, bool first, bool last, cudaStream_t s) {
  constexpr int DC = degree_chunk(TP);
  float* part = ws;
  float* gpart = part + L.part_floats;
  float* dt = gpart + L.gpart_floats;
  const int threads = in >= MAX_FEAT ? MAX_FEAT : (in + 31) / 32 * 32;
  const dim3 grid(L.nrb, (in + threads - 1) / threads);
  const int nchunks = degree_chunks(dp1, DC);
  for (int k = 0; k < nchunks; ++k) {
    fused_dw_bwd_kernel<XT, TP, DC, ROUND><<<grid, threads, 0, s>>>(
        static_cast<const XT*>(x), w2, g, static_cast<XT*>(dx), dt, part,
        gpart, B, in, dp1, T, ldt, c0, L.rows, 1 + k * DC, apply_tanh,
        want_dx, first && k == 0, last && k == nchunks - 1, k == 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// every column slice of a backward, in order
template <typename XT, bool ROUND>
cudaError_t dispatch_tp(const void* x, const float* w2, const float* g,
                        void* dx, float* ws, const Layout& L,
                        int B, int in, int dp1, int T, int apply_tanh,
                        int want_dx, cudaStream_t s) {
  for (int c0 = 0; c0 < T; c0 += COL_SLICE) {
    const int w = T - c0 < COL_SLICE ? T - c0 : COL_SLICE;
    const bool first = c0 == 0, last = c0 + w == T;
    cudaError_t err;
    switch (qkan::pad_t(w)) {
      case 4: err = launch<XT, 4, ROUND>(x, w2, g, dx, ws, L, B, in, dp1, w, T, c0, apply_tanh, want_dx, first, last, s); break;
      case 8: err = launch<XT, 8, ROUND>(x, w2, g, dx, ws, L, B, in, dp1, w, T, c0, apply_tanh, want_dx, first, last, s); break;
      case 12: err = launch<XT, 12, ROUND>(x, w2, g, dx, ws, L, B, in, dp1, w, T, c0, apply_tanh, want_dx, first, last, s); break;
      case 16: err = launch<XT, 16, ROUND>(x, w2, g, dx, ws, L, B, in, dp1, w, T, c0, apply_tanh, want_dx, first, last, s); break;
      case 32: err = launch<XT, 32, ROUND>(x, w2, g, dx, ws, L, B, in, dp1, w, T, c0, apply_tanh, want_dx, first, last, s); break;
      default: err = launch<XT, 64, ROUND>(x, w2, g, dx, ws, L, B, in, dp1, w, T, c0, apply_tanh, want_dx, first, last, s); break;
    }
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

bool bad_shape(int B, int in, int dp1, int T) {
  return B < 1 || in < 1 || dp1 < 1 || T < 1;
}

size_t workspace_bytes(const Layout& L) {
  return (L.part_floats + L.gpart_floats + L.dt_floats) * sizeof(float);
}

// dw [dp1*in, T] from a workspace's partials: dW_d (d >= 1) summed over the
// row blocks, and colsum(g) summed once and written to all `in` rows of
// dW_0; one launch of the fixed-order pass
cudaError_t sum_workspace(const float* ws, const Layout& L, int in, int dp1,
                          int T, float* dw, cudaStream_t s) {
  return qkan::partial_sum(ws, (long long)(dp1 - 1) * in * T, L.nrb,
                           dw + (size_t)in * T, ws + L.part_floats, T, in, dw,
                           s);
}

int run(const void* x, const void* w2, const void* g, void* dx, void* ws,
        long long ws_bytes, int B, int in, int dp1, int T,
        int x_is_bf16, int round_bf16, int apply_tanh, int want_dx,
        void* dw, void* stream) {
  if (bad_shape(B, in, dp1, T) || (want_dx && dx == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout L =
      bwd_layout(B, in, dp1, T, want_dx, x_is_bf16, round_bf16);
  if (ws_bytes < 0 || (size_t)ws_bytes < workspace_bytes(L)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* w = static_cast<const float*>(w2);
  const float* gg = static_cast<const float*>(g);
  float* f = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const qkan::BwdTcPlan p =
      qkan::bwd_tc_plan(in, dp1, T, x_is_bf16, round_bf16);
  cudaError_t err;
  if (p.ok) {
    err = qkan::fused_bwd_tc(static_cast<const float*>(x), w, gg,
                             static_cast<float*>(dx), f, f + L.part_floats,
                             B, in, dp1, T, p,
                             qkan::BwdTcRows{L.rows, L.nrb}, apply_tanh,
                             want_dx, s);
  } else if (x_is_bf16) {
    err = round_bf16
              ? dispatch_tp<__nv_bfloat16, true>(x, w, gg, dx, f, L, B, in, dp1, T, apply_tanh, want_dx, s)
              : dispatch_tp<__nv_bfloat16, false>(x, w, gg, dx, f, L, B, in, dp1, T, apply_tanh, want_dx, s);
  } else {
    err = round_bf16
              ? dispatch_tp<float, true>(x, w, gg, dx, f, L, B, in, dp1, T, apply_tanh, want_dx, s)
              : dispatch_tp<float, false>(x, w, gg, dx, f, L, B, in, dp1, T, apply_tanh, want_dx, s);
  }
  if (err != cudaSuccess || dw == nullptr) return (int)err;
  return (int)sum_workspace(f, L, in, dp1, T, static_cast<float*>(dw), s);
}

}  // namespace

// Bytes of workspace a backward call needs (dW partials, colsum partials
// and, the CUDA-core kernel past one degree chunk, the carried dt).  The
// backward of the v1 entry passes round_bf16 = 0.
extern "C" long long qkan_fused_bwd_workspace_bytes(int B, int in, int dp1,
                                                    int T, int want_dx,
                                                    int x_is_bf16,
                                                    int round_bf16) {
  if (bad_shape(B, in, dp1, T)) return 0;
  return (long long)workspace_bytes(
      bwd_layout(B, in, dp1, T, want_dx, x_is_bf16, round_bf16));
}

// Row blocks of a backward call, the leading dimension of its partials.
extern "C" int qkan_fused_bwd_row_blocks(int B, int in, int dp1, int T,
                                         int x_is_bf16, int round_bf16) {
  if (bad_shape(B, in, dp1, T)) return 0;
  return bwd_layout(B, in, dp1, T, 0, x_is_bf16, round_bf16).nrb;
}

// 1 where a backward at these sizes runs the tensor-core kernel
// (bwd_tc_plan), 0 where it runs the CUDA-core one.
extern "C" int qkan_fused_bwd_tensor_cores(int in, int dp1, int T,
                                           int x_is_bf16, int round_bf16) {
  if (bad_shape(1, in, dp1, T)) return 0;
  return qkan::bwd_tc_plan(in, dp1, T, x_is_bf16, round_bf16).ok ? 1 : 0;
}

// Input features a block of the tensor-core kernel takes (16 or 32; 0 on
// the CUDA-core route).
extern "C" int qkan_fused_bwd_feature_chunk(int in, int dp1, int T,
                                            int x_is_bf16, int round_bf16) {
  if (bad_shape(1, in, dp1, T)) return 0;
  const qkan::BwdTcPlan p =
      qkan::bwd_tc_plan(in, dp1, T, x_is_bf16, round_bf16);
  return p.ok ? p.fc : 0;
}

// Kernel launches that one call of either entry below makes when it
// succeeds: one on the tensor cores; on the CUDA cores one per degree
// chunk of each column slice.
extern "C" int qkan_fused_bwd_launches(int in, int dp1, int T, int x_is_bf16,
                                       int round_bf16) {
  if (bad_shape(1, in, dp1, T)) return 0;
  if (qkan::bwd_tc_plan(in, dp1, T, x_is_bf16, round_bf16).ok) return 1;
  return bwd_launches(dp1, T);
}

// Column slices of a backward call: COL_SLICE (64) columns each.
extern "C" int qkan_fused_bwd_col_slices(int T) {
  return T < 1 ? 0 : col_slices(T);
}

// C entry points of the backward.  x: [B, in] f32 (x_is_bf16=0) or bf16
// (1); w2: [dp1*in, T] f32; g: [B, T] f32; dx: [B, in] in x's dtype (may be
// null when want_dx = 0); ws: the workspace, of at least
// qkan_fused_bwd_workspace_bytes, which receives the partials; dw: [dp1*in,
// T] f32, or null.  Given dw, the fixed-order pass that sums the partials
// into it is launched next on the same stream (one call a backward); else
// the caller runs qkan_fused_bwd_partial_sum.  All contiguous.  Each
// returns the CUDA error of its launches (0 on success), allocates nothing
// and does not synchronise.
//
// Degree-wise layer (kan_layer_fused_dw); round_bf16 selects 'bf16'.
extern "C" int qkan_fused_dw_bwd(const void* x, const void* w2, const void* g,
                                 void* dx, void* ws, long long ws_bytes, int B,
                                 int in, int dp1, int T, int x_is_bf16,
                                 int round_bf16, int apply_tanh, int want_dx,
                                 void* dw, void* stream) {
  return run(x, w2, g, dx, ws, ws_bytes, B, in, dp1, T, x_is_bf16,
             round_bf16, apply_tanh, want_dx, dw, stream);
}

// v1 layer (kan_layer_fused): 'high'/'default' only.
extern "C" int qkan_fused_bwd(const void* x, const void* w2, const void* g,
                              void* dx, void* ws, long long ws_bytes, int B,
                              int in, int dp1, int T, int x_is_bf16,
                              int apply_tanh, int want_dx, void* dw,
                              void* stream) {
  return run(x, w2, g, dx, ws, ws_bytes, B, in, dp1, T, x_is_bf16, 0,
             apply_tanh, want_dx, dw, stream);
}

// The fixed-order pass alone, over a workspace that an entry above filled
// for the same (B, in, dp1, T, want_dx, x_is_bf16, round_bf16) (a train
// step's: below): dw [dp1*in, T] f32, in the order of
// qkan_partial_sum_segments(nrb, (dp1-1)*in*T).
extern "C" int qkan_fused_bwd_partial_sum(const void* ws, long long ws_bytes,
                                          void* dw, int B, int in, int dp1,
                                          int T, int want_dx, int x_is_bf16,
                                          int round_bf16, void* stream) {
  if (bad_shape(B, in, dp1, T)) return (int)cudaErrorInvalidValue;
  const Layout L = bwd_layout(B, in, dp1, T, want_dx, x_is_bf16, round_bf16);
  if (ws_bytes < 0 || (size_t)ws_bytes < workspace_bytes(L)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)sum_workspace(static_cast<const float*>(ws), L, in, dp1, T,
                            static_cast<float*>(dw),
                            static_cast<cudaStream_t>(stream));
}

// Columns of one launch of a train step at these sizes (step_cols): T
// where one launch takes the step, else the width of its column slices,
// one launch each; 0 where no launch stages dp1.
extern "C" int qkan_fused_step_col_slice(int in, int dp1, int T) {
  if (bad_shape(1, in, dp1, T)) return 0;
  return step_cols(in, dp1, T);
}

// Bytes of workspace a train step needs: K5's layout (step_layout) of dW
// and colsum(g) partials, then one loss partial per row block.
extern "C" long long qkan_fused_step_workspace_bytes(int B, int in, int dp1,
                                                     int T) {
  if (bad_step(B, in, dp1, T)) return 0;
  const Layout L = step_layout(B, in, dp1, T);
  return (long long)(workspace_bytes(L) + (size_t)L.nrb * sizeof(float));
}

// Row blocks of a train step, the leading dimension of its partials: a
// function of (B, in, dp1, T) alone.
extern "C" int qkan_fused_step_row_blocks(int B, int in, int dp1, int T) {
  if (bad_step(B, in, dp1, T)) return 0;
  return step_layout(B, in, dp1, T).nrb;
}

// 1 where the step of these shapes runs fused_step_kernel_tc (the tensor
// cores), 0 where it runs the CUDA-core fused_step_kernel.
extern "C" int qkan_fused_step_tensor_cores(int in, int dp1, int T) {
  if (bad_step(1, in, dp1, T)) return 0;
  return tc_shape(in, dp1, T).ok ? 1 : 0;
}

// The fused train step (kan_train_step_fused).  x: [B, in] f32
// (x_is_bf16=0) or bf16 (1); w2: [dp1*in, T] f32; y: [B, T] f32 for 'mse',
// null for 'sumsq' (then never read); loss: one f32; ws: at least
// qkan_fused_step_workspace_bytes; dw: [dp1*in, T] f32, or null.  All
// contiguous.  Launches the step kernel (fused_step_kernel_tc where
// tc_shape takes the shapes, else fused_step_kernel once a column slice
// of step_cols), the one-block loss sum and, given dw, the fixed-order
// pass into it (one call a step);
// without dw, dW comes from qkan_fused_step_partial_sum over ws.  Returns
// the CUDA error of the launches (0 on success), allocates nothing and
// does not synchronise.
extern "C" int qkan_fused_step(const void* x, const void* w2, const void* y,
                               void* loss, void* ws, long long ws_bytes,
                               int B, int in, int dp1, int T, int x_is_bf16,
                               int apply_tanh, float g_scale,
                               float loss_scale, void* dw, void* stream) {
  if (bad_step(B, in, dp1, T)) return (int)cudaErrorInvalidValue;
  const Layout L = step_layout(B, in, dp1, T);
  if (ws_bytes < 0 ||
      (size_t)ws_bytes < workspace_bytes(L) + (size_t)L.nrb * sizeof(float)) {
    return (int)cudaErrorInvalidValue;
  }
  const TcShape sh = tc_shape(in, dp1, T);
  const float* w = static_cast<const float*>(w2);
  const float* yy = static_cast<const float*>(y);
  float* l = static_cast<float*>(loss);
  float* f = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (sh.ok) {
    err = x_is_bf16
              ? dispatch_step_tc<__nv_bfloat16>(x, w, yy, l, f, L, sh, B, in, dp1, T, apply_tanh, g_scale, loss_scale, s)
              : dispatch_step_tc<float>(x, w, yy, l, f, L, sh, B, in, dp1, T, apply_tanh, g_scale, loss_scale, s);
  } else {
    err = x_is_bf16
              ? dispatch_step<__nv_bfloat16>(x, w, yy, l, f, L, B, in, dp1, T, apply_tanh, g_scale, loss_scale, s)
              : dispatch_step<float>(x, w, yy, l, f, L, B, in, dp1, T, apply_tanh, g_scale, loss_scale, s);
  }
  if (err != cudaSuccess || dw == nullptr) return (int)err;
  return (int)sum_workspace(f, L, in, dp1, T, static_cast<float*>(dw), s);
}

// The fixed-order pass alone over a train step's workspace for the same
// (B, in, dp1, T): dw [dp1*in, T] f32, in the order of
// qkan_partial_sum_segments(nrb, (dp1-1)*in*T).
extern "C" int qkan_fused_step_partial_sum(const void* ws, long long ws_bytes,
                                           void* dw, int B, int in, int dp1,
                                           int T, void* stream) {
  if (bad_step(B, in, dp1, T)) return (int)cudaErrorInvalidValue;
  const Layout L = step_layout(B, in, dp1, T);
  if (ws_bytes < 0 ||
      (size_t)ws_bytes < workspace_bytes(L) + (size_t)L.nrb * sizeof(float)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)sum_workspace(static_cast<const float*>(ws), L, in, dp1, T,
                            static_cast<float*>(dw),
                            static_cast<cudaStream_t>(stream));
}

#ifdef QKAN_STEP_TIMING
// The debug build's phase cycles (see QKAN_STEP_MARK), read and reset.
extern "C" int qkan_step_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, qkan_step_cycles,
                                         sizeof(qkan_step_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[5] = {0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(qkan_step_cycles, zero, sizeof(zero));
}
#endif
