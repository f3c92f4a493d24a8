// Fused FixedKAN layer backward for Hopper (sm_90a), and the fused
// single-layer train step built on its workspace (entry qkan_fused_step,
// described where it starts below).
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
// Schedule.  The TPU grid runs in order, so its dW accumulator carries from
// one step to the next; CUDA blocks run in parallel.  Here a block owns
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
// chosen so that the partials stay under 4 MB.  Past DC degrees (large dp1 or T) the degree
// chunks run as successive launches that carry dt through a [B, in] f32
// workspace, so the whole domain of the forward (dp1 <= 32, T <= 64)
// trains.  want_dx = 0 skips dx (an input that needs no gradient).
//
// Precision.  round_bf16=0: FP32 products and sums.  round_bf16=1
// (degree-wise 'bf16'): g, W_d and T_d are rounded to bf16 before each
// product, sums in f32; colsum(g) stays f32.  With a bf16 x, tanh, the
// recurrences, d * U_{d-1} and (1 - t*t) round to bf16 one op at a time,
// as torch does for a bf16 tensor; only the products with the f32 sums
// widen to f32.

#include <type_traits>

#include "qkan_common.cuh"

namespace {

using qkan::bf16_round;

constexpr int MAX_FEAT = 128;  // threads of a block: one input feature each
constexpr int GROWS = 32;      // rows of g staged in shared memory at a time
constexpr size_t PARTIAL_BUDGET = size_t(4) << 20;  // bytes of dW partials

// degrees a thread holds in registers at once: DC * TP <= 64
__host__ __device__ constexpr int degree_chunk(int tp) {
  return tp >= 64 ? 1 : 64 / tp;
}

// launches of the per-block kernel in one backward call: one per chunk of
// dc degrees of the dp1 - 1 that have products (one when dp1 = 1)
int degree_chunks(int dp1, int dc) {
  return dp1 > 1 ? (dp1 - 1 + dc - 1) / dc : 1;
}

struct Layout {
  int rows;            // batch rows per block, a multiple of GROWS
  int nrb;             // row blocks
  size_t part_floats;  // dW partials [nrb][dp1-1][in][T]
  size_t gpart_floats; // colsum(g) partials [nrb][T]
  size_t dt_floats;    // dt carried across degree chunks [B][in]
};

Layout layout(int B, int in, int dp1, int T, int want_dx) {
  Layout L;
  const size_t per_rb = (size_t)(dp1 - 1) * in * T * sizeof(float);
  size_t max_nrb = per_rb ? PARTIAL_BUDGET / per_rb : (size_t)B;
  if (max_nrb < 1) max_nrb = 1;
  size_t rows = ((size_t)B + max_nrb - 1) / max_nrb;
  rows = (rows + GROWS - 1) / GROWS * GROWS;
  L.rows = (int)rows;
  L.nrb = (int)(((size_t)B + rows - 1) / rows);
  L.part_floats = (size_t)L.nrb * (dp1 - 1) * in * T;
  L.gpart_floats = (size_t)L.nrb * T;
  const int dc = degree_chunk(qkan::pad_t(T));
  L.dt_floats = (want_dx && dp1 - 1 > dc) ? (size_t)B * in : 0;
  return L;
}

// One degree chunk [d_begin, d_begin + DC) over one block's rows.  first:
// the chunk that starts dt (and takes colsum(g)); last: the chunk that
// writes dx.
template <typename XT, int TP, int DC, bool ROUND>
__global__ void __launch_bounds__(MAX_FEAT)
fused_dw_bwd_kernel(const XT* __restrict__ x, const float* __restrict__ w2,
                    const float* __restrict__ g, XT* __restrict__ dx,
                    float* __restrict__ dt_acc, float* __restrict__ part,
                    float* __restrict__ gpart, int B, int in, int dp1, int T,
                    int rows, int d_begin, int apply_tanh, int want_dx,
                    int first, int last) {
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
        v = w2[((size_t)(d_begin + j) * in + i) * T + c];
        if (ROUND) v = bf16_round(v);
      }
      w[j][c] = v;
      acc[j][c] = 0.f;
    }
  }

  // dW_0 = colsum(g), unrounded: this row block's share, in row order, of
  // columns tid and tid + blockDim.x (T <= 64 <= 2 * blockDim.x)
  const bool colsum = first && blockIdx.y == 0;
  float csum0 = 0.f, csum1 = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += GROWS) {
    const int nr = min(GROWS, r_end - r0);
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < GROWS * TP; idx += blockDim.x) {
      const int rr = idx / TP, c = idx - rr * TP;
      g_s[idx] = (rr < nr && c < T) ? g[(size_t)(r0 + rr) * T + c] : 0.f;
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
    if (tid < T) gpart[(size_t)rb * T + tid] = csum0;
    if (tid + (int)blockDim.x < T) {
      gpart[(size_t)rb * T + tid + blockDim.x] = csum1;
    }
  }
  if (!active) return;
#pragma unroll
  for (int j = 0; j < DC; ++j) {
    if (j < nd) {
      float* dst =
          part + (((size_t)rb * (dp1 - 1) + (d_begin - 1 + j)) * in + i) * T;
#pragma unroll
      for (int c = 0; c < TP; ++c) {
        if (c < T) dst[c] = acc[j][c];
      }
    }
  }
}

// -- the fused single-layer train step (entry qkan_fused_step) ---------------
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
// want_dx = 0, so the workspace is K2's and the same fixed-order pass
// turns it into dW unchanged.  A block must own whole rows: g[r, :] needs
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
                  int B, int in, int dp1, int T, int rows, int chunk,
                  int super_rows, int apply_tanh, float g_scale) {
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
              w = w2[((size_t)d * in + i) * T + c];
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
          const float e = y != nullptr ? o - y[(size_t)b * T + c] : o;
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
                  part + (((size_t)rb * (dp1 - 1) + (d0 - 1 + j)) * in + i) * T;
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
            float* dst =
                part + (((size_t)rb * (dp1 - 1) + (d - 1)) * in + it2 % in) * T + c;
            *dst = first_super ? s : *dst + s;
          }
        }
      }
      __syncthreads();
    }
  }

  if (tid < T) gpart[(size_t)rb * T + tid] = gsum;
  l_s[tid] = lsum;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int k = 0; k < STEP_THREADS; ++k) s += l_s[k];
    lpart[rb] = s;
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

template <typename XT, int TP>
cudaError_t launch_step(const void* x, const float* w2, const float* y,
                        float* loss, float* ws, const Layout& L, int B,
                        int in, int dp1, int T, int apply_tanh,
                        float g_scale, float loss_scale, cudaStream_t s) {
  // widest chunk of features whose t and W staging fits its budget
  int chunk = 64;
  while (chunk > STEP_WARPS &&
         (GROWS * (chunk + 1) + dp1 * chunk * TP) * 4 > STEP_STAGE_BYTES) {
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
      L.rows, chunk, super_rows, apply_tanh, g_scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused_step_loss_kernel<<<1, 256, 0, s>>>(lpart, L.nrb, loss_scale, loss);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t dispatch_step(const void* x, const float* w2, const float* y,
                          float* loss, float* ws, const Layout& L, int B,
                          int in, int dp1, int T, int apply_tanh,
                          float g_scale, float loss_scale, cudaStream_t s) {
  switch (qkan::pad_t(T)) {
    case 4: return launch_step<XT, 4>(x, w2, y, loss, ws, L, B, in, dp1, T, apply_tanh, g_scale, loss_scale, s);
    case 8: return launch_step<XT, 8>(x, w2, y, loss, ws, L, B, in, dp1, T, apply_tanh, g_scale, loss_scale, s);
    case 12: return launch_step<XT, 12>(x, w2, y, loss, ws, L, B, in, dp1, T, apply_tanh, g_scale, loss_scale, s);
    case 16: return launch_step<XT, 16>(x, w2, y, loss, ws, L, B, in, dp1, T, apply_tanh, g_scale, loss_scale, s);
    case 32: return launch_step<XT, 32>(x, w2, y, loss, ws, L, B, in, dp1, T, apply_tanh, g_scale, loss_scale, s);
    default: return launch_step<XT, 64>(x, w2, y, loss, ws, L, B, in, dp1, T, apply_tanh, g_scale, loss_scale, s);
  }
}

template <typename XT, int TP, bool ROUND>
cudaError_t launch(const void* x, const float* w2, const float* g, void* dx,
                   float* ws, const Layout& L, int B, int in,
                   int dp1, int T, int apply_tanh, int want_dx,
                   cudaStream_t s) {
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
        gpart, B, in, dp1, T, L.rows, 1 + k * DC, apply_tanh, want_dx,
        k == 0, k == nchunks - 1);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename XT, bool ROUND>
cudaError_t dispatch_tp(const void* x, const float* w2, const float* g,
                        void* dx, float* ws, const Layout& L,
                        int B, int in, int dp1, int T, int apply_tanh,
                        int want_dx, cudaStream_t s) {
  switch (qkan::pad_t(T)) {
    case 4: return launch<XT, 4, ROUND>(x, w2, g, dx, ws, L, B, in, dp1, T, apply_tanh, want_dx, s);
    case 8: return launch<XT, 8, ROUND>(x, w2, g, dx, ws, L, B, in, dp1, T, apply_tanh, want_dx, s);
    case 12: return launch<XT, 12, ROUND>(x, w2, g, dx, ws, L, B, in, dp1, T, apply_tanh, want_dx, s);
    case 16: return launch<XT, 16, ROUND>(x, w2, g, dx, ws, L, B, in, dp1, T, apply_tanh, want_dx, s);
    case 32: return launch<XT, 32, ROUND>(x, w2, g, dx, ws, L, B, in, dp1, T, apply_tanh, want_dx, s);
    default: return launch<XT, 64, ROUND>(x, w2, g, dx, ws, L, B, in, dp1, T, apply_tanh, want_dx, s);
  }
}

bool bad_shape(int B, int in, int dp1, int T) {
  return B < 1 || in < 1 || dp1 < 1 || dp1 > 32 || T < 1 || T > 64;
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
  const Layout L = layout(B, in, dp1, T, want_dx);
  if (ws_bytes < 0 || (size_t)ws_bytes < workspace_bytes(L)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* w = static_cast<const float*>(w2);
  const float* gg = static_cast<const float*>(g);
  float* f = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_is_bf16) {
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
// and, past one degree chunk, the carried dt).
extern "C" long long qkan_fused_bwd_workspace_bytes(int B, int in, int dp1,
                                                    int T, int want_dx) {
  if (bad_shape(B, in, dp1, T)) return 0;
  return (long long)workspace_bytes(layout(B, in, dp1, T, want_dx));
}

// Row blocks of a backward call, the leading dimension of its partials.
extern "C" int qkan_fused_bwd_row_blocks(int B, int in, int dp1, int T) {
  if (bad_shape(B, in, dp1, T)) return 0;
  return layout(B, in, dp1, T, 0).nrb;
}

// Kernel launches that one call of either entry below makes when it
// succeeds: one per degree chunk.
extern "C" int qkan_fused_bwd_launches(int dp1, int T) {
  if (bad_shape(1, 1, dp1, T)) return 0;
  return degree_chunks(dp1, degree_chunk(qkan::pad_t(T)));
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

// The fixed-order pass alone, over a workspace that an entry above or
// qkan_fused_step filled for the same (B, in, dp1, T, want_dx): dw
// [dp1*in, T] f32, in the order of qkan_partial_sum_segments(nrb,
// (dp1-1)*in*T).
extern "C" int qkan_fused_bwd_partial_sum(const void* ws, long long ws_bytes,
                                          void* dw, int B, int in, int dp1,
                                          int T, int want_dx, void* stream) {
  if (bad_shape(B, in, dp1, T)) return (int)cudaErrorInvalidValue;
  const Layout L = layout(B, in, dp1, T, want_dx);
  if (ws_bytes < 0 || (size_t)ws_bytes < workspace_bytes(L)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)sum_workspace(static_cast<const float*>(ws), L, in, dp1, T,
                            static_cast<float*>(dw),
                            static_cast<cudaStream_t>(stream));
}

// Bytes of workspace a train step needs: a backward's with want_dx = 0
// (dW and colsum(g) partials), then one loss partial per row block.
extern "C" long long qkan_fused_step_workspace_bytes(int B, int in, int dp1,
                                                     int T) {
  if (bad_shape(B, in, dp1, T)) return 0;
  const Layout L = layout(B, in, dp1, T, 0);
  return (long long)(workspace_bytes(L) + (size_t)L.nrb * sizeof(float));
}

// The fused train step (kan_train_step_fused).  x: [B, in] f32
// (x_is_bf16=0) or bf16 (1); w2: [dp1*in, T] f32; y: [B, T] f32 for 'mse',
// null for 'sumsq' (then never read); loss: one f32; ws: at least
// qkan_fused_step_workspace_bytes; dw: [dp1*in, T] f32, or null.  All
// contiguous.  Launches the step kernel, the one-block loss sum and, given
// dw, the fixed-order pass into it (one call a step); without dw, dW comes
// from qkan_fused_bwd_partial_sum over ws with want_dx = 0.  Returns the
// CUDA error of the launches (0 on success), allocates nothing and does
// not synchronise.
extern "C" int qkan_fused_step(const void* x, const void* w2, const void* y,
                               void* loss, void* ws, long long ws_bytes,
                               int B, int in, int dp1, int T, int x_is_bf16,
                               int apply_tanh, float g_scale,
                               float loss_scale, void* dw, void* stream) {
  if (bad_shape(B, in, dp1, T)) return (int)cudaErrorInvalidValue;
  const Layout L = layout(B, in, dp1, T, 0);
  if (ws_bytes < 0 ||
      (size_t)ws_bytes < workspace_bytes(L) + (size_t)L.nrb * sizeof(float)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* w = static_cast<const float*>(w2);
  const float* yy = static_cast<const float*>(y);
  float* l = static_cast<float*>(loss);
  float* f = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_is_bf16
          ? dispatch_step<__nv_bfloat16>(x, w, yy, l, f, L, B, in, dp1, T, apply_tanh, g_scale, loss_scale, s)
          : dispatch_step<float>(x, w, yy, l, f, L, B, in, dp1, T, apply_tanh, g_scale, loss_scale, s);
  if (err != cudaSuccess || dw == nullptr) return (int)err;
  return (int)sum_workspace(f, L, in, dp1, T, static_cast<float*>(dw), s);
}
