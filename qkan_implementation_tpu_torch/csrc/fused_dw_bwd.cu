// Fused FixedKAN layer backward for Hopper (sm_90a).
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
// block writes its dW partial to a workspace; a second kernel (its own
// entry, qkan_fused_bwd_partial_sum, launched next by the wrapper) sums the
// partials over row blocks in a fixed order.  No float atomics, so a run
// gives the same bits every time.  Rows per block are chosen so that the
// partials stay under 4 MB.  Past DC degrees (large dp1 or T) the degree
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
constexpr int degree_chunk(int tp) { return tp >= 64 ? 1 : 64 / tp; }

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

// The fixed-order pass: dw[d, i, c] = sum over row blocks of the partials,
// in row-block order.  dW_0 rows all take the colsum(g) sum.
__global__ void fused_bwd_partial_sum_kernel(const float* __restrict__ part,
                                             const float* __restrict__ gpart,
                                             float* __restrict__ dw, int nrb,
                                             int in, int dp1, int T) {
  const size_t per_d = (size_t)in * T;
  const size_t total = (size_t)dp1 * per_d;
  const size_t stride = (size_t)(dp1 - 1) * per_d;  // one row block's share
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (size_t)gridDim.x * blockDim.x) {
    const size_t d = idx / per_d;
    const size_t rem = idx - d * per_d;
    float s = 0.f;
    if (d == 0) {
      const size_t c = rem % T;
      for (int rb = 0; rb < nrb; ++rb) s += gpart[(size_t)rb * T + c];
    } else {
      const float* p = part + (d - 1) * per_d + rem;
      for (int rb = 0; rb < nrb; ++rb) s += p[(size_t)rb * stride];
    }
    dw[idx] = s;
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

int run(const void* x, const void* w2, const void* g, void* dx, void* ws,
        long long ws_bytes, int B, int in, int dp1, int T,
        int x_is_bf16, int round_bf16, int apply_tanh, int want_dx,
        void* stream) {
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
  return (int)err;
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

// C entry points of the per-block pass.  x: [B, in] f32 (x_is_bf16=0) or
// bf16 (1); w2: [dp1*in, T] f32; g: [B, T] f32; dx: [B, in] in x's dtype
// (may be null when want_dx = 0); ws: the workspace, of at least
// qkan_fused_bwd_workspace_bytes, which receives the partials.  All
// contiguous.  Each returns the CUDA error of its launches (0 on success),
// allocates nothing and does not synchronise.
//
// Degree-wise layer (kan_layer_fused_dw); round_bf16 selects 'bf16'.
extern "C" int qkan_fused_dw_bwd(const void* x, const void* w2, const void* g,
                                 void* dx, void* ws, long long ws_bytes, int B,
                                 int in, int dp1, int T, int x_is_bf16,
                                 int round_bf16, int apply_tanh, int want_dx,
                                 void* stream) {
  return run(x, w2, g, dx, ws, ws_bytes, B, in, dp1, T, x_is_bf16,
             round_bf16, apply_tanh, want_dx, stream);
}

// v1 layer (kan_layer_fused): 'high'/'default' only.
extern "C" int qkan_fused_bwd(const void* x, const void* w2, const void* g,
                              void* dx, void* ws, long long ws_bytes, int B,
                              int in, int dp1, int T, int x_is_bf16,
                              int apply_tanh, int want_dx, void* stream) {
  return run(x, w2, g, dx, ws, ws_bytes, B, in, dp1, T, x_is_bf16, 0,
             apply_tanh, want_dx, stream);
}

// The fixed-order pass over a workspace that either entry above filled
// for the same (B, in, dp1, T, want_dx): dw [dp1*in, T] f32.
extern "C" int qkan_fused_bwd_partial_sum(const void* ws, long long ws_bytes,
                                          void* dw, int B, int in, int dp1,
                                          int T, int want_dx, void* stream) {
  if (bad_shape(B, in, dp1, T)) return (int)cudaErrorInvalidValue;
  const Layout L = layout(B, in, dp1, T, want_dx);
  if (ws_bytes < 0 || (size_t)ws_bytes < workspace_bytes(L)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* part = static_cast<const float*>(ws);
  const size_t total = (size_t)dp1 * in * T;
  size_t blocks = (total + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  fused_bwd_partial_sum_kernel<<<(unsigned)blocks, 256, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      part, part + L.part_floats, static_cast<float*>(dw), L.nrb, in, dp1, T);
  return (int)cudaGetLastError();
}
