// Fused FixedKAN layer forward for Hopper (sm_90a).
//
// Replaces two TPU kernels of qkan_implementation_tpu/ops/fused_layer.py:
// _fwd_kernel_degreewise (entry qkan_fused_dw_fwd, for kan_layer_fused_dw)
// and _fwd_kernel (entry qkan_fused_fwd, for the v1 kan_layer_fused).
// Both compute
//
//     out[b, c] = colsum(W_0)[c] + sum_{d>=1} sum_i T_d(t[b, i]) W_d[i, c]
//     t = tanh(x) (or raw x),  T_d by the recurrence T_{d+1} = 2t T_d - T_{d-1}
//
// with w2 degree-major: W_d = w2[d*in : (d+1)*in, :].  The [B, dp1*in]
// basis is never written to device memory.  The v1 TPU kernel built the
// whole basis tile in VMEM and ran one dot; that schedule was a TPU choice,
// so the v1 entry shares these kernels and keeps only its rounding points.
//
// What bounds it on an H100 (bytes: x, w2 and out once over 3.35 TB/s;
// operations: 2 B in (dp1-1) T over 67 TFLOP/s FP32, or three TF32 passes
// over 495 TFLOP/s on the tensor cores).  A FixedKAN layer maps [B, in] to
// [B, target_dim], so the flagship [784,32,16,16,10] launches x[B, 784] @
// w2[6*784, 10] and three x[B, 10] @ w2[60, 10]; a target of 32 gives
// 784 -> 32.  At dp1 = 6:
//   784 -> 32, B 4096: 1.028 GFLOP, 15.3 us FP32 / 6.2 us 3xTF32, against
//                      14.0 MB (4.2 us): operations;
//   784 -> 10, B 4096: 0.32 GFLOP, 4.8 us FP32 / 1.9 us 3xTF32, against
//                      13.2 MB (3.9 us);
//   784 -> T, B 64:    w2 and x, 0.2-0.8 MB: bytes, under 0.25 us;
//   10 -> 10, B 4096:  0.33 MB, 0.1 us: the launch sets the pace.
//
// Two kernels, chosen by the sizes alone (fwd_tc below, C entry
// qkan_fused_fwd_tensor_cores):
//
// fused_dw_fwd_kernel_tc, the tensor-core kernel.  PR 1's kernel gave a
// block 32 rows and walked every feature: at B 64 that was 2 blocks on 132
// SMs, at B 4096 each of 128 blocks restaged all of W, and the tensor cores
// sat idle.  Here the grid is (64-row tiles) x (column tiles of up to 64)
// x (S feature splits), S a function of (B, in, dp1, T) alone (about 264
// blocks; never of the card's SM count, so every card gives the same
// bits).  A block walks its split's features in chunks of fc features x
// dg degrees (fc 32; 8 or 16 at narrow layers, and 16 past 32 features
// where 32 would cap the split count short of 264 blocks, as at the
// flagship's B 64): each thread builds its
// items' T_1 .. T_D in registers (tanh once an element, the recurrence
// carried across degree chunks, so any dp1) into a [64][fc*dg] basis tile
// in shared memory, while the next chunk's W rows arrive by cp.async in a
// two-stage ring and the next feature chunk's x is in flight.  The tile
// is contracted with mma.sync m16n8k8: warp w takes rows 16 (w & 3) ..
// +16, every n-tile, and the k-steps of parity w >> 2; the halves meet in
// shared memory in a fixed order.  3xTF32 ('high'/'default': FP32-class, as in the train
// step's kernel), one pass where both operands are exact in TF32 (the
// 'bf16' mode and the v1 entry on a bf16 x: bf16 values, so the products
// are exact and the sums f32), two where only the basis is (a bf16 x).
// colsum(W_0) is summed in f32 with no products, over the split's
// features.  S = 1 writes out; S > 1 writes per-split partials [S, B, T]
// to the caller's workspace and the same entry launches the fixed-order
// pass of partial_sum.cu over them (as K2/K4/K5 do).  No float atomics:
// the same bits on every run.  T past 64 takes more column tiles.  On an
// H100 80GB HBM3 at 700 W (tools/fwd_vs_old.py) 784 -> 10 takes about
// 35.5 us at B 4096 and 6.4 at B 64, against 88 and 87 for the CUDA-core
// kernel; the basis build and the products each take about a third of
// it, one after the other between two barriers a step (the tool's phase
// split and ablations): builders ahead of mma warps on a double-buffered
// basis, or wgmma, is the next step.
//
// fused_dw_fwd_kernel, the CUDA-core kernel of PR 1, where it is faster:
// the narrow layers (in <= 16), at the launch floor.  A block owns 32 rows
// and 8 warps: lane r of every warp holds row r, warp w takes features w,
// w+8, .. of a W chunk staged in shared memory for all degrees, T
// accumulators in registers; the per-warp partials are added in a fixed
// order.  It takes dp1 <= 32 and T <= 64 (the rule sends the rest to the
// tensor cores).
//
// Precision.  round_bf16=0 ('high'/'default'): FP32-class products and f32
// sums.  round_bf16=1 (degree-wise 'bf16'): T_d and W_d (d >= 1) are
// rounded to bf16 before each product, products and sums in f32; W_0's
// colsum stays f32.  With a bf16 x, tanh and every recurrence op round to
// bf16, as torch does for a bf16 tensor, one op at a time.  The v1 entry
// with a bf16 x rounds all of w2 to bf16, W_0 included (template flag W0R),
// as _fwd_kernel casts w2 to the basis dtype; with an f32 x it is the
// degree-wise 'high' path.  -DQKAN_FWD_TC=0 takes the CUDA-core kernel
// wherever it takes the shape (tools/fwd_vs_old.py builds it beside the
// package's rule).

#include <cstdint>
#include <type_traits>

#include "qkan_common.cuh"
#include "tc_common.cuh"

#ifndef QKAN_FWD_TC
#define QKAN_FWD_TC 1
#endif

namespace {

using qkan::a_frag;
using qkan::acc_sets;
using qkan::acc_total;
using qkan::b_frag;
using qkan::bf16_round;
using qkan::load_as_float;
using qkan::mma_3x;

// -- the CUDA-core kernel ----------------------------------------------------

constexpr int ROWS = 32;
constexpr int NWARPS = 8;
constexpr int NTHREADS = ROWS * NWARPS;

// XT: x's element type; the recurrence rounds to it.  TP: T padded to a
// multiple of 4 (the register accumulator count).  ROUND: round W_d (d >= 1)
// and T_d to bf16.  W0R: round W_0 too (the v1 entry with a bf16 x).
template <typename XT, int TP, bool ROUND, bool W0R>
__global__ void __launch_bounds__(NTHREADS)
fused_dw_fwd_kernel(const XT* __restrict__ x, const float* __restrict__ w2,
                    float* __restrict__ out, int B, int in, int dp1, int T,
                    int chunk, int apply_tanh) {
  constexpr bool XBF16 = !std::is_same<XT, float>::value;
  extern __shared__ __align__(16) float smem[];
  const int ts_stride = chunk + 1;              // odd: lanes hit distinct banks
  float* t_s = smem;                            // [ROWS][chunk + 1]
  float* w_s = smem + ROWS * ts_stride;         // [dp1][chunk][TP]
  // the final reduction reuses the staging area; csum_s sits past both
  const int stage = ROWS * ts_stride + dp1 * chunk * TP;
  const int red = NWARPS * ROWS * (TP + 1);
  float* csum_s = smem + (stage > red ? stage : red);  // [TP]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * ROWS;

  float acc[TP];
#pragma unroll
  for (int c = 0; c < TP; ++c) acc[c] = 0.f;
  float csum = 0.f;  // colsum(W_0)[tid], used by threads tid < T

  for (int i0 = 0; i0 < in; i0 += chunk) {
    // stage t = tanh(x) for the tile, once per element
    for (int idx = tid; idx < ROWS * chunk; idx += NTHREADS) {
      const int r = idx / chunk, k = idx - r * chunk;
      const int b = row0 + r, i = i0 + k;
      float t = 0.f;
      if (b < B && i < in) {
        t = load_as_float(x + (size_t)b * in + i);
        if (apply_tanh) {
          t = tanhf(t);
          if (XBF16) t = bf16_round(t);
        }
      }
      t_s[r * ts_stride + k] = t;
    }
    // stage the W chunk of every degree; rows past `in` and columns past
    // T are zero, so they add nothing
    for (int idx = tid; idx < dp1 * chunk * TP; idx += NTHREADS) {
      const int d = idx / (chunk * TP);
      const int rem = idx - d * chunk * TP;
      const int k = rem / TP, c = rem - k * TP;
      const int i = i0 + k;
      float w = 0.f;
      if (i < in && c < T) {
        w = w2[((size_t)d * in + i) * T + c];
        if (ROUND && (W0R || d > 0)) w = bf16_round(w);
      }
      w_s[idx] = w;
    }
    __syncthreads();

    if (tid < T) {
      for (int k = 0; k < chunk; ++k) csum += w_s[k * TP + tid];
    }
    for (int k = warp; k < chunk; k += NWARPS) {
      const float t = t_s[lane * ts_stride + k];
      float prev = 1.f, cur = t;
      for (int d = 1; d < dp1; ++d) {
        const float a = (ROUND && !XBF16) ? bf16_round(cur) : cur;
        const float4* w4 =
            reinterpret_cast<const float4*>(w_s + (d * chunk + k) * TP);
#pragma unroll
        for (int q = 0; q < TP / 4; ++q) {
          const float4 w = w4[q];
          acc[4 * q + 0] = fmaf(a, w.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(a, w.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(a, w.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(a, w.w, acc[4 * q + 3]);
        }
        // (2t * T_d) - T_{d-1}, each op rounded as torch rounds it: no
        // contraction into one FMA
        const float nxt = qkan::cheb_next<XBF16>(2.f * t, cur, prev);
        prev = cur;
        cur = nxt;
      }
    }
    __syncthreads();
  }

  // fixed-order sum of the per-warp partials
  float* red_s = smem;  // [NWARPS][ROWS][TP + 1]
  if (tid < T) csum_s[tid] = csum;
#pragma unroll
  for (int c = 0; c < TP; ++c) red_s[(warp * ROWS + lane) * (TP + 1) + c] = acc[c];
  __syncthreads();
  for (int idx = tid; idx < ROWS * T; idx += NTHREADS) {
    const int r = idx / T, c = idx - r * T;
    const int b = row0 + r;
    if (b >= B) continue;
    float s = csum_s[c];
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) s += red_s[(w * ROWS + r) * (TP + 1) + c];
    out[(size_t)b * T + c] = s;
  }
}

template <typename XT, int TP, bool ROUND, bool W0R>
cudaError_t launch_cc(const void* x, const float* w2, float* out, int B, int in,
                   int dp1, int T, int apply_tanh, cudaStream_t stream) {
  // widest chunk whose staging fits the budget; a multiple of NWARPS
  const int budget = 160 * 1024;
  int chunk = 64;
  while (chunk > NWARPS &&
         (ROWS * (chunk + 1) + dp1 * chunk * TP + TP) * 4 > budget) {
    chunk /= 2;
  }
  const int in_pad = (in + NWARPS - 1) / NWARPS * NWARPS;
  if (chunk > in_pad) chunk = in_pad;
  // staging or reduction area (they alias), then csum_s: as in the kernel
  const size_t stage = (size_t)ROWS * (chunk + 1) + (size_t)dp1 * chunk * TP;
  const size_t red = (size_t)NWARPS * ROWS * (TP + 1);
  const size_t floats = (stage > red ? stage : red) + TP;
  const size_t bytes = floats * sizeof(float);
  auto kernel = fused_dw_fwd_kernel<XT, TP, ROUND, W0R>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((B + ROWS - 1) / ROWS);
  kernel<<<grid, NTHREADS, bytes, stream>>>(static_cast<const XT*>(x), w2,
                                            out, B, in, dp1, T, chunk,
                                            apply_tanh);
  return cudaGetLastError();
}

template <typename XT, bool ROUND, bool W0R>
cudaError_t dispatch_cc(const void* x, const float* w2, float* out, int B,
                        int in, int dp1, int T, int apply_tanh,
                        cudaStream_t s) {
  switch (qkan::pad_t(T)) {
    case 4: return launch_cc<XT, 4, ROUND, W0R>(x, w2, out, B, in, dp1, T, apply_tanh, s);
    case 8: return launch_cc<XT, 8, ROUND, W0R>(x, w2, out, B, in, dp1, T, apply_tanh, s);
    case 12: return launch_cc<XT, 12, ROUND, W0R>(x, w2, out, B, in, dp1, T, apply_tanh, s);
    case 16: return launch_cc<XT, 16, ROUND, W0R>(x, w2, out, B, in, dp1, T, apply_tanh, s);
    case 32: return launch_cc<XT, 32, ROUND, W0R>(x, w2, out, B, in, dp1, T, apply_tanh, s);
    default: return launch_cc<XT, 64, ROUND, W0R>(x, w2, out, B, in, dp1, T, apply_tanh, s);
  }
}


// -- the tensor-core kernel --------------------------------------------------

constexpr int FR = 64;             // rows of a tile
constexpr int FTH = 256;           // threads: 8 warps
constexpr int FKB = 256;           // basis columns of a chunk, at most
constexpr int FGRID = 264;         // blocks the split count aims at (2 x 132)
constexpr size_t FSMEM = 110 * 1024;  // shared memory a block: two an SM
constexpr int CC_MAX_IN = 16;      // the CUDA-core kernel's layers

// W tile row stride for tn columns: lanes (t4, g8) read rows t4 and columns
// g8 of it, on 32 distinct banks
__host__ __device__ constexpr int w_stride(int tn) {
  return tn == 8 ? 8 : tn == 16 ? 24 : tn + 8;
}

struct FwdPlan {
  int fc;       // features a chunk: 8 or 16 (narrow layers, or where 32
                // would leave the split count short of FGRID), else 32
  int fcs;      // log2(fc)
  int dg;       // degrees a chunk
  int kb;       // basis columns a chunk, fc * dg
  int bs;       // basis row stride: kb rounded up to 32, + 4
  int nt;       // n8-tiles of a column tile: 1, 2, 4 or 8
  int ctiles;   // column tiles
  int nfc;      // feature chunks
  int ngroups;  // degree chunks (0 at dp1 = 1)
  int splits;   // feature splits S
  int rtiles;   // 64-row tiles
  size_t smem;  // dynamic shared memory bytes
};

FwdPlan fwd_plan(int B, int in, int dp1, int T) {
  FwdPlan p{};
  const int tw = T < 64 ? T : 64;
  const int n8 = (tw + 7) / 8;
  p.nt = n8 <= 1 ? 1 : n8 <= 2 ? 2 : n8 <= 4 ? 4 : 8;
  const int tn = 8 * p.nt;
  p.ctiles = (T + tn - 1) / tn;
  p.rtiles = (B + FR - 1) / FR;
  const long long base = (long long)p.rtiles * p.ctiles;
  // 32 features a chunk, unless the splits would run out of chunks short
  // of FGRID blocks (a small batch past 32 features): then 16, twice the
  // blocks
  p.fcs = in <= 8 ? 3
          : in <= 16 || (in > 32 && FGRID / base > (in + 31) / 32) ? 4
                                                                  : 5;
  p.fc = 1 << p.fcs;
  p.nfc = (in + p.fc - 1) / p.fc;
  // the most degrees a chunk whose tiles fit two blocks an SM
  int dg = dp1 - 1 < FKB / p.fc ? dp1 - 1 : FKB / p.fc;
  if (dg < 1) dg = 1;
  for (;; --dg) {
    const int kb = p.fc * dg, bs = (kb + 31) / 32 * 32 + 4;
    const size_t smem = 4 * ((size_t)FR * bs + 2 * (size_t)kb * w_stride(tn) +
                             512 * (size_t)p.nt + FTH + tn);
    if (smem <= FSMEM || dg == 1) {
      p.dg = dg;
      p.kb = kb;
      p.bs = bs;
      p.smem = smem;
      break;
    }
  }
  p.ngroups = dp1 > 1 ? (dp1 - 1 + p.dg - 1) / p.dg : 0;
  long long s = FGRID / base;
  if (s > p.nfc) s = p.nfc;
  if (s < 1) s = 1;
  p.splits = (int)s;
  return p;
}

// the route: the tensor cores unless the CUDA-core kernel takes the shape
// and the layer is narrow
bool fwd_tc(int B, int in, int dp1, int T) {
  (void)B;
  const bool cc_takes = dp1 <= 32 && T <= 64;
  if (QKAN_FWD_TC == 0) return !cc_takes;
  return !(cc_takes && in <= CC_MAX_IN);
}

// The W rows of one step into a stage [kb][WS], column k = j fc + f of
// the basis (degree d0 + j, feature i0 + f); V floats a copy, zeros past
// dp1, in and T.  The indices take shifts only (fc and TN / V are powers
// of 2).
template <int V, int TN, int WS>
__device__ __forceinline__ void load_w(float* stage,
                                       const float* __restrict__ w2, int d0,
                                       int i0, int dp1, int in, int T,
                                       int c0, int kb, int fcs) {
  constexpr unsigned PER = TN / V;  // copies a row
  const int fmask = (1 << fcs) - 1;
  for (unsigned e = threadIdx.x; e < (unsigned)kb * PER; e += FTH) {
    const int k = (int)(e / PER), n = (int)(e % PER) * V;
    const int d = d0 + (k >> fcs), i = i0 + (k & fmask), c = c0 + n;
    int bytes = 0;
    const float* src = w2;
    if (d < dp1 && i < in && c < T) {
      bytes = 4 * (T - c < V ? T - c : V);
      src = w2 + ((size_t)d * in + i) * T + c;
    }
    if (V == 4) {
      qkan::cp_async16(stage + k * WS + n, src, bytes);
    } else if (V == 2) {
      qkan::cp_async8(stage + k * WS + n, src, bytes);
    } else {
      qkan::cp_async4(stage + k * WS + n, src, bytes);
    }
  }
  qkan::cp_async_commit();
}

template <typename XT, int NT, bool ROUND, bool W0R>
__global__ void __launch_bounds__(FTH, 2)
fused_dw_fwd_kernel_tc(const XT* __restrict__ x, const float* __restrict__ w2,
                       float* __restrict__ dst, int B, int in, int dp1, int T,
                       int fc, int fcs, int dg, int kb, int bs, int nfc,
                       int ngroups, int splits, int wv, int apply_tanh) {
  constexpr bool XBF16 = !std::is_same<XT, float>::value;
  constexpr bool EXACT_A = XBF16 || ROUND;  // the basis is bf16: TF32-exact
  constexpr bool EXACT_B = ROUND;           // W_d rounded to bf16
  constexpr int TN = 8 * NT;
  constexpr int WS = w_stride(TN);
  constexpr int FSETS = acc_sets(NT);
  extern __shared__ __align__(16) float smem[];
  float* basis = smem;                   // [64][bs]
  float* wring = basis + FR * bs;        // 2 x [kb][WS]
  float* ored = wring + 2 * kb * WS;     // [4][32][4 NT]
  float* cred = ored + 512 * NT;         // [FTH]
  float* csum = cred + FTH;              // [TN]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int fm = warp & 3, kh = warp >> 2;
  const int r0 = blockIdx.x * FR;
  const int c0 = blockIdx.y * TN;
  const int split = blockIdx.z;
  const int fc_begin = (int)((long long)split * nfc / splits);
  const int fc_end = (int)((long long)(split + 1) * nfc / splits);
  const int steps = (fc_end - fc_begin) * ngroups;
  // out itself, or this split's partial [B, T]
  float* out = dst + (size_t)split * B * T;

  // this thread's basis items: feature f of rows r_item + rstep q, q < nq
  const int nq = fc / 4;
  const int f = tid % fc, r_item = tid / fc, rstep = FTH / fc;

  float xr[8], tt[8], cur[8], prev[8];
  float o[FSETS][NT][4];
#pragma unroll
  for (int a = 0; a < FSETS; ++a)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) o[a][n][q] = 0.f;

  // the W rows of step s (degrees 1 + g dg .. of feature chunk fci) into
  // a stage: 16-, 8- or 4-byte copies as T and w2's alignment allow
#define QKAN_LOAD_W(s, stage)                                                \
  {                                                                          \
    const int fci_ = fc_begin + (s) / ngroups;                               \
    const int d0_ = 1 + ((s) - ((s) / ngroups) * ngroups) * dg;              \
    if (wv == 4) {                                                           \
      load_w<4, TN, WS>((stage), w2, d0_, fci_ * fc, dp1, in, T, c0, kb, fcs); \
    } else if (wv == 2) {                                                    \
      load_w<2, TN, WS>((stage), w2, d0_, fci_ * fc, dp1, in, T, c0, kb, fcs); \
    } else {                                                                 \
      load_w<1, TN, WS>((stage), w2, d0_, fci_ * fc, dp1, in, T, c0, kb, fcs); \
    }                                                                        \
  }
  // x of feature chunk fci for this thread's items (zeros past B and in)
#define QKAN_LOAD_X(fci)                                                     \
  {                                                                          \
    const int i_ = (fci) * fc + f;                                           \
    _Pragma("unroll") for (int q = 0; q < 8; ++q) {                          \
      const int b_ = r0 + r_item + rstep * q;                                \
      xr[q] = 0.f;                                                           \
      if (q < nq && b_ < B && i_ < in) {                                     \
        xr[q] = load_as_float(x + (size_t)b_ * in + i_);                     \
      }                                                                      \
    }                                                                        \
  }

  if (steps > 0) {
    QKAN_LOAD_W(0, wring)
    QKAN_LOAD_X(fc_begin)
  }
  // colsum(W_0) over the split's features, no products: column c0 + tid %
  // TN, the features dealt to FTH / TN groups, each in order
  {
    const int cg = tid / TN, c = c0 + tid % TN;
    const int i_end = fc_end * fc < in ? fc_end * fc : in;
    float s = 0.f;
    if (c < T) {
#pragma unroll 4
      for (int i = fc_begin * fc + cg; i < i_end; i += FTH / TN) {
        float w = w2[(size_t)i * T + c];
        if (W0R) w = bf16_round(w);
        s += w;
      }
    }
    cred[tid] = s;
  }

  int g = 0, fci = fc_begin;  // degree chunk and feature chunk of step s
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) QKAN_LOAD_W(s + 1, wring + ((s + 1) & 1) * kb * WS)
    // the basis of step s: T_{1 + g dg + j}, j < dg, of each item
    if (g == 0) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float t = xr[q];
        if (apply_tanh) {
          t = tanhf(t);
          if (XBF16) t = bf16_round(t);
        }
        tt[q] = 2.f * t;
        prev[q] = 1.f;
        cur[q] = t;
      }
    }
    for (int j = 0; j < dg; ++j) {
      const bool live = 1 + g * dg + j < dp1;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (q < nq) {
          float v = live ? cur[q] : 0.f;
          if (ROUND && !XBF16) v = bf16_round(v);
          basis[(r_item + rstep * q) * bs + j * fc + f] = v;
          const float nxt = qkan::cheb_next<XBF16>(tt[q], cur[q], prev[q]);
          prev[q] = cur[q];
          cur[q] = nxt;
        }
      }
    }
    if (++g == ngroups) {
      g = 0;
      ++fci;
      // the next feature chunk's x is in flight during these products
      if (s + 1 < steps) QKAN_LOAD_X(fci)
    }
    if (s + 1 < steps) {
      qkan::cp_async_wait<1>();
    } else {
      qkan::cp_async_wait<0>();
    }
    __syncthreads();  // the basis and W of step s are in

    {
      const float* wst = wring + (s & 1) * kb * WS;
      const float* rowa = basis + (fm * 16 + g8) * bs;
      const float* rowb = rowa + 8 * bs;
#pragma unroll 2
      for (int k0 = 8 * kh; k0 < kb; k0 += 16) {
        float2 a[4];
        a_frag<EXACT_A>(a, rowa[k0 + t4], rowb[k0 + t4], rowa[k0 + t4 + 4],
                        rowb[k0 + t4 + 4]);
        const float* w0 = wst + (k0 + t4) * WS + g8;
        const float* w1 = w0 + 4 * WS;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          float2 bv = make_float2(w0[8 * n], w1[8 * n]);
          if (ROUND) {
            bv.x = bf16_round(bv.x);
            bv.y = bf16_round(bv.y);
          }
          mma_3x<EXACT_A, EXACT_B>(o[0][n], o[FSETS > 1 ? 1 : 0][n],
                                   o[FSETS - 1][n], a, b_frag<EXACT_B>(bv));
        }
      }
    }
    __syncthreads();  // step s's readers are done with its basis and stage
  }
#undef QKAN_LOAD_W
#undef QKAN_LOAD_X

  __syncthreads();  // cred is in (no steps at dp1 = 1)
  float* mine = ored + (fm * 32 + lane) * 4 * NT;
  if (kh == 1) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        mine[n * 4 + q] = acc_total<FSETS>(o[0][n][q], o[FSETS > 1 ? 1 : 0][n][q],
                                           o[FSETS - 1][n][q]);
      }
  }
  if (tid < TN) {
    float s = 0.f;
    for (int e = 0; e < FTH / TN; ++e) s += cred[e * TN + tid];
    csum[tid] = s;
  }
  __syncthreads();
  if (kh == 0) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = fm * 16 + g8 + (q >> 1) * 8;
        const int cl = n * 8 + 2 * t4 + (q & 1);
        const int b = r0 + r, c = c0 + cl;
        if (b < B && c < T) {
          const float prod =
              acc_total<FSETS>(o[0][n][q], o[FSETS > 1 ? 1 : 0][n][q],
                               o[FSETS - 1][n][q]) +
              mine[n * 4 + q];
          out[(size_t)b * T + c] = csum[cl] + prod;
        }
      }
  }
}

template <typename XT, int NT, bool ROUND, bool W0R>
cudaError_t launch_tc(const void* x, const float* w2, float* dst,
                      const FwdPlan& p, int B, int in, int dp1, int T,
                      int apply_tanh, cudaStream_t s) {
  auto kernel = fused_dw_fwd_kernel_tc<XT, NT, ROUND, W0R>;
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return err;
  }
  // floats a copy of W: 16 bytes where T and w2 allow, else 8, else 4
  const std::uintptr_t a = reinterpret_cast<std::uintptr_t>(w2);
  const int wv = T % 4 == 0 && a % 16 == 0 ? 4 : T % 2 == 0 && a % 8 == 0 ? 2 : 1;
  const dim3 grid(p.rtiles, p.ctiles, p.splits);
  kernel<<<grid, FTH, p.smem, s>>>(static_cast<const XT*>(x), w2, dst, B, in,
                                   dp1, T, p.fc, p.fcs, p.dg, p.kb, p.bs,
                                   p.nfc, p.ngroups, p.splits, wv,
                                   apply_tanh);
  return cudaGetLastError();
}

size_t fwd_ws_floats(int B, int in, int dp1, int T) {
  if (!fwd_tc(B, in, dp1, T)) return 0;
  const FwdPlan p = fwd_plan(B, in, dp1, T);
  return p.splits > 1 ? (size_t)p.splits * B * T : 0;
}

// one forward on the route of fwd_tc: the kernel and, past one split, the
// fixed-order pass over the partials in ws
template <typename XT, bool ROUND, bool W0R>
cudaError_t run(const void* x, const float* w2, float* out, float* ws, int B,
                int in, int dp1, int T, int apply_tanh, cudaStream_t s) {
  if (!fwd_tc(B, in, dp1, T)) {
    return dispatch_cc<XT, ROUND, W0R>(x, w2, out, B, in, dp1, T, apply_tanh,
                                       s);
  }
  const FwdPlan p = fwd_plan(B, in, dp1, T);
  float* dst = p.splits > 1 ? ws : out;
  cudaError_t err;
  switch (p.nt) {
    case 1: err = launch_tc<XT, 1, ROUND, W0R>(x, w2, dst, p, B, in, dp1, T, apply_tanh, s); break;
    case 2: err = launch_tc<XT, 2, ROUND, W0R>(x, w2, dst, p, B, in, dp1, T, apply_tanh, s); break;
    case 4: err = launch_tc<XT, 4, ROUND, W0R>(x, w2, dst, p, B, in, dp1, T, apply_tanh, s); break;
    default: err = launch_tc<XT, 8, ROUND, W0R>(x, w2, dst, p, B, in, dp1, T, apply_tanh, s); break;
  }
  if (err != cudaSuccess || p.splits == 1) return err;
  return qkan::partial_sum(ws, (long long)B * T, p.splits, out, nullptr, 0,
                           0, nullptr, s);
}

bool bad_shape(int B, int in, int dp1, int T) {
  return B < 1 || in < 1 || dp1 < 1 || T < 1;
}

bool bad_call(int B, int in, int dp1, int T, long long ws_bytes) {
  return bad_shape(B, in, dp1, T) || ws_bytes < 0 ||
         (size_t)ws_bytes < fwd_ws_floats(B, in, dp1, T) * sizeof(float);
}

}  // namespace

// C entry points.  x: [B, in] f32 (x_is_bf16=0) or bf16 (1), contiguous;
// w2: [dp1*in, T] f32 contiguous; out: [B, T] f32; ws: a workspace of at
// least qkan_fused_fwd_workspace_bytes (null when that is 0), which
// receives the feature splits' partials.  Each launches the kernel of the
// route (and, past one split, the fixed-order pass), returns the CUDA
// error of its launches (0 on success), allocates nothing and does not
// synchronise.
//
// Degree-wise layer (kan_layer_fused_dw); round_bf16 selects 'bf16'.
extern "C" int qkan_fused_dw_fwd(const void* x, const void* w2, void* out,
                                 void* ws, long long ws_bytes, int B, int in,
                                 int dp1, int T, int x_is_bf16,
                                 int round_bf16, int apply_tanh,
                                 void* stream) {
  if (bad_call(B, in, dp1, T, ws_bytes)) return (int)cudaErrorInvalidValue;
  const float* w = static_cast<const float*>(w2);
  float* o = static_cast<float*>(out);
  float* f = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_is_bf16) {
    err = round_bf16
              ? run<__nv_bfloat16, true, false>(x, w, o, f, B, in, dp1, T, apply_tanh, s)
              : run<__nv_bfloat16, false, false>(x, w, o, f, B, in, dp1, T, apply_tanh, s);
  } else {
    err = round_bf16
              ? run<float, true, false>(x, w, o, f, B, in, dp1, T, apply_tanh, s)
              : run<float, false, false>(x, w, o, f, B, in, dp1, T, apply_tanh, s);
  }
  return (int)err;
}

// v1 layer (kan_layer_fused): x's dtype decides the rounding.
extern "C" int qkan_fused_fwd(const void* x, const void* w2, void* out,
                              void* ws, long long ws_bytes, int B, int in,
                              int dp1, int T, int x_is_bf16, int apply_tanh,
                              void* stream) {
  if (bad_call(B, in, dp1, T, ws_bytes)) return (int)cudaErrorInvalidValue;
  const float* w = static_cast<const float*>(w2);
  float* o = static_cast<float*>(out);
  float* f = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      x_is_bf16
          ? run<__nv_bfloat16, true, true>(x, w, o, f, B, in, dp1, T, apply_tanh, s)
          : run<float, false, false>(x, w, o, f, B, in, dp1, T, apply_tanh, s);
  return (int)err;
}

// Bytes of workspace a forward needs: the splits' partials [S, B, T] f32
// where S > 1 on the tensor-core route, else 0.
extern "C" long long qkan_fused_fwd_workspace_bytes(int B, int in, int dp1,
                                                    int T) {
  if (bad_shape(B, in, dp1, T)) return 0;
  return (long long)(fwd_ws_floats(B, in, dp1, T) * sizeof(float));
}

// 1 where a forward at these sizes runs the tensor-core kernel, 0 where it
// runs the CUDA-core one (fwd_tc).
extern "C" int qkan_fused_fwd_tensor_cores(int B, int in, int dp1, int T) {
  if (bad_shape(B, in, dp1, T)) return 0;
  return fwd_tc(B, in, dp1, T) ? 1 : 0;
}

// Feature splits S of a forward on the tensor-core route (fwd_plan; 1 on
// the CUDA-core route): past 1 the entries also launch the pass.
extern "C" int qkan_fused_fwd_splits(int B, int in, int dp1, int T) {
  if (bad_shape(B, in, dp1, T)) return 0;
  return fwd_tc(B, in, dp1, T) ? fwd_plan(B, in, dp1, T).splits : 1;
}

// Name of a CUDA error code, for the wrapper's exception message.
extern "C" const char* qkan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
