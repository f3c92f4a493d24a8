// Degree-wise fused FixedKAN layer forward for Hopper (sm_90a).
//
// Replaces the TPU kernel qkan_implementation_tpu/ops/fused_layer.py:
// _fwd_kernel_degreewise (entry point kan_layer_fused_dw).  Computes
//
//     out[b, c] = colsum(W_0)[c] + sum_{d>=1} sum_i T_d(t[b, i]) W_d[i, c]
//     t = tanh(x) (or raw x),  T_d by the recurrence T_{d+1} = 2t T_d - T_{d-1}
//
// with w2 degree-major: W_d = w2[d*in : (d+1)*in, :].  The [B, dp1*in]
// basis is never written to device memory.
//
// What bounds it on an H100: at the flagship layer 0 (B=4096, in=784,
// dp1=6, T=10) one call reads x once (12.8 MB in f32) and does about
// 0.39 GFLOP of FP32 FMAs (B*in*(dp1-1)*T*2 plus the recurrence) -- near
// the balance point of 3.35 TB/s against 67 TFLOP/s FP32.  The design
// keeps both at one pass: x is read from device memory exactly once (each
// element by one thread, coalesced along `in`), tanh is taken once per
// element at load, and every T_d(t) value feeds all T output columns from
// registers.  W (188 KB at layer 0, too large to sit in shared memory next
// to the x tiles) is streamed in chunks of `chunk` input features for all
// degrees at once; it stays in L2 across blocks.
//
// Schedule.  A block owns ROWS=32 batch rows and NWARPS=8 warps.  Lane r
// of every warp holds row r; warp w takes the features w, w+8, ... of the
// current chunk, so the 32 lanes of a warp read the same W_d row (a shared
// memory broadcast) while each keeps T accumulators in registers.  After
// the last chunk the 8 per-warp partial sums are added in a fixed order
// through shared memory, so the result is deterministic.  Each block owns
// its rows: no reduction across blocks.
//
// T_0 term: colsum(W_0) exactly as the TPU kernel takes it (no products):
// threads c < T add up column c of each staged W_0 chunk.
//
// Precision.  round_bf16=0 ('high'/'default'): FP32 products and sums --
// true f32 on CUDA cores, so the TPU's bf16x3 split has no counterpart.
// round_bf16=1 ('bf16'): T_d and W_d (d >= 1) are rounded to bf16 before
// each product, products and sums in f32; W_0's colsum stays f32.  With a
// bf16 x, tanh and every recurrence op round to bf16, as torch does for a
// bf16 tensor, one op at a time.
//
// Limits (checked by the Python wrapper): 1 <= dp1 <= 32, 1 <= T <= 64.

#include <type_traits>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int ROWS = 32;
constexpr int NWARPS = 8;
constexpr int NTHREADS = ROWS * NWARPS;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load_as_float(const float* p) { return *p; }
__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// XT: x's element type; the recurrence rounds to it.  TP: T padded to a
// multiple of 4 (the register accumulator count).  ROUND: 'bf16' mode.
template <typename XT, int TP, bool ROUND>
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
        if (ROUND && d > 0) w = bf16_round(w);
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
        float nxt;
        if (XBF16) {
          nxt = bf16_round(__fsub_rn(bf16_round(__fmul_rn(2.f * t, cur)), prev));
        } else {
          nxt = __fsub_rn(__fmul_rn(2.f * t, cur), prev);
        }
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

template <typename XT, int TP, bool ROUND>
cudaError_t launch(const void* x, const float* w2, float* out, int B, int in,
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
  auto kernel = fused_dw_fwd_kernel<XT, TP, ROUND>;
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

template <typename XT, bool ROUND>
cudaError_t dispatch_tp(const void* x, const float* w2, float* out, int B,
                        int in, int dp1, int T, int apply_tanh,
                        cudaStream_t s) {
  if (T <= 4) return launch<XT, 4, ROUND>(x, w2, out, B, in, dp1, T, apply_tanh, s);
  if (T <= 8) return launch<XT, 8, ROUND>(x, w2, out, B, in, dp1, T, apply_tanh, s);
  if (T <= 12) return launch<XT, 12, ROUND>(x, w2, out, B, in, dp1, T, apply_tanh, s);
  if (T <= 16) return launch<XT, 16, ROUND>(x, w2, out, B, in, dp1, T, apply_tanh, s);
  if (T <= 32) return launch<XT, 32, ROUND>(x, w2, out, B, in, dp1, T, apply_tanh, s);
  return launch<XT, 64, ROUND>(x, w2, out, B, in, dp1, T, apply_tanh, s);
}

}  // namespace

// C entry point.  x: [B, in] f32 (x_is_bf16=0) or bf16 (1), contiguous;
// w2: [dp1*in, T] f32 contiguous; out: [B, T] f32.  Returns the CUDA error
// of the launch (0 on success).  Allocates nothing, does not synchronise.
extern "C" int qkan_fused_dw_fwd(const void* x, const void* w2, void* out,
                                 int B, int in, int dp1, int T, int x_is_bf16,
                                 int round_bf16, int apply_tanh,
                                 void* stream) {
  if (B < 1 || in < 1 || dp1 < 1 || dp1 > 32 || T < 1 || T > 64) {
    return (int)cudaErrorInvalidValue;
  }
  const float* w = static_cast<const float*>(w2);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_is_bf16) {
    err = round_bf16
              ? dispatch_tp<__nv_bfloat16, true>(x, w, o, B, in, dp1, T, apply_tanh, s)
              : dispatch_tp<__nv_bfloat16, false>(x, w, o, B, in, dp1, T, apply_tanh, s);
  } else {
    err = round_bf16
              ? dispatch_tp<float, true>(x, w, o, B, in, dp1, T, apply_tanh, s)
              : dispatch_tp<float, false>(x, w, o, B, in, dp1, T, apply_tanh, s);
  }
  return (int)err;
}

// Name of a CUDA error code, for the wrapper's exception message.
extern "C" const char* qkan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
