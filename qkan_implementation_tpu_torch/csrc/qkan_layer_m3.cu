// The batched QKAN layer over the degree-major contraction tensor M3
// [dp1, N, K], forward and backward, for Hopper (sm_90a).
//
// Replaces the three TPU kernels of
// qkan_implementation_tpu/experimental/pallas_layer.py: _fwd_kernel (entry
// qkan_m3_fwd), _bwd_kernel (entry qkan_m3_bwd with want_dx = 1) and
// _bwd_dw_kernel (the same entry with want_dx = 0).  On raw x (no tanh, no
// clip) and the output cotangent g [B, K]:
//
//     out[b, k]  = sum_{d, n} T_d(x[b, n]) M3[d, n, k]
//     dM[d, n, k] = sum_b T_d(x[b, n]) g[b, k]      (dM[0, n, :] = colsum(g))
//     dx[b, n]   = sum_{d>=1} d U_{d-1}(x[b, n]) (g @ M3[d]^T)[b, n]
//
// x, out, g and dx are f32 or bf16 (all in x's dtype), M3 and dM f32.  A
// bf16 x runs the T and U recurrences in bf16, one rounding an op, as the
// TPU kernel's jnp ops on a bf16 tile do; every product and sum is f32 (the
// TPU kernel's preferred_element_type), and out and dx round to x's dtype
// once, at the store.  d * U_{d-1} rounds to bf16 before its product with
// the f32 g.M3[d]^T, as the TPU kernel's bf16 multiply does.
//
// What bounds it on an H100: at the headline layer (B = 262144, N = K = 16,
// dp1 = 8) the forward reads x (16.8 MB) and writes out (16.8 MB), 10 us at
// 3.35 TB/s, against 2 B N (dp1 - 1) K = 0.94 GFLOP of FP32 FMAs, 14 us at
// 67 TFLOP/s: operations.  The backward with dx does twice the FMAs (28 us)
// for x + g + dx (15 us).  The design keeps the basis out of device memory
// (the TPU kernels' point) and M3, a few KB, in shared memory.
//
// Forward schedule.  A block stages M3 once (zero-padded to KP columns) and
// walks its rows grid-stride, one row a thread: the tile of x is staged in
// shared memory with coalesced loads, and the thread keeps KC <= 32 outputs
// in registers, runs the T recurrence on each x[b, n] and reads M3 rows as
// float4 broadcasts (every lane of a warp reads the same address).  Past 32
// outputs the chunks of KC run one after the other on the staged tile.
// Outputs go through shared memory so the stores are coalesced.  Each out
// element has one owner thread: the same bits on every run.
//
// Backward schedule.  A block owns a contiguous range of rows and walks it
// in tiles of TR rows, staging x and g (coalesced) in shared memory.
//   dM: a thread owns (feature n, 4 columns k, a chunk of DC degrees) and
//       keeps DC x 4 sums in registers over every row of the block's range.
//       At narrow layers (fewer such items than threads) the rows are dealt
//       to row groups whose sums are added in shared memory in row-group
//       order; past the threads, the items run in passes over the range.
//       The block writes its partial [dp1, N, K] to a workspace, and a
//       second kernel (entry qkan_m3_dm_sum) adds the partials in block
//       order.  No float atomics: the same bits on every run.
//   dx (want_dx): after the dM sums of a tile, one thread a row runs the U
//       recurrence, takes g.M3[d, n, :] with g's row (in registers up to 32
//       columns) against M3 rows read as broadcasts, and writes dx into the
//       x tile in place, from where the block stores it coalesced.
// want_dx = 0 (the weight-only backward) stages no M3 and writes no dx.

#include <type_traits>

#include "qkan_common.cuh"

namespace {

using qkan::bf16_round;
using qkan::cheb_next;

constexpr int THREADS = 256;      // backward threads; forward at most this
constexpr int MAX_DP1 = 32;
constexpr int DC = 8;             // degrees of dM sums a thread holds at once
constexpr int MAX_BLOCKS = 264;   // row blocks of a backward: 2 per H100 SM
constexpr size_t PART_BUDGET = size_t(16) << 20;  // bytes of dM partials
// shared memory one block may opt into on Hopper (227 KB)
constexpr long long SMEM_LIMIT = 232448;

// Padded widths of the shared-memory tiles.
struct Geo {
  int KP;  // K padded: 4, 8, 16, 32 or a multiple of 32
  int KC;  // outputs (forward) or g columns (dx) a thread holds: min(KP, 32)
  int XS;  // x tile row stride, odd: a thread a row reads without conflicts
  int GS;  // g tile row stride, 4 x odd: float4 rows without conflicts
};

Geo geo(int N, int K) {
  Geo G;
  G.KP = K <= 4 ? 4 : K <= 8 ? 8 : K <= 16 ? 16 : (K + 31) / 32 * 32;
  G.KC = G.KP < 32 ? G.KP : 32;
  G.XS = N | 1;
  G.GS = (G.KP / 4) % 2 ? G.KP : G.KP + 4;
  return G;
}

bool bad_shape(long long B, int N, int dp1, int K) {
  return B < 0 || N < 1 || dp1 < 1 || dp1 > MAX_DP1 || K < 1;
}

long long m3_floats(int N, int dp1, const Geo& G) {
  return (long long)dp1 * N * G.KP;
}

// forward: M3, the x tile and the output tile, for `threads` rows a tile
long long fwd_bytes(int N, int dp1, const Geo& G, int threads) {
  return 4 * (m3_floats(N, dp1, G) + (long long)threads * G.XS +
              (long long)threads * (G.KC + 1));
}

// backward: M3 (want_dx only), then the x and g tiles of TR rows, which the
// row groups' sums reuse at the end of a pass
long long bwd_bytes(int N, int dp1, const Geo& G, int TR, int want_dx) {
  long long tiles = (long long)TR * (G.XS + G.GS);
  const long long red = (long long)THREADS * DC * 4;
  if (tiles < red) tiles = red;
  return 4 * ((want_dx ? m3_floats(N, dp1, G) : 0) + tiles);
}

// the widest tile that fits the budget, or 0
int fwd_threads(int N, int dp1, int K) {
  const Geo G = geo(N, K);
  for (int t = THREADS; t >= 32; t /= 2) {
    if (fwd_bytes(N, dp1, G, t) <= SMEM_LIMIT) return t;
  }
  return 0;
}

int bwd_tile_rows(int N, int dp1, int K, int want_dx) {
  const Geo G = geo(N, K);
  for (int tr = THREADS; tr >= 32; tr /= 2) {
    if (bwd_bytes(N, dp1, G, tr, want_dx) <= SMEM_LIMIT) return tr;
  }
  return 0;
}

struct BwdLayout {
  int TR;    // rows a tile
  int rows;  // rows a block, a multiple of TR
  int nblk;  // blocks, the leading dimension of the partials
};

BwdLayout bwd_layout(long long B, int N, int dp1, int K, int want_dx) {
  BwdLayout L;
  L.TR = bwd_tile_rows(N, dp1, K, want_dx);
  const long long tiles = (B + L.TR - 1) / L.TR;
  long long cap = (long long)(PART_BUDGET / ((size_t)dp1 * N * K * 4));
  if (cap > MAX_BLOCKS) cap = MAX_BLOCKS;
  if (cap < 1) cap = 1;
  const long long per_blk = (tiles + cap - 1) / cap;
  L.rows = (int)(per_blk * L.TR);
  L.nblk = (int)((B + L.rows - 1) / L.rows);
  return L;
}

// Stage rows [r0, r0 + nr) of x [.., N] into x_s [nr][XS] as f32.
template <typename XT>
__device__ __forceinline__ void stage_x(const XT* __restrict__ x, float* x_s,
                                        long long r0, int nr, int N, int XS) {
  const XT* src = x + (size_t)r0 * N;
  for (int i = threadIdx.x; i < nr * N; i += blockDim.x) {
    const int r = i / N, n = i - r * N;
    x_s[r * XS + n] = qkan::load_as_float(src + i);
  }
}

template <typename XT, int KC>
__global__ void __launch_bounds__(THREADS)
m3_fwd_kernel(const XT* __restrict__ x, const float* __restrict__ m3,
              XT* __restrict__ out, long long B, int N, int dp1, int K,
              int KP, int XS) {
  constexpr bool XBF16 = !std::is_same<XT, float>::value;
  extern __shared__ __align__(16) float smem[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  float* m_s = smem;                         // [dp1][N][KP]
  float* x_s = m_s + (size_t)dp1 * N * KP;   // [nt][XS]
  float* o_s = x_s + (size_t)nt * XS;        // [nt][KC + 1]

  for (int i = tid; i < dp1 * N * KP; i += nt) {
    const int row = i / KP, c = i - row * KP;
    m_s[i] = c < K ? m3[(size_t)row * K + c] : 0.f;
  }
  for (long long r0 = (long long)blockIdx.x * nt; r0 < B;
       r0 += (long long)gridDim.x * nt) {
    const int nr = (int)min((long long)nt, B - r0);
    __syncthreads();  // M3 staged; the previous tile's readers are done
    stage_x(x, x_s, r0, nr, N, XS);
    __syncthreads();
    for (int k0 = 0; k0 < KP; k0 += KC) {
      if (tid < nr) {
        float acc[KC];
#pragma unroll
        for (int c = 0; c < KC; ++c) acc[c] = 0.f;
        const float* xr = x_s + tid * XS;
        for (int n = 0; n < N; ++n) {
          const float t = xr[n];
          const float two_t = 2.f * t;
          // T_0 = 1; T_{-1} = T_1 = t makes the recurrence give T_1 exactly
          float cur = 1.f, prev = t;
          const float* mrow = m_s + (size_t)n * KP + k0;
          for (int d = 0; d < dp1; ++d) {
            const float4* m4 =
                reinterpret_cast<const float4*>(mrow + (size_t)d * N * KP);
#pragma unroll
            for (int q = 0; q < KC / 4; ++q) {
              const float4 m = m4[q];
              acc[4 * q + 0] = fmaf(cur, m.x, acc[4 * q + 0]);
              acc[4 * q + 1] = fmaf(cur, m.y, acc[4 * q + 1]);
              acc[4 * q + 2] = fmaf(cur, m.z, acc[4 * q + 2]);
              acc[4 * q + 3] = fmaf(cur, m.w, acc[4 * q + 3]);
            }
            const float nx = cheb_next<XBF16>(two_t, cur, prev);
            prev = cur;
            cur = nx;
          }
        }
#pragma unroll
        for (int c = 0; c < KC; ++c) o_s[tid * (KC + 1) + c] = acc[c];
      }
      __syncthreads();
      const int kw = min(KC, K - k0);
      for (int i = tid; i < nr * kw; i += nt) {
        const int r = i / kw, c = i - r * kw;
        qkan::store_float(out + (size_t)(r0 + r) * K + k0 + c,
                          o_s[r * (KC + 1) + c]);
      }
      __syncthreads();
    }
  }
}

template <typename XT, int KC, bool WANT_DX>
__global__ void __launch_bounds__(THREADS)
m3_bwd_kernel(const XT* __restrict__ x, const float* __restrict__ m3,
              const XT* __restrict__ g, XT* __restrict__ dx,
              float* __restrict__ part, long long B, int N, int dp1, int K,
              int KP, int XS, int GS, int TR, int rows) {
  constexpr bool XBF16 = !std::is_same<XT, float>::value;
  constexpr int ACC = DC * 4;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  float* m_s = smem;                                        // [dp1][N][KP]
  float* x_s = m_s + (WANT_DX ? (size_t)dp1 * N * KP : 0);  // [TR][XS]
  float* g_s = x_s + (size_t)TR * XS;                       // [TR][GS]
  float* red_s = x_s;  // [THREADS][ACC], over the tiles once they are read

  if (WANT_DX) {
    for (int i = tid; i < dp1 * N * KP; i += THREADS) {
      const int row = i / KP, c = i - row * KP;
      m_s[i] = c < K ? m3[(size_t)row * K + c] : 0.f;
    }
  }
  const int blk = blockIdx.x;
  const long long r_begin = (long long)blk * rows;
  const long long r_end = min(B, r_begin + rows);
  const int K4 = KP / 4;
  const int nch = (dp1 + DC - 1) / DC;
  const int items = N * K4 * nch;  // (feature, 4 columns, degree chunk)
  const int rg = items >= THREADS ? 1 : THREADS / items;
  const int passes = (items + THREADS - 1) / THREADS;
  float* dst_blk = part + (size_t)blk * dp1 * N * K;

  for (int p = 0; p < passes; ++p) {
    const int q = rg > 1 ? tid / items : 0;  // row group
    const int it = rg > 1 ? tid - q * items : p * THREADS + tid;
    const bool active = rg > 1 ? q < rg : it < items;
    const int k4 = active ? it % K4 : 0;
    const int n = active ? (it / K4) % N : 0;
    const int d0 = active ? (it / (K4 * N)) * DC : 0;
    const int nd = min(DC, dp1 - d0);
    float acc[DC][4];
#pragma unroll
    for (int j = 0; j < DC; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }

    for (long long r0 = r_begin; r0 < r_end; r0 += TR) {
      const int nr = (int)min((long long)TR, r_end - r0);
      __syncthreads();  // M3 staged; the previous tile's readers are done
      stage_x(x, x_s, r0, nr, N, XS);
      const XT* gsrc = g + (size_t)r0 * K;
      for (int i = tid; i < nr * KP; i += THREADS) {
        const int r = i / KP, c = i - r * KP;
        g_s[r * GS + c] = c < K ? qkan::load_as_float(gsrc + (size_t)r * K + c)
                                : 0.f;
      }
      __syncthreads();

      // dM: this thread's item over its row group's rows of the tile
      if (active) {
        for (int r = q; r < nr; r += rg) {
          const float t = x_s[r * XS + n];
          const float two_t = 2.f * t;
          float cur = 1.f, prev = t;  // T_0, and T_{-1} = T_1
          for (int d = 0; d < d0; ++d) {
            const float nx = cheb_next<XBF16>(two_t, cur, prev);
            prev = cur;
            cur = nx;
          }
          const float4 gv = *reinterpret_cast<const float4*>(g_s + r * GS +
                                                             4 * k4);
#pragma unroll
          for (int j = 0; j < DC; ++j) {
            if (j < nd) {
              acc[j][0] = fmaf(cur, gv.x, acc[j][0]);
              acc[j][1] = fmaf(cur, gv.y, acc[j][1]);
              acc[j][2] = fmaf(cur, gv.z, acc[j][2]);
              acc[j][3] = fmaf(cur, gv.w, acc[j][3]);
              const float nx = cheb_next<XBF16>(two_t, cur, prev);
              prev = cur;
              cur = nx;
            }
          }
        }
      }

      // dx, once (in the first pass): one thread a row of the tile
      if (WANT_DX && p == 0) {
        __syncthreads();  // every reader of the x tile is done with it
        for (int r = tid; r < nr; r += THREADS) {
          const float* grow = g_s + r * GS;
          float4 gq[KC / 4];
          if (KP == KC) {
#pragma unroll
            for (int c = 0; c < KC / 4; ++c) {
              gq[c] = reinterpret_cast<const float4*>(grow)[c];
            }
          }
          for (int nn = 0; nn < N; ++nn) {
            const float t = x_s[r * XS + nn];
            const float two_t = 2.f * t;
            float um2 = 0.f, um1 = 1.f;  // U_{d-2}, U_{d-1}
            float dt = 0.f;
            for (int d = 1; d < dp1; ++d) {
              const float4* m4 = reinterpret_cast<const float4*>(
                  m_s + ((size_t)d * N + nn) * KP);
              float gm0 = 0.f, gm1 = 0.f, gm2 = 0.f, gm3 = 0.f;
              if (KP == KC) {
#pragma unroll
                for (int c = 0; c < KC / 4; ++c) {
                  const float4 m = m4[c];
                  gm0 = fmaf(gq[c].x, m.x, gm0);
                  gm1 = fmaf(gq[c].y, m.y, gm1);
                  gm2 = fmaf(gq[c].z, m.z, gm2);
                  gm3 = fmaf(gq[c].w, m.w, gm3);
                }
              } else {
                const float4* g4 = reinterpret_cast<const float4*>(grow);
                for (int c = 0; c < KP / 4; ++c) {
                  const float4 m = m4[c];
                  const float4 gv = g4[c];
                  gm0 = fmaf(gv.x, m.x, gm0);
                  gm1 = fmaf(gv.y, m.y, gm1);
                  gm2 = fmaf(gv.z, m.z, gm2);
                  gm3 = fmaf(gv.w, m.w, gm3);
                }
              }
              const float gm = (gm0 + gm1) + (gm2 + gm3);
              // d * U_{d-1} in x's dtype, then the f32 product and sum
              float du = __fmul_rn((float)d, um1);
              if (XBF16) du = bf16_round(du);
              dt = __fadd_rn(dt, __fmul_rn(du, gm));
              const float un = cheb_next<XBF16>(two_t, um1, um2);
              um2 = um1;
              um1 = un;
            }
            x_s[r * XS + nn] = dt;  // only this thread reads row r
          }
        }
        __syncthreads();
        XT* ddst = dx + (size_t)r0 * N;
        for (int i = tid; i < nr * N; i += THREADS) {
          const int r = i / N, nn = i - r * N;
          qkan::store_float(ddst + i, x_s[r * XS + nn]);
        }
      }
    }

    // the block's partial of this pass's items
    if (rg == 1) {
      if (active) {
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          if (j < nd) {
            float* dst = dst_blk + ((size_t)(d0 + j) * N + n) * K;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (4 * k4 + e < K) dst[4 * k4 + e] = acc[j][e];
            }
          }
        }
      }
    } else {
      __syncthreads();  // the tiles are read: their memory takes the sums
      float* mine = red_s + (size_t)tid * ACC;
#pragma unroll
      for (int j = 0; j < DC; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[j * 4 + e] = acc[j][e];
      }
      __syncthreads();
      for (int i = tid; i < items * ACC; i += THREADS) {
        const int it2 = i / ACC, rem = i - it2 * ACC;
        const int j = rem / 4, e = rem - j * 4;
        const int kk = 4 * (it2 % K4) + e;
        const int n2 = (it2 / K4) % N;
        const int d = (it2 / (K4 * N)) * DC + j;
        if (kk < K && d < dp1) {
          float s = 0.f;
          for (int q2 = 0; q2 < rg; ++q2) {
            s += red_s[(size_t)(q2 * items + it2) * ACC + rem];
          }
          dst_blk[((size_t)d * N + n2) * K + kk] = s;
        }
      }
    }
  }
}

// dm[i] = sum over blocks of part[blk][i], in block order
__global__ void __launch_bounds__(256)
m3_dm_sum_kernel(const float* __restrict__ part, float* __restrict__ dm,
                 int nblk, long long per) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < per; i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < nblk; ++b) s += part[(size_t)b * per + i];
    dm[i] = s;
  }
}

template <typename F>
cudaError_t allow_smem(F kernel, long long bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename XT, int KC>
cudaError_t launch_fwd(const void* x, const float* m3, void* out, long long B,
                       int N, int dp1, int K, cudaStream_t s) {
  const Geo G = geo(N, K);
  const int nt = fwd_threads(N, dp1, K);
  const long long bytes = fwd_bytes(N, dp1, G, nt);
  auto kernel = m3_fwd_kernel<XT, KC>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  // as many blocks as fit on the card at once, each walking its rows
  int dev = 0, sms = 132, per_sm = 1;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    sms = 132;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, nt,
                                                      (size_t)bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  const long long want = (B + nt - 1) / nt;
  const long long cap = (long long)sms * per_sm;
  const int blocks = (int)(want < cap ? want : cap);
  kernel<<<blocks, nt, (size_t)bytes, s>>>(
      static_cast<const XT*>(x), m3, static_cast<XT*>(out), B, N, dp1, K,
      G.KP, G.XS);
  return cudaGetLastError();
}

template <typename XT, int KC, bool WANT_DX>
cudaError_t launch_bwd(const void* x, const float* m3, const void* g,
                       void* dx, float* part, long long B, int N, int dp1,
                       int K, cudaStream_t s) {
  const Geo G = geo(N, K);
  const BwdLayout L = bwd_layout(B, N, dp1, K, WANT_DX);
  const long long bytes = bwd_bytes(N, dp1, G, L.TR, WANT_DX);
  auto kernel = m3_bwd_kernel<XT, KC, WANT_DX>;
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<L.nblk, THREADS, (size_t)bytes, s>>>(
      static_cast<const XT*>(x), m3, static_cast<const XT*>(g),
      static_cast<XT*>(dx), part, B, N, dp1, K, G.KP, G.XS, G.GS, L.TR,
      L.rows);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t dispatch_fwd(const void* x, const float* m3, void* out,
                         long long B, int N, int dp1, int K, cudaStream_t s) {
  switch (geo(N, K).KC) {
    case 4: return launch_fwd<XT, 4>(x, m3, out, B, N, dp1, K, s);
    case 8: return launch_fwd<XT, 8>(x, m3, out, B, N, dp1, K, s);
    case 16: return launch_fwd<XT, 16>(x, m3, out, B, N, dp1, K, s);
    default: return launch_fwd<XT, 32>(x, m3, out, B, N, dp1, K, s);
  }
}

template <typename XT, bool WANT_DX>
cudaError_t dispatch_bwd(const void* x, const float* m3, const void* g,
                         void* dx, float* part, long long B, int N, int dp1,
                         int K, cudaStream_t s) {
  switch (geo(N, K).KC) {
    case 4: return launch_bwd<XT, 4, WANT_DX>(x, m3, g, dx, part, B, N, dp1, K, s);
    case 8: return launch_bwd<XT, 8, WANT_DX>(x, m3, g, dx, part, B, N, dp1, K, s);
    case 16: return launch_bwd<XT, 16, WANT_DX>(x, m3, g, dx, part, B, N, dp1, K, s);
    default: return launch_bwd<XT, 32, WANT_DX>(x, m3, g, dx, part, B, N, dp1, K, s);
  }
}

}  // namespace

// Shared memory a block of the kernel takes at these sizes (kind 0: the
// forward, 1: the backward with dx, 2: the weight-only backward): at its
// widest tile that fits qkan_m3_smem_limit(), else at its narrowest (more
// than the limit: the kernel does not take these sizes).  -1 for a shape
// outside N >= 1, 1 <= dp1 <= 32, K >= 1.
extern "C" long long qkan_m3_smem_bytes(int N, int dp1, int K, int kind) {
  if (bad_shape(0, N, dp1, K) || kind < 0 || kind > 2) return -1;
  const Geo G = geo(N, K);
  if (kind == 0) {
    const int nt = fwd_threads(N, dp1, K);
    return fwd_bytes(N, dp1, G, nt ? nt : 32);
  }
  const int want_dx = kind == 1;
  const int tr = bwd_tile_rows(N, dp1, K, want_dx);
  return bwd_bytes(N, dp1, G, tr ? tr : 32, want_dx);
}

extern "C" long long qkan_m3_smem_limit() { return SMEM_LIMIT; }

// Blocks of a backward call, the leading dimension of its partials
// [nblk, dp1, N, K] f32 (0 outside the domain or the budget).
extern "C" int qkan_m3_bwd_blocks(long long B, int N, int dp1, int K,
                                  int want_dx) {
  if (bad_shape(B, N, dp1, K) || B < 1 ||
      bwd_tile_rows(N, dp1, K, want_dx) == 0) {
    return 0;
  }
  return bwd_layout(B, N, dp1, K, want_dx).nblk;
}

// Forward: x [B, N] f32 (x_is_bf16 = 0) or bf16 (1); m3 [dp1, N, K] f32;
// out [B, K] in x's dtype.  All contiguous, B >= 1.  Returns the CUDA error
// of the launch (0 on success), allocates nothing, does not synchronise.
extern "C" int qkan_m3_fwd(const void* x, const void* m3, void* out,
                           long long B, int N, int dp1, int K, int x_is_bf16,
                           void* stream) {
  if (bad_shape(B, N, dp1, K) || B < 1 || fwd_threads(N, dp1, K) == 0) {
    return (int)cudaErrorInvalidValue;
  }
  const float* m = static_cast<const float*>(m3);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(x_is_bf16
                   ? dispatch_fwd<__nv_bfloat16>(x, m, out, B, N, dp1, K, s)
                   : dispatch_fwd<float>(x, m, out, B, N, dp1, K, s));
}

// Backward pass: x [B, N] and g [B, K] in x's dtype, m3 [dp1, N, K] f32
// (not read when want_dx = 0), dx [B, N] in x's dtype (null when want_dx =
// 0), part: qkan_m3_bwd_blocks(...) x dp1 x N x K f32 of at least
// part_bytes, which receives each block's dM partial.  All contiguous,
// B >= 1.  Returns the CUDA error of the launch (0 on success), allocates
// nothing, does not synchronise.
extern "C" int qkan_m3_bwd(const void* x, const void* m3, const void* g,
                           void* dx, void* part, long long part_bytes,
                           long long B, int N, int dp1, int K, int x_is_bf16,
                           int want_dx, void* stream) {
  if (bad_shape(B, N, dp1, K) || B < 1 || (want_dx && dx == nullptr) ||
      bwd_tile_rows(N, dp1, K, want_dx) == 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long nblk = bwd_layout(B, N, dp1, K, want_dx).nblk;
  if (part_bytes < nblk * dp1 * N * K * 4) return (int)cudaErrorInvalidValue;
  const float* m = static_cast<const float*>(m3);
  float* f = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_is_bf16) {
    err = want_dx ? dispatch_bwd<__nv_bfloat16, true>(x, m, g, dx, f, B, N, dp1, K, s)
                  : dispatch_bwd<__nv_bfloat16, false>(x, m, g, dx, f, B, N, dp1, K, s);
  } else {
    err = want_dx ? dispatch_bwd<float, true>(x, m, g, dx, f, B, N, dp1, K, s)
                  : dispatch_bwd<float, false>(x, m, g, dx, f, B, N, dp1, K, s);
  }
  return (int)err;
}

// The fixed-order pass: dm [per] f32 = the sum of part [nblk, per] over its
// first axis, in order.
extern "C" int qkan_m3_dm_sum(const void* part, void* dm, int nblk,
                              long long per, void* stream) {
  if (nblk < 1 || per < 1) return (int)cudaErrorInvalidValue;
  long long blocks = (per + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  m3_dm_sum_kernel<<<(unsigned)blocks, 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(dm), nblk, per);
  return (int)cudaGetLastError();
}
