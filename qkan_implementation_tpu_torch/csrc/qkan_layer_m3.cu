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
// Two routes, chosen by the sizes and x's dtype alone (tc_plan below, C
// entry qkan_m3_tc_plan, mirrored by pallas_layer.py's m3_tc_plan):
//   - the tensor cores (qkan_layer_m3_tc.cu: m3_fwd_kernel_tc for K12,
//     m3_bwd_kernel_tc for K13, m3_bwd_dw_kernel_tc for K14, 3xTF32
//     mma.sync) for an f32 x where one launch takes the whole M3
//     (m3_slices below) and, for K12 and K13, M3's fragments and the
//     warps' rings fit a block's shared memory (K13: also at most 8 warps
//     a feature group, K <= 128 at up to 8 degrees);
//   - the FP32 CUDA cores (this file's kernels) for a bf16 x and for what
//     the plan refuses.
// What bounds them on an H100: at the headline layer (B = 262144, N = K =
// 16, dp1 = 8) the forward reads x (16.8 MB) and writes out (16.8 MB), 10
// us at 3.35 TB/s, against 2 B N (dp1 - 1) K = 0.94 GFLOP of FMAs, 14 us
// at 67 TFLOP/s on the CUDA cores (operations) and 5.7 us as three TF32
// passes on the tensor cores (bytes); K14 reads x and g, the same bytes
// and FMAs.  K13 does twice the FMAs (28 us on the CUDA cores, 11.4 as
// three TF32 passes) for x + g + dx (15 us).  Both routes keep the basis
// out of device memory (the TPU kernels' point).  -DQKAN_M3_TC=0 sends
// every shape to this file's kernels (tools/m3_vs_old.py).
//
// The CUDA-core kernels:
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
//       The block writes its partial [dp1, N, K] to a workspace, and the
//       fixed-order pass of partial_sum.cu adds the partials (launched by
//       qkan_m3_bwd itself when given dm, or by qkan_m3_dm_sum).  No float
//       atomics: the same bits on every run.
//   dx (want_dx): after the dM sums of a tile, one thread a row runs the U
//       recurrence, takes g.M3[d, n, :] with g's row (in registers up to 32
//       columns) against M3 rows read as broadcasts, and writes dx into the
//       x tile in place, from where the block stores it coalesced.
// want_dx = 0 (the weight-only backward) stages no M3 and writes no dx.
//
// Any M3 and any D+1.  Where a kernel's staging of M3 (and its tiles) does
// not fit one block's shared memory, an entry runs it over slices of M3
// (m3_slices, below; C entries qkan_m3_slice_n / qkan_m3_slice_k): the
// output columns K first, then, where one 4-column slice still overflows,
// the features N too.  out and dM are disjoint over K slices, dx and dM
// over N slices.  dx adds over K slices and out over N slices: the
// launches carry the f32 sums through a workspace in launch order and the
// last one stores them in x's dtype (out over N continues the one FMA
// chain, so its bits are those of one launch).  The D+1 degrees need no
// slicing: the recurrence runs to each degree chunk in registers.

#include <type_traits>

#include "m3_tc.cuh"
#include "qkan_common.cuh"

namespace {

using qkan::bf16_round;
using qkan::cheb_next;

constexpr int THREADS = 256;      // backward threads; forward at most this
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
  return B < 0 || N < 1 || dp1 < 1 || K < 1;
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

// whether a kernel (kind 0: the forward, 1: the backward with dx, 2: the
// weight-only backward) takes a slice of nw features and kw columns
bool fits(int nw, int dp1, int kw, int kind) {
  return kind == 0 ? fwd_threads(nw, dp1, kw) > 0
                   : bwd_tile_rows(nw, dp1, kw, kind == 1) > 0;
}

// The slice of M3 one launch takes: all of it where it fits; else the
// widest kw of K, then 32-column steps down to 32, then 16, 8, 4; where 4
// columns still overflow (large N * (D+1)), also nw = N halved (rounded
// up) until it fits.  nw = 1 and kw <= 4 may still overflow (D+1 in the
// tens of thousands): the entries refuse that.
struct Slices {
  int nw, kw;
};

Slices m3_slices(int N, int dp1, int K, int kind) {
  Slices s{N, K};
  while (s.kw > 4 && !fits(N, dp1, s.kw, kind)) {
    s.kw = s.kw > 32 ? (s.kw - 1) / 32 * 32 : s.kw > 16 ? 16 : s.kw > 8 ? 8 : 4;
  }
  while (s.nw > 1 && !fits(s.nw, dp1, s.kw, kind)) s.nw = (s.nw + 1) / 2;
  return s;
}

struct BwdLayout {
  int TR;    // rows a tile
  int rows;  // rows a block, a multiple of TR
  int nblk;  // blocks, the leading dimension of the partials
};

// rows and blocks of a backward over the whole M3 (the partials' budget),
// with the tile rows of its widest slice
BwdLayout bwd_layout(long long B, int N, int dp1, int K, int want_dx) {
  BwdLayout L;
  const Slices s = m3_slices(N, dp1, K, want_dx ? 1 : 2);
  L.TR = bwd_tile_rows(s.nw, dp1, s.kw, want_dx);
  const long long tiles = (B + L.TR - 1) / L.TR;
  long long cap = (long long)(PART_BUDGET / ((size_t)dp1 * N * K * 4));
  if (cap > MAX_BLOCKS) cap = MAX_BLOCKS;
  if (cap < 1) cap = 1;
  const long long per_blk = (tiles + cap - 1) / cap;
  L.rows = (int)(per_blk * L.TR);
  L.nblk = (int)((B + L.rows - 1) / L.rows);
  return L;
}

// Stage rows [r0, r0 + nr) of the features [n0, n0 + N) of x [.., ldn]
// into x_s [nr][XS] as f32.
template <typename XT>
__device__ __forceinline__ void stage_x(const XT* __restrict__ x, float* x_s,
                                        long long r0, int nr, int N, int XS,
                                        int ldn, int n0) {
  const XT* src = x + (size_t)r0 * ldn + n0;
  for (int i = threadIdx.x; i < nr * N; i += blockDim.x) {
    const int r = i / N, n = i - r * N;
    x_s[r * XS + n] = qkan::load_as_float(src + (size_t)r * ldn + n);
  }
}

// M3's slice [.., n0 : n0 + N, k0 : k0 + K] of the whole [dp1, ldn, ldk]
// into m_s [dp1][N][KP], zero past K
__device__ __forceinline__ void stage_m3(const float* __restrict__ m3,
                                         float* m_s, int N, int dp1, int K,
                                         int KP, int ldn, int n0, int ldk,
                                         int k0) {
  for (int i = threadIdx.x; i < dp1 * N * KP; i += blockDim.x) {
    const int row = i / KP, c = i - row * KP;
    const int d = row / N, n = row - d * N;
    m_s[i] = c < K ? m3[((size_t)d * ldn + n0 + n) * ldk + k0 + c] : 0.f;
  }
}

// One slice: features [n0, n0 + N) and columns [ks, ks + K) of the whole
// [dp1, ldn, ldk] M3.  first: the slice starts out's sums (else they
// continue from carry [B, ldk] f32); last: it stores out (else carry).
template <typename XT, int KC>
__global__ void __launch_bounds__(THREADS)
m3_fwd_kernel(const XT* __restrict__ x, const float* __restrict__ m3,
              XT* __restrict__ out, float* __restrict__ carry, long long B,
              int N, int dp1, int K, int KP, int XS, int ldn, int n0,
              int ldk, int ks, int first, int last) {
  constexpr bool XBF16 = !std::is_same<XT, float>::value;
  extern __shared__ __align__(16) float smem[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  float* m_s = smem;                         // [dp1][N][KP]
  float* x_s = m_s + (size_t)dp1 * N * KP;   // [nt][XS]
  float* o_s = x_s + (size_t)nt * XS;        // [nt][KC + 1]

  stage_m3(m3, m_s, N, dp1, K, KP, ldn, n0, ldk, ks);
  for (long long r0 = (long long)blockIdx.x * nt; r0 < B;
       r0 += (long long)gridDim.x * nt) {
    const int nr = (int)min((long long)nt, B - r0);
    __syncthreads();  // M3 staged; the previous tile's readers are done
    stage_x(x, x_s, r0, nr, N, XS, ldn, n0);
    __syncthreads();
    for (int k0 = 0; k0 < KP; k0 += KC) {
      if (tid < nr) {
        float acc[KC];
        const float* crow = carry + (size_t)(r0 + tid) * ldk + ks + k0;
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          acc[c] = first || k0 + c >= K ? 0.f : crow[c];
        }
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
        const size_t o = (size_t)(r0 + r) * ldk + ks + k0 + c;
        if (last) {
          qkan::store_float(out + o, o_s[r * (KC + 1) + c]);
        } else {
          carry[o] = o_s[r * (KC + 1) + c];
        }
      }
      __syncthreads();
    }
  }
}

// One slice, as the forward's: features [n0, n0 + N), columns [ks, ks +
// K); the partials are [nblk, dp1, ldn, ldk].  first: the slice starts
// dx's sums (else they continue from carry [B, ldn] f32); last: it stores
// dx (else carry).
template <typename XT, int KC, bool WANT_DX>
__global__ void __launch_bounds__(THREADS)
m3_bwd_kernel(const XT* __restrict__ x, const float* __restrict__ m3,
              const XT* __restrict__ g, XT* __restrict__ dx,
              float* __restrict__ part, float* __restrict__ carry,
              long long B, int N, int dp1, int K, int KP, int XS, int GS,
              int TR, int rows, int ldn, int n0, int ldk, int ks, int first,
              int last) {
  constexpr bool XBF16 = !std::is_same<XT, float>::value;
  constexpr int ACC = DC * 4;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  float* m_s = smem;                                        // [dp1][N][KP]
  float* x_s = m_s + (WANT_DX ? (size_t)dp1 * N * KP : 0);  // [TR][XS]
  float* g_s = x_s + (size_t)TR * XS;                       // [TR][GS]
  float* red_s = x_s;  // [THREADS][ACC], over the tiles once they are read

  if (WANT_DX) stage_m3(m3, m_s, N, dp1, K, KP, ldn, n0, ldk, ks);
  const int blk = blockIdx.x;
  const long long r_begin = (long long)blk * rows;
  const long long r_end = min(B, r_begin + rows);
  const int K4 = KP / 4;
  const int nch = (dp1 + DC - 1) / DC;
  const int items = N * K4 * nch;  // (feature, 4 columns, degree chunk)
  const int rg = items >= THREADS ? 1 : THREADS / items;
  const int passes = (items + THREADS - 1) / THREADS;
  float* dst_blk = part + (size_t)blk * dp1 * ldn * ldk;

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
      stage_x(x, x_s, r0, nr, N, XS, ldn, n0);
      const XT* gsrc = g + (size_t)r0 * ldk + ks;
      for (int i = tid; i < nr * KP; i += THREADS) {
        const int r = i / KP, c = i - r * KP;
        g_s[r * GS + c] =
            c < K ? qkan::load_as_float(gsrc + (size_t)r * ldk + c) : 0.f;
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
        for (int i = tid; i < nr * N; i += THREADS) {
          const int r = i / N, nn = i - r * N;
          const size_t o = (size_t)(r0 + r) * ldn + n0 + nn;
          float v = x_s[r * XS + nn];
          if (!first) v = __fadd_rn(carry[o], v);
          if (last) {
            qkan::store_float(dx + o, v);
          } else {
            carry[o] = v;
          }
        }
      }
    }

    // the block's partial of this pass's items
    if (rg == 1) {
      if (active) {
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          if (j < nd) {
            float* dst = dst_blk + ((size_t)(d0 + j) * ldn + n0 + n) * ldk + ks;
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
          dst_blk[((size_t)d * ldn + n0 + n2) * ldk + ks + kk] = s;
        }
      }
    }
  }
}

template <typename F>
cudaError_t allow_smem(F kernel, long long bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// One forward slice: features [n0, n0 + N), columns [ks, ks + K).
template <typename XT, int KC>
cudaError_t launch_fwd(const void* x, const float* m3, void* out,
                       float* carry, long long B, int N, int dp1, int K,
                       int ldn, int n0, int ldk, int ks, int first, int last,
                       cudaStream_t s) {
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
      static_cast<const XT*>(x), m3, static_cast<XT*>(out), carry, B, N, dp1,
      K, G.KP, G.XS, ldn, n0, ldk, ks, first, last);
  return cudaGetLastError();
}

// One backward slice, with the block layout of the whole call.
template <typename XT, int KC, bool WANT_DX>
cudaError_t launch_bwd(const void* x, const float* m3, const void* g,
                       void* dx, float* part, float* carry, const BwdLayout& L,
                       long long B, int N, int dp1, int K, int ldn, int n0,
                       int ldk, int ks, int first, int last, cudaStream_t s) {
  const Geo G = geo(N, K);
  const long long bytes = bwd_bytes(N, dp1, G, L.TR, WANT_DX);
  auto kernel = m3_bwd_kernel<XT, KC, WANT_DX>;
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<L.nblk, THREADS, (size_t)bytes, s>>>(
      static_cast<const XT*>(x), m3, static_cast<const XT*>(g),
      static_cast<XT*>(dx), part, carry, B, N, dp1, K, G.KP, G.XS, G.GS,
      L.TR, L.rows, ldn, n0, ldk, ks, first, last);
  return cudaGetLastError();
}

// Every slice of a call, N slices outer, K slices inner: out's sums carry
// over N slices (first / last over them), dx's over K slices.
template <typename XT>
cudaError_t run_fwd(const void* x, const float* m3, void* out, float* carry,
                    long long B, int N, int dp1, int K, cudaStream_t s) {
  const Slices sl = m3_slices(N, dp1, K, 0);
  for (int n0 = 0; n0 < N; n0 += sl.nw) {
    const int nw = sl.nw < N - n0 ? sl.nw : N - n0;
    for (int ks = 0; ks < K; ks += sl.kw) {
      const int kw = sl.kw < K - ks ? sl.kw : K - ks;
      const int first = n0 == 0, last = n0 + nw == N;
      cudaError_t err;
      switch (geo(nw, kw).KC) {
        case 4: err = launch_fwd<XT, 4>(x, m3, out, carry, B, nw, dp1, kw, N, n0, K, ks, first, last, s); break;
        case 8: err = launch_fwd<XT, 8>(x, m3, out, carry, B, nw, dp1, kw, N, n0, K, ks, first, last, s); break;
        case 16: err = launch_fwd<XT, 16>(x, m3, out, carry, B, nw, dp1, kw, N, n0, K, ks, first, last, s); break;
        default: err = launch_fwd<XT, 32>(x, m3, out, carry, B, nw, dp1, kw, N, n0, K, ks, first, last, s); break;
      }
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

template <typename XT, bool WANT_DX>
cudaError_t run_bwd(const void* x, const float* m3, const void* g, void* dx,
                    float* part, float* carry, long long B, int N, int dp1,
                    int K, cudaStream_t s) {
  const Slices sl = m3_slices(N, dp1, K, WANT_DX ? 1 : 2);
  const BwdLayout L = bwd_layout(B, N, dp1, K, WANT_DX);
  for (int n0 = 0; n0 < N; n0 += sl.nw) {
    const int nw = sl.nw < N - n0 ? sl.nw : N - n0;
    for (int ks = 0; ks < K; ks += sl.kw) {
      const int kw = sl.kw < K - ks ? sl.kw : K - ks;
      const int first = ks == 0, last = ks + kw == K;
      cudaError_t err;
      switch (geo(nw, kw).KC) {
        case 4: err = launch_bwd<XT, 4, WANT_DX>(x, m3, g, dx, part, carry, L, B, nw, dp1, kw, N, n0, K, ks, first, last, s); break;
        case 8: err = launch_bwd<XT, 8, WANT_DX>(x, m3, g, dx, part, carry, L, B, nw, dp1, kw, N, n0, K, ks, first, last, s); break;
        case 16: err = launch_bwd<XT, 16, WANT_DX>(x, m3, g, dx, part, carry, L, B, nw, dp1, kw, N, n0, K, ks, first, last, s); break;
        default: err = launch_bwd<XT, 32, WANT_DX>(x, m3, g, dx, part, carry, L, B, nw, dp1, kw, N, n0, K, ks, first, last, s); break;
      }
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

// launches of a call (kind as fits()): one per slice
long long launches(int N, int dp1, int K, int kind) {
  const Slices sl = m3_slices(N, dp1, K, kind);
  return (long long)((N + sl.nw - 1) / sl.nw) * ((K + sl.kw - 1) / sl.kw);
}

// floats of the carry a call needs: out's [B, K] where the forward slices
// N, dx's [B, N] where the backward with dx slices K; else none
long long carry_floats(long long B, int N, int dp1, int K, int kind) {
  const Slices sl = m3_slices(N, dp1, K, kind);
  if (kind == 0) return sl.nw < N ? B * K : 0;
  return kind == 1 && sl.kw < K ? B * N : 0;
}

bool refused(int N, int dp1, int K, int kind) {
  const Slices sl = m3_slices(N, dp1, K, kind);
  return !fits(sl.nw, dp1, sl.kw, kind);
}

// The tensor-core route (qkan_layer_m3_tc.cu) and its tiling: an f32 x,
// an M3 that one launch takes whole (no slices, so the launch counts and
// carries are the same on both routes), and the block's shared memory
// within SMEM_LIMIT:
//   K12: M3's B fragments {hi, lo} of degrees 1 .. D [D s][NTP][32] float4,
//        colsum(M3[0]) and 8 warps' rings of M3T_RING stages of 16 mt rows
//        x xs floats (xs: N padded to 8 s, + 8 where that is a multiple of
//        16, so a quad's 8-byte reads of 4 rows fall on distinct banks);
//        ntw = the n8-tiles of K up to 8 (1, 2, 4, 8), mt 4 at ntw 1, else
//        2, ng = the groups of ntw;
//   K14: 8 warps' rings of M3T_RING stages of 32 rows x (8 + M3T_GS)
//        floats, or the row splits' dM^T where that is more; mg m16-tiles
//        of K, dgn groups of dpg <= M3T_DPG degrees, s groups of 8
//        features: mg s dgn groups of warps, wr = 8 / groups of them a
//        group (row splits) where that is more than 1, else gy blocks of 8
//        groups on the grid's second dimension;
//   K13: K14's groups, row splits and rings, dealt to blocks by whole
//        feature groups (the p = mg dgn groups whose dx partials add up,
//        8 / p feature groups a block, so p <= 8), plus the block's groups'
//        M3[d]^T B fragments {hi, lo} (dpg degrees x 2 k-steps x 32 lanes a
//        group, float4) and, where p > 1, the warps' dx partials [2][8][32
//        rows][8 features].
qkan::M3TcPlan tc_plan(int N, int dp1, int K, int kind, int x_is_bf16) {
  qkan::M3TcPlan p{};
  if (!QKAN_M3_TC || x_is_bf16 || bad_shape(0, N, dp1, K) || kind < 0 ||
      kind > 2 || launches(N, dp1, K, kind) != 1) {
    return p;
  }
  const long long D = dp1 - 1;
  p.s = (N + 7) / 8;
  if (kind == 0) {
    const int np = 8 * p.s;
    p.xs = np % 16 == 0 ? np + 8 : np;
    const int nt = (K + 7) / 8;
    p.ntw = nt <= 1 ? 1 : nt <= 2 ? 2 : nt <= 4 ? 4 : 8;
    p.ng = (nt + p.ntw - 1) / p.ntw;
    p.mt = p.ntw == 1 ? 4 : 2;
    const long long ntp = (long long)p.ng * p.ntw;
    p.smem = 16 * D * p.s * ntp * 32 + 4 * 8 * ntp +
             4LL * 8 * qkan::M3T_RING * 16 * p.mt * p.xs;
  } else {
    p.xs = 8;
    p.mg = (K + 15) / 16;
    p.dgn = D <= qkan::M3T_DPG ? 1 : (int)((D + qkan::M3T_DPG - 1) /
                                          qkan::M3T_DPG);
    p.dpg = (int)((D + p.dgn - 1) / p.dgn);
    const long long groups = (long long)p.mg * p.s * p.dgn;
    p.wr = groups >= 8 ? 1 : (int)(8 / groups);
    const long long ring = 4LL * 8 * qkan::M3T_RING * qkan::M3T_CHUNK *
                           (8 + qkan::M3T_GS);
    const long long red = 4LL * 8 * 32 * 4 * (qkan::M3T_DPG + 1);
    p.smem = ring > red ? ring : red;
    long long per_blk = 8;  // groups a block
    if (kind == 1) {
      const long long pg = (long long)p.mg * p.dgn;
      if (pg > 8) return qkan::M3TcPlan{};
      per_blk = 8 / pg * pg;
      const long long wg = groups < per_blk ? groups : per_blk;
      p.smem += 16 * wg * p.dpg * 2 * 32 +
                (pg > 1 ? 4LL * 2 * 8 * qkan::M3T_CHUNK * 8 : 0);
    }
    p.gy = (int)((groups + per_blk - 1) / per_blk);
  }
  p.ok = p.smem <= SMEM_LIMIT;
  return p;
}

}  // namespace

// Shared memory a block of the kernel takes at these sizes (kind 0: the
// forward, 1: the backward with dx, 2: the weight-only backward), at the
// slice the entries launch (qkan_m3_slice_n x qkan_m3_slice_k) and its
// widest tile: at most qkan_m3_smem_limit(), except past D+1 in the tens
// of thousands, which no slice takes (the entries refuse it).  -1 for a
// shape outside N, D+1, K >= 1.
extern "C" long long qkan_m3_smem_bytes(int N, int dp1, int K, int kind) {
  if (bad_shape(0, N, dp1, K) || kind < 0 || kind > 2) return -1;
  const Slices sl = m3_slices(N, dp1, K, kind);
  const Geo G = geo(sl.nw, sl.kw);
  if (kind == 0) {
    const int nt = fwd_threads(sl.nw, dp1, sl.kw);
    return fwd_bytes(sl.nw, dp1, G, nt ? nt : 32);
  }
  const int want_dx = kind == 1;
  const int tr = bwd_tile_rows(sl.nw, dp1, sl.kw, want_dx);
  return bwd_bytes(sl.nw, dp1, G, tr ? tr : 32, want_dx);
}

extern "C" long long qkan_m3_smem_limit() { return SMEM_LIMIT; }

// The slice of M3 a launch takes (m3_slices): features and columns (0
// outside the domain).
extern "C" int qkan_m3_slice_n(int N, int dp1, int K, int kind) {
  if (bad_shape(0, N, dp1, K) || kind < 0 || kind > 2) return 0;
  return m3_slices(N, dp1, K, kind).nw;
}
extern "C" int qkan_m3_slice_k(int N, int dp1, int K, int kind) {
  if (bad_shape(0, N, dp1, K) || kind < 0 || kind > 2) return 0;
  return m3_slices(N, dp1, K, kind).kw;
}

// Kernel launches of one call of kind `kind` (not counting the dM pass).
extern "C" long long qkan_m3_launches(int N, int dp1, int K, int kind) {
  if (bad_shape(0, N, dp1, K) || kind < 0 || kind > 2) return 0;
  return launches(N, dp1, K, kind);
}

// Bytes of the f32 carry one call of kind `kind` needs (0: none).
extern "C" long long qkan_m3_carry_bytes(long long B, int N, int dp1, int K,
                                         int kind) {
  if (bad_shape(B, N, dp1, K) || kind < 0 || kind > 2) return 0;
  return 4 * carry_floats(B, N, dp1, K, kind);
}

// Blocks of a backward call, the leading dimension of its partials
// [nblk, dp1, N, K] f32 (0 outside the domain).
extern "C" int qkan_m3_bwd_blocks(long long B, int N, int dp1, int K,
                                  int want_dx) {
  if (bad_shape(B, N, dp1, K) || B < 1 || refused(N, dp1, K, want_dx ? 1 : 2)) {
    return 0;
  }
  return bwd_layout(B, N, dp1, K, want_dx).nblk;
}

// The tensor-core plan of a call of kind `kind` (0: K12, 1: K13, 2: K14)
// at these sizes and x dtype (tc_plan): plan[12] receives {ok, s, xs, mt,
// ntw, ng, mg, dgn, dpg, wr, gy, smem}; returns ok (1: the call runs the
// tensor-core kernel, 0: this file's CUDA-core kernels).
extern "C" int qkan_m3_tc_plan(int N, int dp1, int K, int kind, int x_is_bf16,
                               long long* plan) {
  const qkan::M3TcPlan p = tc_plan(N, dp1, K, kind, x_is_bf16);
  const long long v[12] = {p.ok, p.s,  p.xs,  p.mt, p.ntw, p.ng,
                           p.mg, p.dgn, p.dpg, p.wr, p.gy,  p.smem};
  if (plan != nullptr) {
    for (int i = 0; i < 12; ++i) plan[i] = p.ok ? v[i] : 0;
  }
  return p.ok;
}

// Forward: x [B, N] f32 (x_is_bf16 = 0) or bf16 (1); m3 [dp1, N, K] f32;
// out [B, K] in x's dtype; carry: qkan_m3_carry_bytes(B, N, dp1, K, 0)
// bytes (null when 0).  All contiguous, B >= 1.  Returns the CUDA error
// of the launches (0 on success), allocates nothing, does not synchronise.
extern "C" int qkan_m3_fwd(const void* x, const void* m3, void* out,
                           void* carry, long long carry_bytes, long long B,
                           int N, int dp1, int K, int x_is_bf16,
                           void* stream) {
  if (bad_shape(B, N, dp1, K) || B < 1 || refused(N, dp1, K, 0) ||
      carry_bytes < 4 * carry_floats(B, N, dp1, K, 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* m = static_cast<const float*>(m3);
  float* c = static_cast<float*>(carry);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const qkan::M3TcPlan p = tc_plan(N, dp1, K, 0, x_is_bf16);
  if (p.ok) {
    return (int)qkan::m3_fwd_tc(static_cast<const float*>(x), m,
                                static_cast<float*>(out), B, N, dp1, K, p, s);
  }
  return (int)(x_is_bf16
                   ? run_fwd<__nv_bfloat16>(x, m, out, c, B, N, dp1, K, s)
                   : run_fwd<float>(x, m, out, c, B, N, dp1, K, s));
}

// Backward pass: x [B, N] and g [B, K] in x's dtype, m3 [dp1, N, K] f32
// (not read when want_dx = 0), dx [B, N] in x's dtype (null when want_dx =
// 0), part: qkan_m3_bwd_blocks(...) x dp1 x N x K f32 of at least
// part_bytes, which receives each block's dM partial, followed by the
// carry of qkan_m3_carry_bytes(B, N, dp1, K, 1 or 2) bytes (part_bytes
// counts both); dm [dp1, N, K] f32, or null.  Given dm, the fixed-order
// pass that sums the partials into it is launched next on the same stream
// (one call a backward); else the caller runs qkan_m3_dm_sum.  All
// contiguous, B >= 1.  Returns the CUDA error of the launches (0 on
// success), allocates nothing, does not synchronise.
extern "C" int qkan_m3_bwd(const void* x, const void* m3, const void* g,
                           void* dx, void* part, long long part_bytes,
                           long long B, int N, int dp1, int K, int x_is_bf16,
                           int want_dx, void* dm, void* stream) {
  const int kind = want_dx ? 1 : 2;
  if (bad_shape(B, N, dp1, K) || B < 1 || (want_dx && dx == nullptr) ||
      refused(N, dp1, K, kind)) {
    return (int)cudaErrorInvalidValue;
  }
  const BwdLayout L = bwd_layout(B, N, dp1, K, want_dx);
  const long long nblk = L.nblk;
  const long long part_floats = nblk * dp1 * N * K;
  if (part_bytes < 4 * (part_floats + carry_floats(B, N, dp1, K, kind))) {
    return (int)cudaErrorInvalidValue;
  }
  const float* m = static_cast<const float*>(m3);
  float* f = static_cast<float*>(part);
  float* c = f + part_floats;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const qkan::M3TcPlan p = tc_plan(N, dp1, K, kind, x_is_bf16);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  if (p.ok) {  // K13 or K14 on the tensor cores, in the same block layout
    err = want_dx ? qkan::m3_bwd_tc(xf, gf, m, static_cast<float*>(dx), f, B,
                                    N, dp1, K, L.rows, L.nblk, p, s)
                  : qkan::m3_bwd_dw_tc(xf, gf, f, B, N, dp1, K, L.rows,
                                       L.nblk, p, s);
  } else if (x_is_bf16) {
    err = want_dx ? run_bwd<__nv_bfloat16, true>(x, m, g, dx, f, c, B, N, dp1, K, s)
                  : run_bwd<__nv_bfloat16, false>(x, m, g, dx, f, c, B, N, dp1, K, s);
  } else {
    err = want_dx ? run_bwd<float, true>(x, m, g, dx, f, c, B, N, dp1, K, s)
                  : run_bwd<float, false>(x, m, g, dx, f, c, B, N, dp1, K, s);
  }
  if (err != cudaSuccess || dm == nullptr) return (int)err;
  return (int)qkan::partial_sum(f, (long long)dp1 * N * K, (int)nblk,
                                static_cast<float*>(dm), nullptr, 0, 0,
                                nullptr, s);
}

// The fixed-order pass alone: dm [per] f32 = the sum of part [nblk, per]
// over its first axis, in the order of qkan_partial_sum_segments.
extern "C" int qkan_m3_dm_sum(const void* part, void* dm, int nblk,
                              long long per, void* stream) {
  if (nblk < 1 || per < 1) return (int)cudaErrorInvalidValue;
  return (int)qkan::partial_sum(static_cast<const float*>(part), per, nblk,
                                static_cast<float*>(dm), nullptr, 0, 0,
                                nullptr, static_cast<cudaStream_t>(stream));
}
