// The fixed-order partial-sum pass that finishes every hand-written
// backward of the package: K2/K4 (qkan_fused_dw_bwd, qkan_fused_bwd), K5
// (qkan_fused_step) and K13/K14 (qkan_m3_bwd).  Their TPU kernels carry dW
// or dM across grid steps that run in order (`dw_ref[...] +=` in
// qkan_implementation_tpu/ops/fused_layer.py and
// experimental/pallas_layer.py); CUDA blocks run in parallel, so each block
// writes a partial and this pass adds the partials up:
//
//     out[i] = sum over b of part[b, i]        part [nblk, per] f32
//
// and, in the form that finishes K2/K4/K5, also the colsum(g) partials
// gpart [nblk, T] summed once per column and written to every one of the
// `rows` rows of out_b [rows, T] (dW_0 = colsum(g): the same row for every
// input feature).
//
// Order.  The partial axis is cut into S segments of L = ceil(nblk / S)
// partials.  Segment s sums partials [s L, min((s + 1) L, nblk)) one add at
// a time in block order, from 0; the S segment sums are then added in
// segment order, from 0.  S depends on (nblk, per) alone (shape() below,
// C entry qkan_partial_sum_segments), so the same call gives the same bits
// every time, on any card.  No float atomics, no cooperative launch.
//
// What bounds it on an H100: one read of the partials and one write of the
// sums, 2.2 MB at the M3 headline (264 x 2048), 0.65 us at 3.35 TB/s; the
// partials were just written by the producer and sit in the 50 MB L2.  The
// work is far below the launch floor, so the design is about latency: no
// thread may walk hundreds of partials one dependent load after another.
//
// Two forms, chosen by nblk alone:
//
// - Up to SMALL_NBLK partials (K2/K4/K5 at the train step's batch 64, the
//   flagship's layer 0 at B 4096, K13/K14 at N16 K128): one thread an
//   output walks the partials in block order (S = 1), grid-stride, with
//   the colsum(g) outputs first: walks this short cost less than the
//   segmented form's shared-memory round (tools/partial_sum_vs_old.py
//   times both forms and the kernels they replaced on the same partials).
// - More partials (the M3 headline's 256, the K5 headline workspace's
//   547): a block is (cols x S) threads: threadIdx.x takes a unit of 4
//   outputs, read as one float4 (16 bytes, coalesced along per),
//   threadIdx.y a segment, whose up to UNROLL loads are issued together
//   before the adds run in order.  S is the fewest segments that walk at
//   most SEGMENT_LOADS partials each and give the grid threads enough to
//   fill the card; where the grid is under one block an SM, blocks take
//   half the columns.  The segment sums meet in shared memory, where one
//   thread an output adds them in order and stores it.  Where per is not
//   a multiple of 4 (or the partials are not 16-byte aligned) a unit is
//   read as 4 scalar loads and a ragged last unit masks its tail: the
//   same grid, the same order, the same bits.  colsum(g) is summed by
//   extra blocks at the start of the grid, once per column and slice of
//   about SLICE_FLOATS of dW_0: each block sums its columns (the same bits
//   in every slice) and writes them to its slice of the `rows` rows (one
//   block writing all 31 KB of dW_0 at the flagship's layer 0 would
//   outlast the rest of the grid by about 1 us).

#include <cstdint>

#include "qkan_common.cuh"

// SMALL_NBLK can be set at compile time (-DQKAN_PS_SMALL_NBLK=0 takes the
// segmented form at every nblk), so that tools/partial_sum_vs_old.py can
// time both forms on the same partials; the package is built with 32.
#ifndef QKAN_PS_SMALL_NBLK
#define QKAN_PS_SMALL_NBLK 32
#endif

namespace {

constexpr int THREADS = 256;         // threads of a block at most
constexpr int SMALL_NBLK = QKAN_PS_SMALL_NBLK;  // one thread an output
constexpr int MAX_SEGMENTS = 32;     // S at most
constexpr int SEGMENT_LOADS = 16;    // partials a segment walks, below the cap
constexpr int UNROLL = 16;           // loads a thread issues before adding
constexpr int SMS = 132;             // H100 SXM
constexpr long long FILL_THREADS = (long long)SMS * THREADS;
constexpr int SLICE_FLOATS = 1024;   // dW_0 floats a colsum(g) block writes

struct Shape {
  bool small;        // one thread an output (S = 1)
  int segments;      // S
  int cols;          // units of 4 outputs a block takes
  long long blocks;  // blocks of the main sum
};

int pow2_at_least(long long v) {
  int p = 1;
  while (p < v && p < MAX_SEGMENTS) p <<= 1;
  return p;
}

Shape shape(int nblk, long long per) {
  Shape sh;
  sh.small = nblk <= SMALL_NBLK;
  if (sh.small) {
    sh.segments = 1;
    sh.cols = 0;
    sh.blocks = 0;
    return sh;
  }
  const long long units = (per + 3) / 4;
  // segments that walk <= SEGMENT_LOADS partials each, and enough of them
  // that the grid's threads fill the card (a power of two, <= 32, <= nblk)
  long long want = (nblk + SEGMENT_LOADS - 1) / SEGMENT_LOADS;
  const long long fill =
      units > 0 ? (FILL_THREADS + units - 1) / units : MAX_SEGMENTS;
  if (fill > want) want = fill;
  sh.segments = pow2_at_least(want);
  if (sh.segments > nblk) sh.segments = nblk;
  sh.cols = THREADS / sh.segments;
  sh.blocks = (units + sh.cols - 1) / sh.cols;
  // under one block an SM, halve the blocks: twice the SMs pull the data
  if (sh.blocks < SMS && sh.cols > 1) {
    sh.cols /= 2;
    sh.blocks = (units + sh.cols - 1) / sh.cols;
  }
  return sh;
}

__device__ __forceinline__ void add4(float4& a, const float4& v) {
  a.x = __fadd_rn(a.x, v.x);
  a.y = __fadd_rn(a.y, v.y);
  a.z = __fadd_rn(a.z, v.z);
  a.w = __fadd_rn(a.w, v.w);
}

// the unit of 4 values at p: one 16-byte load, or `valid` scalar loads
// (the rest 0; their sums are never stored)
__device__ __forceinline__ float4 load4(const float* p, bool vec, int valid) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid > 0) v.x = __ldg(p);
  if (valid > 1) v.y = __ldg(p + 1);
  if (valid > 2) v.z = __ldg(p + 2);
  if (valid > 3) v.w = __ldg(p + 3);
  return v;
}

// The form for nblk <= SMALL_NBLK, the loop of the one-thread-an-output
// kernels this file replaced: output i of [bcast + per] is, for i < bcast,
// column i % T of gpart [nblk, T] summed into out_b[i], else column
// i - bcast of part [nblk, per] summed into out; each a walk in block order
// from 0 (plain loads and adds: the compiler unrolls the walk and issues
// its loads ahead), one thread an output, grid-stride.
__global__ void __launch_bounds__(THREADS)
small_partial_sum_kernel(const float* __restrict__ part, long long per,
                         int nblk, float* __restrict__ out,
                         const float* __restrict__ gpart, int T,
                         long long bcast, float* __restrict__ out_b) {
  const long long total = bcast + per;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    if (i < bcast) {
      const float* p = gpart + i % T;
      for (int b = 0; b < nblk; ++b) s += p[(size_t)b * T];
      out_b[i] = s;
    } else {
      const float* p = part + (i - bcast);
      for (int b = 0; b < nblk; ++b) s += p[(size_t)b * per];
      out[i - bcast] = s;
    }
  }
}

// Blocks [0, col_groups * slices) sum gpart [nblk, T] and write the sums to
// their slice of slice_rows rows of out_b [rows, T]; the blocks after them
// sum part [nblk, per] into out [per].  Block (cols, S): x a unit of 4
// outputs, y a segment.
__global__ void __launch_bounds__(THREADS)
partial_sum_kernel(const float* __restrict__ part, long long per, int nblk,
                   int seg_len, float* __restrict__ out, int col_groups,
                   int slices, int vec_main, const float* __restrict__ gpart,
                   int T, int rows, int slice_rows,
                   float* __restrict__ out_b) {
  __shared__ __align__(16) float red[4 * THREADS];  // [S][4 cols]
  __shared__ float col_s[4 * THREADS];              // the colsum(g) sums
  const int C = blockDim.x, S = blockDim.y;
  const int nt = C * S;
  const int tid = threadIdx.y * C + threadIdx.x;
  const int bcast_blocks = col_groups * slices;
  const bool bcast = (int)blockIdx.x < bcast_blocks;
  const long long ublk = bcast ? blockIdx.x % col_groups
                               : blockIdx.x - bcast_blocks;
  const float* src = bcast ? gpart : part;
  const long long n = bcast ? T : per;  // outputs, and the row stride
  const bool vec = !bcast && vec_main;
  const long long o = 4 * (ublk * C + threadIdx.x);
  const int valid = (int)min((long long)4, n - o);
  const int b0 = threadIdx.y * seg_len;
  const int b1 = min(nblk, b0 + seg_len);

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid > 0) {
    const float* p = src + o;
    for (int b = b0; b < b1; b += UNROLL) {
      float4 v[UNROLL];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        if (b + j < b1) v[j] = load4(p + (size_t)(b + j) * n, vec, valid);
      }
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        if (b + j < b1) add4(acc, v[j]);
      }
    }
  }
  reinterpret_cast<float4*>(red)[tid] = acc;
  __syncthreads();

  // one thread an output: the segment sums in segment order
  for (int k = tid; k < 4 * C; k += nt) {
    float s = 0.f;
    for (int y = 0; y < S; ++y) s = __fadd_rn(s, red[y * 4 * C + k]);
    const long long i = ublk * 4 * C + k;
    if (bcast) {
      col_s[k] = s;
    } else if (i < n) {
      out[i] = s;
    }
  }
  if (!bcast) return;
  __syncthreads();
  // this block's cw columns to the rows of its slice: a thread keeps its
  // column's sum in a register and stores it down the rows, neighbours on
  // neighbouring columns (no load or division in the store loop)
  const long long c0 = ublk * 4 * C;
  const int cw = (int)min((long long)4 * C, n - c0);
  const int per_row = min(cw, nt);         // threads on one row
  const int row_step = nt / per_row;       // rows stored at once
  const int r0 = (int)(blockIdx.x / col_groups) * slice_rows;
  const int r1 = min(rows, r0 + slice_rows);
  if (tid >= per_row * row_step) return;
  float* dst = out_b + c0;
  for (int c = tid % per_row; c < cw; c += per_row) {
    const float v = col_s[c];
#pragma unroll 4
    for (int r = r0 + tid / per_row; r < r1; r += row_step) {
      dst[(size_t)r * T + c] = v;
    }
  }
}

}  // namespace

namespace qkan {

int partial_sum_segments(int nblk, long long per) {
  if (nblk < 1 || per < 0) return 0;
  return shape(nblk, per).segments;
}

cudaError_t partial_sum(const float* part, long long per, int nblk,
                        float* out, const float* gpart, int T, int rows,
                        float* out_b, cudaStream_t stream) {
  if (nblk < 1 || per < 0 || (per > 0 && (part == nullptr || out == nullptr))
      || (gpart != nullptr && (T < 1 || rows < 1 || out_b == nullptr))
      || (per == 0 && gpart == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const Shape sh = shape(nblk, per);
  if (sh.small) {
    const long long bcast = gpart != nullptr ? (long long)rows * T : 0;
    long long blocks = (bcast + per + THREADS - 1) / THREADS;
    if (blocks > SMS * 16) blocks = SMS * 16;
    small_partial_sum_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
        part, per, nblk, out, gpart, T, bcast, out_b);
    return cudaGetLastError();
  }
  const int seg_len = (nblk + sh.segments - 1) / sh.segments;
  int col_groups = 0, slices = 0, slice_rows = 0;
  if (gpart != nullptr) {
    col_groups = ((T + 3) / 4 + sh.cols - 1) / sh.cols;
    const int cw = 4 * sh.cols < T ? 4 * sh.cols : T;
    slice_rows = SLICE_FLOATS / cw > 1 ? SLICE_FLOATS / cw : 1;
    slices = (rows + slice_rows - 1) / slice_rows;
  }
  const long long blocks = sh.blocks + (long long)col_groups * slices;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int vec = per % 4 == 0 &&
                  reinterpret_cast<std::uintptr_t>(part) % 16 == 0;
  partial_sum_kernel<<<(unsigned)blocks, dim3(sh.cols, sh.segments), 0,
                       stream>>>(part, per, nblk, seg_len, out, col_groups,
                                 slices, vec, gpart, T, rows, slice_rows,
                                 out_b);
  return cudaGetLastError();
}

}  // namespace qkan

// Segments S of the pass over `nblk` partials of `per` floats (0 outside
// nblk >= 1, per >= 0): the plain version in the kernel's order takes it.
extern "C" int qkan_partial_sum_segments(int nblk, long long per) {
  return qkan::partial_sum_segments(nblk, per);
}
