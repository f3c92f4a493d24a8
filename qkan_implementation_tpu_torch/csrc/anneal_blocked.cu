// The block-diagonal annealer on the card, for Hopper (sm_90a): its sweeps,
// a chunk of them in one launch (S1), and the one-hot polish, the energies
// and the pick of the best read after them (S2, further down).
//
// S1: the sweeps.  Replaces no Pallas kernel.  The JAX package runs this
// loop as one lax.scan that XLA compiles
// (qkan_implementation_tpu/anneal/sa.py:428 _anneal_kernel_blocked); the
// port ran it as a Python loop of torch ops, about 7 launches for each
// variable of a one-hot block in every sweep (46 a sweep at block size 6).
// This kernel runs k sweeps in one launch.
//
// What it computes, for the state s and the local fields f [bs, R, nb],
// the uniforms u [k, bs, R, nb], the chunk's schedule betas [k] and the
// block couplings J [nb, bs, bs]: for t < k, for i < bs, for every chain
// (read r, block b) at once,
//
//     thr   = -log(u[t, i, r, b]) * (1 / betas[t])
//     sg    = 1 - 2 s[i, r, b]
//     delta = sg * f[i, r, b] < thr ? sg : 0
//     s[i, r, b] += delta
//     f[j, r, b] += J[b, i, j] * delta          for every j < bs
//
// each operation rounded as the plain version (anneal/sa._blocked_sweeps)
// rounds it on the card: torch's CUDA log, then `div_` by a Python scalar,
// which torch evaluates as a product with the reciprocal rounded in the
// tensor's dtype.  sg and delta are -1, 0 or +1, so sg * f and J * delta
// are exact and f + J * delta rounds once, contracted into an FMA or not:
// on the same uniforms the kernel gives the plain version's chain, bit for
// bit.
//
// What bounds it on an H100: the floor is bytes.  Chains never interact,
// so one thread a chain keeps its bs spins and fields in registers for the
// whole chunk; the traffic is the uniforms, each read once (4 B a step in
// float32: 768 MB for 1000 sweeps at R 1000, nb 32, bs 6, 0.23 ms at 3.35
// TB/s), and the state, read and written once a chunk.  Threads are
// numbered b-fastest (r * nb + b), so a warp's loads of u and of the state
// are coalesced in the [.., R, nb] layout.  A thread loads the next sweep's
// bs uniforms while it runs the current one, and a sweep's bs thresholds
// do not depend on the state, so their logs overlap; what runs in sequence
// is the compare, the select and the bs-wide field update of each step.
// At the cells' shapes the kernel stays a few times above that floor:
// 10,000-79,000 chains fill the card thinly, each walks its sweeps in
// order, and a step costs some 35 instructions, most of them the exact log
// the plain version's threshold needs.  (A ring of 8 sweeps of uniforms in
// registers, to keep more bytes in flight, measured slower.)  The
// couplings are staged once a block in shared memory as [bs, bs, nb] (a
// warp's neighbouring b on neighbouring banks) where they fit in 48 KB;
// else each thread reads its own block's from global memory.  Block sizes
// 1..8 (degrees up to 7) are compile-time, the state in registers: 2.8-5.4
// times faster than the generic kernel at block sizes 4 and 6 on an H100.
// Above 8 one generic kernel keeps the state in the tensors themselves
// (each thread its own column, coalesced); register templates there
// spilled.
//
// Each entry returns the CUDA error of its launches (0 on success),
// allocates nothing and does not synchronise; it runs on the given stream.  This
// source is a library of its own (ops/_cuda_build.py: ANNEAL_SOURCES), so
// it carries its own qkan_cuda_error_string.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr long long STAGE_BYTES = 48 * 1024;

__device__ __forceinline__ float dev_log(float v) { return logf(v); }
__device__ __forceinline__ double dev_log(double v) { return log(v); }

// The couplings of block b, (i, j) at base[(i * bs + j) * stride]: staged
// ([bs, bs, nb] in shared memory: base Js + b, stride nb) or not ([nb, bs,
// bs] in global memory: base J + b bs bs, stride 1).
template <typename T>
__device__ __forceinline__ const T* stage_couplings(const T* __restrict__ J,
                                                    T* Js, int bs, int nb,
                                                    int staged, int b,
                                                    int* stride) {
  if (staged) {
    const int bb = bs * bs;
    for (int e = threadIdx.x; e < nb * bb; e += blockDim.x) {
      Js[(e % bb) * nb + e / bb] = J[e];
    }
    __syncthreads();
    *stride = nb;
    return Js + b;
  }
  *stride = 1;
  return J + (long long)b * bs * bs;
}

template <typename T, int BS>
__global__ void __launch_bounds__(THREADS)
blocked_sweeps_kernel(T* __restrict__ s, T* __restrict__ f,
                      const T* __restrict__ u, const T* __restrict__ betas,
                      const T* __restrict__ J, int k, long long chains,
                      int nb, int staged) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // every thread of the block takes part in the staging
  const int b = (int)((c < chains ? c : chains - 1) % nb);
  int js;
  const T* jb = stage_couplings(J, reinterpret_cast<T*>(smem_raw), BS, nb,
                                staged, b, &js);
  if (c >= chains) return;
  T sv[BS], fv[BS], un[BS];
#pragma unroll
  for (int i = 0; i < BS; ++i) {
    sv[i] = s[i * chains + c];
    fv[i] = f[i * chains + c];
    un[i] = u[i * chains + c];
  }
  for (int t = 0; t < k; ++t) {
    T thr[BS];
    const T inv = T(1) / betas[t];
#pragma unroll
    for (int i = 0; i < BS; ++i) thr[i] = -dev_log(un[i]) * inv;
    if (t + 1 < k) {
      const T* un_p = u + (long long)(t + 1) * BS * chains + c;
#pragma unroll
      for (int i = 0; i < BS; ++i) un[i] = un_p[i * chains];
    }
#pragma unroll
    for (int i = 0; i < BS; ++i) {
      const T sg = T(1) - T(2) * sv[i];
      const T delta = sg * fv[i] < thr[i] ? sg : T(0);
      sv[i] += delta;
      // past 256 bytes of couplings, keep the compiler from holding all
      // bs * bs in registers across the sweeps: they would spill
      if (BS * BS * sizeof(T) > 256) asm volatile("" ::: "memory");
#pragma unroll
      for (int j = 0; j < BS; ++j) fv[j] += jb[(i * BS + j) * js] * delta;
    }
  }
#pragma unroll
  for (int i = 0; i < BS; ++i) {
    s[i * chains + c] = sv[i];
    f[i * chains + c] = fv[i];
  }
}

// Any block size: the same steps on the state in place.
template <typename T>
__global__ void __launch_bounds__(THREADS)
blocked_sweeps_generic_kernel(T* __restrict__ s, T* __restrict__ f,
                              const T* __restrict__ u,
                              const T* __restrict__ betas,
                              const T* __restrict__ J, int k, int bs,
                              long long chains, int nb, int staged) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int b = (int)((c < chains ? c : chains - 1) % nb);
  int js;
  const T* jb = stage_couplings(J, reinterpret_cast<T*>(smem_raw), bs, nb,
                                staged, b, &js);
  if (c >= chains) return;
  for (int t = 0; t < k; ++t) {
    const T inv = T(1) / betas[t];
    const T* ut = u + (long long)t * bs * chains + c;
    for (int i = 0; i < bs; ++i) {
      const T thr = -dev_log(ut[i * chains]) * inv;
      const T si = s[i * chains + c];
      const T sg = T(1) - T(2) * si;
      const T delta = sg * f[i * chains + c] < thr ? sg : T(0);
      s[i * chains + c] = si + delta;
      for (int j = 0; j < bs; ++j) {
        f[j * chains + c] += jb[(i * bs + j) * js] * delta;
      }
    }
  }
}

struct Args {
  void* s;
  void* f;
  const void* u;
  const void* betas;
  const void* J;
  int k;
  int bs;
  long long chains;
  int nb;
};

template <typename T, int BS>
cudaError_t launch_fixed(const Args& a, unsigned grid, size_t smem,
                         cudaStream_t st) {
  blocked_sweeps_kernel<T, BS><<<grid, THREADS, smem, st>>>(
      static_cast<T*>(a.s), static_cast<T*>(a.f),
      static_cast<const T*>(a.u), static_cast<const T*>(a.betas),
      static_cast<const T*>(a.J), a.k, a.chains, a.nb, smem > 0);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const unsigned grid = (unsigned)((a.chains + THREADS - 1) / THREADS);
  const long long jbytes = (long long)a.nb * a.bs * a.bs * sizeof(T);
  const size_t smem = jbytes <= STAGE_BYTES ? (size_t)jbytes : 0;
  switch (a.bs) {
#define QKAN_BS_CASE(n) \
  case n:               \
    return launch_fixed<T, n>(a, grid, smem, st);
    QKAN_BS_CASE(1) QKAN_BS_CASE(2) QKAN_BS_CASE(3) QKAN_BS_CASE(4)
    QKAN_BS_CASE(5) QKAN_BS_CASE(6) QKAN_BS_CASE(7) QKAN_BS_CASE(8)
#undef QKAN_BS_CASE
    default:
      break;
  }
  blocked_sweeps_generic_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<T*>(a.s), static_cast<T*>(a.f),
      static_cast<const T*>(a.u), static_cast<const T*>(a.betas),
      static_cast<const T*>(a.J), a.k, a.bs, a.chains, a.nb, smem > 0);
  return cudaGetLastError();
}

// S2: the one-hot polish, the energies and the pick of the best read.
//
// Replaces no Pallas kernel.  The JAX package polishes on the host in numpy
// (qkan_implementation_tpu/anneal/sa.py polish_one_hot_blocks, then
// QuboModel.energy and np.argmin), and so did the port: on the dense J
// [n, n], R n^2 float64 work a call, with every read copied to the host.
//
// What it computes, for the annealed state s [bs, R, nb] (float32 or
// float64), the biases h [nb, bs] and the couplings J [nb, bs, bs] (both
// float64), for every read r and block b, as polish_one_hot_blocks does:
//
//     s[i, r, b] = 0                                   for every i < bs
//     f_i = h[b, i] + sum_j J[b, i, j] s[j, r, b]      for every i < bs
//     k   = the first i of least f_i                   (np.argmin's order)
//     s[k, r, b] = 1
//
// then each read's energy without the offset from its polished bits,
// E_r = sum_b (sum_i s_i h[b, i] + 1/2 sum_ij s_i J[b, i, j] s_j), in
// float64; then out = the bits of the first read of least E_r (np.argmin's
// order again: a NaN first, else the least, ties to the lower index),
// block-major (out[b * bs + i]), and that E_r in out[bs * nb].  The host
// loop polishes the blocks one after another, each seeing the bits the
// earlier ones set; here no coupling leaves a block, so a block's fields
// read no bit outside it, and all blocks of all reads polish at once to
// the same bits.  s keeps the polished bits of every read.
//
// What bounds it on an H100: the launches.  The work is the state read and
// written once (768 KB in float32 at digits-search layer 0: bs 6, nb 32, R
// 1000), h and J (under 11 KB) and 2 R nb bs^2 float64 multiply-adds (2.3
// M): well under a microsecond of either; what is left is two launches of
// a few microseconds and their dependence.  Polish: one warp a read, its
// lanes over the read's blocks (b = lane, lane + 32, ...), so a warp's
// loads and stores of s[i, r, :] are coalesced; a lane keeps the block's
// bits in the state itself (any bs, no register arrays) and reads them
// back from L1.  A read's energy is the sum of its blocks' energies, which
// cancel against the offset (the degree QUBO's h is about -10 a bit, its
// offset +10 a block): a plain sum over 79 blocks reads up to 1e-12 of E
// off.  So the sum is compensated (Neumaier's, each lane over its blocks
// in order, then a tree of shuffles merging the lanes' sums and their
// rounding errors): E within about an ulp of the exact sum, and equal bits
// give equal energies wherever the read lies.  Pick: one block scans the
// R energies and reduces over shared memory, then writes the best read's
// bits.

constexpr int POLISH_THREADS = 256;  // 8 reads a block
constexpr int PICK_THREADS = 512;

// Does (a, ia) come before (b, ib) in np.argmin's order: a NaN first, then
// the lesser value, then the lower index?
__device__ __forceinline__ bool argmin_before(double a, long long ia,
                                              double b, long long ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return na;
  if (!na && a != b) return a < b;
  return ia < ib;
}

// sum + err += v, Neumaier's step: err gathers the rounding errors of sum
__device__ __forceinline__ void add_compensated(double& sum, double& err,
                                                double v) {
  const double t = sum + v;
  err += fabs(sum) >= fabs(v) ? (sum - t) + v : (v - t) + sum;
  sum = t;
}

template <typename T>
__global__ void __launch_bounds__(POLISH_THREADS)
polish_blocked_kernel(T* __restrict__ s, const double* __restrict__ h,
                      const double* __restrict__ J,
                      double* __restrict__ energy, int bs, long long reads,
                      int nb) {
  const long long r =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= reads) return;  // the lanes of a warp share r: it leaves whole
  const long long plane = reads * nb;  // s[i, r, b] at i * plane + r nb + b
  double sum = 0.0, err = 0.0;
  for (int b = lane; b < nb; b += 32) {
    T* sb = s + r * nb + b;
    const double* hb = h + (long long)b * bs;
    const double* jb = J + (long long)b * bs * bs;
    for (int i = 0; i < bs; ++i) sb[i * plane] = T(0);
    int k = 0;
    double least = 0.0;
    for (int i = 0; i < bs; ++i) {
      double f = hb[i];
      for (int j = 0; j < bs; ++j) f += jb[i * bs + j] * (double)sb[j * plane];
      if (i == 0 || argmin_before(f, i, least, k)) {
        least = f;
        k = i;
      }
    }
    sb[k * plane] = T(1);
    double lin = 0.0, quad = 0.0;
    for (int i = 0; i < bs; ++i) {
      const double si = (double)sb[i * plane];
      double row = 0.0;
      for (int j = 0; j < bs; ++j) {
        row += jb[i * bs + j] * (double)sb[j * plane];
      }
      lin += si * hb[i];
      quad += si * row;
    }
    add_compensated(sum, err, lin + 0.5 * quad);
  }
  for (int off = 16; off > 0; off /= 2) {
    const double other_sum = __shfl_down_sync(0xffffffffu, sum, off);
    const double other_err = __shfl_down_sync(0xffffffffu, err, off);
    add_compensated(sum, err, other_sum);
    err += other_err;
  }
  if (lane == 0) energy[r] = sum + err;
}

template <typename T>
__global__ void __launch_bounds__(PICK_THREADS)
pick_best_kernel(const T* __restrict__ s, const double* __restrict__ energy,
                 double* __restrict__ out, int bs, long long reads, int nb) {
  __shared__ double least[PICK_THREADS];
  __shared__ long long at[PICK_THREADS];
  const int t = threadIdx.x;
  double e = 0.0;
  long long idx = -1;
  for (long long r = t; r < reads; r += PICK_THREADS) {
    const double v = energy[r];
    if (idx < 0 || argmin_before(v, r, e, idx)) {
      e = v;
      idx = r;
    }
  }
  least[t] = e;
  at[t] = idx;
  __syncthreads();
  for (int half = PICK_THREADS / 2; half > 0; half /= 2) {
    if (t < half) {
      const long long o = at[t + half];
      if (o >= 0 && (at[t] < 0 ||
                     argmin_before(least[t + half], o, least[t], at[t]))) {
        least[t] = least[t + half];
        at[t] = o;
      }
    }
    __syncthreads();
  }
  const long long best = at[0];
  const long long n = (long long)nb * bs;
  for (long long v = t; v < n; v += PICK_THREADS) {
    out[v] = (double)s[(v % bs) * reads * nb + best * nb + v / bs];
  }
  if (t == 0) out[n] = least[0];
}

template <typename T>
cudaError_t launch_polish(T* s, const double* h, const double* J,
                          double* energy, double* out, int bs,
                          long long reads, int nb, cudaStream_t st) {
  const unsigned grid =
      (unsigned)((reads * 32 + POLISH_THREADS - 1) / POLISH_THREADS);
  polish_blocked_kernel<T><<<grid, POLISH_THREADS, 0, st>>>(
      s, h, J, energy, bs, reads, nb);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pick_best_kernel<T><<<1, PICK_THREADS, 0, st>>>(s, energy, out, bs, reads,
                                                  nb);
  return cudaGetLastError();
}

}  // namespace

// s, f: [bs, reads, nb]; u: [k, bs, reads, nb]; betas: [k]; J: [nb, bs,
// bs]; all contiguous, float32 (is_f64 0) or float64 (1), on the launching
// card.  s and f are updated in place.
extern "C" int qkan_anneal_blocked_sweeps(void* s, void* f, const void* u,
                                          const void* betas, const void* J,
                                          int k, int bs, long long reads,
                                          int nb, int is_f64, void* stream) {
  if (k < 1 || bs < 1 || reads < 1 || nb < 1 ||
      reads * nb > (1LL << 36)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{s, f, u, betas, J, k, bs, reads * nb, nb};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_f64 ? launch<double>(a, st) : launch<float>(a, st));
}

// S2.  s: [bs, reads, nb], float32 (is_f64 0) or float64 (1), polished in
// place; h: [nb, bs] and J: [nb, bs, bs] float64; energy: [reads] float64
// scratch; out: [nb * bs + 1] float64, the best read's bits block-major,
// then its energy without the offset.  All contiguous, on the launching
// card.  Two launches on the given stream (the polish and energies, then
// the pick); returns the first CUDA error, 0 on success.
extern "C" int qkan_anneal_polish_blocked(void* s, const void* h,
                                          const void* J, void* energy,
                                          void* out, int bs, long long reads,
                                          int nb, int is_f64, void* stream) {
  // the polish's grid is a warp a read: reads / 8 blocks
  if (bs < 1 || reads < 1 || nb < 1 || reads * nb > (1LL << 36) ||
      reads > (1LL << 33)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* hd = static_cast<const double*>(h);
  const double* Jd = static_cast<const double*>(J);
  double* e = static_cast<double*>(energy);
  double* o = static_cast<double*>(out);
  return (int)(is_f64
                   ? launch_polish(static_cast<double*>(s), hd, Jd, e, o, bs,
                                   reads, nb, st)
                   : launch_polish(static_cast<float*>(s), hd, Jd, e, o, bs,
                                   reads, nb, st));
}

// Name of a CUDA error code, for the wrapper's exception message.
extern "C" const char* qkan_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
