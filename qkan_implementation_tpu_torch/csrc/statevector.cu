// Streaming statevector kernels for Hopper (sm_90a).
//
// Replace the TPU kernels of qkan_implementation_tpu/sim/pallas_kernels.py:
//
//   qkan_ucry_cs    _ucry_cs_pair_kernel (:168) and _ucry_cs_kernel (:120),
//                   K6/K7: the MSB-targeted multiplexed Ry from
//                   precomputed c = cos(theta/2), s = sin(theta/2)
//   qkan_ucry       _ucry_kernel (:47), K8: the same rotation, with
//                   sincos(theta/2) taken in the kernel
//   qkan_diag_mult  _diag_kernel (:240), K9: psi * diag
//   qkan_h_pair     _h_pair_kernel (:266), K10: a Hadamard on one qubit
//
// The state is a batch of flat real vectors psi [B, 2^q] (float or double).
// The ucry kernels view each as [2, M] (M = 2^(q-1), target = the MSB):
//
//     out[b, 0, i] = c * psi[b, 0, i] - s * psi[b, 1, i]
//     out[b, 1, i] = s * psi[b, 0, i] + c * psi[b, 1, i]
//
// with c, s (or theta) read at b * angle_stride + i: stride 0 for angles
// shared by the batch, M for one row of angles per state.  `inverse`
// negates s, which is the kernel at -theta: the psi-cotangent of the VJP.
// The Hadamard views the state as [B * outer, 2, inner], inner = 2^qubit.
//
// What bounds them on an H100: bytes.  Each is one pass over the state with
// a handful of flops per element (K8 adds one sincos per pair), so the
// least time is the bytes over 3.35 TB/s: in f32, per amplitude, K6 moves
// 12 B (psi in and out, c and s for half of them, once each), K8 10 B,
// K9 12 B, K10 8 B.  The design keeps every access coalesced and single:
// one thread per pair (or element), neighbouring threads on neighbouring
// i, each input read once and each output written once, out of place, no
// shared memory (K9's own design, 16-byte vectors, is at its kernel).
// A grid-stride loop covers any power-of-two size and any
// qubit (the TPU's 8x128 tile rules have no counterpart), with sizes
// passed as log2 so the index math is shifts and masks.  Trig is the
// accurate sincosf/sincos (no fast-math intrinsics): FABLE's angles run
// over [0, 2 pi], where __sinf loses digits.
//
// Entries return the CUDA error of the launch (0 on success), allocate
// nothing and do not synchronise; they run on the given stream.

#include <cuda_runtime.h>

#include "qkan_common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void sincos_t(float x, float* s, float* c) {
  sincosf(x, s, c);
}
__device__ __forceinline__ void sincos_t(double x, double* s, double* c) {
  sincos(x, s, c);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ucry_cs_kernel(const T* __restrict__ psi, const T* __restrict__ c,
               const T* __restrict__ s, T* __restrict__ out, long long pairs,
               int log_half, long long angle_stride, int inverse) {
  const long long half = 1LL << log_half;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < pairs; idx += step) {
    const long long b = idx >> log_half;
    const long long i = idx & (half - 1);
    const long long at0 = (b << (log_half + 1)) + i;  // psi[b, 0, i]
    const long long a = b * angle_stride + i;
    const T p0 = psi[at0];
    const T p1 = psi[at0 + half];
    const T cc = c[a];
    const T ss = inverse ? -s[a] : s[a];
    out[at0] = cc * p0 - ss * p1;
    out[at0 + half] = ss * p0 + cc * p1;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ucry_kernel(const T* __restrict__ psi, const T* __restrict__ theta,
            T* __restrict__ out, long long pairs, int log_half,
            long long angle_stride, int inverse) {
  const long long half = 1LL << log_half;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < pairs; idx += step) {
    const long long b = idx >> log_half;
    const long long i = idx & (half - 1);
    const long long at0 = (b << (log_half + 1)) + i;
    T ss, cc;
    sincos_t(theta[b * angle_stride + i] * T(0.5), &ss, &cc);
    if (inverse) ss = -ss;
    const T p0 = psi[at0];
    const T p1 = psi[at0 + half];
    out[at0] = cc * p0 - ss * p1;
    out[at0 + half] = ss * p0 + cc * p1;
  }
}

// K9, psi * d, redesigned for the H100.  A thread moves one 16-byte
// vector (float4, or double2 in f64) of psi and of d: two independent
// 16-byte loads, then one 16-byte store.  The grid is sized from the
// vector count (one block per 256 vectors), not capped: the old
// grid-stride loop under stream_grid's 8 blocks an SM moved 4 bytes a
// load and held the kernel to 82 % of the HBM rate at 27 qubits.  The
// diagonal's row is found once a vector.  Plain cached loads and stores:
// on the H100 (tools/step_diag_vs_old.py) streaming hints (__ldcs /
// __stcs) and 2-8 vectors a thread were no faster at 27 qubits and slower
// at 21, where psi, d and out stay in the 50 MB L2 between calls.  A
// state narrower than one vector, or a pointer off 16 bytes (a view at an
// odd offset), takes the scalar path in the same kernel (`vec` = 0).
constexpr int DIAG_ITEMS = THREADS;  // vectors (or elements) a block

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  static __device__ __forceinline__ float4 mul(float4 a, float4 b) {
    return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
  static __device__ __forceinline__ double2 mul(double2 a, double2 b) {
    return make_double2(a.x * b.x, a.y * b.y);
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
diag_kernel(const T* __restrict__ psi, const T* __restrict__ d,
            T* __restrict__ out, long long total, int log_dim,
            long long diag_stride, int vec) {
  using V = typename Vec16<T>::type;
  constexpr int N = Vec16<T>::n;
  const long long mask = (1LL << log_dim) - 1;
  const long long v = (long long)blockIdx.x * DIAG_ITEMS + threadIdx.x;
  if (vec) {
    if (v < total / N) {
      const long long e = v * N;  // a vector never crosses a row
      const V p = reinterpret_cast<const V*>(psi)[v];
      const V q = *reinterpret_cast<const V*>(
          d + (e >> log_dim) * diag_stride + (e & mask));
      reinterpret_cast<V*>(out)[v] = Vec16<T>::mul(p, q);
    }
  } else if (v < total) {
    out[v] = psi[v] * d[(v >> log_dim) * diag_stride + (v & mask)];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
h_pair_kernel(const T* __restrict__ psi, T* __restrict__ out, long long pairs,
              int log_inner) {
  const T r = T(0.7071067811865476);  // as the TPU kernel's inv_sqrt2
  const long long inner = 1LL << log_inner;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < pairs; idx += step) {
    const long long o = idx >> log_inner;
    const long long at0 = (o << (log_inner + 1)) + (idx & (inner - 1));
    const T a = psi[at0];
    const T b = psi[at0 + inner];
    out[at0] = (a + b) * r;
    out[at0 + inner] = (a - b) * r;
  }
}

// log2 sizes past 40 (a terabyte of amplitudes) or a product that
// overflows are refused
bool bad_size(long long count, int log2) {
  return count < 1 || log2 < 0 || log2 > 40 || count > (1LL << (62 - log2));
}

template <typename T>
cudaError_t launch_ucry_cs(const void* psi, const void* c, const void* s,
                           void* out, long long batch, int log_half,
                           long long stride, int inverse, cudaStream_t st) {
  const long long pairs = batch << log_half;
  ucry_cs_kernel<T><<<qkan::stream_grid(pairs, THREADS), THREADS, 0, st>>>(
      static_cast<const T*>(psi), static_cast<const T*>(c),
      static_cast<const T*>(s), static_cast<T*>(out), pairs, log_half, stride,
      inverse);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ucry(const void* psi, const void* theta, void* out,
                        long long batch, int log_half, long long stride,
                        int inverse, cudaStream_t st) {
  const long long pairs = batch << log_half;
  ucry_kernel<T><<<qkan::stream_grid(pairs, THREADS), THREADS, 0, st>>>(
      static_cast<const T*>(psi), static_cast<const T*>(theta),
      static_cast<T*>(out), pairs, log_half, stride, inverse);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

template <typename T>
cudaError_t launch_diag(const void* psi, const void* d, void* out,
                        long long batch, int log_dim, long long stride,
                        cudaStream_t st) {
  const long long total = batch << log_dim;
  constexpr int N = Vec16<T>::n;
  const int vec = (1LL << log_dim) >= N && aligned16(psi) && aligned16(d) &&
                  aligned16(out);
  const long long items = vec ? total / N : total;
  const long long blocks = (items + DIAG_ITEMS - 1) / DIAG_ITEMS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  diag_kernel<T><<<(unsigned)blocks, THREADS, 0, st>>>(
      static_cast<const T*>(psi), static_cast<const T*>(d),
      static_cast<T*>(out), total, log_dim, stride, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_h(const void* psi, void* out, long long outer,
                     int log_inner, cudaStream_t st) {
  const long long pairs = outer << log_inner;
  h_pair_kernel<T><<<qkan::stream_grid(pairs, THREADS), THREADS, 0, st>>>(
      static_cast<const T*>(psi), static_cast<T*>(out), pairs, log_inner);
  return cudaGetLastError();
}

}  // namespace

// psi, out: [batch, 2 * 2^log_half] contiguous; c, s: [2^log_half] shared
// (angle_stride 0) or [batch, 2^log_half] (angle_stride 2^log_half).
extern "C" int qkan_ucry_cs(const void* psi, const void* c, const void* s,
                            void* out, long long batch, int log_half,
                            long long angle_stride, int inverse, int is_f64,
                            void* stream) {
  if (bad_size(batch, log_half + 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_f64 ? launch_ucry_cs<double>(psi, c, s, out, batch, log_half,
                                               angle_stride, inverse, st)
                      : launch_ucry_cs<float>(psi, c, s, out, batch, log_half,
                                              angle_stride, inverse, st));
}

// As qkan_ucry_cs with theta in place of c and s.
extern "C" int qkan_ucry(const void* psi, const void* theta, void* out,
                         long long batch, int log_half, long long angle_stride,
                         int inverse, int is_f64, void* stream) {
  if (bad_size(batch, log_half + 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_f64 ? launch_ucry<double>(psi, theta, out, batch, log_half,
                                            angle_stride, inverse, st)
                      : launch_ucry<float>(psi, theta, out, batch, log_half,
                                           angle_stride, inverse, st));
}

// psi, out: [batch, 2^log_dim]; d: [2^log_dim] (diag_stride 0) or
// [batch, 2^log_dim] (diag_stride 2^log_dim).
extern "C" int qkan_diag_mult(const void* psi, const void* d, void* out,
                              long long batch, int log_dim,
                              long long diag_stride, int is_f64, void* stream) {
  if (bad_size(batch, log_dim)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_f64 ? launch_diag<double>(psi, d, out, batch, log_dim,
                                            diag_stride, st)
                      : launch_diag<float>(psi, d, out, batch, log_dim,
                                           diag_stride, st));
}

// psi, out: [outer, 2, 2^log_inner] contiguous (a batch folds into outer).
extern "C" int qkan_h_pair(const void* psi, void* out, long long outer,
                           int log_inner, int is_f64, void* stream) {
  if (bad_size(outer, log_inner + 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_f64 ? launch_h<double>(psi, out, outer, log_inner, st)
                      : launch_h<float>(psi, out, outer, log_inner, st));
}
