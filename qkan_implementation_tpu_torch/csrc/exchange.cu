// Global-qubit exchange fused with the gate's 2x2, for Hopper (sm_90a).
//
// Replaces the TPU kernel qkan_implementation_tpu/sim/rdma.py
// _protocol_kernel (:80), K11, in both of its instances:
//
//   qkan_exchange_ucry  ucry_exchange_fused_rdma: a multiplexed Ry from
//                       c = cos(theta/2), s = sin(theta/2)
//   qkan_exchange_h     h_exchange_fused_rdma: a Hadamard
//
// What it computes, for one slot d of a sharded statevector, partner
// d ^ (1 << dev_bit), device bit g = (d >> dev_bit) & 1: the block is two
// halves of M by the local MSB; the exchange swaps the global qubit with
// the local MSB, so the slot keeps its half g (`kept`) and receives the
// partner's half g (`received`).  With p0 = g ? received : kept and
// p1 = g ? kept : received,
//
//     out[0, i] = c[i] * p0[i] - s[i] * p1[i]      (H: (p0 + p1) / sqrt 2)
//     out[1, i] = s[i] * p0[i] + c[i] * p1[i]      (H: (p0 - p1) / sqrt 2)
//
// The TPU kernel streams the partner's half over the ICI with remote DMAs
// into double-buffered VMEM slots (capacity credits, a barrier semaphore)
// so the transfer hides under the 2x2.  None of that carries over: on one
// card the partner's half already lies in the card's memory, so the kernel
// reads `kept` and `received` through two pointers and writes both output
// halves out of place (the caller's outputs are new tensors: no slot
// overwrites a half its partner still reads).  Where slots sit on
// different cards the wrapper copies the partner's half to the slot's card
// first (Tensor.to, over NVLink) and launches the same kernel.
//
// What bounds it on an H100: bytes.  A pass reads each half once and
// writes both output halves once, with 3 flops an amplitude: per
// amplitude 12 B in f32 for the ucry (the halves in and out, c and s for
// half of them), 8 B for H -- the same as K6 and K10, because the exchange
// moves nothing extra on one card.  One slot of 2^24 amplitudes: 60.1 us
// (ucry), 40.1 us (H) at 3.35 TB/s.  The design is K6's: one thread per
// pair, neighbouring threads on neighbouring i, every access coalesced and
// single, no shared memory, a grid-stride loop over any M.
//
// Entries return the CUDA error of the launch (0 on success), allocate
// nothing and do not synchronise; they run on the given stream.

#include <cuda_runtime.h>

#include "qkan_common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
exchange_ucry_kernel(const T* __restrict__ kept, const T* __restrict__ recv,
                     const T* __restrict__ c, const T* __restrict__ s,
                     T* __restrict__ out, long long m, int g) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += step) {
    const T k = kept[i];
    const T r = recv[i];
    const T p0 = g ? r : k;
    const T p1 = g ? k : r;
    const T cc = c[i];
    const T ss = s[i];
    out[i] = cc * p0 - ss * p1;
    out[m + i] = ss * p0 + cc * p1;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
exchange_h_kernel(const T* __restrict__ kept, const T* __restrict__ recv,
                  T* __restrict__ out, long long m, int g) {
  const T r = T(0.7071067811865476);  // as the TPU kernel's sqrt(0.5)
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += step) {
    const T k = kept[i];
    const T rv = recv[i];
    const T p0 = g ? rv : k;
    const T p1 = g ? k : rv;
    out[i] = (p0 + p1) * r;
    out[m + i] = (p0 - p1) * r;
  }
}

// half sizes past 2^40 amplitudes are refused
bool bad_half(long long m, int g) {
  return m < 1 || m > (1LL << 40) || (g != 0 && g != 1);
}

template <typename T>
cudaError_t launch_ucry(const void* kept, const void* recv, const void* c,
                        const void* s, void* out, long long m, int g,
                        cudaStream_t st) {
  exchange_ucry_kernel<T><<<qkan::stream_grid(m, THREADS), THREADS, 0, st>>>(
      static_cast<const T*>(kept), static_cast<const T*>(recv),
      static_cast<const T*>(c), static_cast<const T*>(s),
      static_cast<T*>(out), m, g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_h(const void* kept, const void* recv, void* out,
                     long long m, int g, cudaStream_t st) {
  exchange_h_kernel<T><<<qkan::stream_grid(m, THREADS), THREADS, 0, st>>>(
      static_cast<const T*>(kept), static_cast<const T*>(recv),
      static_cast<T*>(out), m, g);
  return cudaGetLastError();
}

}  // namespace

// kept, received, c, s: [m] contiguous on the launching card; out: [2, m].
// g: the slot's device bit (0 or 1).
extern "C" int qkan_exchange_ucry(const void* kept, const void* received,
                                  const void* c, const void* s, void* out,
                                  long long m, int g, int is_f64,
                                  void* stream) {
  if (bad_half(m, g)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_f64 ? launch_ucry<double>(kept, received, c, s, out, m, g,
                                            st)
                      : launch_ucry<float>(kept, received, c, s, out, m, g,
                                           st));
}

// As qkan_exchange_ucry with the Hadamard's constant 2x2.
extern "C" int qkan_exchange_h(const void* kept, const void* received,
                               void* out, long long m, int g, int is_f64,
                               void* stream) {
  if (bad_half(m, g)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_f64 ? launch_h<double>(kept, received, out, m, g, st)
                      : launch_h<float>(kept, received, out, m, g, st));
}
