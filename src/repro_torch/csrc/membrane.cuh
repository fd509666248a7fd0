// The fixed-point membrane update of one (lane, neuron), the one
// definition that both entry points (lif_step.cu, route_lif.cu) compute,
// so the unfused and fused engine paths cannot drift apart; and the fused
// step's membrane pass (route_lif.cu).
//
// Semantics (Table 1 of the paper; repro.core.neuron is the reference):
//   xi    = (u|1) << nu            for nu >= 0   (shift clamped to 31)
//         = sign(u) * (|u| >> -nu) for nu <  0   (shift clamped to 31)
//   V'    = V + xi;  spike = V' > theta;  spike resets V' to 0
//   V''   = LIF: V' - floor(V' / 2^lam)   ANN: 0
//   V_out = V'' + syn
// Every add, subtract and multiply wraps mod 2^32, as jnp's int32 does:
// they go through uint32, where C++ defines wraparound (signed overflow
// is undefined and the compiler may assume it never happens).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

__device__ __forceinline__ int32_t wrap_mul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}

// both shifts are computed and one selected: nu differs from neuron to
// neuron, and a branch on it diverges within a warp
__device__ __forceinline__ int32_t noise_from_u(int32_t u, int32_t nu) {
  u |= 1;
  // a left shift of a negative int is undefined in C++: shift the bits
  const int pos = min(max(nu, 0), 31);
  const int32_t left = (int32_t)((uint32_t)u << pos);
  const int neg = min(max(-nu, 0), 31);
  // jnp.abs wraps at INT32_MIN; so does the negation through uint32
  const int32_t mag =
      (int32_t)(u < 0 ? 0u - (uint32_t)u : (uint32_t)u) >> neg;
  const int32_t sign = (u > 0) - (u < 0);
  return nu >= 0 ? left : wrap_mul(sign, mag);
}

// V - floor(V / 2^lam): the arithmetic shift is the exact floor (C's `/`
// truncates toward zero, which is wrong for negative V); for lam >= 31
// the floor quotient of an int32 is V >> 31.
__device__ __forceinline__ int32_t leak(int32_t V, int32_t lam) {
  int sh = lam < 0 ? 0 : (lam > 31 ? 31 : lam);
  return wrap_sub(V, V >> sh);
}

__device__ __forceinline__ int32_t membrane_step(
    int32_t V, int32_t u, int32_t theta, int32_t nu, int32_t lam,
    bool is_lif, int32_t syn, bool* spike) {
  int32_t v = wrap_add(V, noise_from_u(u, nu));
  bool s = v > theta;
  if (s) v = 0;
  v = is_lif ? leak(v, lam) : 0;
  *spike = s;
  return wrap_add(v, syn);
}

// The membrane pass over B lanes x n neurons: one thread per (lane,
// neuron), blockIdx.y the lane and a grid-stride loop over neurons in x,
// so neighbouring threads touch neighbouring addresses and every load is
// coalesced; n is taken as it is and the ragged edge masked here. V, u,
// V_out: (B, n); theta, nu, lam, is_lif: (n,), shared by the lanes. syn
// is (B, n) like V, or with kSynByNeuron (n, syn_ld), each neuron's
// lanes side by side (the fused step's accumulator); syn and V_out may
// be the same buffer: each element is read and then written by one
// thread only.
template <bool kSynByNeuron>
__global__ void membrane_kernel(const int32_t* __restrict__ V,
                                const int32_t* syn,
                                const int32_t* __restrict__ u,
                                const int32_t* __restrict__ theta,
                                const int32_t* __restrict__ nu,
                                const int32_t* __restrict__ lam,
                                const uint8_t* __restrict__ is_lif,
                                int32_t* V_out, int n, int syn_ld) {
  const int64_t lane = (int64_t)blockIdx.y * n;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += gridDim.x * blockDim.x) {
    const int64_t i = lane + j;
    const int32_t in = kSynByNeuron ? syn[(int64_t)j * syn_ld + blockIdx.y]
                                    : syn[i];
    bool s;
    V_out[i] = membrane_step(V[i], u[i], theta[j], nu[j], lam[j],
                             is_lif[j] != 0, in, &s);
  }
}

template <bool kSynByNeuron>
inline cudaError_t membrane_launch(const void* V, const void* syn,
                                   const void* u, const void* theta,
                                   const void* nu, const void* lam,
                                   const void* is_lif, void* V_out, int B,
                                   int n, cudaStream_t stream,
                                   int syn_ld = 0) {
  const int threads = 256;
  int blocks = (n + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;     // grid-stride beyond ~1M threads
  membrane_kernel<kSynByNeuron><<<dim3(blocks, B), threads, 0, stream>>>(
      (const int32_t*)V, (const int32_t*)syn, (const int32_t*)u,
      (const int32_t*)theta, (const int32_t*)nu, (const int32_t*)lam,
      (const uint8_t*)is_lif, (int32_t*)V_out, n, syn_ld);
  return cudaGetLastError();
}
