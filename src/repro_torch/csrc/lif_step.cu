// lif_step: the fused LIF/ANN membrane update over B lanes x N neurons.
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/lif_step.py
// (function `lif_step`, reached through `repro.kernels.ops.lif_step`).
// The arithmetic is membrane.cuh's `membrane_step`, the one definition
// the fused step's membrane pass shares.
//
// Bound on the H100: memory bytes. Each (lane, neuron) does a few dozen
// integer operations but moves 3 int32 reads (V, syn, u) and writes one
// int32 (V_next) and one byte (spike); theta, nu, lam and is_lif are (N,)
// and are read once per neuron, not per lane. At 3.35 TB/s the kernel can
// take no less than those bytes over that rate. No tensor cores: int32
// ALU work and memory traffic only.
//
// Design: a vectorised membrane pass. The first design took one thread
// per (lane, neuron): 4 B loads, one byte per spike store.
//   - a thread owns 4 consecutive neurons, starting on a multiple of 4, of
//     one lane (blockIdx.y). It issues its V, syn and u loads and the
//     neurons' theta, nu and lam as 16 B vectors and is_lif as one 4 B
//     word before any arithmetic, then writes V_next as one 16 B vector
//     and the 4 spikes as one 32-bit word;
//   - one lane a thread, not several: probes on the card (copies of this
//     source with 2, 4 or 8 lanes held in each thread, the parameters
//     loaded once for them) measured no faster at B = 8, N = 125,000,
//     where the parameters come from L1 or L2 for every lane after the
//     first, and slower at the MLP's N = 3,010, where the grid cannot fill
//     the card and fewer, longer threads lengthen the one wave. Neither
//     the block size (64 to 256 threads) nor dropping the spike store
//     moved the time; the membrane arithmetic without branches
//     (membrane.cuh) did, a little, at both shapes;
//   - the stores are PTX vector stores: written as int4 assignments, nvcc
//     split them into 4 B stores;
//   - alignment: lane b's row starts b*n elements past the base, so at
//     N = 3,010 the odd lanes' rows are only 8 B aligned, at an odd N only
//     4 B, and the bool spike rows start at b*n bytes. A neuron group
//     starts on a multiple of 4, so every row of one lane has the same
//     offset mod 16 B at every group, and the spike row's offset mod 4 B
//     follows it. Each lane therefore takes the widest access that all its
//     rows allow (4, 2 or 1 int32 a load, 4, 2 or 1 bytes a spike store),
//     the same for the whole block, so the choice never diverges; the last
//     group of a row (N mod 4 neurons) takes scalar accesses. Every
//     (lane, neuron) is covered exactly once for any B and N >= 1, inside
//     this kernel: nothing falls back to the plain version. When N is a
//     multiple of 4 and every base is 16 B aligned (the core network's
//     N = 125,000) a second instance drops the choice altogether (a few
//     per cent faster there in the probes).
// Left open: the spike store, which no caller on the main path reads
// (every caller keeps only V_next), is still part of the function.
#include <cuda_runtime.h>
#include <stdint.h>

#include "membrane.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kNeurons = 4;     // consecutive neurons a thread owns

// The elements (4, 2 or 1) one access of a lane's rows may take: the
// rows' byte offset mod 16 at a group of 4 neurons is that of the row
// start, OR-ed with the bases' misalignment (`base_or`: the int32 bases,
// and the spike base times 4, so that its 4 B alignment reads as 16 B).
__device__ __forceinline__ int lane_width(uint32_t base_or, int64_t row) {
  const uint32_t a = (base_or | (uint32_t)(row * 4)) & 15u;
  return a == 0 ? 4 : (a & 7u) == 0 ? 2 : 1;
}

// m of the 4 elements at p (the rest zero), w at a time
__device__ __forceinline__ void load4(int32_t (&d)[4],
                                      const int32_t* __restrict__ p, int w,
                                      int m) {
  if (w == 4) {
    const int4 x = *reinterpret_cast<const int4*>(p);
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  } else if (w == 2) {
    const int2 x = reinterpret_cast<const int2*>(p)[0];
    const int2 y = reinterpret_cast<const int2*>(p)[1];
    d[0] = x.x; d[1] = x.y; d[2] = y.x; d[3] = y.y;
  } else {
#pragma unroll
    for (int k = 0; k < kNeurons; ++k) d[k] = k < m ? p[k] : 0;
  }
}

__device__ __forceinline__ void store4(int32_t* __restrict__ p,
                                       const int32_t (&d)[4], int w, int m) {
  if (w == 4) {
    asm volatile("st.global.v4.s32 [%0], {%1, %2, %3, %4};" ::"l"(p),
                 "r"(d[0]), "r"(d[1]), "r"(d[2]), "r"(d[3]) : "memory");
  } else if (w == 2) {
    asm volatile("st.global.v2.s32 [%0], {%1, %2};" ::"l"(p), "r"(d[0]),
                 "r"(d[1]) : "memory");
    asm volatile("st.global.v2.s32 [%0], {%1, %2};" ::"l"(p + 2),
                 "r"(d[2]), "r"(d[3]) : "memory");
  } else {
#pragma unroll
    for (int k = 0; k < kNeurons; ++k)
      if (k < m) p[k] = d[k];
  }
}

// spike k of the group in byte k of `bits` (0 or 1, as torch's bool)
__device__ __forceinline__ void store_spikes(uint8_t* __restrict__ p,
                                             uint32_t bits, int w, int m) {
  if (w == 4) {
    *reinterpret_cast<uint32_t*>(p) = bits;
  } else if (w == 2) {
    reinterpret_cast<uint16_t*>(p)[0] = (uint16_t)bits;
    reinterpret_cast<uint16_t*>(p)[1] = (uint16_t)(bits >> 16);
  } else {
#pragma unroll
    for (int k = 0; k < kNeurons; ++k)
      if (k < m) p[k] = (uint8_t)(bits >> (8 * k));
  }
}

// kAligned: N % 4 == 0 and every base 16 B aligned, so every access is
// 16 B (4 B for is_lif and the spikes) and no lane chooses.
template <bool kAligned>
__global__ void __launch_bounds__(kThreads) lif_step_kernel(
    const int32_t* __restrict__ V, const int32_t* __restrict__ syn,
    const int32_t* __restrict__ u, const int32_t* __restrict__ theta,
    const int32_t* __restrict__ nu, const int32_t* __restrict__ lam,
    const uint8_t* __restrict__ is_lif, int32_t* __restrict__ V_out,
    uint8_t* __restrict__ spikes, int n, uint32_t base_or,
    bool params_vec) {
  const int64_t j0 =
      ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kNeurons;
  if (j0 >= n) return;
  const int m = (int)min((int64_t)kNeurons, n - j0);   // neurons owned
  const int64_t i0 = (int64_t)blockIdx.y * n + j0;      // in the (B, n) rows
  const int w = kAligned ? 4 : m < kNeurons ? 1
                                            : lane_width(base_or, i0 - j0);
  const int pw = kAligned || (params_vec && m == kNeurons) ? 4 : 1;
  int32_t v[4], s[4], r[4], th[4], nv[4], lm[4];
  load4(v, V + i0, w, m);
  load4(s, syn + i0, w, m);
  load4(r, u + i0, w, m);
  load4(th, theta + j0, pw, m);
  load4(nv, nu + j0, pw, m);
  load4(lm, lam + j0, pw, m);
  uint32_t lif = 0;
  if (pw == 4) {
    lif = *reinterpret_cast<const uint32_t*>(is_lif + j0);
  } else {
    for (int k = 0; k < m; ++k) lif |= (uint32_t)is_lif[j0 + k] << (8 * k);
  }
  int32_t out[4];
  uint32_t bits = 0;
#pragma unroll
  for (int k = 0; k < kNeurons; ++k) {
    bool spike;
    out[k] = membrane_step(v[k], r[k], th[k], nv[k], lm[k],
                           ((lif >> (8 * k)) & 0xffu) != 0, s[k], &spike);
    bits |= (uint32_t)spike << (8 * k);
  }
  store4(V_out + i0, out, w, m);
  store_spikes(spikes + i0, bits, w, m);
}

}  // namespace

// V, syn, u, V_out: (B, n) int32, spikes (B, n) bool, theta, nu, lam:
// (n,) int32, is_lif (n,) bool; all contiguous. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int lif_step_launch(const void* V, const void* syn,
                               const void* u, const void* theta,
                               const void* nu, const void* lam,
                               const void* is_lif, void* V_out,
                               void* spikes, int B, int n, void* stream) {
  if (B <= 0 || n <= 0) return (int)cudaSuccess;
  const uint32_t base_or =
      (uint32_t)((uintptr_t)V | (uintptr_t)syn | (uintptr_t)u |
                 (uintptr_t)V_out | ((uintptr_t)spikes << 2)) & 15u;
  const bool params_vec =
      (((uintptr_t)theta | (uintptr_t)nu | (uintptr_t)lam |
        ((uintptr_t)is_lif << 2)) & 15u) == 0;
  const int64_t groups = ((int64_t)n + kNeurons - 1) / kNeurons;
  const dim3 grid((unsigned)((groups + kThreads - 1) / kThreads),
                  (unsigned)B);
  const bool aligned = n % kNeurons == 0 && base_or == 0 && params_vec;
  auto kernel = aligned ? lif_step_kernel<true> : lif_step_kernel<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)V, (const int32_t*)syn, (const int32_t*)u,
      (const int32_t*)theta, (const int32_t*)nu, (const int32_t*)lam,
      (const uint8_t*)is_lif, (int32_t*)V_out, (uint8_t*)spikes, n, base_or,
      params_vec);
  return cudaGetLastError();
}
