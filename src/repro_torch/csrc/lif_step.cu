// lif_step: the fused LIF/ANN membrane update over B lanes x N neurons.
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/lif_step.py
// (function `lif_step`, reached through `repro.kernels.ops.lif_step`).
//
// Bound on the H100: memory bytes. Each (lane, neuron) does a few dozen
// integer operations but moves 3 int32 reads (V, syn, u) and writes one
// int32 (V_next) and one byte (spike); theta, nu, lam and is_lif are (N,)
// and are read once per neuron, not per lane. At 3.35 TB/s the kernel can
// take no less than those bytes over that rate.
//
// Design: the membrane pass of membrane.cuh, storing the spikes — one
// thread per (lane, neuron) with coalesced loads; the kernel takes N as it
// is and masks the ragged edge itself (the 256-padding of the TPU wrapper
// is the TPU's tiling, not a contract). The per-neuron parameters are
// shared by the lanes and mostly come from L2 after the first lane.
#include <cuda_runtime.h>
#include <stdint.h>

#include "membrane.cuh"

// V, syn, u, V_out, spikes: (B, n) contiguous; theta, nu, lam, is_lif:
// (n,). Launches on `stream` and returns cudaGetLastError().
extern "C" int lif_step_launch(const void* V, const void* syn,
                               const void* u, const void* theta,
                               const void* nu, const void* lam,
                               const void* is_lif, void* V_out,
                               void* spikes, int B, int n, void* stream) {
  if (B <= 0 || n <= 0) return (int)cudaSuccess;
  return (int)membrane_launch<true>(V, syn, u, theta, nu, lam, is_lif,
                                    V_out, spikes, B, n,
                                    (cudaStream_t)stream);
}
