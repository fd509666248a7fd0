// split_randint: one SNN step's key split and noise draw over B lanes,
//   (keys'[b], sub) = split(keys[b]);  u[b] = randint(sub, (n,), lo, hi)
// exactly as `jax.random.split` and `jax.random.randint` (int32, legacy
// uint32 keys, `jax_threefry_partitionable=True`) compute them, bit for
// bit: the port's plain version is core/prng.py (`split`, `randint`,
// `random_bits`, `threefry2x32`), which the CPU tests hold against live
// `jax.random`.
//
// Replaces no Pallas kernel: in JAX, XLA fuses this work into the step
// (src/repro/core/engine.py:125-127, src/repro/core/neuron.py:85-91); the
// port's torch ops ran it as ~530 launches a step.
//
// Bound on the H100: integer operations. Each element is one
// threefry2x32 (20 rounds of add, rotate, xor; 5 key injections on two
// words) and the fold, about 80 int32 operations, against one 4 B store;
// at B = 8, N = 125,000 that is ~80 M operations, ~4.8 us at the card's
// int32 rate (132 SMs x 64 lanes a clock), and 4 MB of stores, 1.2 us.
// No tensor cores: uint32 ALU work and stores only.
//
// Design: one launch a step, a grid of (neuron blocks, lanes).
//   - lane prologue: thread 0 of each block derives its lane's sub =
//     threefry(key, (0, 1)), then split(sub)'s keys for the low draw
//     (count 1) and, where the span needs it, the high draw (count 0),
//     into shared memory: two or three hashes a block (a fourth for the
//     new key) against 1,024 elements;
//   - the block of lane b's first neurons also writes keys'[b] =
//     threefry(key, (0, 0)) to a fresh tensor (never in place: other
//     blocks still read the old key);
//   - each thread draws 4 elements strided by the block's width, so the
//     warp's int32 stores are coalesced and the 4 hashes are independent
//     work for the scheduler (probes of copies of this source: 2, 4, 8
//     and 16 elements a thread and 128-thread blocks were within 3 % of
//     each other at B = 8, N = 125,000; at N = 3,010, a grid that cannot
//     fill the card, fewer elements a thread were faster, 4 and 2 by
//     about as much as the kernel takes over an empty launch). Element i
//     is threefry(k, (i >> 32, i))
//     with its two words xor-ed (n < 2^31, so the high word is 0);
//   - the fold is `randint`'s, in the same unsigned 32-bit arithmetic
//     (prng.py `randint`): for a span that is a power of two (the noise
//     span 2^17) 2^32 mod span is 0, the high draw is skipped and the
//     fold is a mask; any other span (the instance taken for it is
//     checked on the card, not used on the main path) draws both words
//     and folds with `%`;
//   - rotations are funnel shifts by constants (SHF). Three things must
//     match JAX exactly: the key-schedule parity 0x1BD11BDA, the
//     injected round counts (i + 1), and the order of the rotations.
// Keys stay int64 (B, 2) tensors holding uint32 words, the layout of
// core/prng.py; the kernel reads and writes that layout.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;                // elements a thread draws
constexpr int kBlockElems = kThreads * kPerThread;
constexpr uint32_t kParity = 0x1BD11BDA;

__device__ __forceinline__ constexpr int rotation(int r) {
  // jax's _threefry2x32_lowering: (13, 15, 26, 6) then (17, 29, 16, 24)
  return r == 0 ? 13 : r == 1 ? 15 : r == 2 ? 26 : r == 3 ? 6
       : r == 4 ? 17 : r == 5 ? 29 : r == 6 ? 16 : 24;
}

// threefry2x32 of the key (k0, k1) over the count (x0, x1), in place
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, rotation(4 * (i % 2) + r)) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// kPow2: span is a power of two (no high draw, the fold a mask)
template <bool kPow2>
__global__ void __launch_bounds__(kThreads) split_randint_kernel(
    const int64_t* __restrict__ keys, int64_t* __restrict__ keys_out,
    int32_t* __restrict__ u, int n, uint32_t lo, uint32_t span,
    uint32_t mult) {
  __shared__ uint32_t draw[4];            // the low draw's key, the high's
  const int b = blockIdx.y;
  if (threadIdx.x == 0) {
    const uint32_t k0 = (uint32_t)keys[2 * b];
    const uint32_t k1 = (uint32_t)keys[2 * b + 1];
    uint32_t s0 = 0, s1 = 1;              // sub = split(key)[1]
    threefry2x32(k0, k1, s0, s1);
    uint32_t l0 = 0, l1 = 1;              // split(sub)[1]: the low bits
    threefry2x32(s0, s1, l0, l1);
    draw[0] = l0;
    draw[1] = l1;
    if (!kPow2) {
      uint32_t h0 = 0, h1 = 0;            // split(sub)[0]: the high bits
      threefry2x32(s0, s1, h0, h1);
      draw[2] = h0;
      draw[3] = h1;
    }
    if (blockIdx.x == 0) {                // keys'[b] = split(key)[0]
      uint32_t n0 = 0, n1 = 0;
      threefry2x32(k0, k1, n0, n1);
      keys_out[2 * b] = n0;
      keys_out[2 * b + 1] = n1;
    }
  }
  __syncthreads();
  const uint32_t l0 = draw[0], l1 = draw[1];
  const int64_t row = (int64_t)b * n;
  const int64_t j0 = (int64_t)blockIdx.x * kBlockElems + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int64_t j = j0 + k * kThreads;
    if (j < n) {
      uint32_t x0 = 0, x1 = (uint32_t)j;
      threefry2x32(l0, l1, x0, x1);
      uint32_t off;
      if (kPow2) {
        off = (x0 ^ x1) & (span - 1);
      } else {
        off = (x0 ^ x1) % span;
        if (mult) {
          uint32_t y0 = 0, y1 = (uint32_t)j;
          threefry2x32(draw[2], draw[3], y0, y1);
          off = ((y0 ^ y1) % span * mult + off) % span;
        }
      }
      u[row + j] = (int32_t)(off + lo);
    }
  }
}

}  // namespace

// keys, keys_out: (B, 2) int64 words in [0, 2^32); u: (B, n) int32;
// lo (minval as uint32), span (>= 1) and mult as prng.randint derives
// them. Launches on `stream` and returns cudaGetLastError().
extern "C" int split_randint_launch(const void* keys, void* keys_out,
                                    void* u, int B, int n, unsigned lo,
                                    unsigned span, unsigned mult,
                                    void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  // at least one block a lane: it writes the lane's new key
  const int64_t blocks = ((int64_t)n + kBlockElems - 1) / kBlockElems;
  const dim3 grid((unsigned)(blocks > 0 ? blocks : 1), (unsigned)B);
  const bool pow2 = (span & (span - 1)) == 0;
  auto kernel = pow2 ? split_randint_kernel<true>
                     : split_randint_kernel<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)keys, (int64_t*)keys_out, (int32_t*)u, n, lo, span,
      mult);
  return cudaGetLastError();
}
