// flash_attention: attention forward with an online softmax, causal or
// full, fp32 or bf16 in and out:
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, g, j]) v[b, g, j]
// over j <= i when causal, with g = h / (H / KV) (grouped-query heads;
// KV == H is the TPU kernel's contract) and scale = D**-0.5. A sliding
// window W (causal only; 0 for none) also masks j <= i - W: the local
// attention of `repro.models.attention._sdpa` (RecurrentGemma's layers).
//
// Query offset: q holds Sq rows and k, v hold Sk >= q_start + Sq keys; row
// i of q sits at position q_start + i, so the masks above read q_start + i
// for i (`_sdpa(q_start=..., kv_len=Sk)`): the sequence-sharded layout's
// block of query rows against the gathered K/V. q_start and Sk are runtime
// ints (no instance is added); with q_start = 0 and Sq == Sk the kernels
// do the arithmetic they did before the offset came, bit for bit.
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/flash_attention.py
// (function `flash_attention`, reached through
// `repro.kernels.ops.flash_attention`, which pads S to the block size). On
// the port's path it is the attention of every layer of `prefill`
// (repro_torch/models/attention.py).
//
// With an lse pointer the same kernel (template flag LSE) also writes each
// row's logsumexp, lse = m + log(max(l, 1e-30)) with m the running max of
// the scaled scores and l the denominator, into a dense fp32 (B, H, S)
// array: the Pallas kernel `_kernel_lse` (function `_flash_fwd_lse`), the
// forward of `flash_attention_trainable`, which the training path runs in
// every layer. Without it the kernel is the prefill's.
//
// Head dims: q and k are D_qk wide, v and o D_v wide. The instances are
// the pairs (D, D) for D in {64, 128, 192, 256} and (192, 128), DeepSeek-
// V2's MLA (128 + 64 for q and k, 128 for v: S = Q K^T runs at 192, P V
// at 128, and V and O are never padded).
//
// Bound on the H100: operations. The causal products are B*H*S^2*(D_qk +
// D_v) flops; the function reads q, k, v once and writes o once, so from
// S of a few hundred on it does far more arithmetic than the card can
// feed from memory. Two designs, one per input type:
//
// bf16 (`flash_attention_wgmma_kernel`, the path's; Hopper tensor cores):
//   - one block per (128 query rows, query head, batch row): two consumer
//     warpgroups of 64 rows each share every K/V tile, plus a producer
//     warpgroup, which hands its registers to the consumers (setmaxnreg:
//     24 and 240 of the 168 a thread the block starts with); the blocks
//     with the most key tiles launch first (heads vary fastest in the
//     grid, so this holds across heads). A consumer's registers at BK
//     keys: O is D_v / 2, the scores BK / 2, P_hi + P_lo BK / 2: 192 at
//     (128, 128) and (192, 128) with BK = 128, 160 at (192, 192) with
//     BK = 64. At (256, 256) (192 of them) ptxas spilled, so that
//     instance keeps one consumer warpgroup of 64 rows and no producer
//     hand-over (up to 255 registers a thread);
//   - one producer thread loads Q once and K and V tiles of BK keys (128
//     at D_v <= 128, 64 above) into a 2-stage ring with TMA (128-byte
//     swizzle, tensor maps over the model's (B, S, heads, D) strides); K
//     and V have `full` and `empty` mbarriers of their own, since a K
//     tile is free once its scores are in and a V tile only one step
//     later. TMA zero-fills rows past S. Causal key tiles in a block's
//     future are never loaded, nor, with a window, those wholly before
//     the window of the block's first row (the walk starts at tile
//     (q0 - W + 1) / BK);
//   - S = Q K^T with wgmma m64nBKk16, both operands K-major in swizzled
//     shared memory, fp32 accumulators; the scale is applied to the fp32
//     scores, not to a bf16 Q (which would add a rounding);
//   - the online softmax runs on the accumulator fragment in registers:
//     a row's columns lie in the 4 threads of a quad (two shuffles for the
//     row max); the diagonal tile and the ragged tail are masked to -1e30,
//     keys before a row's window to -inf (a row whose every key in a tile
//     is before its window keeps p = 0 there: its running max stays -1e30
//     and exp2 of -inf is 0);
//     exp2f of s * (scale * log2 e) - m, with m kept in log2 units (the
//     lse is turned back to natural log at the end);
//   - O += P V with wgmma m64nD_vk16 (N = 64, 128, 192 or 256, each an
//     instance of its own in hopper.cuh): P is fed from registers as the A
//     operand (the accumulator layout, packed in bf16 pairs, is the
//     A-fragment layout), V as an MN-major B operand from shared memory
//     (the transpose-B bit); O is rescaled by each row's alpha first;
//   - P is split as P_hi + P_lo, both bf16 (hi = p rounded, lo = the
//     rest rounded), and P V is two products: with P rounded once, the
//     rounding (2^-9 of p) moved an output across a bf16 rounding boundary
//     (one ulp, 0.031 at |o| in [4, 8)) on a peaky softmax, past the 2e-2
//     tolerance; hi + lo keeps ~16 bits of p. The denominator l is the
//     fp32 sum of the unrounded p. The cost: 1.5x the tensor-core work;
//   - within a warpgroup, tile t's scores and tile t - 1's P V are started
//     together, and tile t's softmax runs while that P V is on the tensor
//     cores; P is split into its bf16 operand registers only after that
//     P V completes (writing a pending product's operands makes ptxas
//     serialize the products);
//   - the finish divides by max(l, 1e-30), rounds with
//     __float2bfloat16_rn, stages the rows in the warpgroup's own (free)
//     Q tile and stores them with 16-byte stores; with LSE one thread of
//     each quad writes its rows' lse.
//   Alignment: TMA and the 16-byte stores need 16-byte-aligned bases and
//   (B, heads, S) strides that are multiples of 8 elements; the wrapper
//   raises for a bf16 tensor that breaks this. What bounds it now (PERF.md
//   has the measurements): the tensor-core work of three products a tile,
//   the shared-memory reads of their operands (Q and K for the scores, V
//   twice) and the K/V tiles each block streams from L2; no softmax/GEMM
//   ping-pong between the warpgroups and no TMA multicast across blocks
//   that share a KV head yet.
//
// fp32 (`flash_attention_kernel<D_qk, D_v, LSE>`): every operation in fp32
// on the CUDA cores, as the TPU kernel's contract asks (the scale before
// the product, an fp32 running max, denominator and accumulator); TF32
// would round to 10 mantissa bits and break the fp32 tolerance (2e-5).
// It only serves the fp32 parity phases, off the bf16 main path:
//   - one block of 256 threads per (64-row query block, query head, batch
//     row); the query blocks with the most key blocks are launched first;
//   - the scaled query tile stays in shared memory as fp32; key and value
//     tiles of 64 rows pass in turn through one shared fp32 tile (D_qk
//     wide, V in its first D_v columns), so that two blocks fit on an SM
//     at D = 128;
//   - each thread owns 4 query rows: a 4 x 4 tile of the scores
//     (columns tx + 16 j) and a 4 x D_v/16 tile of the accumulator (float4
//     columns 4 tx + 64 j), with that rows' running max and denominator
//     in registers, kept the same in the 16 threads of a row through
//     shuffles;
//   - causal key blocks in a query block's future are never loaded (the TPU
//     kernel's `@pl.when`), nor, with a window, the blocks wholly before
//     the window of the block's first row; the diagonal block, and the
//     ragged tail past S in place of the TPU wrapper's padding, are masked
//     with -1e30, keys before a row's window with -inf;
//   - the finish divides by max(l, 1e-30), as the TPU kernel's `_done`
//     does, and with LSE the first thread of each row writes the row's
//     lse, as `_kernel_lse`'s `_emit` does.
//   Padded rows (+4 floats) keep the shared-memory reads free of bank
//   conflicts. No fast-math: expf and IEEE division.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // key rows per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr float kNeg = -1e30f;

using hopper::allow_smem;
using hopper::make_map;
using hopper::Strides;

// the Q tile, one K/V tile (D_qk wide; V fills its first D_v columns)
// and the P tile, fp32 with padded rows
template <int DQK, int DV>
constexpr int smem_bytes() {
  static_assert(DV <= DQK, "V passes through the K tile");
  return (kBQ * (DQK + 4) + kBK * (DQK + 4) + kBQ * (kBK + 4)) * 4;
}

static_assert(kBQ == kBK, "load_tile loads the Q and K/V tiles alike");

// rows [r0, r0 + 64) of one head of x into a (64, D + 4) fp32 tile, times
// `mul`; rows at or past S are zeros
template <int D>
__device__ __forceinline__ void load_tile(float* tile, const float* x,
                                          long long stride_s, int r0, int S,
                                          float mul) {
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float val = 0.f;
    if (r0 + r < S) val = x[(long long)(r0 + r) * stride_s + d] * mul;
    tile[r * (D + 4) + d] = val;
  }
}

template <int DQK, int DV, bool LSE>
__global__ void __launch_bounds__(kThreads, DQK <= 128 ? 2 : 1)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse, Strides qs, Strides ks,
                       Strides vs, Strides os, int Sq, int Sk, int qoff,
                       int rep, int causal, int window, float scale) {
  constexpr int LD = DQK + 4;      // padded row of the Q and K tiles
  constexpr int LV = DV + 4;       // and of the V tile
  constexpr int LP = kBK + 4;      // padded row of the P tile
  constexpr int NJ = DV / 64;      // float4 column groups of O per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KVs = Qs + kBQ * LD;
  float* Ps = KVs + kBK * LD;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  // the block's first row is row q0 of q, at position p0. Only p0 stays
  // live through the key walk; the K/V and O bases are taken from the
  // block's index where they are used (at D = 128 the 128 registers of
  // two blocks an SM leave none to spare: the query offset's arithmetic
  // spilled 36 B until then)
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int p0 = qoff + q0;
  const int h = blockIdx.y, b = blockIdx.z;

  load_tile<DQK>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, Sq, scale);

  float m[4], l[4], acc[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NJ; ++c) acc[i][c] = 0.f;
  }

  const int n_all = (Sk + kBK - 1) / kBK;
  const int n_kb = causal ? min(n_all, (p0 + kBQ - 1) / kBK + 1) : n_all;
  const int kb0 = window > 0 ? max(0, p0 - window + 1) / kBK : 0;
  for (int kb = kb0; kb < n_kb; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();               // Qs is written; KVs and Ps are free
    load_tile<DQK>(KVs, k + (long long)blockIdx.z * ks.b +
                            (long long)(blockIdx.y / rep) * ks.h,
                   ks.s, k0, Sk, 1.f);
    __syncthreads();

    // scores of rows 4 ty + i against keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DQK; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(4 * ty + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&KVs[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(qv[i].x, kv[j].x, t);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          t = fmaf(qv[i].w, kv[j].w, t);
          s[i][j] = t;
        }
    }

    // mask, then the online softmax of each row across its 16 threads
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = p0 + 4 * ty + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= Sk || (causal && kpos > qpos)) s[i][j] = kNeg;
        else if (window > 0 && kpos <= qpos - window)
          s[i][j] = -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(4 * ty + i) * LP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NJ; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();               // every read of the K tile is done
    load_tile<DV>(KVs, v + (long long)blockIdx.z * vs.b +
                           (long long)(blockIdx.y / rep) * vs.h,
                  vs.s, k0, Sk, 1.f);
    __syncthreads();

    // acc += P V over the tile's 64 keys
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(4 * ty + i) * LP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&KVs[c * LV + 4 * tx + 64 * j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * j + 0] = fmaf(p[i], vv.x, acc[i][4 * j + 0]);
          acc[i][4 * j + 1] = fmaf(p[i], vv.y, acc[i][4 * j + 1]);
          acc[i][4 * j + 2] = fmaf(p[i], vv.z, acc[i][4 * j + 2]);
          acc[i][4 * j + 3] = fmaf(p[i], vv.w, acc[i][4 * j + 3]);
        }
      }
    }
  }

  float* op = o + (long long)blockIdx.z * os.b + (long long)blockIdx.y * os.h;
  const int q0e = (gridDim.x - 1 - blockIdx.x) * kBQ;     // q0 again
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0e + 4 * ty + i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if (LSE && tx == 0)
      lse[((long long)b * gridDim.y + h) * Sq + row] = m[i] + logf(den);
    float* orow = op + (long long)row * os.s;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        orow[4 * tx + 64 * j + e] = acc[i][4 * j + e] / den;
  }
}

// ------------------------------------------- bf16: wgmma, TMA, mbarriers
template <int DQK, int DV>
struct Wg {                  // the tensor-core kernel's shape at (D_qk, D_v)
  // consumer warpgroups, 64 query rows each, sharing every K/V tile; one
  // at D_v = 256, where two (O 128, the scores 32 and P_hi + P_lo 32
  // registers a thread of their 240) spilled 12 B in ptxas
  static constexpr int kWGs = DV <= 192 ? 2 : 1;
  static constexpr int kBQ = 64 * kWGs;             // query rows per block
  // keys per K/V tile: 128 while O (D_v / 2 registers a thread) leaves
  // room for 128 keys of scores and P_hi + P_lo, 64 above
  static constexpr int kBK = DV <= 128 ? 128 : 64;
  static constexpr int kQCols = DQK / 64;           // 128-byte column blocks
  static constexpr int kVCols = DV / 64;
  static constexpr int kThreads = 128 * (kWGs + 1); // + the producer's
  static constexpr int kQBytes = kBQ * DQK * 2;
  static constexpr int kKBytes = kBK * DQK * 2;     // one K tile
  static constexpr int kVBytes = kBK * DV * 2;      // one V tile
  static constexpr int kStageBytes = kKBytes + kVBytes;
  static constexpr int kStages = 2;
  // Q, the ring of K and V tiles, 9 mbarriers, 1,024 bytes of alignment
  // slack
  static constexpr int kSmem = 1024 + kQBytes + kStages * kStageBytes + 128;
  static_assert(DV <= DQK, "o is staged in the Q tile");
  static_assert(kSmem <= 232448, "more shared memory than a block has");
  // with BK < BQ (D_v > 128) a block's last causal tile may lie wholly in
  // its first warpgroup's future (as with a query offset): its scores are
  // all masked, and after the row's own keys that adds p = 0
};

// with two consumer warpgroups a block starts at 168 registers a thread
// (65,536 / 384); the producer warpgroup gives its spare ones to them
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr float kLn2 = 0.693147180559945309f;

// (a, b) = hi + lo, each a pair of bf16: hi the rounded values, lo the
// rounded rests (a - hi is exact in fp32), so hi + lo keeps ~16 bits of p
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// starts O += P_hi V + P_lo V: P (64 x BK) from registers, V (BK x DV)
// MN-major
template <int DV, int BK>
__device__ __forceinline__ void start_pv(float (&acc)[DV / 2],
                                         const uint32_t (&hi)[BK / 4],
                                         const uint32_t (&lo)[BK / 4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t vd =
        hopper::sw128_desc(v_addr + kk * 16 * 128, BK * 128, 1024);
    const uint32_t a_hi[4] = {hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2],
                              hi[4 * kk + 3]};
    const uint32_t a_lo[4] = {lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2],
                              lo[4 * kk + 3]};
    hopper::wgmma_rs_tb<DV>(acc, a_hi, vd);
    hopper::wgmma_rs_tb<DV>(acc, a_lo, vd);
  }
}

// the online softmax of one key tile on this thread's two rows (row0 and
// row0 + 8, columns k0 + 8 i + col and the next one), across its quad:
// masks the diagonal tile and the ragged tail to -1e30 and keys before a
// row's window (window > 0) to -inf (row0 and wq0 are positions: the
// query offset included), updates the
// running max m (log2 units) and the denominator l (the fp32 sum of p),
// returns each row's rescale alpha and leaves p = exp2(s * scale * log2 e
// - m) in sc, in the accumulator's layout
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], int k0,
                                             int row0, int col, int Sk,
                                             int causal, int window, int wq0,
                                             float scale_log2, float (&m)[2],
                                             float (&l)[2],
                                             float (&alpha)[2]) {
  if (k0 + BK > Sk || (causal && k0 + BK - 1 > wq0) ||
      (window > 0 && k0 <= wq0 + 63 - window)) {
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e >> 1), key = k0 + 8 * i + col + (e & 1);
        if (key >= Sk || (causal && key > row)) sc[4 * i + e] = kNeg;
        else if (window > 0 && key <= row - window)
          sc[4 * i + e] = -CUDART_INF_F;
      }
  }
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int i = 0; i < BK / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * i + e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    alpha[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < BK / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(fmaf(sc[4 * i + e], scale_log2, -m[e >> 1]));
      l[e >> 1] += p;
      sc[4 * i + e] = p;
    }
}

// p (fp32, the accumulator's layout) as P_hi + P_lo, the A operands of
// P V: bf16 pairs in the same layout
template <int BK>
__device__ __forceinline__ void split_p(const float (&p)[BK / 2],
                                        uint32_t (&hi)[BK / 4],
                                        uint32_t (&lo)[BK / 4]) {
#pragma unroll
  for (int i = 0; i < BK / 4; ++i)
    split_bf16(p[2 * i], p[2 * i + 1], hi[i], lo[i]);
}

template <int DQK, int DV, bool LSE>
__global__ void __launch_bounds__(Wg<DQK, DV>::kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             __nv_bfloat16* __restrict__ o,
                             float* __restrict__ lse, Strides os, int Sq,
                             int Sk, int qoff, int rep, int causal,
                             int window, float scale_log2) {
  using namespace hopper;
  using C = Wg<DQK, DV>;
  constexpr int BQ = C::kBQ, BK = C::kBK, NS = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  // 1,024-byte alignment, so that the 128-byte swizzle's rows line up
  uint8_t* const Qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* const KVs = Qs + C::kQBytes;  // stage s: K, then V
  uint64_t* const full_k = reinterpret_cast<uint64_t*>(
      KVs + NS * C::kStageBytes);
  uint64_t* const full_v = full_k + NS;
  uint64_t* const empty_k = full_v + NS;
  uint64_t* const empty_v = empty_k + NS;
  uint64_t* const qbar = empty_v + NS;

  const int h = blockIdx.x, b = blockIdx.z, g = h / rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest first
  const int p0 = qoff + q0;          // the position of the block's first row
  const int n_all = (Sk + BK - 1) / BK;
  // key tiles kb0 .. kb0 + n_kb - 1: from the window of the block's first
  // row (0 without a window) to its diagonal (all when not causal)
  const int kb0 = window > 0 ? max(0, p0 - window + 1) / BK : 0;
  const int n_kb =
      (causal ? min(n_all, (p0 + BQ - 1) / BK + 1) : n_all) - kb0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 4 * C::kWGs);  // one arrival per consumer warp
      mbar_init(&empty_v[s], 4 * C::kWGs);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * C::kWGs) {
    // the producer warpgroup: one thread starts every TMA copy. K and V
    // have barriers of their own: a K tile is free once its scores are
    // computed, a V tile only after the next tile's softmax
    if constexpr (C::kWGs == 2) setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * C::kWGs) {
      mbar_expect_tx(qbar, C::kQBytes);
      for (int c = 0; c < C::kQCols; ++c)
        tma_load_4d(Qs + c * BQ * 128, &qmap, qbar, 64 * c, q0, h, b);
      for (int t = 0; t < n_kb; ++t) {
        const int s = t % NS;
        const uint32_t parity = (t / NS - 1) & 1;
        uint8_t* Ks = KVs + s * C::kStageBytes;
        uint8_t* Vs = Ks + C::kKBytes;
        if (t >= NS) mbar_wait(&empty_k[s], parity);
        mbar_expect_tx(&full_k[s], C::kKBytes);
        for (int c = 0; c < C::kQCols; ++c)
          tma_load_4d(Ks + c * BK * 128, &kmap, &full_k[s], 64 * c,
                      (kb0 + t) * BK, g, b);
        if (t >= NS) mbar_wait(&empty_v[s], parity);
        mbar_expect_tx(&full_v[s], C::kVBytes);
        for (int c = 0; c < C::kVCols; ++c)
          tma_load_4d(Vs + c * BK * 128, &vmap, &full_v[s], 64 * c,
                      (kb0 + t) * BK, g, b);
      }
    }
    return;
  }
  if constexpr (C::kWGs == 2) setmaxnreg_inc<kConsumerRegs>();

  // a consumer warpgroup: query rows at positions wq0 .. wq0 + 63 (with
  // an offset, a key tile may lie wholly in the first warpgroup's future:
  // its scores are all masked, and p = 0 there)
  const int wg = warp / 4;
  const int wq0 = p0 + 64 * wg;
  const int r_in = 64 * wg + 16 * (warp % 4) + lane / 4;  // row in the block
  const int row0 = q0 + r_in;           // this thread's rows: row0, row0 + 8
  const int prow = qoff + row0;         // and their positions
  const int col = 2 * (lane % 4);       // its first column of each 8
  const uint32_t q_addr = smem_addr(Qs) + 64 * wg * 128;
  const uint32_t kv_addr = smem_addr(KVs);
  auto k_addr = [&](int t) { return kv_addr + (t % NS) * C::kStageBytes; };

  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, alpha[2];  // m: log2 units
  float sc[BK / 2];
  uint32_t hi[BK / 4], lo[BK / 4];

  // tile 0: its scores and softmax (O is still 0: no rescale)
  mbar_wait(qbar, 0);
  mbar_wait(&full_k[0], 0);
  fence_operands(sc);
  wgmma_fence();
  ss_kmajor<DQK, BK, BQ, BK>(sc, q_addr, k_addr(0));
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(sc);
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty_k[0]);
  softmax_tile<BK>(sc, kb0 * BK, prow, col, Sk, causal, window, wq0,
                   scale_log2, m, l, alpha);
  split_p<BK>(sc, hi, lo);

  // tile t's scores and tile t - 1's P V run on the tensor cores while the
  // warpgroup does tile t's softmax; P is split into its bf16 registers
  // only once that P V is done (writing a pending product's operands
  // would make ptxas serialize the products)
  for (int t = 1; t < n_kb; ++t) {
    mbar_wait(&full_k[t % NS], (t / NS) & 1);
    mbar_wait(&full_v[(t - 1) % NS], ((t - 1) / NS) & 1);
    fence_operands(sc);
    fence_operands(acc);
    wgmma_fence();
    ss_kmajor<DQK, BK, BQ, BK>(sc, q_addr, k_addr(t));
    wgmma_commit();
    wgmma_fence();
    start_pv<DV, BK>(acc, hi, lo, k_addr(t - 1) + C::kKBytes);
    wgmma_commit();
    wgmma_wait<1>();                   // the scores are in
    fence_operands(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_k[t % NS]);
    softmax_tile<BK>(sc, (kb0 + t) * BK, prow, col, Sk, causal, window,
                     wq0, scale_log2, m, l, alpha);
    wgmma_wait<0>();                   // P V of tile t - 1 is in
    fence_operands(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_v[(t - 1) % NS]);
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      acc[4 * i + 0] *= alpha[0];
      acc[4 * i + 1] *= alpha[0];
      acc[4 * i + 2] *= alpha[1];
      acc[4 * i + 3] *= alpha[1];
    }
    split_p<BK>(sc, hi, lo);
  }
  // the last tile's P V
  mbar_wait(&full_v[(n_kb - 1) % NS], ((n_kb - 1) / NS) & 1);
  fence_operands(acc);
  wgmma_fence();
  start_pv<DV, BK>(acc, hi, lo, k_addr(n_kb - 1) + C::kKBytes);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(acc);

  // finish: o = acc / max(l, 1e-30) in bf16, lse = m ln 2 + log(max(l, ..))
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    den[r] = fmaxf(l[r], 1e-30f);
    if (LSE && lane % 4 == 0 && row0 + 8 * r < Sq)
      lse[((long long)b * gridDim.x + h) * Sq + row0 + 8 * r] =
          m[r] * kLn2 + logf(den[r]);
  }
  // the rows go through this warpgroup's rows of the Q tile (its last
  // Q K^T has completed; D_v <= D_qk), in the same swizzled layout, then
  // out in 16-byte stores
#pragma unroll
  for (int i = 0; i < DV / 8; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int R = r_in + 8 * r;
      *reinterpret_cast<uint32_t*>(
          Qs + (i / 8) * BQ * 128 + R * 128 + (((i % 8) ^ (R % 8)) << 4) +
          2 * col) = pack_bf16(acc[4 * i + 2 * r] / den[r],
                               acc[4 * i + 2 * r + 1] / den[r]);
    }
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  constexpr int kChunks = DV / 8;       // 16-byte chunks in a row
  __nv_bfloat16* op = o + b * os.b + h * os.h;
  for (int idx = threadIdx.x % 128; idx < 64 * kChunks; idx += 128) {
    const int R = 64 * wg + idx / kChunks, ch = idx % kChunks;
    if (q0 + R < Sq)
      *reinterpret_cast<uint4*>(op + (long long)(q0 + R) * os.s + 8 * ch) =
          *reinterpret_cast<const uint4*>(
              Qs + (ch / 8) * BQ * 128 + R * 128 + (((ch % 8) ^ (R % 8)) << 4));
  }
}

template <int DQK, int DV, bool LSE>
int launch_fma(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int KV, int Sq, int Sk, int qoff,
               int causal, int window, float scale, Strides qs, Strides ks,
               Strides vs, Strides os, cudaStream_t st) {
  auto kernel = flash_attention_kernel<DQK, DV, LSE>;
  constexpr int bytes = smem_bytes<DQK, DV>();
  cudaError_t err = allow_smem<flash_attention_kernel<DQK, DV, LSE>>(bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, bytes, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, qs,
      ks, vs, os, Sq, Sk, qoff, H / KV, causal, window, scale);
  return (int)cudaGetLastError();
}

template <int DQK, int DV, bool LSE>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int H, int KV, int Sq, int Sk, int qoff,
                 int causal, int window, float scale, Strides qs, Strides ks,
                 Strides vs, Strides os, cudaStream_t st) {
  using C = Wg<DQK, DV>;
  CUtensorMap qm, km, vm;
  int err = make_map(&qm, q, DQK, Sq, H, B, qs, C::kBQ);
  if (!err) err = make_map(&km, k, DQK, Sk, KV, B, ks, C::kBK);
  if (!err) err = make_map(&vm, v, DV, Sk, KV, B, vs, C::kBK);
  if (err) return err;
  auto kernel = flash_attention_wgmma_kernel<DQK, DV, LSE>;
  err = (int)allow_smem<flash_attention_wgmma_kernel<DQK, DV, LSE>>(
      C::kSmem);
  if (err) return err;
  dim3 grid(H, (Sq + C::kBQ - 1) / C::kBQ, B);
  kernel<<<grid, C::kThreads, C::kSmem, st>>>(
      qm, km, vm, (__nv_bfloat16*)o, lse, os, Sq, Sk, qoff, H / KV, causal,
      window, (float)(scale * 1.4426950408889634));
  return (int)cudaGetLastError();
}

// the instances' (D_qk, D_v) pairs, as one int
constexpr int pair(int dqk, int dv) { return 1024 * dqk + dv; }

// bf16 -> the tensor-core kernel, fp32 -> the FMA kernel, at (D, Dv)
template <bool LSE>
int launch_d(int bf16, const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int H, int KV, int Sq, int Sk, int qoff,
             int D, int Dv, int causal, int window, float scale, Strides qs,
             Strides ks, Strides vs, Strides os, cudaStream_t st) {
#define FLASH_LAUNCH(DQK, DV)                                                \
  return bf16 ? launch_wgmma<DQK, DV, LSE>(q, k, v, o, lse, B, H, KV, Sq,    \
                                           Sk, qoff, causal, window, scale,  \
                                           qs, ks, vs, os, st)               \
              : launch_fma<DQK, DV, LSE>(q, k, v, o, lse, B, H, KV, Sq, Sk,  \
                                         qoff, causal, window, scale, qs,    \
                                         ks, vs, os, st)
  switch (pair(D, Dv)) {
    case pair(64, 64): FLASH_LAUNCH(64, 64);
    case pair(128, 128): FLASH_LAUNCH(128, 128);
    case pair(192, 192): FLASH_LAUNCH(192, 192);
    case pair(256, 256): FLASH_LAUNCH(256, 256);
    case pair(192, 128): FLASH_LAUNCH(192, 128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_LAUNCH
}

}  // namespace

// q: (B, H, Sq, D), k: (B, KV, Sk, D), v: (B, KV, Sk, Dv), o: (B, H, Sq,
// Dv), q's row i at position q_start + i, with q_start >= 0 and q_start +
// Sq <= Sk; fp32 (bf16 == 0, the FMA kernel) or bf16 (bf16 == 1, the
// tensor-core kernel); (D, Dv) in {(64, 64), (128, 128), (192, 192), (256,
// 256), (192, 128)}; H % KV == 0; each tensor's batch, head and sequence
// strides in elements, its last axis dense; for bf16 every base 16-byte
// aligned and every stride of an axis longer than 1 a multiple of 8. lse:
// null (the forward alone, kernel 4) or a dense fp32 (B, H, Sq) array for
// the rows' logsumexp (kernel 5). window: the sliding window W >= 1
// (causal only) or 0 for none. Launches on `stream` and returns a
// cudaError_t (cudaErrorInvalidValue for a head-dim pair it has no
// instance for, a window without causal, or an offset or lengths out of
// range).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int bf16, int B, int H, int KV, int Sq, int Sk, int q_start, int D,
    int Dv, int causal, int window, float scale,
    long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, void* stream) {
  if (KV <= 0 || H % KV != 0 || window < 0 || (window > 0 && !causal) ||
      q_start < 0 || Sq < 0 || (long long)q_start + Sq > Sk)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || Sq <= 0) return (int)cudaSuccess;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t st = (cudaStream_t)stream;
  float* l = (float*)lse;
  return l ? launch_d<true>(bf16, q, k, v, o, l, B, H, KV, Sq, Sk, q_start,
                            D, Dv, causal, window, scale, qs, ks, vs, os, st)
           : launch_d<false>(bf16, q, k, v, o, l, B, H, KV, Sq, Sk, q_start,
                             D, Dv, causal, window, scale, qs, ks, vs, os,
                             st);
}

// dynamic shared memory of one block of the kernel for (bf16, D, Dv), in
// bytes (0 for a pair it has no instance for)
extern "C" int flash_attention_smem_bytes(int bf16, int D, int Dv) {
#define FLASH_SMEM(DQK, DV) \
  return bf16 ? Wg<DQK, DV>::kSmem : smem_bytes<DQK, DV>()
  switch (pair(D, Dv)) {
    case pair(64, 64): FLASH_SMEM(64, 64);
    case pair(128, 128): FLASH_SMEM(128, 128);
    case pair(192, 192): FLASH_SMEM(192, 192);
    case pair(256, 256): FLASH_SMEM(256, 256);
    case pair(192, 128): FLASH_SMEM(192, 128);
    default: return 0;
  }
#undef FLASH_SMEM
}
