// flash_attention_bwd: the backward of causal (or full) attention with an
// fp32 softmax, from the forward's output o and logsumexp rows lse:
//   p  = exp(q_hat . k - lse),  q_hat = q * D**-0.5  (0 where masked)
//   ds = p * (dO . v - delta),  delta = rowsum(dO * o)
//   dV = p^T dO,  dK = ds^T q_hat,  dQ = D**-0.5 * ds K
// Query head h reads KV head g = h / (H / KV) (grouped-query heads; KV == H
// is the TPU kernel's contract). A sliding window W (causal only; 0 for
// none) also masks the keys j <= i - W of query i (local attention): the
// dK/dV walks stop at the last query tile that sees their keys, the dQ
// walks start at the first key tile in their window, and the tiles on the
// window's edge set p = 0 there.
//
// Query offset (the forward's, flash_attention.cu): q, dO, dQ hold Sq rows
// at positions q_start .. q_start + Sq - 1 and k, v, dK, dV hold Sk keys.
// The dK/dV walks cover every key tile and start at the first query tile
// whose diagonal reaches it (a key tile no query sees is written as
// zeros); the dQ walks stop at the diagonal of their rows' positions.
//
// Replaces the two Pallas kernels of `flash_attention_bwd` in
// src/repro/kernels/flash_attention.py: `_bwd_dkv_kernel` (dK and dV, one
// kv block across the q blocks) and `_bwd_dq_kernel` (dQ, one q block
// across the kv blocks), the backward of `flash_attention_trainable`. On
// the port's path they are the attention backward of every layer of the
// training step (repro_torch/kernels/flash_attention.py). delta is computed
// by the wrapper, as JAX computes it outside its kernels.
//
// Head dims: q, k, dQ and dK are D_qk wide, v, dO and dV D_v wide, at the
// forward's pairs (D, D) for D in {64, 128, 192, 256} and (192, 128),
// DeepSeek-V2's MLA: s, dK and dQ run at 192, dV and dP at 128.
//
// Bound on the H100: operations. The function needs five causal products
// (s, dK, dQ at D_qk, dV, dP at D_v; B*H*S^2*D / 2 multiply-adds each);
// the two kernels, like the TPU's, recompute s and dP in both, seven in
// all: two kernels and not one with a float-atomic dQ, so that two calls
// give the same bits. dK and dV leave the dK/dV kernel as fp32 partials
// (B, KV, chunks, S, D_qk) and (.., D_v), one per chunk of each group's
// query heads, which the wrapper sums in order.
//
// bf16 (`flash_bwd_dkv_wgmma_kernel`, `flash_bwd_dq_wgmma_kernel`, the
// path's; Hopper tensor cores, with the building blocks and tile layout of
// the forward, flash_attention.cu and hopper.cuh):
//   - every product is a wgmma with fp32 accumulators on 128-byte-swizzled
//     bf16 tiles that TMA loads over the model's (B, S, heads, D) strides
//     (zeros past S); a producer warpgroup hands its registers to two
//     consumer warpgroups (setmaxnreg 24 / 240) and keeps an mbarrier ring
//     of 2 stages full; the blocks with the longest causal walks launch
//     first;
//   - the scale is applied to the fp32 scores (exp2 of s * scale * log2 e
//     - lse * log2 e) and to the fp32 dK and dQ at the end, never to a bf16
//     q, which would add a rounding;
//   - P and dS enter their products rounded to bf16 once: the tolerance is
//     2e-2 of each gradient's largest magnitude, and a CPU emulation of
//     this arithmetic (tests/test_torch_flash_attention.py) stays within
//     about 0.004 of it on the training-shape, peaky, flat, ragged, full,
//     D = 192 and D = 256 cases;
//   - dK/dV: one block per (key tile, KV head, batch row, chunk of the
//     group's H / KV query heads). Each consumer warpgroup owns 64 keys
//     (a block 128); K and V stay in shared memory while the producer
//     streams the chunk's (Q, dO) tiles of 64 rows, head after head, from
//     the key tile's diagonal on (all when not causal), and one producer
//     warp stages each tile's 64 lse * log2 e and delta values (+inf and 0
//     past S, so p = 0 there). Per tile: S^T = K Q^T and dP^T = V dO^T
//     (both operands K-major), P^T with each column's lse, dV += P^T dO
//     (P^T from registers, dO MN-major), dS^T = P^T (dP^T - delta), dK +=
//     dS^T Q (Q MN-major). dK + dV take 128 registers a thread at D = 128,
//     S^T and dP^T 64 more. At (192, 128) dK + dV take 160: there dS^T
//     is formed before either bf16 operand is packed and both products
//     start after it, so that no operand is live beside S^T and dP^T
//     (with dV += P^T dO started first, ptxas spilled there). Where dK +
//     dV would be 192 (192, 192) or 256 (256, 256) registers, the two
//     warpgroups share one tile of 64 keys: one holds dV (S^T, P^T, P^T
//     dO), the other dK (S^T and dP^T, dS^T, dS^T Q); each computes S^T
//     itself, one product more than passing P^T through shared memory
//     but no barrier between them;
//   - the GQA chunks: the fewest chunks of the group's query heads (a
//     divisor of H / KV) that give at least 256 blocks, two per SM of the
//     H100's 132 (causal walks differ in length, so one wave would leave
//     SMs idle). At the training shape (B = 1, S = 4,096, 16 / 2 heads,
//     D = 128) that is 4 chunks of 2 heads, 256 blocks, and partials of
//     2 x 16.8 MB in place of the 2 x 33.5 MB that one partial per query
//     head took. The count depends on the shape only, so two calls give
//     the same bits;
//   - dQ: one block per (128 query rows in two consumer warpgroups, query
//     head, batch row; 64 rows and one warpgroup at D = 256, where Q and
//     dO of 128 rows and the ring would not fit in shared memory); Q, dO
//     and each thread's two rows of lse and delta stay resident while K
//     and V tiles of 128 keys (64 above D_qk = 128: dQ is 96 registers a
//     thread at 192, S, dP and dS 80 more) stream through a 2-stage ring
//     up to the diagonal, K and V with full and empty barriers of their
//     own (a V tile is free once dP is in). Per tile: S = Q K^T, dP = dO
//     V^T, P and dS per row, dQ += dS K (dS from registers, K MN-major).
//     The finish scales dQ, rounds it with __float2bfloat16_rn, stages it
//     in the warpgroup's own rows of the Q tile and stores it in q's
//     strides with 16-byte stores.
//   Alignment: TMA and the 16-byte stores need 16-byte-aligned q, k, v, dO
//   and dQ with (B, heads, S) strides that are multiples of 8 elements; the
//   wrapper raises for a bf16 tensor that breaks this.
//
// fp32 (`flash_bwd_dkv_kernel<float, D_qk, D_v>`, `flash_bwd_dq_kernel<..>`):
// every operation in fp32 FMAs on the CUDA cores, the TPU kernels' fp32
// contract (TF32 would break the 1e-4 tolerance); only the fp32 parity
// phases run them. Both with 256 threads (16 x 16) per block and 64-row
// tiles:
//   - flash_bwd_dkv_kernel: one block per (64-key tile, query head, batch
//     row); its K and V tiles stay in shared memory while it walks the q
//     tiles at and after its diagonal (all of them when not causal), the
//     longest walks launched first. Q (scaled) and dO pass in turn through
//     one shared tile. A thread owns a 4 x 4 tile of s / dP (query rows
//     4 ty + i, keys tx + 16 j) and 4 x D/16 tiles of dK and dV (keys
//     4 ty + i, float4 columns 4 tx + 64 j) in registers. p and then ds go
//     through one shared (64, 68) tile, read transposed for p^T dO and
//     ds^T q_hat. Its partials are per query head (H / KV chunks);
//   - flash_bwd_dq_kernel: one block per (64-row q tile, query head, batch
//     row); its Q (scaled) and dO tiles stay in shared memory while it
//     walks the kv tiles up to its diagonal, the longest walks first. V
//     passes first (dP), then K (s, then dQ += ds K from the same tile).
//     dQ is scaled and rounded to the output type in the finish.
//   - p is recomputed from the lse, with masked pairs and the ragged tail
//     past S set to 0 (the TPU kernels mask the scores to -1e30, whose
//     exp is 0); rows past S load as zeros and are never written.
//   Padded rows (+4 floats) keep the shared-memory reads free of bank
//   conflicts. Shared memory is 2 (64, D_qk + 4) tiles and a (64, D_v + 4)
//   one, the (64, 68) tile and two 64-float rows: 70 KB at D = 64, 119 KB
//   at D = 128, 152 KB at (192, 128), 168 KB at D = 192, 218 KB at D =
//   256. No fast-math: expf.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kB = 64;           // rows of every tile (query and key)
constexpr int kThreads = 256;    // 16 x 16
constexpr int LP = kB + 4;       // padded row of the p / ds tile

using hopper::allow_smem;
using hopper::make_map;
using hopper::Strides;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// two D_qk-wide tiles, a D_v-wide one (D_v <= D_qk), the p / ds tile and
// two rows
template <int DQK, int DV>
constexpr int smem_bytes() {
  static_assert(DV <= DQK, "dO and V pass through the D_qk-wide tile");
  return (2 * kB * (DQK + 4) + kB * (DV + 4) + kB * LP + 2 * kB) * 4;
}

// rows [r0, r0 + 64) of one head of x into a (64, D + 4) fp32 tile, times
// `mul`; rows at or past S are zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* tile, const T* x,
                                          long long stride_s, int r0, int S,
                                          float mul) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float val = 0.f;
    if (r0 + r < S) val = to_f32(x[(long long)(r0 + r) * stride_s + d]) * mul;
    tile[r * (D + 4) + d] = val;
  }
}

// s[i][j] = A[4 ty + i] . B[tx + 16 j] over D (rows of two tiles)
template <int D>
__device__ __forceinline__ void row_dots(float (&s)[4][4], const float* A,
                                         const float* Bt, int tx, int ty) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(&A[(4 * ty + i) * LD + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(&Bt[(tx + 16 * j) * LD + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = s[i][j];
        t = fmaf(a[i].x, b[j].x, t);
        t = fmaf(a[i].y, b[j].y, t);
        t = fmaf(a[i].z, b[j].z, t);
        t = fmaf(a[i].w, b[j].w, t);
        s[i][j] = t;
      }
  }
}

// acc[i][4 j + e] += sum_c P[c][row i] * X[c][4 tx + 64 j + e], where the
// row of P is 4 ty + i, read down P's columns when TRANS (P^T X: P is
// (query, key) and the rows are keys) and along its rows otherwise (P X)
template <int D, bool TRANS>
__device__ __forceinline__ void acc_product(float (&acc)[4][D / 16],
                                            const float* P, const float* X,
                                            int tx, int ty) {
  constexpr int LD = D + 4;
  constexpr int NJ = D / 64;
#pragma unroll 4
  for (int c = 0; c < kB; ++c) {
    float p[4];
    if (TRANS) {
      const float4 pc = *reinterpret_cast<const float4*>(&P[c * LP + 4 * ty]);
      p[0] = pc.x;
      p[1] = pc.y;
      p[2] = pc.z;
      p[3] = pc.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = P[(4 * ty + i) * LP + c];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 x =
          *reinterpret_cast<const float4*>(&X[c * LD + 4 * tx + 64 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][4 * j + 0] = fmaf(p[i], x.x, acc[i][4 * j + 0]);
        acc[i][4 * j + 1] = fmaf(p[i], x.y, acc[i][4 * j + 1]);
        acc[i][4 * j + 2] = fmaf(p[i], x.z, acc[i][4 * j + 2]);
        acc[i][4 * j + 3] = fmaf(p[i], x.w, acc[i][4 * j + 3]);
      }
    }
  }
}

// p[i][j] = exp(s[i][j] - lse of row i), or 0 where the pair is masked:
// query past the last (position q_end) or key at or past Sk, (causal) the
// key after the query, or (window > 0) the key before the query's window;
// p0 is the position of the tile's first query row
__device__ __forceinline__ void probs(float (&s)[4][4], const float* L,
                                      int p0, int k0, int q_end, int Sk,
                                      int causal, int window, int tx,
                                      int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = p0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + tx + 16 * j;
      const bool live = qpos < q_end && kpos < Sk &&
                        (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
      s[i][j] = live ? expf(s[i][j] - L[i]) : 0.f;
    }
  }
}

__device__ __forceinline__ void put_tile(float* P, const float (&x)[4][4],
                                         int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) P[(4 * ty + i) * LP + tx + 16 * j] = x[i][j];
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, Strides qs, Strides ks,
                     Strides vs, Strides dos, int Sq, int Sk, int qoff,
                     int rep, int causal, int window, float scale) {
  constexpr int LD = DQK + 4;      // the rows of K and q_hat
  constexpr int NJ = DQK / 64, NV = DV / 64;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Xs = Ks + kB * LD;        // q_hat, then dO, then q_hat again
  float* Vs = Xs + kB * LD;
  float* Ps = Vs + kB * (DV + 4);  // p, then ds
  float* Lrow = Ps + kB * LP;      // the q tile's lse
  float* Drow = Lrow + kB;         // the q tile's delta

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int kb = blockIdx.x;       // the longest walks (kb = 0) first
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int g = h / rep;
  const int k0 = kb * kB;
  const T* qp = q + b * qs.b + h * qs.h;
  const T* dop = dout + b * dos.b + h * dos.h;
  const T* kp = k + b * ks.b + g * ks.h;
  const T* vp = v + b * vs.b + g * vs.h;
  const long long row0 = ((long long)b * H + h) * Sq;   // lse, delta
  const long long out0 = ((long long)b * H + h) * Sk;   // dk, dv

  load_tile<T, DQK>(Ks, kp, ks.s, k0, Sk, 1.f);
  load_tile<T, DV>(Vs, vp, vs.s, k0, Sk, 1.f);

  float dka[4][4 * NJ], dva[4][4 * NV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 4 * NJ; ++c) dka[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NV; ++c) dva[i][c] = 0.f;
  }

  const int nq = (Sq + kB - 1) / kB;
  // the q tiles that see the key tile: from its diagonal (all when not
  // causal) to the last row of its keys' window (none: its keys get zeros)
  const int last = k0 + kB + window - 2 - qoff;  // that row, with a window
  const int nq_end = window > 0 ? (last < 0 ? 0 : min(nq, last / kB + 1))
                                : nq;
  for (int qb = causal ? max(0, k0 - qoff) / kB : 0; qb < nq_end; ++qb) {
    const int q0 = qb * kB;
    __syncthreads();               // the last tile's reads are done
    load_tile<T, DQK>(Xs, qp, qs.s, q0, Sq, scale);
    for (int i = threadIdx.x; i < kB; i += kThreads) {
      const bool in = q0 + i < Sq;
      Lrow[i] = in ? lse[row0 + q0 + i] : 0.f;
      Drow[i] = in ? delta[row0 + q0 + i] : 0.f;
    }
    __syncthreads();

    float p[4][4], L[4];
    row_dots<DQK>(p, Xs, Ks, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) L[i] = Lrow[4 * ty + i];
    probs(p, L, qoff + q0, k0, qoff + Sq, Sk, causal, window, tx, ty);
    __syncthreads();               // every read of q_hat is done
    load_tile<T, DV>(Xs, dop, dos.s, q0, Sq, 1.f);
    put_tile(Ps, p, tx, ty);
    __syncthreads();

    acc_product<DV, true>(dva, Ps, Xs, tx, ty);      // dV += p^T dO
    float dpv[4][4];
    row_dots<DV>(dpv, Xs, Vs, tx, ty);               // dP = dO V^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float dl = Drow[4 * ty + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] *= dpv[i][j] - dl;
    }
    __syncthreads();               // every read of p and dO is done
    put_tile(Ps, p, tx, ty);
    load_tile<T, DQK>(Xs, qp, qs.s, q0, Sq, scale);
    __syncthreads();
    acc_product<DQK, true>(dka, Ps, Xs, tx, ty);     // dK += ds^T q_hat
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + 4 * ty + i;
    if (row >= Sk) continue;
    float* krow = dk + (out0 + row) * DQK;
    float* vrow = dv + (out0 + row) * DV;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      *reinterpret_cast<float4*>(krow + 4 * tx + 64 * j) = make_float4(
          dka[i][4 * j], dka[i][4 * j + 1], dka[i][4 * j + 2],
          dka[i][4 * j + 3]);
#pragma unroll
    for (int j = 0; j < NV; ++j)
      *reinterpret_cast<float4*>(vrow + 4 * tx + 64 * j) = make_float4(
          dva[i][4 * j], dva[i][4 * j + 1], dva[i][4 * j + 2],
          dva[i][4 * j + 3]);
  }
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Strides qs, Strides ks, Strides vs, Strides dos,
                    Strides dqs, int Sq, int Sk, int qoff, int rep,
                    int causal, int window, float scale) {
  constexpr int LD = DQK + 4;
  constexpr int NJ = DQK / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);     // q_hat
  float* Xs = Qs + kB * LD;                        // V, then K
  float* DOs = Xs + kB * LD;                       // dO
  float* Ps = DOs + kB * (DV + 4);                 // ds

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qb = gridDim.x - 1 - blockIdx.x;       // the longest walks first
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int g = h / rep;
  const int q0 = qb * kB;
  const T* kp = k + b * ks.b + g * ks.h;
  const T* vp = v + b * vs.b + g * vs.h;
  const long long row0 = ((long long)b * H + h) * Sq;
  const int p0 = qoff + q0;        // the position of the block's first row

  load_tile<T, DQK>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, Sq, scale);
  load_tile<T, DV>(DOs, dout + b * dos.b + h * dos.h, dos.s, q0, Sq, 1.f);
  float L[4], Dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    L[i] = row < Sq ? lse[row0 + row] : 0.f;
    Dl[i] = row < Sq ? delta[row0 + row] : 0.f;
  }

  float acc[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NJ; ++c) acc[i][c] = 0.f;

  const int n_all = (Sk + kB - 1) / kB;
  const int n_kb = causal ? min(n_all, (p0 + kB - 1) / kB + 1) : n_all;
  const int kb0 = window > 0 ? max(0, p0 - window + 1) / kB : 0;
  for (int kb = kb0; kb < n_kb; ++kb) {
    const int k0 = kb * kB;
    __syncthreads();               // Qs, DOs written; the last K read done
    load_tile<T, DV>(Xs, vp, vs.s, k0, Sk, 1.f);
    __syncthreads();
    float dpv[4][4];
    row_dots<DV>(dpv, DOs, Xs, tx, ty);              // dP = dO V^T
    __syncthreads();               // every read of V is done
    load_tile<T, DQK>(Xs, kp, ks.s, k0, Sk, 1.f);
    __syncthreads();
    float p[4][4];
    row_dots<DQK>(p, Qs, Xs, tx, ty);                // s = q_hat K^T
    probs(p, L, p0, k0, qoff + Sq, Sk, causal, window, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] *= dpv[i][j] - Dl[i];
    put_tile(Ps, p, tx, ty);
    __syncthreads();
    acc_product<DQK, false>(acc, Ps, Xs, tx, ty);    // dQ += ds K
  }

  T* dqp = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Sq) continue;
    T* out = dqp + (long long)row * dqs.s;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(out + 4 * tx + 64 * j + e, scale * acc[i][4 * j + e]);
  }
}

template <typename T, int DQK, int DV>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, float* dk, float* dv,
               int B, int H, int KV, int Sq, int Sk, int qoff, int causal,
               int window, float scale, Strides qs, Strides ks, Strides vs,
               Strides dos, cudaStream_t st) {
  auto kernel = flash_bwd_dkv_kernel<T, DQK, DV>;
  constexpr int bytes = smem_bytes<DQK, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sk + kB - 1) / kB, H, B);
  kernel<<<grid, kThreads, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, dk,
      dv, qs, ks, vs, dos, Sq, Sk, qoff, H / KV, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DQK, int DV>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int H,
              int KV, int Sq, int Sk, int qoff, int causal, int window,
              float scale, Strides qs, Strides ks, Strides vs, Strides dos,
              Strides dqs, cudaStream_t st) {
  auto kernel = flash_bwd_dq_kernel<T, DQK, DV>;
  constexpr int bytes = smem_bytes<DQK, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kB - 1) / kB, H, B);
  kernel<<<grid, kThreads, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, qs, ks, vs, dos, dqs, Sq, Sk, qoff, H / KV, causal, window,
      scale);
  return (int)cudaGetLastError();
}


// ------------------------------------------- bf16: wgmma, TMA, mbarriers
// with two consumer warpgroups a block starts at 168 registers a thread
// (65,536 / 384); the producer warpgroup gives its spare ones to them
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
// the dK/dV kernel takes the fewest chunks of a group's query heads that
// give it this many blocks
constexpr long long kMinBlocks = 256;

template <int DQK, int DV>
struct Dkv {                   // the dK/dV tensor-core kernel's shape
  // each consumer warpgroup owns 64 keys and both accumulators while dK
  // + dV take at most 160 registers a thread ((192, 128): 96 + 64, with
  // S^T and dP^T 64 more, all of the budget of 240 but a few: see
  // dkv_consumer's kLate); above, the two warpgroups share 64 keys, one
  // holding dV and one dK
  static constexpr bool kSplit = (DQK + DV) / 2 > 160;
  static constexpr int kKeys = kSplit ? 64 : 128;   // keys per block
  static constexpr int kBQ = 64;                    // rows per Q / dO tile
  static constexpr int kQCols = DQK / 64;           // 128-byte column blocks
  static constexpr int kVCols = DV / 64;
  static constexpr int kThreads = 384;              // 2 consumer WGs + 1
  static constexpr int kKBytes = kKeys * DQK * 2;   // the K tile
  static constexpr int kVBytes = kKeys * DV * 2;    // the V tile
  static constexpr int kQBytes = kBQ * DQK * 2;     // one Q tile
  static constexpr int kOBytes = kBQ * DV * 2;      // one dO tile
  static constexpr int kStageBytes = kQBytes + kOBytes;
  static constexpr int kStages = 2;
  // K, V, the ring of (Q, dO) tiles and of their lse * log2 e and delta
  // rows, 5 mbarriers, 1,024 bytes of alignment slack
  static constexpr int kSmem = 1024 + kKBytes + kVBytes +
                               kStages * (kStageBytes + 2 * kBQ * 4) + 64;
  static_assert(kSmem <= 232448, "more shared memory than a block has");
};

// the instances' (D_qk, D_v) pairs, as one int
constexpr int pair(int dqk, int dv) { return 1024 * dqk + dv; }

// keys a dK/dV block, for (D_qk, D_v) (0 for a pair with no instance)
int dkv_keys(int D, int Dv) {
  switch (pair(D, Dv)) {
    case pair(64, 64): return Dkv<64, 64>::kKeys;
    case pair(128, 128): return Dkv<128, 128>::kKeys;
    case pair(192, 192): return Dkv<192, 192>::kKeys;
    case pair(256, 256): return Dkv<256, 256>::kKeys;
    case pair(192, 128): return Dkv<192, 128>::kKeys;
    default: return 0;
  }
}

template <int DQK, int DV>
struct Dq {                          // the dQ tensor-core kernel's shape
  // consumer warpgroups, 64 query rows each, sharing every K/V tile; one
  // at D_qk = 256, where Q and dO of 128 rows (131,072 B) and a 2-stage
  // ring of 64-key K and V tiles (131,072 B) would not fit in 227 KB
  static constexpr int kWGs = DQK <= 192 ? 2 : 1;
  static constexpr int kBQ = 64 * kWGs;             // query rows per block
  // keys per K/V tile: 128 while dQ (D_qk / 2 registers a thread) leaves
  // room for 128 keys of S, dP and dS, 64 above
  static constexpr int kBK = DQK <= 128 ? 128 : 64;
  static constexpr int kQCols = DQK / 64;
  static constexpr int kVCols = DV / 64;
  static constexpr int kThreads = 128 * (kWGs + 1); // + the producer's
  static constexpr int kQBytes = kBQ * DQK * 2;     // Q
  static constexpr int kOBytes = kBQ * DV * 2;      // dO
  static constexpr int kKBytes = kBK * DQK * 2;     // one K tile
  static constexpr int kVBytes = kBK * DV * 2;      // one V tile
  static constexpr int kStageBytes = kKBytes + kVBytes;
  static constexpr int kStages = 2;
  // Q, dO, the ring of K and V tiles, 9 mbarriers, 1,024 bytes of slack
  static constexpr int kSmem =
      1024 + kQBytes + kOBytes + kStages * kStageBytes + 128;
  static_assert(DV <= DQK, "dQ is staged in the Q tile");
  static_assert(kSmem <= 232448, "more shared memory than a block has");
  // with BK < BQ a block's last causal tile may lie wholly in its first
  // warpgroup's future (as with a query offset): every pair of it is
  // masked, p = 0
};

// one consumer warpgroup of the dK/dV kernel: keys wk0 .. wk0 + 63 against
// each of the block's n_it (Q, dO) tiles (head it / nt, q tile t0 + it %
// nt, its rows at positions qoff + ..); HV / HK: which of the two
// accumulators it holds; window: the sliding window (0 for none). Writes
// its rows of the chunk's fp32 partials (dK scaled; zeros for keys no
// query sees), dk D_qk and dv D_v wide.
template <int DQK, int DV, bool HV, bool HK>
__device__ __forceinline__ void dkv_consumer(
    const uint8_t* ring, const float* rows, uint64_t* full, uint64_t* empty,
    uint32_t k_addr, uint32_t v_addr, float* __restrict__ dk,
    float* __restrict__ dv, int wk0, int t0, int nt, int n_it, int Sk,
    int qoff, int causal, int window, float scale, float scale_log2) {
  using namespace hopper;
  using C = Dkv<DQK, DV>;
  constexpr int NS = C::kStages, BQ = C::kBQ;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int r_in = 16 * warp + lane / 4;  // its keys: wk0 + r_in, + 8
  const int col = 2 * (lane % 4);         // its first query of each 8
  float dva[HV ? DV / 2 : 1], dka[HK ? DQK / 2 : 1];
#pragma unroll
  for (int i = 0; i < (HV ? DV / 2 : 1); ++i) dva[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (HK ? DQK / 2 : 1); ++i) dka[i] = 0.f;
  float st[BQ / 2], dp[BQ / 2];           // S^T (then P^T), dP^T (then dS^T)
  uint32_t ab[BQ / 4];                    // P^T or dS^T in bf16 pairs
  // with both accumulators above 128 registers ((192, 128): 160), dS^T
  // is formed before either bf16 operand is packed and S^T, dP^T are
  // written afresh each tile (no fence keeps their old values): the peak
  // holds S^T and dP^T but no operand beside them (with dV += P^T dO
  // started before dS^T, as below, ptxas spilled)
  constexpr bool kLate = HV && HK && DQK + DV > 256;

  for (int it = 0; it < n_it; ++it) {
    const int s = it % NS;
    const int q0 = (t0 + it % nt) * BQ + qoff;  // its first row's position
    mbar_wait(&full[s], (it / NS) & 1);
    // the tile is skipped when its queries see none of the keys: all
    // in their future, or (window) all before their windows
    if (wk0 < Sk && !(causal && wk0 > q0 + BQ - 1) &&
        !(window > 0 && wk0 + 63 <= q0 - window)) {
      const uint32_t q_addr = smem_addr(ring + s * C::kStageBytes);
      const uint32_t do_addr = q_addr + C::kQBytes;
      const float* lrow = rows + s * 2 * BQ;  // lse * log2 e, then delta
      const float* drow = lrow + BQ;
      if constexpr (!kLate) {
        fence_operands(st);
        if constexpr (HK) fence_operands(dp);
      }
      wgmma_fence();
      ss_kmajor<DQK, BQ, C::kKeys, BQ>(st, k_addr, q_addr); // S^T = K Q^T
      wgmma_commit();
      if constexpr (HK) {
        ss_kmajor<DV, BQ, C::kKeys, BQ>(dp, v_addr, do_addr); // V dO^T
        wgmma_commit();
        if constexpr (kLate) wgmma_wait<0>();
        else wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_operands(st);
      // P^T = exp2(S^T scale log2 e - lse log2 e), one lse per column; on
      // the diagonal the keys after their query are 0, on the window's
      // edge the keys before their query's window: a pair of such a tile
      // lives iff d = query - key lies in [0, window) (one unsigned
      // compare; without a window, [0, INT_MAX) is the diagonal's test)
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        const float2 l = *reinterpret_cast<const float2*>(lrow + 8 * i + col);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[4 * i + e] = exp2f(fmaf(st[4 * i + e], scale_log2,
                                     -((e & 1) ? l.y : l.x)));
      }
      if ((causal && wk0 + 63 > q0) ||
          (window > 0 && wk0 <= q0 + BQ - 1 - window)) {
        const unsigned span = window > 0 ? (unsigned)window : 0x7fffffffu;
        const int d0 = q0 + col - wk0 - r_in;
#pragma unroll
        for (int i = 0; i < BQ / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if ((unsigned)(d0 + 8 * i + (e & 1) - 8 * (e >> 1)) >= span)
              st[4 * i + e] = 0.f;
      }
      if constexpr (kLate) {
        fence_operands(dp);
#pragma unroll
        for (int i = 0; i < BQ / 8; ++i) {
          const float2 d = *reinterpret_cast<const float2*>(drow + 8 * i + col);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * i + e] = st[4 * i + e] * (dp[4 * i + e] - ((e & 1) ? d.y : d.x));
        }
        uint32_t pa[BQ / 4], sa[BQ / 4];
        pack_a<BQ>(st, pa);
        fence_operands(dva);
        wgmma_fence();
        rs_mnmajor<DV, BQ, BQ>(dva, pa, do_addr);             // dV += P^T dO
        wgmma_commit();
        pack_a<BQ>(dp, sa);
        fence_operands(dka);
        wgmma_fence();
        rs_mnmajor<DQK, BQ, BQ>(dka, sa, q_addr);             // dK += dS^T Q
        wgmma_commit();
      }
      if constexpr (HV && !kLate) {
        pack_a<BQ>(st, ab);
        fence_operands(dva);
        wgmma_fence();
        rs_mnmajor<DV, BQ, BQ>(dva, ab, do_addr);             // dV += P^T dO
        wgmma_commit();
      }
      if constexpr (HK && !kLate) {
        if constexpr (HV) wgmma_wait<1>();                    // dP^T is in
        else wgmma_wait<0>();
        fence_operands(dp);
#pragma unroll
        for (int i = 0; i < BQ / 8; ++i) {
          const float2 d = *reinterpret_cast<const float2*>(drow + 8 * i + col);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * i + e] = st[4 * i + e] * (dp[4 * i + e] - ((e & 1) ? d.y : d.x));
        }
        if constexpr (HV) {                // P^T dO is done: ab is free
          wgmma_wait<0>();
          fence_operands(dva);
        }
        pack_a<BQ>(dp, ab);
        fence_operands(dka);
        wgmma_fence();
        rs_mnmajor<DQK, BQ, BQ>(dka, ab, q_addr);             // dK += dS^T Q
        wgmma_commit();
      }
      wgmma_wait<0>();
      if constexpr (HV) fence_operands(dva);
      if constexpr (HK) fence_operands(dka);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wk0 + r_in + 8 * r;
    if (row >= Sk) continue;
    if constexpr (HV) {
#pragma unroll
      for (int i = 0; i < DV / 8; ++i)
        *reinterpret_cast<float2*>(dv + (long long)row * DV + 8 * i + col) =
            make_float2(dva[4 * i + 2 * r], dva[4 * i + 2 * r + 1]);
    }
    if constexpr (HK) {
#pragma unroll
      for (int i = 0; i < DQK / 8; ++i)
        *reinterpret_cast<float2*>(dk + (long long)row * DQK + 8 * i + col) =
            make_float2(scale * dka[4 * i + 2 * r],
                        scale * dka[4 * i + 2 * r + 1]);
    }
  }
}

// dK and dV partials, dk / dv fp32 (B, KV, chunks, Sk, D_qk / D_v): grid
// (KV * chunks, key tiles, B)
template <int DQK, int DV>
__global__ void __launch_bounds__(Dkv<DQK, DV>::kThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap domap,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv,
                           int Sq, int Sk, int qoff, int H, int rep,
                           int chunks, int causal, int window, float scale,
                           float scale_log2) {
  using namespace hopper;
  using C = Dkv<DQK, DV>;
  constexpr int NS = C::kStages, BQ = C::kBQ;
  extern __shared__ uint8_t smem_raw[];
  // 1,024-byte alignment, so that the 128-byte swizzle's rows line up
  uint8_t* const Ks = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* const Vs = Ks + C::kKBytes;
  uint8_t* const ring = Vs + C::kVBytes;            // stage s: Q, then dO
  float* const rows = reinterpret_cast<float*>(ring + NS * C::kStageBytes);
  uint64_t* const full = reinterpret_cast<uint64_t*>(rows + NS * 2 * BQ);
  uint64_t* const empty = full + NS;
  uint64_t* const kvbar = empty + NS;

  const int g = blockIdx.x / chunks, chunk = blockIdx.x % chunks;
  const int KV = gridDim.x / chunks, b = blockIdx.z;
  const int k0 = blockIdx.y * C::kKeys;   // the longest walks (k0 = 0) first
  const int per = rep / chunks;            // the chunk's query heads
  const int h0 = g * rep + chunk * per;
  const int nq = (Sq + BQ - 1) / BQ;
  // the first q tile seeing a key
  const int t0 = causal ? max(0, k0 - qoff) / BQ : 0;
  // one past the last: the tile of the last row in the last key's window
  const int last = k0 + C::kKeys + window - 2 - qoff;
  const int t_end =
      window > 0 ? (last < 0 ? 0 : min(nq, last / BQ + 1)) : nq;
  const int nt = max(0, t_end - t0), n_it = per * nt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1 + 32);   // the TMA thread and the rows' warp
      mbar_init(&empty[s], 8);       // one arrival per consumer warp
    }
    mbar_init(kvbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    // the producer warpgroup: one thread starts every TMA copy, one warp
    // stages the rows of lse (times log2 e; +inf past S, so p = 0 there)
    // and delta
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(kvbar, C::kKBytes + C::kVBytes);
      for (int c = 0; c < C::kQCols; ++c)
        tma_load_4d(Ks + c * C::kKeys * 128, &kmap, kvbar, 64 * c, k0, g, b);
      for (int c = 0; c < C::kVCols; ++c)
        tma_load_4d(Vs + c * C::kKeys * 128, &vmap, kvbar, 64 * c, k0, g, b);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % NS, h = h0 + it / nt, q0 = (t0 + it % nt) * BQ;
        uint8_t* Qs = ring + s * C::kStageBytes;
        if (it >= NS) mbar_wait(&empty[s], (it / NS - 1) & 1);
        mbar_expect_tx(&full[s], C::kStageBytes);
        for (int c = 0; c < C::kQCols; ++c)
          tma_load_4d(Qs + c * BQ * 128, &qmap, &full[s], 64 * c, q0, h, b);
        for (int c = 0; c < C::kVCols; ++c)
          tma_load_4d(Qs + C::kQBytes + c * BQ * 128, &domap, &full[s],
                      64 * c, q0, h, b);
      }
    } else if (warp == 9) {
      for (int it = 0; it < n_it; ++it) {
        const int s = it % NS, h = h0 + it / nt, q0 = (t0 + it % nt) * BQ;
        float* r = rows + s * 2 * BQ;
        const long long at = ((long long)b * H + h) * Sq;
        if (it >= NS) mbar_wait(&empty[s], (it / NS - 1) & 1);
        for (int i = lane; i < BQ; i += 32) {
          const bool in = q0 + i < Sq;
          r[i] = in ? lse[at + q0 + i] * kLog2e : CUDART_INF_F;
          r[BQ + i] = in ? delta[at + q0 + i] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int wg = warp / 4;
  const int off = C::kSplit ? 0 : 64 * wg;  // the warpgroup's first key
  const uint32_t k_addr = smem_addr(Ks) + off * 128;
  const uint32_t v_addr = smem_addr(Vs) + off * 128;
  const long long out0 = (((long long)b * KV + g) * chunks + chunk) * Sk;
  float* const dkp = dk + out0 * DQK;
  float* const dvp = dv + out0 * DV;
  mbar_wait(kvbar, 0);
  if constexpr (C::kSplit) {
    if (wg == 0)
      dkv_consumer<DQK, DV, true, false>(ring, rows, full, empty, k_addr,
                                         v_addr, dkp, dvp, k0, t0, nt, n_it,
                                         Sk, qoff, causal, window, scale,
                                         scale_log2);
    else
      dkv_consumer<DQK, DV, false, true>(ring, rows, full, empty, k_addr,
                                         v_addr, dkp, dvp, k0, t0, nt, n_it,
                                         Sk, qoff, causal, window, scale,
                                         scale_log2);
  } else {
    dkv_consumer<DQK, DV, true, true>(ring, rows, full, empty, k_addr,
                                      v_addr, dkp, dvp, k0 + off, t0, nt,
                                      n_it, Sk, qoff, causal, window, scale,
                                      scale_log2);
  }
}

// dQ in bf16, q's strides: grid (H, query blocks, B)
template <int DQK, int DV>
__global__ void __launch_bounds__(Dq<DQK, DV>::kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap domap,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, Strides dqs,
                          int Sq, int Sk, int qoff, int rep, int causal,
                          int window, float scale, float scale_log2) {
  using namespace hopper;
  using C = Dq<DQK, DV>;
  constexpr int BQ = C::kBQ, BK = C::kBK, NS = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const Qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* const DOs = Qs + C::kQBytes;
  uint8_t* const KVs = DOs + C::kOBytes;   // stage s: K, then V
  uint64_t* const full_k = reinterpret_cast<uint64_t*>(
      KVs + NS * C::kStageBytes);
  uint64_t* const full_v = full_k + NS;
  uint64_t* const empty_k = full_v + NS;
  uint64_t* const empty_v = empty_k + NS;
  uint64_t* const qbar = empty_v + NS;

  const int h = blockIdx.x, b = blockIdx.z, g = h / rep, H = gridDim.x;
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
    // the producer warpgroup: one thread starts every TMA copy; a V tile
    // is free once dP is in, a K tile only after dQ += dS K
    if constexpr (C::kWGs == 2) setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * C::kWGs) {
      mbar_expect_tx(qbar, C::kQBytes + C::kOBytes);
      for (int c = 0; c < C::kQCols; ++c)
        tma_load_4d(Qs + c * BQ * 128, &qmap, qbar, 64 * c, q0, h, b);
      for (int c = 0; c < C::kVCols; ++c)
        tma_load_4d(DOs + c * BQ * 128, &domap, qbar, 64 * c, q0, h, b);
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
  // every pair of it is masked, p = 0)
  const int wg = warp / 4;
  const int wq0 = p0 + 64 * wg;
  const int r_in = 64 * wg + 16 * (warp % 4) + lane / 4;  // row in the block
  const int row0 = p0 + r_in;  // this thread's rows' positions: row0, + 8
  const int col = 2 * (lane % 4);       // its first column of each 8
  const uint32_t q_addr = smem_addr(Qs) + 64 * wg * 128;
  const uint32_t do_addr = smem_addr(DOs) + 64 * wg * 128;
  const uint32_t kv_addr = smem_addr(KVs);
  float l2[2], dl[2];                    // lse * log2 e (+inf past Sq), delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r_in + 8 * r;
    const long long at = ((long long)b * H + h) * Sq + row;
    l2[r] = row < Sq ? lse[at] * kLog2e : CUDART_INF_F;
    dl[r] = row < Sq ? delta[at] : 0.f;
  }
  float dqa[DQK / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) dqa[i] = 0.f;
  float sc[BK / 2], dp[BK / 2];          // S (then P), dP (then dS)
  uint32_t ab[BK / 4];                   // dS in bf16 pairs

  mbar_wait(qbar, 0);
  for (int t = 0; t < n_kb; ++t) {
    const int s = t % NS, k0 = (kb0 + t) * BK;
    const uint32_t parity = (t / NS) & 1;
    const uint32_t k_addr = kv_addr + s * C::kStageBytes;
    const uint32_t v_addr = k_addr + C::kKBytes;
    mbar_wait(&full_k[s], parity);
    fence_operands(sc);
    wgmma_fence();
    ss_kmajor<DQK, BK, BQ, BK>(sc, q_addr, k_addr);         // S = Q K^T
    wgmma_commit();
    mbar_wait(&full_v[s], parity);
    fence_operands(dp);
    wgmma_fence();
    ss_kmajor<DV, BK, BQ, BK>(dp, do_addr, v_addr);         // dP = dO V^T
    wgmma_commit();
    wgmma_wait<1>();                   // S is in
    fence_operands(sc);
    // P = exp2(S scale log2 e - lse log2 e); then, on the diagonal tile,
    // the ragged tail and the window's edge only (one test a tile), the
    // masked pairs set to 0: keys at or past S, and (causal) pairs whose
    // d = row - key is not in [0, window) ([0, INT_MAX) without a window;
    // one unsigned compare)
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      sc[i] = exp2f(fmaf(sc[i], scale_log2, -l2[(i >> 1) & 1]));
    if (k0 + BK > Sk || (causal && k0 + BK - 1 > wq0) ||
        (window > 0 && k0 <= wq0 + 63 - window)) {
      const unsigned span = window > 0 ? (unsigned)window : 0x7fffffffu;
      const int d0 = row0 - k0 - col;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * i + col + (e & 1);
          const int d = d0 + 8 * (e >> 1) - 8 * i - (e & 1);
          if (key >= Sk || (causal && (unsigned)d >= span)) sc[4 * i + e] = 0.f;
        }
    }
    wgmma_wait<0>();                   // dP is in: the V tile is free
    fence_operands(dp);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_v[s]);
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * i + e] = sc[4 * i + e] * (dp[4 * i + e] - dl[e >> 1]);
    pack_a<BK>(dp, ab);
    fence_operands(dqa);
    wgmma_fence();
    rs_mnmajor<DQK, BK, BK>(dqa, ab, k_addr);               // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dqa);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_k[s]);
  }

  // finish: dQ * scale in bf16 through this warpgroup's rows of the Q tile
  // (its last product has completed), in the same swizzled layout, then
  // out in 16-byte stores
#pragma unroll
  for (int i = 0; i < DQK / 8; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int R = r_in + 8 * r;
      *reinterpret_cast<uint32_t*>(
          Qs + (i / 8) * BQ * 128 + R * 128 + (((i % 8) ^ (R % 8)) << 4) +
          2 * col) = pack_bf16(scale * dqa[4 * i + 2 * r],
                               scale * dqa[4 * i + 2 * r + 1]);
    }
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  constexpr int kChunks = DQK / 8;      // 16-byte chunks in a row
  __nv_bfloat16* dqp = dq + b * dqs.b + h * dqs.h;
  for (int idx = threadIdx.x % 128; idx < 64 * kChunks; idx += 128) {
    const int R = 64 * wg + idx / kChunks, ch = idx % kChunks;
    if (q0 + R < Sq)
      *reinterpret_cast<uint4*>(dqp + (long long)(q0 + R) * dqs.s + 8 * ch) =
          *reinterpret_cast<const uint4*>(
              Qs + (ch / 8) * BQ * 128 + R * 128 + (((ch % 8) ^ (R % 8)) << 4));
  }
}

// the dK/dV partials' chunk count: one per query head for the FMA kernel;
// for the tensor-core kernel the fewest chunks of the group's H / KV heads
// (a divisor) that give at least kMinBlocks blocks
int dkv_chunks(int bf16, int B, int H, int KV, int S, int D, int Dv) {
  const int rep = H / KV;
  if (!bf16) return rep;
  const int keys = dkv_keys(D, Dv);
  if (!keys) return 0;
  const long long base = (long long)B * KV * ((S + keys - 1) / keys);
  for (int c = 1; c < rep; ++c)
    if (rep % c == 0 && base * c >= kMinBlocks) return c;
  return rep;
}

template <int DQK, int DV>
int launch_dkv_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     float* dk, float* dv, int B, int H, int KV, int Sq,
                     int Sk, int qoff, int causal, int window, int chunks,
                     float scale, Strides qs, Strides ks, Strides vs,
                     Strides dos, cudaStream_t st) {
  using C = Dkv<DQK, DV>;
  CUtensorMap qm, km, vm, dm;
  int err = make_map(&qm, q, DQK, Sq, H, B, qs, C::kBQ);
  if (!err) err = make_map(&km, k, DQK, Sk, KV, B, ks, C::kKeys);
  if (!err) err = make_map(&vm, v, DV, Sk, KV, B, vs, C::kKeys);
  if (!err) err = make_map(&dm, dout, DV, Sq, H, B, dos, C::kBQ);
  if (err) return err;
  err = (int)allow_smem<flash_bwd_dkv_wgmma_kernel<DQK, DV>>(C::kSmem);
  if (err) return err;
  dim3 grid(KV * chunks, (Sk + C::kKeys - 1) / C::kKeys, B);
  flash_bwd_dkv_wgmma_kernel<DQK, DV><<<grid, C::kThreads, C::kSmem, st>>>(
      qm, km, vm, dm, lse, delta, dk, dv, Sq, Sk, qoff, H, H / KV, chunks,
      causal, window, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int DQK, int DV>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dq, int B, int H, int KV, int Sq, int Sk, int qoff,
                    int causal, int window, float scale, Strides qs,
                    Strides ks, Strides vs, Strides dos, Strides dqs,
                    cudaStream_t st) {
  using C = Dq<DQK, DV>;
  CUtensorMap qm, km, vm, dm;
  int err = make_map(&qm, q, DQK, Sq, H, B, qs, C::kBQ);
  if (!err) err = make_map(&km, k, DQK, Sk, KV, B, ks, C::kBK);
  if (!err) err = make_map(&vm, v, DV, Sk, KV, B, vs, C::kBK);
  if (!err) err = make_map(&dm, dout, DV, Sq, H, B, dos, C::kBQ);
  if (err) return err;
  err = (int)allow_smem<flash_bwd_dq_wgmma_kernel<DQK, DV>>(C::kSmem);
  if (err) return err;
  dim3 grid(H, (Sq + C::kBQ - 1) / C::kBQ, B);
  flash_bwd_dq_wgmma_kernel<DQK, DV><<<grid, C::kThreads, C::kSmem, st>>>(
      qm, km, vm, dm, lse, delta, (__nv_bfloat16*)dq, dqs, Sq, Sk, qoff,
      H / KV, causal, window, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// Both entries: q (B, H, Sq, D), dout (B, H, Sq, Dv), k (B, KV, Sk, D) and
// v (B, KV, Sk, Dv), q's row i at position q_start + i (q_start >= 0,
// q_start + Sq <= Sk), fp32 (bf16 == 0, the FMA kernels) or bf16 (bf16 ==
// 1, the tensor-core kernels), each with its batch, head and sequence
// strides in elements and a dense last axis (for bf16 every base 16-byte
// aligned and every stride of an axis longer than 1 a multiple of 8); lse
// and delta dense fp32 (B, H, Sq); (D, Dv) in {(64, 64), (128, 128), (192,
// 192), (256, 256), (192, 128)}; H % KV == 0; window the sliding window W
// >= 1 (causal only) or 0 for none. Each launches on `stream` and returns
// a cudaError_t (cudaErrorInvalidValue for a head-dim pair or chunk count
// it has no instance for, a window without causal, or an offset or lengths
// out of range).

// the chunk count the dK/dV entry wants for these shapes (S: the keys, Sk;
// 0 for a head-dim pair with no instance)
extern "C" int flash_bwd_dkv_chunks(int bf16, int B, int H, int KV, int S,
                                    int D, int Dv) {
  if (KV <= 0 || H % KV != 0) return 0;
  return dkv_chunks(bf16, B, H, KV, S, D, Dv);
}

// dK and dV as fp32 partials dk (B, KV, chunks, Sk, D) and dv (B, KV,
// chunks, Sk, Dv), dense, chunk c summing query heads c * H / (KV chunks)
// and on of each group; `chunks` is flash_bwd_dkv_chunks' count.
extern "C" int flash_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int bf16, int B,
    int H, int KV, int Sq, int Sk, int q_start, int D, int Dv, int causal,
    int window, int chunks, float scale,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long d_sb, long long d_sh, long long d_ss,
    void* stream) {
  if (KV <= 0 || H % KV != 0 || window < 0 || (window > 0 && !causal) ||
      q_start < 0 || Sq < 0 || (long long)q_start + Sq > Sk)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || Sq <= 0) return (int)cudaSuccess;
  if (chunks != dkv_chunks(bf16, B, H, KV, Sk, D, Dv))
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, dos{d_sb, d_sh, d_ss};
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
  float* dkf = (float*)dk;
  float* dvf = (float*)dv;
#define DKV_LAUNCH(DQK, DV)                                                  \
  return bf16 ? launch_dkv_wgmma<DQK, DV>(q, k, v, dout, l, dl, dkf, dvf, B, \
                                          H, KV, Sq, Sk, q_start, causal,    \
                                          window, chunks, scale, qs, ks, vs, \
                                          dos, st)                           \
              : launch_dkv<float, DQK, DV>(q, k, v, dout, l, dl, dkf, dvf,   \
                                           B, H, KV, Sq, Sk, q_start,        \
                                           causal, window, scale, qs, ks,    \
                                           vs, dos, st)
  switch (pair(D, Dv)) {
    case pair(64, 64): DKV_LAUNCH(64, 64);
    case pair(128, 128): DKV_LAUNCH(128, 128);
    case pair(192, 192): DKV_LAUNCH(192, 192);
    case pair(256, 256): DKV_LAUNCH(256, 256);
    case pair(192, 128): DKV_LAUNCH(192, 128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DKV_LAUNCH
}

// dQ: dq (B, H, Sq, D) in the input type, with its own strides.
extern "C" int flash_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int bf16, int B, int H,
    int KV, int Sq, int Sk, int q_start, int D, int Dv, int causal,
    int window, float scale,
    long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long d_sb, long long d_sh, long long d_ss, long long o_sb,
    long long o_sh, long long o_ss, void* stream) {
  if (KV <= 0 || H % KV != 0 || window < 0 || (window > 0 && !causal) ||
      q_start < 0 || Sq < 0 || (long long)q_start + Sq > Sk)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || Sq <= 0) return (int)cudaSuccess;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, dos{d_sb, d_sh, d_ss}, dqs{o_sb, o_sh, o_ss};
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
#define DQ_LAUNCH(DQK, DV)                                                   \
  return bf16 ? launch_dq_wgmma<DQK, DV>(q, k, v, dout, l, dl, dq, B, H, KV, \
                                         Sq, Sk, q_start, causal, window,    \
                                         scale, qs, ks, vs, dos, dqs, st)    \
              : launch_dq<float, DQK, DV>(q, k, v, dout, l, dl, dq, B, H,    \
                                          KV, Sq, Sk, q_start, causal,       \
                                          window, scale, qs, ks, vs, dos,    \
                                          dqs, st)
  switch (pair(D, Dv)) {
    case pair(64, 64): DQ_LAUNCH(64, 64);
    case pair(128, 128): DQ_LAUNCH(128, 128);
    case pair(192, 192): DQ_LAUNCH(192, 192);
    case pair(256, 256): DQ_LAUNCH(256, 256);
    case pair(192, 128): DQ_LAUNCH(192, 128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DQ_LAUNCH
}

// dynamic shared memory of one block of the dK/dV (kernel == 0) or the dQ
// (kernel == 1) kernel for (bf16, D, Dv), in bytes (0 for a pair it has no
// instance for)
extern "C" int flash_bwd_smem_bytes(int kernel, int bf16, int D, int Dv) {
#define BWD_SMEM(DQK, DV)                                                    \
  return !bf16 ? smem_bytes<DQK, DV>()                                       \
               : kernel == 0 ? Dkv<DQK, DV>::kSmem : Dq<DQK, DV>::kSmem
  switch (pair(D, Dv)) {
    case pair(64, 64): BWD_SMEM(64, 64);
    case pair(128, 128): BWD_SMEM(128, 128);
    case pair(192, 192): BWD_SMEM(192, 192);
    case pair(256, 256): BWD_SMEM(256, 256);
    case pair(192, 128): BWD_SMEM(192, 128);
    default: return 0;
  }
#undef BWD_SMEM
}
