// flash_attention_bwd: the backward of causal (or full) attention with an
// fp32 softmax, from the forward's output o and logsumexp rows lse:
//   p  = exp(q_hat . k - lse),  q_hat = q * D**-0.5  (0 where masked)
//   ds = p * (dO . v - delta),  delta = rowsum(dO * o)
//   dV = p^T dO,  dK = ds^T q_hat,  dQ = D**-0.5 * ds K
// fp32 or bf16 in, every operation in fp32. Query head h reads KV head
// g = h / (H / KV) (grouped-query heads; KV == H is the TPU kernel's
// contract).
//
// Replaces the two Pallas kernels of `flash_attention_bwd` in
// src/repro/kernels/flash_attention.py: `_bwd_dkv_kernel` (dK and dV, one
// kv block across the q blocks) and `_bwd_dq_kernel` (dQ, one q block
// across the kv blocks), the backward of `flash_attention_trainable`. On
// the port's path they are the attention backward of every layer of the
// training step (repro_torch/kernels/flash_attention.py). delta is computed
// by the wrapper, as JAX computes it outside its kernels.
//
// Bound on the H100: operations. The function needs five causal products
// (s, dV, dP, dK, dQ; B*H*S^2*D multiply-adds each); the two kernels, like
// the TPU's, recompute s and dP in both, seven in all, as fp32 FMAs on the
// CUDA cores (the TPU kernels' fp32 contract); tensor cores are later work.
//
// Design (simple first), both kernels with 256 threads (16 x 16) per block
// and 64-row tiles:
//   - flash_bwd_dkv_kernel: one block per (64-key tile, query head, batch
//     row); its K and V tiles stay in shared memory while it walks the q
//     tiles at and after its diagonal (all of them when not causal), the
//     longest walks launched first. Q (scaled) and dO pass in turn through
//     one shared tile. A thread owns a 4 x 4 tile of s / dP (query rows
//     4 ty + i, keys tx + 16 j) and a 4 x D/16 tile of dK and dV (keys
//     4 ty + i, float4 columns 4 tx + 64 j) in registers. p and then ds go
//     through one shared (64, 68) tile, read transposed for p^T dO and
//     ds^T q_hat. It writes fp32 partials per query head, (B, H, S, D):
//     the wrapper sums each group of H / KV heads in a fixed order, so dK
//     and dV are deterministic without float atomics;
//   - flash_bwd_dq_kernel: one block per (64-row q tile, query head, batch
//     row); its Q (scaled) and dO tiles stay in shared memory while it
//     walks the kv tiles up to its diagonal, the longest walks first. V
//     passes first (dP), then K (s, then dQ += ds K from the same tile).
//     dQ is scaled and rounded to the output type in the finish.
//   - p is recomputed from the lse, with masked pairs and the ragged tail
//     past S set to 0 (the TPU kernels mask the scores to -1e30, whose
//     exp is 0); rows past S load as zeros and are never written.
// Padded rows (+4 floats) keep the shared-memory reads free of bank
// conflicts. Shared memory is 3 (64, D + 4) tiles, the (64, 68) tile and
// two 64-float rows: 70 KB at D = 64, 119 KB at D = 128, 218 KB at D = 256,
// past the 48 KB static limit, so the launch sets
// cudaFuncAttributeMaxDynamicSharedMemorySize. No fast-math: expf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;           // rows of every tile (query and key)
constexpr int kThreads = 256;    // 16 x 16
constexpr int LP = kB + 4;       // padded row of the p / ds tile

struct Strides {                 // in elements; the last axis is dense
  long long b, h, s;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr int smem_bytes() {
  return (3 * kB * (D + 4) + kB * LP + 2 * kB) * 4;
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
// query or key at or past S, or (causal) the key after the query
__device__ __forceinline__ void probs(float (&s)[4][4], const float* L,
                                      int q0, int k0, int S, int causal,
                                      int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + tx + 16 * j;
      const bool live = qpos < S && kpos < S && (!causal || kpos <= qpos);
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, Strides qs, Strides ks,
                     Strides vs, Strides dos, int S, int rep, int causal,
                     float scale) {
  constexpr int LD = D + 4;
  constexpr int NJ = D / 64;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kB * LD;
  float* Xs = Vs + kB * LD;        // q_hat, then dO, then q_hat again
  float* Ps = Xs + kB * LD;        // p, then ds
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
  const long long row0 = ((long long)b * H + h) * S;

  load_tile<T, D>(Ks, kp, ks.s, k0, S, 1.f);
  load_tile<T, D>(Vs, vp, vs.s, k0, S, 1.f);

  float dka[4][4 * NJ], dva[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NJ; ++c) dka[i][c] = dva[i][c] = 0.f;

  const int nq = (S + kB - 1) / kB;
  for (int qb = causal ? kb : 0; qb < nq; ++qb) {
    const int q0 = qb * kB;
    __syncthreads();               // the last tile's reads are done
    load_tile<T, D>(Xs, qp, qs.s, q0, S, scale);
    for (int i = threadIdx.x; i < kB; i += kThreads) {
      const bool in = q0 + i < S;
      Lrow[i] = in ? lse[row0 + q0 + i] : 0.f;
      Drow[i] = in ? delta[row0 + q0 + i] : 0.f;
    }
    __syncthreads();

    float p[4][4], L[4];
    row_dots<D>(p, Xs, Ks, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) L[i] = Lrow[4 * ty + i];
    probs(p, L, q0, k0, S, causal, tx, ty);
    __syncthreads();               // every read of q_hat is done
    load_tile<T, D>(Xs, dop, dos.s, q0, S, 1.f);
    put_tile(Ps, p, tx, ty);
    __syncthreads();

    acc_product<D, true>(dva, Ps, Xs, tx, ty);       // dV += p^T dO
    float dpv[4][4];
    row_dots<D>(dpv, Xs, Vs, tx, ty);                // dP = dO V^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float dl = Drow[4 * ty + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] *= dpv[i][j] - dl;
    }
    __syncthreads();               // every read of p and dO is done
    put_tile(Ps, p, tx, ty);
    load_tile<T, D>(Xs, qp, qs.s, q0, S, scale);
    __syncthreads();
    acc_product<D, true>(dka, Ps, Xs, tx, ty);       // dK += ds^T q_hat
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + 4 * ty + i;
    if (row >= S) continue;
    float* krow = dk + (row0 + row) * D;
    float* vrow = dv + (row0 + row) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = 4 * tx + 64 * j;
      *reinterpret_cast<float4*>(krow + c) = make_float4(
          dka[i][4 * j], dka[i][4 * j + 1], dka[i][4 * j + 2],
          dka[i][4 * j + 3]);
      *reinterpret_cast<float4*>(vrow + c) = make_float4(
          dva[i][4 * j], dva[i][4 * j + 1], dva[i][4 * j + 2],
          dva[i][4 * j + 3]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Strides qs, Strides ks, Strides vs, Strides dos,
                    Strides dqs, int S, int rep, int causal, float scale) {
  constexpr int LD = D + 4;
  constexpr int NJ = D / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);     // q_hat
  float* DOs = Qs + kB * LD;                       // dO
  float* Xs = DOs + kB * LD;                       // V, then K
  float* Ps = Xs + kB * LD;                        // ds

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qb = gridDim.x - 1 - blockIdx.x;       // the longest walks first
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int g = h / rep;
  const int q0 = qb * kB;
  const T* kp = k + b * ks.b + g * ks.h;
  const T* vp = v + b * vs.b + g * vs.h;
  const long long row0 = ((long long)b * H + h) * S;

  load_tile<T, D>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, S, scale);
  load_tile<T, D>(DOs, dout + b * dos.b + h * dos.h, dos.s, q0, S, 1.f);
  float L[4], Dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    L[i] = row < S ? lse[row0 + row] : 0.f;
    Dl[i] = row < S ? delta[row0 + row] : 0.f;
  }

  float acc[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NJ; ++c) acc[i][c] = 0.f;

  const int n_all = (S + kB - 1) / kB;
  const int n_kb = causal ? min(n_all, qb + 1) : n_all;
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kB;
    __syncthreads();               // Qs, DOs written; the last K read done
    load_tile<T, D>(Xs, vp, vs.s, k0, S, 1.f);
    __syncthreads();
    float dpv[4][4];
    row_dots<D>(dpv, DOs, Xs, tx, ty);               // dP = dO V^T
    __syncthreads();               // every read of V is done
    load_tile<T, D>(Xs, kp, ks.s, k0, S, 1.f);
    __syncthreads();
    float p[4][4];
    row_dots<D>(p, Qs, Xs, tx, ty);                  // s = q_hat K^T
    probs(p, L, q0, k0, S, causal, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] *= dpv[i][j] - Dl[i];
    put_tile(Ps, p, tx, ty);
    __syncthreads();
    acc_product<D, false>(acc, Ps, Xs, tx, ty);      // dQ += ds K
  }

  T* dqp = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    T* out = dqp + (long long)row * dqs.s;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(out + 4 * tx + 64 * j + e, scale * acc[i][4 * j + e]);
  }
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, float* dk, float* dv,
               int B, int H, int KV, int S, int causal, float scale,
               Strides qs, Strides ks, Strides vs, Strides dos,
               cudaStream_t st) {
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kB - 1) / kB, H, B);
  kernel<<<grid, kThreads, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, dk,
      dv, qs, ks, vs, dos, S, H / KV, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int H,
              int KV, int S, int causal, float scale, Strides qs, Strides ks,
              Strides vs, Strides dos, Strides dqs, cudaStream_t st) {
  auto kernel = flash_bwd_dq_kernel<T, D>;
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kB - 1) / kB, H, B);
  kernel<<<grid, kThreads, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, qs, ks, vs, dos, dqs, S, H / KV, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dkv_d(int D, const void* q, const void* k, const void* v,
          const void* dout, const float* lse, const float* delta, float* dk,
          float* dv, int B, int H, int KV, int S, int causal, float scale,
          Strides qs, Strides ks, Strides vs, Strides dos, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, KV,
                               S, causal, scale, qs, ks, vs, dos, st);
    case 128:
      return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, KV,
                                S, causal, scale, qs, ks, vs, dos, st);
    case 256:
      return launch_dkv<T, 256>(q, k, v, dout, lse, delta, dk, dv, B, H, KV,
                                S, causal, scale, qs, ks, vs, dos, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dq_d(int D, const void* q, const void* k, const void* v,
         const void* dout, const float* lse, const float* delta, void* dq,
         int B, int H, int KV, int S, int causal, float scale, Strides qs,
         Strides ks, Strides vs, Strides dos, Strides dqs, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch_dq<T, 64>(q, k, v, dout, lse, delta, dq, B, H, KV, S,
                              causal, scale, qs, ks, vs, dos, dqs, st);
    case 128:
      return launch_dq<T, 128>(q, k, v, dout, lse, delta, dq, B, H, KV, S,
                               causal, scale, qs, ks, vs, dos, dqs, st);
    case 256:
      return launch_dq<T, 256>(q, k, v, dout, lse, delta, dq, B, H, KV, S,
                               causal, scale, qs, ks, vs, dos, dqs, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Both entries: q, dout (B, H, S, D) and k, v (B, KV, S, D), fp32 (bf16 ==
// 0) or bf16 (bf16 == 1), each with its batch, head and sequence strides in
// elements and a dense last axis; lse and delta dense fp32 (B, H, S); D in
// {64, 128, 256}; H % KV == 0. Each launches on `stream` and returns a
// cudaError_t (cudaErrorInvalidValue for a head dimension it has no
// instance for).
//
// dK and dV per query head: dk, dv dense fp32 (B, H, S, D).
extern "C" int flash_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int bf16, int B,
    int H, int KV, int S, int D, int causal, float scale, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long d_sb, long long d_sh, long long d_ss, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return (int)cudaSuccess;
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, dos{d_sb, d_sh, d_ss};
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
  if (bf16)
    return dkv_d<__nv_bfloat16>(D, q, k, v, dout, l, dl, (float*)dk,
                                (float*)dv, B, H, KV, S, causal, scale, qs,
                                ks, vs, dos, st);
  return dkv_d<float>(D, q, k, v, dout, l, dl, (float*)dk, (float*)dv, B, H,
                      KV, S, causal, scale, qs, ks, vs, dos, st);
}

// dQ: dq (B, H, S, D) in the input type, with its own strides.
extern "C" int flash_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int bf16, int B, int H,
    int KV, int S, int D, int causal, float scale, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long d_sb, long long d_sh, long long d_ss, long long o_sb,
    long long o_sh, long long o_ss, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return (int)cudaSuccess;
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, dos{d_sb, d_sh, d_ss}, dqs{o_sb, o_sh, o_ss};
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
  if (bf16)
    return dq_d<__nv_bfloat16>(D, q, k, v, dout, l, dl, dq, B, H, KV, S,
                               causal, scale, qs, ks, vs, dos, dqs, st);
  return dq_d<float>(D, q, k, v, dout, l, dl, dq, B, H, KV, S, causal, scale,
                     qs, ks, vs, dos, dqs, st);
}
