// flash_attention: attention forward with an online softmax, causal or
// full, fp32 or bf16 in and out, every operation in fp32:
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, g, j]) v[b, g, j]
// over j <= i when causal, with g = h / (H / KV) (grouped-query heads;
// KV == H is the TPU kernel's contract) and scale = D**-0.5 applied to q
// before the product.
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
// every layer. Without it the kernel is the prefill's, unchanged.
//
// Bound on the H100: operations. The causal product is 2*B*H*S^2*D flops;
// the function reads q, k, v once and writes o once, so from S of a few
// hundred on it does far more arithmetic than the card can feed from
// memory. This kernel does that arithmetic on the CUDA cores in fp32, as
// the TPU kernel's contract asks (the scale before the product, an fp32
// running max, denominator and accumulator), and so sits far above the bf16
// tensor-core bound; mma/wgmma with TMA pipelining are later work.
//
// Design (simple first):
//   - one block of 256 threads per (64-row query block, query head, batch
//     row); the query blocks with the most key blocks are launched first;
//   - the scaled query tile stays in shared memory as fp32; key and value
//     tiles of 64 rows pass in turn through one shared fp32 tile, so that
//     two blocks fit on an SM at D = 128;
//   - each thread owns 4 query rows: a 4 x 4 tile of the scores
//     (columns tx + 16 j) and a 4 x D/16 tile of the accumulator (float4
//     columns 4 tx + 64 j), with that rows' running max and denominator
//     in registers, kept the same in the 16 threads of a row through
//     shuffles;
//   - causal key blocks in a query block's future are never loaded (the TPU
//     kernel's `@pl.when`); the diagonal block, and the ragged tail past S
//     in place of the TPU wrapper's padding, are masked with -1e30;
//   - the finish divides by max(l, 1e-30) and rounds to the output type
//     (__float2bfloat16_rn for bf16), as the TPU kernel's `_done` does,
//     and with LSE the first thread of each row writes the row's lse, as
//     `_kernel_lse`'s `_emit` does.
// Padded rows (+4 floats) keep the shared-memory reads free of bank
// conflicts. No fast-math: expf and IEEE division.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // key rows per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr float kNeg = -1e30f;

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
  return (kBQ * (D + 4) + kBK * (D + 4) + kBQ * (kBK + 4)) * 4;
}

static_assert(kBQ == kBK, "load_tile loads the Q and K/V tiles alike");

// rows [r0, r0 + 64) of one head of x into a (64, D + 4) fp32 tile, times
// `mul`; rows at or past S are zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* tile, const T* x,
                                          long long stride_s, int r0, int S,
                                          float mul) {
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float val = 0.f;
    if (r0 + r < S) val = to_f32(x[(long long)(r0 + r) * stride_s + d]) * mul;
    tile[r * (D + 4) + d] = val;
  }
}

template <typename T, int D, bool LSE>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 2 : 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, Strides qs, Strides ks,
                       Strides vs, Strides os, int S,
                       int rep, int causal, float scale) {
  constexpr int LD = D + 4;        // padded row of the Q and K/V tiles
  constexpr int LP = kBK + 4;      // padded row of the P tile
  constexpr int NJ = D / 64;       // float4 column groups of O per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KVs = Qs + kBQ * LD;
  float* Ps = KVs + kBK * LD;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / rep;
  const int q0 = qb * kBQ;
  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + g * ks.h;
  const T* vp = v + b * vs.b + g * vs.h;
  T* op = o + b * os.b + h * os.h;

  load_tile<T, D>(Qs, qp, qs.s, q0, S, scale);

  float m[4], l[4], acc[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NJ; ++c) acc[i][c] = 0.f;
  }

  const int n_all = (S + kBK - 1) / kBK;
  const int n_kb = causal ? min(n_all, (q0 + kBQ - 1) / kBK + 1) : n_all;
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();               // Qs is written; KVs and Ps are free
    load_tile<T, D>(KVs, kp, ks.s, k0, S, 1.f);
    __syncthreads();

    // scores of rows 4 ty + i against keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
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
      const int qpos = q0 + 4 * ty + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= S || (causal && kpos > qpos)) s[i][j] = kNeg;
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
    load_tile<T, D>(KVs, vp, vs.s, k0, S, 1.f);
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
            *reinterpret_cast<const float4*>(&KVs[c * LD + 4 * tx + 64 * j]);
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if (LSE && tx == 0)
      lse[((long long)b * gridDim.y + h) * S + row] = m[i] + logf(den);
    T* orow = op + (long long)row * os.s;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(orow + 4 * tx + 64 * j + e, acc[i][4 * j + e] / den);
  }
}

template <typename T, int D, bool LSE>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int KV, int S, int causal, float scale, Strides qs,
           Strides ks, Strides vs, Strides os, cudaStream_t st) {
  auto kernel = flash_attention_kernel<T, D, LSE>;
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, qs, ks, vs, os, S,
      H / KV, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool LSE>
int launch_d(const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int H, int KV, int S, int D, int causal,
             float scale, Strides qs, Strides ks, Strides vs, Strides os,
             cudaStream_t st) {
  switch (D) {
    case 64:
      return launch<T, 64, LSE>(q, k, v, o, lse, B, H, KV, S, causal, scale,
                                qs, ks, vs, os, st);
    case 128:
      return launch<T, 128, LSE>(q, k, v, o, lse, B, H, KV, S, causal,
                                 scale, qs, ks, vs, os, st);
    case 256:
      return launch<T, 256, LSE>(q, k, v, o, lse, B, H, KV, S, causal,
                                 scale, qs, ks, vs, os, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int H, int KV, int S, int D, int causal,
             float scale, Strides qs, Strides ks, Strides vs, Strides os,
             cudaStream_t st) {
  if (lse)
    return launch_d<T, true>(q, k, v, o, lse, B, H, KV, S, D, causal, scale,
                             qs, ks, vs, os, st);
  return launch_d<T, false>(q, k, v, o, lse, B, H, KV, S, D, causal, scale,
                            qs, ks, vs, os, st);
}

}  // namespace

// q, o: (B, H, S, D); k, v: (B, KV, S, D); fp32 (bf16 == 0) or bf16
// (bf16 == 1); D in {64, 128, 256}; H % KV == 0; each tensor's batch, head
// and sequence strides in elements, its last axis dense. lse: null (the
// forward alone, kernel 4) or a dense fp32 (B, H, S) array for the rows'
// logsumexp (kernel 5). Launches on `stream` and returns a cudaError_t
// (cudaErrorInvalidValue for a head dimension it has no instance for).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int bf16, int B, int H, int KV, int S, int D, int causal, float scale,
    long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return (int)cudaSuccess;
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t st = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (bf16)
    return launch_t<__nv_bfloat16>(q, k, v, o, l, B, H, KV, S, D, causal,
                                   scale, qs, ks, vs, os, st);
  return launch_t<float>(q, k, v, o, l, B, H, KV, S, D, causal, scale, qs,
                         ks, vs, os, st);
}
