// The forward of one whole post-LN transformer encoder layer in one kernel
// launch, on Hopper (sm_90a). One kernel body serves two TPU kernels:
//
//   csrc/fused_encoder.cu        encoder_layer_kernel<T, false>, T = float or
//                                bf16: the sampling layer (B1)
//   csrc/fused_encoder_train.cu  encoder_layer_kernel<float, true>: the
//                                training forward with dropout (B3)
//
// Per chain b and per tile of kTM query rows it computes
//
//   qkv = x W_qkv + b_qkv              (q columns pre-scaled by 1/sqrt(dh))
//   per head: P = softmax(q k^T), O = (P * keep_attn) v
//   x1  = LN1(x + (O W_out + b_out) * keep_out)
//   y   = LN2(x1 + ((relu(x1 W1 + b1) * keep_ff) W2 + b2) * keep_ff2)
//
// where every keep factor is 1 without dropout (kDrop false).
//
// Numerics follow the TPU kernels: products take operands in the activation
// dtype and accumulate in fp32; results are rounded to the activation dtype
// after qkv, P, O, LN1, the ReLU and LN2; LayerNorm statistics are fp32 with
// eps 1e-5. fp32 uses the exact max-subtracted softmax; bf16 uses the
// max-free form (scores clamped to +-60, exp, approximate reciprocal of the
// row sum).
//
// Dropout masks: keep/(1-rate) from a murmur3 finalizer of the position,
// keyed by tag = seed + chain*131071 + site*7919 + extra*104729, exactly as
// the TPU kernel's interpret-mode _keep/_hash_bits (ops/flash_attention.py):
// positions are indexed in the TPU kernel's coordinates, (d, l) for the
// OUT/FF2 sites, (f, l) for FF, and (g, i, j) for ATTN with g the head's
// index inside its head group and extra = the group's first head. So the
// masks here, in the plain PyTorch version and in the JAX package's
// interpret mode are bit-identical. The backward (B4) regenerates them with
// the same functions.
//
// Layout: activations (B, L, D) row-major with exactly L valid rows (no
// padded keys, so nothing is masked). Weights are packed (in, out)
// row-major, so consecutive threads read consecutive output columns.
//
// Bound: at the flagship shape (D 72, F 2048, L 100) the layer does about
// 66 MFLOP per chain; the weights that every chain shares are 0.6 MB in
// bf16 (1.3 MB in fp32) and each chain's x 14-29 KB, so it is bound by
// operations, not bytes. This first version runs all products on the fp32
// CUDA cores (no wgmma, no TMA): one CTA per (row tile, chain) keeps its
// tile's activations, the chain's K and V and one chunk of the FFN hidden
// layer in shared memory, so device memory sees only x, the output and the
// (L2-resident) weights. Each thread computes kRM rows of one output
// column, reading four activations at a time as one float4 from shared
// memory, so an FMA costs a quarter of a shared load. d_ff is streamed in
// chunks of kFC columns.
//
// Long chains and wide layers (kKvGlobal): the chain's x and K|V take
// L*(3D+1) floats of shared memory, more than the 227 KB a CTA can have
// from L=225 at D=72 or L=107 at D=128. There a first launch
// (kv_proj_kernel, one CTA per row tile and chain) writes each chain's K|V
// once to a (B, L, 2D) fp32 workspace in device memory, with the same
// products and rounding, and the layer kernel reads K and V from there
// (through L1 and L2) instead of computing them; shared memory then holds
// only the tile's rows, one head's scores and the FFN chunk. Where the
// shared-memory plan fits, it is the one used.

#pragma once

#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fdiff {

constexpr int kThreads = 288;   // 9 warps; FFN2 at D=72 is 288 items
constexpr int kTM = 32;         // query rows per CTA
constexpr int kRM = 8;          // rows per thread in the products
constexpr int kFC = 288;        // d_ff chunk width
constexpr float kLnEps = 1e-5f;
constexpr float kScoreClamp = 60.0f;
constexpr int kMaxSmem = 232448;  // 227 KB opt-in limit on sm_90
constexpr uint32_t kC0 = 1000003u;
constexpr uint32_t kC1 = 19349663u;
constexpr int kSiteAttn = 0, kSiteOut = 1, kSiteFf = 2, kSiteFf2 = 3;

// Matrices in the activation dtype T, vectors in fp32; the packed order.
template <typename T>
struct Weights {
  const T* w_qkv; const float* b_qkv; const T* w_out; const float* b_out;
  const float* ln1_s; const float* ln1_b; const T* w1; const float* b1;
  const T* w2; const float* b2; const float* ln2_s; const float* ln2_b;
};

// The 12 packed tensors as the C interfaces pass them: an array of pointers
// in the order w_qkv, b_qkv, w_out, b_out, ln1_s, ln1_b, w1, b1, w2, b2,
// ln2_s, ln2_b.
template <typename T>
inline Weights<T> weights_of(const void* const* w) {
  auto m = [&](int i) { return static_cast<const T*>(w[i]); };
  auto v = [&](int i) { return static_cast<const float*>(w[i]); };
  return Weights<T>{m(0), v(1), m(2), v(3), v(4), v(5), m(6), v(7), m(8), v(9), v(10), v(11)};
}

struct Dropout {
  uint32_t seed;   // the layer's int32 seed, as unsigned
  uint32_t thr;    // keep where bits < thr: int((1 - rate) * (2**32 - 1))
  float scale;     // 1 / (1 - rate)
  int group;       // heads per attention head group
};

// ---- dropout masks ----------------------------------------------------------

__device__ __forceinline__ uint32_t hash_bits(uint32_t idx, uint32_t key) {
  uint32_t x = idx ^ key;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__device__ __forceinline__ uint32_t mask_key(const Dropout& dp, int chain, int site,
                                             int extra) {
  return dp.seed + (uint32_t)chain * 131071u + (uint32_t)site * 7919u +
         (uint32_t)extra * 104729u;
}

__device__ __forceinline__ uint32_t attn_key(const Dropout& dp, int chain, int h) {
  return mask_key(dp, chain, kSiteAttn, h - h % dp.group);
}

// Site of shape (rows, Lp) in the TPU kernel: position (r, l). 1 without dropout.
template <bool kDrop = true>
__device__ __forceinline__ float keep2(const Dropout& dp, uint32_t key, int r, int l) {
  if constexpr (!kDrop) {
    return 1.0f;
  } else {
    const uint32_t idx = (uint32_t)r * kC0 * kC1 + (uint32_t)l;
    return hash_bits(idx, key) < dp.thr ? dp.scale : 0.0f;
  }
}

// ATTN site of shape (group, Lp, Lp): position (g, i, j). 1 without dropout.
template <bool kDrop = true>
__device__ __forceinline__ float keep3(const Dropout& dp, uint32_t key, int g, int i,
                                       int j) {
  if constexpr (!kDrop) {
    return 1.0f;
  } else {
    const uint32_t idx = (((uint32_t)g * kC0) * kC1 + (uint32_t)i) * kC1 + (uint32_t)j;
    return hash_bits(idx, key) < dp.thr ? dp.scale : 0.0f;
  }
}

// ---- small helpers ------------------------------------------------------------

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// C[r, n] = epi(r, n, sum_k A[r, k] * B[k, n]) for r < M, n < N.
// A: fp32 in shared memory, row stride lda (multiple of 4), readable for
// rows up to round_up(M, kRM). B: global (in, out) weights, row stride ldb.
// K is a multiple of 4.
template <typename W, typename Epi>
__device__ __forceinline__ void matmul(const float* __restrict__ A, int lda, int M,
                                       const W* __restrict__ B, int ldb, int N, int K,
                                       Epi epi) {
  const int groups = (M + kRM - 1) / kRM;
  for (int item = threadIdx.x; item < groups * N; item += blockDim.x) {
    const int n = item % N;
    const int r0 = (item / N) * kRM;
    float acc[kRM];
#pragma unroll
    for (int i = 0; i < kRM; ++i) acc[i] = 0.0f;
    const W* b = B + n;
    for (int k = 0; k < K; k += 4) {
      const float w0 = to_f(__ldg(b + (k + 0) * ldb));
      const float w1 = to_f(__ldg(b + (k + 1) * ldb));
      const float w2 = to_f(__ldg(b + (k + 2) * ldb));
      const float w3 = to_f(__ldg(b + (k + 3) * ldb));
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(A + (r0 + i) * lda + k);
        acc[i] = fmaf(a.x, w0, acc[i]);
        acc[i] = fmaf(a.y, w1, acc[i]);
        acc[i] = fmaf(a.z, w2, acc[i]);
        acc[i] = fmaf(a.w, w3, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRM; ++i)
      if (r0 + i < M) epi(r0 + i, n, acc[i]);
  }
}

// In-place LayerNorm of `rows` rows of width D (row stride D), one warp
// per row, fp32 statistics, result rounded to T.
template <typename T>
__device__ __forceinline__ void layer_norm_rows(float* x, int rows, int D,
                                                const float* __restrict__ scale,
                                                const float* __restrict__ bias) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += blockDim.x / 32) {
    float* row = x + r * D;
    float s = 0.0f;
    for (int c = lane; c < D; c += 32) s += row[c];
    const float mean = warp_sum(s) / D;
    float v = 0.0f;
    for (int c = lane; c < D; c += 32) {
      const float d = row[c] - mean;
      v += d * d;
    }
    const float inv = rsqrtf(warp_sum(v) / D + kLnEps);
    for (int c = lane; c < D; c += 32)
      row[c] = round_to<T>((row[c] - mean) * inv * scale[c] + bias[c]);
  }
}

// Shared-memory plan, in floats. K and V rows have an odd stride (2D + 1)
// so that the score loop, whose neighbouring threads read neighbouring
// keys, does not hit one bank. Without kv_in_smem, K|V and the whole-chain
// x are not in shared memory (kKvGlobal).
struct Smem {
  int lp8, region, kvs;
  int off_kv, off_xs, off_q, off_o, off_x1, total;
  __host__ __device__ Smem(int L, int D, bool kv_in_smem = true) {
    lp8 = (L + kRM - 1) / kRM * kRM;
    int r = kv_in_smem ? lp8 * D : 0;    // whole-chain x
    if (kTM * L > r) r = kTM * L;        // one head's scores
    if (kTM * kFC > r) r = kTM * kFC;    // one FFN hidden chunk
    region = r;
    kvs = 2 * D + 1;
    off_kv = region;                     // K | V, L x kvs
    off_xs = kv_in_smem ? (off_kv + L * kvs + 3) / 4 * 4 : region;  // own rows of x
    off_q = off_xs + kTM * D;            // q, later the FFN2 sum
    off_o = off_q + kTM * D;             // attention output
    off_x1 = off_o + kTM * D;            // pre-LN1, then x1
    total = off_x1 + kTM * D;
  }
};

// The weights come as separate __restrict__ pointer parameters, not as a
// Weights struct: with the struct, ptxas allocated registers differently and
// the sampling kernel ran measurably slower on an H100. kv_ws is the
// (B, L, 2D) K|V workspace of kKvGlobal, unused otherwise.
template <typename T, bool kDrop, bool kKvGlobal>
__global__ void __launch_bounds__(kThreads)
encoder_layer_kernel(const T* __restrict__ x,
                     const T* __restrict__ w_qkv, const float* __restrict__ b_qkv,
                     const T* __restrict__ w_out, const float* __restrict__ b_out,
                     const float* __restrict__ ln1_s, const float* __restrict__ ln1_b,
                     const T* __restrict__ w1, const float* __restrict__ b1,
                     const T* __restrict__ w2, const float* __restrict__ b2,
                     const float* __restrict__ ln2_s, const float* __restrict__ ln2_b,
                     T* __restrict__ out, int L, int D, int H, int F, Dropout dp,
                     float* kv_ws) {
  constexpr bool kFast = sizeof(T) == 2;
  extern __shared__ __align__(16) float smem[];
  const Smem lay(L, D, !kKvGlobal);
  float* xall = smem;                // phase 1-2
  float* ph = smem;                  // scores (phase 3), hidden chunk (phase 5)
  float* kv = kKvGlobal ? kv_ws + (size_t)blockIdx.y * L * 2 * D : smem + lay.off_kv;
  float* xs = smem + lay.off_xs;
  float* q = smem + lay.off_q;
  float* fsum = q;                   // q is dead once the scores exist
  float* o = smem + lay.off_o;
  float* x1 = smem + lay.off_x1;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, n_warps = blockDim.x / 32;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kTM;
  const int rows = min(kTM, L - row0);
  const int dh = D / H;
  const int kvs = kKvGlobal ? 2 * D : lay.kvs;
  const T* xb = x + (size_t)b * L * D;
  const uint32_t key_out = mask_key(dp, b, kSiteOut, 0);
  const uint32_t key_ff = mask_key(dp, b, kSiteFf, 0);
  const uint32_t key_ff2 = mask_key(dp, b, kSiteFf2, 0);

  // Phase 1: zero shared memory (padding rows stay finite), load x.
  for (int i = tid; i < lay.total; i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();
  if constexpr (!kKvGlobal)
    for (int i = tid; i < L * D; i += blockDim.x) xall[i] = to_f(xb[i]);
  for (int i = tid; i < rows * D; i += blockDim.x) xs[i] = to_f(xb[row0 * D + i]);
  __syncthreads();

  // Phase 2: K, V for every row of the chain (kKvGlobal: read from kv_ws,
  // written by kv_proj_kernel); q for this tile's rows.
  if constexpr (!kKvGlobal)
    matmul(xall, D, L, w_qkv + D, 3 * D, 2 * D, D, [&](int r, int n, float acc) {
      kv[r * kvs + n] = round_to<T>(acc + b_qkv[D + n]);
    });
  matmul(xs, D, rows, w_qkv, 3 * D, D, D, [&](int r, int n, float acc) {
    q[r * D + n] = round_to<T>(acc + b_qkv[n]);
  });
  __syncthreads();

  // Phase 3: attention, one head at a time.
  for (int h = 0; h < H; ++h) {
    const int c0 = h * dh;
    const uint32_t key_attn = attn_key(dp, b, h);
    const int g = h % dp.group;
    for (int item = tid; item < rows * L; item += blockDim.x) {
      const int i = item / L, j = item % L;
      const float* qi = q + i * D + c0;
      const float* kj = kv + j * kvs + c0;
      float s = 0.0f;
      for (int d = 0; d < dh; ++d) s = fmaf(qi[d], kj[d], s);
      ph[i * L + j] = s;
    }
    __syncthreads();
    for (int i = warp; i < rows; i += n_warps) {
      float* srow = ph + i * L;
      if (kFast) {
        float sum = 0.0f;
        for (int j = lane; j < L; j += 32) {
          const float e = __expf(fminf(fmaxf(srow[j], -kScoreClamp), kScoreClamp));
          srow[j] = e;
          sum += e;
        }
        const float inv = __fdividef(1.0f, warp_sum(sum));
        for (int j = lane; j < L; j += 32)
          srow[j] = round_to<T>(srow[j] * inv) * keep3<kDrop>(dp, key_attn, g, row0 + i, j);
      } else {
        float m = -FLT_MAX;
        for (int j = lane; j < L; j += 32) m = fmaxf(m, srow[j]);
        m = warp_max(m);
        float sum = 0.0f;
        for (int j = lane; j < L; j += 32) {
          const float e = expf(srow[j] - m);
          srow[j] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        for (int j = lane; j < L; j += 32)
          srow[j] = round_to<T>(srow[j] / sum) * keep3<kDrop>(dp, key_attn, g, row0 + i, j);
      }
    }
    __syncthreads();
    for (int item = tid; item < rows * dh; item += blockDim.x) {
      const int i = item / dh, d = item % dh;
      const float* pi = ph + i * L;
      const float* vj = kv + D + c0 + d;
      float acc = 0.0f;
      for (int j = 0; j < L; ++j) acc = fmaf(pi[j], vj[j * kvs], acc);
      o[i * D + c0 + d] = round_to<T>(acc);
    }
    __syncthreads();
  }

  // Phase 4: out projection, dropout, residual, LN1.
  matmul(o, D, rows, w_out, D, D, D, [&](int r, int n, float acc) {
    x1[r * D + n] =
        xs[r * D + n] + (acc + b_out[n]) * keep2<kDrop>(dp, key_out, n, row0 + r);
  });
  for (int i = tid; i < kTM * D; i += blockDim.x) fsum[i] = 0.0f;
  __syncthreads();
  layer_norm_rows<T>(x1, rows, D, ln1_s, ln1_b);
  __syncthreads();

  // Phase 5: FFN with hidden dropout, d_ff streamed in chunks of kFC.
  for (int c = 0; c < F; c += kFC) {
    const int fc = min(kFC, F - c);
    matmul(x1, D, rows, w1 + c, F, fc, D, [&](int r, int n, float acc) {
      ph[r * kFC + n] = round_to<T>(fmaxf(acc + b1[c + n], 0.0f)) *
                        keep2<kDrop>(dp, key_ff, c + n, row0 + r);
    });
    __syncthreads();
    matmul(ph, kFC, rows, w2 + (size_t)c * D, D, D, fc, [&](int r, int n, float acc) {
      fsum[r * D + n] += acc;
    });
    __syncthreads();
  }

  // Phase 6: output dropout, residual, LN2, store.
  for (int i = tid; i < rows * D; i += blockDim.x) {
    const int r = i / D, n = i % D;
    x1[i] = x1[i] + (fsum[i] + b2[n]) * keep2<kDrop>(dp, key_ff2, n, row0 + r);
  }
  __syncthreads();
  layer_norm_rows<T>(x1, rows, D, ln2_s, ln2_b);
  __syncthreads();
  T* ob = out + ((size_t)b * L + row0) * D;
  for (int i = tid; i < rows * D; i += blockDim.x) ob[i] = from_f<T>(x1[i]);
}

// kKvGlobal's first launch: K|V of this tile's rows of chain b, the same
// products and rounding as phase 2, into kv_ws (B, L, 2D). Each (tile,
// chain) writes its own rows, so no two CTAs write one element.
template <typename T>
__global__ void __launch_bounds__(kThreads)
kv_proj_kernel(const T* __restrict__ x, const T* __restrict__ w_qkv,
               const float* __restrict__ b_qkv, float* __restrict__ kv_ws, int L, int D) {
  extern __shared__ __align__(16) float smem[];  // kTM x D rows of x
  const int b = blockIdx.y, row0 = blockIdx.x * kTM;
  const int rows = min(kTM, L - row0);
  const T* xb = x + ((size_t)b * L + row0) * D;
  for (int i = threadIdx.x; i < kTM * D; i += blockDim.x)
    smem[i] = i < rows * D ? to_f(xb[i]) : 0.0f;
  __syncthreads();
  float* kv = kv_ws + ((size_t)b * L + row0) * 2 * D;
  matmul(smem, D, rows, w_qkv + D, 3 * D, 2 * D, D, [&](int r, int n, float acc) {
    kv[r * 2 * D + n] = round_to<T>(acc + b_qkv[D + n]);
  });
}

// Whether the chain's K|V fit in shared memory at sequence length L and
// width D (else the layer runs kKvGlobal).
inline bool encoder_layer_kv_in_smem(int L, int D) {
  return Smem(L, D, true).total * (int)sizeof(float) <= kMaxSmem;
}

// Shared-memory bytes one CTA of the layer kernel needs at L and D, in the
// plan the launcher takes.
inline int encoder_layer_smem_bytes(int L, int D) {
  return Smem(L, D, encoder_layer_kv_in_smem(L, D)).total * (int)sizeof(float);
}

// Floats of one chain's K|V workspace: 0 where K|V fit in shared memory.
inline int encoder_layer_kv_floats(int L, int D) {
  return encoder_layer_kv_in_smem(L, D) ? 0 : L * 2 * D;
}

// Launches the layer over B chains; returns cudaGetLastError() after the
// launch (0 on success), or the error that stopped it before. kv_ws holds
// encoder_layer_kv_floats(L, D) floats per chain (may be null when that is 0).
template <typename T, bool kDrop>
int launch_encoder_layer(const void* x, const Weights<T>& w, void* out, void* kv_ws, int B,
                         int L, int D, int H, int F, const Dropout& dp,
                         cudaStream_t stream) {
  const int bytes = encoder_layer_smem_bytes(L, D);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  const dim3 grid((L + kTM - 1) / kTM, B);
  float* kv = static_cast<float*>(kv_ws);
  cudaError_t err;
  if (encoder_layer_kv_in_smem(L, D)) {
    err = cudaFuncSetAttribute(encoder_layer_kernel<T, kDrop, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    encoder_layer_kernel<T, kDrop, false><<<grid, kThreads, bytes, stream>>>(
        static_cast<const T*>(x), w.w_qkv, w.b_qkv, w.w_out, w.b_out, w.ln1_s, w.ln1_b,
        w.w1, w.b1, w.w2, w.b2, w.ln2_s, w.ln2_b, static_cast<T*>(out), L, D, H, F, dp, kv);
    return (int)cudaGetLastError();
  }
  if (kv == nullptr) return (int)cudaErrorInvalidValue;
  const int kv_bytes = kTM * D * (int)sizeof(float);
  if (kv_bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kv_proj_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_bytes);
  if (err != cudaSuccess) return (int)err;
  kv_proj_kernel<T><<<grid, kThreads, kv_bytes, stream>>>(static_cast<const T*>(x), w.w_qkv,
                                                          w.b_qkv, kv, L, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(encoder_layer_kernel<T, kDrop, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  encoder_layer_kernel<T, kDrop, true><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), w.w_qkv, w.b_qkv, w.w_out, w.b_out, w.ln1_s, w.ln1_b, w.w1,
      w.b1, w.w2, w.b2, w.ln2_s, w.ln2_b, static_cast<T*>(out), L, D, H, F, dp, kv);
  return (int)cudaGetLastError();
}

}  // namespace fdiff
