// Helpers of the port's encoder-layer kernels on Hopper (sm_90a), shared by
//
//   csrc/encoder_layer_tc.cuh    B1 (sampling), B3 and B4's recompute (training):
//                                the weights' layout, the dropout mask hash,
//                                the rounding helpers and warp sums;
//   csrc/fused_encoder_int8.cu   B7 and B8 (int8 sampling): those, and the
//                                CUDA-core product matmul, layer_norm_rows and
//                                kv_proj_kernel (K|V to a device workspace where
//                                a chain's K|V do not fit in shared memory);
//   csrc/flash_attention.cu      B2, B5, B6: the mask hash and rounding helpers.
//
// Dropout masks: keep/(1-rate) from a murmur3 finalizer of the position,
// keyed by tag = seed + chain*131071 + site*7919 + extra*104729, exactly as
// the TPU kernel's interpret-mode _keep/_hash_bits (ops/flash_attention.py):
// positions are indexed in the TPU kernel's coordinates, (d, l) for the
// OUT/FF2 sites, (f, l) for FF, and (g, i, j) for ATTN with g the head's
// index inside its head group and extra = the group's first head. So the
// masks of the kernels, of the plain PyTorch versions and of the JAX package
// in interpret mode are bit-identical; B4 regenerates them with the same
// functions.
//
// Layout: activations (B, L, D) row-major with exactly L valid rows (no
// padded keys, so nothing is masked). Weights are packed (in, out)
// row-major, so consecutive threads read consecutive output columns.

#pragma once

#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fdiff {

constexpr int kThreads = 288;   // 9 warps; FFN2 at D=72 is 288 items
constexpr int kTM = 32;         // query rows per CTA
constexpr int kRM = 8;          // rows per thread in the products
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

// K|V of this tile's rows of chain b, computed with matmul and rounded to T,
// into kv_ws (B, L, 2D), for a layer whose chain's K|V do not fit in shared
// memory. Each (tile, chain) writes its own rows, so no two CTAs write one
// element.
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

}  // namespace fdiff
