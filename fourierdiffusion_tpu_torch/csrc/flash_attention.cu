// Multi-head attention forward, softmax(Q K^T / sqrt(dh)) V over (B, H, L, dh)
// tensors, for the unfused score network on Hopper (sm_90a): the validation
// loss of training and the unfused sampler.
//
// Replaces the TPU kernels of fourierdiffusion_tpu/ops/flash_attention.py,
// forward of flash_attention:
//   _fwd_kernel (fp32, and bf16 with dh >= 16): S = (q k^T) * scale in fp32,
//     exact max-subtracted softmax, P rounded to the input type, O = P v with
//     fp32 accumulation, rounded to the input type;
//   _fast_fwd_kernel (bf16 with dh < 16): q pre-scaled by the wrapper and
//     rounded to bf16, S = q k^T in fp32 clamped to +-60, exp without the max
//     pass, approximate reciprocal of the row sum, P rounded to bf16, O = P v.
// The TPU kernels pad L to 128 lanes and mask keys at or past L; here there
// are exactly L keys, so nothing is masked.
//
// Bound: at the flagship's validation shape (B 64, H 12, L 100, dh 6) one
// call does 4 B H L^2 dh = 184 MFLOP against 4 x 1.8 MB of q, k, v, o in
// fp32, so operations bound it in fp32 (2.7 us at 67 TFLOP/s) and bytes in
// bf16 (1.1 us at 3.35 TB/s).
//
// Design: one CTA per (chain, head) stages the head's K and V in shared
// memory as fp32; each warp takes query rows in turn, keeps the row of
// scores in shared memory, reduces its max and sum with shuffles, and forms
// the dh outputs of the row as warp sums over the keys. Scores never reach
// device memory.

#include <cfloat>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDh = 64;
constexpr float kScoreClamp = 60.0f;
constexpr int kMaxSmem = 232448;

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

// kFast: the max-free bf16 form; q arrives pre-scaled and `scale` is unused.
template <typename T, bool kFast>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int L, int dh,
                     float scale) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                       // L x dh
  float* vs = ks + L * dh;                // L x dh
  float* rows = vs + L * dh;              // kWarps x L scores
  float* qs = rows + kWarps * L;          // kWarps x kMaxDh query rows
  const size_t base = (size_t)blockIdx.x * L * dh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int e = threadIdx.x; e < L * dh; e += blockDim.x) {
    ks[e] = to_f(k[base + e]);
    vs[e] = to_f(v[base + e]);
  }
  __syncthreads();
  float* srow = rows + warp * L;
  float* qr = qs + warp * kMaxDh;
  for (int i = warp; i < L; i += kWarps) {
    for (int d = lane; d < dh; d += 32) qr[d] = to_f(q[base + (size_t)i * dh + d]);
    __syncwarp();
    float m = -FLT_MAX;
    for (int j = lane; j < L; j += 32) {
      float s = 0.0f;
      for (int d = 0; d < dh; ++d) s = fmaf(qr[d], ks[j * dh + d], s);
      if (kFast) {
        s = fminf(fmaxf(s, -kScoreClamp), kScoreClamp);
      } else {
        s *= scale;
        m = fmaxf(m, s);
      }
      srow[j] = s;
    }
    if (!kFast) m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < L; j += 32) {
      const float e = kFast ? __expf(srow[j]) : expf(srow[j] - m);
      srow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    const float inv = kFast ? __fdividef(1.0f, sum) : 0.0f;
    for (int j = lane; j < L; j += 32)
      srow[j] = round_to<T>(kFast ? srow[j] * inv : srow[j] / sum);
    __syncwarp();
    for (int d = 0; d < dh; ++d) {
      float acc = 0.0f;
      for (int j = lane; j < L; j += 32) acc = fmaf(srow[j], vs[j * dh + d], acc);
      acc = warp_sum(acc);
      if (lane == 0) o[base + (size_t)i * dh + d] = from_f<T>(acc);
    }
    __syncwarp();
  }
}

template <typename T, bool kFast>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int L, int dh,
           float scale, cudaStream_t stream) {
  const int bytes = (2 * L * dh + kWarps * (L + kMaxDh)) * (int)sizeof(float);
  if (bytes > kMaxSmem || dh > kMaxDh) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<T, kFast>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  attention_fwd_kernel<T, kFast><<<BH, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), L, dh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// variant 0: fp32 exact; 1: bf16 exact (dh >= 16); 2: bf16 max-free (q
// pre-scaled). BH = B * H rows of (L, dh). Returns cudaGetLastError() after
// the launch (0 on success), or the error that stopped it before.
int fdiff_attention_fwd(int variant, const void* q, const void* k, const void* v, void* o,
                        int BH, int L, int dh, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (variant == 0) return launch<float, false>(q, k, v, o, BH, L, dh, scale, s);
  if (variant == 1) return launch<__nv_bfloat16, false>(q, k, v, o, BH, L, dh, scale, s);
  if (variant == 2) return launch<__nv_bfloat16, true>(q, k, v, o, BH, L, dh, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* fdiff_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
