// One whole post-LN transformer encoder layer in one kernel launch, for
// the reverse-diffusion sampling path on Hopper (sm_90a).
//
// Replaces the TPU kernel fourierdiffusion_tpu/ops/fused_encoder.py::
// _encoder_layer_kernel (fp32 and bf16; the int8 variants are not ported).
// Per chain b and per tile of TM query rows it computes
//
//   qkv = x W_qkv + b_qkv              (q columns pre-scaled by 1/sqrt(dh))
//   per head: S = q k^T, P = softmax(S), O = P v
//   x1  = LN1(x + (O W_out + b_out))
//   out = LN2(x1 + (relu(x1 W1 + b1) W2 + b2))
//
// Numerics follow the TPU kernel: products take operands in the activation
// dtype and accumulate in fp32; results are rounded to the activation
// dtype after qkv, P, O, LN1, the ReLU and LN2; LayerNorm statistics are
// fp32 with eps 1e-5. fp32 uses the exact max-subtracted softmax; bf16
// uses the max-free form (scores clamped to +-60, exp, approximate
// reciprocal of the row sum).
//
// Layout: activations (B, L, D) row-major with exactly L valid rows (no
// padded keys, so nothing is masked). Weights are packed by
// ops/fused_encoder.py::pack_encoder_layer as (in, out) row-major, so
// consecutive threads read consecutive output columns.
//
// Bound: at the flagship shape (D 72, F 2048, L 100) the layer does about
// 66 MFLOP per chain; the weights that every chain shares are 0.6 MB in
// bf16 (1.3 MB in fp32) and each chain's x is 14 KB, so it is bound by
// operations, not bytes. This first version runs all products on the fp32
// CUDA cores (no wgmma, no TMA): one CTA per (row tile, chain) keeps its
// tile's activations, the chain's K and V and one chunk of the FFN hidden
// layer in shared memory, so device memory sees only x, the output and the
// (L2-resident) weights. Each thread computes RM rows of one output column,
// reading four activations at a time as one float4 from shared memory, so
// an FMA costs a quarter of a shared load. d_ff is streamed in chunks of FC
// columns. Nothing goes to device-memory scratch.

#include <cfloat>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 288;   // 9 warps; FFN2 at D=72 is 288 items
constexpr int kTM = 32;         // query rows per CTA
constexpr int kRM = 8;          // rows per thread in the products
constexpr int kFC = 288;        // d_ff chunk width
constexpr float kLnEps = 1e-5f;
constexpr float kScoreClamp = 60.0f;
constexpr int kMaxSmem = 232448;  // 227 KB opt-in limit on sm_90

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
// keys, does not hit one bank.
struct Smem {
  int lp8, region, kvs;
  int off_kv, off_xs, off_q, off_o, off_x1, total;
  __host__ __device__ Smem(int L, int D) {
    lp8 = (L + kRM - 1) / kRM * kRM;
    int r = lp8 * D;                     // whole-chain x
    if (kTM * L > r) r = kTM * L;        // one head's scores
    if (kTM * kFC > r) r = kTM * kFC;    // one FFN hidden chunk
    region = r;
    kvs = 2 * D + 1;
    off_kv = region;                     // K | V, L x kvs
    off_xs = (off_kv + L * kvs + 3) / 4 * 4;  // own rows of x
    off_q = off_xs + kTM * D;            // q, later the FFN2 sum
    off_o = off_q + kTM * D;             // attention output
    off_x1 = off_o + kTM * D;            // pre-LN1, then x1
    total = off_x1 + kTM * D;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
encoder_layer_kernel(const T* __restrict__ x,
                     const T* __restrict__ w_qkv, const float* __restrict__ b_qkv,
                     const T* __restrict__ w_out, const float* __restrict__ b_out,
                     const float* __restrict__ ln1_s, const float* __restrict__ ln1_b,
                     const T* __restrict__ w1, const float* __restrict__ b1,
                     const T* __restrict__ w2, const float* __restrict__ b2,
                     const float* __restrict__ ln2_s, const float* __restrict__ ln2_b,
                     T* __restrict__ out, int L, int D, int H, int F) {
  constexpr bool kFast = sizeof(T) == 2;
  extern __shared__ __align__(16) float smem[];
  const Smem lay(L, D);
  float* xall = smem;                // phase 1-2
  float* ph = smem;                  // scores (phase 3), hidden chunk (phase 5)
  float* kv = smem + lay.off_kv;
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
  const int kvs = lay.kvs;
  const T* xb = x + (size_t)b * L * D;

  // Phase 1: zero shared memory (padding rows stay finite), load x.
  for (int i = tid; i < lay.total; i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();
  for (int i = tid; i < L * D; i += blockDim.x) xall[i] = to_f(xb[i]);
  for (int i = tid; i < rows * D; i += blockDim.x) xs[i] = to_f(xb[row0 * D + i]);
  __syncthreads();

  // Phase 2: K, V for every row of the chain; q for this tile's rows.
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
        for (int j = lane; j < L; j += 32) srow[j] = round_to<T>(srow[j] * inv);
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
        for (int j = lane; j < L; j += 32) srow[j] = round_to<T>(srow[j] / sum);
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

  // Phase 4: out projection, residual, LN1.
  matmul(o, D, rows, w_out, D, D, D, [&](int r, int n, float acc) {
    x1[r * D + n] = xs[r * D + n] + (acc + b_out[n]);
  });
  for (int i = tid; i < kTM * D; i += blockDim.x) fsum[i] = 0.0f;
  __syncthreads();
  layer_norm_rows<T>(x1, rows, D, ln1_s, ln1_b);
  __syncthreads();

  // Phase 5: FFN, d_ff streamed in chunks of kFC.
  for (int c = 0; c < F; c += kFC) {
    const int fc = min(kFC, F - c);
    matmul(x1, D, rows, w1 + c, F, fc, D, [&](int r, int n, float acc) {
      ph[r * kFC + n] = round_to<T>(fmaxf(acc + b1[c + n], 0.0f));
    });
    __syncthreads();
    matmul(ph, kFC, rows, w2 + (size_t)c * D, D, D, fc, [&](int r, int n, float acc) {
      fsum[r * D + n] += acc;
    });
    __syncthreads();
  }

  // Phase 6: residual, LN2, store.
  for (int i = tid; i < rows * D; i += blockDim.x) {
    const int n = i % D;
    x1[i] = x1[i] + (fsum[i] + b2[n]);
  }
  __syncthreads();
  layer_norm_rows<T>(x1, rows, D, ln2_s, ln2_b);
  __syncthreads();
  T* ob = out + ((size_t)b * L + row0) * D;
  for (int i = tid; i < rows * D; i += blockDim.x) ob[i] = from_f<T>(x1[i]);
}

template <typename T>
int launch(const void* x, const void* w_qkv, const float* b_qkv, const void* w_out,
           const float* b_out, const float* ln1_s, const float* ln1_b, const void* w1,
           const float* b1, const void* w2, const float* b2, const float* ln2_s,
           const float* ln2_b, void* out, int B, int L, int D, int H, int F,
           cudaStream_t stream) {
  const int bytes = Smem(L, D).total * (int)sizeof(float);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      encoder_layer_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + kTM - 1) / kTM, B);
  encoder_layer_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_qkv), b_qkv,
      static_cast<const T*>(w_out), b_out, ln1_s, ln1_b, static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2), b2, ln2_s, ln2_b, static_cast<T*>(out), L, D, H, F);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one CTA needs at sequence length L and width D.
int fdiff_encoder_layer_smem_bytes(int L, int D) {
  return Smem(L, D).total * (int)sizeof(float);
}

// dtype_code 0: float32, 1: bfloat16. Returns cudaGetLastError() after the
// launch (0 on success), or the error that stopped it before.
int fdiff_encoder_layer(int dtype_code, const void* x, const void* w_qkv,
                        const void* b_qkv, const void* w_out, const void* b_out,
                        const void* ln1_s, const void* ln1_b, const void* w1,
                        const void* b1, const void* w2, const void* b2,
                        const void* ln2_s, const void* ln2_b, void* out, int B, int L,
                        int D, int H, int F, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0)
    return launch<float>(x, w_qkv, f(b_qkv), w_out, f(b_out), f(ln1_s), f(ln1_b), w1,
                         f(b1), w2, f(b2), f(ln2_s), f(ln2_b), out, B, L, D, H, F, s);
  if (dtype_code == 1)
    return launch<__nv_bfloat16>(x, w_qkv, f(b_qkv), w_out, f(b_out), f(ln1_s),
                                 f(ln1_b), w1, f(b1), w2, f(b2), f(ln2_s), f(ln2_b),
                                 out, B, L, D, H, F, s);
  return (int)cudaErrorInvalidValue;
}

const char* fdiff_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
