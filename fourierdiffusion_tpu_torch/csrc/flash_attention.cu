// Multi-head attention over (B, H, L, dh) tensors on Hopper (sm_90a):
// softmax(Q K^T / sqrt(dh)) V forward, with and without dropout on the
// attention weights, and its backward. The unfused score network runs them:
// the validation loss and the unfused sampler (forward), and unfused training
// (forward and backward, with dropout where the rate is above 0).
//
// Replaces the TPU kernels of fourierdiffusion_tpu/ops/flash_attention.py:
//   B2 _fwd_kernel (fp32, and bf16 with dh >= 16): S = (q k^T) * scale in
//     fp32, exact max-subtracted softmax, P rounded to the input type,
//     O = P v with fp32 accumulation, rounded to the input type;
//   B2 _fast_fwd_kernel (bf16 with dh < 16): q pre-scaled by the wrapper and
//     rounded to bf16, S = q k^T in fp32 clamped to +-60, exp without the max
//     pass, approximate reciprocal of the row sum, P rounded to bf16, O = P v;
//   B5 _bwd_kernel (core _bwd_core): recomputes P, then O = P v,
//     D = rowsum(dO o O), dP = dO v^T, dS = P o (dP - D), dq = dS k scale,
//     dk = dS^T q scale, dv = P^T dO;
//   B6 _dropout_fwd_kernel / _dropout_bwd_kernel: the same with the keep
//     factors (keep / (1 - rate)) multiplied into P before P v, and into dP
//     and P^T in the backward.
// attention_fwd_kernel<float, false, kDrop> serves B2 (fp32) and B6-fwd;
// attention_bwd_kernel<kDrop> serves B5 (kDrop false: every keep factor is
// the constant 1) and B6-bwd. The training kernels are fp32 only.
//
// Dropout masks: the TPU kernels' interpret-mode _keep_scale. Head h of
// chain b is keyed by tag = seed + b*131071 + g0 (uint32), where g0 = h - h %
// group is the first head of its head group (group = _bwd_group, the same in
// forward and backward); entry (i, j) is kept where _hash_bits of its position
// (g, i, j) in the group's (g, Lp, Lp) block, g = h - g0, is below the
// threshold int((1 - rate) * (2**32 - 1)), and then scaled by 1 / (1 - rate).
// The hash is encoder_layer.cuh's. The seed is read from device memory, so
// drawing it costs the host no synchronisation.
//
// The TPU kernels pad L to 128 lanes and mask keys at or past L; here there
// are exactly L keys, so nothing is masked.
//
// Bound: at the flagship's training shape (B 64, H 12, L 100, dh 6) the
// forward does 4 B H L^2 dh = 184 MFLOP against 4 x 1.8 MB of q, k, v, o in
// fp32, and the backward about three times that (12 B H L^2 dh) against 7 x
// 1.8 MB, so operations bound both in fp32 (2.7 us and 8.3 us at 67
// TFLOP/s); bytes bound the bf16 forward (1.1 us at 3.35 TB/s).
//
// Design: one CTA per (chain, head), 4 warps. The forward stages the head's K
// and V in shared memory as fp32; each warp takes query rows in turn, keeps
// the row of scores in shared memory, reduces its max and sum with shuffles,
// and forms the dh outputs of the row as warp sums over the keys. The
// backward stages Q, K, V and dO of the head and makes three passes, all
// with fixed warp and lane orders (no atomics, so its sums are the same in
// every run): (1) per query row, the softmax max and sum and
// D = dO . (P_used v); (2) per query row, dS over the keys and dq as warp
// sums; (3) per key, dS and P_used down the column and dk, dv as warp sums.
// Scores and probabilities are recomputed in each pass and never reach
// device memory.

#include "encoder_layer.cuh"

namespace {

using fdiff::from_f;
using fdiff::round_to;
using fdiff::to_f;
using fdiff::warp_max;
using fdiff::warp_sum;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDh = 64;
constexpr float kScoreClamp = 60.0f;
constexpr int kMaxSmem = fdiff::kMaxSmem;

// Dropout of the attention weights: seed points to one int64 in device memory.
struct AttnDropout {
  const long long* seed;
  unsigned int thr;  // keep where bits < thr: int((1 - rate) * (2**32 - 1))
  float scale;       // 1 / (1 - rate)
  int group;         // heads per head group
};

// The hash's parameters for head h of chain b: the Dropout of
// encoder_layer.cuh (for keep3), the tag and the head's index in its group.
struct HeadMask {
  fdiff::Dropout dp;
  uint32_t tag;
  int g;
};

template <bool kDrop>
__device__ __forceinline__ HeadMask head_mask(const AttnDropout& drop, int b, int h) {
  HeadMask m{{0u, 0u, 1.0f, 1}, 0u, 0};
  if constexpr (kDrop) {
    const uint32_t seed = (uint32_t)(unsigned long long)(*drop.seed);
    m.dp = fdiff::Dropout{seed, drop.thr, drop.scale, drop.group};
    m.tag = seed + (uint32_t)b * 131071u + (uint32_t)(h - h % drop.group);
    m.g = h % drop.group;
  }
  return m;
}

// keep / (1 - rate) of entry (i, j); 1 without dropout.
template <bool kDrop>
__device__ __forceinline__ float keep(const HeadMask& m, int i, int j) {
  return fdiff::keep3<kDrop>(m.dp, m.tag, m.g, i, j);
}

// kFast: the max-free bf16 form; q arrives pre-scaled and `scale` is unused.
// kDrop: P o keep before P v (fp32 only).
template <typename T, bool kFast, bool kDrop>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H, int L, int dh,
                     float scale, AttnDropout drop) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                       // L x dh
  float* vs = ks + L * dh;                // L x dh
  float* rows = vs + L * dh;              // kWarps x L scores
  float* qs = rows + kWarps * L;          // kWarps x kMaxDh query rows
  const size_t base = (size_t)blockIdx.x * L * dh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const HeadMask mask = head_mask<kDrop>(drop, blockIdx.x / H, blockIdx.x % H);
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
      srow[j] = round_to<T>(kFast ? srow[j] * inv : srow[j] / sum) * keep<kDrop>(mask, i, j);
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

// S[i, j] = (q_i . k_j) * scale and dO_i . v_j, in one fixed order, so that
// every pass of the backward recomputes the same values.
__device__ __forceinline__ float score(const float* qs, const float* ks, int i, int j, int dh,
                                       float scale) {
  float s = 0.0f;
  for (int d = 0; d < dh; ++d) s = fmaf(qs[i * dh + d], ks[j * dh + d], s);
  return s * scale;
}

__device__ __forceinline__ float dot_rows(const float* a, const float* b, int i, int j,
                                          int dh) {
  float s = 0.0f;
  for (int d = 0; d < dh; ++d) s = fmaf(a[i * dh + d], b[j * dh + d], s);
  return s;
}

// Shared memory of the backward, in floats: q, k, v, dO of the head
// (4 L dh), the row statistics m, l, D (3 L), and two L-long buffers per warp.
__host__ __device__ inline int bwd_smem_floats(int L, int dh) {
  return 4 * L * dh + 3 * L + 2 * kWarps * L;
}

template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                     int H, int L, int dh, float scale, AttnDropout drop) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // L x dh
  float* ks = qs + L * dh;
  float* vs = ks + L * dh;
  float* dos = vs + L * dh;
  float* row_m = dos + L * dh;      // softmax max of row i
  float* row_l = row_m + L;         // softmax sum of row i
  float* row_d = row_l + L;         // D_i = dO_i . O_i
  float* bufs = row_d + L;          // kWarps x 2L
  const size_t base = (size_t)blockIdx.x * L * dh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const HeadMask mask = head_mask<kDrop>(drop, blockIdx.x / H, blockIdx.x % H);
  for (int e = threadIdx.x; e < L * dh; e += blockDim.x) {
    qs[e] = q[base + e];
    ks[e] = k[base + e];
    vs[e] = v[base + e];
    dos[e] = dout[base + e];
  }
  __syncthreads();
  float* buf = bufs + warp * 2 * L;
  float* buf2 = buf + L;

  // Pass 1, per query row i: m, l and D = sum_d dO[i, d] O[i, d] with
  // O = P_used v recomputed (P_used = P o keep).
  for (int i = warp; i < L; i += kWarps) {
    float m = -FLT_MAX;
    for (int j = lane; j < L; j += 32) {
      const float s = score(qs, ks, i, j, dh, scale);
      buf[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(buf[j] - m);
      buf[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < L; j += 32) buf[j] = buf[j] / sum * keep<kDrop>(mask, i, j);
    __syncwarp();
    float dsum = 0.0f;
    for (int d = 0; d < dh; ++d) {
      float acc = 0.0f;
      for (int j = lane; j < L; j += 32) acc = fmaf(buf[j], vs[j * dh + d], acc);
      dsum = fmaf(dos[i * dh + d], warp_sum(acc), dsum);
    }
    if (lane == 0) {
      row_m[i] = m;
      row_l[i] = sum;
      row_d[i] = dsum;
    }
    __syncwarp();
  }
  __syncthreads();

  // Pass 2, per query row i: dS[i, :] and dq_i = scale * sum_j dS[i, j] k_j.
  for (int i = warp; i < L; i += kWarps) {
    const float m = row_m[i], l = row_l[i], D = row_d[i];
    for (int j = lane; j < L; j += 32) {
      const float p = expf(score(qs, ks, i, j, dh, scale) - m) / l;
      const float dp = dot_rows(dos, vs, i, j, dh) * keep<kDrop>(mask, i, j);
      buf[j] = p * (dp - D);
    }
    __syncwarp();
    for (int d = 0; d < dh; ++d) {
      float acc = 0.0f;
      for (int j = lane; j < L; j += 32) acc = fmaf(buf[j], ks[j * dh + d], acc);
      acc = warp_sum(acc);
      if (lane == 0) dq[base + (size_t)i * dh + d] = acc * scale;
    }
    __syncwarp();
  }

  // Pass 3, per key j: dS[:, j] and P_used[:, j]; dk_j = scale * sum_i
  // dS[i, j] q_i and dv_j = sum_i P_used[i, j] dO_i.
  for (int j = warp; j < L; j += kWarps) {
    for (int i = lane; i < L; i += 32) {
      const float p = expf(score(qs, ks, i, j, dh, scale) - row_m[i]) / row_l[i];
      const float kp = keep<kDrop>(mask, i, j);
      const float dp = dot_rows(dos, vs, i, j, dh) * kp;
      buf[i] = p * (dp - row_d[i]);
      buf2[i] = p * kp;
    }
    __syncwarp();
    for (int d = 0; d < dh; ++d) {
      float acc_k = 0.0f, acc_v = 0.0f;
      for (int i = lane; i < L; i += 32) {
        acc_k = fmaf(buf[i], qs[i * dh + d], acc_k);
        acc_v = fmaf(buf2[i], dos[i * dh + d], acc_v);
      }
      acc_k = warp_sum(acc_k);
      acc_v = warp_sum(acc_v);
      if (lane == 0) {
        dk[base + (size_t)j * dh + d] = acc_k * scale;
        dv[base + (size_t)j * dh + d] = acc_v;
      }
    }
    __syncwarp();
  }
}

// The keep factors of B6 as the kernels above apply them, (B, H, L, L), for checking.
__global__ void attention_masks_kernel(float* __restrict__ out, int B, int H, int L,
                                       AttnDropout drop) {
  const size_t n = (size_t)B * H * L * L;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int j = e % L, i = (e / L) % L;
    const int bh = e / ((size_t)L * L);
    out[e] = keep<true>(head_mask<true>(drop, bh / H, bh % H), i, j);
  }
}

template <typename T, bool kFast, bool kDrop>
int launch_fwd(const void* q, const void* k, const void* v, void* o, int B, int H, int L,
               int dh, float scale, const AttnDropout& drop, cudaStream_t stream) {
  const int bytes = (2 * L * dh + kWarps * (L + kMaxDh)) * (int)sizeof(float);
  if (bytes > kMaxSmem || dh > kMaxDh) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<T, kFast, kDrop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  attention_fwd_kernel<T, kFast, kDrop><<<B * H, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, L, dh, scale, drop);
  return (int)cudaGetLastError();
}

template <bool kDrop>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, void* dq,
               void* dk, void* dv, int B, int H, int L, int dh, float scale,
               const AttnDropout& drop, cudaStream_t stream) {
  const int bytes = bwd_smem_floats(L, dh) * (int)sizeof(float);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_kernel<kDrop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_kernel<kDrop><<<B * H, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), H, L, dh, scale, drop);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// variant 0: fp32 exact; 1: bf16 exact (dh >= 16); 2: bf16 max-free (q
// pre-scaled). seed: null for no dropout, else one int64 in device memory
// (variant 0 only); thr, keep_scale and group as in AttnDropout. B chains of H
// heads of (L, dh). Returns cudaGetLastError() after the launch (0 on
// success), or the error that stopped it before.
int fdiff_attention_fwd(int variant, const void* q, const void* k, const void* v, void* o,
                        int B, int H, int L, int dh, float scale, const void* seed,
                        unsigned int thr, float keep_scale, int group, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const AttnDropout drop{static_cast<const long long*>(seed), thr, keep_scale, group};
  if (seed != nullptr) {
    if (variant != 0 || group < 1) return (int)cudaErrorInvalidValue;
    return launch_fwd<float, false, true>(q, k, v, o, B, H, L, dh, scale, drop, s);
  }
  if (variant == 0) return launch_fwd<float, false, false>(q, k, v, o, B, H, L, dh, scale, drop, s);
  if (variant == 1)
    return launch_fwd<__nv_bfloat16, false, false>(q, k, v, o, B, H, L, dh, scale, drop, s);
  if (variant == 2)
    return launch_fwd<__nv_bfloat16, true, false>(q, k, v, o, B, H, L, dh, scale, drop, s);
  return (int)cudaErrorInvalidValue;
}

// fp32 backward: dq, dk, dv from q, k, v and dO (all (B, H, L, dh)); seed as
// in fdiff_attention_fwd (null: B5, else B6-bwd).
int fdiff_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                        void* dq, void* dk, void* dv, int B, int H, int L, int dh,
                        float scale, const void* seed, unsigned int thr, float keep_scale,
                        int group, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const AttnDropout drop{static_cast<const long long*>(seed), thr, keep_scale, group};
  if (seed == nullptr)
    return launch_bwd<false>(q, k, v, dout, dq, dk, dv, B, H, L, dh, scale, drop, s);
  if (group < 1) return (int)cudaErrorInvalidValue;
  return launch_bwd<true>(q, k, v, dout, dq, dk, dv, B, H, L, dh, scale, drop, s);
}

// The (B, H, L, L) keep factors of fdiff_attention_fwd's dropout, for checking.
int fdiff_attention_dropout_masks(void* out, int B, int H, int L, const void* seed,
                                  unsigned int thr, float keep_scale, int group,
                                  void* stream) {
  if (seed == nullptr || group < 1) return (int)cudaErrorInvalidValue;
  const AttnDropout drop{static_cast<const long long*>(seed), thr, keep_scale, group};
  attention_masks_kernel<<<264, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), B, H, L, drop);
  return (int)cudaGetLastError();
}

// Shared-memory bytes of one backward CTA.
int fdiff_attention_bwd_smem_bytes(int L, int dh) {
  return bwd_smem_floats(L, dh) * (int)sizeof(float);
}

const char* fdiff_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
