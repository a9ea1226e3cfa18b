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
//   B2 _fast_fwd_kernel (bf16 with dh < 16): q pre-scaled (as the TPU
//     wrapper does it: by the scale rounded to bf16, the product rounded to
//     bf16), S = q k^T in fp32 clamped to +-60, exp without the max
//     pass, approximate reciprocal of the row sum, P rounded to bf16, O = P v;
//   B5 _bwd_kernel (core _bwd_core): recomputes P, then O = P v,
//     D = rowsum(dO o O), dP = dO v^T, dS = P o (dP - D), dq = dS k scale,
//     dk = dS^T q scale, dv = P^T dO;
//   B6 _dropout_fwd_kernel / _dropout_bwd_kernel: the same with the keep
//     factors (keep / (1 - rate)) multiplied into P before P v, and into dP
//     and P^T in the backward.
// attention_fwd_mma_kernel<T, kFast, kDrop, kDh, kPacked, kKept> serves B2
// (kDrop false: fp32, bf16 and the fast bf16 form) and B6-fwd (kDrop true:
// fp32, and bf16 in the exact form; kKept where the plan keeps S); the two
// launches attention_bwd_dq_mma_kernel<T, kDrop, kDh, kKept> and
// attention_bwd_dkv_mma_kernel<T, kDrop, kDh> serve B5 (kDrop false: every
// keep factor is the constant 1) and B6-bwd, in fp32 and bf16.
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
// The TPU kernels pad L to 128 lanes and mask keys at or past L; the
// kernels here pad to blocks of 64 and give a padded key (or query row) no
// weight.
//
// Bound: at the flagship's training shape (B 64, H 12, L 100, dh 6) the
// forward does 4 B H L^2 dh = 184 MFLOP against 4 x 1.8 MB of q, k, v, o in
// fp32, and the backward five products of that size (10 B H L^2 dh: S =
// q k^T, dP = dO v^T, dq = dS k, dk = dS^T q, dv = P^T dO; D comes from the
// saved o) against 8 x 1.8 MB (q, k, v, o, dO in; dq, dk, dv out), so
// operations bound both in fp32 (2.7 us and 6.9 us at 67 TFLOP/s on the
// CUDA cores; as 3xTF32 on the tensor cores, three times the products at
// 495 TFLOP/s, 1.1 us and 2.8 us); bytes bound both in bf16 (1.1 us and
// 2.2 us at 3.35 TB/s: the backward's products, 0.47 us at 989 TFLOP/s,
// are fewer than its 7.4 MB take).
//
// The kernels are attention_mma.cuh's, over (B, H, L, dh) heads (kPacked
// false: no AttnLayout is read): B2 attention_fwd_mma_kernel<T, kFast, false, kDh, false, kKept> (fp32,
// bf16 and the fast bf16 form), B6-fwd its kDrop instance (fp32, and bf16 in
// the exact form: JAX's _dropout_fwd_kernel takes no fast form), B5 and
// B6-bwd the two launches attention_bwd_dq_mma_kernel<T, kDrop, kDh, kKept>
// (kKept where the plan keeps S in registers) and
// attention_bwd_dkv_mma_kernel<T, kDrop, kDh> (kDrop false: every keep
// factor is the constant 1), all with kPacked false. Their design and numerics are described there.
// The launches' plans (AttnFwdPlan, AttnBwdPlan) are computed by the Python
// wrapper and passed in.

#include "attention_mma.cuh"

namespace {

using namespace fdiff::attn;

// B6's dropout: the seed in device memory, the TPU kernels' tag (the head
// group's first head added as it is).
AttnDropout attn_dropout(const void* seed, unsigned int thr, float keep_scale, int group) {
  return {static_cast<const long long*>(seed), 0u, thr, keep_scale, group, 1u};
}

template <typename T>
const T* in(const void* x) { return static_cast<const T*>(x); }

template <typename T, bool kDrop>
int fwd_exact(const void* q, const void* k, const void* v, void* o, int B, int H, int L, int dh,
              float scale, const AttnDropout& drop, const AttnFwdPlan& p, cudaStream_t s) {
  return (int)launch_fwd_exact<T, kDrop, false>(in<T>(q), in<T>(k), in<T>(v),
                                                static_cast<T*>(o), AttnLayout{}, B, H, L, dh,
                                                scale, drop, p, s);
}

template <typename T, bool kDrop>
int bwd(const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
        void* dk, void* dv, void* stats, int B, int H, int L, int dh, float scale,
        const AttnDropout& drop, const AttnBwdPlan& p, cudaStream_t s) {
  const AttnBwdArgs<T> a{in<T>(q), in<T>(k), in<T>(v), in<T>(o), in<T>(dout),
                         static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
                         nullptr, nullptr, nullptr, static_cast<float*>(stats), AttnLayout{}};
  return (int)launch_bwd<T, kDrop, false>(a, B, H, L, dh, scale, drop, p, s);
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

}  // namespace

extern "C" {

// variant 0: fp32 exact; 1: bf16 exact (B2 with dh >= 16, and B6-fwd); 2:
// bf16 max-free (q pre-scaled). plan: the launch (ops/flash_attention.py:
// attention_fwd_plan, of the variant's dtype, with dropout too). seed: null
// for no dropout (B2), else one int64 in device memory (B6-fwd, variant 0
// or 1); thr, keep_scale and group as in AttnDropout. B chains of H heads
// of (L, dh). Returns cudaGetLastError() after the launch (0 on success),
// or the error that stopped it before.
int fdiff_attention_fwd(int variant, const void* q, const void* k, const void* v, void* o,
                        int B, int H, int L, int dh, float scale, const AttnFwdPlan* plan,
                        const void* seed, unsigned int thr, float keep_scale, int group,
                        void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (plan == nullptr) return (int)cudaErrorInvalidValue;
  const AttnFwdPlan& p = *plan;
  const AttnDropout drop = attn_dropout(seed, thr, keep_scale, group);
  using bf16 = __nv_bfloat16;
  if (seed != nullptr) {
    if (group < 1) return (int)cudaErrorInvalidValue;
    if (variant == 0) return fwd_exact<float, true>(q, k, v, o, B, H, L, dh, scale, drop, p, s);
    if (variant == 1) return fwd_exact<bf16, true>(q, k, v, o, B, H, L, dh, scale, drop, p, s);
    return (int)cudaErrorInvalidValue;
  }
  if (variant == 0) return fwd_exact<float, false>(q, k, v, o, B, H, L, dh, scale, drop, p, s);
  if (variant == 1) return fwd_exact<bf16, false>(q, k, v, o, B, H, L, dh, scale, drop, p, s);
  if (variant == 2 && dh < 16 && p.kdh == 16)
    return (int)launch_fwd_mma<bf16, true, false, 16, false>(in<bf16>(q), in<bf16>(k), in<bf16>(v),
                                                      static_cast<bf16*>(o), AttnLayout{}, B,
                                                      H, L, dh, scale, drop, p, s);
  return (int)cudaErrorInvalidValue;
}

// The backward (B5 with seed null, else B6-bwd) in fp32 (variant 0) or bf16
// (variant 1): dq, dk, dv from q, k, v, the forward's output o (read in
// fp32 only; null in bf16) and dO (all (B, H, L, dh) of the variant's dtype), in two
// launches (plan: ops/flash_attention.py: attention_bwd_plan, of that
// dtype), with the rows' softmax max, sum and D = dO . O written to stats
// (B, H, L, 3), fp32; seed, thr, keep_scale and group as in
// fdiff_attention_fwd.
int fdiff_attention_bwd(int variant, const void* q, const void* k, const void* v,
                        const void* o, const void* dout, void* dq, void* dk, void* dv,
                        void* stats, int B, int H, int L, int dh, float scale,
                        const AttnBwdPlan* plan, const void* seed, unsigned int thr,
                        float keep_scale, int group, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (plan == nullptr || (seed != nullptr && group < 1)) return (int)cudaErrorInvalidValue;
  const AttnDropout drop = attn_dropout(seed, thr, keep_scale, group);
  const bool drops = seed != nullptr;
  if (variant == 0)
    return drops ? bwd<float, true>(q, k, v, o, dout, dq, dk, dv, stats, B, H, L, dh, scale,
                                    drop, *plan, s)
                 : bwd<float, false>(q, k, v, o, dout, dq, dk, dv, stats, B, H, L, dh, scale,
                                     drop, *plan, s);
  if (variant == 1)
    return drops ? bwd<__nv_bfloat16, true>(q, k, v, o, dout, dq, dk, dv, stats, B, H, L, dh,
                                            scale, drop, *plan, s)
                 : bwd<__nv_bfloat16, false>(q, k, v, o, dout, dq, dk, dv, stats, B, H, L, dh,
                                             scale, drop, *plan, s);
  return (int)cudaErrorInvalidValue;
}

// The (B, H, L, L) keep factors of fdiff_attention_fwd's dropout, for checking.
int fdiff_attention_dropout_masks(void* out, int B, int H, int L, const void* seed,
                                  unsigned int thr, float keep_scale, int group,
                                  void* stream) {
  if (seed == nullptr || group < 1) return (int)cudaErrorInvalidValue;
  const AttnDropout drop = attn_dropout(seed, thr, keep_scale, group);
  attention_masks_kernel<<<264, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), B, H, L, drop);
  return (int)cudaGetLastError();
}

const char* fdiff_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
