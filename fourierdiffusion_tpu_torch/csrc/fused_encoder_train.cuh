// One post-LN transformer encoder layer in training mode, forward (B3) and
// backward (B4), fp32 and bf16, for the training path on Hopper (sm_90a):
// the kernels and launch sequences, instantiated for fp32 by
// fused_encoder_train.cu and for bf16 by fused_encoder_train_bf16.cu (two
// libraries, so that nvcc builds them side by side).
//
// Replaces the TPU kernels of fourierdiffusion_tpu/ops/fused_encoder_train.py:
//   _train_fwd_kernel (B3): the layer with the dropout masks at its four
//     sites (attention probabilities, attention output, FFN hidden layer,
//     FFN output), in four launches (seven where D is wider than 256): the
//     QKV tile product and the tail in kTailTrainFwd with its finish (which
//     writes LN2's output) of encoder_layer_tc.cuh, and between them the
//     attention forward of attention_mma.cuh on mma.sync tiles with the
//     attention-site dropout (layer_attention_fwd; train_forward).
//   _train_bwd_kernel (B4): recomputes that forward from x alone with the
//     same launches on the same plan (train_forward in kTailTrainBwd), so the
//     gradient belongs to the forward whose loss was taken, sum for sum;
//     regenerates the four dropout masks with the same hash, and computes dx
//     and the gradients of the 12 packed weights. The TPU kernel sums the
//     weight gradients over its sequential grid (ref += contrib); here each
//     sum over rows is split into row slices whose partials one last launch
//     adds in slice order.
//
// Numerics, as the TPU kernels in the activation dtype T: the forward's as
// encoder_layer_tc.cuh sets them (exact max-subtracted softmax, P times
// its keep factor rounded to T, the residual around the FFN in fp32); every
// product of the backward takes operands in T and sums in fp32 (fp32 as
// 3xTF32, bf16 on bf16 tensor cores, mma_tile.cuh): in bf16 the FFN's
// x1, h, dF2 and dh, the out projection's dao, the attention's dO, P keep
// and dS, and dqkv are rounded to T where they enter a product, while the
// bias and LayerNorm gradients sum their fp32 values; LayerNorm statistics
// and the softmax in fp32 with eps 1e-5; dx in T; the weight gradients in
// fp32 (the wrapper rounds them to the packed weights' dtype, as the TPU
// kernel's caller does).
//
// Layout: activations (B, L, D) row-major with exactly L rows; weights as
// packed by ops/fused_encoder_train.py (in, out) row-major; the weight
// gradients in the same layout.
//
// Bound: at the flagship's training shape (B 64, L 100, D 72, F 2048, H 12)
// the forward does about 4.2 GFLOP against 1.3 MB of weights and 2 x 1.8 MB
// of activations, the backward about 12.7 GFLOP (the recompute, then two products per
// forward product); weights are 1.3 MB and x 1.8 MB, so it is bound by
// operations, both. The first B3 and B4 ran one CTA per chain (64 CTAs on 132 SMs), each
// product a loop of 4 x 4 fp32 outputs per thread over operands read from
// L2 (B3: per 32 query rows of a chain, K and V recomputed by each). Both
// now spread the work over all B*L rows on the tensor cores: B3 in the 4
// launches above, B4 in 17 (20 where the tail runs wide), in order:
//   forward   qkv (tile product), attention (layer_attention_fwd), layer_tail_kernel<kTrain>
//             and tail_finish_kernel<kTrain> (encoder_layer_tc.cuh): x1, the
//             LN statistics, LN2's backward g2 and dF2 = g2 * keep_ff2;
//   hidden    x1 W1 + b1 and dF2 W2^T in one pass -> h = relu * keep and dh;
//   products  dW1 = x1^T dh and dW2 = h^T dF2 per row slice; dh W1^T per
//             d_ff slice;
//   ln1/out   dx1 = g2 + those slices in order; LN1's backward da,
//             dao = da * keep_out; dattn = round_T(dao W_out^T) (dO);
//             dW_out = O^T dao per row slice;
//   attention attention_mma.cuh's backward over the packed qkv, no atomics:
//             a CTA per (chain, head, 128 query rows) and a warp per 16 rows
//             for dq and the softmax statistics, then the same per 128 keys
//             for dk and dv, K and V (then Q, dO and the statistics) streamed
//             through a two-stage cp.async ring of 64 rows, every product on
//             mma.sync (layer_attention_bwd);
//   qkv       dW_qkv = x^T dqkv per row slice; dx = da + dqkv W_qkv^T;
//   reduce    column sums (bias and LayerNorm gradients) per row slice, then
//             every partial added in slice order.
// Every sum has one fixed order, so two calls on the same inputs give
// bit-identical results. The plans (the tail's plan and CTAs, row slices,
// workspace offsets) come from the wrapper (ops/fused_encoder_train.py:
// train_fwd_plan, and train_bwd_plan, whose forward stage is the same plan),
// which also holds a plain PyTorch version that follows B4's stages.

#pragma once

#include "attention_mma.cuh"
#include "encoder_layer_tc.cuh"

namespace {

using namespace fdiff;

// Offsets of the 12 gradients in the packed gradient vector.
struct GradOffsets {
  int w_qkv, b_qkv, w_out, b_out, ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b, total;
  __host__ __device__ GradOffsets(int D, int F) {
    int o = 0;
    w_qkv = o; o += D * 3 * D;
    b_qkv = o; o += 3 * D;
    w_out = o; o += D * D;
    b_out = o; o += D;
    ln1_s = o; o += D;
    ln1_b = o; o += D;
    w1 = o;    o += D * F;
    b1 = o;    o += F;
    w2 = o;    o += F * D;
    b2 = o;    o += D;
    ln2_s = o; o += D;
    ln2_b = o; o += D;
    total = o;
  }
};

constexpr int kGrads = 12;
enum GradIdx { kWQkv, kBQkv, kWOut, kBOut, kLn1S, kLn1B, kW1, kB1, kW2, kB2, kLn2S, kLn2B };

// The backward's plan, as ops/fused_encoder_train.py's BwdPlan passes it:
// the tail's plan and CTAs, workspace offsets in floats (qkv, attn, h and
// dattn hold T; stats the softmax statistics, (B, H, L, 3); in bf16 x1t,
// df2t, dht, daot and dqkvt hold the product operands x1, dF2, dh, dao and
// dqkv rounded to T, which in fp32 are those buffers themselves), the row
// slices of the four weight products (rows per slice ks_, slices sp_), the
// column sums' rows per slice and slices, per gradient the offset of its
// partials and their number, and the attention stages' launches
// (ops/flash_attention.py: attention_fwd_plan, attention_bwd_plan).
struct BwdPlan {
  TailPlan tail;
  long long tail_ctas;
  long long qkv, attn, x1, xhat1, inv1, xhat2, inv2, g2, df2, h, dh, dx1, da, dao, dattn,
      dqkv, stats, dx1p, x1t, df2t, dht, daot, dqkvt, tail_part, part;
  long long ks_w1, ks_w2, ks_w_out, ks_w_qkv, sp_w1, sp_w2, sp_w_out, sp_w_qkv;
  long long ks_dx1, sp_dx1;  // d_ff slices of dh W1^T
  long long cs_rows, cs_slices;
  long long p_off[kGrads], p_n[kGrads];
  AttnFwdPlan attn_fwd;  // the forward recompute's attention (FwdPlan's)
  AttnBwdPlan attn_bwd;  // the attention backward's two launches
};

constexpr int kBwdStages = 7;  // events: before, then after each stage

// The forward's plan, as ops/fused_encoder_train.py's FwdPlan passes it:
// the tail's plan and CTAs, and workspace offsets in floats: qkv (N x 3D,
// T), attn (N x D, T), x1 (N x D; the wide route's x1 in T), the wide
// route's pre (N x D) and h (N x F, T), the fused route's f2 partials.
struct FwdPlan {
  TailPlan tail;
  long long tail_ctas;
  long long qkv, attn, x1, pre, h, tail_part;
  AttnFwdPlan attn_fwd;  // the attention forward (ops/flash_attention.py: attention_fwd_plan)
};

__device__ __forceinline__ void chain_of(int m, int L, int& b, int& l) {
  b = m / L;
  l = m - b * L;
}

// ---- epilogues of the tile products ----------------------------------------------------

template <typename T>
struct AddStore {  // out[m, n] = round_T(add[m, n] + v)
  T* out; const float* add; int ld;
  __device__ void operator()(int m, int n, float v) const {
    out[(long)m * ld + n] = from_f<T>(add[(long)m * ld + n] + v);
  }
};

template <typename T>
struct StoreRounded {  // out[m, n] = round_T(v)
  T* out; int ld;
  __device__ void operator()(int m, int n, float v) const { out[(long)m * ld + n] = from_f<T>(v); }
};

struct StorePartial {  // slice blockIdx.z of the partials
  float* part; int ld; long slice;
  __device__ void operator()(int m, int n, float v) const {
    part[blockIdx.z * slice + (long)m * ld + n] = v;
  }
};

// From x1 W1 (v) and dF2 W2^T (dv): pre = v + b1, h = round_T(relu(pre) *
// keep_ff), dh = (pre > 0 ? keep_ff : 0) * dv, and in bf16 dht = round_T(dh).
template <typename T>
struct HiddenEpi {
  T* h; float* dh; T* dht; const float* b1; int F, L; Dropout dp;
  __device__ void operator()(int m, int n, float v, float dv) const {
    int b, l;
    chain_of(m, L, b, l);
    const float pre = v + b1[n];
    const float kf = keep2<true>(dp, mask_key(dp, b, kSiteFf, 0), n, l);
    const float d = (pre > 0.0f ? kf : 0.0f) * dv;
    h[(long)m * F + n] = from_f<T>(fmaxf(pre, 0.0f) * kf);
    dh[(long)m * F + n] = d;
    if constexpr (sizeof(T) == 2) dht[(long)m * F + n] = from_f<T>(d);
  }
};

// ---- row and column kernels --------------------------------------------------------------

// dx1 = g2 + the d_ff slices' partials of dh W1^T in slice order, then
// LN1's input gradient, a warp per row: da = inv (g s - mean(g s) - xhat
// mean(g s xhat)); dao = da * keep_out, and in bf16 daot = round_T(dao).
template <typename T>
__global__ void ln1_bwd_kernel(const float* __restrict__ g2, const float* __restrict__ dx1p,
                               int slices, float* __restrict__ dx1,
                               const float* __restrict__ xhat1,
                               const float* __restrict__ inv1, const float* __restrict__ ln1_s,
                               float* __restrict__ da, float* __restrict__ dao,
                               T* __restrict__ daot, int N, int L, int D, Dropout dp) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (r >= N) return;
  const size_t g = (size_t)r * D, slice = (size_t)N * D;
  float s1 = 0.0f, s2 = 0.0f;
  for (int c = lane; c < D; c += 32) {
    float acc = dx1p[g + c];
    for (int z = 1; z < slices; ++z) acc += dx1p[z * slice + g + c];
    dx1[g + c] = g2[g + c] + acc;
    const float dxh = dx1[g + c] * ln1_s[c];
    s1 += dxh;
    s2 += dxh * xhat1[g + c];
  }
  const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
  int b, l;
  chain_of(r, L, b, l);
  const uint32_t key = mask_key(dp, b, kSiteOut, 0);
  for (int c = lane; c < D; c += 32) {
    const float v = inv1[r] * (dx1[g + c] * ln1_s[c] - m1 - xhat1[g + c] * m2);
    const float o = v * keep2<true>(dp, key, c, l);
    da[g + c] = v;
    dao[g + c] = o;
    if constexpr (sizeof(T) == 2) daot[g + c] = from_f<T>(o);
  }
}

// One column sum: out[z][c] = sum over rows of slice z of a[r, c] (* b[r, c]);
// a in fp32, or in bf16 where a_bf16 (dy of a bf16 layer).
struct ColSum {
  const void* a; const float* b; float* out; int cols; int a_bf16;
};
constexpr int kColSums = 8;
struct ColSums { ColSum job[kColSums]; };

// grid (ceil(max cols / 128), slices, jobs).
__global__ void col_sums_kernel(ColSums jobs, int N, int rows_per_slice) {
  const ColSum& j = jobs.job[blockIdx.z];
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= j.cols) return;
  const int r0 = blockIdx.y * rows_per_slice, r1 = min(N, r0 + rows_per_slice);
  float s = 0.0f;
  for (int r = r0; r < r1; ++r) {
    const size_t e = (size_t)r * j.cols + c;
    const float v = j.a_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(j.a)[e])
                             : static_cast<const float*>(j.a)[e];
    s += j.b ? v * j.b[e] : v;
  }
  j.out[(size_t)blockIdx.y * j.cols + c] = s;
}

struct PartialSets { long long off[kGrads], n[kGrads]; };

// grads[p] = sum over the slices z = 0, 1, ... of gradient k's partials.
__global__ void reduce_partials_kernel(const float* __restrict__ part, float* __restrict__ grads,
                                       PartialSets ps, int D, int F) {
  const GradOffsets go(D, F);
  const int starts[kGrads + 1] = {go.w_qkv, go.b_qkv, go.w_out, go.b_out, go.ln1_s, go.ln1_b,
                                  go.w1,    go.b1,    go.w2,    go.b2,    go.ln2_s, go.ln2_b,
                                  go.total};
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < go.total;
       p += gridDim.x * blockDim.x) {
    int k = 0;
    while (p >= starts[k + 1]) ++k;
    const int size = starts[k + 1] - starts[k], i = p - starts[k];
    const float* src = part + ps.off[k] + i;
    float s = 0.0f;
    for (long long z = 0; z < ps.n[k]; ++z) s += src[z * size];
    grads[p] = s;
  }
}

// ---- attention -----------------------------------------------------------------------------

// The layer's attention on attention_mma.cuh's kernels. Head h of chain b
// lies in the packed qkv (B*L x 3D, T) at columns h dh (q), D + h dh (k) and
// 2D + h dh (v), and in the (B*L x D) attention output and its gradient at
// columns h dh: strided rows, read where they lie; dq, dk and dv go to the
// packed gradient at q's, k's and v's columns. The scores take no scale
// (the packed q columns carry 1/sqrt(dh)); the ATTN site's masks are the
// layer's (attn_key, keep3), so dropout_masks_kernel checks them.
inline attn::AttnLayout packed_heads(int L, int D, int H) {
  return {(long long)L * 3 * D, D / H, (long long)L * D, D / H, 3 * D, D};
}

inline attn::AttnDropout layer_attn_dropout(const Dropout& dp) {
  return {nullptr, dp.seed, dp.thr, dp.scale, dp.group, 104729u};
}

// O = round_T(round_T(softmax(q k^T) * keep) v) into out (B*L x D, T).
template <typename T>
cudaError_t layer_attention_fwd(const T* qkv, T* out, int B, int L, int D, int H,
                                const Dropout& dp, const AttnFwdPlan& p, cudaStream_t s) {
  return attn::launch_fwd_exact<T, true, true>(qkv, qkv + D, qkv + 2 * D, out,
                                               packed_heads(L, D, H), B, H, L, D / H, 1.0f,
                                               layer_attn_dropout(dp), p, s);
}

// dq, dk and dv from dO = dattn (B*L x D, rounded to T by the out
// projection's epilogue) into dqkv (fp32) and, in bf16, dqkvt (T) (in fp32
// dqkvt is dqkv itself); D = dO . O from the forward's O in fp32, from O
// recomputed in bf16; the softmax statistics of launch 1 in stats (B, H,
// L, 3).
template <typename T>
cudaError_t layer_attention_bwd(const T* qkv, const T* o, const T* dattn, float* dqkv,
                                T* dqkvt, float* stats, int B, int L, int D, int H,
                                const Dropout& dp, const AttnBwdPlan& p, cudaStream_t s) {
  constexpr bool kBf16 = sizeof(T) == 2;
  auto f32 = [&](int part) { return kBf16 ? dqkv + part * D : nullptr; };
  const attn::AttnBwdArgs<T> a{qkv,        qkv + D,        qkv + 2 * D, o,
                               dattn,      dqkvt,          dqkvt + D,   dqkvt + 2 * D,
                               f32(0),     f32(1),         f32(2),      stats,
                               packed_heads(L, D, H)};
  return attn::launch_bwd<T, true, true>(a, B, H, L, D / H, 1.0f, layer_attn_dropout(dp), p,
                                         s);
}

// The four masks, as the kernels above apply them, for checking.
__global__ void dropout_masks_kernel(float* attn, float* out_m, float* ff, float* ff2,
                                     int B, int L, int D, int H, int F, Dropout dp) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t start = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n_attn = (size_t)B * H * L * L;
  for (size_t e = start; e < n_attn; e += stride) {
    const int j = e % L, i = (e / L) % L, h = (e / ((size_t)L * L)) % H;
    const int b = e / ((size_t)H * L * L);
    attn[e] = keep3(dp, attn_key(dp, b, h), h % dp.group, i, j);
  }
  const size_t n_d = (size_t)B * L * D;
  for (size_t e = start; e < n_d; e += stride) {
    const int d = e % D, l = (e / D) % L, b = e / ((size_t)L * D);
    out_m[e] = keep2(dp, mask_key(dp, b, kSiteOut, 0), d, l);
    ff2[e] = keep2(dp, mask_key(dp, b, kSiteFf2, 0), d, l);
  }
  const size_t n_f = (size_t)B * L * F;
  for (size_t e = start; e < n_f; e += stride) {
    const int f = e % F, l = (e / F) % L, b = e / ((size_t)L * F);
    ff[e] = keep2(dp, mask_key(dp, b, kSiteFf, 0), f, l);
  }
}

// The training forward over the N = B*L rows: the QKV tile product rounded
// as the sampling layer rounds it (encoder_layer_tc.cuh), attention on
// mma.sync tiles with the attention-site dropout (layer_attention_fwd), and
// the tail in kMode (encoder_layer_tc.cuh): kTailTrainFwd (B3)
// writes LN2's output to out, kTailTrainBwd (B4's recompute) the residuals
// and LN2's backward to tr. Returns cudaGetLastError() after the last launch.
template <typename T, TailMode kMode>
cudaError_t train_forward(const T* x, const Weights<T>& W, T* out, T* qkv, T* attn,
                          const TailWs<T>& tail_ws, const TailTrain& tr, const TailPlan& tail,
                          int tail_ctas, const AttnFwdPlan& attn_plan, int B, int L, int D,
                          int H, int F, const Dropout& dp, cudaStream_t s) {
  const int N = B * L, D3 = 3 * D;
  cudaError_t err = tc::gemm<T, true, false>(x, D, W.w_qkv, D3, N, D3, D,
                                             tc::round_up(D, tc::kGemmBK), 1,
                                             StoreBiasRounded<T>{qkv, W.b_qkv, D3}, s);
  if (err != cudaSuccess) return err;
  err = layer_attention_fwd<T>(qkv, attn, B, L, D, H, dp, attn_plan, s);
  if (err != cudaSuccess) return err;
  return launch_layer_tail<T, kMode>(x, attn, W, out, N, L, D, F, dp, tail, tail_ctas, tr,
                                     tail_ws, s);
}

#define FDIFF_TRY(expr)                              \
  do {                                               \
    const cudaError_t e_ = (expr);                   \
    if (e_ != cudaSuccess) return (int)e_;           \
  } while (0)

// The backward's launches; events (null, or kBwdStages + 1 events) are
// recorded before the first stage and after each.
template <typename T>
int train_bwd(const T* x, const T* dy, const Weights<T>& W, T* dx, float* grads, float* ws,
              const BwdPlan& p, int B, int L, int D, int H, int F, const Dropout& dp,
              void* const* events, cudaStream_t s) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int N = B * L, D3 = 3 * D;
  auto at = [&](long long off) { return ws + off; };
  auto in_t = [&](long long off) { return reinterpret_cast<T*>(ws + off); };
  // a product's operand: its own T buffer in bf16, the fp32 buffer itself in fp32
  auto op = [&](long long t_off, long long f_off) { return in_t(kBf16 ? t_off : f_off); };
  int stage = 0;
  auto mark = [&]() -> cudaError_t {
    if (events == nullptr) return cudaSuccess;
    return cudaEventRecord(static_cast<cudaEvent_t>(events[stage++]), s);
  };
  float* part = at(p.part);
  const GradOffsets go(D, F);
  const int full = tc::round_up(D3 > F ? D3 : F, tc::kGemmBK);  // k_slice of a whole K
  T* x1t = op(p.x1t, p.x1);
  T* df2t = op(p.df2t, p.df2);
  T* dht = op(p.dht, p.dh);
  T* daot = op(p.daot, p.dao);
  T* dqkvt = op(p.dqkvt, p.dqkv);

  FDIFF_TRY(mark());
  // forward recompute, LN2 backward
  const TailTrain tr{at(p.xhat1), at(p.inv1), at(p.xhat2), at(p.inv2), at(p.g2), at(p.df2),
                     kBf16 ? x1t : nullptr, kBf16 ? df2t : nullptr, dy};
  // (the wide tail's pre and h in dx1 and h, free until later stages)
  const TailWs<T> tail_ws{at(p.x1), at(p.tail_part), at(p.dx1), x1t, in_t(p.h)};
  FDIFF_TRY((train_forward<T, kTailTrainBwd>(x, W, nullptr, in_t(p.qkv), in_t(p.attn), tail_ws,
                                             tr, p.tail, (int)p.tail_ctas, p.attn_fwd, B, L, D,
                                             H, F, dp, s)));
  FDIFF_TRY(mark());
  // the hidden layer and its gradient, in one pass of two products
  FDIFF_TRY((tc::gemm_pair<T, true, false, true>(
      x1t, W.w1, df2t, W.w2, D, F, D, N, F, D,
      HiddenEpi<T>{in_t(p.h), at(p.dh), dht, W.b1, F, L, dp}, s)));
  FDIFF_TRY(mark());
  // FFN weight products per row slice; dx1 = g2 + dh W1^T
  FDIFF_TRY((tc::gemm<T, false, false>(x1t, D, dht, F, D, F, N, (int)p.ks_w1, (int)p.sp_w1,
                                       StorePartial{part + p.p_off[kW1], F, (long)D * F}, s)));
  FDIFF_TRY((tc::gemm<T, false, false>(in_t(p.h), F, df2t, D, F, D, N, (int)p.ks_w2,
                                       (int)p.sp_w2,
                                       StorePartial{part + p.p_off[kW2], D, (long)F * D}, s)));
  FDIFF_TRY((tc::gemm<T, true, true>(dht, F, W.w1, F, N, D, F, (int)p.ks_dx1, (int)p.sp_dx1,
                                     StorePartial{at(p.dx1p), D, (long)N * D}, s)));
  FDIFF_TRY(mark());
  // LN1 backward, out projection
  ln1_bwd_kernel<T><<<(N + 7) / 8, 256, 0, s>>>(at(p.g2), at(p.dx1p), (int)p.sp_dx1, at(p.dx1),
                                                at(p.xhat1), at(p.inv1), W.ln1_s, at(p.da),
                                                at(p.dao), daot, N, L, D, dp);
  FDIFF_TRY(cudaGetLastError());
  FDIFF_TRY((tc::gemm<T, true, true>(daot, D, W.w_out, D, N, D, D, full, 1,
                                     StoreRounded<T>{in_t(p.dattn), D}, s)));
  FDIFF_TRY((tc::gemm<T, false, false>(in_t(p.attn), D, daot, D, D, D, N, (int)p.ks_w_out,
                                       (int)p.sp_w_out,
                                       StorePartial{part + p.p_off[kWOut], D, (long)D * D}, s)));
  FDIFF_TRY(mark());
  // attention backward
  FDIFF_TRY(layer_attention_bwd<T>(in_t(p.qkv), in_t(p.attn), in_t(p.dattn), at(p.dqkv), dqkvt,
                                   at(p.stats), B, L, D, H, dp, p.attn_bwd, s));
  FDIFF_TRY(mark());
  // QKV projection
  FDIFF_TRY((tc::gemm<T, false, false>(x, D, dqkvt, D3, D, D3, N, (int)p.ks_w_qkv,
                                       (int)p.sp_w_qkv,
                                       StorePartial{part + p.p_off[kWQkv], D3, (long)D * D3},
                                       s)));
  FDIFF_TRY((tc::gemm<T, true, true>(dqkvt, D3, W.w_qkv, D3, N, D, D3, full, 1,
                                     AddStore<T>{dx, at(p.da), D}, s)));
  FDIFF_TRY(mark());
  // column sums per row slice, then every partial in slice order
  ColSums jobs{{
      {dy, at(p.xhat2), part + p.p_off[kLn2S], D, kBf16},
      {dy, nullptr, part + p.p_off[kLn2B], D, kBf16},
      {at(p.df2), nullptr, part + p.p_off[kB2], D, 0},
      {at(p.dh), nullptr, part + p.p_off[kB1], F, 0},
      {at(p.dx1), at(p.xhat1), part + p.p_off[kLn1S], D, 0},
      {at(p.dx1), nullptr, part + p.p_off[kLn1B], D, 0},
      {at(p.dao), nullptr, part + p.p_off[kBOut], D, 0},
      {at(p.dqkv), nullptr, part + p.p_off[kBQkv], D3, 0},
  }};
  const int max_cols = F > D3 ? F : D3;
  col_sums_kernel<<<dim3((max_cols + 127) / 128, (int)p.cs_slices, kColSums), 128, 0, s>>>(
      jobs, N, (int)p.cs_rows);
  FDIFF_TRY(cudaGetLastError());
  PartialSets ps;
  for (int k = 0; k < kGrads; ++k) {
    ps.off[k] = p.p_off[k];
    ps.n[k] = p.p_n[k];
  }
  reduce_partials_kernel<<<(go.total + 255) / 256, 256, 0, s>>>(part, grads, ps, D, F);
  FDIFF_TRY(cudaGetLastError());
  return (int)mark();
}

template <typename T>
int train_fwd(const void* x, const void* const* weights, void* out, float* ws, const FwdPlan& p,
              int B, int L, int D, int H, int F, const Dropout& dp, cudaStream_t s) {
  auto in_t = [&](long long off) { return reinterpret_cast<T*>(ws + off); };
  const TailWs<T> tail_ws{ws + p.x1, ws + p.tail_part, ws + p.pre, in_t(p.x1), in_t(p.h)};
  return (int)train_forward<T, kTailTrainFwd>(
      static_cast<const T*>(x), weights_of<T>(weights), static_cast<T*>(out), in_t(p.qkv),
      in_t(p.attn), tail_ws, TailTrain{}, p.tail, (int)p.tail_ctas, p.attn_fwd, B, L, D, H, F,
      dp, s);
}

// The C interface's bodies, one instance per activation type (the fp32
// and bf16 libraries, each its own source so that nvcc builds them side by
// side): the forward and backward of fdiff_train_fwd / fdiff_train_bwd.
template <typename T>
int train_fwd_c(const void* x, const void* const* weights, void* out, void* workspace,
                const void* plan, int B, int L, int D, int H, int F, int group,
                unsigned int seed, unsigned int thr, float scale, void* stream) {
  const Dropout dp{seed, thr, scale, group};
  return train_fwd<T>(x, weights, out, static_cast<float*>(workspace),
                      *static_cast<const FwdPlan*>(plan), B, L, D, H, F, dp,
                      static_cast<cudaStream_t>(stream));
}

template <typename T>
int train_bwd_c(const void* x, const void* dy, const void* const* weights, void* dx,
                void* grads, void* workspace, const void* plan, int B, int L, int D, int H,
                int F, int group, unsigned int seed, unsigned int thr, float scale,
                void* const* events, void* stream) {
  const Dropout dp{seed, thr, scale, group};
  return train_bwd<T>(static_cast<const T*>(x), static_cast<const T*>(dy),
                      weights_of<T>(weights), static_cast<T*>(dx), static_cast<float*>(grads),
                      static_cast<float*>(workspace), *static_cast<const BwdPlan*>(plan), B, L,
                      D, H, F, dp, events, static_cast<cudaStream_t>(stream));
}

}  // namespace
