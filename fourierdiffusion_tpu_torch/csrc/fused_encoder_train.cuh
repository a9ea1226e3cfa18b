// One post-LN transformer encoder layer in training mode, forward (B3) and
// backward (B4), fp32 and bf16, for the training path on Hopper (sm_90a):
// the kernels and launch sequences, instantiated for fp32 by
// fused_encoder_train.cu and for bf16 by fused_encoder_train_bf16.cu (two
// libraries, so that nvcc builds them side by side).
//
// Replaces the TPU kernels of fourierdiffusion_tpu/ops/fused_encoder_train.py:
//   _train_fwd_kernel (B3): the layer with the dropout masks at its four
//     sites (attention probabilities, attention output, FFN hidden layer,
//     FFN output), in the four launches of encoder_layer_tc.cuh (seven where
//     D is wider than 256): the QKV tile product, attention_fwd_kernel with
//     the attention-site dropout, and the tail in kTailTrainFwd with its
//     finish, which writes LN2's output (train_forward).
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
//   forward   qkv (tile product), attention_fwd_kernel, layer_tail_kernel<kTrain>
//             and tail_finish_kernel<kTrain> (encoder_layer_tc.cuh): x1, the
//             LN statistics, LN2's backward g2 and dF2 = g2 * keep_ff2;
//   hidden    x1 W1 + b1 and dF2 W2^T in one pass -> h = relu * keep and dh;
//   products  dW1 = x1^T dh and dW2 = h^T dF2 per row slice; dh W1^T per
//             d_ff slice;
//   ln1/out   dx1 = g2 + those slices in order; LN1's backward da,
//             dao = da * keep_out; dattn = dao W_out^T;
//             dW_out = O^T dao per row slice;
//   attention two launches per (128 rows, head, chain), no atomics: a thread
//             per query row for dq (and the softmax statistics), then a
//             thread per key for dk and dv;
//   qkv       dW_qkv = x^T dqkv per row slice; dx = da + dqkv W_qkv^T;
//   reduce    column sums (bias and LayerNorm gradients) per row slice, then
//             every partial added in slice order.
// Every sum has one fixed order, so two calls on the same inputs give
// bit-identical results. The plans (the tail's plan and CTAs, row slices,
// workspace offsets) come from the wrapper (ops/fused_encoder_train.py:
// train_fwd_plan, and train_bwd_plan, whose forward stage is the same plan),
// which also holds a plain PyTorch version that follows B4's stages.

#pragma once

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
// the tail's plan and CTAs, workspace offsets in floats (qkv, attn and h
// hold T; in bf16 x1t, df2t, dht, daot and dqkvt hold the product operands
// x1, dF2, dh, dao and dqkv rounded to T, which in fp32 are those buffers
// themselves), the row slices of the four weight products (rows per slice
// ks_, slices sp_), the column sums' rows per slice and slices, and per
// gradient the offset of its partials and their number.
struct BwdPlan {
  TailPlan tail;
  long long tail_ctas;
  long long qkv, attn, x1, xhat1, inv1, xhat2, inv2, g2, df2, h, dh, dx1, da, dao, dattn,
      dqkv, stats, dx1p, x1t, df2t, dht, daot, dqkvt, tail_part, part;
  long long ks_w1, ks_w2, ks_w_out, ks_w_qkv, sp_w1, sp_w2, sp_w_out, sp_w_qkv;
  long long ks_dx1, sp_dx1;  // d_ff slices of dh W1^T
  long long cs_rows, cs_slices;
  long long p_off[kGrads], p_n[kGrads];
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
};

__device__ __forceinline__ void chain_of(int m, int L, int& b, int& l) {
  b = m / L;
  l = m - b * L;
}

// ---- epilogues of the tile products ----------------------------------------------------

struct StoreF {  // out[m, n] = v
  float* out; int ld;
  __device__ void operator()(int m, int n, float v) const { out[(long)m * ld + n] = v; }
};

template <typename T>
struct AddStore {  // out[m, n] = round_T(add[m, n] + v)
  T* out; const float* add; int ld;
  __device__ void operator()(int m, int n, float v) const {
    out[(long)m * ld + n] = from_f<T>(add[(long)m * ld + n] + v);
  }
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

// ---- attention backward ---------------------------------------------------------------------

// Query rows (or keys) per block of operands staged in shared memory (fp32):
// 16 KB of rows of `floats` each.
__host__ __device__ constexpr int rows_per_block(int floats) { return 16 * 1024 / (4 * floats); }

// dq: grid (ceil(L / 128), H, B), a thread per query row i with K and V of
// its chain and head staged a block of keys at a time: the softmax
// statistics (max, sum), dcol_i = dO_i . O_i and dq_i = sum_j dS_ij k_j with
// dS = round_T(P (dP keep - dcol)), dP = dO V^T and dO = round_T(dattn).
// In fp32 O is the forward's attn; in bf16 it is recomputed unrounded, O_i
// = sum_j round_T(P_ij keep_ij) v_j, as the TPU kernel takes it. stats
// (N x H x 3) keeps max, sum and dcol for the dk/dv kernel; dq goes to dqkv
// (fp32) and, in bf16, rounded to dqkvt.
template <typename T, int kDh>
__global__ void __launch_bounds__(kAttnThreads)
attention_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ attn,
                        const float* __restrict__ dattn, float* __restrict__ dqkv,
                        T* __restrict__ dqkvt, float* __restrict__ stats, int L, int D, int H,
                        Dropout dp) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int KB = rows_per_block(2 * kDh);
  __shared__ float sK[KB * kDh], sV[KB * kDh];
  const int i = blockIdx.x * kAttnThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const bool active = i < L;
  const int dh = D / H, c0 = h * dh, D3 = 3 * D;
  const size_t row0 = (size_t)b * L;
  const T* base = qkv + row0 * D3;
  const uint32_t key = attn_key(dp, b, h);
  const int g = h % dp.group;
  float q[kDh], dO[kDh], acc[kDh];
  float dcol = 0.0f;
#pragma unroll
  for (int d = 0; d < kDh; ++d) {
    q[d] = (active && d < dh) ? to_f(base[(size_t)i * D3 + c0 + d]) : 0.0f;
    dO[d] = (active && d < dh) ? round_to<T>(dattn[(row0 + i) * D + c0 + d]) : 0.0f;
    if (!kBf16 && active && d < dh) dcol = fmaf(dO[d], to_f(attn[(row0 + i) * D + c0 + d]), dcol);
    acc[d] = 0.0f;
  }
  auto for_keys = [&](auto f) {
    for (int j0 = 0; j0 < L; j0 += KB) {
      const int nb = min(KB, L - j0);
      __syncthreads();
      for (int e = threadIdx.x; e < nb * kDh; e += kAttnThreads) {
        const int j = e / kDh, d = e % kDh;
        const T* row = base + (size_t)(j0 + j) * D3 + c0 + d;
        sK[e] = d < dh ? to_f(row[D]) : 0.0f;
        sV[e] = d < dh ? to_f(row[2 * D]) : 0.0f;
      }
      __syncthreads();
      if (active)
        for (int j = 0; j < nb; ++j) {
          float sc = 0.0f;
#pragma unroll
          for (int d = 0; d < kDh; ++d)
            if (d < dh) sc = fmaf(q[d], sK[j * kDh + d], sc);
          f(j0 + j, j, sc);
        }
    }
  };
  float m = -FLT_MAX;
  for_keys([&](int, int, float sc) { m = fmaxf(m, sc); });
  float sum = 0.0f;
  for_keys([&](int, int, float sc) { sum += expf(sc - m); });
  if constexpr (kBf16) {  // O in fp32 (in acc), then dcol
    for_keys([&](int j, int jl, float sc) {
      const float pk = round_to<T>(expf(sc - m) / sum * keep3<true>(dp, key, g, i, j));
#pragma unroll
      for (int d = 0; d < kDh; ++d)
        if (d < dh) acc[d] = fmaf(pk, sV[jl * kDh + d], acc[d]);
    });
#pragma unroll
    for (int d = 0; d < kDh; ++d) {
      if (d < dh) dcol = fmaf(dO[d], acc[d], dcol);
      acc[d] = 0.0f;
    }
  }
  for_keys([&](int j, int jl, float sc) {
    const float p = expf(sc - m) / sum;
    float dpv = 0.0f;
#pragma unroll
    for (int d = 0; d < kDh; ++d)
      if (d < dh) dpv = fmaf(dO[d], sV[jl * kDh + d], dpv);
    const float ds = round_to<T>(p * (dpv * keep3<true>(dp, key, g, i, j) - dcol));
#pragma unroll
    for (int d = 0; d < kDh; ++d)
      if (d < dh) acc[d] = fmaf(ds, sK[jl * kDh + d], acc[d]);
  });
  if (!active) return;
  float* out = dqkv + (row0 + i) * D3 + c0;
#pragma unroll
  for (int d = 0; d < kDh; ++d)
    if (d < dh) {
      out[d] = acc[d];
      if constexpr (kBf16) dqkvt[(row0 + i) * D3 + c0 + d] = from_f<T>(acc[d]);
    }
  float* st = stats + ((row0 + i) * H + h) * 3;
  st[0] = m;
  st[1] = sum;
  st[2] = dcol;
}

// dk and dv: grid (ceil(L / 128), H, B), a thread per key j with Q, dO and
// the statistics of its chain and head staged a block of query rows at a
// time: dk_j = sum_i dS_ij q_i, dv_j = sum_i round_T(P_ij keep_ij) dO_i,
// to dqkv (fp32) and, in bf16, rounded to dqkvt.
template <typename T, int kDh>
__global__ void __launch_bounds__(kAttnThreads)
attention_bwd_dkv_kernel(const T* __restrict__ qkv, const float* __restrict__ dattn,
                         float* __restrict__ dqkv, T* __restrict__ dqkvt,
                         const float* __restrict__ stats, int L, int D, int H, Dropout dp) {
  constexpr int kRow = 2 * kDh + 3;
  constexpr int QB = rows_per_block(kRow);
  __shared__ float sQ[QB * kRow];
  const int j = blockIdx.x * kAttnThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const bool active = j < L;
  const int dh = D / H, c0 = h * dh, D3 = 3 * D;
  const size_t row0 = (size_t)b * L;
  const T* base = qkv + row0 * D3;
  const uint32_t key = attn_key(dp, b, h);
  const int g = h % dp.group;
  float k[kDh], v[kDh], dk[kDh], dv[kDh];
#pragma unroll
  for (int d = 0; d < kDh; ++d) {
    k[d] = (active && d < dh) ? to_f(base[(size_t)j * D3 + D + c0 + d]) : 0.0f;
    v[d] = (active && d < dh) ? to_f(base[(size_t)j * D3 + 2 * D + c0 + d]) : 0.0f;
    dk[d] = dv[d] = 0.0f;
  }
  for (int i0 = 0; i0 < L; i0 += QB) {
    const int nb = min(QB, L - i0);
    __syncthreads();
    for (int e = threadIdx.x; e < nb * kRow; e += kAttnThreads) {
      const int i = e / kRow, c = e % kRow;
      const size_t r = row0 + i0 + i;
      float val = 0.0f;
      if (c < kDh)
        val = c < dh ? to_f(base[(size_t)(i0 + i) * D3 + c0 + c]) : 0.0f;
      else if (c < 2 * kDh)
        val = c - kDh < dh ? round_to<T>(dattn[r * D + c0 + c - kDh]) : 0.0f;
      else
        val = stats[(r * H + h) * 3 + c - 2 * kDh];
      sQ[e] = val;
    }
    __syncthreads();
    if (active)
      for (int i = 0; i < nb; ++i) {
        const float* qi = sQ + i * kRow;
        const float* dOi = qi + kDh;
        const float* st = dOi + kDh;
        float sc = 0.0f, dpv = 0.0f;
#pragma unroll
        for (int d = 0; d < kDh; ++d)
          if (d < dh) {
            sc = fmaf(qi[d], k[d], sc);
            dpv = fmaf(dOi[d], v[d], dpv);
          }
        const float p = expf(sc - st[0]) / st[1];
        const float kp = keep3<true>(dp, key, g, i0 + i, j);
        const float ds = round_to<T>(p * (dpv * kp - st[2]));
        const float pk = round_to<T>(p * kp);
#pragma unroll
        for (int d = 0; d < kDh; ++d)
          if (d < dh) {
            dk[d] = fmaf(ds, qi[d], dk[d]);
            dv[d] = fmaf(pk, dOi[d], dv[d]);
          }
      }
  }
  if (!active) return;
  const size_t o = (row0 + j) * D3 + c0;
#pragma unroll
  for (int d = 0; d < kDh; ++d)
    if (d < dh) {
      dqkv[o + D + d] = dk[d];
      dqkv[o + 2 * D + d] = dv[d];
      if constexpr (sizeof(T) == 2) {
        dqkvt[o + D + d] = from_f<T>(dk[d]);
        dqkvt[o + 2 * D + d] = from_f<T>(dv[d]);
      }
    }
}

template <typename T, int kDh>
cudaError_t attention_bwd(const T* qkv, const T* attn, const float* dattn, float* dqkv,
                          T* dqkvt, float* stats, int B, int L, int D, int H, const Dropout& dp,
                          cudaStream_t s) {
  const dim3 grid((L + kAttnThreads - 1) / kAttnThreads, H, B);
  attention_bwd_dq_kernel<T, kDh><<<grid, kAttnThreads, 0, s>>>(qkv, attn, dattn, dqkv, dqkvt,
                                                                stats, L, D, H, dp);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkv_kernel<T, kDh><<<grid, kAttnThreads, 0, s>>>(qkv, dattn, dqkv, dqkvt, stats,
                                                                 L, D, H, dp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_attention_bwd(const T* qkv, const T* attn, const float* dattn, float* dqkv,
                                 T* dqkvt, float* stats, int B, int L, int D, int H,
                                 const Dropout& dp, cudaStream_t s) {
  const int dh = D / H;
  if (dh <= 8) return attention_bwd<T, 8>(qkv, attn, dattn, dqkv, dqkvt, stats, B, L, D, H, dp, s);
  if (dh <= 16)
    return attention_bwd<T, 16>(qkv, attn, dattn, dqkv, dqkvt, stats, B, L, D, H, dp, s);
  if (dh <= 32)
    return attention_bwd<T, 32>(qkv, attn, dattn, dqkv, dqkvt, stats, B, L, D, H, dp, s);
  if (dh <= 64)
    return attention_bwd<T, 64>(qkv, attn, dattn, dqkv, dqkvt, stats, B, L, D, H, dp, s);
  if (dh <= 384)
    return attention_bwd<T, 384>(qkv, attn, dattn, dqkv, dqkvt, stats, B, L, D, H, dp, s);
  return cudaErrorInvalidValue;
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

// The training forward over the N = B*L rows (encoder_layer_tc.cuh): the
// QKV tile product rounded as the sampling layer rounds it, attention with
// the attention-site dropout, and the tail in kMode: kTailTrainFwd (B3)
// writes LN2's output to out, kTailTrainBwd (B4's recompute) the residuals
// and LN2's backward to tr. Returns cudaGetLastError() after the last launch.
template <typename T, TailMode kMode>
cudaError_t train_forward(const T* x, const Weights<T>& W, T* out, T* qkv, T* attn,
                          const TailWs<T>& tail_ws, const TailTrain& tr, const TailPlan& tail,
                          int tail_ctas, int B, int L, int D, int H, int F, const Dropout& dp,
                          cudaStream_t s) {
  const int N = B * L, D3 = 3 * D;
  cudaError_t err = tc::gemm<T, true, false>(x, D, W.w_qkv, D3, N, D3, D,
                                             tc::round_up(D, tc::kGemmBK), 1,
                                             StoreBiasRounded<T>{qkv, W.b_qkv, D3}, s);
  if (err != cudaSuccess) return err;
  err = launch_attention_fwd<T, true>(qkv, attn, B, L, D, H, dp, s);
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
                                             tr, p.tail, (int)p.tail_ctas, B, L, D, H, F, dp,
                                             s)));
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
                                     StoreF{at(p.dattn), D}, s)));
  FDIFF_TRY((tc::gemm<T, false, false>(in_t(p.attn), D, daot, D, D, D, N, (int)p.ks_w_out,
                                       (int)p.sp_w_out,
                                       StorePartial{part + p.p_off[kWOut], D, (long)D * D}, s)));
  FDIFF_TRY(mark());
  // attention backward
  FDIFF_TRY(launch_attention_bwd<T>(in_t(p.qkv), in_t(p.attn), at(p.dattn), at(p.dqkv), dqkvt,
                                    at(p.stats), B, L, D, H, dp, s));
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
      in_t(p.attn), tail_ws, TailTrain{}, p.tail, (int)p.tail_ctas, B, L, D, H, F, dp, s);
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
