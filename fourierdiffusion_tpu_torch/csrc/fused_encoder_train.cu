// One post-LN transformer encoder layer in training mode, forward (B3) and
// backward (B4), fp32, for the training path on Hopper (sm_90a).
//
// Replaces the TPU kernels of fourierdiffusion_tpu/ops/fused_encoder_train.py:
//   _train_fwd_kernel (B3): encoder_layer_kernel<float, true> of
//     encoder_layer.cuh, the body the sampling kernel (fused_encoder.cu)
//     runs without dropout, here with the dropout masks at its four sites
//     (attention probabilities, attention output, FFN hidden layer, FFN
//     output). Its numerics, mask hash, layout and bound are described there.
//   _train_bwd_kernel (B4): recomputes that forward from x alone, regenerates
//     the four dropout masks with the same hash, and computes dx and the
//     gradients of the 12 packed weights; the TPU kernel sums the weight
//     gradients over its sequential grid (ref += contrib), which here is a
//     second launch that sums one partial per chain in chain order
//     (reduce_partials_kernel).
//
// Numerics: fp32 throughout, exact max-subtracted softmax, LayerNorm
// statistics in fp32 with eps 1e-5.
//
// Layout: activations (B, L, D) row-major with exactly L rows; weights as
// packed by ops/fused_encoder_train.py (in, out) row-major; the weight
// gradients in the same layout.
//
// Bound: at the flagship's training shape (B 64, L 100, D 72, F 2048, H 12)
// the forward does about 65 MFLOP per chain and the backward about three
// times that (recompute, then two products per forward product); weights
// are 1.3 MB and each chain's x 29 KB, so both are bound by operations on
// the fp32 CUDA cores (no tensor cores in fp32 without TF32).
//
// Design of the backward: one CTA per chain, because dK and dV (and the
// LayerNorm and weight gradients) sum over every row of the chain. LN2's
// input needs the whole f2 = W2 drop(relu(W1 x1)) before any backward step,
// so the FFN runs two chunked passes over d_ff: the first builds f2, the
// second recomputes the hidden chunk and takes its gradients. x1, f2 (then
// dF2) and the two hidden chunks live in shared memory; the other per-chain
// intermediates (qkv, O, the normalised LN inputs, one head's P and dP,
// dqkv, ...) live in a per-chain workspace in device memory that the wrapper
// allocates, small enough to stay in L2. Each CTA writes its chain's weight
// gradients to its own partial; the reduction sums the partials of all
// chains. Where x1 and f2 do not fit beside the hidden chunks in the 227 KB
// a CTA can have (from L=214 at D=72, L=152 at D=128), they move to the
// per-chain workspace too (train_bwd_kernel<false>), and shared memory holds
// only the two hidden chunks.

#include "encoder_layer.cuh"

namespace {

using namespace fdiff;

constexpr int kBwdThreads = 256;
constexpr int kBFC = 64;          // backward: d_ff chunk width

// Products with any operand layout: C[r, n] = epi(r, n, sum_k
// a(r, k) * b(k, n)), 4 x 4 outputs per thread. Out-of-range rows and
// columns are clamped for the loads and skipped at the store.
template <typename FA, typename FB, typename Epi>
__device__ __forceinline__ void gemm(int M, int N, int K, FA a, FB b, Epi epi) {
  const int mt = (M + 3) / 4, nt = (N + 3) / 4;
  for (int item = threadIdx.x; item < mt * nt; item += blockDim.x) {
    const int r0 = (item / nt) * 4, n0 = (item % nt) * 4;
    int rr[4], nn[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      rr[i] = min(r0 + i, M - 1);
      nn[i] = min(n0 + i, N - 1);
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int k = 0; k < K; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a(rr[i], k);
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b(k, nn[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (r0 + i < M && n0 + j < N) epi(r0 + i, n0 + j, acc[i][j]);
  }
}

// LayerNorm of one row held by one warp: returns inv and writes xhat.
__device__ __forceinline__ float ln_row(const float* in, float* xhat, int D, int lane) {
  float s = 0.0f;
  for (int c = lane; c < D; c += 32) s += in[c];
  const float mean = warp_sum(s) / D;
  float v = 0.0f;
  for (int c = lane; c < D; c += 32) {
    const float d = in[c] - mean;
    v += d * d;
  }
  const float inv = rsqrtf(warp_sum(v) / D + kLnEps);
  for (int c = lane; c < D; c += 32) xhat[c] = (in[c] - mean) * inv;
  return inv;
}

// LayerNorm input gradient of one row: dx = inv (g s - mean(g s) - xhat
// mean(g s xhat)), in place over g.
__device__ __forceinline__ void ln_row_bwd(float* g, const float* xhat, float inv,
                                           const float* __restrict__ scale, int D,
                                           int lane) {
  float s1 = 0.0f, s2 = 0.0f;
  for (int c = lane; c < D; c += 32) {
    const float dxh = g[c] * scale[c];
    s1 += dxh;
    s2 += dxh * xhat[c];
  }
  const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
  __syncwarp();
  for (int c = lane; c < D; c += 32) g[c] = inv * (g[c] * scale[c] - m1 - xhat[c] * m2);
}

// ---- B4: training backward -------------------------------------------------------

__host__ __device__ inline int up4(int n) { return (n + 3) / 4 * 4; }

// Whether x1 and f2 fit in shared memory beside the two hidden chunks.
__host__ __device__ inline bool bwd_x1_in_smem(int L, int D) {
  return (2 * L * D + 2 * L * kBFC) * (int)sizeof(float) <= kMaxSmem;
}

// Per-chain workspace in device memory, in floats; x1 and f2 only where
// they are not in shared memory.
struct BwdWs {
  int qkv, attn, xhat1, inv1, xhat2, inv2, dx1, da, dao, dattn, dqkv, p, dp, dcol,
      x1, f2, total;
  __host__ __device__ BwdWs(int L, int D) {
    int o = 0;
    qkv = o;   o += up4(L * 3 * D);
    attn = o;  o += up4(L * D);
    xhat1 = o; o += up4(L * D);
    inv1 = o;  o += up4(L);
    xhat2 = o; o += up4(L * D);
    inv2 = o;  o += up4(L);
    dx1 = o;   o += up4(L * D);
    da = o;    o += up4(L * D);
    dao = o;   o += up4(L * D);
    dattn = o; o += up4(L * D);
    dqkv = o;  o += up4(L * 3 * D);
    p = o;     o += up4(L * L);
    dp = o;    o += up4(L * L);
    dcol = o;  o += up4(L);
    x1 = f2 = 0;
    if (!bwd_x1_in_smem(L, D)) {
      x1 = o;  o += up4(L * D);
      f2 = o;  o += up4(L * D);
    }
    total = o;
  }
};

// Offsets of the 12 gradients in one chain's partial (the packed layout).
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

__host__ __device__ inline int bwd_smem_floats(int L, int D) {
  return (bwd_x1_in_smem(L, D) ? 2 * L * D : 0) + 2 * L * kBFC;
}

// Column sums over the chain's L rows: out[c] = sum_l f(l, c).
template <typename Fn>
__device__ __forceinline__ void col_sums(int L, int N, float* out, Fn f) {
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    float s = 0.0f;
    for (int l = 0; l < L; ++l) s += f(l, c);
    out[c] = s;
  }
}

// One head's softmax probabilities (no dropout) into P (L x L).
__device__ void head_probs(const float* qkv, float* P, int L, int D, int dh, int h) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, n_warps = blockDim.x / 32;
  const int c0 = h * dh;
  gemm(L, L, dh, [&](int i, int k) { return qkv[i * 3 * D + c0 + k]; },
       [&](int k, int j) { return qkv[j * 3 * D + D + c0 + k]; },
       [&](int i, int j, float acc) { P[i * L + j] = acc; });
  __syncthreads();
  for (int i = warp; i < L; i += n_warps) {
    float* row = P + i * L;
    float m = -FLT_MAX;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < L; j += 32) row[j] = row[j] / sum;
  }
  __syncthreads();
}

// kX1Smem: x1 and f2 in shared memory (bwd_x1_in_smem), else in the workspace.
template <bool kX1Smem>
__global__ void __launch_bounds__(kBwdThreads)
train_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                 Weights<float> W, float* __restrict__ dx, float* partials, float* workspace, int L, int D,
                 int H, int F, Dropout dp) {
  extern __shared__ __align__(16) float smem[];
  const BwdWs wl(L, D);
  float* ws = workspace + (size_t)blockIdx.x * wl.total;
  float* x1s = kX1Smem ? smem : ws + wl.x1;         // x1 = LN1 output (L x D)
  float* f2s = kX1Smem ? x1s + L * D : ws + wl.f2;  // f2, then dF2 (L x D)
  float* hs = kX1Smem ? f2s + L * D : smem;  // hidden chunk: h_pre, then drop(relu(h_pre))
  float* dhs = hs + L * kBFC;      // hidden chunk gradient

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, n_warps = blockDim.x / 32;
  const int b = blockIdx.x;
  const int dh = D / H;
  const int D3 = 3 * D;
  const GradOffsets go(D, F);
  float* qkv = ws + wl.qkv;
  float* attn = ws + wl.attn;
  float* xhat1 = ws + wl.xhat1;
  float* inv1 = ws + wl.inv1;
  float* xhat2 = ws + wl.xhat2;
  float* inv2 = ws + wl.inv2;
  float* dx1 = ws + wl.dx1;
  float* da = ws + wl.da;
  float* dao = ws + wl.dao;
  float* dattn = ws + wl.dattn;
  float* dqkv = ws + wl.dqkv;
  float* P = ws + wl.p;
  float* dP = ws + wl.dp;
  float* dcol = ws + wl.dcol;
  float* grad = partials + (size_t)b * go.total;
  const float* xb = x + (size_t)b * L * D;
  const float* dyb = dy + (size_t)b * L * D;
  float* dxb = dx + (size_t)b * L * D;
  const uint32_t key_out = mask_key(dp, b, kSiteOut, 0);
  const uint32_t key_ff = mask_key(dp, b, kSiteFf, 0);
  const uint32_t key_ff2 = mask_key(dp, b, kSiteFf2, 0);

  // ---- recompute the forward ----
  gemm(L, D3, D, [&](int r, int k) { return xb[r * D + k]; },
       [&](int k, int n) { return __ldg(W.w_qkv + k * D3 + n); },
       [&](int r, int n, float acc) { qkv[r * D3 + n] = acc + W.b_qkv[n]; });
  __syncthreads();
  for (int h = 0; h < H; ++h) {
    const int c0 = h * dh, g = h % dp.group;
    const uint32_t key_attn = attn_key(dp, b, h);
    head_probs(qkv, P, L, D, dh, h);
    for (int e = tid; e < L * L; e += blockDim.x)
      P[e] *= keep3(dp, key_attn, g, e / L, e % L);
    __syncthreads();
    gemm(L, dh, L, [&](int i, int j) { return P[i * L + j]; },
         [&](int j, int d) { return qkv[j * D3 + 2 * D + c0 + d]; },
         [&](int i, int d, float acc) { attn[i * D + c0 + d] = acc; });
    __syncthreads();
  }
  gemm(L, D, D, [&](int r, int k) { return attn[r * D + k]; },
       [&](int k, int n) { return __ldg(W.w_out + k * D + n); },
       [&](int r, int n, float acc) {
         xhat1[r * D + n] = xb[r * D + n] + (acc + W.b_out[n]) * keep2(dp, key_out, n, r);
       });
  __syncthreads();
  for (int r = warp; r < L; r += n_warps) {
    const float inv = ln_row(xhat1 + r * D, xhat1 + r * D, D, lane);
    if (lane == 0) inv1[r] = inv;
    __syncwarp();
    for (int c = lane; c < D; c += 32)
      x1s[r * D + c] = xhat1[r * D + c] * W.ln1_s[c] + W.ln1_b[c];
  }
  for (int i = tid; i < L * D; i += blockDim.x) f2s[i] = 0.0f;
  __syncthreads();
  // FFN pass 1: f2 = drop(relu(x1 W1 + b1)) W2, chunk by chunk.
  for (int c = 0; c < F; c += kBFC) {
    const int fc = min(kBFC, F - c);
    gemm(L, fc, D, [&](int r, int k) { return x1s[r * D + k]; },
         [&](int k, int n) { return __ldg(W.w1 + (size_t)k * F + c + n); },
         [&](int r, int n, float acc) {
           hs[r * kBFC + n] = fmaxf(acc + W.b1[c + n], 0.0f) * keep2(dp, key_ff, c + n, r);
         });
    __syncthreads();
    gemm(L, D, fc, [&](int r, int k) { return hs[r * kBFC + k]; },
         [&](int k, int n) { return __ldg(W.w2 + (size_t)(c + k) * D + n); },
         [&](int r, int n, float acc) { f2s[r * D + n] += acc; });
    __syncthreads();
  }
  for (int i = tid; i < L * D; i += blockDim.x) {
    const int r = i / D, n = i % D;
    xhat2[i] = x1s[i] + (f2s[i] + W.b2[n]) * keep2(dp, key_ff2, n, r);
  }
  __syncthreads();

  // ---- LN2 backward, dF2 ----
  for (int r = warp; r < L; r += n_warps) {
    const float inv = ln_row(xhat2 + r * D, xhat2 + r * D, D, lane);
    if (lane == 0) inv2[r] = inv;
    __syncwarp();
    for (int c = lane; c < D; c += 32) dx1[r * D + c] = dyb[r * D + c];
    __syncwarp();
    ln_row_bwd(dx1 + r * D, xhat2 + r * D, inv, W.ln2_s, D, lane);
    __syncwarp();
    for (int c = lane; c < D; c += 32)
      f2s[r * D + c] = dx1[r * D + c] * keep2(dp, key_ff2, c, r);
  }
  __syncthreads();
  col_sums(L, D, grad + go.ln2_s, [&](int l, int c) { return dyb[l * D + c] * xhat2[l * D + c]; });
  col_sums(L, D, grad + go.ln2_b, [&](int l, int c) { return dyb[l * D + c]; });
  col_sums(L, D, grad + go.b2, [&](int l, int c) { return f2s[l * D + c]; });

  // ---- FFN pass 2: the hidden chunk's gradients ----
  for (int c = 0; c < F; c += kBFC) {
    const int fc = min(kBFC, F - c);
    gemm(L, fc, D, [&](int r, int k) { return x1s[r * D + k]; },
         [&](int k, int n) { return __ldg(W.w1 + (size_t)k * F + c + n); },
         [&](int r, int n, float acc) { hs[r * kBFC + n] = acc + W.b1[c + n]; });
    gemm(L, fc, D, [&](int r, int k) { return f2s[r * D + k]; },
         [&](int k, int n) { return __ldg(W.w2 + (size_t)(c + n) * D + k); },
         [&](int r, int n, float acc) { dhs[r * kBFC + n] = acc; });
    __syncthreads();
    for (int e = tid; e < L * fc; e += blockDim.x) {
      const int r = e / fc, n = e % fc;
      const float kf = keep2(dp, key_ff, c + n, r);
      const float hp = hs[r * kBFC + n];
      dhs[r * kBFC + n] = hp > 0.0f ? dhs[r * kBFC + n] * kf : 0.0f;
      hs[r * kBFC + n] = fmaxf(hp, 0.0f) * kf;
    }
    __syncthreads();
    gemm(L, D, fc, [&](int r, int k) { return dhs[r * kBFC + k]; },
         [&](int k, int n) { return __ldg(W.w1 + (size_t)n * F + c + k); },
         [&](int r, int n, float acc) { dx1[r * D + n] += acc; });
    gemm(D, fc, L, [&](int d, int l) { return x1s[l * D + d]; },
         [&](int l, int n) { return dhs[l * kBFC + n]; },
         [&](int d, int n, float acc) { grad[go.w1 + (size_t)d * F + c + n] = acc; });
    gemm(fc, D, L, [&](int f, int l) { return hs[l * kBFC + f]; },
         [&](int l, int n) { return f2s[l * D + n]; },
         [&](int f, int n, float acc) { grad[go.w2 + (size_t)(c + f) * D + n] = acc; });
    col_sums(L, fc, grad + go.b1 + c, [&](int l, int n) { return dhs[l * kBFC + n]; });
    __syncthreads();
  }

  // ---- LN1 backward, out projection ----
  col_sums(L, D, grad + go.ln1_s, [&](int l, int c) { return dx1[l * D + c] * xhat1[l * D + c]; });
  col_sums(L, D, grad + go.ln1_b, [&](int l, int c) { return dx1[l * D + c]; });
  __syncthreads();
  for (int r = warp; r < L; r += n_warps) {
    for (int c = lane; c < D; c += 32) da[r * D + c] = dx1[r * D + c];
    __syncwarp();
    ln_row_bwd(da + r * D, xhat1 + r * D, inv1[r], W.ln1_s, D, lane);
    __syncwarp();
    for (int c = lane; c < D; c += 32) dao[r * D + c] = da[r * D + c] * keep2(dp, key_out, c, r);
  }
  __syncthreads();
  col_sums(L, D, grad + go.b_out, [&](int l, int c) { return dao[l * D + c]; });
  gemm(D, D, L, [&](int i, int l) { return attn[l * D + i]; },
       [&](int l, int n) { return dao[l * D + n]; },
       [&](int i, int n, float acc) { grad[go.w_out + i * D + n] = acc; });
  gemm(L, D, D, [&](int l, int n) { return dao[l * D + n]; },
       [&](int n, int i) { return __ldg(W.w_out + i * D + n); },
       [&](int l, int i, float acc) { dattn[l * D + i] = acc; });
  __syncthreads();

  // ---- attention backward, one head at a time ----
  for (int h = 0; h < H; ++h) {
    const int c0 = h * dh, g = h % dp.group;
    const uint32_t key_attn = attn_key(dp, b, h);
    head_probs(qkv, P, L, D, dh, h);
    for (int i = tid; i < L; i += blockDim.x) {
      float s = 0.0f;
      for (int d = 0; d < dh; ++d) s += dattn[i * D + c0 + d] * attn[i * D + c0 + d];
      dcol[i] = s;
    }
    __syncthreads();
    // dS = P (dP_used * keep - rowsum(dO O)); P becomes P * keep.
    gemm(L, L, dh, [&](int i, int d) { return dattn[i * D + c0 + d]; },
         [&](int d, int j) { return qkv[j * D3 + 2 * D + c0 + d]; },
         [&](int i, int j, float acc) {
           const float kp = keep3(dp, key_attn, g, i, j);
           const float p = P[i * L + j];
           dP[i * L + j] = p * (acc * kp - dcol[i]);
           P[i * L + j] = p * kp;
         });
    __syncthreads();
    gemm(L, dh, L, [&](int i, int j) { return dP[i * L + j]; },
         [&](int j, int d) { return qkv[j * D3 + D + c0 + d]; },
         [&](int i, int d, float acc) { dqkv[i * D3 + c0 + d] = acc; });
    gemm(L, dh, L, [&](int j, int i) { return dP[i * L + j]; },
         [&](int i, int d) { return qkv[i * D3 + c0 + d]; },
         [&](int j, int d, float acc) { dqkv[j * D3 + D + c0 + d] = acc; });
    gemm(L, dh, L, [&](int j, int i) { return P[i * L + j]; },
         [&](int i, int d) { return dattn[i * D + c0 + d]; },
         [&](int j, int d, float acc) { dqkv[j * D3 + 2 * D + c0 + d] = acc; });
    __syncthreads();
  }

  // ---- QKV projection ----
  col_sums(L, D3, grad + go.b_qkv, [&](int l, int n) { return dqkv[l * D3 + n]; });
  gemm(D, D3, L, [&](int d, int l) { return xb[l * D + d]; },
       [&](int l, int n) { return dqkv[l * D3 + n]; },
       [&](int d, int n, float acc) { grad[go.w_qkv + d * D3 + n] = acc; });
  gemm(L, D, D3, [&](int l, int n) { return dqkv[l * D3 + n]; },
       [&](int n, int d) { return __ldg(W.w_qkv + d * D3 + n); },
       [&](int l, int d, float acc) { dxb[l * D + d] = da[l * D + d] + acc; });
}

// out[p] = sum over chains b = 0 .. B-1 of partials[b, p], in chain order.
__global__ void reduce_partials_kernel(const float* __restrict__ partials,
                                       float* __restrict__ out, int B, int P) {
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < P; p += gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int b = 0; b < B; ++b) s += partials[(size_t)b * P + p];
    out[p] = s;
  }
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

}  // namespace

extern "C" {

int fdiff_train_fwd_smem_bytes(int L, int D) { return encoder_layer_smem_bytes(L, D); }

// Floats per chain of the forward's K|V workspace (0: none; encoder_layer.cuh).
int fdiff_train_fwd_kv_floats(int L, int D) { return encoder_layer_kv_floats(L, D); }

int fdiff_train_bwd_smem_bytes(int L, int D) {
  return bwd_smem_floats(L, D) * (int)sizeof(float);
}

// Floats of one chain's backward workspace and of one chain's gradient partial.
int fdiff_train_bwd_workspace_floats(int L, int D) { return BwdWs(L, D).total; }
int fdiff_train_grad_floats(int D, int F) { return GradOffsets(D, F).total; }

// weights: the 12 packed tensors in the order w_qkv, b_qkv, w_out, b_out,
// ln1_s, ln1_b, w1, b1, w2, b2, ln2_s, ln2_b. kv_ws: B x
// fdiff_train_fwd_kv_floats floats (null when that is 0). Returns
// cudaGetLastError() after the launch (0 on success), or the error that
// stopped it before.
int fdiff_train_fwd(const void* x, const void* const* weights, void* out, void* kv_ws,
                    int B, int L, int D, int H, int F, int group, unsigned int seed,
                    unsigned int thr, float scale, void* stream) {
  const Dropout dp{seed, thr, scale, group};
  return launch_encoder_layer<float, true>(x, weights_of<float>(weights), out, kv_ws, B, L,
                                           D, H, F, dp, static_cast<cudaStream_t>(stream));
}

// Backward body (one CTA per chain, partials (B, grad_floats)), then the
// reduction of the partials into grads (grad_floats).
int fdiff_train_bwd(const void* x, const void* dy, const void* const* weights, void* dx,
                    void* partials, void* workspace, void* grads, int B, int L, int D,
                    int H, int F, int group, unsigned int seed, unsigned int thr,
                    float scale, void* stream) {
  const int bytes = fdiff_train_bwd_smem_bytes(L, D);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = bwd_x1_in_smem(L, D) ? train_bwd_kernel<true> : train_bwd_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  auto s = static_cast<cudaStream_t>(stream);
  const Dropout dp{seed, thr, scale, group};
  kernel<<<B, kBwdThreads, bytes, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      weights_of<float>(weights), static_cast<float*>(dx), static_cast<float*>(partials),
      static_cast<float*>(workspace), L, D, H, F, dp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int P = GradOffsets(D, F).total;
  reduce_partials_kernel<<<(P + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partials), static_cast<float*>(grads), B, P);
  return (int)cudaGetLastError();
}

int fdiff_dropout_masks(void* attn, void* out, void* ff, void* ff2, int B, int L, int D,
                        int H, int F, int group, unsigned int seed, unsigned int thr,
                        float scale, void* stream) {
  const Dropout dp{seed, thr, scale, group};
  dropout_masks_kernel<<<264, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(attn), static_cast<float*>(out), static_cast<float*>(ff),
      static_cast<float*>(ff2), B, L, D, H, F, dp);
  return (int)cudaGetLastError();
}

const char* fdiff_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
