// One whole post-LN transformer encoder layer with W8A8 int8 products in one
// kernel launch, for the opt-in int8 sampling path on Hopper (sm_90a).
//
// Replaces two TPU kernels of fourierdiffusion_tpu/ops/fused_encoder.py:
//   _encoder_layer_kernel_int8 (B7, FDIFF_FUSED_INT8=1):
//     encoder_layer_int8_kernel<T, false, *>: attention and LN1 with the
//     sampling layer's (B1's) rounding points, but x1 stays fp32; then the
//     W8A8 FFN (_ffn_int8).
//   _encoder_layer_kernel_int8_attn (B8, FDIFF_FUSED_INT8=2):
//     encoder_layer_int8_kernel<T, true, *>: the QKV, PV and out-projection
//     products in int8 too (_attention_ln1_int8); the S product stays in the
//     activation dtype. Then the same FFN.
//
// Quantization (ops/fused_encoder.py quantize_along, bit for bit): over a
// slice, scale = max(absmax, 1e-12) * fp32(1/127) and
// code = clamp(rint(v * (1/scale)), -127, 127), the reciprocal correctly
// rounded and the rounding half to even. Weights carry one fp32 scale per
// output row (packed once); activations are quantized on the fly:
//   B7/B8 FFN: x1 per token (over D); for each hidden chunk of kChunk = 512
//     units (the TPU kernel's _INT8_FFN_CHUNK; the last may be shorter)
//     h = relu(int32(W1q_c . qx) * (w1_s * s_x) + b1) is quantized per
//     (chunk, token), and f += int32(W2q_c . qh) * (w2_s * s_h).
//   B8 attention: x per token; qkv_f = int32(Wqkv_q . qx) * (w_s * s_x) + b
//     in fp32; q and k rounded to T; V quantized per (chain, column) over
//     the chain's L keys; P (fp32, unrounded) per (head, query) over the
//     keys; O = int32(qP . qV) * (s_v * s_p) quantized per token over D.
// Integer products are exact (__dp4a, int32 sums: |sum| <= K * 127^2, 8.3 M
// at K=512), so the kernel and the plain version differ only where their
// fp32 inputs to a quantization differ. Dequantization multiplies and adds
// with __fmul_rn/__fadd_rn in the TPU kernel's order (no fused multiply-add).
// The rest follows B1: fp32 LayerNorm statistics (eps 1e-5), exact softmax
// in fp32 and the max-free one in bf16, y rounded to T.
//
// Probe: where the caller passes code buffers (int8, null to skip), the
// kernel also writes the codes of every quantization site: x (B, L, D; B8),
// v (B, L, D; B8, by the first row tile of each chain), p (B, H, L, L; B8),
// o (B, L, D; B8), x1 (B, L, D) and h (B, L, F). chip_smoke.py locates with
// them every code that differs from the plain version's.
//
// Layout: activations (B, L, D) with exactly L rows. B7's attention weights
// are B1's ((in, out) in T); every int8 matrix is (out, in) row-major, so a
// thread reads 8 codes of one contraction as one 64-bit word; the
// contractions (D, the chunk, the keys padded with zero codes to a multiple
// of 8) are multiples of 8.
//
// Bound: at the flagship shape (L 100, D 72, F 2048, H 12) the FFN's int8
// products are 59 M of the layer's 66 M multiply-adds per chain, and the
// weights (0.33 MB of codes and scales) are shared by all chains, so the
// layer is bound by operations. This first version runs the int8 products
// on the CUDA cores' __dp4a (no int8 tensor-core mma or wgmma yet) and the
// rest on the CUDA cores (encoder_layer.cuh's matmul): one CTA per (32-row
// tile, chain) keeps
// its rows, the chain's K|V (and for B8 V's codes) and one FFN chunk (h in
// fp32, then its codes: 80 KB) in shared memory. Where that plan does not fit
// (at D=72 from L=192 for B7 and L=161 for B8; at D=128 from L=79 and 67), a
// first launch writes each chain's K|V (B8: K rounded, V in fp32) to a
// (B, L, 2D) device workspace (kv_proj_kernel for B7), and every CTA reads the whole
// chain's V from there for its scales. No two CTAs write one element.

#include "encoder_layer.cuh"

namespace {

using namespace fdiff;

constexpr int kChunk = 512;                         // FFN hidden chunk (numerics)
constexpr float kInv127 = (float)(1.0 / 127.0);     // fp32(1/127), as JAX's constant
constexpr float kAbsFloor = 1e-12f;

// Weights: B7 uses w_qkv/w_out in T ((in, out)); B8 uses the int8 ones.
template <typename T>
struct Int8Weights {
  const T* w_qkv; const int8_t* w_qkv_q; const float* w_qkv_s; const float* b_qkv;
  const T* w_out; const int8_t* w_out_q; const float* w_out_s; const float* b_out;
  const float* ln1_s; const float* ln1_b;
  const int8_t* w1_q; const float* w1_s; const float* b1;
  const int8_t* w2_q; const float* w2_s; const float* b2;
  const float* ln2_s; const float* ln2_b;
};

struct Probe {
  int8_t* x; int8_t* v; int8_t* p; int8_t* o; int8_t* x1; int8_t* h;
};

__device__ __forceinline__ float quant_scale(float absmax) {
  return __fmul_rn(fmaxf(absmax, kAbsFloor), kInv127);
}

__device__ __forceinline__ int8_t quant_code(float v, float inv) {
  const float t = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.0f), 127.0f);
  return (int8_t)__float2int_rn(t);
}

// acc * (ws * sx) + b without contraction, in the TPU kernel's order.
__device__ __forceinline__ float dequant(int acc, float ws, float sx, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), __fmul_rn(ws, sx)), b);
}

// Quantize `rows` rows of n fp32 values (row stride lds floats) to codes
// (row stride ldq bytes), one warp per row; the row's scale to scale[r]; the
// codes also to probe row r (stride ldp) where probe is not null.
__device__ __forceinline__ void quantize_rows(const float* src, int lds, int rows, int n,
                                              int8_t* dst, int ldq, float* scale,
                                              int8_t* probe, size_t ldp) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += blockDim.x / 32) {
    const float* row = src + r * lds;
    float m = 0.0f;
    for (int c = lane; c < n; c += 32) m = fmaxf(m, fabsf(row[c]));
    const float s = quant_scale(warp_max(m));
    const float inv = __frcp_rn(s);
    for (int c = lane; c < n; c += 32) {
      const int8_t q = quant_code(row[c], inv);
      dst[r * ldq + c] = q;
      if (probe != nullptr) probe[r * ldp + c] = q;
    }
    if (lane == 0) scale[r] = s;
  }
}

// C[r, n] = epi(r, n, sum_k A[r, k] * B[n, k]) in int32 for r < M, n < N.
// A: codes in shared memory, row stride lda bytes, readable (zero) for rows
// up to round_up(M, kRM). B: global codes (N, K) row-major, row stride ldb
// bytes. K, lda and ldb are multiples of 8, A and B 8-byte aligned.
template <typename Epi>
__device__ __forceinline__ void imatmul(const int8_t* __restrict__ A, int lda, int M,
                                        const int8_t* __restrict__ B, int ldb, int N, int K,
                                        Epi epi) {
  const int groups = (M + kRM - 1) / kRM;
  for (int item = threadIdx.x; item < groups * N; item += blockDim.x) {
    const int n = item % N;
    const int r0 = (item / N) * kRM;
    int acc[kRM];
#pragma unroll
    for (int i = 0; i < kRM; ++i) acc[i] = 0;
    const int2* b = reinterpret_cast<const int2*>(B + (size_t)n * ldb);
    for (int k = 0; k < K / 8; ++k) {
      const int2 w = __ldg(b + k);
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const int2 a = *reinterpret_cast<const int2*>(A + (r0 + i) * lda + 8 * k);
        acc[i] = __dp4a(a.x, w.x, acc[i]);
        acc[i] = __dp4a(a.y, w.y, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRM; ++i)
      if (r0 + i < M) epi(r0 + i, n, acc[i]);
  }
}

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Shared-memory plan, in floats (every buffer starts on 16 bytes).
struct SmemI8 {
  int lp8, region, kvs;
  int off_kv, off_xs, off_q, off_o, off_x1, off_qa, off_sc;
  int off_sxall, off_sv, off_qvt, off_qp, total;
  __host__ __device__ SmemI8(int L, int D, bool attn8, bool kv_in_smem) {
    lp8 = round_up(L, kRM);
    int r = 0;
    if (kv_in_smem) r = attn8 ? lp8 * D / 4 : lp8 * D;  // whole-chain x: codes or fp32
    if (kTM * L > r) r = kTM * L;                         // one head's scores
    if (kTM * kChunk + kTM * kChunk / 4 > r) r = kTM * kChunk + kTM * kChunk / 4;  // h, qh
    region = r;
    kvs = 2 * D + 1;
    off_kv = region;                                      // K | V, L x kvs
    off_xs = kv_in_smem ? round_up(off_kv + L * kvs, 4) : region;  // own rows of x
    off_q = off_xs + kTM * D;                             // q, later the FFN2 sum
    off_o = off_q + kTM * D;                              // attention output
    off_x1 = off_o + kTM * D;                             // pre-LN1, then x1
    off_qa = off_x1 + kTM * D;                            // kTM x D codes (x, O or x1)
    off_sc = off_qa + kTM * D / 4;                        // 4 x kTM row scales
    off_sxall = off_sc + 4 * kTM;                         // B8: x scales of every row
    off_sv = off_sxall + (attn8 && kv_in_smem ? lp8 : 0); // B8: V scales, D
    off_qvt = off_sv + (attn8 ? round_up(D, 4) : 0);      // B8: V codes, D x lp8
    off_qp = off_qvt + (attn8 ? D * lp8 / 4 : 0);         // B8: P codes, kTM x lp8
    total = off_qp + (attn8 ? kTM * lp8 / 4 : 0);
  }
};

template <typename T, bool kAttn8, bool kKvGlobal>
__global__ void __launch_bounds__(kThreads)
encoder_layer_int8_kernel(const T* __restrict__ x, const Int8Weights<T> w,
                          T* __restrict__ out, const float* kv_ws, const Probe probe,
                          int L, int D, int H, int F) {
  constexpr bool kFast = sizeof(T) == 2;
  extern __shared__ __align__(16) float smem[];
  const SmemI8 lay(L, D, kAttn8, !kKvGlobal);
  float* xall = smem;                               // B7, phases 1-2
  int8_t* qxall = reinterpret_cast<int8_t*>(smem);  // B8, phases 1-2
  float* ph = smem;                                 // scores; FFN hidden chunk
  int8_t* qh = reinterpret_cast<int8_t*>(smem + kTM * kChunk);
  const int kvs = kKvGlobal ? 2 * D : lay.kvs;
  const float* kv = kKvGlobal ? kv_ws + (size_t)blockIdx.y * L * 2 * D : smem + lay.off_kv;
  float* kv_s = smem + lay.off_kv;                  // writable K|V (shared plan)
  float* xs = smem + lay.off_xs;
  float* q = smem + lay.off_q;
  float* fsum = q;
  float* o = smem + lay.off_o;
  float* x1 = smem + lay.off_x1;
  int8_t* qa = reinterpret_cast<int8_t*>(smem + lay.off_qa);
  float* s_a = smem + lay.off_sc;                   // scales of qa's rows
  float* s_h = s_a + kTM;
  float* s_p = s_h + kTM;
  float* sxall = smem + lay.off_sxall;
  float* s_v = smem + lay.off_sv;
  int8_t* qvt = reinterpret_cast<int8_t*>(smem + lay.off_qvt);
  int8_t* qp = reinterpret_cast<int8_t*>(smem + lay.off_qp);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, n_warps = blockDim.x / 32;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kTM;
  const int rows = min(kTM, L - row0);
  const int dh = D / H;
  const int lp8 = lay.lp8;
  const T* xb = x + (size_t)b * L * D;
  const size_t tok0 = (size_t)b * L + row0;         // first token of this tile

  // Phase 1: zero shared memory (padding rows and codes stay 0), load x.
  for (int i = tid; i < lay.total; i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();
  if constexpr (!kKvGlobal && !kAttn8)
    for (int i = tid; i < L * D; i += blockDim.x) xall[i] = to_f(xb[i]);
  for (int i = tid; i < rows * D; i += blockDim.x) xs[i] = to_f(xb[row0 * D + i]);
  __syncthreads();

  // Phase 2: q of this tile's rows; K, V of every row (kKvGlobal: written by
  // the first launch).
  if constexpr (kAttn8) {
    // x per token: every row into qxall (shared plan), else this tile's rows.
    int8_t* px = probe.x == nullptr ? nullptr : probe.x + tok0 * D;
    if constexpr (!kKvGlobal) {
      for (int r = warp; r < L; r += n_warps) {
        const T* row = xb + (size_t)r * D;
        float m = 0.0f;
        for (int c = lane; c < D; c += 32) m = fmaxf(m, fabsf(to_f(row[c])));
        const float s = quant_scale(warp_max(m));
        const float inv = __frcp_rn(s);
        for (int c = lane; c < D; c += 32) {
          const int8_t code = quant_code(to_f(row[c]), inv);
          qxall[r * D + c] = code;
          if (px != nullptr && r >= row0 && r < row0 + rows) px[(r - row0) * D + c] = code;
        }
        if (lane == 0) sxall[r] = s;
      }
    } else {
      quantize_rows(xs, D, rows, D, qa, D, s_a, px, D);
    }
    __syncthreads();
    const int8_t* qxs = kKvGlobal ? qa : qxall + row0 * D;
    const float* sxs = kKvGlobal ? s_a : sxall + row0;
    if constexpr (!kKvGlobal)
      imatmul(qxall, D, L, w.w_qkv_q + (size_t)D * D, D, 2 * D, D, [&](int r, int n, int acc) {
        const float v = dequant(acc, w.w_qkv_s[D + n], sxall[r], w.b_qkv[D + n]);
        kv_s[r * kvs + n] = n < D ? round_to<T>(v) : v;
      });
    imatmul(qxs, D, rows, w.w_qkv_q, D, D, D, [&](int r, int n, int acc) {
      q[r * D + n] = round_to<T>(dequant(acc, w.w_qkv_s[n], sxs[r], w.b_qkv[n]));
    });
    __syncthreads();
    // V's codes per (chain, column) over the L keys, transposed: qvt[c][j].
    for (int c = warp; c < D; c += n_warps) {
      const float* vc = kv + D + c;
      float m = 0.0f;
      for (int j = lane; j < L; j += 32) m = fmaxf(m, fabsf(vc[(size_t)j * kvs]));
      const float s = quant_scale(warp_max(m));
      const float inv = __frcp_rn(s);
      for (int j = lane; j < L; j += 32) {
        const int8_t code = quant_code(vc[(size_t)j * kvs], inv);
        qvt[c * lp8 + j] = code;
        if (probe.v != nullptr && blockIdx.x == 0) probe.v[((size_t)b * L + j) * D + c] = code;
      }
      if (lane == 0) s_v[c] = s;
    }
  } else {
    if constexpr (!kKvGlobal)
      matmul(xall, D, L, w.w_qkv + D, 3 * D, 2 * D, D, [&](int r, int n, float acc) {
        kv_s[r * kvs + n] = round_to<T>(acc + w.b_qkv[D + n]);
      });
    matmul(xs, D, rows, w.w_qkv, 3 * D, D, D, [&](int r, int n, float acc) {
      q[r * D + n] = round_to<T>(acc + w.b_qkv[n]);
    });
  }
  __syncthreads();

  // Phase 3: attention, one head at a time.
  for (int h = 0; h < H; ++h) {
    const int c0 = h * dh;
    for (int item = tid; item < rows * L; item += blockDim.x) {
      const int i = item / L, j = item % L;
      const float* qi = q + i * D + c0;
      const float* kj = kv + (size_t)j * kvs + c0;
      float s = 0.0f;
      for (int d = 0; d < dh; ++d) s = fmaf(qi[d], kj[d], s);
      ph[i * L + j] = s;
    }
    __syncthreads();
    for (int i = warp; i < rows; i += n_warps) {
      float* srow = ph + i * L;
      float scale;
      if (kFast) {
        float sum = 0.0f;
        for (int j = lane; j < L; j += 32) {
          const float e = __expf(fminf(fmaxf(srow[j], -kScoreClamp), kScoreClamp));
          srow[j] = e;
          sum += e;
        }
        const float inv = __fdividef(1.0f, warp_sum(sum));
        for (int j = lane; j < L; j += 32)
          srow[j] = kAttn8 ? srow[j] * inv : round_to<T>(srow[j] * inv);
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
      if constexpr (kAttn8) {  // P per (head, query) over the keys
        float m = 0.0f;
        for (int j = lane; j < L; j += 32) m = fmaxf(m, fabsf(srow[j]));
        scale = quant_scale(warp_max(m));
        const float inv = __frcp_rn(scale);
        int8_t* pp = probe.p == nullptr
                         ? nullptr
                         : probe.p + (((size_t)b * H + h) * L + row0 + i) * L;
        for (int j = lane; j < L; j += 32) {
          const int8_t code = quant_code(srow[j], inv);
          qp[i * lp8 + j] = code;
          if (pp != nullptr) pp[j] = code;
        }
        if (lane == 0) s_p[i] = scale;
      }
    }
    __syncthreads();
    if constexpr (kAttn8) {
      for (int item = tid; item < rows * dh; item += blockDim.x) {
        const int i = item / dh, c = c0 + item % dh;
        const int2* pi = reinterpret_cast<const int2*>(qp + i * lp8);
        const int2* vc = reinterpret_cast<const int2*>(qvt + c * lp8);
        int acc = 0;
        for (int k = 0; k < lp8 / 8; ++k) {
          const int2 a = pi[k], v = vc[k];
          acc = __dp4a(a.x, v.x, acc);
          acc = __dp4a(a.y, v.y, acc);
        }
        o[i * D + c] = __fmul_rn(__int2float_rn(acc), __fmul_rn(s_v[c], s_p[i]));
      }
    } else {
      for (int item = tid; item < rows * dh; item += blockDim.x) {
        const int i = item / dh, d = item % dh;
        const float* pi = ph + i * L;
        const float* vj = kv + D + c0 + d;
        float acc = 0.0f;
        for (int j = 0; j < L; ++j) acc = fmaf(pi[j], vj[(size_t)j * kvs], acc);
        o[i * D + c0 + d] = round_to<T>(acc);
      }
    }
    __syncthreads();
  }

  // Phase 4: out projection, residual, LN1 in fp32 (x1 is not rounded).
  if constexpr (kAttn8) {
    quantize_rows(o, D, rows, D, qa, D, s_a,
                  probe.o == nullptr ? nullptr : probe.o + tok0 * D, D);
    __syncthreads();
    imatmul(qa, D, rows, w.w_out_q, D, D, D, [&](int r, int n, int acc) {
      x1[r * D + n] = __fadd_rn(xs[r * D + n], dequant(acc, w.w_out_s[n], s_a[r], w.b_out[n]));
    });
  } else {
    matmul(o, D, rows, w.w_out, D, D, D, [&](int r, int n, float acc) {
      x1[r * D + n] = xs[r * D + n] + (acc + w.b_out[n]);
    });
  }
  for (int i = tid; i < kTM * D; i += blockDim.x) fsum[i] = 0.0f;
  __syncthreads();
  layer_norm_rows<float>(x1, rows, D, w.ln1_s, w.ln1_b);
  __syncthreads();

  // Phase 5: the W8A8 FFN, d_ff in chunks of kChunk.
  quantize_rows(x1, D, rows, D, qa, D, s_a,
                probe.x1 == nullptr ? nullptr : probe.x1 + tok0 * D, D);
  __syncthreads();
  for (int c = 0; c < F; c += kChunk) {
    const int fc = min(kChunk, F - c);
    imatmul(qa, D, rows, w.w1_q + (size_t)c * D, D, fc, D, [&](int r, int n, int acc) {
      ph[r * kChunk + n] = fmaxf(dequant(acc, w.w1_s[c + n], s_a[r], w.b1[c + n]), 0.0f);
    });
    __syncthreads();
    quantize_rows(ph, kChunk, rows, fc, qh, kChunk, s_h,
                  probe.h == nullptr ? nullptr : probe.h + tok0 * F + c, F);
    __syncthreads();
    imatmul(qh, kChunk, rows, w.w2_q + c, F, D, fc, [&](int r, int n, int acc) {
      fsum[r * D + n] =
          __fadd_rn(fsum[r * D + n], __fmul_rn(__int2float_rn(acc), __fmul_rn(w.w2_s[n], s_h[r])));
    });
    __syncthreads();
  }

  // Phase 6: residual, LN2, store.
  for (int i = tid; i < rows * D; i += blockDim.x)
    x1[i] = __fadd_rn(x1[i], __fadd_rn(fsum[i], w.b2[i % D]));
  __syncthreads();
  layer_norm_rows<T>(x1, rows, D, w.ln2_s, w.ln2_b);
  __syncthreads();
  T* ob = out + tok0 * D;
  for (int i = tid; i < rows * D; i += blockDim.x) ob[i] = from_f<T>(x1[i]);
}

// B8's first launch where K|V live in device memory: this tile's rows of
// chain b quantized per token, then K (rounded to T) and V (fp32) into kv_ws
// (B, L, 2D), with phase 2's products and rounding. Each (tile, chain) writes
// its own rows.
template <typename T>
__global__ void __launch_bounds__(kThreads)
kv_proj_int8_kernel(const T* __restrict__ x, const int8_t* __restrict__ w_qkv_q,
                    const float* __restrict__ w_qkv_s, const float* __restrict__ b_qkv,
                    float* __restrict__ kv_ws, int L, int D) {
  extern __shared__ __align__(16) float smem[];  // kTM x D fp32, codes, scales
  float* xs = smem;
  int8_t* qx = reinterpret_cast<int8_t*>(smem + kTM * D);
  float* sx = smem + kTM * D + kTM * D / 4;
  const int b = blockIdx.y, row0 = blockIdx.x * kTM;
  const int rows = min(kTM, L - row0);
  const T* xb = x + ((size_t)b * L + row0) * D;
  for (int i = threadIdx.x; i < kTM * D + kTM * D / 4 + kTM; i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) xs[i] = to_f(xb[i]);
  __syncthreads();
  quantize_rows(xs, D, rows, D, qx, D, sx, nullptr, 0);
  __syncthreads();
  float* kv = kv_ws + ((size_t)b * L + row0) * 2 * D;
  imatmul(qx, D, rows, w_qkv_q + (size_t)D * D, D, 2 * D, D, [&](int r, int n, int acc) {
    const float v = dequant(acc, w_qkv_s[D + n], sx[r], b_qkv[D + n]);
    kv[r * 2 * D + n] = n < D ? round_to<T>(v) : v;
  });
}

inline bool int8_kv_in_smem(bool attn8, int L, int D) {
  return SmemI8(L, D, attn8, true).total * (int)sizeof(float) <= kMaxSmem;
}

inline int int8_smem_bytes(bool attn8, int L, int D) {
  return SmemI8(L, D, attn8, int8_kv_in_smem(attn8, L, D)).total * (int)sizeof(float);
}

template <typename T, bool kAttn8, bool kKvGlobal>
int launch_kernel(const void* x, const Int8Weights<T>& w, void* out, const float* kv,
                  const Probe& probe, int B, int L, int D, int H, int F, cudaStream_t stream) {
  const int bytes = int8_smem_bytes(kAttn8, L, D);
  auto kernel = encoder_layer_int8_kernel<T, kAttn8, kKvGlobal>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + kTM - 1) / kTM, B);
  kernel<<<grid, kThreads, bytes, stream>>>(static_cast<const T*>(x), w, static_cast<T*>(out),
                                            kv, probe, L, D, H, F);
  return (int)cudaGetLastError();
}

// Launches the layer over B chains (two launches where K|V go to kv_ws);
// returns cudaGetLastError() after the last launch, or the error that
// stopped it before.
template <typename T, bool kAttn8>
int launch_int8(const void* x, const Int8Weights<T>& w, void* out, void* kv_ws,
                const Probe& probe, int B, int L, int D, int H, int F, cudaStream_t stream) {
  if (D % 8 || F % 8 || D % H || int8_smem_bytes(kAttn8, L, D) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (int8_kv_in_smem(kAttn8, L, D))
    return launch_kernel<T, kAttn8, false>(x, w, out, nullptr, probe, B, L, D, H, F, stream);
  float* kv = static_cast<float*>(kv_ws);
  if (kv == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid((L + kTM - 1) / kTM, B);
  cudaError_t err;
  if constexpr (kAttn8) {
    const int bytes = (kTM * D + kTM * D / 4 + kTM) * (int)sizeof(float);
    err = cudaFuncSetAttribute(kv_proj_int8_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    kv_proj_int8_kernel<T><<<grid, kThreads, bytes, stream>>>(
        static_cast<const T*>(x), w.w_qkv_q, w.w_qkv_s, w.b_qkv, kv, L, D);
  } else {
    const int bytes = kTM * D * (int)sizeof(float);
    err = cudaFuncSetAttribute(kv_proj_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
    kv_proj_kernel<T><<<grid, kThreads, bytes, stream>>>(static_cast<const T*>(x), w.w_qkv,
                                                         w.b_qkv, kv, L, D);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_kernel<T, kAttn8, true>(x, w, out, kv, probe, B, L, D, H, F, stream);
}

template <typename T>
Int8Weights<T> int8_weights_of(const void* const* p) {
  auto f = [&](int i) { return static_cast<const float*>(p[i]); };
  auto q = [&](int i) { return static_cast<const int8_t*>(p[i]); };
  return Int8Weights<T>{static_cast<const T*>(p[0]), q(1), f(2), f(3),
                        static_cast<const T*>(p[4]), q(5), f(6), f(7),
                        f(8), f(9), q(10), f(11), f(12), q(13), f(14), f(15), f(16), f(17)};
}

}  // namespace

extern "C" {

// Shared-memory bytes one CTA needs (attn8 0: B7, 1: B8).
int fdiff_encoder_layer_int8_smem_bytes(int attn8, int L, int D) {
  return int8_smem_bytes(attn8 != 0, L, D);
}

// Floats per chain of the K|V workspace the launch needs (0: none).
int fdiff_encoder_layer_int8_kv_floats(int attn8, int L, int D) {
  return int8_kv_in_smem(attn8 != 0, L, D) ? 0 : L * 2 * D;
}

// dtype_code 0: float32, 1: bfloat16; attn8 0: B7, 1: B8. w: 18 pointers in
// the order of Int8Weights (w_qkv, w_qkv_q, w_qkv_s, b_qkv, w_out, w_out_q,
// w_out_s, b_out, ln1_s, ln1_b, w1_q, w1_s, b1, w2_q, w2_s, b2, ln2_s,
// ln2_b; B7 passes null for the int8 attention weights, B8 for w_qkv and
// w_out). probe: 6 code buffers (x, v, p, o, x1, h), each may be null, or
// probe itself null. kv_ws: B x fdiff_encoder_layer_int8_kv_floats floats
// (null when that is 0). Returns cudaGetLastError() after the launch (0 on
// success), or the error that stopped it before.
int fdiff_encoder_layer_int8(int dtype_code, int attn8, const void* x, const void* const* w,
                             void* out, void* kv_ws, void* const* probe, int B, int L, int D,
                             int H, int F, void* stream) {
  Probe pr{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  if (probe != nullptr)
    pr = Probe{static_cast<int8_t*>(probe[0]), static_cast<int8_t*>(probe[1]),
               static_cast<int8_t*>(probe[2]), static_cast<int8_t*>(probe[3]),
               static_cast<int8_t*>(probe[4]), static_cast<int8_t*>(probe[5])};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0 && attn8 == 0)
    return launch_int8<float, false>(x, int8_weights_of<float>(w), out, kv_ws, pr, B, L, D, H,
                                     F, s);
  if (dtype_code == 0 && attn8 == 1)
    return launch_int8<float, true>(x, int8_weights_of<float>(w), out, kv_ws, pr, B, L, D, H,
                                    F, s);
  if (dtype_code == 1 && attn8 == 0)
    return launch_int8<__nv_bfloat16, false>(x, int8_weights_of<__nv_bfloat16>(w), out, kv_ws,
                                             pr, B, L, D, H, F, s);
  if (dtype_code == 1 && attn8 == 1)
    return launch_int8<__nv_bfloat16, true>(x, int8_weights_of<__nv_bfloat16>(w), out, kv_ws,
                                            pr, B, L, D, H, F, s);
  return (int)cudaErrorInvalidValue;
}

const char* fdiff_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
