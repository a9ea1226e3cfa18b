// The post-LN transformer encoder layer with W8A8 int8 products, for the
// opt-in int8 sampling path on Hopper (sm_90a), in four launches over the
// B*L rows of the batch, every int8 product on the tensor cores
// (mma_tile.cuh's mma_s8: mma.sync.m16n8k32 s8 x s8 -> s32).
//
// Replaces two TPU kernels of fourierdiffusion_tpu/ops/fused_encoder.py:
//   _encoder_layer_kernel_int8 (B7, FDIFF_FUSED_INT8=1): the sampling
//     layer's (B1's) attention with x1 kept in fp32, then the W8A8 FFN
//     (_ffn_int8). Launches:
//       1. qkv = round_T(x W_qkv + b_qkv): B1's tile product (gemm_kernel);
//       2. B1's attention_fwd_kernel: O = round_T(round_T(P) V);
//       3. int8_tail_kernel<T, false, *>;
//       4. int8_finish_kernel.
//   _encoder_layer_kernel_int8_attn (B8, FDIFF_FUSED_INT8=2): the QKV, PV
//     and out-projection products in int8 too (_attention_ln1_int8); S in
//     the activation dtype. Launches:
//       1. qkv_int8_kernel: x quantized per token, qkv_f = int32(qx . Wqkv_q)
//          * (w_s * s_x) + b in fp32; q and k rounded to T, V kept fp32;
//       2. attention_int8_kernel: S = q k^T on mma.sync (bf16, or 3xTF32 in
//          fp32), the softmax's row statistics in a first pass over the key
//          blocks, then P's codes per (head, query) and O = int32(qP . qV) *
//          (s_v * s_p) in fp32, V quantized per (chain, column) over the L
//          keys;
//       3. int8_tail_kernel<T, true, *>: O quantized per token, the out
//          projection in int8, then B7's FFN;
//       4. int8_finish_kernel.
//
// The tail (launch 3) runs B1's persistent TailSchedule over (row tile of
// 32 rows, or 16 where D > 128; hidden chunk of kChunk = 512 units, the TPU
// kernel's _INT8_FFN_CHUNK). Per segment (a CTA's run of chunks of one row
// tile): the out projection (B7: in T, as B1's tail; B8: by mma_s8 on O's
// codes), the residual with x in fp32 and LN1, giving x1 in fp32 (written
// once per row, by the segment that holds chunk 0); x1 quantized per token;
// then per chunk: W1's 512 rows by mma_s8, dequantized, + b1, ReLU, every
// warp's row maxima reduced through shared memory into the chunk's absmax
// per token before any code of h is formed; h's codes to shared memory;
// W2's 512 columns by mma_s8 (two warps per output column, each half of
// the chunk, their int32 sums added exactly), dequantized with w2_s * s_h,
// and the chunk's partial to a slot of its own (part, chunks x B*L x D).
// The finish (launch 4, a warp per row) adds the partials in chunk order,
// f = ((p0 + p1) + p2) + ..., as JAX's f = f + ..., then + b2, the residual
// x1 + f and LN2, rounded to T. Weights stream through a ring of shared-
// memory slots by cp.async: B7's W_out k-tiles (in T) or B8's W_out codes,
// then per chunk W1's 512 rows and W2's 512 columns in tiles of wt (the
// plan's: the ring's depth and tile width are chosen in ops/
// fused_encoder.py int8_layer_plan).
//
// Quantization (ops/fused_encoder.py quantize_along, bit for bit): over a
// slice, scale = max(absmax, 1e-12) * fp32(1/127) and
// code = clamp(rint(v * (1/scale)), -127, 127), the reciprocal correctly
// rounded and the rounding half to even. Weights carry one fp32 scale per
// output row (packed once, (out, in) row-major: the B operand's [n][k]
// layout as it is); activations are quantized on the fly. Integer sums are
// exact (int32: |sum| <= K * 127^2, 8.3 M at K = 512, and so is their
// conversion to fp32), so the tiling of an int8 product is free and the
// kernel and the plain version differ only where their fp32 inputs to a
// quantization differ. Dequantization computes float(acc) * (w_s * s_x) + b
// with __fmul_rn/__fadd_rn in the TPU kernel's order (no fused
// multiply-add). The rest follows B1: fp32 LayerNorm statistics (eps
// 1e-5), the exact softmax in fp32 and the max-free one in bf16.
//
// P's scale needs P's absmax per row before any code: it is the value at
// the row's largest score, so the first pass's statistics give it: 1 / l
// in the exact form (exp(0) = 1), exp(clamp(s_max)) * (1 / l) in the
// max-free one. The second pass forms the codes from registers. P . V runs
// on mma_s8 with the keys of each 32-key block permuted so that the S
// accumulator's layout is the s8 A fragment: thread t holds keys 8j + 2t,
// 8j + 2t + 1 of the n8 tiles j = 0..3, which become k = 4t .. 4t + 3 (j =
// 0, 1) and 16 + 4t .. (j = 2, 3); V's codes are staged per column
// (keys contiguous) in the same order, so P's codes never go through
// shared memory. Keys at or past L have zero P and V codes.
//
// Probe: where the caller passes code buffers (int8, null to skip), the
// kernels also write the codes of every quantization site: x (B, L, D; B8),
// v (B, L, D; B8, by the first query tile of each head), p (B, H, L, L;
// B8), o (B, L, D; B8), x1 (B, L, D) and h (B, L, F). chip_smoke.py locates
// with them every code that differs from the plain version's.
//
// Bound: at the flagship shape (B 32, L 100, D 72, F 2048, H 12) the FFN's
// int8 products are 59 M of the layer's 66 M multiply-adds per chain and
// the weights (0.33 MB of codes and scales) are shared by all chains, so
// the layer is bound by operations, at the int8 tensor-core rate. The plan
// (Int8Plan) is computed by the Python wrapper (ops/fused_encoder.py:
// int8_plan) and passed in.

#include <type_traits>

#include "encoder_layer_tc.cuh"

// The int8 layer's plan, as ops/fused_encoder.py's Int8Plan passes it.
// Strides of code tiles in bytes, of T or fp32 tiles in elements; offsets
// and sizes in bytes. (Outside the anonymous namespace: the exported
// function takes it.)
struct Int8Plan {
  // B8's attention (attention_int8_kernel), as B2's AttnFwdPlan
  int kdh;         // head width of the instance: dh padded to S's k step, doubled
  int warps;       // per CTA: one per 16 query rows, at most 8
  int q_tiles;     // CTAs per head: tiles of 128 query rows
  int key_blocks;  // blocks of 64 keys
  int sk;          // row stride (elements of T) of a staged K block
  int sv;          // row stride (floats) of a staged V block
  int stage;       // bytes of a stage of the ring: a K block, then a V block
  int attn_bytes;  // two stages, V's codes and scales
  int qkv_bytes;   // B8's QKV (qkv_int8_kernel)
  // the tail (int8_tail_kernel)
  int tm;     // rows per tile: 32 (D <= 128) or 16
  int kd;     // D rounded up to the k step of T (B7's out projection)
  int kq;     // D rounded up to 32 (the int8 contractions over D)
  int sa;     // B7: stride of the O tile (T); B8: of O's codes
  int sq;     // stride of a tile of codes over D (x1, W1's rows, B8's W_out)
  int sh;     // stride of h's codes (a chunk)
  int swo;    // B7: stride of a W_out k-tile (T, [kOutKT][D])
  int wt;     // W1 rows / W2 columns per weight tile: 128 or 256
  int sw2;    // stride of a W2 tile (codes, [D][wt])
  int slot;   // bytes of a ring slot
  int slots;  // weight tiles in the ring: 2 or 3
  int off_a, off_pre, off_q, off_h, off_sc, off_par, off_ring, bytes;
};

namespace {

using namespace fdiff;

constexpr int kChunk = 512;    // FFN hidden chunk (numerics: h's scales are per chunk)
constexpr int kQuarter = 128;  // W1 rows / W2 columns of a chunk per step of its products
constexpr int kOutKT = 32;     // B7: k-rows of a W_out tile
constexpr float kInv127 = (float)(1.0 / 127.0);  // fp32(1/127), as JAX's constant
constexpr float kAbsFloor = 1e-12f;
constexpr int kQkvTile = 64, kQkvThreads = 256;  // B8's QKV: 64 x 64 per CTA, 8 warps
constexpr int kKeyBlock = 64, kWarpRows = 16, kMmaWarps = 8, kTileRows = 128;
constexpr int kSVq = kKeyBlock + 16;  // stride of V's codes ([column][key], keys permuted)

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

__device__ __forceinline__ uint32_t pack_codes(int8_t a, int8_t b, int8_t c, int8_t d) {
  return (uint32_t)(uint8_t)a | (uint32_t)(uint8_t)b << 8 | (uint32_t)(uint8_t)c << 16 |
         (uint32_t)(uint8_t)d << 24;
}

// Waits until at most slots - 1 (slots 2 or 3) of this thread's cp.async
// groups are pending.
__device__ __forceinline__ void cp_async_wait_ring(int slots) {
  if (slots == 3)
    tc::cp_async_wait<2>();
  else
    tc::cp_async_wait<1>();
}

// Quantizes R rows of n values that one warp holds at once (row k's column
// lane + 32 j in v[k][j], 0 past n), their reductions interleaved: the
// codes of row k to dst + k * row_step * ldq over [0, kq) (kq <= 32 KC),
// its scale to scale[k * row_step], the codes also to probe(k) where that
// is not null.
template <int R, int KC, typename ProbeRow>
__device__ __forceinline__ void quantize_rows(const float (&v)[R][KC], int n, int kq,
                                              int8_t* dst, int ldq, int row_step, float* scale,
                                              ProbeRow probe) {
  const int lane = threadIdx.x & 31;
  float inv[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    float m = 0.0f;
#pragma unroll
    for (int j = 0; j < KC; ++j) m = fmaxf(m, fabsf(v[k][j]));
    inv[k] = m;
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const float s = quant_scale(warp_max(inv[k]));
    if (lane == 0) scale[k * row_step] = s;
    inv[k] = __frcp_rn(s);
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    int8_t* pr = probe(k);
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const int c = lane + 32 * j;
      if (c >= kq) break;
      const int8_t q = c < n ? quant_code(v[k][j], inv[k]) : 0;
      dst[k * row_step * ldq + c] = q;
      if (pr != nullptr && c < n) pr[c] = q;
    }
  }
}

// ---- B8 launch 1: the int8 QKV product --------------------------------------------

// grid (ceil(N / 64), ceil(3D / 64)); 8 warps of 16 x 32. The CTA's 64 rows
// of x, staged by cp.async, are quantized per token (by the CTAs of the
// first column tile also to the probe), its 64 rows of W_qkv's codes staged
// meanwhile.
template <typename T>
__global__ void __launch_bounds__(kQkvThreads)
qkv_int8_kernel(const T* __restrict__ x, const int8_t* __restrict__ w_q,
                const float* __restrict__ w_s, const float* __restrict__ b,
                T* __restrict__ qk, float* __restrict__ v, int8_t* probe_x, int N, int D,
                Int8Plan p) {
  extern __shared__ __align__(16) unsigned char qkv_smem[];
  int8_t* sA = reinterpret_cast<int8_t*>(qkv_smem);      // 64 x sq: x's codes
  int8_t* sB = sA + kQkvTile * p.sq;                      // 64 x sq: W_qkv's rows
  float* sS = reinterpret_cast<float*>(sB + kQkvTile * p.sq);  // x's scales
  T* sX = reinterpret_cast<T*>(sS + kQkvTile);                 // 64 x D: x's rows
  const int m0 = blockIdx.x * kQkvTile, n0 = blockIdx.y * kQkvTile;
  const int warp = threadIdx.x >> 5;
  tc::stage_tile<T, true>(sX, D, x, D, m0, kQkvTile, N, 0, D, D);
  tc::cp_async_commit();
  tc::stage_codes(sB, p.sq, w_q + (size_t)n0 * D, D, min(kQkvTile, 3 * D - n0), D);
  tc::cp_async_commit();
  tc::cp_async_wait<1>();
  __syncthreads();
  {  // a warp holds rows warp, warp + 8, ... (zero past N)
    constexpr int kWarps = kQkvThreads / 32, R = kQkvTile / kWarps;
    const int lane = threadIdx.x & 31;
    float xv[R][kTailMaxD / 32];
#pragma unroll
    for (int k = 0; k < R; ++k)
#pragma unroll
      for (int j = 0; j < kTailMaxD / 32; ++j) {
        const int c = lane + 32 * j;
        xv[k][j] = c < D ? to_f(sX[(warp + kWarps * k) * D + c]) : 0.0f;
      }
    quantize_rows(xv, D, p.kq, sA + warp * p.sq, p.sq, kWarps, sS + warp, [&](int k) {
      const int gr = m0 + warp + kWarps * k;
      return probe_x != nullptr && blockIdx.y == 0 && gr < N ? probe_x + (size_t)gr * D
                                                               : nullptr;
    });
  }
  tc::cp_async_wait<0>();
  __syncthreads();
  const int wm = (warp >> 1) * 16, wn = (warp & 1) * 32;
  int acc[1][4][4];
  tc::zero(acc);
  tc::warp_mma_s8<1, 4>(acc, sA, p.sq, wm, sB, p.sq, wn, 8, 4, p.kq);
  tc::for_each_acc(acc, wm, wn, 8, 4, [&](int r, int n, int a) {
    const int gr = m0 + r, gn = n0 + n;
    if (gr >= N || gn >= 3 * D) return;
    const float val = dequant(a, w_s[gn], sS[r], b[gn]);
    if (gn < 2 * D)
      qk[(size_t)gr * 2 * D + gn] = from_f<T>(val);
    else
      v[(size_t)gr * D + gn - 2 * D] = val;
  });
}

// ---- B8 launch 2: attention with int8 P . V ------------------------------------------

// The ring of two stages: step s + 1 is staged while step s is used.
template <typename Load>
__device__ __forceinline__ unsigned char* ring_begin(unsigned char* ring, int stage, int s,
                                                     int steps, Load load) {
  if (s + 1 < steps) load(s + 1);
  tc::cp_async_commit();
  tc::cp_async_wait<1>();
  __syncthreads();
  return ring + (s % 2) * stage;
}

// Position in a 32-key block of V's codes of key kk of the block (the
// permutation that makes the S accumulator the s8 A fragment).
__device__ __forceinline__ int key_position(int kk) {
  const int r = kk & 15;
  return (kk & 16) + 4 * ((r & 7) >> 1) + 2 * (r >> 3) + (r & 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // a in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// grid (B * H, p.q_tiles); p.warps warps, a warp per 16 query rows. qk: (B*L,
// 2D) q | k in T; v: (B*L, D) fp32; o: (B*L, D) fp32.
template <typename T, int kDh>
__global__ void __launch_bounds__(kMmaWarps * 32)
attention_int8_kernel(const T* __restrict__ qk, const float* __restrict__ v,
                      float* __restrict__ o, int8_t* probe_v, int8_t* probe_p, int L, int D,
                      int H, Int8Plan p) {
  constexpr bool kF32 = sizeof(T) == 4;  // fp32: exact softmax; bf16: max-free
  constexpr int KS = kDh / (kF32 ? 8 : 16);
  constexpr int NO = kDh / 8;
  extern __shared__ __align__(16) unsigned char attn_smem[];
  unsigned char* ring = attn_smem;
  int8_t* sVq = reinterpret_cast<int8_t*>(attn_smem + 2 * p.stage);
  float* sSv = reinterpret_cast<float*>(sVq + kDh * kSVq);  // V's scales
  float* sIv = sSv + kDh;                                    // and their reciprocals
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int dh = D / H, c0 = h * dh;
  const int nb = p.key_blocks, steps = 2 * nb;
  const size_t row_base = (size_t)b * L;
  const T* kb = qk + row_base * 2 * D + D + c0;
  const float* vb = v + row_base * D + c0;
  const int kbytes = kKeyBlock * p.sk * (int)sizeof(T);

  // Step s stages key block s % nb: K in the first pass, K and V in the
  // second (zero past L keys and dh columns).
  auto load = [&](int s) {
    unsigned char* st = ring + (s % 2) * p.stage;
    const int j0 = (s % nb) * kKeyBlock;
    tc::stage_tile<T, true>(reinterpret_cast<T*>(st), p.sk, kb, 2 * D, j0, kKeyBlock, L, 0, kDh,
                            dh);
    if (s >= nb)
      tc::stage_tile<float, true>(reinterpret_cast<float*>(st + kbytes), p.sv, vb, D, j0,
                                  kKeyBlock, L, 0, kDh, dh);
  };
  load(0);
  tc::cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n_warps = blockDim.x >> 5;
  // V's scales per (chain, column) over the chain's L keys: a warp per column
  // (read from device memory while the first key block is staged).
  for (int c = warp; c < kDh; c += n_warps) {
    float m = 0.0f;
    if (c < dh)
      for (int j = lane; j < L; j += 32) m = fmaxf(m, fabsf(vb[(size_t)j * D + c]));
    const float s = quant_scale(warp_max(m));
    if (lane == 0) {
      sSv[c] = s;
      sIv[c] = __frcp_rn(s);
    }
  }

  const int r0 = blockIdx.y * kTileRows + warp * kWarpRows;
  const bool live = r0 < L;
  const T* qb = qk + row_base * 2 * D + c0;
  auto q_at = [&](int r, int c) {
    return (r < L && c < dh) ? to_f(qb[(size_t)r * 2 * D + c]) : 0.0f;
  };
  uint32_t qa[KS][4], ql[kF32 ? KS : 1][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e & 1);
      if constexpr (kF32) {
        tc::split_tf32(q_at(r, 8 * ks + t + 4 * (e >> 1)), qa[ks][e], ql[ks][e]);
      } else {
        const int c = 16 * ks + 2 * t + 8 * (e >> 1);
        qa[ks][e] = pack_bf16(q_at(r, c), q_at(r, c + 1));
      }
    }

  // S of the n8 tile at key n of the staged block (first key j0), in the
  // accumulator layout; keys past L give -inf; the max-free form clamps.
  auto scores = [&](const T* sK, int j0, int n, float (&c)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = 0.0f;
    if (j0 + n < L) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t bb[2];
        if constexpr (kF32) {
          const float* kr = reinterpret_cast<const float*>(sK) + (n + g) * p.sk + 8 * ks + t;
          uint32_t bl[2];
          tc::split_tf32(kr[0], bb[0], bl[0]);
          tc::split_tf32(kr[4], bb[1], bl[1]);
          tc::mma_tf32(c, ql[ks], bb);
          tc::mma_tf32(c, qa[ks], bl);
          tc::mma_tf32(c, qa[ks], bb);
        } else {
          const T* kr = sK + (n + g) * p.sk + 16 * ks + 2 * t;
          bb[0] = *reinterpret_cast<const uint32_t*>(kr);
          bb[1] = *reinterpret_cast<const uint32_t*>(kr + 8);
          tc::mma_bf16(c, qa[ks], bb);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = j0 + n + 2 * t + (e & 1) < L;
      c[e] = !in ? -INFINITY : kF32 ? c[e] : fminf(fmaxf(c[e], -kScoreClamp), kScoreClamp);
    }
  };

  // Pass 1, per row (g and g + 8): the running max and the rescaled sum of
  // exp(s - max) (max-free: the max and the sum of exp(s)).
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.0f, 0.0f};
  auto pass1 = [&](const T* sK, int j0) {
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) scores(sK, j0, 8 * j, sc[j]);
    float mb[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mb[e >> 1] = fmaxf(mb[e >> 1], sc[j][e]);
    if constexpr (!kF32) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) l[e >> 1] += __expf(sc[j][e]);
      m[0] = mb[0];
      m[1] = mb[1];
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] *= expf(m[r] - mb[r]);
        m[r] = mb[r];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) l[e >> 1] += expf(sc[j][e] - m[e >> 1]);
    }
  };
  // Then over the row's four threads, and P's scale per row: its absmax is
  // its value at the largest score.
  float inv[2], sp[2], ip[2];
  auto row_stats = [&]() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
        const float mo = __shfl_xor_sync(0xffffffffu, m[r], off), mn = fmaxf(m[r], mo);
        if constexpr (!kF32) {
          l[r] += lo;
        } else {
          l[r] = l[r] * expf(m[r] - mn) + lo * expf(mo - mn);
        }
        m[r] = mn;
      }
      inv[r] = __fdividef(1.0f, l[r]);
      sp[r] = quant_scale(kF32 ? 1.0f / l[r] : __expf(m[r]) * inv[r]);
      ip[r] = __frcp_rn(sp[r]);
    }
  };

  // Pass 2: S again, P = exp(s - max) / sum (max-free: exp(s) * inv), its
  // codes, and acc += qP qV per 32-key half from the registers.
  int acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0;
  int8_t* pp = probe_p == nullptr ? nullptr : probe_p + (size_t)blockIdx.x * L * L;
  auto pass2 = [&](const T* sK, int j0) {
    int8_t qp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float pr[4];
      scores(sK, j0, 8 * j, pr);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float pv = kF32 ? expf(pr[e] - m[r]) / l[r] : __expf(pr[e]) * inv[r];
        qp[j][e] = quant_code(pv, ip[r]);
        const int row = r0 + g + 8 * r, key = j0 + 8 * j + 2 * t + (e & 1);
        if (pp != nullptr && row < L && key < L) pp[(size_t)row * L + key] = qp[j][e];
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (j0 + 32 * hh >= L) continue;
      const int j = 4 * hh;
      const uint32_t a[4] = {
          pack_codes(qp[j][0], qp[j][1], qp[j + 1][0], qp[j + 1][1]),
          pack_codes(qp[j][2], qp[j][3], qp[j + 1][2], qp[j + 1][3]),
          pack_codes(qp[j + 2][0], qp[j + 2][1], qp[j + 3][0], qp[j + 3][1]),
          pack_codes(qp[j + 2][2], qp[j + 2][3], qp[j + 3][2], qp[j + 3][3])};
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        if (8 * n >= dh) continue;
        uint32_t bb[2];
        tc::ldmatrix_x2(bb, sVq + (8 * n + (lane & 7)) * kSVq + 32 * hh + ((lane >> 3) & 1) * 16);
        tc::mma_s8(acc[n], a, bb);
      }
    }
  };

  for (int s = 0; s < nb; ++s) {
    const T* sK = reinterpret_cast<const T*>(ring_begin(ring, p.stage, s, steps, load));
    if (live) pass1(sK, s * kKeyBlock);
    __syncthreads();
  }
  if (live) row_stats();
  for (int s = nb; s < steps; ++s) {
    const unsigned char* st = ring_begin(ring, p.stage, s, steps, load);
    const int j0 = (s - nb) * kKeyBlock;
    // V's codes of the block, [column][key] with the keys permuted; zero
    // past L keys and dh columns (V staged as 0 there).
    const float* sV = reinterpret_cast<const float*>(st + kbytes);
    for (int e = threadIdx.x; e < kDh * kKeyBlock; e += blockDim.x) {
      const int c = e / kKeyBlock, kk = e - c * kKeyBlock;
      const int8_t q = quant_code(sV[kk * p.sv + c], sIv[c]);
      sVq[c * kSVq + (kk & 32) + key_position(kk)] = q;
      if (probe_v != nullptr && blockIdx.y == 0 && c < dh && j0 + kk < L)
        probe_v[(row_base + j0 + kk) * D + c0 + c] = q;
    }
    __syncthreads();
    if (live) pass2(reinterpret_cast<const T*>(st), j0);
    __syncthreads();
  }
  if (!live) return;

  // O = acc * (s_v * s_p) in fp32: element e of tile n at (row g + 8 (e >>
  // 1), column 8n + 2t + (e & 1)).
  float* ob = o + row_base * D + c0;
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e >> 1), c = 8 * n + 2 * t + (e & 1);
      if (r < L && c < dh)
        ob[(size_t)r * D + c] =
            __fmul_rn(__int2float_rn(acc[n][e]), __fmul_rn(sSv[c], sp[e >> 1]));
    }
}

// ---- launch 3: the int8 tail -----------------------------------------------------------

// CTA k takes its units of TailSchedule(N, F, tm, kChunk) (gridDim.x CTAs),
// a segment at a time; see the file's comment. o: B7's O (N x D, T) or B8's
// (N x D, fp32). kMT = tm / 16 m-tiles per warp. Warps: the out projection
// and W1 split the output columns eight ways; W2 splits them four ways and
// the chunk in two halves.
template <typename T, bool kAttn8, int kMT>
__global__ void __launch_bounds__(kTailThreads, 2)
int8_tail_kernel(const T* __restrict__ x, const void* __restrict__ o_any,
                 const Int8Weights<T> w, const Probe probe, int N, int D, int F, Int8Plan p,
                 float* __restrict__ x1g, float* __restrict__ part) {
  constexpr int kWarps = kTailThreads / 32;
  constexpr int NTO = kMT == 1 ? 4 : 2;  // out projection: D <= 256 (kMT 1), 128 (kMT 2)
  constexpr int NT2 = kMT == 1 ? 8 : 4;  // W2
  constexpr int RPW = 2 * kMT;           // rows per warp in the row-wise stages
  constexpr int KC = kTailMaxD / 32 / kMT;  // columns per lane there: D <= 32 KC
  using Acc = std::conditional_t<kAttn8, int, float>;
  extern __shared__ __align__(16) unsigned char tail_smem[];
  T* sA = reinterpret_cast<T*>(tail_smem + p.off_a);              // B7: O in T
  int8_t* sAq = reinterpret_cast<int8_t*>(tail_smem + p.off_a);   // B8: O's codes
  float* sPre = reinterpret_cast<float*>(tail_smem + p.off_pre);  // pre-LN1, then x1
  int* sRed = reinterpret_cast<int*>(tail_smem + p.off_pre);      // W2's second half-sums
  int8_t* sQ = reinterpret_cast<int8_t*>(tail_smem + p.off_q);    // x1's codes
  int8_t* sH = reinterpret_cast<int8_t*>(tail_smem + p.off_h);    // h's codes of a chunk
  float* sMax = reinterpret_cast<float*>(tail_smem + p.off_sc);   // kWarps x tm row maxima
  float* s_o = sMax + kWarps * p.tm;                              // row scales: O (B8),
  float* s_x1 = s_o + p.tm;                                       // x1,
  float* s_h = s_x1 + p.tm;                                       // h of the chunk
  float* sLn1s = reinterpret_cast<float*>(tail_smem + p.off_par); // the vectors over D
  float* sLn1b = sLn1s + D;
  float* sBout = sLn1b + D;
  float* sWos = sBout + D;  // B8: W_out's scales
  float* sW2s = sWos + D;
  unsigned char* ring = tail_smem + p.off_ring;
  const T* o_t = static_cast<const T*>(o_any);
  const float* o_f = static_cast<const float*>(o_any);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int ntd = D / 8;
  const int nact_o = max(0, (ntd - warp + kWarps - 1) / kWarps);
  const int kh = warp >> 2, nw = warp & 3;
  const int nact_2 = max(0, (ntd - nw + 3) / 4);
  const int n_pro = kAttn8 ? 1 : (p.kd + kOutKT - 1) / kOutKT;
  const int qpt = p.wt / kQuarter;          // steps of a product per weight tile
  const int tpc = 2 * (kChunk / p.wt);      // weight tiles per chunk: W1's, then W2's
  const TailSchedule sc(N, F, p.tm, kChunk);
  const long long u_end = sc.begin(blockIdx.x + 1, gridDim.x);
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    sLn1s[c] = w.ln1_s[c];
    sLn1b[c] = w.ln1_b[c];
    sBout[c] = w.b_out[c];
    sWos[c] = kAttn8 ? w.w_out_s[c] : 0.0f;
    sW2s[c] = w.w2_s[c];
  }

  for (long long u = sc.begin(blockIdx.x, gridDim.x); u < u_end;) {
    const int tile = (int)(u / sc.chunks);
    const int c_lo = (int)(u - (long long)tile * sc.chunks);
    const int c_hi = (int)min((long long)sc.chunks, u_end - (long long)tile * sc.chunks);
    u = (long long)tile * sc.chunks + c_hi;
    const int row0 = tile * p.tm, rows = min(p.tm, N - row0);
    const int n_tiles = n_pro + (c_hi - c_lo) * tpc;
    // Tile i of the segment's weight stream: W_out (B7: k-tile i; B8: all
    // of W_out's codes), then per chunk W1's rows [c 512 + wt v, + wt)
    // (v < tpc / 2) and W2's columns [c 512 + wt (v - tpc / 2), + wt).
    auto stage = [&](int i) {
      unsigned char* s = ring + (i % p.slots) * p.slot;
      if (i < n_pro) {
        if constexpr (kAttn8)
          tc::stage_codes(reinterpret_cast<int8_t*>(s), p.sq, w.w_out_q, D, D, D);
        else
          tc::stage_tile<T, false>(reinterpret_cast<T*>(s), p.swo, w.w_out, D, 0, D, D,
                                   i * kOutKT, kOutKT, D);
        return;
      }
      const int q = i - n_pro, c = c_lo + q / tpc, v = q % tpc;
      // rows of W1 past F and columns of W2 past F are not staged: their
      // products are discarded (h is 0 there) or meet zero codes of h
      const int f0 = c * kChunk + (v % (tpc / 2)) * p.wt;
      if (v < tpc / 2)
        tc::stage_codes(reinterpret_cast<int8_t*>(s), p.sq, w.w1_q + (size_t)f0 * D, D,
                        min(p.wt, F - f0), D);
      else
        tc::stage_codes(reinterpret_cast<int8_t*>(s), p.sw2, w.w2_q + f0, F, D,
                        min(p.wt, F - f0));
    };
    int it = 0;  // the stream's next tile
    auto next = [&]() -> const unsigned char* {
      __syncthreads();  // every warp is done with the slot staged next
      if (it + p.slots - 1 < n_tiles) stage(it + p.slots - 1);
      tc::cp_async_commit();
      cp_async_wait_ring(p.slots);
      __syncthreads();
      return ring + (it++ % p.slots) * p.slot;
    };

    __syncthreads();  // the last segment is done with shared memory
    // O's tile (B7: in T, the A operand; B8: fp32 in sPre, to be quantized)
    if constexpr (kAttn8)
      tc::stage_tile<float, true>(sPre, D, o_f, D, row0, p.tm, N, 0, D, D);
    else
      tc::stage_tile<T, true>(sA, p.sa, o_t, D, row0, p.tm, N, 0, p.kd, D);
    tc::cp_async_commit();  // its own group: slots groups in flight below
    for (int i = 0; i < p.slots - 1; ++i) {
      if (i < n_tiles) stage(i);
      tc::cp_async_commit();
    }
    // The out projection, the residual with x in fp32 (x read ahead).
    {
      float xr[kMT][NTO][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < NTO; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 16 * i + g + 8 * (e >> 1), n = 8 * warp + 64 * j + 2 * t + (e & 1);
            xr[i][j][e] = j < nact_o && r < rows ? to_f(x[(size_t)(row0 + r) * D + n]) : 0.0f;
          }
      if constexpr (kAttn8) {
        // O per token over D: a warp holds rows warp, warp + 8, ...
        cp_async_wait_ring(p.slots);
        __syncthreads();
        float v[RPW][KC];
#pragma unroll
        for (int k = 0; k < RPW; ++k)
#pragma unroll
          for (int j = 0; j < KC; ++j) {
            const int c = lane + 32 * j;
            v[k][j] = c < D ? sPre[(warp + kWarps * k) * D + c] : 0.0f;
          }
        quantize_rows(v, D, p.kq, sAq + warp * p.sa, p.sa, kWarps, s_o + warp, [&](int k) {
          const int r = warp + kWarps * k;
          return probe.o != nullptr && c_lo == 0 && r < rows ? probe.o + (size_t)(row0 + r) * D
                                                             : nullptr;
        });
      }

      Acc acc_o[kMT][NTO][4];
      tc::zero(acc_o);
      for (int i = 0; i < n_pro; ++i) {
        const unsigned char* s = next();
        if constexpr (kAttn8) {
          tc::warp_mma_s8<kMT, NTO>(acc_o, sAq, p.sa, 0, reinterpret_cast<const int8_t*>(s),
                                    p.sq, 8 * warp, 8 * kWarps, nact_o, p.kq);
        } else {
          const int kv = min(kOutKT, p.kd - i * kOutKT);
          tc::warp_mma<T, kMT, NTO, true, false>(acc_o, sA + i * kOutKT, p.sa, 0,
                                                 reinterpret_cast<const T*>(s), p.swo, 8 * warp,
                                                 8 * kWarps, nact_o, 0, kv);
        }
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < NTO; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 16 * i + g + 8 * (e >> 1), n = 8 * warp + 64 * j + 2 * t + (e & 1);
            if (j >= nact_o || r >= rows) continue;
            if constexpr (kAttn8)
              sPre[r * D + n] =
                  __fadd_rn(xr[i][j][e], dequant(acc_o[i][j][e], sWos[n], s_o[r], sBout[n]));
            else
              sPre[r * D + n] = xr[i][j][e] + (acc_o[i][j][e] + sBout[n]);
          }
    }
    __syncthreads();
    // LN1 in fp32 (x1, to device memory once per row), x1 per token: a warp
    // holds rows warp, warp + 8, ... at once, its lane columns lane + 32 j.
    {
      float v[RPW][KC], mean[RPW], var[RPW];
#pragma unroll
      for (int k = 0; k < RPW; ++k) {
        const int r = warp + kWarps * k;
        mean[k] = 0.0f;
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          const int c = lane + 32 * j;
          v[k][j] = c < D && r < rows ? sPre[r * D + c] : 0.0f;
          mean[k] += v[k][j];
        }
      }
#pragma unroll
      for (int k = 0; k < RPW; ++k) {
        mean[k] = warp_sum(mean[k]) / D;
        var[k] = 0.0f;
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          const float d = v[k][j] - mean[k];
          if (lane + 32 * j < D) var[k] += d * d;
        }
      }
#pragma unroll
      for (int k = 0; k < RPW; ++k) {
        const int r = warp + kWarps * k;
        const float inv = rsqrtf(warp_sum(var[k]) / D + kLnEps);
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          const int c = lane + 32 * j;
          v[k][j] = c < D && r < rows ? (v[k][j] - mean[k]) * inv * sLn1s[c] + sLn1b[c] : 0.0f;
          if (c < D && r < rows && c_lo == 0) x1g[(size_t)(row0 + r) * D + c] = v[k][j];
        }
      }
      quantize_rows(v, D, p.kq, sQ + warp * p.sq, p.sq, kWarps, s_x1 + warp, [&](int k) {
        const int r = warp + kWarps * k;
        return probe.x1 != nullptr && c_lo == 0 && r < rows ? probe.x1 + (size_t)(row0 + r) * D
                                                            : nullptr;
      });
    }

    for (int c = c_lo; c < c_hi; ++c) {
      // W1's chunk: this warp's n-tiles warp and warp + 8 of each 128 rows.
      int acc1[4][kMT][2][4];
      const int8_t* s1 = nullptr;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q % qpt == 0) s1 = reinterpret_cast<const int8_t*>(next());
        tc::zero(acc1[q]);
        tc::warp_mma_s8<kMT, 2>(acc1[q], sQ, p.sq, 0, s1 + (q % qpt) * kQuarter * p.sq, p.sq,
                                8 * warp, 64, 2, p.kq);
      }
      // h = relu(dequant + b1) (0 past F), in place (as fp32 bits); the row
      // maxima over this thread's units, then over the row's quad and the warps.
      float mx[kMT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) mx[i][0] = mx[i][1] = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int f = c * kChunk + q * kQuarter + 64 * j + 8 * warp + 2 * t + (e & 1);
              const int r = 16 * i + g + 8 * (e >> 1);
              const float hf = f < F ? fmaxf(dequant(acc1[q][i][j][e], w.w1_s[f], s_x1[r],
                                                     w.b1[f]), 0.0f)
                                     : 0.0f;
              acc1[q][i][j][e] = __float_as_int(hf);
              mx[i][e >> 1] = fmaxf(mx[i][e >> 1], hf);
            }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float v = mx[i][hh];
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
          if (t == 0) sMax[warp * p.tm + 16 * i + g + 8 * hh] = v;
        }
      __syncthreads();
      // the chunk's scale per token from all 512 units; then h's codes
      float ih[kMT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 16 * i + g + 8 * hh;
          float v = 0.0f;
#pragma unroll
          for (int k = 0; k < kWarps; ++k) v = fmaxf(v, sMax[k * p.tm + r]);
          const float s = quant_scale(v);
          ih[i][hh] = __frcp_rn(s);
          if (warp == 0 && t == 0) s_h[r] = s;
        }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int n = q * kQuarter + 64 * j + 8 * warp + 2 * t + (e & 1);
              const int r = 16 * i + g + 8 * (e >> 1);
              const int8_t code = quant_code(__int_as_float(acc1[q][i][j][e]), ih[i][e >> 1]);
              sH[r * p.sh + n] = code;
              if (probe.h != nullptr && r < rows && c * kChunk + n < F)
                probe.h[(size_t)(row0 + r) * F + c * kChunk + n] = code;
            }

      // W2's chunk: columns nw, nw + 4, ... over half kh of each 128 units.
      int acc2[kMT][NT2][4];
      tc::zero(acc2);
      const int8_t* s2 = nullptr;
#pragma unroll 1
      for (int q = 0; q < 4; ++q) {
        if (q % qpt == 0) s2 = reinterpret_cast<const int8_t*>(next());
        tc::warp_mma_s8<kMT, NT2>(acc2, sH + q * kQuarter + kh * 64, p.sh, 0,
                                  s2 + (q % qpt) * kQuarter + kh * 64, p.sw2, 8 * nw, 32, nact_2,
                                  64);
      }
      // the chunk's partial: both halves' exact sums, dequantized once
      if (kh == 1)
        tc::for_each_acc(acc2, 0, 8 * nw, 32, nact_2,
                         [&](int r, int n, int v) { sRed[r * D + n] = v; });
      __syncthreads();
      if (kh == 0) {
        float* dst = part + ((size_t)c * N + row0) * D;
        tc::for_each_acc(acc2, 0, 8 * nw, 32, nact_2, [&](int r, int n, int v) {
          if (r < rows)
            dst[(size_t)r * D + n] = __fmul_rn(__int2float_rn(v + sRed[r * D + n]),
                                               __fmul_rn(sW2s[n], s_h[r]));
        });
      }
    }
  }
}

// ---- launch 4: the finish --------------------------------------------------------------

// f = the row's chunk partials added in chunk order; LN2(x1 + (f + b2))
// rounded to T. A warp per row.
template <typename T>
__global__ void __launch_bounds__(256)
int8_finish_kernel(const float* __restrict__ part, const float* __restrict__ x1,
                   const float* __restrict__ b2, const float* __restrict__ ln2_s,
                   const float* __restrict__ ln2_b, T* __restrict__ out, int N, int D,
                   int chunks) {
  __shared__ float rows[8][kTailMaxD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = blockIdx.x * 8 + warp;
  if (gr >= N) return;
  float* row = rows[warp];
  for (int c = lane; c < D; c += 32) {
    float f = part[(size_t)gr * D + c];
    for (int k = 1; k < chunks; ++k) f = __fadd_rn(f, part[((size_t)k * N + gr) * D + c]);
    row[c] = __fadd_rn(x1[(size_t)gr * D + c], __fadd_rn(f, b2[c]));
  }
  __syncwarp();
  ln2_row<T, false>(row, gr, 1, D, ln2_s, ln2_b, out, Dropout{0u, 0u, 1.0f, 1}, TailTrain{});
}

// ---- launching ---------------------------------------------------------------------------

// B8's attention instance by the plan's head width.
template <typename T>
cudaError_t launch_attention_int8(const T* qk, const float* v, float* o, const Probe& pr, int B,
                                  int L, int D, int H, const Int8Plan& p, cudaStream_t s) {
  auto run = [&](auto kernel) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.attn_bytes);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(B * H, p.q_tiles), p.warps * 32, p.attn_bytes, s>>>(qk, v, o, pr.v, pr.p, L,
                                                                       D, H, p);
    return cudaGetLastError();
  };
  switch (p.kdh) {
    case 8:
      if constexpr (sizeof(T) == 4) return run(attention_int8_kernel<T, 8>);
      break;
    case 16: return run(attention_int8_kernel<T, 16>);
    case 32: return run(attention_int8_kernel<T, 32>);
    case 64: return run(attention_int8_kernel<T, 64>);
  }
  return cudaErrorInvalidValue;
}

// ws: qkv (B7: N x 3D in T; B8: N x 2D q | k in T), v (B8: N x D fp32), o
// (N x D: B7 in T, B8 fp32), x1 (N x D fp32), part (chunks x N x D fp32).
template <typename T, bool kAttn8>
int launch_int8(const T* x, const Int8Weights<T>& w, T* out, void* const* ws, const Probe& pr,
                const Int8Plan& p, int ctas, int B, int L, int D, int H, int F,
                cudaStream_t s) {
  const int N = B * L;
  const TailSchedule sc(N, F, p.tm, kChunk);
  if (N < 1 || D % 8 || F % 8 || D % H || D / H > (kAttn8 ? 64 : 384) ||
      D > (p.tm == 16 ? kTailMaxD : kTailMaxD / 2) || (p.tm != 16 && p.tm != 32) ||
      p.bytes > kMaxSmem || p.attn_bytes > kMaxSmem || (p.slots != 2 && p.slots != 3) ||
      (p.wt != 128 && p.wt != 256) ||
      ctas < 1 || ctas > sc.units || ws[0] == nullptr || ws[2] == nullptr ||
      ws[3] == nullptr || ws[4] == nullptr || (kAttn8 && ws[1] == nullptr))
    return (int)cudaErrorInvalidValue;
  T* qkv = static_cast<T*>(ws[0]);
  cudaError_t err;
  if constexpr (kAttn8) {
    float* v = static_cast<float*>(ws[1]);
    float* o = static_cast<float*>(ws[2]);
    err = cudaFuncSetAttribute(qkv_int8_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p.qkv_bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((N + kQkvTile - 1) / kQkvTile, (3 * D + kQkvTile - 1) / kQkvTile);
    qkv_int8_kernel<T><<<grid, kQkvThreads, p.qkv_bytes, s>>>(x, w.w_qkv_q, w.w_qkv_s, w.b_qkv,
                                                              qkv, v, pr.x, N, D, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    err = launch_attention_int8<T>(qkv, v, o, pr, B, L, D, H, p, s);
  } else {
    err = tc::gemm<T, true, false>(x, D, w.w_qkv, 3 * D, N, 3 * D, D,
                                   tc::round_up(D, tc::kGemmBK), 1,
                                   StoreBiasRounded<T>{qkv, w.b_qkv, 3 * D}, s);
    if (err != cudaSuccess) return (int)err;
    err = launch_attention_fwd<T>(qkv, static_cast<T*>(ws[2]), B, L, D, H, s);
  }
  if (err != cudaSuccess) return (int)err;
  auto tail = p.tm == 16 ? int8_tail_kernel<T, kAttn8, 1> : int8_tail_kernel<T, kAttn8, 2>;
  err = cudaFuncSetAttribute(tail, cudaFuncAttributeMaxDynamicSharedMemorySize, p.bytes);
  if (err != cudaSuccess) return (int)err;
  float* x1 = static_cast<float*>(ws[3]);
  float* part = static_cast<float*>(ws[4]);
  tail<<<ctas, kTailThreads, p.bytes, s>>>(x, ws[2], w, pr, N, D, F, p, x1, part);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  int8_finish_kernel<T><<<(N + 7) / 8, 256, 0, s>>>(part, x1, w.b2, w.ln2_s, w.ln2_b, out, N, D,
                                                    sc.chunks);
  return (int)cudaGetLastError();
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

// dtype_code 0: float32, 1: bfloat16; attn8 0: B7, 1: B8. w: 18 pointers in
// the order of Int8Weights (w_qkv, w_qkv_q, w_qkv_s, b_qkv, w_out, w_out_q,
// w_out_s, b_out, ln1_s, ln1_b, w1_q, w1_s, b1, w2_q, w2_s, b2, ln2_s,
// ln2_b; B7 passes null for the int8 attention weights, B8 for w_qkv and
// w_out). ws: 5 workspaces (qkv, v, o, x1, part; see launch_int8; v null
// for B7). probe: 6 code buffers (x, v, p, o, x1, h), each may be null, or
// probe itself null. plan: ops/fused_encoder.py int8_plan; tail_ctas its
// schedule's CTAs. Returns cudaGetLastError() after the last launch (0 on
// success), or the error that stopped it before.
int fdiff_encoder_layer_int8(int dtype_code, int attn8, const void* x, const void* const* w,
                             void* out, void* const* ws, void* const* probe,
                             const Int8Plan* plan, int tail_ctas, int B, int L, int D, int H,
                             int F, void* stream) {
  Probe pr{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  if (probe != nullptr)
    pr = Probe{static_cast<int8_t*>(probe[0]), static_cast<int8_t*>(probe[1]),
               static_cast<int8_t*>(probe[2]), static_cast<int8_t*>(probe[3]),
               static_cast<int8_t*>(probe[4]), static_cast<int8_t*>(probe[5])};
  auto s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto* t) {
    using T = std::remove_pointer_t<decltype(t)>;
    const T* xt = static_cast<const T*>(x);
    T* ot = static_cast<T*>(out);
    if (attn8)
      return launch_int8<T, true>(xt, int8_weights_of<T>(w), ot, ws, pr, *plan, tail_ctas, B, L,
                                  D, H, F, s);
    return launch_int8<T, false>(xt, int8_weights_of<T>(w), ot, ws, pr, *plan, tail_ctas, B, L,
                                 D, H, F, s);
  };
  if (dtype_code == 0) return run(static_cast<float*>(nullptr));
  if (dtype_code == 1) return run(static_cast<__nv_bfloat16*>(nullptr));
  return (int)cudaErrorInvalidValue;
}

const char* fdiff_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
