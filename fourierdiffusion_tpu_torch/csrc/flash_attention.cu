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
// attention_fwd_mma_kernel<T, kFast, kDh> serves B2 (fp32, bf16 and the fast
// bf16 form); attention_dropout_fwd_kernel serves B6-fwd;
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
// The TPU kernels pad L to 128 lanes and mask keys at or past L; B2 pads the
// keys to blocks of 64 and gives a padded key no weight; B5 and B6 take
// exactly L keys, so nothing is masked there.
//
// Bound: at the flagship's training shape (B 64, H 12, L 100, dh 6) the
// forward does 4 B H L^2 dh = 184 MFLOP against 4 x 1.8 MB of q, k, v, o in
// fp32, and the backward about three times that (12 B H L^2 dh) against 7 x
// 1.8 MB, so operations bound both in fp32 (2.7 us and 8.3 us at 67
// TFLOP/s); bytes bound the bf16 forward (1.1 us at 3.35 TB/s).
//
// B2's design (attention_fwd_mma_kernel): one CTA per (chain, head) and 128
// query rows, a warp per 16 query rows (one m16 tile), up to 8 warps. The
// head's K and V stream through a ring of two key blocks of 64 rows in
// shared memory, filled by cp.async (16 bytes a copy where the rows allow
// it, else 4: stage_keys; zero past L keys and dh columns): one block is
// staged while the other is used, so shared memory does not grow with L and every length
// runs. Both products run on the tensor cores with mma_tile.cuh's
// fragments: bf16 m16n8k16, fp32 as 3xTF32 m16n8k8 (K and V split into TF32
// hi and lo as fragments are read). To keep JAX's rounding points (P
// normalised and rounded to T before P v) the kernel makes two passes over
// the key blocks: the first stages K alone and keeps each row's running max
// and rescaled sum (per thread, then over the row's quad by shuffles), the
// second stages K and V again, recomputes S, forms P, rounds it and
// multiplies it by V straight from the accumulator registers (for fp32 the
// keys of an n8 tile are permuted so that the accumulator layout is the
// A-operand layout, and V's rows are read in the same permutation). At these
// head widths recomputing S costs one small mma per key tile. The launch's
// plan (AttnFwdPlan) is computed by the Python wrapper and passed in. The
// old forward (one row per warp, a shuffle sum per output) stays only for
// B6-fwd.
//
// B5/B6's design: one CTA per (chain, head), 4 warps. The dropout forward
// stages the head's K and V in shared memory as fp32; each warp takes query
// rows in turn, keeps the row of scores in shared memory, reduces its max
// and sum with shuffles, and forms the dh outputs of the row as warp sums
// over the keys. The backward stages Q, K, V and dO of the head and makes
// three passes, all with fixed warp and lane orders (no atomics, so its sums
// are the same in every run): (1) per query row, the softmax max and sum and
// D = dO . (P_used v); (2) per query row, dS over the keys and dq as warp
// sums; (3) per key, dS and P_used down the column and dk, dv as warp sums.
// Scores and probabilities are recomputed in each pass and never reach
// device memory.

#include <cmath>

#include "encoder_layer.cuh"
#include "mma_tile.cuh"

// B2's launch, as ops/flash_attention.py's AttnFwdPlan passes it (computed
// there by attention_fwd_plan). A stage of the ring holds one key block of
// K, then (in the second pass) the same block of V: 64 rows (kKeyBlock) of
// stride elements each. (Outside the anonymous namespace: the exported
// fdiff_attention_fwd takes it.)
struct AttnFwdPlan {
  int kdh;         // head width of the instance: dh padded to the mma's k step
  int warps;       // per CTA: one per 16 query rows, at most 8
  int q_tiles;     // CTAs per head (grid.y): tiles of 128 query rows
  int key_blocks;  // blocks of 64 keys
  int stride;      // row stride (elements) of a staged K or V block
  int stage;       // elements of a stage of the ring
  int bytes;       // dynamic shared memory: two stages
};

namespace {

using fdiff::from_f;
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

// ---- B2: the attention forward on mma.sync tiles ---------------------------------------

namespace tc = fdiff::tc;

constexpr int kKeyBlock = 64;  // keys per block of the two passes; keys pad to it
constexpr int kWarpRows = 16;  // query rows per warp: one m16 tile
constexpr int kFwdWarps = 8;   // at most; 128 query rows per CTA
constexpr int kTileRows = kFwdWarps * kWarpRows;
constexpr int kFwdStages = 2;  // key blocks in the ring: one staged while one is used

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // a in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Key rows [j0, j0 + kKeyBlock) x columns [0, kDh) of a head's (L, dh) K or
// V (row-major, rows of dh) into a staged block of stride S, zero past L
// rows and dh columns, by cp.async in the caller's group: 16 bytes a copy
// where the rows allow it (tc::stage_tile), else 4 (one fp32, or a bf16
// pair where dh is even: the head widths 6 and 12), else plain loads.
template <typename T, int kDh>
__device__ __forceinline__ void stage_keys(T* __restrict__ s, int S, const T* __restrict__ g,
                                           int j0, int L, int dh) {
  constexpr int E = 4 / sizeof(T), per_row = kDh / E;
  if (dh % (16 / (int)sizeof(T)) == 0 || dh % E != 0 ||
      (reinterpret_cast<uintptr_t>(g) & 3) != 0) {
    tc::stage_tile<T, true>(s, S, g, dh, j0, kKeyBlock, L, 0, kDh, dh);
    return;
  }
  for (int c = threadIdx.x; c < kKeyBlock * per_row; c += blockDim.x) {
    const int r = c / per_row, i = (c % per_row) * E, gr = j0 + r;
    const int n = gr < L ? max(0, min(E, dh - i)) : 0;
    tc::cp_async4(s + r * S + i, n > 0 ? g + (size_t)gr * dh + i : g, n * (int)sizeof(T));
  }
}

// B2 over (B, H, L, dh) tensors: grid (B * H, p.q_tiles); blockDim p.warps
// warps. kFast: the max-free bf16 form; `scale` (rounded to bf16 by the
// caller) then scales q as it is loaded, rounded to bf16, in place of S.
template <typename T, bool kFast, int kDh>
__global__ void __launch_bounds__(kFwdWarps * 32)
attention_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o, int L, int dh,
                         float scale, AttnFwdPlan p) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int KS = kDh / (kF32 ? 8 : 16);  // k steps of q k^T
  constexpr int NO = kDh / 8;                 // n8 tiles of O
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  T* ring = reinterpret_cast<T*>(fwd_smem);
  const int S = p.stride, nb = p.key_blocks, steps = 2 * nb;
  const size_t base = (size_t)blockIdx.x * L * dh;

  // Step s of 2 nb stages key block s % nb into stage s % kFwdStages: K in
  // the first pass (s < nb), K and V in the second; zero past L keys and dh
  // columns.
  auto load = [&](int s) {
    T* sK = ring + (s % kFwdStages) * p.stage;
    const int j0 = (s % nb) * kKeyBlock;
    stage_keys<T, kDh>(sK, S, k + base, j0, L, dh);
    if (s >= nb) stage_keys<T, kDh>(sK + kKeyBlock * S, S, v + base, j0, L, dh);
  };
  load(0);
  tc::cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.y * kTileRows + warp * kWarpRows;
  const bool live = r0 < L;  // a warp past L still stages and waits at the barriers
  const T* qb = q + base;

  // This warp's q rows as A fragments, kept for both passes. fp32: element
  // e of a fragment is (row g + 8 (e & 1), column t + 4 (e >> 1)); bf16:
  // (row g + 8 (e & 1), columns 2t + 8 (e >> 1) and the next).
  auto q_at = [&](int r, int c) {
    const float x = (r < L && c < dh) ? to_f(qb[(size_t)r * dh + c]) : 0.0f;
    return kFast ? fdiff::round_to<T>(x * scale) : x;
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

  // S of the n8 tile at key n of the block staged at sK, whose first key
  // is j0 (accumulator layout: element e at row g + 8 (e >> 1), key n + 2t +
  // (e & 1)), scaled, clamped in the fast form; keys past L give -inf (0
  // weight in either form). fp32 K is split into TF32 hi and lo as it is
  // read.
  auto scores = [&](const T* sK, int j0, int n, float (&c)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = 0.0f;
    if (j0 + n < L) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t b[2];
        if constexpr (kF32) {
          const float* kr = reinterpret_cast<const float*>(sK) + (n + g) * S + 8 * ks + t;
          uint32_t bl[2];
          tc::split_tf32(kr[0], b[0], bl[0]);
          tc::split_tf32(kr[4], b[1], bl[1]);
          tc::mma_tf32(c, ql[ks], b);
          tc::mma_tf32(c, qa[ks], bl);
          tc::mma_tf32(c, qa[ks], b);
        } else {
          const T* kr = sK + (n + g) * S + 16 * ks + 2 * t;
          b[0] = *reinterpret_cast<const uint32_t*>(kr);
          b[1] = *reinterpret_cast<const uint32_t*>(kr + 8);
          tc::mma_bf16(c, qa[ks], b);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = j0 + n + 2 * t + (e & 1) < L;
      if constexpr (kFast)
        c[e] = in ? fminf(fmaxf(c[e], -kScoreClamp), kScoreClamp) : -INFINITY;
      else
        c[e] = in ? c[e] * scale : -INFINITY;
    }
  };

  // Pass 1, per row (g and g + 8): the running max and the sum of exp(s -
  // max) rescaled as the max grows (the fast form: the sum of exp(s)), over
  // this thread's keys of the block.
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.0f, 0.0f};
  auto pass1 = [&](const T* sK, int j0) {
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) scores(sK, j0, 8 * j, sc[j]);
    if constexpr (kFast) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) l[e >> 1] += __expf(sc[j][e]);
    } else {
      float mb[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mb[e >> 1] = fmaxf(mb[e >> 1], sc[j][e]);
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
  // Then over the row's four threads.
  float inv[2];  // the fast form's approximate reciprocal of the sum
  auto row_stats = [&]() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
        if constexpr (kFast) {
          l[r] += lo;
        } else {
          const float mo = __shfl_xor_sync(0xffffffffu, m[r], off), mn = fmaxf(m[r], mo);
          l[r] = l[r] * expf(m[r] - mn) + lo * expf(mo - mn);
          m[r] = mn;
        }
      }
      inv[r] = __fdividef(1.0f, l[r]);
    }
  };

  // Pass 2: S again, P = exp(s - max) / sum (fast: exp(s) * inv), rounded to
  // T, and O += P V from the accumulator registers.
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  auto pass2 = [&](const T* sK, const T* sV, int j0) {
    float pr[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      scores(sK, j0, 8 * j, pr[j]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        pr[j][e] = kFast ? __expf(pr[j][e]) * inv[r] : expf(pr[j][e] - m[r]) / l[r];
      }
    }
    if constexpr (kF32) {
      // The n8 tile's keys n + 2t and n + 2t + 1 are the mma's k = t and
      // t + 4: the accumulator (c0, c1; c2, c3) is then the A fragment
      // (a0, a2; a1, a3), and V's rows are read in the same order.
      const float* vf = reinterpret_cast<const float*>(sV);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j0 + 8 * j >= L) continue;
        uint32_t ah[4], al[4];
        const float pa[4] = {pr[j][0], pr[j][2], pr[j][1], pr[j][3]};
#pragma unroll
        for (int e = 0; e < 4; ++e) tc::split_tf32(pa[e], ah[e], al[e]);
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          if (8 * n >= dh) continue;
          const float* vr = vf + (8 * j + 2 * t) * S + 8 * n + g;
          uint32_t bh[2], bl[2];
          tc::split_tf32(vr[0], bh[0], bl[0]);
          tc::split_tf32(vr[S], bh[1], bl[1]);
          tc::mma_tf32(acc[n], al, bh);
          tc::mma_tf32(acc[n], ah, bl);
          tc::mma_tf32(acc[n], ah, bh);
        }
      }
    } else {
      // Two n8 tiles of P (16 keys) are one m16n8k16 A fragment, rounded to
      // bf16 as it is packed.
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (j0 + 16 * jj >= L) continue;
        const uint32_t a[4] = {pack_bf16(pr[2 * jj][0], pr[2 * jj][1]),
                               pack_bf16(pr[2 * jj][2], pr[2 * jj][3]),
                               pack_bf16(pr[2 * jj + 1][0], pr[2 * jj + 1][1]),
                               pack_bf16(pr[2 * jj + 1][2], pr[2 * jj + 1][3])};
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          if (8 * n >= dh) continue;
          uint32_t b[2];
          tc::ldmatrix_x2_trans(b, sV + (16 * jj + (lane & 15)) * S + 8 * n);
          tc::mma_bf16(acc[n], a, b);
        }
      }
    }
  };

  // The ring: step s + 1 is staged while step s is used. begin(s) waits
  // for step s's block and gives its stage; the barrier after its use
  // frees the stage for step s + 2.
  auto begin = [&](int s) {
    if (s + 1 < steps) load(s + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    return ring + (s % kFwdStages) * p.stage;
  };
  for (int s = 0; s < nb; ++s) {
    const T* sK = begin(s);
    if (live) pass1(sK, s * kKeyBlock);
    __syncthreads();
  }
  if (live) row_stats();
  for (int s = nb; s < steps; ++s) {
    const T* sK = begin(s);
    if (live) pass2(sK, sK + kKeyBlock * S, (s - nb) * kKeyBlock);
    __syncthreads();
  }
  if (!live) return;

  // O rounded to T: element e of tile n at (row g + 8 (e >> 1), column 8n +
  // 2t + (e & 1)).
  T* ob = o + base;
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e >> 1), c = 8 * n + 2 * t + (e & 1);
      if (r < L && c < dh) ob[(size_t)r * dh + c] = from_f<T>(acc[n][e]);
    }
}

template <typename T, bool kFast, int kDh>
int launch_fwd_mma(const void* q, const void* k, const void* v, void* o, int B, int H, int L,
                   int dh, float scale, const AttnFwdPlan& p, cudaStream_t stream) {
  if (B * H < 1 || L < 1 || dh > kDh || p.warps < 1 || p.warps > kFwdWarps ||
      p.stride < kDh || p.stage < 2 * kKeyBlock * p.stride ||
      p.bytes < kFwdStages * p.stage * (int)sizeof(T) || p.bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  auto kernel = attention_fwd_mma_kernel<T, kFast, kDh>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         p.bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(B * H, p.q_tiles), p.warps * 32, p.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), L, dh, scale, p);
  return (int)cudaGetLastError();
}

// B2's exact forms (fp32; bf16 with dh >= 16), the instance by the plan's
// head width.
template <typename T>
int launch_fwd_exact(const void* q, const void* k, const void* v, void* o, int B, int H, int L,
                     int dh, float scale, const AttnFwdPlan& p, cudaStream_t s) {
  switch (p.kdh) {
    case 8:
      if constexpr (sizeof(T) == 4)
        return launch_fwd_mma<T, false, 8>(q, k, v, o, B, H, L, dh, scale, p, s);
      break;
    case 16: return launch_fwd_mma<T, false, 16>(q, k, v, o, B, H, L, dh, scale, p, s);
    case 32: return launch_fwd_mma<T, false, 32>(q, k, v, o, B, H, L, dh, scale, p, s);
    case 64: return launch_fwd_mma<T, false, 64>(q, k, v, o, B, H, L, dh, scale, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---- B6-fwd: the attention forward with dropout ------------------------------------------

// fp32; P o keep before P v.
__global__ void __launch_bounds__(kThreads)
attention_dropout_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, float* __restrict__ o, int H, int L,
                             int dh, float scale, AttnDropout drop) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                       // L x dh
  float* vs = ks + L * dh;                // L x dh
  float* rows = vs + L * dh;              // kWarps x L scores
  float* qs = rows + kWarps * L;          // kWarps x kMaxDh query rows
  const size_t base = (size_t)blockIdx.x * L * dh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const HeadMask mask = head_mask<true>(drop, blockIdx.x / H, blockIdx.x % H);
  for (int e = threadIdx.x; e < L * dh; e += blockDim.x) {
    ks[e] = k[base + e];
    vs[e] = v[base + e];
  }
  __syncthreads();
  float* srow = rows + warp * L;
  float* qr = qs + warp * kMaxDh;
  for (int i = warp; i < L; i += kWarps) {
    for (int d = lane; d < dh; d += 32) qr[d] = q[base + (size_t)i * dh + d];
    __syncwarp();
    float m = -FLT_MAX;
    for (int j = lane; j < L; j += 32) {
      float s = 0.0f;
      for (int d = 0; d < dh; ++d) s = fmaf(qr[d], ks[j * dh + d], s);
      s *= scale;
      m = fmaxf(m, s);
      srow[j] = s;
    }
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(srow[j] - m);
      srow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < L; j += 32) srow[j] = srow[j] / sum * keep<true>(mask, i, j);
    __syncwarp();
    for (int d = 0; d < dh; ++d) {
      float acc = 0.0f;
      for (int j = lane; j < L; j += 32) acc = fmaf(srow[j], vs[j * dh + d], acc);
      acc = warp_sum(acc);
      if (lane == 0) o[base + (size_t)i * dh + d] = acc;
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

int launch_dropout_fwd(const void* q, const void* k, const void* v, void* o, int B, int H,
                       int L, int dh, float scale, const AttnDropout& drop,
                       cudaStream_t stream) {
  const int bytes = (2 * L * dh + kWarps * (L + kMaxDh)) * (int)sizeof(float);
  if (bytes > kMaxSmem || dh > kMaxDh) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_dropout_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  attention_dropout_fwd_kernel<<<B * H, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, L, dh, scale, drop);
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
// pre-scaled). plan: B2's launch (ops/flash_attention.py: attention_fwd_plan;
// unused with dropout). seed: null for no dropout, else one int64 in device
// memory (variant 0 only); thr, keep_scale and group as in AttnDropout. B
// chains of H heads of (L, dh). Returns cudaGetLastError() after the launch
// (0 on success), or the error that stopped it before.
int fdiff_attention_fwd(int variant, const void* q, const void* k, const void* v, void* o,
                        int B, int H, int L, int dh, float scale, const AttnFwdPlan* plan,
                        const void* seed, unsigned int thr, float keep_scale, int group,
                        void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (seed != nullptr) {
    if (variant != 0 || group < 1) return (int)cudaErrorInvalidValue;
    const AttnDropout drop{static_cast<const long long*>(seed), thr, keep_scale, group};
    return launch_dropout_fwd(q, k, v, o, B, H, L, dh, scale, drop, s);
  }
  if (plan == nullptr) return (int)cudaErrorInvalidValue;
  const AttnFwdPlan& p = *plan;
  if (variant == 0) return launch_fwd_exact<float>(q, k, v, o, B, H, L, dh, scale, p, s);
  if (variant == 1)
    return launch_fwd_exact<__nv_bfloat16>(q, k, v, o, B, H, L, dh, scale, p, s);
  if (variant == 2 && dh < 16 && p.kdh == 16)
    return launch_fwd_mma<__nv_bfloat16, true, 16>(q, k, v, o, B, H, L, dh, scale, p, s);
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
