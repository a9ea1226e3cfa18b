// Multi-head attention on mma.sync tiles for Hopper (sm_90a): the forward
// softmax(S) V and its backward as two launches, for heads whose rows lie at
// any row stride. Used by
//
//   csrc/flash_attention.cu        B2, B5 and B6 over (B, H, L, dh) tensors (the
//                                  unfused score network);
//   csrc/fused_encoder_train.cuh   the attention stages of the training layer,
//                                  B3's forward and B4's recompute and backward,
//                                  over the layer's packed (B*L, 3D) qkv, head h
//                                  at columns h dh, D + h dh and 2D + h dh, with
//                                  the layer's own dropout masks.
//
// Where the heads lie: with kPacked, an AttnLayout gives the inputs q, k, v
// and the outputs dq, dk, dv one offset and row stride per head, O and dO
// another (the training layer); without it every tensor is (B, H, L, dh),
// addressed as one offset per head at stride dh (B2, B5, B6: their
// instances keep that addressing, and its register use, at compile time).
// The outputs are rounded to T and, where an fp32 pointer is given, also
// written in fp32 at the same offsets (the training layer's dqkv beside the
// operand dqkvt it rounds for its products). A CTA serves one (chain, head)
// (blockIdx.x = b H + h) and 128 rows of it (blockIdx.y).
//
// The forward (attention_fwd_mma_kernel): a warp per 16 query rows (one m16
// tile), up to 8 warps, over key blocks of 64 rows in shared memory, filled
// by cp.async (16 bytes a copy where the rows allow it, else 4: stage_keys;
// zero past L keys and dh columns). Both products run on the tensor cores
// with mma_tile.cuh's fragments: bf16 m16n8k16, fp32 as 3xTF32 m16n8k8 (K
// and V split into TF32 hi and lo as fragments are read). To keep JAX's
// rounding points (P normalised and rounded to T before P v) the kernel makes
// two passes over the key blocks: the first keeps each row's running max and
// rescaled sum (per thread, then over the row's quad by shuffles), the
// second forms P, multiplies it by its keep factor (kDrop), rounds it and
// multiplies it by V straight from the accumulator registers (for fp32 the
// keys of an n8 tile are permuted so that the accumulator layout is the
// A-operand layout, and V's rows are read in the same permutation; in bf16
// P is formed two n8 tiles at a time, just before their product, and not
// past L). Where the head's K and V fit in half the shared memory (two CTAs
// to an SM; up to L = 1152 at dh 16 in bf16 and at dh 6 in fp32) they are
// staged once, K and V as two cp.async groups, so pass 1 waits for K alone
// while V's copy runs on, and pass 2 for V, with no barrier between their
// steps (resident); in bf16's exact form at L <= 128 (two key blocks) and
// kDh 16 each warp also keeps its rows' S over the keys in registers from
// pass 1, so pass 2 forms P from it without computing S again (kKept);
// longer heads stream K, then K and V again, through a ring of two key
// blocks, one staged while the other is used and a barrier per step, so
// shared memory does not grow with L and every length runs (pass 2 then
// computes S again, one small mma per key tile at these head widths). Every
// form sums each row over the keys in the same order with the same
// expressions, so all give the same bits. kFast is B2's bf16 max-free form
// (q pre-scaled, scores clamped to +-60, no max pass).
//
// The backward, JAX's _bwd_core: dq = dS k scale, dk = dS^T q scale, dv =
// P_used^T dO with dS = P o (dP o keep - D), as two launches on the
// forward's tiles, with no atomics: each output row is summed by one warp in
// one fixed order, so two calls on the same inputs are bit-identical, and a
// chain's result does not depend on the others in its batch.
//   Launch 1, attention_bwd_dq_mma_kernel: a CTA per (chain, head, 128 query
//   rows), a warp per 16 rows, over key blocks of 64. Pass 1 keeps
//   each row's running max and rescaled sum (the forward's first pass); in
//   fp32 D = dO . O takes the O the forward wrote (JAX recomputes O = P_used
//   v, which in fp32 differs only in summation order), in bf16 a second
//   pass recomputes O = P_used V unrounded in fp32 (the saved output is
//   rounded); the last pass computes dP = dO v^T, forms P and dS with the
//   keep factors, and adds dS K from the accumulator registers (in fp32 the
//   n8 tile's keys permuted as the forward feeds P into P v). It writes dq
//   and each row's (m, l, D) to a (B, H, L, 3) fp32 scratch. The three
//   passes depend on each other (D needs all of O, dS needs D), so on this
//   card their cost is set by how often the head is read and how often S
//   and P are formed: where the head's K and V fit in half the shared
//   memory (two CTAs to an SM; up to L = 1152 at dh 16 in bf16), they are
//   staged once and every pass reads them in place with no barrier
//   (resident); in bf16 at L <= 128 (two key blocks) and kDh 16 each warp
//   also keeps its S in registers from pass 1 and turns it into P once, so
//   the two later passes form neither again, and with dropout each entry's
//   keep bit from pass 2, so the hash runs once (kKept); longer heads stream K and V
//   through the ring of two key blocks, a barrier per step, so every length
//   runs. Every form sums each row over the keys in the same order.
//   Launch 2, attention_bwd_dkv_mma_kernel: a CTA per (chain, head, 128
//   keys), a warp per 16 keys, Q, dO and the rows' statistics streamed
//   through the ring in blocks of 64 query rows: S^T = k q^T scale and dP^T
//   = v dO^T, P^T from the statistics (0 for query rows at or past L, whose
//   statistics were never written), then dk += dS^T q and dv += (P o
//   keep)^T dO.
// In fp32 every product is 3xTF32 on mma.sync. In bf16 every product is bf16
// m16n8k16 with fp32 accumulation, at JAX's rounding points: P is the exact
// softmax in fp32; P_used = bf16(P keep) before P_used^T dO; dP = dO V^T
// from bf16 operands, times keep; dS = bf16(P (dP keep - D)) before dS K and
// dS^T Q; dq, dk scaled in fp32 and dq, dk, dv rounded to T as they are
// written. Two n8 tiles of P_used or dS in the accumulator layout are one A
// fragment, and the staged block's rows are its B operand through
// ldmatrix.trans. The keep factors are hashed per (i, j) in every launch
// (keep3 of encoder_layer.cuh). Launch 2's shared memory is two stages of
// two blocks and the fp32 statistics of 64 rows whatever L, launch 1's the
// head's K and V where resident, else the same ring (AttnBwdPlan). Scores and
// probabilities never reach device memory.

#pragma once

#include <cmath>
#include <type_traits>

#include "encoder_layer.cuh"
#include "mma_tile.cuh"

// The forward's launch, as ops/flash_attention.py's AttnFwdPlan passes it
// (computed there by attention_fwd_plan). Where resident the head's K and V
// lie whole in shared memory (K's key blocks, then V's); else a stage of the
// ring holds one key block of K, then (in the second pass) the same block of
// V: 64 rows (kKeyBlock) of stride elements each. (Outside the namespaces:
// the exported C functions and the training layer's plans take it.)
struct AttnFwdPlan {
  int kdh;         // head width of the instance: dh padded to the mma's k step
  int warps;       // per CTA: one per 16 query rows, at most 8
  int q_tiles;     // CTAs per head (grid.y): tiles of 128 query rows
  int key_blocks;  // blocks of 64 keys
  int stride;      // row stride (elements) of a staged K or V block
  int stage;       // elements of a stage of the ring
  int bytes;       // dynamic shared memory: the head's K and V where resident, else two stages
  int resident;    // the head's K and V staged whole: 2 blocks x 64 rows x stride
  int kept;        // S kept in registers from pass 1 (bf16 exact, resident, 2 blocks, kdh 16)
};

// The backward's two launches, as ops/flash_attention.py's AttnBwdPlan
// passes it (computed there by attention_bwd_plan). Launch 1 takes the rows
// of a tile as query rows and reads blocks of keys (K, then K and V), held
// whole in shared memory where resident, else streamed through the ring;
// launch 2 takes them as keys and streams blocks of query rows (Q, dO and
// their statistics) through the ring.
struct AttnBwdPlan {
  int kdh;       // head width of the instance: dh padded to the mma's k step (8, bf16 16), doubled
  int warps;     // per CTA: one per 16 rows, at most 8
  int tiles;     // CTAs per head (grid.y): tiles of 128 rows
  int blocks;    // blocks of 64 rows (keys in launch 1, query rows in launch 2)
  int stride;    // row stride (elements) of a staged block
  int stage;     // elements of a stage of the ring: two blocks and 64 rows of fp32 statistics
  int bytes;     // launch 2's dynamic shared memory (and launch 1's in the ring): two stages
  int resident;  // launch 1 holds the head's K and V whole: 2 blocks x 64 rows x stride
  int kept;      // launch 1 keeps S, then P, in registers (bf16, resident, 2 blocks, kdh 16)
  int dq_bytes;  // launch 1's dynamic shared memory
};

namespace fdiff {
namespace attn {

constexpr int kKeyBlock = 64;  // keys per block of the passes; keys pad to it
constexpr int kWarpRows = 16;  // query rows per warp: one m16 tile
constexpr int kMmaWarps = 8;   // at most; 128 query rows per CTA
constexpr int kTileRows = kMmaWarps * kWarpRows;
constexpr int kRingStages = 2;  // key blocks in the ring: one staged while one is used
constexpr int kKeptBlocks = 2;  // the forward and launch 1 keep S in registers over up to two key blocks
constexpr int kStatCols = 3;  // per query row: the softmax max m, its sum l, D = dO . O

// Where the heads lie, in elements. Head h of chain b: the inputs q, k, v
// and the outputs dq, dk, dv start chain_in b + head_in h past their
// pointers, rows ld_in apart; O and dO start chain_o b + head_o h past
// theirs, rows ld_o apart.
struct AttnLayout {
  long long chain_in, head_in, chain_o, head_o;
  int ld_in, ld_o;
};

// This CTA's head (blockIdx.x = b H + h): its chain, head, the offsets of
// its rows in the inputs and in O, and their strides. kPacked reads them
// from lay (the training layer's packed qkv); otherwise every tensor is
// (B, H, L, dh) and lay is not read, so B2's, B5's and B6's instances
// address their heads as one offset, (b H + h) L dh, at stride dh.
struct HeadAt {
  int b, h;
  size_t in, o;
  int ld, ldo;
};

template <bool kPacked>
__device__ __forceinline__ HeadAt head_at(const AttnLayout& lay, int H, int L, int dh) {
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  if constexpr (kPacked) {
    return {b, h, (size_t)(b * lay.chain_in + h * lay.head_in),
            (size_t)(b * lay.chain_o + h * lay.head_o), lay.ld_in, lay.ld_o};
  } else {
    const size_t base = (size_t)blockIdx.x * L * dh;
    return {b, h, base, base, dh, dh};
  }
}

// Dropout of the attention weights. Head h of chain b is keyed by tag =
// seed + b 131071 + g0 group_stride (uint32), g0 = h - h % group the first
// head of its group, and entry (i, j) kept where keep3's hash of (h - g0, i,
// j) is below thr, then scaled: B6's masks (seed in device memory,
// group_stride 1) and the training layer's ATTN site (seed_value,
// group_stride 104729: encoder_layer.cuh's attn_key).
struct AttnDropout {
  const long long* seed;  // one int64 in device memory, or null: seed_value
  uint32_t seed_value;
  uint32_t thr;           // keep where bits < thr: int((1 - rate) * (2**32 - 1))
  float scale;            // 1 / (1 - rate)
  int group;              // heads per head group
  uint32_t group_stride;  // the tag's step per head group
};

// The hash's parameters for head h of chain b: the Dropout of
// encoder_layer.cuh (for keep3), the tag and the head's index in its group.
struct HeadMask {
  Dropout dp;
  uint32_t tag;
  int g;
};

template <bool kDrop>
__device__ __forceinline__ HeadMask head_mask(const AttnDropout& drop, int b, int h) {
  HeadMask m{{0u, 0u, 1.0f, 1}, 0u, 0};
  if constexpr (kDrop) {
    const uint32_t seed =
        drop.seed != nullptr ? (uint32_t)(unsigned long long)(*drop.seed) : drop.seed_value;
    m.dp = Dropout{seed, drop.thr, drop.scale, drop.group};
    m.tag = seed + (uint32_t)b * 131071u + (uint32_t)(h - h % drop.group) * drop.group_stride;
    m.g = h % drop.group;
  }
  return m;
}

// keep / (1 - rate) of entry (i, j); 1 without dropout.
template <bool kDrop>
__device__ __forceinline__ float keep(const HeadMask& m, int i, int j) {
  return keep3<kDrop>(m.dp, m.tag, m.g, i, j);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // a in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Key rows [j0, j0 + rows) x columns [0, kDh) of a head's rows (row stride
// ld) into staged rows of stride S (a block of kKeyBlock rows, or the whole
// head), zero past L rows and dh columns, by cp.async in the caller's group:
// 16 bytes a copy where the rows allow it (tc::stage_tile), else 4 (one fp32,
// or a bf16 pair where dh and ld are even: the head widths 6 and 12), else
// plain loads.
template <typename T, int kDh>
__device__ __forceinline__ void stage_keys(T* __restrict__ s, int S, const T* __restrict__ g,
                                           int ld, int j0, int L, int dh,
                                           int rows = kKeyBlock) {
  constexpr int E = 4 / sizeof(T), per_row = kDh / E;
  if (dh % (16 / (int)sizeof(T)) == 0 || dh % E != 0 || ld % E != 0 ||
      (reinterpret_cast<uintptr_t>(g) & 3) != 0) {
    tc::stage_tile<T, true>(s, S, g, ld, j0, rows, L, 0, kDh, dh);
    return;
  }
  for (int c = threadIdx.x; c < rows * per_row; c += blockDim.x) {
    const int r = c / per_row, i = (c % per_row) * E, gr = j0 + r;
    const int n = gr < L ? max(0, min(E, dh - i)) : 0;
    tc::cp_async4(s + r * S + i, n > 0 ? g + (size_t)gr * ld + i : g, n * (int)sizeof(T));
  }
}

// The ring: step s + 1 is staged (load) while step s is used; ring_begin(s)
// waits for step s and gives its stage; the barrier after its use frees the
// stage for step s + 2.
template <typename T, typename Load>
__device__ __forceinline__ T* ring_begin(T* ring, int stage, int s, int steps, Load load) {
  if (s + 1 < steps) load(s + 1);
  tc::cp_async_commit();
  tc::cp_async_wait<1>();
  __syncthreads();
  return ring + (s % kRingStages) * stage;
}

// acc[n] += x . (rows n0 .. n0 + 7 of the staged block s, columns 8n ..
// 8n + 7) for the head width's NO n8 tiles, as 3xTF32. x is a tile in the
// accumulator layout over those 8 block rows (element e at row g + 8 (e >>
// 1), block row n0 + 2t + (e & 1)); taking block rows n0 + 2t and n0 + 2t +
// 1 as the mma's k = t and t + 4 makes (x0, x1; x2, x3) the A fragment (a0,
// a2; a1, a3), and the block's rows are read in the same order (the fp32 P
// v, dS K, dS^T Q and P^T dO).
template <int NO>
__device__ __forceinline__ void acc_times_block(float (&acc)[NO][4], const float (&x)[4],
                                                const float* __restrict__ s, int S, int n0,
                                                int dh) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float xa[4] = {x[0], x[2], x[1], x[3]};
  uint32_t ah[4], al[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) tc::split_tf32(xa[e], ah[e], al[e]);
  const float* r = s + (n0 + 2 * t) * S + g;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (8 * n >= dh) break;
    uint32_t bh[2], bl[2];
    tc::split_tf32(r[8 * n], bh[0], bl[0]);
    tc::split_tf32(r[8 * n + S], bh[1], bl[1]);
    tc::mma_tf32(acc[n], al, bh);
    tc::mma_tf32(acc[n], ah, bl);
    tc::mma_tf32(acc[n], ah, bh);
  }
}

// Rows [r0, r0 + 16) x columns [0, kDh) of a head's fp32 rows (stride ld) as
// m16n8k8 A fragments split into TF32 hi and lo (element e of k step ks:
// row g + 8 (e & 1), column 8 ks + t + 4 (e >> 1)), zero past L and dh.
template <int kDh>
struct RowFrags {
  uint32_t hi[kDh / 8][4], lo[kDh / 8][4];

  __device__ __forceinline__ void load(const float* __restrict__ x, int ld, int r0, int L,
                                       int dh) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int ks = 0; ks < kDh / 8; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + 8 * (e & 1), c = 8 * ks + t + 4 * (e >> 1);
        tc::split_tf32(r < L && c < dh ? x[(size_t)r * ld + c] : 0.0f, hi[ks][e], lo[ks][e]);
      }
  }
};

// The same rows of bf16 as m16n8k16 A fragments (element e of k step ks:
// row g + 8 (e & 1), columns 16 ks + 2t + 8 (e >> 1) and the next, the
// first in the low half), zero past L and dh.
template <int kDh>
struct RowFragsBf16 {
  uint32_t a[kDh / 16][4];

  __device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ x, int ld, int r0,
                                       int L, int dh) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    auto at = [&](int r, int c) { return r < L && c < dh ? to_f(x[(size_t)r * ld + c]) : 0.0f; };
#pragma unroll
    for (int ks = 0; ks < kDh / 16; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + 8 * (e & 1), c = 16 * ks + 2 * t + 8 * (e >> 1);
        a[ks][e] = pack_bf16(at(r, c), at(r, c + 1));
      }
  }
};

// A warp's 16 rows of T as the A fragments of its products.
template <typename T, int kDh>
using RowFragsOf = std::conditional_t<sizeof(T) == 4, RowFrags<kDh>, RowFragsBf16<kDh>>;

// c = (the 16 rows of a) . (rows n .. n + 7 of the staged block s)^T over the
// head width, as 3xTF32: element e at (row g + 8 (e >> 1), block row n + 2t
// + (e & 1)). The block's rows are split into TF32 hi and lo as they are read.
template <int kDh>
__device__ __forceinline__ void rows_dot_block(float (&c)[4], const RowFrags<kDh>& a,
                                               const float* __restrict__ s, int S, int n,
                                               int dh) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* r = s + (n + g) * S + t;
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < kDh / 8; ++ks) {
    if (8 * ks >= dh) break;
    uint32_t bh[2], bl[2];
    tc::split_tf32(r[8 * ks], bh[0], bl[0]);
    tc::split_tf32(r[8 * ks + 4], bh[1], bl[1]);
    tc::mma_tf32(c, a.lo[ks], bh);
    tc::mma_tf32(c, a.hi[ks], bl);
    tc::mma_tf32(c, a.hi[ks], bh);
  }
}

// The same over a staged bf16 block, on bf16 m16n8k16 with fp32 sums: the
// block row n + g's pairs of columns are the B fragment as they lie (the
// bf16 scores).
template <int kDh>
__device__ __forceinline__ void rows_dot_block(float (&c)[4], const RowFragsBf16<kDh>& a,
                                               const __nv_bfloat16* __restrict__ s, int S,
                                               int n, int dh) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* r = s + (n + g) * S + 2 * t;
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < kDh / 16; ++ks) {
    if (16 * ks >= dh) break;
    const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(r + 16 * ks),
                           *reinterpret_cast<const uint32_t*>(r + 16 * ks + 8)};
    tc::mma_bf16(c, a.a[ks], b);
  }
}

// acc[n] += (x0 | x1) . (rows n0 .. n0 + 15 of the staged bf16 block s,
// columns 8n .. 8n + 7) for the head width's NO n8 tiles, on bf16
// m16n8k16: x0 and x1 are two tiles in the accumulator layout over block
// rows n0 .. n0 + 7 and n0 + 8 .. n0 + 15 (element e at row g + 8 (e >> 1),
// block row 2t + (e & 1) of its eight), rounded to bf16 as they are packed
// into one A fragment, and the block's rows are the B operand through
// ldmatrix.trans (the bf16 P v, dS K, dS^T Q and P_used^T dO).
template <int NO>
__device__ __forceinline__ void pair_times_block(float (&acc)[NO][4], const float (&x0)[4],
                                                 const float (&x1)[4],
                                                 const __nv_bfloat16* __restrict__ s, int S,
                                                 int n0, int dh) {
  const int lane = threadIdx.x & 31;
  const uint32_t a[4] = {pack_bf16(x0[0], x0[1]), pack_bf16(x0[2], x0[3]),
                         pack_bf16(x1[0], x1[1]), pack_bf16(x1[2], x1[3])};
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (8 * n >= dh) break;
    uint32_t b[2];
    tc::ldmatrix_x2_trans(b, s + (n0 + (lane & 15)) * S + 8 * n);
    tc::mma_bf16(acc[n], a, b);
  }
}

// out[r0 + row, col] = acc * scale (rows ld apart) for the warp's rows below
// L and columns below dh (element e of tile n at row g + 8 (e >> 1), column
// 8n + 2t + (e & 1)): rounded to T, and in fp32 to out_f where not null.
template <typename T, int NO>
__device__ __forceinline__ void store_rows(T* __restrict__ out, float* __restrict__ out_f,
                                           int ld, const float (&acc)[NO][4], int r0, int L,
                                           int dh, float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e >> 1), c = 8 * n + 2 * t + (e & 1);
      if (r < L && c < dh) {
        const size_t at = (size_t)r * ld + c;
        const float x = acc[n][e] * scale;
        out[at] = from_f<T>(x);
        if (out_f != nullptr) out_f[at] = x;
      }
    }
}

// ---- the forward ------------------------------------------------------------------------

// grid (B * H, p.q_tiles); blockDim p.warps warps. kFast: the max-free bf16
// form; `scale` (rounded to bf16 by the caller) then scales q as it is
// loaded, rounded to bf16, in place of S. kDrop: P o keep before P v, with
// the mask of `drop`. Where p.resident, the head's K and V lie whole in
// shared memory (K's blocks, then V's), staged once as two cp.async groups;
// else they stream through the ring, a barrier per step. kKept (bf16 exact,
// resident, at most kKeptBlocks key blocks): each warp keeps its rows' S
// from pass 1 for pass 2 (the same values as computed again: the same
// products and scale).
template <typename T, bool kFast, bool kDrop, int kDh, bool kPacked, bool kKept>
__global__ void __launch_bounds__(kMmaWarps * 32)
attention_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o, AttnLayout lay, int H,
                         int L, int dh, float scale, AttnDropout drop, AttnFwdPlan p) {
  constexpr bool kF32 = sizeof(T) == 4;
  static_assert(!kDrop || !kFast, "dropout runs in the exact form only");
  static_assert(!kKept || (!kF32 && !kFast && kDh == 16), "S is kept in bf16's exact form");
  constexpr int KS = kDh / (kF32 ? 8 : 16);  // k steps of q k^T
  constexpr int NO = kDh / 8;                 // n8 tiles of O
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  T* smem = reinterpret_cast<T*>(fwd_smem);
  const int S = p.stride, nb = p.key_blocks, steps = 2 * nb;
  const bool resident = kKept || p.resident;
  const HeadAt at = head_at<kPacked>(lay, H, L, dh);
  const int ld = at.ld;
  // V's block lies this far past K's: past the head's K where resident, past
  // one block in a stage of the ring.
  const int v_off = (resident ? nb : 1) * kKeyBlock * S;

  // Ring step s of 2 nb stages key block s % nb into stage s % kRingStages:
  // K in the first pass (s < nb), K and V in the second; zero past L keys
  // and dh columns.
  auto load = [&](int s) {
    T* sK = smem + (s % kRingStages) * p.stage;
    const int j0 = (s % nb) * kKeyBlock;
    stage_keys<T, kDh>(sK, S, k + at.in, ld, j0, L, dh);
    if (s >= nb) stage_keys<T, kDh>(sK + kKeyBlock * S, S, v + at.in, ld, j0, L, dh);
  };
  if (resident) {
    stage_keys<T, kDh>(smem, S, k + at.in, ld, 0, L, dh, nb * kKeyBlock);
    tc::cp_async_commit();
    stage_keys<T, kDh>(smem + v_off, S, v + at.in, ld, 0, L, dh, nb * kKeyBlock);
  } else {
    load(0);
  }
  tc::cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.y * kTileRows + warp * kWarpRows;
  const bool live = r0 < L;  // a warp past L still stages and waits at the barriers
  const T* qb = q + at.in;
  const HeadMask mask = head_mask<kDrop>(drop, at.b, at.h);

  // This warp's q rows as A fragments, kept for both passes. fp32: element
  // e of a fragment is (row g + 8 (e & 1), column t + 4 (e >> 1)); bf16:
  // (row g + 8 (e & 1), columns 2t + 8 (e >> 1) and the next).
  auto q_at = [&](int r, int c) {
    const float x = (r < L && c < dh) ? to_f(qb[(size_t)r * ld + c]) : 0.0f;
    return kFast ? round_to<T>(x * scale) : x;
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

  // fn(b, sK, sV, j0) for each key block b of the pass whose first ring
  // step is `first` (K at sK, V at sV, first key j0), in block order, by the
  // live warps. Resident, the blocks lie in place (kKept: b a constant once
  // unrolled, so the kept tiles stay in registers); in the ring each step
  // waits for its stage and frees it after.
  auto each_block = [&](int first, auto&& fn) {
    if constexpr (kKept) {
#pragma unroll
      for (int b = 0; b < kKeptBlocks; ++b) {
        const T* sK = smem + b * kKeyBlock * S;
        if (b < nb && live) fn(b, sK, sK + v_off, b * kKeyBlock);
      }
    } else {
      for (int b = 0; b < nb; ++b) {
        const T* sK = resident ? smem + b * kKeyBlock * S
                               : ring_begin(smem, p.stage, first + b, steps, load);
        if (live) fn(b, sK, sK + v_off, b * kKeyBlock);
        if (!resident) __syncthreads();
      }
    }
  };
  // Resident, wait for K (group 0) before pass 1, for V (group 1) after it.
  auto resident_wait = [&](auto groups_left) {
    if (resident) {
      tc::cp_async_wait<decltype(groups_left)::value>();
      __syncthreads();
    }
  };

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
        uint32_t bb[2];
        if constexpr (kF32) {
          const float* kr = reinterpret_cast<const float*>(sK) + (n + g) * S + 8 * ks + t;
          uint32_t bl[2];
          tc::split_tf32(kr[0], bb[0], bl[0]);
          tc::split_tf32(kr[4], bb[1], bl[1]);
          tc::mma_tf32(c, ql[ks], bb);
          tc::mma_tf32(c, qa[ks], bl);
          tc::mma_tf32(c, qa[ks], bb);
        } else {
          const T* kr = sK + (n + g) * S + 16 * ks + 2 * t;
          bb[0] = *reinterpret_cast<const uint32_t*>(kr);
          bb[1] = *reinterpret_cast<const uint32_t*>(kr + 8);
          tc::mma_bf16(c, qa[ks], bb);
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

  // kKept: S of the warp's rows, per key block and n8 tile.
  float kept[kKept ? kKeptBlocks : 1][8][4];

  // Pass 1, per row (g and g + 8): the running max and the sum of exp(s -
  // max) rescaled as the max grows (the fast form: the sum of exp(s)), over
  // this thread's keys of the block.
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.0f, 0.0f};
  auto pass1 = [&](int b, const T* sK, const T*, int j0) {
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
        for (int e = 0; e < 4; ++e) {
          l[e >> 1] += expf(sc[j][e] - m[e >> 1]);
          if constexpr (kKept) kept[b][j][e] = sc[j][e];
        }
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

  // Pass 2: P = exp(s - max) / sum (fast: exp(s) * inv) of each n8 tile
  // from S again (or kept), with dropout times keep, rounded to T, and O +=
  // P V from the accumulator registers.
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  auto pass2 = [&](int b, const T* sK, const T* sV, int j0) {
    auto probs = [&](int j, float (&pr)[4]) {
      if constexpr (kKept) {
#pragma unroll
        for (int e = 0; e < 4; ++e) pr[e] = kept[b][j][e];
      } else {
        scores(sK, j0, 8 * j, pr);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        pr[e] = kFast ? __expf(pr[e]) * inv[r] : expf(pr[e] - m[r]) / l[r];
        if constexpr (kDrop)
          pr[e] *= keep<kDrop>(mask, r0 + g + 8 * r, j0 + 8 * j + 2 * t + (e & 1));
      }
    };
    if constexpr (kF32) {
      float pr[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) probs(j, pr[j]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j0 + 8 * j < L)
          acc_times_block(acc, pr[j], reinterpret_cast<const float*>(sV), S, 8 * j, dh);
    } else {
      // Two n8 tiles of P (16 keys), formed just before their product, are
      // one m16n8k16 A fragment, rounded to bf16 as it is packed.
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (j0 + 16 * jj >= L) continue;
        float pr[2][4];
        probs(2 * jj, pr[0]);
        probs(2 * jj + 1, pr[1]);
        pair_times_block(acc, pr[0], pr[1], reinterpret_cast<const __nv_bfloat16*>(sV), S,
                         16 * jj, dh);
      }
    }
  };

  resident_wait(std::integral_constant<int, 1>{});
  each_block(0, pass1);
  if (live) row_stats();
  resident_wait(std::integral_constant<int, 0>{});
  each_block(nb, pass2);
  if (!live) return;
  store_rows(o + at.o, static_cast<float*>(nullptr), at.ldo, acc, r0, L, dh, 1.0f);
}

// Checks the plan against the shape and launches the forward in T at the
// instance's head width kDh (its kKept instance where the plan keeps S).
template <typename T, bool kFast, bool kDrop, int kDh, bool kPacked>
cudaError_t launch_fwd_mma(const T* q, const T* k, const T* v, T* o, const AttnLayout& lay,
                           int B, int H, int L, int dh, float scale, const AttnDropout& drop,
                           const AttnFwdPlan& p, cudaStream_t stream) {
  constexpr bool kCanKeep = sizeof(T) == 2 && !kFast && kDh <= 16;
  const int head_bytes = 2 * p.key_blocks * kKeyBlock * p.stride * (int)sizeof(T);
  if (B * H < 1 || L < 1 || dh > kDh || p.warps < 1 || p.warps > kMmaWarps ||
      (p.q_tiles - 1) * kTileRows + p.warps * kWarpRows < L || p.key_blocks * kKeyBlock < L ||
      p.stride < kDh || p.stage < 2 * kKeyBlock * p.stride ||
      (p.resident != 0 && p.resident != 1) || (p.kept != 0 && p.kept != 1) ||
      p.bytes < (p.resident ? head_bytes : kRingStages * p.stage * (int)sizeof(T)) ||
      p.bytes > kMaxSmem || (p.resident && head_bytes > kMaxSmem / 2) ||
      (p.kept && !(kCanKeep && p.resident && p.key_blocks <= kKeptBlocks)))
    return cudaErrorInvalidValue;
  auto kernel = attention_fwd_mma_kernel<T, kFast, kDrop, kDh, kPacked, false>;
  if constexpr (kCanKeep)
    if (p.kept) kernel = attention_fwd_mma_kernel<T, kFast, kDrop, kDh, kPacked, true>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         p.bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * H, p.q_tiles), p.warps * 32, p.bytes, stream>>>(q, k, v, o, lay, H, L, dh,
                                                                    scale, drop, p);
  return cudaGetLastError();
}

// The exact forms (fp32; bf16), with or without dropout, the instance by the
// plan's head width (bf16 from 16).
template <typename T, bool kDrop, bool kPacked>
cudaError_t launch_fwd_exact(const T* q, const T* k, const T* v, T* o, const AttnLayout& lay,
                             int B, int H, int L, int dh, float scale, const AttnDropout& drop,
                             const AttnFwdPlan& p, cudaStream_t s) {
  auto launch = [&](auto kdh) {
    return launch_fwd_mma<T, false, kDrop, decltype(kdh)::value, kPacked>(
        q, k, v, o, lay, B, H, L, dh, scale, drop, p, s);
  };
  switch (p.kdh) {
    case 8:
      if constexpr (sizeof(T) == 4) return launch(std::integral_constant<int, 8>{});
      break;
    case 16: return launch(std::integral_constant<int, 16>{});
    case 32: return launch(std::integral_constant<int, 32>{});
    case 64: return launch(std::integral_constant<int, 64>{});
  }
  return cudaErrorInvalidValue;
}

// ---- the backward -----------------------------------------------------------------------

// Launch 1: grid (B * H, p.tiles), p.warps warps, a warp per 16 query rows.
// dq = scale dS K, and (m, l, D) of each row
// into stats (B, H, L, 3) in fp32. The passes over the key blocks: the
// statistics (K), in bf16 O = P_used V for D (K and V), then dq (K and V).
// In bf16 `o` is not read. Where p.resident, the head's K and V lie whole in
// shared memory (K's blocks, then V's), staged once as two cp.async groups,
// and every pass reads them there with no barrier between its steps; else
// they stream through the ring, a barrier per step. kKept (bf16, resident, at
// most kKeptBlocks key blocks): each warp keeps its rows' S over the keys in
// registers from pass 1 and turns it into P once the statistics are known,
// so the later passes compute neither again (the same values as computed
// again: the same products and the same expf(s - m) / l), and with dropout
// the keep bits that pass 2 hashed, for the last pass.
template <typename T, bool kDrop, int kDh, bool kPacked, bool kKept>
__global__ void __launch_bounds__(kMmaWarps * 32)
attention_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ o,
                            const T* __restrict__ dout, T* __restrict__ dq,
                            float* __restrict__ dq_f, float* __restrict__ stats, AttnLayout lay,
                            int H, int L, int dh, float scale, AttnDropout drop, AttnBwdPlan p) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int NO = kDh / 8;  // n8 tiles of a row of dq (and of O)
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  T* smem = reinterpret_cast<T*>(bwd_smem);
  const int S = p.stride, nb = p.blocks, steps = (kF32 ? 2 : 3) * nb;
  const bool resident = kKept || p.resident;
  const HeadAt at = head_at<kPacked>(lay, H, L, dh);
  const int ld = at.ld, ldo = at.ldo;
  // V's block lies this far past K's: past the head's K where resident, past
  // one block in a stage of the ring.
  const int v_off = (resident ? nb : 1) * kKeyBlock * S;

  // Ring step s stages key block s % nb: K in pass 1 (s < nb), K and V in
  // the passes after; zero past L keys and dh columns.
  auto load = [&](int s) {
    T* sK = smem + (s % kRingStages) * p.stage;
    const int j0 = (s % nb) * kKeyBlock;
    stage_keys<T, kDh>(sK, S, k + at.in, ld, j0, L, dh);
    if (s >= nb) stage_keys<T, kDh>(sK + kKeyBlock * S, S, v + at.in, ld, j0, L, dh);
  };
  if (resident) {
    stage_keys<T, kDh>(smem, S, k + at.in, ld, 0, L, dh, nb * kKeyBlock);
    tc::cp_async_commit();
    stage_keys<T, kDh>(smem + v_off, S, v + at.in, ld, 0, L, dh, nb * kKeyBlock);
  } else {
    load(0);
  }
  tc::cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.y * kTileRows + warp * kWarpRows;
  const bool live = r0 < L;  // a warp past L still stages and waits at the barriers
  const HeadMask mask = head_mask<kDrop>(drop, at.b, at.h);
  RowFragsOf<T, kDh> qf, df;
  if (live) qf.load(q + at.in, ld, r0, L, dh);

  // fn(b, sK, sV, j0) for each key block b of the pass whose first ring
  // step is `first` (K at sK, V at sV, first key j0), in block order, by the
  // live warps. Resident, the blocks lie in place (kKept: b a constant once
  // unrolled, so the kept tiles stay in registers); in the ring each step
  // waits for its stage and frees it after.
  auto each_block = [&](int first, auto&& fn) {
    if constexpr (kKept) {
#pragma unroll
      for (int b = 0; b < kKeptBlocks; ++b) {
        const T* sK = smem + b * kKeyBlock * S;
        if (b < nb && live) fn(b, sK, sK + v_off, b * kKeyBlock);
      }
    } else {
      for (int b = 0; b < nb; ++b) {
        const T* sK = resident ? smem + b * kKeyBlock * S
                               : ring_begin(smem, p.stage, first + b, steps, load);
        if (live) fn(b, sK, sK + v_off, b * kKeyBlock);
        if (!resident) __syncthreads();
      }
    }
  };
  // Resident, wait for K (group 0) before pass 1, for V (group 1) after it.
  auto resident_wait = [&](auto groups_left) {
    if (resident) {
      tc::cp_async_wait<decltype(groups_left)::value>();
      __syncthreads();
    }
  };

  // S of the n8 tile at key n of the block staged at sK, whose first key is
  // j0, scaled; keys past L give -inf (0 weight).
  auto scores = [&](const T* sK, int j0, int n, float (&c)[4]) {
    if (j0 + n < L) rows_dot_block(c, qf, sK, S, n, dh);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      c[e] = j0 + n + 2 * t + (e & 1) < L ? c[e] * scale : -INFINITY;
  };

  // kKept: S of the warp's rows, per key block and n8 tile, then P; with
  // dropout, each kept entry's keep bit (bit 4 j + e of block b), hashed in
  // pass 2 for the last pass (keep3 gives exactly drop.scale or 0).
  float kept[kKept ? kKeptBlocks : 1][8][4];
  uint32_t kept_bits[kKept && kDrop ? kKeptBlocks : 1] = {};

  // Pass 1, per row (g and g + 8): the running max and the sum of exp(s -
  // max) rescaled as the max grows, over this thread's keys of the block;
  // then over the row's four threads.
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.0f, 0.0f};
  auto pass1 = [&](int b, const T* sK, const T*, int j0) {
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) scores(sK, j0, 8 * j, sc[j]);
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
      for (int e = 0; e < 4; ++e) {
        l[e >> 1] += expf(sc[j][e] - m[e >> 1]);
        if constexpr (kKept) kept[b][j][e] = sc[j][e];
      }
  };
  resident_wait(std::integral_constant<int, 1>{});
  each_block(0, pass1);

  // The row statistics over the quad, and in fp32 D = dO . O of each row
  // from the forward's O (a quad thread per fourth column, then over the
  // quad), both the same in all four threads.
  float D[2] = {0.0f, 0.0f};
  if (live) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
        const float mo = __shfl_xor_sync(0xffffffffu, m[r], off), mn = fmaxf(m[r], mo);
        l[r] = l[r] * expf(m[r] - mn) + lo * expf(mo - mn);
        m[r] = mn;
      }
      if constexpr (kF32) {
        const int row = r0 + g + 8 * r;
        if (row < L)
          for (int c = t; c < dh; c += 4)
            D[r] = fmaf(to_f(dout[at.o + (size_t)row * ldo + c]),
                        to_f(o[at.o + (size_t)row * ldo + c]), D[r]);
        D[r] += __shfl_xor_sync(0xffffffffu, D[r], 1);
        D[r] += __shfl_xor_sync(0xffffffffu, D[r], 2);
      }
    }
    df.load(dout + at.o, ldo, r0, L, dh);
    // kKept: P = exp(s - m) / l of every kept tile (0 past L).
    if constexpr (kKept) {
#pragma unroll
      for (int b = 0; b < kKeptBlocks; ++b)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (b < nb) kept[b][j][e] = expf(kept[b][j][e] - m[e >> 1]) / l[e >> 1];
    }
  }
  resident_wait(std::integral_constant<int, 0>{});

  // bf16, pass 2: O = P_used V in fp32 from the accumulator registers, with
  // P_used = bf16(P keep) (JAX's _bwd_core), then D = dO . O per row (each
  // thread over its columns, then over the quad).
  if constexpr (!kF32) {
    float oacc[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[n][e] = 0.0f;
    auto pass_o = [&](int b, const T* sK, const T* sV, int j0) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (j0 + 16 * jj >= L) break;
        float pk[2][4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int n = 16 * jj + 8 * hh;
          if constexpr (!kKept) scores(sK, j0, n, pk[hh]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            if constexpr (kKept) {
              const float kp = keep<kDrop>(mask, r0 + g + 8 * r, j0 + n + 2 * t + (e & 1));
              if constexpr (kDrop) kept_bits[b] |= (kp != 0.0f ? 1u : 0u) << (n / 2 + e);
              pk[hh][e] = kept[b][2 * jj + hh][e] * kp;
            } else
              pk[hh][e] = expf(pk[hh][e] - m[r]) / l[r] *
                          keep<kDrop>(mask, r0 + g + 8 * r, j0 + n + 2 * t + (e & 1));
          }
        }
        pair_times_block(oacc, pk[0], pk[1], reinterpret_cast<const __nv_bfloat16*>(sV), S,
                         16 * jj, dh);
      }
    };
    each_block(nb, pass_o);
    if (live) {
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + g + 8 * (e >> 1), c = 8 * n + 2 * t + (e & 1);
          if (row < L && c < dh)
            D[e >> 1] = fmaf(to_f(dout[at.o + (size_t)row * ldo + c]), oacc[n][e],
                             D[e >> 1]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        D[r] += __shfl_xor_sync(0xffffffffu, D[r], 1);
        D[r] += __shfl_xor_sync(0xffffffffu, D[r], 2);
      }
    }
  }

  // The last pass: dP = dO V^T per n8 tile of keys, P = exp(s - m) / l (S
  // again, or kept), dS = P (dP keep - D) (in bf16 rounded as it is packed),
  // and dq += dS K from the accumulator registers.
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  auto ds_tile = [&](int b, const T* sK, const T* sV, int j0, int n, float (&ds)[4]) {
    float pr[4], dp[4];
    if constexpr (kKept) {
#pragma unroll
      for (int e = 0; e < 4; ++e) pr[e] = kept[b][n / 8][e];
    } else {
      scores(sK, j0, n, pr);
#pragma unroll
      for (int e = 0; e < 4; ++e) pr[e] = expf(pr[e] - m[e >> 1]) / l[e >> 1];
    }
    rows_dot_block(dp, df, sV, S, n, dh);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, i = r0 + g + 8 * r, jj = j0 + n + 2 * t + (e & 1);
      float kp;
      if constexpr (kKept && kDrop)
        kp = (kept_bits[b] >> (n / 2 + e)) & 1u ? mask.dp.scale : 0.0f;
      else
        kp = keep<kDrop>(mask, i, jj);
      ds[e] = pr[e] * (dp[e] * kp - D[r]);
    }
  };
  auto pass_dq = [&](int b, const T* sK, const T* sV, int j0) {
    if constexpr (kF32) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j0 + 8 * j >= L) break;
        float ds[4];
        ds_tile(b, sK, sV, j0, 8 * j, ds);
        acc_times_block(acc, ds, reinterpret_cast<const float*>(sK), S, 8 * j, dh);
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (j0 + 16 * jj >= L) break;
        float ds[2][4];
        ds_tile(b, sK, sV, j0, 16 * jj, ds[0]);
        ds_tile(b, sK, sV, j0, 16 * jj + 8, ds[1]);
        pair_times_block(acc, ds[0], ds[1], reinterpret_cast<const __nv_bfloat16*>(sK), S,
                         16 * jj, dh);
      }
    }
  };
  each_block(steps - nb, pass_dq);
  if (!live) return;

  store_rows(dq + at.in, dq_f != nullptr ? dq_f + at.in : nullptr, ld, acc, r0, L, dh, scale);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (row < L) {
        float* st = stats + ((size_t)blockIdx.x * L + row) * kStatCols;
        st[0] = m[r];
        st[1] = l[r];
        st[2] = D[r];
      }
    }
  }
}

// Launch 2 over the same heads: grid (B * H, p.tiles), p.warps warps, a
// warp per 16 keys. dk = scale dS^T Q and dv = (P o keep)^T dO, with P^T
// formed from launch 1's statistics.
template <typename T, bool kDrop, int kDh, bool kPacked>
__global__ void __launch_bounds__(kMmaWarps * 32)
attention_bwd_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ dout,
                             const float* __restrict__ stats, T* __restrict__ dk,
                             T* __restrict__ dv, float* __restrict__ dk_f,
                             float* __restrict__ dv_f, AttnLayout lay, int H, int L, int dh,
                             float scale, AttnDropout drop, AttnBwdPlan p) {
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  T* ring = reinterpret_cast<T*>(bwd_smem);
  const int S = p.stride, nb = p.blocks;
  const HeadAt at = head_at<kPacked>(lay, H, L, dh);
  const int ld = at.ld, ldo = at.ldo;
  const float* head_stats = stats + (size_t)blockIdx.x * L * kStatCols;

  // Step s stages query block s: its rows of Q and dO (zero past L rows and
  // dh columns) and their fp32 statistics (zero past L).
  auto load = [&](int s) {
    T* sQ = ring + (s % kRingStages) * p.stage;
    const int i0 = s * kKeyBlock;
    stage_keys<T, kDh>(sQ, S, q + at.in, ld, i0, L, dh);
    stage_keys<T, kDh>(sQ + kKeyBlock * S, S, dout + at.o, ldo, i0, L, dh);
    float* st = reinterpret_cast<float*>(sQ + 2 * kKeyBlock * S);
    for (int c = threadIdx.x; c < kKeyBlock * kStatCols; c += blockDim.x) {
      const bool in = i0 + c / kStatCols < L;
      tc::cp_async4(st + c, in ? head_stats + (size_t)i0 * kStatCols + c : head_stats,
                    in ? 4 : 0);
    }
  };
  load(0);
  tc::cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.y * kTileRows + warp * kWarpRows;
  const bool live = r0 < L;
  const HeadMask mask = head_mask<kDrop>(drop, at.b, at.h);
  RowFragsOf<T, kDh> kf, vf;
  if (live) {
    kf.load(k + at.in, ld, r0, L, dh);
    vf.load(v + at.in, ld, r0, L, dh);
  }
  float dka[kDh / 8][4], dva[kDh / 8][4];
#pragma unroll
  for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;

  // Per n8 tile of query rows: S^T and dP^T, P^T = exp(s - m) / l (0 past
  // L, in either direction), dS^T = P^T (dP^T keep - D), then dk += dS^T Q
  // and dv += (P^T keep) dO from the accumulator registers (in bf16 both
  // rounded as they are packed, two tiles to a fragment).
  auto block = [&](const T* sQ, int i0) {
    const T* sD = sQ + kKeyBlock * S;
    const float* st = reinterpret_cast<const float*>(sQ + 2 * kKeyBlock * S);
    auto tile = [&](int n, float (&ds)[4], float (&pk)[4]) {
      float sc[4], dp[4];
      rows_dot_block(sc, kf, sQ, S, n, dh);
      rows_dot_block(dp, vf, sD, S, n, dh);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = r0 + g + 8 * (e >> 1), il = n + 2 * t + (e & 1), i = i0 + il;
        const float* sti = st + il * kStatCols;
        const float pr = i < L && key < L ? expf(sc[e] * scale - sti[0]) / sti[1] : 0.0f;
        const float kp = keep<kDrop>(mask, i, key);
        ds[e] = pr * (dp[e] * kp - sti[2]);
        pk[e] = pr * kp;
      }
    };
    if constexpr (kF32) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (i0 + 8 * j >= L) break;
        float ds[4], pk[4];
        tile(8 * j, ds, pk);
        acc_times_block(dka, ds, reinterpret_cast<const float*>(sQ), S, 8 * j, dh);
        acc_times_block(dva, pk, reinterpret_cast<const float*>(sD), S, 8 * j, dh);
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (i0 + 16 * jj >= L) break;
        float ds[2][4], pk[2][4];
        tile(16 * jj, ds[0], pk[0]);
        tile(16 * jj + 8, ds[1], pk[1]);
        pair_times_block(dka, ds[0], ds[1], reinterpret_cast<const __nv_bfloat16*>(sQ), S,
                         16 * jj, dh);
        pair_times_block(dva, pk[0], pk[1], reinterpret_cast<const __nv_bfloat16*>(sD), S,
                         16 * jj, dh);
      }
    }
  };
  for (int s = 0; s < nb; ++s) {
    const T* sQ = ring_begin(ring, p.stage, s, nb, load);
    if (live) block(sQ, s * kKeyBlock);
    __syncthreads();
  }
  if (!live) return;
  store_rows(dk + at.in, dk_f != nullptr ? dk_f + at.in : nullptr, ld, dka, r0, L, dh, scale);
  store_rows(dv + at.in, dv_f != nullptr ? dv_f + at.in : nullptr, ld, dva, r0, L, dh, 1.0f);
}

// The backward's tensors: q, k, v (and dq, dk, dv, with their fp32 copies
// where not null) on lay's input rows, o (read in fp32 only) and dO on its O
// rows; stats (B, H, L, 3) fp32.
template <typename T>
struct AttnBwdArgs {
  const T *q, *k, *v, *o, *dout;
  T *dq, *dk, *dv;
  float *dq_f, *dk_f, *dv_f, *stats;
  AttnLayout lay;
};

// The backward in T at the instance's head width: launch 1 (its kKept
// instance where the plan keeps S), then launch 2 on the same stream. A
// stage holds two blocks of T and the fp32 statistics of kKeyBlock rows;
// stats is (B, H, L, 3) fp32.
template <typename T, bool kDrop, int kDh, bool kPacked>
cudaError_t launch_bwd_mma(const AttnBwdArgs<T>& a, int B, int H, int L, int dh, float scale,
                           const AttnDropout& drop, const AttnBwdPlan& p, cudaStream_t stream) {
  constexpr int kStatElems = kKeyBlock * kStatCols * (int)(sizeof(float) / sizeof(T));
  constexpr bool kCanKeep = sizeof(T) == 2 && kDh <= 16;
  const int head_bytes = 2 * p.blocks * kKeyBlock * p.stride * (int)sizeof(T);
  if (B * H < 1 || L < 1 || dh > kDh || p.warps < 1 || p.warps > kMmaWarps ||
      (p.tiles - 1) * kTileRows + p.warps * kWarpRows < L || p.blocks * kKeyBlock < L ||
      p.stride < kDh ||
      p.stage < 2 * kKeyBlock * p.stride + kStatElems ||
      p.bytes < kRingStages * p.stage * (int)sizeof(T) || p.bytes > kMaxSmem ||
      p.dq_bytes < (p.resident ? head_bytes : p.bytes) || p.dq_bytes > kMaxSmem ||
      (p.kept && !(kCanKeep && p.resident && p.blocks <= kKeptBlocks)))
    return cudaErrorInvalidValue;
  auto dq_kernel = attention_bwd_dq_mma_kernel<T, kDrop, kDh, kPacked, false>;
  if constexpr (kCanKeep)
    if (p.kept) dq_kernel = attention_bwd_dq_mma_kernel<T, kDrop, kDh, kPacked, true>;
  auto dkv_kernel = attention_bwd_dkv_mma_kernel<T, kDrop, kDh, kPacked>;
  cudaError_t err =
      cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.dq_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, p.tiles);
  dq_kernel<<<grid, p.warps * 32, p.dq_bytes, stream>>>(a.q, a.k, a.v, a.o, a.dout, a.dq,
                                                        a.dq_f, a.stats, a.lay, H, L, dh,
                                                        scale, drop, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<<<grid, p.warps * 32, p.bytes, stream>>>(a.q, a.k, a.v, a.dout, a.stats, a.dk,
                                                      a.dv, a.dk_f, a.dv_f, a.lay, H, L, dh,
                                                      scale, drop, p);
  return cudaGetLastError();
}

// The instance by the plan's head width (bf16 from 16).
template <typename T, bool kDrop, bool kPacked>
cudaError_t launch_bwd(const AttnBwdArgs<T>& a, int B, int H, int L, int dh, float scale,
                       const AttnDropout& drop, const AttnBwdPlan& p, cudaStream_t s) {
  switch (p.kdh) {
    case 8:
      if constexpr (sizeof(T) == 4)
        return launch_bwd_mma<T, kDrop, 8, kPacked>(a, B, H, L, dh, scale, drop, p, s);
      break;
    case 16: return launch_bwd_mma<T, kDrop, 16, kPacked>(a, B, H, L, dh, scale, drop, p, s);
    case 32: return launch_bwd_mma<T, kDrop, 32, kPacked>(a, B, H, L, dh, scale, drop, p, s);
    case 64: return launch_bwd_mma<T, kDrop, 64, kPacked>(a, B, H, L, dh, scale, drop, p, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace attn
}  // namespace fdiff
