// One post-LN transformer encoder layer on Hopper's tensor cores (sm_90a),
// in four launches over the B*L rows of the batch:
//
//   1. qkv = x W_qkv + b_qkv, rounded to T: gemm_kernel (mma_tile.cuh) over
//      all rows, so K|V are computed once per row;
//   2. attention_fwd_kernel, one CTA per (128 query rows, head, chain), a
//      thread per query row, K and V staged in shared memory:
//      P = softmax(q k^T) * keep, O = round(P V);
//   3. layer_tail_kernel, a persistent schedule of two CTAs per SM (one
//      where two do not fit) over the units (row tile of 16 or 32 rows, d_ff
//      chunk of 64) (TailSchedule):
//      per row tile it holds, the out projection, dropout, residual, LN1,
//      then the FFN over its chunks with the hidden chunk in shared memory,
//      and the partial sum f2 of those chunks to device memory;
//   4. tail_finish_kernel, a warp per row: the row's partials in a fixed
//      order, dropout, residual, LN2.
//   Where D is wider than the tail's register tiles (256), 3 and 4 run
//   instead as five launches through device memory (launch_layer_tail_wide).
//
// Used by the sampling layer B1 (fused_encoder.cu: T = float or bf16, no
// dropout), by the training forward B3 and by the training backward B4's
// recompute of that forward (fused_encoder_train.cu: T = float, dropout).
// The tail's TailMode says which: kTailSample (B1), kTailTrainFwd (B3:
// dropout at the out, FF and FF2 sites, LN2's output) or kTailTrainBwd
// (B4: dropout, and in place of LN2's output the normalised LN inputs, their
// inverse deviations and LN2's backward).
//
// Numerics are the TPU kernels': products take operands in T and
// accumulate in fp32 (bf16 on the tensor cores, fp32 as 3xTF32); results
// are rounded to T after qkv, P, O, LN1, the ReLU and LN2; LayerNorm
// statistics in fp32 with eps 1e-5; fp32 takes the exact max-subtracted
// softmax, bf16 the max-free one with scores clamped to +-60. Dropout masks
// come from encoder_layer.cuh's hash at the TPU kernels' positions.
//
// What bounds it, and the design: at the flagship's shape (D 72, F 2048,
// L 100) the layer is 90 % FFN products and is bound by operations; the
// first body ran every product on the fp32 CUDA cores, each thread reading
// its weights from L2 element by element, in less than one wave of CTAs.
// Here every product is an mma.sync tile product: weights stream through a
// three-slot ring of shared-memory tiles filled by cp.async, two tiles in
// flight while one is multiplied, so no thread reads a weight for its own
// FMA. The QKV product and attention run 200 and 384 CTAs at B=32, L=100.
// The tail's 100 row tiles of 32 rows there would leave 32 of the 132 SMs
// idle, and 200 tiles of 16 rows measured slower on an H100 (two tiles on
// some SMs): so the tail splits the 3200 (row tile, chunk) units evenly
// over 264 CTAs instead, 12 or 13 each. Two CTAs share each SM (their
// registers bounded for it), which on an H100 ran faster than one CTA per
// SM with twice the units: each hides the other's latency.
//
// The tail's plan (TailPlan) is computed by the Python wrapper
// (ops/fused_encoder.py: tail_plan) and passed in.

#pragma once

#include "encoder_layer.cuh"
#include "mma_tile.cuh"

namespace fdiff {

constexpr int kTailThreads = 256;  // 8 warps
constexpr int kTailMaxKT = 128;   // k-rows of a weight tile, at most
constexpr int kTailMaxFC = 128;   // d_ff chunk, at most
constexpr int kTailMaxD = 256;    // columns of the register tiles (16-row tiles; 32: 128)
constexpr int kAttnThreads = 128;

// What the tail does besides the layer's arithmetic, fixed at compile time.
enum TailMode { kTailSample, kTailTrainFwd, kTailTrainBwd };
__host__ __device__ constexpr bool tail_drops(TailMode m) { return m != kTailSample; }

// The tail's plan, as ops/fused_encoder.py's TailPlan passes it: with
// wide, the tail runs as launch_layer_tail_wide (the other fields unused);
// else layer_tail_kernel's tiles and shared-memory plan. Element strides of
// the T tiles; byte offsets.
struct TailPlan {
  int wide;   // 1: D wider than the register tiles (kTailMaxD)
  int tm;     // rows per CTA: 16 or 32
  int kt;     // k-rows of a streamed weight tile: kd (D <= 128) or 64
  int fc;     // d_ff chunk
  int slots;  // weight tiles in the ring: 3, or 2 where 3 do not fit
  int kd;     // D rounded up to the k step of T
  int dn;     // D rounded up to 8
  int sa;     // stride of sA (tm x kd, T): O, then x1
  int sh;     // stride of sH (tm x fc, T): the hidden chunk
  int swo;    // stride of a [kt or fc][dn] weight tile (W_out, W2 chunk)
  int sw1;    // stride of a [kt][fc] weight tile (W1 chunk)
  int slot;   // elements of one ring slot
  int off_a, off_h, off_ring, off_pre, bytes;
};

// What the tail writes in kTailTrainBwd besides x1 (all fp32, N x D unless
// noted): xhat1 / inv1 (N), xhat2 / inv2 (N), g2 = LN2's input gradient,
// df2 = g2 * keep_ff2; dy is read.
struct TailTrain {
  float* xhat1; float* inv1; float* xhat2; float* inv2; float* g2; float* df2;
  const float* dy;
};

// The tail's device-memory workspace. Fused route: x1 (N x D, fp32; LN1's
// output) and part (the f2 partials, TailSchedule::parts x tm x D, fp32).
// Wide route: pre (N x D, fp32), x1t (N x D) and h (N x F) in T.
template <typename T>
struct TailWs {
  float* x1; float* part; float* pre; T* x1t; T* h;
};

// The fused tail's persistent schedule. Its units are (row tile, d_ff
// chunk), tile-major; CTA k of G (ops/fused_encoder.py: tail_schedule)
// takes the units [k U / G, (k + 1) U / G), so every SM gets the same
// share of the FFN whether or not the row tiles divide evenly among them. The units of one CTA within one row tile are
// a segment; its f2 partial goes to slot tile + k (unique: a later CTA
// never holds an earlier tile), and tail_finish_kernel adds a tile's
// partials in CTA order. G <= U, so no CTA's range is empty.
struct TailSchedule {
  long long units;
  int chunks;
  __host__ __device__ TailSchedule(int N, int F, const TailPlan& p)
      : units((long long)((N + p.tm - 1) / p.tm) * ((F + p.fc - 1) / p.fc)),
        chunks((F + p.fc - 1) / p.fc) {}
  __host__ __device__ long long begin(int k, int G) const { return (long long)k * units / G; }
  // the CTA whose range holds unit u
  __host__ __device__ int cta_of(long long u, int G) const {
    return (int)(((u + 1) * G - 1) / units);
  }
};

template <typename T>
struct StoreBiasRounded {  // out[m, n] = round_T(v + bias[n])
  T* out; const float* bias; int ld;
  __device__ void operator()(int m, int n, float v) const {
    out[(long)m * ld + n] = from_f<T>(v + bias[n]);
  }
};

// ---- attention ----------------------------------------------------------------

// Keys per block of K and V staged in shared memory (fp32): 16 KB.
template <int kDh>
__host__ __device__ constexpr int attn_key_block() {
  return 16 * 1024 / (2 * kDh * 4);
}

// grid (ceil(L / 128), H, B); O (B*L, D) in T. The chain's K and V of head
// h are staged in shared memory, a block of keys at a time; each thread
// holds its query row and reads the keys as broadcasts.
template <typename T, bool kDrop, int kDh>
__global__ void __launch_bounds__(kAttnThreads)
attention_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ o, int L, int D, int H,
                     Dropout dp) {
  constexpr bool kFast = sizeof(T) == 2;
  constexpr int KB = attn_key_block<kDh>();
  __shared__ float sK[KB * kDh], sV[KB * kDh];
  const int i = blockIdx.x * kAttnThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const bool active = i < L;
  const int dh = D / H, c0 = h * dh, D3 = 3 * D;
  const T* base = qkv + (size_t)b * L * D3;
  float q[kDh], acc[kDh];
#pragma unroll
  for (int d = 0; d < kDh; ++d) {
    q[d] = (active && d < dh) ? to_f(base[(size_t)i * D3 + c0 + d]) : 0.0f;
    acc[d] = 0.0f;
  }
  const uint32_t key = attn_key(dp, b, h);
  const int g = h % dp.group;
  // f(j, score_j) for every key j, block by block.
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
  auto accumulate = [&](int jl, float p) {
#pragma unroll
    for (int d = 0; d < kDh; ++d)
      if (d < dh) acc[d] = fmaf(p, sV[jl * kDh + d], acc[d]);
  };
  if constexpr (kFast) {
    float sum = 0.0f;
    for_keys([&](int, int, float sc) {
      sum += __expf(fminf(fmaxf(sc, -kScoreClamp), kScoreClamp));
    });
    const float inv = __fdividef(1.0f, sum);
    for_keys([&](int j, int jl, float sc) {
      const float e = __expf(fminf(fmaxf(sc, -kScoreClamp), kScoreClamp));
      accumulate(jl, round_to<T>(e * inv) * keep3<kDrop>(dp, key, g, i, j));
    });
  } else {
    float m = -FLT_MAX;
    for_keys([&](int, int, float sc) { m = fmaxf(m, sc); });
    float sum = 0.0f;
    for_keys([&](int, int, float sc) { sum += expf(sc - m); });
    for_keys([&](int j, int jl, float sc) {
      accumulate(jl, round_to<T>(expf(sc - m) / sum) * keep3<kDrop>(dp, key, g, i, j));
    });
  }
  if (!active) return;
  T* oi = o + ((size_t)b * L + i) * D + c0;
#pragma unroll
  for (int d = 0; d < kDh; ++d)
    if (d < dh) oi[d] = from_f<T>(acc[d]);
}

template <typename T, bool kDrop>
cudaError_t launch_attention_fwd(const T* qkv, T* o, int B, int L, int D, int H,
                                 const Dropout& dp, cudaStream_t s) {
  const dim3 grid((L + kAttnThreads - 1) / kAttnThreads, H, B);
  const int dh = D / H;
  if (dh <= 8)
    attention_fwd_kernel<T, kDrop, 8><<<grid, kAttnThreads, 0, s>>>(qkv, o, L, D, H, dp);
  else if (dh <= 16)
    attention_fwd_kernel<T, kDrop, 16><<<grid, kAttnThreads, 0, s>>>(qkv, o, L, D, H, dp);
  else if (dh <= 32)
    attention_fwd_kernel<T, kDrop, 32><<<grid, kAttnThreads, 0, s>>>(qkv, o, L, D, H, dp);
  else if (dh <= 64)
    attention_fwd_kernel<T, kDrop, 64><<<grid, kAttnThreads, 0, s>>>(qkv, o, L, D, H, dp);
  else if (dh <= 384)
    attention_fwd_kernel<T, kDrop, 384><<<grid, kAttnThreads, 0, s>>>(qkv, o, L, D, H, dp);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// ---- the tail ----------------------------------------------------------------------

// LayerNorm statistics of one row held by one warp: mean and 1/sqrt(var + eps).
__device__ __forceinline__ float2 ln_stats(const float* row, int D, int lane) {
  float s = 0.0f;
  for (int c = lane; c < D; c += 32) s += row[c];
  const float mean = warp_sum(s) / D;
  float v = 0.0f;
  for (int c = lane; c < D; c += 32) {
    const float d = row[c] - mean;
    v += d * d;
  }
  return make_float2(mean, rsqrtf(warp_sum(v) / D + kLnEps));
}

// LN1 of row gr (N = B*L rows; fp32, held by one warp): x1 = round_T(LN1),
// put(c, x1) for every column c; with tr (may be null), also its xhat1 and
// inv1.
template <typename T, typename Put>
__device__ __forceinline__ void ln1_row(const float* row, int gr, int D,
                                        const float* __restrict__ ln1_s,
                                        const float* __restrict__ ln1_b, const TailTrain* tr,
                                        Put put) {
  const int lane = threadIdx.x & 31;
  const float2 st = ln_stats(row, D, lane);
  const size_t g = (size_t)gr * D;
  for (int c = lane; c < D; c += 32) {
    const float xh = (row[c] - st.x) * st.y;
    put(c, round_to<T>(xh * ln1_s[c] + ln1_b[c]));
    if (tr != nullptr) tr->xhat1[g + c] = xh;
  }
  if (tr != nullptr && lane == 0) tr->inv1[gr] = st.y;
}

// LN2 of row gr (fp32, held by one warp) into out; with kBwd, instead,
// LN2's backward from tr.dy: g2 = inv (dy s - mean(dy s) - xhat mean(dy s
// xhat)), df2 = g2 * keep_ff2, with xhat2 and inv2.
template <typename T, bool kBwd>
__device__ __forceinline__ void ln2_row(const float* row, int gr, int L, int D,
                                        const float* __restrict__ ln2_s,
                                        const float* __restrict__ ln2_b, T* __restrict__ out,
                                        const Dropout& dp, const TailTrain& tr) {
  const int lane = threadIdx.x & 31;
  const float2 st = ln_stats(row, D, lane);
  const size_t g = (size_t)gr * D;
  if constexpr (!kBwd) {
    for (int c = lane; c < D; c += 32)
      out[g + c] = from_f<T>((row[c] - st.x) * st.y * ln2_s[c] + ln2_b[c]);
  } else {
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane; c < D; c += 32) {
      const float xh = (row[c] - st.x) * st.y;
      tr.xhat2[g + c] = xh;
      const float dxh = tr.dy[g + c] * ln2_s[c];
      s1 += dxh;
      s2 += dxh * xh;
    }
    const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
    const int b = gr / L, l = gr - b * L;
    const uint32_t key = mask_key(dp, b, kSiteFf2, 0);
    for (int c = lane; c < D; c += 32) {
      const float gv = st.y * (tr.dy[g + c] * ln2_s[c] - m1 - tr.xhat2[g + c] * m2);
      tr.g2[g + c] = gv;
      tr.df2[g + c] = gv * keep2<true>(dp, key, c, l);
    }
    if (lane == 0) tr.inv2[gr] = st.y;
  }
}

// The fused tail: CTA k takes its units of TailSchedule (gridDim.x CTAs),
// a segment at a time. For a segment of row tile t (rows [t tm, t tm + tm)
// of the N = B*L rows) and chunks [c_lo, c_hi): the out projection of O
// (N x D, T, from attention_fwd_kernel), dropout, residual and LN1 (x1 to
// ws.x1, and in kTailTrainBwd xhat1 and inv1, by the segment that holds
// chunk 0), then the FFN over its chunks, and its f2 partial to ws.part.
// kMT = tm / 16 m-tiles per warp. Warps: the out projection and W1 split
// the output columns eight ways; W2 splits them four ways and its k-range
// (the chunk) in two halves, added at the end of the segment.
template <typename T, TailMode kMode, int kMT>
__global__ void __launch_bounds__(kTailThreads, 2)
layer_tail_kernel(const T* __restrict__ x, const T* __restrict__ o,
                  const T* __restrict__ w_out, const float* __restrict__ b_out,
                  const float* __restrict__ ln1_s, const float* __restrict__ ln1_b,
                  const T* __restrict__ w1, const float* __restrict__ b1,
                  const T* __restrict__ w2, int N, int L, int D, int F, Dropout dp,
                  TailPlan p, TailTrain tr, float* __restrict__ x1g,
                  float* __restrict__ part) {
  constexpr int kWarps = kTailThreads / 32;
  constexpr bool kDrop = tail_drops(kMode);
  constexpr int NTO = kMT == 1 ? 4 : 2;  // out projection: D <= 256 (kMT 1), 128 (kMT 2)
  constexpr int NT2 = kMT == 1 ? 8 : 4;  // W2
  extern __shared__ __align__(16) unsigned char tail_smem[];
  T* sA = reinterpret_cast<T*>(tail_smem + p.off_a);
  T* sH = reinterpret_cast<T*>(tail_smem + p.off_h);
  T* ring = reinterpret_cast<T*>(tail_smem + p.off_ring);
  float* sPre = reinterpret_cast<float*>(tail_smem + p.off_pre);
  float* sRed = reinterpret_cast<float*>(tail_smem + p.off_ring);  // after the last tile

  const int tid = threadIdx.x, warp = tid >> 5;
  const int nkd = (p.kd + p.kt - 1) / p.kt;
  const int ntd = p.dn / 8;
  // out projection: n-tiles warp, warp + 8, ...; W1: n-tiles warp, warp +
  // 8, ... of the chunk; W2: n-tiles nw, nw + 4, ... over half kh of the chunk
  const int nact_o = max(0, (ntd - warp + kWarps - 1) / kWarps);
  const int nact_1 = p.fc / (8 * kWarps);
  const int kh = warp >> 2, nw = warp & 3;
  const int nact_2 = max(0, (ntd - nw + 3) / 4);
  const TailSchedule sc(N, F, p);
  const long long u_end = sc.begin(blockIdx.x + 1, gridDim.x);

  for (long long u = sc.begin(blockIdx.x, gridDim.x); u < u_end;) {
    const int tile = (int)(u / sc.chunks);
    const int c_lo = (int)(u - (long long)tile * sc.chunks);
    const int c_hi = (int)min((long long)sc.chunks, u_end - (long long)tile * sc.chunks);
    u = (long long)tile * sc.chunks + c_hi;
    const int row0 = tile * p.tm, rows = min(p.tm, N - row0);
    const int n_tiles = nkd + (c_hi - c_lo) * (nkd + 1);
    auto chain_pos = [&](int r, int& b, int& l) {
      const int gr = row0 + r;
      b = gr / L;
      l = gr - b * L;
    };
    // Weight tile t of the segment's stream: W_out k-tiles, then per d_ff
    // chunk its W1 k-tiles and its W2 tile.
    auto stage = [&](int t) {
      T* s = ring + (t % p.slots) * p.slot;
      if (t < nkd) {
        tc::stage_tile<T, false>(s, p.swo, w_out, D, 0, p.dn, D, t * p.kt, p.kt, D);
        return;
      }
      const int q = t - nkd, c = c_lo + q / (nkd + 1), v = q % (nkd + 1);
      if (v < nkd)
        tc::stage_tile<T, false>(s, p.sw1, w1, F, c * p.fc, p.fc, F, v * p.kt, p.kt, D);
      else
        tc::stage_tile<T, false>(s, p.swo, w2, D, 0, p.dn, D, c * p.fc, p.fc, F);
    };

    __syncthreads();  // the last segment is done with shared memory
    tc::stage_tile<T, true>(sA, p.sa, o, D, row0, p.tm, N, 0, p.kd, D);
    for (int t = 0; t < p.slots - 1; ++t) {
      if (t < n_tiles) stage(t);
      tc::cp_async_commit();
    }

    float acc_o[kMT][NTO][4], acc1[kMT][2][4], acc2[kMT][NT2][4];
    tc::zero(acc_o);
    tc::zero(acc1);
    tc::zero(acc2);

    for (int t = 0; t < n_tiles; ++t) {
      if (t + p.slots - 1 < n_tiles) stage(t + p.slots - 1);
      tc::cp_async_commit();
      if (p.slots == 3)
        tc::cp_async_wait<2>();
      else
        tc::cp_async_wait<1>();
      __syncthreads();
      const T* s = ring + (t % p.slots) * p.slot;
      if (t < nkd) {
        // out projection, k-tile t
        const int kv = min(p.kt, p.kd - t * p.kt);
        tc::warp_mma<T, kMT, NTO, true, false>(acc_o, sA + t * p.kt, p.sa, 0, s, p.swo,
                                                8 * warp, 8 * kWarps, nact_o, 0, kv);
        if (t == nkd - 1) {
          tc::for_each_acc(acc_o, 0, 8 * warp, 8 * kWarps, nact_o, [&](int r, int n, float v) {
            if (r < rows && n < D) {
              int b, l;
              chain_pos(r, b, l);
              const float keep = keep2<kDrop>(dp, mask_key(dp, b, kSiteOut, 0), n, l);
              sPre[r * D + n] = to_f(x[(size_t)(row0 + r) * D + n]) + (v + b_out[n]) * keep;
            }
          });
          __syncthreads();
          // LN1: x1 rounded to T, into sA (the FFN's A operand) and, once
          // per row, to device memory
          const TailTrain* trp = kMode == kTailTrainBwd && c_lo == 0 ? &tr : nullptr;
          for (int r = warp; r < rows; r += kWarps)
            ln1_row<T>(sPre + r * D, row0 + r, D, ln1_s, ln1_b, trp, [&](int c, float x1) {
              sA[r * p.sa + c] = from_f<T>(x1);
              if (c_lo == 0) x1g[(size_t)(row0 + r) * D + c] = x1;
            });
        }
      } else {
        const int q = t - nkd, c = c_lo + q / (nkd + 1), v = q % (nkd + 1);
        if (v < nkd) {
          // W1 chunk c, k-tile v
          const int kv = min(p.kt, p.kd - v * p.kt);
          tc::warp_mma<T, kMT, 2, true, false>(acc1, sA + v * p.kt, p.sa, 0, s, p.sw1,
                                               8 * warp, 8 * kWarps, nact_1, 0, kv);
          if (v == nkd - 1) {
            tc::for_each_acc(acc1, 0, 8 * warp, 8 * kWarps, nact_1, [&](int r, int n, float val) {
              const int f = c * p.fc + n;
              float h = 0.0f;
              if (f < F) {
                int b, l;
                chain_pos(r, b, l);
                h = round_to<T>(fmaxf(val + b1[f], 0.0f)) *
                    keep2<kDrop>(dp, mask_key(dp, b, kSiteFf, 0), f, l);
              }
              sH[r * p.sh + n] = from_f<T>(h);
            });
            tc::zero(acc1);
          }
        } else {
          // W2 chunk c: this warp's columns over its half of the chunk
          tc::warp_mma<T, kMT, NT2, true, false>(acc2, sH, p.sh, 0, s, p.swo, 8 * nw, 32,
                                                 nact_2, kh * (p.fc / 2), (kh + 1) * (p.fc / 2));
        }
      }
      __syncthreads();
    }

    // the segment's f2 partial: its two half-chunk sums, in order
    tc::for_each_acc(acc2, 0, 8 * nw, 32, nact_2, [&](int r, int n, float v) {
      sRed[(kh * p.tm + r) * p.dn + n] = v;
    });
    __syncthreads();
    float* dst = part + (size_t)(tile + blockIdx.x) * p.tm * D;
    for (int e = tid; e < rows * D; e += kTailThreads) {
      const int r = e / D, n = e - r * D;
      dst[e] = sRed[r * p.dn + n] + sRed[(p.tm + r) * p.dn + n];
    }
  }
}

// f2 of each row = its tile's partials in CTA order (G CTAs in the tail),
// + b2; dropout; residual x1 (N x D, fp32); LN2 into out, or in
// kTailTrainBwd its backward into tr. A warp per row.
template <typename T, TailMode kMode>
__global__ void __launch_bounds__(256)
tail_finish_kernel(const float* __restrict__ part, const float* __restrict__ x1,
                   const float* __restrict__ b2, const float* __restrict__ ln2_s,
                   const float* __restrict__ ln2_b, T* __restrict__ out, int N, int L, int D,
                   int F, int G, Dropout dp, TailPlan p, TailTrain tr) {
  __shared__ float rows[8][kTailMaxD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = blockIdx.x * 8 + warp;
  if (gr >= N) return;
  const TailSchedule sc(N, F, p);
  const int tile = gr / p.tm, r = gr - tile * p.tm;
  const long long u0 = (long long)tile * sc.chunks;
  const int k0 = sc.cta_of(u0, G), k1 = sc.cta_of(u0 + sc.chunks - 1, G);
  const int b = gr / L, l = gr - b * L;
  const uint32_t key = mask_key(dp, b, kSiteFf2, 0);
  float* row = rows[warp];
  for (int c = lane; c < D; c += 32) {
    float f2 = part[((size_t)(tile + k0) * p.tm + r) * D + c];
    for (int k = k0 + 1; k <= k1; ++k) f2 += part[((size_t)(tile + k) * p.tm + r) * D + c];
    row[c] = x1[(size_t)gr * D + c] + (f2 + b2[c]) * keep2<tail_drops(kMode)>(dp, key, c, l);
  }
  __syncwarp();
  ln2_row<T, kMode == kTailTrainBwd>(row, gr, L, D, ln2_s, ln2_b, out, dp, tr);
}

// ---- the tail of wide layers ------------------------------------------------------------
// Where D is wider than layer_tail_kernel's register tiles (kTailMaxD), the
// tail runs as five launches through device memory, with the same
// products (the tile product, gemm_kernel), roundings, masks and
// LayerNorms: pre = x + (O W_out + b_out) keep_out; x1 = round(LN1(pre));
// h = round(relu(x1 W1 + b1)) keep_ff; pre = x1 + (h W2 + b2) keep_ff2;
// LN2(pre). Each product sums its whole depth in one order.

// pre[m, n] = res[m, n] + (v + bias[n]) * keep at a site of shape (D, L).
template <typename T, bool kDrop>
struct ResidualEpi {
  float* pre; const T* res; const float* bias; int D, L, site; Dropout dp;
  __device__ void operator()(int m, int n, float v) const {
    const int b = m / L, l = m - b * L;
    const float keep = keep2<kDrop>(dp, mask_key(dp, b, site, 0), n, l);
    pre[(long)m * D + n] = to_f(res[(long)m * D + n]) + (v + bias[n]) * keep;
  }
};

// h[m, f] = round_T(relu(v + b1[f])) * keep_ff.
template <typename T, bool kDrop>
struct HiddenRoundEpi {
  T* h; const float* b1; int F, L; Dropout dp;
  __device__ void operator()(int m, int f, float v) const {
    const int b = m / L, l = m - b * L;
    const float keep = keep2<kDrop>(dp, mask_key(dp, b, kSiteFf, 0), f, l);
    h[(long)m * F + f] = from_f<T>(round_to<T>(fmaxf(v + b1[f], 0.0f)) * keep);
  }
};

constexpr int kRowThreads = 256;  // a warp per row

template <typename T, bool kBwd>
__global__ void __launch_bounds__(kRowThreads)
tail_ln1_kernel(const float* __restrict__ pre, T* __restrict__ x1,
                const float* __restrict__ ln1_s, const float* __restrict__ ln1_b, int N, int D,
                TailTrain tr) {
  const int r = blockIdx.x * (kRowThreads / 32) + threadIdx.x / 32;
  if (r >= N) return;
  ln1_row<T>(pre + (size_t)r * D, r, D, ln1_s, ln1_b, kBwd ? &tr : nullptr,
             [&](int c, float v) { x1[(size_t)r * D + c] = from_f<T>(v); });
}

template <typename T, bool kBwd>
__global__ void __launch_bounds__(kRowThreads)
tail_ln2_kernel(const float* __restrict__ pre, T* __restrict__ out,
                const float* __restrict__ ln2_s, const float* __restrict__ ln2_b, int N, int L,
                int D, Dropout dp, TailTrain tr) {
  const int r = blockIdx.x * (kRowThreads / 32) + threadIdx.x / 32;
  if (r >= N) return;
  ln2_row<T, kBwd>(pre + (size_t)r * D, r, L, D, ln2_s, ln2_b, out, dp, tr);
}

template <typename T, TailMode kMode>
cudaError_t launch_layer_tail_wide(const T* x, const T* o, const Weights<T>& w, T* out, int N,
                                   int L, int D, int F, const Dropout& dp,
                                   const TailWs<T>& ws, const TailTrain& tr,
                                   cudaStream_t s) {
  constexpr bool kDrop = tail_drops(kMode), kBwd = kMode == kTailTrainBwd;
  if (ws.pre == nullptr || ws.x1t == nullptr || ws.h == nullptr) return cudaErrorInvalidValue;
  const int row_blocks = (N + kRowThreads / 32 - 1) / (kRowThreads / 32);
  cudaError_t err = tc::gemm<T, true, false>(
      o, D, w.w_out, D, N, D, D, tc::round_up(D, tc::kGemmBK), 1,
      ResidualEpi<T, kDrop>{ws.pre, x, w.b_out, D, L, kSiteOut, dp}, s);
  if (err != cudaSuccess) return err;
  tail_ln1_kernel<T, kBwd><<<row_blocks, kRowThreads, 0, s>>>(ws.pre, ws.x1t, w.ln1_s,
                                                                w.ln1_b, N, D, tr);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = tc::gemm<T, true, false>(ws.x1t, D, w.w1, F, N, F, D, tc::round_up(D, tc::kGemmBK), 1,
                                 HiddenRoundEpi<T, kDrop>{ws.h, w.b1, F, L, dp}, s);
  if (err != cudaSuccess) return err;
  err = tc::gemm<T, true, false>(ws.h, F, w.w2, D, N, D, F, tc::round_up(F, tc::kGemmBK), 1,
                                 ResidualEpi<T, kDrop>{ws.pre, ws.x1t, w.b2, D, L, kSiteFf2, dp},
                                 s);
  if (err != cudaSuccess) return err;
  tail_ln2_kernel<T, kBwd><<<row_blocks, kRowThreads, 0, s>>>(ws.pre, out, w.ln2_s, w.ln2_b,
                                                                N, L, D, dp, tr);
  return cudaGetLastError();
}

// Launches the tail over N rows with plan p: on the fused route, ctas CTAs
// (TailSchedule's G, at most its units) and the finish; on the wide route,
// launch_layer_tail_wide. Returns cudaGetLastError().
template <typename T, TailMode kMode>
cudaError_t launch_layer_tail(const T* x, const T* o, const Weights<T>& w, T* out, int N,
                              int L, int D, int F, const Dropout& dp, const TailPlan& p,
                              int ctas, const TailTrain& tr, const TailWs<T>& ws,
                              cudaStream_t s) {
  if (p.wide) return launch_layer_tail_wide<T, kMode>(x, o, w, out, N, L, D, F, dp, ws, tr, s);
  if (p.bytes > kMaxSmem || (p.tm != 16 && p.tm != 32) ||
      D > (p.tm == 16 ? kTailMaxD : kTailMaxD / 2) || p.kt > kTailMaxKT || p.fc > kTailMaxFC ||
      p.fc % 64 || p.kt % tc::KStep<T>::value || (p.slots != 2 && p.slots != 3) || ctas < 1 ||
      ctas > TailSchedule(N, F, p).units || ws.x1 == nullptr || ws.part == nullptr)
    return cudaErrorInvalidValue;
  auto kernel = p.tm == 16 ? layer_tail_kernel<T, kMode, 1> : layer_tail_kernel<T, kMode, 2>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.bytes);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, kTailThreads, p.bytes, s>>>(x, o, w.w_out, w.b_out, w.ln1_s, w.ln1_b, w.w1,
                                             w.b1, w.w2, N, L, D, F, dp, p, tr, ws.x1, ws.part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  tail_finish_kernel<T, kMode><<<(N + 7) / 8, 256, 0, s>>>(
      ws.part, ws.x1, w.b2, w.ln2_s, w.ln2_b, out, N, L, D, F, ctas, dp, p, tr);
  return cudaGetLastError();
}

// The layer without dropout (B1): qkv_ws (N x 3D) and o_ws (N x D) in T;
// the tail's workspace and CTAs as launch_layer_tail takes them.
template <typename T>
int launch_encoder_layer_tc(const T* x, const Weights<T>& w, T* out, T* qkv_ws, T* o_ws,
                            const TailWs<T>& tail_ws, int B, int L, int D, int H, int F,
                            const TailPlan& p, int tail_ctas, cudaStream_t s) {
  const int N = B * L, D3 = 3 * D;
  const Dropout none{0u, 0u, 1.0f, 1};
  cudaError_t err = tc::gemm<T, true, false>(
      x, D, w.w_qkv, D3, N, D3, D, tc::round_up(D, tc::kGemmBK), 1,
      StoreBiasRounded<T>{qkv_ws, w.b_qkv, D3}, s);
  if (err != cudaSuccess) return (int)err;
  err = launch_attention_fwd<T, false>(qkv_ws, o_ws, B, L, D, H, none, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_layer_tail<T, kTailSample>(x, o_ws, w, out, N, L, D, F, none, p, tail_ctas,
                                          TailTrain{}, tail_ws, s);
}

}  // namespace fdiff
