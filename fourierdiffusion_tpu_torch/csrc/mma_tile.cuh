// Tensor-core tile products for Hopper (sm_90a), shared by the layer
// kernels of encoder_layer_tc.cuh (the sampling layer B1, the training
// forward B3 and B4's recompute of it), the training backward (B4,
// fused_encoder_train.cu) and the attention forward (B2, flash_attention.cu,
// which uses the fragment helpers and stage_tile).
//
// Operands are staged in shared memory and multiplied by warp-level
// mma.sync with fp32 accumulators in registers, in two forms:
//
//   bf16: mma.sync.m16n8k16 on bf16 operands (fragments loaded with
//         ldmatrix), fp32 accumulation: the TPU kernels' "operands in the
//         activation dtype, preferred_element_type=float32".
//   fp32: 3xTF32. Each operand is split x = hi + lo with hi = tf32(x)
//         rounded to nearest (as cvt.rna) and lo = x - hi, read by the
//         tensor core as tf32 (split_tf32); a*b ~= lo_a*hi_b + hi_a*lo_b +
//         hi_a*hi_b, three mma.sync.m16n8k8.tf32 with fp32 accumulation.
//         The dropped lo*lo term and lo's truncation leave about 2^-21 of
//         |a||b| per product, close to fp32 FMA; one TF32 pass (2^-11)
//         does not hold the fp32 gates.
//
// Shared-memory tiles hold an operand as element (r, k) of an R x K tile,
// r the output row (A) or output column (B), in one of two layouts:
//   kKMaj: s[r * S + k]  (rows of k; global memory contiguous along k)
//   row-major in r: s[k * S + r]  (global memory contiguous along r, e.g.
//          the packed (in, out) weights as the B operand)
// The row stride S is padded (tile_stride) so that every fragment load of a
// warp hits 32 distinct banks. Tiles are filled by cp.async (16 bytes per
// copy, zero-filled past the matrix edge) where the global rows allow it,
// else by plain loads, so padded rows and columns are always zero.
//
// gemm_kernel is a general C = A B over such tiles (64 x 64 per CTA, depth
// 32, four stages, 4 warps of 32 x 32), with an epilogue functor per
// element and an optional split of K over gridDim.z (each slice's result
// goes to its own partial; nothing is summed with atomics).

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fdiff {
namespace tc {

using bf16 = __nv_bfloat16;

// ---- sizes ------------------------------------------------------------------

template <typename T> struct KStep { static constexpr int value = sizeof(T) == 4 ? 8 : 16; };

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Row stride (elements) of a shared tile whose rows hold n elements.
// fp32 in kKMaj layout: S % 8 == 4 (fragment rows g*S + t fall in distinct
// banks). fp32 row-major in r, and bf16 either way (ldmatrix rows of 16
// bytes): S % 16 == 8. Every stride keeps 16-byte rows.
template <typename T>
__host__ __device__ constexpr int tile_stride(int n, bool kmaj) {
  return (sizeof(T) == 4 && kmaj) ? (n + 3) / 8 * 8 + 4 : (n + 7) / 16 * 16 + 8;
}

// ---- PTX wrappers -------------------------------------------------------------
// The mma wrappers are plain asm (they only read and write registers);
// copies and ldmatrix are volatile, in program order with the barriers.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; bytes past src_bytes are written as zero.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
// 4 bytes from global to shared (cp.async.cg takes only 16, so this one is
// .ca); bytes past src_bytes are written as zero.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo for a 3xTF32 product. hi is cvt.rna.tf32(x), computed with
// integer operations (add half of the 13 dropped bits to the magnitude,
// then clear them: round to nearest, ties away from zero), which on an H100
// ran faster than the conversion instruction. lo = x - hi is exact in fp32
// and goes to the tensor core as it is: mma reads a tf32 operand from the
// top 19 bits of its register, which truncates lo, by at most 2^-21 of |x|,
// as small as the lo*lo term the form drops (CUTLASS's 3xTF32 does the same).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// ---- warp tile product -----------------------------------------------------------

template <bool kKMaj>
__device__ __forceinline__ int at(int r, int k, int s) {
  return kKMaj ? r * s + k : k * s + r;
}

// acc[i][j] += sum over k in [k0, k1) of A(m0 + 16 i + ., k) B(k, n0 + j nstep + .)
// for i < MT and j < min(NT, nact): one warp, m16 x n8 accumulator tiles
// in the mma C layout (c0, c1: row g, columns 2t, 2t+1; c2, c3: row g + 8).
// A is kKMaj with stride sa (bf16: required); B is kKMaj ([n][k]) or
// row-major in n ([k][n]; bf16: required), stride sb. k1 - k0 is a multiple
// of KStep<T>.
template <typename T, int MT, int NT, bool kAKMaj, bool kBKMaj>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4], const T* __restrict__ sA,
                                         int sa, int m0, const T* __restrict__ sB, int sb,
                                         int n0, int nstep, int nact, int k0, int k1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (sizeof(T) == 4) {
    for (int k = k0; k < k1; k += 8) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = m0 + 16 * i + g;
        split_tf32(sA[at<kAKMaj>(r, k + t, sa)], ah[i][0], al[i][0]);
        split_tf32(sA[at<kAKMaj>(r + 8, k + t, sa)], ah[i][1], al[i][1]);
        split_tf32(sA[at<kAKMaj>(r, k + t + 4, sa)], ah[i][2], al[i][2]);
        split_tf32(sA[at<kAKMaj>(r + 8, k + t + 4, sa)], ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nact) {
          const int n = n0 + j * nstep + g;
          uint32_t bh[2], bl[2];
          split_tf32(sB[at<kBKMaj>(n, k + t, sb)], bh[0], bl[0]);
          split_tf32(sB[at<kBKMaj>(n, k + t + 4, sb)], bh[1], bl[1]);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_tf32(acc[i][j], al[i], bh);
            mma_tf32(acc[i][j], ah[i], bl);
            mma_tf32(acc[i][j], ah[i], bh);
          }
        }
      }
    }
  } else {
    static_assert(kAKMaj && !kBKMaj, "bf16 tiles: A [m][k], B [k][n]");
    for (int k = k0; k < k1; k += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], sA + (m0 + 16 * i + (lane & 15)) * sa + k + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nact) {
          uint32_t b[2];
          ldmatrix_x2_trans(b, sB + (k + (lane & 15)) * sb + n0 + j * nstep);
#pragma unroll
          for (int i = 0; i < MT; ++i) mma_bf16(acc[i][j], a[i], b);
        }
      }
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
}

// Calls f(row, col, value) for every accumulator element of warp_mma's
// tiles (row m0 + 16 i + ..., column n0 + j nstep + ...), j < nact.
template <int MT, int NT, typename Fn>
__device__ __forceinline__ void for_each_acc(const float (&acc)[MT][NT][4], int m0, int n0,
                                             int nstep, int nact, Fn f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < nact)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f(m0 + 16 * i + g + (e >> 1) * 8, n0 + j * nstep + 2 * t + (e & 1), acc[i][j][e]);
}

// ---- staging global tiles into shared memory ----------------------------------------

template <typename T> __device__ __forceinline__ T zero_of() { return T(0); }
template <> __device__ __forceinline__ bf16 zero_of<bf16>() { return __float2bfloat16(0.0f); }

// Copies the tile rows [r0, r0 + R) x k [k0, k0 + K) of a global matrix
// into shared memory, zero outside r < r_end, k < k_end. Global element
// (r, k) is g[r * ld + k] (kGKMaj) or g[k * ld + r]; shared element (r, k)
// is s[at<kGKMaj>(r - r0, k - k0, S)] (the tile keeps the global's
// contiguous axis). 16-byte cp.async where ld and g are aligned for it,
// else plain loads. All threads of the block call it.
template <typename T, bool kGKMaj>
__device__ __forceinline__ void stage_tile(T* __restrict__ s, int S, const T* __restrict__ g,
                                           long ld, int r0, int R, int r_end, int k0, int K,
                                           int k_end) {
  constexpr int V = 16 / sizeof(T);
  // contiguous axis: k (kGKMaj) or r; the other is "outer"
  const int inner = kGKMaj ? K : R, outer = kGKMaj ? R : K;
  const int i0 = kGKMaj ? k0 : r0, o0 = kGKMaj ? r0 : k0;
  const int i_end = kGKMaj ? k_end : r_end, o_end = kGKMaj ? r_end : k_end;
  const bool vec = (ld % V == 0) && ((reinterpret_cast<uintptr_t>(g) & 15) == 0) &&
                   (i0 % V == 0) && (inner % V == 0);
  // Each thread walks (o, i) from (tid / per_row, tid % per_row) in steps
  // of blockDim.x: two divisions per call, none per element.
  const int per_row = vec ? inner / V : inner;
  const int total = outer * per_row;
  const int step_o = blockDim.x / per_row, step_i = blockDim.x % per_row;
  int o = threadIdx.x / per_row, i = threadIdx.x % per_row;
  for (int c = threadIdx.x; c < total; c += blockDim.x) {
    const int go = o0 + o;
    if (vec) {
      const int gi = i0 + i * V;
      const int n = (go < o_end) ? max(0, min(V, i_end - gi)) : 0;
      const T* src = n > 0 ? g + (long)go * ld + gi : g;
      cp_async16(s + o * S + i * V, src, n * (int)sizeof(T));
    } else {
      const int gi = i0 + i;
      s[o * S + i] = (go < o_end && gi < i_end) ? g[(long)go * ld + gi] : zero_of<T>();
    }
    o += step_o;
    i += step_i;
    if (i >= per_row) {
      i -= per_row;
      ++o;
    }
  }
}

// ---- general tile product ----------------------------------------------------------------

constexpr int kGemmBM = 64, kGemmBN = 64, kGemmBK = 32, kGemmThreads = 128;
constexpr int kGemmMT = 2;  // m16 tiles per warp: warps of (16 kGemmMT) x 32
constexpr int kGemmStages = 4;  // three tiles in flight while one is multiplied

template <typename T>
__host__ __device__ constexpr int gemm_tile_elems() {
  // the larger of the two layouts of a 64 x 32 operand tile
  return tile_stride<T>(kGemmBK, true) * 64 > tile_stride<T>(64, false) * kGemmBK
             ? tile_stride<T>(kGemmBK, true) * 64
             : tile_stride<T>(64, false) * kGemmBK;
}

// Dynamic shared memory of gemm_kernel<T>, bytes: kGemmStages stages of an
// A and a B tile.
template <typename T>
__host__ __device__ constexpr int gemm_smem_bytes() {
  return kGemmStages * 2 * gemm_tile_elems<T>() * (int)sizeof(T);
}

// A (M x K): element (m, k) at a[m * lda + k] (kAKMaj) or a[k * lda + m].
// B (K x N): element (k, n) at b[n * ldb + k] (kBKMaj) or b[k * ldb + n].
// Slice z = blockIdx.z covers k in [z * k_slice, min(K, (z + 1) * k_slice)),
// k_slice a multiple of kGemmBK; epi(m, n, value) for m < M, n < N.
// The k-tiles stream through a ring of kGemmStages stages (cp.async).
template <typename T, bool kAKMaj, bool kBKMaj, typename Epi>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const T* __restrict__ a, long lda, const T* __restrict__ b, long ldb, int M,
            int N, int K, int k_slice, Epi epi) {
  constexpr int E = gemm_tile_elems<T>();
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  T* sA = reinterpret_cast<T*>(gemm_smem);
  T* sB = sA + kGemmStages * E;
  constexpr int SA = tile_stride<T>(kAKMaj ? kGemmBK : kGemmBM, kAKMaj);
  constexpr int SB = tile_stride<T>(kBKMaj ? kGemmBK : kGemmBN, kBKMaj);
  const int m0 = blockIdx.x * kGemmBM, n0 = blockIdx.y * kGemmBN;
  const int kb = blockIdx.z * k_slice, ke = min(K, kb + k_slice);
  const int nk = (ke - kb + kGemmBK - 1) / kGemmBK;
  const int warp = threadIdx.x >> 5, wm = (warp >> 1) * 16 * kGemmMT,
            wn = (warp & 1) * 32;

  auto load = [&](int kt) {
    const int stage = kt % kGemmStages, k = kb + kt * kGemmBK;
    stage_tile<T, kAKMaj>(sA + stage * E, SA, a, lda, m0, kGemmBM, M, k, kGemmBK, ke);
    stage_tile<T, kBKMaj>(sB + stage * E, SB, b, ldb, n0, kGemmBN, N, k, kGemmBK, ke);
  };
  float acc[kGemmMT][4][4];
  zero(acc);
#pragma unroll
  for (int kt = 0; kt < kGemmStages - 1; ++kt) {
    if (kt < nk) load(kt);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + kGemmStages - 1 < nk) load(kt + kGemmStages - 1);
    cp_async_commit();
    cp_async_wait<kGemmStages - 1>();
    __syncthreads();
    const int stage = kt % kGemmStages;
    warp_mma<T, kGemmMT, 4, kAKMaj, kBKMaj>(acc, sA + stage * E, SA, wm, sB + stage * E, SB, wn, 8,
                                      4, 0, kGemmBK);
    __syncthreads();
  }
  for_each_acc(acc, m0 + wm, n0 + wn, 8, 4, [&](int m, int n, float v) {
    if (m < M && n < N) epi(m, n, v);
  });
}

// Launches gemm_kernel on `splits` slices of K of k_slice (a multiple of
// kGemmBK) each; returns cudaGetLastError().
template <typename T, bool kAKMaj, bool kBKMaj, typename Epi>
cudaError_t gemm(const T* a, long lda, const T* b, long ldb, int M, int N, int K, int k_slice,
                 int splits, Epi epi, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  constexpr int bytes = gemm_smem_bytes<T>();
  auto kernel = gemm_kernel<T, kAKMaj, kBKMaj, Epi>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kGemmBM - 1) / kGemmBM, (N + kGemmBN - 1) / kGemmBN, splits);
  kernel<<<grid, kGemmThreads, bytes, stream>>>(a, lda, b, ldb, M, N, K, k_slice, epi);
  return cudaGetLastError();
}

// Two products over the same (M, N, K) in one pass: C1 = A1 B1 and
// C2 = A2 B2 (layouts as gemm_kernel's, B2's its own), epi(m, n, c1, c2).
// For an epilogue that needs both at one element, it keeps C1 and C2 out
// of device memory. kGemmPairStages stages of four tiles.
constexpr int kGemmPairStages = 3;

template <typename T>
__host__ __device__ constexpr int gemm_pair_smem_bytes() {
  return kGemmPairStages * 4 * gemm_tile_elems<T>() * (int)sizeof(T);
}

template <typename T, bool kAKMaj, bool kBKMaj, bool kB2KMaj, typename Epi>
__global__ void __launch_bounds__(kGemmThreads)
gemm_pair_kernel(const T* __restrict__ a1, const T* __restrict__ b1,
                 const T* __restrict__ a2, const T* __restrict__ b2, long lda, long ldb1,
                 long ldb2, int M, int N, int K, Epi epi) {
  constexpr int E = gemm_tile_elems<T>();
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  T* sm = reinterpret_cast<T*>(gemm_smem);  // per stage: A1, B1, A2, B2
  constexpr int SA = tile_stride<T>(kAKMaj ? kGemmBK : kGemmBM, kAKMaj);
  constexpr int SB1 = tile_stride<T>(kBKMaj ? kGemmBK : kGemmBN, kBKMaj);
  constexpr int SB2 = tile_stride<T>(kB2KMaj ? kGemmBK : kGemmBN, kB2KMaj);
  const int m0 = blockIdx.x * kGemmBM, n0 = blockIdx.y * kGemmBN;
  const int nk = (K + kGemmBK - 1) / kGemmBK;
  const int warp = threadIdx.x >> 5, wm = (warp >> 1) * 16 * kGemmMT,
            wn = (warp & 1) * 32;

  auto load = [&](int kt) {
    T* st = sm + (kt % kGemmPairStages) * 4 * E;
    const int k = kt * kGemmBK;
    stage_tile<T, kAKMaj>(st, SA, a1, lda, m0, kGemmBM, M, k, kGemmBK, K);
    stage_tile<T, kBKMaj>(st + E, SB1, b1, ldb1, n0, kGemmBN, N, k, kGemmBK, K);
    stage_tile<T, kAKMaj>(st + 2 * E, SA, a2, lda, m0, kGemmBM, M, k, kGemmBK, K);
    stage_tile<T, kB2KMaj>(st + 3 * E, SB2, b2, ldb2, n0, kGemmBN, N, k, kGemmBK, K);
  };
  float acc1[kGemmMT][4][4], acc2[kGemmMT][4][4];
  zero(acc1);
  zero(acc2);
#pragma unroll
  for (int kt = 0; kt < kGemmPairStages - 1; ++kt) {
    if (kt < nk) load(kt);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + kGemmPairStages - 1 < nk) load(kt + kGemmPairStages - 1);
    cp_async_commit();
    cp_async_wait<kGemmPairStages - 1>();
    __syncthreads();
    const T* st = sm + (kt % kGemmPairStages) * 4 * E;
    warp_mma<T, kGemmMT, 4, kAKMaj, kBKMaj>(acc1, st, SA, wm, st + E, SB1, wn, 8, 4, 0,
                                            kGemmBK);
    warp_mma<T, kGemmMT, 4, kAKMaj, kB2KMaj>(acc2, st + 2 * E, SA, wm, st + 3 * E, SB2, wn, 8,
                                             4, 0, kGemmBK);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < kGemmMT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + 16 * i + g + (e >> 1) * 8, n = n0 + wn + 8 * j + 2 * t + (e & 1);
        if (m < M && n < N) epi(m, n, acc1[i][j][e], acc2[i][j][e]);
      }
}

template <typename T, bool kAKMaj, bool kBKMaj, bool kB2KMaj, typename Epi>
cudaError_t gemm_pair(const T* a1, const T* b1, const T* a2, const T* b2, long lda, long ldb1,
                      long ldb2, int M, int N, int K, Epi epi, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  constexpr int bytes = gemm_pair_smem_bytes<T>();
  auto kernel = gemm_pair_kernel<T, kAKMaj, kBKMaj, kB2KMaj, Epi>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kGemmBM - 1) / kGemmBM, (N + kGemmBN - 1) / kGemmBN);
  kernel<<<grid, kGemmThreads, bytes, stream>>>(a1, b1, a2, b2, lda, ldb1, ldb2, M, N, K, epi);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace fdiff
