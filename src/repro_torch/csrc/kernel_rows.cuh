// Shared device code of the fupdate, decision and gram kernels.
//
// All three evaluate k(A[r], B[c]) for tiles of rows of two matrices,
// where k is the linear, rbf or poly kernel on an f32 dot product (rbf
// also reads the f32 squared norms of the rows). gram writes every value;
// fupdate and decision take, for every row r of A, the weighted row sum
//
//     s[r] = sum_{c < N} w[c] * k(A[r], B[c])
//
// fupdate with A = the training rows, B = the selected block, w = the
// dual step, writing f + s; decision with A = the queries, B = the packed
// support rows, w = gamma, writing (s - rho1) * (rho2 - s).
//
// dot_tile: a CTA of (BM/TR) * (BN/TC) threads stages BM rows of A and BN
// rows of B in DK-deep feature chunks in shared memory as f32 (16-bit
// inputs are widened as they are loaded), one stage, and each thread
// keeps a TR x TC register tile of dot products, each summed by f32 FMA
// over the features in order. Thread (ty, tx) owns rows ty + i * NTY and
// columns tx + j * NTX. Rows past M, columns past N and features past D
// load as 0, so ragged edges need no padding. It is the first design's
// tile: fupdate's narrow default and the f32 gram default run on it;
// the redesigned kernels (gram.cu's SIMT and wgmma classes, the split
// kernels of split_rows.cuh that decision.cu and fupdate.cu's wide
// classes share, fupdate.cu's pipelined narrow entries) stage their own
// operands (the SIMT classes by fetch_chunk / stash_chunk below, the
// wgmma classes by TMA, hopper.cuh).
//
// weighted_row_sums: one CTA owns BM rows of A, so its outputs belong to
// it alone: no cross-CTA reduction and no atomics. It walks B in chunks of
// BN rows; after each chunk's dot tile the epilogue runs on the thread's
// tile, weighted by w, into TR per-row partials (add_weighted), skipping
// columns past N (so they add exactly nothing); the NTX threads sharing a
// row add their partials with warp shuffles at the end (reduce_row).
//
// Sum order: each dot product is one thread's sequential FMA chain over
// the features, whatever BM, BN, TR, TC or the staging; a row sum's order
// depends on BN and TC (which columns a thread adds, and the shuffle tree
// over NTX) but not on BM, TR, the feature-chunk depth or the number of
// stages. So fupdate's narrow launches that differ only in those give
// bitwise equal outputs, and so do all f32 gram launches (the bf16/f16
// gram launches run wgmma, whose sums are the tensor cores';
// split_rows.cuh states its classes' orders; kernels/tiling.py keeps
// each class's menu to that).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace repro {

enum Kind { kLinear = 0, kRbf = 1, kPoly = 2 };
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// Feature-chunk depth dot_tile stages in shared memory per step (and
// the pipelined fupdate entries' chunk).
constexpr int DK = 32;

// Dynamic shared memory a CTA may take on an H100 (227 KB).
constexpr int kMaxSmem = 232448;

// Opt `kernel` in to `bytes` of dynamic shared memory, once per card:
// `done` is the calling launcher's own record (one per instantiation), so
// the first launch sets it, before any launch a CUDA graph captures.
template <typename K>
int allow_smem(K kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (bytes <= 48 * 1024 || dev >= 64 || done[dev]) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done[dev] = true;
  return static_cast<int>(e);
}

struct KernelParams {
  int kind;
  float gamma;
  float coef0;
  int degree;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

// x ** n by repeated squaring from the low bit: the multiplication order
// of jax.lax.integer_pow, not powf.
__device__ __forceinline__ float int_pow(float x, int n) {
  float acc = 1.0f;
  bool have = false;
  while (n > 0) {
    if (n & 1) {
      acc = have ? __fmul_rn(acc, x) : x;
      have = true;
    }
    n >>= 1;
    if (n > 0) x = __fmul_rn(x, x);
  }
  return acc;
}

// The kernel value from an f32 dot product, with the reference's rounding
// steps kept (no FMA contraction): rbf is exp(-g * max(rn + cn - 2 dot, 0)),
// poly (g * dot + c0) ** degree. kernel_value fixes the kind at compile
// time, for loops that dispatch once outside; epilogue dispatches on
// p.kind for each value. Both do the same arithmetic.
template <int KIND>
__device__ __forceinline__ float kernel_value(float dot, float rn, float cn,
                                              const KernelParams& p) {
  if (KIND == kRbf) {
    const float sq = __fsub_rn(__fadd_rn(rn, cn), __fmul_rn(2.0f, dot));
    return expf(__fmul_rn(-p.gamma, fmaxf(sq, 0.0f)));
  }
  if (KIND == kPoly) {
    return int_pow(__fadd_rn(__fmul_rn(p.gamma, dot), p.coef0), p.degree);
  }
  return dot;
}

__device__ __forceinline__ float epilogue(float dot, float rn, float cn,
                                          const KernelParams& p) {
  if (p.kind == kRbf) return kernel_value<kRbf>(dot, rn, cn, p);
  if (p.kind == kPoly) return kernel_value<kPoly>(dot, rn, cn, p);
  return dot;
}

// acc[i][j] = dot(A[row0 + ty + i * NTY], B[col0 + tx + j * NTX]) over
// the D features, 0 for rows or columns outside the matrices. Every
// thread of the CTA must call it (it synchronises the CTA).
template <typename T, int BM, int BN, int TR, int TC>
__device__ __forceinline__ void dot_tile(const T* __restrict__ A,
                                         const T* __restrict__ B, int M,
                                         int N, int D, int row0, int col0,
                                         float (&acc)[TR][TC]) {
  constexpr int NTY = BM / TR;
  constexpr int NTX = BN / TC;
  constexpr int NT = NTY * NTX;
  // +1 column of padding: the transposed stores below hit 32 banks.
  __shared__ float As[DK][BM + 1];
  __shared__ float Bs[DK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % NTX;
  const int ty = tid / NTX;

#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < D; k0 += DK) {
    for (int e = tid; e < BM * DK; e += NT) {
      const int r = e / DK, k = e % DK;
      const int gr = row0 + r, gk = k0 + k;
      As[k][r] = (gr < M && gk < D)
                     ? widen(A[static_cast<size_t>(gr) * D + gk])
                     : 0.0f;
    }
    for (int e = tid; e < BN * DK; e += NT) {
      const int c = e / DK, k = e % DK;
      const int gc = col0 + c, gk = k0 + k;
      Bs[k][c] = (gc < N && gk < D)
                     ? widen(B[static_cast<size_t>(gc) * D + gk])
                     : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < DK; ++k) {
      float a[TR], b[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) a[i] = As[k][ty + i * NTY];
#pragma unroll
      for (int j = 0; j < TC; ++j) b[j] = Bs[k][tx + j * NTX];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j)
          acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// part[i] += w[c] * k(acc[i][j]) for the thread's columns c = n0 + tx +
// j * NTX below N (rows' norms rn, columns' norms b_norm), in j order.
template <int TR, int TC, int NTX>
__device__ __forceinline__ void add_weighted(
    const float (&acc)[TR][TC], const float (&rn)[TR],
    const float* __restrict__ b_norm, const float* __restrict__ w, int N,
    int n0, int tx, const KernelParams& p, float (&part)[TR]) {
#pragma unroll
  for (int j = 0; j < TC; ++j) {
    const int c = n0 + tx + j * NTX;
    if (c < N) {
      const float cn = b_norm[c];
      const float wc = w[c];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        part[i] = fmaf(epilogue(acc[i][j], rn[i], cn, p), wc, part[i]);
    }
  }
}

// The NTX threads of a row (in one warp) add their partials; after it
// every one of them holds the row's sum.
template <int TR, int NTX>
__device__ __forceinline__ void reduce_row(float (&part)[TR]) {
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int off = NTX / 2; off > 0; off >>= 1)
      part[i] += __shfl_xor_sync(0xffffffffu, part[i], off);
}

// Per-thread partial sums for rows row0 + ty + i * NTY (i < TR); after
// the call the thread with tx == 0 holds each of its rows' full sums.
// Every thread of the CTA must call it (it synchronises the CTA and the
// final shuffles use the full warp mask).
template <typename T, int BM, int BN, int TR, int TC>
__device__ __forceinline__ void weighted_row_sums(
    const T* __restrict__ A, const T* __restrict__ B,
    const float* __restrict__ a_norm, const float* __restrict__ b_norm,
    const float* __restrict__ w, int M, int N, int D,
    const KernelParams& p, int row0, float (&part)[TR]) {
  constexpr int NTY = BM / TR;
  constexpr int NTX = BN / TC;
  static_assert(NTX <= 32 && (32 % NTX) == 0,
                "a row's threads must sit in one warp");
  static_assert((NTY * NTX) % 32 == 0, "whole warps only");

  const int tx = threadIdx.x % NTX;
  const int ty = threadIdx.x / NTX;

  float rn[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = row0 + ty + i * NTY;
    rn[i] = (r < M) ? a_norm[r] : 0.0f;
    part[i] = 0.0f;
  }

  for (int n0 = 0; n0 < N; n0 += BN) {
    float acc[TR][TC];
    dot_tile<T, BM, BN, TR, TC>(A, B, M, N, D, row0, n0, acc);
    add_weighted<TR, TC, NTX>(acc, rn, b_norm, w, N, n0, tx, p, part);
  }
  reduce_row<TR, NTX>(part);
}

// The pipelined SIMT tiles' staging (gram.cu's f32 class, the f32 split
// class of split_rows.cuh): one BK-deep chunk of rows fetched as float4s into
// registers, then transposed into shared memory.

// Rows [base, base + R) x features [k0, k0 + BK) of src (rows x d) as
// float4s, L a thread, 0 outside the matrix; `vec`: d % 4 == 0 and src
// 16-byte aligned, so a float4 is wholly inside or outside.
template <int BK, int L, int NT>
__device__ __forceinline__ void fetch_chunk(const float* __restrict__ src,
                                            int rows, int d, int base,
                                            int k0, bool vec,
                                            float4 (&r)[L]) {
  constexpr int Q = BK / 4;   // float4s in a row of the chunk
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int u = threadIdx.x + l * NT;
    const int gr = base + u / Q;
    const int gk = k0 + (u % Q) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (gr < rows) {
      const float* s = src + static_cast<size_t>(gr) * d + gk;
      if (vec) {
        if (gk < d) v = __ldg(reinterpret_cast<const float4*>(s));
      } else {
        if (gk < d) v.x = __ldg(s);
        if (gk + 1 < d) v.y = __ldg(s + 1);
        if (gk + 2 < d) v.z = __ldg(s + 2);
        if (gk + 3 < d) v.w = __ldg(s + 3);
      }
    }
    r[l] = v;
  }
}

// The fetched float4s, transposed into dst[k][row].
template <int BK, int L, int NT, int LD>
__device__ __forceinline__ void stash_chunk(float (*dst)[LD],
                                            const float4 (&r)[L]) {
  constexpr int Q = BK / 4;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int u = threadIdx.x + l * NT;
    const int row = u / Q;
    const int k = (u % Q) * 4;
    dst[k][row] = r[l].x;
    dst[k + 1][row] = r[l].y;
    dst[k + 2][row] = r[l].z;
    dst[k + 3][row] = r[l].w;
  }
}

}  // namespace repro
