// Shared device code of the fupdate and decision kernels.
//
// Both kernels compute, for every row r of a matrix A, the weighted row
// sum
//
//     s[r] = sum_{c < N} w[c] * k(A[r], B[c])
//
// where k is the linear, rbf or poly kernel evaluated on an f32 dot
// product (rbf also reads the f32 squared norms of the rows). fupdate
// takes A = the training rows, B = the selected block, w = the dual step
// and writes f + s; decision takes A = the queries, B = the packed
// support rows, w = gamma and writes (s - rho1) * (rho2 - s).
//
// Layout: one CTA owns BM rows of A, so its outputs belong to it alone:
// no cross-CTA reduction and no atomics. It walks B in chunks of BN rows
// and the features in chunks of DK; each chunk of A and B is staged in
// shared memory as f32 (16-bit inputs are widened as they are loaded),
// and each thread keeps a TR x TC register tile of dot products summed
// by f32 FMA. After the last feature chunk the kernel epilogue runs on
// the thread's tile, weighted by w, into TR per-row partials; the NTX
// threads sharing a row add their partials with warp shuffles at the
// end. Ragged edges are masked here: rows of A past M and features past
// D load as 0, and columns past N are skipped in the epilogue, so they
// add exactly nothing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace repro {

enum Kind { kLinear = 0, kRbf = 1, kPoly = 2 };
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// Feature-chunk depth staged in shared memory per step.
constexpr int DK = 32;

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
// poly (g * dot + c0) ** degree.
__device__ __forceinline__ float epilogue(float dot, float rn, float cn,
                                          const KernelParams& p) {
  if (p.kind == kRbf) {
    const float sq = __fsub_rn(__fadd_rn(rn, cn), __fmul_rn(2.0f, dot));
    return expf(__fmul_rn(-p.gamma, fmaxf(sq, 0.0f)));
  }
  if (p.kind == kPoly) {
    return int_pow(__fadd_rn(__fmul_rn(p.gamma, dot), p.coef0), p.degree);
  }
  return dot;
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
  constexpr int NT = NTY * NTX;
  static_assert(NTX <= 32 && (32 % NTX) == 0,
                "a row's threads must sit in one warp");
  // +1 column of padding: the transposed stores below hit 32 banks.
  __shared__ float As[DK][BM + 1];
  __shared__ float Bs[DK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % NTX;
  const int ty = tid / NTX;

  float rn[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = row0 + ty + i * NTY;
    rn[i] = (r < M) ? a_norm[r] : 0.0f;
    part[i] = 0.0f;
  }

  for (int n0 = 0; n0 < N; n0 += BN) {
    float acc[TR][TC];
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
        const int gc = n0 + c, gk = k0 + k;
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

#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int off = NTX / 2; off > 0; off >>= 1)
      part[i] += __shfl_xor_sync(0xffffffffu, part[i], off);
}

}  // namespace repro
