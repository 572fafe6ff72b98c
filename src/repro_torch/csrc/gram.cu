// Kernel matrix:   out[i, j] = k(x_i, y_j),   out (m, n) f32.
//
// Replaces the TPU kernel _gram_kernel / gram_pallas of
// src/repro/kernels/gram/kernel.py, which walks an (M/TM, N/TN, D/TK)
// grid with the feature axis innermost, sums each (TM, TN) output tile in
// VMEM across the feature steps and runs the epilogue on the last one,
// on inputs padded to 128-multiples. Here the grid is 2-D over output
// tiles only: each CTA owns a BM x BN tile, walks all the features itself
// in DK-deep chunks staged in shared memory (dot_tile in
// kernel_rows.cuh), and every thread stores its TR x TC outputs directly
// after the epilogue: no cross-thread or cross-CTA reduction, no pass
// over the output but the one store. Ragged rows, columns and features
// are masked, so nothing is padded.
//
// Numerics, as the reference: inputs in f32, bf16 or f16 widened to f32
// as they are staged; f32 norms of the rounded rows (made by the
// wrapper); an f32 FMA dot accumulator; the rbf / poly / linear epilogue
// with the reference's rounding steps (kernel_rows.cuh). Each output is
// one thread's sequential sum over the features, so every menu entry
// gives bitwise the same matrix.
//
// What bounds it on an H100: 2*d flops per output against 4 bytes of
// output written (d = 128: 64 flop per byte) — operations-bound in f32
// (8192 x 8192 x 128: 17.2 GFLOP, 0.256 ms at 67 TFLOP/s, against
// 268 MB of output, 0.080 ms at 3.35 TB/s); bytes-bound against the
// 989 TFLOP/s of 16-bit inputs on the tensor cores. This simple version
// runs f32 FMA on the CUDA cores; wgmma and TMA are later work.
#include "kernel_rows.cuh"

namespace repro {
namespace {

template <typename T, int BM, int BN, int TR, int TC>
__global__ void __launch_bounds__((BM / TR) * (BN / TC))
    gram_kernel(const T* __restrict__ x, const T* __restrict__ y,
                const float* __restrict__ xn, const float* __restrict__ yn,
                float* __restrict__ out, int m, int n, int d,
                KernelParams p) {
  constexpr int NTY = BM / TR;
  constexpr int NTX = BN / TC;
  static_assert((NTY * NTX) % 32 == 0, "whole warps only");
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  float acc[TR][TC];
  dot_tile<T, BM, BN, TR, TC>(x, y, m, n, d, row0, col0, acc);

  const int tx = threadIdx.x % NTX;
  const int ty = threadIdx.x / NTX;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = row0 + ty + i * NTY;
    if (r >= m) continue;
    const float rn = xn[r];
    float* row = out + static_cast<size_t>(r) * n;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int c = col0 + tx + j * NTX;
      if (c < n) row[c] = epilogue(acc[i][j], rn, yn[c], p);
    }
  }
}

struct Args {
  const void *x, *y, *xn, *yn;
  void* out;
  int m, n, d;
  KernelParams p;
};

template <typename T, int BM, int BN, int TR, int TC>
void launch(const Args& a, cudaStream_t stream) {
  // Column tiles on x (up to 2^31 - 1), row tiles on y (up to 65535).
  const dim3 grid((a.n + BN - 1) / BN, (a.m + BM - 1) / BM);
  constexpr int threads = (BM / TR) * (BN / TC);
  gram_kernel<T, BM, BN, TR, TC><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.y),
      static_cast<const float*>(a.xn), static_cast<const float*>(a.yn),
      static_cast<float*>(a.out), a.m, a.n, a.d, a.p);
}

// The menu: launch index -> <BM, BN, TR, TC>, in the order of
// MENUS["gram"] in kernels/tiling.py (tests read these lines). DK is
// fixed; anything else may vary, since no entry changes a sum's order.
// Entry 0 (a 64 x 64 tile, 4 x 4 outputs a thread) is the default.
template <typename T>
int launch_menu(int cfg, const Args& a, cudaStream_t st) {
  switch (cfg) {
    case 0: launch<T, 64, 64, 4, 4>(a, st); break;
    case 1: launch<T, 128, 128, 8, 8>(a, st); break;
    case 2: launch<T, 128, 64, 8, 4>(a, st); break;
    case 3: launch<T, 64, 128, 4, 8>(a, st); break;
    case 4: launch<T, 32, 64, 2, 4>(a, st); break;
    case 5: launch<T, 32, 32, 2, 2>(a, st); break;
    case 6: launch<T, 64, 64, 4, 2>(a, st); break;
    case 7: launch<T, 128, 128, 4, 8>(a, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// x (m, d) and y (n, d) row-major in `dtype` (0 f32, 1 bf16, 2 f16);
// xn (m,), yn (n,) f32 squared norms of the rows (read by rbf only); out
// (m, n) f32; `cfg` the index of a menu entry. Launches on `stream`,
// which must belong to the caller's current device, and returns
// cudaGetLastError() (cudaErrorInvalidValue, launching nothing, for an
// unknown dtype or menu index).
extern "C" int gram_launch(const void* x, const void* y, const void* xn,
                           const void* yn, void* out, int m, int n, int d,
                           int dtype, int kind, float gamma, float coef0,
                           int degree, int cfg, void* stream) {
  using namespace repro;
  const Args a{x, y, xn, yn, out, m, n, d,
               KernelParams{kind, gamma, coef0, degree}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_menu<float>(cfg, a, st);
    case kBF16: return launch_menu<__nv_bfloat16>(cfg, a, st);
    case kF16: return launch_menu<__half>(cfg, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* gram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
