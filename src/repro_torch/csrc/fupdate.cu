// Fused SMO f-cache update:   out = f + k(X, X_sel) @ delta.
//
// Replaces the TPU kernel _fupdate_kernel / fupdate_pallas of
// src/repro/kernels/fupdate/kernel.py, which keeps the whole selected
// block resident in VMEM and walks a (m/TM, d/TK) grid in order. Here the
// selected block can be up to 2048 rows (the init pass and the warm
// reconcile): at d = 128 in f32 that is 1 MiB, far above a CTA's shared
// memory, so each CTA loops over it in chunks (kernel_rows.cuh).
//
// The launch shape comes from a menu of template instantiations (below);
// the wrapper picks the entry through kernels/tiling.resolve_tiles (the
// tuned table, else its class's default).
//
// What bounds it on an H100: on the solver's hot loop S = 2P = 16 or 32,
// so the kernel does 2*S flops per element of X it reads — bytes-bound (X
// is read once per call; 4 MiB at m = 8192, d = 128 in f32, half that in
// 16-bit). The design answers with one pass over X per call, the norms
// precomputed once per solve by the caller, and 16-bit X read as 16-bit.
// For the init pass (m = S = 2048) it is operations-bound; this simple
// version uses f32 FMA on the CUDA cores, not the tensor cores.
#include "kernel_rows.cuh"

namespace repro {
namespace {

template <typename T, int BM, int BN, int TR, int TC>
__global__ void __launch_bounds__((BM / TR) * (BN / TC))
    fupdate_kernel(const T* __restrict__ x, const T* __restrict__ xsel,
                   const float* __restrict__ delta,
                   const float* __restrict__ f,
                   const float* __restrict__ xn,
                   const float* __restrict__ seln, float* __restrict__ out,
                   int m, int s, int d, KernelParams p) {
  constexpr int NTY = BM / TR;
  constexpr int NTX = BN / TC;
  const int row0 = blockIdx.x * BM;
  float part[TR];
  weighted_row_sums<T, BM, BN, TR, TC>(x, xsel, xn, seln, delta, m, s, d, p,
                                       row0, part);
  if (threadIdx.x % NTX == 0) {
    const int ty = threadIdx.x / NTX;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = row0 + ty + i * NTY;
      if (r < m) out[r] = f[r] + part[i];
    }
  }
}

struct Args {
  const void *x, *xsel, *delta, *f, *xn, *seln;
  void* out;
  int m, s, d;
  KernelParams p;
};

template <typename T, int BM, int BN, int TR, int TC>
void launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.m + BM - 1) / BM);
  constexpr int threads = (BM / TR) * (BN / TC);
  fupdate_kernel<T, BM, BN, TR, TC><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.xsel),
      static_cast<const float*>(a.delta), static_cast<const float*>(a.f),
      static_cast<const float*>(a.xn), static_cast<const float*>(a.seln),
      static_cast<float*>(a.out), a.m, a.s, a.d, a.p);
}

// The menu: launch index -> <BM, BN, TR, TC>, in the order of
// MENUS["fupdate"] in kernels/tiling.py (tests read these lines). Two
// classes by the selected block's size S, each with fixed BN and TC so
// that every entry of a class sums each row in the same order: BN = 32
// for the hot loop (S = 2P <= 32: one column chunk), BN = 64 above it
// (the init pass and the warm reconcile, up to S = 2048). Entry 0
// (64 rows per CTA) and entry 6 (32 rows per CTA, so that m = 2048 still
// spreads over 64 CTAs) are each class's default.
template <typename T>
int launch_menu(int cfg, const Args& a, cudaStream_t st) {
  switch (cfg) {
    case 0: launch<T, 64, 32, 4, 2>(a, st); break;
    case 1: launch<T, 32, 32, 2, 2>(a, st); break;
    case 2: launch<T, 32, 32, 4, 2>(a, st); break;
    case 3: launch<T, 16, 32, 1, 2>(a, st); break;
    case 4: launch<T, 128, 32, 8, 2>(a, st); break;
    case 5: launch<T, 64, 32, 2, 2>(a, st); break;
    case 6: launch<T, 32, 64, 2, 4>(a, st); break;
    case 7: launch<T, 16, 64, 1, 4>(a, st); break;
    case 8: launch<T, 16, 64, 2, 4>(a, st); break;
    case 9: launch<T, 64, 64, 4, 4>(a, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// x (m, d) and xsel (s, d) row-major in `dtype` (0 f32, 1 bf16, 2 f16);
// delta (s,), f (m,), xn (m,), seln (s,) and out (m,) f32; `cfg` the
// index of a menu entry. Launches on `stream`, which must belong to the
// caller's current device, and returns cudaGetLastError()
// (cudaErrorInvalidValue, launching nothing, for an unknown dtype or
// menu index).
extern "C" int fupdate_launch(const void* x, const void* xsel,
                              const void* delta, const void* f,
                              const void* xn, const void* seln, void* out,
                              int m, int s, int d, int dtype, int kind,
                              float gamma, float coef0, int degree, int cfg,
                              void* stream) {
  using namespace repro;
  const Args a{x, xsel, delta, f, xn, seln, out, m, s, d,
               KernelParams{kind, gamma, coef0, degree}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_menu<float>(cfg, a, st);
    case kBF16: return launch_menu<__nv_bfloat16>(cfg, a, st);
    case kF16: return launch_menu<__half>(cfg, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* fupdate_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
