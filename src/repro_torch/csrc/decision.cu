// Slab decision function:   out = (s - rho1) * (rho2 - s),
//                           s   = sum_j gamma_j k(q, t_j).
//
// Replaces the TPU kernel _decision_kernel / decision_pallas of
// src/repro/kernels/decision/kernel.py (grid (NQ/TM, M/TN), support tiles
// walked in order into a VMEM accumulator). Here one CTA owns BM queries
// (16 by default; the menu below) and loops over the packed support rows
// in shared-memory chunks (kernel_rows.cuh), keeping one f32 sum per
// query in registers and applying the slab rule once at the end.
//
// What bounds it on an H100: every query meets every support row, 2*d
// flops per pair against the support block read once per CTA from L2 —
// operations-bound at serving batch sizes (at 4096 queries x 4096 support
// rows, d = 128: 4.3 GFLOP against 2 MiB of f32 support rows). This simple
// version runs f32 FMA on the CUDA cores; the tensor cores (wgmma) are
// later work. The support block is read in the serving dtype, 16-bit
// when packed so.
#include "kernel_rows.cuh"

namespace repro {
namespace {

template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH>
__global__ void __launch_bounds__((BM / TR) * (BN / TC))
    decision_kernel(const T* __restrict__ q, const T* __restrict__ t,
                    const float* __restrict__ gamma,
                    const float* __restrict__ qn,
                    const float* __restrict__ tnorm, float* __restrict__ out,
                    int nq, int nt, int d, KernelParams p, float rho1,
                    float rho2) {
  static_assert(BK == DK && DEPTH == 1, "dot_tile stages DK, one stage");
  constexpr int NTY = BM / TR;
  constexpr int NTX = BN / TC;
  const int row0 = blockIdx.x * BM;
  float part[TR];
  weighted_row_sums<T, BM, BN, TR, TC>(q, t, qn, tnorm, gamma, nq, nt, d, p,
                                       row0, part);
  if (threadIdx.x % NTX == 0) {
    const int ty = threadIdx.x / NTX;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = row0 + ty + i * NTY;
      if (r < nq) {
        const float s = part[i];
        out[r] = __fmul_rn(__fsub_rn(s, rho1), __fsub_rn(rho2, s));
      }
    }
  }
}

struct Args {
  const void *q, *t, *gamma, *qn, *tnorm;
  void* out;
  int nq, nt, d;
  KernelParams p;
  float rho1, rho2;
};

template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH>
int launch_tile(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.nq + BM - 1) / BM);
  constexpr int threads = (BM / TR) * (BN / TC);
  decision_kernel<T, BM, BN, BK, TR, TC, DEPTH><<<grid, threads, 0,
                                                  stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.t),
      static_cast<const float*>(a.gamma), static_cast<const float*>(a.qn),
      static_cast<const float*>(a.tnorm), static_cast<float*>(a.out), a.nq,
      a.nt, a.d, a.p, a.rho1, a.rho2);
  return static_cast<int>(cudaGetLastError());
}

// The menu: launch index -> <BM, BN, BK, TR, TC, DEPTH>, in the order of
// MENUS["decision"] in kernels/tiling.py (tests read these lines). BN = 64
// support rows per chunk and TC = 4 are fixed, so every entry sums each
// query's s in the same order; entry 0 (16 queries per CTA) is the
// default.
template <typename T>
int launch_menu(int cfg, const Args& a, cudaStream_t st) {
  switch (cfg) {
    case 0: return launch_tile<T, 16, 64, 32, 1, 4, 1>(a, st);
    case 1: return launch_tile<T, 8, 64, 32, 1, 4, 1>(a, st);
    case 2: return launch_tile<T, 32, 64, 32, 2, 4, 1>(a, st);
    case 3: return launch_tile<T, 32, 64, 32, 1, 4, 1>(a, st);
    case 4: return launch_tile<T, 64, 64, 32, 4, 4, 1>(a, st);
    case 5: return launch_tile<T, 16, 64, 32, 2, 4, 1>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro

// q (nq, d) and t (nt, d) row-major in `dtype` (0 f32, 1 bf16, 2 f16);
// gamma (nt,), qn (nq,), tnorm (nt,) and out (nq,) f32; `cfg` the index
// of a menu entry. Launches on `stream`, which must belong to the
// caller's current device, and returns cudaGetLastError()
// (cudaErrorInvalidValue, launching nothing, for an unknown dtype or
// menu index).
extern "C" int decision_launch(const void* q, const void* t,
                               const void* gamma, const void* qn,
                               const void* tnorm, void* out, int nq, int nt,
                               int d, int dtype, int kind, float kgamma,
                               float coef0, int degree, float rho1,
                               float rho2, int cfg, void* stream) {
  using namespace repro;
  const Args a{q, t, gamma, qn, tnorm, out, nq, nt, d,
               KernelParams{kind, kgamma, coef0, degree}, rho1, rho2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_menu<float>(cfg, a, st);
    case kBF16: return launch_menu<__nv_bfloat16>(cfg, a, st);
    case kF16: return launch_menu<__half>(cfg, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* decision_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
