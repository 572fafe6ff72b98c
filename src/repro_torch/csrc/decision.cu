// Slab decision function:   out = (s - rho1) * (rho2 - s),
//                           s   = sum_j gamma_j k(q, t_j).
//
// Replaces the TPU kernel _decision_kernel / decision_pallas of
// src/repro/kernels/decision/kernel.py (grid (NQ/TM, M/TN), support tiles
// walked in order into a VMEM accumulator). Here one CTA owns 16 queries
// and loops over the packed support rows in shared-memory chunks
// (kernel_rows.cuh), keeping one f32 sum per query in registers and
// applying the slab rule once at the end.
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

constexpr int BM = 16;  // queries per CTA
constexpr int BN = 64;  // support rows per shared-memory chunk
constexpr int TR = 1;
constexpr int TC = 4;

template <typename T>
__global__ void __launch_bounds__((BM / TR) * (BN / TC))
    decision_kernel(const T* __restrict__ q, const T* __restrict__ t,
                    const float* __restrict__ gamma,
                    const float* __restrict__ qn,
                    const float* __restrict__ tnorm, float* __restrict__ out,
                    int nq, int nt, int d, KernelParams p, float rho1,
                    float rho2) {
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

template <typename T>
void launch(const void* q, const void* t, const void* gamma, const void* qn,
            const void* tnorm, void* out, int nq, int nt, int d,
            KernelParams p, float rho1, float rho2, cudaStream_t stream) {
  const dim3 grid((nq + BM - 1) / BM);
  constexpr int threads = (BM / TR) * (BN / TC);
  decision_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(t),
      static_cast<const float*>(gamma), static_cast<const float*>(qn),
      static_cast<const float*>(tnorm), static_cast<float*>(out), nq, nt, d,
      p, rho1, rho2);
}

}  // namespace
}  // namespace repro

// q (nq, d) and t (nt, d) row-major in `dtype` (0 f32, 1 bf16, 2 f16);
// gamma (nt,), qn (nq,), tnorm (nt,) and out (nq,) f32. Launches on
// `stream`, which must belong to the caller's current device, and returns
// cudaGetLastError().
extern "C" int decision_launch(const void* q, const void* t,
                               const void* gamma, const void* qn,
                               const void* tnorm, void* out, int nq, int nt,
                               int d, int dtype, int kind, float kgamma,
                               float coef0, int degree, float rho1,
                               float rho2, void* stream) {
  using namespace repro;
  const KernelParams p{kind, kgamma, coef0, degree};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      launch<float>(q, t, gamma, qn, tnorm, out, nq, nt, d, p, rho1, rho2,
                    st);
      break;
    case kBF16:
      launch<__nv_bfloat16>(q, t, gamma, qn, tnorm, out, nq, nt, d, p, rho1,
                            rho2, st);
      break;
    case kF16:
      launch<__half>(q, t, gamma, qn, tnorm, out, nq, nt, d, p, rho1, rho2,
                     st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* decision_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
