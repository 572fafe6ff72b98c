// Slab decision function:   out = (s - rho1) * (rho2 - s),
//                           s   = sum_j gamma_j k(q, t_j).
//
// Replaces the TPU kernel _decision_kernel / decision_pallas of
// src/repro/kernels/decision/kernel.py, whose grid (NQ/TM, M/TN) walks
// the support tiles in order on one core into a VMEM accumulator. On
// Hopper that support axis is spread over the SMs: the split kernels of
// split_rows.cuh with A = the queries, B = the support rows, w = gamma,
// and the slab rule as the reduction's epilogue. That header states the
// design, the numerics and the sum order every entry of a class keeps.
//
// What bounds it on an H100: every query meets every support row, 2*d
// flops a pair, and rbf adds one expf and about 7 f32 instructions a
// pair. At 4096 x 4096, d = 128: 4.3 GFLOP (0.064 ms of f32 FMA at
// 67 TFLOP/s, 0.0044 ms on the tensor cores) and 16.7 M exps (about
// 4.5 us at 16 a clock per SM). f32 rows take the SIMT class, bf16/f16
// rows the wgmma class; a 16-bit query tile too wide to stay resident in
// shared memory (d above 640-1664 by the entry) takes the streamed entry.
#include "split_rows.cuh"

namespace repro {
namespace {

struct Args {
  const void *q, *t, *gamma, *qn, *tnorm;
  float* ws;
  void* out;
  int nq, nt, d;
  KernelParams p;
  float rho1, rho2;
};

SplitArgs split_args(const Args& a) {
  return SplitArgs{a.q, a.t, a.gamma, a.qn, a.tnorm, a.ws,
                   a.nq, a.nt, a.d, a.p};
}

SlabRule slab_rule(const Args& a) {
  return SlabRule{static_cast<float*>(a.out), a.rho1, a.rho2};
}

template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH>
int launch_simt(const Args& a, cudaStream_t st) {
  return launch_split_simt<T, BM, BN, BK, TR, TC, DEPTH>(
      split_args(a), slab_rule(a), st);
}

template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH>
int launch_wgmma(const Args& a, cudaStream_t st) {
  return launch_split_wgmma<T, BM, BN, BK, TR, TC, DEPTH, false>(
      split_args(a), slab_rule(a), st);
}

// A streamed query tile: NW = 4 * TC = 256 takes the wide kernel whose
// clusters share the support rows, narrower chunks the plain one.
template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH>
int launch_stream(const Args& a, cudaStream_t st) {
  if constexpr (4 * TC == 256)
    return launch_split_cluster<T, BM, BN, BK, TR, TC, DEPTH>(
        split_args(a), slab_rule(a), st);
  else
    return launch_split_wgmma<T, BM, BN, BK, TR, TC, DEPTH, true>(
        split_args(a), slab_rule(a), st);
}

// The menu: launch index -> <BM, BN, BK, TR, TC, DEPTH>, in the order of
// MENUS["decision"] in kernels/tiling.py (tests read these lines). Two
// classes by the rows' type, each compiled for its types only: f32 runs
// the SIMT entries (SW = BN = 64; entry 0 is the default), bf16 and f16
// the wgmma entries (SW = BN = 32, NW = 4 * TC; entry 4 is the default;
// entries 9 and 10 stream the query tile, for any d, 10 in 2-CTA clusters
// of NW = 256). An index of the other class is refused with
// cudaErrorInvalidValue.
template <typename T>
int launch_f32(int cfg, const Args& a, cudaStream_t st) {
  switch (cfg) {
    case 0: return launch_simt<T, 128, 64, 8, 8, 8, 2>(a, st);
    case 1: return launch_simt<T, 64, 64, 8, 4, 8, 2>(a, st);
    case 2: return launch_simt<T, 32, 64, 8, 4, 8, 2>(a, st);
    case 3: return launch_simt<T, 16, 64, 8, 4, 8, 2>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_16bit(int cfg, const Args& a, cudaStream_t st) {
  switch (cfg) {
    case 4: return launch_wgmma<T, 128, 32, 64, 2, 8, 4>(a, st);
    case 5: return launch_wgmma<T, 64, 32, 64, 2, 8, 4>(a, st);
    case 6: return launch_wgmma<T, 128, 32, 64, 2, 16, 4>(a, st);
    case 7: return launch_wgmma<T, 128, 32, 64, 2, 32, 4>(a, st);
    case 8: return launch_wgmma<T, 128, 32, 64, 2, 32, 2>(a, st);
    case 9: return launch_stream<T, 128, 32, 64, 2, 16, 3>(a, st);
    case 10: return launch_stream<T, 128, 32, 64, 2, 64, 4>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro

// q (nq, d) and t (nt, d) row-major in `dtype` (0 f32, 1 bf16, 2 f16; in
// 16 bits d % 8 == 0 and both 16-byte aligned); gamma (nt,), qn (nq,),
// tnorm (nt,) and out (nq,) f32; ws an f32 workspace of (splits, nq) with
// splits = ceil(nt / BN) of the entry; `cfg` the index of a menu entry of
// the dtype's class. Launches on `stream`, which must belong to the
// caller's current device, and returns cudaGetLastError(); launching
// nothing, cudaErrorInvalidValue for an unknown dtype or menu index, a
// TMA map cuTensorMapEncodeTiled refuses or a resident 16-bit query tile
// too wide for shared memory (tiling.wgmma_fits: take the streamed entry
// or another that fits), cudaErrorMisalignedAddress for 16-bit rows TMA
// cannot read and cudaErrorNotSupported when cuTensorMapEncodeTiled is
// not found.
extern "C" int decision_launch(const void* q, const void* t,
                               const void* gamma, const void* qn,
                               const void* tnorm, void* ws, void* out,
                               int nq, int nt, int d, int dtype, int kind,
                               float kgamma, float coef0, int degree,
                               float rho1, float rho2, int cfg,
                               void* stream) {
  using namespace repro;
  const Args a{q,  t,  gamma, qn, tnorm, static_cast<float*>(ws), out,
               nq, nt, d,     KernelParams{kind, kgamma, coef0, degree},
               rho1, rho2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_f32<float>(cfg, a, st);
    case kBF16: return launch_16bit<__nv_bfloat16>(cfg, a, st);
    case kF16: return launch_16bit<__half>(cfg, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The clusters of case 10 (the wide streamed entry) the current card holds
// at once, for rows of `dtype` (1 bf16, 2 f16), into *most: what its
// launcher sizes the grid from. Returns a CUDA error, or
// cudaErrorInvalidValue for another dtype.
extern "C" int decision_wide_clusters(int dtype, int* most) {
  using namespace repro;
  switch (dtype) {
    case kBF16:
      return split_cluster_capacity<__nv_bfloat16, 128, 32, 64, 2, 64, 4>(
          most);
    case kF16:
      return split_cluster_capacity<__half, 128, 32, 64, 2, 64, 4>(most);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* decision_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
