// Fixed-order sums shared by the scan kernels (ssm_scan.cu, wkv6.cu).
//
// The backward kernels sum gradients over channels, batch rows and time.
// Float atomics would add them in an order that changes from run to run;
// these helpers add them in one fixed order instead, so two runs on the
// same inputs give the same bits: within a CTA a fixed xor tree per warp
// and the warps in order (cta_sums), across CTAs or rows a second pass
// that adds each element's partials in order (sum_parts).
#pragma once

#include <cuda_runtime.h>

namespace repro {
namespace {

// The sums of v[m] over the CTA's NW warps' threads, for m < M <= the
// CTA's thread count: thread m returns sum m (other threads return 0).
// Every thread of the CTA must call it; `red` is NW x M floats of shared
// memory.
template <int M, int NW>
__device__ __forceinline__ float cta_sums(const float (&v)[M],
                                          float (*red)[M]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float x = v[m];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) red[warp][m] = x;
  }
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x < M) {
#pragma unroll
    for (int w = 0; w < NW; ++w) s += red[w][threadIdx.x];
  }
  __syncthreads();   // red is free again when this returns
  return s;
}

// out[j] = the sum over p < parts of in[p * n + j], p in order.
__global__ void sum_parts(const float* __restrict__ in,
                          float* __restrict__ out, int parts, long n) {
  const long j = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
  if (j >= n) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += in[p * n + j];
  out[j] = s;
}

inline void launch_sum_parts(const float* in, float* out, int parts, long n,
                             cudaStream_t st) {
  constexpr int kThreads = 256;
  const long blocks = (n + kThreads - 1) / kThreads;
  sum_parts<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(in, out,
                                                                parts, n);
}

}  // namespace
}  // namespace repro
