// Mamba's selective scan, forward and backward, in f32:
//
//   h_t = exp(dt_t A) * h_{t-1} + dt_t u_t B_t,   y_t = <h_t, C_t> + D u_t
//
// for each batch row b and channel i (h: N states, A: the channel's row).
//
// Replaces no Pallas kernel. The JAX package runs this recurrence as a
// lax.scan over chunks of 128 steps, each chunk under jax.checkpoint
// (src/repro/models/mamba.py:47, _ssm_scan), which XLA compiles to one
// loop on the device; the port ran it as a Python loop of ~8 operations a
// step. These kernels are that loop on the card, and their backward keeps
// the reference's structure: the forward writes the state at each chunk's
// start, the backward walks the chunks last to first, recomputes each
// chunk's states from its carry into a workspace of one chunk and walks
// the chunk backwards (kernels/scan/ref.py's ssm_scan_bwd_plain is the
// same arithmetic in PyTorch operations).
//
// Design: one thread a channel, CH channels a CTA, grid (inner / CH, Bt).
// A thread keeps h[N] and A[i, :N] in registers (N templated: 8 reduced,
// 16 jamba); B_t and C_t, shared by every channel of a row, are staged in
// shared memory T steps at a time in the forward and read as broadcast
// loads in the backward. A step's arithmetic does not depend on S or on
// the step's place in a chunk (the state update is one helper that the
// forward and the recompute share; the sum over N runs n = 0..N-1), so a
// prefill of S steps and S decode steps of one step give the same bits.
// The backward's sums over channels (dB, dC) are per-CTA fixed-order
// sums, then a second pass over the CTAs in order; those over batch rows
// and time (dA, dD) are per-thread sums, then a pass over the rows in
// order (scan.cuh): no float atomics, so two runs are bitwise equal.
//
// What bounds it on an H100: the bytes (u, dt read and y written once:
// 12 B a channel-step; B, C: 8N B a row-step) and the exps (one a state a
// step). jamba's layer at B = 1, S = 4096, inner 16384, N 16: 0.8 GB
// (0.24 ms at 3.35 TB/s) and 1.07 G expf (~0.28 ms on the SFUs). With one
// thread a channel the card holds only inner x Bt threads (16384 at B = 1:
// 4 warps an SM) walking S dependent steps, so latency, not either bound,
// sets the pace; spreading N over lanes or the chunked-parallel form is
// later work (ROADMAP B.9).
#include <cuda_runtime.h>

#include "scan.cuh"

namespace repro {
namespace {

constexpr int CH = 64;   // channels (threads) a CTA: ops.SSM_CHANNELS
constexpr int NW = CH / 32;
constexpr int T = 32;    // steps of B_t, C_t staged at a time (forward)

struct Fwd {
  const float *u, *dt, *B, *C, *A, *D, *h0;
  float *y, *h_last, *carries;
  int bt, S, inner, ck, nc;
};

struct Bwd {
  const float *gy, *gh, *u, *dt, *B, *C, *A, *D, *carries;
  float *du, *ddt, *dB, *dC, *dA, *dD, *dh0;
  float *ws, *dB_part, *dC_part, *dA_part, *dD_part;
  int bt, S, inner, ck, nc;
};

// One step of a channel's state. The forward and the backward's
// recompute share it, so the two give the same states.
template <int N>
__device__ __forceinline__ void ssm_step(float (&h)[N], const float (&A)[N],
                                         float dt, float dtu,
                                         const float* Bt) {
#pragma unroll
  for (int n = 0; n < N; ++n)
    h[n] = __fmaf_rn(expf(__fmul_rn(dt, A[n])), h[n], __fmul_rn(dtu, Bt[n]));
}

template <int N>
__global__ void __launch_bounds__(CH) ssm_fwd(Fwd a) {
  __shared__ float sB[T][N], sC[T][N];
  const int b = blockIdx.y, i = blockIdx.x * CH + threadIdx.x;
  const bool live = i < a.inner;
  const size_t row = static_cast<size_t>(b) * a.S;
  float h[N], A[N];
  const float Di = live ? a.D[i] : 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    A[n] = live ? a.A[static_cast<size_t>(i) * N + n] : 0.f;
    h[n] = live ? a.h0[(static_cast<size_t>(b) * a.inner + i) * N + n] : 0.f;
  }
  for (int t0 = 0; t0 < a.S; t0 += T) {
    const int nt = min(T, a.S - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < nt * N; j += CH) {
      sB[j / N][j % N] = a.B[(row + t0) * N + j];
      sC[j / N][j % N] = a.C[(row + t0) * N + j];
    }
    __syncthreads();
    if (!live) continue;
    for (int s = 0; s < nt; ++s) {
      const int t = t0 + s;
      if (t % a.ck == 0) {
        float* c = a.carries +
                   ((static_cast<size_t>(b) * a.nc + t / a.ck) * a.inner + i) *
                       N;
#pragma unroll
        for (int n = 0; n < N; ++n) c[n] = h[n];
      }
      const size_t x = (row + t) * a.inner + i;
      const float u = a.u[x], dt = a.dt[x];
      ssm_step<N>(h, A, dt, __fmul_rn(dt, u), sB[s]);
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) acc = __fmaf_rn(h[n], sC[s][n], acc);
      a.y[x] = __fmaf_rn(Di, u, acc);
    }
  }
  if (live) {
    float* hl = a.h_last + (static_cast<size_t>(b) * a.inner + i) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) hl[n] = h[n];
  }
}

template <int N>
__global__ void __launch_bounds__(CH) ssm_bwd(Bwd a) {
  __shared__ float red[NW][2 * N];
  const int b = blockIdx.y, i = blockIdx.x * CH + threadIdx.x;
  const bool live = i < a.inner;
  const size_t row = static_cast<size_t>(b) * a.S;
  const size_t bi = static_cast<size_t>(b) * a.inner + i;
  float A[N], g[N], gA[N];
  const float Di = live ? a.D[i] : 0.f;
  float gD = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    A[n] = live ? a.A[static_cast<size_t>(i) * N + n] : 0.f;
    g[n] = live ? a.gh[bi * N + n] : 0.f;   // d/d h after the last step
    gA[n] = 0.f;
  }
  // The chunk's states, [s][n][i] for this row: neighbouring channels
  // write neighbouring addresses.
  float* ws = a.ws + static_cast<size_t>(b) * a.ck * N * a.inner + i;
  for (int c = a.nc - 1; c >= 0; --c) {
    const int t0 = c * a.ck, t1 = min(t0 + a.ck, a.S);
    const float* carry =
        a.carries + ((static_cast<size_t>(b) * a.nc + c) * a.inner + i) * N;
    if (live) {
      float h[N];
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = carry[n];
      for (int t = t0; t < t1; ++t) {
        const size_t x = (row + t) * a.inner + i;
        const float u = a.u[x], dt = a.dt[x];
        ssm_step<N>(h, A, dt, __fmul_rn(dt, u), a.B + (row + t) * N);
        float* w = ws + static_cast<size_t>(t - t0) * N * a.inner;
#pragma unroll
        for (int n = 0; n < N; ++n) w[n * a.inner] = h[n];
      }
    }
    for (int t = t1 - 1; t >= t0; --t) {
      float v[2 * N];   // this channel's dB (v[:N]) and dC (v[N:]) terms
      if (live) {
        const size_t x = (row + t) * a.inner + i;
        const float u = a.u[x], dt = a.dt[x], gy = a.gy[x];
        const float dtu = __fmul_rn(dt, u);
        const float* Bt = a.B + (row + t) * N;
        const float* Ct = a.C + (row + t) * N;
        const float* ht = ws + static_cast<size_t>(t - t0) * N * a.inner;
        // The state before step t: the one after step t - 1, or the carry.
        const float* hp = t > t0 ? ht - static_cast<size_t>(N) * a.inner
                                 : carry;
        const int hs = t > t0 ? a.inner : 1;
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float h_t = ht[n * a.inner];
          const float h_p = hp[n * hs];
          const float gn = __fmaf_rn(gy, Ct[n], g[n]);      // d/d h_t
          const float dAe = expf(__fmul_rn(dt, A[n]));
          const float gdA = __fmul_rn(__fmul_rn(gn, h_p), dAe);  // d/d(dt A)
          s1 = __fmaf_rn(gdA, A[n], s1);
          s2 = __fmaf_rn(gn, Bt[n], s2);
          gA[n] = __fmaf_rn(gdA, dt, gA[n]);
          v[n] = __fmul_rn(gn, dtu);
          v[N + n] = __fmul_rn(gy, h_t);
          g[n] = __fmul_rn(gn, dAe);                          // d/d h_{t-1}
        }
        a.ddt[x] = __fmaf_rn(s2, u, s1);
        a.du[x] = __fmaf_rn(s2, dt, __fmul_rn(gy, Di));
        gD = __fmaf_rn(gy, u, gD);
      } else {
#pragma unroll
        for (int n = 0; n < 2 * N; ++n) v[n] = 0.f;
      }
      const float s = cta_sums<2 * N, NW>(v, red);
      if (threadIdx.x < 2 * N) {
        const int n = threadIdx.x % N;
        float* part = threadIdx.x < N ? a.dB_part : a.dC_part;
        part[((static_cast<size_t>(blockIdx.x) * a.bt + b) * a.S + t) * N +
             n] = s;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      a.dh0[bi * N + n] = g[n];
      a.dA_part[bi * N + n] = gA[n];
    }
    a.dD_part[bi] = gD;
  }
}

template <int N>
void launch_fwd(const Fwd& a, cudaStream_t st) {
  const dim3 grid((a.inner + CH - 1) / CH, a.bt);
  ssm_fwd<N><<<grid, CH, 0, st>>>(a);
}

template <int N>
void launch_bwd(const Bwd& a, cudaStream_t st) {
  const int nblk = (a.inner + CH - 1) / CH;
  ssm_bwd<N><<<dim3(nblk, a.bt), CH, 0, st>>>(a);
  const long rows = static_cast<long>(a.bt) * a.S * N;
  launch_sum_parts(a.dB_part, a.dB, nblk, rows, st);
  launch_sum_parts(a.dC_part, a.dC, nblk, rows, st);
  launch_sum_parts(a.dA_part, a.dA, a.bt, static_cast<long>(a.inner) * N,
                   st);
  launch_sum_parts(a.dD_part, a.dD, a.bt, a.inner, st);
}

bool bad_sizes(int bt, int S, int inner, int chunk) {
  return bt <= 0 || bt > 65535 || S <= 0 || inner <= 0 || chunk <= 0;
}

}  // namespace
}  // namespace repro

// u, dt (bt, S, inner); B, C (bt, S, N); A (inner, N); D (inner,); h0,
// h_last (bt, inner, N); y (bt, S, inner); carries (bt, nc, inner, N)
// with ck = min(chunk, S), nc = ceil(S / ck): the state before each
// chunk's first step. All f32, contiguous. N is 8 or 16. Launches on
// `stream` (of the caller's current device) and returns
// cudaGetLastError(); cudaErrorInvalidValue, launching nothing, for
// another N or an empty shape.
extern "C" int ssm_scan_fwd_launch(const void* u, const void* dt,
                                   const void* B, const void* C,
                                   const void* A, const void* D,
                                   const void* h0, void* y, void* h_last,
                                   void* carries, int bt, int S, int inner,
                                   int N, int chunk, void* stream) {
  using namespace repro;
  if (bad_sizes(bt, S, inner, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ck = chunk < S ? chunk : S, nc = (S + ck - 1) / ck;
  const Fwd a{static_cast<const float*>(u),  static_cast<const float*>(dt),
              static_cast<const float*>(B),  static_cast<const float*>(C),
              static_cast<const float*>(A),  static_cast<const float*>(D),
              static_cast<const float*>(h0), static_cast<float*>(y),
              static_cast<float*>(h_last),   static_cast<float*>(carries),
              bt, S, inner, ck, nc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 8: launch_fwd<8>(a, st); break;
    case 16: launch_fwd<16>(a, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The gradients of ssm_scan_fwd_launch's (y, h_last) given gy (bt, S,
// inner) and gh (bt, inner, N): du, ddt (bt, S, inner), dB, dC (bt, S,
// N), dA (inner, N), dD (inner,), dh0 (bt, inner, N). Workspace, f32:
// ws (bt, ck, N, inner), one chunk's states; dB_part, dC_part (nblk, bt,
// S, N) with nblk = ceil(inner / 64), the per-CTA sums; dA_part (bt,
// inner, N) and dD_part (bt, inner), the per-row sums. Five launches on
// `stream` (the scan, then the four fixed-order passes); returns
// cudaGetLastError(), or cudaErrorInvalidValue as the forward.
extern "C" int ssm_scan_bwd_launch(
    const void* gy, const void* gh, const void* u, const void* dt,
    const void* B, const void* C, const void* A, const void* D,
    const void* carries, void* du, void* ddt, void* dB, void* dC, void* dA,
    void* dD, void* dh0, void* ws, void* dB_part, void* dC_part,
    void* dA_part, void* dD_part, int bt, int S, int inner, int N,
    int chunk, void* stream) {
  using namespace repro;
  if (bad_sizes(bt, S, inner, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ck = chunk < S ? chunk : S, nc = (S + ck - 1) / ck;
  const Bwd a{static_cast<const float*>(gy), static_cast<const float*>(gh),
              static_cast<const float*>(u),  static_cast<const float*>(dt),
              static_cast<const float*>(B),  static_cast<const float*>(C),
              static_cast<const float*>(A),  static_cast<const float*>(D),
              static_cast<const float*>(carries),
              static_cast<float*>(du),       static_cast<float*>(ddt),
              static_cast<float*>(dB),       static_cast<float*>(dC),
              static_cast<float*>(dA),       static_cast<float*>(dD),
              static_cast<float*>(dh0),      static_cast<float*>(ws),
              static_cast<float*>(dB_part),  static_cast<float*>(dC_part),
              static_cast<float*>(dA_part),  static_cast<float*>(dD_part),
              bt, S, inner, ck, nc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 8: launch_bwd<8>(a, st); break;
    case 16: launch_bwd<16>(a, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
