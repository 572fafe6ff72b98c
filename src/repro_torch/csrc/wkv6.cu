// RWKV6's WKV recurrence, forward and backward, in f32, per batch row b
// and head h with head size D:
//
//   y_t = r_t (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(w_t) S_{t-1}
//                                                    + k_t v_t^T
//
// (S: D x D; y_t[e] = sum_d r_t[d] (S[d][e] + u[d] k_t[d] v_t[e])).
//
// Replaces no Pallas kernel. The JAX package runs the recurrence as a
// lax.scan over chunks of 128 steps, each under jax.checkpoint
// (src/repro/models/rwkv.py:96, inside rwkv_time_mix), which XLA compiles
// to one loop on the device; the port ran it as a Python loop of ~5
// operations a step. These kernels are that loop on the card, with the
// reference's backward structure: the forward writes the state at each
// chunk's start; the backward walks the chunks last to first, recomputes
// each chunk's states from its carry into a workspace of one chunk
// (never S_{t-1} = (S_t - k v^T) / w, which loses everything where w is
// tiny) and walks it backwards (kernels/scan/ref.py's wkv6_bwd_plain is
// the same arithmetic in PyTorch operations). Only the real steps are
// scanned (ROADMAP C.13).
//
// Design: one CTA a (b, h), D threads (templated: 16 reduced, 64
// rwkv6-7b). Forward: thread e keeps column S[:, e] in registers and
// r_t, k_t, w_t (shared by every column) in shared memory, T steps at a
// time; y_t[e] sums d = 0..D-1 in order in one thread. Backward: thread d
// keeps row d of the state's gradient, so dr, dk, dw and du are sums
// within a thread; dv sums over the rows, through a D x (D + 1) tile of
// shared memory, in row order. No float atomics: du's per-row sums are
// added over the batch rows in order by a second pass (scan.cuh). A
// step's arithmetic does not depend on S (the state update is written
// the same way in both kernels), so a prefill of S steps and S decode
// steps of one step give the same bits.
//
// What bounds it on an H100: bytes (r, k, v, w read and y written once,
// 20 B a (b, t, h, d)) against 2 D FLOP a (b, t, h, e) of FMA: rwkv6-7b's
// layer at B = 4, S = 512 moves 168 MB (0.050 ms at 3.35 TB/s) for
// 0.27 GFLOP (0.004 ms at 67 TFLOP/s). B x H CTAs of D threads (256 CTAs
// of 2 warps there) walking S dependent steps: latency sets the pace;
// the chunked-parallel form is later work (ROADMAP B.9).
#include <cuda_runtime.h>

#include "scan.cuh"

namespace repro {
namespace {

constexpr int T = 16;   // steps of r, k, w staged at a time (forward)

struct Fwd {
  const float *r, *k, *v, *w, *u, *S0;
  float *y, *S_last, *carries;
  int b, S, H, ck, nc;
};

struct Bwd {
  const float *gy, *gS, *r, *k, *v, *w, *u, *carries;
  float *dr, *dk, *dv, *dw, *du, *dS0;
  float *ws, *du_part;
  int b, S, H, ck, nc;
};

// S[d][e] after a step; the forward and the backward's recompute share it.
__device__ __forceinline__ float wkv_update(float s, float w, float kv) {
  return __fmaf_rn(w, s, kv);
}

template <int D>
__global__ void __launch_bounds__(D) wkv_fwd(Fwd a) {
  __shared__ float sr[T][D], sk[T][D], sw[T][D], su[D];
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, e = threadIdx.x;
  const size_t DD = static_cast<size_t>(D) * D;
  su[e] = a.u[h * D + e];
  float S[D];   // column e of the state
  const float* s0 = a.S0 + bh * DD + e;
#pragma unroll
  for (int d = 0; d < D; ++d) S[d] = s0[d * D];
  for (int t0 = 0; t0 < a.S; t0 += T) {
    const int nt = min(T, a.S - t0);
    __syncthreads();
    for (int s = 0; s < nt; ++s) {
      const size_t x =
          ((static_cast<size_t>(b) * a.S + t0 + s) * a.H + h) * D + e;
      sr[s][e] = a.r[x];
      sk[s][e] = a.k[x];
      sw[s][e] = a.w[x];
    }
    __syncthreads();
    for (int s = 0; s < nt; ++s) {
      const int t = t0 + s;
      if (t % a.ck == 0) {
        float* c = a.carries +
                   ((static_cast<size_t>(b) * a.nc + t / a.ck) * a.H + h) * DD +
                   e;
#pragma unroll
        for (int d = 0; d < D; ++d) c[d * D] = S[d];
      }
      const size_t x = ((static_cast<size_t>(b) * a.S + t) * a.H + h) * D + e;
      const float ve = a.v[x];
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float kv = __fmul_rn(sk[s][d], ve);
        acc = __fmaf_rn(sr[s][d], __fmaf_rn(su[d], kv, S[d]), acc);
        S[d] = wkv_update(S[d], sw[s][d], kv);
      }
      a.y[x] = acc;
    }
  }
  float* sl = a.S_last + bh * DD + e;
#pragma unroll
  for (int d = 0; d < D; ++d) sl[d * D] = S[d];
}

template <int D>
__global__ void __launch_bounds__(D) wkv_bwd(Bwd a) {
  __shared__ float sv[D], sgy[D], gv[D][D + 1];
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, d = threadIdx.x;
  const size_t DD = static_cast<size_t>(D) * D;
  const float ud = a.u[h * D + d];
  float g[D];   // row d of d/d S_t, S_t the state after the current step
  const float* gS = a.gS + bh * DD + static_cast<size_t>(d) * D;
#pragma unroll
  for (int e = 0; e < D; ++e) g[e] = gS[e];
  float gu = 0.f;
  // The chunk's states, [s][e][d] for this (b, h): neighbouring rows
  // write neighbouring addresses.
  float* ws = a.ws + bh * a.ck * DD + d;
  for (int c = a.nc - 1; c >= 0; --c) {
    const int t0 = c * a.ck, t1 = min(t0 + a.ck, a.S);
    const float* carry =
        a.carries + ((static_cast<size_t>(b) * a.nc + c) * a.H + h) * DD +
        static_cast<size_t>(d) * D;   // row d
    {
      float Sr[D];
#pragma unroll
      for (int e = 0; e < D; ++e) Sr[e] = carry[e];
      for (int t = t0; t < t1; ++t) {
        const size_t x = ((static_cast<size_t>(b) * a.S + t) * a.H + h) * D;
        __syncthreads();
        sv[d] = a.v[x + d];
        __syncthreads();
        const float kd = a.k[x + d], wd = a.w[x + d];
        float* out = ws + static_cast<size_t>(t - t0) * DD;
#pragma unroll
        for (int e = 0; e < D; ++e) {
          Sr[e] = wkv_update(Sr[e], wd, __fmul_rn(kd, sv[e]));
          out[e * D] = Sr[e];
        }
      }
    }
    for (int t = t1 - 1; t >= t0; --t) {
      const size_t x = ((static_cast<size_t>(b) * a.S + t) * a.H + h) * D;
      __syncthreads();
      sv[d] = a.v[x + d];
      sgy[d] = a.gy[x + d];
      __syncthreads();
      const float rd = a.r[x + d], kd = a.k[x + d], wd = a.w[x + d];
      const float rud = __fmul_rn(rd, ud);
      // Row d of S_{t-1}: the state after step t - 1, or the carry.
      const float* sp = t > t0 ? ws + static_cast<size_t>(t - t0 - 1) * DD
                               : carry;
      const int stride = t > t0 ? D : 1;
      float gr = 0.f, gk = 0.f, gw = 0.f, gyv = 0.f;
#pragma unroll
      for (int e = 0; e < D; ++e) {
        const float s_p = sp[e * stride];
        const float ve = sv[e], gye = sgy[e];
        const float kv = __fmul_rn(kd, ve);
        gr = __fmaf_rn(gye, __fmaf_rn(ud, kv, s_p), gr);
        const float gkv = __fmaf_rn(gye, rud, g[e]);   // d/d (k v^T)[d][e]
        gk = __fmaf_rn(gkv, ve, gk);
        gw = __fmaf_rn(g[e], s_p, gw);
        gyv = __fmaf_rn(gye, ve, gyv);
        gv[d][e] = __fmul_rn(gkv, kd);
        g[e] = __fmaf_rn(g[e], wd, __fmul_rn(gye, rd));   // d/d S_{t-1}
      }
      a.dr[x + d] = gr;
      a.dk[x + d] = gk;
      a.dw[x + d] = gw;
      gu = __fmaf_rn(__fmul_rn(rd, kd), gyv, gu);
      __syncthreads();
      float s = 0.f;   // dv[e = d]: column d of gv, rows in order
#pragma unroll
      for (int r = 0; r < D; ++r) s += gv[r][d];
      a.dv[x + d] = s;
    }
  }
  float* ds0 = a.dS0 + bh * DD + static_cast<size_t>(d) * D;
#pragma unroll
  for (int e = 0; e < D; ++e) ds0[e] = g[e];
  a.du_part[static_cast<size_t>(bh) * D + d] = gu;
}

bool bad_sizes(int b, int S, int H, int chunk) {
  return b <= 0 || S <= 0 || H <= 0 || chunk <= 0;
}

}  // namespace
}  // namespace repro

// r, k, v, w, y (b, S, H, D); u (H, D); S0, S_last (b, H, D, D);
// carries (b, nc, H, D, D) with ck = min(chunk, S), nc = ceil(S / ck):
// the state before each chunk's first step. All f32, contiguous. D is 16
// or 64. Launches on `stream` (of the caller's current device) and
// returns cudaGetLastError(); cudaErrorInvalidValue, launching nothing,
// for another D or an empty shape.
extern "C" int wkv6_fwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* S0,
                               void* y, void* S_last, void* carries, int b,
                               int S, int H, int D, int chunk,
                               void* stream) {
  using namespace repro;
  if (bad_sizes(b, S, H, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ck = chunk < S ? chunk : S, nc = (S + ck - 1) / ck;
  const Fwd a{static_cast<const float*>(r),  static_cast<const float*>(k),
              static_cast<const float*>(v),  static_cast<const float*>(w),
              static_cast<const float*>(u),  static_cast<const float*>(S0),
              static_cast<float*>(y),        static_cast<float*>(S_last),
              static_cast<float*>(carries),  b, S, H, ck, nc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: wkv_fwd<16><<<b * H, 16, 0, st>>>(a); break;
    case 64: wkv_fwd<64><<<b * H, 64, 0, st>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The gradients of wkv6_fwd_launch's (y, S_last) given gy (b, S, H, D)
// and gS (b, H, D, D): dr, dk, dv, dw (b, S, H, D), du (H, D), dS0 (b, H,
// D, D). Workspace, f32: ws (b, H, ck, D, D), one chunk's states; du_part
// (b, H, D), the per-row sums. Two launches on `stream` (the scan, then
// du's fixed-order pass); returns cudaGetLastError(), or
// cudaErrorInvalidValue as the forward.
extern "C" int wkv6_bwd_launch(const void* gy, const void* gS, const void* r,
                               const void* k, const void* v, const void* w,
                               const void* u, const void* carries, void* dr,
                               void* dk, void* dv, void* dw, void* du,
                               void* dS0, void* ws, void* du_part, int b,
                               int S, int H, int D, int chunk,
                               void* stream) {
  using namespace repro;
  if (bad_sizes(b, S, H, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ck = chunk < S ? chunk : S, nc = (S + ck - 1) / ck;
  const Bwd a{static_cast<const float*>(gy), static_cast<const float*>(gS),
              static_cast<const float*>(r),  static_cast<const float*>(k),
              static_cast<const float*>(v),  static_cast<const float*>(w),
              static_cast<const float*>(u),
              static_cast<const float*>(carries),
              static_cast<float*>(dr),       static_cast<float*>(dk),
              static_cast<float*>(dv),       static_cast<float*>(dw),
              static_cast<float*>(du),       static_cast<float*>(dS0),
              static_cast<float*>(ws),       static_cast<float*>(du_part),
              b, S, H, ck, nc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: wkv_bwd<16><<<b * H, 16, 0, st>>>(a); break;
    case 64: wkv_bwd<64><<<b * H, 64, 0, st>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  launch_sum_parts(a.du_part, a.du, b, static_cast<long>(H) * D, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
