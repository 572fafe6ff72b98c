// Mamba's selective scan, forward and backward, in f32:
//
//   h_t = exp(dt_t A) * h_{t-1} + dt_t u_t B_t,   y_t = <h_t, C_t> + D u_t
//
// for each batch row b and channel i (h: N states, A: the channel's row).
//
// Replaces no Pallas kernel. The JAX package runs this recurrence as a
// lax.scan over chunks of 128 steps, each chunk under jax.checkpoint
// (src/repro/models/mamba.py:47, _ssm_scan), which XLA compiles to one
// loop on the device. These kernels are that loop on the card, with the
// reference's backward structure: the forward writes the state at each
// chunk's start; the backward walks the chunks last to first and
// recomputes each chunk from its carry (kernels/scan/ref.py's
// ssm_scan_bwd_plain is the same computation through autograd).
//
// What bounds it on an H100: the bytes (u, dt read and y written once:
// 12 B a channel-step; B, C: 8N B a row-step) and the exps (one a
// state-step each way, on the 16 SFU lanes of an SM). jamba's layer at
// B = 1, S = 4096, inner 16384, N 16: 0.8 GB (0.24 ms at 3.35 TB/s) and
// 1.07 G expf (0.26 ms on the SFUs at 1.98 GHz). Each step depends on the
// last only through one FMA a state (h = e h + x); e = exp(dt A) and x =
// dt u B depend on the inputs alone. So the pace is set by the
// instructions a state-step (expf is several, one on the SFU) and the
// warps there are to issue them, once the inputs' latency is hidden.
//
// Forward: G lanes a channel (G = 4: 256 threads, 64 channels a CTA;
// 65,536 threads at B = 1, 16 warps an SM), each keeping N / G
// consecutive states and their A in registers. u and dt (the CTA's 64
// channels) and B and C (the row's) arrive T = 16 steps at a time by
// cp.async into a second buffer while the current T steps compute; the T
// steps are unrolled, so the exps and dt u B of later steps are issued
// while the FMA chain through h runs. A lane adds its states' h C by a
// fixed tree; the channel's G lanes then add their T partial sums by a
// butterfly that halves the values a lane keeps at each level (each lane
// ends with T / G steps' sums): the same 16-leaf pairwise tree whatever
// G. y goes through shared memory to coalesced rows.
//
// Backward: the same lanes, at most 128 registers (two CTAs, 16 warps an
// SM: all 256 CTAs of B = 1 in one wave). Each chunk is walked in
// sub-chunks of L = 8 steps: a first pass runs the chunk from its carry
// and keeps the state at each sub-chunk's start in shared memory
// (ceil(ck / L) - 2 of them, the carry and the last start being in hand:
// 56 KiB a CTA at ck = 128; each thread reads back only what it wrote);
// each sub-chunk is then recomputed into registers, with exp(dt A) kept
// beside each state, and walked backwards (one expf a state-step in the
// walk, two in all). Inputs arrive a sub-chunk at a time by cp.async, the
// next one's while the current one computes. Each step's sums over n
// (dt's and u's) add a lane's states in order, then the channel's lanes
// by a butterfly. dB and dC, sums over channels of each (t, n), are added
// per step within the warp by a halving butterfly, then once a sub-chunk
// over the warps by a tree (one shared-memory round, one pair of
// barriers); each CTA writes its 64 channels' partials, which a second
// pass adds over the CTAs by a tree (scan.cuh's sum_parts_tree): one
// pairwise tree over all channels when their count is a power of two
// (a serial sum over jamba's 256 CTAs put dB and dC twice as far from
// float64 as the plain version). dA and dD are per-thread sums over
// time, then a pass over the batch rows by the same tree (in order up to
// 3 rows).
// The global workspace is those partials alone: 129 MiB at jamba's shape,
// against 257 MiB with the chunk's states kept there.
//
// Determinism and prefill = decode: a step's arithmetic does not depend on
// S, on where the step falls in a chunk or a staging block, or on the
// lanes' split (the state update is one helper; each sum is a fixed tree
// whatever the block's length), so a prefill of S steps and S one-step
// calls give the same bits. No float atomics: two backward runs give the
// same bits. The state update, dA, dD and dh0 keep the arithmetic of the
// one-thread-a-channel kernels this design replaced (dA and dD up to 3
// batch rows); y's sum over n, dt's and u's sums over n, and dB's and
// dC's sums over channels are reordered (fixed trees in place of serial
// chains).
//
// Measured on an H100 (700 W) at jamba's 1 x 4096: forward 0.911 ms,
// backward 3.34 ms (one thread a channel: 3.27 / 11.32). Tried and lost
// (scratch builds of this file with other lane counts or parts changed,
// timed as tools/ssm_scan_variants.py times a tree): forward G = 1, 2, 8,
// 16 at 1.92, 1.25, 1.39, 2.48 ms against G = 4's 1.07 (a loop-built
// butterfly then, whose values spilled to local memory); the
// backward at 174 registers (one CTA an SM, two waves) 5.51 ms, G = 2 /
// 8 6.91 / 5.81; capped at 128 registers, G = 8 / 2 4.71 / 5.50 against
// 3.83; zeros in a ragged CTA's idle columns in place of selects 3.60;
// one barrier a block or unit, the outputs written during the next one:
// forward 0.969, backward 3.55. Where the backward's time goes (scratch
// builds with a part left out): the first pass 0.62 ms, the dB / dC
// butterfly 0.42, writing the outputs 0.30, the walk with its sums 1.94.
#include <cuda_runtime.h>

#include <type_traits>

#include "scan.cuh"

namespace repro {
namespace {

constexpr int CH = 64;   // channels a CTA (ops.SSM_CHANNELS)
constexpr int T = 16;    // forward: steps staged at a time
constexpr int L = 8;     // backward: steps a sub-chunk
constexpr int G = 4;     // lanes a channel, N / G states a lane
constexpr int NT = CH * G;   // threads a CTA

struct Fwd {
  const float *u, *dt, *B, *C, *A, *D, *h0;
  float *y, *h_last, *carries;
  int bt, S, inner, ck, nc;
};

struct Bwd {
  const float *gy, *gh, *u, *dt, *B, *C, *A, *D, *carries;
  float *du, *ddt, *dB, *dC, *dA, *dD, *dh0;
  float *dB_part, *dC_part, *dA_part, *dD_part;
  int bt, S, inner, ck, nc;
};

// One step of K states, keeping e = exp(dt A). The forward and the
// backward's two passes share it, so all three give the same states.
template <int K>
__device__ __forceinline__ void ssm_step(float (&h)[K], float (&e)[K],
                                         const float (&A)[K], float dt,
                                         float dtu, const float (&Bt)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    e[k] = expf(__fmul_rn(dt, A[k]));
    h[k] = __fmaf_rn(e[k], h[k], __fmul_rn(dtu, Bt[k]));
  }
}

// K consecutive floats of shared memory (16-byte aligned when K % 4 == 0).
template <int K>
__device__ __forceinline__ void load_k(float (&x)[K], const float* p) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int j = 0; j < K / 4; ++j) {
      const float4 f = reinterpret_cast<const float4*>(p)[j];
      x[4 * j] = f.x, x[4 * j + 1] = f.y, x[4 * j + 2] = f.z;
      x[4 * j + 3] = f.w;
    }
  } else if constexpr (K == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x, x[1] = f.y;
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = p[k];
  }
}

// Rows s < n of the CTA's nch channels, src[s * inner + c], into
// dst[s * CH + c], by the NT threads: 16-byte copies when the rows are
// 16-byte aligned (inner % 4 == 0; the launch aligns the base), else
// 4-byte copies. Uncommitted.
template <int NT, int ROWS>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int n, int nch, int inner,
                                           int tid) {
  if (inner % 4 == 0) {
    constexpr int V = CH / 4;
    for (int x = tid; x < ROWS * V; x += NT) {
      const int s = x / V, c4 = x % V;
      if (s < n && 4 * c4 < nch)
        cp_async16(dst + s * CH + 4 * c4,
                   src + static_cast<size_t>(s) * inner + 4 * c4);
    }
  } else {
    for (int x = tid; x < ROWS * CH; x += NT) {
      const int s = x / CH, c = x % CH;
      if (s < n && c < nch)
        cp_async4(dst + s * CH + c, src + static_cast<size_t>(s) * inner + c);
    }
  }
}

// Rows s < n of N floats (B or C of one batch row) into dst[s * N].
template <int NT, int ROWS, int N>
__device__ __forceinline__ void stage_states(float* dst, const float* src,
                                             int n, int tid) {
  for (int x = tid; x < ROWS * N / 4; x += NT)
    if (4 * x < n * N) cp_async16(dst + 4 * x, src + 4 * x);
}

// -------------------------------------------------------------------------
// forward
// -------------------------------------------------------------------------

template <int N>
__global__ void __launch_bounds__(NT) ssm_fwd(Fwd a) {
  constexpr int K = N / G;
  static_assert(K * G == N, "lanes");
  using BF = Butterfly<T, 1, G>;
  __shared__ __align__(16) float su[2][T][CH], sdt[2][T][CH];
  __shared__ __align__(16) float sB[2][T][N], sC[2][T][N];
  __shared__ float sy[T][CH];
  const int tid = threadIdx.x, g = tid % G, c = tid / G, lane = tid & 31;
  const int b = blockIdx.y, i0 = blockIdx.x * CH, i = i0 + c;
  const int nch = min(CH, a.inner - i0);
  const bool live = c < nch;
  const size_t row = static_cast<size_t>(b) * a.S;
  const size_t hi = (static_cast<size_t>(b) * a.inner + i) * N + g * K;
  float h[K], A[K];
  const float Di = live ? a.D[i] : 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    A[k] = live ? a.A[static_cast<size_t>(i) * N + g * K + k] : 0.f;
    h[k] = live ? a.h0[hi + k] : 0.f;
  }

  // Steps [t0, t0 + n) of u, dt, B, C into buffer `buf`.
  auto stage = [&](int buf, int t0, int n) {
    const size_t x0 = (row + t0) * a.inner + i0;
    stage_rows<NT, T>(&su[buf][0][0], a.u + x0, n, nch, a.inner, tid);
    stage_rows<NT, T>(&sdt[buf][0][0], a.dt + x0, n, nch, a.inner, tid);
    stage_states<NT, T, N>(&sB[buf][0][0], a.B + (row + t0) * N, n, tid);
    stage_states<NT, T, N>(&sC[buf][0][0], a.C + (row + t0) * N, n, tid);
    cp_async_commit();
  };
  // A staging block ends at T steps, the next chunk's start or S, so that
  // a chunk's carry is written at a block's start.
  auto block_end = [&](int t0) {
    return min(min(t0 + T, (t0 / a.ck + 1) * a.ck), a.S);
  };
  // Step s of buffer `buf` on the lane's states; returns their share of
  // y's sum, by a fixed tree.
  auto step = [&](int buf, int s) {
    const float u = su[buf][s][c], dt = sdt[buf][s][c];
    float Bk[K], Ck[K], e[K], q[K];
    load_k<K>(Bk, &sB[buf][s][g * K]);
    load_k<K>(Ck, &sC[buf][s][g * K]);
    ssm_step<K>(h, e, A, dt, __fmul_rn(dt, u), Bk);
#pragma unroll
    for (int k = 0; k < K; ++k) q[k] = __fmul_rn(h[k], Ck[k]);
    return tree_sum(q);
  };

  int t0 = 0, t1 = block_end(0);
  stage(0, 0, t1);
  for (int it = 0; t0 < a.S; ++it) {
    const int buf = it & 1, n = t1 - t0;
    const int t2 = t1 < a.S ? block_end(t1) : t1;
    if (t1 < a.S) {
      stage(buf ^ 1, t1, t2 - t1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (live && t0 % a.ck == 0) {   // the state before the chunk's first step
      float* cy = a.carries +
                  ((static_cast<size_t>(b) * a.nc + t0 / a.ck) * a.inner + i) *
                      N + g * K;
#pragma unroll
      for (int k = 0; k < K; ++k) cy[k] = h[k];
    }
    __syncthreads();
    float p[T];
    if (n == T) {
#pragma unroll
      for (int s = 0; s < T; ++s) p[s] = step(buf, s);
    } else {
#pragma unroll
      for (int s = 0; s < T; ++s) p[s] = s < n ? step(buf, s) : 0.f;
    }
    // y: the channel's G lanes by the butterfly, plus D u
    int off, dup;
    BF::run(p, lane, off, dup);
    if (live && (lane & dup) == 0) {
#pragma unroll
      for (int j = 0; j < BF::kept; ++j) {
        const int s = off + j;
        if (s < n) sy[s][c] = __fmaf_rn(Di, su[buf][s][c], p[j]);
      }
    }
    __syncthreads();
    float* yb = a.y + (row + t0) * a.inner + i0;
    for (int x = tid; x < n * CH; x += NT) {
      const int s = x / CH, cc = x % CH;
      if (cc < nch) yb[static_cast<size_t>(s) * a.inner + cc] = sy[s][cc];
    }
    t0 = t1;
    t1 = t2;
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < K; ++k) a.h_last[hi + k] = h[k];
  }
}

// -------------------------------------------------------------------------
// backward
// -------------------------------------------------------------------------

// The sub-chunk starts the backward keeps in shared memory for a chunk of
// ck steps: ceil(ck / L) - 2 (the first is the carry, the last stays in
// registers), none below 3 sub-chunks.
int start_slots(int ck) {
  const int ns = (ck + L - 1) / L;
  return ns > 2 ? ns - 2 : 0;
}

// Its dynamic shared memory in bytes: each slot is CH x N floats.
size_t bwd_smem_bytes(int N, int ck) {
  return sizeof(float) * static_cast<size_t>(start_slots(ck)) * CH * N;
}

// A unit of the backward's walk over chunk c: pass 1 runs sub-chunk j
// forward (j < nsub - 1); pass 2 recomputes sub-chunk j and walks it back
// (j = nsub - 1 down to 0). c < 0: past the last unit.
struct Unit {
  int c, pass, j;
};

// Two CTAs an SM where they fit (at most 128 registers a thread).
template <int N>
__global__ void __launch_bounds__(NT, 2) ssm_bwd(Bwd a) {
  constexpr int K = N / G, NW = NT / 32;
  static_assert(K * G == N, "lanes");
  using BC = Butterfly<2 * K, G, 32>;   // dB, dC over the warp's channels
  using BS = Butterfly<2, 1, G>;        // dt's, u's sums over the lanes
  extern __shared__ __align__(16) float starts[];   // [slot][NT][K]
  __shared__ __align__(16) float su[2][L][CH], sdt[2][L][CH], sgy[2][L][CH];
  __shared__ __align__(16) float sB[2][L][N], sC[2][L][N];
  __shared__ float red[L][NW][2 * N];   // dB (m < N), dC: the warps' sums
  __shared__ float sdu[L][CH], sddt[L][CH];

  const int tid = threadIdx.x, g = tid % G, c = tid / G;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, i0 = blockIdx.x * CH, i = i0 + c;
  const int nch = min(CH, a.inner - i0);
  const bool live = c < nch;
  const size_t row = static_cast<size_t>(b) * a.S;
  const size_t hi = (static_cast<size_t>(b) * a.inner + i) * N + g * K;
  float A[K], gr[K], gA[K], h[K];   // gr: d/d h after the current step
  const float Di = live ? a.D[i] : 0.f;
  float gD = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    A[k] = live ? a.A[static_cast<size_t>(i) * N + g * K + k] : 0.f;
    gr[k] = live ? a.gh[hi + k] : 0.f;
    gA[k] = 0.f;
    h[k] = 0.f;
  }

  auto chunk_steps = [&](int cc) { return min(a.ck, a.S - cc * a.ck); };
  auto subchunks = [&](int cc) { return (chunk_steps(cc) + L - 1) / L; };
  auto first = [&](int cc) {
    return subchunks(cc) > 1 ? Unit{cc, 1, 0} : Unit{cc, 2, 0};
  };
  auto next = [&](Unit x) {
    const int ns = subchunks(x.c);
    if (x.pass == 1) return x.j + 1 < ns - 1 ? Unit{x.c, 1, x.j + 1}
                                             : Unit{x.c, 2, ns - 1};
    if (x.j > 0) return Unit{x.c, 2, x.j - 1};
    return x.c > 0 ? first(x.c - 1) : Unit{-1, 0, 0};
  };
  auto unit_t0 = [&](Unit x) { return x.c * a.ck + x.j * L; };
  auto unit_n = [&](Unit x) { return min(L, chunk_steps(x.c) - x.j * L); };
  // The start of sub-chunk j >= 1 of the current chunk, the thread's K.
  auto slot = [&](int j) {
    return starts + (static_cast<size_t>(j - 1) * NT + tid) * K;
  };
  // The unit's inputs (pass 1: u, dt, B; pass 2: also gy and C).
  auto stage = [&](int buf, Unit x) {
    const int n = unit_n(x), t0 = unit_t0(x);
    const size_t x0 = (row + t0) * a.inner + i0;
    stage_rows<NT, L>(&su[buf][0][0], a.u + x0, n, nch, a.inner, tid);
    stage_rows<NT, L>(&sdt[buf][0][0], a.dt + x0, n, nch, a.inner, tid);
    stage_states<NT, L, N>(&sB[buf][0][0], a.B + (row + t0) * N, n, tid);
    if (x.pass == 2) {
      stage_rows<NT, L>(&sgy[buf][0][0], a.gy + x0, n, nch, a.inner, tid);
      stage_states<NT, L, N>(&sC[buf][0][0], a.C + (row + t0) * N, n, tid);
    }
    cp_async_commit();
  };

  Unit x = first(a.nc - 1);
  stage(0, x);
  for (int it = 0; x.c >= 0; ++it) {
    const int buf = it & 1, n = unit_n(x), t0 = unit_t0(x);
    const Unit nx = next(x);
    if (nx.c >= 0) {
      stage(buf ^ 1, nx);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // The unit's start: the chunk's carry, a kept start, or the registers
    // (pass 1 past its first sub-chunk; the walk's first sub-chunk, which
    // starts where pass 1 ended).
    const int ns = subchunks(x.c);
    if (x.j == 0) {
      const float* cy = a.carries +
                        ((static_cast<size_t>(b) * a.nc + x.c) * a.inner + i) *
                            N + g * K;
#pragma unroll
      for (int k = 0; k < K; ++k) h[k] = live ? cy[k] : 0.f;
    } else if (x.pass == 2 && x.j < ns - 1) {
      load_k<K>(h, slot(x.j));
    }

    // Pass 1 and the walk, each written for a full sub-chunk (the steps
    // unrolled without a test, `full`) and for a short one.
    auto pass1 = [&](auto full) {
#pragma unroll
      for (int s = 0; s < L; ++s) {
        if (decltype(full)::value || s < n) {
          const float u = su[buf][s][c], dt = sdt[buf][s][c];
          float Bk[K], e[K];
          load_k<K>(Bk, &sB[buf][s][g * K]);
          ssm_step<K>(h, e, A, dt, __fmul_rn(dt, u), Bk);
        }
      }
    };
    auto walk = [&](auto full) {
      // The recompute: hs[s] the state before step s, es[s] its exp(dt A).
      float hs[L + 1][K], es[L][K];
#pragma unroll
      for (int k = 0; k < K; ++k) hs[0][k] = h[k];
#pragma unroll
      for (int s = 0; s < L; ++s) {
        if (decltype(full)::value || s < n) {
          const float u = su[buf][s][c], dt = sdt[buf][s][c];
          float Bk[K];
          load_k<K>(Bk, &sB[buf][s][g * K]);
#pragma unroll
          for (int k = 0; k < K; ++k) hs[s + 1][k] = hs[s][k];
          ssm_step<K>(hs[s + 1], es[s], A, dt, __fmul_rn(dt, u), Bk);
        }
      }
      // The walk, last step first.
#pragma unroll
      for (int s = L - 1; s >= 0; --s) {
        if (decltype(full)::value || s < n) {   // the same for the CTA
          const float u = su[buf][s][c], dt = sdt[buf][s][c];
          const float gy = sgy[buf][s][c], dtu = __fmul_rn(dt, u);
          float Bk[K], Ck[K], v[2 * K];   // v: dB's (k < K) and dC's terms
          load_k<K>(Bk, &sB[buf][s][g * K]);
          load_k<K>(Ck, &sC[buf][s][g * K]);
          // q: the lane's share of dt's (through dt A) and u's (through
          // B) sums over n
          float q[2] = {0.f, 0.f};
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float gn = __fmaf_rn(gy, Ck[k], gr[k]);   // d/d h_t
            const float gdA =                                // d/d(dt A)
                __fmul_rn(__fmul_rn(gn, hs[s][k]), es[s][k]);
            q[0] = __fmaf_rn(gdA, A[k], q[0]);
            q[1] = __fmaf_rn(gn, Bk[k], q[1]);
            gA[k] = __fmaf_rn(gdA, dt, gA[k]);
            v[k] = live ? __fmul_rn(gn, dtu) : 0.f;
            v[K + k] = live ? __fmul_rn(gy, hs[s + 1][k]) : 0.f;
            gr[k] = __fmul_rn(gn, es[s][k]);                 // d/d h_{t-1}
          }
          gD = __fmaf_rn(gy, u, gD);
          // dt's and u's sums: the channel's G lanes by the butterfly; lane
          // g = 0 ends with dt's, lane 1 with u's, and g = 0 takes both.
          int off, dup;
          BS::run(q, lane, off, dup);
          const float s2 = __shfl_xor_sync(kFull, q[0], 1);
          if (live && g == 0) {
            sddt[s][c] = __fmaf_rn(s2, u, q[0]);
            sdu[s][c] = __fmaf_rn(s2, dt, __fmul_rn(gy, Di));
          }
          // dB, dC: the warp's channels (lane bits G .. 16)
          BC::run(v, lane, off, dup);
          if ((lane & dup) == 0) {
#pragma unroll
            for (int j = 0; j < BC::kept; ++j) {
              const int m = off + j;
              red[s][warp][(m / K) * N + g * K + m % K] = v[j];
            }
          }
        }
      }
    };

    if (x.pass == 1) {
      if (n == L) {
        pass1(std::true_type{});
      } else {
        pass1(std::false_type{});
      }
      if (x.j + 1 < ns - 1) {   // the next sub-chunk's start
        float* d = slot(x.j + 1);
#pragma unroll
        for (int k = 0; k < K; ++k) d[k] = h[k];
      }
      __syncthreads();   // the buffer is restaged next
    } else {
      if (n == L) {
        walk(std::true_type{});
      } else {
        walk(std::false_type{});
      }
      __syncthreads();
      // The unit's outputs: du and ddt rows; dB's and dC's partials, the
      // warps' sums added by a tree.
      const size_t x0 = (row + t0) * a.inner + i0;
      for (int q = tid; q < n * CH; q += NT) {
        const int s = q / CH, cc = q % CH;
        if (cc < nch) {
          const size_t o = x0 + static_cast<size_t>(s) * a.inner + cc;
          a.du[o] = sdu[s][cc];
          a.ddt[o] = sddt[s][cc];
        }
      }
      for (int q = tid; q < n * 2 * N; q += NT) {
        const int s = q / (2 * N), m = q % (2 * N);
        float w8[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w) w8[w] = red[s][w][m];
        const float acc = tree_sum(w8);
        float* part = m < N ? a.dB_part : a.dC_part;
        part[((static_cast<size_t>(blockIdx.x) * a.bt + b) * a.S + t0 + s) *
                 N + m % N] = acc;
      }
    }
    x = nx;
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      a.dh0[hi + k] = gr[k];
      a.dA_part[hi + k] = gA[k];
    }
    if (g == 0) a.dD_part[static_cast<size_t>(b) * a.inner + i] = gD;
  }
}

template <int N>
void launch_fwd(const Fwd& a, cudaStream_t st) {
  const dim3 grid((a.inner + CH - 1) / CH, a.bt);
  ssm_fwd<N><<<grid, NT, 0, st>>>(a);
}

// The scan, then the four fixed-order passes, on `st`; the scan's dynamic
// shared memory allowed first (a setting of the device's; repeating it
// costs little).
template <int N>
cudaError_t launch_bwd(const Bwd& a, cudaStream_t st) {
  const size_t smem = bwd_smem_bytes(N, a.ck);
  const cudaError_t err = cudaFuncSetAttribute(
      ssm_bwd<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int nblk = (a.inner + CH - 1) / CH;
  ssm_bwd<N><<<dim3(nblk, a.bt), NT, smem, st>>>(a);
  const long rows = static_cast<long>(a.bt) * a.S * N;
  launch_sum_parts(a.dB_part, a.dB, nblk, rows, st);
  launch_sum_parts(a.dC_part, a.dC, nblk, rows, st);
  launch_sum_parts(a.dA_part, a.dA, a.bt, static_cast<long>(a.inner) * N,
                   st);
  launch_sum_parts(a.dD_part, a.dD, a.bt, a.inner, st);
  return cudaSuccess;
}

// The largest chunk the backward takes (its starts in shared memory):
// ops.SSM_MAX_CHUNK. The forward refuses a longer one too, so that a
// forward whose backward would be refused does no work.
constexpr int kMaxChunk = 256;

bool bad_sizes(int bt, int S, int inner, int chunk) {
  return bt <= 0 || bt > 65535 || S <= 0 || inner <= 0 || chunk <= 0 ||
         (chunk < S ? chunk : S) > kMaxChunk;
}

}  // namespace
}  // namespace repro

// u, dt (bt, S, inner); B, C (bt, S, N); A (inner, N); D (inner,); h0,
// h_last (bt, inner, N); y (bt, S, inner); carries (bt, nc, inner, N)
// with ck = min(chunk, S), nc = ceil(S / ck): the state before each
// chunk's first step. All f32, contiguous, 16-byte aligned. N is 8 or 16.
// Launches on `stream` (of the caller's current device) and returns
// cudaGetLastError(); cudaErrorInvalidValue, launching nothing, for
// another N, an empty shape or min(chunk, S) > 256.
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
// N), dA (inner, N), dD (inner,), dh0 (bt, inner, N). Workspace `ws`, f32,
// of ws_floats floats (anything else is refused): dB's and dC's per-CTA
// partials (nblk, bt, S, N) each with nblk = ceil(inner / 64), then dA's
// and dD's per-row partials (bt, inner, N) and (bt, inner). Five launches
// on `stream` (the scan, then the four fixed-order passes); returns
// cudaGetLastError(), or cudaErrorInvalidValue as the forward and for
// a workspace of another size.
extern "C" int ssm_scan_bwd_launch(
    const void* gy, const void* gh, const void* u, const void* dt,
    const void* B, const void* C, const void* A, const void* D,
    const void* carries, void* du, void* ddt, void* dB, void* dC, void* dA,
    void* dD, void* dh0, void* ws, long long ws_floats, int bt, int S,
    int inner, int N, int chunk, void* stream) {
  using namespace repro;
  if (bad_sizes(bt, S, inner, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ck = chunk < S ? chunk : S, nc = (S + ck - 1) / ck;
  const long long nblk = (inner + CH - 1) / CH;
  const long long part = nblk * bt * S * N;
  const long long rowp = static_cast<long long>(bt) * inner * N;
  if (ws_floats != 2 * part + rowp + static_cast<long long>(bt) * inner)
    return static_cast<int>(cudaErrorInvalidValue);
  float* w = static_cast<float*>(ws);
  const Bwd a{static_cast<const float*>(gy), static_cast<const float*>(gh),
              static_cast<const float*>(u),  static_cast<const float*>(dt),
              static_cast<const float*>(B),  static_cast<const float*>(C),
              static_cast<const float*>(A),  static_cast<const float*>(D),
              static_cast<const float*>(carries),
              static_cast<float*>(du),       static_cast<float*>(ddt),
              static_cast<float*>(dB),       static_cast<float*>(dC),
              static_cast<float*>(dA),       static_cast<float*>(dD),
              static_cast<float*>(dh0),      w, w + part, w + 2 * part,
              w + 2 * part + rowp,           bt, S, inner, ck, nc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (N) {
    case 8: err = launch_bwd<8>(a, st); break;
    case 16: err = launch_bwd<16>(a, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The backward kernel's dynamic shared memory in bytes at N and a chunk of
// ck steps (0 for an N it is not compiled for).
extern "C" int ssm_scan_bwd_smem_bytes(int N, int ck) {
  using namespace repro;
  return N == 8 || N == 16 ? static_cast<int>(bwd_smem_bytes(N, ck)) : 0;
}

extern "C" const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
