// RWKV6's WKV recurrence, forward and backward, in f32, per batch row b
// and head h with head size D:
//
//   y_t = r_t (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(w_t) S_{t-1}
//                                                    + k_t v_t^T
//
// (S: D x D; y_t[e] = sum_d r_t[d] S[d][e] + v_t[e] sum_d r_t[d] u[d]
// k_t[d]: the bonus term is a scalar a step times v_t).
//
// Replaces no Pallas kernel. The JAX package runs the recurrence as a
// lax.scan over chunks of 128 steps, each under jax.checkpoint
// (src/repro/models/rwkv.py:96, inside rwkv_time_mix), which XLA compiles
// to one loop on the device. These kernels are that loop on the card, with
// the reference's backward structure: the forward writes the state at
// each chunk's start; the backward walks the chunks last to first and
// recomputes each chunk's states forward from its carry (never S_{t-1} =
// (S_t - k v^T) / w, which loses everything where w is tiny). The plain
// backward, kernels/scan/ref.py's wkv6_bwd_plain (_scan_vjp), recomputes
// each chunk from its carry too but differentiates it with autograd, so
// it shares none of these kernels' hand-derived gradient arithmetic. Only
// the real steps are scanned (ROADMAP C.13).
//
// What bounds it on an H100: rwkv6-7b's layer at B = 4, S = 512, H = D =
// 64 moves 168 MB forward (0.050 ms at 3.35 TB/s) for 0.27 GFLOP; the
// backward does ~3x the FLOPs. Every step depends on the last, so the
// parallelism is B x H states of D x D elements (256 of 4096 there, ~2 an
// SM), and the pace is set by the instructions each step runs (FMAs,
// shared-memory loads, shuffles) and the warps there are to hide their
// latency.
//
// Forward: one CTA a (b, h) of D / C x RF threads (RF = 8 lanes a
// column, C = 4 columns a thread at D = 64: 128 threads). Thread (e, q)
// keeps rows 4 (q + RF j) + i (j < D / 4RF, i < 4) of its C columns in
// registers, so r_t, k_t and w_t reach it as float4 loads without bank
// conflicts, one load serving C columns. For each column it sums its rows'
// r S in independent chains, added by a fixed tree, plus v times its rows'
// r (u k) (the bonus); the RF lanes of a column are then added by a
// butterfly (one fixed tree, a lane keeping half its columns a level). r,
// k, w and v arrive T steps at a time by cp.async into a second buffer
// while the current T steps compute. On an H100 no other split (4 or 16
// lanes a column, 1 to 8 columns a thread) was faster, nor unrolling or
// software-pipelining the steps, nor TMA bulk copies in place of cp.async.
//
// Backward: one CTA a (b, h) of D x RB threads (RB = 8 lanes a row at D =
// 64: 512 threads, 16 warps, the 128 registers a thread that leaves).
// Thread (d, q) keeps columns 4 (q + RB j) + i of row d of the state's
// gradient, so dr, dk, dw and du's row terms are sums within the thread,
// then over RB lanes; dv, a sum over rows, is reduced within the warp by a
// butterfly that halves the values a lane keeps at each level, then over
// the warps in order. Each chunk is walked in sub-chunks of L = 8 steps: a
// first pass runs the chunk forward from its carry and keeps the state at
// each sub-chunk's start (in registers for the last, in a global workspace
// of ceil(ck / L) - 2 states for the rest: 56 MiB at the shape above,
// written and read once, against 512 MiB written and read for a whole
// chunk's states); each sub-chunk is then recomputed from its start into
// dynamic shared memory (128 KiB at D = 64; each thread reads back only
// what it wrote) and walked backwards. Inputs arrive a sub-chunk at a time
// by cp.async, the next one's while the current one computes.
//
// Determinism and prefill = decode: a step's arithmetic is the same
// whatever S is and wherever the step falls in a chunk or a staging
// block (the state update is one helper; every sum is a fixed tree), so
// a prefill of S steps and S one-step calls give the same bits. No float
// atomics: du's per-row sums are added over the batch rows by a fixed
// tree in a second pass (scan.cuh), so two backward runs give the same
// bits.
#include <cuda_runtime.h>

#include <cstdint>

#include "scan.cuh"

namespace repro {
namespace {

constexpr int T = 16;     // forward: steps staged at a time
constexpr int L = 8;      // backward: steps a sub-chunk (ops.WKV_SUBCHUNK)

// Backward: lanes a state row, by head size (a thread keeps D / RB
// columns, a multiple of 4).
template <int D>
struct BwdLanes {
  static constexpr int value = D >= 64 ? 8 : 4;
};

struct Fwd {
  const float *r, *k, *v, *w, *u, *S0;
  float *y, *S_last, *carries;
  int b, S, H, ck, nc;
};

struct Bwd {
  const float *gy, *gS, *r, *k, *v, *w, *u, *carries;
  float *dr, *dk, *dv, *dw, *du, *dS0;
  float *ws, *du_part;
  int b, S, H, ck, nc, nws;   // nws: workspace states a (b, h)
};

// S[d][e] after a step; the forward and the backward's recompute share it.
__device__ __forceinline__ float wkv_update(float s, float w, float kv) {
  return __fmaf_rn(w, s, kv);
}

// The m-th of the D / R rows (forward) or columns (backward) that lane q
// of R owns: float4 groups q, q + R, ..., so R lanes reading their m-th
// group read R neighbouring float4s (no bank conflicts).
template <int R>
__device__ __forceinline__ int owned(int q, int m) {
  return 4 * (q + R * (m >> 2)) + (m & 3);
}

// x summed over the R neighbouring lanes that own one row or column, by a
// fixed xor tree; each of them gets the same bits (a + b == b + a).
template <int R>
__device__ __forceinline__ float lanes_sum(float x) {
#pragma unroll
  for (int o = 1; o < R; o <<= 1)
    x = __fadd_rn(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// -------------------------------------------------------------------------
// forward
// -------------------------------------------------------------------------

// Forward: the lanes a state column and the columns a thread, by head
// size (a thread keeps D / RF rows, a multiple of 4, of C columns).
template <int D>
struct FwdShape {
  static constexpr int RF = D >= 64 ? 8 : 4;
  static constexpr int C = D >= 64 ? 4 : 2;
  static constexpr int NT = D / C * RF;
};

template <int D>
__global__ void __launch_bounds__(FwdShape<D>::NT) wkv_fwd(Fwd a) {
  constexpr int RF = FwdShape<D>::RF, C = FwdShape<D>::C;
  constexpr int NT = FwdShape<D>::NT, ROWS = D / RF, J = ROWS / 4;
  constexpr int V = D / 4;   // float4s a step's row of one input
  static_assert(ROWS % 4 == 0 && C % 2 == 0 && C <= RF && NT % 32 == 0,
                "shape");
  using BF = Butterfly<C, 1, RF>;
  // r, k, w, v of T steps, two buffers; y of the T steps
  __shared__ __align__(16) float st[2][4][T][D];
  __shared__ __align__(16) float sy[T][D];
  const int tid = threadIdx.x, q = tid % RF, e0 = tid / RF * C;
  const int lane = tid & 31;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const size_t DD = static_cast<size_t>(D) * D;
  const size_t HD = static_cast<size_t>(a.H) * D;

  float S[ROWS][C];   // S[m][c] = state[owned(q, m)][e0 + c]
  float u[ROWS];      // u[owned(q, m)]
  {
    const float* s0 = a.S0 + bh * DD;
#pragma unroll
    for (int m = 0; m < ROWS; ++m) {
      u[m] = a.u[h * D + owned<RF>(q, m)];
#pragma unroll
      for (int c = 0; c < C; ++c)
        S[m][c] = s0[owned<RF>(q, m) * D + e0 + c];
    }
  }

  // Steps [t0, t0 + n) of r, k, w, v into buffer `buf`.
  auto stage = [&](int buf, int t0, int n) {
    const size_t x0 = (static_cast<size_t>(b) * a.S + t0) * HD +
                      static_cast<size_t>(h) * D;
    for (int i = tid; i < 4 * T * V; i += NT) {   // constant divisors
      const int arr = i / (T * V), s = i / V % T, c4 = i % V;
      if (s >= n) continue;
      const float* src = arr == 0 ? a.r : arr == 1 ? a.k : arr == 2 ? a.w
                                                                    : a.v;
      cp_async16(&st[buf][arr][s][4 * c4], src + x0 + s * HD + 4 * c4);
    }
    cp_async_commit();
  };
  // A staging block ends at T steps, the next chunk's start or S, so that
  // a chunk's carry is written at a block's start.
  auto block_end = [&](int t0) {
    return min(min(t0 + T, (t0 / a.ck + 1) * a.ck), a.S);
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
    if (t0 % a.ck == 0) {   // the state before the chunk's first step
      float* c = a.carries +
                 ((static_cast<size_t>(b) * a.nc + t0 / a.ck) * a.H + h) * DD;
#pragma unroll
      for (int m = 0; m < ROWS; ++m)
#pragma unroll
        for (int cc = 0; cc < C; ++cc)
          c[owned<RF>(q, m) * D + e0 + cc] = S[m][cc];
    }
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      // p[c]: the rows' r S of column c plus v[c] times their r (u k)
      float p[C], v[C], acc[C][J], bonus[J];
#pragma unroll
      for (int c = 0; c < C; c += 2) {
        const float2 v2 =
            *reinterpret_cast<const float2*>(&st[buf][3][s][e0 + c]);
        v[c] = v2.x, v[c + 1] = v2.y;
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int d0 = owned<RF>(q, 4 * j);
        const float4 r4 = *reinterpret_cast<const float4*>(&st[buf][0][s][d0]);
        const float4 k4 = *reinterpret_cast<const float4*>(&st[buf][1][s][d0]);
        const float4 w4 = *reinterpret_cast<const float4*>(&st[buf][2][s][d0]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        bonus[j] = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c][j] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          bonus[j] = __fmaf_rn(rr[i], __fmul_rn(u[4 * j + i], kk[i]),
                               bonus[j]);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            float& x = S[4 * j + i][c];
            acc[c][j] = __fmaf_rn(rr[i], x, acc[c][j]);
            x = wkv_update(x, ww[i], __fmul_rn(kk[i], v[c]));
          }
        }
      }
      const float bq = tree_sum(bonus);
#pragma unroll
      for (int c = 0; c < C; ++c) p[c] = __fmaf_rn(v[c], bq, tree_sum(acc[c]));
      // y: the column's RF lanes by the butterfly
      int off, dup;
      BF::run(p, lane, off, dup);
      if ((lane & dup) == 0) {
#pragma unroll
        for (int i = 0; i < BF::kept; ++i) sy[s][e0 + off + i] = p[i];
      }
    }
    __syncthreads();
    const size_t x0 = (static_cast<size_t>(b) * a.S + t0) * HD +
                      static_cast<size_t>(h) * D;
    for (int i = tid; i < n * V; i += NT) {
      const int s = i / V, c4 = i % V;
      *reinterpret_cast<float4*>(a.y + x0 + s * HD + 4 * c4) =
          *reinterpret_cast<const float4*>(&sy[s][4 * c4]);
    }
    t0 = t1;
    t1 = t2;
  }
  float* sl = a.S_last + bh * DD;
#pragma unroll
  for (int m = 0; m < ROWS; ++m)
#pragma unroll
    for (int c = 0; c < C; ++c) sl[owned<RF>(q, m) * D + e0 + c] = S[m][c];
}

// -------------------------------------------------------------------------
// backward
// -------------------------------------------------------------------------

// The backward's dynamic shared memory, in floats: the sub-chunk's states
// ([s][j][thread] float4s: each thread reads back only what it wrote) and
// two buffers of r, k, v, w, gy for L steps. What the walk writes (dv's
// per-warp sums, dr, dk, dw) is in static shared memory, so the compiler
// may move one step's loads past the last step's stores.
template <int D>
struct BwdSmem {
  static constexpr int RB = BwdLanes<D>::value;
  static constexpr int NT = D * RB, NW = NT / 32, CPT = D / RB;
  static constexpr int states = 0;
  static constexpr int stage = states + L * CPT * NT;
  static constexpr int floats = stage + 2 * 5 * L * D;
  static constexpr size_t bytes = sizeof(float) * floats;
};

// A unit of the backward's walk over chunk c: pass 1 runs sub-chunk j
// forward (j < nsub - 1); pass 2 recomputes sub-chunk j and walks it back
// (j = nsub - 1 down to 0). c < 0: past the last unit.
struct Unit {
  int c, pass, j;
};

template <int D>
__global__ void __launch_bounds__(BwdSmem<D>::NT, 1) wkv_bwd(Bwd a) {
  using SM = BwdSmem<D>;
  constexpr int RB = SM::RB, NT = SM::NT, NW = SM::NW, CPT = SM::CPT;
  constexpr int J = CPT / 4, V = D / 4;
  static_assert(CPT % 4 == 0 && NT % 32 == 0, "shape");
  extern __shared__ __align__(16) float4 bwd_smem[];
  __shared__ float dvp[L][NW][D];      // dv's sums over each warp's rows
  __shared__ float outs[3][L][D];      // dr, dk, dw
  __shared__ float su[D], sgyv[L], sruk[L];
  float* const sm = reinterpret_cast<float*>(bwd_smem);
  float4* const states = bwd_smem + SM::states / 4;
  // stg(buf, array, s): array 0 r, 1 k, 2 v, 3 w, 4 gy
  auto stg = [&](int buf, int arr, int s) {
    return sm + SM::stage + ((buf * 5 + arr) * L + s) * D;
  };

  const int tid = threadIdx.x, q = tid % RB, d = tid / RB;
  const int lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const size_t DD = static_cast<size_t>(D) * D;
  const size_t HD = static_cast<size_t>(a.H) * D;
  for (int i = tid; i < D; i += NT) su[i] = a.u[h * D + i];
  const float ud = a.u[h * D + d];

  auto chunk_steps = [&](int c) { return min(a.ck, a.S - c * a.ck); };
  auto subchunks = [&](int c) { return (chunk_steps(c) + L - 1) / L; };
  auto first = [&](int c) {
    return subchunks(c) > 1 ? Unit{c, 1, 0} : Unit{c, 2, 0};
  };
  auto next = [&](Unit x) {
    const int ns = subchunks(x.c);
    if (x.pass == 1) return x.j + 1 < ns - 1 ? Unit{x.c, 1, x.j + 1}
                                             : Unit{x.c, 2, ns - 1};
    if (x.j > 0) return Unit{x.c, 2, x.j - 1};
    return x.c > 0 ? first(x.c - 1) : Unit{-1, 0, 0};
  };
  // Whether a unit starts from a stored state (the chunk's carry, or a
  // sub-chunk start in the workspace) rather than from the registers: all
  // but pass 1 past its first sub-chunk and the walk's first sub-chunk,
  // which starts where pass 1 ended.
  auto loads_start = [&](Unit x) {
    return x.pass == 1 ? x.j == 0 : !(x.j == subchunks(x.c) - 1 && x.j > 0);
  };
  auto start_of = [&](Unit x) {
    return x.j == 0
               ? a.carries +
                     ((static_cast<size_t>(b) * a.nc + x.c) * a.H + h) * DD
               : a.ws + (static_cast<size_t>(bh) * a.nws + x.j - 1) * DD;
  };
  auto unit_t0 = [&](Unit x) { return x.c * a.ck + x.j * L; };
  auto unit_n = [&](Unit x) {
    return min(L, chunk_steps(x.c) - x.j * L);
  };
  // A row of the thread's columns of a stored (D x D, row-major) state.
  auto load_row = [&](float (&x)[CPT], const float* src) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float4 f = *reinterpret_cast<const float4*>(
          src + d * D + owned<RB>(q, 4 * j));
      x[4 * j] = f.x, x[4 * j + 1] = f.y, x[4 * j + 2] = f.z;
      x[4 * j + 3] = f.w;
    }
  };
  auto store_row = [&](const float (&x)[CPT], float* dst) {
#pragma unroll
    for (int j = 0; j < J; ++j)
      *reinterpret_cast<float4*>(dst + d * D + owned<RB>(q, 4 * j)) =
          make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
  };
  // The unit's inputs (pass 1: k, v, w; pass 2: all five) into `buf`.
  auto stage = [&](int buf, Unit x) {
    const int n = unit_n(x), a0 = x.pass == 1 ? 1 : 0;
    const int na = x.pass == 1 ? 3 : 5;
    const size_t x0 = (static_cast<size_t>(b) * a.S + unit_t0(x)) * HD +
                      static_cast<size_t>(h) * D;
    for (int i = tid; i < na * L * V; i += NT) {   // constant divisors
      const int arr = a0 + i / (L * V), s = i / V % L, c4 = i % V;
      if (s >= n) continue;
      const float* src = arr == 0 ? a.r : arr == 1 ? a.k : arr == 2 ? a.v
                         : arr == 3 ? a.w : a.gy;
      cp_async16(stg(buf, arr, s) + 4 * c4, src + x0 + s * HD + 4 * c4);
    }
    cp_async_commit();
  };

  float G[CPT];   // row d, the thread's columns, of d/d S_t
  load_row(G, a.gS + bh * DD);
  float S[CPT], S_next[CPT];
  float gu = 0.f;

  Unit x = first(a.nc - 1);
  load_row(S_next, start_of(x));
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
    if (loads_start(x)) {
#pragma unroll
      for (int m = 0; m < CPT; ++m) S[m] = S_next[m];
    }
    if (nx.c >= 0 && loads_start(nx)) load_row(S_next, start_of(nx));
    __syncthreads();
    const float* sr = stg(buf, 0, 0);
    const float* sk = stg(buf, 1, 0);
    const float* sv = stg(buf, 2, 0);
    const float* sw = stg(buf, 3, 0);
    const float* sg = stg(buf, 4, 0);

    // S through step s of the unit (registers), given its inputs.
    auto advance = [&](int s) {
      const float kd = sk[s * D + d], wd = sw[s * D + d];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float4 v4 = *reinterpret_cast<const float4*>(
            sv + s * D + owned<RB>(q, 4 * j));
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          S[4 * j + i] =
              wkv_update(S[4 * j + i], wd, __fmul_rn(kd, vv[i]));
      }
    };

    if (x.pass == 1) {
      for (int s = 0; s < n; ++s) advance(s);
      if (x.j + 1 < subchunks(x.c) - 1)   // the next sub-chunk's start
        store_row(S, a.ws + (static_cast<size_t>(bh) * a.nws + x.j) * DD);
    } else {
      // gy_s . v_s and r_s . (u k_s) of each step: a warp's dot product.
      for (int i = warp; i < 2 * n; i += NW) {
        const int s = i >> 1;
        float p = 0.f;
        for (int e = lane; e < D; e += 32)
          p = (i & 1) ? __fmaf_rn(sr[s * D + e],
                                  __fmul_rn(su[e], sk[s * D + e]), p)
                      : __fmaf_rn(sg[s * D + e], sv[s * D + e], p);
        p = warp_sum(p);
        if (lane == 0) ((i & 1) ? sruk : sgyv)[s] = p;
      }
      // The states before each step, into the thread's own slots.
      for (int s = 0; s < n; ++s) {
#pragma unroll
        for (int j = 0; j < J; ++j)
          states[(s * J + j) * NT + tid] = make_float4(
              S[4 * j], S[4 * j + 1], S[4 * j + 2], S[4 * j + 3]);
        advance(s);
      }
      __syncthreads();
      for (int s = n - 1; s >= 0; --s) {
        const float rd = sr[s * D + d], kd = sk[s * D + d];
        const float wd = sw[s * D + d], gyv = sgyv[s];
        float ar[J], ak[J], aw[J], p[CPT];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float4 sp4 = states[(s * J + j) * NT + tid];
          const float4 v4 = *reinterpret_cast<const float4*>(
              sv + s * D + owned<RB>(q, 4 * j));
          const float4 g4 = *reinterpret_cast<const float4*>(
              sg + s * D + owned<RB>(q, 4 * j));
          const float sp[4] = {sp4.x, sp4.y, sp4.z, sp4.w};
          const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
          const float gg[4] = {g4.x, g4.y, g4.z, g4.w};
          ar[j] = ak[j] = aw[j] = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float& g = G[4 * j + i];
            ar[j] = __fmaf_rn(gg[i], sp[i], ar[j]);
            ak[j] = __fmaf_rn(g, vv[i], ak[j]);
            aw[j] = __fmaf_rn(g, sp[i], aw[j]);
            p[4 * j + i] = __fmul_rn(g, kd);
            g = __fmaf_rn(wd, g, __fmul_rn(rd, gg[i]));   // d/d S_{t-1}
          }
        }
        const float dr = __fmaf_rn(__fmul_rn(ud, kd), gyv,
                                   lanes_sum<RB>(tree_sum(ar)));
        const float dk = __fmaf_rn(__fmul_rn(rd, ud), gyv,
                                   lanes_sum<RB>(tree_sum(ak)));
        const float dw = lanes_sum<RB>(tree_sum(aw));
        gu = __fmaf_rn(__fmul_rn(rd, kd), gyv, gu);
        if (q == 0) {
          outs[0][s][d] = dr;
          outs[1][s][d] = dk;
          outs[2][s][d] = dw;
        }
        // dv: the warp's rows (lane bits RB .. 16) by the butterfly, then
        // the warps in order below.
        using BF = Butterfly<CPT, RB, 32>;
        int off, dup;
        BF::run(p, lane, off, dup);
        if ((lane & dup) == 0) {
#pragma unroll
          for (int i = 0; i < BF::kept; ++i)
            dvp[s][warp][owned<RB>(q, off + i)] = p[i];
        }
      }
      __syncthreads();
      // The unit's outputs, a step's row at a time: dv adds the warps'
      // sums in order, then gy r . (u k).
      const size_t x0 = (static_cast<size_t>(b) * a.S + t0) * HD +
                        static_cast<size_t>(h) * D;
      for (int i = tid; i < n * D; i += NT) {
        const int s = i / D, e = i % D;
        float acc = dvp[s][0][e];
#pragma unroll
        for (int w = 1; w < NW; ++w) acc = __fadd_rn(acc, dvp[s][w][e]);
        const size_t o = x0 + s * HD + e;
        a.dv[o] = __fmaf_rn(sg[s * D + e], sruk[s], acc);
        a.dr[o] = outs[0][s][e];
        a.dk[o] = outs[1][s][e];
        a.dw[o] = outs[2][s][e];
      }
    }
    __syncthreads();
    x = nx;
  }
  store_row(G, a.dS0 + bh * DD);
  if (q == 0) a.du_part[static_cast<size_t>(bh) * D + d] = gu;
}

bool bad_sizes(int b, int S, int H, int chunk) {
  return b <= 0 || S <= 0 || H <= 0 || chunk <= 0;
}

// The sub-chunk starts the backward keeps in its workspace for each
// (b, h): ceil(ck / L) - 2 (the first is the carry, the last stays in
// registers), none below 3 sub-chunks.
int workspace_states(int ck) {
  const int ns = (ck + L - 1) / L;
  return ns > 2 ? ns - 2 : 0;
}

// Launches the backward on `st`, first allowing it its dynamic shared
// memory (a setting of the device's; repeating it costs little).
template <int D>
cudaError_t launch_bwd(const Bwd& a, cudaStream_t st) {
  using SM = BwdSmem<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      wkv_bwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SM::bytes));
  if (err != cudaSuccess) return err;
  wkv_bwd<D><<<a.b * a.H, SM::NT, SM::bytes, st>>>(a);
  return cudaSuccess;
}

}  // namespace
}  // namespace repro

// r, k, v, w, y (b, S, H, D); u (H, D); S0, S_last (b, H, D, D);
// carries (b, nc, H, D, D) with ck = min(chunk, S), nc = ceil(S / ck):
// the state before each chunk's first step. All f32, contiguous, 16-byte
// aligned. D is 16 or 64. Launches on `stream` (of the caller's current
// device) and returns cudaGetLastError(); cudaErrorInvalidValue,
// launching nothing, for another D or an empty shape.
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
    case 16: wkv_fwd<16><<<b * H, FwdShape<16>::NT, 0, st>>>(a); break;
    case 64: wkv_fwd<64><<<b * H, FwdShape<64>::NT, 0, st>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The gradients of wkv6_fwd_launch's (y, S_last) given gy (b, S, H, D)
// and gS (b, H, D, D): dr, dk, dv, dw (b, S, H, D), du (H, D), dS0 (b, H,
// D, D). Workspace, f32: ws (b, H, ceil(ck / 8) - 2 or 0, D, D), the
// sub-chunk starts of one chunk, of ws_floats floats (anything else is
// refused); du_part (b, H, D), the per-row sums. Two launches on `stream`
// (the scan, then du's fixed-order pass); returns cudaGetLastError(), or
// cudaErrorInvalidValue as the forward.
extern "C" int wkv6_bwd_launch(const void* gy, const void* gS, const void* r,
                               const void* k, const void* v, const void* w,
                               const void* u, const void* carries, void* dr,
                               void* dk, void* dv, void* dw, void* du,
                               void* dS0, void* ws, void* du_part,
                               long long ws_floats, int b, int S, int H,
                               int D, int chunk, void* stream) {
  using namespace repro;
  if (bad_sizes(b, S, H, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ck = chunk < S ? chunk : S, nc = (S + ck - 1) / ck;
  const int nws = workspace_states(ck);
  if (ws_floats != static_cast<long long>(b) * H * nws * D * D)
    return static_cast<int>(cudaErrorInvalidValue);
  const Bwd a{static_cast<const float*>(gy), static_cast<const float*>(gS),
              static_cast<const float*>(r),  static_cast<const float*>(k),
              static_cast<const float*>(v),  static_cast<const float*>(w),
              static_cast<const float*>(u),
              static_cast<const float*>(carries),
              static_cast<float*>(dr),       static_cast<float*>(dk),
              static_cast<float*>(dv),       static_cast<float*>(dw),
              static_cast<float*>(du),       static_cast<float*>(dS0),
              static_cast<float*>(ws),       static_cast<float*>(du_part),
              b, S, H, ck, nc, nws};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 16: err = launch_bwd<16>(a, st); break;
    case 64: err = launch_bwd<64>(a, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_sum_parts(a.du_part, a.du, b, static_cast<long>(H) * D, st);
  return static_cast<int>(cudaGetLastError());
}

// The backward kernel's dynamic shared memory in bytes at head size D (0
// for a D it is not compiled for).
extern "C" int wkv6_bwd_smem_bytes(int D) {
  using namespace repro;
  switch (D) {
    case 16: return static_cast<int>(BwdSmem<16>::bytes);
    case 64: return static_cast<int>(BwdSmem<64>::bytes);
    default: return 0;
  }
}

extern "C" const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
