// Slab decision function:   out = (s - rho1) * (rho2 - s),
//                           s   = sum_j gamma_j k(q, t_j).
//
// Replaces the TPU kernel _decision_kernel / decision_pallas of
// src/repro/kernels/decision/kernel.py, whose grid (NQ/TM, M/TN) walks
// the support tiles in order on one core into a VMEM accumulator. On
// Hopper that support axis is spread over the SMs: the grid is (query
// tiles) x (support splits), a CTA owning BM queries and one or more
// splits of SW = BN contiguous support rows. For each split it writes one
// f32 partial per query to a workspace (splits, nq) the wrapper
// allocates; a second kernel adds each query's partials in split order
// and applies the slab rule. No atomics: the output is bitwise the same
// from run to run.
//
// Numerics, as the reference: f32 dot products, f32 norms of the rounded
// rows (made by the wrapper), the kernel value with the reference's
// rounding steps and expf (kernel_rows.cuh), an f32 weighted sum.
//
// What bounds it on an H100: every query meets every support row, 2*d
// flops a pair, and rbf adds one expf and about 7 f32 instructions a
// pair. At 4096 x 4096, d = 128: 4.3 GFLOP (0.064 ms of f32 FMA at
// 67 TFLOP/s, 0.0044 ms on the tensor cores) and 16.7 M exps (about
// 4.5 us at 16 a clock per SM). Two classes by the rows' type:
//
// * f32 (SIMT, CUDA cores, no TF32): decision_simt_kernel, gram.cu's
//   pipelined f32 tile (float4 loads of BK = 8 features into registers
//   while the previous chunk computes, two shared stages, float4 shared
//   reads) over a BM x 64 tile, with the weighted row-sum epilogue in
//   place of the store. Thread (ty, tx) owns columns tx*4 + e and
//   32 + tx*4 + e (e < 4) of the split and TR rows; each dot product is
//   its FMA chain over the features in order.
// * bf16 / f16 (wgmma, tensor cores): decision_wgmma_kernel. One
//   producer warp loads the CTA's query tile (BM x d, 128-byte swizzle)
//   by TMA once, where it stays, then streams the support rows of the
//   CTA's chunks (NW = 4 * TC rows: 32, 64 or 128, whole splits of 32)
//   through a ring of DEPTH stages of NW rows x 64 features; BM / 64
//   consumer warpgroups each run wgmma.m64nNWk16 over the features into
//   f32 accumulators and the weighted row-sum epilogue on the fragment
//   (hopper.cuh), split by split, one chunk at a time; the other
//   warpgroup and the SM's other CTAs run their products while one runs
//   its exps. The chunks a CTA takes are the launcher's: as many CTAs as
//   the SMs hold at once.
//
// Sum order, what every entry of a class keeps: a split's partial for
// query r is the sum of w[c] * k(r, c) over the split's columns, each
// thread adding its own columns in a fixed order and then a fixed
// shuffle tree over the threads of the row (SIMT: columns j < 8 in
// order, then xor 4, 2, 1 over the 8 threads; wgmma: the fragment's
// (j, h) order, then xor 1, 2 over the quad); s is the sum of the
// partials in split order. SW, the column map and the tree are the
// class's; BM, TR, the ring's depth, the number of consumer warpgroups,
// a wgmma's width NW and the splits a CTA takes are free. Columns past nt
// add nothing.
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"   // TMA, mbarriers, wgmma (includes kernel_rows.cuh)

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

// ---------------------------------------------------------------------------
// The reduction: each query's partials in split order, then the slab rule
// ---------------------------------------------------------------------------

// A CTA owns kRedQ queries: its threads load up to kRedK splits' partials
// of them into shared memory at once (all loads in flight), then one warp
// adds each query's in order.
constexpr int kRedQ = 32;
constexpr int kRedK = 128;
constexpr int kRedThreads = 256;

__global__ void __launch_bounds__(kRedThreads)
    decision_reduce_kernel(const float* __restrict__ ws,
                           float* __restrict__ out, int nq, int splits,
                           float rho1, float rho2) {
  __shared__ float part[kRedK][kRedQ + 1];
  constexpr int ROWS = kRedThreads / kRedQ;
  const int lane = threadIdx.x % kRedQ;
  const int r = blockIdx.x * kRedQ + lane;
  float s = 0.0f;
  for (int k0 = 0; k0 < splits; k0 += kRedK) {
    const int nk = splits - k0 < kRedK ? splits - k0 : kRedK;
#pragma unroll 4
    for (int k = threadIdx.x / kRedQ; k < nk; k += ROWS)
      part[k][lane] = r < nq ? ws[static_cast<size_t>(k0 + k) * nq + r]
                             : 0.0f;
    __syncthreads();
    if (threadIdx.x < kRedQ)
      for (int k = 0; k < nk; ++k) s = __fadd_rn(s, part[k][lane]);
    __syncthreads();
  }
  if (threadIdx.x < kRedQ && r < nq)
    out[r] = __fmul_rn(__fsub_rn(s, rho1), __fsub_rn(rho2, s));
}

int launch_reduce(const Args& a, int splits, cudaStream_t stream) {
  decision_reduce_kernel<<<(a.nq + kRedQ - 1) / kRedQ, kRedThreads, 0,
                           stream>>>(a.ws, static_cast<float*>(a.out), a.nq,
                                     splits, a.rho1, a.rho2);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: the pipelined SIMT tile
// ---------------------------------------------------------------------------

// part[i] += w[c] * k(acc[i][j]) over the thread's columns c below nt,
// j in order, the kind fixed.
template <int KIND, int TR, int TC, int BN>
__device__ __forceinline__ void simt_add_weighted(
    const float (&acc)[TR][TC], const float (&rn)[TR],
    const float* __restrict__ tnorm, const float* __restrict__ gamma,
    int nt, int col0, int tx, const KernelParams& p, float (&part)[TR]) {
#pragma unroll
  for (int j = 0; j < TC; ++j) {
    const int c = col0 + (j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + j - 4);
    if (c < nt) {
      const float cn = __ldg(tnorm + c), w = __ldg(gamma + c);
#pragma unroll
      for (int i = 0; i < TR; ++i)
        part[i] = fmaf(kernel_value<KIND>(acc[i][j], rn[i], cn, p), w,
                       part[i]);
    }
  }
}

// CTA b: query tile b % qtiles, split b / qtiles. Thread (ty, tx) owns
// rows ty*4 + i (i < 4) and, for TR = 8, BM/2 + ty*4 + i; columns as the
// header says.
template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH>
__global__ void __launch_bounds__((BM / TR) * (BN / TC))
    decision_simt_kernel(const float* __restrict__ q,
                         const float* __restrict__ t,
                         const float* __restrict__ gamma,
                         const float* __restrict__ qn,
                         const float* __restrict__ tnorm,
                         float* __restrict__ ws, int nq, int nt, int d,
                         KernelParams p, int vec) {
  static_assert(std::is_same<T, float>::value, "the SIMT class is f32");
  static_assert((TR == 4 || TR == 8) && TC == 8,
                "one or two float4s of rows, two of columns");
  static_assert(DEPTH == 2, "register-staged double buffering");
  constexpr int NTY = BM / TR;
  constexpr int NTX = BN / TC;
  constexpr int NT = NTY * NTX;
  static_assert(NTX <= 32 && (32 % NTX) == 0,
                "a row's threads must sit in one warp");
  static_assert(NT % 32 == 0, "whole warps only");
  constexpr int LA = BM * BK / (4 * NT);
  constexpr int LB = BN * BK / (4 * NT);
  static_assert(LA * 4 * NT == BM * BK && LB * 4 * NT == BN * BK,
                "each thread fetches whole float4s");
  __shared__ __align__(16) float As[2][BK][BM + 4];
  __shared__ __align__(16) float Bs[2][BK][BN + 4];

  const int tx = threadIdx.x % NTX;
  const int ty = threadIdx.x / NTX;
  const int qtiles = (nq + BM - 1) / BM;
  const int split = blockIdx.x / qtiles;
  const int row0 = (blockIdx.x % qtiles) * BM;
  const int col0 = split * BN;
  const int nk = (d + BK - 1) / BK;

  float rn[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
    rn[i] = r < nq ? qn[r] : 0.0f;
  }

  float acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.0f;

  float4 ra[LA], rb[LB];
  fetch_chunk<BK, LA, NT>(q, nq, d, row0, 0, vec, ra);
  fetch_chunk<BK, LB, NT>(t, nt, d, col0, 0, vec, rb);
  stash_chunk<BK, LA, NT>(As[0], ra);
  stash_chunk<BK, LB, NT>(Bs[0], rb);
  __syncthreads();

  for (int c = 0; c < nk; ++c) {
    const int cur = c & 1;
    const bool more = c + 1 < nk;
    if (more) {      // chunk c + 1 in flight while chunk c computes
      fetch_chunk<BK, LA, NT>(q, nq, d, row0, (c + 1) * BK, vec, ra);
      fetch_chunk<BK, LB, NT>(t, nt, d, col0, (c + 1) * BK, vec, rb);
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TR];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
      a[0] = a0.x, a[1] = a0.y, a[2] = a0.z, a[3] = a0.w;
      if constexpr (TR == 8) {
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[cur][k][BM / 2 + ty * 4]);
        a[TR - 4] = a1.x, a[TR - 3] = a1.y, a[TR - 2] = a1.z,
        a[TR - 1] = a1.w;
      }
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[cur][k][BN / 2 + tx * 4]);
      const float b[TC] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      stash_chunk<BK, LA, NT>(As[cur ^ 1], ra);
      stash_chunk<BK, LB, NT>(Bs[cur ^ 1], rb);
    }
    __syncthreads();
  }

  float part[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) part[i] = 0.0f;
  switch (p.kind) {       // one dispatch a CTA, not one a value
    case kRbf:
      simt_add_weighted<kRbf, TR, TC, BN>(acc, rn, tnorm, gamma, nt, col0, tx,
                                          p, part);
      break;
    case kPoly:
      simt_add_weighted<kPoly, TR, TC, BN>(acc, rn, tnorm, gamma, nt, col0,
                                           tx, p, part);
      break;
    default:
      simt_add_weighted<kLinear, TR, TC, BN>(acc, rn, tnorm, gamma, nt, col0,
                                             tx, p, part);
      break;
  }
  reduce_row<TR, NTX>(part);
  if (tx == 0) {
    float* w = ws + static_cast<size_t>(split) * nq;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = row0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
      if (r < nq) w[r] = part[i];
    }
  }
}

template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH>
int launch_simt(const Args& a, cudaStream_t stream) {
  const int splits = (a.nt + BN - 1) / BN;
  if (splits > 0) {
    const auto aligned = [](const void* ptr) {
      return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
    };
    const int vec = a.d % 4 == 0 && aligned(a.q) && aligned(a.t);
    const int qtiles = (a.nq + BM - 1) / BM;
    constexpr int threads = (BM / TR) * (BN / TC);
    decision_simt_kernel<T, BM, BN, BK, TR, TC, DEPTH><<<
        qtiles * splits, threads, 0, stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.t),
        static_cast<const float*>(a.gamma), static_cast<const float*>(a.qn),
        static_cast<const float*>(a.tnorm), a.ws, a.nq, a.nt, a.d, a.p,
        vec);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return launch_reduce(a, splits, stream);
}

// ---------------------------------------------------------------------------
// bf16 / f16: wgmma fed by TMA
// ---------------------------------------------------------------------------

// The partials of the NW / BN splits of chunk c from one warpgroup's
// NW-wide fragment, the kind fixed: split u's columns are fragment
// columns u*BN .. u*BN + BN - 1, i.e. accumulators u*BN/2 .. on, laid
// out as a BN-wide fragment's (hopper.cuh); the quad's lane 0 writes
// rows r0 and r0 + 8 of the split's workspace row.
template <int KIND, int NW, int BN>
__device__ __forceinline__ void chunk_partials(
    const float (&acc)[NW / 2], float rn0, float rn1,
    const float* __restrict__ tnorm, const float* __restrict__ gamma,
    float* __restrict__ ws, int nq, int nt, int splits, int c, int r0,
    int lane, const KernelParams& p) {
#pragma unroll
  for (int u = 0; u < NW / BN; ++u) {
    const int s = c * (NW / BN) + u;
    if (s >= splits) break;
    const float(&sub)[BN / 2] =
        *reinterpret_cast<const float(*)[BN / 2]>(&acc[u * (BN / 2)]);
    float part0 = 0.0f, part1 = 0.0f;
    fragment_add_weighted<KIND, BN>(sub, rn0, rn1, tnorm, gamma, nt, s * BN,
                                    lane, p, part0, part1);
    quad_reduce(part0, part1);
    if (lane % 4 == 0) {
      float* w = ws + static_cast<size_t>(s) * nq;
      if (r0 < nq) w[r0] = part0;
      if (r0 + 8 < nq) w[r0 + 8] = part1;
    }
  }
}

// Dynamic shared memory: the resident query tile (nk k-blocks of BM x BK),
// the ring of NW x BK stages, 1024 bytes of slack to align both for the
// swizzle, and the barriers (a full and an empty one a stage, one for the
// query tile).
template <int BM, int NW, int BK, int DEPTH>
__host__ __device__ constexpr int dec_wgmma_smem_bytes(int nk) {
  return nk * BM * BK * 2 + DEPTH * NW * BK * 2 + 1024 + 8 * (2 * DEPTH + 1);
}

// Threads: BM / 64 consumer warpgroups (warpgroup w owns the tile's rows
// 64w .. 64w + 63), then the producer warp, whose first thread issues
// every TMA load. A wgmma covers a chunk of NW = 4 * TC support rows,
// NW / BN splits, whose partials the epilogue takes apart (the same sums
// as one split a wgmma: a lane owns the same columns of each split).
// CTA b: query tile b % qtiles, chunks [c0, c0 + per_cta) with
// c0 = (b / qtiles) * per_cta.
template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH>
__global__ void __launch_bounds__(BM / 64 * kWarpGroup + 32)
    decision_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_t,
                          const float* __restrict__ gamma,
                          const float* __restrict__ qn,
                          const float* __restrict__ tnorm,
                          float* __restrict__ ws, int nq, int nt, int d,
                          KernelParams p, int per_cta) {
  constexpr int NW = 4 * TC;
  static_assert(BM % 64 == 0 && BM <= 128 && BK == 64,
                "m64 warpgroups, k-block 64");
  static_assert(TR == 2 && NW % BN == 0 && BN % 8 == 0,
                "the wgmma fragment: 2 x NW/4, whole splits a chunk");
  constexpr int WGS = BM / 64;
  constexpr int QBLOCK = BM * BK * 2;     // one k-block of the query tile
  constexpr int STAGE = NW * BK * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const int nk = (d + BK - 1) / BK;
  unsigned char* ring = qs + nk * QBLOCK;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + DEPTH * STAGE);
  uint64_t* empty = full + DEPTH;
  uint64_t* qbar = empty + DEPTH;

  const int qtiles = (nq + BM - 1) / BM;
  const int splits = (nt + BN - 1) / BN;
  const int chunks = (nt + NW - 1) / NW;
  const int qt = blockIdx.x % qtiles;
  const int c0 = (blockIdx.x / qtiles) * per_cta;
  const int c1 = c0 + per_cta < chunks ? c0 + per_cta : chunks;
  const int wg = threadIdx.x / kWarpGroup;

  if (threadIdx.x == 0) {
    for (int s = 0; s < DEPTH; ++s) {
      mbar_init(&full[s], 1);                    // the producer's expect_tx
      mbar_init(&empty[s], WGS * kWarpGroup);    // every consumer thread
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == WGS) {
    if (threadIdx.x == WGS * kWarpGroup) {
      mbar_expect_tx(qbar, nk * QBLOCK);         // out-of-bounds fill counts
      for (int kb = 0; kb < nk; ++kb)
        tma_load(qs + kb * QBLOCK, &map_q, qbar, kb * BK, qt * BM);
      int stage = 0, phase = 0;
      for (int c = c0; c < c1; ++c) {
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], STAGE);
          tma_load(ring + stage * STAGE, &map_t, &full[stage], kb * BK,
                   c * NW);
          if (++stage == DEPTH) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  const int t = threadIdx.x % kWarpGroup;
  const int lane = t % 32;
  const int rr = (t / 32) * 16 + lane / 4;       // row in the 64-row box
  const int r0 = qt * BM + wg * 64 + rr;
  const float rn0 = r0 < nq ? qn[r0] : 0.0f;
  const float rn1 = r0 + 8 < nq ? qn[r0 + 8] : 0.0f;
  const unsigned char* a = qs + wg * 64 * BK * 2;
  mbar_wait(qbar, 0);
  int stage = 0, phase = 0;
  for (int c = c0; c < c1; ++c) {
    float acc[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.0f;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(&full[stage], phase);
      const unsigned char* qa = a + kb * QBLOCK;
      const unsigned char* b = ring + stage * STAGE;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)    // 32 bytes = 2 units a step
        Wgmma<T, NW>::mma(acc, smem_desc(qa) + 2 * kk,
                          smem_desc(b) + 2 * kk);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      mbar_arrive(&empty[stage]);
      if (++stage == DEPTH) {
        stage = 0;
        phase ^= 1;
      }
    }
    switch (p.kind) {     // one dispatch a chunk, not one a value
      case kRbf:
        chunk_partials<kRbf, NW, BN>(acc, rn0, rn1, tnorm, gamma, ws, nq, nt,
                                     splits, c, r0, lane, p);
        break;
      case kPoly:
        chunk_partials<kPoly, NW, BN>(acc, rn0, rn1, tnorm, gamma, ws, nq,
                                      nt, splits, c, r0, lane, p);
        break;
      default:
        chunk_partials<kLinear, NW, BN>(acc, rn0, rn1, tnorm, gamma, ws, nq,
                                        nt, splits, c, r0, lane, p);
        break;
    }
  }
}

template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH>
int launch_wgmma(const Args& a, cudaStream_t stream) {
  constexpr int NW = 4 * TC;
  static_assert(dec_wgmma_smem_bytes<BM, NW, BK, DEPTH>(1) <= kMaxSmem,
                "the ring exceeds shared memory");
  const int chunks = (a.nt + NW - 1) / NW;
  if (chunks > 0) {
    // TMA: 16-byte aligned rows (the wrapper pads d to a multiple of 8).
    if (a.d % 8 != 0 || reinterpret_cast<uintptr_t>(a.q) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(a.t) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
    // The query tile stays resident: d up to 640-830 at BM = 128, by
    // the ring's size.
    const int smem = dec_wgmma_smem_bytes<BM, NW, BK, DEPTH>(
        (a.d + BK - 1) / BK);
    if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    const CUtensorMapDataType type = std::is_same<T, __half>::value
                                         ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    CUtensorMap map_q, map_t;
    int err = encode_map(&map_q, type, 2, a.q, a.nq, a.d, BM, BK);
    if (err == 0) err = encode_map(&map_t, type, 2, a.t, a.nt, a.d, NW, BK);
    static bool smem_set[64] = {};
    const auto kernel = decision_wgmma_kernel<T, BM, BN, BK, TR, TC, DEPTH>;
    if (err == 0) err = allow_smem(kernel, kMaxSmem, smem_set);
    int dev = 0, sms = 0;
    if (err == 0) err = static_cast<int>(cudaGetDevice(&dev));
    if (err == 0)
      err = static_cast<int>(cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, dev));
    if (err != 0) return err;
    // As many CTAs as the SMs hold at once: the chunks of a query tile
    // in runs of per_cta, each CTA loading its query tile once.
    constexpr int threads = BM / 64 * kWarpGroup + 32;
    int per_sm = 0;
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, threads, smem));
    if (err != 0) return err;
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int qtiles = (a.nq + BM - 1) / BM;
    int groups = (per_sm * sms + qtiles - 1) / qtiles;
    if (groups > chunks) groups = chunks;
    const int per_cta = (chunks + groups - 1) / groups;
    groups = (chunks + per_cta - 1) / per_cta;
    kernel<<<qtiles * groups, threads, smem, stream>>>(
        map_q, map_t, static_cast<const float*>(a.gamma),
        static_cast<const float*>(a.qn), static_cast<const float*>(a.tnorm),
        a.ws, a.nq, a.nt, a.d, a.p, per_cta);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return launch_reduce(a, (a.nt + BN - 1) / BN, stream);
}

// The menu: launch index -> <BM, BN, BK, TR, TC, DEPTH>, in the order of
// MENUS["decision"] in kernels/tiling.py (tests read these lines). Two
// classes by the rows' type, each compiled for its types only: f32 runs
// the SIMT entries (SW = BN = 64; entry 0 is the default), bf16 and f16
// the wgmma entries (SW = BN = 32, NW = 4 * TC; entry 4 is the default).
// An index of the other class is refused with cudaErrorInvalidValue.
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
// TMA map cuTensorMapEncodeTiled refuses or a 16-bit query tile too wide
// for shared memory, cudaErrorMisalignedAddress for 16-bit rows TMA
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

extern "C" const char* decision_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
