// Split row sums: the kernels decision.cu and fupdate.cu's wide classes
// share. For every row r of A (na x d) they take
//
//     s[r] = sum_{c < nb} w[c] * k(A[r], B[c])
//
// over the rows of B (nb x d), spread over the SMs: the grid is (row
// tiles of A) x (splits of SW = BN contiguous rows of B), a CTA owning BM
// rows of A and one or more splits. For each split it writes one f32
// partial per row to a workspace (splits, na) the wrapper allocates; a
// second kernel adds each row's partials in split order and applies the
// caller's epilogue (decision: the slab rule (s - rho1) * (rho2 - s) with
// A = the queries, B = the support rows, w = gamma; fupdate: f + s with
// A = the training rows, B = the selected block, w = the dual step). No
// atomics: the output is bitwise the same from run to run.
//
// Numerics, as the reference: f32 dot products, f32 norms of the rounded
// rows (made by the wrapper), the kernel value with the reference's
// rounding steps and expf (kernel_rows.cuh), an f32 weighted sum.
//
// Two classes by the rows' type:
//
// * f32 (SIMT, CUDA cores, no TF32): split_simt_kernel, gram.cu's
//   pipelined f32 tile (float4 loads of BK = 8 features into registers
//   while the previous chunk computes, two shared stages, float4 shared
//   reads) over a BM x 64 tile, with the weighted row-sum epilogue in
//   place of the store. Thread (ty, tx) owns columns tx*4 + e and
//   32 + tx*4 + e (e < 4) of the split and TR rows; each dot product is
//   its FMA chain over the features in order.
// * bf16 / f16 (wgmma, tensor cores): split_wgmma_kernel. One producer
//   warp loads by TMA (128-byte swizzle) the CTA's A tile (BM x d) and
//   the B rows of the CTA's chunks (NW = 4 * TC rows: 32, 64 or 128,
//   whole splits of 32) through a ring of DEPTH stages of NW rows x 64
//   features; BM / 64 consumer warpgroups each run wgmma.m64nNWk16 over
//   the features into f32 accumulators and the weighted row-sum epilogue
//   on the fragment (hopper.cuh), split by split, one chunk at a time.
//   The chunks a CTA takes are the launcher's: as many CTAs as the SMs
//   hold at once. Two modes of the A tile:
//   - resident: loaded once per CTA, before the first chunk, where it
//     stays (nk k-blocks of BM x 64). It caps d by shared memory: the
//     largest padded d is 1664 at BM = 64, NW = 32, DEPTH = 4, and 640 to
//     832 at BM = 128 (tiling.wgmma_fits mirrors the formula);
//   - streamed: each ring stage holds the A tile's k-block beside the B
//     rows' k-block, loaded once per chunk; shared memory no longer grows
//     with d, at the price of re-reading the A tile (from L2) for every
//     chunk. split_wgmma_kernel_cluster (below) streams chunks of 256
//     rows of B shared by 2-CTA clusters, for launches that fill the card.
//   All feed wgmma the same k-blocks in the same order, so every mode
//   gives bitwise the same sums.
//
// Sum order, what every entry of a class keeps: a split's partial for
// row r is the sum of w[c] * k(r, c) over the split's columns, each
// thread adding its own columns in a fixed order and then a fixed
// shuffle tree over the threads of the row (SIMT: columns j < 8 in
// order, then xor 4, 2, 1 over the 8 threads; wgmma: the fragment's
// (j, h) order, then xor 1, 2 over the quad); s is the sum of the
// partials in split order. SW, the column map and the tree are the
// class's; BM, TR, the ring's depth, the number of consumer warpgroups,
// a wgmma's width NW, the A tile's mode and the splits a CTA takes are
// free. Columns past nb add nothing.
#pragma once

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"   // TMA, mbarriers, wgmma (includes kernel_rows.cuh)

namespace repro {
namespace {

// One launch: A (na, d) and B (nb, d) row-major in the tile type, w and
// bn (nb,) and an (na,) f32, ws the (splits, na) f32 workspace.
struct SplitArgs {
  const void *a, *b, *w, *an, *bn;
  float* ws;
  int na, nb, d;
  KernelParams p;
};

// The reduction's epilogues: what row r's output is from its sum s.
struct SlabRule {          // decision: (s - rho1) * (rho2 - s)
  float* out;
  float rho1, rho2;
  __device__ __forceinline__ void operator()(int r, float s) const {
    out[r] = __fmul_rn(__fsub_rn(s, rho1), __fsub_rn(rho2, s));
  }
};

struct AddToF {            // fupdate: f + s
  const float* f;
  float* out;
  __device__ __forceinline__ void operator()(int r, float s) const {
    out[r] = __fadd_rn(f[r], s);
  }
};

// ---------------------------------------------------------------------------
// The reduction: each row's partials in split order, then the epilogue
// ---------------------------------------------------------------------------

// A CTA owns kRedQ rows: its threads load up to kRedK splits' partials
// of them into shared memory at once (all loads in flight), then one warp
// adds each row's in order.
constexpr int kRedQ = 32;
constexpr int kRedK = 128;
constexpr int kRedThreads = 256;

template <typename Epi>
__global__ void __launch_bounds__(kRedThreads)
    split_reduce_kernel(const float* __restrict__ ws, int na, int splits,
                        Epi epi) {
  __shared__ float part[kRedK][kRedQ + 1];
  constexpr int ROWS = kRedThreads / kRedQ;
  const int lane = threadIdx.x % kRedQ;
  const int r = blockIdx.x * kRedQ + lane;
  float s = 0.0f;
  for (int k0 = 0; k0 < splits; k0 += kRedK) {
    const int nk = splits - k0 < kRedK ? splits - k0 : kRedK;
#pragma unroll 4
    for (int k = threadIdx.x / kRedQ; k < nk; k += ROWS)
      part[k][lane] = r < na ? ws[static_cast<size_t>(k0 + k) * na + r]
                             : 0.0f;
    __syncthreads();
    if (threadIdx.x < kRedQ)
      for (int k = 0; k < nk; ++k) s = __fadd_rn(s, part[k][lane]);
    __syncthreads();
  }
  if (threadIdx.x < kRedQ && r < na) epi(r, s);
}

template <typename Epi>
int launch_reduce(const SplitArgs& a, int splits, const Epi& epi,
                  cudaStream_t stream) {
  split_reduce_kernel<Epi><<<(a.na + kRedQ - 1) / kRedQ, kRedThreads, 0,
                             stream>>>(a.ws, a.na, splits, epi);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: the pipelined SIMT tile
// ---------------------------------------------------------------------------

// part[i] += w[c] * k(acc[i][j]) over the thread's columns c below nb,
// j in order, the kind fixed.
template <int KIND, int TR, int TC, int BN>
__device__ __forceinline__ void simt_add_weighted(
    const float (&acc)[TR][TC], const float (&rn)[TR],
    const float* __restrict__ bn, const float* __restrict__ w, int nb,
    int col0, int tx, const KernelParams& p, float (&part)[TR]) {
#pragma unroll
  for (int j = 0; j < TC; ++j) {
    const int c = col0 + (j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + j - 4);
    if (c < nb) {
      const float cn = __ldg(bn + c), wc = __ldg(w + c);
#pragma unroll
      for (int i = 0; i < TR; ++i)
        part[i] = fmaf(kernel_value<KIND>(acc[i][j], rn[i], cn, p), wc,
                       part[i]);
    }
  }
}

// CTA b: row tile b % qtiles, split b / qtiles. Thread (ty, tx) owns
// rows ty*4 + i (i < 4) and, for TR = 8, BM/2 + ty*4 + i; columns as the
// header says.
template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH>
__global__ void __launch_bounds__((BM / TR) * (BN / TC))
    split_simt_kernel(const float* __restrict__ A,
                      const float* __restrict__ B,
                      const float* __restrict__ w,
                      const float* __restrict__ an,
                      const float* __restrict__ bn,
                      float* __restrict__ ws, int na, int nb, int d,
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
  const int qtiles = (na + BM - 1) / BM;
  const int split = blockIdx.x / qtiles;
  const int row0 = (blockIdx.x % qtiles) * BM;
  const int col0 = split * BN;
  const int nk = (d + BK - 1) / BK;

  float rn[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
    rn[i] = r < na ? an[r] : 0.0f;
  }

  float acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.0f;

  float4 ra[LA], rb[LB];
  fetch_chunk<BK, LA, NT>(A, na, d, row0, 0, vec, ra);
  fetch_chunk<BK, LB, NT>(B, nb, d, col0, 0, vec, rb);
  stash_chunk<BK, LA, NT>(As[0], ra);
  stash_chunk<BK, LB, NT>(Bs[0], rb);
  __syncthreads();

  for (int c = 0; c < nk; ++c) {
    const int cur = c & 1;
    const bool more = c + 1 < nk;
    if (more) {      // chunk c + 1 in flight while chunk c computes
      fetch_chunk<BK, LA, NT>(A, na, d, row0, (c + 1) * BK, vec, ra);
      fetch_chunk<BK, LB, NT>(B, nb, d, col0, (c + 1) * BK, vec, rb);
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
      simt_add_weighted<kRbf, TR, TC, BN>(acc, rn, bn, w, nb, col0, tx, p,
                                          part);
      break;
    case kPoly:
      simt_add_weighted<kPoly, TR, TC, BN>(acc, rn, bn, w, nb, col0, tx, p,
                                           part);
      break;
    default:
      simt_add_weighted<kLinear, TR, TC, BN>(acc, rn, bn, w, nb, col0, tx,
                                             p, part);
      break;
  }
  reduce_row<TR, NTX>(part);
  if (tx == 0) {
    float* out = ws + static_cast<size_t>(split) * na;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = row0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
      if (r < na) out[r] = part[i];
    }
  }
}

template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH,
          typename Epi>
int launch_split_simt(const SplitArgs& a, const Epi& epi,
                      cudaStream_t stream) {
  if (a.na == 0) return 0;
  const int splits = (a.nb + BN - 1) / BN;
  if (splits > 0) {
    const auto aligned = [](const void* ptr) {
      return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
    };
    const int vec = a.d % 4 == 0 && aligned(a.a) && aligned(a.b);
    const int qtiles = (a.na + BM - 1) / BM;
    constexpr int threads = (BM / TR) * (BN / TC);
    split_simt_kernel<T, BM, BN, BK, TR, TC, DEPTH><<<
        qtiles * splits, threads, 0, stream>>>(
        static_cast<const float*>(a.a), static_cast<const float*>(a.b),
        static_cast<const float*>(a.w), static_cast<const float*>(a.an),
        static_cast<const float*>(a.bn), a.ws, a.na, a.nb, a.d, a.p, vec);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return launch_reduce(a, splits, epi, stream);
}

// ---------------------------------------------------------------------------
// bf16 / f16: wgmma fed by TMA
// ---------------------------------------------------------------------------

// The partials of the NW / BN splits of chunk c from one warpgroup's
// NW-wide fragment, the kind fixed: split u's columns are fragment
// columns u*BN .. u*BN + BN - 1, i.e. accumulators u*BN/2 .. on, laid
// out as a BN-wide fragment's (hopper.cuh); the quad's lane 0 writes
// rows r0 and r0 + 8 of the split's workspace row. MASKED = false: the
// caller knows every split and column of the chunk lies below nb (the
// same sums, without the checks).
template <int KIND, int NW, int BN, bool MASKED = true>
__device__ __forceinline__ void chunk_partials(
    const float (&acc)[NW / 2], float rn0, float rn1,
    const float* __restrict__ bn, const float* __restrict__ w,
    float* __restrict__ ws, int na, int nb, int splits, int c, int r0,
    int lane, const KernelParams& p) {
#pragma unroll
  for (int u = 0; u < NW / BN; ++u) {
    const int s = c * (NW / BN) + u;
    if (MASKED && s >= splits) break;
    const float(&sub)[BN / 2] =
        *reinterpret_cast<const float(*)[BN / 2]>(&acc[u * (BN / 2)]);
    float part0 = 0.0f, part1 = 0.0f;
    fragment_add_weighted<KIND, BN, MASKED>(sub, rn0, rn1, bn, w, nb,
                                            s * BN, lane, p, part0, part1);
    quad_reduce(part0, part1);
    if (lane % 4 == 0) {
      float* out = ws + static_cast<size_t>(s) * na;
      if (r0 < na) out[r0] = part0;
      if (r0 + 8 < na) out[r0 + 8] = part1;
    }
  }
}

// chunk_partials with the kind dispatched once a chunk, not once a value.
template <int NW, int BN, bool MASKED = true>
__device__ __forceinline__ void kind_partials(
    const float (&acc)[NW / 2], float rn0, float rn1,
    const float* __restrict__ bn, const float* __restrict__ w,
    float* __restrict__ ws, int na, int nb, int splits, int c, int r0,
    int lane, const KernelParams& p) {
  switch (p.kind) {
    case kRbf:
      chunk_partials<kRbf, NW, BN, MASKED>(acc, rn0, rn1, bn, w, ws, na, nb,
                                           splits, c, r0, lane, p);
      break;
    case kPoly:
      chunk_partials<kPoly, NW, BN, MASKED>(acc, rn0, rn1, bn, w, ws, na, nb,
                                            splits, c, r0, lane, p);
      break;
    default:
      chunk_partials<kLinear, NW, BN, MASKED>(acc, rn0, rn1, bn, w, ws, na,
                                              nb, splits, c, r0, lane, p);
      break;
  }
}

// Dynamic shared memory: the A tile (resident: its nk k-blocks of
// BM x BK; streamed: one k-block a stage), the ring of NW x BK stages,
// 1024 bytes of slack to align both for the swizzle, and the barriers (a
// full and an empty one a stage, one for the resident tile).
template <int BM, int NW, int BK, int DEPTH, bool STREAM>
__host__ __device__ constexpr int split_wgmma_smem_bytes(int nk) {
  return (STREAM ? DEPTH : nk) * BM * BK * 2 + DEPTH * NW * BK * 2 + 1024 +
         8 * (2 * DEPTH + 1);
}

// Threads: BM / 64 consumer warpgroups (warpgroup w owns the tile's rows
// 64w .. 64w + 63), then the producer warp, whose first thread issues
// every TMA load. A wgmma covers a chunk of NW = 4 * TC rows of B,
// NW / BN splits, whose partials the epilogue takes apart (the same sums
// as one split a wgmma: a lane owns the same columns of each split).
// CTA b: row tile b % qtiles, chunks [c0, c0 + per_cta) with
// c0 = (b / qtiles) * per_cta.
template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH,
          bool STREAM>
__global__ void __launch_bounds__(BM / 64 * kWarpGroup + 32)
    split_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b,
                       const float* __restrict__ w,
                       const float* __restrict__ an,
                       const float* __restrict__ bn,
                       float* __restrict__ ws, int na, int nb, int d,
                       KernelParams p, int per_cta) {
  constexpr int NW = 4 * TC;
  static_assert(BM % 64 == 0 && BM <= 128 && BK == 64,
                "m64 warpgroups, k-block 64");
  static_assert(TR == 2 && NW % BN == 0 && BN % 8 == 0,
                "the wgmma fragment: 2 x NW/4, whole splits a chunk");
  constexpr int WGS = BM / 64;
  constexpr int ABLOCK = BM * BK * 2;     // one k-block of the A tile
  constexpr int BBLOCK = NW * BK * 2;     // one k-block of a chunk of B
  constexpr int STAGE = (STREAM ? ABLOCK : 0) + BBLOCK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* as = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const int nk = (d + BK - 1) / BK;
  unsigned char* ring = STREAM ? as : as + nk * ABLOCK;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + DEPTH * STAGE);
  uint64_t* empty = full + DEPTH;
  uint64_t* abar = empty + DEPTH;

  const int qtiles = (na + BM - 1) / BM;
  const int splits = (nb + BN - 1) / BN;
  const int chunks = (nb + NW - 1) / NW;
  const int qt = blockIdx.x % qtiles;
  const int c0 = (blockIdx.x / qtiles) * per_cta;
  const int c1 = c0 + per_cta < chunks ? c0 + per_cta : chunks;
  const int wg = threadIdx.x / kWarpGroup;

  if (threadIdx.x == 0) {
    for (int s = 0; s < DEPTH; ++s) {
      mbar_init(&full[s], 1);                    // the producer's expect_tx
      mbar_init(&empty[s], WGS * kWarpGroup);    // every consumer thread
    }
    mbar_init(abar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == WGS) {
    if (threadIdx.x == WGS * kWarpGroup) {
      if (!STREAM) {
        mbar_expect_tx(abar, nk * ABLOCK);       // out-of-bounds fill counts
        for (int kb = 0; kb < nk; ++kb)
          tma_load(as + kb * ABLOCK, &map_a, abar, kb * BK, qt * BM);
      }
      int stage = 0, phase = 0;
      for (int c = c0; c < c1; ++c) {
        for (int kb = 0; kb < nk; ++kb) {
          unsigned char* st = ring + stage * STAGE;
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], STAGE);
          if (STREAM) tma_load(st, &map_a, &full[stage], kb * BK, qt * BM);
          tma_load(st + (STREAM ? ABLOCK : 0), &map_b, &full[stage],
                   kb * BK, c * NW);
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
  const float rn0 = r0 < na ? an[r0] : 0.0f;
  const float rn1 = r0 + 8 < na ? an[r0 + 8] : 0.0f;
  const int wg_off = wg * 64 * BK * 2;           // the warpgroup's rows
  if (!STREAM) mbar_wait(abar, 0);
  int stage = 0, phase = 0;
  for (int c = c0; c < c1; ++c) {
    float acc[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.0f;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(&full[stage], phase);
      const unsigned char* st = ring + stage * STAGE;
      const unsigned char* qa = (STREAM ? st : as + kb * ABLOCK) + wg_off;
      const unsigned char* b = st + (STREAM ? ABLOCK : 0);
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
    kind_partials<NW, BN>(acc, rn0, rn1, bn, w, ws, na, nb, splits, c, r0,
                          lane, p);
  }
}

template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH,
          bool STREAM, typename Epi>
int launch_split_wgmma(const SplitArgs& a, const Epi& epi,
                       cudaStream_t stream) {
  constexpr int NW = 4 * TC;
  static_assert(split_wgmma_smem_bytes<BM, NW, BK, DEPTH, STREAM>(1) <=
                    kMaxSmem,
                "the ring exceeds shared memory");
  if (a.na == 0) return 0;
  const int chunks = (a.nb + NW - 1) / NW;
  if (chunks > 0) {
    // TMA: 16-byte aligned rows (the wrappers pad d to a multiple of 8).
    if (a.d % 8 != 0 || reinterpret_cast<uintptr_t>(a.a) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(a.b) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
    // A resident A tile caps d (tiling.wgmma_fits); a streamed one not.
    const int smem = split_wgmma_smem_bytes<BM, NW, BK, DEPTH, STREAM>(
        (a.d + BK - 1) / BK);
    if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    const CUtensorMapDataType type = std::is_same<T, __half>::value
                                         ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    CUtensorMap map_a, map_b;
    int err = encode_map(&map_a, type, 2, a.a, a.na, a.d, BM, BK);
    if (err == 0) err = encode_map(&map_b, type, 2, a.b, a.nb, a.d, NW, BK);
    static bool smem_set[64] = {};
    const auto kernel =
        split_wgmma_kernel<T, BM, BN, BK, TR, TC, DEPTH, STREAM>;
    if (err == 0) err = allow_smem(kernel, kMaxSmem, smem_set);
    int dev = 0, sms = 0;
    if (err == 0) err = static_cast<int>(cudaGetDevice(&dev));
    if (err == 0)
      err = static_cast<int>(cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, dev));
    if (err != 0) return err;
    // As many CTAs as the SMs hold at once: the chunks of a row tile in
    // runs of per_cta, each CTA loading a resident A tile once.
    constexpr int threads = BM / 64 * kWarpGroup + 32;
    int per_sm = 0;
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, threads, smem));
    if (err != 0) return err;
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int qtiles = (a.na + BM - 1) / BM;
    int groups = (per_sm * sms + qtiles - 1) / qtiles;
    if (groups > chunks) groups = chunks;
    const int per_cta = (chunks + groups - 1) / groups;
    groups = (chunks + per_cta - 1) / per_cta;
    kernel<<<qtiles * groups, threads, smem, stream>>>(
        map_a, map_b, static_cast<const float*>(a.w),
        static_cast<const float*>(a.an), static_cast<const float*>(a.bn),
        a.ws, a.na, a.nb, a.d, a.p, per_cta);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return launch_reduce(a, (a.nb + BN - 1) / BN, epi, stream);
}

// ---------------------------------------------------------------------------
// bf16 / f16, the wide streamed entry: 2-CTA clusters share the support rows
// ---------------------------------------------------------------------------

// The wgmma accumulators stay in their registers across the asm
// statements around them (no copy while a wgmma is in flight).
template <int N>
__device__ __forceinline__ void fence_acc(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// CTAs of a cluster of the wide streamed entry: neighbouring query tiles.
constexpr int kClusterCtas = 2;

// The streamed tile, widened and shared. The streamed kernel above pulls
// the A tile's k-block from L2 again for every chunk of NW rows of B: at
// 4096 queries x 32768 support rows, d = 4096, bf16, NW = 64, that is
// 32 A tiles x 512 chunks x 1 MiB = 16 GiB a launch, beside 32 x 256 MiB
// = 8 GiB of B: 24 GiB through L2 for 1.1 TFLOP, whose bound is 1.11 ms
// at 989 TFLOP/s (it took 3.45 ms on an H100 SXM, PERF.md).
// This kernel takes NW = 256 (wgmma m64n256k16, 128 f32 accumulators a
// consumer thread), so the A k-block is reloaded once every 256 rows of
// B (4 GiB), and runs in clusters of kClusterCtas CTAs on neighbouring A
// tiles that walk the same chunks: each CTA loads its own A k-block and
// half of the chunk's B k-block, which TMA multicasts into both CTAs'
// rings, so each B row is pulled once a cluster (4 GiB): 8 GiB a launch
// (1.52 ms there, 73% of the bound).
// A stage is refilled only when the consumers of both CTAs have released
// it (each consumer warp arrives on the stage's empty barrier in both),
// and a producer leaves only when every stage is released, so no remote
// arrival or copy meets a CTA that has left. The consumers keep one wgmma
// group in flight (wait_group 1) and release the stage before it; a
// chunk whose columns all lie below nb takes the epilogue without masks.
// The ring (DEPTH stages of BM + NW rows x BK) takes most of an SM's
// shared memory, so the launcher sizes the grid to one wave: pairs of A
// tiles x runs of chunks, one CTA an SM. A partner tile past the last A
// tile loads the last one and writes nothing; a B half past the last row
// loads rows the column masks drop. The k-blocks, the fragment and the
// split partials are the streamed kernel's: bitwise its sums.
template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH>
__global__ void __cluster_dims__(kClusterCtas, 1, 1)
    __launch_bounds__(BM / 64 * kWarpGroup + 32, 1)
    split_wgmma_kernel_cluster(const __grid_constant__ CUtensorMap map_a,
                               const __grid_constant__ CUtensorMap map_b,
                               const float* __restrict__ w,
                               const float* __restrict__ an,
                               const float* __restrict__ bn,
                               float* __restrict__ ws, int na, int nb,
                               int d, KernelParams p, int per_cta) {
  constexpr int NW = 4 * TC;
  constexpr int CL = kClusterCtas;
  constexpr int WGS = BM / 64;
  static_assert(BM % 64 == 0 && BM <= 128 && BK == 64,
                "m64 warpgroups, k-block 64");
  static_assert(TR == 2 && NW % BN == 0 && BN % 8 == 0 && NW % (8 * CL) == 0,
                "the wgmma fragment: 2 x NW/4, whole splits a chunk");
  constexpr int ABLOCK = BM * BK * 2;     // one k-block of the A tile
  constexpr int BBLOCK = NW * BK * 2;     // one k-block of a chunk of B
  constexpr int BHALF = BBLOCK / CL;      // the part a CTA multicasts
  constexpr int STAGE = ABLOCK + BBLOCK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + DEPTH * STAGE);
  uint64_t* empty = full + DEPTH;

  const int rank = cluster_rank();
  const int nk = (d + BK - 1) / BK;
  const int qtiles = (na + BM - 1) / BM;
  const int pairs = (qtiles + CL - 1) / CL;
  const int splits = (nb + BN - 1) / BN;
  const int chunks = (nb + NW - 1) / NW;
  const int cluster = blockIdx.x / CL;
  const int qt = (cluster % pairs) * CL + rank;
  const int c0 = (cluster / pairs) * per_cta;
  const int c1 = c0 + per_cta < chunks ? c0 + per_cta : chunks;
  const int wg = threadIdx.x / kWarpGroup;

  if (threadIdx.x == 0) {
    for (int s = 0; s < DEPTH; ++s) {
      mbar_init(&full[s], 1);                    // the producer's expect_tx
      mbar_init(&empty[s], CL * WGS * 4);        // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();   // the partner's barriers exist before any copy

  if (wg == WGS) {
    if (threadIdx.x == WGS * kWarpGroup) {
      const int arow = (qt < qtiles ? qt : qtiles - 1) * BM;
      const int blast = (nb - 1) / (NW / CL) * (NW / CL);
      const auto brow = [&](int c) {
        const int r = c * NW + rank * (NW / CL);
        return r < blast ? r : blast;
      };
      int stage = 0, phase = 0;
      for (int c = c0; c < c1; ++c) {
        for (int kb = 0; kb < nk; ++kb) {
          unsigned char* st = ring + stage * STAGE;
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], STAGE);
          tma_load(st, &map_a, &full[stage], kb * BK, arow);
          tma_load_multicast(st + ABLOCK + rank * BHALF, &map_b,
                             &full[stage], kb * BK, brow(c),
                             static_cast<uint16_t>((1 << CL) - 1));
          if (++stage == DEPTH) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      for (int s = 0; s < DEPTH; ++s) {   // every stage released
        mbar_wait(&empty[stage], phase ^ 1);
        if (++stage == DEPTH) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int t = threadIdx.x % kWarpGroup;
  const int lane = t % 32;
  const int rr = (t / 32) * 16 + lane / 4;       // row in the 64-row box
  const int r0 = qt * BM + wg * 64 + rr;
  const float rn0 = r0 < na ? an[r0] : 0.0f;
  const float rn1 = r0 + 8 < na ? an[r0 + 8] : 0.0f;
  const int wg_off = wg * 64 * BK * 2;           // the warpgroup's rows
  const auto release = [&](int s) {              // in every CTA
    if (lane == 0) {
      mbar_arrive(&empty[s]);
      for (int k = 1; k < CL; ++k)
        mbar_arrive_cluster(&empty[s], (rank + k) % CL);
    }
  };
  int stage = 0, phase = 0;
  for (int c = c0; c < c1; ++c) {
    float acc[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.0f;
    int prev = -1;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(&full[stage], phase);
      const unsigned char* st = ring + stage * STAGE;
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)    // 32 bytes = 2 units a step
        Wgmma<T, NW>::mma(acc, smem_desc(st + wg_off) + 2 * kk,
                          smem_desc(st + ABLOCK) + 2 * kk);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(acc);
      if (prev >= 0) release(prev);              // its wgmma has retired
      prev = stage;
      if (++stage == DEPTH) {
        stage = 0;
        phase ^= 1;
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    if (prev >= 0) release(prev);
    if ((c + 1) * NW <= nb)
      kind_partials<NW, BN, false>(acc, rn0, rn1, bn, w, ws, na, nb,
                                   splits, c, r0, lane, p);
    else
      kind_partials<NW, BN, true>(acc, rn0, rn1, bn, w, ws, na, nb,
                                  splits, c, r0, lane, p);
  }
}

// The clusters of the wide streamed kernel the current card holds at once,
// its shared memory opted in first; asked once a card. The SMs of a GPC
// pair up: 66 on an H100 SXM's 132 SMs when all do, what
// tiling.decision_grid assumes (tiling.wide_clusters); the card's answer
// is checked against it (ops.wide_clusters).
template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH>
int split_cluster_capacity(int* most) {
  constexpr int smem =
      split_wgmma_smem_bytes<BM, 4 * TC, BK, DEPTH, true>(1);
  static_assert(smem <= kMaxSmem, "the ring exceeds shared memory");
  static bool smem_set[64] = {};
  static int most_of[64] = {};
  const auto kernel =
      split_wgmma_kernel_cluster<T, BM, BN, BK, TR, TC, DEPTH>;
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err != 0) return err;
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidValue);
  err = allow_smem(kernel, smem, smem_set);
  if (err != 0) return err;
  if (most_of[dev] == 0) {
    cudaLaunchConfig_t lc = {};
    lc.gridDim = dim3(kClusterCtas, 1, 1);
    lc.blockDim = dim3(BM / 64 * kWarpGroup + 32, 1, 1);
    lc.dynamicSmemBytes = smem;
    err = static_cast<int>(
        cudaOccupancyMaxActiveClusters(&most_of[dev], kernel, &lc));
    if (err != 0) return err;
  }
  *most = most_of[dev];
  return 0;
}

// The wide streamed entry's launch: one wave of clusters, pairs of A
// tiles x runs of chunks, one CTA an SM (the ring's shared memory allows
// no more); tiling.decision_grid mirrors it.
template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH,
          typename Epi>
int launch_split_cluster(const SplitArgs& a, const Epi& epi,
                         cudaStream_t stream) {
  constexpr int NW = 4 * TC;
  constexpr int smem = split_wgmma_smem_bytes<BM, NW, BK, DEPTH, true>(1);
  if (a.na == 0) return 0;
  const int chunks = (a.nb + NW - 1) / NW;
  if (chunks > 0) {
    if (a.d % 8 != 0 || reinterpret_cast<uintptr_t>(a.a) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(a.b) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
    const CUtensorMapDataType type = std::is_same<T, __half>::value
                                         ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    CUtensorMap map_a, map_b;
    int err = encode_map(&map_a, type, 2, a.a, a.na, a.d, BM, BK);
    if (err == 0)
      err = encode_map(&map_b, type, 2, a.b, a.nb, a.d, NW / kClusterCtas,
                       BK);
    int most = 0;
    if (err == 0)
      err = split_cluster_capacity<T, BM, BN, BK, TR, TC, DEPTH>(&most);
    if (err != 0) return err;
    if (most < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int qtiles = (a.na + BM - 1) / BM;
    const int pairs = (qtiles + kClusterCtas - 1) / kClusterCtas;
    int groups = most / pairs;
    if (groups < 1) groups = 1;
    if (groups > chunks) groups = chunks;
    const int per_cta = (chunks + groups - 1) / groups;
    groups = (chunks + per_cta - 1) / per_cta;
    constexpr int threads = BM / 64 * kWarpGroup + 32;
    const auto kernel =
        split_wgmma_kernel_cluster<T, BM, BN, BK, TR, TC, DEPTH>;
    kernel<<<kClusterCtas * pairs * groups, threads, smem, stream>>>(
        map_a, map_b, static_cast<const float*>(a.w),
        static_cast<const float*>(a.an), static_cast<const float*>(a.bn),
        a.ws, a.na, a.nb, a.d, a.p, per_cta);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return launch_reduce(a, (a.nb + BN - 1) / BN, epi, stream);
}

}  // namespace
}  // namespace repro
