// Fused SMO f-cache update:   out = f + k(X, X_sel) @ delta.
//
// Replaces the TPU kernel _fupdate_kernel / fupdate_pallas of
// src/repro/kernels/fupdate/kernel.py, which keeps the whole selected
// block resident in VMEM and walks a (m/TM, d/TK) grid in order. Here the
// selected block can be up to 2048 rows (the init pass and the warm
// reconcile): at d = 128 in f32 that is 1 MiB, far above a CTA's shared
// memory. Three classes, by the selected block's size S and the rows'
// type; the wrapper picks the entry through kernels/tiling.resolve_tiles
// (the tuned table, else its class's default).
//
// * The narrow class (S <= 32: the solver's hot loop at S = 2P = 16 or
//   32), any type. Bytes-bound (X is read once per call; 4 MiB at
//   m = 8192, d = 128 in f32, half that in 16-bit, and held in the 50 MB
//   L2 from one iteration to the next), and each CTA is short, so what it
//   pays is latency. A CTA owns BM rows of X and walks the block in BN =
//   32 chunks. Its default is the first design's tile (dot_tile,
//   kernel_rows.cuh), which loads one DK-deep chunk at a time, with scalar
//   loads widened in flight and a barrier on each side, and pays d / DK
//   load latencies in a row. Its pipelined entries (fupdate_pipe_kernel)
//   copy the rows' raw bytes with cp.async (16 bytes a copy where the
//   rows allow it), put DEPTH chunks in flight before the first computes
//   (all of them at d = 128 and DEPTH = 4: one latency a CTA), keep
//   16-bit rows 16-bit in shared memory and widen them as they are read,
//   16 bytes at a time. Their sums are the tile's: the same columns a
//   thread, the same FMA chain a dot and the same shuffle tree.
// * The wide classes (S > 32: the warm refit's hot loop at the
//   delta-scaled S = 128, its reconcile, the init pass at m = S = 2048):
//   operations-bound (2 S d flops a row of X), and at m = S = 2048 one CTA
//   a BM-row tile would leave most of the card idle while it walked the
//   block. They are decision's split design (split_rows.cuh) with A = X,
//   B = X_sel, w = delta: the block is cut into splits of SW rows spread
//   over CTAs, each split's partial per row written to a (splits, m)
//   workspace, and a second kernel adds each row's partials in split
//   order and then f (f + s, as the reference sums k(X, X_sel) @ delta
//   first). f32 rows take the pipelined SIMT tile (SW = 64, no TF32),
//   bf16/f16 rows the wgmma class (SW = 32, the X tile resident by TMA,
//   X_sel streamed in NW-row chunks; entry 13 streams the X tile too,
//   for any d).
//
// Every entry of a class gives bitwise the same output (kernels/tiling.py).
#include <cstdint>

#include "split_rows.cuh"

namespace repro {
namespace {

struct Args {
  const void *x, *xsel, *delta, *f, *xn, *seln;
  float* ws;
  void* out;
  int m, s, d;
  KernelParams p;
};

// ---------------------------------------------------------------------------
// The first design's tile (dot_tile): the narrow class's default
// ---------------------------------------------------------------------------

template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH>
__global__ void __launch_bounds__((BM / TR) * (BN / TC))
    fupdate_kernel(const T* __restrict__ x, const T* __restrict__ xsel,
                   const float* __restrict__ delta,
                   const float* __restrict__ f,
                   const float* __restrict__ xn,
                   const float* __restrict__ seln, float* __restrict__ out,
                   int m, int s, int d, KernelParams p) {
  static_assert(BK == DK && DEPTH == 1, "dot_tile stages DK, one stage");
  constexpr int NTY = BM / TR;
  constexpr int NTX = BN / TC;
  const int row0 = blockIdx.x * BM;
  float part[TR];
  weighted_row_sums<T, BM, BN, TR, TC>(x, xsel, xn, seln, delta, m, s, d, p,
                                       row0, part);
  if (threadIdx.x % NTX == 0) {
    const int ty = threadIdx.x / NTX;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = row0 + ty + i * NTY;
      if (r < m) out[r] = f[r] + part[i];
    }
  }
}

template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH>
int launch_tile(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.m + BM - 1) / BM);
  constexpr int threads = (BM / TR) * (BN / TC);
  fupdate_kernel<T, BM, BN, BK, TR, TC, DEPTH><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.xsel),
      static_cast<const float*>(a.delta), static_cast<const float*>(a.f),
      static_cast<const float*>(a.xn), static_cast<const float*>(a.seln),
      static_cast<float*>(a.out), a.m, a.s, a.d, a.p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The pipelined narrow entries
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [base, base + R) x features [k0, k0 + BK) of src (rows x d) as raw
// bytes into dst, a row every ROW bytes, 0 outside the matrix. The copy
// unit is `w` bytes (2^lgu units a row of the chunk): 16 or 4 by
// cp.async (zero-filled when outside), 2 by a plain load and store for
// 16-bit rows of odd d. A unit lies wholly inside or outside the matrix,
// since the host takes w only where d * sizeof(T) is a multiple of it.
template <typename T, int R, int BK, int ROW, int NT>
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           const T* __restrict__ src,
                                           int rows, int d, int base, int k0,
                                           int w, int lgu) {
  const int mask = (1 << lgu) - 1;
  for (int u = threadIdx.x; u < (R << lgu); u += NT) {
    const int r = u >> lgu;
    const int b = (u & mask) * w;                  // byte in the chunk row
    const int gr = base + r;
    const int gk = k0 + b / static_cast<int>(sizeof(T));
    const bool ok = gr < rows && gk < d;
    const T* g = ok ? src + static_cast<size_t>(gr) * d + gk : src;
    unsigned char* s = dst + r * ROW + b;
    if (w == 16) {
      cp_async16(s, g, ok);
    } else if (w == 4) {
      cp_async4(s, g, ok);
    } else {
      *reinterpret_cast<uint16_t*>(s) =
          ok ? *reinterpret_cast<const uint16_t*>(g) : uint16_t{0};
    }
  }
}

// The 16 / sizeof(T) values at p (16-byte aligned shared memory) in f32.
template <typename T>
__device__ __forceinline__ void widen16(const unsigned char* p,
                                        float (&o)[16 / sizeof(T)]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int v = 0; v < static_cast<int>(16 / sizeof(T)); ++v)
    o[v] = widen(e[v]);
}

// dot_tile's thread layout and sums (rows ty + i * NTY, columns
// tx + j * NTX, each dot one FMA chain over the features in order, the
// epilogue and the shuffle tree of weighted_row_sums) on operands staged
// as raw bytes in a ring of DEPTH BK-deep chunks of dynamic shared
// memory. Rows are ROW = BK * sizeof(T) + 16 bytes apart: 16-byte aligned
// for cp.async and the 16-byte reads, and 8 consecutive rows' reads fall
// in disjoint banks.
template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH>
__global__ void __launch_bounds__((BM / TR) * (BN / TC))
    fupdate_pipe_kernel(const T* __restrict__ x, const T* __restrict__ xsel,
                        const float* __restrict__ delta,
                        const float* __restrict__ f,
                        const float* __restrict__ xn,
                        const float* __restrict__ seln,
                        float* __restrict__ out, int m, int s, int d,
                        KernelParams p, int w, int lgu) {
  constexpr int NTY = BM / TR;
  constexpr int NTX = BN / TC;
  constexpr int NT = NTY * NTX;
  constexpr int V = 16 / sizeof(T);               // values a 16-byte read
  constexpr int ROW = BK * sizeof(T) + 16;
  constexpr int STAGE = (BM + BN) * ROW;
  static_assert(NTX <= 32 && (32 % NTX) == 0,
                "a row's threads must sit in one warp");
  static_assert(NT % 32 == 0 && BK % V == 0, "whole warps, whole reads");
  extern __shared__ __align__(16) unsigned char ring[];

  const int tx = threadIdx.x % NTX;
  const int ty = threadIdx.x / NTX;
  const int row0 = blockIdx.x * BM;
  const int nk = (d + BK - 1) / BK;

  float rn[TR], part[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = row0 + ty + i * NTY;
    rn[i] = r < m ? xn[r] : 0.0f;
    part[i] = 0.0f;
  }

  for (int n0 = 0; n0 < s; n0 += BN) {
    // DEPTH chunks in flight before the first computes; a commit group a
    // chunk (empty past the last), so chunk c is in once DEPTH - 1 groups
    // at most are pending.
#pragma unroll
    for (int c = 0; c < DEPTH; ++c) {
      if (c < nk) {
        unsigned char* st = ring + c * STAGE;
        stage_rows<T, BM, BK, ROW, NT>(st, x, m, d, row0, c * BK, w, lgu);
        stage_rows<T, BN, BK, ROW, NT>(st + BM * ROW, xsel, s, d, n0, c * BK,
                                       w, lgu);
      }
      cp_async_commit();
    }
    float acc[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[i][j] = 0.0f;

    for (int c = 0; c < nk; ++c) {
      cp_async_wait<DEPTH - 1>();
      __syncthreads();
      const unsigned char* xs = ring + (c % DEPTH) * STAGE;
      const unsigned char* bs = xs + BM * ROW;
#pragma unroll
      for (int k = 0; k < BK; k += V) {
        float a[TR][V], b[TC][V];
#pragma unroll
        for (int i = 0; i < TR; ++i)
          widen16<T>(xs + (ty + i * NTY) * ROW + k * sizeof(T), a[i]);
#pragma unroll
        for (int j = 0; j < TC; ++j)
          widen16<T>(bs + (tx + j * NTX) * ROW + k * sizeof(T), b[j]);
#pragma unroll
        for (int v = 0; v < V; ++v)
#pragma unroll
          for (int i = 0; i < TR; ++i)
#pragma unroll
            for (int j = 0; j < TC; ++j)
              acc[i][j] = fmaf(a[i][v], b[j][v], acc[i][j]);
      }
      __syncthreads();          // the stage is free for chunk c + DEPTH
      if (c + DEPTH < nk) {
        unsigned char* st = ring + (c % DEPTH) * STAGE;
        stage_rows<T, BM, BK, ROW, NT>(st, x, m, d, row0, (c + DEPTH) * BK,
                                       w, lgu);
        stage_rows<T, BN, BK, ROW, NT>(st + BM * ROW, xsel, s, d, n0,
                                       (c + DEPTH) * BK, w, lgu);
      }
      cp_async_commit();
    }
    add_weighted<TR, TC, NTX>(acc, rn, seln, delta, s, n0, tx, p, part);
  }
  reduce_row<TR, NTX>(part);

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = row0 + ty + i * NTY;
      if (r < m) out[r] = f[r] + part[i];
    }
  }
}

template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH>
int launch_pipe(const Args& a, cudaStream_t stream) {
  constexpr int smem = DEPTH * (BM + BN) * (BK * sizeof(T) + 16);
  static_assert(smem <= kMaxSmem, "the ring exceeds shared memory");
  // The widest copy the rows' alignment allows: 16 bytes, else 4, else 2
  // (16-bit rows of odd d).
  const auto fits = [&](uintptr_t w) {
    return reinterpret_cast<uintptr_t>(a.x) % w == 0 &&
           reinterpret_cast<uintptr_t>(a.xsel) % w == 0 &&
           (static_cast<uintptr_t>(a.d) * sizeof(T)) % w == 0;
  };
  const int w = fits(16) ? 16 : fits(4) ? 4 : 2;
  int lgu = 0;
  while ((w << lgu) < BK * static_cast<int>(sizeof(T))) ++lgu;
  static bool smem_set[64] = {};
  const auto kernel = fupdate_pipe_kernel<T, BM, BN, BK, TR, TC, DEPTH>;
  const int err = allow_smem(kernel, smem, smem_set);
  if (err != 0) return err;
  const dim3 grid((a.m + BM - 1) / BM);
  constexpr int threads = (BM / TR) * (BN / TC);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.xsel),
      static_cast<const float*>(a.delta), static_cast<const float*>(a.f),
      static_cast<const float*>(a.xn), static_cast<const float*>(a.seln),
      static_cast<float*>(a.out), a.m, a.s, a.d, a.p, w, lgu);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The wide classes: split_rows.cuh's kernels, f + s as the epilogue
// ---------------------------------------------------------------------------

SplitArgs split_args(const Args& a) {
  return SplitArgs{a.x, a.xsel, a.delta, a.xn, a.seln, a.ws,
                   a.m, a.s, a.d, a.p};
}

AddToF add_to_f(const Args& a) {
  return AddToF{static_cast<const float*>(a.f), static_cast<float*>(a.out)};
}

template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH>
int launch_simt(const Args& a, cudaStream_t st) {
  return launch_split_simt<T, BM, BN, BK, TR, TC, DEPTH>(
      split_args(a), add_to_f(a), st);
}

template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH>
int launch_wgmma(const Args& a, cudaStream_t st) {
  return launch_split_wgmma<T, BM, BN, BK, TR, TC, DEPTH, false>(
      split_args(a), add_to_f(a), st);
}

template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH>
int launch_stream(const Args& a, cudaStream_t st) {
  return launch_split_wgmma<T, BM, BN, BK, TR, TC, DEPTH, true>(
      split_args(a), add_to_f(a), st);
}

// The menu: launch index -> <BM, BN, BK, TR, TC, DEPTH>, in the order of
// MENUS["fupdate"] in kernels/tiling.py (tests read these lines). Each
// class fixes what sets its sums' order, so every entry of a class
// sums each row in the same order:
//
// * narrow (S <= 32), every type: BN = 32, TC = 2 (one column chunk).
//   Entry 0 (64 rows per CTA, the first design's tile) is its default;
//   entries 2-4 are its pipelined ones, each the winner of a cell of the
//   full sweep on an H100 (PERF.md);
// * wide f32 (S > 32): the SIMT split tile, SW = BN = 64, TC = 8; entry 5
//   is its default;
// * wide bf16/f16 (S > 32): the wgmma split kernel, SW = BN = 32,
//   NW = 4 * TC; entry 9 is its default, entry 13 streams the X tile.
//
// Each switch is compiled for its class's types only; an index of
// another class is refused with cudaErrorInvalidValue.
template <typename T>
int launch_narrow(int cfg, const Args& a, cudaStream_t st) {
  switch (cfg) {
    case 0: return launch_tile<T, 64, 32, 32, 4, 2, 1>(a, st);
    case 1: return launch_tile<T, 16, 32, 32, 1, 2, 1>(a, st);
    case 2: return launch_pipe<T, 64, 32, 32, 4, 2, 4>(a, st);
    case 3: return launch_pipe<T, 32, 32, 32, 2, 2, 4>(a, st);
    case 4: return launch_pipe<T, 16, 32, 32, 1, 2, 4>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The first index of the wide classes.
constexpr int kWide = 5;

template <typename T>
int launch_f32(int cfg, const Args& a, cudaStream_t st) {
  switch (cfg) {
    case 5: return launch_simt<T, 64, 64, 8, 4, 8, 2>(a, st);
    case 6: return launch_simt<T, 128, 64, 8, 8, 8, 2>(a, st);
    case 7: return launch_simt<T, 32, 64, 8, 4, 8, 2>(a, st);
    case 8: return launch_simt<T, 16, 64, 8, 4, 8, 2>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_16bit(int cfg, const Args& a, cudaStream_t st) {
  switch (cfg) {
    case 9: return launch_wgmma<T, 128, 32, 64, 2, 8, 4>(a, st);
    case 10: return launch_wgmma<T, 64, 32, 64, 2, 8, 4>(a, st);
    case 11: return launch_wgmma<T, 128, 32, 64, 2, 16, 4>(a, st);
    case 12: return launch_wgmma<T, 128, 32, 64, 2, 32, 4>(a, st);
    case 13: return launch_stream<T, 128, 32, 64, 2, 16, 3>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro

// x (m, d) and xsel (s, d) row-major in `dtype` (0 f32, 1 bf16, 2 f16;
// for the 16-bit wide class d % 8 == 0 and both 16-byte aligned);
// delta (s,), f (m,), xn (m,), seln (s,) and out (m,) f32; ws an f32
// workspace of (splits, m) with splits = ceil(s / BN) for the wide
// classes (unread by the narrow one; may be null); `cfg` the index of a
// menu entry of the launch's class. Launches on `stream`, which must
// belong to the caller's current device, and returns cudaGetLastError();
// launching nothing, cudaErrorInvalidValue for an unknown dtype or menu
// index, a TMA map cuTensorMapEncodeTiled refuses or a resident 16-bit X
// tile too wide for shared memory (tiling.wgmma_fits),
// cudaErrorMisalignedAddress for 16-bit rows TMA cannot read and
// cudaErrorNotSupported when cuTensorMapEncodeTiled is not found.
extern "C" int fupdate_launch(const void* x, const void* xsel,
                              const void* delta, const void* f,
                              const void* xn, const void* seln, void* ws,
                              void* out, int m, int s, int d, int dtype,
                              int kind, float gamma, float coef0, int degree,
                              int cfg, void* stream) {
  using namespace repro;
  const Args a{x, xsel, delta, f, xn, seln, static_cast<float*>(ws), out,
               m, s, d, KernelParams{kind, gamma, coef0, degree}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return cfg < kWide ? launch_narrow<float>(cfg, a, st)
                         : launch_f32<float>(cfg, a, st);
    case kBF16:
      return cfg < kWide ? launch_narrow<__nv_bfloat16>(cfg, a, st)
                         : launch_16bit<__nv_bfloat16>(cfg, a, st);
    case kF16:
      return cfg < kWide ? launch_narrow<__half>(cfg, a, st)
                         : launch_16bit<__half>(cfg, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* fupdate_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
