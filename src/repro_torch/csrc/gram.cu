// Kernel matrix:   out[i, j] = k(x_i, y_j),   out (m, n) f32.
//
// Replaces the TPU kernel _gram_kernel / gram_pallas of
// src/repro/kernels/gram/kernel.py, which walks an (M/TM, N/TN, D/TK)
// grid with the feature axis innermost, sums each (TM, TN) output tile in
// VMEM across the feature steps and runs the epilogue on the last one,
// on inputs padded to 128-multiples. Here each CTA owns whole output
// tiles, walks all the features itself and runs the epilogue on the
// finished dot products before the one store: no cross-CTA reduction, no
// pass over the output but the one store.
//
// Numerics, as the reference: f32 norms of the rounded rows (made by the
// wrapper), f32 dot products, the rbf / poly / linear epilogue with the
// reference's rounding steps (kernel_rows.cuh).
//
// What bounds it on an H100: 2*d flops per output against 4 bytes of
// output written (d = 128: 64 flop per byte). In f32 that is
// operations-bound (8192 x 8192 x 128: 17.2 GFLOP, 0.256 ms at
// 67 TFLOP/s, against 268 MB of output, 0.080 ms at 3.35 TB/s); with
// 16-bit rows on the tensor cores (989 TFLOP/s) it is bound by the
// output's bytes. Two classes of launches, by the rows' type:
//
// * f32 (SIMT, CUDA cores): no TF32, as the reference's f32 is true f32.
//   gram_simt_kernel is a pipelined 128-row tile: float4 global loads
//   into registers while the previous feature chunk computes (two
//   shared-memory stages), 8 x 8 outputs a thread read as float4s from
//   shared memory, float4 stores. gram_kernel is the first design's
//   tile on the shared dot_tile (kernel_rows.cuh), kept as the class's
//   default and oracle. Each output of either is one thread's
//   sequential FMA chain over the features in order, so every f32 entry
//   gives bitwise the same matrix.
// * bf16 / f16 (wgmma, tensor cores): gram_wgmma_kernel, a persistent
//   grid (one CTA per SM walking output tiles) with one producer thread
//   keeping TMA loads (128-byte swizzle, BK = 64 features: one swizzle
//   row) in a ring of DEPTH shared-memory stages signalled by mbarriers,
//   and two consumer warpgroups each running wgmma.m64nBNk16 with f32
//   accumulators in registers on 64 of the tile's 128 rows. The epilogue
//   runs on the accumulator fragments, its kind dispatched once a tile
//   (a per-value dispatch made it twice as slow), and goes out through
//   swizzled shared memory by TMA stores, two 64-column chunks a
//   warpgroup in flight, while the producer already loads the next
//   tile's stages; rows whose f32 stride is no multiple of 16 bytes
//   (n % 4 != 0) are stored directly instead. Rows past M or N read as
//   TMA's zero fill and are not stored; the wrapper pads the features to
//   a multiple of 8 (TMA's 16-byte row stride) with zeros, which add
//   exactly nothing. Each output is the tensor cores' sum over k16 steps
//   in feature order, whatever BN or DEPTH.
#include <cuda.h>   // CUtensorMap (the encoder is found at run time)

#include <cstdint>
#include <type_traits>

#include "kernel_rows.cuh"

namespace repro {
namespace {

struct Args {
  const void *x, *y, *xn, *yn;
  void* out;
  int m, n, d;
  KernelParams p;
};

// ---------------------------------------------------------------------------
// f32, the first design's tile (dot_tile): the class's default
// ---------------------------------------------------------------------------

template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH>
__global__ void __launch_bounds__((BM / TR) * (BN / TC))
    gram_kernel(const T* __restrict__ x, const T* __restrict__ y,
                const float* __restrict__ xn, const float* __restrict__ yn,
                float* __restrict__ out, int m, int n, int d,
                KernelParams p) {
  static_assert(BK == DK && DEPTH == 1, "dot_tile stages DK, one stage");
  constexpr int NTY = BM / TR;
  constexpr int NTX = BN / TC;
  static_assert((NTY * NTX) % 32 == 0, "whole warps only");
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  float acc[TR][TC];
  dot_tile<T, BM, BN, TR, TC>(x, y, m, n, d, row0, col0, acc);

  const int tx = threadIdx.x % NTX;
  const int ty = threadIdx.x / NTX;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = row0 + ty + i * NTY;
    if (r >= m) continue;
    const float rn = xn[r];
    float* row = out + static_cast<size_t>(r) * n;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int c = col0 + tx + j * NTX;
      if (c < n) row[c] = epilogue(acc[i][j], rn, yn[c], p);
    }
  }
}

template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH>
int launch_tile(const Args& a, cudaStream_t stream) {
  // Column tiles on x (up to 2^31 - 1), row tiles on y (up to 65535).
  const dim3 grid((a.n + BN - 1) / BN, (a.m + BM - 1) / BM);
  constexpr int threads = (BM / TR) * (BN / TC);
  gram_kernel<T, BM, BN, BK, TR, TC, DEPTH><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.y),
      static_cast<const float*>(a.xn), static_cast<const float*>(a.yn),
      static_cast<float*>(a.out), a.m, a.n, a.d, a.p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32, the pipelined SIMT tile
// ---------------------------------------------------------------------------

// Rows [base, base + R) x features [k0, k0 + BK) of src (rows x d) as
// float4s, L a thread, 0 outside the matrix; `vec`: d % 4 == 0 and src
// 16-byte aligned, so a float4 is wholly inside or outside.
template <int BK, int L, int NT>
__device__ __forceinline__ void fetch_chunk(const float* __restrict__ src,
                                            int rows, int d, int base,
                                            int k0, bool vec,
                                            float4 (&r)[L]) {
  constexpr int Q = BK / 4;   // float4s in a row of the chunk
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int u = threadIdx.x + l * NT;
    const int gr = base + u / Q;
    const int gk = k0 + (u % Q) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (gr < rows) {
      const float* s = src + static_cast<size_t>(gr) * d + gk;
      if (vec) {
        if (gk < d) v = __ldg(reinterpret_cast<const float4*>(s));
      } else {
        if (gk < d) v.x = __ldg(s);
        if (gk + 1 < d) v.y = __ldg(s + 1);
        if (gk + 2 < d) v.z = __ldg(s + 2);
        if (gk + 3 < d) v.w = __ldg(s + 3);
      }
    }
    r[l] = v;
  }
}

// The fetched float4s, transposed into dst[k][row].
template <int BK, int L, int NT, int LD>
__device__ __forceinline__ void stash_chunk(float (*dst)[LD],
                                            const float4 (&r)[L]) {
  constexpr int Q = BK / 4;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int u = threadIdx.x + l * NT;
    const int row = u / Q;
    const int k = (u % Q) * 4;
    dst[k][row] = r[l].x;
    dst[k + 1][row] = r[l].y;
    dst[k + 2][row] = r[l].z;
    dst[k + 3][row] = r[l].w;
  }
}

// Thread (ty, tx) owns rows ty*4 + i and BM/2 + ty*4 + i (i < 4) and the
// same pattern of columns, so its operands and its outputs are float4s.
template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH>
__global__ void __launch_bounds__((BM / TR) * (BN / TC))
    gram_simt_kernel(const float* __restrict__ x,
                     const float* __restrict__ y,
                     const float* __restrict__ xn,
                     const float* __restrict__ yn, float* __restrict__ out,
                     int m, int n, int d, KernelParams p, int vec_in,
                     int vec_out) {
  static_assert(std::is_same<T, float>::value, "the SIMT class is f32");
  static_assert(TR == 8 && TC == 8, "two float4s of rows and of columns");
  static_assert(DEPTH == 2, "register-staged double buffering");
  constexpr int NTY = BM / TR;
  constexpr int NTX = BN / TC;
  constexpr int NT = NTY * NTX;
  constexpr int LA = BM * BK / (4 * NT);
  constexpr int LB = BN * BK / (4 * NT);
  static_assert(LA * 4 * NT == BM * BK && LB * 4 * NT == BN * BK,
                "each thread fetches whole float4s");
  // +4 columns: rows stay 16-byte aligned, transposed stores spread.
  __shared__ __align__(16) float As[2][BK][BM + 4];
  __shared__ __align__(16) float Bs[2][BK][BN + 4];

  const int tx = threadIdx.x % NTX;
  const int ty = threadIdx.x / NTX;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int nk = (d + BK - 1) / BK;

  float acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.0f;

  float4 ra[LA], rb[LB];
  fetch_chunk<BK, LA, NT>(x, m, d, row0, 0, vec_in, ra);
  fetch_chunk<BK, LB, NT>(y, n, d, col0, 0, vec_in, rb);
  stash_chunk<BK, LA, NT>(As[0], ra);
  stash_chunk<BK, LB, NT>(Bs[0], rb);
  __syncthreads();

  for (int c = 0; c < nk; ++c) {
    const int cur = c & 1;
    const bool more = c + 1 < nk;
    if (more) {      // chunk c + 1 in flight while chunk c computes
      fetch_chunk<BK, LA, NT>(x, m, d, row0, (c + 1) * BK, vec_in, ra);
      fetch_chunk<BK, LB, NT>(y, n, d, col0, (c + 1) * BK, vec_in, rb);
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[cur][k][BM / 2 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[cur][k][BN / 2 + tx * 4]);
      const float a[TR] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
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

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
    if (r >= m) continue;
    const float rn = xn[r];
    float* row = out + static_cast<size_t>(r) * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + h * (BN / 2) + tx * 4;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = c + e < n ? epilogue(acc[i][h * 4 + e], rn, yn[c + e], p)
                         : 0.0f;
      if (vec_out && c + 3 < n) {
        *reinterpret_cast<float4*>(row + c) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < n) row[c + e] = v[e];
      }
    }
  }
}

template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH>
int launch_simt(const Args& a, cudaStream_t stream) {
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  const int vec_in = a.d % 4 == 0 && aligned(a.x) && aligned(a.y);
  const int vec_out = a.n % 4 == 0 && aligned(a.out);
  const dim3 grid((a.n + BN - 1) / BN, (a.m + BM - 1) / BM);
  constexpr int threads = (BM / TR) * (BN / TC);
  gram_simt_kernel<T, BM, BN, BK, TR, TC, DEPTH><<<grid, threads, 0,
                                                   stream>>>(
      static_cast<const float*>(a.x), static_cast<const float*>(a.y),
      static_cast<const float*>(a.xn), static_cast<const float*>(a.yn),
      static_cast<float*>(a.out), a.m, a.n, a.d, a.p, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 / f16: wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int kWarpGroup = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Returns once the phase of parity `parity` of `bar` has completed. A
// wait that outlasts 2^24 tries (seconds; a real one takes microseconds)
// traps, so a broken ring fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0, tries = 0;
  do {
    if (++tries == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// A 2-D TMA tile load of the box at (c0 = feature, c1 = row) into dst,
// completing its bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// A 2-D TMA tile store of the box at src to (c0 = column, c1 = row), in
// the thread's bulk group; rows and columns outside the matrix are not
// written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until at most N of the thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Until all of the thread's bulk groups are complete.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The generic-proxy writes to shared memory before it, seen by TMA.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier of the 128 threads of one warpgroup (ids 1, 2: 0 is
// __syncthreads's).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// wgmma's descriptor of a K-major tile written by TMA with 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(const void* ptr) {
  const uint64_t addr = smem_u32(ptr);
  return ((addr & 0x3FFFF) >> 4)             // start address, 16-byte units
         | (uint64_t{1} << 16)               // leading offset (unused here)
         | (uint64_t{1024 >> 4} << 32)       // stride offset: 8 rows
         | (uint64_t{1} << 62);              // 128-byte swizzle
}

// The accumulator operands of wgmma m64nNk16 (N / 2 f32 a thread).
#define REPRO_REGS128 \
  "{" "%0," "%1," "%2," "%3," "%4," "%5," "%6," "%7," "%8," "%9," "%10," "%11," \
  "%12," "%13," "%14," "%15," "%16," "%17," "%18," "%19," "%20," "%21," "%22," "%23," \
  "%24," "%25," "%26," "%27," "%28," "%29," "%30," "%31," "%32," "%33," "%34," "%35," \
  "%36," "%37," "%38," "%39," "%40," "%41," "%42," "%43," "%44," "%45," "%46," "%47," \
  "%48," "%49," "%50," "%51," "%52," "%53," "%54," "%55," "%56," "%57," "%58," "%59," \
  "%60," "%61," "%62," "%63" "}"
#define REPRO_ACC128 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
  "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
  "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define REPRO_REGS256 \
  "{" "%0," "%1," "%2," "%3," "%4," "%5," "%6," "%7," "%8," "%9," "%10," "%11," \
  "%12," "%13," "%14," "%15," "%16," "%17," "%18," "%19," "%20," "%21," "%22," "%23," \
  "%24," "%25," "%26," "%27," "%28," "%29," "%30," "%31," "%32," "%33," "%34," "%35," \
  "%36," "%37," "%38," "%39," "%40," "%41," "%42," "%43," "%44," "%45," "%46," "%47," \
  "%48," "%49," "%50," "%51," "%52," "%53," "%54," "%55," "%56," "%57," "%58," "%59," \
  "%60," "%61," "%62," "%63," "%64," "%65," "%66," "%67," "%68," "%69," "%70," "%71," \
  "%72," "%73," "%74," "%75," "%76," "%77," "%78," "%79," "%80," "%81," "%82," "%83," \
  "%84," "%85," "%86," "%87," "%88," "%89," "%90," "%91," "%92," "%93," "%94," "%95," \
  "%96," "%97," "%98," "%99," "%100," "%101," "%102," "%103," "%104," "%105," "%106," "%107," \
  "%108," "%109," "%110," "%111," "%112," "%113," "%114," "%115," "%116," "%117," "%118," "%119," \
  "%120," "%121," "%122," "%123," "%124," "%125," "%126," "%127" "}"
#define REPRO_ACC256 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
  "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
  "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), \
  "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), \
  "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
  "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), \
  "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
  "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), \
  "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
  "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), \
  "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), \
  "+f"(d[126]), "+f"(d[127])

// d (N / 2 f32 a thread) += A (64 x 16, descriptor da) B^T (N x 16, db),
// both K-major in shared memory.
template <typename T, int N>
struct Wgmma;

// scale-d is the predicate p, set: d += A B^T (the accumulators start at 0).
#define REPRO_WGMMA(N, TY, REGS, ACC, IA, IB, IS)                           \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"          \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY \
               " " REGS ", %" #IA ", %" #IB ", p, 1, 1, 0, 0;\n}\n"       \
               : ACC                                                        \
               : "l"(da), "l"(db), "r"(1))

template <>
struct Wgmma<__nv_bfloat16, 128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    REPRO_WGMMA(128, "bf16", REPRO_REGS128, REPRO_ACC128, 64, 65, 66);
  }
};
template <>
struct Wgmma<__half, 128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    REPRO_WGMMA(128, "f16", REPRO_REGS128, REPRO_ACC128, 64, 65, 66);
  }
};
template <>
struct Wgmma<__nv_bfloat16, 256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da,
                                             uint64_t db) {
    REPRO_WGMMA(256, "bf16", REPRO_REGS256, REPRO_ACC256, 128, 129, 130);
  }
};
template <>
struct Wgmma<__half, 256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da,
                                             uint64_t db) {
    REPRO_WGMMA(256, "f16", REPRO_REGS256, REPRO_ACC256, 128, 129, 130);
  }
};

// The output goes out through shared memory in chunks of 64 rows (one
// consumer warpgroup's) x 64 f32 columns: two TMA boxes of 32 columns (one
// 128-byte swizzle row each). A warpgroup has two chunk buffers, one
// stored by TMA while the other is written.
constexpr int kOutBox = 64 * 128;
constexpr int kOutChunk = 2 * kOutBox;

// Bytes of one ring stage (a BM x BK tile of x and a BN x BK tile of y)
// and of the kernel's dynamic shared memory (the ring, four output
// chunks, two tiles' column norms, 1024 bytes of slack to align the ring
// for the swizzle, and a full and an empty barrier a stage).
template <int BM, int BN, int BK>
__host__ __device__ constexpr int wgmma_stage_bytes() {
  return (BM + BN) * BK * 2;
}
template <int BM, int BN, int BK, int DEPTH>
__host__ __device__ constexpr int wgmma_smem_bytes() {
  return DEPTH * wgmma_stage_bytes<BM, BN, BK>() + 4 * kOutChunk +
         2 * BN * 4 + 1024 + 16 * DEPTH;
}

// out[r, c], out[r, c + 1] of an (m, n) matrix, inside it only; as one
// 8-byte store when `vec` (n even, so every row starts 8-byte aligned).
__device__ __forceinline__ void store2(float* __restrict__ out, int m,
                                       int n, int r, int c, float v0,
                                       float v1, bool vec) {
  if (r >= m) return;
  float* o = out + static_cast<size_t>(r) * n + c;
  if (vec && c + 1 < n) {
    *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
  } else {
    if (c < n) o[0] = v0;
    if (c + 1 < n) o[1] = v1;
  }
}

// Where one consumer warpgroup's 64 x BN block of a tile goes: the
// output (by TMA through the warpgroup's two chunk buffers when `tma`,
// else by direct stores), the tile's column norms in shared memory, and
// the thread's place: its rows row0 + rr and row0 + rr + 8, norms rn0 and
// rn1.
struct OutTile {
  float* out;
  const CUtensorMap* map;
  unsigned char* chunks;
  const float* cns;
  int m, n, row0, col0, wg, t, lane, rr;
  float rn0, rn1;
  bool tma, vec;
};

// The epilogue of a consumer's accumulators, the kind fixed. Fragment:
// acc[4j + h] is row rr (+ 8 for h >= 2), column 8j + 2*(lane % 4) + h % 2.
template <int KIND, int BN>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2],
                                           const OutTile& o,
                                           const KernelParams& p) {
  const int rr = o.rr, lane = o.lane;
  if (o.tma) {
#pragma unroll
    for (int q = 0; q < BN / 64; ++q) {           // a 64-column chunk
      unsigned char* chunk = o.chunks + (2 * o.wg + (q & 1)) * kOutChunk;
      if (o.t == 0) bulk_wait_read<1>();          // its last store has read
      warpgroup_sync(1 + o.wg);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * q + jj;
        const int cc = 8 * j + 2 * (lane % 4);    // column in the tile
        const float cn0 = o.cns[cc], cn1 = o.cns[cc + 1];
        // Box jj / 4; its 16-byte unit u of a 128-byte row lies at
        // u ^ (row % 8).
        unsigned char* box = chunk + (jj / 4) * kOutBox;
        const int u = 2 * (jj % 4) + (lane % 4) / 2;
        const int at = ((u ^ (rr & 7)) << 4) + (lane % 2) * 8;
        *reinterpret_cast<float2*>(box + rr * 128 + at) =
            make_float2(kernel_value<KIND>(acc[4 * j], o.rn0, cn0, p),
                        kernel_value<KIND>(acc[4 * j + 1], o.rn0, cn1, p));
        *reinterpret_cast<float2*>(box + (rr + 8) * 128 + at) =
            make_float2(kernel_value<KIND>(acc[4 * j + 2], o.rn1, cn0, p),
                        kernel_value<KIND>(acc[4 * j + 3], o.rn1, cn1, p));
      }
      fence_async_shared();
      warpgroup_sync(1 + o.wg);
      if (o.t == 0) {
        const int c0 = o.col0 + 64 * q;
        tma_store(o.map, chunk, c0, o.row0);
        tma_store(o.map, chunk + kOutBox, c0 + 32, o.row0);
        bulk_commit();
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int cc = 8 * j + 2 * (lane % 4);
      const int c = o.col0 + cc;
      const float cn0 = o.cns[cc], cn1 = o.cns[cc + 1];
      store2(o.out, o.m, o.n, o.row0 + rr, c,
             kernel_value<KIND>(acc[4 * j], o.rn0, cn0, p),
             kernel_value<KIND>(acc[4 * j + 1], o.rn0, cn1, p), o.vec);
      store2(o.out, o.m, o.n, o.row0 + rr + 8, c,
             kernel_value<KIND>(acc[4 * j + 2], o.rn1, cn0, p),
             kernel_value<KIND>(acc[4 * j + 3], o.rn1, cn1, p), o.vec);
    }
  }
}

// Threads 0-255: the two consumer warpgroups (rows 0-63 and 64-127 of the
// tile); warpgroup 2: the producer, whose first thread issues every TMA
// load. Tiles are walked in row-major order, tile blockIdx.x first, then
// every gridDim.x-th.
template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH>
__global__ void __launch_bounds__(3 * kWarpGroup, 1)
    gram_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_y,
                      const __grid_constant__ CUtensorMap map_out,
                      const float* __restrict__ xn,
                      const float* __restrict__ yn, float* __restrict__ out,
                      int m, int n, int d, KernelParams p, int tma_out) {
  static_assert(BM == 2 * 64 && BK == 64, "two m64 warpgroups, k-block 64");
  static_assert(TR == 2 && TC == BN / 4, "the wgmma fragment: 2 x BN/4");
  constexpr int STAGE = wgmma_stage_bytes<BM, BN, BK>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  unsigned char* chunks = ring + DEPTH * STAGE;
  float* col_norms = reinterpret_cast<float*>(chunks + 4 * kOutChunk);
  uint64_t* full = reinterpret_cast<uint64_t*>(col_norms + 2 * BN);
  uint64_t* empty = full + DEPTH;

  const int tiles_n = (n + BN - 1) / BN;
  const int tiles = ((m + BM - 1) / BM) * tiles_n;
  const int nk = (d + BK - 1) / BK;
  const int wg = threadIdx.x / kWarpGroup;

  if (threadIdx.x == 0) {
    for (int s = 0; s < DEPTH; ++s) {
      mbar_init(&full[s], 1);                  // the producer's expect_tx
      mbar_init(&empty[s], 2 * kWarpGroup);    // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    if (threadIdx.x == 2 * kWarpGroup) {
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int tm = tile / tiles_n, tn = tile % tiles_n;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* a = ring + stage * STAGE;
          mbar_expect_tx(&full[stage], STAGE);   // out-of-bounds fill counts
          tma_load(a, &map_x, &full[stage], kb * BK, tm * BM);
          tma_load(a + BM * BK * 2, &map_y, &full[stage], kb * BK, tn * BN);
          if (++stage == DEPTH) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  static_assert(BN <= 2 * kWarpGroup, "a column norm a consumer thread");
  const int t = threadIdx.x % kWarpGroup;
  const int warp = t / 32, lane = t % 32;
  const int rr = warp * 16 + lane / 4;            // row in the 64-row box
  const bool vec = n % 2 == 0;
  int stage = 0, phase = 0, parity = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, parity ^= 1) {
    const int tm = tile / tiles_n, tn = tile % tiles_n;
    // The tile's norms, loaded before the mainloop so that their latency
    // hides behind it; the column norms go through shared memory (one
    // each for the 256 consumer threads, two tiles' buffers).
    const int row0 = tm * BM + wg * 64;
    const float rn0 = row0 + rr < m ? xn[row0 + rr] : 0.0f;
    const float rn1 = row0 + rr + 8 < m ? xn[row0 + rr + 8] : 0.0f;
    const int cj = tn * BN + threadIdx.x;
    const float my_cn = threadIdx.x < BN && cj < n ? yn[cj] : 0.0f;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(&full[stage], phase);
      const unsigned char* a = ring + stage * STAGE + wg * 64 * BK * 2;
      const unsigned char* b = ring + stage * STAGE + BM * BK * 2;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)    // 32 bytes = 2 units a step
        Wgmma<T, BN>::mma(acc, smem_desc(a) + 2 * kk, smem_desc(b) + 2 * kk);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      mbar_arrive(&empty[stage]);
      if (++stage == DEPTH) {
        stage = 0;
        phase ^= 1;
      }
    }

    // The column norms of this tile: written, then seen by both consumer
    // warpgroups (named barrier 3, 256 threads). The buffer alternates by
    // tile, and no warpgroup passes this barrier twice before the other
    // has finished the previous tile's reads.
    float* cns = col_norms + parity * BN;
    if (threadIdx.x < BN) cns[threadIdx.x] = my_cn;
    asm volatile("bar.sync 3, 256;\n" ::: "memory");

    const OutTile o{out, &map_out, chunks, cns, m, n, row0, tn * BN, wg, t,
                    lane, rr, rn0, rn1, tma_out != 0, vec};
    switch (p.kind) {       // one dispatch a tile, not one an output
      case kRbf: store_tile<kRbf, BN>(acc, o, p); break;
      case kPoly: store_tile<kPoly, BN>(acc, o, p); break;
      default: store_tile<kLinear, BN>(acc, o, p); break;
    }
  }
  if (tma_out && t == 0) bulk_wait_all();     // before the CTA's memory goes
}

// cuTensorMapEncodeTiled, looked up in libcuda at run time (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// The TMA map of a row-major (rows, cols) matrix of `type` (`size`
// bytes an element), in boxes of `box_rows` x `box_cols` (128 bytes),
// 128-byte swizzle; loads fill outside the matrix with zeros, stores
// leave it alone.
int encode_map(CUtensorMap* map, CUtensorMapDataType type, int size,
               const void* base, int rows, int cols, int box_rows,
               int box_cols) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * size};
  const cuuint32_t boxes[2] = {static_cast<cuuint32_t>(box_cols),
                               static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims,
                        strides, boxes, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int BM, int BN, int BK, int TR, int TC, int DEPTH>
int launch_wgmma(const Args& a, cudaStream_t stream) {
  constexpr int smem = wgmma_smem_bytes<BM, BN, BK, DEPTH>();
  static_assert(smem <= kMaxSmem, "the ring exceeds shared memory");
  // TMA: 16-byte aligned rows (the wrapper pads d to a multiple of 8).
  if (a.d % 8 != 0 || reinterpret_cast<uintptr_t>(a.x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.y) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap map_x, map_y, map_out = {};
  int err = encode_map(&map_x, type, 2, a.x, a.m, a.d, BM, BK);
  if (err == 0) err = encode_map(&map_y, type, 2, a.y, a.n, a.d, BN, BK);
  // The output by TMA where its rows are 16-byte multiples, else by
  // direct 8-byte stores (4-byte ones for odd n).
  const int tma_out = a.n % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  if (err == 0 && tma_out)
    err = encode_map(&map_out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.out,
                     a.m, a.n, 64, 32);
  static bool smem_set[64] = {};
  const auto kernel = gram_wgmma_kernel<T, BM, BN, BK, TR, TC, DEPTH>;
  if (err == 0) err = allow_smem(kernel, smem, smem_set);
  int dev = 0, sms = 0;
  if (err == 0) err = static_cast<int>(cudaGetDevice(&dev));
  if (err == 0)
    err = static_cast<int>(cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, dev));
  if (err != 0) return err;
  const int tiles = ((a.m + BM - 1) / BM) * ((a.n + BN - 1) / BN);
  const int grid = tiles < sms ? tiles : sms;   // persistent: one a SM
  kernel<<<grid, 3 * kWarpGroup, smem, stream>>>(
      map_x, map_y, map_out, static_cast<const float*>(a.xn),
      static_cast<const float*>(a.yn), static_cast<float*>(a.out), a.m, a.n,
      a.d, a.p, tma_out);
  return static_cast<int>(cudaGetLastError());
}

// The menu: launch index -> <BM, BN, BK, TR, TC, DEPTH>, in the order of
// MENUS["gram"] in kernels/tiling.py (tests read these lines). Two
// classes by the rows' type, each compiled for its types only: f32 runs
// the SIMT kernels (entry 0, the first design's 64 x 64 tile, is the
// default), bf16
// and f16 run wgmma (entry 2, 128 x 256 with 3 stages, is the default).
// Each entry won a cell of the full sweep on an H100 (PERF.md).
// An index of the other class is refused with cudaErrorInvalidValue.
template <typename T>
int launch_f32(int cfg, const Args& a, cudaStream_t st) {
  switch (cfg) {
    case 0: return launch_tile<T, 64, 64, 32, 4, 4, 1>(a, st);
    case 1: return launch_simt<T, 128, 128, 8, 8, 8, 2>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_16bit(int cfg, const Args& a, cudaStream_t st) {
  switch (cfg) {
    case 2: return launch_wgmma<T, 128, 256, 64, 2, 64, 3>(a, st);
    case 3: return launch_wgmma<T, 128, 256, 64, 2, 64, 2>(a, st);
    case 4: return launch_wgmma<T, 128, 128, 64, 2, 32, 4>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro

// x (m, d) and y (n, d) row-major in `dtype` (0 f32, 1 bf16, 2 f16; in
// 16 bits d % 8 == 0 and both 16-byte aligned); xn (m,), yn (n,) f32
// squared norms of the rows (read by rbf only); out (m, n) f32; `cfg` the
// index of a menu entry of the dtype's class. Launches on `stream`, which
// must belong to the caller's current device, and returns
// cudaGetLastError(); launching nothing, cudaErrorInvalidValue for an
// unknown dtype or menu index or a TMA map cuTensorMapEncodeTiled refuses,
// cudaErrorMisalignedAddress for 16-bit rows TMA cannot read and
// cudaErrorNotSupported when cuTensorMapEncodeTiled is not found.
extern "C" int gram_launch(const void* x, const void* y, const void* xn,
                           const void* yn, void* out, int m, int n, int d,
                           int dtype, int kind, float gamma, float coef0,
                           int degree, int cfg, void* stream) {
  using namespace repro;
  const Args a{x, y, xn, yn, out, m, n, d,
               KernelParams{kind, gamma, coef0, degree}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_f32<float>(cfg, a, st);
    case kBF16: return launch_16bit<__nv_bfloat16>(cfg, a, st);
    case kF16: return launch_16bit<__half>(cfg, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* gram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
