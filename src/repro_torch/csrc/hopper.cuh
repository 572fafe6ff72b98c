// Hopper building blocks of the tensor-core kernels (gram.cu's wgmma
// class and split_rows.cuh's): mbarriers, TMA tile loads and stores, the
// wgmma shared-memory descriptor and instructions, and the TMA map
// encoder; then the weighted row-sum epilogue of a wgmma fragment.
//
// Everything down to encode_map is gram.cu's own code, moved here as it
// was, so that gram's kernels compile to what they were. Like the rest
// of each kernel's code it sits in an anonymous namespace: every source
// that includes it gets its own copies.
#pragma once

#include <cuda.h>   // CUtensorMap (the encoder is found at run time)

#include <cstdint>

#include "kernel_rows.cuh"

namespace repro {
namespace {

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

// Clusters (split_rows.cuh's wide streamed entry). A tma_load into the
// same offset of the shared memory of every CTA of the cluster in `mask`
// (bit r: the CTA of rank r), completing its bytes on the barrier at
// `bar`'s offset in each of them.
__device__ __forceinline__ void tma_load_multicast(void* dst,
                                                   const CUtensorMap* map,
                                                   uint64_t* bar, int c0,
                                                   int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "h"(mask),
      "r"(c0), "r"(c1)
      : "memory");
}

// This CTA's rank in its cluster.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

// Every thread of every CTA of the cluster: the writes before it (the
// barriers' initialisation) are seen by all of them after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// An arrival on the barrier at `bar`'s offset in the shared memory of
// the cluster's CTA of rank `cta`, with the default (release, CTA scope)
// semantics, as CUTLASS's ClusterBarrier::arrive: a cluster-scope release
// here cost the wide streamed entry 0.8 ms of 2.3 at 4096 x 32768,
// d = 4096 (PERF.md).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    int cta) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}"
      "\n" ::"r"(smem_u32(bar)),
      "r"(cta)
      : "memory");
}

// The accumulator operands of wgmma m64n32k16 (16 f32 a thread), for
// split_rows.cuh's narrower chunks (its 128-row chunks take the
// m64n128k16 above) ...
#define REPRO_REGS32 \
  "{" "%0," "%1," "%2," "%3," "%4," "%5," "%6," "%7," "%8," "%9," "%10," "%11," \
  "%12," "%13," "%14," "%15" "}"
#define REPRO_ACC32 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

// ... and of wgmma m64n64k16 (32 f32 a thread).
#define REPRO_REGS64 \
  "{" "%0," "%1," "%2," "%3," "%4," "%5," "%6," "%7," "%8," "%9," "%10," "%11," \
  "%12," "%13," "%14," "%15," "%16," "%17," "%18," "%19," "%20," "%21," "%22," "%23," \
  "%24," "%25," "%26," "%27," "%28," "%29," "%30," "%31" "}"
#define REPRO_ACC64 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
  "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31])

template <>
struct Wgmma<__nv_bfloat16, 64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    REPRO_WGMMA(64, "bf16", REPRO_REGS64, REPRO_ACC64, 32, 33, 34);
  }
};
template <>
struct Wgmma<__half, 64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    REPRO_WGMMA(64, "f16", REPRO_REGS64, REPRO_ACC64, 32, 33, 34);
  }
};
template <>
struct Wgmma<__nv_bfloat16, 32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da,
                                             uint64_t db) {
    REPRO_WGMMA(32, "bf16", REPRO_REGS32, REPRO_ACC32, 16, 17, 18);
  }
};
template <>
struct Wgmma<__half, 32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da,
                                             uint64_t db) {
    REPRO_WGMMA(32, "f16", REPRO_REGS32, REPRO_ACC32, 16, 17, 18);
  }
};

// ---------------------------------------------------------------------------
// The weighted row-sum epilogue of a wgmma fragment
// ---------------------------------------------------------------------------
//
// A consumer warpgroup's m64nN accumulators hold dot products of 64 rows
// and N columns; the thread's acc[4j + h] is row rr (+ 8 for h >= 2),
// column 8j + 2*(lane % 4) + h % 2. The row-sum kernels (split_rows.cuh:
// decision, and fupdate's wide classes) want, for each row,
// sum_c w[c] * k(row, c) and never the values themselves.

// part0 (row rr) and part1 (row rr + 8) += w[c] * k(acc, rn, cn[c]) over
// the thread's columns c = col0 + 8j + 2*(lane % 4) + h below n, in
// (j, h) order, the kind fixed. cn and w are read from global memory
// (the quad's lanes read neighbouring columns; the 8 quads of a warp the
// same ones). MASKED = false: the caller knows every column lies below n
// (the same sums, without the checks).
template <int KIND, int N, bool MASKED = true>
__device__ __forceinline__ void fragment_add_weighted(
    const float (&acc)[N / 2], float rn0, float rn1,
    const float* __restrict__ cn, const float* __restrict__ w, int n,
    int col0, int lane, const KernelParams& p, float& part0,
    float& part1) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + 8 * j + 2 * (lane % 4) + h;
      if (!MASKED || c < n) {
        const float cc = __ldg(cn + c), wc = __ldg(w + c);
        part0 = fmaf(kernel_value<KIND>(acc[4 * j + h], rn0, cc, p), wc,
                     part0);
        part1 = fmaf(kernel_value<KIND>(acc[4 * j + 2 + h], rn1, cc, p), wc,
                     part1);
      }
    }
  }
}

// The quad's four lanes (one pair of rows) add their partials: xor 1,
// then xor 2; after it each lane holds the rows' sums.
__device__ __forceinline__ void quad_reduce(float& part0, float& part1) {
  part0 += __shfl_xor_sync(0xffffffffu, part0, 1);
  part1 += __shfl_xor_sync(0xffffffffu, part1, 1);
  part0 += __shfl_xor_sync(0xffffffffu, part0, 2);
  part1 += __shfl_xor_sync(0xffffffffu, part1, 2);
}

}  // namespace
}  // namespace repro
