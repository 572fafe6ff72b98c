// Helpers shared by the scan kernels (ssm_scan.cu, wkv6.cu): fixed-order
// sums and cp.async staging.
//
// The backward kernels sum gradients over channels, batch rows and time.
// Float atomics would add them in an order that changes from run to run;
// these helpers add them in one fixed order instead, so two runs on the
// same inputs give the same bits: within a thread a fixed pairwise tree
// (tree_sum), across lanes a fixed xor butterfly (Butterfly), within a
// CTA the warps by a tree or in order (in the kernels), across CTAs or
// rows a second pass that adds each element's partials by a tree
// (sum_parts_tree).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace repro {
namespace {

constexpr unsigned kFull = 0xffffffffu;

// cp.async: a 16-byte (or 4-byte) copy from global to shared memory that
// runs while the thread goes on; commit closes a group of copies, and
// wait<N> returns once at most N groups are still in flight.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The sum of a[0..N) by a fixed pairwise tree.
template <int N>
__device__ __forceinline__ float tree_sum(float (&a)[N]) {
#pragma unroll
  for (int w = 1; w < N; w *= 2) {
#pragma unroll
    for (int i = 0; i + w < N; i += 2 * w) a[i] = __fadd_rn(a[i], a[i + w]);
  }
  return a[0];
}

// p[0..N), one value a column, summed over the lanes that differ only in
// the lane bits O0, 2 O0, ..., < O1, by a butterfly: at each level a lane
// keeps half of its values (the upper half where its bit is set) and adds
// its partner's values of them; once one is left, both partners add. The
// order is fixed, so every run and every step gives the same bits. On
// return p[0..kept) are the sums of columns off .. off + kept - 1, and
// the lanes with (lane & dup) != 0 hold copies of other lanes' sums.
__host__ __device__ constexpr int ilog2(int x) {
  return x > 1 ? 1 + ilog2(x / 2) : 0;
}

template <int N, int O0, int O1>
struct Butterfly {
  static constexpr int levels = ilog2(O1 / O0);
  static constexpr int kept = (N >> levels) > 0 ? (N >> levels) : 1;
  static __device__ __forceinline__ void run(float (&p)[N], int lane,
                                             int& off, int& dup) {
    off = 0;
    dup = 0;
    level<O0, N>(p, lane, off, dup);
  }
  // Lane bit O with NV values kept so far; a template a level, so that
  // every index is known at compile time (p stays in registers).
  template <int O, int NV>
  static __device__ __forceinline__ void level(float (&p)[N], int lane,
                                               int& off, int& dup) {
    if constexpr (O < O1) {
      const bool up = lane & O;
      if constexpr (NV > 1) {
        constexpr int H = NV / 2;
#pragma unroll
        for (int i = 0; i < H; ++i) {
          const float send = up ? p[i] : p[i + H];
          const float keep = up ? p[i + H] : p[i];
          p[i] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, O));
        }
        if (up) off += H;
        level<2 * O, H>(p, lane, off, dup);
      } else {
        p[0] = __fadd_rn(p[0], __shfl_xor_sync(kFull, p[0], O));
        dup |= O;
        level<2 * O, 1>(p, lane, off, dup);
      }
    }
  }
};

// A binary counter of partial sums: acc[l] holds the sum of 2^l
// consecutive parts while bit l of `have` is set. v, the sum of 2^L0
// parts that follow them (levels below L0 empty), merges up, the earlier
// sum on the left.
template <int L0, int LV>
__device__ __forceinline__ void push_sum(float (&acc)[LV], unsigned& have,
                                         float v) {
#pragma unroll
  for (int l = L0; l < LV; ++l) {
    if (have & (1u << l)) {
      v = __fadd_rn(acc[l], v);
      have &= ~(1u << l);
    } else {
      acc[l] = v;
      have |= 1u << l;
      return;
    }
  }
}

// out[j] = the sum over p < parts of in[p * n + j] by a fixed pairwise
// tree over p (the binary counter above; what is left at the end is added
// largest first), read 8 parts at a time (their tree is the counter's).
// Up to 3 parts it adds them in order, as a serial sum would; over many
// parts (CTAs) its rounding grows with the log of their count, not the
// count.
__global__ void sum_parts_tree(const float* __restrict__ in,
                               float* __restrict__ out, int parts, long n) {
  const long j = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
  if (j >= n) return;
  constexpr int kLevels = 16;   // up to 65535 parts
  float acc[kLevels];
  unsigned have = 0;
  int p = 0;
  for (; p + 8 <= parts; p += 8) {
    float g[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) g[q] = in[(p + q) * n + j];
    push_sum<3>(acc, have, tree_sum(g));
  }
  for (; p < parts; ++p) push_sum<0>(acc, have, in[p * n + j]);
  float s = 0.f;
  bool first = true;
#pragma unroll
  for (int l = kLevels - 1; l >= 0; --l) {
    if (have & (1u << l)) {
      s = first ? acc[l] : __fadd_rn(s, acc[l]);
      first = false;
    }
  }
  out[j] = s;
}

inline void launch_sum_parts(const float* in, float* out, int parts, long n,
                             cudaStream_t st) {
  constexpr int kThreads = 256;
  const long blocks = (n + kThreads - 1) / kThreads;
  sum_parts_tree<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      in, out, parts, n);
}

}  // namespace
}  // namespace repro
