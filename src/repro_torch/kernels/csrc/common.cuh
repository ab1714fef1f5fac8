// Shared device helpers of the hand-written kernels: the kernel-function
// values k(x, y), fixed-order reductions, the staging of a contiguous run
// of floats into shared memory (a TMA bulk copy and cp.async), and the
// thread-block-cluster primitives the cluster kernels exchange sums with
// (split cluster barriers, mbarriers, st.async into another block's
// shared memory).
//
// Determinism: no kernel of this package uses a float atomic or sums
// across blocks in a run-dependent order.  A sum that changed from run
// to run would flip the dynamic protocol's sync decisions and, through
// them, the byte ledger; every reduction here is a fixed tree.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

enum KernelKind { KIND_GAUSSIAN = 0, KIND_LINEAR = 1, KIND_POLY = 2 };

// x ** n (n >= 0) by repeated squaring, in the multiplication order of
// JAX's lax.integer_pow and of the port's rkhs.int_pow (never powf).
__device__ __forceinline__ float int_pow(float x, int n) {
  float acc = 1.0f;
  bool have = false;
  while (n > 0) {
    if (n & 1) {
      acc = have ? acc * x : x;
      have = true;
    }
    n >>= 1;
    if (n > 0) x = x * x;
  }
  return acc;
}

// k(x, y) from cross = <x, y>, xx = <x, x>, yy = <y, y>.  The gaussian
// keeps the reference's xx + yy - 2 cross, clamped at 0.  KIND is a
// template parameter where a kernel instantiates one loop per kind.
template <int KIND>
__device__ __forceinline__ float kernel_value(float cross, float xx, float yy,
                                              float gamma, int degree,
                                              float coef0) {
  if constexpr (KIND == KIND_LINEAR) {
    return cross;
  } else if constexpr (KIND == KIND_POLY) {
    return int_pow(cross + coef0, degree);
  } else {
    // (xx + yy) - 2 cross: 2 cross is exact, so the fused form rounds once
    // where the written one does
    const float sq = fmaxf(fmaf(-2.0f, cross, xx + yy), 0.0f);
    return expf(-gamma * sq);
  }
}

__device__ __forceinline__ float kernel_value(int kind, float cross, float xx,
                                              float yy, float gamma,
                                              int degree, float coef0) {
  if (kind == KIND_LINEAR)
    return kernel_value<KIND_LINEAR>(cross, xx, yy, gamma, degree, coef0);
  if (kind == KIND_POLY)
    return kernel_value<KIND_POLY>(cross, xx, yy, gamma, degree, coef0);
  return kernel_value<KIND_GAUSSIAN>(cross, xx, yy, gamma, degree, coef0);
}

// Sum of v over the block, in a fixed tree order; blockDim.x must be a
// power of two no larger than the buffer.  Every thread gets the sum.
__device__ __forceinline__ float block_sum(float v, float* buf) {
  const int t = threadIdx.x;
  buf[t] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (t < s) buf[t] += buf[t + s];
    __syncthreads();
  }
  const float total = buf[0];
  __syncthreads();
  return total;
}

// Sum of v over the warp in a fixed shuffle tree (offsets 16, 8, 4, 2,
// 1); lane 0 gets the sum.  All 32 lanes must call it.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block: each warp's fixed shuffle tree, then thread 0
// adds the warps' sums in warp order.  Only thread 0's result is the sum;
// red holds a float per warp.  Ends with the block synchronized.
__device__ __forceinline__ float block_sum_ordered(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
    total = red[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) total += red[w];
  }
  return total;
}

// ---------------------------------------------------------------------
// Hopper's asynchronous primitives (sm_90).
// ---------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the address of the same shared variable in block `rank` of the cluster
__device__ __forceinline__ unsigned cluster_addr(const void* p,
                                                 unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_u32(p)), "r"(rank));
  return out;
}

// the two halves of a cluster barrier: every thread of the cluster
// arrives, and a wait returns once all have (exited threads excepted)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes this thread's mbarrier inits visible to the cluster and to the
// asynchronous proxy (TMA, st.async)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once, expecting `bytes` more of asynchronous writes this phase
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until phase `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// one TMA bulk copy of `bytes` (a multiple of 16; both ends 16-byte
// aligned) from device memory into this block's shared memory, counted
// on `bar`
__device__ __forceinline__ void tma_bulk(float* dst, const float* src,
                                         unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// write v into another block's shared memory (cluster addresses from
// cluster_addr), counted as 4 bytes on that block's barrier `bar`
__device__ __forceinline__ void st_async(unsigned dst, float v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(dst),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------------
// Staging contiguous runs of floats into shared memory, counted on an
// mbarrier.
//
// A run src[0, n) lands at dst[align_of(src) + e]: it keeps its position
// within a 16-byte line, so its 16-byte aligned body lands 16-byte
// aligned (dst itself 16-byte aligned, with room for n + 3 floats).  The
// body goes as one TMA bulk copy; the at most 3 floats before it and 3
// after it as 4-byte cp.async copies.  One thread stages all the runs of
// a stage (stage_runs) on a barrier initialized for one arrival, and the
// readers wait for the barrier's phase.  Runs of 16-byte aligned starts
// and lengths (the engine's shapes) have no ends: then the stage is one
// arrive.expect_tx and the bulk copies.
// ---------------------------------------------------------------------

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// floats of shared memory for a staged run of n floats
__host__ __device__ __forceinline__ int staged_floats(int n) {
  return round4(n + 3);
}

__device__ __forceinline__ int align_of(const float* p) {
  return (int)(((uintptr_t)p >> 2) & 3);
}

// a run's split: `head` floats, then a 16-byte aligned body of `body`
// floats, then the rest; `dst` already at the run's offset
struct Run {
  const float* src;
  float* dst;
  int n, head, body;
};

__device__ __forceinline__ Run run_of(float* dst, const float* src, int n) {
  const int off = align_of(src);
  const int head = min(n, (4 - off) & 3);
  return Run{src, dst + off, n, head, (n - head) & ~3};
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// cp.async groups: close this thread's copies issued so far into a
// group; wait until all of this thread's groups have landed
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stages the K runs on `bar`, by one thread.  With unaligned ends, their
// cp.async copies go first, then an arrive that raises the barrier's
// pending count now and lands once they have (so the phase waits for
// them); then the one arrival, expecting the bodies' bytes; then the
// bodies.
template <int K>
__device__ __forceinline__ void stage_runs(const Run (&runs)[K],
                                           uint64_t* bar) {
  unsigned bytes = 0;
  bool ends = false;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    bytes += 4u * (unsigned)runs[k].body;
    ends = ends || runs[k].head + runs[k].body < runs[k].n ||
           runs[k].head > 0;
  }
  if (ends) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const Run& r = runs[k];
      for (int e = 0; e < r.head; ++e) cp_async4(r.dst + e, r.src + e);
      for (int e = r.head + r.body; e < r.n; ++e)
        cp_async4(r.dst + e, r.src + e);
    }
    asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                     smem_u32(bar))
                 : "memory");
  }
  mbar_arrive_expect(bar, bytes);
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (runs[k].body > 0)
      tma_bulk(runs[k].dst + runs[k].head, runs[k].src + runs[k].head,
               4u * (unsigned)runs[k].body, bar);
}

// <x, s> and <s, s> over k = 0..d-1, in that order, one FMA each.  With d
// even and s 8-byte aligned, s is read as float2: at an odd d / 2 (d =
// 18) a half-warp reading rows d floats apart then hits 16 distinct
// 8-byte banks.
__device__ __forceinline__ void row_dots(const float* xs, const float* s,
                                         int d, float& cross, float& yy) {
  float c = 0.0f, q = 0.0f;
  if (((d | ((int)((uintptr_t)s >> 2))) & 1) == 0) {
    const float2* s2 = reinterpret_cast<const float2*>(s);
    for (int k = 0; k < d / 2; ++k) {
      const float2 v = s2[k];
      c = fmaf(xs[2 * k], v.x, c);
      q = fmaf(v.x, v.x, q);
      c = fmaf(xs[2 * k + 1], v.y, c);
      q = fmaf(v.y, v.y, q);
    }
  } else {
    for (int k = 0; k < d; ++k) {
      const float v = s[k];
      c = fmaf(xs[k], v, c);
      q = fmaf(v, v, q);
    }
  }
  cross = c;
  yy = q;
}
