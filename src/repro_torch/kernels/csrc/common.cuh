// Shared device helpers of the hand-written kernels: the kernel-function
// values k(x, y) and a fixed-order block reduction.
//
// Determinism: no kernel of this package uses a float atomic or sums
// across blocks in a run-dependent order.  A sum that changed from run
// to run would flip the dynamic protocol's sync decisions and, through
// them, the byte ledger; every reduction here is a fixed tree.
#pragma once

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
