// quadform: P independent forms q_p = alpha_p^T K(X_p, Y_p) beta_p,
// without materializing any Gram matrix in device memory.
//
// Replaces the TPU kernel repro/kernels/quadform.py::quadform_pallas
// (as the reference vmaps it: rkhs_dist_sq is three forms per learner).
//
// Bound: operations.  At the engine's dynamic check (m = 32 learners,
// budget 1024, d = 18) it evaluates ~96 x 1024^2 kernel entries,
// ~4.3 GFLOP: about 65 us at fp32's 67 TFLOP/s.
//
// Design.  The TPU kernel carries one scalar across its sequential grid
// steps; on this card blocks run in parallel in no order, so:
//   pass 1: block (r, p) owns rows [r*kRows, (r+1)*kRows) of form p and
//     walks all columns of Y_p in tiles of kThreads (one column per
//     thread), staging kChunk features of the rows and of the column
//     tile in shared memory at a time; each thread accumulates its
//     columns' beta_j * sum_i alpha_i K_ij in a fixed order, then a
//     fixed-order block reduce writes partial[p, r];
//   pass 2: one thread per form sums its partials in order r = 0..R-1.
// No float atomics, no cross-block sum in run-dependent order: a run
// gives the same bits every time.  Padded rows / columns are masked (a
// padded row has alpha = 0 and contributes exactly 0).
#include "common.cuh"

namespace {

constexpr int kRows = 32;      // rows of X_p per block
constexpr int kThreads = 128;  // columns of Y_p per tile, one per thread
constexpr int kChunk = 32;     // features staged in shared memory at once

__global__ void quadform_partial_kernel(
    const float* __restrict__ X, const float* __restrict__ Y,
    const float* __restrict__ alpha, const float* __restrict__ beta,
    float* __restrict__ partial, int M, int N, int d, int kind, float gamma,
    int degree, float coef0) {
  __shared__ float xs[kRows][kChunk + 1];
  __shared__ float ys[kThreads][kChunk + 1];   // +1: no bank conflicts
  __shared__ float xx_s[kRows];
  __shared__ float a_s[kRows];
  __shared__ float red[kThreads];

  const int r = blockIdx.x;
  const int p = blockIdx.y;
  const int t = threadIdx.x;
  const int row0 = r * kRows;
  const int rows = min(kRows, M - row0);
  const float* Xp = X + (size_t)p * M * d;
  const float* Yp = Y + (size_t)p * N * d;
  const float* Ap = alpha + (size_t)p * M;
  const float* Bp = beta + (size_t)p * N;

  if (t < kRows) {
    float s = 0.0f, av = 0.0f;
    if (t < rows) {
      const float* xr = Xp + (size_t)(row0 + t) * d;
      for (int k = 0; k < d; ++k) s += xr[k] * xr[k];
      av = Ap[row0 + t];
    }
    xx_s[t] = s;
    a_s[t] = av;
  }
  __syncthreads();

  float acc = 0.0f;
  for (int col0 = 0; col0 < N; col0 += kThreads) {
    float cross[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) cross[i] = 0.0f;
    float yy = 0.0f;
    for (int k0 = 0; k0 < d; k0 += kChunk) {
      const int kc = min(kChunk, d - k0);
      __syncthreads();
      for (int e = t; e < kRows * kChunk; e += kThreads) {
        const int i = e / kChunk, k = e % kChunk;
        xs[i][k] = (i < rows && k < kc)
                       ? Xp[(size_t)(row0 + i) * d + k0 + k] : 0.0f;
      }
      for (int e = t; e < kThreads * kChunk; e += kThreads) {
        const int c = e / kChunk, k = e % kChunk;
        ys[c][k] = (col0 + c < N && k < kc)
                       ? Yp[(size_t)(col0 + c) * d + k0 + k] : 0.0f;
      }
      __syncthreads();
      for (int k = 0; k < kc; ++k) {
        const float yv = ys[t][k];
        yy += yv * yv;
#pragma unroll
        for (int i = 0; i < kRows; ++i) cross[i] += xs[i][k] * yv;
      }
    }
    const int j = col0 + t;
    if (j < N) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (i < rows) {
          s += a_s[i] *
               kernel_value(kind, cross[i], xx_s[i], yy, gamma, degree, coef0);
        }
      }
      acc += Bp[j] * s;
    }
  }
  const float total = block_sum(acc, red);
  if (t == 0) partial[(size_t)p * gridDim.x + r] = total;
}

__global__ void quadform_finish_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, int P,
                                       int R) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float s = 0.0f;
  for (int r = 0; r < R; ++r) s += partial[(size_t)p * R + r];
  out[p] = s;
}

}  // namespace

// partial must hold P * ceil(M / kRows) floats (kRows = 32, mirrored by
// ROWS_PER_BLOCK in kernels/quadform.py).
extern "C" int repro_quadform(const float* X, const float* Y,
                              const float* alpha, const float* beta,
                              float* partial, float* out, int P, int M, int N,
                              int d, int kind, float gamma, int degree,
                              float coef0, void* stream) {
  if (P > 0 && M > 0) {
    const int R = (M + kRows - 1) / kRows;
    dim3 grid(R, P);
    quadform_partial_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        X, Y, alpha, beta, partial, M, N, d, kind, gamma, degree, coef0);
    quadform_finish_kernel<<<(P + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        partial, out, P, R);
  }
  return (int)cudaGetLastError();
}
