// sv_predict: yhat_i = sum_j k(x_i, SV_ij) A_ij for B stacked learners.
//
// Replaces the TPU kernel repro/kernels/fused.py::sv_predict_pallas
// (body _sv_predict_kernel / _kernel_row).
//
// Bound: bytes.  At the engine's shape (B = 32 learners, budget
// N = 1024, d = 18) it reads ~2.4 MB, under a microsecond at 3.35 TB/s,
// so the launch itself dominates.
//
// Design: one block per row i, looping over the budget in tiles of
// blockDim slots (thread t takes slots t, t + blockDim, ...), then a
// fixed-order block reduce.  A row's floats therefore never depend on
// B (the reference's row-bitwise contract).  The budget's ragged edge
// is masked by the loop bound: nothing is padded.  Padded slots carry
// A = 0 and contribute exactly 0.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void sv_predict_kernel(const float* __restrict__ X,
                                  const float* __restrict__ SV,
                                  const float* __restrict__ A,
                                  float* __restrict__ out, int N, int d,
                                  int kind, float gamma, int degree,
                                  float coef0) {
  extern __shared__ float xs[];   // the query row, d floats
  __shared__ float red[kThreads];
  const int i = blockIdx.x;
  const int t = threadIdx.x;
  const float* x = X + (size_t)i * d;
  const float* sv = SV + (size_t)i * N * d;
  const float* a = A + (size_t)i * N;

  for (int k = t; k < d; k += kThreads) xs[k] = x[k];
  __syncthreads();
  float xx = 0.0f;
  for (int k = 0; k < d; ++k) xx += xs[k] * xs[k];

  float acc = 0.0f;
  for (int j = t; j < N; j += kThreads) {
    const float* s = sv + (size_t)j * d;
    float cross = 0.0f, yy = 0.0f;
    for (int k = 0; k < d; ++k) {
      const float v = s[k];
      cross += xs[k] * v;
      yy += v * v;
    }
    acc += kernel_value(kind, cross, xx, yy, gamma, degree, coef0) * a[j];
  }
  const float total = block_sum(acc, red);
  if (t == 0) out[i] = total;
}

}  // namespace

extern "C" int repro_sv_predict(const float* X, const float* SV,
                                const float* A, float* out, int B, int N,
                                int d, int kind, float gamma, int degree,
                                float coef0, void* stream) {
  if (B > 0) {
    sv_predict_kernel<<<B, kThreads, d * sizeof(float),
                        (cudaStream_t)stream>>>(X, SV, A, out, N, d, kind,
                                                gamma, degree, coef0);
  }
  return (int)cudaGetLastError();
}
