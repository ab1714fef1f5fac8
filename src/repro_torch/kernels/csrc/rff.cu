// rff: random Fourier features Z[i, j] = scale * cos(<X[i, :], W[j, :]> + b[j])
// for X (M, d), W (D, d), b (D,), Z (M, D), all float32 row-major.
//
// Replaces the TPU kernel repro/kernels/rff.py::rff_pallas (body
// _rff_kernel): there a (bm, bd) tile is one MXU product plus a fused
// bias-cos-scale epilogue.
//
// Bound: bytes.  d is small (18 on SUSY), so the "GEMM" has K = d and
// does 2 M D d operations against 4 (M d + D d + D + M D) bytes, most of
// them the write of Z; tensor cores buy nothing.  At the serving shape
// (M <= 64, D = 2048, d = 18) the work is well under a microsecond of
// memory time: the launch dominates.
//
// Design: one thread per output column j of a block of kRows rows.  The
// thread walks k = 0 .. d-1 once, reads W[j, k] once and adds
// X[i, k] W[j, k] into each of its kRows accumulators, then writes
// scale * cosf(acc + b[j]) for every row in range.  Every element is the
// same sequential sum over k in the same order: Z[i, j] depends only on
// X[i, :], W[j, :], b[j] and scale, never on M, on the tile that holds
// it or on the launch shape (no split over k, no atomics).  That is the
// serving contract: a padded bucket's row equals the single-row call
// bitwise.  Row tiles beyond gridDim.y are taken in a grid-stride loop,
// so any M >= 1 launches.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // columns per block
constexpr int kRows = 4;        // rows per block

__global__ void rff_kernel(const float* __restrict__ X,
                           const float* __restrict__ W,
                           const float* __restrict__ b,
                           float* __restrict__ Z, int M, int D, int d,
                           float scale) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= D) return;
  const float* wj = W + (size_t)j * d;
  const float bj = b[j];
  for (int r0 = blockIdx.y * kRows; r0 < M; r0 += gridDim.y * kRows) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    for (int k = 0; k < d; ++k) {
      const float wk = wj[k];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = r0 + r;
        // a row past M reads X[M - 1] and is never stored
        const float xk = X[(size_t)(i < M ? i : M - 1) * d + k];
        acc[r] += xk * wk;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = r0 + r;
      if (i < M) Z[(size_t)i * D + j] = scale * cosf(acc[r] + bj);
    }
  }
}

}  // namespace

extern "C" int repro_rff(const float* X, const float* W, const float* b,
                         float* Z, int M, int D, int d, float scale,
                         void* stream) {
  if (M > 0 && D > 0) {
    const int row_tiles = (M + kRows - 1) / kRows;
    dim3 grid((D + kThreads - 1) / kThreads,
              row_tiles < 65535 ? row_tiles : 65535);
    rff_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(X, W, b, Z, M, D,
                                                            d, scale);
  }
  return (int)cudaGetLastError();
}
