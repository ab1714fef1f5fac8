// gram: the Gram matrix K[i, j] = k(X[i, :], Y[j, :]) for X (M, d),
// Y (N, d), K (M, N), all float32 row-major; k is the gaussian
// exp(-gamma max(|x|^2 + |y|^2 - 2 <x, y>, 0)), the polynomial
// (<x, y> + coef0)^degree or the linear <x, y> (common.cuh).
//
// Replaces the TPU kernel repro/kernels/gram.py::gram_pallas (body
// _gram_kernel): there a (bm, bn) tile is one MXU product for the cross
// term plus the row norms, computed in-tile on the VPU and fused with the
// exp, so the squared distances never leave VMEM.  The same here: a block
// computes the norms of its rows and columns in float32 from the tiles it
// staged, and writes each K[i, j] once, finished.
//
// Bound: bytes.  d is small (18 on SUSY), so an element costs about 2 d
// operations against the 4 bytes of its write: at the SV sync's shape
// (M = N = m tau = 32768, d = 18) the output is 4.29 GB, 1.28 ms at
// 3.35 TB/s, against 0.7 ms of float32 operations.  Tensor cores would
// round the cross term (TF32 keeps about three digits, outside the
// gaussian's cancellation tolerance), so the cross term is float32 FMAs.
//
// Design: a block of 128 threads owns a tile of 32 rows by 128 columns,
// one column per thread, its 32 cross terms in registers.  The features
// are staged in chunks of 32 in shared memory: Y transposed (one
// conflict-free read per thread per feature), X transposed so that four
// rows come as one broadcast float4 read.  Every K[i, j] is one
// sequential sum over k in a fixed order: it depends on X[i, :] and
// Y[j, :] only, not on the tile.  Rows past M and columns past N are
// never stored; row tiles past the grid's y extent are taken in a
// grid-stride loop.  expf keeps its full-precision path (no fast math).
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kCols = 128;   // threads per block, one column each
constexpr int kRows = 32;    // rows per tile
constexpr int kDK = 32;      // features per staged chunk

__global__ void __launch_bounds__(kCols)
gram_kernel(const float* __restrict__ X, const float* __restrict__ Y,
            float* __restrict__ K, int M, int N, int d, int kind,
            float gamma, int degree, float coef0) {
  __shared__ __align__(16) float Xs[kDK][kRows];
  __shared__ float Ys[kDK][kCols + 1];
  __shared__ float xx_s[kRows];
  const int t = threadIdx.x;
  const int j0 = blockIdx.x * kCols;
  const int j = j0 + t;
  for (int i0 = blockIdx.y * kRows; i0 < M; i0 += gridDim.y * kRows) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    float yy = 0.0f, xx = 0.0f;
    for (int k0 = 0; k0 < d; k0 += kDK) {
      const int dk = min(kDK, d - k0);
      __syncthreads();   // the last chunk's reads are done
      for (int e = t; e < kRows * kDK; e += kCols) {
        const int r = e % kRows, kk = e / kRows, i = i0 + r;
        Xs[kk][r] = (i < M && kk < dk) ? X[(size_t)i * d + k0 + kk] : 0.0f;
      }
      for (int e = t; e < kCols * kDK; e += kCols) {
        const int c = e / kDK, kk = e % kDK, jj = j0 + c;
        Ys[kk][c] = (jj < N && kk < dk) ? Y[(size_t)jj * d + k0 + kk] : 0.0f;
      }
      __syncthreads();
      for (int kk = 0; kk < dk; ++kk) {
        const float y = Ys[kk][t];
        yy = fmaf(y, y, yy);
#pragma unroll
        for (int r = 0; r < kRows; r += 4) {
          const float4 x4 = *reinterpret_cast<const float4*>(&Xs[kk][r]);
          acc[r] = fmaf(x4.x, y, acc[r]);
          acc[r + 1] = fmaf(x4.y, y, acc[r + 1]);
          acc[r + 2] = fmaf(x4.z, y, acc[r + 2]);
          acc[r + 3] = fmaf(x4.w, y, acc[r + 3]);
        }
      }
      if (t < kRows)
        for (int kk = 0; kk < dk; ++kk) xx = fmaf(Xs[kk][t], Xs[kk][t], xx);
    }
    if (t < kRows) xx_s[t] = xx;
    __syncthreads();
    if (j < N) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + r;
        if (i < M)
          K[(size_t)i * N + j] =
              kernel_value(kind, acc[r], xx_s[r], yy, gamma, degree, coef0);
      }
    }
    __syncthreads();   // xx_s is read before the next tile rewrites it
  }
}

}  // namespace

extern "C" int repro_gram(const float* X, const float* Y, float* K, int M,
                          int N, int d, int kind, float gamma, int degree,
                          float coef0, void* stream) {
  if (M > 0 && N > 0) {
    const int row_tiles = (M + kRows - 1) / kRows;
    const dim3 grid((N + kCols - 1) / kCols,
                    row_tiles < 65535 ? row_tiles : 65535);
    gram_kernel<<<grid, kCols, 0, (cudaStream_t)stream>>>(
        X, Y, K, M, N, d, kind, gamma, degree, coef0);
  }
  return (int)cudaGetLastError();
}
