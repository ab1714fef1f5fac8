// gram: the Gram matrix K[i, j] = k(X[i, :], Y[j, :]) for X (M, d),
// Y (N, d), K (M, N), all float32 row-major; k is the gaussian
// exp(-gamma max(|x|^2 + |y|^2 - 2 <x, y>, 0)), the polynomial
// (<x, y> + coef0)^degree or the linear <x, y> (common.cuh).
//
// Replaces the TPU kernel repro/kernels/gram.py::gram_pallas (body
// _gram_kernel): there a (bm, bn) tile is one MXU product for the cross
// term plus the row norms, computed in-tile on the VPU and fused with the
// exp, so the squared distances never leave VMEM.  The same here: a block
// computes the norms of its rows and columns in float32 from the features
// it staged, and writes each K[i, j] once, finished.
//
// Bound: bytes.  d is small (18 on SUSY), so an element costs about 2 d
// operations against the 4 bytes of its write: at the SV sync's shape
// (M = N = m tau = 32768, d = 18) the output is 4.29 GB, 1.28 ms at
// 3.35 TB/s (a PyTorch fill_ of that buffer takes 1.30 ms on an H100
// 80GB HBM3 at 700 W), against 0.7 ms of float32 operations.  The issue
// slots come close behind: 18 FMAs an element, and for the gaussian a
// dozen instructions more (expf's full path), about 1.1 ms of the SMs'
// issue at full rate.  Measured there, this kernel's store pattern alone
// (d = 0) takes 1.33 ms and d = 4 1.37, while at d = 18 the first
// register tile of this design (8 rows x 4 columns a thread) took 1.75
// (linear) and 2.33 (gaussian): the feature loop, not the stores, sets
// the time at the main shape, so the design spends as few instructions
// as it can on anything but the FMAs.  Tensor cores would round the
// cross term (TF32 keeps about three digits, outside the gaussian's
// cancellation tolerance), so the cross term is float32 FMAs.
//
// Design (the first design, one short-lived block per 32 x 128 tile with
// 4-byte stores and a runtime kind, took 3.65 ms, the linear kind 2.98):
// - a persistent grid: as many blocks of 256 threads as fit the SMs at
//   once; block b walks the contiguous range [b T / G, (b + 1) T / G) of
//   the T tiles of 128 rows x 128 columns, in row-band order, with a
//   cursor (no division a tile);
// - a register tile a thread: warp w owns the tile's rows 16 w .. 16 w +
//   15, lane l the columns 4 l .. 4 l + 3, 64 sums in registers; per
//   feature k four broadcast 16-byte shared loads of the 16 rows' x_k and
//   one of the 4 columns' y_k feed 64 FMAs (8 rows took 3 loads for 32
//   FMAs and 1.75 / 2.33 ms; a 4 x 8 tile, 2.05 / 2.57);
// - the features are staged transposed in shared memory (X as [k][128],
//   Y as [k][128]) in chunks of at most 32 by 4-byte cp.async copies,
//   two buffers: the next tile's features come in while this one
//   computes, behind one barrier a chunk;
// - the gaussian's norms: threads 0-127 sum their row's x_k^2, threads
//   128-255 their column's y_k^2, in k order, while every thread sums its
//   cross terms; one barrier a tile publishes them for the epilogue;
// - the epilogue writes each row's 4 values as one 16-byte streaming
//   store (st.global.cs: evict first, so X and Y stay in L2), 512
//   contiguous bytes a warp and row; the stores drain while the next
//   tile computes (4-byte stores where N is not a multiple of 4 or K is
//   not 16-byte aligned, and past N).  Staging the tile in shared memory
//   and sending it by bulk copies (cp.async.bulk, a warp's 8 rows a
//   group) took 2.70 / 2.13 ms against these stores' 2.33 / 1.75 in the
//   same run (8-row tiles), so the stores stay;
// - the kind is a template parameter, dispatched once at the C entry.
//
// Numerics (unchanged from the first design): every K[i, j] is one
// sequential fmaf sum over k = 0 .. d - 1 from 0, and the norms the same
// sums of squares, so it depends on X[i, :] and Y[j, :] alone, never on
// the tile, the block or M, N.  expf keeps its full-precision path (no
// fast math), and there are no atomics.  Rows past M and columns past N
// are never stored.
//
// Registers and shared memory (ptxas -v, sm_90a, from the build log the
// kernels' build writes beside the library, build/<hash>/build.log, and
// chip_smoke.py saves as chip_smoke_build.log; on an H100): 127
// registers (gaussian, poly) and 120 (linear), no spills, no static
// shared memory, 2 blocks an SM; dynamic shared memory 2 kc (128 + 128)
// + 256 floats, 37,888 bytes at d = 18.
#include <algorithm>
#include <climits>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kTM = 128;        // rows of a tile: 8 warps x 16 rows
constexpr int kTN = 128;        // columns of a tile: 32 lanes x 4
constexpr int kKC = 32;         // features a chunk holds at most

// floats of dynamic shared memory for chunks of kc features: two
// buffers of X ([kc][64]) and Y ([kc][128]), then the tile's norms
int smem_floats(int kc) { return 2 * kc * (kTM + kTN) + kTM + kTN; }

// a position in a block's walk: tile (row, col) of the grid of tiles,
// chunk c of its features; advanced in place, no division
struct Cursor {
  int row, col, c;
  __device__ __forceinline__ void advance(int nk, int col_tiles) {
    if (++c == nk) {
      c = 0;
      if (++col == col_tiles) {
        col = 0;
        ++row;
      }
    }
  }
};

template <int KIND>
__global__ void __launch_bounds__(kThreads, 2)
    gram_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                float* __restrict__ K, int M, int N, int d, int kc,
                int col_tiles, int tiles, float gamma, int degree,
                float coef0) {
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;                      // [2][kc][kTM]
  float* Ys = Xs + 2 * kc * kTM;         // [2][kc][kTN]
  float* xx_s = Ys + 2 * kc * kTN;       // [kTM]
  float* yy_s = xx_s + kTM;              // [kTN]
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nk = max(1, (d + kc - 1) / kc);   // chunks a tile
  const int first = (int)((long long)tiles * blockIdx.x / gridDim.x);
  const int stages =
      ((int)((long long)tiles * (blockIdx.x + 1) / gridDim.x) - first) * nk;
  // 16-byte stores along a row where every row starts 16-byte aligned
  const bool vec = (N & 3) == 0 && ((uintptr_t)K & 15) == 0;

  // stage a chunk into buffer b: this thread's share of its X rows and
  // Y columns
  auto stage = [&](const Cursor& at, int b) {
    const int k0 = at.c * kc, dk = min(kc, d - k0);
    const int i = at.row * kTM + (t & (kTM - 1));
    const int j = at.col * kTN + (t & (kTN - 1));
    float* xs = Xs + b * kc * kTM + (t & (kTM - 1));
    float* ys = Ys + b * kc * kTN + (t & (kTN - 1));
    for (int k = t / kTM; k < dk; k += kThreads / kTM) {
      if (i < M) cp_async4(xs + k * kTM, X + (size_t)i * d + k0 + k);
      else xs[k * kTM] = 0.0f;
    }
    for (int k = t / kTN; k < dk; k += kThreads / kTN) {
      if (j < N) cp_async4(ys + k * kTN, Y + (size_t)j * d + k0 + k);
      else ys[k * kTN] = 0.0f;
    }
    cp_async_commit();
  };

  float acc[16][4] = {};
  float nrm = 0.0f;   // row t's |x|^2 (t < 128), column t - 128's |y|^2
  Cursor at{first / col_tiles, first % col_tiles, 0};   // stage s
  Cursor next = at;                                     // stage s + 1
  next.advance(nk, col_tiles);
  if (stages > 0) stage(at, 0);
  for (int s = 0; s < stages; ++s) {
    cp_async_wait_all();
    __syncthreads();   // stage s landed; every thread is done with s - 1
    if (s + 1 < stages) stage(next, (s + 1) & 1);
    if (at.c == 0) {
#pragma unroll
      for (int r = 0; r < 16; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
      nrm = 0.0f;
    }
    const int dk = min(kc, d - at.c * kc);
    const float* xs = Xs + (s & 1) * kc * kTM;
    const float* ys = Ys + (s & 1) * kc * kTN;
    if constexpr (KIND == KIND_GAUSSIAN) {
      if (t < kTM) {
        for (int k = 0; k < dk; ++k)
          nrm = fmaf(xs[k * kTM + t], xs[k * kTM + t], nrm);
      } else if (t < kTM + kTN) {
        const float* col = ys + (t - kTM);
        for (int k = 0; k < dk; ++k)
          nrm = fmaf(col[k * kTN], col[k * kTN], nrm);
      }
    }
    // one feature: 4 broadcast loads of the 16 rows' x_k, one of the 4
    // columns' y_k, 64 FMAs
    auto feature = [&](int k) {
      const float* xk = xs + k * kTM + 16 * warp;
      const float4 xa = *reinterpret_cast<const float4*>(xk);
      const float4 xb = *reinterpret_cast<const float4*>(xk + 4);
      const float4 xc = *reinterpret_cast<const float4*>(xk + 8);
      const float4 xd = *reinterpret_cast<const float4*>(xk + 12);
      const float4 y =
          *reinterpret_cast<const float4*>(ys + k * kTN + 4 * lane);
      const float xr[16] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w,
                            xc.x, xc.y, xc.z, xc.w, xd.x, xd.y, xd.z, xd.w};
      const float yq[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int r = 0; r < 16; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[r][q] = fmaf(xr[r], yq[q], acc[r][q]);
    };
    // two features a step, written out: `#pragma unroll 3` on this loop
    // (a runtime trip count) gave wrong sums for every d not a multiple
    // of 3 (CUDA 12.8, sm_90a), so no count is left to the pragma
    int k = 0;
    for (; k + 1 < dk; k += 2) {
      feature(k);
      feature(k + 1);
    }
    if (k < dk) feature(k);
    const Cursor done = at;
    at = next;
    next.advance(nk, col_tiles);
    if (done.c != nk - 1) continue;

    // the tile's last chunk: publish the norms (the gaussian's alone
    // reads them), then write the tile
    if constexpr (KIND == KIND_GAUSSIAN) {
      if (t < kTM) xx_s[t] = nrm;
      else if (t < kTM + kTN) yy_s[t - kTM] = nrm;
      __syncthreads();
    }
    const int i0 = done.row * kTM + 16 * warp;
    const int j = done.col * kTN + 4 * lane;
    const float4 yy = *reinterpret_cast<const float4*>(yy_s + 4 * lane);
    const float yv[4] = {yy.x, yy.y, yy.z, yy.w};
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int i = i0 + r;
      if (i >= M) break;
      const float xx = xx_s[16 * warp + r];
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = kernel_value<KIND>(acc[r][q], xx, yv[q], gamma, degree, coef0);
      float* row = K + (size_t)i * N + j;
      if (vec && j < N) {
        __stcs(reinterpret_cast<float4*>(row),
               make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j + q < N) __stcs(row + q, v[q]);
      }
    }
  }
}

template <int KIND>
cudaError_t launch(const float* X, const float* Y, float* K, int M, int N,
                   int d, float gamma, int degree, float coef0,
                   cudaStream_t stream) {
  const int kc = std::max(1, std::min(d, kKC));
  const int smem = 4 * smem_floats(kc);
  cudaError_t err = cudaFuncSetAttribute(
      gram_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gram_kernel<KIND>, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int col_tiles = (N + kTN - 1) / kTN;
  const long long tiles = (long long)((M + kTM - 1) / kTM) * col_tiles;
  if (tiles * std::max(1, (d + kc - 1) / kc) > INT_MAX)
    return cudaErrorInvalidValue;
  const int blocks = (int)std::min(tiles, (long long)sms * std::max(1, per_sm));
  gram_kernel<KIND><<<blocks, kThreads, smem, stream>>>(
      X, Y, K, M, N, d, kc, col_tiles, (int)tiles, gamma, degree, coef0);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_gram(const float* X, const float* Y, float* K, int M,
                          int N, int d, int kind, float gamma, int degree,
                          float coef0, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (d < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case KIND_LINEAR:
      return (int)launch<KIND_LINEAR>(X, Y, K, M, N, d, gamma, degree,
                                      coef0, st);
    case KIND_POLY:
      return (int)launch<KIND_POLY>(X, Y, K, M, N, d, gamma, degree, coef0,
                                    st);
    case KIND_GAUSSIAN:
      return (int)launch<KIND_GAUSSIAN>(X, Y, K, M, N, d, gamma, degree,
                                        coef0, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
