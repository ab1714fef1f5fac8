// rff: random Fourier features Z[i, j] = scale * cos(<X[i, :], W[j, :]> + b[j])
// for X (M, d), W (D, d), b (D,), Z (M, D), all float32 row-major.
//
// Replaces the TPU kernel repro/kernels/rff.py::rff_pallas (body
// _rff_kernel): there a (bm, bd) tile is one MXU product plus a fused
// bias-cos-scale epilogue.
//
// Bound: bytes.  d is small (18 on SUSY), so the "GEMM" has K = d and
// does 2 M D d operations against 4 (M d + D d + D + M D) bytes, most of
// them the write of Z; tensor cores buy nothing.  At the serving shapes
// (M in 1 .. 64, D = 2048, d = 18) that is well under a microsecond of
// memory time: latency sets the time, not work.  The first design (one
// thread a column in blocks of 256 columns and 4 rows: 8 blocks at M <= 4,
// 64 at M = 32) loaded W and X inside a run-time feature loop, and its
// time followed d, not M (tools/kernel_probe.py; PERF.md section 6): a
// chain of round trips to L2 with most SMs idle.
// So:
// - a block owns 32 columns of Z (a lane each) and a row tile of 8 R
//   rows (R = 1, 2, 4 or 8 rows a thread, a warp's rows 8 apart); the
//   wrapper picks the least R that still gives about one block per SM
//   (132 on the H100; kernels/rff.py::rff_geometry): at D = 2048 that
//   is 128 blocks at M = 16, 32 and 64 (R = 1, 2, 4);
// - the block's W slab (32 rows of W, contiguous), its X rows and its
//   slice of b are loaded by all 256 threads, every load issued before
//   the first store to shared memory and one barrier: one round trip
//   to L2.  4-byte loads: any start (a bucket sliced from a larger
//   tensor starts 4 bytes past a 16-byte boundary) and any d;
// - the stage is always a chunk of 32 features, zeros past d: thread t
//   loads feature t % 32 of slab rows t / 32 + 8 u (a warp one row,
//   coalesced; no division by d), and the feature loop runs over the
//   whole chunk with a trip count known at compile time (a run-time
//   one, even at d = 1, cost the launch 0.0002 to 0.0004 ms: PERF.md
//   section 6).  fmaf(0, 0, acc) is acc (or +0 for -0, which
//   acc + b[j] maps to the same float), so the padding keeps every
//   float.  d > 32 takes chunks of 32 one after another;
// - W lands in shared memory at a stride of 36 floats (4 mod 8), so a
//   quarter-warp's 16-byte reads of eight W rows hit 32 distinct banks;
//   X's reads are warp-wide float4 broadcasts.  One read of W[j, k]
//   feeds R FMAs;
// - a warp stores 32 consecutive floats of one row: 128 bytes.
// No cluster: every block reads the same few KB of X from L2, and the
// probe found X's loads no dearer than W's (each alone about 0.2 us of
// the launch): a multicast of X would leave W's round trip in place.
//
// Every element is the same sequence: acc = 0, then
// acc = fmaf(X[i, k], W[j, k], acc) for k = 0 .. d-1 in that order (and
// the padding's fmaf(0, 0, acc)), then scale * cosf(acc + b[j]) (no fast
// math).  That is what the first design
// (one thread a column, acc += x * w, contracted to an FMA) computed, so
// the outputs are bitwise its outputs; and Z[i, j] depends only on
// X[i, :], W[j, :], b[j] and scale, never on M, on the tile that holds it
// or on the launch shape (no split over k, no atomics).  That is the
// serving contract: a padded bucket's row equals the single-row call
// bitwise.  Row tiles beyond gridDim.y are taken in a grid-stride loop,
// so any M >= 1 launches.
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;                  // columns of Z a block, a lane each
constexpr int kWarps = 8;
constexpr int kThreads = kCols * kWarps;   // 256
constexpr int kMaxR = 8;                   // rows a thread at most
constexpr int kMaxRows = kWarps * kMaxR;   // rows a block at most (64)
constexpr int kChunk = 32;                 // features a stage
constexpr int kWStride = kChunk + 4;       // 4 (mod 8): conflict-free
constexpr int kQStep = kThreads / kChunk;  // slab rows a stage load spans
constexpr int kWPer = kCols / kQStep;      // W loads a thread
constexpr int kXPer = kMaxRows / kQStep;   // X loads a thread

template <int R>
__global__ void __launch_bounds__(kThreads)
    rff_kernel(const float* __restrict__ X, const float* __restrict__ W,
               const float* __restrict__ b, float* __restrict__ Z, int M,
               int D, int d, float scale) {
  constexpr int kRows = kWarps * R;
  __shared__ __align__(16) float Ws[kCols * kWStride];
  __shared__ __align__(16) float Xs[kMaxRows * kChunk];
  __shared__ float bs[kCols];
  const int t = threadIdx.x, lane = t % kCols, warp = t / kCols;
  const int q = t / kChunk, f = t % kChunk;   // a stage's row, feature
  const int j0 = blockIdx.x * kCols;
  const int cols = min(kCols, D - j0);
  const int row_tiles = (M + kRows - 1) / kRows;
  bool first = true;
  for (int rt = blockIdx.y; rt < row_tiles; rt += gridDim.y) {
    const int i0 = rt * kRows;
    const int rows = min(kRows, M - i0);
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    int k0 = 0;
    do {
      const bool in_d = k0 + f < d;
      // every load of the stage first (zeros past the edges) ...
      float wv[kWPer], xv[kXPer], bv = 0.0f;
#pragma unroll
      for (int u = 0; u < kWPer; ++u) {
        const int j = q + kQStep * u;
        wv[u] = in_d && j < cols ? W[(size_t)(j0 + j) * d + k0 + f] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kXPer; ++u) {
        const int r = q + kQStep * u;
        xv[u] = in_d && r < rows ? X[(size_t)(i0 + r) * d + k0 + f] : 0.0f;
      }
      if (first && t < cols) bv = b[j0 + t];
      // ... then, once the previous stage is read, the stores
      if (!first) __syncthreads();
#pragma unroll
      for (int u = 0; u < kWPer; ++u)
        Ws[(q + kQStep * u) * kWStride + f] = wv[u];
#pragma unroll
      for (int u = 0; u < kXPer; ++u)
        Xs[(q + kQStep * u) * kChunk + f] = xv[u];
      if (first && t < kCols) bs[t] = bv;
      __syncthreads();
      first = false;
      const float* ws = Ws + lane * kWStride;
      const float* xs = Xs + warp * kChunk;   // row warp + kWarps r
#pragma unroll
      for (int k = 0; k < kChunk; k += 4) {
        const float4 w = *reinterpret_cast<const float4*>(ws + k);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 x =
              *reinterpret_cast<const float4*>(xs + r * kWarps * kChunk + k);
          acc[r] = fmaf(x.x, w.x, acc[r]);
          acc[r] = fmaf(x.y, w.y, acc[r]);
          acc[r] = fmaf(x.z, w.z, acc[r]);
          acc[r] = fmaf(x.w, w.w, acc[r]);
        }
      }
      k0 += kChunk;
    } while (k0 < d);
    const float bj = bs[lane];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = warp + kWarps * r;
      if (i < rows && lane < cols)
        Z[(size_t)(i0 + i) * D + j0 + lane] = scale * cosf(acc[r] + bj);
    }
  }
}

}  // namespace

// rows_per_thread (R: 1, 2, 4 or 8) is the wrapper's plan
// (kernels/rff.py::rff_geometry: the least R that still gives about 132
// blocks); any other value returns cudaErrorInvalidValue and launches
// nothing.
extern "C" int repro_rff(const float* X, const float* W, const float* b,
                         float* Z, int M, int D, int d, float scale,
                         int rows_per_thread, void* stream) {
  const int R = rows_per_thread;
  if (R != 1 && R != 2 && R != 4 && R != kMaxR)
    return (int)cudaErrorInvalidValue;
  if (M > 0 && D > 0) {
    const int row_tiles = (M + kWarps * R - 1) / (kWarps * R);
    const dim3 grid((D + kCols - 1) / kCols,
                    row_tiles < 65535 ? row_tiles : 65535);
    const cudaStream_t st = (cudaStream_t)stream;
    switch (R) {
      case 1: rff_kernel<1><<<grid, kThreads, 0, st>>>(X, W, b, Z, M, D, d,
                                                       scale); break;
      case 2: rff_kernel<2><<<grid, kThreads, 0, st>>>(X, W, b, Z, M, D, d,
                                                       scale); break;
      case 4: rff_kernel<4><<<grid, kThreads, 0, st>>>(X, W, b, Z, M, D, d,
                                                       scale); break;
      default: rff_kernel<kMaxR><<<grid, kThreads, 0, st>>>(X, W, b, Z, M, D,
                                                            d, scale);
    }
  }
  return (int)cudaGetLastError();
}
