// primal_step: one whole online round for B stacked primal learners —
// z = scale cos(W x + bias) (RFF) or z = x (linear), yhat = <w, z> + b,
// the hinge or squared loss and its gradient g, and the NORMA update
// w' = (1 - eta lam) w - eta g z, b' = b - eta g.
//
// Replaces the TPU kernel repro/kernels/fused.py::primal_step_pallas
// (bodies _rff_step_kernel, _linear_step_kernel, _primal_step_math).
//
// Bound: bytes.  At the engine's RFF shape (B = 32, D = 2048, d = 18)
// it reads x, y, w, b (B (d + D + 2) floats) and W, bias (D (d + 1),
// read once: every row shares them) and writes w', b', ell, yhat
// (B (D + 3)): 684,416 bytes, 0.000204 ms at 3.35 TB/s.  The launch and
// the latency of a few dependent steps are what a design has to beat:
// the first design (one block of 256 threads per learner, W rows read
// 72 bytes apart from device memory, every feature computed twice, a
// barrier tree and thread 0 alone on the loss) took 16 us.
//
// RFF geometry (kernels/fused.py::primal_step_geometry, checked here):
// learner i gets a thread-block cluster of C = min(8, ceil(D / 256))
// blocks of 256 threads; block r owns the features [r slice,
// min(D, (r + 1) slice)), slice = ceil(D / C), never empty: 8 blocks of
// 256 features at D = 2048, 256 blocks at B = 32.  C and slice depend on
// D alone, the staging tile on D and d.
//
// Each feature once: a block stages its slice of W (contiguous, slice x
// d floats; every learner reads the same W, which stays in L2) into
// shared memory, by thread 0 (common.cuh, "Staging": the run's 16-byte
// aligned body as one TMA bulk copy, its unaligned ends as 4-byte
// cp.async copies, counted on one mbarrier; at D = 2048, d = 18 every
// slice is aligned), in tiles of `tile` features: stage, wait, compute,
// repeat, one buffer.  The entry point picks the tile from this file's
// shared-memory layout: up to 256 features, halved until it fits a
// block, so the engine's shapes (a slice of at most 256 features at
// d = 18) take one tile.  Rows keep the stride d: at d = 18 the float2
// reads hit 16 distinct banks a half-warp.  Thread t computes the
// features t, t + tile, ... of the slice: the d-dot in k order, one
// cosf, and keeps z and w in shared memory for the update; w and bias
// come as coalesced loads issued before the wait for the tile.
//
// Reduction and broadcast in one exchange (a learner's floats depend on
// D and d only, never on B):
//   1. thread t adds w_j z_j over its features in order; each warp sums
//      its threads by a fixed shuffle tree (offsets 16, 8, 4, 2, 1);
//      thread 0 adds the warps' sums in warp order;
//   2. thread 0 of every block r writes that sum into parts[r] of every
//      block of the cluster (itself included) through distributed shared
//      memory (st.async, counted on the receiver's mbarrier), after a
//      split cluster barrier (arrive at the start, wait before the first
//      remote write: every block has started, every mbarrier is ready);
//   3. every thread of every block waits for its C sums and adds
//      parts[0..C-1] in rank order: each block holds the same yhat
//      bitwise and forms the loss and g itself, so g needs no second
//      exchange; rank 0 writes b', ell and yhat;
//   4. the block writes w' over its slice as 16-byte stores (4-byte at
//      the unaligned ends), w' = fmaf(-eta g, z, decay w) in every path.
// No block reads another's memory after the exchange, and none exits
// before its C sums have landed, so no closing barrier is needed.  No
// float atomics, one launch.
//
// Linear variant (z = x, D = d; B = 1024, D = 18 at the engine).  Bound:
// bytes, B (3 D + 5) floats, 241,664 bytes or 0.0000721 ms at the
// engine's shape; what a design has to beat is the launch (0.00114 ms
// device for one PyTorch kernel on one element) and the chain of
// dependent steps behind it.  The first design (a block of a power of
// two >= 32 threads a learner: x staged in shared memory, a barrier, w
// loaded after it, a five-barrier shared-memory tree, thread 0 alone on
// the loss, a barrier to hand g on) took 0.00267 ms.  This one
// (kernels/fused.py::primal_step_geometry(D, False) = (1, 32), checked
// here):
// - a warp a learner, 8 learners a block (contiguous rows of x and w);
//   lane l owns the features l, l + 32, ... < D: one path for every D,
//   no shared memory, no barrier;
// - every lane loads its x_j and w_j as the warp's coalesced run of the
//   row (one 72-byte run an operand at D = 18), and the label and bias
//   in the same round trip; scalar loads, because 16-byte ones would
//   tie the lane order to the row's alignment;
// - yhat: each lane's fmaf sum in j order, then the fixed shuffle tree
//   (offsets 16, 8, 4, 2, 1); lane 0 forms the loss, g and b', and one
//   __shfl_sync hands g to the warp;
// - w' = fmaf(-eta g, x, decay w) as in the RFF path, a coalesced store
//   a lane and feature.
// A learner's floats depend on D alone: not on B, not on its warp in the
// block.  At D <= 32 they are the first design's bitwise (the same
// products, the same tree).
//
// Registers and shared memory (ptxas -v, sm_90a, from the build log the
// kernels' build writes beside the library, build/<hash>/build.log, and
// chip_smoke.py saves as chip_smoke_build.log; on an H100): the RFF kernel
// 63 registers, 80 bytes of static shared memory a block, 32 bytes of
// stack (cosf's path for huge arguments), no spills, and 20,576 bytes of
// dynamic shared memory at D = 2048, d = 18; the linear kernel 32
// registers, no shared memory, no barrier.
#include <algorithm>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRffThreads = 256;      // an RFF block's threads; a tile's most
constexpr int kMaxCluster = 8;        // the portable cluster size
constexpr int kLinearWarps = 8;       // learners a linear block, a warp each
constexpr int kLinearThreads = 32 * kLinearWarps;
constexpr int kSmemLimit = 232448;    // shared memory bytes a block can use

enum Loss { LOSS_HINGE = 0, LOSS_SQUARED = 1 };

// the loss and its gradient at yhat, as _primal_step_math
__device__ __forceinline__ void loss_grad(int loss, float yhat, float y,
                                          float& l, float& g) {
  if (loss == LOSS_HINGE) {
    l = fmaxf(0.0f, 1.0f - y * yhat);
    g = l > 0.0f ? -y : 0.0f;
  } else {
    const float r = yhat - y;
    l = 0.5f * r * r;
    g = r;
  }
}

// the NORMA update of one weight, one rounding order in every path
__device__ __forceinline__ float norma(float decay, float w, float step,
                                       float z) {
  return fmaf(-step, z, decay * w);
}

// bytes of dynamic shared memory for the RFF block: the example (d), w
// and z of the slice, and one staged W tile
long long rff_smem_bytes(int d, int slice, int tile) {
  return 4LL * (round4(d) + 2LL * round4(slice) + staged_floats(tile * d));
}

__global__ void __launch_bounds__(kRffThreads)
    rff_step_kernel(const float* __restrict__ X, const float* __restrict__ Yl,
                    const float* __restrict__ w, const float* __restrict__ b,
                    const float* __restrict__ W,
                    const float* __restrict__ bias,
                    float* __restrict__ w_new, float* __restrict__ b_new,
                    float* __restrict__ ell_out, float* __restrict__ yhat_out,
                    int d, int D, int slice, int tile, float scale, int loss,
                    float eta, float decay) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kRffThreads / 32];
  __shared__ float parts[kMaxCluster];
  __shared__ __align__(8) uint64_t full;      // a W tile's copies
  __shared__ __align__(8) uint64_t sums;      // the C block sums
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int i = blockIdx.x / C;
  const int t = threadIdx.x;
  const int j0 = min(D, rank * slice);
  const int n = min(D, j0 + slice) - j0;
  float* xs = smem;
  float* ws = xs + round4(d);
  float* zs = ws + round4(slice);
  float* Ws = zs + round4(slice);
  const float* Wb = W + (size_t)j0 * d;
  const float* wi = w + (size_t)i * D + j0;

  if (t == 0) {
    mbar_init(&full, 1);
    mbar_init(&sums, 1);
    mbar_init_fence();
  }
  // by thread 0 (common.cuh: "Staging")
  auto stage = [&](int first) {
    const Run runs[1] = {
        run_of(Ws, Wb + (size_t)first * d, min(tile, n - first) * d)};
    stage_runs(runs, &full);
  };
  // w and bias of the thread's feature in the tile from `first`, loaded
  // before the wait for the tile
  float wv = 0.0f, bv = 0.0f;
  auto load = [&](int first) {
    if (t < min(tile, n - first)) {
      wv = wi[first + t];
      bv = bias[j0 + first + t];
    }
  };

  if (t == 0 && n > 0) stage(0);
  cluster_arrive_relaxed();
  for (int k = t; k < d; k += kRffThreads) xs[k] = X[(size_t)i * d + k];
  const float y = Yl[i], bi = b[i];
  load(0);
  __syncthreads();   // the example; the barriers initialized

  float acc = 0.0f;
  for (int first = 0, s = 0; first < n; first += tile, ++s) {
    mbar_wait(&full, s & 1);
    if (t < min(tile, n - first)) {
      const int e = first + t;
      const float* row = Ws + (size_t)t * d + align_of(Wb + (size_t)first * d);
      float proj, unused;
      row_dots(xs, row, d, proj, unused);
      const float z = scale * cosf(proj + bv);
      ws[e] = wv;
      zs[e] = z;
      acc = fmaf(wv, z, acc);
    }
    if (first + tile < n) {
      __syncthreads();   // every thread is done with the tile
      if (t == 0) stage(first + tile);
      load(first + tile);
    }
  }

  // (its barrier also makes every thread's w and z visible to pass 2)
  const float total = block_sum_ordered(acc, red);
  cluster_wait();   // every block has started; every barrier is ready
  if (t == 0) {
    mbar_arrive_expect(&sums, 4u * C);
    for (int r = 0; r < C; ++r)
      st_async(cluster_addr(&parts[rank], r), total, cluster_addr(&sums, r));
  }
  mbar_wait(&sums, 0);
  float dot = parts[0];
  for (int r = 1; r < C; ++r) dot += parts[r];
  const float yhat = dot + bi;
  float l, g;
  loss_grad(loss, yhat, y, l, g);
  if (rank == 0 && t == 0) {
    ell_out[i] = l;
    yhat_out[i] = yhat;
    b_new[i] = bi - eta * g;
  }
  const float step = eta * g;
  float* wo = w_new + (size_t)i * D + j0;
  const int head = min(n, (4 - align_of(wo)) & 3);
  const int vecs = (n - head) >> 2;
  const int tail = head + 4 * vecs;
  if (t < head) wo[t] = norma(decay, ws[t], step, zs[t]);
  for (int v = t; v < vecs; v += kRffThreads) {
    const int e = head + 4 * v;
    float4 o;
    o.x = norma(decay, ws[e], step, zs[e]);
    o.y = norma(decay, ws[e + 1], step, zs[e + 1]);
    o.z = norma(decay, ws[e + 2], step, zs[e + 2]);
    o.w = norma(decay, ws[e + 3], step, zs[e + 3]);
    *reinterpret_cast<float4*>(wo + e) = o;
  }
  if (t < n - tail)
    wo[tail + t] = norma(decay, ws[tail + t], step, zs[tail + t]);
}

__global__ void __launch_bounds__(kLinearThreads)
    linear_step_kernel(const float* __restrict__ X,
                       const float* __restrict__ Yl,
                       const float* __restrict__ w,
                       const float* __restrict__ b,
                       float* __restrict__ w_new, float* __restrict__ b_new,
                       float* __restrict__ ell_out,
                       float* __restrict__ yhat_out, int B, int D, float eta,
                       float decay, int loss) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kLinearWarps + (threadIdx.x >> 5);
  if (i >= B) return;   // a whole warp: the shuffles below see all 32 lanes
  const float* xi = X + (size_t)i * D;
  const float* wi = w + (size_t)i * D;
  // the label and bias with the first features: one round trip
  const float y = Yl[i], bi = b[i];
  float acc = 0.0f;
  for (int j = lane; j < D; j += 32) acc = fmaf(wi[j], xi[j], acc);
  const float dot = warp_sum(acc);   // lane 0's
  float l = 0.0f, g = 0.0f;
  if (lane == 0) {
    const float yhat = dot + bi;
    loss_grad(loss, yhat, y, l, g);
    ell_out[i] = l;
    yhat_out[i] = yhat;
    b_new[i] = bi - eta * g;
  }
  const float step = eta * __shfl_sync(0xffffffffu, g, 0);
  float* wo = w_new + (size_t)i * D;
  for (int j = lane; j < D; j += 32) wo[j] = norma(decay, wi[j], step, xi[j]);
}

cudaError_t launch_rff(int B, int C, int smem, cudaStream_t stream,
                       const float* X, const float* Yl, const float* w,
                       const float* b, const float* W, const float* bias,
                       float* w_new, float* b_new, float* ell, float* yhat,
                       int d, int D, int slice, int tile, float scale,
                       int loss, float eta, float decay) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rff_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * (unsigned)C);
  cfg.blockDim = dim3(kRffThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, rff_step_kernel, X, Yl, w, b, W, bias,
                            w_new, b_new, ell, yhat, d, D, slice, tile, scale,
                            loss, eta, decay);
}

}  // namespace

// cluster, chunk: kernels/fused.py::primal_step_geometry(D, featurize).
// RFF: the cluster and its slice of the features, the tile this file's to
// pick; linear: cluster 1 and chunk 32, a warp a learner whose lane l
// owns the features l, l + 32, ...  A geometry or a width this kernel
// cannot run returns cudaErrorInvalidValue and launches nothing.
extern "C" int repro_primal_step(const float* X, const float* Yl,
                                 const float* w, const float* b,
                                 const float* W, const float* bias,
                                 float* w_new, float* b_new, float* ell,
                                 float* yhat, int B, int d, int D,
                                 int featurize, float scale, int loss,
                                 float eta, float decay, int cluster,
                                 int chunk, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (loss != LOSS_HINGE && loss != LOSS_SQUARED)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!featurize) {
    if (D != d || D < 1 || cluster != 1 || chunk != 32)
      return (int)cudaErrorInvalidValue;
    linear_step_kernel<<<(B + kLinearWarps - 1) / kLinearWarps,
                         kLinearThreads, 0, st>>>(
        X, Yl, w, b, w_new, b_new, ell, yhat, B, D, eta, decay, loss);
    return (int)cudaGetLastError();
  }
  const bool covers = D == 0 ? cluster == 1
                             : (long long)(cluster - 1) * chunk < D &&
                                   (long long)cluster * chunk >= D;
  if (d < 1 || D < 0 || cluster < 1 || cluster > kMaxCluster || chunk < 0 ||
      !covers)
    return (int)cudaErrorInvalidValue;
  int tile = std::max(1, std::min(kRffThreads, chunk));
  while (tile > 1 && rff_smem_bytes(d, chunk, tile) > kSmemLimit) tile /= 2;
  const long long smem = rff_smem_bytes(d, chunk, tile);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      launch_rff(B, cluster, (int)smem, st, X, Yl, w, b, W, bias, w_new,
                 b_new, ell, yhat, d, D, chunk, tile, scale, loss, eta, decay);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
