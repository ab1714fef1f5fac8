// sv_predict: yhat_i = sum_j k(x_i, SV_ij) A_ij for B stacked learners.
//
// Replaces the TPU kernel repro/kernels/fused.py::sv_predict_pallas
// (body _sv_predict_kernel / _kernel_row).
//
// Bound: bytes.  At the engine's shape (B = 32 learners, budget
// N = 1024, d = 18) it reads B (N d + N + d) floats and writes B:
// 2,494,592 bytes, 0.000745 ms at 3.35 TB/s.  The work is small, so
// what a design has to beat is latency: the first design (one block of
// 128 threads per row, each thread reading 18-float rows 72 bytes apart
// from device memory, a 7-step barrier tree) kept 32 SMs busy at 11 us.
//
// Geometry (kernels/fused.py::sv_predict_geometry, checked here): row i
// gets a thread-block cluster of C = min(8, ceil(N / 128)) blocks of 128
// threads; block r of the cluster owns the budget slots
// [r chunk, min(N, (r + 1) chunk)), chunk = ceil(N / C), never empty.
// At N = 1024 that is 8 blocks of 128 slots, 256 blocks at B = 32.
// C and chunk depend on N alone, the staging tile on N and d.
//
// Loads: a block's slots are contiguous in SV (chunk x d floats) and in
// A.  Thread 0 stages them into shared memory (common.cuh, "Staging"):
// each run's 16-byte aligned body as one TMA bulk copy, its at most 3
// unaligned floats at either end as 4-byte cp.async copies, all counted
// on the stage's mbarrier (at N = 1024, d = 18 every run is aligned and
// has no ends).  Tiles of `tile` slots, two in flight from the start and
// a buffer refilled as soon as every thread is done with it.  The entry
// point picks the tile from this file's shared-memory layout: up to 128
// slots, halved until the stages fit a block (only a very wide d halves
// it).  Whether a block has more than one tile is a template parameter,
// so the main shape runs straight-line code.  The staged rows keep the
// global stride d; at d = 18 thread t reads its row as float2 at 9 t
// float2s, 16 distinct banks a half-warp: no conflict.  The query row
// goes to shared memory once, and each thread forms xx = <x, x> from it
// in k order.
//
// Summation order (a row's floats depend on N and d only, never on B):
//   1. thread t of block r adds k(x_i, s_j) a_j for its slots
//      j = r chunk + t, + tile, + 2 tile, ... in that order;
//   2. each warp sums its 32 threads by a fixed shuffle tree (offsets
//      16, 8, 4, 2, 1); thread 0 adds the 4 warps' sums in warp order;
//   3. every block r > 0 writes its sum into rank 0's parts[r] through
//      distributed shared memory (st.async, counted on rank 0's
//      mbarrier); rank 0 waits for the C - 1 sums, adds parts[0..C-1] in
//      rank order and writes out[i].  A split cluster barrier (arrive at
//      the start, wait before the first remote write) makes sure that
//      every block of the cluster has started and rank 0's mbarrier is
//      initialized.
// The sums only move towards rank 0, and rank 0 cannot exit before they
// have all landed, so no closing barrier is needed: blocks r > 0 exit
// right after their write.  No float atomics, one launch.  Padded slots
// carry A = 0 and add exactly 0; the kind (gaussian, linear, poly) is a
// template parameter.
//
// Registers and shared memory (ptxas -v, sm_90a, from the build log the
// kernels' build writes beside the library, build/<hash>/build.log, and
// chip_smoke.py saves as chip_smoke_build.log; on an H100): the one-tile
// instances (the main shape's) 32 registers, 64 bytes of static shared
// memory a block, no stack, and 9,840 bytes of dynamic shared memory at
// N = 1024, d = 18; the multi-tile instances 48 to 56 registers and 80
// bytes of static shared memory; no spills.
#include <algorithm>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;      // a block's threads; a tile's most slots
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kSmemLimit = 232448; // shared memory bytes a block can use

// floats of one stage: the SV tile and the A tile, each staged
__host__ __device__ __forceinline__ int stage_floats(int tile, int d) {
  return staged_floats(tile * d) + staged_floats(tile);
}

// bytes of dynamic shared memory: the query row and the stages (two when
// a block has more than one tile)
long long smem_bytes(int d, int chunk, int tile) {
  return 4LL * (round4(d) + (chunk > tile ? 2LL : 1LL) *
                                (long long)stage_floats(tile, d));
}

// MULTI: a block may own more than one tile (chunk > tile).
template <int KIND, bool MULTI>
__global__ void __launch_bounds__(kThreads)
    sv_predict_kernel(const float* __restrict__ X,
                      const float* __restrict__ SV,
                      const float* __restrict__ A, float* __restrict__ out,
                      int N, int d, int chunk, int tile, float gamma,
                      int degree, float coef0) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kThreads / 32];
  __shared__ float parts[kMaxCluster];
  // each stage's copies: two scalars, not an array (an indexed array of
  // barriers compiled to a slower wait on the H100)
  __shared__ __align__(8) uint64_t full0, full1;
  __shared__ __align__(8) uint64_t sums;      // the C - 1 block sums
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int i = blockIdx.x / C;
  const int t = threadIdx.x;
  const int j0 = min(N, rank * chunk);
  const int n = min(N, j0 + chunk) - j0;
  const int ntiles = MULTI ? (n + tile - 1) / tile : min(n, 1);
  const int sf = stage_floats(tile, d);
  const int a_at = staged_floats(tile * d);
  float* xs = smem;
  float* stages = smem + round4(d);
  const float* sv = SV + ((size_t)i * N + j0) * d;
  const float* a = A + (size_t)i * N + j0;

  // tile s goes to stage buffer s & 1, counted on its barrier
  auto stage_of = [](int s) { return MULTI ? s & 1 : 0; };
  auto full = [&](int s) { return stage_of(s) ? &full1 : &full0; };
  if (t == 0) {
    mbar_init(&full0, 1);
    if (MULTI) mbar_init(&full1, 1);
    mbar_init(&sums, 1);
    mbar_init_fence();
  }
  // by thread 0 (common.cuh: "Staging")
  auto issue = [&](int s) {
    const int first = s * tile;
    const int cnt = min(tile, n - first);
    float* buf = stages + stage_of(s) * sf;
    const float* svs = sv + (size_t)first * d;
    const Run runs[2] = {run_of(buf, svs, cnt * d),
                         run_of(buf + a_at, a + first, cnt)};
    stage_runs(runs, full(s));
  };

  if (t == 0 && ntiles > 0) issue(0);
  if (t == 0 && MULTI && ntiles > 1) issue(1);
  cluster_arrive_relaxed();
  for (int k = t; k < d; k += kThreads) xs[k] = X[(size_t)i * d + k];
  __syncthreads();   // the query row; the barriers initialized
  float xx = 0.0f;
  for (int k = 0; k < d; ++k) xx = fmaf(xs[k], xs[k], xx);

  float acc = 0.0f;
  for (int s = 0; s < ntiles; ++s) {
    mbar_wait(full(s), MULTI ? (s >> 1) & 1 : 0);
    const int first = s * tile;
    if (t < min(tile, n - first)) {
      const float* buf = stages + stage_of(s) * sf;
      const float* row = buf + (size_t)t * d + align_of(sv + (size_t)first * d);
      const float av = buf[a_at + t + align_of(a + first)];
      float cross, yy;
      row_dots(xs, row, d, cross, yy);
      acc = fmaf(kernel_value<KIND>(cross, xx, yy, gamma, degree, coef0),
                 av, acc);
    }
    if (!MULTI) break;   // (one tile: no loop in the code)
    if (s + 2 < ntiles) {
      __syncthreads();   // every thread is done with stage s & 1
      if (t == 0) issue(s + 2);
    }
  }

  const float total = block_sum_ordered(acc, red);
  cluster_wait();   // every block has started; rank 0's barrier is ready
  if (t != 0) return;
  if (rank != 0) {
    st_async(cluster_addr(&parts[rank], 0), total, cluster_addr(&sums, 0));
    return;
  }
  parts[0] = total;
  mbar_arrive_expect(&sums, 4u * (C - 1));
  mbar_wait(&sums, 0);
  float sum = parts[0];
  for (int r = 1; r < C; ++r) sum += parts[r];
  out[i] = sum;
}

template <int KIND, bool MULTI>
cudaError_t launch(int B, int C, int smem, cudaStream_t stream,
                   const float* X, const float* SV, const float* A,
                   float* out, int N, int d, int chunk, int tile,
                   float gamma, int degree, float coef0) {
  auto kernel = sv_predict_kernel<KIND, MULTI>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * (unsigned)C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, X, SV, A, out, N, d, chunk, tile,
                            gamma, degree, coef0);
}

template <int KIND>
cudaError_t launch_kind(bool multi, int B, int C, int smem, cudaStream_t st,
                        const float* X, const float* SV, const float* A,
                        float* out, int N, int d, int chunk, int tile,
                        float gamma, int degree, float coef0) {
  const auto go = multi ? launch<KIND, true> : launch<KIND, false>;
  return go(B, C, smem, st, X, SV, A, out, N, d, chunk, tile, gamma, degree,
            coef0);
}

}  // namespace

// cluster, chunk: kernels/fused.py::sv_predict_geometry(N, d); the tile
// is this file's to pick.  A geometry or a width this kernel cannot run
// returns cudaErrorInvalidValue and launches nothing.
extern "C" int repro_sv_predict(const float* X, const float* SV,
                                const float* A, float* out, int B, int N,
                                int d, int kind, float gamma, int degree,
                                float coef0, int cluster, int chunk,
                                void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const bool covers = N == 0 ? cluster == 1
                             : (long long)(cluster - 1) * chunk < N &&
                                   (long long)cluster * chunk >= N;
  if (d < 1 || N < 0 || cluster < 1 || cluster > kMaxCluster || chunk < 0 ||
      !covers || kind < KIND_GAUSSIAN || kind > KIND_POLY)
    return (int)cudaErrorInvalidValue;
  int tile = std::max(1, std::min(kThreads, chunk));
  while (tile > 1 && smem_bytes(d, chunk, tile) > kSmemLimit) tile /= 2;
  const long long smem = smem_bytes(d, chunk, tile);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const bool multi = chunk > tile;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (kind == KIND_LINEAR)
    err = launch_kind<KIND_LINEAR>(multi, B, cluster, (int)smem, st, X, SV,
                                   A, out, N, d, chunk, tile, gamma, degree,
                                   coef0);
  else if (kind == KIND_POLY)
    err = launch_kind<KIND_POLY>(multi, B, cluster, (int)smem, st, X, SV, A,
                                 out, N, d, chunk, tile, gamma, degree, coef0);
  else
    err = launch_kind<KIND_GAUSSIAN>(multi, B, cluster, (int)smem, st, X, SV,
                                     A, out, N, d, chunk, tile, gamma, degree,
                                     coef0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
