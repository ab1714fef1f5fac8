// quadform: P independent forms q_p = alpha_p^T K(X_p, Y_p) beta_p,
// without materializing any Gram matrix in device memory.
//
// Replaces the TPU kernel repro/kernels/quadform.py::quadform_pallas
// (as the reference vmaps it: rkhs_dist_sq is three forms per learner).
//
// Bound: operations.  At the engine's dynamic check (m = 32 learners,
// budget 1024, d = 18) it evaluates 96 x 1024^2 kernel entries, each d
// FMAs of the cross term and about a dozen instructions of the gaussian
// (norms, clamp, expf), all float32 on the CUDA cores: about 65 us at
// fp32's 67 TFLOP/s.  What keeps a kernel from that rate is the
// instructions it spends on everything but FMAs: a shared-memory load per
// FMA, a branch on the kind per entry, the norms recomputed per entry,
// index arithmetic and barriers per column tile.  So:
// - the kind is a template parameter: one loop per kind, no branch;
// - each thread owns a 4 x 8 register tile of (rows, columns), two 4 x 4
//   halves 64 columns apart; features are staged transposed in shared
//   memory, so one 16-byte load of four rows' x_k and two of four
//   columns' y_k feed 32 FMAs;
// - the squared norms are computed once per block for its rows and once
//   per column tile for its columns (from the staged features, two
//   partial sums a column in a fixed order), and read from shared memory;
// - the rows' features are staged once per block when d fits one chunk
//   of 32 features (d = 18 does); a larger d streams the chunks of rows
//   and columns per column tile;
// - the next column tile's features are loaded into registers while this
//   one computes, and a column tile is 128 wide, so its two barriers and
//   its index arithmetic are spread over 32 entries a thread.
// The gaussian keeps the reference's max(xx + yy - 2 cross, 0) and full
// expf (no fast math).
//
// Two passes; the TPU kernel carries one scalar across its sequential
// grid steps, while blocks here run in parallel in no order:
//   pass 1: block (r, p) owns rows [64 r, 64 r + 64) of form p and walks
//     all columns of Y_p in tiles of 128; each thread accumulates, tile by
//     tile and column by column, beta_j * sum_i alpha_i K_ij over its
//     4 x 8 entries in a fixed order, then a fixed-order block reduce
//     writes partial[p, r];
//   pass 2: one thread per form sums its partials in order r = 0..R-1.
// No float atomics, no cross-block sum in run-dependent order: a run
// gives the same bits every time.  Padded rows and columns are staged as
// zeros with alpha = 0 and beta = 0, so their entries stay finite and
// add exactly 0.
#include "common.cuh"

namespace {

constexpr int kTM = 64;         // rows of X_p per block
constexpr int kTN = 128;        // columns of Y_p per step
constexpr int kTile = 4;        // a thread's rows, and columns per half
constexpr int kThreads = 256;   // 16 x 16: 4 rows x (2 x 4) columns each
constexpr int kChunk = 32;      // features staged in shared memory at once
constexpr int kPad = 4;         // row padding: fewer bank conflicts on
                                // staging, 16-byte rows kept
// Staging: thread t moves row (column) t % R of R rows (columns) of the
// tile, features f + L u for f = t / R, L = kThreads / R lanes.
constexpr int kLanesX = kThreads / kTM, kPerLaneX = kChunk / kLanesX;
constexpr int kLanesY = kThreads / kTN, kPerLaneY = kChunk / kLanesY;
static_assert(kLanesY == 2, "a column's norm is two partial sums");

// features [k0, k0 + kc) of rows [first, first + R) of src (n of them
// real, the rest zero) for this thread, in the staging map above
template <int R, int NV>
__device__ __forceinline__ void fetch(float (&v)[NV], const float* src,
                                      int d, int first, int n, int k0,
                                      int kc) {
  const int i = threadIdx.x % R, f = threadIdx.x / R;
  const float* row = src + (size_t)(first + i) * d + k0;
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int k = f + (kThreads / R) * u;
    v[u] = i < n && k < kc ? row[k] : 0.0f;
  }
}
template <int R, int NV>
__device__ __forceinline__ void put(float (*dst)[R + kPad],
                                    const float (&v)[NV], int kc) {
  const int i = threadIdx.x % R, f = threadIdx.x / R;
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int k = f + (kThreads / R) * u;
    if (k < kc) dst[k][i] = v[u];
  }
}

template <int KIND>
__global__ void __launch_bounds__(kThreads, 3)
quadform_partial_kernel(const float* __restrict__ X,
                        const float* __restrict__ Y,
                        const float* __restrict__ alpha,
                        const float* __restrict__ beta,
                        float* __restrict__ partial, int M, int N, int d,
                        float gamma, int degree, float coef0) {
  __shared__ __align__(16) float xs[kChunk][kTM + kPad];   // xs[k][row]
  __shared__ __align__(16) float ys[kChunk][kTN + kPad];   // ys[k][col]
  __shared__ float xx_s[kTM], a_s[kTM];
  __shared__ float yy_s[kLanesY][kTN], b_s[kTN];
  __shared__ float red[kThreads];

  const int r = blockIdx.x;
  const int p = blockIdx.y;
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int row0 = r * kTM;
  const int rows = min(kTM, M - row0);
  const float* Xp = X + (size_t)p * M * d;
  const float* Yp = Y + (size_t)p * N * d;
  const float* Ap = alpha + (size_t)p * M;
  const float* Bp = beta + (size_t)p * N;
  const bool x_once = d <= kChunk;

  if (t < kTM) {
    float s = 0.0f, av = 0.0f;
    if (t < rows) {
      const float* xr = Xp + (size_t)(row0 + t) * d;
      for (int k = 0; k < d; ++k) s += xr[k] * xr[k];
      av = Ap[row0 + t];
    }
    xx_s[t] = s;
    a_s[t] = av;
  }
  if (x_once) {   // the rows' features stay for the whole block
    float w[kPerLaneX];
    fetch<kTM>(w, Xp, d, row0, rows, 0, d);
    put<kTM>(xs, w, d);
  }
  __syncthreads();
  float xx[kTile], a[kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    xx[i] = xx_s[ty * kTile + i];
    a[i] = a_s[ty * kTile + i];
  }

  // the next chunk's column features wait in registers (v, b) while this
  // one computes, so no load of Y is on the critical path
  float v[kPerLaneY], b = 0.0f;
  auto fetch_y = [&](int col0, int k0) {
    fetch<kTN>(v, Yp, d, col0, N - col0, k0, min(kChunk, d - k0));
    if (k0 == 0 && t < kTN) b = col0 + t < N ? Bp[col0 + t] : 0.0f;
  };
  if (N > 0) fetch_y(0, 0);

  float acc = 0.0f;
  for (int col0 = 0; col0 < N; col0 += kTN) {
    float cross[2][kTile][kTile];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < kTile; ++i)
#pragma unroll
        for (int j = 0; j < kTile; ++j) cross[h][i][j] = 0.0f;
    float yy = 0.0f;   // this thread's share of its staged column's norm
    for (int k0 = 0; k0 < d; k0 += kChunk) {
      const int kc = min(kChunk, d - k0);
      __syncthreads();   // the last chunk's reads are done
      put<kTN>(ys, v, kc);
#pragma unroll
      for (int u = 0; u < kPerLaneY; ++u) yy += v[u] * v[u];   // 0 past kc
      if (k0 + kChunk >= d) {
        yy_s[t / kTN][t % kTN] = yy;
        if (t < kTN) b_s[t] = b;
      }
      if (!x_once) {
        float w[kPerLaneX];
        fetch<kTM>(w, Xp, d, row0, rows, k0, kc);
        put<kTM>(xs, w, kc);
      }
      __syncthreads();
      if (k0 + kChunk < d)
        fetch_y(col0, k0 + kChunk);
      else if (col0 + kTN < N)
        fetch_y(col0 + kTN, 0);
#pragma unroll 2
      for (int k = 0; k < kc; ++k) {
        const float4 xv = *reinterpret_cast<const float4*>(&xs[k][ty * kTile]);
        const float xk[kTile] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 yv = *reinterpret_cast<const float4*>(
              &ys[k][h * (kTN / 2) + tx * kTile]);
          const float yk[kTile] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
          for (int i = 0; i < kTile; ++i)
#pragma unroll
            for (int j = 0; j < kTile; ++j)
              cross[h][i][j] = fmaf(xk[i], yk[j], cross[h][i][j]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const int col = h * (kTN / 2) + tx * kTile + j;
        const float yyc = yy_s[0][col] + yy_s[1][col];
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < kTile; ++i)
          s += a[i] * kernel_value<KIND>(cross[h][i][j], xx[i], yyc, gamma,
                                         degree, coef0);
        acc += b_s[col] * s;
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

template <int KIND>
void launch_partial(dim3 grid, cudaStream_t stream, const float* X,
                    const float* Y, const float* alpha, const float* beta,
                    float* partial, int M, int N, int d, float gamma,
                    int degree, float coef0) {
  quadform_partial_kernel<KIND><<<grid, kThreads, 0, stream>>>(
      X, Y, alpha, beta, partial, M, N, d, gamma, degree, coef0);
}

}  // namespace

// partial must hold P * ceil(M / kTM) floats (kTM = 64, mirrored by
// ROWS_PER_BLOCK in kernels/quadform.py).
extern "C" int repro_quadform(const float* X, const float* Y,
                              const float* alpha, const float* beta,
                              float* partial, float* out, int P, int M, int N,
                              int d, int kind, float gamma, int degree,
                              float coef0, void* stream) {
  if (P > 0 && M > 0) {
    const int R = (M + kTM - 1) / kTM;
    const dim3 grid(R, P);
    cudaStream_t st = (cudaStream_t)stream;
    if (kind == KIND_LINEAR)
      launch_partial<KIND_LINEAR>(grid, st, X, Y, alpha, beta, partial, M, N,
                                  d, gamma, degree, coef0);
    else if (kind == KIND_POLY)
      launch_partial<KIND_POLY>(grid, st, X, Y, alpha, beta, partial, M, N,
                                d, gamma, degree, coef0);
    else
      launch_partial<KIND_GAUSSIAN>(grid, st, X, Y, alpha, beta, partial, M,
                                    N, d, gamma, degree, coef0);
    quadform_finish_kernel<<<(P + 127) / 128, 128, 0, st>>>(partial, out, P,
                                                             R);
  }
  return (int)cudaGetLastError();
}
