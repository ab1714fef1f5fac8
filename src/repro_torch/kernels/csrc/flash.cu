// flash: attention with the online-softmax recurrence,
//   O[bh, i, :] = sum_j softmax_j(scale * <q[bh, i, :], k[bh, j, :]>) v[bh, j, :]
// over the keys j that query i may see: all of them, j <= i (causal), and
// with window > 0 also j > i - window.  q (BH, S, hd), k and v (BH, L, hd),
// O (BH, S, hd), row-major, all float32 or all bfloat16.
//
// Replaces the TPU kernel repro/kernels/flash.py::flash_attention (body
// _flash_kernel).  There the grid is (BH, S/bq, L/bk) and the kv axis runs
// in order on one core, carrying the running max m, the normalizer l and
// the unnormalized accumulator acc in VMEM scratch from one grid step to
// the next.  Here that sequential axis is a loop inside one block: a block
// owns one (bh, query tile) pair, streams the K and V tiles it needs
// through shared memory and keeps m, l and acc in registers.  No block
// reads another's sums: no split over the keys, no atomics, so a repeat
// is bitwise.
//
// Numbers follow the reference: q, k, v are read in their type and
// widened to float32; scores, exp, the sums and p.v are float32 (the TPU
// kernel upcasts and asks for preferred_element_type=float32); masked
// scores are -1e30 exactly as there, so a row that has seen no visible
// key yet is wiped by alpha = exp(-1e30 - m) = 0 once it does; the output
// is acc / max(l, 1e-30), rounded once to the input type.  Keys past L
// (the ragged edge) are -inf: they take no part in the max or the sums,
// so any S and L work without padding.  Tiles that no query of the block
// may see are skipped, as the TPU kernel skips them with pl.when.
//
// Bound: operations.  Causal at the LM's prefill shape (BH 64, S 1500,
// hd 128, bf16) the visible pairs need 4 hd flops each (q.k and p.v),
// 3.7e10 float32 operations (0.55 ms at 67 TFLOP/s) against 98 MB of
// q, k, v and O (0.03 ms at 3.35 TB/s).  This first version does them
// as plain float32 FMAs from shared memory (no tensor cores: they would
// round the products to TF32 or bf16, which the reference does not).
//
// Layout: 256 threads as 16 x 16.  Thread (ty, tx) owns query rows
// ty*4 .. ty*4+3 of the tile; for the scores it owns keys tx + 16 b
// (b < 4), for the output columns tx + 16 c (c < hd/16).  Row max and
// row sums go through a butterfly of warp shuffles over the 16 tx lanes,
// which gives every lane the same floats.  Q is kept transposed in shared
// memory for the whole loop; one buffer holds K (transposed) and then V,
// so a block takes 82 KB at hd 128 and two blocks fit on an SM.  Query
// tiles are issued last first: under the causal mask they have the most
// keys.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kPStride = kBK + 4;   // P row stride: no bank conflict across ty
constexpr float kMasked = -1e30f;   // the reference's NEG_INF

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int s = 1; s < 16; s <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int s = 1; s < 16; s <<= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

template <int HD>
constexpr int smem_floats() {
  // Q^T [HD][kBQ + 1]; K^T [HD][kBK + 1] or V [kBK][HD]; P [kBQ][kPStride]
  return HD * (kBQ + 1) + HD * (kBK + 1) + kBQ * kPStride;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int L,
             float scale, int causal, int window) {
  static_assert(HD % 16 == 0 && HD * (kBK + 1) >= kBK * HD, "head dim");
  constexpr int kC = HD / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qt = smem;                        // Qt[c * (kBQ + 1) + r]
  float* KV = Qt + HD * (kBQ + 1);         // K^T, then V
  float* P = KV + HD * (kBK + 1);          // P[r * kPStride + j]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const T* qb = q + (size_t)bh * S * HD;
  const T* kb = k + (size_t)bh * L * HD;
  const T* vb = v + (size_t)bh * L * HD;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, c = e % HD, i = q0 + r;
    Qt[c * (kBQ + 1) + r] = i < S ? widen(qb[(size_t)i * HD + c]) : 0.0f;
  }

  float m[4], l[4], acc[4][kC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kMasked;
    l[a] = 0.0f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[a][c] = 0.0f;
  }

  // the key tiles some query of this tile may see
  const int k_end = causal ? min(L, q0 + kBQ) : L;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_end = (k_end + kBK - 1) / kBK;
  for (int kt = k_first / kBK; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // Q stored; the last tile's V and P reads done
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int r = e / HD, c = e % HD, j = k0 + r;
      KV[c * (kBK + 1) + r] = j < L ? widen(kb[(size_t)j * HD + c]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.0f;
#pragma unroll 8
    for (int c = 0; c < HD; ++c) {
      float qa[4], kc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = Qt[c * (kBQ + 1) + ty * 4 + a];
#pragma unroll
      for (int b = 0; b < 4; ++b) kc[b] = KV[c * (kBK + 1) + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = fmaf(qa[a], kc[b], s[a][b]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = q0 + ty * 4 + a;
      float mx = -INFINITY;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = k0 + tx + 16 * b;
        float x = s[a][b] * scale;
        if (j >= L)
          x = -INFINITY;
        else if ((causal && j > i) || (window > 0 && j <= i - window))
          x = kMasked;
        s[a][b] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[a], row_max16(mx));
      const float alpha = expf(m[a] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = expf(s[a][b] - m_new);
        P[(ty * 4 + a) * kPStride + tx + 16 * b] = p;
        rs += p;
      }
      l[a] = alpha * l[a] + row_sum16(rs);
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();   // K reads done, P written

    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int r = e / HD, c = e % HD, j = k0 + r;
      KV[r * HD + c] = j < L ? widen(vb[(size_t)j * HD + c]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < kBK; ++jj) {
      float pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = P[(ty * 4 + a) * kPStride + jj];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float vv = KV[jj * HD + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(pa[a], vv, acc[a][c]);
      }
    }
  }

  T* ob = o + (size_t)bh * S * HD;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty * 4 + a;
    if (i >= S) continue;
    const float den = fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int c = 0; c < kC; ++c)
      store(&ob[(size_t)i * HD + tx + 16 * c], acc[a][c] / den);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int S, int L, float scale, int causal, int window,
                   cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, BH);
  flash_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, L, scale, causal,
      window);
  return cudaGetLastError();
}

}  // namespace

// hd must be 64 or 128 and BH at most 65535 (the wrapper checks both).
extern "C" int repro_flash(const void* q, const void* k, const void* v,
                           void* o, int BH, int S, int L, int hd, int bf16,
                           float scale, int causal, int window, void* stream) {
  if (BH <= 0 || S <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
  if (hd == 64 && bf16)
    err = launch<__nv_bfloat16, 64>(q, k, v, o, BH, S, L, scale, causal,
                                    window, st);
  else if (hd == 64)
    err = launch<float, 64>(q, k, v, o, BH, S, L, scale, causal, window, st);
  else if (hd == 128 && bf16)
    err = launch<__nv_bfloat16, 128>(q, k, v, o, BH, S, L, scale, causal,
                                     window, st);
  else if (hd == 128)
    err = launch<float, 128>(q, k, v, o, BH, S, L, scale, causal, window, st);
  return (int)err;
}
