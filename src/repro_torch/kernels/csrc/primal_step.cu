// primal_step: one whole online round for B stacked primal learners —
// z = scale cos(W x + bias) (RFF) or z = x (linear), yhat = <w, z> + b,
// the hinge or squared loss and its gradient g, and the NORMA update
// w' = (1 - eta lam) w - eta g z, b' = b - eta g.
//
// Replaces the TPU kernel repro/kernels/fused.py::primal_step_pallas
// (bodies _rff_step_kernel, _linear_step_kernel, _primal_step_math).
//
// Bound: bytes.  At the engine's RFF shape (B = 32, D = 2048, d = 18)
// it moves ~0.7 MB, well under a microsecond of memory time: the
// launch dominates.
//
// Design: one block per learner row.  The TPU kernel holds a (bm, D)
// feature slab in VMEM; here nothing of size D is held in shared
// memory.  Pass 1 strides over D (thread t takes features t,
// t + blockDim, ...), computes each z_j on the fly (a d-long dot and a
// cos) and accumulates w_j z_j; a fixed-order block reduce gives yhat.
// Thread 0 forms the loss and gradient.  Pass 2 recomputes z_j and
// writes w'.  The block size depends on D only, so a row's floats never
// depend on B.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;

enum Loss { LOSS_HINGE = 0, LOSS_SQUARED = 1 };

__device__ __forceinline__ float feature(int j, const float* xs, int d,
                                         const float* __restrict__ W,
                                         const float* __restrict__ bias,
                                         int featurize, float scale) {
  if (!featurize) return xs[j];
  const float* wj = W + (size_t)j * d;
  float proj = 0.0f;
  for (int k = 0; k < d; ++k) proj += xs[k] * wj[k];
  return scale * cosf(proj + bias[j]);
}

__global__ void primal_step_kernel(
    const float* __restrict__ X, const float* __restrict__ Yl,
    const float* __restrict__ w, const float* __restrict__ b,
    const float* __restrict__ W, const float* __restrict__ bias,
    float* __restrict__ w_new, float* __restrict__ b_new,
    float* __restrict__ ell_out, float* __restrict__ yhat_out, int d, int D,
    int featurize, float scale, int loss, float eta, float decay) {
  extern __shared__ float xs[];   // the learner's example, d floats
  __shared__ float red[kMaxThreads];
  __shared__ float g_s;
  const int i = blockIdx.x;
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const float* wi = w + (size_t)i * D;
  float* wo = w_new + (size_t)i * D;

  for (int k = t; k < d; k += nt) xs[k] = X[(size_t)i * d + k];
  __syncthreads();

  float acc = 0.0f;
  for (int j = t; j < D; j += nt) {
    acc += wi[j] * feature(j, xs, d, W, bias, featurize, scale);
  }
  const float dot = block_sum(acc, red);
  if (t == 0) {
    const float yhat = dot + b[i];
    const float y = Yl[i];
    float l, g;
    if (loss == LOSS_HINGE) {
      l = fmaxf(0.0f, 1.0f - y * yhat);
      g = l > 0.0f ? -y : 0.0f;
    } else {
      const float r = yhat - y;
      l = 0.5f * r * r;
      g = r;
    }
    ell_out[i] = l;
    yhat_out[i] = yhat;
    b_new[i] = b[i] - eta * g;
    g_s = g;
  }
  __syncthreads();
  const float step = eta * g_s;
  for (int j = t; j < D; j += nt) {
    wo[j] = decay * wi[j] - step * feature(j, xs, d, W, bias, featurize, scale);
  }
}

}  // namespace

extern "C" int repro_primal_step(const float* X, const float* Yl,
                                 const float* w, const float* b,
                                 const float* W, const float* bias,
                                 float* w_new, float* b_new, float* ell,
                                 float* yhat, int B, int d, int D,
                                 int featurize, float scale, int loss,
                                 float eta, float decay, void* stream) {
  if (B > 0) {
    int threads = 32;   // a power of two (block_sum), enough to cover D
    while (threads < D && threads < kMaxThreads) threads *= 2;
    primal_step_kernel<<<B, threads, d * sizeof(float),
                         (cudaStream_t)stream>>>(
        X, Yl, w, b, W, bias, w_new, b_new, ell, yhat, d, D, featurize,
        scale, loss, eta, decay);
  }
  return (int)cudaGetLastError();
}
