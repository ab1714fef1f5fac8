// flash_tc: the port's flash attention (src/repro_torch/kernels/csrc/
// flash.cu) redesigned for Hopper's tensor cores; an experiment beside the
// port, built and measured by tools/flash_tc/run.py.  It computes
//   O[bh, i, :] = sum_j softmax_j(scale * <q[bh, i, :], k[bh, j, :]>) v[bh, j, :]
// over the keys j that query i may see: all of them, j <= i (causal), and
// with window > 0 also j > i - window.  q (BH, S, hd), k and v (BH, L, hd),
// O (BH, S, hd), row-major, all float32 or all bfloat16.
//
// Like the port's kernel it replaces the TPU kernel
// repro/kernels/flash.py::flash_attention (body _flash_kernel).  There the grid is (BH, S/bq, L/bk) and the kv axis runs
// in order on one core, carrying the running max m, the normalizer l and
// the unnormalized accumulator acc in VMEM scratch from one grid step to
// the next.  Here that sequential axis is a loop inside one block: a block
// owns one (bh, query tile) pair, streams the K and V tiles it needs
// through shared memory and keeps m, l and acc in registers.  No block
// reads another's sums: no split over the keys, no atomics, so a repeat
// is bitwise.
//
// Numbers follow the reference, which computes in float32 (the TPU kernel
// upcasts and asks for preferred_element_type=float32): scores, exp, the
// sums and acc are float32; masked scores are -1e30 exactly as there, so a
// row that has seen no visible key yet is wiped by alpha = exp(-1e30 - m)
// = 0 once it does; the output is acc / max(l, 1e-30), rounded once to the
// input type.  Keys past L (the ragged edge) are -inf: they take no part
// in the max or the sums, so any S and L work without padding.  Tiles that
// no query of the block may see are skipped, as the TPU kernel skips them
// with pl.when.  A row that may see no key at all (a window that ends
// before the first key of its block's tiles) averages the keys of the
// tiles it reads, where the plain version averages all keys; no caller
// makes such a row.
//
// Bound: operations.  At the LM's prefill shape (BH 64, S 1500, hd 128,
// bf16, causal) the visible pairs need 2 hd flops for q.k and 2 hd for
// p.v, against 98 MB of q, k, v and O (0.03 ms at 3.35 TB/s).  Float32
// FMAs on the CUDA cores would need 0.55 ms at their 67 TFLOP/s peak, so
// both products run on the tensor cores (Hopper's warpgroup MMA, wgmma,
// bf16 operands, float32 accumulators) and still keep float32 precision:
// - q.k: a product of two bf16 values is exact in float32, so for bf16
//   inputs one pass is the reference's product.
// - p.v: p is a float32 weight; it is split in registers into three bf16
//   parts, hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi - mid), which
//   hold its 24 bits, and each part runs against v (exact in bf16): three
//   passes, three times the tensor-core work of a one-pass bf16 p.v.
// - float32 inputs go through the same template: q, k and v are split
//   into three bf16 parts each and every product runs the six cross terms
//   above 2^-24.  A bf16 input runs only the terms whose parts are not
//   zero by construction, in the same order, so the float32 kernel on
//   widened bf16 inputs adds exact zeros in between and ends with the bf16
//   kernel's accumulators bit for bit.
// - The tensor cores add into their float32 accumulators without
//   rounding to nearest, so the error grows with every MMA chained onto
//   one accumulator.  Chains are kept short: q.k in two halves of hd added
//   in float32; p.v per key tile, smallest terms first (all lo parts, then
//   mid, then hi), folded into acc by a float32 FMA.  No rounding of the
//   tensor cores' runs across tiles.
// That is four bf16 passes (0.075 ms at the tensor cores' 989 TFLOP/s),
// with the softmax (scale, mask, max, exp, sums, the split) on the CUDA
// cores between them.  The operands stay bf16 in shared memory as stored,
// the K and V tiles double-buffered with cp.async so that the next tile
// loads during this tile's math: 81 KB a block at hd 128, two blocks an
// SM.  What bounds it now is that softmax: one warpgroup per block waits
// for its own MMAs, and only the other block on the SM fills the gap.
//
// Layout: one warpgroup (128 threads) owns 64 query rows and loops over
// tiles of 64 keys: s = q k^T is a 64 x 64 wgmma with both operands in
// shared memory, O += p v a 64 x hd wgmma with p in registers.  Warp w
// holds rows 16 w .. 16 w + 15; each row's 64 scores lie on the 4 lanes
// of a quad, so the row max and row sum are a lane's own values in a
// fixed order and then a butterfly of two shuffles, which gives every
// lane the same floats.  The score accumulators are in the layout of the
// register operand of the next wgmma, so p goes to p.v without shared
// memory.  Tiles are stored in wgmma's 128-byte swizzle (regions of 64
// columns, 16-byte chunk c of row r at c ^ (r & 7)), which the operand
// descriptors name: q and k K-major, v MN-major (transposed by the MMA).
// Masks are applied only on tiles that cross the diagonal, the window's
// edge or L.  The grid is (BH, query tiles) with the last query tile
// first: under the causal mask those have the most keys, and they start
// in the first wave.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;       // one warpgroup
constexpr int kBQ = 64;             // query rows per block, 16 per warp
constexpr int kBK = 64;             // keys per tile
constexpr int kNT = kBK / 8;        // 16 x 8 score blocks a warp holds
constexpr float kMasked = -1e30f;   // the reference's NEG_INF

// The cross terms of a product of two three-part splits that lie above
// 2^-24 of the leading one, smallest first: term t multiplies part
// term_a(t) of the left operand by part term_b(t) of the right, (2,0)
// (1,1) (0,2) (1,0) (0,1) (0,0), so each addition to an accumulator is
// truncated against the smallest sum it can be.
constexpr int kTerms = 6;
__host__ __device__ constexpr int term_a(int t) {
  return t == 0 ? 2 : t == 1 || t == 3 ? 1 : 0;
}
__host__ __device__ constexpr int term_b(int t) {
  return t == 2 ? 2 : t == 1 || t == 4 ? 1 : 0;
}

template <typename T>
struct Parts {   // bf16 parts of a split input
  static constexpr int n = std::is_same<T, float>::value ? 3 : 1;
};

template <typename T, int HD>
struct Smem {
  static constexpr int kParts = Parts<T>::n;
  static constexpr int kStages = kParts == 1 ? 2 : 1;   // cp.async ring
  static constexpr int kQ = kBQ * HD;                    // bf16s a part
  static constexpr int kKV = kBK * HD;
  // Q parts, then per stage the K parts and the V parts
  // (+ 1024: the tiles are aligned up to the swizzle's 1024-byte atom)
  static constexpr int bytes =
      2 * (kParts * kQ + kStages * 2 * kParts * kKV) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// x = hi + mid + lo in bf16: hi = bf16(x), mid = bf16(x - hi),
// lo = bf16(x - hi - mid); each subtraction is exact.  For a pair
// (x0, x1), packed as mma operands (x0 in the low half), one paired
// conversion a part.
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ void split_pair(float x0, float x1,
                                           uint32_t (&out)[3]) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
  const float2 h = __bfloat1622float2(hi);
  const float r0 = x0 - h.x, r1 = x1 - h.y;
  const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
  const float2 m = __bfloat1622float2(mid);
  out[0] = as_u32(hi);
  out[1] = as_u32(mid);
  out[2] = as_u32(__floats2bfloat162_rn(r0 - m.x, r1 - m.y));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Tiles are ROWS x HD bf16 in regions of 64 columns (128-byte rows), each
// region stored in the 128-byte swizzle that wgmma's descriptors name:
// 16-byte chunk c of row r at chunk c ^ (r & 7), regions 1024-aligned.
template <int ROWS>
__device__ __forceinline__ int swz_byte(int r, int c) {   // c: chunk of HD/8
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int HD, int ROWS>
__device__ __forceinline__ void load_async(unsigned char* dst, const bf16* src,
                                           int row0, int n) {
  constexpr int kChunks = HD / 8;
  for (int e = threadIdx.x; e < ROWS * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const bool ok = row0 + r < n;
    const bf16* g = src + (size_t)(ok ? row0 + r : 0) * HD + c * 8;
    cp_async16(smem_u32(dst + swz_byte<ROWS>(r, c)), g, ok ? 16 : 0);
  }
}

template <int HD, int ROWS>
__device__ __forceinline__ void load_split(unsigned char* dst, const float* src,
                                           int row0, int n) {
  constexpr int kChunks = HD / 8;
  constexpr int kPart = ROWS * HD * 2;   // bytes
  for (int e = threadIdx.x; e < ROWS * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    float x[8];
    if (row0 + r < n) {
      const float4* g =
          reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * HD + c * 8);
      const float4 a = g[0], b = g[1];
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
    } else {
#pragma unroll
      for (int t = 0; t < 8; ++t) x[t] = 0.0f;
    }
    uint32_t w[3][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      uint32_t s[3];
      split_pair(x[2 * t], x[2 * t + 1], s);
#pragma unroll
      for (int p = 0; p < 3; ++p) w[p][t] = s[p];
    }
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint4*>(dst + p * kPart + swz_byte<ROWS>(r, c)) =
          make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int HD>
__device__ __forceinline__ void pv_mma(float (&acc)[HD / 2],
                                       const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void pv_mma<64>(float (&acc)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  wgmma_rs_n64(acc, a, db);
}
template <>
__device__ __forceinline__ void pv_mma<128>(float (&acc)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  wgmma_rs_n128(acc, a, db);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, Parts<T>::n == 1 ? 2 : 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int L,
             float scale, int causal, int window) {
  static_assert(HD == 64 || HD == 128, "head dim");
  static_assert(kThreads == 128 && kBK == 64, "one warpgroup, 64 keys");
  using Sm = Smem<T, HD>;
  constexpr int NP = Sm::kParts;
  constexpr int kQB = kBQ * HD * 2, kKVB = kBK * HD * 2;   // bytes a part
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* Qs = base;
  unsigned char* KVs = Qs + NP * kQB;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const T* qb = q + (size_t)bh * S * HD;
  const T* kb = k + (size_t)bh * L * HD;
  const T* vb = v + (size_t)bh * L * HD;

  const int k_end = causal ? min(L, q0 + kBQ) : L;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt0 = k_first / kBK;
  const int kt_end = (k_end + kBK - 1) / kBK;

  auto kv_tile = [&](int stage, int which) {
    return KVs + (stage * 2 + which) * NP * kKVB;
  };
  auto load_kv = [&](int kt, int stage) {
    if constexpr (NP == 1) {
      load_async<HD, kBK>(kv_tile(stage, 0), (const bf16*)kb, kt * kBK, L);
      load_async<HD, kBK>(kv_tile(stage, 1), (const bf16*)vb, kt * kBK, L);
    } else {
      load_split<HD, kBK>(kv_tile(stage, 0), (const float*)kb, kt * kBK, L);
      load_split<HD, kBK>(kv_tile(stage, 1), (const float*)vb, kt * kBK, L);
    }
  };

  if constexpr (NP == 1) {
    load_async<HD, kBQ>(Qs, (const bf16*)qb, q0, S);
    if (kt0 < kt_end) load_kv(kt0, 0);
    cp_commit();
  } else {
    load_split<HD, kBQ>(Qs, (const float*)qb, q0, S);
  }

  const int wr0 = q0 + warp * 16;
  const int g = lane >> 2, t4 = lane & 3;
  const int i0 = wr0 + g, i1 = i0 + 8;
  float m[2] = {kMasked, kMasked}, l[2] = {0.0f, 0.0f};
  float acc[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) acc[x] = 0.0f;
  const uint32_t q_addr = smem_u32(Qs);

  for (int kt = kt0; kt < kt_end; ++kt) {
    const int stage = Sm::kStages == 2 ? (kt - kt0) & 1 : 0;
    if constexpr (NP == 1) {
      if (kt + 1 < kt_end) {
        load_kv(kt + 1, stage ^ 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
    } else {
      load_kv(kt, 0);
    }
    proxy_fence();   // the tiles, written by this thread, to wgmma's reads
    __syncthreads();

    const int k0 = kt * kBK;
    const uint32_t k_addr = smem_u32(kv_tile(stage, 0));
    const uint32_t v_addr = smem_u32(kv_tile(stage, 1));

    // s = q k^T: 64 x 64 on one warpgroup, hd in steps of 16
    float s[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] = 0.0f;
    float s2[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) s2[x] = 0.0f;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const uint32_t off = (ks >> 2) * (64 * 128) + (ks & 3) * 32;
#pragma unroll
      for (int t = 0; t < kTerms; ++t) {
        if (term_a(t) >= NP || term_b(t) >= NP) continue;
        wgmma_ss_n64(ks < HD / 32 ? s : s2,
                     desc(q_addr + term_a(t) * kQB + off, 16, 1024),
                     desc(k_addr + term_b(t) * kKVB + off, 16, 1024));
      }
    }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] += s2[x];

    const bool edge = k0 + kBK > L || (causal && k0 + kBK - 1 > wr0) ||
                      (window > 0 && k0 <= wr0 + 15 - window);
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] *= scale;
    if (edge) {
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? i0 : i1;
          const int j = k0 + n * 8 + 2 * t4 + (e & 1);
          if (j >= L)
            s[4 * n + e] = -INFINITY;
          else if ((causal && j > i) || (window > 0 && j <= i - window))
            s[4 * n + e] = kMasked;
        }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int x = 0; x < 32; ++x) mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], s[x]);
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[4 * n + e] - m[e >> 1]);
        s[4 * n + e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + quad_sum(rs[h]);
    float pv[HD / 2];
#pragma unroll
    for (int x = 0; x < HD / 2; ++x) pv[x] = 0.0f;

    // acc += p v: p in three parts from registers, v from shared memory
    uint32_t pa[kBK / 16][3][4];
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      uint32_t w[3];
      const float* c0 = &s[8 * kc];       // keys 16 kc .. + 7
      const float* c1 = &s[8 * kc + 4];   // keys 16 kc + 8 .. + 15
      split_pair(c0[0], c0[1], w);
#pragma unroll
      for (int p = 0; p < 3; ++p) pa[kc][p][0] = w[p];
      split_pair(c0[2], c0[3], w);
#pragma unroll
      for (int p = 0; p < 3; ++p) pa[kc][p][1] = w[p];
      split_pair(c1[0], c1[1], w);
#pragma unroll
      for (int p = 0; p < 3; ++p) pa[kc][p][2] = w[p];
      split_pair(c1[2], c1[3], w);
#pragma unroll
      for (int p = 0; p < 3; ++p) pa[kc][p][3] = w[p];
    }
    wg_fence();
#pragma unroll
    for (int t = 0; t < kTerms; ++t)
#pragma unroll
      for (int kc = 0; kc < kBK / 16; ++kc) {
        if (term_b(t) >= NP) continue;
        pv_mma<HD>(pv, pa[kc][term_a(t)],
                   desc(v_addr + term_b(t) * kKVB + kc * 16 * 128,
                        kBK * 128, 1024));
      }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int x = 0; x < HD / 2; ++x)
      acc[x] = fmaf(acc[x], alpha[(x >> 1) & 1], pv[x]);
    __syncthreads();   // this stage's reads done before it is refilled
  }
  if constexpr (NP == 1) cp_wait<0>();

  T* ob = o + (size_t)bh * S * HD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = h == 0 ? i0 : i1;
    if (i >= S) continue;
    const float den = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      store2(&ob[(size_t)i * HD + n * 8 + 2 * t4], acc[4 * n + 2 * h] / den,
             acc[4 * n + 2 * h + 1] / den);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int S, int L, float scale, int causal, int window,
                   cudaStream_t stream) {
  constexpr int bytes = Smem<T, HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (S + kBQ - 1) / kBQ);
  flash_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, L, scale, causal,
      window);
  return cudaGetLastError();
}

}  // namespace

// hd must be 64 or 128, ceil(S / 64) at most 65535 and every pointer
// 16-byte aligned (the wrapper checks all three).
extern "C" int flash_tc(const void* q, const void* k, const void* v,
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
