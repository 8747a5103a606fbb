// Flash attention, forward and backward, for the port's dense transformer.
//
// Replaces the Pallas TPU kernels
//   flash_attention_fwd (_attn_kernel)     src/repro/kernels/flash_attention/kernel.py:79
//   flash_fwd_lse       (_fwd_lse_kernel)  src/repro/kernels/flash_attention/bwd.py:82
//   flash_attention_bwd (_dq_kernel, _dkv_kernel, and the GQA group sum)
//                                          src/repro/kernels/flash_attention/bwd.py:199
//
// Layout as in JAX: q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), contiguous,
// f32 or bf16; queries right-aligned (query row i sits at key position
// i + Skv - Sq); causal and sliding-window masks; GQA by grouping (q head h
// reads kv head h / (Hq / Hkv)). The math is f32 throughout: tiles are
// converted to f32 as they are loaded, outputs are rounded once to the
// input type (round to nearest), lse and delta are f32.
//
//   flash_fwd[_lse]  one block per (b*Hq, 64 query rows), looping over the
//                    64-key tiles inside the block (the TPU's sequential kv
//                    grid axis), online softmax (m, l, acc) in registers;
//                    the _lse entry also writes lse = m + log(l).
//   flash_bwd_dq     one block per (b*Hq, 64 query rows), looping over the
//                    key tiles: p = exp(s - lse), ds = p (dp - delta) scale,
//                    dq += ds k.
//   flash_bwd_dkv    one block per (b*Hkv, 64 key rows), looping over the G
//                    query heads of the group and their query tiles:
//                    dv += p do, dk += ds q. The group sum (bwd.py:269-270)
//                    happens here in f32, so no (B*Hq, Skv, D) per-head
//                    outputs are written; JAX rounds each head's partial to
//                    q.dtype before it sums them.
//
// Every thread owns one row (a query row, or a key row in dkv) and 32 of its
// D dims, in four-element chunks interleaved with the row's other threads
// (chunk c belongs to thread c % (D/32)), so neighbouring threads read
// neighbouring 16-byte words of a shared-memory row. A row's dot products
// are finished with a butterfly of __shfl_xor_sync over its D/32 threads,
// which leaves the same bits in every one of them. No atomics: every output
// element is written by one thread after a fixed-order loop, so two runs
// give the same bits.
//
// Masks, as the TPU kernels compute them: a masked score is -1e30, not -inf,
// so exp(-1e30 - m) underflows to exactly 0 once a row has seen a valid key,
// and a row that has seen none keeps m = -1e30 and weighs every key it has
// seen by exp(0) = 1. A key past Skv (a ragged last tile) gets -inf and
// weight 0. Key tiles wholly masked for every row of a block are skipped,
// except in a block holding a row with no valid key at all (causal with
// Sq > Skv): the TPU kernel visits every tile, so such a row's output is the
// mean of v and its lse is -1e30 + log(Skv) = -1e30, and the block here
// visits every tile too. The backward recomputes p from that lse, so such a
// row weighs every key by exp(0) = 1 there, as the TPU kernels do.
//
// What bounds it on an H100: at the main path's shapes (S = 4096, D = 64)
// the work is ~4 S^2 D / 2 flops per head against ~4 S D bytes, far above
// the ridge point, so the bound is operations (989 TFLOP/s bf16 on the
// tensor cores). This first version runs its products as f32 FMAs on the
// CUDA cores (67 TFLOP/s peak), with k/v (or q/do) tiles staged in shared
// memory and broadcast to the threads of a warp; it is right and simple,
// not fast. Tensor-core products (mma.sync / wgmma) and TMA loads are later
// work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // the TPU kernels' mask value
constexpr int kBQ = 64;             // query rows per tile
constexpr int kBK = 64;             // key rows per tile
constexpr int kE = 32;              // head dims a thread owns
constexpr int kChunk = 16;          // keys per online-softmax update (fwd)

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 a, b;
  *reinterpret_cast<uint32_t*>(&a) = u.x;
  *reinterpret_cast<uint32_t*>(&b) = u.y;
  const float2 fa = __bfloat1622float2(a);
  const float2 fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// the sum of x over a row's TPR consecutive lanes, identical in each
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool allowed(int qpos, int kpos, int causal,
                                        int window) {
  return (!causal || qpos >= kpos) && (window <= 0 || qpos - kpos < window);
}

// n rows of a (rows, D) global matrix into a (kRows, D) f32 shared tile;
// rows n..kRows-1 are zero-filled
template <int D, int kRows, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int n) {
  constexpr int C = D / 4;
  for (int idx = threadIdx.x; idx < kRows * C; idx += blockDim.x) {
    const int r = idx / C, c = idx - (idx / C) * C;
    const float4 x = r < n ? load4(src + (size_t)r * D + 4 * c)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    store4(dst + r * D + 4 * c, x);
  }
}

// this thread's 32 dims of a row: chunks part, part + TPR, ...
template <int D, typename T>
__device__ __forceinline__ void load_row(float* x, const T* row, int part) {
  constexpr int TPR = D / kE;
#pragma unroll
  for (int t = 0; t < kE / 4; ++t) {
    const float4 v = load4(row + 4 * (part + TPR * t));
    x[4 * t] = v.x; x[4 * t + 1] = v.y; x[4 * t + 2] = v.z; x[4 * t + 3] = v.w;
  }
}

template <int D, typename T>
__device__ __forceinline__ void store_row(T* row, const float* x, int part) {
  constexpr int TPR = D / kE;
#pragma unroll
  for (int t = 0; t < kE / 4; ++t)
    store4(row + 4 * (part + TPR * t),
           make_float4(x[4 * t], x[4 * t + 1], x[4 * t + 2], x[4 * t + 3]));
}

// partial dot of this thread's 32 dims with a shared f32 row
template <int D>
__device__ __forceinline__ float dot_part(const float* x, const float* srow,
                                          int part) {
  constexpr int TPR = D / kE;
  float d = 0.f;
#pragma unroll
  for (int t = 0; t < kE / 4; ++t) {
    const float4 y = *reinterpret_cast<const float4*>(srow + 4 * (part + TPR * t));
    d = fmaf(x[4 * t], y.x, d);
    d = fmaf(x[4 * t + 1], y.y, d);
    d = fmaf(x[4 * t + 2], y.z, d);
    d = fmaf(x[4 * t + 3], y.w, d);
  }
  return d;
}

// acc += a * (this thread's 32 dims of a shared f32 row)
template <int D>
__device__ __forceinline__ void axpy_part(float* acc, float a,
                                          const float* srow, int part) {
  constexpr int TPR = D / kE;
#pragma unroll
  for (int t = 0; t < kE / 4; ++t) {
    const float4 y = *reinterpret_cast<const float4*>(srow + 4 * (part + TPR * t));
    acc[4 * t] = fmaf(a, y.x, acc[4 * t]);
    acc[4 * t + 1] = fmaf(a, y.y, acc[4 * t + 1]);
    acc[4 * t + 2] = fmaf(a, y.z, acc[4 * t + 2]);
    acc[4 * t + 3] = fmaf(a, y.w, acc[4 * t + 3]);
  }
}

// key tiles [lo, hi) a block of query rows [q0, q0 + kBQ) must visit
__device__ __forceinline__ void kv_tiles(int q0, int Sq, int Skv, int causal,
                                         int window, int* lo, int* hi) {
  const int nkt = (Skv + kBK - 1) / kBK;
  const int off = Skv - Sq;
  *lo = 0;
  *hi = nkt;
  if (causal && q0 + off < 0) return;   // a row with no valid key: all
  if (causal) {
    const int kmax = min(q0 + kBQ, Sq) - 1 + off;   // >= 0 here
    *hi = min(nkt, kmax / kBK + 1);
  }
  if (window > 0) {
    const int kmin = q0 + off - window + 1;
    if (kmin > 0) *lo = kmin / kBK;
  }
}

// query tiles [lo, hi) that reach the key rows [k0, k0 + kBK)
__device__ __forceinline__ void q_tiles(int k0, int Sq, int Skv, int causal,
                                        int window, int* lo, int* hi) {
  const int nqt = (Sq + kBQ - 1) / kBQ;
  const int off = Skv - Sq;
  *lo = 0;
  *hi = nqt;
  if (causal && off >= 0) {   // (off < 0: rows with no valid key reach all)
    const int imin = k0 - off;
    if (imin > 0) *lo = imin / kBQ;
  }
  if (window > 0) {
    const int imax = min(k0 + kBK, Skv) - 1 + window - 1 - off;
    *hi = imax < 0 ? 0 : min(nqt, imax / kBQ + 1);
  }
}

template <int D, typename T, bool kLse>
__global__ void __launch_bounds__(kBQ * (D / kE))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv,
                 int causal, int window, float scale) {
  constexpr int TPR = D / kE;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [kBK][D]
  float* Vs = Ks + kBK * D;                      // [kBK][D]

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - (bh / Hq) * Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int part = threadIdx.x % TPR;
  const int i = q0 + threadIdx.x / TPR;
  const bool row_ok = i < Sq;
  const int qpos = i + Skv - Sq;

  float qr[kE], acc[kE];
  load_row<D>(qr, q + ((size_t)bh * Sq + (row_ok ? i : 0)) * D, part);
#pragma unroll
  for (int e = 0; e < kE; ++e) acc[e] = 0.f;
  float m = kNegInf, l = 0.f;

  const T* kb = k + (size_t)kvh * Skv * D;
  const T* vb = v + (size_t)kvh * Skv * D;
  int lo, hi;
  kv_tiles(q0, Sq, Skv, causal, window, &lo, &hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kBK;
    const int nk = min(kBK, Skv - k0);
    __syncthreads();                 // the previous tile is consumed
    load_tile<D, kBK>(Ks, kb + (size_t)k0 * D, nk);
    load_tile<D, kBK>(Vs, vb + (size_t)k0 * D, nk);
    __syncthreads();
    for (int jc = 0; jc < nk; jc += kChunk) {
      float s[kChunk];
      float mc = m;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = k0 + jc + jj;
        const float d = row_sum<TPR>(dot_part<D>(qr, Ks + (jc + jj) * D, part));
        float sv = d * scale;
        if (j >= Skv) sv = -INFINITY;
        else if (!allowed(qpos, j, causal, window)) sv = kNegInf;
        s[jj] = sv;
        mc = fmaxf(mc, sv);
      }
      const float corr = expf(m - mc);
      l *= corr;
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] *= corr;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = expf(s[jj] - mc);
        l += p;
        axpy_part<D>(acc, p, Vs + (jc + jj) * D, part);
      }
      m = mc;
    }
  }
  if (row_ok) {
    const float ls = fmaxf(l, 1e-30f);
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] = acc[e] / ls;
    store_row<D>(o + ((size_t)bh * Sq + i) * D, acc, part);
    if (kLse && part == 0) lse[(size_t)bh * Sq + i] = m + logf(ls);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kBQ * (D / kE))
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Hq, int Hkv, int Sq, int Skv, int causal, int window,
                    float scale) {
  constexpr int TPR = D / kE;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [kBK][D]
  float* Vs = Ks + kBK * D;                      // [kBK][D]

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - (bh / Hq) * Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int part = threadIdx.x % TPR;
  const int i = q0 + threadIdx.x / TPR;
  const bool row_ok = i < Sq;
  const int qpos = i + Skv - Sq;
  const size_t row = (size_t)bh * Sq + (row_ok ? i : 0);

  float qr[kE], dor[kE], acc[kE];
  load_row<D>(qr, q + row * D, part);
  load_row<D>(dor, dout + row * D, part);
#pragma unroll
  for (int e = 0; e < kE; ++e) acc[e] = 0.f;
  const float lse_i = lse[row], delta_i = delta[row];

  const T* kb = k + (size_t)kvh * Skv * D;
  const T* vb = v + (size_t)kvh * Skv * D;
  int lo, hi;
  kv_tiles(q0, Sq, Skv, causal, window, &lo, &hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kBK;
    const int nk = min(kBK, Skv - k0);
    __syncthreads();
    load_tile<D, kBK>(Ks, kb + (size_t)k0 * D, nk);
    load_tile<D, kBK>(Vs, vb + (size_t)k0 * D, nk);
    __syncthreads();
#pragma unroll 2
    for (int jj = 0; jj < nk; ++jj) {
      const float* kr = Ks + jj * D;
      const float sd = row_sum<TPR>(dot_part<D>(qr, kr, part));
      const float dp = row_sum<TPR>(dot_part<D>(dor, Vs + jj * D, part));
      float s = sd * scale;
      if (!allowed(qpos, k0 + jj, causal, window)) s = kNegInf;
      const float p = expf(s - lse_i);
      const float ds = p * (dp - delta_i) * scale;
      axpy_part<D>(acc, ds, kr, part);
    }
  }
  if (row_ok) store_row<D>(dq + row * D, acc, part);
}

template <int D, typename T>
__global__ void __launch_bounds__(kBK * (D / kE))
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Hq, int Hkv, int Sq, int Skv,
                     int causal, int window, float scale) {
  constexpr int TPR = D / kE;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [kBQ][D]
  float* Ds = Qs + kBQ * D;                      // [kBQ][D] (do)
  float* Ls = Ds + kBQ * D;                      // [kBQ] lse
  float* Dl = Ls + kBQ;                          // [kBQ] delta

  const int bkv = blockIdx.y;
  const int b = bkv / Hkv, hkv = bkv - (bkv / Hkv) * Hkv;
  const int G = Hq / Hkv;
  const int k0 = blockIdx.x * kBK;
  const int part = threadIdx.x % TPR;
  const int j = k0 + threadIdx.x / TPR;
  const bool col_ok = j < Skv;
  const int off = Skv - Sq;
  const size_t krow = (size_t)bkv * Skv + (col_ok ? j : 0);

  float kr[kE], vr[kE], dka[kE], dva[kE];
  load_row<D>(kr, k + krow * D, part);
  load_row<D>(vr, v + krow * D, part);
#pragma unroll
  for (int e = 0; e < kE; ++e) { dka[e] = 0.f; dva[e] = 0.f; }

  int lo, hi;
  q_tiles(k0, Sq, Skv, causal, window, &lo, &hi);
  for (int g = 0; g < G; ++g) {
    const size_t bh = (size_t)b * Hq + (size_t)hkv * G + g;
    for (int qt = lo; qt < hi; ++qt) {
      const int q0 = qt * kBQ;
      const int nq = min(kBQ, Sq - q0);
      __syncthreads();
      load_tile<D, kBQ>(Qs, q + (bh * Sq + q0) * D, nq);
      load_tile<D, kBQ>(Ds, dout + (bh * Sq + q0) * D, nq);
      for (int r = threadIdx.x; r < kBQ; r += blockDim.x) {
        Ls[r] = r < nq ? lse[bh * Sq + q0 + r] : 0.f;
        Dl[r] = r < nq ? delta[bh * Sq + q0 + r] : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int ii = 0; ii < nq; ++ii) {
        const float* qrow = Qs + ii * D;
        const float* drow = Ds + ii * D;
        const float sd = row_sum<TPR>(dot_part<D>(kr, qrow, part));
        const float dp = row_sum<TPR>(dot_part<D>(vr, drow, part));
        float s = sd * scale;
        if (!allowed(q0 + ii + off, j, causal, window)) s = kNegInf;
        const float p = expf(s - Ls[ii]);
        axpy_part<D>(dva, p, drow, part);
        const float ds = p * (dp - Dl[ii]) * scale;
        axpy_part<D>(dka, ds, qrow, part);
      }
    }
  }
  if (col_ok) {
    store_row<D>(dk + krow * D, dka, part);
    store_row<D>(dv + krow * D, dva, part);
  }
}

// dynamic shared memory above 48 KB must be allowed per kernel, once
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int D, typename T, bool kLse>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int Hq, int Hkv, int Sq, int Skv,
               int causal, int window, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D, T, kLse>;
  const int smem = 2 * kBK * D * (int)sizeof(float);
  static const cudaError_t set = allow_smem(kernel, smem);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * Hq);
  kernel<<<grid, kBQ * (D / kE), smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, Hq, Hkv, Sq,
      Skv, causal, window, scale);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int Hq,
              int Hkv, int Sq, int Skv, int causal, int window, float scale,
              cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<D, T>;
  const int smem = 2 * kBK * D * (int)sizeof(float);
  static const cudaError_t set = allow_smem(kernel, smem);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * Hq);
  kernel<<<grid, kBQ * (D / kE), smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, Hq, Hkv, Sq, Skv,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int Hq, int Hkv, int Sq, int Skv, int causal, int window,
               float scale, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<D, T>;
  const int smem = (2 * kBQ * D + 2 * kBQ) * (int)sizeof(float);
  static const cudaError_t set = allow_smem(kernel, smem);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid((Skv + kBK - 1) / kBK, B * Hkv);
  kernel<<<grid, kBK * (D / kE), smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, Hq, Hkv, Sq,
      Skv, causal, window, scale);
  return (int)cudaGetLastError();
}

bool shapes_ok(int B, int Hq, int Hkv, int Sq, int Skv, int D) {
  return B > 0 && Hkv > 0 && Hq % Hkv == 0 && Sq > 0 && Skv > 0 &&
         (D == 64 || D == 128) && (long long)B * Hq < 65536;
}

// dispatch on (D, dtype): dtype 0 = f32, 1 = bf16; anything else is refused
#define REPRO_FLASH_DISPATCH(D, dtype, CALL)                              \
  if (D == 64 && dtype == 0) { constexpr int kD = 64; typedef float T; return CALL; } \
  if (D == 64 && dtype == 1) { constexpr int kD = 64; typedef __nv_bfloat16 T; return CALL; } \
  if (D == 128 && dtype == 0) { constexpr int kD = 128; typedef float T; return CALL; } \
  if (D == 128 && dtype == 1) { constexpr int kD = 128; typedef __nv_bfloat16 T; return CALL; } \
  return (int)cudaErrorInvalidValue;

}  // namespace

extern "C" {

// q (B,Hq,Sq,D), k/v (B,Hkv,Skv,D) -> o (B,Hq,Sq,D); window <= 0: none.
// Returns the cudaError_t of the launch (0 on success).
int flash_fwd(const void* q, const void* k, const void* v, void* o, int B,
              int Hq, int Hkv, int Sq, int Skv, int D, int dtype, int causal,
              int window, float scale, void* stream) {
  if (!shapes_ok(B, Hq, Hkv, Sq, Skv, D)) return (int)cudaErrorInvalidValue;
  REPRO_FLASH_DISPATCH(D, dtype, (launch_fwd<kD, T, false>(
      q, k, v, o, nullptr, B, Hq, Hkv, Sq, Skv, causal, window, scale,
      (cudaStream_t)stream)));
}

// as flash_fwd, and lse (B,Hq,Sq) f32
int flash_fwd_lse(const void* q, const void* k, const void* v, void* o,
                  void* lse, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                  int dtype, int causal, int window, float scale,
                  void* stream) {
  if (!shapes_ok(B, Hq, Hkv, Sq, Skv, D)) return (int)cudaErrorInvalidValue;
  REPRO_FLASH_DISPATCH(D, dtype, (launch_fwd<kD, T, true>(
      q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, causal, window, scale,
      (cudaStream_t)stream)));
}

// dout (B,Hq,Sq,D); lse, delta (B,Hq,Sq) f32 -> dq (B,Hq,Sq,D)
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                 int dtype, int causal, int window, float scale,
                 void* stream) {
  if (!shapes_ok(B, Hq, Hkv, Sq, Skv, D)) return (int)cudaErrorInvalidValue;
  REPRO_FLASH_DISPATCH(D, dtype, (launch_dq<kD, T>(
      q, k, v, dout, lse, delta, dq, B, Hq, Hkv, Sq, Skv, causal, window,
      scale, (cudaStream_t)stream)));
}

// -> dk, dv (B,Hkv,Skv,D), summed over each kv head's group in f32
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Skv,
                  int D, int dtype, int causal, int window, float scale,
                  void* stream) {
  if (!shapes_ok(B, Hq, Hkv, Sq, Skv, D)) return (int)cudaErrorInvalidValue;
  REPRO_FLASH_DISPATCH(D, dtype, (launch_dkv<kD, T>(
      q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Sq, Skv, causal, window,
      scale, (cudaStream_t)stream)));
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
