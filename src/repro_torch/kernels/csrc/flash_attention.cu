// Flash attention, forward and backward, for the port's dense transformer.
//
// Replaces the Pallas TPU kernels
//   flash_attention_fwd (_attn_kernel)     src/repro/kernels/flash_attention/kernel.py:79
//   flash_fwd_lse       (_fwd_lse_kernel)  src/repro/kernels/flash_attention/bwd.py:82
//   flash_attention_bwd (_dq_kernel, _dkv_kernel, and the GQA group sum)
//                                          src/repro/kernels/flash_attention/bwd.py:199
//
// Layout as in JAX: q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), contiguous,
// f32 or bf16, D 64, 80, 128 or 256; queries right-aligned (query row i sits at key
// position i + Skv - Sq); causal and sliding-window masks; GQA by grouping
// (q head h reads kv head h / (Hq / Hkv)). Softmax state (m, l), lse, delta
// and every accumulator are f32; outputs are rounded once to the input type
// (round to nearest), lse is f32.
//
//   flash_fwd[_lse]  a block per (b*Hq, query tile), looping over the key
//                    tiles inside the block (the TPU's sequential kv grid
//                    axis), online softmax (m, l, acc) in registers; the
//                    _lse entry also writes lse = m + log(l).
//   flash_bwd_dq     a block per (b*Hq, query tile), looping over the key
//                    tiles: p = exp(s - lse), ds = p (dp - delta) scale,
//                    dq += ds k.
//   flash_bwd_dkv    a block per (b*Hkv, key tile), looping over the G
//                    query heads of the group and their query tiles:
//                    dv += p^T do, dk += ds^T q. The group sum (bwd.py:269-270)
//                    happens here in f32, so no (B*Hq, Skv, D) per-head
//                    outputs are written; JAX rounds each head's partial to
//                    q.dtype before it sums them.
// No atomics on the outputs (the bf16 kernels count a ring stage's
// releases on a shared-memory counter, which orders no arithmetic): every
// output element is written by one thread after a fixed-order loop, so two
// runs give the same bits.
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
// the ridge point, so the bound is operations: 989 TFLOP/s bf16 on the
// tensor cores. Two implementations, picked by the inputs' type:
//
// bf16: the Hopper kernels (flash_*_wgmma, sm_90a). A block is two
// warpgroups of 64 rows each (query rows; key rows in dk/dv). Thread 0
// copies by TMA the block's fixed tiles once (q; q and do; k and v), then
// the tiles it loops over into a ring of shared-memory stages, each with
// a "full" mbarrier; the warp that is last to release a stage copies the
// next tile into it, so no warp waits on another warpgroup. Tiles are
// 128-byte swizzled, 64 columns a TMA box (a D = 128 tile is two boxes,
// and a product's k-steps walk across them); TMA zero-fills rows past S.
// dk/dv's stages also carry the query tile's lse and delta (two 1-D
// boxes). Products are wgmma with f32 accumulators: those of two bf16
// inputs (s = q k^T, dp = do v^T) read both operands from shared memory
// and are exact in f32. A product with an f32-computed operand (p v, ds k,
// p^T do, ds^T q) takes it from registers, converted from the accumulator
// fragment it was computed in and split into hi = bf16(x) and
// lo = bf16(x - hi), as two bf16 wgmmas into one f32 accumulator: x is
// carried to about 2^-17 of itself, where one bf16 rounding (2^-9) puts
// o, dq and dv 24-46x over the element limit the port holds them to
// (tests/test_torch_flash_attention.py models both on the CPU). Scores
// are kept in log2 units so that a weight is one ex2. Each warpgroup runs
// its tiles as a two-step pipeline: it issues tile i + 1's s (and dp),
// then tile i's products with p or ds, and computes tile i + 1's softmax
// (or p and ds) while those run on the tensor cores. The forward loops
// over 64-key tiles at D = 64, two blocks an SM (128 registers a thread),
// and 128-key tiles at D = 128, one block; dq over 64 keys, dk/dv over 32
// queries, one block an SM. Only tiles that cross a mask edge or the
// ragged end evaluate the mask; causal query tiles are launched longest
// rows first.
//
// The tensor cores do not bound these kernels: with the products taken
// out the forward keeps most of its time (PERF.md). The warps' own work
// does: the softmax's exps, the split's conversions and the waits of a
// pipeline two tiles deep, on 8 (forward at D = 64: 16) warps an SM. A
// separate TMA warpgroup with setmaxnreg (the usual Hopper shape) was
// tried: the card's ptxas kept every thread of the 384-thread block at
// the entry budget of 168 registers and spilled, so the copies are issued
// from the consumer warps and a block is 256 threads (255 registers).
//
// f32: the first version's CUDA-core kernels (flash_*_kernel), kept as the
// exact-f32 path: every product an f32 FMA (67 TFLOP/s peak), k/v (or q/do)
// tiles staged in shared memory and broadcast to the threads of a warp.
// Every thread owns one row (a query row, or a key row in dkv) and kE of
// its D dims (32; 20 at D = 80, so that a row has a power of two of
// threads), in four-element chunks interleaved with the row's other
// threads, and finishes a row's dot products with a butterfly of
// __shfl_xor_sync over its D/kE threads, which leaves the same bits in
// each. A block holds 64 rows (32 at D = 256: 8 threads a row, and four
// 32-dim rows of registers a thread in dk/dv).
//
// Head dims 80 and 256 in bf16. A row of 80 is 160 bytes, no whole number
// of 128-byte swizzle boxes: its tiles are read as D = 128 tiles (the
// tensor map's row is 80 columns, so TMA zero-fills columns 80..127 of
// the second box), the products over the head dim stop at column 80, and
// only 80 columns of o, dq, dk and dv are stored; the products that run
// across the head dim (p v, ds k, p^T do, ds^T q) carry the zero columns.
// At D = 256 a 64 x 256 f32 accumulator is 128 registers a thread: the
// forward and dq loop over 64- and 32-key tiles in 2 stages, and dk/dv,
// two such accumulators, runs as two blocks a key tile, each computing the
// products over all 256 dims and accumulating 128 columns of dk and dv.
#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // the TPU kernels' mask value

__device__ __forceinline__ bool allowed(int qpos, int kpos, int causal,
                                        int window) {
  return (!causal || qpos >= kpos) && (window <= 0 || qpos - kpos < window);
}

// key tiles [lo, hi) of BK keys that the query rows [q0, q0 + BQ) must visit
template <int BQ, int BK>
__device__ __forceinline__ void kv_tiles(int q0, int Sq, int Skv, int causal,
                                         int window, int* lo, int* hi) {
  const int nkt = (Skv + BK - 1) / BK;
  const int off = Skv - Sq;
  *lo = 0;
  *hi = nkt;
  if (causal && q0 + off < 0) return;   // a row with no valid key: all
  if (causal) {
    const int kmax = min(q0 + BQ, Sq) - 1 + off;   // >= 0 here
    *hi = min(nkt, kmax / BK + 1);
  }
  if (window > 0) {
    const int kmin = q0 + off - window + 1;
    if (kmin > 0) *lo = kmin / BK;
  }
}

// query tiles [lo, hi) of BQ rows that reach the key rows [k0, k0 + BK)
template <int BQ, int BK>
__device__ __forceinline__ void q_tiles(int k0, int Sq, int Skv, int causal,
                                        int window, int* lo, int* hi) {
  const int nqt = (Sq + BQ - 1) / BQ;
  const int off = Skv - Sq;
  *lo = 0;
  *hi = nqt;
  if (causal && off >= 0) {   // (off < 0: rows with no valid key reach all)
    const int imin = k0 - off;
    if (imin > 0) *lo = imin / BQ;
  }
  if (window > 0) {
    const int imax = min(k0 + BK, Skv) - 1 + window - 1 - off;
    *hi = imax < 0 ? 0 : min(nqt, imax / BQ + 1);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core kernels
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;             // query rows a tile (dk/dv's ring)
constexpr int kBK = 64;             // key rows a tile (the forward's, dq's)
constexpr int kChunk = 16;          // keys per online-softmax update (fwd)

// kE: head dims a thread owns (D / kE threads a row, a power of two);
// kRows: the rows of a block (query rows; key rows in dk/dv)
template <int D>
struct F32Shape {
  static constexpr int kE = D == 80 ? 20 : 32;
  static constexpr int kRows = D == 256 ? 32 : 64;
  static constexpr int kThreads = kRows * (D / kE);
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// the sum of x over a row's TPR consecutive lanes, identical in each
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// n rows of a (rows, D) global matrix into a (kRows, D) shared tile;
// rows n..kRows-1 are zero-filled
template <int D, int kRows>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int n) {
  constexpr int C = D / 4;
  for (int idx = threadIdx.x; idx < kRows * C; idx += blockDim.x) {
    const int r = idx / C, c = idx - (idx / C) * C;
    const float4 x = r < n ? load4(src + (size_t)r * D + 4 * c)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    store4(dst + r * D + 4 * c, x);
  }
}

// this thread's kE dims of a row: chunks part, part + TPR, ...
template <int D>
__device__ __forceinline__ void load_row(float* x, const float* row, int part) {
  constexpr int kE = F32Shape<D>::kE, TPR = D / kE;
#pragma unroll
  for (int t = 0; t < kE / 4; ++t) {
    const float4 v = load4(row + 4 * (part + TPR * t));
    x[4 * t] = v.x; x[4 * t + 1] = v.y; x[4 * t + 2] = v.z; x[4 * t + 3] = v.w;
  }
}

template <int D>
__device__ __forceinline__ void store_row(float* row, const float* x, int part) {
  constexpr int kE = F32Shape<D>::kE, TPR = D / kE;
#pragma unroll
  for (int t = 0; t < kE / 4; ++t)
    store4(row + 4 * (part + TPR * t),
           make_float4(x[4 * t], x[4 * t + 1], x[4 * t + 2], x[4 * t + 3]));
}

// partial dot of this thread's kE dims with a shared f32 row
template <int D>
__device__ __forceinline__ float dot_part(const float* x, const float* srow,
                                          int part) {
  constexpr int kE = F32Shape<D>::kE, TPR = D / kE;
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

// acc += a * (this thread's kE dims of a shared f32 row)
template <int D>
__device__ __forceinline__ void axpy_part(float* acc, float a,
                                          const float* srow, int part) {
  constexpr int kE = F32Shape<D>::kE, TPR = D / kE;
#pragma unroll
  for (int t = 0; t < kE / 4; ++t) {
    const float4 y = *reinterpret_cast<const float4*>(srow + 4 * (part + TPR * t));
    acc[4 * t] = fmaf(a, y.x, acc[4 * t]);
    acc[4 * t + 1] = fmaf(a, y.y, acc[4 * t + 1]);
    acc[4 * t + 2] = fmaf(a, y.z, acc[4 * t + 2]);
    acc[4 * t + 3] = fmaf(a, y.w, acc[4 * t + 3]);
  }
}

template <int D, bool kLse>
__global__ void __launch_bounds__(F32Shape<D>::kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv,
                 int causal, int window, float scale) {
  constexpr int kE = F32Shape<D>::kE, TPR = D / kE, R = F32Shape<D>::kRows;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [kBK][D]
  float* Vs = Ks + kBK * D;                      // [kBK][D]

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - (bh / Hq) * Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int q0 = blockIdx.x * R;
  const int part = threadIdx.x % TPR;
  const int i = q0 + threadIdx.x / TPR;
  const bool row_ok = i < Sq;
  const int qpos = i + Skv - Sq;

  float qr[kE], acc[kE];
  load_row<D>(qr, q + ((size_t)bh * Sq + (row_ok ? i : 0)) * D, part);
#pragma unroll
  for (int e = 0; e < kE; ++e) acc[e] = 0.f;
  float m = kNegInf, l = 0.f;

  const float* kb = k + (size_t)kvh * Skv * D;
  const float* vb = v + (size_t)kvh * Skv * D;
  int lo, hi;
  kv_tiles<R, kBK>(q0, Sq, Skv, causal, window, &lo, &hi);
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

template <int D>
__global__ void __launch_bounds__(F32Shape<D>::kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int Hq, int Hkv, int Sq, int Skv, int causal, int window,
                    float scale) {
  constexpr int kE = F32Shape<D>::kE, TPR = D / kE, R = F32Shape<D>::kRows;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [kBK][D]
  float* Vs = Ks + kBK * D;                      // [kBK][D]

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - (bh / Hq) * Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int q0 = blockIdx.x * R;
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

  const float* kb = k + (size_t)kvh * Skv * D;
  const float* vb = v + (size_t)kvh * Skv * D;
  int lo, hi;
  kv_tiles<R, kBK>(q0, Sq, Skv, causal, window, &lo, &hi);
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

template <int D>
__global__ void __launch_bounds__(F32Shape<D>::kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int Hq, int Hkv, int Sq, int Skv,
                     int causal, int window, float scale) {
  constexpr int kE = F32Shape<D>::kE, TPR = D / kE, R = F32Shape<D>::kRows;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [kBQ][D]
  float* Ds = Qs + kBQ * D;                      // [kBQ][D] (do)
  float* Ls = Ds + kBQ * D;                      // [kBQ] lse
  float* Dl = Ls + kBQ;                          // [kBQ] delta

  const int bkv = blockIdx.y;
  const int b = bkv / Hkv, hkv = bkv - (bkv / Hkv) * Hkv;
  const int G = Hq / Hkv;
  const int k0 = blockIdx.x * R;
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
  q_tiles<kBQ, R>(k0, Sq, Skv, causal, window, &lo, &hi);
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

template <int D, bool kLse>
int launch_fwd_f32(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int Hq, int Hkv, int Sq, int Skv,
                   int causal, int window, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D, kLse>;
  const int smem = 2 * kBK * D * (int)sizeof(float);
  static const cudaError_t set = allow_smem(kernel, smem);
  if (set != cudaSuccess) return (int)set;
  constexpr int R = F32Shape<D>::kRows;
  const dim3 grid((Sq + R - 1) / R, B * Hq);
  kernel<<<grid, F32Shape<D>::kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o,
      (float*)lse, Hq, Hkv, Sq, Skv, causal, window, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_f32(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, int B, int Hq, int Hkv, int Sq, int Skv,
                  int causal, int window, float scale, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<D>;
  const int smem = 2 * kBK * D * (int)sizeof(float);
  static const cudaError_t set = allow_smem(kernel, smem);
  if (set != cudaSuccess) return (int)set;
  constexpr int R = F32Shape<D>::kRows;
  const dim3 grid((Sq + R - 1) / R, B * Hq);
  kernel<<<grid, F32Shape<D>::kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dq, Hq, Hkv, Sq, Skv,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_f32(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int B, int Hq, int Hkv, int Sq,
                   int Skv, int causal, int window, float scale,
                   cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<D>;
  const int smem = (2 * kBQ * D + 2 * kBQ) * (int)sizeof(float);
  static const cudaError_t set = allow_smem(kernel, smem);
  if (set != cudaSuccess) return (int)set;
  constexpr int R = F32Shape<D>::kRows;
  const dim3 grid((Skv + R - 1) / R, B * Hkv);
  kernel<<<grid, F32Shape<D>::kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, Hq, Hkv,
      Sq, Skv, causal, window, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: Hopper kernels, wgmma on TMA-loaded tiles
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;
constexpr int kWarps = 8;                // two warpgroups
constexpr int kThreads = 32 * kWarps;
constexpr int kPanelRow = 128;   // bytes of a tile row in one 64-column panel

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
               "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// until the phase of the given parity has completed. A wait of more than
// 2^34 cycles (seconds) is a lost arrival: it traps, so the launch fails
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}

// one (rows x 64 columns) box at (col, row, bh) of a 3-D tensor map into
// shared memory, completing `bar`'s transaction bytes
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(bh) : "memory");
}

// one box at offset x of a 1-D tensor map into shared memory
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// until at most N of this warpgroup's committed product groups are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads of an accumulator above wg_wait
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile (8-row groups
// 1024 bytes apart; lbo: the stride between 64-column panels, read only by
// an MN-major operand wider than one panel)
__device__ __forceinline__ uint64_t sw128(const void* p, uint32_t lbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 | (uint64_t)(1024 >> 4) << 32 |
         1ull << 62;
}
// K-major operand (the product's depth runs along the tile's columns):
// k-step kk is 16 columns, 32 bytes into panel kk / 4
__device__ __forceinline__ uint64_t kmajor(const uint8_t* tile, int panel,
                                           int kk) {
  return sw128(tile + (kk / 4) * panel + (kk % 4) * 32, 16);
}
// MN-major B (the depth runs along the tile's rows): k-step kk is rows
// [16 kk, 16 kk + 16), every panel
__device__ __forceinline__ uint64_t mnmajor(const uint8_t* tile, int panel,
                                            int kk) {
  return sw128(tile + kk * 16 * kPanelRow, panel);
}

// m64nNk16, f32 += bf16 x bf16. SS: A and B from shared memory, both
// K-major; RS: A from registers (the accumulator-shaped fragment of to_a),
// B MN-major. acc = 0 overwrites d.
__device__ __forceinline__ void mma_ss_n32(float* d, uint64_t da, uint64_t db,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void mma_ss_n64(float* d, uint64_t da, uint64_t db,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void mma_rs_n64(float* d, const uint32_t* a,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void mma_ss_n128(float* d, uint64_t da, uint64_t db,
                                            int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void mma_rs_n128(float* d, const uint32_t* a,
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// the product over one k-step with an N-column accumulator, both operands
// K-major in shared memory
template <int N>
__device__ __forceinline__ void mma_ss(float* d, uint64_t da, uint64_t db,
                                       int acc) {
  if constexpr (N == 32) mma_ss_n32(d, da, db, acc);
  else if constexpr (N == 64) mma_ss_n64(d, da, db, acc);
  else mma_ss_n128(d, da, db, acc);
}
// d += (hi + lo) b over k-step kk, b the N-column MN-major tile (64-column
// panels `panel` bytes apart) in shared memory; N = 256 as two 128-column
// halves (registers 0..63 and 64..127 of the accumulator)
template <int N>
__device__ __forceinline__ void mma_rs2(float* d, const uint32_t* hi,
                                        const uint32_t* lo,
                                        const uint8_t* tile, int panel,
                                        int kk) {
  const uint64_t db = mnmajor(tile, panel, kk);
  if constexpr (N == 64) {
    mma_rs_n64(d, hi, db, 1);
    mma_rs_n64(d, lo, db, 1);
  } else if constexpr (N == 128) {
    mma_rs_n128(d, hi, db, 1);
    mma_rs_n128(d, lo, db, 1);
  } else {
    static_assert(N == 256, "N is 64, 128 or 256");
    mma_rs2<128>(d, hi, lo, tile, panel, kk);
    mma_rs2<128>(d + 64, hi, lo, tile + 2 * panel, panel, kk);
  }
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}
// hi = bf16(x) and lo = bf16(x - hi) of two f32 values, packed in pairs
// (x - hi is exact in f32)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t* hi,
                                       uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  *hi = pack(h);
  *lo = pack(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}
// the A-operand fragments (hi and lo, one per 16 columns) of a 64 x N f32
// accumulator: wgmma's accumulator and A layouts agree per 8 x 8 block
// (thread lane holds row lane / 4 (+8), columns 2 (lane % 4) + {0, 1}), so
// column block j of the accumulator (registers 4j..4j+3) is half a k-step
template <int N>
__device__ __forceinline__ void to_a(const float* c, uint32_t (*hi)[4],
                                     uint32_t (*lo)[4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split2(c[8 * kk + 2 * r], c[8 * kk + 2 * r + 1], &hi[kk][r], &lo[kk][r]);
}

// In an m64nN accumulator, register e of thread (warp w of the warpgroup,
// lane) holds row 16 w + lane / 4 + 8 ((e / 2) % 2) and column
// 8 (e / 4) + 2 (lane % 4) + e % 2.
__device__ __forceinline__ int acc_half(int e) { return (e >> 1) & 1; }
__device__ __forceinline__ int acc_col(int e, int lane) {
  return 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~(uintptr_t)1023);
}

// Shared memory of a block: its fixed tiles, then a ring of kStages stages
// (two tiles each, then the columns' lse and delta if any, each stage
// 1024-aligned), then the mbarriers (fixed, full[kStages]) and the stages'
// release counters. A tile of R rows and D columns (a head dim's kPad) is
// D / 64 panels of R x 128 bytes.
template <int kTile, int kCols>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * kTile + (kCols ? 1024 : 0);
}
template <int kFixed, int kTile, int kStages, int kCols = 0>
constexpr int smem_bytes() {
  return 1024 + kFixed + kStages * stage_bytes<kTile, kCols>() +
         (1 + kStages) * 8 + kStages * 4;
}

// The columns a head dim's tiles are read at: whole 64-column TMA boxes
// (D = 80 as 128, the columns past 80 zero)
template <int D>
constexpr int kPad = (D + 63) / 64 * 64;

// The forward's ring: at D = 64, 64-key tiles in 2 stages and two blocks
// an SM (at most 128 registers a thread; a second block's warps issue
// while the first block's wait on their products or exps); at D = 80 and
// 128, 128-key tiles in 3 stages, one block an SM (the 64 x 128 f32 output
// accumulator alone is 64 registers a thread); at D = 256, 64-key tiles in
// 2 stages (a 128 x 256 q tile and two 64 x 256 tiles a stage: 192 KiB).
// dq: 64-key tiles in 3 stages (32 keys in 2 at D = 256); dk/dv: 32-query
// tiles (two 64 x 128 f32 accumulators, over 128 of the columns at D =
// 256) in 3 stages (2 at D = 256); one block an SM.
template <int D>
struct FwdShape {
  static constexpr int kBK = D == 64 || D == 256 ? 64 : 128;
  static constexpr int kStages = D == 64 || D == 256 ? 2 : 3;
  static constexpr int kBlocks = D == 64 ? 2 : 1;
};
template <int D>
struct BwdShape {
  static constexpr int kDqBK = D == 256 ? 32 : 64;
  static constexpr int kStages = D == 256 ? 2 : 3;
  static constexpr int kCols = kPad<D> < 128 ? kPad<D> : 128;  // dk/dv's
};
constexpr int kDkvBQ = 32;

// The ring of a block: n tiles in order, tile i in stage i % kStages.
// Thread 0 copies the fixed tiles and the first kStages ring tiles in; a
// warpgroup's products wait on the stage's "full" mbarrier (the copy's
// bytes have landed). When a warp is done with ring tile i it counts
// itself on the stage's counter, and the warp that completes the count
// (all eight are done with tile i) copies tile i + kStages in. No thread
// waits for another warpgroup. With kCols > 0 a stage also holds kCols
// entries of two 1-D f32 maps (tl, td: lse and delta) from the tile's
// flat row offset x = bh S + row: a TMA box must start 16-byte aligned,
// so the box (kCols + 4 entries) starts at x rounded down to a multiple
// of 4, and cols() points x % 4 entries into it.
template <int D, int kRows, int kStages, typename Where, int kCols = 0>
struct Ring {
  static constexpr int kTile = kRows * D * 2;   // bytes of one ring tile
  static constexpr int kStage = stage_bytes<kTile, kCols>();
  uint8_t* base;                                // stage s at s kStage
  uint64_t* bar;                                // fixed, full[kStages]
  int* done;                                    // [kStages] warps released
  const CUtensorMap* ta;
  const CUtensorMap* tb;
  int n;
  Where where;   // where(i, &row, &bh): the box origin of ring tile i
  const CUtensorMap* tl = nullptr;
  const CUtensorMap* td = nullptr;
  int S = 0;     // rows of a head in ta/tb (the flat offset bh S + row)

  __device__ __forceinline__ const uint8_t* a(int i) const {
    return base + (i % kStages) * kStage;
  }
  __device__ __forceinline__ const uint8_t* b(int i) const {
    return a(i) + kTile;
  }
  // lse of ring tile i's kCols rows; delta at + kDelta
  static constexpr int kDelta = 64;
  __device__ __forceinline__ const float* cols(int i) const {
    int row, bh;
    where(i, &row, &bh);
    return reinterpret_cast<const float*>(a(i) + 2 * kTile) +
           ((bh * S + row) & 3);
  }
  __device__ __forceinline__ void load(int i) const {
    const int s = i % kStages;
    int row, bh;
    where(i, &row, &bh);
    uint8_t* st = base + s * kStage;
    mbar_expect_tx(bar + 1 + s,
                   2 * kTile + (kCols ? 2 * (kCols + 4) * 4 : 0));
    for (int c = 0; c < D / 64; ++c) {
      tma_load(st + c * kRows * kPanelRow, ta, bar + 1 + s, 64 * c, row, bh);
      tma_load(st + kTile + c * kRows * kPanelRow, tb, bar + 1 + s, 64 * c,
               row, bh);
    }
    if (kCols) {
      const int x = (bh * S + row) & ~3;
      tma_load_1d(st + 2 * kTile, tl, bar + 1 + s, x);
      tma_load_1d(st + 2 * kTile + 4 * kDelta, td, bar + 1 + s, x);
    }
  }
  // every thread: the barriers; thread 0: the fixed tiles fa (and fb), R
  // rows at (row, bh), and the first ring tiles
  template <int R>
  __device__ __forceinline__ void start(uint8_t* fixed, const CUtensorMap* fa,
                                        const CUtensorMap* fb, int row,
                                        int bh) const {
    if (threadIdx.x == 0) {
      for (int s = 0; s <= kStages; ++s) mbar_init(bar + s, 1);
      for (int s = 0; s < kStages; ++s) done[s] = 0;
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      constexpr int kFix = R * D * 2;
      mbar_expect_tx(bar, fb ? 2 * kFix : kFix);
      for (int c = 0; c < D / 64; ++c) {
        tma_load(fixed + c * R * kPanelRow, fa, bar, 64 * c, row, bh);
        if (fb)
          tma_load(fixed + kFix + c * R * kPanelRow, fb, bar, 64 * c, row,
                   bh);
      }
      for (int i = 0; i < min(n, kStages); ++i) load(i);
    }
    __syncthreads();
    mbar_wait(bar, 0);
  }
  __device__ __forceinline__ void wait_full(int i) const {
    mbar_wait(bar + 1 + i % kStages, (i / kStages) & 1);
  }
  // this warp is done with ring tile i (and has waited for it: a warp
  // never counts itself on a use of a stage before that use's copy)
  __device__ __forceinline__ void release(int i) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0 &&
        atomicAdd(done + i % kStages, 1) == kWarps * (i / kStages + 1) - 1 &&
        i + kStages < n)
      load(i + kStages);
  }
  // a tile this warpgroup has no work in
  __device__ __forceinline__ void skip(int i) const {
    wait_full(i);
    release(i);
  }
};

template <int D, int kRows, int kStages, int kCols = 0, typename Where>
__device__ __forceinline__ Ring<D, kRows, kStages, Where, kCols> make_ring(
    uint8_t* base, const CUtensorMap* ta, const CUtensorMap* tb, int n,
    Where where) {
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      base + kStages * stage_bytes<kRows * D * 2, kCols>());
  return Ring<D, kRows, kStages, Where, kCols>{
      base, bar, reinterpret_cast<int*>(bar + 1 + kStages), ta, tb, n, where};
}

// [lo, hi) of a warpgroup's own tiles, inside the block's [blo, bhi)
__device__ __forceinline__ void clamp(int blo, int bhi, int* lo, int* hi) {
  *lo = min(max(*lo, blo), bhi);
  *hi = max(min(*hi, bhi), *lo);
}

// Scores are kept in log2 units, t = s log2(e), so that a weight is one
// ex2: exp(s - m) = 2^(t - m log2(e)). Masked scores stay -1e30 (-inf
// past Skv): a row with no valid key then has t = m = -1e30 and weight 1.
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the scores of one tile in log2 units (scale2 = scale log2(e)), masked
// where the tile crosses an edge: keys past Skv -inf, masked pairs -1e30.
// Rows (here: query rows row0, row0 + 8) and columns (keys from k0) as an
// accumulator holds them; transposed (kT: rows are keys, columns queries)
// for dk/dv. `edge` false: no pair of the tile is masked.
template <int N, bool kT>
__device__ __forceinline__ void scores2(float* s, float scale2, bool edge,
                                        int row0, int col0, int lane, int Sq,
                                        int Skv, int causal, int window) {
  const int off = Skv - Sq;
#pragma unroll
  for (int e = 0; e < N / 2; ++e) {
    float x = s[e] * scale2;
    if (edge) {
      const int row = row0 + 8 * acc_half(e), col = col0 + acc_col(e, lane);
      const int qi = kT ? col : row, kj = kT ? row : col;
      if (kT ? qi >= Sq : kj >= Skv) x = -INFINITY;
      else if (!allowed(qi + off, kj, causal, window)) x = kNegInf;
    }
    s[e] = x;
  }
}

// the forward's online softmax over one tile of log2 scores t: the running
// max m (log2 units), the weights p = 2^(t - m) in place, the running
// (per-thread partial) sum l, and corr = 2^(m_old - m) for the output
template <int BK>
__device__ __forceinline__ void online_softmax(float* t, float* m, float* l,
                                               float* corr) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int e = 0; e < BK / 2; ++e)
    mx[acc_half(e)] = fmaxf(mx[acc_half(e)], t[e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = ex2(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= corr[r];
  }
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    t[e] = ex2(t[e] - m[acc_half(e)]);
    l[acc_half(e)] += t[e];
  }
}

// lse in log2 units for the backward's p = 2^(t - lse2); a row with no
// valid key keeps lse = -1e30 (so that p = 1 there, as in the TPU kernels)
__device__ __forceinline__ float lse_log2(float lse) {
  return lse <= kNegInf ? kNegInf : lse * kLog2e;
}

// Forward: a block per (b*Hq, 128 query rows), warpgroup wg holding rows
// [64 wg, 64 wg + 64); BK keys a ring tile (k, then v). Each warpgroup
// pipelines its tiles: it issues tile i + 1's scores, then tile i's p v,
// and runs tile i + 1's softmax while p v is on the tensor cores.
template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, FwdShape<D>::kBlocks)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv,
                int causal, int window, float scale) {
  constexpr int DP = kPad<D>;
  constexpr int BK = FwdShape<D>::kBK, kQ = 128 * DP * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align1024(smem_raw);
  const int nqt = (Sq + 127) / 128;
  const int q0 = 128 * (causal ? nqt - 1 - (int)blockIdx.x : (int)blockIdx.x);
  const int bh = blockIdx.y, b = bh / Hq, h = bh - b * Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  int lo, hi;
  kv_tiles<128, BK>(q0, Sq, Skv, causal, window, &lo, &hi);
  const auto ring = make_ring<DP, BK, FwdShape<D>::kStages>(
      sq + kQ, &tk, &tv, hi - lo,
                                     [=](int i, int* row, int* head) {
                                       *row = (lo + i) * BK;
                                       *head = kvh;
                                     });
  ring.template start<128>(sq, &tq, nullptr, q0, bh);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qw = q0 + 64 * (warp / 4);
  const int row0 = qw + 16 * (warp % 4) + lane / 4;   // and row0 + 8
  const int off = Skv - Sq;
  const float scale2 = scale * kLog2e;
  int wlo, whi;
  kv_tiles<64, BK>(qw, Sq, Skv, causal, window, &wlo, &whi);
  clamp(lo, hi, &wlo, &whi);
  float acc[DP / 2], sc[BK / 2];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
  uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) acc[e] = 0.f;
  const uint8_t* qs = sq + (qw - q0) * kPanelRow;
  // s = q k^T of ring tile i into sc; o += p v of ring tile i
  auto scores = [&](int i) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<BK>(sc, kmajor(qs, 128 * kPanelRow, kk),
                 kmajor(ring.a(i), BK * kPanelRow, kk), kk > 0);
    wg_commit();
  };
  auto pv = [&](int i) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_rs2<DP>(acc, ph[kk], pl[kk], ring.b(i), BK * kPanelRow, kk);
    wg_commit();
  };
  auto softmax = [&](int i) {
    const int k0 = (lo + i) * BK;
    const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > qw + off) ||
                      (window > 0 && qw + 63 + off - k0 >= window);
    scores2<BK, false>(sc, scale2, edge, row0, k0, lane, Sq, Skv, causal,
                       window);
    online_softmax<BK>(sc, m, l, corr);
  };
  int i = 0;
  for (; lo + i < wlo; ++i) ring.skip(i);
  if (wlo < whi) {
    ring.wait_full(i);
    wg_fence();
    scores(i);
    wg_wait<0>();
    pin<BK / 2>(sc);
    softmax(i);                 // acc is 0: nothing to rescale
    to_a<BK>(sc, ph, pl);
    for (; lo + i + 1 < whi; ++i) {
      ring.wait_full(i + 1);
      wg_fence();
      scores(i + 1);
      pv(i);
      wg_wait<1>();
      pin<BK / 2>(sc);
      softmax(i + 1);
      wg_wait<0>();
      pin<DP / 2>(acc);
      ring.release(i);
#pragma unroll
      for (int e = 0; e < DP / 2; ++e) acc[e] *= corr[acc_half(e)];
      to_a<BK>(sc, ph, pl);
    }
    wg_fence();
    pv(i);
    wg_wait<0>();
    pin<DP / 2>(acc);
    ring.release(i++);
  }
  for (; lo + i < hi; ++i) ring.skip(i);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    const float ls = fmaxf(l[r], 1e-30f);
    bf16* orow = o + ((size_t)bh * Sq + row) * D + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] / ls, acc[4 * j + 2 * r + 1] / ls);
    if (kLse && (lane & 3) == 0)
      lse[(size_t)bh * Sq + row] =
          (m[r] <= kNegInf ? kNegInf : m[r] * kLn2) + logf(ls);
  }
}

// dq: a block per (b*Hq, 128 query rows) as the forward, 64 keys a ring
// tile (k, then v); q and do are the fixed tiles. Pipelined as the
// forward: tile i + 1's s and dp are issued, then tile i's dq += ds k.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int Hq, int Hkv, int Sq, int Skv, int causal, int window,
                   float scale) {
  constexpr int DP = kPad<D>;
  constexpr int BK = BwdShape<D>::kDqBK;
  constexpr int kQ = 128 * DP * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align1024(smem_raw);     // q, then do
  const int nqt = (Sq + 127) / 128;
  const int q0 = 128 * (causal ? nqt - 1 - (int)blockIdx.x : (int)blockIdx.x);
  const int bh = blockIdx.y, b = bh / Hq, h = bh - b * Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  int lo, hi;
  kv_tiles<128, BK>(q0, Sq, Skv, causal, window, &lo, &hi);
  const auto ring = make_ring<DP, BK, BwdShape<D>::kStages>(
      sq + 2 * kQ, &tk, &tv, hi - lo,
                                     [=](int i, int* row, int* head) {
                                       *row = (lo + i) * BK;
                                       *head = kvh;
                                     });
  ring.template start<128>(sq, &tq, &tdo, q0, bh);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qw = q0 + 64 * (warp / 4);
  const int row0 = qw + 16 * (warp % 4) + lane / 4;   // and row0 + 8
  const int off = Skv - Sq;
  const float scale2 = scale * kLog2e;
  int wlo, whi;
  kv_tiles<64, BK>(qw, Sq, Skv, causal, window, &wlo, &whi);
  clamp(lo, hi, &wlo, &whi);
  float lse2[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < Sq ? lse_log2(lse[(size_t)bh * Sq + row]) : 0.f;
    dl_r[r] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
  }
  float acc[DP / 2], sc[BK / 2], dp[BK / 2];
  uint32_t dh[BK / 16][4], dl[BK / 16][4];
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) acc[e] = 0.f;
  const uint8_t* qs = sq + (qw - q0) * kPanelRow;
  const uint8_t* dos = qs + kQ;
  // s = q k^T and dp = do v^T of ring tile i; dq += ds k of ring tile i
  auto products = [&](int i) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<BK>(sc, kmajor(qs, 128 * kPanelRow, kk),
                 kmajor(ring.a(i), BK * kPanelRow, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<BK>(dp, kmajor(dos, 128 * kPanelRow, kk),
                 kmajor(ring.b(i), BK * kPanelRow, kk), kk > 0);
    wg_commit();
  };
  auto dsk = [&](int i) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_rs2<DP>(acc, dh[kk], dl[kk], ring.a(i), BK * kPanelRow, kk);
    wg_commit();
  };
  // p = 2^(t - lse2) (t masked as the forward), ds = p (dp - delta) scale,
  // into sc
  auto ds = [&](int i) {
    const int k0 = (lo + i) * BK;
    const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > qw + off) ||
                      (window > 0 && qw + 63 + off - k0 >= window);
    scores2<BK, false>(sc, scale2, edge, row0, k0, lane, Sq, Skv, causal,
                       window);
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const float p = ex2(sc[e] - lse2[acc_half(e)]);
      sc[e] = p * (dp[e] - dl_r[acc_half(e)]) * scale;
    }
  };
  int i = 0;
  for (; lo + i < wlo; ++i) ring.skip(i);
  if (wlo < whi) {
    ring.wait_full(i);
    wg_fence();
    products(i);
    wg_wait<0>();
    pin<BK / 2>(sc);
    pin<BK / 2>(dp);
    ds(i);
    to_a<BK>(sc, dh, dl);
    for (; lo + i + 1 < whi; ++i) {
      ring.wait_full(i + 1);
      wg_fence();
      products(i + 1);
      dsk(i);
      wg_wait<1>();
      pin<BK / 2>(sc);
      pin<BK / 2>(dp);
      ds(i + 1);
      wg_wait<0>();
      pin<DP / 2>(acc);
      ring.release(i);
      to_a<BK>(sc, dh, dl);
    }
    wg_fence();
    dsk(i);
    wg_wait<0>();
    pin<DP / 2>(acc);
    ring.release(i++);
  }
  for (; lo + i < hi; ++i) ring.skip(i);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    bf16* drow = dq + ((size_t)bh * Sq + row) * D + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(drow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// dk/dv: a block per (b*Hkv, 128 key rows), warpgroup wg holding keys
// [64 wg, 64 wg + 64); k and v are the fixed tiles, q and do the ring's
// (BQ queries a tile, over the group's G heads in turn). The products run
// transposed: s^T = k q^T and dp^T = v do^T put p^T and ds^T in the
// accumulator layout, whence they are the A operand of dv += p^T do and
// dk += ds^T q; lse and delta are read per column. Pipelined as the
// forward within each head. The tensor cores' f32 accumulation truncates:
// over a group of 8 heads of 4096 queries its drift reaches two bf16 ulps
// (PERF.md), so with G > 1 each head's sums are moved into an f32 scratch
// (B, Hkv, Skv, D) pair, (((head 0) + head 1) + ...) rounded to nearest,
// and the accumulators start again from zero. Block z of a key tile
// accumulates the kCols columns of dk and dv from c0 = kCols z (all of
// them below D = 256).
template <int D, int BQ>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tlse,
                    const __grid_constant__ CUtensorMap tdelta,
                    bf16* __restrict__ dk, bf16* __restrict__ dv,
                    float* __restrict__ scratch, int Hq, int Hkv, int Sq,
                    int Skv, int causal, int window, float scale) {
  constexpr int DP = kPad<D>, DN = BwdShape<D>::kCols;
  constexpr int kOut = DN < D ? DN : D;  // the columns this block stores
  constexpr int kK = 128 * DP * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sk = align1024(smem_raw);     // k, then v
  const int bkv = blockIdx.y, b = bkv / Hkv, hkv = bkv - b * Hkv;
  const int G = Hq / Hkv;
  const int k0 = 128 * blockIdx.x;
  const int c0 = DN * blockIdx.z;        // this block's dk/dv columns
  int lo, hi;
  q_tiles<BQ, 128>(k0, Sq, Skv, causal, window, &lo, &hi);
  const int nq = max(hi - lo, 0);
  auto ring = make_ring<DP, BQ, BwdShape<D>::kStages, BQ>(
      sk + 2 * kK, &tq, &tdo, G * nq, [=](int i, int* row, int* head) {
        *row = (lo + i % nq) * BQ;
        *head = b * Hq + hkv * G + i / nq;
      });
  ring.tl = &tlse;
  ring.td = &tdelta;
  ring.S = Sq;
  ring.template start<128>(sk, &tk, &tv, k0, bkv);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kw = k0 + 64 * (warp / 4);
  const int key0 = kw + 16 * (warp % 4) + lane / 4;   // and key0 + 8
  const int off = Skv - Sq;
  const float scale2 = scale * kLog2e;
  int wlo, whi;
  q_tiles<BQ, 64>(kw, Sq, Skv, causal, window, &wlo, &whi);
  clamp(lo, lo + nq, &wlo, &whi);
  float dka[DN / 2], dva[DN / 2], st[BQ / 2], dpt[BQ / 2];
  uint32_t ph[BQ / 16][4], pl[BQ / 16][4], dh[BQ / 16][4], dl[BQ / 16][4];
#pragma unroll
  for (int e = 0; e < DN / 2; ++e) dka[e] = dva[e] = 0.f;
  const uint8_t* ks = sk + (kw - k0) * kPanelRow;
  const uint8_t* vs = ks + kK;
  // s^T = k q^T and dp^T = v do^T of ring tile i; then dv += p^T do and
  // dk += ds^T q of ring tile i
  auto products = [&](int i) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<BQ>(st, kmajor(ks, 128 * kPanelRow, kk),
                 kmajor(ring.a(i), BQ * kPanelRow, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<BQ>(dpt, kmajor(vs, 128 * kPanelRow, kk),
                 kmajor(ring.b(i), BQ * kPanelRow, kk), kk > 0);
    wg_commit();
  };
  const int cpanel = (c0 / 64) * BQ * kPanelRow;   // c0's panel in a tile
  auto grads = [&](int i) {
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      mma_rs2<DN>(dva, ph[kk], pl[kk], ring.b(i) + cpanel, BQ * kPanelRow,
                  kk);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      mma_rs2<DN>(dka, dh[kk], dl[kk], ring.a(i) + cpanel, BQ * kPanelRow,
                  kk);
    wg_commit();
  };
  // p^T = 2^(t^T - lse2) into st, ds^T = p^T (dp^T - delta) scale into dpt,
  // for ring tile i (queries from q0; its lse and delta in the ring)
  auto p_ds = [&](int i, int q0) {
    const bool edge = q0 + BQ > Sq || (causal && kw + 63 > q0 + off) ||
                      (window > 0 && q0 + BQ - 1 + off - kw >= window);
    scores2<BQ, true>(st, scale2, edge, key0, q0, lane, Sq, Skv, causal,
                      window);
    const float* cl = ring.cols(i);
#pragma unroll
    for (int e = 0; e < BQ / 2; ++e) {
      const int c = acc_col(e, lane);
      const float p = ex2(st[e] - lse_log2(cl[c]));
      st[e] = p;
      dpt[e] = p * (dpt[e] - cl[decltype(ring)::kDelta + c]) * scale;
    }
  };
  // after a head of the group: its sums into the scratch (the first head's
  // stored, later ones added), the accumulators back to zero; after the
  // last, the scratch into the accumulators
  auto promote = [&](bool first, bool last) {
    const size_t half = (size_t)gridDim.y * Skv * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= Skv) continue;
      float* sk_ =
          scratch + ((size_t)bkv * Skv + key) * D + c0 + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < kOut / 8; ++j) {
        float2* pk = reinterpret_cast<float2*>(sk_ + 8 * j);
        float2* pv = reinterpret_cast<float2*>(sk_ + half + 8 * j);
        float2 ak = make_float2(dka[4 * j + 2 * r], dka[4 * j + 2 * r + 1]);
        float2 av = make_float2(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
        if (!first) {
          const float2 ok = *pk, ov = *pv;
          ak = make_float2(ok.x + ak.x, ok.y + ak.y);
          av = make_float2(ov.x + av.x, ov.y + av.y);
        }
        if (last) {
          dka[4 * j + 2 * r] = ak.x;
          dka[4 * j + 2 * r + 1] = ak.y;
          dva[4 * j + 2 * r] = av.x;
          dva[4 * j + 2 * r + 1] = av.y;
        } else {
          *pk = ak;
          *pv = av;
        }
      }
    }
    if (!last) {
#pragma unroll
      for (int e = 0; e < DN / 2; ++e) dka[e] = dva[e] = 0.f;
    }
  };
  int i = 0;
  for (int g = 0; g < G; ++g) {
    for (int qt = lo; qt < wlo; ++qt) ring.skip(i++);
    if (wlo < whi) {
      ring.wait_full(i);
      wg_fence();
      products(i);
      wg_wait<0>();
      pin<BQ / 2>(st);
      pin<BQ / 2>(dpt);
      p_ds(i, wlo * BQ);
      to_a<BQ>(st, ph, pl);
      to_a<BQ>(dpt, dh, dl);
      for (int qt = wlo + 1; qt < whi; ++qt, ++i) {
        ring.wait_full(i + 1);
        wg_fence();
        products(i + 1);
        grads(i);
        wg_wait<1>();
        pin<BQ / 2>(st);
        pin<BQ / 2>(dpt);
        p_ds(i + 1, qt * BQ);
        wg_wait<0>();
        pin<DN / 2>(dka);
        pin<DN / 2>(dva);
        ring.release(i);
        to_a<BQ>(st, ph, pl);
        to_a<BQ>(dpt, dh, dl);
      }
      wg_fence();
      grads(i);
      wg_wait<0>();
      pin<DN / 2>(dka);
      pin<DN / 2>(dva);
      ring.release(i++);
    }
    for (int qt = whi; qt < lo + nq; ++qt) ring.skip(i++);
    if (G > 1) promote(g == 0, g + 1 == G);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= Skv) continue;
    const size_t base = ((size_t)bkv * Skv + key) * D + c0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < kOut / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + base + 8 * j) =
          __floats2bfloat162_rn(dka[4 * j + 2 * r], dka[4 * j + 2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + base + 8 * j) =
          __floats2bfloat162_rn(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime (the
// library is not linked against libcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// (BH, S, D) bf16 as a 3-D tensor map read in (rows x 64 columns) boxes,
// 128-byte swizzled; rows past S and columns past D (D = 80: 80..127 of
// the second box) read as zeros. Returns a cudaError_t.
int tile_map(CUtensorMap* map, const void* base, int BH, int S, int D,
             int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}


template <int D, bool kLse>
int launch_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                    void* lse, int B, int Hq, int Hkv, int Sq, int Skv,
                    int causal, int window, float scale, cudaStream_t stream) {
  constexpr int BK = FwdShape<D>::kBK;
  CUtensorMap tq, tk, tv;
  int err;
  if ((err = tile_map(&tq, q, B * Hq, Sq, D, 128)) ||
      (err = tile_map(&tk, k, B * Hkv, Skv, D, BK)) ||
      (err = tile_map(&tv, v, B * Hkv, Skv, D, BK)))
    return err;
  auto kernel = flash_fwd_wgmma<D, kLse>;
  constexpr int DP = kPad<D>;
  constexpr int smem =
      smem_bytes<128 * DP * 2, BK * DP * 2, FwdShape<D>::kStages>();
  static const cudaError_t set = allow_smem(kernel, smem);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid((Sq + 127) / 128, B * Hq);
  kernel<<<grid, kThreads, smem, stream>>>(tq, tk, tv, (bf16*)o, (float*)lse,
                                           Hq, Hkv, Sq, Skv, causal, window,
                                           scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_bf16(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int B, int Hq, int Hkv, int Sq, int Skv,
                   int causal, int window, float scale, cudaStream_t stream) {
  constexpr int DP = kPad<D>, BK = BwdShape<D>::kDqBK;
  CUtensorMap tq, tk, tv, tdo;
  int err;
  if ((err = tile_map(&tq, q, B * Hq, Sq, D, 128)) ||
      (err = tile_map(&tdo, dout, B * Hq, Sq, D, 128)) ||
      (err = tile_map(&tk, k, B * Hkv, Skv, D, BK)) ||
      (err = tile_map(&tv, v, B * Hkv, Skv, D, BK)))
    return err;
  auto kernel = flash_bwd_dq_wgmma<D>;
  constexpr int smem =
      smem_bytes<2 * 128 * DP * 2, BK * DP * 2, BwdShape<D>::kStages>();
  static const cudaError_t set = allow_smem(kernel, smem);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid((Sq + 127) / 128, B * Hq);
  kernel<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, tdo, (const float*)lse, (const float*)delta, (bf16*)dq, Hq,
      Hkv, Sq, Skv, causal, window, scale);
  return (int)cudaGetLastError();
}

// n f32 as a 1-D tensor map read in boxes of kDkvBQ + 4 (lse or delta
// around a tile's flat row offset bh Sq + q0); entries past n read as zeros
int cols_map(CUtensorMap* map, const void* base, int n) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 4};   // (none for rank 1)
  const cuuint32_t box[1] = {(cuuint32_t)kDkvBQ + 4}, unit[1] = {1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch_dkv_bf16(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, void* scratch, int B, int Hq, int Hkv,
                    int Sq, int Skv, int causal, int window, float scale,
                    cudaStream_t stream) {
  if (Hq > Hkv && !scratch) return (int)cudaErrorInvalidValue;
  constexpr int BQ = kDkvBQ;
  CUtensorMap tq, tk, tv, tdo, tlse, tdelta;
  int err;
  if ((err = tile_map(&tq, q, B * Hq, Sq, D, BQ)) ||
      (err = tile_map(&tdo, dout, B * Hq, Sq, D, BQ)) ||
      (err = cols_map(&tlse, lse, B * Hq * Sq)) ||
      (err = cols_map(&tdelta, delta, B * Hq * Sq)) ||
      (err = tile_map(&tk, k, B * Hkv, Skv, D, 128)) ||
      (err = tile_map(&tv, v, B * Hkv, Skv, D, 128)))
    return err;
  auto kernel = flash_bwd_dkv_wgmma<D, BQ>;
  constexpr int DP = kPad<D>;
  constexpr int smem =
      smem_bytes<2 * 128 * DP * 2, BQ * DP * 2, BwdShape<D>::kStages, BQ>();
  static const cudaError_t set = allow_smem(kernel, smem);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid((Skv + 127) / 128, B * Hkv, DP / BwdShape<D>::kCols);
  kernel<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, tdo, tlse, tdelta, (bf16*)dk, (bf16*)dv, (float*)scratch,
      Hq, Hkv, Sq, Skv, causal, window, scale);
  return (int)cudaGetLastError();
}

bool shapes_ok(int B, int Hq, int Hkv, int Sq, int Skv, int D) {
  return B > 0 && Hkv > 0 && Hq % Hkv == 0 && Sq > 0 && Skv > 0 &&
         (D == 64 || D == 80 || D == 128 || D == 256) &&
         (long long)B * Hq < 65536;
}

// dispatch on (dtype, D): dtype 0 = f32 (the CUDA-core kernels), 1 = bf16
// (the Hopper kernels); anything else is refused
#define REPRO_FLASH_DISPATCH(D, dtype, F32, BF16)                         \
  if (dtype == 0 && D == 64) { constexpr int kD = 64; return F32; }       \
  if (dtype == 0 && D == 80) { constexpr int kD = 80; return F32; }       \
  if (dtype == 0 && D == 128) { constexpr int kD = 128; return F32; }     \
  if (dtype == 0 && D == 256) { constexpr int kD = 256; return F32; }     \
  if (dtype == 1 && D == 64) { constexpr int kD = 64; return BF16; }      \
  if (dtype == 1 && D == 80) { constexpr int kD = 80; return BF16; }      \
  if (dtype == 1 && D == 128) { constexpr int kD = 128; return BF16; }    \
  if (dtype == 1 && D == 256) { constexpr int kD = 256; return BF16; }    \
  return (int)cudaErrorInvalidValue;

}  // namespace

extern "C" {

// q (B,Hq,Sq,D), k/v (B,Hkv,Skv,D) -> o (B,Hq,Sq,D); window <= 0: none.
// Returns the cudaError_t of the launch (0 on success).
int flash_fwd(const void* q, const void* k, const void* v, void* o, int B,
              int Hq, int Hkv, int Sq, int Skv, int D, int dtype, int causal,
              int window, float scale, void* stream) {
  if (!shapes_ok(B, Hq, Hkv, Sq, Skv, D)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  REPRO_FLASH_DISPATCH(D, dtype,
      (launch_fwd_f32<kD, false>(q, k, v, o, nullptr, B, Hq, Hkv, Sq, Skv,
                                 causal, window, scale, st)),
      (launch_fwd_bf16<kD, false>(q, k, v, o, nullptr, B, Hq, Hkv, Sq, Skv,
                                  causal, window, scale, st)));
}

// as flash_fwd, and lse (B,Hq,Sq) f32
int flash_fwd_lse(const void* q, const void* k, const void* v, void* o,
                  void* lse, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                  int dtype, int causal, int window, float scale,
                  void* stream) {
  if (!shapes_ok(B, Hq, Hkv, Sq, Skv, D)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  REPRO_FLASH_DISPATCH(D, dtype,
      (launch_fwd_f32<kD, true>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, causal,
                                window, scale, st)),
      (launch_fwd_bf16<kD, true>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, causal,
                                 window, scale, st)));
}

// dout (B,Hq,Sq,D); lse, delta (B,Hq,Sq) f32 -> dq (B,Hq,Sq,D)
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                 int dtype, int causal, int window, float scale,
                 void* stream) {
  if (!shapes_ok(B, Hq, Hkv, Sq, Skv, D)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  REPRO_FLASH_DISPATCH(D, dtype,
      (launch_dq_f32<kD>(q, k, v, dout, lse, delta, dq, B, Hq, Hkv, Sq, Skv,
                         causal, window, scale, st)),
      (launch_dq_bf16<kD>(q, k, v, dout, lse, delta, dq, B, Hq, Hkv, Sq, Skv,
                          causal, window, scale, st)));
}

// -> dk, dv (B,Hkv,Skv,D), summed over each kv head's group in f32; bf16
// with Hq > Hkv needs scratch: 2 x (B,Hkv,Skv,D) f32 (its contents are
// overwritten; f32 ignores it)
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, void* scratch, int B, int Hq, int Hkv,
                  int Sq, int Skv, int D, int dtype, int causal, int window,
                  float scale, void* stream) {
  if (!shapes_ok(B, Hq, Hkv, Sq, Skv, D)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  REPRO_FLASH_DISPATCH(D, dtype,
      (launch_dkv_f32<kD>(q, k, v, dout, lse, delta, dk, dv, B, Hq, Hkv, Sq,
                          Skv, causal, window, scale, st)),
      (launch_dkv_bf16<kD>(q, k, v, dout, lse, delta, dk, dv, scratch, B, Hq,
                           Hkv, Sq, Skv, causal, window, scale, st)));
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
