// Chunked linear scan (the SSD / gated-linear-attention recurrence of Mamba2).
//
// Replaces the Pallas TPU kernel
//   linear_scan_fwd (_scan_kernel)   src/repro/kernels/linear_scan/kernel.py:68
//                                    (pallas_call at :83)
//
// Per head bh it computes, with an f32 (ds x hd) state,
//
//     h_t = exp(g_t) h_{t-1} + k_t v_t^T ;   y_t = q_t^T h_t
//
// in chunk-parallel form. Within a chunk of L steps, with cum the running
// sum of g from the chunk's start and h_in the state entering it,
//
//     y_i   = exp(cum_i) q_i^T h_in + sum_{j <= i} exp(cum_i - cum_j) (q_i . k_j) v_j
//     h_out = exp(cum_{L-1}) h_in + sum_j exp(cum_{L-1} - cum_j) k_j v_j^T
//
// With strict = 1 the sum runs over j < i: y_t = q_t^T (h_t - k_t v_t^T),
// the form the backward's dq and dk calls take (the diagonal is added back
// outside, so that dg is not a difference of two sums that the diagonal
// dominates). Given y_inter, the kernel also writes the first term alone,
// exp(cum_i) q_i^T h_in (f32): the backward assembles dg chunk by chunk
// from it (kernels/linear_scan/ops.py).
//
// cum is summed in f64 and each exponent, cum_i - cum_j, is taken in f64
// before it is rounded to f32 for expf. Within a chunk |cum| reaches
// L |g| (hundreds at zamba2's decays), where an f32 cum would carry an
// absolute error of its ulp (1e-5..1e-4) into every exponent: a relative
// error of that size in every term, which the backward's dg, a difference
// of sums formed by two calls with differently rounded exponents, turns
// into errors far above f32 rounding in the decay-rate gradient (PERF.md).
//
// Layout as in JAX: g (BH, S) f32; q, k (BHG, S, ds), shared by the
// rep = BH / BHG heads of a group (head bh reads row bh / rep, the JAX index
// map at kernel.py:79-80); v (BH, S, hd); y (BH, S, hd) in v's type. q and k
// are f32 or bf16, v f32 or bf16 (the Mamba2 mapping feeds bf16 q, k and an
// f32 v = x * dt); every product and sum is f32, and y is rounded once.
// The backward of the scan is this same kernel on flipped and swapped f32
// operands (kernels/linear_scan/ops.py), so ds and hd each take 16, 32, 64
// or 128.
//
// Grid: one block per (head, slice of hs of the hd columns). The columns of
// v, of the state and of y are independent, so splitting hd puts more
// blocks on the card when the heads alone would leave SMs idle; each slice
// recomputes the chunk's q . k scores. The block walks the chunks in order
// (the TPU's sequential chunk grid axis) with the (ds x hs) state in shared
// memory. A chunk is cut into 64-step tiles: for each query tile, the
// inter-chunk term from h_in, then the key tiles at or before it, where a
// score is formed only for i >= j and exp(cum_i - cum_j) is evaluated only
// there (the TPU kernel forms the whole q k^T and masks after the exp);
// then the state update over the chunk's key tiles. A ragged chunk (L not a
// multiple of 64) masks its last tile; any L that divides S works.
//
// What bounds it on an H100: per head and chunk it does about
// L^2/2 (ds + hd) + 2 L ds hd multiply-adds against L (2 ds + 2 hd) loads.
// At zamba2's main shape the least time is the bytes (the chunked form's
// products at the tensor cores' rate would take less). This first version
// runs the products as f32 FMAs on the CUDA cores (67 TFLOP/s peak), which
// bound it: tiles staged in shared memory, each thread a 4 x 4 (or
// 4 x hs/16) block of outputs in registers, conflict-free shared-memory
// strides. Tensor-core products (mma.sync / wgmma), TMA loads and a
// chunk-parallel state pass are later work. No atomics: every output
// element is written once after a fixed-order loop, so two runs give the
// same bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;          // steps per tile (queries and keys)
constexpr int kThreads = 256;   // 16 x 16 threads: (ty, tx)
constexpr int kSLD = 80;        // score row stride: conflict-free writes

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Shared memory: cum[L] (f64), then in floats hst[DS*HS] | qs[kT*(DS+1)] |
// ks[kT*(DS+1)] | vs[kT*HS] | ss[kT*kSLD]
template <int DS, int HS>
constexpr int smem_floats_fixed() {
  return DS * HS + 2 * kT * (DS + 1) + kT * HS + kT * kSLD;
}

template <typename TQK, typename TV, int DS, int HS>
__global__ void __launch_bounds__(kThreads)
linear_scan_kernel(const float* __restrict__ g, const TQK* __restrict__ q,
                   const TQK* __restrict__ k, const TV* __restrict__ v,
                   TV* __restrict__ y, float* __restrict__ y_inter, int S,
                   int hd, int rep, int L, int strict) {
  constexpr int QLD = DS + 1;        // odd stride: column reads hit 16 banks
  constexpr int CPT = HS / 16;       // output columns per thread
  constexpr int RPT = DS / 16;       // state rows per thread (state update)
  extern __shared__ double smem_d[];
  double* cum = smem_d;
  float* hst = reinterpret_cast<float*>(cum + L);   // the state
  float* qs = hst + DS * HS;
  float* ks = qs + kT * QLD;
  float* vs = ks + kT * QLD;
  float* ss = vs + kT * HS;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int64_t bh = blockIdx.x;
  const int col0 = blockIdx.y * HS;
  const int64_t grp = bh / rep;
  const float* gh = g + bh * S;
  const TQK* qh = q + grp * S * DS;
  const TQK* kh = k + grp * S * DS;
  const TV* vh = v + bh * S * hd + col0;
  TV* yh = y + bh * S * hd + col0;
  float* yih = y_inter == nullptr ? nullptr : y_inter + bh * S * hd + col0;
  const int nt = (L + kT - 1) / kT;   // tiles per chunk

  for (int i = tid; i < DS * HS; i += kThreads) hst[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += L) {
    // -- cum: inclusive running sum of g over the chunk (warp 0) ---------
    __syncthreads();   // the previous chunk is done with cum and hst
    for (int t = tid; t < L; t += kThreads) cum[t] = gh[c0 + t];
    __syncthreads();
    if (tid < 32) {
      const int per = (L + 31) / 32;
      const int beg = min(tid * per, L), end = min(beg + per, L);
      double s = 0.0;
      for (int t = beg; t < end; ++t) {
        s += cum[t];
        cum[t] = s;
      }
      double incl = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double n = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += n;
      }
      const double excl = incl - s;
      for (int t = beg; t < end; ++t) cum[t] += excl;
    }
    __syncthreads();

    // -- outputs, one query tile at a time ------------------------------
    for (int qt = 0; qt < nt; ++qt) {
      const int i0 = qt * kT;
      for (int idx = tid; idx < kT * DS; idx += kThreads) {
        const int r = idx / DS, d = idx % DS;
        qs[r * QLD + d] =
            i0 + r < L ? ld(qh + (int64_t)(c0 + i0 + r) * DS + d) : 0.f;
      }
      __syncthreads();
      float acc[4][CPT];
      // inter-chunk: exp(cum_i) q_i^T h_in
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) acc[r][cc] = 0.f;
      if (c0 > 0) {
#pragma unroll 8
        for (int d = 0; d < DS; ++d) {
          float a[4], b[CPT];
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = qs[(ty + 16 * r) * QLD + d];
#pragma unroll
          for (int cc = 0; cc < CPT; ++cc) b[cc] = hst[d * HS + tx + 16 * cc];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int cc = 0; cc < CPT; ++cc) acc[r][cc] += a[r] * b[cc];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
          const float e = i < L ? expf((float)cum[i]) : 0.f;
#pragma unroll
          for (int cc = 0; cc < CPT; ++cc) acc[r][cc] *= e;
        }
      }
      if (yih != nullptr) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
          if (i < L) {
#pragma unroll
            for (int cc = 0; cc < CPT; ++cc)
              yih[(int64_t)(c0 + i) * hd + tx + 16 * cc] = acc[r][cc];
          }
        }
      }
      // intra-chunk: key tiles at or before the query tile
      for (int kt = 0; kt <= qt; ++kt) {
        const int j0 = kt * kT;
        for (int idx = tid; idx < kT * DS; idx += kThreads) {
          const int r = idx / DS, d = idx % DS;
          ks[r * QLD + d] =
              j0 + r < L ? ld(kh + (int64_t)(c0 + j0 + r) * DS + d) : 0.f;
        }
        for (int idx = tid; idx < kT * HS; idx += kThreads) {
          const int r = idx / HS, cc = idx % HS;
          vs[r * HS + cc] =
              j0 + r < L ? ld(vh + (int64_t)(c0 + j0 + r) * hd + cc) : 0.f;
        }
        __syncthreads();
        // scores s_ij = exp(cum_i - cum_j) (q_i . k_j), i >= j only
        float s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
        for (int d = 0; d < DS; ++d) {
          float a[4], b[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = qs[(ty + 16 * r) * QLD + d];
#pragma unroll
          for (int c = 0; c < 4; ++c) b[c] = ks[(tx + 16 * c) * QLD + d];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[r][c] += a[r] * b[c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx + 16 * c;
            // the mask comes before the exp: cum_i - cum_j > 0 above the
            // diagonal and may overflow
            ss[(ty + 16 * r) * kSLD + tx + 16 * c] =
                (i < L && j + strict <= i)
                    ? s[r][c] * expf((float)(cum[i] - cum[j]))
                    : 0.f;
          }
        }
        __syncthreads();
        // y += s v
#pragma unroll 8
        for (int j = 0; j < kT; ++j) {
          float a[4], b[CPT];
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = ss[(ty + 16 * r) * kSLD + j];
#pragma unroll
          for (int cc = 0; cc < CPT; ++cc) b[cc] = vs[j * HS + tx + 16 * cc];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int cc = 0; cc < CPT; ++cc) acc[r][cc] += a[r] * b[cc];
        }
        __syncthreads();   // ks, vs, ss (and, after the last, qs) are free
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i < L) {
#pragma unroll
          for (int cc = 0; cc < CPT; ++cc)
            st(yh + (int64_t)(c0 + i) * hd + tx + 16 * cc, acc[r][cc]);
        }
      }
    }

    // -- state update: h = exp(seg) h + sum_j (k_j exp(seg - cum_j)) v_j^T
    if (c0 + L < S) {
      const double seg = cum[L - 1];
      float h2[RPT][CPT];
#pragma unroll
      for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) h2[rr][cc] = 0.f;
      for (int kt = 0; kt < nt; ++kt) {
        const int j0 = kt * kT;
        for (int idx = tid; idx < kT * DS; idx += kThreads) {
          const int r = idx / DS, d = idx % DS;
          const int j = j0 + r;
          ks[r * QLD + d] =
              j < L ? ld(kh + (int64_t)(c0 + j) * DS + d) *
                          expf((float)(seg - cum[j]))
                    : 0.f;
        }
        for (int idx = tid; idx < kT * HS; idx += kThreads) {
          const int r = idx / HS, cc = idx % HS;
          vs[r * HS + cc] =
              j0 + r < L ? ld(vh + (int64_t)(c0 + j0 + r) * hd + cc) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int j = 0; j < kT; ++j) {
          float a[RPT], b[CPT];
#pragma unroll
          for (int rr = 0; rr < RPT; ++rr) a[rr] = ks[j * QLD + ty + 16 * rr];
#pragma unroll
          for (int cc = 0; cc < CPT; ++cc) b[cc] = vs[j * HS + tx + 16 * cc];
#pragma unroll
          for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
            for (int cc = 0; cc < CPT; ++cc) h2[rr][cc] += a[rr] * b[cc];
        }
        __syncthreads();
      }
      const float es = expf((float)seg);
#pragma unroll
      for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          float* hp = hst + (ty + 16 * rr) * HS + tx + 16 * cc;
          *hp = es * *hp + h2[rr][cc];
        }
    }
  }
}

template <typename TQK, typename TV, int DS, int HS>
int launch_typed(const void* g, const void* q, const void* k, const void* v,
                 void* y, void* y_inter, int BH, int rep, int S, int hd,
                 int L, int strict, cudaStream_t stream) {
  auto kern = linear_scan_kernel<TQK, TV, DS, HS>;
  const size_t bytes =
      sizeof(double) * (size_t)L + sizeof(float) * smem_floats_fixed<DS, HS>();
  static size_t granted = 48 * 1024;
  if (bytes > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    granted = bytes;
  }
  const dim3 grid((unsigned)BH, (unsigned)(hd / HS));
  kern<<<grid, kThreads, bytes, stream>>>(
      (const float*)g, (const TQK*)q, (const TQK*)k, (const TV*)v, (TV*)y,
      (float*)y_inter, S, hd, rep, L, strict);
  return (int)cudaGetLastError();
}

template <typename TQK, typename TV, int HS>
int launch_ds(int ds, const void* g, const void* q, const void* k,
              const void* v, void* y, void* yi, int BH, int rep, int S,
              int hd, int L, int strict, cudaStream_t stream) {
  switch (ds) {
    case 16: return launch_typed<TQK, TV, 16, HS>(g, q, k, v, y, yi, BH, rep, S, hd, L, strict, stream);
    case 32: return launch_typed<TQK, TV, 32, HS>(g, q, k, v, y, yi, BH, rep, S, hd, L, strict, stream);
    case 64: return launch_typed<TQK, TV, 64, HS>(g, q, k, v, y, yi, BH, rep, S, hd, L, strict, stream);
    case 128: return launch_typed<TQK, TV, 128, HS>(g, q, k, v, y, yi, BH, rep, S, hd, L, strict, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename TQK, typename TV>
int launch_hs(int hs, int ds, const void* g, const void* q, const void* k,
              const void* v, void* y, void* yi, int BH, int rep, int S,
              int hd, int L, int strict, cudaStream_t stream) {
  switch (hs) {
    case 16: return launch_ds<TQK, TV, 16>(ds, g, q, k, v, y, yi, BH, rep, S, hd, L, strict, stream);
    case 32: return launch_ds<TQK, TV, 32>(ds, g, q, k, v, y, yi, BH, rep, S, hd, L, strict, stream);
    case 64: return launch_ds<TQK, TV, 64>(ds, g, q, k, v, y, yi, BH, rep, S, hd, L, strict, stream);
  }
  return (int)cudaErrorInvalidValue;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

bool dim_ok(int n) { return n == 16 || n == 32 || n == 64 || n == 128; }

}  // namespace

extern "C" {

// g (BH, S) f32; q, k (BHG, S, ds); v, y (BH, S, hd); all contiguous;
// y_inter: null, or (BH, S, hd) f32 for the inter-chunk term alone.
// qk_bf16 / v_bf16: 1 for bf16, 0 for f32 (y has v's type). chunk divides
// S. strict: 1 leaves each step's own term out of its output. A block owns
// the widest slice of hd columns (64, 32 or 16) that still gives one block
// per SM. Returns the cudaError_t of the launch (0 on success).
int linear_scan(const void* g, const void* q, const void* k, const void* v,
                void* y, void* y_inter, int BH, int BHG, int S, int ds, int hd,
                int chunk, int qk_bf16, int v_bf16, int strict, void* stream) {
  if (BH <= 0 || BHG <= 0 || BH % BHG || S <= 0 || chunk <= 0 ||
      S % chunk || !dim_ok(ds) || !dim_ok(hd) || (strict != 0 && strict != 1))
    return (int)cudaErrorInvalidValue;
  int hs = hd < 64 ? hd : 64;   // the widest slice that fills one wave
  while (hs > 16 && (int64_t)BH * (hd / hs) < (int64_t)sm_count()) hs /= 2;
  const int rep = BH / BHG;
  cudaStream_t st = (cudaStream_t)stream;
  if (qk_bf16 && v_bf16)
    return launch_hs<__nv_bfloat16, __nv_bfloat16>(
        hs, ds, g, q, k, v, y, y_inter, BH, rep, S, hd, chunk, strict, st);
  if (qk_bf16)
    return launch_hs<__nv_bfloat16, float>(hs, ds, g, q, k, v, y, y_inter, BH,
                                           rep, S, hd, chunk, strict, st);
  if (v_bf16) return (int)cudaErrorInvalidValue;   // f32 q/k, bf16 v: unused
  return launch_hs<float, float>(hs, ds, g, q, k, v, y, y_inter, BH, rep, S,
                                 hd, chunk, strict, st);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
