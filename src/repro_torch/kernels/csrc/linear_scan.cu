// Chunked linear scan (the SSD / gated-linear-attention recurrence of Mamba2),
// chunk-parallel, with its products on the tensor cores.
//
// Replaces the Pallas TPU kernel
//   linear_scan_fwd (_scan_kernel)   src/repro/kernels/linear_scan/kernel.py:68
//                                    (pallas_call at :83)
//
// Per head bh it computes, with an f32 (ds x hd) state,
//
//     h_t = exp(g_t) h_{t-1} + k_t v_t^T ;   y_t = q_t^T h_t
//
// in chunk-parallel form (the SSD split). With L the chunk, cum the running
// sum of g from the chunk's start, seg = cum_{L-1} and h_in[c] the state
// entering chunk c:
//
//   1. linear_scan_state, per (head, chunk c < nc - 1, hd slice), in parallel:
//        S_c = sum_j (k_j exp(seg - cum_j)) v_j^T ;  dec_c = exp(seg)
//   2. linear_scan_pass, per state element, sequential over the chunks:
//        h_in[0] = 0 ;  h_in[c] = dec_{c-1} h_in[c-1] + S_{c-1}   (f32)
//      in place: the scratch that held S_{c-1} then holds h_in[c];
//   3. linear_scan_out, per (head, chunk, 64-query tile, hd slice):
//        y_i = exp(cum_i) q_i^T h_in[c]
//              + sum_{j <= i} exp(cum_i - cum_j) (q_i . k_j) v_j
//
// With strict = 1 the sum runs over j < i: y_t = q_t^T (h_t - k_t v_t^T),
// the form the backward's dq and dk calls take (the diagonal is added back
// outside, so that dg is not a difference of two sums that the diagonal
// dominates). Given y_inter, stage 3 also writes the first term alone,
// exp(cum_i) q_i^T h_in (f32): the backward assembles dg chunk by chunk
// from it (kernels/linear_scan/ops.py).
//
// cum is summed in f64 and each exponent (cum_i - cum_j, seg - cum_j) is
// taken in f64 before it is rounded to f32 for expf. Within a chunk |cum|
// reaches L |g| (hundreds at zamba2's decays), where an f32 cum would carry
// an absolute error of its ulp (1e-5..1e-4) into every exponent: a relative
// error of that size in every term, which the backward's dg, a difference
// of sums formed by two calls with differently rounded exponents, turns
// into errors far above f32 rounding in the decay-rate gradient (PERF.md).
// Stages 1 and 3 form cum with the same code, so they agree bit for bit.
// The mask comes before the exp: cum_i - cum_j > 0 above the diagonal and
// may overflow.
//
// Layout as in JAX: g (BH, S) f32; q, k (BHG, S, ds), shared by the
// rep = BH / BHG heads of a group (head bh reads row bh / rep, the JAX index
// map at kernel.py:79-80); v (BH, S, hd); y (BH, S, hd) in v's type. q and k
// are f32 or bf16, v f32 or bf16 (the Mamba2 mapping feeds bf16 q, k and an
// f32 v = x * dt; the backward's three forms are all f32). ds and hd each
// take 16, 32, 64 or 128; any chunk that divides S (ragged tiles masked).
// Scratch from the caller: states (BH, nc - 1, ds, hd) f32, decay
// (BH, nc - 1) f32 (unused when nc = 1: stage 3 alone runs).
//
// Products: mma.sync on the tensor cores (HMMA), on 32-key tiles that
// cp.async brings into shared memory two stages deep, so the next tile
// loads while this one is multiplied. A TF32 operand keeps 11 bits; y is
// held to one ulp of its dtype plus 3e-6 of its largest element, so an f32
// operand x is split hi = x rounded to TF32, lo = x - hi (read to 11 bits)
// and each product is three m16n8k8 TF32 products: lo*hi + hi*lo + hi*hi
// (3xTF32, about 2^-22 relative; tests/test_torch_linear_scan.py models
// it: plain TF32 reads over 100x the limit, a two-term bf16 split 2-5x,
// 3xTF32 0.08-0.13). A bf16 operand is exact in TF32 and is not split,
// and bf16 scores q k^T (the forward's) are one m16n8k16 bf16 product.
// The tensor cores truncate as they accumulate: the P v products of a
// key tile, and the chunk state's, go into a zeroed partial that is added
// to the running sum in f32, rounded to nearest, once a tile; the scores
// and the inter-chunk term (sums over ds) accumulate in place.
//
// The P v product takes the scores straight from the registers that hold
// them: an accumulator fragment (row g, columns 2t and 2t + 1 of an 8-key
// slice) serves as the A fragment (columns t and t + 4) once the slice's
// keys are taken in the order 0, 2, 4, 6, 1, 3, 5, 7, and v's rows are read
// in that order too. Key slices past a warp's last row are skipped whole,
// and only tiles that cross the diagonal (or the chunk's end) evaluate the
// mask element by element.
//
// What bounds it on an H100: at zamba2's main shape (BH 160, S 4096, L 256,
// ds = hd = 64) the least time is the bytes, 0.10 ms at 3.35 TB/s, against
// about 0.14 ms of TF32 products with the split's extra terms at
// 495 TFLOP/s. mma.sync, the splits, the f64 exponents and exps, and the
// re-reads of a chunk's key tiles by each of its query tiles keep these
// kernels several times above it (PERF.md has the times and what each
// part costs). No atomics: every output element is written once after a
// fixed-order loop, so two runs give the same bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQT = 64;           // query rows per stage-3 block
constexpr int kKT = 32;           // keys per tile (stages 1 and 3)
constexpr int kOutThreads = 128;  // stage 3: 4 warps of 16 query rows
constexpr int kStateStages = 2;   // key tiles in flight, stage 1
constexpr int kOutStages = 2;     // key tiles in flight, stage 3
constexpr int kPassThreads = 256;

template <typename T> struct Exact { static constexpr bool value = false; };
template <> struct Exact<__nv_bfloat16> { static constexpr bool value = true; };

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// x as TF32 hi + lo; a bf16 value (EXACT) is its own hi. hi is x rounded
// as cvt.rna.tf32.f32 rounds (to nearest, ties away from zero), on the
// bits: two integer instructions where the conversion compiles to five
// (its guard for non-finite x). lo = x - hi exactly; the TF32 products
// read only its leading 11 bits, so it is not rounded. A non-finite x
// keeps lo non-finite (hi of a NaN may not be), so it reaches y.
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (EXACT) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
    lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
  }
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B, 16 x 8 x 16 in bf16 (exact products, f32 accumulation)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B for one k-step (16 x 8 x 8) from the split operands, the small
// products first
template <bool EA, bool EB>
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          uint32_t bh0, uint32_t bh1,
                                          uint32_t bl0, uint32_t bl1) {
  if (!EA) mma(d, al, bh0, bh1);
  if (!EB) mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

// acc += part, rounded to nearest; part = 0 (a tile's sums are promoted
// out of the tensor cores' truncating accumulation)
template <int M>
__device__ __forceinline__ void promote(float (&acc)[M][4],
                                        float (&part)[M][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[m][e] = __fadd_rn(acc[m][e], part[m][e]);
      part[m][e] = 0.f;
    }
}

template <int M>
__device__ __forceinline__ void zero(float (&x)[M][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[m][e] = 0.f;
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [0, rows) of a (row stride gld) global matrix, cols elements each,
// into shared memory (row stride sld) by cp.async; rows >= valid are
// zero-filled (row 0 must exist)
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int sld, const T* src,
                                          int64_t gld, int rows, int cols,
                                          int valid, int tid, int nthreads) {
  constexpr int V = 16 / (int)sizeof(T);
  const int per_row = cols / V;
  for (int idx = tid; idx < rows * per_row; idx += nthreads) {
    const int r = idx / per_row, c = (idx - r * per_row) * V;
    const bool ok = r < valid;
    cp16(dst + r * sld + c, ok ? src + r * gld + c : src, ok);
  }
}

// cum[t] = g[0] + ... + g[t] over the chunk, in f64: warp 0, each lane a
// run of steps, then a shuffle scan of the runs. Every stage forms it with
// this code. Ends with a barrier.
__device__ void chunk_cumsum(double* cum, const float* gc, int L, int tid,
                             int nthreads) {
  for (int t = tid; t < L; t += nthreads) cum[t] = gc[t];
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
}

// -- stage 1: the chunk's own state -------------------------------------------
template <int DS>
__host__ __device__ constexpr int state_kld() {   // conflict-free A reads
  return DS + 8;
}
template <int HS>
__host__ __device__ constexpr int state_vld() {   // conflict-free B reads
  return HS + 8;
}

template <typename TK, typename TV, int DS, int HS>
size_t state_smem(int L) {
  return kStateStages * kKT * (state_kld<DS>() * sizeof(TK) +
                               state_vld<HS>() * sizeof(TV)) +
         (size_t)L * (sizeof(double) + sizeof(float));
}

// grid (hd / HS, nc - 1, BH); DS / 16 warps, each 16 state rows by HS
// columns. states (BH, nc - 1, DS, hd) gets S_c, decay (BH, nc - 1) dec_c.
template <typename TK, typename TV, int DS, int HS>
__global__ void __launch_bounds__(2 * DS)
linear_scan_state(const float* __restrict__ g, const TK* __restrict__ k,
                  const TV* __restrict__ v, float* __restrict__ states,
                  float* __restrict__ decay, int S, int hd, int rep, int L) {
  constexpr int NT = 2 * DS, ST = kStateStages;
  constexpr int KLD = state_kld<DS>(), VLD = state_vld<HS>();
  constexpr bool EV = Exact<TV>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  TK* ks = reinterpret_cast<TK*>(smem);
  TV* vs = reinterpret_cast<TV*>(smem + ST * kKT * KLD * sizeof(TK));
  double* cum = reinterpret_cast<double*>(
      smem + ST * kKT * (KLD * sizeof(TK) + VLD * sizeof(TV)));
  float* w = reinterpret_cast<float*>(cum + L);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int col0 = blockIdx.x * HS;
  const int c = blockIdx.y, n_states = gridDim.y;
  const int64_t bh = blockIdx.z;
  const int64_t c0 = (int64_t)c * L;
  const TK* kc = k + ((bh / rep) * S + c0) * DS;
  const TV* vc = v + (bh * S + c0) * hd + col0;
  const int nt = (L + kKT - 1) / kKT;

  auto load_tile = [&](int t) {   // key tile t into stage t % ST
    const int j = t * kKT;
    load_rows(ks + (t % ST) * kKT * KLD, KLD, kc + (int64_t)j * DS, DS, kKT,
              DS, L - j, tid, NT);
    load_rows(vs + (t % ST) * kKT * VLD, VLD, vc + (int64_t)j * hd, hd, kKT,
              HS, L - j, tid, NT);
  };
  // the first ST - 1 tiles load while cum forms; one commit group a tile
  for (int t = 0; t < ST - 1; ++t) {
    if (t < nt) load_tile(t);
    cp_commit();
  }
  chunk_cumsum(cum, g + bh * S + c0, L, tid, NT);
  const double seg = cum[L - 1];
  for (int j = tid; j < L; j += NT) w[j] = expf((float)(seg - cum[j]));

  float acc[HS / 8][4], part[HS / 8][4];
  zero(acc);
  zero(part);
  const int d0 = warp * 16;
  for (int it = 0; it < nt; ++it) {
    if (it + ST - 1 < nt) load_tile(it + ST - 1);
    cp_commit();
    cp_wait<ST - 1>();
    __syncthreads();   // tile it (and, the first time, w) is in
    const TK* kt = ks + (it % ST) * kKT * KLD;
    const TV* vt = vs + (it % ST) * kKT * VLD;
    const int j0 = it * kKT;
#pragma unroll 2
    for (int kk = 0; kk < kKT; kk += 8) {
      // A = (k w)^T: rows d0 + gq (+ 8), columns keys kk + tq (+ 4)
      const int ja = kk + tq, jb = ja + 4;
      const float wa = j0 + ja < L ? w[j0 + ja] : 0.f;
      const float wb = j0 + jb < L ? w[j0 + jb] : 0.f;
      const float a[4] = {__fmul_rn(ld(kt + ja * KLD + d0 + gq), wa),
                          __fmul_rn(ld(kt + ja * KLD + d0 + gq + 8), wa),
                          __fmul_rn(ld(kt + jb * KLD + d0 + gq), wb),
                          __fmul_rn(ld(kt + jb * KLD + d0 + gq + 8), wb)};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split<false>(a[e], ah[e], al[e]);
#pragma unroll
      for (int m = 0; m < HS / 8; ++m) {
        uint32_t bh0, bh1, bl0, bl1;
        split<EV>(ld(vt + ja * VLD + 8 * m + gq), bh0, bl0);
        split<EV>(ld(vt + jb * VLD + 8 * m + gq), bh1, bl1);
        mma_split<false, EV>(part[m], ah, al, bh0, bh1, bl0, bl1);
      }
    }
    promote(acc, part);
    __syncthreads();   // the stage is free for the load issued next
  }
  float* out = states + ((bh * n_states + c) * DS + d0 + gq) * hd + col0;
#pragma unroll
  for (int m = 0; m < HS / 8; ++m) {
    st2(out + 8 * m + 2 * tq, acc[m][0], acc[m][1]);
    st2(out + 8 * hd + 8 * m + 2 * tq, acc[m][2], acc[m][3]);
  }
  if (blockIdx.x == 0 && tid == 0)
    decay[bh * n_states + c] = expf((float)seg);
}

// -- stage 2: the states entering the chunks ----------------------------------
// states (BH, n, per_head): S_0..S_{n-1} in, h_in[1]..h_in[n] out
__global__ void __launch_bounds__(kPassThreads)
linear_scan_pass(float* __restrict__ states, const float* __restrict__ decay,
                 int64_t per_head, int n, int64_t total) {
  const int64_t e = blockIdx.x * (int64_t)kPassThreads + threadIdx.x;
  if (e >= total) return;
  const int64_t bh = e / per_head;
  float* s = states + bh * n * per_head + (e - bh * per_head);
  const float* dc = decay + bh * n;
  float h = 0.f;
#pragma unroll 4
  for (int c = 0; c < n; ++c) {
    h = __fadd_rn(__fmul_rn(dc[c], h), s[(int64_t)c * per_head]);
    s[(int64_t)c * per_head] = h;
  }
}

// -- stage 3: the outputs -----------------------------------------------------
template <typename T, int D>
__host__ __device__ constexpr int out_ld() {
  // conflict-free fragment reads; rows of whole 16-byte chunks
  return D + (Exact<T>::value ? 8 : 4);
}

template <typename TQK, typename TV, int DS, int HS>
size_t out_smem(int L) {
  return (kQT + kOutStages * kKT) * out_ld<TQK, DS>() * sizeof(TQK) +
         kOutStages * kKT * out_ld<TV, HS>() * sizeof(TV) +
         (size_t)DS * (HS + 8) * sizeof(float) + (size_t)L * sizeof(double);
}

// grid (nqt * hd / HS, nc, BH); 4 warps, each 16 query rows by HS columns.
// hin: the pass's output (h_in[c] at index c - 1).
template <typename TQK, typename TV, int DS, int HS>
__global__ void __launch_bounds__(kOutThreads)
linear_scan_out(const float* __restrict__ g, const TQK* __restrict__ q,
                const TQK* __restrict__ k, const TV* __restrict__ v,
                const float* __restrict__ hin, TV* __restrict__ y,
                float* __restrict__ y_inter, int S, int hd, int rep, int L,
                int strict, int nqt) {
  constexpr int NT = kOutThreads, NK = kKT / 8, ST = kOutStages;
  constexpr int QLD = out_ld<TQK, DS>(), VLD = out_ld<TV, HS>();
  constexpr int HLD = HS + 8;
  constexpr bool EQK = Exact<TQK>::value, EV = Exact<TV>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  TQK* qs = reinterpret_cast<TQK*>(smem);
  TQK* ks = qs + kQT * QLD;
  TV* vs = reinterpret_cast<TV*>(ks + ST * kKT * QLD);
  float* hs = reinterpret_cast<float*>(vs + ST * kKT * VLD);
  double* cum = reinterpret_cast<double*>(hs + DS * HLD);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int nslice = hd / HS;
  const int qt = nqt - 1 - (int)blockIdx.x / nslice;   // longest rows first
  const int col0 = ((int)blockIdx.x % nslice) * HS;
  const int c = blockIdx.y;
  const int64_t bh = blockIdx.z;
  const int64_t c0 = (int64_t)c * L;
  const int64_t grp = bh / rep;
  const TQK* qc = q + (grp * S + c0) * DS;
  const TQK* kc = k + (grp * S + c0) * DS;
  const TV* vc = v + (bh * S + c0) * hd + col0;
  const int i0 = qt * kQT;
  const int nkt = (min(i0 + kQT, L) + kKT - 1) / kKT;   // key tiles

  load_rows(qs, QLD, qc + (int64_t)i0 * DS, DS, kQT, DS, L - i0, tid, NT);
  if (c > 0)
    load_rows(hs, HLD,
              hin + ((bh * (S / L - 1) + c - 1) * DS) * (int64_t)hd + col0,
              hd, DS, HS, DS, tid, NT);
  auto load_tile = [&](int t) {   // key tile t into stage t % ST
    const int j = t * kKT;
    load_rows(ks + (t % ST) * kKT * QLD, QLD, kc + (int64_t)j * DS, DS, kKT,
              DS, L - j, tid, NT);
    load_rows(vs + (t % ST) * kKT * VLD, VLD, vc + (int64_t)j * hd, hd, kKT,
              HS, L - j, tid, NT);
  };
  // q, h_in and the first ST - 1 key tiles load while cum forms
  for (int t = 0; t < ST - 1; ++t) {
    if (t < nkt) load_tile(t);
    cp_commit();
  }
  chunk_cumsum(cum, g + bh * S + c0, L, tid, NT);

  const int r0 = warp * 16;               // the warp's rows in the tile
  const int ia = i0 + r0 + gq, ib = ia + 8;
  const double cia = ia < L ? cum[ia] : 0.0, cib = ib < L ? cum[ib] : 0.0;
  float acc[HS / 8][4], part[HS / 8][4];
  zero(acc);
  zero(part);

  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + ST - 1 < nkt) load_tile(kt + ST - 1);
    cp_commit();
    cp_wait<ST - 1>();
    __syncthreads();
    if (kt == 0) {
      // the inter-chunk term: exp(cum_i) (q_i . h_in)
      if (c > 0) {
#pragma unroll 2
        for (int kk = 0; kk < DS; kk += 8) {
          const float a[4] = {ld(qs + (r0 + gq) * QLD + kk + tq),
                              ld(qs + (r0 + gq + 8) * QLD + kk + tq),
                              ld(qs + (r0 + gq) * QLD + kk + tq + 4),
                              ld(qs + (r0 + gq + 8) * QLD + kk + tq + 4)};
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split<EQK>(a[e], ah[e], al[e]);
#pragma unroll
          for (int m = 0; m < HS / 8; ++m) {
            uint32_t bh0, bh1, bl0, bl1;
            split<false>(hs[(kk + tq) * HLD + 8 * m + gq], bh0, bl0);
            split<false>(hs[(kk + tq + 4) * HLD + 8 * m + gq], bh1, bl1);
            mma_split<EQK, false>(acc[m], ah, al, bh0, bh1, bl0, bl1);
          }
        }
        const float ea = ia < L ? expf((float)cia) : 0.f;
        const float eb = ib < L ? expf((float)cib) : 0.f;
#pragma unroll
        for (int m = 0; m < HS / 8; ++m) {
          acc[m][0] = __fmul_rn(acc[m][0], ea);
          acc[m][1] = __fmul_rn(acc[m][1], ea);
          acc[m][2] = __fmul_rn(acc[m][2], eb);
          acc[m][3] = __fmul_rn(acc[m][3], eb);
        }
      }
      if (y_inter != nullptr) {
        float* yi = y_inter + (bh * S + c0) * hd + col0 + 2 * tq;
#pragma unroll
        for (int m = 0; m < HS / 8; ++m) {
          if (ia < L) st2(yi + (int64_t)ia * hd + 8 * m, acc[m][0], acc[m][1]);
          if (ib < L) st2(yi + (int64_t)ib * hd + 8 * m, acc[m][2], acc[m][3]);
        }
      }
    }
    const int j0 = kt * kKT;
    // key slices past the warp's last row are masked whole: skipped
    const int n_end = min(NK, (i0 + r0 + 16 - j0) / 8);
    if (n_end > 0) {
      const TQK* kts = ks + (kt % ST) * kKT * QLD;
      const TV* vts = vs + (kt % ST) * kKT * VLD;
      // scores q_i . k_j: the warp's 16 rows by the tile's keys
      float s[NK][4];
      zero(s);
      if constexpr (EQK) {
        // bf16 q and k: one bf16 product (m16n8k16) a k-step, each pair of
        // neighbouring columns read as one 32-bit word
        const uint32_t* q2 = reinterpret_cast<const uint32_t*>(qs);
        const uint32_t* k2 = reinterpret_cast<const uint32_t*>(kts);
#pragma unroll 2
        for (int kk = 0; kk < DS; kk += 16) {
          const int c2 = kk / 2 + tq;
          const uint32_t a[4] = {q2[(r0 + gq) * (QLD / 2) + c2],
                                 q2[(r0 + gq + 8) * (QLD / 2) + c2],
                                 q2[(r0 + gq) * (QLD / 2) + c2 + 4],
                                 q2[(r0 + gq + 8) * (QLD / 2) + c2 + 4]};
#pragma unroll
          for (int n = 0; n < NK; ++n) {
            if (n < n_end)
              mma_bf16(s[n], a, k2[(8 * n + gq) * (QLD / 2) + c2],
                       k2[(8 * n + gq) * (QLD / 2) + c2 + 4]);
          }
        }
      } else {
        // f32 q and k: 3xTF32, the small products in sl, so that no chain
        // of dependent products runs longer than DS / 8
        float sl[NK][4];
        zero(sl);
#pragma unroll 2
        for (int kk = 0; kk < DS; kk += 8) {
          const float a[4] = {qs[(r0 + gq) * QLD + kk + tq],
                              qs[(r0 + gq + 8) * QLD + kk + tq],
                              qs[(r0 + gq) * QLD + kk + tq + 4],
                              qs[(r0 + gq + 8) * QLD + kk + tq + 4]};
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split<false>(a[e], ah[e], al[e]);
#pragma unroll
          for (int n = 0; n < NK; ++n) {
            if (n < n_end) {
              uint32_t bh0, bh1, bl0, bl1;
              split<false>(kts[(8 * n + gq) * QLD + kk + tq], bh0, bl0);
              split<false>(kts[(8 * n + gq) * QLD + kk + tq + 4], bh1, bl1);
              mma(sl[n], al, bh0, bh1);
              mma(sl[n], ah, bl0, bl1);
              mma(s[n], ah, bh0, bh1);
            }
          }
        }
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = __fadd_rn(s[n][e], sl[n][e]);
      }
      // mask, then decay: p_ij = exp(cum_i - cum_j) s_ij for j + strict <= i
      // (a tile wholly before the warp's rows needs no mask)
      if (j0 + kKT + strict <= i0 + r0 + 1 && i0 + r0 + 16 <= L) {
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const double ci = e < 2 ? cia : cib;
            const int j = j0 + 8 * n + 2 * tq + (e & 1);
            s[n][e] = __fmul_rn(s[n][e], expf((float)(ci - cum[j])));
          }
      } else {
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? ia : ib;
            const double ci = e < 2 ? cia : cib;
            const int j = j0 + 8 * n + 2 * tq + (e & 1);
            s[n][e] = (n < n_end && i < L && j + strict <= i)
                          ? __fmul_rn(s[n][e], expf((float)(ci - cum[j])))
                          : 0.f;
          }
      }
      // part += p v: slice n's keys, in the order 2t, 2t + 1, are a k-step
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        if (n < n_end) {
          const float a[4] = {s[n][0], s[n][2], s[n][1], s[n][3]};
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split<false>(a[e], ah[e], al[e]);
          const TV* v0 = vts + (8 * n + 2 * tq) * VLD + gq;
#pragma unroll
          for (int m = 0; m < HS / 8; ++m) {
            uint32_t bh0, bh1, bl0, bl1;
            split<EV>(ld(v0 + 8 * m), bh0, bl0);
            split<EV>(ld(v0 + VLD + 8 * m), bh1, bl1);
            mma_split<false, EV>(part[m], ah, al, bh0, bh1, bl0, bl1);
          }
        }
      }
      promote(acc, part);
    }
    __syncthreads();   // the stage is free for the load issued next
  }
  TV* yo = y + (bh * S + c0) * hd + col0 + 2 * tq;
#pragma unroll
  for (int m = 0; m < HS / 8; ++m) {
    if (ia < L) st2(yo + (int64_t)ia * hd + 8 * m, acc[m][0], acc[m][1]);
    if (ib < L) st2(yo + (int64_t)ib * hd + 8 * m, acc[m][2], acc[m][3]);
  }
}

// -- launch -------------------------------------------------------------------
template <typename Kern>
int allow_smem(Kern kern, size_t bytes, size_t& granted) {
  if (bytes > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    granted = bytes;
  }
  return 0;
}

struct Args {
  const void *g, *q, *k, *v;
  void *y, *y_inter, *states, *decay;
  int BH, rep, S, hd, L, strict;
  cudaStream_t stream;
};

template <typename TQK, typename TV, int DS, int HS>
int launch_typed(const Args& a) {
  const int nc = a.S / a.L;
  if (nc > 1) {
    auto state = linear_scan_state<TQK, TV, DS, HS>;
    static size_t granted_state = 48 * 1024;
    const size_t bytes = state_smem<TQK, TV, DS, HS>(a.L);
    int err = allow_smem(state, bytes, granted_state);
    if (err) return err;
    state<<<dim3(a.hd / HS, nc - 1, a.BH), 2 * DS, bytes, a.stream>>>(
        (const float*)a.g, (const TQK*)a.k, (const TV*)a.v,
        (float*)a.states, (float*)a.decay, a.S, a.hd, a.rep, a.L);
    err = (int)cudaGetLastError();
    if (err) return err;
    const int64_t per_head = (int64_t)DS * a.hd, total = per_head * a.BH;
    linear_scan_pass<<<(unsigned)((total + kPassThreads - 1) / kPassThreads),
                       kPassThreads, 0, a.stream>>>(
        (float*)a.states, (const float*)a.decay, per_head, nc - 1, total);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  auto out = linear_scan_out<TQK, TV, DS, HS>;
  static size_t granted_out = 48 * 1024;
  const size_t bytes = out_smem<TQK, TV, DS, HS>(a.L);
  const int err = allow_smem(out, bytes, granted_out);
  if (err) return err;
  const int nqt = (a.L + kQT - 1) / kQT;
  out<<<dim3(nqt * (a.hd / HS), nc, a.BH), kOutThreads, bytes, a.stream>>>(
      (const float*)a.g, (const TQK*)a.q, (const TQK*)a.k, (const TV*)a.v,
      (const float*)a.states, (TV*)a.y, (float*)a.y_inter, a.S, a.hd, a.rep,
      a.L, a.strict, nqt);
  return (int)cudaGetLastError();
}

template <typename TQK, typename TV, int HS>
int launch_ds(int ds, const Args& a) {
  switch (ds) {
    case 16: return launch_typed<TQK, TV, 16, HS>(a);
    case 32: return launch_typed<TQK, TV, 32, HS>(a);
    case 64: return launch_typed<TQK, TV, 64, HS>(a);
    case 128: return launch_typed<TQK, TV, 128, HS>(a);
  }
  return (int)cudaErrorInvalidValue;
}

// a block owns hs = min(hd, 64) of the hd columns
template <typename TQK, typename TV>
int launch_hs(int ds, const Args& a) {
  switch (a.hd < 64 ? a.hd : 64) {
    case 16: return launch_ds<TQK, TV, 16>(ds, a);
    case 32: return launch_ds<TQK, TV, 32>(ds, a);
    case 64: return launch_ds<TQK, TV, 64>(ds, a);
  }
  return (int)cudaErrorInvalidValue;
}

bool dim_ok(int n) { return n == 16 || n == 32 || n == 64 || n == 128; }

}  // namespace

extern "C" {

// g (BH, S) f32; q, k (BHG, S, ds); v, y (BH, S, hd); all contiguous and
// 16-byte aligned; y_inter: null, or (BH, S, hd) f32 for the inter-chunk
// term alone. states (BH, S / chunk - 1, ds, hd) and decay
// (BH, S / chunk - 1) f32: scratch (null when chunk = S). qk_bf16 / v_bf16:
// 1 for bf16, 0 for f32 (y has v's type). chunk divides S. strict: 1
// leaves each step's own term out of its output. Launches the three stages
// (one when chunk = S) on the stream; returns the first non-zero
// cudaError_t (0 on success).
int linear_scan(const void* g, const void* q, const void* k, const void* v,
                void* y, void* y_inter, void* states, void* decay, int BH,
                int BHG, int S, int ds, int hd, int chunk, int qk_bf16,
                int v_bf16, int strict, void* stream) {
  if (BH <= 0 || BHG <= 0 || BH % BHG || S <= 0 || chunk <= 0 ||
      S % chunk || !dim_ok(ds) || !dim_ok(hd) || (strict != 0 && strict != 1))
    return (int)cudaErrorInvalidValue;
  if (S / chunk > 1 && (states == nullptr || decay == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{g, q, k, v, y, y_inter, states, decay, BH, BH / BHG, S, hd,
               chunk, strict, (cudaStream_t)stream};
  if (qk_bf16 && v_bf16) return launch_hs<__nv_bfloat16, __nv_bfloat16>(ds, a);
  if (qk_bf16) return launch_hs<__nv_bfloat16, float>(ds, a);
  if (v_bf16) return (int)cudaErrorInvalidValue;   // f32 q/k, bf16 v: unused
  return launch_hs<float, float>(ds, a);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
