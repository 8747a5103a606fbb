// Single-pass masked pop of the stacked delay-tolerant ring (layout v3).
//
// Replaces the Pallas TPU kernel variable_pop_fwd (_variable_pop_kernel_f32,
// _variable_pop_kernel_int8 and the _variable_meta epilogue) in
// src/repro/kernels/delay_ring/kernel.py:159 (pallas_call at :213, :224).
// With ring (S, P, rows, 128), f32 or int8 with per-row scales (S, P, rows),
// and mask (S,) the slots due this step:
//
//     popped[p,r,:] = sum over due j, ascending from 0.0f, of slot_j[p,r,:]
//                     (int8: q_j * s_j, dequantized in the same pass)
//     meta          = (count, stale_sum) = (sum_j m_j c_j, sum_j m_j c_j t_j)
//                     over counts_stale (2, S): c the pod-summed counts,
//                     t the staleness tags, in the same ascending order
//
// The pod fold stays the caller's (core.delayed.pod_sum), as on the TPU.
//
// The TPU kernel folds acc + m_j * slot_j over all S slots. Here only the
// due slots are read: on finite data that is the same sum bit for bit
// (m * x is exact for m in {0, 1}, and adding the zero of a dead slot
// leaves acc as it is), a non-finite value in a dead slot cannot leak into
// the result (as it cannot in the CPU path's gather), and the kernel moves
// H slots instead of all S.
//
// Bound on an H100 SXM: memory. Per element it reads H slots (4 bytes f32,
// 1 byte int8 plus 12 bytes of scales per 128-lane row and slot) and writes
// 4 bytes of popped; a handful of adds. At H = 1 that is 8 bytes (f32) or
// 5.1 bytes (int8) per element: 3.7 GB or 2.4 GB for an arena of 464 M
// parameters, 1.1 ms or 0.7 ms at 3.35 TB/s.
//
// Design: a simple grid-stride pass, the first version that is right. The
// mask is uniform across the grid: thread 0 of each block lists the due
// slots in shared memory once, so the loop over them never diverges. Each
// thread moves 4 lanes (a 16-byte load of f32, a 4-byte load of int8),
// 64-bit offsets. Rounding is pinned with __fadd_rn and, under int8,
// __fmul_rn for q * s, so acc + q * s is never contracted into an FMA. One
// thread of block 0 writes the (count, stale_sum) epilogue; nothing goes
// to the host.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlots = 256;

template <bool kInt8>
__global__ void __launch_bounds__(kThreads)
variable_pop_kernel(const void* __restrict__ ring,
                    const float* __restrict__ scales,
                    const uint8_t* __restrict__ mask,
                    const float* __restrict__ counts_stale,
                    float* __restrict__ popped, float* __restrict__ meta,
                    int n_slots, int64_t n_rows) {
  __shared__ int due[kMaxSlots];
  __shared__ int n_due;
  if (threadIdx.x == 0) {
    int h = 0;
    for (int j = 0; j < n_slots; ++j)
      if (mask[j]) due[h++] = j;
    n_due = h;
    if (meta != nullptr && blockIdx.x == 0) {
      float count = 0.0f, stale_sum = 0.0f;
      for (int j = 0; j < n_slots; ++j) {
        const float mc = __fmul_rn(mask[j] ? 1.0f : 0.0f, counts_stale[j]);
        count = __fadd_rn(count, mc);
        stale_sum = __fadd_rn(stale_sum,
                              __fmul_rn(mc, counts_stale[n_slots + j]));
      }
      meta[0] = count;
      meta[1] = stale_sum;
    }
  }
  __syncthreads();
  const int h = n_due;
  const int64_t n4 = n_rows * 32;            // 4-lane groups per slot
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int k = 0; k < h; ++k) {
      const int64_t j = due[k];
      float4 x;
      if constexpr (kInt8) {
        const char4 q = static_cast<const char4*>(ring)[j * n4 + i];
        const float s = scales[j * n_rows + (i >> 5)];
        x.x = __fmul_rn((float)q.x, s);
        x.y = __fmul_rn((float)q.y, s);
        x.z = __fmul_rn((float)q.z, s);
        x.w = __fmul_rn((float)q.w, s);
      } else {
        x = static_cast<const float4*>(ring)[j * n4 + i];
      }
      acc.x = __fadd_rn(acc.x, x.x);
      acc.y = __fadd_rn(acc.y, x.y);
      acc.z = __fadd_rn(acc.z, x.z);
      acc.w = __fadd_rn(acc.w, x.w);
    }
    reinterpret_cast<float4*>(popped)[i] = acc;
  }
}

int grid_for(int64_t n_threads) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const int64_t want = (n_threads + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * 8;   // 8 blocks x 256 threads per SM
  return (int)(want < cap ? (want > 0 ? want : 1) : cap);
}

}  // namespace

extern "C" {

// ring: (n_slots, P, rows, 128) f32 (scales null) or int8 (scales
// (n_slots, P, rows) f32), 16- or 4-byte aligned; mask: (n_slots,) bytes,
// 0 or 1; counts_stale: (2, n_slots) f32 or null; popped: (P, rows, 128)
// f32, 16-byte aligned; meta: (2,) f32, written when counts_stale is given.
// n_rows = P * rows. Returns the cudaError_t of the launch.
int variable_pop(const void* ring, const void* scales, const void* mask,
                 const void* counts_stale, void* popped, void* meta,
                 int n_slots, int64_t n_rows, void* stream) {
  if (n_slots < 1 || n_slots > kMaxSlots) return (int)cudaErrorInvalidValue;
  if (n_rows == 0 && counts_stale == nullptr) return 0;
  const int grid = grid_for(n_rows * 32);
  float* m = counts_stale == nullptr ? nullptr : (float*)meta;
  if (scales == nullptr) {
    variable_pop_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        ring, nullptr, (const uint8_t*)mask, (const float*)counts_stale,
        (float*)popped, m, n_slots, n_rows);
  } else {
    variable_pop_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        ring, (const float*)scales, (const uint8_t*)mask,
        (const float*)counts_stale, (float*)popped, m, n_slots, n_rows);
  }
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
