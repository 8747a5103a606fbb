// int8 delay-ring slot rotate (ring layout v2) on the gradient arena.
//
// Replaces the Pallas TPU kernel delay_ring_slot_fwd (_slot_kernel_int8) in
// src/repro/kernels/delay_ring/kernel.py:77 (pallas_call at :100). Per pod
// p and arena row r, with s_old = scales_pop[p,r] and s = scale_new[p,r]:
//
//     popped[p,r,:]   = q_old * s_old                    (dequantize the pop)
//     q               = clip(round_half_even(fed / s), -127, 127)
//     slot_push[p,r,:] = (int8) q ;  scales_push[p,r] = s
//     fed[p,r,:]      = fed - q * s                      (error-feedback residual)
//
// The pop and push slots are different buffers under ring layout v2, so
// they never alias; the residual is written over fed in place.
//
// Bound on an H100 SXM: memory. Per element of each pod it reads q_old
// (1 B) and fed (4 B) and writes popped (4 B), q (1 B) and the residual
// (4 B): 14 bytes, plus 12 bytes of scales per 128-lane row, against about
// 7 flops. At 3.35 TB/s that is 0.14 us for the 256-row linreg arena (the
// launch sets the time there) and 2.0 ms per pod for an arena of 464 M
// parameters.
//
// Design: a simple grid-stride pass, the first version that is right. One
// warp takes one 128-lane row at a time (each thread 4 lanes: a 16-byte
// load of fed, a 4-byte load of q_old), loads the row's two scales once,
// and strides over the (P * rows) rows with 64-bit offsets. The arithmetic
// is pinned to the plain PyTorch version and the JAX reference: __fdiv_rn
// for fed / s, rintf (round half to even, as jnp.round and torch.round;
// roundf would round half away from zero), and __fmul_rn / __fsub_rn for
// the residual, which must not contract into an FMA (the JAX package pins
// it with an optimization_barrier, kernels/delay_ring/ref.py:52).
//
// The same file carries the v1 stacked-ring rotate, ring_rotate below.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float quantize(float f, float s) {
  const float x = rintf(__fdiv_rn(f, s));
  return x < -127.0f ? -127.0f : (x > 127.0f ? 127.0f : x);
}

__global__ void __launch_bounds__(kThreads)
slot_rotate_int8_kernel(const int8_t* __restrict__ slot_pop,
                        const float* __restrict__ scales_pop,
                        int8_t* __restrict__ slot_push,
                        float* __restrict__ scales_push,
                        float* __restrict__ fed,
                        const float* __restrict__ scale_new,
                        float* __restrict__ popped, int64_t n_rows) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t r = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       r < n_rows; r += n_warps) {
    const float s_old = scales_pop[r];
    const float s = scale_new[r];
    const int64_t e = r * 32 + lane;   // in units of 4 lanes
    const char4 qo = reinterpret_cast<const char4*>(slot_pop)[e];
    float4 p;
    p.x = __fmul_rn((float)qo.x, s_old);
    p.y = __fmul_rn((float)qo.y, s_old);
    p.z = __fmul_rn((float)qo.z, s_old);
    p.w = __fmul_rn((float)qo.w, s_old);
    reinterpret_cast<float4*>(popped)[e] = p;

    const float4 f = reinterpret_cast<const float4*>(fed)[e];
    const float qx = quantize(f.x, s), qy = quantize(f.y, s);
    const float qz = quantize(f.z, s), qw = quantize(f.w, s);
    reinterpret_cast<char4*>(slot_push)[e] =
        make_char4((signed char)qx, (signed char)qy, (signed char)qz,
                   (signed char)qw);
    float4 res;
    res.x = __fsub_rn(f.x, __fmul_rn(qx, s));
    res.y = __fsub_rn(f.y, __fmul_rn(qy, s));
    res.z = __fsub_rn(f.z, __fmul_rn(qz, s));
    res.w = __fsub_rn(f.w, __fmul_rn(qw, s));
    reinterpret_cast<float4*>(fed)[e] = res;
    if (lane == 0) scales_push[r] = s;
  }
}

// v1 stacked-ring rotate: pop ring[head], push into the same slot.
//
// Replaces the Pallas TPU kernel delay_ring_fwd (_ring_kernel_f32,
// _ring_kernel_int8) in src/repro/kernels/delay_ring/kernel.py:231
// (pallas_call at :251, :269). ring is (tau, P, rows, 128); head, a 0-dim
// int32 in device memory, picks the slot, so nothing goes to the host.
//
//     f32:   popped = ring[head] ;  ring[head] = g
//     int8:  popped = q_old * s_old ; ring[head] = q ; scales[head] = s ;
//            fed = fed - q * s     (q, s as in slot_rotate_int8 above)
//
// Every element is read before the same thread writes it, so popping and
// pushing one slot in place is safe; under int8 a warp's lanes all read
// the row's old scale before lane 0 overwrites it (__syncwarp).
//
// Bound on an H100 SXM: memory. f32 reads the slot and g and writes popped
// and the slot, 16 bytes per element; int8 moves the 14 bytes per element
// of slot_rotate_int8 (plus 12 bytes of scales per row). Design: the same
// grid-stride pass as slot_rotate_int8, one warp per 128-lane row, with the
// same pinned rounding (rintf, __fdiv_rn, __fmul_rn, __fsub_rn).
__device__ __forceinline__ int64_t read_head(const int32_t* head, int tau) {
  __shared__ int32_t h;
  if (threadIdx.x == 0) h = *head;
  __syncthreads();
  if (h < 0 || h >= tau) __trap();   // the ring's head is always in range
  return h;
}

__global__ void __launch_bounds__(kThreads)
ring_rotate_f32_kernel(float* __restrict__ ring, const float* __restrict__ g,
                       const int32_t* __restrict__ head,
                       float* __restrict__ popped, int tau, int64_t n_rows) {
  const int64_t n4 = n_rows * 32;
  float4* slot = reinterpret_cast<float4*>(ring) + read_head(head, tau) * n4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 old = slot[i];
    reinterpret_cast<float4*>(popped)[i] = old;
    slot[i] = reinterpret_cast<const float4*>(g)[i];
  }
}

__global__ void __launch_bounds__(kThreads)
ring_rotate_int8_kernel(int8_t* __restrict__ ring, float* __restrict__ scales,
                        float* __restrict__ fed,
                        const float* __restrict__ scale_new,
                        const int32_t* __restrict__ head,
                        float* __restrict__ popped, int tau, int64_t n_rows) {
  const int64_t h = read_head(head, tau);
  char4* slot = reinterpret_cast<char4*>(ring) + h * n_rows * 32;
  float* slot_scales = scales + h * n_rows;
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t r = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       r < n_rows; r += n_warps) {
    const float s_old = slot_scales[r];
    const float s = scale_new[r];
    const int64_t e = r * 32 + lane;   // in units of 4 lanes
    const char4 qo = slot[e];
    float4 p;
    p.x = __fmul_rn((float)qo.x, s_old);
    p.y = __fmul_rn((float)qo.y, s_old);
    p.z = __fmul_rn((float)qo.z, s_old);
    p.w = __fmul_rn((float)qo.w, s_old);
    reinterpret_cast<float4*>(popped)[e] = p;

    const float4 f = reinterpret_cast<const float4*>(fed)[e];
    const float qx = quantize(f.x, s), qy = quantize(f.y, s);
    const float qz = quantize(f.z, s), qw = quantize(f.w, s);
    slot[e] = make_char4((signed char)qx, (signed char)qy, (signed char)qz,
                         (signed char)qw);
    float4 res;
    res.x = __fsub_rn(f.x, __fmul_rn(qx, s));
    res.y = __fsub_rn(f.y, __fmul_rn(qy, s));
    res.z = __fsub_rn(f.z, __fmul_rn(qz, s));
    res.w = __fsub_rn(f.w, __fmul_rn(qw, s));
    reinterpret_cast<float4*>(fed)[e] = res;
    __syncwarp();
    if (lane == 0) slot_scales[r] = s;
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

// slot_pop, slot_push: (P, rows, 128) int8, 4-byte aligned; scales_pop,
// scales_push, scale_new: (P, rows) f32; fed, popped: (P, rows, 128) f32,
// 16-byte aligned. slot_push, scales_push and fed are written in place,
// popped is written. Returns the cudaError_t of the launch.
int slot_rotate_int8(const void* slot_pop, const void* scales_pop,
                     void* slot_push, void* scales_push, void* fed,
                     const void* scale_new, void* popped, int64_t n_rows,
                     void* stream) {
  if (n_rows == 0) return 0;
  slot_rotate_int8_kernel<<<grid_for(n_rows * 32), kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const int8_t*)slot_pop, (const float*)scales_pop, (int8_t*)slot_push,
      (float*)scales_push, (float*)fed, (const float*)scale_new,
      (float*)popped, n_rows);
  return (int)cudaGetLastError();
}

// v1: ring: (tau, P, rows, 128) f32 (scales and scale_new null; g is the
// pushed gradient) or int8 (scales (tau, P, rows) f32; g is fed, 16-byte
// aligned, and receives the residual); scale_new: (P, rows) f32; head: ()
// int32 in device memory; popped: (P, rows, 128) f32. n_rows = P * rows.
// Returns the cudaError_t of the launch.
int ring_rotate(void* ring, void* scales, void* g, const void* scale_new,
                const void* head, void* popped, int tau, int64_t n_rows,
                void* stream) {
  if (n_rows == 0) return 0;
  if (scales == nullptr) {
    ring_rotate_f32_kernel<<<grid_for(n_rows * 32), kThreads, 0,
                             (cudaStream_t)stream>>>(
        (float*)ring, (const float*)g, (const int32_t*)head, (float*)popped,
        tau, n_rows);
  } else {
    ring_rotate_int8_kernel<<<grid_for(n_rows * 32), kThreads, 0,
                              (cudaStream_t)stream>>>(
        (int8_t*)ring, (float*)scales, (float*)g, (const float*)scale_new,
        (const int32_t*)head, (float*)popped, tau, n_rows);
  }
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
