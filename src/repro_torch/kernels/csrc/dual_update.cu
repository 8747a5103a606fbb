// Fused dual-averaging updates on a (rows, 128) f32 arena.
//
// dual_update_fused replaces the Pallas TPU kernel dual_update_fused_fwd
// (_fused_kernel) in src/repro/kernels/dual_update/kernel.py:38
// (pallas_call at :51), the master's update on the gradient arena:
//
//     g = g_sum / denom ;  z <- z + g (in place) ;  w = -alpha * z
//
// dual_update replaces dual_update_fwd (_update_kernel) in the same file,
// :73 (pallas_call at :81), the legacy pytree update without the count
// normalization, reached only through the pytree wrapper
// (kernels/dual_update/ops.py dual_update):
//
//     z <- z + g (in place) ;  w = -alpha * z
//
// Bound on an H100 SXM: memory. Each element reads z and g (g_sum) and writes
// z and w, 16 bytes, against 3 flops; at 3.35 TB/s the least time is
// 16 B x elements / 3.35e12 (0.16 us for the 256-row linreg arena, 2.2 ms
// for an arena of 464 M parameters). At the linreg arena the launch, not
// the bytes, sets the time.
//
// Design: a simple grid-stride elementwise pass, the first version that is
// right. Each thread moves 4 lanes with one 16-byte load per operand, so a
// warp covers one 128-lane row; the grid is capped at a few blocks per SM
// and strides over the rest, with 64-bit offsets (an arena of more than
// 2^31 elements is in reach). alpha and denom are read from a 2-element
// device tensor: count is a device scalar, and taking it to the host would
// stall the card every step. The arithmetic is pinned to the plain PyTorch
// version (and the JAX reference) with round-to-nearest intrinsics, which
// the compiler never contracts into FMAs: __fdiv_rn, then __fadd_rn, then
// __fmul_rn (the unnormalized update: __fadd_rn, then __fmul_rn).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
dual_update_fused_kernel(float* __restrict__ z, const float* __restrict__ g_sum,
                         float* __restrict__ w, const float* __restrict__ scal,
                         int64_t n4) {
  const float a = scal[0];   // alpha
  const float d = scal[1];   // denom = max(count, 1e-12)
  const float na = -a;       // negation is exact: -a * z == -(a * z)
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 zz = reinterpret_cast<const float4*>(z)[i];
    const float4 gg = reinterpret_cast<const float4*>(g_sum)[i];
    zz.x = __fadd_rn(zz.x, __fdiv_rn(gg.x, d));
    zz.y = __fadd_rn(zz.y, __fdiv_rn(gg.y, d));
    zz.z = __fadd_rn(zz.z, __fdiv_rn(gg.z, d));
    zz.w = __fadd_rn(zz.w, __fdiv_rn(gg.w, d));
    float4 ww;
    ww.x = __fmul_rn(na, zz.x);
    ww.y = __fmul_rn(na, zz.y);
    ww.z = __fmul_rn(na, zz.z);
    ww.w = __fmul_rn(na, zz.w);
    reinterpret_cast<float4*>(z)[i] = zz;
    reinterpret_cast<float4*>(w)[i] = ww;
  }
}

__global__ void __launch_bounds__(kThreads)
dual_update_kernel(float* __restrict__ z, const float* __restrict__ g,
                   float* __restrict__ w, const float* __restrict__ alpha,
                   int64_t n4) {
  const float na = -alpha[0];   // negation is exact: -a * z == -(a * z)
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 zz = reinterpret_cast<const float4*>(z)[i];
    const float4 gg = reinterpret_cast<const float4*>(g)[i];
    zz.x = __fadd_rn(zz.x, gg.x);
    zz.y = __fadd_rn(zz.y, gg.y);
    zz.z = __fadd_rn(zz.z, gg.z);
    zz.w = __fadd_rn(zz.w, gg.w);
    float4 ww;
    ww.x = __fmul_rn(na, zz.x);
    ww.y = __fmul_rn(na, zz.y);
    ww.z = __fmul_rn(na, zz.z);
    ww.w = __fmul_rn(na, zz.w);
    reinterpret_cast<float4*>(z)[i] = zz;
    reinterpret_cast<float4*>(w)[i] = ww;
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

// z, g_sum, w: (rows, 128) f32, 16-byte aligned, z updated in place and w
// written; scal: 2 f32 on the device, {alpha, denom}. Returns the
// cudaError_t of the launch (0 on success).
int dual_update_fused(void* z, const void* g_sum, void* w, const void* scal,
                      int64_t rows, void* stream) {
  const int64_t n4 = rows * 32;   // float4s: 128 lanes / 4
  if (n4 == 0) return 0;
  dual_update_fused_kernel<<<grid_for(n4), kThreads, 0,
                             (cudaStream_t)stream>>>(
      (float*)z, (const float*)g_sum, (float*)w, (const float*)scal, n4);
  return (int)cudaGetLastError();
}

// z, g, w: (rows, 128) f32, 16-byte aligned, z updated in place and w
// written; alpha: 1 f32 on the device. Returns the cudaError_t of the
// launch (0 on success).
int dual_update(void* z, const void* g, void* w, const void* alpha,
                int64_t rows, void* stream) {
  const int64_t n4 = rows * 32;
  if (n4 == 0) return 0;
  dual_update_kernel<<<grid_for(n4), kThreads, 0, (cudaStream_t)stream>>>(
      (float*)z, (const float*)g, (float*)w, (const float*)alpha, n4);
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
