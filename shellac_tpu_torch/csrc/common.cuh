// Shared helpers for the port's CUDA kernels (Hopper, sm_90a).
//
// Every launcher has a plain C interface (bound with ctypes from
// ops/_build.py): device pointers and the stream arrive as void*, a dtype
// code picks the template instance, and the launcher returns the
// cudaError_t of the launch (0 on success) so the Python wrapper can raise.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace shellac {

// dtype codes, mirrored in ops/_build.py
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// Masked-logit sentinel of the JAX kernels: finite, so m - m stays 0 and
// an online-softmax step can gate fully-masked tiles on s > NEG_INF / 2.
constexpr float kNegInf = -2.0e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// Round an fp32 value through T (the JAX kernels cast p to v's dtype
// before the p.V product).
template <typename T>
__device__ __forceinline__ float round_through(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// The current device's SM count, read once per device.
inline cudaError_t sm_count(int* sms) {
  constexpr int kMaxDevices = 64;
  static int sms_of[kMaxDevices] = {};
  int dev;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms_of[dev] == 0 &&
      (err = cudaDeviceGetAttribute(&sms_of[dev],
                                    cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return err;
  *sms = sms_of[dev];
  return cudaSuccess;
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace shellac
