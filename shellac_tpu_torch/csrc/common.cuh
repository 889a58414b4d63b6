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

// Tensor-core helpers of the bf16 backward kernels (mma.sync m16n8k16).
// Fragments (lane = 4 * g + t4): A regs hold rows g, g + 8 and columns
// 2 t4 (+1), 2 t4 + 8 (+9); B regs hold rows 2 t4 (+1), 2 t4 + 8 (+9) of
// column g; C holds rows g, g + 8 and columns 2 t4, 2 t4 + 1.

// d += a (16x16, row-major) * b (16x8, column-major); bf16 in, fp32 out.
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two consecutive bf16 as one 32-bit fragment register.
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Round two floats to bf16 and pack them, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat16 l = __float2bfloat16(lo), h = __float2bfloat16(hi);
  return (uint32_t)(*reinterpret_cast<unsigned short*>(&l)) |
         ((uint32_t)(*reinterpret_cast<unsigned short*>(&h)) << 16);
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace shellac
