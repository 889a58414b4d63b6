// RMSNorm forward: out = x * rsqrt(mean(x^2) + eps) * (1 + scale).
//
// Replaces the Pallas kernel `_rms_kernel` (shellac_tpu/ops/norms.py),
// launched by `_rms_forward`. Same arithmetic: fp32 sum of squares, fp32
// rsqrt, the (1 + scale) offset with the scale read as fp32, output cast
// to x's dtype. Takes bf16 or fp32 x and any width d.
//
// Bound on the H100: bytes. It reads x once and writes out once (the
// scale vector is d floats, shared by every row through L1/L2), against
// a handful of flops per element. Design: one warp per row, four rows per
// 128-thread block, so the prefill's 4096 rows fill every SM and a
// decode's 8 rows still launch one small block. Loads are 16 bytes per
// lane when d allows it; the second pass re-reads the row, which at
// d = 2048 (4 KB in bf16) is still in L1.
#include "common.cuh"

namespace shellac {
namespace {

constexpr int kWarpsPerBlock = 4;

template <typename T, bool kVec>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
rms_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                T* __restrict__ out, int rows, int d, float eps) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * d;
  T* orow = out + (size_t)row * d;
  constexpr int kN = 16 / sizeof(T);  // elements per 16-byte load

  float ss = 0.f;
  if (kVec) {
    for (int i = lane * kN; i < d; i += 32 * kN) {
      uint4 u = *reinterpret_cast<const uint4*>(xr + i);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        float f = to_f32(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      float f = to_f32(xr[i]);
      ss += f * f;
    }
  }
  ss = warp_sum(ss);
  const float inv = rsqrtf(ss / (float)d + eps);

  if (kVec) {
    for (int i = lane * kN; i < d; i += 32 * kN) {
      uint4 u = *reinterpret_cast<const uint4*>(xr + i);
      const T* e = reinterpret_cast<const T*>(&u);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        float y = to_f32(e[j]) * inv;
        oe[j] = from_f32<T>(y * (1.f + scale[i + j]));
      }
      *reinterpret_cast<uint4*>(orow + i) = o;
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      float y = to_f32(xr[i]) * inv;
      orow[i] = from_f32<T>(y * (1.f + scale[i]));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, void* out, int rows,
                   int d, float eps, cudaStream_t stream) {
  constexpr int kN = 16 / sizeof(T);
  const bool vec = d % kN == 0 && ((uintptr_t)x % 16) == 0 &&
                   ((uintptr_t)out % 16) == 0;
  dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  dim3 block(32 * kWarpsPerBlock);
  const T* xp = static_cast<const T*>(x);
  const float* sp = static_cast<const float*>(scale);
  T* op = static_cast<T*>(out);
  if (vec) {
    rms_norm_kernel<T, true><<<grid, block, 0, stream>>>(xp, sp, op, rows, d,
                                                         eps);
  } else {
    rms_norm_kernel<T, false><<<grid, block, 0, stream>>>(xp, sp, op, rows,
                                                          d, eps);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace shellac

extern "C" int shellac_rms_norm(const void* x, const void* scale, void* out,
                                int rows, int d, float eps, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == shellac::kF32)
    return shellac::launch<float>(x, scale, out, rows, d, eps, s);
  if (dtype == shellac::kBF16)
    return shellac::launch<__nv_bfloat16>(x, scale, out, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}
