// RMSNorm forward: out = x * rsqrt(mean(x^2) + eps) * (1 + scale).
//
// Replaces the Pallas kernel `_rms_kernel` (shellac_tpu/ops/norms.py),
// launched by `_rms_forward`. Same arithmetic: fp32 sum of squares, fp32
// rsqrt, the (1 + scale) offset with the scale read as fp32 and added in
// fp32 before the multiply, output cast to x's dtype. Takes bf16 or fp32 x
// and any width d.
//
// Bound on the H100: bytes. It reads x once and writes out once (the
// scale vector is d floats, shared by every row), against a handful of
// flops per element.
//
// Design. Every width of whole 16-byte vectors (d a multiple of 8 in
// bf16, of 4 in fp32) up to 2048 vectors (16384 bf16 columns, 8192 fp32)
// takes `rms_norm_rows`, which holds a row in registers: each of TPR
// threads of a row issues all of its (at most VPT) 16-byte loads at
// once, reduces, scales and stores, so x is read from HBM exactly once
// and no loop with a run-time trip count sits between a load and its
// use. A width that is not a multiple of TPR vectors (GPT-OSS's 2880 is
// 360 bf16 vectors) leaves the last vectors of some threads out: a
// predicate on each vector, the loop still unrolled. The thread's share
// of (1 + scale) is loaded as 16-byte vectors once and kept in registers
// for every row the thread handles (a grid-stride loop over rows), and
// the thread loads its next row before it reduces and stores the current
// one. The host picks the instance from the row's vectors and the row
// count:
//   - many rows (prefill, training): the fewest threads a row with at
//     most 8 vectors a thread, from 16 (d <= 128 in bf16) through a warp
//     (up to 2048 bf16 columns) to 256, with as many CTAs as fit on the
//     card at once;
//   - few rows (decode's 8 or 16, any count that would leave SMs idle
//     at that many threads a row): one 256-thread CTA a row, 1, 2, 4 or
//     8 vectors a thread, and a two-level reduction (shuffles, then the
//     warps' sums through shared memory), so a row costs one load round
//     trip.
// Loads bypass L1 (`ld.global.nc.L1::no_allocate`) and stores stream
// (`st.global.cs`): the data is touched once. Unaligned pointers and
// widths that are not whole vectors take `rms_norm_kernel`, one warp a
// row with two passes over the row, which the second pass reads from L1.
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

// ------------------------------------------------- rows held in registers

constexpr int kRowsBlock = 256;

__device__ __forceinline__ uint4 load_once(const void* p) {
  uint4 u;
  asm volatile(
      "ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
      : "l"(p));
  return u;
}

__device__ __forceinline__ void store_once(void* p, uint4 u) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(u.x), "r"(u.y), "r"(u.z), "r"(u.w)
               : "memory");
}

// TPR threads a row (a power of two dividing kRowsBlock), at most VPT
// 16-byte vectors a thread: any d of whole vectors up to TPR * VPT * kN
// (kTail), or exactly that d (!kTail: no predicate, a constant stride).
// Vector v of thread t of a row holds columns [(v * TPR + t) * kN, +kN),
// so the row's threads read one contiguous 16 * TPR bytes per vector
// index; vectors past d are neither loaded nor stored.
template <typename T, int TPR, int VPT, bool kTail>
__global__ void __launch_bounds__(kRowsBlock)
rms_norm_rows(const T* __restrict__ x, const float* __restrict__ scale,
              T* __restrict__ out, int rows, int d_in, float eps) {
  constexpr int kN = 16 / sizeof(T);
  constexpr int kRowsPer = kRowsBlock / TPR;  // rows a block holds at once
  const int d = kTail ? d_in : TPR * VPT * kN;
  constexpr int kWarpsPerRow = TPR > 32 ? TPR / 32 : 1;
  static_assert(kRowsBlock % TPR == 0, "TPR divides the block");
  __shared__ float part[kRowsPer * kWarpsPerRow];

  const int t = threadIdx.x % TPR;
  const int slot = threadIdx.x / TPR;
  const int step = gridDim.x * kRowsPer;
  const int nv = d / kN;  // vectors a row
  auto in = [&](int v) { return !kTail || v * TPR + t < nv; };

  float w[VPT][kN];  // 1 + scale, fp32, this thread's columns
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const float4* s =
        reinterpret_cast<const float4*>(scale + (v * TPR + t) * kN);
#pragma unroll
    for (int q = 0; q < kN / 4; ++q) {
      const float4 f = in(v) ? s[q] : make_float4(0.f, 0.f, 0.f, 0.f);
      w[v][4 * q] = 1.f + f.x;
      w[v][4 * q + 1] = 1.f + f.y;
      w[v][4 * q + 2] = 1.f + f.z;
      w[v][4 * q + 3] = 1.f + f.w;
    }
  }

  auto load_row = [&](int row, uint4* u) {
    const T* xr = x + (size_t)row * d;
#pragma unroll
    for (int v = 0; v < VPT; ++v)
      u[v] = row < rows && in(v) ? load_once(xr + (v * TPR + t) * kN)
                                 : make_uint4(0, 0, 0, 0);
  };
  // The next row's loads are in flight while this one is reduced and
  // stored.
  uint4 u[VPT], next[VPT];
  load_row(blockIdx.x * kRowsPer + slot, next);

  for (int row0 = blockIdx.x * kRowsPer; row0 < rows; row0 += step) {
    const int row = row0 + slot;
#pragma unroll
    for (int v = 0; v < VPT; ++v) u[v] = next[v];
    load_row(row + step, next);

    float ss = 0.f;
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const T* e = reinterpret_cast<const T*>(&u[v]);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const float f = to_f32(e[j]);
        ss += f * f;
      }
      // Keep x packed until the scaled write converts it again (holding
      // the converted floats would take twice the registers in bf16).
      asm volatile("" : "+r"(u[v].x), "+r"(u[v].y), "+r"(u[v].z),
                   "+r"(u[v].w));
    }
    if constexpr (TPR <= 32) {
#pragma unroll
      for (int o = TPR / 2; o > 0; o >>= 1)
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
    } else {
      ss = warp_sum(ss);
      if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
      __syncthreads();
      ss = 0.f;
#pragma unroll
      for (int i = 0; i < kWarpsPerRow; ++i)
        ss += part[slot * kWarpsPerRow + i];
      __syncthreads();  // part is rewritten by the next row
    }
    const float inv = rsqrtf(ss / (float)d + eps);

    if (row < rows) {
      T* orow = out + (size_t)row * d;
#pragma unroll
      for (int v = 0; v < VPT; ++v) {
        const T* e = reinterpret_cast<const T*>(&u[v]);
        uint4 o;
        T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
        for (int j = 0; j < kN; ++j)
          oe[j] = from_f32<T>(to_f32(e[j]) * inv * w[v][j]);
        if (in(v)) store_once(orow + (v * TPR + t) * kN, o);
      }
    }
  }
}

// Launch rms_norm_rows<T, TPR, VPT, kTail> with as many blocks as the
// rows need, at most as many as fit on the card at once (the rest loop).
template <typename T, int TPR, int VPT, bool kTail>
cudaError_t launch_rows(const T* x, const float* scale, T* out, int rows,
                        int d, float eps, cudaStream_t stream) {
  auto kernel = rms_norm_rows<T, TPR, VPT, kTail>;
  static int resident = 0;  // blocks of this instance the card holds
  cudaError_t err;
  if (resident == 0) {
    int per_sm = 0, sms = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kRowsBlock, 0)) != cudaSuccess ||
        (err = sm_count(&sms)) != cudaSuccess)
      return err;
    resident = (per_sm > 0 ? per_sm : 1) * sms;
  }
  constexpr int kRowsPer = kRowsBlock / TPR;
  const int need = (rows + kRowsPer - 1) / kRowsPer;
  const int grid = need < resident ? need : resident;
  kernel<<<grid, kRowsBlock, 0, stream>>>(x, scale, out, rows, d, eps);
  return cudaGetLastError();
}

// The most 16-byte vectors a row the register-resident instances take.
constexpr int kMaxVectors = kRowsBlock * 8;

// Threads a row for many rows: the fewest with at most 8 vectors each
// (16 while a row has at most 16 vectors).
inline int many_tpr(int nv) {
  if (nv <= 16) return 16;
  if (nv <= 256) return 32;
  return nv <= 512 ? 64 : nv <= 1024 ? 128 : 256;
}

// The register-resident instances, in bf16 and fp32 alike (nv vectors a
// row): many rows <16, 1> (nv <= 16), <32, 1 | 2 | 4 | 8> (up to 32, 64,
// 128, 256), <64, 8>, <128, 8>, <256, 8> (up to 512, 1024, 2048); few
// rows, a CTA a row, <256, 1 | 2 | 4 | 8> (up to 256, 512, 1024, 2048).
// The six the main paths' d 2048 and 128 land on in bf16 or fp32 (<16,
// 1>, <32, 1>, <32, 8>, <64, 8>, <256, 1>, <256, 2>) also have an
// exact-fit twin without the tail's predicates, taken where d is their
// span: the predicated body measured 3-4% slower at 4096 and 12288 rows
// of 2048 on an H100. Returns false where the width or alignment has
// none.
template <typename T>
bool launch_held(const T* x, const float* scale, T* out, int rows, int d,
                 float eps, cudaStream_t stream, cudaError_t* err) {
  constexpr int kN = 16 / sizeof(T);
  if (((uintptr_t)x | (uintptr_t)out | (uintptr_t)scale) % 16 || d % kN)
    return false;
  const int nv = d / kN;
  if (nv == 0 || nv > kMaxVectors) return false;
  const int tpr = many_tpr(nv);
  int sms = 0;
  if ((*err = sm_count(&sms)) != cudaSuccess) return true;
  // A row wider than a warp's single vectors, at so few rows that the
  // many-rows instance would leave SMs without a block: a CTA a row.
  const bool few =
      nv > 32 && (rows + kRowsBlock / tpr - 1) / (kRowsBlock / tpr) < sms;
#define SHELLAC_RMS(TPR, VPT) \
  launch_rows<T, TPR, VPT, true>(x, scale, out, rows, d, eps, stream)
#define SHELLAC_RMS_EXACT(TPR, VPT)                                       \
  (nv == (TPR) * (VPT)                                                    \
       ? launch_rows<T, TPR, VPT, false>(x, scale, out, rows, d, eps,     \
                                         stream)                          \
       : SHELLAC_RMS(TPR, VPT))
  if (few)
    *err = nv <= 256   ? SHELLAC_RMS_EXACT(256, 1)
           : nv <= 512 ? SHELLAC_RMS_EXACT(256, 2)
           : nv <= 1024 ? SHELLAC_RMS(256, 4)
                        : SHELLAC_RMS(256, 8);
  else if (tpr == 16)
    *err = SHELLAC_RMS_EXACT(16, 1);
  else if (tpr == 32)
    *err = nv <= 32    ? SHELLAC_RMS_EXACT(32, 1)
           : nv <= 64  ? SHELLAC_RMS(32, 2)
           : nv <= 128 ? SHELLAC_RMS(32, 4)
                       : SHELLAC_RMS_EXACT(32, 8);
  else
    *err = tpr == 64    ? SHELLAC_RMS_EXACT(64, 8)
           : tpr == 128 ? SHELLAC_RMS(128, 8)
                        : SHELLAC_RMS(256, 8);
#undef SHELLAC_RMS_EXACT
#undef SHELLAC_RMS
  return true;
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, void* out, int rows,
                   int d, float eps, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const float* sp = static_cast<const float*>(scale);
  T* op = static_cast<T*>(out);
  cudaError_t err = cudaSuccess;
  if (launch_held<T>(xp, sp, op, rows, d, eps, stream, &err)) return err;
  constexpr int kN = 16 / sizeof(T);
  const bool vec = d % kN == 0 && ((uintptr_t)x % 16) == 0 &&
                   ((uintptr_t)out % 16) == 0;
  dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  dim3 block(32 * kWarpsPerBlock);
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
