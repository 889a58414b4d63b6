// Flash-decode over a dense head-major KV cache.
//
// q (B, s, H, D) attends cache_k/cache_v (B, Hkv, L, D), in q's dtype or
// int8 with (B, Hkv, L) fp32 scales. The body is the shared warp-parallel
// decode in decode_core.cuh; position p of slot b, kv head hk, is row
// (b * Hkv + hk) * L + p, and an int8 row's scale sits at the same index
// of the scale arrays.
//
// Replaces the Pallas kernels `_dense_kernel` and `_dense_kernel_quant`
// (shellac_tpu/ops/decode_attention.py) over their tile body
// `_decode_tile`, launched by `_dense_flash`. Bound on the H100: bytes
// (see decode_core.cuh); the int8 cache streams 2 D + 8 bytes per
// position and kv head against 4 D in bf16. At shellac-1b's B = 8 and
// Hkv = 8 the grid is only 64 blocks on 132 SMs.
#include "decode_core.cuh"

namespace shellac {
namespace {

struct DenseRows {
  int L, Hkv;
  size_t base;  // row of position 0 of this block's (slot, kv head)

  __host__ __device__ int capacity() const { return L; }
  int extra_ints() const { return 0; }
  __device__ void stage(int b, int hk, int, int, int*, int) {
    base = ((size_t)b * Hkv + hk) * L;
  }
  __device__ size_t row(int pos) const { return base + pos; }
};

template <typename T, typename KT>
cudaError_t launch_dense(const void* q, const void* k, const void* v,
                         const void* ks, const void* vs, const void* index,
                         const void* sinks, void* out, int B, int s, int H,
                         int Hkv, int L, int D, float scale, int window,
                         float softcap, cudaStream_t stream) {
  const DenseRows addr{L, Hkv, 0};
  return decode::launch<T, KT>(q, k, v, ks, vs, index, sinks, out, B, s, H,
                               Hkv, D, scale, window, softcap, addr, stream);
}

}  // namespace
}  // namespace shellac

// window <= 0: none; softcap <= 0: none; sinks may be null.
extern "C" int shellac_decode_attention(const void* q, const void* k,
                                        const void* v, const void* index,
                                        const void* sinks, void* out, int B,
                                        int s, int H, int Hkv, int L, int D,
                                        float scale, int window,
                                        float softcap, int dtype,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == shellac::kF32)
    return shellac::launch_dense<float, float>(q, k, v, nullptr, nullptr,
                                               index, sinks, out, B, s, H,
                                               Hkv, L, D, scale, window,
                                               softcap, st);
  if (dtype == shellac::kBF16)
    return shellac::launch_dense<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, nullptr, nullptr, index, sinks, out, B, s, H, Hkv, L, D,
        scale, window, softcap, st);
  return (int)cudaErrorInvalidValue;
}

// int8 k/v (B, Hkv, L, D) with fp32 scales ks/vs (B, Hkv, L); dtype is
// q's (and the output's).
extern "C" int shellac_decode_attention_int8(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* index, const void* sinks, void* out, int B,
    int s, int H, int Hkv, int L, int D, float scale, int window,
    float softcap, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == shellac::kF32)
    return shellac::launch_dense<float, int8_t>(q, k, v, ks, vs, index,
                                                sinks, out, B, s, H, Hkv, L,
                                                D, scale, window, softcap,
                                                st);
  if (dtype == shellac::kBF16)
    return shellac::launch_dense<__nv_bfloat16, int8_t>(
        q, k, v, ks, vs, index, sinks, out, B, s, H, Hkv, L, D, scale,
        window, softcap, st);
  return (int)cudaErrorInvalidValue;
}
