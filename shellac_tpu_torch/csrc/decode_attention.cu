// Flash-decode over a dense head-major KV cache.
//
// q (B, s, H, D) attends cache_k/cache_v (B, Hkv, L, D). The body is the
// shared warp-parallel decode in decode_core.cuh; position p of slot b,
// kv head hk, is row (b * Hkv + hk) * L + p.
//
// Replaces the Pallas kernel `_dense_kernel` (shellac_tpu/ops/
// decode_attention.py) over its tile body `_decode_tile`, launched by
// `_dense_flash`. Bound on the H100: bytes (see decode_core.cuh). At
// shellac-1b's B = 8 and Hkv = 8 the grid is only 64 blocks on 132 SMs.
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

template <typename T>
cudaError_t launch_dense(const void* q, const void* k, const void* v,
                         const void* index, const void* sinks, void* out,
                         int B, int s, int H, int Hkv, int L, int D,
                         float scale, int window, float softcap,
                         cudaStream_t stream) {
  const DenseRows addr{L, Hkv, 0};
  return decode::launch<T>(q, k, v, index, sinks, out, B, s, H, Hkv, D,
                           scale, window, softcap, addr, stream);
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
    return shellac::launch_dense<float>(q, k, v, index, sinks, out, B, s, H,
                                        Hkv, L, D, scale, window, softcap,
                                        st);
  if (dtype == shellac::kBF16)
    return shellac::launch_dense<__nv_bfloat16>(q, k, v, index, sinks, out,
                                                B, s, H, Hkv, L, D, scale,
                                                window, softcap, st);
  return (int)cudaErrorInvalidValue;
}
