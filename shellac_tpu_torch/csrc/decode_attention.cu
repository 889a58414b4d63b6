// Flash-decode over a dense head-major KV cache.
//
// q (B, s, H, D) attends cache_k/cache_v (B, Hkv, L, D), in q's dtype or
// int8 with (B, Hkv, L) fp32 scales. Position p of slot b, kv head hk, is
// row (b * Hkv + hk) * L + p, and an int8 row's scale sits at the same
// index of the scale arrays.
//
// Replaces the Pallas kernels `_dense_kernel` and `_dense_kernel_quant`
// (shellac_tpu/ops/decode_attention.py) over their tile body
// `_decode_tile`, launched by `_dense_flash`. A bf16 q, which the main
// paths run, takes the split-K body of decode_split.cuh
// (`decode_split_kernel`, whose note gives the design) with DenseTiles
// below, over the bf16 cache (kernel 5) and over the int8 cache (kernel
// 6): a slot's kv-head range is contiguous, so a tile of k (or of v) is
// one 1-D bulk copy of n * D * sizeof(KT) bytes between 16-byte-aligned
// rows (a row is 64-256 bytes at D 64 and 128, and the wrapper refuses an
// unaligned cache), and an int8 tile's scales are per-lane loads at the
// same row indices. An fp32 q (the parity path) runs the warp-parallel
// body of decode_core.cuh with DenseRows, one 256-thread block per (slot,
// kv head). MLA's absorbed decode (D 576, every head's row against one
// latent row, one array as k and v) takes decode_wide.cuh with
// DenseTiles (its `row_of`): a bf16 q its tensor-core body over the bf16
// or int8 latent cache, an fp32 q its CUDA-core body over the fp32 or
// int8 one.
//
// Bound on the H100: bytes (2 * live * D * 2 bytes per slot and kv head
// in bf16, 2 * live * (D + 4) in int8), but at a decode step's sizes
// mostly latency: at shellac-1b's generate shape (B 8, Hkv 8, 128-576
// live positions) one block per (slot, kv head) is 64 blocks on 132
// SMs, each walking its range in serial chunks. The split body takes
// clusters of 4 or 8 there, so all its CTAs are resident together.
#include "decode_core.cuh"
#include "decode_split.cuh"
#include "decode_wide.cuh"

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

// Kernels 5 and 6's tiles policy for the split-K body (decode_split.cuh):
// a slot's kv-head range is contiguous, so a tile of k (or v) is one copy,
// and position p0 + lane's row (its int8 scale's index) is DenseRows's.
struct DenseTiles {
  int L, Hkv;
  size_t base;  // row of position 0 of this block's (slot, kv head)

  __host__ __device__ int capacity() const { return L; }
  __device__ void begin(int b, int hk) { base = ((size_t)b * Hkv + hk) * L; }
  __device__ void fetch(int, int, int) {}
  template <int D, typename KT>
  __device__ void issue(uint64_t* bar, KT* dst, const KT* src, int p0, int n,
                        int lane) const {
    if (lane == 0) {
      const uint32_t bytes = n * D * sizeof(KT);
      hopper::mbar_arrive_expect_tx(bar, bytes);
      hopper::bulk_load(dst, src + (base + p0) * D, bytes, bar);
    }
  }
  __device__ size_t lane_row(int p0, int lane) const {
    return base + p0 + lane;
  }
  // Any one lane: the row of position pos (the wide body's copies).
  __device__ size_t row_of(int pos) const { return base + pos; }
};

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
  const shellac::DenseTiles tiles{L, Hkv, 0};
  if (D == shellac::wide::kD && dtype == shellac::kF32)
    return shellac::wide::launch<float, float>(
        q, k, v, nullptr, nullptr, index, sinks, out, B, s, H, Hkv, D, scale,
        window, softcap, tiles, st);
  if (D == shellac::wide::kD && dtype == shellac::kBF16)
    return shellac::wide::launch<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, nullptr, nullptr, index, sinks, out, B, s, H, Hkv, D, scale,
        window, softcap, tiles, st);
  if (dtype == shellac::kF32)
    return shellac::launch_dense<float, float>(q, k, v, nullptr, nullptr,
                                               index, sinks, out, B, s, H,
                                               Hkv, L, D, scale, window,
                                               softcap, st);
  if (dtype == shellac::kBF16)
    return shellac::split::launch<__nv_bfloat16>(
        q, k, v, nullptr, nullptr, index, sinks, out, B, s, H, Hkv, D, scale,
        window, softcap, tiles, st);
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
  const shellac::DenseTiles tiles{L, Hkv, 0};
  if (D == shellac::wide::kD && dtype == shellac::kF32)
    return shellac::wide::launch<float, int8_t>(
        q, k, v, ks, vs, index, sinks, out, B, s, H, Hkv, D, scale, window,
        softcap, tiles, st);
  if (D == shellac::wide::kD && dtype == shellac::kBF16)
    return shellac::wide::launch<__nv_bfloat16, int8_t>(
        q, k, v, ks, vs, index, sinks, out, B, s, H, Hkv, D, scale, window,
        softcap, tiles, st);
  if (dtype == shellac::kF32)
    return shellac::launch_dense<float, int8_t>(q, k, v, ks, vs, index,
                                                sinks, out, B, s, H, Hkv, L,
                                                D, scale, window, softcap,
                                                st);
  if (dtype == shellac::kBF16)
    return shellac::split::launch<int8_t>(
        q, k, v, ks, vs, index, sinks, out, B, s, H, Hkv, D, scale, window,
        softcap, tiles, st);
  return (int)cudaErrorInvalidValue;
}
