// Flash-decode over a paged KV block pool.
//
// q (B, s, H, D) attends pools (n_blocks, Hkv, bs, D) through per-slot
// block tables (B, max_blocks) int32: logical position p of slot b lives
// at pool[tables[b, p / bs], :, p % bs]. The body is the shared
// warp-parallel decode in decode_core.cuh; only the address differs. An
// int8 pool comes with fp32 scale pools (n_blocks, Hkv, bs) that mirror
// it page for page, so a position's scale sits at its row index.
//
// Replaces both Pallas paged kernels of shellac_tpu/ops/
// decode_attention.py: `_paged_group_kernel` (launched by
// `_paged_group_flash`, `group` pages gathered per grid step), its int8
// branch (quant=True, which gathers the scale pages beside the value
// pages), and `_paged_kernel` (launched by `_paged_flash`, one page per
// step). Any block size and D 64 or 128 take this one kernel, int8
// included: the TPU's 32-aligned int8 pages were a tiling constraint of
// its VMEM gather, which this kernel does not have.
//
// Design: each block stages its slot's table entries for the live page
// range in shared memory once (at most max_blocks ints); each lane then
// turns its position into (page, offset) with one division per chunk,
// and the p.V loop gets each row's address by a shuffle. A 32-position
// chunk that spans pages (bs < 32) or a page that spans chunks (bs > 32)
// needs nothing special. Only pages from the window's first live one to
// (index + s - 1) / bs are ever addressed, so an unallocated or dead page
// is never read, whatever it holds. The TPU kernel's gather of `group`
// pages into one VMEM tile is not carried over: it amortizes the TPU's
// per-grid-step overhead, which this card does not have.
//
// Bound on the H100: bytes, the live k/v rows of every slot. Serving
// decodes 16 slots x 8 kv heads = 128 blocks on 132 SMs.
#include "decode_core.cuh"

namespace shellac {
namespace {

struct PagedRows {
  const int* tables;  // (B, max_blocks)
  int max_blocks, bs, Hkv;
  // Set by stage(): the staged table entries of pages first_pg.. and
  // this block's kv head.
  const int* tab;
  int first_pg, hk;

  __host__ __device__ int capacity() const { return max_blocks * bs; }
  int extra_ints() const { return max_blocks; }
  __device__ void stage(int b, int hk_, int first, int live_end, int* ints,
                        int tid) {
    hk = hk_;
    first_pg = first / bs;
    const int n = (live_end - 1) / bs - first_pg + 1;
    const int* row = tables + (size_t)b * max_blocks + first_pg;
    for (int i = tid; i < n; i += decode::kThreads) ints[i] = row[i];
    tab = ints;
  }
  __device__ size_t row(int pos) const {
    const int pg = pos / bs;
    return ((size_t)tab[pg - first_pg] * Hkv + hk) * bs + (pos - pg * bs);
  }
};

template <typename T, typename KT>
cudaError_t launch_paged(const void* q, const void* k, const void* v,
                         const void* ks, const void* vs, const void* tables,
                         const void* index, const void* sinks, void* out,
                         int B, int s, int H, int Hkv, int bs,
                         int max_blocks, int D, float scale, int window,
                         float softcap, cudaStream_t stream) {
  const PagedRows addr{static_cast<const int*>(tables), max_blocks, bs, Hkv,
                       nullptr, 0, 0};
  return decode::launch<T, KT>(q, k, v, ks, vs, index, sinks, out, B, s, H,
                               Hkv, D, scale, window, softcap, addr, stream);
}

}  // namespace
}  // namespace shellac

// window <= 0: none; softcap <= 0: none; sinks may be null.
extern "C" int shellac_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* tables,
    const void* index, const void* sinks, void* out, int B, int s, int H,
    int Hkv, int bs, int max_blocks, int D, float scale, int window,
    float softcap, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == shellac::kF32)
    return shellac::launch_paged<float, float>(
        q, k, v, nullptr, nullptr, tables, index, sinks, out, B, s, H, Hkv,
        bs, max_blocks, D, scale, window, softcap, st);
  if (dtype == shellac::kBF16)
    return shellac::launch_paged<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, nullptr, nullptr, tables, index, sinks, out, B, s, H, Hkv,
        bs, max_blocks, D, scale, window, softcap, st);
  return (int)cudaErrorInvalidValue;
}

// int8 pools k/v (n_blocks, Hkv, bs, D) with fp32 scale pools ks/vs
// (n_blocks, Hkv, bs); dtype is q's (and the output's).
extern "C" int shellac_paged_decode_attention_int8(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* tables, const void* index, const void* sinks,
    void* out, int B, int s, int H, int Hkv, int bs, int max_blocks, int D,
    float scale, int window, float softcap, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == shellac::kF32)
    return shellac::launch_paged<float, int8_t>(
        q, k, v, ks, vs, tables, index, sinks, out, B, s, H, Hkv, bs,
        max_blocks, D, scale, window, softcap, st);
  if (dtype == shellac::kBF16)
    return shellac::launch_paged<__nv_bfloat16, int8_t>(
        q, k, v, ks, vs, tables, index, sinks, out, B, s, H, Hkv, bs,
        max_blocks, D, scale, window, softcap, st);
  return (int)cudaErrorInvalidValue;
}
