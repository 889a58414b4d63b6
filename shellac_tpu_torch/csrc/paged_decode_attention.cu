// Flash-decode over a paged KV block pool.
//
// q (B, s, H, D) attends pools (n_blocks, Hkv, bs, D) through per-slot
// block tables (B, max_blocks) int32: logical position p of slot b lives
// at pool[tables[b, p / bs], :, p % bs]. An int8 pool comes with fp32
// scale pools (n_blocks, Hkv, bs) that mirror it page for page, so a
// position's scale sits at its row index.
//
// Replaces both Pallas paged kernels of shellac_tpu/ops/
// decode_attention.py: `_paged_group_kernel` (launched by
// `_paged_group_flash`, `group` pages gathered per grid step), its int8
// branch (quant=True, which gathers the scale pages beside the value
// pages), and `_paged_kernel` (launched by `_paged_flash`, one page per
// step). Any block size and D 64 or 128 take these kernels, int8
// included: the TPU's 32-aligned int8 pages were a tiling constraint of
// its VMEM gather, which this card does not have. The TPU kernels'
// gather of `group` pages into one VMEM tile is not carried over either:
// it amortizes the TPU's per-grid-step overhead.
//
// A bf16 q (the main path, over a bf16 or an int8 pool) takes the split-K
// body of decode_split.cuh (`decode_split_kernel`, whose note gives the
// design: a cluster of CTAs per (slot, kv head), 32-position tiles of the
// live range dealt round robin to their warps, a merge through
// distributed shared memory) with PagedTiles below:
//   - the pool's bs rows of one (page, kv head) are contiguous, so a tile
//     is one 1-D bulk copy per page segment it covers, for k and for v:
//     the warp's first lanes each copy one segment (2-3 at bs 16, 1-2 at
//     int8's bs 64, up to 32 at bs 1), and lane 0 arms the stage's
//     mbarrier with the tile's total bytes. Any block size takes the
//     same body: a segment is a whole number of rows, 64-256 bytes each,
//     so every copy is 16-byte aligned;
//   - the issuing lanes read their segments' page ids from the slot's
//     table row, one tile ahead: the next tile's ids load while this one
//     computes, so only the first tile pays the chain index -> table ->
//     copy. There is no staged table and no block-wide barrier for it;
//   - an int8 tile's fp32 scales are ordinary per-lane loads (lane =
//     position; a segment's scales are n x 4 bytes at any offset, not a
//     valid bulk copy in general), issued with the tile's k copy, each
//     lane taking its position's page id from its segment's lane by a
//     shuffle.
// Only table entries and rows of pages from the window's first live
// position to index + s - 1 are read, so an unallocated or dead page,
// and the rows of the last page past a slot's length, are never read.
//
// An fp32 q (the parity path) runs the shared warp-parallel body of
// decode_core.cuh with PagedRows: each block stages its slot's live
// table entries in shared memory, and each lane turns its position into
// (page, offset) with one division per chunk. MLA's latent pools (D 576,
// one pool as k and v) take decode_wide.cuh with PagedTiles (its
// `row_of`: each copying thread reads its row's page id itself), a bf16
// q the tensor-core body, an fp32 q the CUDA-core one, over pools in q's
// dtype or int8.
//
// Bound on the H100: bytes, the live k/v rows of every slot (and their
// scales in int8). Serving decodes 16 slots x 8 kv heads; the split body
// runs them as clusters of 2 CTAs in bf16 and of 4 in int8, whose stages
// are half the size, so more CTAs fit at once.
#include "decode_core.cuh"
#include "decode_split.cuh"
#include "decode_wide.cuh"

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

// The split-K body's tiles policy: a tile is one copy per page segment.
struct PagedTiles {
  const int* tables;  // (B, max_blocks)
  int max_blocks, bs, Hkv;
  // Set by begin(): this block's table row and kv head. Set by fetch():
  // the fetched tile's first page, and lane l's page id: the table entry
  // of the tile's l-th page (0 past its last).
  const int* row;
  int hk, first_pg, page;

  __host__ __device__ int capacity() const { return max_blocks * bs; }
  __device__ void begin(int b, int hk_) {
    row = tables + (size_t)b * max_blocks;
    hk = hk_;
  }
  __device__ void fetch(int p0, int n, int lane) {
    first_pg = p0 / bs;
    const int last = (p0 + n - 1) / bs;
    page = first_pg + lane <= last ? row[first_pg + lane] : 0;
  }
  template <int D, typename KT>
  __device__ void issue(uint64_t* bar, KT* dst, const KT* src, int p0, int n,
                        int lane) const {
    if (lane == 0) hopper::mbar_arrive_expect_tx(bar, n * D * sizeof(KT));
    __syncwarp();
    const int pg = first_pg + lane;
    const int lo = max(p0, pg * bs), hi = min(p0 + n, pg * bs + bs);
    if (lo < hi)
      hopper::bulk_load(
          dst + (size_t)(lo - p0) * D,
          src + (((size_t)page * Hkv + hk) * bs + (lo - pg * bs)) * D,
          (hi - lo) * D * sizeof(KT), bar);
  }
  __device__ size_t lane_row(int p0, int lane) const {
    const int pos = p0 + lane;
    const int pg = pos / bs;
    const int id = __shfl_sync(0xffffffffu, page, (pg - first_pg) & 31);
    return ((size_t)id * Hkv + hk) * bs + (pos - pg * bs);
  }
  // Any one lane: the row of position pos, from its own table read (the
  // wide body's copies, one row a lane).
  __device__ size_t row_of(int pos) const {
    const int pg = pos / bs;
    return ((size_t)row[pg] * Hkv + hk) * bs + (pos - pg * bs);
  }
};

template <typename T, typename KT>
cudaError_t launch_paged(const void* q, const void* k, const void* v,
                         const void* ks, const void* vs, const void* tables,
                         const void* index, const void* sinks, void* out,
                         int B, int s, int H, int Hkv, int bs,
                         int max_blocks, int D, float scale, int window,
                         float softcap, cudaStream_t stream) {
  if (D == wide::kD) {
    const PagedTiles tiles{static_cast<const int*>(tables), max_blocks, bs,
                           Hkv, nullptr, 0, 0, 0};
    return wide::launch<T, KT>(q, k, v, ks, vs, index, sinks, out, B, s, H,
                               Hkv, D, scale, window, softcap, tiles, stream);
  }
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const PagedTiles tiles{static_cast<const int*>(tables), max_blocks, bs,
                           Hkv, nullptr, 0, 0, 0};
    return split::launch<KT>(q, k, v, ks, vs, index, sinks, out, B, s, H,
                             Hkv, D, scale, window, softcap, tiles, stream);
  } else {
    const PagedRows addr{static_cast<const int*>(tables), max_blocks, bs,
                         Hkv, nullptr, 0, 0};
    return decode::launch<T, KT>(q, k, v, ks, vs, index, sinks, out, B, s,
                                 H, Hkv, D, scale, window, softcap, addr,
                                 stream);
  }
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
