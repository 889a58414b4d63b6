// Flash-decode at a wide head dim, the Hopper body of MLA's absorbed
// decode (kernels 5, 6 and 7 at D 576: decode_attention.cu and
// paged_decode_attention.cu dispatch D 576 here, in bf16 and fp32 q, over
// caches in q's dtype or int8).
//
// The absorbed decode attends every query head (G * s rows of the one kv
// head) against ONE latent row a token, kv_lora_rank + qk_rope_head_dim =
// 576 wide, with the same array as k and v (the JAX `_mla_attention`,
// shellac_tpu/models/transformer.py:854-940). So this body takes one
// array (and, in int8, one scale a row) in both roles, and no window,
// softcap or sinks, which no MLA model has; the launch refuses anything
// else. The semantics are decode_split.cuh's (the JAX `_decode_tile`):
// only the live range is read, fp32 online softmax with p rounded to q's
// dtype before p.V; over an int8 cache the logit is the dot with the
// integer row times the row's scale, and p is multiplied by the same
// scale before p.V over the integer row.
//
// Bound on the H100: bytes, the live latent rows read once (1152 bytes a
// position in bf16, 580 in int8 with its scale): at serve's shape (16
// slots near 512 positions) 9.4 MB a layer, 2.8 us at 3.35 TB/s. The
// operations are 4 x 576 a position and q row, 32 flops a byte at 16
// rows in bf16, far below the tensor cores' 295; at a decode step's sizes
// the launch's latency weighs as much as the bytes.
//
// Both bodies: a CTA holds up to 16 q rows; more rows (DeepSeek-V2/V3's
// 128 heads) take more CTAs along the grid's y axis, 16 rows each, which
// read the same latent tiles (through L2 after the first). The CTAs of a
// (slot, kv head, row group) form a cluster of up to 8 (decode_split.
// cuh's `pick_split` over the clusters the card holds at once); the live
// range is cut into 32-position tiles dealt round robin to them, and
// their states merge through distributed shared memory (`merge_cluster`).
//
// A bf16 q takes the tensor-core body, `decode_wide_mma`: the 16 q rows
// against one latent row are the m16 side of `mma.sync.m16n8k16` (bf16
// operands, fp32 accumulators), in both products.
//   - 8 warps, two to each of four 144-wide column slices of the 576
//     dims; a warp uses its slice in both products. q.K^T sums over the
//     dims: a slice's two warps take 2 n8 tiles (16 positions) each of a
//     32-position tile over the slice's 9 k-steps, their q fragments held
//     in registers all along (36 registers, `ldmatrix` once from q staged
//     in shared memory as bf16, 18 KB where the CUDA-core body held 36 KB
//     of fp32). p.V's output columns are the slice's: 9 n8 tiles a warp,
//     36 fp32 accumulators a lane. Eight warps, two a scheduler, hide
//     each other's latencies: four warps (one a scheduler, 72
//     accumulators a lane) measured 6-20% slower on an H100 (PERF.md).
//   - The warps agree on the softmax: each writes its partial logits to a
//     double-buffered shared buffer, one __syncthreads a tile, and every
//     warp sums the four slices' partials in the same order and runs the
//     same online-softmax step on the accumulator fragments (row max and
//     sum by quad shuffles), so all eight hold the same m, l and p with
//     no second exchange. p's fragments are p.V's A operand in registers
//     (two adjacent n8 accumulator tiles are one k16 A fragment), rounded
//     to bf16.
//   - A tile lands by 16-byte `cp.async` copies, 8 threads a row (9
//     copies each in bf16), into rows padded by one 16-byte chunk (1168
//     bytes): a latent row is 1152 bytes, 9 x 128, so the 8 rows an
//     `ldmatrix` reads at one column would share their banks (8-way);
//     padded, they fall on 8 different chunks. Each thread arrives on the
//     stage's mbarrier (`cp.async.mbarrier.arrive`) once its copies land.
//     One 1-D bulk copy a row (TMA, one lane a row) measured 1-6% slower
//     on an H100 (PERF.md). The same stage feeds q.K^T (`ldmatrix`) and p.V
//     (`ldmatrix.trans`): the latent leaves HBM once. A row's address
//     comes from the tiles policy (`row_of`: the dense slot's row, or the
//     page table's entry), so dense caches and pools of any block size
//     take the same copies.
//   - A ring of 4 stages: at serve's shape all of a CTA's tiles are in
//     flight from the start. A stage is refilled after the barrier that
//     shows every warp is past it (the next tile's, in bf16), each
//     thread's table read started before that tile's q.K^T. The shared
//     memory (185 KB) holds one CTA an SM, so the card holds 15 clusters
//     of 8 and serve's 16 slots split 4 ways (PERF.md: two CTAs an SM
//     would split them 8 ways).
//   - Stage rows past a tile's live count hold stale bytes or anything at
//     all: their logits are selected away, and their p.V operands are
//     masked to zero in registers (0 x NaN would not be).
//   - int8: rows of 576 bytes land in their own ring (592-byte rows, the
//     row's scale beside them by a 4-byte cp.async), and each warp
//     converts the rows its q.K^T reads of its slice to bf16 (|v| <= 127
//     is exact in bf16; bit operations and one bf16x2 subtraction a pair,
//     not I2F) in a shared tile, double-buffered since the slice's other
//     warp reads those rows in p.V after the barrier. The logit takes the
//     row's scale after the dot. p times the row's scale is rounded to
//     bf16 for the MMA where the reference keeps it fp32
//     (shellac_tpu/ops/decode_attention.py:144-151): a relative error of
//     at most 2^-9 on each weight, inside the bf16 tolerance the card's
//     checks hold a bf16 q to.
// An fp32 q, the parity path, keeps the CUDA-core body `decode_wide_
// kernel`: its 4 warps split the rows (4 each) and walk the same tiles;
// lane l takes position l for the logits, against q in shared memory
// (fp32, scaled), and owns 9 dim pairs in p.V; one stage in fp32, two in
// int8; a __syncthreads closes each tile.
#pragma once

#include <type_traits>

#include "decode_core.cuh"
#include "decode_split.cuh"
#include "hopper.cuh"

namespace shellac {
namespace wide {

using bf16 = __nv_bfloat16;

constexpr int kD = 576;       // the head dim this body is built for
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;     // positions a tile
constexpr int kRows = 16;     // q rows (G * s) a CTA holds at most
constexpr int kRowsWarp = kRows / kWarps;

// The cluster's merge, after each CTA put its rows' state in shared
// memory (Mc, Lc: [kRows]; Ac: [kRows][kD], fp32, unnormalised): one
// thread a row reads the CTAs' (m, l) once and keeps each CTA's weight in
// Wc ([kRows][kMaxSplit], its rescale and 1 / l folded in), then each
// CTA writes a share of the outputs, one remote load a CTA an element.
// (A merge that re-read every CTA's m and l for each of the 16 x 576
// outputs took 0.0604 ms a call at generate's shape on an H100, this one
// 0.0560, with the CUDA-core body.)
template <typename T>
__device__ __forceinline__ void merge_cluster(const float* Mc,
                                              const float* Lc,
                                              const float* Ac, float* Wc,
                                              T* __restrict__ out, int rows,
                                              int r_base, int b, int s,
                                              int H, int hk, int G) {
  const int tid = threadIdx.x;
  const int rank = blockIdx.x;
  const int n_split = gridDim.x;
  hopper::cluster_sync();
  if (tid < rows) {
    const int r = tid;
    float mc[split::kMaxSplit];
    float M = kNegInf, Ls = 0.f;
#pragma unroll
    for (int c = 0; c < split::kMaxSplit; ++c) {
      mc[c] = c < n_split
                  ? hopper::cluster_load(hopper::cluster_map(Mc + r, c))
                  : kNegInf;
      M = fmaxf(M, mc[c]);
    }
#pragma unroll
    for (int c = 0; c < split::kMaxSplit; ++c) {
      mc[c] = c < n_split ? expf(mc[c] - M) : 0.f;
      if (c < n_split)
        Ls += hopper::cluster_load(hopper::cluster_map(Lc + r, c)) * mc[c];
    }
    const float denom = Ls == 0.f ? 1.f : Ls;
#pragma unroll
    for (int c = 0; c < split::kMaxSplit; ++c)
      Wc[r * split::kMaxSplit + c] = mc[c] / denom;
  }
  __syncthreads();
  const int threads = blockDim.x;
  for (int i = rank * threads + tid; i < rows * kD; i += n_split * threads) {
    const int r = i / kD, d = i % kD, R = r_base + r;
    float A = 0.f;
#pragma unroll
    for (int c = 0; c < split::kMaxSplit; ++c)
      if (c < n_split)
        A += Wc[r * split::kMaxSplit + c] *
             hopper::cluster_load(hopper::cluster_map(Ac + i, c));
    out[(((size_t)b * s + R % s) * H + hk * G + R / s) * kD + d] =
        from_f32<T>(A);
  }
  hopper::cluster_sync();  // peers may still read this CTA's partials
}

// ------------------------------------------ the tensor-core body (bf16 q)

constexpr int kSlices = 4;           // column slices of the 576 dims
constexpr int kCols = kD / kSlices;  // 144
constexpr int kKSteps = kCols / 16;  // q.K^T's k16 steps in a slice
constexpr int kNTiles = kCols / 8;   // p.V's n8 tiles in a slice
constexpr int kPitch = kD * 2 + 16;  // a bf16 row in shared memory, padded
constexpr int kSTiles = kTile / 8;   // q.K^T's n8 tiles a tile
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kHalves = kMmaWarps / kSlices;     // warps a slice
constexpr int kQkTiles = kSTiles / kHalves;      // q.K^T n8 tiles a warp
constexpr int kPvTiles = kNTiles / kHalves;      // p.V n8 tiles a warp
constexpr int kRowThreads = kMmaThreads / kTile;  // copying threads a row
static_assert(kCols % 16 == 0 && kTile % 16 == 0, "whole MMA steps");
static_assert(kQkTiles % 2 == 0, "q.K^T n8 tiles in pairs");
static_assert((kPitch / 16) % 2 == 1, "rows an odd number of chunks apart");

// Four 8x8 b16 matrices; lanes 8i-8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_addr(p))
      : "memory");
}

// Two 8x8 b16 matrices, transposed; lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(hopper::smem_addr(p))
      : "memory");
}

// Four 8x8 b16 matrices, each transposed.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_addr(p))
      : "memory");
}

// d (m16 x n8, fp32) += a (m16 x k16, bf16) * b (k16 x n8, bf16).
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, asynchronously, through L2 only.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   hopper::smem_addr(dst)),
               "l"(src)
               : "memory");
}

// 4 bytes global -> shared, asynchronously.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   hopper::smem_addr(dst)),
               "l"(src)
               : "memory");
}

// Arrive on `bar` once every cp.async this thread issued before has
// landed (the barrier counts the arrivals: one a thread).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   hopper::smem_addr(bar))
               : "memory");
}

// 4 int8 values (one word) as 2 packed bf16 pairs, exactly: a byte b's
// low 7 bits under bf16's 2^7 (128 + (b & 127)) minus 128, or 256 where
// b's sign bit is set; a prmt, two lop3 and one bf16x2 subtraction a pair.
__device__ __forceinline__ uint2 int8x4_to_bf16(uint32_t w) {
  uint32_t out[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t t = __byte_perm(w, 0u, h ? 0x4342 : 0x4140);
    const uint32_t xb = (t & 0x007F007Fu) | 0x43004300u;
    const uint32_t yb = (t & 0x00800080u) | 0x43004300u;
    const __nv_bfloat162 d = __hsub2(
        *reinterpret_cast<const __nv_bfloat162*>(&xb),
        *reinterpret_cast<const __nv_bfloat162*>(&yb));
    out[h] = *reinterpret_cast<const uint32_t*>(&d);
  }
  return make_uint2(out[0], out[1]);
}

// Shared memory: the stages' full barriers, q (bf16, [kRows][kPitch]),
// the slices' partial logits ([2][kSlices][kSTiles][32] float4), the int8
// scales ([stage][kTile]), in int8 the tile as bf16 ([kWorkBufs][kTile]
// [kPitch]: two when two warps share a slice, so one can convert the
// next tile while the other still reads this one), then the ring
// ([stage][kTile] rows of kRowPitch bytes), which the merge's per-row
// state reuses once every tile is consumed.
template <typename KT>
struct MmaLayout {
  static constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  static constexpr int kStages = 4;
  static constexpr int kRowPitch = kQuant ? kD + 16 : kPitch;
  static constexpr int kWorkBufs = kQuant ? kHalves : 0;
  static constexpr size_t kQ = 128;
  static constexpr size_t kS = kQ + (size_t)kRows * kPitch;
  static constexpr size_t kSc =
      kS + sizeof(float) * 2 * kSlices * kRows * kTile;
  static constexpr size_t kWork = kSc + sizeof(float) * kStages * kTile;
  static constexpr size_t kRing = kWork + (size_t)kWorkBufs * kTile * kPitch;
  static constexpr size_t kBytes =
      kRing + (size_t)kStages * kTile * kRowPitch;
  static_assert(kStages * 8 <= kQ, "barriers fit before q");
  static_assert(kRowPitch % 16 == 0 && kWork % 16 == 0 && kRing % 16 == 0,
                "16-byte copies land aligned");
  static_assert(sizeof(float) * kRows * (kD + 2) <=
                    (size_t)kStages * kTile * kRowPitch,
                "the merge's state fits in the ring");
  static_assert(kRows * split::kMaxSplit <= 2 * kSlices * kRows * kTile,
                "the merge's weights fit where the partial logits were");
  static_assert(kBytes <= 227 * 1024, "one CTA an SM");
};

template <typename KT, typename Tiles>
__global__ void __launch_bounds__(kMmaThreads, 1)
decode_wide_mma(const bf16* __restrict__ q, const KT* cache,
                const float* scales, const int* __restrict__ index,
                bf16* __restrict__ out, int s, int H, int Hkv, int n_groups,
                float scale, Tiles tiles) {
  using Lay = MmaLayout<KT>;
  constexpr bool kQuant = Lay::kQuant;
  constexpr int ST = Lay::kStages;
  constexpr int RP = Lay::kRowPitch;
  constexpr int kChunks = kD * sizeof(KT) / 16;  // 16-byte chunks a row
  // bf16 reads a stage in both products, so a stage is free only after
  // the next tile's barrier; int8 converts it before its own barrier.
  constexpr int kConvRows = kTile / kHalves;  // int8: rows a warp converts
  constexpr int kLag = kQuant ? 0 : 1;

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [stage]
  unsigned char* Qs = smem + Lay::kQ;
  float4* Sp = reinterpret_cast<float4*>(smem + Lay::kS);
  float* Sc = reinterpret_cast<float*>(smem + Lay::kSc);  // [stage][32]
  unsigned char* ring = smem + Lay::kRing;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4, c = lane % 4;  // the MMA fragments' row, pair
  const int rank = blockIdx.x;  // the cluster rank: clusters (n_split, 1, 1)
  const int n_split = gridDim.x;
  const int hk = blockIdx.y / n_groups;
  const int r_base = (blockIdx.y % n_groups) * kRows;  // this CTA's rows
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int rows = min(kRows, G * s - r_base);
  // This warp's column slice, and which of its warps it is: q.K^T over
  // n8 tiles [half * kQkTiles, +kQkTiles) of the slice's dims, p.V into
  // the slice's n8 tiles [half * kPvTiles, +kPvTiles).
  const int slice = warp % kSlices, half = warp / kSlices;
  const int col0 = slice * kCols;
  // The row of each tile this thread copies, kRowThreads threads a row,
  // and its first chunk.
  const int lr = tid / kRowThreads, lc = tid % kRowThreads;

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) hopper::mbar_init(&full[i], kMmaThreads);
    hopper::mbar_init_fence();
  }
  tiles.begin(b, hk);
  const int idx = index[b];
  const int live_end = min(idx + s, tiles.capacity());  // exclusive
  const int n_tiles = live_end > 0 ? (live_end + kTile - 1) / kTile : 0;
  // This CTA's j-th tile is tile rank + n_split * j.
  const int my_tiles =
      rank < n_tiles ? (n_tiles - rank + n_split - 1) / n_split : 0;
  auto tile_pos = [&](int j) { return (rank + n_split * j) * kTile; };
  auto tile_n = [&](int j) { return min(kTile, live_end - tile_pos(j)); };
  auto stage = [&](int st) { return ring + (size_t)st * kTile * RP; };
  auto row_for = [&](int j) -> size_t {
    return lr < tile_n(j) ? tiles.row_of(tile_pos(j) + lr) : 0;
  };
  // Every thread: its share of its row's chunks of tile j (and in int8
  // the row's scale), then its arrival on the stage's barrier once they
  // land.
  auto issue = [&](int j, size_t row) {
    const int st = j % ST;
    if (lr < tile_n(j)) {
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(cache + row * kD);
      unsigned char* dst = stage(st) + lr * RP;
#pragma unroll
      for (int k = lc; k < kChunks; k += kRowThreads)
        cp_async16(dst + 16 * k, src + 16 * k);
      if constexpr (kQuant)
        if (lc == 0) cp_async4(Sc + st * kTile + lr, scales + row);
    }
    cp_async_arrive(&full[st]);
  };
  __syncthreads();  // the barriers are initialised
  {
    size_t first[ST];
#pragma unroll
    for (int j = 0; j < ST; ++j) first[j] = j < my_tiles ? row_for(j) : 0;
#pragma unroll
    for (int j = 0; j < ST; ++j)
      if (j < my_tiles) issue(j, first[j]);
  }

  // q's rows in shared memory as bf16 (rows past `rows` zero). Local row
  // r is row R = r_base + r of the kv head: (group member g = R / s,
  // query si = R % s), q head hk*G + g at position idx + si.
  for (int i = tid; i < kRows * (kD / 8); i += kMmaThreads) {
    const int r = i / (kD / 8), ch = i % (kD / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < rows) {
      const int R = r_base + r;
      v = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * s + R % s) * H + hk * G + R / s) * kD + ch * 8);
    }
    *reinterpret_cast<uint4*>(Qs + r * kPitch + ch * 16) = v;
  }
  __syncthreads();
  uint32_t qa[kKSteps][4];  // this warp's q.K^T A fragments
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk)
    ldsm_x4(qa[kk], Qs + (lane % 16) * kPitch +
                        (col0 + kk * 16 + (lane / 16) * 8) * 2);

  // Rows g and g + 8 of the fragments: their query positions and state.
  const int qpos[2] = {idx + (r_base + g) % s, idx + (r_base + g + 8) % s};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kPvTiles][4];
#pragma unroll
  for (int t = 0; t < kPvTiles; ++t)
    o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  size_t row_next = 0;  // the row this thread copies of the next refill
  unsigned char* work = smem + Lay::kWork;  // int8: the tile as bf16

  for (int j = 0; j < my_tiles; ++j) {
    const int st = j % ST, p0 = tile_pos(j), n = tile_n(j);
    const int jr = j + ST - kLag;  // refilled after this tile's barrier
    const bool refill = j >= kLag && jr < my_tiles;
    if (refill) row_next = row_for(jr);  // the table read overlaps q.K^T
    hopper::mbar_wait(&full[st], (j / ST) & 1);
    const unsigned char* kv = stage(st);  // the tile as bf16 rows
    float ksc[kSTiles][2];  // int8: the scales of this lane's positions
    if constexpr (kQuant) {
      // This warp's rows of its slice of the int8 tile into `work` as
      // bf16 (the rows its q.K^T reads; p.V reads the slice's other warp's
      // rows too, after the barrier).
      kv = work + (size_t)(j % Lay::kWorkBufs) * kTile * kPitch;
      unsigned char* conv = const_cast<unsigned char*>(kv);
      __syncwarp();  // the slice's last p.V reads are done
      const unsigned char* src = stage(st);
      for (int i = lane; i < kConvRows * (kCols / 16); i += 32) {
        const int r = half * kConvRows + i / (kCols / 16),
                  ch = i % (kCols / 16);
        const uint4 w = *reinterpret_cast<const uint4*>(
            src + r * RP + col0 + ch * 16);
        const uint2 a = int8x4_to_bf16(w.x), b2 = int8x4_to_bf16(w.y);
        const uint2 c2 = int8x4_to_bf16(w.z), d2 = int8x4_to_bf16(w.w);
        uint4* dst = reinterpret_cast<uint4*>(conv + r * kPitch +
                                              (col0 + ch * 16) * 2);
        dst[0] = make_uint4(a.x, a.y, b2.x, b2.y);
        dst[1] = make_uint4(c2.x, c2.y, d2.x, d2.y);
      }
      __syncwarp();
#pragma unroll
      for (int t = 0; t < kSTiles; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          ksc[t][e] = Sc[st * kTile + 8 * t + 2 * c + e];
    }

    // q.K^T over this warp's slice and n8 tiles: sacc[i] is positions
    // 8 (t0 + i) .. +7.
    const int t0 = half * kQkTiles;
    float sacc[kQkTiles][4];
#pragma unroll
    for (int i = 0; i < kQkTiles; ++i)
      sacc[i][0] = sacc[i][1] = sacc[i][2] = sacc[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int np = 0; np < kQkTiles / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, kv + (8 * t0 + 16 * np + (lane / 16) * 8 + lane % 8) *
                             kPitch +
                        (col0 + kk * 16 + ((lane / 8) % 2) * 8) * 2);
        mma_bf16(sacc[2 * np], qa[kk], bk[0], bk[1]);
        mma_bf16(sacc[2 * np + 1], qa[kk], bk[2], bk[3]);
      }
    }
    float4* part = Sp + (j % 2) * kSlices * kSTiles * 32;
#pragma unroll
    for (int i = 0; i < kQkTiles; ++i)
      part[(slice * kSTiles + t0 + i) * 32 + lane] =
          make_float4(sacc[i][0], sacc[i][1], sacc[i][2], sacc[i][3]);
    __syncthreads();  // partials written; every warp is past tile j - 1
    if (refill) issue(jr, row_next);

    // Every warp sums the slices' partials in the same order and runs the
    // same softmax step: element e of tile t is row g + 8 (e / 2),
    // position p0 + 8t + 2c + e % 2.
    float x[kSTiles][4];
#pragma unroll
    for (int t = 0; t < kSTiles; ++t) {
      float4 a = part[t * 32 + lane];
#pragma unroll
      for (int w = 1; w < kSlices; ++w) {
        const float4 y = part[(w * kSTiles + t) * 32 + lane];
        a.x += y.x;
        a.y += y.y;
        a.z += y.z;
        a.w += y.w;
      }
      x[t][0] = a.x;
      x[t][1] = a.y;
      x[t][2] = a.z;
      x[t][3] = a.w;
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int t = 0; t < kSTiles; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * t + 2 * c + e % 2;
        float v = x[t][e] * scale;
        if constexpr (kQuant) v *= ksc[t][e % 2];  // dequantize the logit
        v = col < n && p0 + col <= qpos[e / 2] ? v : kNegInf;
        x[t][e] = v;
        mx[e / 2] = fmaxf(mx[e / 2], v);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int t = 0; t < kSTiles; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = x[t][e];
        const float p = v > 0.5f * kNegInf ? expf(v - m[e / 2]) : 0.f;
        sum[e / 2] += p;
        float w = p;  // p.V's weight (a dead row's stale scale unread)
        if constexpr (kQuant) w = v > 0.5f * kNegInf ? p * ksc[t][e % 2] : 0.f;
        x[t][e] = w;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = alpha[h] * l[h] + sum[h];
    }
#pragma unroll
    for (int t = 0; t < kPvTiles; ++t) {
      o[t][0] *= alpha[0];
      o[t][1] *= alpha[0];
      o[t][2] *= alpha[1];
      o[t][3] *= alpha[1];
    }

    // p.V into this warp's n8 tiles. Operands of rows past n are zeroed:
    // lane holds positions 16ks + 2c (+1) in b0 and 16ks + 8 + 2c (+1)
    // in b1 of each n8 tile.
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      if (16 * ks >= n) break;
      const uint32_t pa[4] = {
          hopper::pack_bf16x2(x[2 * ks][0], x[2 * ks][1]),
          hopper::pack_bf16x2(x[2 * ks][2], x[2 * ks][3]),
          hopper::pack_bf16x2(x[2 * ks + 1][0], x[2 * ks + 1][1]),
          hopper::pack_bf16x2(x[2 * ks + 1][2], x[2 * ks + 1][3])};
      const int pl = 16 * ks + 2 * c;
      const uint32_t lo = (pl < n ? 0xffffu : 0u) |
                          (pl + 1 < n ? 0xffff0000u : 0u);
      const uint32_t hi = (pl + 8 < n ? 0xffffu : 0u) |
                          (pl + 9 < n ? 0xffff0000u : 0u);
      const unsigned char* vrow =
          kv + (16 * ks + ((lane / 8) % 2) * 8 + lane % 8) * kPitch +
          (col0 + half * kPvTiles * 8) * 2;
#pragma unroll
      for (int np = 0; np < kPvTiles / 2; ++np) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vrow + (np * 16 + (lane / 16) * 8) * 2);
        mma_bf16(o[2 * np], pa, bv[0] & lo, bv[1] & hi);
        mma_bf16(o[2 * np + 1], pa, bv[2] & lo, bv[3] & hi);
      }
      if constexpr (kPvTiles % 2 == 1) {
        uint32_t bv[2];
        ldsm_x2_trans(bv, vrow + (kPvTiles - 1) * 8 * 2);
        mma_bf16(o[kPvTiles - 1], pa, bv[0] & lo, bv[1] & hi);
      }
    }
  }

  // Each row's state into shared memory (the ring is free once every
  // warp is past its last tile), then the cluster's merge.
  __syncthreads();
  float* Mc = reinterpret_cast<float*>(ring);  // [kRows]
  float* Lc = Mc + kRows;                      // [kRows]
  float* Ac = Lc + kRows;                      // [kRows][kD]
#pragma unroll
  for (int t = 0; t < kPvTiles; ++t) {
    const int col = col0 + 8 * (half * kPvTiles + t) + 2 * c;
    *reinterpret_cast<float2*>(Ac + g * kD + col) =
        make_float2(o[t][0], o[t][1]);
    *reinterpret_cast<float2*>(Ac + (g + 8) * kD + col) =
        make_float2(o[t][2], o[t][3]);
  }
  if (warp == 0 && c == 0) {
    Mc[g] = m[0];
    Mc[g + 8] = m[1];
    Lc[g] = l[0];
    Lc[g + 8] = l[1];
  }
  merge_cluster<bf16>(Mc, Lc, Ac, reinterpret_cast<float*>(Sp), out, rows,
                      r_base, b, s, H, hk, G);
}

// ------------------------------------------ the CUDA-core body (fp32 q)

template <typename KT>
constexpr int stages() {
  return sizeof(KT) == 4 ? 1 : 2;
}

// Shared memory: barriers ([stage]), q (fp32, scaled: [2][kRows][D / 8][4],
// the low and high halves of each 8-element chunk apart), p ([kWarps]
// [kRowsWarp][kTile]), the int8 scales ([stage][kTile]), then the stages
// ([stage][kTile][D] of KT), which the merge's per-row state reuses once
// every tile is consumed.
template <typename KT, int D>
struct Layout {
  static constexpr int kStages = stages<KT>();
  static constexpr size_t kQ = 128;
  static constexpr size_t kP = kQ + sizeof(float) * kRows * D;
  static constexpr size_t kS =
      kP + sizeof(float) * kWarps * kRowsWarp * kTile;
  static constexpr size_t kRing =
      (kS + sizeof(float) * kStages * kTile + 127) / 128 * 128;
  static constexpr size_t kStage = sizeof(KT) * kTile * D;
  static constexpr size_t kRingBytes = kStages * kStage;
  static constexpr size_t kMergeBytes = sizeof(float) * kRows * (D + 2);
  static constexpr size_t kBytes =
      kRing + (kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes);
  static_assert(kStages * 8 <= kQ, "barriers fit before q");
  static_assert(kWarps * kRowsWarp * kTile >= kRows * split::kMaxSplit,
                "the merge's weights fit where p was");
  // Two CTAs an SM: 228 KB of shared memory, 1 KB of it reserved a CTA.
  static_assert(2 * (kBytes + 1024) <= 228 * 1024, "two CTAs fit an SM");
};

// 8 consecutive KT values as floats (a bf16 or int8 chunk in one load, an
// fp32 chunk in two).
template <typename KT>
__device__ __forceinline__ void load8(const KT* p, float* out) {
  if constexpr (sizeof(KT) == 4) {
    decode::load_f32<KT, 4>(p, out);
    decode::load_f32<KT, 4>(p + 4, out + 4);
  } else {
    split::load_f32<KT, 8>(p, out);
  }
}

// 2 consecutive KT values as floats (one dim pair of p.V).
template <typename KT>
__device__ __forceinline__ void load2(const KT* p, float* out) {
  if constexpr (std::is_same<KT, int8_t>::value) {
    const unsigned short u = *reinterpret_cast<const unsigned short*>(p);
    out[0] = (float)(int8_t)(u & 0xff);
    out[1] = (float)(int8_t)(u >> 8);
  } else {
    decode::load_f32<KT, 2>(p, out);
  }
}

template <typename T, typename KT, int D, typename Tiles>
__global__ void __launch_bounds__(kThreads, 2)
decode_wide_kernel(const T* __restrict__ q, const KT* cache,
                   const float* scales, const int* __restrict__ index,
                   T* __restrict__ out, int s, int H, int Hkv, int n_groups,
                   float scale, Tiles tiles) {
  using Lay = Layout<KT, D>;
  constexpr int ST = Lay::kStages;
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int NC = D / 8;   // 8-element chunks of a row
  constexpr int NP = D / 64;  // dim pairs a lane owns in p.V
  static_assert(D % 64 == 0, "whole dim pairs a lane");

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [stage]
  float* Qlo = reinterpret_cast<float*>(smem + Lay::kQ);  // [kRows][NC][4]
  float* Qhi = Qlo + kRows * D / 2;
  float* Ps = reinterpret_cast<float*>(smem + Lay::kP);
  float* Sc = reinterpret_cast<float*>(smem + Lay::kS);  // [stage][32]
  KT* ring = reinterpret_cast<KT*>(smem + Lay::kRing);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int rank = blockIdx.x;  // the cluster rank: clusters (n_split, 1, 1)
  const int n_split = gridDim.x;
  const int hk = blockIdx.y / n_groups;
  const int r_base = (blockIdx.y % n_groups) * kRows;  // this CTA's rows
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int rows = min(kRows, G * s - r_base);

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::mbar_init_fence();
  }
  tiles.begin(b, hk);
  const int idx = index[b];
  const int live_end = min(idx + s, tiles.capacity());  // exclusive
  const int n_tiles = live_end > 0 ? (live_end + kTile - 1) / kTile : 0;
  // This CTA's j-th tile is tile rank + n_split * j.
  const int my_tiles =
      rank < n_tiles ? (n_tiles - rank + n_split - 1) / n_split : 0;
  auto tile_pos = [&](int j) { return (rank + n_split * j) * kTile; };
  auto tile_n = [&](int j) { return min(kTile, live_end - tile_pos(j)); };
  auto stage = [&](int st) { return ring + (size_t)st * kTile * D; };
  // Warp 0 puts tile j into stage j % ST: its copy and, in int8, its
  // scales (0 past the tile's live count: never read there).
  auto load_tile = [&](int j) {
    const int st = j % ST, p0 = tile_pos(j), n = tile_n(j);
    tiles.fetch(p0, n, lane);
    tiles.template issue<D>(&bars[st], stage(st), cache, p0, n, lane);
    if constexpr (kQuant) {
      const size_t row = tiles.lane_row(p0, lane);
      Sc[st * kTile + lane] = lane < n ? scales[row] : 0.f;
    }
  };
  __syncthreads();  // the barriers are initialised
  if (warp == 0)
    for (int j = 0; j < ST && j < my_tiles; ++j) load_tile(j);

  // Local row r is row R = r_base + r of the kv head: (group member g =
  // R / s, query si = R % s), q head hk*G + g at position idx + si.
  // Element c of row r goes to the low or high half of its chunk.
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D, R = r_base + r;
    const T* qr = q + (((size_t)b * s + R % s) * H + hk * G + R / s) * D;
    ((c & 4) ? Qhi : Qlo)[(r * NC + c / 8) * 4 + (c & 3)] =
        to_f32(qr[c]) * scale;
  }
  __syncthreads();

  // This warp's rows: r0 .. r0 + kRowsWarp - 1 (those below `rows`).
  const int r0 = warp * kRowsWarp;
  float m[kRowsWarp], l[kRowsWarp], acc[kRowsWarp][NP][2];
#pragma unroll
  for (int rr = 0; rr < kRowsWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < NP; ++i) acc[rr][i][0] = acc[rr][i][1] = 0.f;
  }
  float* pw = Ps + warp * kRowsWarp * kTile;

  for (int j = 0; j < my_tiles; ++j) {
    const int st = j % ST;
    const uint32_t parity = (j / ST) & 1;
    const int p0 = tile_pos(j);
    const int n = tile_n(j);
    const KT* kt = stage(st);
    const float* sc_t = Sc + st * kTile;

    // sc[rr]: the logit of row r0 + rr at this lane's position p0 + lane.
    // Stage rows past n hold stale bytes; their logits are masked below.
    hopper::mbar_wait(&bars[st], parity);
    float sc[kRowsWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsWarp; ++rr) sc[rr] = 0.f;
    const KT* krow = kt + lane * D;
#pragma unroll 4
    for (int c = 0; c < NC; ++c) {
      int cc = c + lane;
      cc = cc >= NC ? cc - NC : cc;
      float kf[8];
      load8<KT>(krow + cc * 8, kf);
#pragma unroll
      for (int rr = 0; rr < kRowsWarp; ++rr) {
        if (r0 + rr < rows) {
          const float4 lo = *reinterpret_cast<const float4*>(
              Qlo + ((r0 + rr) * NC + cc) * 4);
          const float4 hi = *reinterpret_cast<const float4*>(
              Qhi + ((r0 + rr) * NC + cc) * 4);
          sc[rr] += lo.x * kf[0] + lo.y * kf[1] + lo.z * kf[2] +
                    lo.w * kf[3] + hi.x * kf[4] + hi.y * kf[5] +
                    hi.z * kf[6] + hi.w * kf[7];
        }
      }
    }

    // Online-softmax step per row over this tile.
    const int pos = p0 + lane;
    const bool in = lane < n;
#pragma unroll
    for (int rr = 0; rr < kRowsWarp; ++rr) {
      const int r = r0 + rr;
      if (r < rows) {
        float x = sc[rr];
        if constexpr (kQuant) x *= sc_t[lane];  // dequantize the logit
        const int qpos = idx + (r_base + r) % s;
        x = in && pos <= qpos ? x : kNegInf;
        const float m_new = fmaxf(m[rr], warp_max(x));
        const float p = x > 0.5f * kNegInf ? expf(x - m_new) : 0.f;
        const float alpha = expf(m[rr] - m_new);
        l[rr] = alpha * l[rr] + warp_sum(p);
        m[rr] = m_new;
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          acc[rr][i][0] *= alpha;
          acc[rr][i][1] *= alpha;
        }
        if constexpr (kQuant)
          pw[rr * kTile + lane] = p * sc_t[lane];  // fp32, not rounded
        else
          pw[rr * kTile + lane] = round_through<T>(p);
      }
    }
    __syncwarp();

    // p.V over the same stage: lane owns the dim pairs lane + 32 i.
#pragma unroll 2
    for (int j0 = 0; j0 < kTile; j0 += 4) {
      if (j0 < n) {
        float4 p4[kRowsWarp];
#pragma unroll
        for (int rr = 0; rr < kRowsWarp; ++rr)
          p4[rr] = *reinterpret_cast<const float4*>(pw + rr * kTile + j0);
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          float vf[4][2];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (j0 + e < n) {
              load2<KT>(kt + (j0 + e) * D + 2 * (lane + 32 * i), vf[e]);
            } else {
              vf[e][0] = vf[e][1] = 0.f;
            }
          }
#pragma unroll
          for (int rr = 0; rr < kRowsWarp; ++rr) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
              acc[rr][i][h] += p4[rr].x * vf[0][h] + p4[rr].y * vf[1][h] +
                               p4[rr].z * vf[2][h] + p4[rr].w * vf[3][h];
          }
        }
      }
    }
    __syncthreads();  // every warp is done with stage st and its scales
    if (warp == 0 && j + ST < my_tiles) load_tile(j + ST);
  }

  // Each row's state into shared memory (the stages are free: every copy
  // issued was waited for), then the cluster's merge.
  float* Mc = reinterpret_cast<float*>(smem + Lay::kRing);  // [kRows]
  float* Lc = Mc + kRows;                                  // [kRows]
  float* Ac = Lc + kRows;                                  // [kRows][D]
  float* Wc = Ps;  // [kRows][kMaxSplit], p is spent
#pragma unroll
  for (int rr = 0; rr < kRowsWarp; ++rr) {
    const int r = r0 + rr;
    if (r < rows) {
      if (lane == 0) {
        Mc[r] = m[rr];
        Lc[r] = l[rr];
      }
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        *reinterpret_cast<float2*>(Ac + r * D + 2 * (lane + 32 * i)) =
            make_float2(acc[rr][i][0], acc[rr][i][1]);
      }
    }
  }
  merge_cluster<T>(Mc, Lc, Ac, Wc, out, rows, r_base, b, s, H, hk, G);
}

// T q's type (bf16: the tensor-core body; fp32: the CUDA-core one); KT
// the cache's (T, or int8_t with the fp32 scales ks, one a row, null
// otherwise). D must be kD, v the same array as k (and vs as ks), with no
// window, softcap or sinks: MLA's latent. Rows (G * s) past kRows take
// more CTAs, kRows each; the split over a cluster is the split body's.
template <typename T, typename KT, typename Tiles>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* index,
                   const void* sinks, void* out, int B, int s, int H,
                   int Hkv, int D, float scale, int window, float softcap,
                   const Tiles& tiles, cudaStream_t stream) {
  if (D != kD || v != k || vs != ks || window > 0 || softcap > 0.f ||
      sinks != nullptr)
    return cudaErrorInvalidValue;
  constexpr bool kMma = std::is_same<T, bf16>::value;
  using Kernel = void (*)(const T*, const KT*, const float*, const int*, T*,
                          int, int, int, int, float, Tiles);
  Kernel kernel;
  size_t kSmem;
  if constexpr (kMma) {
    kernel = decode_wide_mma<KT, Tiles>;
    kSmem = MmaLayout<KT>::kBytes;
  } else {
    kernel = decode_wide_kernel<T, KT, kD, Tiles>;
    kSmem = Layout<KT, kD>::kBytes;
  }
  cudaError_t err;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kMma ? kMmaThreads : kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // Once per instance: the shared memory opt-in, and the clusters of each
  // size the card holds at once.
  static int clusters[split::kSplits] = {};
  static bool queried = false;
  if (!queried) {
    if ((err = allow_smem(kernel, kSmem)) != cudaSuccess) return err;
    for (int i = 0; i < split::kSplits; ++i) {
      cfg.gridDim = dim3(1 << i);
      attr[0].val.clusterDim.x = 1 << i;
      if ((err = cudaOccupancyMaxActiveClusters(&clusters[i], kernel,
                                                &cfg)) != cudaSuccess)
        return err;
    }
    queried = true;
  }
  const int n_groups = ((H / Hkv) * s + kRows - 1) / kRows;
  const int n_split =
      split::pick_split(B, Hkv * n_groups, tiles.capacity(), clusters);
  cfg.gridDim = dim3(n_split, Hkv * n_groups, B);
  attr[0].val.clusterDim.x = n_split;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const KT*>(k),
      static_cast<const float*>(ks), static_cast<const int*>(index),
      static_cast<T*>(out), s, H, Hkv, n_groups, scale, tiles);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace wide
}  // namespace shellac
