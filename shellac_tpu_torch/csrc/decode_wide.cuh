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
// dtype before p.V (p times the row's scale in fp32 over an int8 cache,
// whose logit is the fp32 dot of the scaled q with the integer row times
// the same scale).
//
// Why not decode_split.cuh at 576: there each of a CTA's 4 warps keeps
// every row's accumulator, R x D / 32 fp32 registers a lane, and walks
// its own tiles. At 16 rows x 576 that is 288 registers a lane, past the
// 255 a thread can hold. Here the 4 warps split the ROWS instead (4 rows
// a warp, 72 accumulators a lane) and walk the SAME tiles:
//   - a CTA holds up to 16 rows; more rows (DeepSeek-V2/V3's 128 heads)
//     take more CTAs along the grid's y axis, 16 rows each, which read the
//     same latent tiles (through L2 after the first);
//   - a tile of 32 positions lands in a CTA-wide stage by 1-D
//     `cp.async.bulk` copies through the same tiles policies as the split
//     body (DenseTiles, PagedTiles), issued by warp 0; two stages in bf16
//     and int8 (the next tile lands while this one computes), one in fp32
//     (the parity path), whose stage is twice the bytes. One read of the
//     latent a step, the byte bound's count, and two CTAs an SM;
//   - logits: lane l takes position l, walks its row's 72 8-element
//     chunks in an order rotated by l (conflict-free, as the split body's
//     shared-q path) against q in shared memory (fp32, scaled, the low
//     and high halves of each chunk apart so 8 lanes read 128 contiguous
//     bytes), for its warp's 4 rows;
//   - p.V: lane l owns the 9 dim pairs l, l + 32, ..., l + 256 (pairs of
//     2 elements), so a warp reads each row of the stage as contiguous
//     words;
//   - the CTAs of a (slot, kv head, row group) form a cluster of up to 8
//     (the split body's `pick_split`), tiles dealt round robin, merged
//     through distributed shared memory; each row's state has one owner
//     warp in a CTA, so there is no merge inside the CTA, and each row's
//     weights across the cluster are computed once (a merge that re-read
//     every CTA's m and l for each of the 16 x 576 outputs took 0.0604 ms
//     a call at generate's shape on an H100, this one 0.0560).
// A __syncthreads closes each tile (the stage is free), so the warps step
// together. The bound at serve's shape (16 slots near 512 positions) is
// the latent's bytes, 9.4 MB a layer, 2.8 us at 3.35 TB/s; this body is
// far from it (PERF.md): each lane's logits read 9 16-byte words of
// shared memory a chunk (its k chunk and 4 rows of q), so the logits are
// bound by shared-memory bandwidth. The 16 q rows against one latent row
// are an m16 MMA's shape (mma.sync m16n8k16 for q.K^T and p.V), the
// redesign this body leaves for later.
#pragma once

#include <type_traits>

#include "decode_core.cuh"
#include "decode_split.cuh"
#include "hopper.cuh"

namespace shellac {
namespace wide {

constexpr int kD = 576;       // the head dim this body is built for
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;     // positions a tile: one a lane in the softmax
constexpr int kRows = 16;     // q rows (G * s) a CTA holds at most
constexpr int kRowsWarp = kRows / kWarps;

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
  // issued was waited for), then the cluster's merge through distributed
  // shared memory: one thread a row reads the CTAs' (m, l) once and keeps
  // each CTA's weight (its rescale and 1 / l folded in), then each CTA
  // writes a share of the outputs, one remote load a CTA an element.
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
  for (int i = rank * kThreads + tid; i < rows * D; i += n_split * kThreads) {
    const int r = i / D, d = i % D, R = r_base + r;
    float A = 0.f;
#pragma unroll
    for (int c = 0; c < split::kMaxSplit; ++c)
      if (c < n_split)
        A += Wc[r * split::kMaxSplit + c] *
             hopper::cluster_load(hopper::cluster_map(Ac + i, c));
    out[(((size_t)b * s + R % s) * H + hk * G + R / s) * D + d] =
        from_f32<T>(A);
  }
  hopper::cluster_sync();  // peers may still read this CTA's partials
}

// T q's type (bf16 or fp32); KT the cache's (T, or int8_t with the fp32
// scales ks, one a row, null otherwise). D must be kD, v the same array as
// k (and vs as ks), with no window, softcap or sinks: MLA's latent. Rows
// (G * s) past kRows take more CTAs, kRows each; the split over a cluster
// is the split body's.
template <typename T, typename KT, typename Tiles>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* index,
                   const void* sinks, void* out, int B, int s, int H,
                   int Hkv, int D, float scale, int window, float softcap,
                   const Tiles& tiles, cudaStream_t stream) {
  if (D != kD || v != k || vs != ks || window > 0 || softcap > 0.f ||
      sinks != nullptr)
    return cudaErrorInvalidValue;
  auto kernel = decode_wide_kernel<T, KT, kD, Tiles>;
  constexpr size_t kSmem = Layout<KT, kD>::kBytes;
  cudaError_t err;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
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
