// Split-K flash-decode over a thread-block cluster, the Hopper body of
// the dense decode over bf16 and int8 caches (kernels 5 and 6,
// decode_attention.cu) and of the paged decode over bf16 and int8 pools
// (kernel 7, paged_decode_attention.cu).
//
// q (B, s, H, D) bf16 attends one slot's kv rows, stored in bf16 or in
// int8 (KT = int8_t) with one fp32 scale per (position, kv head). The
// semantics are decode_core.cuh's (the JAX `_decode_tile`): the GQA rows
// of a kv head (G * s, kv-head-major) share every k/v row read; only the
// live range, the window's first live position to index + s, is read;
// softcap before the mask; fp32 online softmax with p rounded to bf16
// before p.V in bf16, and in int8 the logit is the fp32 dot of the
// scaled q with the integer k row times ks[pos] (then softcap and mask),
// p times vs[pos] stays fp32 before p.V over the integer v row, and l
// sums the unscaled p; sinks folded in at the end as sink_rebase does.
//
// Bound on the H100: bytes (the live k/v rows, ~4 flops a byte in bf16,
// ~8 in int8), but at a decode step's sizes mostly latency: one block
// per (slot, kv head) walking its range in serial chunks leaves most SMs
// idle. Flash-decoding's split-K on Hopper's clusters:
//   - the grid is (n_split, Hkv, B) with a cluster of n_split CTAs (at
//     most 8) per (slot, kv head); the host picks n_split from B, Hkv,
//     the capacity and how many clusters of the instance the card holds
//     at once, never from `index` or a block table (reading them would
//     cost a sync);
//   - each CTA finds its share on the device: the live range is cut into
//     32-position tiles, dealt round robin to the cluster's CTAs and,
//     within a CTA, to its 4 warps; only live rows are copied, so nothing
//     past a slot's length (or before its window) is read;
//   - a tile of k (and of v) lands in the warp's own shared-memory stage
//     by 1-D `cp.async.bulk` copies (a pointer and a byte count),
//     completed on an mbarrier; a tiles policy (`Tiles`) says where the
//     tile's rows live and issues the copies: one copy for a dense
//     cache, one per page segment for a paged pool (see DenseTiles and
//     PagedTiles). k and v complete separately, so the logits start
//     before v lands, and the next tile's k is requested as soon as the
//     logits are done. An int8 tile's scales are ordinary per-lane loads
//     (lane = position), issued with its k copy;
//   - logits on CUDA cores (the tensor cores would buy nothing at these
//     flops a byte). Up to 4 rows keep q in registers: lane l holds the
//     8-element chunks l % 8 (+ 8) of every row, takes them from the 8
//     positions of its group of 8 lanes and the group sums each position
//     in a transposed butterfly (4 + 2 + 1 shuffles), leaving position
//     l's logit in lane l. A bf16 chunk is 16 bytes, so a group reads 128
//     contiguous bytes of one row in a quarter-warp: no bank conflict. An
//     int8 chunk is 8 bytes and a half-warp's two groups read rows 1 KB
//     apart, so at D 128 the odd groups walk their two chunks in the
//     other order. More rows stage q in shared memory and lane l walks
//     row l's chunks in an order rotated by l;
//   - p.V with the lanes splitting the head dim over conflict-free v
//     rows, p (bf16-rounded, or p * vs in fp32) broadcast from shared
//     memory. Stage rows past a tile's live count hold stale bytes (or
//     anything at all): their logits and v rows are selected away, never
//     multiplied by 0;
//   - the merge stays in the launch: the 4 warps' (m, l, acc) merge in
//     shared memory, then the cluster's CTAs merge through distributed
//     shared memory (`mapa`, `ld.shared::cluster`, `barrier.cluster`),
//     each CTA writing a share of the outputs and folding in the sinks.
//     No second kernel, no global workspace, nothing to reset between
//     calls or graph replays.
//
// A tiles policy answers, for the block's (slot, kv head):
//   int capacity()                       positions a slot can address;
//   void begin(b, hk)                    once, before the first tile;
//   void fetch(p0, n, lane)              the whole warp, one tile ahead
//                                        of its copies: the addressing
//                                        the tile's copies need (the
//                                        paged policy's page ids);
//   void issue<D>(bar, dst, src, p0, n, lane)
//                                        the whole warp: copy rows
//                                        [p0, p0 + n) of the fetched tile
//                                        into dst, completing on bar;
//   size_t lane_row(p0, lane)            the whole warp: the row of
//                                        position p0 + lane in the
//                                        fetched tile, which is also the
//                                        index of its int8 scale.
#pragma once

#include <type_traits>

#include "decode_core.cuh"
#include "hopper.cuh"

namespace shellac {
namespace split {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;     // positions a tile: one a lane in the softmax
constexpr int kMaxSplit = 8;  // CTAs a cluster (the portable limit)
// Rows up to this many keep their q in registers (the logits split the
// head dim over the lanes); more rows read q from shared memory.
constexpr int kRegRows = 4;

// Shared memory: barriers, q (fp32, scaled, [2][R][D / 8][4]: the low and
// high halves of each 8-element chunk of k; only for R > kRegRows), p
// ([kWarps][R][kTile]), then one stage a warp ([kWarps][k, v][kTile][D]
// of KT; two stages a warp measured slower in bf16: the shared memory
// then holds one CTA a SM), which the merge's partials reuse once every
// tile is consumed.
template <typename KT, int D, int R>
struct Layout {
  static constexpr int kBars = kWarps * 2;
  static constexpr size_t kQ = 128;  // after the barriers
  static constexpr size_t kP =
      kQ + (R > kRegRows ? sizeof(float) * R * D : 0);
  static constexpr size_t kRing =
      (kP + sizeof(float) * kWarps * R * kTile + 127) / 128 * 128;
  static constexpr size_t kRingBytes = sizeof(KT) * kWarps * 2 * kTile * D;
  // Warp partials [kWarps][R] m, l and [kWarps][R][D] acc, then the CTA's
  // [R] m, l and [R][D] acc.
  static constexpr size_t kMergeBytes =
      sizeof(float) * (kWarps + 1) * R * (D + 2);
  static constexpr size_t kBytes =
      kRing + (kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes);
  static_assert(kBars * 8 <= kQ, "barriers fit before q");
};

// Of 8 partial sums a lane holds (one a position of its group of 8), sum
// position `lane % 8` over the 8 lanes of the group: a transposed
// butterfly, 4 + 2 + 1 shuffles where 8 separate sums would take 24.
__device__ __forceinline__ float group8_sum(const float* part, int lane) {
  const bool h4 = lane & 4, h2 = lane & 2, h1 = lane & 1;
  float a[4], c[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = (h4 ? part[4 + i] : part[i]) +
           __shfl_xor_sync(0xffffffffu, h4 ? part[i] : part[4 + i], 4);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    c[i] = (h2 ? a[2 + i] : a[i]) +
           __shfl_xor_sync(0xffffffffu, h2 ? a[i] : a[2 + i], 2);
  return (h1 ? c[1] : c[0]) +
         __shfl_xor_sync(0xffffffffu, h1 ? c[0] : c[1], 1);
}

// Load N consecutive KT values into floats. int8 takes the full-rate
// pipes instead of I2F (a quarter of the FMA rate on this card, and the
// int8 body converts as many values as it multiplies): each byte biased
// by 128 (xor 0x80) goes under the exponent of 2^23 (prmt), and 2^23 +
// 128 is subtracted, exactly.
template <typename KT, int N>
__device__ __forceinline__ void load_f32(const KT* p, float* out) {
  if constexpr (std::is_same<KT, int8_t>::value) {
    uint32_t w[(N + 3) / 4];
    if constexpr (N == 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x;
      w[1] = u.y;
    } else if constexpr (N == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      static_assert(N == 2, "int8 loads of 2, 4 or 8 values");
      w[0] = *reinterpret_cast<const unsigned short*>(p);
    }
#pragma unroll
    for (int i = 0; i < N; ++i)
      out[i] = __uint_as_float(__byte_perm(w[i / 4] ^ 0x80808080u,
                                           0x4B000000u, 0x7540 + i % 4)) -
               8388736.f;
  } else {
    decode::load_f32<KT, N>(p, out);
  }
}

// Shared memory bounds the CTAs a SM holds in bf16: min-blocks 1 keeps
// ptxas from capping registers at a higher occupancy and spilling. The
// int8 stage is half the size, so registers bound it instead: at up to
// kRegRows rows, 5 CTAs a SM (at most 102 registers) let serve-int8's 128
// clusters of 4 run at once (at 4 a SM the card holds 124 such
// clusters), where bf16's split is 2; the dense int8 instances (kernel 6)
// take the same bounds.
template <typename KT, int D, int R, typename Tiles>
__global__ void __launch_bounds__(
    kThreads, std::is_same<KT, int8_t>::value && R <= kRegRows ? 5 : 1)
decode_split_kernel(const bf16* __restrict__ q, const KT* __restrict__ cache_k,
                    const KT* __restrict__ cache_v,
                    const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ index,
                    const float* __restrict__ sinks, bf16* __restrict__ out,
                    int s, int H, int Hkv, float scale, int window,
                    float softcap, Tiles tiles) {
  using Lay = Layout<KT, D, R>;
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int NC = D / 8;    // 8-element chunks of a k row
  constexpr int CPL = NC / 8;  // chunks a lane of a group of 8 owns
  constexpr int DL = D / 32;   // head dims a lane owns in p.V
  constexpr bool kQRegs = R <= kRegRows;
  // int8 at D 128: the odd groups of 8 walk their two chunks reversed.
  constexpr bool kRot = kQuant && CPL == 2;

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [stage][k, v]
  float* Qlo = reinterpret_cast<float*>(smem + Lay::kQ);  // [R][NC][4]
  float* Qhi = Qlo + R * D / 2;
  float* Ps = reinterpret_cast<float*>(smem + Lay::kP);  // [kWarps][R][kTile]
  KT* ring = reinterpret_cast<KT*>(smem + Lay::kRing);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int rank = blockIdx.x;  // the cluster rank: clusters (n_split, 1, 1)
  const int n_split = gridDim.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int rows = G * s;

  if (tid == 0) {
    for (int i = 0; i < Lay::kBars; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::mbar_init_fence();
  }
  tiles.begin(b, hk);
  const int idx = index[b];

  // Row r is (group member g = r / s, query si = r % s): q head hk*G + g
  // at position idx + si. With q in registers, lane l (l % 8 = dg) holds
  // the chunks dg + 8 c of every row (c in the group's order), scaled.
  auto q_row = [&](int r) {
    return q + (((size_t)b * s + r % s) * H + hk * G + r / s) * D;
  };
  auto chunk = [&](int c) {  // the chunk lane's c-th step reads
    return (lane & 7) + 8 * (kRot ? (c + (lane >> 3)) & 1 : c);
  };
  float qv[kQRegs ? R : 1][CPL][8];
  if constexpr (kQRegs) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        if (r < rows) {
          decode::load_f32<bf16, 8>(q_row(r) + chunk(c) * 8, qv[r][c]);
#pragma unroll
          for (int e = 0; e < 8; ++e) qv[r][c][e] *= scale;
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) qv[r][c][e] = 0.f;
        }
      }
    }
  }

  const int live_end = min(idx + s, tiles.capacity());  // exclusive
  const int first = window > 0 ? max(idx - window + 1, 0) : 0;
  const int n_tiles =
      live_end > first ? (live_end - first + kTile - 1) / kTile : 0;
  // This warp's j-th tile is tile rank + n_split * (warp + kWarps * j).
  const int stride = n_split * kWarps;
  const int t0 = rank + n_split * warp;
  const int my_tiles =
      t0 < n_tiles ? (n_tiles - t0 + stride - 1) / stride : 0;
  __syncthreads();  // the barriers are initialised

  // The warp's j-th tile starts at position tile_pos(j) and holds
  // tile_n(j) live rows; every tile of the warp passes through its one
  // stage, `warp`.
  auto tile_pos = [&](int j) { return first + (t0 + stride * j) * kTile; };
  auto tile_n = [&](int j) { return min(kTile, live_end - tile_pos(j)); };
  KT* kt = ring + (size_t)warp * 2 * kTile * D;
  KT* vt = kt + kTile * D;
  uint64_t* kbar = &bars[2 * warp];
  uint64_t* vbar = &bars[2 * warp + 1];
  // int8: the scales of this lane's position in the current tile and in
  // the next (0 past the tile's live count: never read there).
  float ksc = 0.f, vsc = 0.f, ksn = 0.f, vsn = 0.f;
  auto load_scales = [&](int p0, int n) {
    const size_t row = tiles.lane_row(p0, lane);
    ksn = lane < n ? ks[row] : 0.f;
    vsn = lane < n ? vs[row] : 0.f;
  };
  if (my_tiles > 0) {
    tiles.fetch(tile_pos(0), tile_n(0), lane);
    tiles.template issue<D>(kbar, kt, cache_k, tile_pos(0), tile_n(0), lane);
    tiles.template issue<D>(vbar, vt, cache_v, tile_pos(0), tile_n(0), lane);
    if constexpr (kQuant) load_scales(tile_pos(0), tile_n(0));
  }

  if constexpr (!kQRegs) {
    // Element c of row r goes to the low or high half of its k chunk.
    for (int i = tid; i < rows * D; i += kThreads) {
      const int r = i / D, c = i % D;
      ((c & 4) ? Qhi : Qlo)[(r * NC + c / 8) * 4 + (c & 3)] =
          to_f32(q_row(r)[c]) * scale;
    }
    __syncthreads();
  }

  float m[R], l[R], acc[R][DL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[r][e] = 0.f;
  }
  float* pw = Ps + warp * R * kTile;

  for (int j = 0; j < my_tiles; ++j) {
    const int p0 = tile_pos(j);
    const int n = tile_n(j);
    const bool more = j + 1 < my_tiles;
    const uint32_t parity = j & 1;
    // The next tile's addressing is read while this one computes.
    if (more) tiles.fetch(tile_pos(j + 1), tile_n(j + 1), lane);
    if constexpr (kQuant) {
      ksc = ksn;
      vsc = vsn;
    }

    // sc[r]: the logit of row r at this lane's position p0 + lane. Tile
    // rows past n hold stale bytes; their logits are masked below.
    hopper::mbar_wait(kbar, parity);
    float sc[R];
    if constexpr (kQRegs) {
      // Lane (group pg = lane / 8, dg = lane % 8) takes its chunks of the
      // group's 8 positions, then the group sums position dg of each row.
      const KT* kg = kt + (lane / 8) * 8 * D;
      float part[R][8];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < 8; ++i) part[r][i] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          float kf[8];
          load_f32<KT, 8>(kg + i * D + chunk(c) * 8, kf);
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (r < rows)
#pragma unroll
              for (int e = 0; e < 8; ++e) part[r][i] += qv[r][c][e] * kf[e];
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < rows) sc[r] = group8_sum(part[r], lane);
    } else {
      // Lane j walks its own k row's chunks in an order rotated by j, so
      // the lanes of a load phase read different bank groups.
#pragma unroll
      for (int r = 0; r < R; ++r) sc[r] = 0.f;
      const KT* krow = kt + lane * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int cc = (c + lane) & (NC - 1);
        float kf[8];
        load_f32<KT, 8>(krow + cc * 8, kf);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < rows) {
            const float4 lo =
                *reinterpret_cast<const float4*>(Qlo + (r * NC + cc) * 4);
            const float4 hi =
                *reinterpret_cast<const float4*>(Qhi + (r * NC + cc) * 4);
            sc[r] += lo.x * kf[0] + lo.y * kf[1] + lo.z * kf[2] +
                     lo.w * kf[3] + hi.x * kf[4] + hi.y * kf[5] +
                     hi.z * kf[6] + hi.w * kf[7];
          }
        }
      }
    }
    __syncwarp();  // k is read: the next tile's k may land in the stage
    if (more) {
      tiles.template issue<D>(kbar, kt, cache_k, tile_pos(j + 1),
                              tile_n(j + 1), lane);
      if constexpr (kQuant) load_scales(tile_pos(j + 1), tile_n(j + 1));
    }

    // Online-softmax step per row over this tile.
    const int pos = p0 + lane;
    const bool in = lane < n;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rows) {
        float x = sc[r];
        if constexpr (kQuant) x *= ksc;  // dequant before softcap
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const int qpos = idx + r % s;
        bool ok = in && pos <= qpos;
        if (window > 0) ok = ok && qpos - pos < window;
        x = ok ? x : kNegInf;
        const float m_new = fmaxf(m[r], warp_max(x));
        const float p = x > 0.5f * kNegInf ? expf(x - m_new) : 0.f;
        const float alpha = expf(m[r] - m_new);
        l[r] = alpha * l[r] + warp_sum(p);
        m[r] = m_new;
#pragma unroll
        for (int e = 0; e < DL; ++e) acc[r][e] *= alpha;
        if constexpr (kQuant)
          pw[r * kTile + lane] = p * vsc;  // fp32, not rounded
        else
          pw[r * kTile + lane] = round_through<bf16>(p);
      }
    }
    __syncwarp();

    // p.V: lane owns head dims [lane * DL, lane * DL + DL).
    hopper::mbar_wait(vbar, parity);
#pragma unroll
    for (int j0 = 0; j0 < kTile; j0 += 4) {
      if (j0 < n) {
        float vf[4][DL];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (j0 + i < n) {
            load_f32<KT, DL>(vt + (j0 + i) * D + lane * DL, vf[i]);
          } else {
#pragma unroll
            for (int e = 0; e < DL; ++e) vf[i][e] = 0.f;
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < rows) {
            const float4 p4 =
                *reinterpret_cast<const float4*>(pw + r * kTile + j0);
#pragma unroll
            for (int e = 0; e < DL; ++e)
              acc[r][e] += p4.x * vf[0][e] + p4.y * vf[1][e] +
                           p4.z * vf[2][e] + p4.w * vf[3][e];
          }
        }
      }
    }
    __syncwarp();  // v and p are read
    if (more)
      tiles.template issue<D>(vbar, vt, cache_v, tile_pos(j + 1),
                              tile_n(j + 1), lane);
  }

  // Merge the warps' states in shared memory (the ring is free: every
  // copy issued was waited for).
  __syncthreads();
  float* Mw = reinterpret_cast<float*>(smem + Lay::kRing);  // [kWarps][R]
  float* Lw = Mw + kWarps * R;                             // [kWarps][R]
  float* Aw = Lw + kWarps * R;                             // [kWarps][R][D]
  float* Mc = Aw + kWarps * R * D;                         // [R]
  float* Lc = Mc + R;                                      // [R]
  float* Ac = Lc + R;                                      // [R][D]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < rows) {
      if (lane == 0) {
        Mw[warp * R + r] = m[r];
        Lw[warp * R + r] = l[r];
      }
#pragma unroll
      for (int e = 0; e < DL; ++e)
        Aw[(warp * R + r) * D + lane * DL + e] = acc[r][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, Mw[w * R + r]);
    float Ls = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(Mw[w * R + r] - M);
      Ls += Lw[w * R + r] * f;
      A += Aw[(w * R + r) * D + d] * f;
    }
    Ac[i] = A;
    if (d == 0) {
      Mc[r] = M;
      Lc[r] = Ls;
    }
  }

  // Merge the cluster's CTAs through distributed shared memory; each CTA
  // writes a share of the outputs.
  hopper::cluster_sync();
  for (int i = rank * kThreads + tid; i < rows * D; i += n_split * kThreads) {
    const int r = i / D, d = i % D;
    float M = kNegInf;
    for (int c = 0; c < n_split; ++c)
      M = fmaxf(M, hopper::cluster_load(hopper::cluster_map(Mc + r, c)));
    float Ls = 0.f, A = 0.f;
    for (int c = 0; c < n_split; ++c) {
      const float f =
          expf(hopper::cluster_load(hopper::cluster_map(Mc + r, c)) - M);
      Ls += hopper::cluster_load(hopper::cluster_map(Lc + r, c)) * f;
      A += hopper::cluster_load(hopper::cluster_map(Ac + i, c)) * f;
    }
    const int g = r / s, si = r % s;
    const int head = hk * G + g;
    float rr = 1.f, denom;
    if (sinks != nullptr) {
      const float sk = sinks[head];
      const float m2 = fmaxf(M, sk);
      rr = expf(M - m2);
      denom = Ls * rr + expf(sk - m2);
    } else {
      denom = Ls == 0.f ? 1.f : Ls;
    }
    out[(((size_t)b * s + si) * H + head) * D + d] =
        from_f32<bf16>(A * rr / denom);
  }
  hopper::cluster_sync();  // peers may still read this CTA's partials
}

// Cluster sizes the split takes: 1, 2, 4 and 8 CTAs.
constexpr int kSplits = 4;

// CTAs per (slot, kv head): the largest power of two up to kMaxSplit
// whose B * Hkv clusters the card holds all at once (`clusters[i]` for
// clusters of 2^i CTAs: a cluster's CTAs share a GPC, so this is fewer
// than the resident CTAs over the cluster size) and that leaves every
// CTA at least one tile of the slot's capacity. From shapes alone, never
// from `index` or a block table.
inline int pick_split(int B, int Hkv, int capacity, const int* clusters) {
  const long pairs = (long)B * Hkv;
  int n = 1;
  for (int i = 1; i < kSplits && pairs <= clusters[i] &&
                  2 * n * kTile <= capacity;
       ++i)
    n *= 2;
  return n;
}

template <typename KT, int D, int R, typename Tiles>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        const void* ks, const void* vs, const void* index,
                        const void* sinks, void* out, int B, int s, int H,
                        int Hkv, float scale, int window, float softcap,
                        const Tiles& tiles, cudaStream_t stream) {
  auto kernel = decode_split_kernel<KT, D, R, Tiles>;
  constexpr size_t kSmem = Layout<KT, D, R>::kBytes;
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
  // Once per instance (the decode tick is bound by the host): the shared
  // memory opt-in, and the clusters of each size the card holds at once.
  static int clusters[kSplits] = {};
  static bool queried = false;
  if (!queried) {
    if ((err = allow_smem(kernel, kSmem)) != cudaSuccess) return err;
    for (int i = 0; i < kSplits; ++i) {
      cfg.gridDim = dim3(1 << i);
      attr[0].val.clusterDim.x = 1 << i;
      if ((err = cudaOccupancyMaxActiveClusters(&clusters[i], kernel,
                                                &cfg)) != cudaSuccess)
        return err;
    }
    queried = true;
  }
  const int n_split = pick_split(B, Hkv, tiles.capacity(), clusters);
  cfg.gridDim = dim3(n_split, Hkv, B);
  attr[0].val.clusterDim.x = n_split;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(index),
      static_cast<const float*>(sinks), static_cast<bf16*>(out), s, H, Hkv,
      scale, window, softcap, tiles);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// q bf16; KT bf16 (ks, vs null) or int8_t. Rows (G * s) up to 2
// (shellac-1b's decode) or up to decode::kRMax; D 64 or 128.
template <typename KT, typename Tiles>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* index,
                   const void* sinks, void* out, int B, int s, int H,
                   int Hkv, int D, float scale, int window, float softcap,
                   const Tiles& tiles, cudaStream_t stream) {
  const int rows = (H / Hkv) * s;
#define SHELLAC_SPLIT_ROWS(DD)                                              \
  if (rows <= 2)                                                            \
    return launch_rows<KT, DD, 2>(q, k, v, ks, vs, index, sinks, out, B, s, \
                                  H, Hkv, scale, window, softcap, tiles,    \
                                  stream);                                  \
  if (rows <= decode::kRMax)                                                \
    return launch_rows<KT, DD, decode::kRMax>(q, k, v, ks, vs, index, sinks, \
                                              out, B, s, H, Hkv, scale,     \
                                              window, softcap, tiles,       \
                                              stream);                      \
  return cudaErrorInvalidValue;
  if (D == 64) { SHELLAC_SPLIT_ROWS(64) }
  if (D == 128) { SHELLAC_SPLIT_ROWS(128) }
#undef SHELLAC_SPLIT_ROWS
  return cudaErrorInvalidValue;
}

}  // namespace split
}  // namespace shellac
