// Flash-decode over a dense head-major KV cache.
//
// q (B, s, H, D) attends cache_k/cache_v (B, Hkv, L, D), in q's dtype or
// int8 with (B, Hkv, L) fp32 scales. Position p of slot b, kv head hk, is
// row (b * Hkv + hk) * L + p, and an int8 row's scale sits at the same
// index of the scale arrays.
//
// Replaces the Pallas kernels `_dense_kernel` and `_dense_kernel_quant`
// (shellac_tpu/ops/decode_attention.py) over their tile body
// `_decode_tile`, launched by `_dense_flash`. The fp32 cache (the parity
// path) and the int8 cache run the shared warp-parallel body of
// decode_core.cuh, one 256-thread block per (slot, kv head). The bf16
// cache, which the main path runs, takes `decode_split_kernel` below.
//
// Bound on the H100: bytes (2 * live * D * 2 bytes per slot and kv head
// for ~4 flops a byte), but at a decode step's sizes mostly latency: at
// shellac-1b's generate shape (B 8, Hkv 8, 128-576 live positions) one
// block per (slot, kv head) is 64 blocks on 132 SMs, each walking its
// range in serial chunks. `decode_split_kernel` is flash-decoding's
// split-K on Hopper's clusters:
//   - the grid is (n_split, Hkv, B) with a cluster of n_split CTAs (at
//     most 8) per (slot, kv head); the host picks n_split from B, Hkv, L
//     and how many CTAs the card holds at once, never from `index`
//     (reading it would cost a sync): 4 at generate's B 8, so all 256
//     CTAs are resident together;
//   - each CTA finds its share on the device: the live range (the
//     window's first position to index + s) is cut into 32-position
//     tiles, dealt round robin to the cluster's CTAs and, within a CTA,
//     to its 4 warps; only live rows are copied, so nothing past a slot's
//     length (or before its window) is read;
//   - a slot's kv-head range is contiguous, so a tile of k (and of v) is
//     one 1-D `cp.async.bulk` (a pointer and a byte count) into the
//     warp's own shared-memory stage, completed on an mbarrier; k and v
//     complete separately, so the logits start before v lands, and the
//     next tile's k is requested as soon as the logits are done;
//   - logits on CUDA cores (~4 flops a byte: the tensor cores would buy
//     nothing). Up to 4 rows (shellac-1b's G = 2 at s = 1) keep q in
//     registers: lane l holds the 16-byte chunks l % 8 (+ 8) of every
//     row, takes them from the 8 positions of its group of 8 lanes (8
//     lanes read 8 consecutive chunks of one row: no bank conflict) and
//     the group sums each position in a transposed butterfly (4 + 2 + 1
//     shuffles), leaving position l's logit in lane l. More rows stage q
//     in shared memory and lane l walks row l's chunks in an order
//     rotated by l, so neither read conflicts though rows are 256 bytes
//     apart;
//   - softmax as the shared body does it (p rounded to bf16 before p.V, l
//     summing the unrounded p); p.V with the lanes splitting the head
//     dim over conflict-free v rows, p broadcast from shared memory;
//   - the merge stays in the launch: the 4 warps' (m, l, acc) merge in
//     shared memory, then the cluster's CTAs merge through distributed
//     shared memory (`mapa`, `ld.shared::cluster`, `barrier.cluster`),
//     each CTA writing a share of the outputs and folding in the sinks
//     as sink_rebase does. No second kernel, no global workspace, nothing
//     to reset between calls or graph replays.
#include "decode_core.cuh"
#include "hopper.cuh"

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

// ------------------------------------------------- split-K bf16 decode

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
// high halves of each 16-byte chunk of k; only for R > kRegRows), p
// ([kWarps][R][kTile]), then one stage a warp ([kWarps][k, v][kTile][D]
// bf16; two stages a warp measured slower: the shared memory then holds
// one CTA a SM), which the merge's partials reuse once every tile is
// consumed.
template <int D, int R>
struct Layout {
  static constexpr int kBars = kWarps * 2;
  static constexpr size_t kQ = 128;  // after the barriers
  static constexpr size_t kP =
      kQ + (R > kRegRows ? sizeof(float) * R * D : 0);
  static constexpr size_t kRing =
      (kP + sizeof(float) * kWarps * R * kTile + 127) / 128 * 128;
  static constexpr size_t kRingBytes =
      sizeof(bf16) * kWarps * 2 * kTile * D;
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

// Lane 0 of a warp: copy tile rows [p0, min(p0 + kTile, live_end)) of k
// (half 0) or v (half 1) into stage `st`, completing on its barrier.
template <int D>
__device__ __forceinline__ void issue_tile(uint64_t* bars, bf16* ring,
                                           const bf16* cache, size_t base,
                                           int p0, int live_end, int st,
                                           int half) {
  const uint32_t bytes = min(kTile, live_end - p0) * D * sizeof(bf16);
  uint64_t* bar = &bars[2 * st + half];
  hopper::mbar_arrive_expect_tx(bar, bytes);
  hopper::bulk_load(ring + (size_t)(2 * st + half) * kTile * D,
                    cache + (base + p0) * D, bytes, bar);
}

// Shared memory, not registers, bounds the CTAs a SM holds (three at
// 2 rows, two at 16): min-blocks 1 keeps ptxas from capping registers
// at a higher occupancy and spilling.
template <int D, int R>
__global__ void __launch_bounds__(kThreads, 1)
decode_split_kernel(const bf16* __restrict__ q,
                    const bf16* __restrict__ cache_k,
                    const bf16* __restrict__ cache_v,
                    const int* __restrict__ index,
                    const float* __restrict__ sinks, bf16* __restrict__ out,
                    int s, int H, int Hkv, int L, float scale, int window,
                    float softcap) {
  using Lay = Layout<D, R>;
  constexpr int NC = D / 8;    // 16-byte chunks of a k row
  constexpr int CPL = NC / 8;  // chunks a lane of a group of 8 owns
  constexpr int DL = D / 32;   // head dims a lane owns in p.V
  constexpr bool kQRegs = R <= kRegRows;

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [stage][k, v]
  float* Qlo = reinterpret_cast<float*>(smem + Lay::kQ);  // [R][NC][4]
  float* Qhi = Qlo + R * D / 2;
  float* Ps = reinterpret_cast<float*>(smem + Lay::kP);  // [kWarps][R][kTile]
  bf16* ring = reinterpret_cast<bf16*>(smem + Lay::kRing);

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
  const int idx = index[b];

  // Row r is (group member g = r / s, query si = r % s): q head hk*G + g
  // at position idx + si. With q in registers, lane l (l % 8 = dg) holds
  // the 16-byte chunks dg + 8 c of every row, scaled.
  auto q_row = [&](int r) {
    return q + (((size_t)b * s + r % s) * H + hk * G + r / s) * D;
  };
  float qv[kQRegs ? R : 1][CPL][8];
  if constexpr (kQRegs) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        if (r < rows) {
          decode::load_f32<bf16, 8>(q_row(r) + ((lane & 7) + 8 * c) * 8,
                                    qv[r][c]);
#pragma unroll
          for (int e = 0; e < 8; ++e) qv[r][c][e] *= scale;
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) qv[r][c][e] = 0.f;
        }
      }
    }
  }

  const int live_end = min(idx + s, L);  // exclusive
  const int first = window > 0 ? max(idx - window + 1, 0) : 0;
  const int n_tiles =
      live_end > first ? (live_end - first + kTile - 1) / kTile : 0;
  const size_t base = ((size_t)b * Hkv + hk) * L;  // row of position 0
  // This warp's j-th tile is tile rank + n_split * (warp + kWarps * j).
  const int stride = n_split * kWarps;
  const int t0 = rank + n_split * warp;
  const int my_tiles =
      t0 < n_tiles ? (n_tiles - t0 + stride - 1) / stride : 0;
  __syncthreads();  // the barriers are initialised

  // The warp's j-th tile starts at position tile_pos(j); every tile of
  // the warp passes through its one stage, `warp`.
  auto tile_pos = [&](int j) { return first + (t0 + stride * j) * kTile; };
  if (lane == 0 && my_tiles > 0) {
    issue_tile<D>(bars, ring, cache_k, base, tile_pos(0), live_end, warp, 0);
    issue_tile<D>(bars, ring, cache_v, base, tile_pos(0), live_end, warp, 1);
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
    const int n = min(kTile, live_end - p0);
    const uint32_t parity = j & 1;
    const bf16* kt = ring + (size_t)warp * 2 * kTile * D;
    const bf16* vt = kt + kTile * D;

    // sc[r]: the logit of row r at this lane's position p0 + lane. Tile
    // rows past n hold stale bytes; their logits are masked below.
    hopper::mbar_wait(&bars[2 * warp], parity);
    float sc[R];
    if constexpr (kQRegs) {
      // Lane (group pg = lane / 8, dg = lane % 8) takes its chunks of the
      // group's 8 positions (8 lanes read one row's 8 consecutive chunks:
      // no bank conflict), then the group sums position dg of each row.
      const bf16* kg = kt + (lane / 8) * 8 * D + (lane & 7) * 8;
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
          decode::load_f32<bf16, 8>(kg + i * D + c * 64, kf);
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
      // the 8 lanes of a quarter-warp read 8 different bank groups.
#pragma unroll
      for (int r = 0; r < R; ++r) sc[r] = 0.f;
      const bf16* krow = kt + lane * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int cc = (c + lane) & (NC - 1);
        float kf[8];
        decode::load_f32<bf16, 8>(krow + cc * 8, kf);
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
    if (lane == 0 && j + 1 < my_tiles)
      issue_tile<D>(bars, ring, cache_k, base, tile_pos(j + 1), live_end,
                    warp, 0);

  // Online-softmax step per row over this tile.
    const int pos = p0 + lane;
    const bool in = lane < n;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rows) {
        float x = sc[r];
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
        pw[r * kTile + lane] = round_through<bf16>(p);
      }
    }
    __syncwarp();

    // p.V: lane owns head dims [lane * DL, lane * DL + DL).
    hopper::mbar_wait(&bars[2 * warp + 1], parity);
#pragma unroll
    for (int j0 = 0; j0 < kTile; j0 += 4) {
      if (j0 < n) {
        float vf[4][DL];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (j0 + i < n) {
            decode::load_f32<bf16, DL>(vt + (j0 + i) * D + lane * DL, vf[i]);
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
    if (lane == 0 && j + 1 < my_tiles)
      issue_tile<D>(bars, ring, cache_v, base, tile_pos(j + 1), live_end,
                    warp, 1);
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

// CTAs per (slot, kv head): the largest power of two up to kMaxSplit that
// keeps all B * Hkv * n_split CTAs resident at once (`resident` a SM) and
// leaves every CTA at least one tile of the cache's capacity. From shapes
// alone, never from `index`.
inline int pick_split(int B, int Hkv, int L, int resident) {
  const long pairs = (long)B * Hkv;
  int n = 1;
  while (n < kMaxSplit && pairs * 2 * n <= resident && 2 * n * kTile <= L)
    n *= 2;
  return n;
}

template <int D, int R>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        const void* index, const void* sinks, void* out,
                        int B, int s, int H, int Hkv, int L, float scale,
                        int window, float softcap, cudaStream_t stream) {
  auto kernel = decode_split_kernel<D, R>;
  constexpr size_t kSmem = Layout<D, R>::kBytes;
  cudaError_t err;
  // Once per instance (the decode tick is bound by the host): the shared
  // memory opt-in, and the CTAs of this instance the card holds at once.
  static int resident = 0;
  if (resident == 0) {
    int per_sm = 0, sms = 0;
    if ((err = allow_smem(kernel, kSmem)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, kSmem)) != cudaSuccess ||
        (err = sm_count(&sms)) != cudaSuccess)
      return err;
    resident = (per_sm > 0 ? per_sm : 1) * sms;
  }
  const int n_split = pick_split(B, Hkv, L, resident);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(index),
      static_cast<const float*>(sinks), static_cast<bf16*>(out), s, H, Hkv,
      L, scale, window, softcap);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Rows (G * s) up to 2 (shellac-1b's decode) or up to decode::kRMax.
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* index, const void* sinks, void* out, int B,
                   int s, int H, int Hkv, int L, int D, float scale,
                   int window, float softcap, cudaStream_t stream) {
  const int rows = (H / Hkv) * s;
#define SHELLAC_SPLIT_ROWS(DD)                                               \
  if (rows <= 2)                                                             \
    return launch_rows<DD, 2>(q, k, v, index, sinks, out, B, s, H, Hkv, L,   \
                              scale, window, softcap, stream);               \
  if (rows <= decode::kRMax)                                                 \
    return launch_rows<DD, decode::kRMax>(q, k, v, index, sinks, out, B, s,  \
                                          H, Hkv, L, scale, window, softcap, \
                                          stream);                           \
  return cudaErrorInvalidValue;
  if (D == 64) { SHELLAC_SPLIT_ROWS(64) }
  if (D == 128) { SHELLAC_SPLIT_ROWS(128) }
#undef SHELLAC_SPLIT_ROWS
  return cudaErrorInvalidValue;
}

}  // namespace split
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
    return shellac::split::launch(q, k, v, index, sinks, out, B, s, H, Hkv,
                                  L, D, scale, window, softcap, st);
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
