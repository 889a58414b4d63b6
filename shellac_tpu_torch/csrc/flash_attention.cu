// Flash-attention forward over q (B, S, H, D), k/v (B, S, Hkv, D).
//
// Replaces the Pallas kernel `_flash_kernel` (shellac_tpu/ops/
// flash_attention.py), launched by `_flash_forward`, for serving and for
// training: causal or not, sliding window, Gemma-2 softcap, GPT-OSS sinks,
// GQA, packed segments (one (B, S) int32 row shared by q and kv, as
// `_scores` masks them), and the logsumexp rows (B, H, S) fp32 the
// backward kernels read (sink-inclusive, natural log, as `_flash_kernel`'s
// finalizer writes them). The serving calls pass no segments and no lse
// pointer, and nothing is written there.
//
// What it keeps from the TPU kernel: the online softmax with m, l and the
// output accumulator in fp32; softcap before the causal, window and
// segment masks; the fully-masked-tile gate (p = 0 where s is the NEG_INF
// sentinel, so a tile no row can see leaves the accumulator untouched);
// p rounded to v's dtype before the p.V product while l sums the
// unrounded p; sinks folded in at the end as sink_rebase does; kv tiles
// outside [first live tile of the window, causal diagonal] neither loaded
// nor computed (`_make_clamp_ki`); GQA through kv head h / G.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s): at the
// training shape (6 x 2048, H 16, D 128, causal, with lse) the
// operations, 0.104 ms; at generate's prefill (8 x 512) the bytes of q,
// k, v and out, 0.015 ms. So the bf16 body is built to keep the tensor
// cores fed (wgmma, fed by TMA, with the softmax hidden behind it), and
// to pay the fixed cost of a q tile (its loads, its epilogue) once per
// SM rather than once per tile. Two bodies:
//
//   - bf16, `flash_fwd_wgmma`, a persistent kernel: one CTA an SM (at
//     most), each walking work tiles of (q head, batch, 128-row q tile)
//     from a longest-first list (under the causal mask q tile qt reads
//     qt + 1 kv tiles) in a snake order, so the CTAs finish together.
//     Three warpgroups. Warpgroup 2 is the producer: it drops to 24
//     registers (setmaxnreg) and one thread starts TMA loads: each work
//     tile's q into one of two q buffers (the next tile's q arrives
//     while this one's epilogue runs), and the live kv tiles (128 rows)
//     into a ring of K and V stages (2 at D 128, 3 at D 64) with a full
//     and an empty mbarrier each for K and for V. Warpgroups 0 and 1
//     are consumers of 64 q rows each at 240 registers. S = Q K^T is a
//     wgmma m64n128k16 with both operands in shared memory (K-major);
//     the online softmax runs on the accumulator fragments in base 2
//     (scale * log2(e) folded into one multiply, ex2 on the SFU); p is
//     re-packed in registers to bf16 as the A operand of O += P V, a
//     wgmma with V read MN-major through its descriptor (no transposed
//     copy). As in FlashAttention-3, the products of kv tile i overlap
//     the softmax: S_i starts with P_{i-1} V_{i-1}, and the softmax of
//     S_i runs while the second product completes (intra-warpgroup
//     overlap); and two named barriers hand the tensor cores from one
//     consumer to the other (ping-pong), so one warpgroup's softmax runs
//     under the other's products. K is released after the softmax that
//     read it, V after its product. Every mbarrier wait sits before the
//     wgmmas it feeds start: a wait loop while a wgmma is in flight
//     makes ptxas serialize the wgmmas (warning C7520). All tiles are
//     128-byte swizzled (q, k, v as TMA leaves them, out as the TMA
//     store reads it), so neither the wgmma reads nor the epilogue's
//     shared stores conflict on banks. Only boundary tiles (the causal
//     diagonal, a window edge, the ragged tail, a segment boundary) run
//     the per-score compares; every other tile is mask-free. The
//     epilogue writes O through the work tile's q buffer and one TMA
//     store per panel; rows past S are neither loaded (TMA fills zeros)
//     nor stored. Shared memory: two q tiles and the ring, 192 KB at D
//     128 (2 x 32 + 2 x (32 + 32)), 128 KB at D 64 (2 x 16 + 3 x (16 +
//     16)), 192 KB at D 192 (MLA's expanded prefill, q and k 192 wide, v
//     padded to 192: 2 x 48 + 1 x (48 + 48), a ring of ONE stage, where
//     K_i loads while V_{i-1} is read and V_i once P_{i-1} V_{i-1} is
//     done; P V there is three n64 wgmmas a 16-row step, one a panel);
//     registers 168 a thread at launch, then 2 x 128 x 240 + 128 x 24 =
//     64,512; no spills (`ptxas -v`).
//     Left for later: a 64-row q tile for grids that fill few of the 132
//     SMs (serve's B = 1 admissions run 128 work tiles), a dynamic tile
//     scheduler, K and V multicast to both q heads of a GQA pair in a
//     cluster, and fp8.
//   - fp32: scalar fp32 FMAs over a 4x4 register tile per thread (the
//     tensor cores would round fp32 inputs to tf32); the parity path,
//     with its own 64 x 64 tiles and plain loads.
#include <cuda.h>

#include "common.cuh"
#include "hopper.cuh"

namespace shellac {
namespace {

constexpr int kF32Threads = 256;  // 16 x 16 thread grid over a tile
constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // kv rows per tile

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1)      // Qs, padded rows
                          + D * (kBK + 1)    // Kt, transposed, padded
                          + kBK * D          // Vs
                          + kBQ * (kBK + 1)  // Ps, padded rows
                          + kBK              // kv segment ids
                         );
}

// fp32 body: scalar FMAs, 4 q rows x 4 kv columns (then x D/16 output
// dims) per thread. SEG: segment masking is compiled in (the serving
// calls, which pass no segments, run the instance without it).
template <int D, bool SEG>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ sinks,
              const int* __restrict__ seg, float* __restrict__ out,
              float* __restrict__ lse, int S, int H, int Hkv, float scale,
              int causal, int window, float softcap) {
  constexpr int RQ = kBQ / 16;  // q rows per thread
  constexpr int CK = kBK / 16;  // kv columns per thread in the score tile
  constexpr int DV = D / 16;    // output dims per thread
  constexpr int QS = D + 1;
  constexpr int KS = kBK + 1;
  constexpr int PS = kBK + 1;

  extern __shared__ float smem[];
  float* Qs = smem;            // [kBQ][QS]
  float* Kt = Qs + kBQ * QS;   // [D][KS]
  float* Vs = Kt + D * KS;     // [kBK][D]
  float* Ps = Vs + kBK * D;    // [kBQ][PS]
  int* Kseg = reinterpret_cast<int*>(Ps + kBQ * PS);  // [kBK]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const size_t qstride = (size_t)H * D;  // between positions
  const size_t kstride = (size_t)Hkv * D;
  const float* qb = q + (size_t)b * S * qstride + (size_t)h * D;
  const float* kb = k + (size_t)b * S * kstride + (size_t)hk * D;
  const float* vb = v + (size_t)b * S * kstride + (size_t)hk * D;

  for (int i = tid; i < kBQ * D; i += kF32Threads) {
    const int r = i / D, c = i % D;
    const int pos = q0 + r;
    Qs[r * QS + c] =
        pos < S ? qb[(size_t)pos * qstride + c] * scale : 0.f;
  }

  const int* segb = SEG ? seg + (size_t)b * S : nullptr;
  float m_i[RQ], l_i[RQ], acc[RQ][DV];
  int qseg[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    qseg[i] = SEG && row < S ? segb[row] : 0;
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DV; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = (S + kBK - 1) / kBK;
  int kt_last = n_tiles - 1;
  if (causal) kt_last = min(kt_last, (q0 + kBQ - 1) / kBK);
  const int kt_first = window > 0 ? max(q0 - window + 1, 0) / kBK : 0;

  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's Kt/Vs/Ps are consumed
    for (int i = tid; i < kBK * D; i += kF32Threads) {
      const int r = i / D, c = i % D;
      const int pos = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (pos < S) {
        kv = kb[(size_t)pos * kstride + c];
        vv = vb[(size_t)pos * kstride + c];
      }
      Kt[c * KS + r] = kv;
      Vs[r * D + c] = vv;
    }
    if (SEG && tid < kBK) Kseg[tid] = k0 + tid < S ? segb[k0 + tid] : -1;
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty * RQ + i) * QS + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = Kt[d * KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = q0 + ty * RQ + i;
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = col < S;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && row - col < window;
        if (SEG) ok = ok && qseg[i] == Kseg[tx + 16 * j];
        s[i][j] = ok ? x : kNegInf;
        mc = fmaxf(mc, s[i][j]);
      }
      // Reduce over the 16 lanes that share this row (one half-warp).
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, o));
      const float m_new = fmaxf(m_i[i], mc);
      const float alpha = expf(m_i[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p =
            s[i][j] > 0.5f * kNegInf ? expf(s[i][j] - m_new) : 0.f;
        ps += p;
        Ps[(ty * RQ + i) * PS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l_i[i] = alpha * l_i[i] + ps;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < DV; ++j) acc[i][j] *= alpha;
    }
    // A row's p values come from the 16 lanes of its own half-warp.
    __syncwarp();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[RQ], vv[DV];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = Ps[(ty * RQ + i) * PS + c];
#pragma unroll
      for (int j = 0; j < DV; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < DV; ++j) acc[i][j] += pv[i] * vv[j];
    }
  }

  float* ob = out + (size_t)b * S * qstride + (size_t)h * D;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    if (row >= S) continue;
    float r = 1.f, denom, m_fin = m_i[i];
    if (sinks != nullptr) {
      const float sk = sinks[h];
      const float m2 = fmaxf(m_i[i], sk);
      r = expf(m_i[i] - m2);
      denom = l_i[i] * r + expf(sk - m2);
      m_fin = m2;
    } else {
      denom = l_i[i] == 0.f ? 1.f : l_i[i];
    }
#pragma unroll
    for (int j = 0; j < DV; ++j)
      ob[(size_t)row * qstride + tx + 16 * j] =
          acc[i][j] * r / denom;
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * H + h) * S + row] = m_fin + logf(denom);
  }
}


// ------------------------------------------------------------ bf16 body

constexpr int kBM = 128;           // q rows per work tile: two consumers x 64
constexpr int kBN = 128;           // kv rows per tile
constexpr int kWgThreads = 384;    // consumers: warpgroups 0, 1; producer 2
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
constexpr int kPanelBytesPerRow = 128;  // 64 bf16: one swizzled panel row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Byte offsets into the CTA's dynamic shared memory (1024-aligned base).
template <int D>
struct Smem {
  static constexpr int kPanels = D / 64;
  static constexpr int kStages = D == 64 ? 3 : D == 128 ? 2 : 1;
  static constexpr int kQBytes = kBM * D * 2;   // a q tile, later out
  static constexpr int kKVBytes = kBN * D * 2;  // one K or one V tile
  static constexpr int kQ = 0;                  // two q tiles
  static constexpr int kK = kQ + 2 * kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kSeg = kV + kStages * kKVBytes;  // [stage][kBN] int
  static constexpr int kKInfo = kSeg + kStages * kBN * 4;  // [stage] int2
  static constexpr int kQInfo = kKInfo + kStages * 8;  // [2][2] int2
  // mbarriers: q_full[2], q_empty[2], then per stage full_k, full_v,
  // empty_k, empty_v.
  static constexpr int kBar = kQInfo + 4 * 8;
  static constexpr int kBytes = kBar + (4 + 4 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

// S = Q K^T (one 64 x 128 accumulator tile) for this consumer warpgroup.
template <int D>
__device__ __forceinline__ void qk_tile(float* s, const unsigned char* qs,
                                        const unsigned char* ks) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // 16 head dims are 32 bytes inside one 128-byte swizzled row.
    const int off = (kk % 4) * 32;
    const uint64_t da =
        smem_desc(qs + (kk / 4) * kBM * kPanelBytesPerRow + off, 16, 1024);
    const uint64_t db =
        smem_desc(ks + (kk / 4) * kBN * kPanelBytesPerRow + off, 16, 1024);
    wgmma_ss_n128(s, da, db, kk > 0);
  }
}

// O += P V for this consumer warpgroup: P the bf16 A fragments, V read
// MN-major (16 kv rows per step; the D columns span D / 64 panels, kBN
// rows apart). D 192 takes one n64 product a panel, into the panel's 32
// accumulators (the fragment of 8-column block j is o[4 j .. 4 j + 3] at
// every width).
template <int D>
__device__ __forceinline__ void pv_tile(float* o, uint32_t (*pa)[4],
                                        const unsigned char* vs) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const unsigned char* v = vs + kk * 16 * kPanelBytesPerRow;
    if constexpr (D == 128) {
      wgmma_rs_n128_mn(o, pa[kk],
                       smem_desc(v, kBN * kPanelBytesPerRow, 1024));
    } else {
#pragma unroll
      for (int p = 0; p < D / 64; ++p)
        wgmma_rs_n64_mn(o + 32 * p, pa[kk],
                        smem_desc(v + p * kBN * kPanelBytesPerRow,
                                  kBN * kPanelBytesPerRow, 1024));
    }
  }
}

// One tile's online-softmax step on this thread's S accumulators (rows
// row0 and row0 + 8, 32 columns each): base-2 logits, the masks only on
// a boundary tile, the running max m and sum l updated, alpha the factor
// that rescales O, and s left holding p in fp32.
template <bool SEG>
__device__ __forceinline__ void softmax_tile(
    float* s, float* alpha, float* m_r, float* l_r, bool boundary,
    bool capped, float mul, float post, int c0, int row0, int S, int causal,
    int window, const int* qseg, const int* ksg, int t4) {
  using hopper::ex2;
  const bool plain = !boundary && !capped;
  float mx[2] = {kNegInf, kNegInf};
  if (plain) {
    // Mask-free: the max of the raw scores, scaled after (mul > 0).
#pragma unroll
    for (int j = 0; j < kBN / 2; ++j)
      mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
  } else {
#pragma unroll
    for (int j = 0; j < kBN / 2; ++j) {
      const int r = (j >> 1) & 1;
      float x = capped ? post * tanhf(s[j] * mul) : s[j] * mul;
      if (boundary) {
        const int cl = (j >> 2) * 8 + t4 * 2 + (j & 1);
        const int col = c0 + cl;
        const int row = row0 + 8 * r;
        bool ok = col < S;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && row - col < window;
        if (SEG) ok = ok && qseg[r] == ksg[cl];
        x = ok ? x : kNegInf;
      }
      s[j] = x;
      mx[r] = fmaxf(mx[r], x);
    }
  }
  float m_new[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // The 4 lanes of a group hold one row's 128 columns between them.
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    if (plain) mx[r] *= mul;
    m_new[r] = fmaxf(m_r[r], mx[r]);
    alpha[r] = ex2(m_r[r] - m_new[r]);
    m_r[r] = m_new[r];
  }
  if (plain) {
#pragma unroll
    for (int j = 0; j < kBN / 2; ++j) {
      const int r = (j >> 1) & 1;
      s[j] = ex2(fmaf(s[j], mul, -m_new[r]));
      rs[r] += s[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < kBN / 2; ++j) {
      const int r = (j >> 1) & 1;
      s[j] = s[j] > 0.5f * kNegInf ? ex2(s[j] - m_new[r]) : 0.f;
      rs[r] += s[j];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    l_r[r] = alpha[r] * l_r[r] + rs[r];
  }
}

// One work tile: a (q head, batch, 128-row q tile). Tiles are numbered
// longest first: under the causal mask q tile qt reads qt + 1 kv tiles,
// so index t walks the q tiles from the last to the first, and within
// one q tile the heads (fastest) and the batches.
struct WorkTile {
  int h, b, q0, kt_first, kt_last;
};

__device__ __forceinline__ WorkTile work_tile(int t, int S, int H, int B,
                                              int causal, int window) {
  const int nq = (S + kBM - 1) / kBM;
  const int hb = H * B;
  WorkTile w;
  w.h = t % H;
  w.b = (t % hb) / H;
  w.q0 = (nq - 1 - t / hb) * kBM;
  w.kt_last = (S + kBN - 1) / kBN - 1;
  if (causal) w.kt_last = min(w.kt_last, (w.q0 + kBM - 1) / kBN);
  w.kt_first = window > 0 ? max(w.q0 - window + 1, 0) / kBN : 0;
  return w;
}

// SEG: segment masking is compiled in (the serving calls, which pass no
// segments, run the instance without it). A persistent grid: CTA c runs
// work tiles work_index(0, c, G), work_index(1, c, G), ...
template <int D, bool SEG>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap omap,
                const float* __restrict__ sinks, const int* __restrict__ seg,
                float* __restrict__ lse, int B, int S, int H, int Hkv,
                float scale, int causal, int window, float softcap) {
  using namespace hopper;
  using L = Smem<D>;
  constexpr int ST = L::kStages;
  extern __shared__ unsigned char wg_smem[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_smem) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = sm + L::kQ;  // [2] q tiles, each later its out tile
  unsigned char* Ks = sm + L::kK;
  unsigned char* Vs = sm + L::kV;
  int* kseg = reinterpret_cast<int*>(sm + L::kSeg);
  int2* kinfo = reinterpret_cast<int2*>(sm + L::kKInfo);  // {uniform, id}
  int2* qinfo = reinterpret_cast<int2*>(sm + L::kQInfo);  // [2][2]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::kBar);  // [2]
  uint64_t* q_empty = q_full + 2;                                 // [2]
  uint64_t* full_k = q_empty + 2;
  uint64_t* full_v = full_k + ST;
  uint64_t* empty_k = full_v + ST;
  uint64_t* empty_v = empty_k + ST;
  const int n_work = (S + kBM - 1) / kBM * H * B;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + i, 1);
      mbar_init(q_empty + i, 2);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty_k + s, 8);  // one arrival per consumer warp
      mbar_init(empty_v + s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;

  if (wg == 2) {
    // ----------------------------------------------------- producer
    setmaxnreg_dec<kProducerRegs>();
    if (warp != 0) return;
    int it = 0;  // position in the K/V ring, across work tiles
    for (int n_local = 0, t; (t = work_index(n_local, blockIdx.x,
                                             gridDim.x)) < n_work;
         ++n_local) {
      const WorkTile w = work_tile(t, S, H, B, causal, window);
      const int hk = w.h / (H / Hkv);
      const int qb = n_local & 1;
      const int* segb = SEG ? seg + (size_t)w.b * S : nullptr;
      // The q buffer is free once both consumers' out stores have read it.
      mbar_wait(q_empty + qb, ((n_local >> 1) & 1) ^ 1);
      if (SEG) {
        // Is each consumer's 64-row slice one document? Lane l reads
        // rows 4 l .. 4 l + 3; lanes 0-15 cover warpgroup 0, 16-31
        // warpgroup 1.
        const int first = w.q0 + (lane / 16) * 64;
        const int ref = first < S ? segb[first] : 0;
        bool ok = first < S;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = w.q0 + 4 * lane + i;
          if (r < S) ok = ok && segb[r] == ref;
        }
        const unsigned all = __ballot_sync(0xffffffffu, ok);
        if (lane % 16 == 0)
          qinfo[2 * qb + lane / 16] =
              make_int2(((all >> lane) & 0xffffu) == 0xffffu, ref);
        __syncwarp();
      }
      if (lane == 0) {
        unsigned char* qdst = Qs + qb * L::kQBytes;
        mbar_arrive_expect_tx(q_full + qb, L::kQBytes);
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            tma_load_4d(&qmap, q_full + qb,
                        qdst + p * kBM * kPanelBytesPerRow +
                            half * 64 * kPanelBytesPerRow,
                        p * 64, w.h, w.q0 + half * 64, w.b);
      }
      for (int kt = w.kt_first; kt <= w.kt_last; ++kt, ++it) {
        const int st = it % ST;
        const uint32_t free_ph = ((it / ST) & 1) ^ 1;
        mbar_wait(empty_k + st, free_ph);
        const int c0 = kt * kBN;
        if (SEG) {
          // The tile's kv ids for the boundary tiles' compares, and
          // whether every column is live and of one document.
          const int ref = segb[c0];
          bool ok = c0 + kBN <= S;
          int e[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = c0 + 4 * lane + j;
            e[j] = c < S ? segb[c] : ref;
            ok = ok && e[j] == ref;
          }
          *reinterpret_cast<int4*>(kseg + st * kBN + 4 * lane) =
              make_int4(e[0], e[1], e[2], e[3]);
          const bool all = __all_sync(0xffffffffu, ok);
          if (lane == 0) kinfo[st] = make_int2(all, ref);
          __syncwarp();
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(full_k + st, L::kKVBytes);
#pragma unroll
          for (int p = 0; p < L::kPanels; ++p)
            tma_load_4d(&kmap, full_k + st,
                        Ks + st * L::kKVBytes + p * kBN * kPanelBytesPerRow,
                        p * 64, hk, c0, w.b);
        }
        mbar_wait(empty_v + st, free_ph);
        if (lane == 0) {
          mbar_arrive_expect_tx(full_v + st, L::kKVBytes);
#pragma unroll
          for (int p = 0; p < L::kPanels; ++p)
            tma_load_4d(&vmap, full_v + st,
                        Vs + st * L::kKVBytes + p * kBN * kPanelBytesPerRow,
                        p * 64, hk, c0, w.b);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------- consumers
  setmaxnreg_inc<kConsumerRegs>();
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int rl = wg * 64 + warp * 16 + g;  // tile rows rl and rl + 8
  const bool capped = softcap > 0.f;
  // Base-2 logits: x = s * mul (no softcap), or
  // x = post * tanh(s * mul) (softcap applied to the natural logit).
  const float mul = capped ? scale / softcap : scale * kLog2e;
  const float post = softcap * kLog2e;
  int it = 0;  // position in the K/V ring, as the producer counts it

  for (int n_local = 0, t; (t = work_index(n_local, blockIdx.x,
                                           gridDim.x)) < n_work;
       ++n_local) {
    const WorkTile w = work_tile(t, S, H, B, causal, window);
    const int qb = n_local & 1;
    const int row0 = w.q0 + rl;
    const int w_lo = w.q0 + wg * 64;  // this warpgroup's rows
    int qseg[2] = {0, 0};
    if (SEG) {
      const int* segb = seg + (size_t)w.b * S;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (row0 + 8 * i < S) qseg[i] = segb[row0 + 8 * i];
    }
    float m_r[2] = {kNegInf, kNegInf};
    float l_r[2] = {0.f, 0.f};
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float s[kBN / 2];          // S_j, then p_j in fp32
    uint32_t pa[kBN / 16][4];  // p_j as bf16 A fragments
    float alpha[2];

    mbar_wait(q_full + qb, (n_local >> 1) & 1);
    const int2 qi = SEG ? qinfo[2 * qb + wg] : make_int2(1, 0);
    unsigned char* qtile = Qs + qb * L::kQBytes;
    const unsigned char* qs = qtile + wg * 64 * kPanelBytesPerRow;
    const int n = w.kt_last - w.kt_first + 1;
    // Ping-pong: a consumer starts its wgmmas between sched_sync (its
    // turn) and sched_arrive (the other's turn), so one warpgroup's
    // softmax runs while the other's products keep the tensor cores
    // busy. Warpgroup 0 goes first in each work tile; every slot but
    // warpgroup 1's last hands the turn over, so each barrier sees as
    // many arrivals as syncs.
    const auto sched_sync = [&] { named_barrier(3 + wg, 256); };
    const auto sched_arrive = [&](int slot) {
      named_barrier_arrive_if(4 - wg, 256, wg == 0 || slot != n - 1);
    };
    named_barrier_arrive_if(3, 256, wg == 1);

    const auto softmax = [&](int i) {
      const int st = (it + i) % ST;
      const int c0 = (w.kt_first + i) * kBN;
      const bool boundary =
          c0 + kBN > S || (causal && c0 + kBN - 1 > w_lo) ||
          (window > 0 && w_lo + 63 - c0 >= window) ||
          (SEG && !(qi.x && kinfo[st].x && qi.y == kinfo[st].y));
      softmax_tile<SEG>(s, alpha, m_r, l_r, boundary, capped, mul, post, c0,
                        row0, S, causal, window, qseg, kseg + st * kBN, t4);
      mbar_arrive_if(empty_k + st, lane == 0);  // K and its ids are read
    };
    const auto pack_p = [&] {
      // The accumulators of 8-column blocks 2 kk and 2 kk + 1 are one
      // 16-column A fragment, as for mma.sync; p rounds to bf16 here.
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[kk][e] = pack_bf16x2(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
    };

    // kv tile 0: S_0 alone.
    {
      const int st = it % ST;
      mbar_wait(full_k + st, (it / ST) & 1);
      sched_sync();
      wgmma_fence();
      qk_tile<D>(s, qs, Ks + st * L::kKVBytes);
      wgmma_commit();
      sched_arrive(0);
      wgmma_wait<0>();
      pin<kBN / 2>(s);
      softmax(0);
      pack_p();
    }
    // kv tile i: S_i = Q K_i^T in flight with O += P_{i-1} V_{i-1}; the
    // softmax of S_i overlaps the second product, and O is rescaled by
    // alpha_i once it has completed.
    for (int i = 1; i < n; ++i) {
      const int st = (it + i) % ST;
      const int sp = (it + i - 1) % ST;
      // Both waits come before the first wgmma: a wait loop while a
      // wgmma is in flight makes ptxas serialize the wgmmas.
      mbar_wait(full_k + st, ((it + i) / ST) & 1);
      mbar_wait(full_v + sp, ((it + i - 1) / ST) & 1);
      sched_sync();
      wgmma_fence();
      qk_tile<D>(s, qs, Ks + st * L::kKVBytes);
      wgmma_commit();
      pv_tile<D>(o, pa, Vs + sp * L::kKVBytes);
      wgmma_commit();
      sched_arrive(i);
      wgmma_wait<1>();
      pin<kBN / 2>(s);
      softmax(i);
      wgmma_wait<0>();
      pin<D / 2>(o);
      pin<kBN / 4>(&pa[0][0]);
      mbar_arrive_if(empty_v + sp, lane == 0);
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
      pack_p();
    }
    {
      const int sp = (it + n - 1) % ST;
      mbar_wait(full_v + sp, ((it + n - 1) / ST) & 1);
      wgmma_fence();
      pv_tile<D>(o, pa, Vs + sp * L::kKVBytes);
      wgmma_commit();
      wgmma_wait<0>();
      pin<D / 2>(o);
      pin<kBN / 4>(&pa[0][0]);
      mbar_arrive_if(empty_v + sp, lane == 0);
    }
    it += n;

    // ----------------------------------------------------- epilogue
    const float sk2 = sinks != nullptr ? sinks[w.h] * kLog2e : 0.f;
    float fac[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float rr = 1.f, denom, m_fin = m_r[r];
      if (sinks != nullptr) {
        const float m2 = fmaxf(m_r[r], sk2);
        rr = ex2(m_r[r] - m2);
        denom = l_r[r] * rr + ex2(sk2 - m2);
        m_fin = m2;
      } else {
        denom = l_r[r] == 0.f ? 1.f : l_r[r];
      }
      fac[r] = rr / denom;
      const int row = row0 + 8 * r;
      if (lse != nullptr && t4 == 0 && row < S)
        lse[((size_t)w.b * H + w.h) * S + row] =
            (m_fin > 0.5f * kNegInf ? m_fin * kLn2 : kNegInf) + logf(denom);
    }
    // O into this warpgroup's rows of the q tile (only its own wgmma read
    // them), in the swizzled layout the out map's TMA store reads.
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rl + 8 * r;
        const int byte = (nd / 8) * kBM * kPanelBytesPerRow +
                         row * kPanelBytesPerRow +
                         (((nd % 8) ^ (row % 8)) << 4) + t4 * 4;
        *reinterpret_cast<uint32_t*>(qtile + byte) = pack_bf16x2(
            o[4 * nd + 2 * r] * fac[r], o[4 * nd + 2 * r + 1] * fac[r]);
      }
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (tid == 0) {
      if (w_lo < S) {
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p)
          tma_store_4d(&omap,
                       qtile + p * kBM * kPanelBytesPerRow +
                           wg * 64 * kPanelBytesPerRow,
                       p * 64, w.h, w_lo, w.b);
        tma_store_commit();
        tma_store_wait_read();
      }
      mbar_arrive_if(q_empty + qb, 1);  // the producer may refill it
    }
  }
}

template <int D, bool SEG>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const float* sinks, const int* seg, void* out,
                         float* lse, int B, int S, int H, int Hkv,
                         float scale, int causal, int window, float softcap,
                         cudaStream_t stream) {
  using namespace hopper;
  CUtensorMap qm, km, vm, om;
  cudaError_t err;
  if ((err = tensor_map(&qm, q, B, S, H, D, 64)) != cudaSuccess ||
      (err = tensor_map(&km, k, B, S, Hkv, D, kBN)) != cudaSuccess ||
      (err = tensor_map(&vm, v, B, S, Hkv, D, kBN)) != cudaSuccess ||
      (err = tensor_map(&om, out, B, S, H, D, 64)) != cudaSuccess)
    return err;
  auto kernel = flash_fwd_wgmma<D, SEG>;
  constexpr size_t smem = Smem<D>::kAlloc;
  if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
  const int n_work = (S + kBM - 1) / kBM * H * B;
  int ctas;
  if ((err = persistent_ctas(n_work, &ctas)) != cudaSuccess) return err;
  kernel<<<ctas, kWgThreads, smem, stream>>>(
      qm, km, vm, om, sinks, seg, lse, B, S, H, Hkv, scale, causal, window,
      softcap);
  return cudaGetLastError();
}

template <typename T, int D, bool SEG>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* sinks, const void* seg, void* out, void* lse,
                   int B, int S, int H, int Hkv, float scale, int causal,
                   int window, float softcap, cudaStream_t stream) {
  const float* sp = static_cast<const float*>(sinks);
  const int* gp = static_cast<const int*>(seg);
  float* lp = static_cast<float*>(lse);
  if constexpr (sizeof(T) == 4) {
    dim3 grid((S + kBQ - 1) / kBQ, H, B);
    auto kernel = flash_fwd_f32<D, SEG>;
    constexpr size_t smem = f32_smem_bytes<D>();
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kF32Threads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), sp, gp, static_cast<float*>(out), lp,
        S, H, Hkv, scale, causal, window, softcap);
    return cudaGetLastError();
  } else {
    return launch_wgmma<D, SEG>(q, k, v, sp, gp, out, lp, B, S, H, Hkv,
                                scale, causal, window, softcap, stream);
  }
}

template <typename T>
cudaError_t launch_dim(const void* q, const void* k, const void* v,
                       const void* sinks, const void* seg, void* out,
                       void* lse, int B, int S, int H, int Hkv, int D,
                       float scale, int causal, int window, float softcap,
                       cudaStream_t stream) {
  const bool g = seg != nullptr;
  if (D == 64)
    return (g ? launch<T, 64, true> : launch<T, 64, false>)(
        q, k, v, sinks, seg, out, lse, B, S, H, Hkv, scale, causal, window,
        softcap, stream);
  if (D == 128)
    return (g ? launch<T, 128, true> : launch<T, 128, false>)(
        q, k, v, sinks, seg, out, lse, B, S, H, Hkv, scale, causal, window,
        softcap, stream);
  // MLA's expanded prefill (serving), and its training with packed
  // segments.
  if (D == 192)
    return (g ? launch<T, 192, true> : launch<T, 192, false>)(
        q, k, v, sinks, seg, out, lse, B, S, H, Hkv, scale, causal, window,
        softcap, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace shellac

// window <= 0: none; softcap <= 0: none; sinks, seg (B, S) int32 and
// lse (B, H, S) fp32 may be null (lse is then not written).
extern "C" int shellac_flash_attention(const void* q, const void* k,
                                       const void* v, const void* sinks,
                                       const void* seg, void* out, void* lse,
                                       int B, int S, int H, int Hkv, int D,
                                       float scale, int causal, int window,
                                       float softcap, int dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == shellac::kF32)
    return shellac::launch_dim<float>(q, k, v, sinks, seg, out, lse, B, S, H,
                                      Hkv, D, scale, causal, window, softcap,
                                      s);
  if (dtype == shellac::kBF16)
    return shellac::launch_dim<__nv_bfloat16>(q, k, v, sinks, seg, out, lse,
                                              B, S, H, Hkv, D, scale, causal,
                                              window, softcap, s);
  return (int)cudaErrorInvalidValue;
}
