// Flash-attention backward over q (B, S, H, D), k/v (B, S, Hkv, D).
//
// Two kernels, one per pass of `_flash_backward` (shellac_tpu/ops/
// flash_attention.py):
//   - dkdv replaces `_flash_bwd_dkdv_kernel`: dk and dv of one kv tile of
//     one kv head, summed inside the block over every q tile of every q
//     head of its GQA group (the TPU grid's sequential (G * q_blocks)
//     axis becomes a loop), so no atomics are needed and every dk/dv
//     tile is written by one block: the result is deterministic;
//   - dq replaces `_flash_bwd_dq_kernel`: dq of one q tile of one q head,
//     over the kv tiles it can see.
// Both recompute p and ds from (q, k, v, dO, lse, delta) by the formulas
// of `_tile_p_ds`: s = scale * q.k, softcap, then the causal, window,
// segment and ragged-tail masks to the NEG_INF sentinel;
// p = exp(s - lse) gated on s > NEG_INF / 2 (lse alone is no gate: a row
// masked across a tile would see exp(NEG_INF - lse) where lse may sit at
// the sentinel too); ds = p (dp - delta) scale, times the softcap
// derivative 1 - (s / cap)^2 gated on the same sentinel (the ungated
// (NEG_INF / cap)^2 overflows to inf, and 0 * inf is NaN). dk takes ds^T
// q with the unscaled q, since ds already carries the scale. p and ds
// are rounded to the inputs' dtype before their products, as the TPU
// kernels' astype does; every sum is fp32; outputs are written in the
// inputs' dtype. Dead causal and window tiles are not visited.
//
// What bounds them on the H100 (989 TFLOP/s bf16, 3.35 TB/s): at the
// training shape (B 6, S 2048, H 16, Hkv 8, D 128, causal) the
// operations, over the causal half of the score matrix: dkdv four
// products (0.209 ms), dq three (0.156 ms). So the bf16 bodies are built
// as kernel 2's forward is (csrc/flash_attention.cu): persistent, one CTA
// an SM at most, walking work tiles from a longest-first list in a snake
// order; warpgroup 2 a TMA producer at 24 registers (setmaxnreg), its
// warp 0 loading; warpgroups 0 and 1 `wgmma` consumers at 240, each
// owning 64 rows of a 128-row work tile. Every tile in shared memory is
// 128-byte swizzled as TMA leaves it, and every operand is read where it
// lies: the products that need a transposed operand read it MN-major
// through the descriptor's transpose bit, so nothing is copied twice.
//
//   - bf16 dkdv, `flash_bwd_dkdv_wgmma`: a work tile is (b, kv head,
//     128-row kv tile); the low kv tiles see the most q tiles under the
//     causal mask, so the list runs kv tiles upwards. K and V are loaded
//     once a work tile into one of two buffers (the next tile's arrive
//     while this one runs). The q and dO tiles (64 rows) of every q head
//     of the group stream through a ring of stages (2 at D 128, 4 at
//     D 64) with a full and an empty mbarrier each; the producer also
//     puts each q tile's lse (times log2 e), delta and segment ids into
//     the stage. Per q tile a consumer computes s^T = K q^T and
//     dp^T = V dO^T (m64n64, both operands K-major in shared memory), p^T
//     and ds^T in the accumulators (masks only on boundary tiles), packs
//     them to bf16 A fragments where they lie (the accumulator layout is
//     the A layout), and adds dv += p^T dO and dk += ds^T q (A from
//     registers, dO and q read MN-major). dk and dv stay in fp32
//     registers for the whole work tile (2 x D / 2 a thread), then go
//     through the consumer's own rows of the K and V buffers to TMA
//     stores.
//   - bf16 dq, `flash_bwd_dq_wgmma`: a work tile is (q head, b, 128-row q
//     tile), the last q tiles first; q, dO (two buffers) and each row's
//     lse and delta stay put; the live kv tiles (64 rows) stream through a
//     ring (3 stages at D 128, 4 at D 64). Per kv tile: s = q K^T and
//     dp = dO V^T (m64n64, K-major), ds in the accumulators, dq += ds K
//     with K read MN-major; dq leaves through the consumer's rows of the
//     q buffer and a TMA store.
// Every mbarrier wait sits before the wgmmas it feeds (a wait loop while
// a wgmma is in flight makes ptxas serialize them, warning C7520), and
// accumulators and A fragments in flight are pinned with empty asm.
// Shared memory: dkdv 2 x (32 + 32) KB of K/V and 2 x (16 + 16) KB of
// stages at D 128; dq 2 x (32 + 32) KB of q/dO and 3 x (16 + 16) KB of
// stages. Rows past S are neither loaded (TMA fills zeros) nor stored.
// Each consumer waits for its products before the next step: the two
// consumers' steps interleave on the tensor cores. Computing p while
// dp^T is in flight, and ds while dv is, was slower on an H100 (dk/dv
// 0.565 against 0.451 ms at 6 x 2048, with spills at D 128).
// Left for later: ping-pong between the consumers as in the forward,
// both q heads of a GQA pair in one dq block, and a split of the long
// dk/dv work tiles for grids that fill few SMs (B = 1 runs 128 work
// tiles of 4 to 64 steps).
//   - bf16 at D 192 (MLA training: q and k 192 wide, v and so dO padded
//     from 128, which the bodies do not assume): the same two kernels,
//     laid out for a budget of 232,448 bytes of shared memory and 240
//     registers a consumer thread. A consumer that owned 64 kv rows and
//     both outputs would hold dK and dV (96 fp32 each at m64n192) with
//     s^T and dp^T (32 each): 256 registers before any address. So the
//     dkdv work tile is 64 kv rows, taken by both consumers, split by
//     output: warpgroup 0 computes s^T = K q^T, p^T (written to shared
//     memory as fp32, times the softcap's derivative where there is
//     one; 16 KB) and dV += p^T dO; warpgroup 1 computes dp^T = V dO^T,
//     waits on a named barrier for p^T, forms ds^T and adds
//     dK += ds^T q. Each does one 192-deep product and one n192 product
//     (three n64 products, one a 64-column panel, as the forward's P V
//     at 192) a q tile, so neither waits on the other by design; a
//     second named barrier says p^T was read. Warpgroup 0 reads no V and
//     warpgroup 1 no K, so dV leaves through the K buffer and dK through
//     the V buffer. K/V double-buffered (2 x 48 KB), a ring of 2 q/dO
//     stages (2 x 48 KB) and p^T: 211 KB; 3072 work tiles at 6 x 2048 x
//     16 heads. dq keeps the D 128 layout with one q and one dO buffer
//     (2 x 48 KB) and a ring of 2 K/V stages (2 x 48 KB): 193 KB; dq,
//     s, dp and the fragments are 176 registers a thread.
//   - fp32, `flash_bwd_dkdv_simt` and `flash_bwd_dq_simt`: scalar fp32
//     FMAs over 4 x 4 register tiles per thread (the tensor cores would
//     round fp32 inputs to tf32); the parity path.
#include <cuda.h>

#include "common.cuh"
#include "hopper.cuh"

namespace shellac {
namespace {

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, H, S)
  const float* delta;  // (B, H, S)
  const int* seg;      // (B, S) or null
  void* dq;
  void* dk;
  void* dv;
  int S, H, Hkv;
  float scale;
  int causal, window;  // window <= 0: none
  float softcap;       // <= 0: none
};

// p and ds of one (q row, kv col) entry from its raw products q.k and
// dO.v, as `_tile_p_ds` computes them.
__device__ __forceinline__ void p_ds(const BwdArgs& a, float qk, float dp,
                                     int row, int col, bool same_seg,
                                     float lse_r, float delta_r, float& p,
                                     float& ds) {
  float s = qk * a.scale;
  if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
  bool ok = row < a.S && col < a.S && same_seg;
  if (a.causal) ok = ok && col <= row;
  if (a.window > 0) ok = ok && row - col < a.window;
  s = ok ? s : kNegInf;
  const bool live = s > 0.5f * kNegInf;
  p = live ? expf(s - lse_r) : 0.f;
  ds = p * (dp - delta_r) * a.scale;
  if (a.softcap > 0.f) {
    const float t = s / a.softcap;
    ds *= live ? 1.f - t * t : 0.f;
  }
}

// q tiles [first, last] that can see kv rows [k0, k0 + rows).
__device__ __forceinline__ void live_q_tiles(int S, int causal, int window,
                                             int k0, int rows, int bq,
                                             int& first, int& last) {
  first = causal ? k0 / bq : 0;
  last = (S + bq - 1) / bq - 1;
  if (window > 0) last = min(last, (k0 + rows - 1 + window - 1) / bq);
}

// kv tiles [first, last] that q rows [q0, q0 + rows) can see.
__device__ __forceinline__ void live_kv_tiles(int S, int causal, int window,
                                              int q0, int rows, int bk,
                                              int& first, int& last) {
  last = (S + bk - 1) / bk - 1;
  if (causal) last = min(last, (q0 + rows - 1) / bk);
  first = window > 0 ? max(q0 - window + 1, 0) / bk : 0;
}

// ---------------------------------------------------------------------------
// bf16 bodies: persistent, warp-specialized, wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int kTile = 128;       // rows of a work tile: two consumers x 64
constexpr int kStep = 64;        // rows of a streamed tile
constexpr int kRow = 128;        // bytes of one swizzled panel row (64 bf16)
constexpr int kWgThreads = 384;  // consumers: warpgroups 0, 1; producer 2
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemMax = 232448;  // bytes a block may use on Hopper

// acc (m64 x n64) = A B^T over D: A 64 rows at `a`, B 64 rows at `b`,
// both K-major (rows of D columns), their D / 64 panels `pa` and `pb`
// bytes apart.
template <int D>
__device__ __forceinline__ void ss_n64(float* acc, const unsigned char* a,
                                       int pa, const unsigned char* b,
                                       int pb) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // 16 columns are 32 bytes inside one 128-byte swizzled row.
    const int off = (kk % 4) * 32;
    wgmma_ss_n64(acc, smem_desc(a + (kk / 4) * pa + off, 16, 1024),
                 smem_desc(b + (kk / 4) * pb + off, 16, 1024), kk > 0);
  }
}

// acc (m64 x nD) += F B: F the bf16 A fragments of a 64 x 64 tile (four
// k-steps of 16), B a 64-row tile (the k index) of D columns read
// MN-major, its panels kStep rows apart. D 192 takes one n64 product a
// panel, into the panel's 32 accumulators (the fragment of 8-column
// block j is acc[4 j .. 4 j + 3] at every width).
template <int D>
__device__ __forceinline__ void rs_nd(float* acc, uint32_t (*f)[4],
                                      const unsigned char* b) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < kStep / 16; ++kk) {
    const unsigned char* bk = b + kk * 16 * kRow;
    if constexpr (D == 128) {
      wgmma_rs_n128_mn(acc, f[kk], smem_desc(bk, kStep * kRow, 1024));
    } else {
#pragma unroll
      for (int p = 0; p < D / 64; ++p)
        wgmma_rs_n64_mn(acc + 32 * p, f[kk],
                        smem_desc(bk + p * kStep * kRow, kStep * kRow, 1024));
    }
  }
}

// A 64 x 64 accumulator tile as bf16 A fragments: 8-column blocks 2 kk
// and 2 kk + 1 are the 16-column fragment kk, as for mma.sync.
__device__ __forceinline__ void pack_frags(uint32_t (*f)[4], const float* s) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[kk][e] = hopper::pack_bf16x2(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

// This thread's rows (rl, rl + 8 of a ROWS-row tile) of an m64 x nD
// accumulator, as bf16, into `tile` in the swizzled layout a TMA store
// reads (D / 64 panels of ROWS rows).
template <int D, int ROWS>
__device__ __forceinline__ void stage_out(unsigned char* tile,
                                          const float* acc, int rl, int t4) {
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rl + 8 * r;
      const int byte = (nd / 8) * ROWS * kRow + row * kRow +
                       (((nd % 8) ^ (row % 8)) << 4) + t4 * 4;
      *reinterpret_cast<uint32_t*>(tile + byte) = hopper::pack_bf16x2(
          acc[4 * nd + 2 * r], acc[4 * nd + 2 * r + 1]);
    }
}

// What a consumer needs to turn raw products into p and ds.
struct PdsOpts {
  float mul;    // scale log2 e, or scale / cap with a softcap
  float post;   // cap log2 e
  float scale;  // ds's factor
  bool capped;
};

// The accumulator element j of a m64n64 tile: row (e >> 1) * 8 + the
// thread's row, column 8 (j >> 2) + 2 t4 + (j & 1).
//
// One live element: base-2 logit z of raw product x, p against the
// row's lse2 (lse log2 e), ds against its delta.
__device__ __forceinline__ void elem(float x, float dp, float lse2,
                                     float dlt, bool ok, const PdsOpts& o,
                                     float& p, float& ds) {
  float t = 0.f, z;
  if (o.capped) {
    t = tanhf(x * o.mul);
    z = t * o.post;
  } else {
    z = x * o.mul;
  }
  p = ok ? hopper::ex2(z - lse2) : 0.f;
  ds = p * (dp - dlt) * o.scale;
  if (o.capped) ds *= 1.f - t * t;
}

// dkdv: s^T and dp^T tiles (rows kv, columns q) into p^T and ds^T in
// place. krow/kseg: this thread's two kv rows and their segment ids;
// lse2/dlt/qsg: the stage's 64 q rows; q0 the tile's first q row.
template <bool SEG>
__device__ __forceinline__ void p_ds_kv_rows(
    float* s, float* dp, bool boundary, const PdsOpts& o, const float* lse2,
    const float* dlt, const int* qsg, int q0, const int* krow,
    const int* kseg, int S, int causal, int window, int t4) {
#pragma unroll
  for (int jb = 0; jb < 8; ++jb) {
    const int cl = 8 * jb + 2 * t4;
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + cl);
    const float2 de = *reinterpret_cast<const float2*>(dlt + cl);
    int2 qs = make_int2(0, 0);
    if (SEG && boundary) qs = *reinterpret_cast<const int2*>(qsg + cl);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * jb + e, r = e >> 1, c = e & 1;
      bool ok = true;
      if (boundary) {
        const int col = q0 + cl + c, row = krow[r];
        ok = col < S && row < S;
        if (causal) ok = ok && row <= col;
        if (window > 0) ok = ok && col - row < window;
        if (SEG) ok = ok && (c ? qs.y : qs.x) == kseg[r];
      }
      elem(s[j], dp[j], c ? l2.y : l2.x, c ? de.y : de.x, ok, o, s[j],
           dp[j]);
    }
  }
}

// dq: s and dp tiles (rows q, columns kv) into ds in place (in dp).
// qrow/qseg/lse2/dlt: this thread's two q rows; ksg: the stage's 64 kv
// segment ids; k0 the tile's first kv row.
template <bool SEG>
__device__ __forceinline__ void ds_q_rows(
    const float* s, float* dp, bool boundary, const PdsOpts& o,
    const float* lse2, const float* dlt, const int* qrow, const int* qseg,
    const int* ksg, int k0, int S, int causal, int window, int t4) {
#pragma unroll
  for (int jb = 0; jb < 8; ++jb) {
    const int cl = 8 * jb + 2 * t4;
    int2 ks = make_int2(0, 0);
    if (SEG && boundary) ks = *reinterpret_cast<const int2*>(ksg + cl);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * jb + e, r = e >> 1, c = e & 1;
      bool ok = true;
      if (boundary) {
        const int col = k0 + cl + c, row = qrow[r];
        ok = col < S && row < S;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && row - col < window;
        if (SEG) ok = ok && (c ? ks.y : ks.x) == qseg[r];
      }
      float p;
      elem(s[j], dp[j], lse2[r], dlt[r], ok, o, p, dp[j]);
    }
  }
}

__device__ __forceinline__ PdsOpts pds_opts(float scale, float softcap) {
  PdsOpts o;
  o.capped = softcap > 0.f;
  o.mul = o.capped ? scale / softcap : scale * kLog2e;
  o.post = softcap * kLog2e;
  o.scale = scale;
  return o;
}

// Is each consumer's 64-row half of the 128 rows from r0 one document?
// Lane l reads rows r0 + 4 l .. + 3; lanes 0-15 cover consumer 0, 16-31
// consumer 1; lanes 0 and 16 write {uniform, id} to info[0] and info[1].
__device__ __forceinline__ void halves_info(const int* segb, int r0, int S,
                                            int lane, int2* info) {
  const int first = r0 + (lane / 16) * 64;
  const int ref = first < S ? segb[first] : 0;
  bool ok = first < S;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * lane + i;
    if (r < S) ok = ok && segb[r] == ref;
  }
  const unsigned all = __ballot_sync(0xffffffffu, ok);
  if (lane % 16 == 0)
    info[lane / 16] =
        make_int2(((all >> lane) & 0xffffu) == 0xffffu, ref);
}

// Load a (rows x D) tile at row r0 through `map` as 64-row boxes, one per
// panel and half, into a tile of `rows` rows a panel.
template <int D>
__device__ __forceinline__ void tma_tile(const CUtensorMap* map,
                                         uint64_t* bar, unsigned char* dst,
                                         int rows, int head, int r0, int b) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
    for (int half = 0; half < rows / 64; ++half)
      hopper::tma_load_4d(map, bar,
                          dst + p * rows * kRow + half * 64 * kRow, p * 64,
                          head, r0 + half * 64, b);
}

// Store this consumer's 64 rows (at row wg * 64 of a ROWS-row tile) to
// rows r0.. through `map`.
template <int D, int ROWS>
__device__ __forceinline__ void tma_store_rows(const CUtensorMap* map,
                                               const unsigned char* tile,
                                               int wg, int head, int r0,
                                               int b) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
    hopper::tma_store_4d(map, tile + p * ROWS * kRow + wg * 64 * kRow,
                         p * 64, head, r0, b);
}

// Segment ids of the 64 rows from r0, two a lane (a row past S takes the
// first row's id), into `ids` where it is not null; returns {every row
// live and of one document, the first row's id}.
__device__ __forceinline__ int2 rows64_info(const int* segb, int r0, int S,
                                            int lane, int* ids) {
  const int ref = r0 < S ? segb[r0] : 0;
  const int r = r0 + 2 * lane;
  const int s0 = r < S ? segb[r] : ref;
  const int s1 = r + 1 < S ? segb[r + 1] : ref;
  if (ids != nullptr)
    *reinterpret_cast<int2*>(ids + 2 * lane) = make_int2(s0, s1);
  const bool all =
      __all_sync(0xffffffffu, r + 1 < S && s0 == ref && s1 == ref);
  return make_int2(all, ref);
}

// dkdv at D 192, warpgroup 0: an s^T tile (rows kv, columns q) into p^T
// in place. Each p, times the softcap's derivative where there is a cap,
// goes to `hand` (this thread's 32 values at hand[j * 128 + tid]), from
// which warpgroup 1 forms ds^T. Arguments as `p_ds_kv_rows`.
template <bool SEG>
__device__ __forceinline__ void p_kv_rows(
    float* s, float* hand, int tid, bool boundary, const PdsOpts& o,
    const float* lse2, const int* qsg, int q0, const int* krow,
    const int* kseg, int S, int causal, int window, int t4) {
#pragma unroll
  for (int jb = 0; jb < 8; ++jb) {
    const int cl = 8 * jb + 2 * t4;
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + cl);
    int2 qs = make_int2(0, 0);
    if (SEG && boundary) qs = *reinterpret_cast<const int2*>(qsg + cl);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * jb + e, r = e >> 1, c = e & 1;
      bool ok = true;
      if (boundary) {
        const int col = q0 + cl + c, row = krow[r];
        ok = col < S && row < S;
        if (causal) ok = ok && row <= col;
        if (window > 0) ok = ok && col - row < window;
        if (SEG) ok = ok && (c ? qs.y : qs.x) == kseg[r];
      }
      float t = 0.f, z;
      if (o.capped) {
        t = tanhf(s[j] * o.mul);
        z = t * o.post;
      } else {
        z = s[j] * o.mul;
      }
      const float p = ok ? hopper::ex2(z - (c ? l2.y : l2.x)) : 0.f;
      s[j] = p;
      hand[j * 128 + tid] = o.capped ? p * (1.f - t * t) : p;
    }
  }
}

// dkdv at D 192, warpgroup 1: a dp^T tile into ds^T in place from the
// handed p^T and the stage's delta rows `dlt`.
__device__ __forceinline__ void ds_kv_rows(float* dp, const float* hand,
                                           int tid, const float* dlt,
                                           float scale, int t4) {
#pragma unroll
  for (int jb = 0; jb < 8; ++jb) {
    const float2 de =
        *reinterpret_cast<const float2*>(dlt + 8 * jb + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * jb + e;
      dp[j] = hand[j * 128 + tid] * (dp[j] - (e & 1 ? de.y : de.x)) * scale;
    }
  }
}

// ------------------------------------------------------------------ dkdv

template <int D>
struct DkdvSmem {
  // D 192 splits the consumers by output over 64-row kv tiles (see the
  // kernel) and hands p^T from one to the other through shared memory.
  static constexpr bool kSplit = D == 192;
  static constexpr int kKVRows = kSplit ? kStep : kTile;  // a work tile
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kKVBytes = kKVRows * D * 2;  // a K or V tile
  static constexpr int kQBytes = kStep * D * 2;     // a q or dO tile
  static constexpr int kK = 0;                    // [2] K tiles, later dK
  static constexpr int kV = kK + 2 * kKVBytes;    // [2] V tiles, later dV
  static constexpr int kQ = kV + 2 * kKVBytes;    // [stage] q tiles
  static constexpr int kO = kQ + kStages * kQBytes;  // [stage] dO tiles
  // [stage] lse2 and delta rows (float [2][kStep]), q segment ids.
  static constexpr int kRowsF = kO + kStages * kQBytes;
  static constexpr int kQSeg = kRowsF + kStages * 2 * kStep * 4;
  static constexpr int kQInfo = kQSeg + kStages * kStep * 4;  // [stage]
  static constexpr int kKVInfo = kQInfo + kStages * 8;  // [2 bufs][2 wg]
  // mbarriers: kv_full[2], kv_empty[2], then full[stage], empty[stage].
  static constexpr int kBar = kKVInfo + 4 * 8;
  // D 192: the handed p^T, fp32 [32][128] (element j of thread tid).
  static constexpr int kHand = kBar + (4 + 2 * kStages) * 8;
  static constexpr int kBytes = kHand + (kSplit ? 32 * 128 * 4 : 0);
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
  static_assert(kAlloc <= kSmemMax, "dkdv shared memory");
};

// A work tile: (kv head, batch, ROWS-row kv tile), numbered longest
// first: under the causal mask the kv tile at k0 is seen by the q tiles
// from k0 on, so t walks the kv tiles upwards, and within one the kv
// heads (fastest) and the batches.
struct KvWork {
  int hk, b, k0, qt_first, nq;
};

template <int ROWS>
__device__ __forceinline__ KvWork kv_work(int t, int S, int Hkv, int B,
                                          int causal, int window) {
  const int hb = Hkv * B;
  KvWork w;
  w.hk = t % Hkv;
  w.b = (t % hb) / Hkv;
  w.k0 = (t / hb) * ROWS;
  int last;
  live_q_tiles(S, causal, window, w.k0, ROWS, kStep, w.qt_first, last);
  w.nq = last - w.qt_first + 1;
  return w;
}

// Named barriers of the D 192 dkdv body's p^T hand-off (1 and 2 are the
// consumers' epilogues).
constexpr int kBarHandFull = 3;   // warpgroup 0 wrote p^T
constexpr int kBarHandEmpty = 4;  // warpgroup 1 read it

template <int D, bool SEG>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap omap,
                     const __grid_constant__ CUtensorMap dkmap,
                     const __grid_constant__ CUtensorMap dvmap,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ seg, int B, int S, int H,
                     int Hkv, float scale, int causal, int window,
                     float softcap) {
  using namespace hopper;
  using L = DkdvSmem<D>;
  constexpr int ST = L::kStages;
  constexpr int KR = L::kKVRows;
  extern __shared__ unsigned char wg_smem[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_smem) + 1023) & ~uintptr_t(1023));
  unsigned char* Ks = sm + L::kK;
  unsigned char* Vs = sm + L::kV;
  unsigned char* Qs = sm + L::kQ;
  unsigned char* Os = sm + L::kO;
  float* rowsf = reinterpret_cast<float*>(sm + L::kRowsF);
  int* qseg_s = reinterpret_cast<int*>(sm + L::kQSeg);
  int2* qinfo = reinterpret_cast<int2*>(sm + L::kQInfo);
  int2* kvinfo = reinterpret_cast<int2*>(sm + L::kKVInfo);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::kBar);  // [2]
  uint64_t* kv_empty = kv_full + 2;                                // [2]
  uint64_t* full = kv_empty + 2;
  uint64_t* empty = full + ST;
  const int G = H / Hkv;
  const int n_work = (S + KR - 1) / KR * Hkv * B;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(kv_full + i, 1);
      mbar_init(kv_empty + i, 2);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // one arrival per consumer warp
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
    int it = 0;  // position in the q/dO ring, across work tiles
    for (int n_local = 0, t; (t = work_index(n_local, blockIdx.x,
                                             gridDim.x)) < n_work;
         ++n_local) {
      const KvWork w = kv_work<KR>(t, S, Hkv, B, causal, window);
      const int kb = n_local & 1;
      const int* segb = SEG ? seg + (size_t)w.b * S : nullptr;
      // The K/V buffer is free once both consumers' dK/dV stores have
      // read it.
      mbar_wait(kv_empty + kb, ((n_local >> 1) & 1) ^ 1);
      if (SEG) {
        if constexpr (L::kSplit) {
          const int2 info = rows64_info(segb, w.k0, S, lane, nullptr);
          if (lane == 0) kvinfo[2 * kb] = info;
        } else {
          halves_info(segb, w.k0, S, lane, kvinfo + 2 * kb);
        }
        __syncwarp();
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full + kb, 2 * L::kKVBytes);
        tma_tile<D>(&kmap, kv_full + kb, Ks + kb * L::kKVBytes, KR, w.hk,
                    w.k0, w.b);
        tma_tile<D>(&vmap, kv_full + kb, Vs + kb * L::kKVBytes, KR, w.hk,
                    w.k0, w.b);
      }
      for (int i = 0; i < G * w.nq; ++i, ++it) {
        const int h = w.hk * G + i / w.nq;
        const int q0 = (w.qt_first + i % w.nq) * kStep;
        const int st = it % ST;
        mbar_wait(empty + st, ((it / ST) & 1) ^ 1);
        // The q rows' lse (in base 2), delta and segment ids: two rows a
        // lane; rows past S are never live.
        const size_t hrow = ((size_t)w.b * H + h) * S;
        float* l2 = rowsf + st * 2 * kStep;
        const int r = q0 + 2 * lane;
        float2 lv = make_float2(0.f, 0.f), dv = make_float2(0.f, 0.f);
        if (r < S) {
          lv.x = lse[hrow + r] * kLog2e;
          dv.x = delta[hrow + r];
        }
        if (r + 1 < S) {
          lv.y = lse[hrow + r + 1] * kLog2e;
          dv.y = delta[hrow + r + 1];
        }
        *reinterpret_cast<float2*>(l2 + 2 * lane) = lv;
        *reinterpret_cast<float2*>(l2 + kStep + 2 * lane) = dv;
        if (SEG) {
          const int2 info =
              rows64_info(segb, q0, S, lane, qseg_s + st * kStep);
          if (lane == 0) qinfo[st] = info;
        }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive_expect_tx(full + st, 2 * L::kQBytes);
          tma_tile<D>(&qmap, full + st, Qs + st * L::kQBytes, kStep, h, q0,
                      w.b);
          tma_tile<D>(&omap, full + st, Os + st * L::kQBytes, kStep, h, q0,
                      w.b);
        }
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  setmaxnreg_inc<kConsumerRegs>();
  const int g = lane / 4;
  const int t4 = lane % 4;
  const PdsOpts o = pds_opts(scale, softcap);
  int it = 0;  // position in the q/dO ring, as the producer counts it

  if constexpr (L::kSplit) {
    // D 192: both warpgroups take the work tile's 64 kv rows, one output
    // each. Warpgroup 0 computes s^T = K q^T, p^T (handed to warpgroup 1
    // through shared memory) and dV += p^T dO; warpgroup 1 dp^T = V dO^T,
    // ds^T from the handed p^T, and dK += ds^T q. Warpgroup 0 reads no V
    // and warpgroup 1 no K, so dV leaves through the K buffer and dK
    // through the V buffer.
    float* hand = reinterpret_cast<float*>(sm + L::kHand);
    const int rl = warp * 16 + g;  // tile rows rl and rl + 8
    bool handed = false;           // warpgroup 0: p^T handed before
    for (int n_local = 0, t; (t = work_index(n_local, blockIdx.x,
                                             gridDim.x)) < n_work;
         ++n_local) {
      const KvWork w = kv_work<KR>(t, S, Hkv, B, causal, window);
      const int kb = n_local & 1;
      const int krow[2] = {w.k0 + rl, w.k0 + rl + 8};
      int kseg[2] = {0, 0};
      if (SEG) {
        const int* segb = seg + (size_t)w.b * S;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (krow[i] < S) kseg[i] = segb[krow[i]];
      }
      float acc[D / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

      mbar_wait(kv_full + kb, (n_local >> 1) & 1);
      const int2 kvi = SEG ? kvinfo[2 * kb] : make_int2(1, 0);
      unsigned char* kt = Ks + kb * L::kKVBytes;  // later this tile's dV
      unsigned char* vt = Vs + kb * L::kKVBytes;  // later its dK
      const unsigned char* a_op = wg == 0 ? kt : vt;

      for (int i = 0; i < G * w.nq; ++i, ++it) {
        const int q0 = (w.qt_first + i % w.nq) * kStep;
        const int st = it % ST;
        mbar_wait(full + st, (it / ST) & 1);
        const unsigned char* qs = Qs + st * L::kQBytes;
        const unsigned char* os = Os + st * L::kQBytes;
        float x[32];  // s^T, then p^T (0); dp^T, then ds^T (1)
        wgmma_fence();
        ss_n64<D>(x, a_op, kStep * kRow, wg == 0 ? qs : os, kStep * kRow);
        wgmma_commit();
        wgmma_wait<0>();
        pin<32>(x);
        const float* l2 = rowsf + st * 2 * kStep;
        if (wg == 0) {
          const int2 qi = SEG ? qinfo[st] : make_int2(1, 0);
          const bool boundary =
              q0 + kStep > S || w.k0 + 64 > S ||
              (causal && q0 < w.k0 + 63) ||
              (window > 0 && q0 + kStep - 1 - w.k0 >= window) ||
              (SEG && !(qi.x && kvi.x && qi.y == kvi.y));
          // The previous p^T has been read before this one is written.
          if (handed) named_barrier(kBarHandEmpty, 256);
          handed = true;
          p_kv_rows<SEG>(x, hand, tid, boundary, o, l2, qseg_s + st * kStep,
                         q0, krow, kseg, S, causal, window, t4);
          named_barrier_arrive_if(kBarHandFull, 256, 1);
        } else {
          named_barrier(kBarHandFull, 256);
          ds_kv_rows(x, hand, tid, l2 + kStep, o.scale, t4);
          named_barrier_arrive_if(kBarHandEmpty, 256, 1);
        }
        uint32_t f[4][4];
        pack_frags(f, x);
        wgmma_fence();
        rs_nd<D>(acc, f, wg == 0 ? os : qs);
        wgmma_commit();
        wgmma_wait<0>();
        pin<D / 2>(acc);
        pin<16>(&f[0][0]);
        mbar_arrive_if(empty + st, lane == 0);  // q, dO and the rows read
      }

      // --------------------------------------------------- epilogue
      unsigned char* out = wg == 0 ? kt : vt;
      stage_out<D, kStep>(out, acc, rl, t4);
      fence_proxy_async();
      named_barrier(1 + wg, 128);
      if (tid == 0) {
        if (w.k0 < S) {
          tma_store_rows<D, kStep>(wg == 0 ? &dvmap : &dkmap, out, 0, w.hk,
                                   w.k0, w.b);
          tma_store_commit();
          tma_store_wait_read();
        }
        mbar_arrive_if(kv_empty + kb, 1);  // the producer may refill it
      }
    }
    // Take warpgroup 1's last arrival on the hand-off barrier.
    if (wg == 0 && handed) named_barrier(kBarHandEmpty, 256);
    return;
  } else {
    const int rl = wg * 64 + warp * 16 + g;  // tile rows rl and rl + 8
    for (int n_local = 0, t; (t = work_index(n_local, blockIdx.x,
                                             gridDim.x)) < n_work;
         ++n_local) {
      const KvWork w = kv_work<KR>(t, S, Hkv, B, causal, window);
      const int kb = n_local & 1;
      const int lo = w.k0 + wg * 64;  // this warpgroup's kv rows
      const int krow[2] = {w.k0 + rl, w.k0 + rl + 8};
      int kseg[2] = {0, 0};
      if (SEG) {
        const int* segb = seg + (size_t)w.b * S;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (krow[i] < S) kseg[i] = segb[krow[i]];
      }
      float dk[D / 2], dv[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

      mbar_wait(kv_full + kb, (n_local >> 1) & 1);
      const int2 kvi = SEG ? kvinfo[2 * kb + wg] : make_int2(1, 0);
      unsigned char* kt = Ks + kb * L::kKVBytes;  // later this tile's dK
      unsigned char* vt = Vs + kb * L::kKVBytes;  // later its dV
      const unsigned char* ka = kt + wg * 64 * kRow;
      const unsigned char* va = vt + wg * 64 * kRow;

      for (int i = 0; i < G * w.nq; ++i, ++it) {
        const int q0 = (w.qt_first + i % w.nq) * kStep;
        const int st = it % ST;
        mbar_wait(full + st, (it / ST) & 1);
        const bool dead = lo >= S || (causal && q0 + kStep - 1 < lo) ||
                          (window > 0 && q0 - (lo + 63) >= window);
        if (dead) {
          mbar_arrive_if(empty + st, lane == 0);
          continue;
        }
        const unsigned char* qs = Qs + st * L::kQBytes;
        const unsigned char* os = Os + st * L::kQBytes;
        float s[32], dp[32];
        wgmma_fence();
        ss_n64<D>(s, ka, kTile * kRow, qs, kStep * kRow);
        ss_n64<D>(dp, va, kTile * kRow, os, kStep * kRow);
        wgmma_commit();
        wgmma_wait<0>();
        pin<32>(s);
        pin<32>(dp);
        const int2 qi = SEG ? qinfo[st] : make_int2(1, 0);
        const bool boundary =
            q0 + kStep > S || lo + 64 > S || (causal && q0 < lo + 63) ||
            (window > 0 && q0 + kStep - 1 - lo >= window) ||
            (SEG && !(qi.x && kvi.x && qi.y == kvi.y));
        const float* l2 = rowsf + st * 2 * kStep;
        p_ds_kv_rows<SEG>(s, dp, boundary, o, l2, l2 + kStep,
                          qseg_s + st * kStep, q0, krow, kseg, S, causal,
                          window, t4);
        uint32_t pf[4][4], sf[4][4];
        pack_frags(pf, s);
        pack_frags(sf, dp);
        wgmma_fence();
        rs_nd<D>(dv, pf, os);
        rs_nd<D>(dk, sf, qs);
        wgmma_commit();
        wgmma_wait<0>();
        pin<D / 2>(dv);
        pin<D / 2>(dk);
        pin<16>(&pf[0][0]);
        pin<16>(&sf[0][0]);
        mbar_arrive_if(empty + st, lane == 0);  // q, dO and the rows read
      }

      // --------------------------------------------------- epilogue
      // dK and dV into this warpgroup's rows of the K and V tiles (only
      // its own wgmmas read them), then TMA stores.
      stage_out<D, kTile>(kt, dk, rl, t4);
      stage_out<D, kTile>(vt, dv, rl, t4);
      fence_proxy_async();
      named_barrier(1 + wg, 128);
      if (tid == 0) {
        if (lo < S) {
          tma_store_rows<D, kTile>(&dkmap, kt, wg, w.hk, lo, w.b);
          tma_store_rows<D, kTile>(&dvmap, vt, wg, w.hk, lo, w.b);
          tma_store_commit();
          tma_store_wait_read();
        }
        mbar_arrive_if(kv_empty + kb, 1);  // the producer may refill it
      }
    }
  }
}

// -------------------------------------------------------------------- dq

template <int D>
struct DqSmem {
  // q and dO double-buffered at D 64 and 128; at D 192 one buffer each,
  // which leaves room for a ring of two K/V stages (192 KB in all).
  static constexpr int kQBufs = D == 192 ? 1 : 2;
  static constexpr int kStages = D == 64 ? 4 : D == 128 ? 3 : 2;
  static constexpr int kQBytes = kTile * D * 2;   // a q or dO tile
  static constexpr int kKVBytes = kStep * D * 2;  // a K or V tile
  static constexpr int kQ = 0;                    // [bufs] q tiles, later dq
  static constexpr int kO = kQ + kQBufs * kQBytes;  // [bufs] dO tiles
  static constexpr int kK = kO + kQBufs * kQBytes;  // [stage] K tiles
  static constexpr int kV = kK + kStages * kKVBytes;  // [stage] V tiles
  static constexpr int kKSeg = kV + kStages * kKVBytes;  // [stage][kStep]
  static constexpr int kKInfo = kKSeg + kStages * kStep * 4;  // [stage]
  static constexpr int kQInfo = kKInfo + kStages * 8;  // [2 bufs][2 wg]
  // mbarriers: q_full[2], q_empty[2], then full[stage], empty[stage].
  static constexpr int kBar = kQInfo + 4 * 8;
  static constexpr int kBytes = kBar + (4 + 2 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;
  static_assert(kAlloc <= kSmemMax, "dq shared memory");
};

// A work tile: (q head, batch, 128-row q tile), numbered longest first:
// under the causal mask q tile qt reads the kv tiles up to its diagonal,
// so t walks the q tiles from the last to the first, and within one the
// heads (fastest) and the batches.
struct QWork {
  int h, b, q0, kt_first, nk;
};

__device__ __forceinline__ QWork q_work(int t, int S, int H, int B,
                                        int causal, int window) {
  const int hb = H * B;
  QWork w;
  w.h = t % H;
  w.b = (t % hb) / H;
  w.q0 = ((S + kTile - 1) / kTile - 1 - t / hb) * kTile;
  int last;
  live_kv_tiles(S, causal, window, w.q0, kTile, kStep, w.kt_first, last);
  w.nk = last - w.kt_first + 1;
  return w;
}

template <int D, bool SEG>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap omap,
                   const __grid_constant__ CUtensorMap dqmap,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const int* __restrict__ seg, int B, int S, int H, int Hkv,
                   float scale, int causal, int window, float softcap) {
  using namespace hopper;
  using L = DqSmem<D>;
  constexpr int ST = L::kStages;
  constexpr int QB = L::kQBufs;
  extern __shared__ unsigned char wg_smem[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_smem) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = sm + L::kQ;
  unsigned char* Os = sm + L::kO;
  unsigned char* Ks = sm + L::kK;
  unsigned char* Vs = sm + L::kV;
  int* kseg_s = reinterpret_cast<int*>(sm + L::kKSeg);
  int2* kinfo = reinterpret_cast<int2*>(sm + L::kKInfo);
  int2* qinfo = reinterpret_cast<int2*>(sm + L::kQInfo);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::kBar);  // [2]
  uint64_t* q_empty = q_full + 2;                                 // [2]
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + ST;
  const int G = H / Hkv;
  const int n_work = (S + kTile - 1) / kTile * H * B;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + i, 1);
      mbar_init(q_empty + i, 2);
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);
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
    int it = 0;
    for (int n_local = 0, t; (t = work_index(n_local, blockIdx.x,
                                             gridDim.x)) < n_work;
         ++n_local) {
      const QWork w = q_work(t, S, H, B, causal, window);
      const int hk = w.h / G;
      const int qb = QB == 2 ? n_local & 1 : 0;
      const int qpar = QB == 2 ? (n_local >> 1) & 1 : n_local & 1;
      const int* segb = SEG ? seg + (size_t)w.b * S : nullptr;
      mbar_wait(q_empty + qb, qpar ^ 1);
      if (SEG) {
        halves_info(segb, w.q0, S, lane, qinfo + 2 * qb);
        __syncwarp();
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(q_full + qb, 2 * L::kQBytes);
        tma_tile<D>(&qmap, q_full + qb, Qs + qb * L::kQBytes, kTile, w.h,
                    w.q0, w.b);
        tma_tile<D>(&omap, q_full + qb, Os + qb * L::kQBytes, kTile, w.h,
                    w.q0, w.b);
      }
      for (int i = 0; i < w.nk; ++i, ++it) {
        const int k0 = (w.kt_first + i) * kStep;
        const int st = it % ST;
        mbar_wait(empty + st, ((it / ST) & 1) ^ 1);
        if (SEG) {
          // The tile's kv ids for the boundary tiles' compares, and
          // whether every column is live and of one document.
          const int2 info =
              rows64_info(segb, k0, S, lane, kseg_s + st * kStep);
          if (lane == 0) kinfo[st] = info;
          __syncwarp();
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(full + st, 2 * L::kKVBytes);
          tma_tile<D>(&kmap, full + st, Ks + st * L::kKVBytes, kStep, hk, k0,
                      w.b);
          tma_tile<D>(&vmap, full + st, Vs + st * L::kKVBytes, kStep, hk, k0,
                      w.b);
        }
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  setmaxnreg_inc<kConsumerRegs>();
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int rl = wg * 64 + warp * 16 + g;  // tile rows rl and rl + 8
  const PdsOpts o = pds_opts(scale, softcap);
  int it = 0;

  for (int n_local = 0, t; (t = work_index(n_local, blockIdx.x,
                                           gridDim.x)) < n_work;
       ++n_local) {
    const QWork w = q_work(t, S, H, B, causal, window);
    const int qb = QB == 2 ? n_local & 1 : 0;
    const int lo = w.q0 + wg * 64;  // this warpgroup's q rows
    const int qrow[2] = {w.q0 + rl, w.q0 + rl + 8};
    const size_t hrow = ((size_t)w.b * H + w.h) * S;
    float lse2[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};
    int qseg[2] = {0, 0};
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (qrow[i] < S) {
        lse2[i] = lse[hrow + qrow[i]] * kLog2e;
        dlt[i] = delta[hrow + qrow[i]];
        if (SEG) qseg[i] = seg[(size_t)w.b * S + qrow[i]];
      }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    mbar_wait(q_full + qb, QB == 2 ? (n_local >> 1) & 1 : n_local & 1);
    const int2 qi = SEG ? qinfo[2 * qb + wg] : make_int2(1, 0);
    unsigned char* qtile = Qs + qb * L::kQBytes;  // later this tile's dq
    const unsigned char* qa = qtile + wg * 64 * kRow;
    const unsigned char* oa = Os + qb * L::kQBytes + wg * 64 * kRow;

    for (int i = 0; i < w.nk; ++i, ++it) {
      const int k0 = (w.kt_first + i) * kStep;
      const int st = it % ST;
      mbar_wait(full + st, (it / ST) & 1);
      const bool dead = lo >= S || (causal && k0 > lo + 63) ||
                        (window > 0 && lo - (k0 + kStep - 1) >= window);
      if (dead) {
        mbar_arrive_if(empty + st, lane == 0);
        continue;
      }
      const unsigned char* ks = Ks + st * L::kKVBytes;
      float s[32], dp[32];
      wgmma_fence();
      ss_n64<D>(s, qa, kTile * kRow, ks, kStep * kRow);
      ss_n64<D>(dp, oa, kTile * kRow, Vs + st * L::kKVBytes, kStep * kRow);
      wgmma_commit();
      wgmma_wait<0>();
      pin<32>(s);
      pin<32>(dp);
      const int2 ki = SEG ? kinfo[st] : make_int2(1, 0);
      const bool boundary =
          lo + 64 > S || k0 + kStep > S || (causal && k0 + kStep - 1 > lo) ||
          (window > 0 && lo + 63 - k0 >= window) ||
          (SEG && !(qi.x && ki.x && qi.y == ki.y));
      ds_q_rows<SEG>(s, dp, boundary, o, lse2, dlt, qrow, qseg,
                     kseg_s + st * kStep, k0, S, causal, window, t4);
      uint32_t sf[4][4];
      pack_frags(sf, dp);
      wgmma_fence();
      rs_nd<D>(dq, sf, ks);
      wgmma_commit();
      wgmma_wait<0>();
      pin<D / 2>(dq);
      pin<16>(&sf[0][0]);
      mbar_arrive_if(empty + st, lane == 0);  // K, V and the ids read
    }

    // ----------------------------------------------------- epilogue
    stage_out<D, kTile>(qtile, dq, rl, t4);
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (tid == 0) {
      if (lo < S) {
        tma_store_rows<D, kTile>(&dqmap, qtile, wg, w.h, lo, w.b);
        tma_store_commit();
        tma_store_wait_read();
      }
      mbar_arrive_if(q_empty + qb, 1);  // the producer may refill it
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA-core bodies: fp32
// ---------------------------------------------------------------------------
//
// The parity path (the tensor cores would round fp32 to tf32): rows are
// staged into shared memory (row stride D + 1) and every product is a
// scalar fp32 FMA over 4 x 4 register tiles. Shared memory is 165 KB
// (dkdv) and 214 KB (dq) at D 192, one block an SM; the accumulators are
// 2 x 4 x D / 16 (dkdv) and 4 x D / 16 (dq) fp32 a thread.

constexpr int kF32Threads = 256;  // 16 x 16 thread grid over a tile
constexpr int kKV3 = 64;  // dkdv: kv rows per block
constexpr int kQ3 = 32;   // dkdv: q rows per inner step
constexpr int kQ4 = 64;   // dq: q rows per block
constexpr int kKV4 = 64;  // dq: kv rows per inner step

// Stage rows [r0, r0 + rows) of a (S, stride) matrix block into smem
// with row stride D + 1; rows past S are zero.
template <int D>
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src,
                                               size_t stride, int r0,
                                               int rows, int S) {
  for (int i = threadIdx.x; i < rows * D; i += kF32Threads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] =
        r0 + r < S ? src[(size_t)(r0 + r) * stride + c] : 0.f;
  }
}

template <int D>
constexpr size_t dkdv_f32_smem() {
  // Ks, Vs [kKV3][D + 1]; Qs, dOs [kQ3][D + 1]; Pt, dSt [kKV3][kQ3 + 1];
  // lse, delta; kv and q segment ids.
  return sizeof(float) * (2 * kKV3 * (D + 1) + 2 * kQ3 * (D + 1) +
                          2 * kKV3 * (kQ3 + 1) + 2 * kQ3) +
         sizeof(int) * (kKV3 + kQ3);
}

// Thread (tx, ty) owns kv rows 4 ty + i. It computes the transposed
// score tile at q columns tx + 16 j, then dk, dv at head dims tx + 16 j.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_dkdv_simt(BwdArgs a) {
  constexpr int KP = D + 1;
  constexpr int PP = kQ3 + 1;
  constexpr int RK = kKV3 / 16;  // kv rows per thread
  constexpr int CQ = kQ3 / 16;   // q columns per thread
  constexpr int DV = D / 16;     // head dims per thread

  extern __shared__ float smem_f[];
  float* Ks = smem_f;
  float* Vs = Ks + kKV3 * KP;
  float* Qs = Vs + kKV3 * KP;
  float* dOs = Qs + kQ3 * KP;
  float* Pt = dOs + kQ3 * KP;
  float* dSt = Pt + kKV3 * PP;
  float* lse_s = dSt + kKV3 * PP;
  float* delta_s = lse_s + kQ3;
  int* kseg_s = reinterpret_cast<int*>(delta_s + kQ3);
  int* qseg_s = kseg_s + kKV3;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kKV3;
  const int S = a.S, H = a.H, G = H / a.Hkv;
  const size_t qstride = (size_t)H * D, kstride = (size_t)a.Hkv * D;
  const size_t kvoff = (size_t)b * S * kstride + (size_t)hk * D;
  const int* segb = a.seg == nullptr ? nullptr : a.seg + (size_t)b * S;

  stage_rows_f32<D>(Ks, static_cast<const float*>(a.k) + kvoff, kstride, k0,
                    kKV3, S);
  stage_rows_f32<D>(Vs, static_cast<const float*>(a.v) + kvoff, kstride, k0,
                    kKV3, S);
  for (int i = tid; i < kKV3; i += kF32Threads)
    kseg_s[i] = segb != nullptr && k0 + i < S ? segb[k0 + i] : 0;

  float dk[RK][DV], dv[RK][DV];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < DV; ++j) dk[i][j] = dv[i][j] = 0.f;

  int qt_first, qt_last;
  live_q_tiles(a.S, a.causal, a.window, k0, kKV3, kQ3, qt_first,
               qt_last);
  for (int hh = 0; hh < G; ++hh) {
    const int h = hk * G + hh;
    const size_t qoff = (size_t)b * S * qstride + (size_t)h * D;
    const float* lseb = a.lse + ((size_t)b * H + h) * S;
    const float* deltab = a.delta + ((size_t)b * H + h) * S;
    for (int qt = qt_first; qt <= qt_last; ++qt) {
      const int q0 = qt * kQ3;
      __syncthreads();  // the previous q tile, Pt and dSt are consumed
      stage_rows_f32<D>(Qs, static_cast<const float*>(a.q) + qoff, qstride,
                        q0, kQ3, S);
      stage_rows_f32<D>(dOs, static_cast<const float*>(a.dout) + qoff,
                        qstride, q0, kQ3, S);
      for (int i = tid; i < kQ3; i += kF32Threads) {
        const bool in = q0 + i < S;
        lse_s[i] = in ? lseb[q0 + i] : 0.f;
        delta_s[i] = in ? deltab[q0 + i] : 0.f;
        qseg_s[i] = segb != nullptr && in ? segb[q0 + i] : 0;
      }
      __syncthreads();

      float st[RK][CQ], dpt[RK][CQ];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < CQ; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[RK], vv[RK], qv[CQ], ov[CQ];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          kv[i] = Ks[(ty * RK + i) * KP + d];
          vv[i] = Vs[(ty * RK + i) * KP + d];
        }
#pragma unroll
        for (int j = 0; j < CQ; ++j) {
          qv[j] = Qs[(tx + 16 * j) * KP + d];
          ov[j] = dOs[(tx + 16 * j) * KP + d];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < CQ; ++j) {
            st[i][j] += kv[i] * qv[j];
            dpt[i][j] += vv[i] * ov[j];
          }
      }
#pragma unroll
      for (int i = 0; i < RK; ++i) {
#pragma unroll
        for (int j = 0; j < CQ; ++j) {
          const int kl = ty * RK + i, ql = tx + 16 * j;
          float p, ds;
          p_ds(a, st[i][j], dpt[i][j], q0 + ql, k0 + kl,
               qseg_s[ql] == kseg_s[kl], lse_s[ql], delta_s[ql], p, ds);
          Pt[kl * PP + ql] = p;
          dSt[kl * PP + ql] = ds;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int ql = 0; ql < kQ3; ++ql) {
        float pv[RK], sv[RK], ov[DV], qv[DV];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pv[i] = Pt[(ty * RK + i) * PP + ql];
          sv[i] = dSt[(ty * RK + i) * PP + ql];
        }
#pragma unroll
        for (int j = 0; j < DV; ++j) {
          ov[j] = dOs[ql * KP + tx + 16 * j];
          qv[j] = Qs[ql * KP + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < DV; ++j) {
            dv[i][j] += pv[i] * ov[j];
            dk[i][j] += sv[i] * qv[j];
          }
      }
    }
  }

  float* dkb = static_cast<float*>(a.dk) + kvoff;
  float* dvb = static_cast<float*>(a.dv) + kvoff;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int row = k0 + ty * RK + i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < DV; ++j) {
      dkb[(size_t)row * kstride + tx + 16 * j] = dk[i][j];
      dvb[(size_t)row * kstride + tx + 16 * j] = dv[i][j];
    }
  }
}

template <int D>
constexpr size_t dq_f32_smem() {
  // Qs, dOs [kQ4][D + 1]; Ks, Vs [kKV4][D + 1]; dSs [kQ4][kKV4 + 1]; kv
  // segment ids.
  return sizeof(float) * (2 * kQ4 * (D + 1) + 2 * kKV4 * (D + 1) +
                          kQ4 * (kKV4 + 1)) +
         sizeof(int) * kKV4;
}

// Thread (tx, ty) owns q rows 4 ty + i. It computes the score tile at kv
// columns tx + 16 j, then dq at head dims tx + 16 j.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_dq_simt(BwdArgs a) {
  constexpr int KP = D + 1;
  constexpr int SP = kKV4 + 1;
  constexpr int RQ = kQ4 / 16;   // q rows per thread
  constexpr int CK = kKV4 / 16;  // kv columns per thread
  constexpr int DV = D / 16;

  extern __shared__ float smem_f[];
  float* Qs = smem_f;
  float* dOs = Qs + kQ4 * KP;
  float* Ks = dOs + kQ4 * KP;
  float* Vs = Ks + kKV4 * KP;
  float* dSs = Vs + kKV4 * KP;
  int* kseg_s = reinterpret_cast<int*>(dSs + kQ4 * SP);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kQ4;
  const int S = a.S, H = a.H, hk = h / (H / a.Hkv);
  const size_t qstride = (size_t)H * D, kstride = (size_t)a.Hkv * D;
  const size_t qoff = (size_t)b * S * qstride + (size_t)h * D;
  const size_t kvoff = (size_t)b * S * kstride + (size_t)hk * D;
  const int* segb = a.seg == nullptr ? nullptr : a.seg + (size_t)b * S;

  stage_rows_f32<D>(Qs, static_cast<const float*>(a.q) + qoff, qstride, q0,
                    kQ4, S);
  stage_rows_f32<D>(dOs, static_cast<const float*>(a.dout) + qoff, qstride,
                    q0, kQ4, S);
  float lse_r[RQ], delta_r[RQ], dq[RQ][DV];
  int qseg[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    const bool in = row < S;
    lse_r[i] = in ? a.lse[((size_t)b * H + h) * S + row] : 0.f;
    delta_r[i] = in ? a.delta[((size_t)b * H + h) * S + row] : 0.f;
    qseg[i] = segb != nullptr && in ? segb[row] : 0;
#pragma unroll
    for (int j = 0; j < DV; ++j) dq[i][j] = 0.f;
  }

  int kt_first, kt_last;
  live_kv_tiles(a.S, a.causal, a.window, q0, kQ4, kKV4, kt_first,
                kt_last);
  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int k0 = kt * kKV4;
    __syncthreads();  // the previous kv tile and dSs are consumed
    stage_rows_f32<D>(Ks, static_cast<const float*>(a.k) + kvoff, kstride,
                      k0, kKV4, S);
    stage_rows_f32<D>(Vs, static_cast<const float*>(a.v) + kvoff, kstride,
                      k0, kKV4, S);
    for (int i = tid; i < kKV4; i += kF32Threads)
      kseg_s[i] = segb != nullptr && k0 + i < S ? segb[k0 + i] : 0;
    __syncthreads();

    float sc[RQ][CK], dp[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RQ], ov[RQ], kv[CK], vv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        qv[i] = Qs[(ty * RQ + i) * KP + d];
        ov[i] = dOs[(ty * RQ + i) * KP + d];
      }
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        kv[j] = Ks[(tx + 16 * j) * KP + d];
        vv[j] = Vs[(tx + 16 * j) * KP + d];
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          sc[i][j] += qv[i] * kv[j];
          dp[i][j] += ov[i] * vv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int ql = ty * RQ + i, kl = tx + 16 * j;
        float p, ds;
        p_ds(a, sc[i][j], dp[i][j], q0 + ql, k0 + kl,
             qseg[i] == kseg_s[kl], lse_r[i], delta_r[i], p, ds);
        dSs[ql * SP + kl] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kl = 0; kl < kKV4; ++kl) {
      float sv[RQ], kv[DV];
#pragma unroll
      for (int i = 0; i < RQ; ++i) sv[i] = dSs[(ty * RQ + i) * SP + kl];
#pragma unroll
      for (int j = 0; j < DV; ++j) kv[j] = Ks[kl * KP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < DV; ++j) dq[i][j] += sv[i] * kv[j];
    }
  }

  float* dqb = static_cast<float*>(a.dq) + qoff;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < DV; ++j)
      dqb[(size_t)row * qstride + tx + 16 * j] = dq[i][j];
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t run(K kernel, dim3 grid, int threads, size_t smem,
                const BwdArgs& a, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D, bool SEG>
cudaError_t launch_dkdv_wgmma(const BwdArgs& a, int B, cudaStream_t s) {
  using hopper::tensor_map;
  CUtensorMap qm, km, vm, om, dkm, dvm;
  cudaError_t err;
  if ((err = tensor_map(&qm, a.q, B, a.S, a.H, D, kStep)) != cudaSuccess ||
      (err = tensor_map(&km, a.k, B, a.S, a.Hkv, D, kStep)) != cudaSuccess ||
      (err = tensor_map(&vm, a.v, B, a.S, a.Hkv, D, kStep)) != cudaSuccess ||
      (err = tensor_map(&om, a.dout, B, a.S, a.H, D, kStep)) !=
          cudaSuccess ||
      (err = tensor_map(&dkm, a.dk, B, a.S, a.Hkv, D, kStep)) !=
          cudaSuccess ||
      (err = tensor_map(&dvm, a.dv, B, a.S, a.Hkv, D, kStep)) != cudaSuccess)
    return err;
  auto kernel = flash_bwd_dkdv_wgmma<D, SEG>;
  constexpr size_t smem = DkdvSmem<D>::kAlloc;
  constexpr int rows = DkdvSmem<D>::kKVRows;
  if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
  int ctas;
  if ((err = hopper::persistent_ctas((a.S + rows - 1) / rows * a.Hkv * B,
                                     &ctas)) != cudaSuccess)
    return err;
  kernel<<<ctas, kWgThreads, smem, s>>>(qm, km, vm, om, dkm, dvm, a.lse,
                                        a.delta, a.seg, B, a.S, a.H, a.Hkv,
                                        a.scale, a.causal, a.window,
                                        a.softcap);
  return cudaGetLastError();
}

template <int D, bool SEG>
cudaError_t launch_dq_wgmma(const BwdArgs& a, int B, cudaStream_t s) {
  using hopper::tensor_map;
  CUtensorMap qm, km, vm, om, dqm;
  cudaError_t err;
  if ((err = tensor_map(&qm, a.q, B, a.S, a.H, D, kStep)) != cudaSuccess ||
      (err = tensor_map(&km, a.k, B, a.S, a.Hkv, D, kStep)) != cudaSuccess ||
      (err = tensor_map(&vm, a.v, B, a.S, a.Hkv, D, kStep)) != cudaSuccess ||
      (err = tensor_map(&om, a.dout, B, a.S, a.H, D, kStep)) !=
          cudaSuccess ||
      (err = tensor_map(&dqm, a.dq, B, a.S, a.H, D, kStep)) != cudaSuccess)
    return err;
  auto kernel = flash_bwd_dq_wgmma<D, SEG>;
  constexpr size_t smem = DqSmem<D>::kAlloc;
  if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
  int ctas;
  if ((err = hopper::persistent_ctas(
           (a.S + kTile - 1) / kTile * a.H * B, &ctas)) != cudaSuccess)
    return err;
  kernel<<<ctas, kWgThreads, smem, s>>>(qm, km, vm, om, dqm, a.lse, a.delta,
                                        a.seg, B, a.S, a.H, a.Hkv, a.scale,
                                        a.causal, a.window, a.softcap);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkdv_simt(const BwdArgs& a, int B, cudaStream_t s) {
  return run(flash_bwd_dkdv_simt<D>,
             dim3((a.S + kKV3 - 1) / kKV3, a.Hkv, B), kF32Threads,
             dkdv_f32_smem<D>(), a, s);
}

template <int D>
cudaError_t launch_dq_simt(const BwdArgs& a, int B, cudaStream_t s) {
  return run(flash_bwd_dq_simt<D>, dim3((a.S + kQ4 - 1) / kQ4, a.H, B),
             kF32Threads, dq_f32_smem<D>(), a, s);
}

template <int D>
cudaError_t launch_dkdv(const BwdArgs& a, int B, int dtype,
                        cudaStream_t s) {
  if (dtype == kF32) return launch_dkdv_simt<D>(a, B, s);
  return a.seg != nullptr ? launch_dkdv_wgmma<D, true>(a, B, s)
                          : launch_dkdv_wgmma<D, false>(a, B, s);
}

template <int D>
cudaError_t launch_dq(const BwdArgs& a, int B, int dtype, cudaStream_t s) {
  if (dtype == kF32) return launch_dq_simt<D>(a, B, s);
  return a.seg != nullptr ? launch_dq_wgmma<D, true>(a, B, s)
                          : launch_dq_wgmma<D, false>(a, B, s);
}

BwdArgs make_args(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  const void* seg, void* dq, void* dk, void* dv, int S,
                  int H, int Hkv, float scale, int causal, int window,
                  float softcap) {
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.seg = static_cast<const int*>(seg);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.S = S;
  a.H = H;
  a.Hkv = Hkv;
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  a.softcap = softcap;
  return a;
}

}  // namespace
}  // namespace shellac

// Kernel 3: dk, dv (B, S, Hkv, D) in the inputs' dtype. lse and delta are
// (B, H, S) fp32; seg (B, S) int32 may be null; window <= 0: none;
// softcap <= 0: none.
extern "C" int shellac_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg, void* dk, void* dv,
    int B, int S, int H, int Hkv, int D, float scale, int causal, int window,
    float softcap, int dtype, void* stream) {
  using namespace shellac;
  if (dtype != kF32 && dtype != kBF16) return (int)cudaErrorInvalidValue;
  const BwdArgs a = make_args(q, k, v, dout, lse, delta, seg, nullptr, dk,
                              dv, S, H, Hkv, scale, causal, window, softcap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch_dkdv<64>(a, B, dtype, s);
  if (D == 128) return (int)launch_dkdv<128>(a, B, dtype, s);
  if (D == 192) return (int)launch_dkdv<192>(a, B, dtype, s);
  return (int)cudaErrorInvalidValue;
}

// Kernel 4: dq (B, S, H, D) in the inputs' dtype; arguments as above.
extern "C" int shellac_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg, void* dq, int B,
    int S, int H, int Hkv, int D, float scale, int causal, int window,
    float softcap, int dtype, void* stream) {
  using namespace shellac;
  if (dtype != kF32 && dtype != kBF16) return (int)cudaErrorInvalidValue;
  const BwdArgs a = make_args(q, k, v, dout, lse, delta, seg, dq, nullptr,
                              nullptr, S, H, Hkv, scale, causal, window,
                              softcap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch_dq<64>(a, B, dtype, s);
  if (D == 128) return (int)launch_dq<128>(a, B, dtype, s);
  if (D == 192) return (int)launch_dq<192>(a, B, dtype, s);
  return (int)cudaErrorInvalidValue;
}
