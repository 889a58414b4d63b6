// Flash-attention backward over q (B, S, H, D), k/v (B, S, Hkv, D).
//
// Two kernels, one per pass of `_flash_backward` (shellac_tpu/ops/
// flash_attention.py):
//   - dkdv replaces `_flash_bwd_dkdv_kernel`: dk and dv of one 64-row kv
//     tile of one kv head, summed inside the block over every q tile of
//     every q head of its GQA group (the TPU grid's sequential
//     (G * q_blocks) axis becomes a loop), so no atomics are needed;
//   - dq replaces `_flash_bwd_dq_kernel`: dq of one 64-row q tile of one
//     q head, over the kv tiles it can see.
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
// What changes for Hopper: the TPU's VMEM scratch accumulators, carried
// across grid steps, become registers carried across a loop inside one
// thread block. Two bodies, as in the forward:
//   - bf16: mma.sync m16n8k16 (bf16 in, fp32 accumulate), 4 warps of 16
//     rows. dkdv computes the transposed tiles s^T = K Q^T and
//     dp^T = V dO^T, so p^T and ds^T come out of the accumulators already
//     in the A-operand layout of dv += p^T dO and dk += ds^T Q; q and dO
//     are staged twice, row-major for the first products and transposed
//     for the second. dq keeps its tile's q and dO in shared memory and
//     stages k twice for the same reason.
//   - fp32: scalar fp32 FMAs over 4 x 4 register tiles per thread (the
//     tensor cores would round fp32 inputs to tf32).
//
// Bound on the H100: at the training shape (B 6, S 2048, H 16, Hkv 8,
// D 128, causal) both kernels are bound by operations (dkdv four
// products, dq three, over the causal half of the score matrix), not by
// bytes. This version issues mma.sync from plain shared-memory loads with
// no pipelining; wgmma fed by TMA through multi-stage buffers is the step
// towards that bound.
#include "common.cuh"

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
__device__ __forceinline__ void live_q_tiles(const BwdArgs& a, int k0,
                                             int rows, int bq, int& first,
                                             int& last) {
  first = a.causal ? k0 / bq : 0;
  last = (a.S + bq - 1) / bq - 1;
  if (a.window > 0) last = min(last, (k0 + rows - 1 + a.window - 1) / bq);
}

// kv tiles [first, last] that q rows [q0, q0 + rows) can see.
__device__ __forceinline__ void live_kv_tiles(const BwdArgs& a, int q0,
                                              int rows, int bk, int& first,
                                              int& last) {
  last = (a.S + bk - 1) / bk - 1;
  if (a.causal) last = min(last, (q0 + rows - 1) / bk);
  first = a.window > 0 ? max(q0 - a.window + 1, 0) / bk : 0;
}

// ---------------------------------------------------------------------------
// bf16 bodies
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr int kCH = 8;         // bf16 per 16-byte load
constexpr int kKV3 = 64;       // dkdv: kv rows per block
constexpr int kQ3 = 32;        // dkdv: q rows per inner step
constexpr int kQ4 = 64;        // dq: q rows per block
constexpr int kKV4 = 64;       // dq: kv rows per inner step

template <int D>
constexpr size_t dkdv_bf16_smem() {
  // Ks, Vs [kKV3][D + 8]; Qs, dOs [kQ3][D + 8]; Qt, dOt [D][kQ3 + 8];
  // lse and delta of the q tile; kv and q segment ids.
  return sizeof(bf16) * (2 * kKV3 * (D + 8) + 2 * kQ3 * (D + 8) +
                         2 * D * (kQ3 + 8)) +
         sizeof(float) * 2 * kQ3 + sizeof(int) * (kKV3 + kQ3);
}

// Stage rows [r0, r0 + rows) of a (S, stride) bf16 matrix block into
// row-major smem (row stride RP); rows past S are zero. Neighbouring
// threads take neighbouring 16-byte chunks of a row.
template <int D, int RP>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           size_t stride, int r0, int rows,
                                           int S) {
  for (int i = threadIdx.x; i < rows * D / kCH; i += kThreads) {
    const int r = i / (D / kCH), c = (i % (D / kCH)) * kCH;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (r0 + r < S)
      u = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * stride +
                                          c);
    *reinterpret_cast<uint4*>(dst + r * RP + c) = u;
  }
}

// The same rows staged twice: row-major (stride RP) and transposed
// ([D][TP]). Neighbouring threads take neighbouring rows, so the 2-byte
// transposed stores fall in distinct banks.
template <int D, int RP, int TP>
__device__ __forceinline__ void stage_rows_both(bf16* dst, bf16* dst_t,
                                                const bf16* src,
                                                size_t stride, int r0,
                                                int rows, int S) {
  for (int i = threadIdx.x; i < rows * D / kCH; i += kThreads) {
    const int r = i % rows, c = (i / rows) * kCH;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (r0 + r < S)
      u = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * stride +
                                          c);
    *reinterpret_cast<uint4*>(dst + r * RP + c) = u;
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int j = 0; j < kCH; ++j) dst_t[(c + j) * TP + r] = e[j];
  }
}

// A fragment of rows [row, row + 16), columns [col, col + 16) of a
// row-major bf16 tile with row stride P.
template <int P>
__device__ __forceinline__ void load_a(uint32_t* f, const bf16* t, int row,
                                       int col, int g, int t4) {
  const bf16* p = t + (row + g) * P + col + t4 * 2;
  f[0] = ld32(p);
  f[1] = ld32(p + 8 * P);
  f[2] = ld32(p + 8);
  f[3] = ld32(p + 8 * P + 8);
}

// B fragment of the 16 x 8 product operand whose column n is row
// (n0 + n) of a row-major tile with row stride P (k runs along the row).
template <int P>
__device__ __forceinline__ void load_b(uint32_t* f, const bf16* t, int n0,
                                       int k0, int g, int t4) {
  const bf16* p = t + (n0 + g) * P + k0 + t4 * 2;
  f[0] = ld32(p);
  f[1] = ld32(p + 8);
}

// Two 8-column accumulator blocks (16 x 16) as one A fragment, rounded
// to bf16.
__device__ __forceinline__ void pack_a(uint32_t* f, const float* lo,
                                       const float* hi) {
  f[0] = pack_bf16(lo[0], lo[1]);
  f[1] = pack_bf16(lo[2], lo[3]);
  f[2] = pack_bf16(hi[0], hi[1]);
  f[3] = pack_bf16(hi[2], hi[3]);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_bf16(BwdArgs a) {
  constexpr int RP = D + 8;    // row stride of Ks, Vs, Qs, dOs
  constexpr int TP = kQ3 + 8;  // row stride of Qt, dOt
  constexpr int KD = D / 16;   // k-steps over the head dim
  constexpr int NB = kQ3 / 8;  // 8-column blocks of the q tile
  constexpr int ND = D / 8;    // 8-column blocks of dk, dv

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kKV3 * RP;
  bf16* Qs = Vs + kKV3 * RP;
  bf16* dOs = Qs + kQ3 * RP;
  bf16* Qt = dOs + kQ3 * RP;
  bf16* dOt = Qt + D * TP;
  float* lse_s = reinterpret_cast<float*>(dOt + D * TP);
  float* delta_s = lse_s + kQ3;
  int* kseg_s = reinterpret_cast<int*>(delta_s + kQ3);
  int* qseg_s = kseg_s + kKV3;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kKV3;
  const int S = a.S, H = a.H, G = H / a.Hkv;
  const size_t qstride = (size_t)H * D, kstride = (size_t)a.Hkv * D;
  const size_t kvoff = (size_t)b * S * kstride + (size_t)hk * D;
  const int* segb = a.seg == nullptr ? nullptr : a.seg + (size_t)b * S;

  stage_rows<D, RP>(Ks, static_cast<const bf16*>(a.k) + kvoff, kstride, k0,
                    kKV3, S);
  stage_rows<D, RP>(Vs, static_cast<const bf16*>(a.v) + kvoff, kstride, k0,
                    kKV3, S);
  for (int i = tid; i < kKV3; i += kThreads)
    kseg_s[i] = segb != nullptr && k0 + i < S ? segb[k0 + i] : 0;

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  int qt_first, qt_last;
  live_q_tiles(a, k0, kKV3, kQ3, qt_first, qt_last);
  const int kr = warp * 16;  // this warp's kv rows in the tile

  for (int hh = 0; hh < G; ++hh) {
    const int h = hk * G + hh;
    const size_t qoff = (size_t)b * S * qstride + (size_t)h * D;
    const float* lseb = a.lse + ((size_t)b * H + h) * S;
    const float* deltab = a.delta + ((size_t)b * H + h) * S;
    for (int qt = qt_first; qt <= qt_last; ++qt) {
      const int q0 = qt * kQ3;
      __syncthreads();  // the previous q tile is consumed
      stage_rows_both<D, RP, TP>(Qs, Qt,
                                 static_cast<const bf16*>(a.q) + qoff,
                                 qstride, q0, kQ3, S);
      stage_rows_both<D, RP, TP>(dOs, dOt,
                                 static_cast<const bf16*>(a.dout) + qoff,
                                 qstride, q0, kQ3, S);
      for (int i = tid; i < kQ3; i += kThreads) {
        const bool in = q0 + i < S;
        lse_s[i] = in ? lseb[q0 + i] : 0.f;
        delta_s[i] = in ? deltab[q0 + i] : 0.f;
        qseg_s[i] = segb != nullptr && in ? segb[q0 + i] : 0;
      }
      __syncthreads();

      // s^T = K Q^T and dp^T = V dO^T over this warp's 16 kv rows.
      float st[NB][4], dpt[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nb][e] = dpt[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ka[4], va[4];
        load_a<RP>(ka, Ks, kr, kk * 16, g, t4);
        load_a<RP>(va, Vs, kr, kk * 16, g, t4);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          uint32_t qf[2], of[2];
          load_b<RP>(qf, Qs, nb * 8, kk * 16, g, t4);
          load_b<RP>(of, dOs, nb * 8, kk * 16, g, t4);
          mma_16816(st[nb], ka, qf);
          mma_16816(dpt[nb], va, of);
        }
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = kr + g + (e >> 1) * 8;
          const int ql = nb * 8 + t4 * 2 + (e & 1);
          float p, ds;
          p_ds(a, st[nb][e], dpt[nb][e], q0 + ql, k0 + kl,
               qseg_s[ql] == kseg_s[kl], lse_s[ql], delta_s[ql], p, ds);
          st[nb][e] = p;
          dpt[nb][e] = ds;
        }
      }
      // dv += p^T dO and dk += ds^T Q over the tile's q rows.
#pragma unroll
      for (int kk = 0; kk < kQ3 / 16; ++kk) {
        uint32_t pa[4], sa[4];
        pack_a(pa, st[2 * kk], st[2 * kk + 1]);
        pack_a(sa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          uint32_t of[2], qf[2];
          load_b<TP>(of, dOt, nd * 8, kk * 16, g, t4);
          load_b<TP>(qf, Qt, nd * 8, kk * 16, g, t4);
          mma_16816(dv[nd], pa, of);
          mma_16816(dk[nd], sa, qf);
        }
      }
    }
  }

  bf16* dkb = static_cast<bf16*>(a.dk) + kvoff;
  bf16* dvb = static_cast<bf16*>(a.dv) + kvoff;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + kr + g + 8 * i;
    if (row >= S) continue;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const size_t o = (size_t)row * kstride + nd * 8 + t4 * 2;
      *reinterpret_cast<uint32_t*>(dkb + o) =
          pack_bf16(dk[nd][2 * i], dk[nd][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dvb + o) =
          pack_bf16(dv[nd][2 * i], dv[nd][2 * i + 1]);
    }
  }
}

template <int D>
constexpr size_t dq_bf16_smem() {
  // Qs, dOs [kQ4][D + 8]; Ks, Vs [kKV4][D + 8]; Kt [D][kKV4 + 8]; kv
  // segment ids.
  return sizeof(bf16) * (2 * kQ4 * (D + 8) + 2 * kKV4 * (D + 8) +
                         D * (kKV4 + 8)) +
         sizeof(int) * kKV4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16(BwdArgs a) {
  constexpr int RP = D + 8;
  constexpr int TP = kKV4 + 8;  // row stride of Kt
  constexpr int KD = D / 16;
  constexpr int NB = kKV4 / 8;  // 8-column blocks of the kv tile
  constexpr int ND = D / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kQ4 * RP;
  bf16* Ks = dOs + kQ4 * RP;
  bf16* Vs = Ks + kKV4 * RP;
  bf16* Kt = Vs + kKV4 * RP;
  int* kseg_s = reinterpret_cast<int*>(Kt + D * TP);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kQ4;
  const int S = a.S, H = a.H, hk = h / (H / a.Hkv);
  const size_t qstride = (size_t)H * D, kstride = (size_t)a.Hkv * D;
  const size_t qoff = (size_t)b * S * qstride + (size_t)h * D;
  const size_t kvoff = (size_t)b * S * kstride + (size_t)hk * D;
  const int* segb = a.seg == nullptr ? nullptr : a.seg + (size_t)b * S;

  stage_rows<D, RP>(Qs, static_cast<const bf16*>(a.q) + qoff, qstride, q0,
                    kQ4, S);
  stage_rows<D, RP>(dOs, static_cast<const bf16*>(a.dout) + qoff, qstride,
                    q0, kQ4, S);

  const int qr = warp * 16;  // this warp's q rows in the tile
  float lse_r[2], delta_r[2];
  int qseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + qr + g + 8 * i;
    const bool in = row < S;
    lse_r[i] = in ? a.lse[((size_t)b * H + h) * S + row] : 0.f;
    delta_r[i] = in ? a.delta[((size_t)b * H + h) * S + row] : 0.f;
    qseg[i] = segb != nullptr && in ? segb[row] : 0;
  }

  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  int kt_first, kt_last;
  live_kv_tiles(a, q0, kQ4, kKV4, kt_first, kt_last);
  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int k0 = kt * kKV4;
    __syncthreads();  // the previous kv tile is consumed
    stage_rows_both<D, RP, TP>(Ks, Kt, static_cast<const bf16*>(a.k) + kvoff,
                               kstride, k0, kKV4, S);
    stage_rows<D, RP>(Vs, static_cast<const bf16*>(a.v) + kvoff, kstride, k0,
                      kKV4, S);
    for (int i = tid; i < kKV4; i += kThreads)
      kseg_s[i] = segb != nullptr && k0 + i < S ? segb[k0 + i] : 0;
    __syncthreads();

    // s = Q K^T and dp = dO V^T over this warp's 16 q rows.
    float sc[NB][4], dp[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], oa[4];
      load_a<RP>(qa, Qs, qr, kk * 16, g, t4);
      load_a<RP>(oa, dOs, qr, kk * 16, g, t4);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        uint32_t kf[2], vf[2];
        load_b<RP>(kf, Ks, nb * 8, kk * 16, g, t4);
        load_b<RP>(vf, Vs, nb * 8, kk * 16, g, t4);
        mma_16816(sc[nb], qa, kf);
        mma_16816(dp[nb], oa, vf);
      }
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kl = nb * 8 + t4 * 2 + (e & 1);
        float p, ds;
        p_ds(a, sc[nb][e], dp[nb][e], q0 + qr + g + 8 * i, k0 + kl,
             qseg[i] == kseg_s[kl], lse_r[i], delta_r[i], p, ds);
        sc[nb][e] = ds;
      }
    }
    // dq += ds K over the tile's kv rows.
#pragma unroll
    for (int kk = 0; kk < kKV4 / 16; ++kk) {
      uint32_t sa[4];
      pack_a(sa, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        uint32_t kf[2];
        load_b<TP>(kf, Kt, nd * 8, kk * 16, g, t4);
        mma_16816(dq[nd], sa, kf);
      }
    }
  }

  bf16* dqb = static_cast<bf16*>(a.dq) + qoff;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + qr + g + 8 * i;
    if (row >= S) continue;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<uint32_t*>(dqb + (size_t)row * qstride + nd * 8 +
                                   t4 * 2) =
          pack_bf16(dq[nd][2 * i], dq[nd][2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// fp32 bodies
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;  // 16 x 16 thread grid over a tile

// Stage rows [r0, r0 + rows) of a (S, stride) fp32 matrix block into smem
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
flash_bwd_dkdv_f32(BwdArgs a) {
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
  live_q_tiles(a, k0, kKV3, kQ3, qt_first, qt_last);
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
flash_bwd_dq_f32(BwdArgs a) {
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
  live_kv_tiles(a, q0, kQ4, kKV4, kt_first, kt_last);
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

template <int D>
cudaError_t launch_dkdv(const BwdArgs& a, int B, int dtype,
                        cudaStream_t s) {
  dim3 grid((a.S + kKV3 - 1) / kKV3, a.Hkv, B);
  if (dtype == kF32)
    return run(flash_bwd_dkdv_f32<D>, grid, kF32Threads, dkdv_f32_smem<D>(),
               a, s);
  return run(flash_bwd_dkdv_bf16<D>, grid, kThreads, dkdv_bf16_smem<D>(), a,
             s);
}

template <int D>
cudaError_t launch_dq(const BwdArgs& a, int B, int dtype, cudaStream_t s) {
  dim3 grid((a.S + kQ4 - 1) / kQ4, a.H, B);
  if (dtype == kF32)
    return run(flash_bwd_dq_f32<D>, grid, kF32Threads, dq_f32_smem<D>(), a,
               s);
  return run(flash_bwd_dq_bf16<D>, grid, kThreads, dq_bf16_smem<D>(), a, s);
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
  return (int)cudaErrorInvalidValue;
}
