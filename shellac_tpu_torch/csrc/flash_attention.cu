// Flash-attention forward over q (B, S, H, D), k/v (B, S, Hkv, D).
//
// Replaces the Pallas kernel `_flash_kernel` (shellac_tpu/ops/
// flash_attention.py), launched by `_flash_forward`, for serving and for
// training: causal or not, sliding window, Gemma-2 softcap, GPT-OSS sinks,
// GQA, packed segments (one (B, S) int32 row shared by q and kv, as
// `_scores` masks them), and the logsumexp rows (B, H, S) fp32 the
// backward kernels read (sink-inclusive, as `_flash_kernel`'s
// finalizer writes them). The serving calls pass no segments and no lse
// pointer, and nothing is written there.
//
// What it keeps from the TPU kernel: the online softmax with m, l and the
// output accumulator in fp32; the scale applied in fp32 (to q in the fp32
// body, as the TPU kernel does; to the fp32 scores in the bf16 body, so
// q is not rounded to bf16 after scaling); softcap before the causal,
// window and segment masks; the fully-masked-tile gate (p = 0 where s is
// the NEG_INF sentinel, so a tile no row can see leaves the accumulator
// untouched); p rounded to v's dtype before the p.V product while l sums
// the unrounded p; sinks folded in at the end as sink_rebase does; kv
// tiles outside [first live tile of the window, causal diagonal] neither
// loaded nor computed (`_make_clamp_ki`); GQA through kv head h / G.
//
// What changes for Hopper: the TPU walks kv blocks as a sequential grid
// axis carrying VMEM scratch; here one thread block owns one (batch, q
// head, 64-row q tile) and loops over 64-row kv tiles itself, staging
// each k and v tile in shared memory. The ragged tail of any S is masked
// in-kernel, so no length gate is needed. Two bodies:
//   - bf16: tensor cores through mma.sync m16n8k16 (bf16 in, fp32
//     accumulate). Each of the 4 warps owns 16 q rows; its q fragments,
//     scores and output stay in registers, and the score accumulators
//     are re-packed in place as the A operand of the p.V product. v is
//     stored transposed so its B fragments are contiguous.
//   - fp32: scalar fp32 FMAs over a 4x4 register tile per thread (the
//     tensor cores would round fp32 inputs to tf32).
//
// Bound on the H100: at the serving prefill shape (S = 512, D = 128) the
// bytes bound (q, k, v, out once each) and the operations bound are
// within 1.5x of each other. This version uses mma.sync with plain loads
// and no pipelining; wgmma with TMA-fed, multi-stage shared memory is the
// step towards either bound.
#include "common.cuh"

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

// bf16 body: tensor cores.
constexpr int kMmaThreads = 128;  // 4 warps x 16 q rows

template <int D>
constexpr size_t bf16_smem_bytes() {
  // Qs and Ks [64][D + 8], Vt [D][64 + 8]: 16-byte padded rows keep the
  // fragment loads free of bank conflicts; then the kv segment ids.
  return sizeof(__nv_bfloat16) *
             (kBQ * (D + 8) + kBK * (D + 8) + D * (kBK + 8)) +
         sizeof(int) * kBK;
}

// mma.sync fragment layout: see common.cuh. SEG as in the fp32 body.
template <int D, bool SEG>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const float* __restrict__ sinks,
               const int* __restrict__ seg, __nv_bfloat16* __restrict__ out,
               float* __restrict__ lse, int S, int H, int Hkv, float scale,
               int causal, int window, float softcap) {
  using bf16 = __nv_bfloat16;
  constexpr int QP = D + 8;    // Qs/Ks row stride (elements)
  constexpr int VP = kBK + 8;  // Vt row stride
  constexpr int KD = D / 16;   // k-steps over the head dim
  constexpr int NB = kBK / 8;  // 8-column blocks of the score tile
  constexpr int ND = D / 8;    // 8-column blocks of the output
  constexpr int CH = 8;        // bf16 per 16-byte load

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][QP]
  bf16* Ks = Qs + kBQ * QP;                      // [kBK][QP]
  bf16* Vt = Ks + kBK * QP;                      // [D][VP], v transposed
  int* Kseg = reinterpret_cast<int*>(Vt + D * VP);  // [kBK]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const size_t qstride = (size_t)H * D;
  const size_t kstride = (size_t)Hkv * D;
  const bf16* qb = q + (size_t)b * S * qstride + (size_t)h * D;
  const bf16* kb = k + (size_t)b * S * kstride + (size_t)hk * D;
  const bf16* vb = v + (size_t)b * S * kstride + (size_t)hk * D;

  for (int i = tid; i < kBQ * D / CH; i += kMmaThreads) {
    const int r = i / (D / CH), c = (i % (D / CH)) * CH;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (q0 + r < S)
      u = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * qstride +
                                          c);
    *reinterpret_cast<uint4*>(Qs + r * QP + c) = u;
  }
  __syncthreads();
  // This warp's 16 q rows as A fragments, held for the whole kv loop.
  uint32_t qa[KD][4];
  const bf16* qw = Qs + warp * 16 * QP;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const bf16* p0 = qw + g * QP + kk * 16 + t4 * 2;
    qa[kk][0] = ld32(p0);
    qa[kk][1] = ld32(p0 + 8 * QP);
    qa[kk][2] = ld32(p0 + 8);
    qa[kk][3] = ld32(p0 + 8 * QP + 8);
  }

  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0+8
  const int* segb = SEG ? seg + (size_t)b * S : nullptr;
  int qseg[2] = {0, 0};
  if (SEG) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row0 + 8 * i < S) qseg[i] = segb[row0 + 8 * i];
  }
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;

  const int n_tiles = (S + kBK - 1) / kBK;
  int kt_last = n_tiles - 1;
  if (causal) kt_last = min(kt_last, (q0 + kBQ - 1) / kBK);
  const int kt_first = window > 0 ? max(q0 - window + 1, 0) / kBK : 0;

  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's Ks/Vt are consumed
    for (int i = tid; i < kBK * D / CH; i += kMmaThreads) {
      const int r = i / (D / CH), c = (i % (D / CH)) * CH;
      uint4 u = make_uint4(0, 0, 0, 0);
      if (k0 + r < S)
        u = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * kstride +
                                            c);
      *reinterpret_cast<uint4*>(Ks + r * QP + c) = u;
    }
    // v: neighbouring threads take neighbouring positions, so the
    // transposed 2-byte stores fall in distinct banks.
    for (int i = tid; i < kBK * D / CH; i += kMmaThreads) {
      const int r = i % kBK, c = (i / kBK) * CH;
      uint4 u = make_uint4(0, 0, 0, 0);
      if (k0 + r < S)
        u = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * kstride +
                                            c);
      const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int j = 0; j < CH; ++j) Vt[(c + j) * VP + r] = e[j];
    }
    if (SEG && tid < kBK) Kseg[tid] = k0 + tid < S ? segb[k0 + tid] : -1;
    __syncthreads();

    float sc[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const bf16* kp = Ks + (nb * 8 + g) * QP + kk * 16 + t4 * 2;
        const uint32_t kf[2] = {ld32(kp), ld32(kp + 8)};
        mma_16816(sc[nb], qa[kk], kf);
      }
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8;
        const int col = k0 + nb * 8 + t4 * 2 + (e & 1);
        float x = sc[nb][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = col < S;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && row - col < window;
        if (SEG) ok = ok && qseg[e >> 1] == Kseg[nb * 8 + t4 * 2 + (e & 1)];
        x = ok ? x : kNegInf;
        sc[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // The 4 lanes of a group hold one row's 64 columns between them.
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      alpha[i] = expf(m_r[i] - m_new);
      m_r[i] = m_new;
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[nb][e];
        const float p = x > 0.5f * kNegInf ? expf(x - m_r[e >> 1]) : 0.f;
        rs[e >> 1] += p;
        sc[nb][e] = p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l_r[i] = alpha[i] * l_r[i] + rs[i];
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] *= alpha[e >> 1];

    // p.V: the score accumulators of two 8-column blocks are one A
    // fragment (p rounded to bf16 here, as the TPU kernel casts p to v's
    // dtype).
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
          pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
          pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]),
      };
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const bf16* vp = Vt + (nd * 8 + g) * VP + kk * 16 + t4 * 2;
        const uint32_t vf[2] = {ld32(vp), ld32(vp + 8)};
        mma_16816(o[nd], pa, vf);
      }
    }
  }

  bf16* ob = out + (size_t)b * S * qstride + (size_t)h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= S) continue;
    float rr = 1.f, denom, m_fin = m_r[i];
    if (sinks != nullptr) {
      const float sk = sinks[h];
      const float m2 = fmaxf(m_r[i], sk);
      rr = expf(m_r[i] - m2);
      denom = l_r[i] * rr + expf(sk - m2);
      m_fin = m2;
    } else {
      denom = l_r[i] == 0.f ? 1.f : l_r[i];
    }
    if (lse != nullptr && t4 == 0)
      lse[((size_t)b * H + h) * S + row] = m_fin + logf(denom);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row * qstride + nd * 8 +
                                   t4 * 2) =
          pack_bf16(o[nd][2 * i] * rr / denom, o[nd][2 * i + 1] * rr / denom);
  }
}

template <typename T, int D, bool SEG>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* sinks, const void* seg, void* out, void* lse,
                   int B, int S, int H, int Hkv, float scale, int causal,
                   int window, float softcap, cudaStream_t stream) {
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  const float* sp = static_cast<const float*>(sinks);
  const int* gp = static_cast<const int*>(seg);
  float* lp = static_cast<float*>(lse);
  if constexpr (sizeof(T) == 4) {
    auto kernel = flash_fwd_f32<D, SEG>;
    constexpr size_t smem = f32_smem_bytes<D>();
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kF32Threads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), sp, gp, static_cast<float*>(out), lp,
        S, H, Hkv, scale, causal, window, softcap);
  } else {
    auto kernel = flash_fwd_bf16<D, SEG>;
    constexpr size_t smem = bf16_smem_bytes<D>();
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), sp, gp, static_cast<T*>(out), lp, S, H,
        Hkv, scale, causal, window, softcap);
  }
  return cudaGetLastError();
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
