// Flash-decode body shared by the dense and the paged decode kernels for
// an fp32 q, the parity path; a bf16 q takes decode_split.cuh.
//
// q (B, s, H, D) attends one slot's kv rows; q row si of slot b sits at
// position index[b] + si and attends kv positions <= its own, optionally
// within a sliding window, with Gemma-2 softcap and GPT-OSS sinks. The
// cache is stored in q's dtype or in int8 (KT = int8_t) with one fp32
// dequant scale per (position, kv head). The two kernels differ only in
// where position p of a slot lives, which an addressing policy answers (see DenseRows in decode_attention.cu and
// PagedRows in paged_decode_attention.cu):
//   int capacity()          positions a slot can address;
//   void stage(b, hk, first, live_end, ints, tid)
//                           per-block set-up before the block's barrier,
//                           with `ints` shared memory of extra_ints();
//   size_t row(pos)         the index of position pos's D-vector in the
//                           k (and v) array; for int8 also the index of
//                           its scale in ks (and vs), whose layout is the
//                           value layout without the head dim.
//
// Kept from the TPU kernels: the GQA rows of one kv head are processed
// together (G*s rows, kv-head-major as `_flatten_q` orders them) so each
// k/v row is read once for the whole group; only the slot's live range
// is walked (`_live_range`): from the window's first live position to
// index + s - 1, so nothing past a slot's length is read; causal masking
// within the s rows; softcap before the mask; fp32 online softmax with p
// rounded to v's dtype before the p.V product (l sums the unrounded p);
// sinks folded in at the end as sink_rebase does. The int8 cache
// follows `_dense_kernel_quant` and the quant branch of
// `_paged_group_kernel` (`_decode_tile` with ks_ref/vs_ref): the logit is
// the fp32 dot of the scaled q with the integer k row, times ks[pos],
// then softcap and mask; p is multiplied by vs[pos] in fp32 (never
// rounded to a 16-bit type) before p.V over the integer v row; l sums
// the unscaled p.
//
// What changes for Hopper: the TPU kernels walk kv blocks as a
// sequential grid carrying VMEM scratch. Here one 256-thread block owns
// one (slot, kv head), and its 8 warps split the live range among
// themselves in 32-position chunks, each warp with its own online-softmax
// state in registers:
//   - logits: each lane takes one position of the chunk, computes its row
//     address once, and computes all G*s dot products from its own k row
//     (16-byte loads, q broadcast from shared memory), so no cross-lane
//     reduction is needed per position;
//   - softmax step: one warp max and one warp sum per row per chunk;
//   - p.V: the lanes split the head dim, the chunk's v rows stream in
//     coalesced, and each row's address and p reach every lane by a
//     shuffle.
// The 8 warps' (m, l, acc) are merged once at the end through shared
// memory. There is no block-wide barrier inside the loop, so every warp
// keeps its loads in flight independently.
//
// Bound on the H100: bytes. Each step reads the live k/v range once
// (2 * live * D * 2 bytes per slot and kv head in bf16; 2 * live * (D + 4)
// in int8, values and scales) for ~4 flops per byte (~8 in int8). With
// one block per (slot, kv head) the grid is B * Hkv blocks; at fewer
// blocks than the card's 132 SMs its bandwidth is not reached. This body
// serves the fp32 dense cache and the fp32 paged pool (the parity paths)
// and the int8 dense cache; the bf16 dense cache and the paged pool in
// bf16 and int8 take flash-decoding's split-K across a thread-block
// cluster instead (`decode_split_kernel` in decode_split.cuh).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace shellac {
namespace decode {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // positions per warp step: one per lane
constexpr int kRMax = 16;   // most q rows (G * s) per block

// Load N consecutive T values into floats (N * sizeof(T) bytes: 2, 4, 8
// or 16, aligned to that size by the callers' layout).
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float* out) {
  constexpr int kBytes = N * sizeof(T);
  if constexpr (kBytes == 16) {
    uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f32(e[j]);
  } else if constexpr (kBytes == 8) {
    uint2 u = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f32(e[j]);
  } else if constexpr (kBytes == 4) {
    unsigned u = *reinterpret_cast<const unsigned*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f32(e[j]);
  } else {
    // int8 p.V at D 64: two bytes a lane.
    static_assert(kBytes == 2, "loads of 2, 4, 8 or 16 bytes");
    unsigned short u = *reinterpret_cast<const unsigned short*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f32(e[j]);
  }
}

inline size_t smem_bytes(int rows, int D, int extra_ints) {
  // Qs [rows][D]; per-warp m, l [kWarps][rows]; acc [kWarps][rows][D];
  // then the addressing policy's ints.
  return sizeof(float) * ((size_t)rows * D + 2 * kWarps * rows +
                          (size_t)kWarps * rows * D) +
         sizeof(int) * (size_t)extra_ints;
}

// T: q's and the output's type; KT: the cache's (T, or int8_t with the
// fp32 scales ks/vs, which are null otherwise).
template <typename T, typename KT, int D, int R, typename Addr>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const KT* __restrict__ cache_k,
              const KT* __restrict__ cache_v, const float* __restrict__ ks,
              const float* __restrict__ vs, const int* __restrict__ index,
              const float* __restrict__ sinks, T* __restrict__ out, int s,
              int H, int Hkv, float scale, int window, float softcap,
              Addr addr) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int CH = 16 / sizeof(KT);  // k elements per 16-byte load
  constexpr int DL = D / 32;           // head dims per lane in p.V

  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / Hkv;
  const int rows = G * s;
  const int idx = index[b];
  const int live_end = min(idx + s, addr.capacity());  // exclusive
  const int first = window > 0 ? max(idx - window + 1, 0) : 0;
  float* Qs = smem;                      // [rows][D], scaled
  float* Mw = Qs + rows * D;             // [kWarps][rows]
  float* Lw = Mw + kWarps * rows;        // [kWarps][rows]
  float* Aw = Lw + kWarps * rows;        // [kWarps][rows][D]
  int* Xs = reinterpret_cast<int*>(Aw + kWarps * rows * D);

  // Row r is (group member g = r / s, query si = r % s): q head hk*G + g
  // at position idx + si.
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int g = r / s, si = r % s;
    Qs[i] =
        to_f32(q[(((size_t)b * s + si) * H + hk * G + g) * D + c]) * scale;
  }
  addr.stage(b, hk, first, live_end, Xs, tid);
  __syncthreads();

  float m[R], l[R], acc[R][DL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DL; ++j) acc[r][j] = 0.f;
  }

  for (int c0 = first + warp * kChunk; c0 < live_end;
       c0 += kWarps * kChunk) {
    const int pos = c0 + lane;
    const bool in = pos < live_end;
    // Element offset of this lane's k/v row; shuffled to the whole warp
    // in the p.V loop. An int8 row's scales sit at the row index.
    const size_t row = in ? addr.row(pos) : 0;
    const size_t off = row * D;
    float ksc = 0.f, vsc = 0.f;
    if constexpr (kQuant) {
      if (in) {
        ksc = ks[row];
        vsc = vs[row];
      }
    }

    // Logits of this lane's position for every row.
    float sc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sc[r] = 0.f;
    if (in) {
      const KT* krow = cache_k + off;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += CH) {
        float kf[CH];
        load_f32<KT, CH>(krow + d0, kf);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < rows) {
            const float* qr = Qs + r * D + d0;
#pragma unroll
            for (int j = 0; j < CH; ++j) sc[r] += qr[j] * kf[j];
          }
        }
      }
    }

    // Online-softmax step per row over this chunk.
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
        for (int j = 0; j < DL; ++j) acc[r][j] *= alpha;
        if constexpr (kQuant)
          sc[r] = p * vsc;  // fp32, not rounded
        else
          sc[r] = round_through<T>(p);
      }
    }

    // p.V: lane owns head dims [lane * DL, lane * DL + DL).
    const int n = min(kChunk, live_end - c0);
#pragma unroll 8
    for (int j = 0; j < kChunk; ++j) {
      if (j < n) {
        const size_t vo = __shfl_sync(0xffffffffu, off, j);
        float vf[DL];
        load_f32<KT, DL>(cache_v + vo + lane * DL, vf);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < rows) {
            const float pj = __shfl_sync(0xffffffffu, sc[r], j);
#pragma unroll
            for (int e = 0; e < DL; ++e) acc[r][e] += pj * vf[e];
          }
        }
      }
    }
  }

  // Merge the warps' partial softmax states.
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < rows) {
      if (lane == 0) {
        Mw[warp * rows + r] = m[r];
        Lw[warp * rows + r] = l[r];
      }
#pragma unroll
      for (int e = 0; e < DL; ++e)
        Aw[(warp * rows + r) * D + lane * DL + e] = acc[r][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float M = kNegInf;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, Mw[w * rows + r]);
    float Lsum = 0.f, A = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(Mw[w * rows + r] - M);
      Lsum += Lw[w * rows + r] * f;
      A += Aw[(w * rows + r) * D + d] * f;
    }
    const int g = r / s, si = r % s;
    const int head = hk * G + g;
    float rr = 1.f, denom;
    if (sinks != nullptr) {
      const float sk = sinks[head];
      const float m2 = fmaxf(M, sk);
      rr = expf(M - m2);
      denom = Lsum * rr + expf(sk - m2);
    } else {
      denom = Lsum == 0.f ? 1.f : Lsum;
    }
    out[(((size_t)b * s + si) * H + head) * D + d] =
        from_f32<T>(A * rr / denom);
  }
}

template <typename T, typename KT, int D, int R, typename Addr>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        const void* ks, const void* vs, const void* index,
                        const void* sinks, void* out, int B, int s, int H,
                        int Hkv, float scale, int window, float softcap,
                        const Addr& addr, cudaStream_t stream) {
  auto kernel = decode_kernel<T, KT, D, R, Addr>;
  const int extra = addr.extra_ints();
  cudaError_t err = allow_smem(kernel, smem_bytes(R, D, extra));
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B);
  kernel<<<grid, kThreads, smem_bytes((H / Hkv) * s, D, extra), stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(index),
      static_cast<const float*>(sinks), static_cast<T*>(out), s, H, Hkv,
      scale, window, softcap, addr);
  return cudaGetLastError();
}

// Register arrays are sized for the rows: 2 covers GQA groups of up to 2
// at s = 1 (shellac-1b's decode); anything larger takes kRMax.
// KT = T for a cache in q's dtype (ks, vs null), int8_t for an int8 cache.
template <typename T, typename KT, typename Addr>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* index,
                   const void* sinks, void* out, int B, int s, int H,
                   int Hkv, int D, float scale, int window, float softcap,
                   const Addr& addr, cudaStream_t stream) {
  const int rows = (H / Hkv) * s;
#define SHELLAC_DECODE_ROWS(DD)                                             \
  if (rows <= 2)                                                            \
    return launch_rows<T, KT, DD, 2>(q, k, v, ks, vs, index, sinks, out, B, \
                                     s, H, Hkv, scale, window, softcap,     \
                                     addr, stream);                         \
  if (rows <= kRMax)                                                        \
    return launch_rows<T, KT, DD, kRMax>(q, k, v, ks, vs, index, sinks,     \
                                         out, B, s, H, Hkv, scale, window,  \
                                         softcap, addr, stream);            \
  return cudaErrorInvalidValue;
  if (D == 64) { SHELLAC_DECODE_ROWS(64) }
  if (D == 128) { SHELLAC_DECODE_ROWS(128) }
#undef SHELLAC_DECODE_ROWS
  return cudaErrorInvalidValue;
}

}  // namespace decode
}  // namespace shellac
