"""Attention ops (port of `shellac_tpu/ops/attention.py`).

`attention(...)` is the entry point the model calls for attention within
a chunk (training-style forward and fresh-cache prefill). It dispatches
between:
  - `attention_ref`: einsum + fp32 softmax, the plain PyTorch version and
    the CPU path;
  - `flash_attention` (ops/flash_attention.py): the hand-written CUDA
    kernels (forward, and under autograd the two backward kernels), for
    every CUDA call they take: packed segments when q and kv share one
    segment tensor, as the JAX dispatch requires. A CUDA call they do not
    take (explicit positions, a kv_mask, distinct q and kv segments)
    raises.

Layout convention everywhere: q (B, Sq, H, D); k, v (B, Sk, Hkv, D) with
grouped-query attention when Hkv < H. Softmax/logits are always fp32.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0e38


def _build_mask(
    q_positions: torch.Tensor,  # (B, Sq) int
    kv_positions: torch.Tensor,  # (B, Sk) int
    causal: bool,
    window: Optional[int],
    kv_mask: Optional[torch.Tensor],  # (B, Sk) bool — valid kv slots
    q_segments: Optional[torch.Tensor] = None,  # (B, Sq) int
    kv_segments: Optional[torch.Tensor] = None,  # (B, Sk) int
) -> Optional[torch.Tensor]:
    """Boolean (B, 1, Sq, Sk) mask; True = attend."""
    parts = []
    qp = q_positions[:, :, None]
    kp = kv_positions[:, None, :]
    if causal:
        parts.append(kp <= qp)
    if window is not None:
        parts.append(qp - kp < window)
    if kv_mask is not None:
        parts.append(kv_mask[:, None, :])
    if q_segments is not None:
        parts.append(q_segments[:, :, None] == kv_segments[:, None, :])
    if not parts:
        return None
    mask = parts[0]
    for p in parts[1:]:
        mask = mask & p
    return mask[:, None, :, :]


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    q_segments: Optional[torch.Tensor] = None,
    kv_segments: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reference scaled-dot-product attention with GQA.

    softcap: scaled scores pass through cap*tanh(s/cap) BEFORE masking.
    sinks: (H,) per-head sink logits; each row's softmax denominator
    gains exp(sink_h), a virtual column attending a zero value.
    """
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    if h % hkv != 0:
        raise ValueError(f"n_heads={h} not divisible by n_kv_heads={hkv}")
    g = h // hkv
    if scale is None:
        scale = d ** -0.5
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(sk - sq, sk, device=dev).expand(b, sq)
    if kv_positions is None:
        kv_positions = torch.arange(sk, device=dev).expand(b, sk)

    qg = q.reshape(b, sq, hkv, g, d)
    # (B, Hkv, G, Sq, Sk) logits in fp32.
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    logits = logits * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    mask = _build_mask(
        q_positions, kv_positions, causal, window, kv_mask,
        q_segments, kv_segments,
    )
    if mask is not None:
        logits = logits.masked_fill(~mask[:, :, None, :, :], NEG_INF)
    if sinks is not None:
        sink_col = sinks.float().reshape(1, hkv, g, 1, 1).expand(
            b, hkv, g, sq, 1
        )
        probs = torch.softmax(torch.cat([logits, sink_col], dim=-1),
                              dim=-1)[..., :-1]
    else:
        probs = torch.softmax(logits, dim=-1)
    out = torch.einsum(
        "bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(), v.float()
    )
    return out.reshape(b, sq, h, d).to(q.dtype)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    sinks: Optional[torch.Tensor] = None,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    q_segments: Optional[torch.Tensor] = None,
    kv_segments: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Dispatching attention. impl: "auto" | "ref".

    "auto" sends a CUDA call to the flash kernel (raising for what it
    does not take) and a CPU call to the plain version; "ref" always
    takes the plain version.
    """
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "auto" and q.is_cuda:
        from shellac_tpu_torch.ops.flash_attention import flash_attention

        if q_positions is not None or kv_positions is not None \
                or kv_mask is not None:
            raise NotImplementedError(
                "the CUDA flash kernel takes no q_positions/kv_positions/"
                "kv_mask; use impl='ref'"
            )
        if q_segments is not kv_segments:
            raise NotImplementedError(
                "the CUDA flash kernels mask with one segment row shared "
                "by q and kv (pass the same tensor as q_segments and "
                "kv_segments); use impl='ref'"
            )
        return flash_attention(
            q, k, v, causal=causal, scale=scale, window=window,
            softcap=softcap, sinks=sinks, segments=q_segments,
        )
    return attention_ref(
        q, k, v, causal=causal, window=window, scale=scale,
        softcap=softcap, sinks=sinks,
        q_positions=q_positions, kv_positions=kv_positions, kv_mask=kv_mask,
        q_segments=q_segments, kv_segments=kv_segments,
    )
