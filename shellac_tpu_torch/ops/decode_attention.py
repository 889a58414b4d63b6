"""Flash-decode attention over a dense head-major KV cache.

`decode_attention` attends q (B, s, H, D) against a cache (B, Hkv, L, D):
q row si of batch b sits at position index[b] + si and attends kv
positions <= its own (optionally windowed), so positions past each
slot's length never contribute. On a CUDA tensor it launches the kernel
in `csrc/decode_attention.cu`, which reads only each slot's live range;
on a CPU tensor it takes `_decode_ref`, the plain PyTorch version (masked
reference attention over the whole buffer).
"""

from __future__ import annotations

from typing import Optional

import torch

from shellac_tpu_torch.ops import _build
from shellac_tpu_torch.ops.attention import attention_ref

_KERNEL_DTYPES = {torch.float32: _build.DTYPE_F32,
                  torch.bfloat16: _build.DTYPE_BF16}
KERNEL_HEAD_DIMS = (64, 128)
# Most q rows one block holds per kv head (G * s): the kernel keeps one
# fp32 accumulator per row per thread in registers.
KERNEL_MAX_ROWS = 16


def _decode_ref(q, cache_k, cache_v, index, window, scale, softcap=None,
                sinks=None):
    """The plain PyTorch version: masked attention over the whole cache."""
    # cache: (B, Hkv, L, D) head-major -> (B, L, Hkv, D) for the ref.
    cache_k = cache_k.transpose(1, 2)
    cache_v = cache_v.transpose(1, 2)
    b, s = q.shape[:2]
    max_len = cache_k.shape[1]
    dev = q.device
    index = index.to(device=dev, dtype=torch.int64)
    q_positions = index[:, None] + torch.arange(s, device=dev)[None, :]
    kv_positions = torch.arange(max_len, device=dev).expand(b, max_len)
    kv_mask = kv_positions < (index[:, None] + s)
    return attention_ref(
        q, cache_k.to(q.dtype), cache_v.to(q.dtype),
        causal=True, window=window, scale=scale, softcap=softcap,
        sinks=sinks,
        q_positions=q_positions, kv_positions=kv_positions, kv_mask=kv_mask,
    )


def decode_attention_cuda(q, cache_k, cache_v, index, *, window=None,
                          scale=None, softcap=None, sinks=None):
    """Launch the CUDA dense flash-decode kernel.

    index: (B,) int32 on the card. Raises on what the kernel does not
    take. `decode_attention_cuda.launches` counts the kernel's launches.
    """
    if not (q.is_cuda and cache_k.is_cuda and cache_v.is_cuda
            and index.is_cuda):
        raise ValueError("decode_attention_cuda needs CUDA tensors")
    if q.dtype not in _KERNEL_DTYPES or cache_k.dtype != q.dtype \
            or cache_v.dtype != q.dtype:
        raise ValueError(
            f"decode_attention_cuda: dtypes {q.dtype}/{cache_k.dtype}/"
            f"{cache_v.dtype}"
        )
    if index.dtype != torch.int32:
        raise ValueError("decode_attention_cuda: index must be int32")
    if q.dim() != 4 or cache_k.dim() != 4 or cache_v.shape != cache_k.shape:
        raise ValueError(
            "decode_attention_cuda: q (B,s,H,D), cache (B,Hkv,L,D)"
        )
    b, s, h, d = q.shape
    cb, hkv, max_len, dk = cache_k.shape
    if cb != b or dk != d or index.shape != (b,):
        raise ValueError(
            f"decode_attention_cuda: q {tuple(q.shape)} cache "
            f"{tuple(cache_k.shape)} index {tuple(index.shape)}"
        )
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"decode_attention_cuda: head_dim {d} not in "
                         f"{KERNEL_HEAD_DIMS}")
    if h % hkv != 0:
        raise ValueError(f"n_heads={h} not divisible by n_kv_heads={hkv}")
    if (h // hkv) * s > KERNEL_MAX_ROWS:
        raise ValueError(
            f"decode_attention_cuda: G*s = {(h // hkv) * s} rows per kv "
            f"head > {KERNEL_MAX_ROWS}"
        )
    if window is not None and window < 1:
        raise ValueError("decode_attention_cuda: window must be >= 1")
    if not (q.is_contiguous() and cache_k.is_contiguous()
            and cache_v.is_contiguous() and index.is_contiguous()):
        raise ValueError("decode_attention_cuda needs contiguous tensors")
    if cache_k.data_ptr() % 16 or cache_v.data_ptr() % 16:
        raise ValueError("decode_attention_cuda: caches must be 16-byte "
                         "aligned (the kernel loads 16 bytes at a time)")
    if sinks is not None:
        if sinks.dtype != torch.float32 or sinks.shape != (h,) \
                or not sinks.is_cuda or not sinks.is_contiguous():
            raise ValueError("decode_attention_cuda: sinks must be fp32 (H,)")
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _build.launch(
        "shellac_decode_attention", q.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), index.data_ptr(),
        None if sinks is None else sinks.data_ptr(), out.data_ptr(),
        b, s, h, hkv, max_len, d, float(scale),
        -1 if window is None else int(window),
        0.0 if softcap is None else float(softcap),
        _KERNEL_DTYPES[q.dtype],
    )
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0


def decode_attention(
    q, cache_k, cache_v, index, *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    sinks=None,
    impl: str = "auto",
    k_scale=None, v_scale=None,
):
    """Attention of q (B, s, H, D) against a dense cache (B, Hkv, L, D).

    index: (B,) int32 — per-sequence pre-write length. impl "auto" takes
    the CUDA kernel on CUDA tensors and the plain version on CPU tensors;
    "ref" always takes the plain version.
    """
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "int8 KV caches (k_scale/v_scale) are not ported yet"
        )
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown decode impl {impl!r}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl == "auto" and q.is_cuda:
        return decode_attention_cuda(
            q, cache_k, cache_v, index, window=window, scale=scale,
            softcap=softcap, sinks=sinks,
        )
    if impl == "auto" and q.device.type != "cpu":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return _decode_ref(q, cache_k, cache_v, index, window, scale,
                       softcap=softcap, sinks=sinks)
