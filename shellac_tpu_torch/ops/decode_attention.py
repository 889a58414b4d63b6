"""Flash-decode attention over a dense head-major KV cache or a paged
block pool.

Ports `shellac_tpu/ops/decode_attention.py`: `decode_attention` and
`paged_decode_attention` (:863, with `paged_decode_supported` :841).

`decode_attention` attends q (B, s, H, D) against a cache (B, Hkv, L, D):
q row si of batch b sits at position index[b] + si and attends kv
positions <= its own (optionally windowed), so positions past each
slot's length never contribute. `paged_decode_attention` does the same
against pools (n_blocks, Hkv, bs, D) through block tables (B,
max_blocks). On CUDA tensors each launches its kernel
(`csrc/decode_attention.cu`, `csrc/paged_decode_attention.cu`), which
reads only each slot's live range, or raises on a shape the kernel does
not take; on CPU tensors each takes its plain PyTorch version (masked
reference attention over the whole buffer, after a gather for the pool).
"""

from __future__ import annotations

from typing import Optional

import torch

from shellac_tpu_torch.inference.cache.layout import paged_gather_layer
from shellac_tpu_torch.ops import _build
from shellac_tpu_torch.ops.attention import attention_ref
from shellac_tpu_torch.ops.dispatch import refuse_grad

_KERNEL_DTYPES = {torch.float32: _build.DTYPE_F32,
                  torch.bfloat16: _build.DTYPE_BF16}
KERNEL_HEAD_DIMS = (64, 128)
# Most q rows one block holds per kv head (G * s): the kernel keeps one
# fp32 accumulator per row per thread in registers.
KERNEL_MAX_ROWS = 16
# Most table entries the paged kernel stages in shared memory per block.
KERNEL_MAX_BLOCKS = 32768


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
    take, and under autograd (the kernel is inference-only).
    `decode_attention_cuda.launches` counts the kernel's launches.
    """
    refuse_grad("decode_attention_cuda", q, cache_k, cache_v, sinks)
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


def paged_decode_supported(q, pool_k, *, quant: bool = False) -> bool:
    """Whether the CUDA paged kernel takes these shapes: D 64 or 128 in
    both q and the pool, fp32 or bf16 in both, whole GQA groups, at most
    KERNEL_MAX_ROWS q rows per kv head, no int8 pool. Any block size."""
    b, s, h, d = q.shape
    hkv, dk = pool_k.shape[1], pool_k.shape[3]
    return (not quant and d in KERNEL_HEAD_DIMS and dk == d
            and q.dtype in _KERNEL_DTYPES and pool_k.dtype == q.dtype
            and h % hkv == 0 and (h // hkv) * s <= KERNEL_MAX_ROWS)


def _paged_decode_ref(q, pool_k, pool_v, tables, index, window, scale,
                      softcap=None, sinks=None):
    """The plain PyTorch version: gather each slot's pages into a dense
    view, then masked attention over it."""
    k_all, v_all = paged_gather_layer(pool_k, pool_v, tables)
    return _decode_ref(q, k_all, v_all, index, window, scale,
                       softcap=softcap, sinks=sinks)


def paged_decode_attention_cuda(q, pool_k, pool_v, tables, index, *,
                                window=None, scale=None, softcap=None,
                                sinks=None):
    """Launch the CUDA paged flash-decode kernel.

    tables: (B, max_blocks) int32 and index: (B,) int32, on the card.
    Raises on what the kernel does not take, and under autograd (the
    kernel is inference-only). `paged_decode_attention_cuda.launches`
    counts the kernel's launches.
    """
    name = "paged_decode_attention_cuda"
    refuse_grad(name, q, pool_k, pool_v, sinks)
    if not all(t.is_cuda for t in (q, pool_k, pool_v, tables, index)):
        raise ValueError(f"{name} needs CUDA tensors")
    if q.dim() != 4 or pool_k.dim() != 4 or pool_v.shape != pool_k.shape:
        raise ValueError(f"{name}: q (B,s,H,D), pools (n_blocks,Hkv,bs,D)")
    if not paged_decode_supported(q, pool_k) or pool_v.dtype != q.dtype:
        raise ValueError(
            f"{name} does not take q {tuple(q.shape)} {q.dtype}, pool "
            f"{tuple(pool_k.shape)} {pool_k.dtype}: it needs head_dim in "
            f"{KERNEL_HEAD_DIMS} in both, fp32 or bf16 in all three, "
            f"n_heads divisible by kv heads and G*s <= {KERNEL_MAX_ROWS} "
            "rows per kv head"
        )
    b, s, h, d = q.shape
    _, hkv, bs, _ = pool_k.shape
    if tables.dtype != torch.int32 or index.dtype != torch.int32:
        raise ValueError(f"{name}: tables and index must be int32")
    if tables.dim() != 2 or tables.shape[0] != b or index.shape != (b,):
        raise ValueError(
            f"{name}: tables {tuple(tables.shape)} and index "
            f"{tuple(index.shape)} do not match batch {b}"
        )
    max_blocks = tables.shape[1]
    if not 1 <= max_blocks <= KERNEL_MAX_BLOCKS:
        raise ValueError(f"{name}: max_blocks {max_blocks} not in "
                         f"[1, {KERNEL_MAX_BLOCKS}]")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1")
    if not all(t.is_contiguous() for t in (q, pool_k, pool_v, tables,
                                           index)):
        raise ValueError(f"{name} needs contiguous tensors")
    if pool_k.data_ptr() % 16 or pool_v.data_ptr() % 16:
        raise ValueError(f"{name}: pools must be 16-byte aligned (the "
                         "kernel loads 16 bytes at a time)")
    if sinks is not None:
        if sinks.dtype != torch.float32 or sinks.shape != (h,) \
                or not sinks.is_cuda or not sinks.is_contiguous():
            raise ValueError(f"{name}: sinks must be fp32 (H,)")
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _build.launch(
        "shellac_paged_decode_attention", q.data_ptr(), pool_k.data_ptr(),
        pool_v.data_ptr(), tables.data_ptr(), index.data_ptr(),
        None if sinks is None else sinks.data_ptr(), out.data_ptr(),
        b, s, h, hkv, bs, max_blocks, d, float(scale),
        -1 if window is None else int(window),
        0.0 if softcap is None else float(softcap),
        _KERNEL_DTYPES[q.dtype],
    )
    paged_decode_attention_cuda.launches += 1
    return out


paged_decode_attention_cuda.launches = 0


def paged_decode_attention(
    q, pool_k, pool_v, tables, index, *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    sinks=None,
    impl: str = "auto",
    k_scale=None, v_scale=None,
):
    """Attention of q (B, s, H, D) against a paged pool via block tables.

    pool_k/v: (n_blocks, Hkv, bs, D); tables: (B, max_blocks) int32;
    index: (B,) int32 pre-write lengths. impl "auto" launches the CUDA
    kernel on CUDA tensors (raising on a shape it does not take) and the
    plain version on CPU tensors; "ref" always takes the plain version.
    """
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "int8 paged pools (k_scale/v_scale) are not ported yet"
        )
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown paged decode impl {impl!r}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl == "auto" and q.is_cuda:
        return paged_decode_attention_cuda(
            q, pool_k, pool_v, tables, index, window=window, scale=scale,
            softcap=softcap, sinks=sinks,
        )
    if impl == "auto" and q.device.type != "cpu":
        raise ValueError(
            f"paged_decode_attention: unsupported device {q.device}")
    return _paged_decode_ref(q, pool_k, pool_v, tables, index, window,
                             scale, softcap=softcap, sinks=sinks)
