"""Flash-decode attention over a dense head-major KV cache or a paged
block pool, in the compute dtype or int8.

Ports `shellac_tpu/ops/decode_attention.py`: `decode_attention` and
`paged_decode_attention` (:863, with `paged_decode_supported` :841),
including their int8 caches (`k_scale`/`v_scale`, kernels
`_dense_kernel_quant` :334 and the `quant=True` branch of
`_paged_group_kernel` :562).

`decode_attention` attends q (B, s, H, D) against a cache (B, Hkv, L, D):
q row si of batch b sits at position index[b] + si and attends kv
positions <= its own (optionally windowed), so positions past each
slot's length never contribute. `paged_decode_attention` does the same
against pools (n_blocks, Hkv, bs, D) through block tables (B,
max_blocks). An int8 cache comes with fp32 per-(token, kv head) scales,
(B, Hkv, L) or (n_blocks, Hkv, bs): both or neither.

On CUDA tensors each launches its kernel (`csrc/decode_attention.cu`,
`csrc/paged_decode_attention.cu`), which reads only each slot's live
range, or raises on a shape the kernel does not take. A bf16 q takes the
split-K body of `csrc/decode_split.cuh` over the dense cache and the
paged pool, each in bf16 or int8; the fp32 parity path takes the
one-block-per-(slot, kv head) body of `csrc/decode_core.cuh`. MLA's
absorbed decode (D 576: every q head against one latent row a token,
the same array as k and v, with no window, softcap or sinks) takes the
wide body of `csrc/decode_wide.cuh` in bf16 and fp32, over bf16, fp32
and int8 caches. An int8
cache on the card launches its int8 kernel or raises: nothing
dequantizes the whole cache there (the JAX package's
`QuantFallbackWarning` fallback is not ported). On CPU tensors each
takes its plain PyTorch version: masked reference attention over the
whole buffer, after a gather for the pool and, for int8, a dequantize in
fp32 cast to q's dtype (JAX `_decode_ref` :522).
"""

from __future__ import annotations

from typing import Optional

import torch

from shellac_tpu_torch.inference.cache.layout import (
    paged_gather_layer,
    paged_gather_scales,
)
from shellac_tpu_torch.ops import _build
from shellac_tpu_torch.ops.attention import attention_ref
from shellac_tpu_torch.ops.dispatch import refuse_grad

_KERNEL_DTYPES = {torch.float32: _build.DTYPE_F32,
                  torch.bfloat16: _build.DTYPE_BF16}
# 576: MLA's absorbed decode (kv_lora_rank 512 + qk_rope_head_dim 64), the
# wide body of csrc/decode_wide.cuh.
KERNEL_HEAD_DIMS = (64, 128, 576)
WIDE_HEAD_DIM = 576
# Most q rows one block holds per kv head (G * s) at D 64 and 128; the
# wide body takes any number, 16 a CTA.
KERNEL_MAX_ROWS = 16
# Most table entries per slot: the fp32 paged body stages a slot's live
# entries in shared memory.
KERNEL_MAX_BLOCKS = 32768


def _check_scales(name, k_scale, v_scale):
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: k_scale and v_scale come together")


def _dequantize(cache, scales, dtype):
    """An int8 cache times its per-token scales in fp32, cast to dtype."""
    return (cache.float() * scales[..., None]).to(dtype)


def _decode_ref(q, cache_k, cache_v, index, window, scale, softcap=None,
                sinks=None, k_scale=None, v_scale=None):
    """The plain PyTorch version: masked attention over the whole cache
    (dequantized first when it is int8)."""
    if k_scale is not None:
        cache_k = _dequantize(cache_k, k_scale, q.dtype)
        cache_v = _dequantize(cache_v, v_scale, q.dtype)
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


def _check_kernel_args(name, q, k, v, index, window, softcap, sinks, quant,
                       k_scale, v_scale, scale_shape):
    """What both decode kernels need (after `refuse_grad`), in the
    compute dtype or int8:
    CUDA, contiguous tensors; q fp32 or bf16; the cache in q's dtype or
    int8 with fp32 scales of `scale_shape`; D 64, 128 or 576 in both; whole
    GQA groups, of at most KERNEL_MAX_ROWS rows at D 64 and 128; at D 576
    MLA's latent: v the same storage as k (and v_scale as k_scale), no
    window, softcap or sinks; 16-byte aligned q and caches.
    Raises ValueError naming what is wrong."""
    tensors = [q, k, v, index] + ([k_scale, v_scale] if quant else [])
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{name} needs CUDA tensors")
    kv_dtype = torch.int8 if quant else q.dtype
    if q.dtype not in _KERNEL_DTYPES or k.dtype != kv_dtype \
            or v.dtype != kv_dtype:
        raise ValueError(
            f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}: q must be fp32 "
            f"or bf16 and the cache {'int8' if quant else 'of q dtype'}"
        )
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q (B,s,H,D), cache 4-d, k and v alike")
    b, s, h, d = q.shape
    hkv, dk = k.shape[1], k.shape[3]
    if dk != d or d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} (cache {dk}) not in "
                         f"{KERNEL_HEAD_DIMS}")
    if h % hkv != 0:
        raise ValueError(f"n_heads={h} not divisible by n_kv_heads={hkv}")
    if d == WIDE_HEAD_DIM:
        if v.data_ptr() != k.data_ptr() or (
                quant and v_scale.data_ptr() != k_scale.data_ptr()):
            raise ValueError(f"{name}: at D {d} v must be k's storage (and "
                             "v_scale k_scale's): MLA's latent")
        if window is not None or softcap is not None or sinks is not None:
            raise ValueError(f"{name}: at D {d} no window, softcap or sinks")
    elif (h // hkv) * s > KERNEL_MAX_ROWS:
        raise ValueError(
            f"{name}: G*s = {(h // hkv) * s} rows per kv head > "
            f"{KERNEL_MAX_ROWS}"
        )
    if index.dtype != torch.int32 or index.shape != (b,):
        raise ValueError(f"{name}: index must be int32 ({b},)")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1")
    if quant:
        for t in (k_scale, v_scale):
            if t.dtype != torch.float32 or tuple(t.shape) != scale_shape:
                raise ValueError(
                    f"{name}: scales must be fp32 {scale_shape}, got "
                    f"{t.dtype} {tuple(t.shape)}"
                )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{name}: q and the caches must be 16-byte "
                         "aligned (the kernel loads 16 bytes at a time)")
    if sinks is not None:
        if sinks.dtype != torch.float32 or sinks.shape != (h,) \
                or not sinks.is_cuda or not sinks.is_contiguous():
            raise ValueError(f"{name}: sinks must be fp32 (H,)")


def _dense_cuda(wrapper, q, cache_k, cache_v, index, window, scale, softcap,
                sinks, k_scale=None, v_scale=None):
    """Check, then launch the dense kernel (int8 when scales are given);
    counts the launch on `wrapper`."""
    quant = k_scale is not None
    name = wrapper.__name__
    refuse_grad(name, q, cache_k, cache_v, sinks, k_scale, v_scale)
    if cache_k.dim() != 4 or q.dim() != 4 or cache_k.shape[0] != q.shape[0]:
        raise ValueError(f"{name}: q (B,s,H,D), cache (B,Hkv,L,D)")
    _check_kernel_args(name, q, cache_k, cache_v, index, window, softcap,
                       sinks, quant, k_scale, v_scale,
                       tuple(cache_k.shape[:3]))
    b, s, h, d = q.shape
    _, hkv, max_len, _ = cache_k.shape
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    head = [q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr()]
    if quant:
        head += [k_scale.data_ptr(), v_scale.data_ptr()]
    _build.launch(
        "shellac_decode_attention_int8" if quant
        else "shellac_decode_attention",
        *head, index.data_ptr(),
        None if sinks is None else sinks.data_ptr(), out.data_ptr(),
        b, s, h, hkv, max_len, d, float(scale),
        -1 if window is None else int(window),
        0.0 if softcap is None else float(softcap),
        _KERNEL_DTYPES[q.dtype],
    )
    wrapper.launches += 1
    return out


def decode_attention_cuda(q, cache_k, cache_v, index, *, window=None,
                          scale=None, softcap=None, sinks=None):
    """Launch the CUDA dense flash-decode kernel (cache in q's dtype).

    index: (B,) int32 on the card. Raises on what the kernel does not
    take, and under autograd (the kernel is inference-only).
    `decode_attention_cuda.launches` counts the kernel's launches.
    """
    return _dense_cuda(decode_attention_cuda, q, cache_k, cache_v, index,
                       window, scale, softcap, sinks)


def decode_attention_quant_cuda(q, cache_k, cache_v, k_scale, v_scale,
                                index, *, window=None, scale=None,
                                softcap=None, sinks=None):
    """Launch the CUDA dense flash-decode kernel over an int8 cache.

    cache_k/v: (B, Hkv, L, D) int8; k_scale/v_scale: (B, Hkv, L) fp32.
    Raises as `decode_attention_cuda` does;
    `decode_attention_quant_cuda.launches` counts its launches.
    """
    return _dense_cuda(decode_attention_quant_cuda, q, cache_k, cache_v,
                       index, window, scale, softcap, sinks, k_scale,
                       v_scale)


decode_attention_cuda.launches = 0
decode_attention_quant_cuda.launches = 0


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

    index: (B,) int32 — per-sequence pre-write length. k_scale/v_scale:
    (B, Hkv, L) fp32 dequant scales of an int8 cache, both or neither.
    impl "auto" takes the CUDA kernel on CUDA tensors and the plain
    version on CPU tensors; "ref" always takes the plain version.
    """
    _check_scales("decode_attention", k_scale, v_scale)
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown decode impl {impl!r}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    kw = dict(window=window, scale=scale, softcap=softcap, sinks=sinks)
    if impl == "auto" and q.is_cuda:
        if k_scale is not None:
            return decode_attention_quant_cuda(q, cache_k, cache_v, k_scale,
                                               v_scale, index, **kw)
        return decode_attention_cuda(q, cache_k, cache_v, index, **kw)
    if impl == "auto" and q.device.type != "cpu":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return _decode_ref(q, cache_k, cache_v, index, window, scale,
                       softcap=softcap, sinks=sinks, k_scale=k_scale,
                       v_scale=v_scale)


def paged_decode_supported(q, pool_k, *, quant: bool = False) -> bool:
    """Whether the CUDA paged kernel takes these shapes: D 64, 128 or 576 in
    both q and the pool, q fp32 or bf16, the pool in q's dtype (or int8
    with quant), whole GQA groups, at most KERNEL_MAX_ROWS q rows per kv
    head below D 576. Any block size, int8 included."""
    b, s, h, d = q.shape
    hkv, dk = pool_k.shape[1], pool_k.shape[3]
    kv_dtype = torch.int8 if quant else q.dtype
    return (d in KERNEL_HEAD_DIMS and dk == d
            and q.dtype in _KERNEL_DTYPES and pool_k.dtype == kv_dtype
            and h % hkv == 0
            and (d == WIDE_HEAD_DIM or (h // hkv) * s <= KERNEL_MAX_ROWS))


def _paged_decode_ref(q, pool_k, pool_v, tables, index, window, scale,
                      softcap=None, sinks=None, k_scale=None, v_scale=None):
    """The plain PyTorch version: gather each slot's pages (and scale
    pages) into a dense view, then the dense plain version over it."""
    k_all, v_all = paged_gather_layer(pool_k, pool_v, tables)
    if k_scale is not None:
        k_scale = paged_gather_scales(k_scale, tables)
        v_scale = paged_gather_scales(v_scale, tables)
    return _decode_ref(q, k_all, v_all, index, window, scale,
                       softcap=softcap, sinks=sinks, k_scale=k_scale,
                       v_scale=v_scale)


def _paged_cuda(wrapper, q, pool_k, pool_v, tables, index, window, scale,
                softcap, sinks, k_scale=None, v_scale=None):
    """Check, then launch the paged kernel (int8 when scales are given);
    counts the launch on `wrapper`."""
    quant = k_scale is not None
    name = wrapper.__name__
    refuse_grad(name, q, pool_k, pool_v, sinks, k_scale, v_scale)
    if not tables.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")
    if q.dim() != 4 or pool_k.dim() != 4:
        raise ValueError(f"{name}: q (B,s,H,D), pools (n_blocks,Hkv,bs,D)")
    _check_kernel_args(name, q, pool_k, pool_v, index, window, softcap,
                       sinks, quant, k_scale, v_scale,
                       tuple(pool_k.shape[:3]))
    b, s, h, d = q.shape
    _, hkv, bs, _ = pool_k.shape
    if tables.dtype != torch.int32 or tables.dim() != 2 \
            or tables.shape[0] != b:
        raise ValueError(f"{name}: tables must be int32 ({b}, max_blocks), "
                         f"got {tables.dtype} {tuple(tables.shape)}")
    if not tables.is_contiguous():
        raise ValueError(f"{name} needs contiguous tensors")
    max_blocks = tables.shape[1]
    if not 1 <= max_blocks <= KERNEL_MAX_BLOCKS:
        raise ValueError(f"{name}: max_blocks {max_blocks} not in "
                         f"[1, {KERNEL_MAX_BLOCKS}]")
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    head = [q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr()]
    if quant:
        head += [k_scale.data_ptr(), v_scale.data_ptr()]
    _build.launch(
        "shellac_paged_decode_attention_int8" if quant
        else "shellac_paged_decode_attention",
        *head, tables.data_ptr(), index.data_ptr(),
        None if sinks is None else sinks.data_ptr(), out.data_ptr(),
        b, s, h, hkv, bs, max_blocks, d, float(scale),
        -1 if window is None else int(window),
        0.0 if softcap is None else float(softcap),
        _KERNEL_DTYPES[q.dtype],
    )
    wrapper.launches += 1
    return out


def paged_decode_attention_cuda(q, pool_k, pool_v, tables, index, *,
                                window=None, scale=None, softcap=None,
                                sinks=None):
    """Launch the CUDA paged flash-decode kernel (pool in q's dtype).

    tables: (B, max_blocks) int32 and index: (B,) int32, on the card.
    Raises on what the kernel does not take, and under autograd (the
    kernel is inference-only). `paged_decode_attention_cuda.launches`
    counts the kernel's launches.
    """
    return _paged_cuda(paged_decode_attention_cuda, q, pool_k, pool_v,
                       tables, index, window, scale, softcap, sinks)


def paged_decode_attention_quant_cuda(q, pool_k, pool_v, k_scale, v_scale,
                                      tables, index, *, window=None,
                                      scale=None, softcap=None, sinks=None):
    """Launch the CUDA paged flash-decode kernel over an int8 pool.

    pool_k/v: (n_blocks, Hkv, bs, D) int8; k_scale/v_scale: (n_blocks,
    Hkv, bs) fp32. Raises as `paged_decode_attention_cuda` does;
    `paged_decode_attention_quant_cuda.launches` counts its launches.
    """
    return _paged_cuda(paged_decode_attention_quant_cuda, q, pool_k, pool_v,
                       tables, index, window, scale, softcap, sinks,
                       k_scale, v_scale)


paged_decode_attention_cuda.launches = 0
paged_decode_attention_quant_cuda.launches = 0


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
    index: (B,) int32 pre-write lengths. k_scale/v_scale: (n_blocks, Hkv,
    bs) fp32 scale pools of an int8 pool, both or neither. impl "auto"
    launches the CUDA kernel on CUDA tensors (raising on a shape it does
    not take) and the plain version on CPU tensors; "ref" always takes
    the plain version.
    """
    _check_scales("paged_decode_attention", k_scale, v_scale)
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown paged decode impl {impl!r}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    kw = dict(window=window, scale=scale, softcap=softcap, sinks=sinks)
    if impl == "auto" and q.is_cuda:
        if k_scale is not None:
            return paged_decode_attention_quant_cuda(
                q, pool_k, pool_v, k_scale, v_scale, tables, index, **kw)
        return paged_decode_attention_cuda(q, pool_k, pool_v, tables, index,
                                           **kw)
    if impl == "auto" and q.device.type != "cpu":
        raise ValueError(
            f"paged_decode_attention: unsupported device {q.device}")
    return _paged_decode_ref(q, pool_k, pool_v, tables, index, window,
                             scale, softcap=softcap, sinks=sinks,
                             k_scale=k_scale, v_scale=v_scale)
