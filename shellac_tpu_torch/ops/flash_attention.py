"""Flash attention forward: the CUDA kernel's wrapper and its plain version.

`flash_attention` takes q (B, S, H, D) and k, v (B, S, Hkv, D) and
computes causal or non-causal attention with an optional sliding window,
softcap and per-head sinks. On a CUDA tensor it launches the kernel in
`csrc/flash_attention.cu`; on a CPU tensor it takes `flash_attention_ref`,
the plain PyTorch version (the masked reference attention).

The kernel takes any S (the ragged tail is masked in-kernel), head_dim 64
and 128, bf16 and fp32. It computes the serving forward only: packed
segments and the logsumexp output come with the backward kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from shellac_tpu_torch.ops import _build
from shellac_tpu_torch.ops.attention import attention_ref

_KERNEL_DTYPES = {torch.float32: _build.DTYPE_F32,
                  torch.bfloat16: _build.DTYPE_BF16}
KERNEL_HEAD_DIMS = (64, 128)


def sink_rebase(m, l, sink):
    """Fold a sink logit into an online-softmax (m, l) pair.

    Returns (r, l2, m2): rescale the accumulator by r, divide by l2, and
    m2 + log(l2) is the sink-inclusive logsumexp. The CUDA kernels apply
    the same three lines in their finalizers.
    """
    m2 = torch.maximum(m, sink)
    r = torch.exp(m - m2)
    return r, l * r + torch.exp(sink - m2), m2


def flash_attention_ref(q, k, v, *, causal=True, scale=None, window=None,
                        softcap=None, sinks=None):
    """The plain PyTorch version of the flash kernel."""
    return attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                         softcap=softcap, sinks=sinks)


def flash_attention_cuda(q, k, v, *, causal=True, scale=None, window=None,
                         softcap=None, sinks=None):
    """Launch the CUDA flash-attention forward kernel.

    Raises on what the kernel does not take. `flash_attention_cuda.
    launches` counts the kernel's launches.
    """
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention_cuda: dtypes {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention_cuda: q (B,S,H,D), k=v (B,S,Hkv,D)")
    b, s, h, d = q.shape
    _, sk, hkv, dk = k.shape
    if k.shape[0] != b or sk != s or dk != d:
        raise ValueError(
            f"flash_attention_cuda: q {tuple(q.shape)} vs k {tuple(k.shape)}"
        )
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head_dim {d} not in "
                         f"{KERNEL_HEAD_DIMS}")
    if h % hkv != 0:
        raise ValueError(f"n_heads={h} not divisible by n_kv_heads={hkv}")
    if window is not None and (window < 1 or not causal):
        raise ValueError(
            "flash_attention_cuda: a window needs causal=True and window >= 1"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda needs contiguous q, k, v")
    if sinks is not None:
        if sinks.dtype != torch.float32 or sinks.shape != (h,) \
                or not sinks.is_cuda or not sinks.is_contiguous():
            raise ValueError("flash_attention_cuda: sinks must be fp32 (H,)")
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _build.launch(
        "shellac_flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if sinks is None else sinks.data_ptr(), out.data_ptr(),
        b, s, h, hkv, d, float(scale), int(causal),
        -1 if window is None else int(window),
        0.0 if softcap is None else float(softcap),
        _KERNEL_DTYPES[q.dtype],
    )
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def flash_attention(q, k, v, *, causal=True, scale=None, window=None,
                    softcap=None, sinks=None):
    """Flash attention forward: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if q.is_cuda:
        return flash_attention_cuda(
            q, k, v, causal=causal, scale=scale, window=window,
            softcap=softcap, sinks=sinks,
        )
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return flash_attention_ref(q, k, v, causal=causal, scale=scale,
                               window=window, softcap=softcap, sinks=sinks)
