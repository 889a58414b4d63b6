"""Flash attention: the CUDA kernels' wrappers, their plain versions and the
autograd Function that joins them.

Ports `shellac_tpu/ops/flash_attention.py`. `flash_attention` takes q
(B, S, H, D) and k, v (B, S, Hkv, D) and computes causal or non-causal
attention with an optional sliding window, softcap, per-head sinks and
packed segments (one (B, S) int32 row of document ids shared by q and
kv). On CUDA tensors it launches the kernels of `csrc/flash_attention.cu`
(forward, kernel 2) and `csrc/flash_attention_bwd.cu` (dk/dv, kernel 3;
dq, kernel 4) through `FlashAttentionFunction` when autograd records the
call, the forward alone otherwise. On CPU tensors it takes
`flash_attention_ref`, the plain PyTorch version (the masked reference
attention), differentiated by torch autograd.

The kernels take any S (the ragged tail is masked in-kernel), head_dim
64, 128 and 192 (MLA's expanded attention: q and k 192 wide, v padded to
192, as the JAX package pads it), bf16 and fp32, with or without packed
segments. Every bf16 shape runs the `wgmma` bodies; at 192 the dk/dv
body splits its two consumer warpgroups by output (dV and dK) over
64-row kv tiles, and the dq body single-buffers q and dO, so that
their registers and shared memory fit (the note at the head of
`csrc/flash_attention_bwd.cu`). fp32 runs the CUDA-core parity bodies.
Beside each kernel stands its plain version computing the same outputs
from the same inputs by the same recomputation (`flash_forward_ref`,
`flash_bwd_dkdv_ref`,
`flash_bwd_dq_ref`): the tests and `chip_smoke.py` hold the kernels to
them, and the Function takes either set (`KERNELS`, `PLAIN`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from shellac_tpu_torch.ops import _build
from shellac_tpu_torch.ops.attention import NEG_INF, attention_ref

_KERNEL_DTYPES = {torch.float32: _build.DTYPE_F32,
                  torch.bfloat16: _build.DTYPE_BF16}
# 192: MLA's qk width (q and k 192 wide, v padded up to it).
KERNEL_HEAD_DIMS = (64, 128, 192)


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
                        softcap=None, sinks=None, segments=None):
    """The plain PyTorch version of the flash forward's output."""
    return attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                         softcap=softcap, sinks=sinks, q_segments=segments,
                         kv_segments=segments)


# --------------------------------------------------------------------------
# plain versions of the kernels' recomputation
# --------------------------------------------------------------------------


def _scores_ref(q, k, *, causal, scale, window, softcap, segments):
    """Scaled fp32 logits (B, Hkv, G, S, S) with every mask applied to the
    NEG_INF sentinel, as `_scores` computes them (softcap first)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, d).float() * scale
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
    rows = torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(s, device=q.device)[None, :]
    ok = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (cols <= rows)
    if window is not None:
        ok = ok & (rows - cols < window)
    ok = ok[None, None, None]
    if segments is not None:
        same = segments[:, :, None] == segments[:, None, :]
        ok = ok & same[:, None, None]
    return sc.masked_fill(~ok, NEG_INF)


def flash_forward_ref(q, k, v, *, causal=True, scale=None, window=None,
                      softcap=None, sinks=None, segments=None):
    """(out, lse) of the forward kernel: out (B, S, H, D) in q's dtype and
    the sink-inclusive logsumexp rows (B, H, S) fp32."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    sc = _scores_ref(q, k, causal=causal, scale=scale, window=window,
                     softcap=softcap, segments=segments)
    live = sc > 0.5 * NEG_INF
    m = sc.amax(-1)
    l = torch.where(live, torch.exp(sc - m[..., None]), 0.0).sum(-1)
    if sinks is not None:
        sk = sinks.float().reshape(1, hkv, h // hkv, 1)
        _, l, m = sink_rebase(m, l, sk)
    else:
        l = torch.where(l == 0.0, 1.0, l)
    lse = m + torch.log(l)
    p = torch.where(live, torch.exp(sc - lse[..., None]), 0.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return (out.reshape(b, s, h, d).to(q.dtype),
            lse.reshape(b, h, s).contiguous())


def _p_ds_ref(q, k, v, dout, lse, delta, *, causal, scale, window, softcap,
              segments):
    """p and ds (B, Hkv, G, S, S) fp32 from the saved lse and delta, by
    the formulas of `_tile_p_ds`."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    sc = _scores_ref(q, k, causal=causal, scale=scale, window=window,
                     softcap=softcap, segments=segments)
    # Gate on the sentinel itself: a row masked across a tile may have an
    # lse at the sentinel too, and exp(s - lse) would then be 1.
    live = sc > 0.5 * NEG_INF
    lse_g = lse.reshape(b, hkv, g, s, 1)
    p = torch.where(live, torch.exp(sc - lse_g), 0.0)
    dog = dout.reshape(b, s, hkv, g, d).float()
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = p * (dp - delta.reshape(b, hkv, g, s, 1)) * scale
    if softcap is not None:
        # (NEG_INF / cap)^2 is inf on masked slots; gate it like p.
        ds = ds * torch.where(live, 1.0 - torch.square(sc / softcap), 0.0)
    return p, ds


def flash_bwd_dkdv_ref(q, k, v, dout, lse, delta, *, causal=True, scale=None,
                       window=None, softcap=None, segments=None):
    """(dk, dv) of kernel 3: summed over each kv head's GQA group, in k's
    dtype. dk takes ds^T q with the unscaled q (ds carries the scale)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    p, ds = _p_ds_ref(q, k, v, dout, lse, delta, causal=causal, scale=scale,
                      window=window, softcap=softcap, segments=segments)
    qg = q.reshape(b, s, hkv, h // hkv, d)
    dog = dout.reshape(b, s, hkv, h // hkv, d)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(dout.dtype).float(),
                      dog.float())
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds.to(q.dtype).float(),
                      qg.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_ref(q, k, v, dout, lse, delta, *, causal=True, scale=None,
                     window=None, softcap=None, segments=None):
    """dq of kernel 4, in q's dtype."""
    b, s, h, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    _, ds = _p_ds_ref(q, k, v, dout, lse, delta, causal=causal, scale=scale,
                      window=window, softcap=softcap, segments=segments)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds.to(k.dtype).float(), k.float())
    return dq.reshape(b, s, h, d).to(q.dtype)


def flash_bwd_dsinks(sinks, lse, delta):
    """The sink gradient (H,), plain torch as in the JAX package. The sink
    column's value is zero, so its only path is the softmax denominator:
    -sum over batch and rows of exp(sink - lse) * delta (lse includes the
    sink)."""
    return -(torch.exp(sinks.float()[None, :, None] - lse)
             * delta).sum(dim=(0, 2)).to(sinks.dtype)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def _check(name, q, k, v, *, causal, window, sinks, segments):
    """Raise on what the flash kernels do not take; returns the shapes."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"{name} needs CUDA tensors")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q (B,S,H,D), k=v (B,S,Hkv,D)")
    b, s, h, d = q.shape
    _, sk, hkv, dk = k.shape
    if k.shape[0] != b or sk != s or dk != d:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {KERNEL_HEAD_DIMS}")
    if h % hkv != 0:
        raise ValueError(f"n_heads={h} not divisible by n_kv_heads={hkv}")
    if window is not None and (window < 1 or not causal):
        raise ValueError(
            f"{name}: a window needs causal=True and window >= 1"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name} needs contiguous q, k, v")
    _check_tma(name, q=q, k=k, v=v)
    if sinks is not None:
        if sinks.dtype != torch.float32 or sinks.shape != (h,) \
                or not sinks.is_cuda or not sinks.is_contiguous():
            raise ValueError(f"{name}: sinks must be fp32 (H,)")
    if segments is not None:
        if segments.dtype != torch.int32 or segments.shape != (b, s) \
                or not segments.is_cuda or not segments.is_contiguous():
            raise ValueError(f"{name}: segments must be int32 (B, S), "
                             "contiguous, on the card")
    return b, s, h, hkv, d


def _check_tma(name, **tensors):
    """The bf16 kernels read and write through TMA tensor maps: base
    addresses and the strides the maps use (between heads, positions and
    batches) must be multiples of 16 bytes."""
    for nm, t in tensors.items():
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"{name}: {nm}.data_ptr() is not 16-byte "
                             "aligned")
        if any(st * t.element_size() % 16 != 0 for st in t.stride()[:3]):
            raise ValueError(f"{name}: {nm}'s strides are not multiples "
                             "of 16 bytes")


def _opt(x):
    return None if x is None else x.data_ptr()


def flash_attention_cuda(q, k, v, *, causal=True, scale=None, window=None,
                         softcap=None, sinks=None, segments=None,
                         with_lse=False):
    """Launch the CUDA flash-attention forward kernel (kernel 2).

    Returns out, or (out, lse) with `with_lse`: lse is the
    sink-inclusive logsumexp (B, H, S) fp32 the backward kernels read.
    Raises on what the kernel does not take.
    `flash_attention_cuda.launches` counts the kernel's launches.
    """
    b, s, h, hkv, d = _check("flash_attention_cuda", q, k, v, causal=causal,
                             window=window, sinks=sinks, segments=segments)
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() != 0:
        _build.launch(
            "shellac_flash_attention", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), _opt(sinks), _opt(segments), out.data_ptr(),
            _opt(lse), b, s, h, hkv, d, float(scale), int(causal),
            -1 if window is None else int(window),
            0.0 if softcap is None else float(softcap),
            _KERNEL_DTYPES[q.dtype],
        )
        flash_attention_cuda.launches += 1
    return (out, lse) if with_lse else out


flash_attention_cuda.launches = 0


def _check_bwd(name, q, k, v, dout, lse, delta, *, causal, window,
               segments):
    b, s, h, hkv, d = _check(name, q, k, v, causal=causal, window=window,
                             sinks=None, segments=segments)
    if dout.shape != q.shape or dout.dtype != q.dtype or not dout.is_cuda \
            or not dout.is_contiguous():
        raise ValueError(f"{name}: dout must match q, contiguous")
    _check_tma(name, dout=dout)
    for nm, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, s) or t.dtype != torch.float32 \
                or not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be fp32 (B, H, S)")
    return b, s, h, hkv, d


def _bwd_tail(d, scale, causal, window, softcap, dtype):
    return (float(d ** -0.5 if scale is None else scale), int(causal),
            -1 if window is None else int(window),
            0.0 if softcap is None else float(softcap),
            _KERNEL_DTYPES[dtype])


def flash_bwd_dkdv_cuda(q, k, v, dout, lse, delta, *, causal=True,
                        scale=None, window=None, softcap=None,
                        segments=None):
    """Launch kernel 3: (dk, dv), each (B, S, Hkv, D) in k's dtype.

    lse and delta are (B, H, S) fp32. Raises on what the kernel does not
    take. `flash_bwd_dkdv_cuda.launches` counts the kernel's launches.
    """
    b, s, h, hkv, d = _check_bwd("flash_bwd_dkdv_cuda", q, k, v, dout, lse,
                                 delta, causal=causal, window=window,
                                 segments=segments)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if dk.numel() != 0:
        _build.launch(
            "shellac_flash_attention_bwd_dkdv", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            _opt(segments), dk.data_ptr(), dv.data_ptr(), b, s, h, hkv, d,
            *_bwd_tail(d, scale, causal, window, softcap, q.dtype),
        )
        flash_bwd_dkdv_cuda.launches += 1
    return dk, dv


flash_bwd_dkdv_cuda.launches = 0


def flash_bwd_dq_cuda(q, k, v, dout, lse, delta, *, causal=True, scale=None,
                      window=None, softcap=None, segments=None):
    """Launch kernel 4: dq (B, S, H, D) in q's dtype.

    Arguments as `flash_bwd_dkdv_cuda`. `flash_bwd_dq_cuda.launches`
    counts the kernel's launches.
    """
    b, s, h, hkv, d = _check_bwd("flash_bwd_dq_cuda", q, k, v, dout, lse,
                                 delta, causal=causal, window=window,
                                 segments=segments)
    dq = torch.empty_like(q)
    if dq.numel() != 0:
        _build.launch(
            "shellac_flash_attention_bwd_dq", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            _opt(segments), dq.data_ptr(), b, s, h, hkv, d,
            *_bwd_tail(d, scale, causal, window, softcap, q.dtype),
        )
        flash_bwd_dq_cuda.launches += 1
    return dq


flash_bwd_dq_cuda.launches = 0


# --------------------------------------------------------------------------
# autograd
# --------------------------------------------------------------------------


class FlashImpl(NamedTuple):
    """The three functions `FlashAttentionFunction` runs: forward ->
    (out, lse), dkdv -> (dk, dv), dq -> dq, with the keyword contract of
    the plain versions."""

    forward: object
    dkdv: object
    dq: object


def _forward_cuda(q, k, v, **kw):
    return flash_attention_cuda(q, k, v, with_lse=True, **kw)


KERNELS = FlashImpl(_forward_cuda, flash_bwd_dkdv_cuda, flash_bwd_dq_cuda)
PLAIN = FlashImpl(flash_forward_ref, flash_bwd_dkdv_ref, flash_bwd_dq_ref)


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with a recomputing backward, as the JAX package's
    `_flash` custom VJP: the forward saves (q, k, v, segments, sinks, out,
    lse); the backward computes delta = sum(dO * O) in fp32, then dk and
    dv, then dq, and the sink gradient in plain torch.

    apply(q, k, v, segments, sinks, causal, scale, window, softcap, impl):
    `impl` is `KERNELS` on the card or `PLAIN` (any `FlashImpl`).
    """

    @staticmethod
    def forward(ctx, q, k, v, segments, sinks, causal, scale, window,
                softcap, impl):
        opts = dict(causal=causal, scale=scale, window=window,
                    softcap=softcap)
        out, lse = impl.forward(q, k, v, sinks=sinks, segments=segments,
                                **opts)
        ctx.save_for_backward(q, k, v, segments, sinks, out, lse)
        ctx.opts = opts
        ctx.impl = impl
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, segments, sinks, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        # delta_i = sum_d dO_id * O_id per (head, row), fp32, (B, H, S).
        delta = torch.einsum("bshd,bshd->bhs", dout.float(),
                             out.float()).contiguous()
        kw = dict(segments=segments, **ctx.opts)
        dk, dv = ctx.impl.dkdv(q, k, v, dout, lse, delta, **kw)
        dq = ctx.impl.dq(q, k, v, dout, lse, delta, **kw)
        d_sinks = None
        if sinks is not None and ctx.needs_input_grad[4]:
            d_sinks = flash_bwd_dsinks(sinks, lse, delta)
        return dq, dk, dv, None, d_sinks, None, None, None, None, None


def flash_attention(q, k, v, *, causal=True, scale=None, window=None,
                    softcap=None, sinks=None, segments=None):
    """Flash attention. On CUDA tensors: the kernels (through
    `FlashAttentionFunction` when autograd records the call, so the
    backward kernels run; the forward kernel alone otherwise). On CPU
    tensors: the plain version."""
    if q.is_cuda:
        if scale is None:
            scale = q.shape[-1] ** -0.5
        kw = dict(causal=causal, scale=float(scale), window=window,
                  softcap=softcap)
        if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, sinks)
        ):
            return FlashAttentionFunction.apply(
                q, k, v, segments, sinks, causal, float(scale), window,
                softcap, KERNELS,
            )
        return flash_attention_cuda(q, k, v, sinks=sinks, segments=segments,
                                    **kw)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return flash_attention_ref(q, k, v, causal=causal, scale=scale,
                               window=window, softcap=softcap, sinks=sinks,
                               segments=segments)
