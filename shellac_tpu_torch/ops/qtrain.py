"""Quantized (int8) matmuls for the training step.

Port of `shellac_tpu/ops/qtrain.py`: `int8_dot` (:66), `int8_dot_full`
(:124) and `quant_dot` (:151), each dot a `torch.autograd.Function`.
XLA's int8 `dot_general` with int32 accumulation becomes `torch._int_mm`
(int8 x int8 -> int32, exact), on the card and on the CPU alike.

  - forward: dynamic symmetric quantization, activations per row (scale
    over the contraction axis) and weights per output channel, an int8
    product, dequantized by the product of both scales;
  - `int8_dot`'s backward is straight-through in the compute dtype:
    dx = g W^T and dW = x^T g, unquantized;
  - `int8_dot_full`'s backward ("int8_bwd") runs both products in int8
    too: dx contracts over the features (g per row, W per input
    channel), dW over the batch (x and g each with one scale per channel
    over the whole batch).

On the card `torch._int_mm` takes (m, k) x (k, n) with m > 16 and k and n
multiples of 8; a product outside that raises (`_check_int_mm`), it does
not fall back to another dot. The master parameters stay fp32: this is a
compute quantization, derived from the live weights every step. The
embeddings, the LM head, the routers and the expert products stay in the
compute dtype, as in the reference.
"""

from __future__ import annotations

import torch

_QMAX = 127.0


def _quantize_rows(x: torch.Tensor, axis: int):
    """Symmetric int8 quantization with a scale per slice along `axis`
    (the reference's `_quantize_rows`): (int8 values, fp32 scales with
    `axis` kept)."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax / _QMAX, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -_QMAX, _QMAX).to(torch.int8)
    return q, scale


def _check_int_mm(a: torch.Tensor, b: torch.Tensor) -> None:
    """Raise on an int8 product the card's `torch._int_mm` does not take."""
    if not a.is_cuda:
        return
    m, k = a.shape
    n = b.shape[1]
    if m <= 16 or k % 8 or n % 8:
        raise ValueError(
            f"int8 product ({m}, {k}) x ({k}, {n}): the card's int8 matmul "
            "needs more than 16 rows and k, n multiples of 8"
        )


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (m, k) x (k, n) -> int32, exact."""
    _check_int_mm(a, b)
    return torch._int_mm(a.contiguous(), b.contiguous())


def _int8_forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    qx, sx = _quantize_rows(xf, axis=1)  # (N, 1)
    qw, sw = _quantize_rows(w, axis=0)  # (1, F)
    out = _int_mm(qx, qw).float() * sx * sw
    return out.reshape(*x.shape[:-1], w.shape[1]).to(x.dtype)


def _int8_contract(a, b, a_axis: int, b_axis: int) -> torch.Tensor:
    """int8 a x b contracting (a_axis, b_axis) of two matrices, with one
    dequant scale per slice along each contraction: the int32 sum is
    exact and the scales factor out of it (`_int8_contract` :98)."""
    qa, sa = _quantize_rows(a, axis=a_axis)
    qb, sb = _quantize_rows(b, axis=b_axis)
    qa = qa if a_axis == 1 else qa.t()
    qb = qb if b_axis == 0 else qb.t()
    acc = _int_mm(qa, qb)
    return acc.float() * sa.reshape(-1, 1) * sb.reshape(1, -1)


class Int8Dot(torch.autograd.Function):
    """x (..., D) @ w (D, F): int8 forward, straight-through backward in
    the inputs' dtype (`int8_dot`)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _int8_forward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        d, f = w.shape
        gf = g.reshape(-1, f)
        xf = x.reshape(-1, d)
        dx = (gf @ w.to(g.dtype).t()).reshape(x.shape).to(x.dtype)
        dw = (xf.t() @ gf.to(xf.dtype)).to(w.dtype)
        return dx, dw


class Int8DotFull(torch.autograd.Function):
    """x (..., D) @ w (D, F): int8 forward and int8 backward products
    (`int8_dot_full`)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _int8_forward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        d, f = w.shape
        gf = g.reshape(-1, f).float()
        xf = x.reshape(-1, d).float()
        # dx[n, d] = sum_f g[n, f] w[d, f]: g per row, w per input channel.
        dx = _int8_contract(gf, w.float(), 1, 1)
        # dW[d, f] = sum_n x[n, d] g[n, f]: both per channel over the batch.
        dw = _int8_contract(xf, gf, 0, 0)
        return dx.reshape(x.shape).to(x.dtype), dw.to(w.dtype)


def int8_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return Int8Dot.apply(x, w)


def int8_dot_full(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return Int8DotFull.apply(x, w)


def quant_dot(x: torch.Tensor, w: torch.Tensor, quant_training) -> torch.Tensor:
    """The transformer's dense-projection dot: quantized when asked."""
    if quant_training == "int8":
        return int8_dot(x, w)
    if quant_training == "int8_bwd":
        return int8_dot_full(x, w)
    if quant_training is not None:
        raise ValueError(
            f"unknown quant_training {quant_training!r}; "
            "have 'int8', 'int8_bwd'"
        )
    return x @ w
