"""Loss functions (fp32 throughout).

Port of `shellac_tpu/training/losses.py`: `cross_entropy` (:11) and the
vocab-chunked `fused_cross_entropy` (:187) with its recomputing backward
(the reference's custom VJP, :127-183).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def cross_entropy(
    logits: torch.Tensor,  # (..., V)
    targets: torch.Tensor,  # (...) int
    mask: Optional[torch.Tensor] = None,  # (...) 0/1
    z_loss_weight: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean token cross-entropy with optional z-loss.

    Returns (loss, metrics): `loss` (the mean over the mask's tokens),
    `perplexity` (exp of the loss capped at 30) and `tokens` (the
    denominator), all fp32 0-dim tensors.
    """
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - true_logit
    if z_loss_weight:
        nll = nll + z_loss_weight * torch.square(logz)
    if mask is None:
        denom = torch.tensor(float(nll.numel()), dtype=torch.float32,
                             device=nll.device)
        total = nll.sum()
    else:
        mask = mask.float()
        denom = torch.clamp(mask.sum(), min=1.0)
        total = (nll * mask).sum()
    loss = total / denom
    metrics = {
        "loss": loss,
        "perplexity": torch.exp(torch.clamp(loss, max=30.0)),
        "tokens": denom,
    }
    return loss, metrics


# --------------------------------------------------------------------------
# Fused (vocab-chunked) cross-entropy
# --------------------------------------------------------------------------


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b summed and returned in fp32, as the reference's dot_general
    with preferred_element_type=float32: bf16 operands on the card's
    tensor cores with an fp32 result, fp32 products otherwise."""
    if a.is_cuda and a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class FusedCrossEntropyFunction(torch.autograd.Function):
    """(nll, lse) of x (N, D) @ w (D, V) against targets (N,) by an online
    logsumexp over vocab chunks, never holding the (N, V) logits. The
    backward recomputes each chunk's logits from the saved lse:
    dlogits_c = a p_c - b onehot_c, a = g_nll + g_lse, b = g_nll, rounded
    to x's dtype before its two products (the reference's `bwd`)."""

    @staticmethod
    def forward(ctx, x, w, targets, vocab_chunk):
        n = x.shape[0]
        v = w.shape[1]
        m = torch.full((n,), float("-inf"), dtype=torch.float32,
                       device=x.device)
        s = torch.zeros((n,), dtype=torch.float32, device=x.device)
        tgt = torch.zeros((n,), dtype=torch.float32, device=x.device)
        for c0 in range(0, v, vocab_chunk):
            logits = _mm_f32(x, w[:, c0:c0 + vocab_chunk])
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=-1)
            m = m_new
            idx = targets - c0
            in_range = (idx >= 0) & (idx < vocab_chunk)
            got = torch.gather(logits, 1, idx.clamp(0, vocab_chunk - 1)
                               [:, None].long())[:, 0]
            tgt = torch.where(in_range, got, tgt)
        lse = m + torch.log(s)
        ctx.save_for_backward(x, w, targets, lse)
        ctx.vocab_chunk = vocab_chunk
        return lse - tgt, lse

    @staticmethod
    def backward(ctx, g_nll, g_lse):
        x, w, targets, lse = ctx.saved_tensors
        chunk = ctx.vocab_chunk
        if g_nll is None:
            g_nll = torch.zeros_like(lse)
        if g_lse is None:
            g_lse = torch.zeros_like(lse)
        a = (g_nll + g_lse).float()[:, None]
        b = g_nll.float()[:, None]
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw = torch.empty(w.shape, dtype=w.dtype, device=w.device)
        cols = torch.arange(chunk, device=x.device)[None, :]
        for c0 in range(0, w.shape[1], chunk):
            wc = w[:, c0:c0 + chunk]
            p = torch.exp(_mm_f32(x, wc) - lse[:, None])
            onehot = cols == (targets - c0)[:, None]
            dlog = (a * p - torch.where(onehot, b, 0.0)).to(x.dtype)
            dx += _mm_f32(dlog, wc.t())
            dw[:, c0:c0 + chunk] = _mm_f32(x.t(), dlog).to(w.dtype)
        return dx.to(x.dtype), dw, None, None


def fused_cross_entropy(
    hidden: torch.Tensor,  # (..., D) compute dtype, post-final-norm
    w_out: torch.Tensor,  # (D, V)
    targets: torch.Tensor,  # (...) int
    mask: Optional[torch.Tensor] = None,
    z_loss_weight: float = 0.0,
    vocab_chunk: int = 2048,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """`cross_entropy` without the (N, V) logits: the LM-head product, the
    log-softmax and the target gather run chunked over the vocab. V must
    divide by vocab_chunk (the train step falls back to the unfused path
    otherwise). Returns (loss, metrics) as `cross_entropy` does."""
    d = hidden.shape[-1]
    v = w_out.shape[-1]
    if v % vocab_chunk:
        raise ValueError(f"vocab {v} not divisible by chunk {vocab_chunk}")
    lead = hidden.shape[:-1]
    x = hidden.reshape(-1, d)
    t = targets.reshape(-1).to(torch.int32)
    nll, lse = FusedCrossEntropyFunction.apply(x, w_out, t, vocab_chunk)
    nll = nll.reshape(lead)
    lse = lse.reshape(lead)
    if z_loss_weight:
        nll = nll + z_loss_weight * torch.square(lse)
    if mask is None:
        denom = torch.tensor(float(nll.numel()), dtype=torch.float32,
                             device=nll.device)
        total = nll.sum()
    else:
        mask = mask.float()
        denom = torch.clamp(mask.sum(), min=1.0)
        total = (nll * mask).sum()
    loss = total / denom
    metrics = {
        "loss": loss,
        "perplexity": torch.exp(torch.clamp(loss, max=30.0)),
        "tokens": denom,
    }
    return loss, metrics
