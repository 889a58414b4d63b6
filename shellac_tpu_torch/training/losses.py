"""Loss functions (fp32 throughout).

Port of `shellac_tpu/training/losses.py` `cross_entropy` (:11). The
vocab-chunked `fused_cross_entropy` (:187) is not ported.
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
