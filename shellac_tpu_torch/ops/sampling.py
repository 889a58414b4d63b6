"""Token sampling: temperature, top-k, nucleus (top-p), min-p, greedy.

All filtering happens in fp32 logit space with masks, as in the JAX
package's `ops/sampling.py`. Random draws come from an explicit
`torch.Generator`; they cannot match JAX's threefry bits, so sampled
tokens agree with the JAX package in distribution, not token for token.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask all but the k largest logits per row (ties at the kth value
    are kept). k >= vocab is a no-op; k < 1 is rejected."""
    if k < 1:
        raise ValueError(f"top_k must be >= 1, got {k}")
    k = min(k, logits.shape[-1])
    kth = torch.sort(logits, dim=-1).values[..., -k][..., None]
    return torch.where(logits < kth, NEG_INF, logits)


def top_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest set with cumulative prob >= p."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # Keep entries whose *previous* cumulative mass is < p (always keeps
    # the top-1).
    keep_sorted = (cum - probs) < p
    kth = torch.where(keep_sorted, sorted_logits, torch.inf).amin(
        dim=-1, keepdim=True
    )
    return torch.where(logits < kth, NEG_INF, logits)


def min_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Keep tokens whose prob >= p * max prob (scale-adaptive cutoff)."""
    probs = torch.softmax(logits, dim=-1)
    cutoff = p * probs.amax(dim=-1, keepdim=True)
    return torch.where(probs < cutoff, NEG_INF, logits)


def repetition_penalty(
    logits: torch.Tensor,  # (..., V)
    seen: torch.Tensor,  # (..., V) bool — tokens already in the context
    penalty: float,
) -> torch.Tensor:
    """HF-convention penalty: seen tokens' logits /p if >0 else *p."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def sample(
    generator: Optional[torch.Generator],
    logits: torch.Tensor,  # (..., V)
    *,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    min_p: Optional[float] = None,
) -> torch.Tensor:
    """Sample token ids (int64). temperature == 0 means greedy."""
    logits = logits.float()
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k is not None:
        logits = top_k_mask(logits, top_k)
    if top_p is not None:
        logits = top_p_mask(logits, top_p)
    if min_p is not None:
        logits = min_p_mask(logits, min_p)
    probs = torch.softmax(logits, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    draws = torch.multinomial(flat, 1, generator=generator)
    return draws.reshape(probs.shape[:-1])
