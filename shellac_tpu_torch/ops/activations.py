"""Gated activations used by the MLP blocks."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """SwiGLU combine: silu(gate) * up."""
    return F.silu(gate) * up


def geglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """GeGLU combine with the tanh-approximated gelu (jax.nn.gelu's
    default)."""
    return F.gelu(gate, approximate="tanh") * up


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Soft logit cap: cap * tanh(x / cap), computed in fp32."""
    x32 = x.float()
    return (cap * torch.tanh(x32 / cap)).to(x.dtype)
