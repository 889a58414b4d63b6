"""Rotary position embeddings: the NeoX half rotation (`apply_rope`) and
MLA's adjacent-pair rotation (`apply_rope_interleaved`).

Frequencies are computed in fp32 regardless of compute dtype: bf16 loses
precision at long positions. Same numerics as the JAX package's
`ops/rope.py`, including the yarn, llama3 and linear scalings.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float = 10000.0,
                yarn=None, llama3=None, linear=None):
    """cos/sin tables for given absolute positions.

    positions: int tensor, any shape (typically (B, S) or (S,)).
    Returns (cos, sin) with shape positions.shape + (head_dim // 2,), fp32.
    """
    half = head_dim // 2
    scale = 1.0
    dev = positions.device
    if yarn is not None:
        freq, scale = _yarn_table(head_dim, theta, yarn, dev)
    else:
        freq = 1.0 / (
            theta ** (torch.arange(0, half, dtype=torch.float32, device=dev)
                      / half)
        )
        if llama3 is not None:
            freq = _llama3_inv_freq(freq, llama3)
        if linear is not None:
            freq = freq / linear
    ang = positions.float()[..., None] * freq
    return torch.cos(ang) * scale, torch.sin(ang) * scale


def _llama3_inv_freq(inv_freq: torch.Tensor, l3) -> torch.Tensor:
    """Llama-3.1 banded frequency scaling (HF _compute_llama3_parameters)."""
    old = l3.original_max_position_embeddings
    low_wl = old / l3.low_freq_factor
    high_wl = old / l3.high_freq_factor
    wavelen = 2 * math.pi / inv_freq
    scaled = torch.where(wavelen > low_wl, inv_freq / l3.factor, inv_freq)
    smooth = (old / wavelen - l3.low_freq_factor) / (
        l3.high_freq_factor - l3.low_freq_factor
    )
    smoothed = (1 - smooth) * scaled / l3.factor + smooth * scaled
    medium = (~(wavelen < high_wl)) & (~(wavelen > low_wl))
    return torch.where(medium, smoothed, scaled)


# (dim, base, yarn config, device) -> (inverse frequencies on the device,
# attention factor). Never evicted: a captured CUDA graph reads a table's
# storage on every replay and holds no reference to it, so a table freed
# while a graph over it lives would be read after the allocator reused it.
_YARN_TABLES: dict = {}


def _yarn_table(dim: int, base: float, yarn, device: torch.device):
    """The yarn inverse frequencies on `device` and the attention factor,
    made once per (dim, base, config, device) and shared read-only for
    the life of the process: a copy from host memory cannot be recorded
    in a CUDA graph, and every program runs eagerly (filling this)
    before its capture."""
    key = (dim, base, yarn, device)
    table = _YARN_TABLES.get(key)
    if table is None:
        freq, scale = _yarn_inv_freq(dim, base, yarn)
        table = _YARN_TABLES[key] = (freq.to(device), scale)
    return table


def _yarn_inv_freq(dim: int, base: float, yarn):
    """Yarn inverse frequencies + attention factor (static, numpy)."""
    factor = yarn.factor
    attention_factor = yarn.attention_factor

    def get_mscale(scale, mscale=1.0):
        if scale <= 1:
            return 1.0
        return 0.1 * mscale * math.log(scale) + 1.0

    if attention_factor is None:
        if yarn.mscale and yarn.mscale_all_dim:
            attention_factor = float(
                get_mscale(factor, yarn.mscale)
                / get_mscale(factor, yarn.mscale_all_dim)
            )
        else:
            attention_factor = get_mscale(factor)

    def correction_dim(num_rot):
        return (dim * math.log(
            yarn.original_max_position_embeddings / (num_rot * 2 * math.pi)
        )) / (2 * math.log(base))

    low = correction_dim(yarn.beta_fast)
    high = correction_dim(yarn.beta_slow)
    if yarn.truncate:
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, dim - 1)
    if low == high:
        high += 0.001

    pos_freqs = base ** (np.arange(0, dim, 2, dtype=np.float32) / dim)
    extrap = 1.0 / pos_freqs
    interp = 1.0 / (factor * pos_freqs)
    ramp = np.clip(
        (np.arange(dim // 2, dtype=np.float32) - low) / (high - low), 0, 1
    )
    extrap_factor = 1.0 - ramp
    inv_freq = interp * (1 - extrap_factor) + extrap * extrap_factor
    return (torch.from_numpy(np.asarray(inv_freq, np.float32)),
            float(attention_factor))


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate the head dimension of x.

    x: (..., S, H, D). cos/sin: broadcastable to (..., S, 1, D/2) — e.g.
    shape (B, S, D/2) or (S, D/2).
    """
    half = x.shape[-1] // 2
    c = cos[..., None, :]
    s = sin[..., None, :]
    x1f = x[..., :half].float()
    x2f = x[..., half:].float()
    out1 = x1f * c - x2f * s
    out2 = x2f * c + x1f * s
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor,
                           sin: torch.Tensor) -> torch.Tensor:
    """Rotate ADJACENT pairs of the head dim (the complex / GPT-J form).

    DeepSeek's MLA rope treats (x[2i], x[2i+1]) as one complex number,
    unlike `apply_rope`'s half rotation; port of the JAX package's
    `apply_rope_interleaved` (ops/rope.py:116). Shapes as `apply_rope`:
    x (..., S, H, D), cos/sin broadcastable to (..., S, 1, D/2). fp32
    rotation, cast back to x's dtype.
    """
    c = cos[..., None, :]
    s = sin[..., None, :]
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.reshape(x.shape).to(x.dtype)
