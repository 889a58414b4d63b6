"""Dense KV cache for autoregressive decoding.

Layout: stacked over layers and HEAD-MAJOR, (L, B, Hkv, max_len, Dh), as
in the JAX package: each (slot, kv head) reads one contiguous
(positions, head_dim) stream, which is what the decode kernel walks. The
cache lives in the compute dtype.

Ragged batches carry per-sequence `lengths`: prompts are right-padded
and written from offset 0 (prefill writes all S padded positions), and
`lengths = index + new_tokens_len` records how many are real. Decode
writes each sequence's next token at its own length, overwriting stale
pad slots.

Unlike the JAX package, the port writes the cache IN PLACE: `update_layer`
stores into the given tensors, and `forward_with_cache` returns a
`KVCache` that shares its k/v storage with the one it was given.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from shellac_tpu_torch.config import ModelConfig


@dataclass
class KVCache:
    k: torch.Tensor  # (L, B, Hkv, max_len, Dh)
    v: torch.Tensor  # (L, B, Hkv, max_len, Dh)
    lengths: torch.Tensor  # (B,) int32 — valid positions per sequence
    # Host-side max of `lengths`, kept so a write past max_len is
    # refused without reading the device.
    max_length: int = 0

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    def replace(self, **kw) -> "KVCache":
        return replace(self, **kw)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> KVCache:
    """An all-zero dense cache in the compute dtype."""
    if cfg.mla is not None:
        raise NotImplementedError("MLA latent caches are not ported yet")
    shape = (cfg.n_layers, batch, cfg.kv_heads, max_len, cfg.dim_per_head)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def update_layer(
    cache_k: torch.Tensor,  # (B, Hkv, max_len, Dh) — one layer's cache
    cache_v: torch.Tensor,
    k_new: torch.Tensor,  # (B, S, Hkv, Dh)
    v_new: torch.Tensor,
    index: torch.Tensor,  # (B,) int — per-sequence write offset
):
    """Write S new positions at per-sequence offsets, in place.

    Returns the (same) cache tensors. The caller keeps every
    index + S <= max_len: `forward_with_cache` checks that against the
    cache's host-side `max_length` and raises before writing.
    """
    b, s = k_new.shape[:2]
    pos = index.to(torch.int64)[:, None] + torch.arange(
        s, device=index.device
    )[None, :]  # (B, S)
    rows = torch.arange(b, device=index.device)[:, None]  # (B, 1)
    # Advanced indices split by a slice put their (B, S) dims first, so
    # the target view is (B, S, Hkv, Dh) — the layout of k_new itself.
    cache_k[rows, :, pos, :] = k_new.to(cache_k.dtype)
    cache_v[rows, :, pos, :] = v_new.to(cache_v.dtype)
    return cache_k, cache_v
