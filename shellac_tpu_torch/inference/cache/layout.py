"""KV caches for autoregressive decoding: a dense slot cache and a paged
block pool.

Ports `shellac_tpu/inference/cache/layout.py` (`KVCache`, `init_cache`,
`update_layer`, `scatter_slot`, `PagedKVCache` :309, `init_paged_cache`
:341, `paged_update_layer` :359, `paged_gather_layer` :392).

Dense layout: stacked over layers and HEAD-MAJOR, (L, B, Hkv, max_len, Dh), as
in the JAX package: each (slot, kv head) reads one contiguous
(positions, head_dim) stream, which is what the decode kernel walks. The
cache lives in the compute dtype.

Ragged batches carry per-sequence `lengths`: prompts are right-padded
and written from offset 0 (prefill writes all S padded positions), and
`lengths = index + new_tokens_len` records how many are real. Decode
writes each sequence's next token at its own length, overwriting stale
pad slots.

Unlike the JAX package, the port writes the caches IN PLACE:
`update_layer`, `paged_update_layer` and `scatter_slot` store into the
given tensors, and `forward_with_cache` returns a cache that shares its
k/v storage with the one it was given.

Indices: JAX's gathers clamp an out-of-range index; torch's raise on the
CPU and fault on the card. The callers keep every table index in range
(a prefill pad is capped at max_len, and max_blocks = ceil(max_len /
block_size)), so nothing here clamps.
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
    # Host-side bound on `lengths`, kept so a write past max_len is
    # refused without reading the device. forward_with_cache grows it by
    # every write; a batching engine, whose slots recycle, sets it to its
    # own host maximum before each decode window.
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


def scatter_slot(cache: KVCache, mini: KVCache, slot: int) -> KVCache:
    """Write a batch-1 mini cache into `slot` of a dense slot cache, in
    place. A mini shorter than the cache fills the first positions of the
    slot's rows (JAX's dynamic_update_slice); its length becomes the
    slot's."""
    n = mini.k.shape[3]
    cache.k[:, slot:slot + 1, :, :n] = mini.k
    cache.v[:, slot:slot + 1, :, :n] = mini.v
    cache.lengths[slot:slot + 1] = mini.lengths
    return cache


# ---------------------------------------------------------------------------
# Paged cache (block pool + per-slot block tables)
# ---------------------------------------------------------------------------


@dataclass
class PagedKVCache:
    """Block-pool KV cache: slots map to pool blocks through tables.

    k, v: (L, n_blocks, Hkv, block_size, Dh), head-major inside each block.
    tables: (n_slots, max_blocks) int32, the pool block of each logical
        block; unallocated entries point at block 0, which is scratch and
        never handed to a slot, so stray writes through them land there.
    lengths: (n_slots,) int32, valid tokens per slot.
    """

    k: torch.Tensor
    v: torch.Tensor
    tables: torch.Tensor
    lengths: torch.Tensor
    # Host-side bound on `lengths`, as KVCache.max_length.
    max_length: int = 0

    @property
    def block_size(self) -> int:
        return self.k.shape[3]

    @property
    def max_blocks(self) -> int:
        return self.tables.shape[1]

    @property
    def max_len(self) -> int:
        """Positions a table row can address."""
        return self.max_blocks * self.block_size

    def replace(self, **kw) -> "PagedKVCache":
        return replace(self, **kw)


def init_paged_cache(cfg: ModelConfig, n_slots: int, n_blocks: int,
                     block_size: int, max_blocks_per_slot: int,
                     device: torch.device) -> PagedKVCache:
    """An all-zero pool in the compute dtype, every table entry at 0."""
    if cfg.mla is not None:
        raise NotImplementedError("MLA latent caches are not ported yet")
    shape = (cfg.n_layers, n_blocks, cfg.kv_heads, block_size,
             cfg.dim_per_head)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        tables=torch.zeros((n_slots, max_blocks_per_slot), dtype=torch.int32,
                           device=device),
        lengths=torch.zeros((n_slots,), dtype=torch.int32, device=device),
    )


def paged_update_layer(
    pool_k: torch.Tensor,  # (n_blocks, Hkv, bs, Dh) — one layer's pool
    pool_v: torch.Tensor,
    k_new: torch.Tensor,  # (B, S, Hkv, Dh)
    v_new: torch.Tensor,
    index: torch.Tensor,  # (B,) int — per-slot write offsets
    tables: torch.Tensor,  # (B, max_blocks) int32
):
    """Scatter S new positions through the block tables, in place.

    Position index[b] + i lands at (tables[b, p // bs], :, p % bs).
    Returns the (same) pools. A position past the table raises on the
    CPU rather than clamping.
    """
    bs = pool_k.shape[2]
    b, s = k_new.shape[:2]
    pos = index.to(torch.int64)[:, None] + torch.arange(
        s, device=index.device
    )[None, :]  # (B, S)
    blocks = torch.gather(tables.to(torch.int64), 1, pos // bs).reshape(-1)
    offs = (pos % bs).reshape(-1)
    # Advanced indices at dims 0 and 2 (split by the head slice) put the
    # token rows first: the target is (B*S, Hkv, Dh), as k_new's rows.
    pool_k[blocks, :, offs] = k_new.to(pool_k.dtype).reshape(
        b * s, *k_new.shape[2:])
    pool_v[blocks, :, offs] = v_new.to(pool_v.dtype).reshape(
        b * s, *v_new.shape[2:])
    return pool_k, pool_v


def paged_gather_layer(
    pool_k: torch.Tensor,  # (n_blocks, Hkv, bs, Dh)
    pool_v: torch.Tensor,
    tables: torch.Tensor,  # (B, max_blocks)
):
    """Each slot's logical KV view, head-major: (B, Hkv, max_blocks*bs,
    Dh), the layout of a dense cache layer, so the plain decode
    attention reads it directly."""
    b, mb = tables.shape
    hkv, bs, dh = pool_k.shape[1:]

    def gather(pool):
        x = pool[tables.reshape(-1).to(torch.int64)]  # (B*mb, Hkv, bs, Dh)
        x = x.reshape(b, mb, hkv, bs, dh).transpose(1, 2)
        return x.reshape(b, hkv, mb * bs, dh)

    return gather(pool_k), gather(pool_v)
