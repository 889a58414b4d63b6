"""KV caches for autoregressive decoding: a dense slot cache and a paged
block pool.

Ports `shellac_tpu/inference/cache/layout.py` (`KVCache`, `init_cache`,
`update_layer`, `scatter_slot`, `slot_view` :280, `PagedKVCache` :309,
`init_paged_cache` :341, `paged_update_layer` :359, `paged_gather_layer`
:392) and its int8 storage (`QuantKVCache` :77, `init_quant_cache` :101,
`kv_field_names` :123, `init_cache_for` :131, `quantize_kv` :180,
`quant_update_layer` :198, `QuantPagedKVCache` :417,
`init_quant_paged_cache` :449, `quant_paged_update_layer` :479,
`paged_gather_scales` :505).

MLA (DeepSeek) models cache their latent instead (layout.py :44, :101,
:341, :449): one row a token, `cfg.cache_head_dim` = kv_lora_rank +
qk_rope_head_dim wide, under `cfg.cache_kv_heads` = 1 head, and a
zero-width v (`cfg.cache_v_head_dim` = 0) whose int8 scales are unit; the
model reads the k array as both k and v, and in int8 its one scale a row
serves both roles. Every shape below is sized by those three fields.

Dense layout: stacked over layers and HEAD-MAJOR, (L, B, Hkv, max_len, Dh), as
in the JAX package: each (slot, kv head) reads one contiguous
(positions, head_dim) stream, which is what the decode kernel walks. The
cache lives in the compute dtype, or in int8 with one fp32 dequant scale
per written (token, kv head): symmetric, scale = amax / 127 over the head
dim, K quantized after RoPE.

Ragged batches carry per-sequence `lengths`: prompts are right-padded
and written from offset 0 (prefill writes all S padded positions), and
`lengths = index + new_tokens_len` records how many are real. Decode
writes each sequence's next token at its own length, overwriting stale
pad slots.

Unlike the JAX package, the port writes the caches IN PLACE:
`update_layer`, `paged_update_layer` and `scatter_slot` store into the
given tensors, and `forward_with_cache` returns a cache that shares its
k/v (and ks/vs) storage with the one it was given.

Indices: JAX's gathers clamp an out-of-range index; torch's raise on the
CPU and fault on the card. The callers keep every table index in range
(a prefill pad is capped at max_len, and max_blocks = ceil(max_len /
block_size)), so nothing here clamps.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

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
    """An all-zero dense cache in the compute dtype (an MLA model's holds
    its latent rows: see the module's note)."""
    head = (cfg.n_layers, batch, cfg.cache_kv_heads, max_len)
    return KVCache(
        k=torch.zeros((*head, cfg.cache_head_dim), dtype=cfg.compute_dtype,
                      device=device),
        v=torch.zeros((*head, cfg.cache_v_head_dim), dtype=cfg.compute_dtype,
                      device=device),
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
    _write_rows((cache_k, cache_v), (k_new, v_new), index)
    return cache_k, cache_v


def _write_positions(index: torch.Tensor, s: int) -> torch.Tensor:
    """(B, S) int64 positions index[b] + i."""
    return index.to(torch.int64)[:, None] + torch.arange(
        s, device=index.device
    )[None, :]


def _write_rows(targets, news, index):
    """Write each new (B, S, Hkv[, Dh]) into its target (B, Hkv, len[,
    Dh]) at per-sequence offsets, in place, with one set of indices."""
    b, s = news[0].shape[:2]
    pos = _write_positions(index, s)
    rows = torch.arange(b, device=index.device)[:, None]  # (B, 1)
    # Advanced indices split by a slice put their (B, S) dims first, so
    # the target view is (B, S, Hkv[, Dh]) — the layout of the new rows.
    for target, new in zip(targets, news):
        target[rows, :, pos] = new.to(target.dtype)


def scatter_slot(cache: KVCache, mini: KVCache, slot) -> KVCache:
    """Write a batch-1 mini cache into `slot` of a dense slot cache (a
    KVCache or a QuantKVCache, values and scales), in place. A mini
    shorter than the cache fills the first positions of the
    slot's rows (JAX's dynamic_update_slice); its length becomes the
    slot's. `slot` is an int or a (1,) int64 tensor on the cache's
    device: a captured program takes the tensor, so that it does not
    bake in one slot."""
    if not isinstance(slot, torch.Tensor):
        slot = torch.full((1,), int(slot), dtype=torch.int64,
                          device=cache.k.device)
    n = mini.k.shape[3]
    for name in kv_field_names(cache_quant(cache)):
        getattr(cache, name)[:, :, :, :n].index_copy_(
            1, slot, getattr(mini, name))
    cache.lengths.index_copy_(0, slot, mini.lengths.to(torch.int32))
    return cache


def slot_view(cache, slot: int, lengths: torch.Tensor):
    """Batch-1 view of one slot's rows of a dense cache (values and
    scales), sharing their storage, so a forward through it writes the
    slot in place; `lengths` (1,) replaces the stored per-slot lengths
    (a chunked prefill's continuation resumes from an explicit offset).
    The view's host `max_length` is left for the caller to set."""
    fields = {n: getattr(cache, n)[:, slot:slot + 1]
              for n in kv_field_names(cache_quant(cache))}
    return cache.replace(**fields, lengths=lengths.to(torch.int32))


# ---------------------------------------------------------------------------
# Int8 cache (half the resident bytes and half the decode stream of bf16)
# ---------------------------------------------------------------------------


@dataclass
class QuantKVCache:
    """A dense cache stored int8 with one fp32 scale per written (token,
    kv head): the KVCache layout and write-at-own-length contract. A
    value dequantizes as k * ks[..., None]."""

    k: torch.Tensor  # (L, B, Hkv, max_len, Dh) int8
    v: torch.Tensor  # (L, B, Hkv, max_len, Dh) int8
    ks: torch.Tensor  # (L, B, Hkv, max_len) fp32
    vs: torch.Tensor  # (L, B, Hkv, max_len) fp32
    lengths: torch.Tensor  # (B,) int32
    max_length: int = 0  # as KVCache.max_length

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    def replace(self, **kw) -> "QuantKVCache":
        return replace(self, **kw)


def init_quant_cache(cfg: ModelConfig, batch: int, max_len: int,
                     device: torch.device) -> QuantKVCache:
    """An all-zero int8 cache with all-zero scales."""
    head = (cfg.n_layers, batch, cfg.cache_kv_heads, max_len)
    return QuantKVCache(
        k=torch.zeros((*head, cfg.cache_head_dim), dtype=torch.int8,
                      device=device),
        v=torch.zeros((*head, cfg.cache_v_head_dim), dtype=torch.int8,
                      device=device),
        ks=torch.zeros(head, dtype=torch.float32, device=device),
        vs=torch.zeros(head, dtype=torch.float32, device=device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def kv_field_names(kv_quant: Optional[str] = None):
    """The value and scale fields of a cache kind, shared by the dense
    and paged caches: what a prefill scatter has to carry."""
    return ("k", "v", "ks", "vs") if kv_quant == "int8" else ("k", "v")


def cache_quant(cache) -> Optional[str]:
    """"int8" for an int8 cache (dense or paged), else None."""
    return ("int8" if isinstance(cache, (QuantKVCache, QuantPagedKVCache))
            else None)


def init_cache_for(cfg: ModelConfig, batch: int, max_len: int,
                   device: torch.device, kv_quant: Optional[str] = None,
                   rolling: bool = False):
    """The engines' dense cache constructor: compute dtype or int8."""
    if rolling:
        raise NotImplementedError("rolling caches are not ported yet")
    if kv_quant == "int8":
        return init_quant_cache(cfg, batch, max_len, device)
    if kv_quant is not None:
        raise ValueError(f"kv_quant={kv_quant!r}; have None, 'int8'")
    return init_cache(cfg, batch, max_len, device)


def quantize_kv(x: torch.Tensor):
    """(B, S, Hkv, Dh) -> int8 values and (B, S, Hkv) fp32 scales.

    Symmetric: scale = amax / 127 over the head dim (1 where amax is 0),
    values round(x / scale) half to even, clipped to +-127, as the JAX
    package computes them. A zero-width input gives unit scales.
    """
    if x.shape[-1] == 0:
        return (torch.zeros(x.shape, dtype=torch.int8, device=x.device),
                torch.ones(x.shape[:-1], dtype=torch.float32,
                           device=x.device))
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def quant_update_layer(
    cache_k, cache_v, cache_ks, cache_vs,  # one layer's (B, Hkv, len[, Dh])
    k_new, v_new,  # (B, S, Hkv, Dh) unquantized
    index,  # (B,) int — per-sequence write offsets
):
    """Quantize S new positions and write values and scales at
    per-sequence offsets, in place. Returns the (same) four tensors."""
    kq, ks = quantize_kv(k_new)
    vq, vs = quantize_kv(v_new)
    _write_rows((cache_k, cache_v, cache_ks, cache_vs), (kq, vq, ks, vs),
                index)
    return cache_k, cache_v, cache_ks, cache_vs


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
    head = (cfg.n_layers, n_blocks, cfg.cache_kv_heads, block_size)
    return PagedKVCache(
        k=torch.zeros((*head, cfg.cache_head_dim), dtype=cfg.compute_dtype,
                      device=device),
        v=torch.zeros((*head, cfg.cache_v_head_dim), dtype=cfg.compute_dtype,
                      device=device),
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
    _scatter_pages((pool_k, pool_v), (k_new, v_new), index, tables)
    return pool_k, pool_v


def _scatter_pages(targets, news, index, tables):
    """Scatter each new (B, S, Hkv[, Dh]) into its pool (n_blocks, Hkv,
    bs[, Dh]) through the block tables, in place, with one set of
    indices."""
    bs = targets[0].shape[2]
    b, s = news[0].shape[:2]
    pos = _write_positions(index, s)
    blocks = torch.gather(tables.to(torch.int64), 1, pos // bs).reshape(-1)
    offs = (pos % bs).reshape(-1)
    # Advanced indices at dims 0 and 2 (split by the head slice) put the
    # token rows first: the target is (B*S, Hkv[, Dh]), as the new rows.
    for target, new in zip(targets, news):
        target[blocks, :, offs] = new.to(target.dtype).reshape(
            b * s, *new.shape[2:])


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


# ---------------------------------------------------------------------------
# Int8 paged cache
# ---------------------------------------------------------------------------


@dataclass
class QuantPagedKVCache:
    """A block pool stored int8 with per-(token, kv head) fp32 scale
    pools that mirror the value pools block for block: the PagedKVCache
    tables, scratch block 0 and allocator contract, the QuantKVCache
    quantization contract.

    k, v: (L, n_blocks, Hkv, block_size, Dh) int8
    ks, vs: (L, n_blocks, Hkv, block_size) fp32
    """

    k: torch.Tensor
    v: torch.Tensor
    ks: torch.Tensor
    vs: torch.Tensor
    tables: torch.Tensor
    lengths: torch.Tensor
    max_length: int = 0  # as KVCache.max_length

    block_size = PagedKVCache.block_size
    max_blocks = PagedKVCache.max_blocks
    max_len = PagedKVCache.max_len

    def replace(self, **kw) -> "QuantPagedKVCache":
        return replace(self, **kw)


def init_quant_paged_cache(cfg: ModelConfig, n_slots: int, n_blocks: int,
                           block_size: int, max_blocks_per_slot: int,
                           device: torch.device) -> QuantPagedKVCache:
    """An all-zero int8 pool. The scale pools are zeroed too (never left
    uninitialized), so an idle slot's read of scratch block 0 multiplies
    by 0, not by whatever the memory held."""
    head = (cfg.n_layers, n_blocks, cfg.cache_kv_heads, block_size)
    return QuantPagedKVCache(
        k=torch.zeros((*head, cfg.cache_head_dim), dtype=torch.int8,
                      device=device),
        v=torch.zeros((*head, cfg.cache_v_head_dim), dtype=torch.int8,
                      device=device),
        ks=torch.zeros(head, dtype=torch.float32, device=device),
        vs=torch.zeros(head, dtype=torch.float32, device=device),
        tables=torch.zeros((n_slots, max_blocks_per_slot), dtype=torch.int32,
                           device=device),
        lengths=torch.zeros((n_slots,), dtype=torch.int32, device=device),
    )


def quant_paged_update_layer(
    pool_k, pool_v, pool_ks, pool_vs,  # one layer's int8 pools + scales
    k_new, v_new,  # (B, S, Hkv, Dh) unquantized
    index,  # (B,) int — per-slot write offsets
    tables,  # (B, max_blocks) int32
):
    """Quantize S new positions and scatter values and scales through
    the block tables (the bf16 pool's position -> block arithmetic), in
    place. Returns the (same) four tensors."""
    kq, ks = quantize_kv(k_new)
    vq, vs = quantize_kv(v_new)
    _scatter_pages((pool_k, pool_v, pool_ks, pool_vs), (kq, vq, ks, vs),
                   index, tables)
    return pool_k, pool_v, pool_ks, pool_vs


def paged_gather_scales(
    pool_s: torch.Tensor,  # (n_blocks, Hkv, bs)
    tables: torch.Tensor,  # (B, max_blocks)
):
    """Each slot's logical scale view, (B, Hkv, max_blocks * bs): the
    dense QuantKVCache scale layout, which the plain decode reads."""
    b, mb = tables.shape
    hkv, bs = pool_s.shape[1:]
    x = pool_s[tables.reshape(-1).to(torch.int64)]  # (B*mb, Hkv, bs)
    x = x.reshape(b, mb, hkv, bs).transpose(1, 2)
    return x.reshape(b, hkv, mb * bs)
