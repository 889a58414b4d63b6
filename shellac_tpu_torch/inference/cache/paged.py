"""Paged block-pool backend: slots borrow fixed-size blocks and return
them on completion, so resident KV tracks the tokens alive rather than
n_slots x max_len.

Ports `shellac_tpu/inference/cache/paged.py` (`PagedBackend` :45 and
the int8 pool `QuantPagedBackend` :474): the free list in constructor
order, `ensure_blocks` :163, `prepare_slot` :234 (the full footprint is
reserved at admission), `release_slot` :291, `pre_window` :310 (lengths
projected past the windows in flight), `reset`, `utilization` :456 and
`residency` :462. All allocator state is host-side; the device sees
only the block tables, which are written in place, in stream order: a
new table segment goes through pinned memory (`copy_from_host`), so the
write never waits for a window in flight. Block 0 is scratch: free
table entries point at it, so an idle slot (length 0, table row all 0)
attends one position of block 0.

prefix_cache=True adds the reference's automatic prefix cache: full
prompt blocks are hashed as a chain (`inference/prefix.py`), kept pooled
after release with a refcount, and evicted least recently used only when
the free list runs dry (`alloc_block` :136); a new prompt attaches the
longest cached chain read-only (`_match_prefix` :191, `attach_prefix`
:205), and its prefill computes only the suffix past `prefill_offset`.
A slot writes only positions past its matched prefix, which lie in its
own blocks. The KV fabric's manifest, chain export and seeding (:363-452)
are not ported, nor its per-hash sidecar state (parents, depths, touch
times, hit counters), which is all `_prune_hash` (:151) prunes.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from shellac_tpu_torch.config import ModelConfig
from shellac_tpu_torch.inference import prefix as prefix_mod
from shellac_tpu_torch.inference.cache.base import CacheBackend, PoolExhausted
from shellac_tpu_torch.inference.cache.layout import (
    init_paged_cache,
    init_quant_paged_cache,
)
from shellac_tpu_torch.ops.dispatch import copy_from_host


class PagedBackend(CacheBackend):
    name = "paged"
    is_paged = True

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int, *,
                 kv_quant: Optional[str] = None, block_size: int = 16,
                 pool_tokens: Optional[int] = None,
                 prefix_cache: bool = False):
        super().__init__(cfg, n_slots, max_len, kv_quant=kv_quant)
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if kv_quant == "int8":
            # Kept for parity with the JAX engines, whose int8 TPU kernel
            # needs 32-aligned pages; the CUDA kernel takes any block size.
            if block_size % 32:
                raise ValueError(
                    f"kv_quant='int8' paged pools need block_size % 32 "
                    f"== 0 (got {block_size}); use 32 or 64"
                )
            self.name = "paged-int8"
        self.block_size = block_size
        self.prefix_cache = bool(prefix_cache)
        self.max_blocks_per_slot = -(-max_len // block_size)
        if pool_tokens is None:
            pool_tokens = n_slots * max_len // 2
        self.n_blocks = max(
            -(-pool_tokens // block_size), self.max_blocks_per_slot
        ) + 1
        self.peak_blocks_used = 0
        self.reset()

    def init_cache(self, device: torch.device):
        init_pool = (init_quant_paged_cache if self.kv_quant == "int8"
                     else init_paged_cache)
        return init_pool(self.cfg, self.n_slots, self.n_blocks,
                         self.block_size, self.max_blocks_per_slot, device)

    # ---- allocator ---------------------------------------------------

    def initial_stats(self) -> Dict[str, int]:
        if not self.prefix_cache:
            return {}
        return {
            "prefix_hit_tokens": 0,
            "prefix_query_tokens": 0,
            "prefix_evictions": 0,
            "prefix_seeded_blocks": 0,
        }

    def blocks_used(self) -> int:
        return self.n_blocks - 1 - len(self._free)

    def evictable(self) -> int:
        return sum(1 for r in self._block_ref.values() if r == 0)

    def alloc_block(self) -> int:
        """Pop a free block, or evict the least recently used cached
        block that no slot holds when the free list is dry. The caller
        checks capacity first."""
        if self._free:
            return self._free.pop()
        for h, blk in self._hash_to_block.items():  # front = LRU
            if self._block_ref[blk] == 0:
                del self._hash_to_block[h]
                del self._block_ref[blk]
                self.engine.stats["prefix_evictions"] += 1
                return blk
        raise RuntimeError("alloc_block called with no capacity")

    def ensure_blocks(self, slot: int, total_tokens: int) -> bool:
        """Grow the slot's table to cover total_tokens; False if the pool
        (free and evictable blocks) is short. Blocks the slot attached
        from the prefix cache count as held: only new blocks are its
        own to write."""
        need = -(-total_tokens // self.block_size)
        have = len(self._slot_blocks[slot])
        if need <= have:
            return True
        if need - have > len(self._free) + self.evictable():
            return False
        new_ids = [self.alloc_block() for _ in range(need - have)]
        self._slot_blocks[slot].extend(new_ids)
        copy_from_host(self.engine._cache.tables[slot, have:need], new_ids)
        self.peak_blocks_used = max(self.peak_blocks_used, self.blocks_used())
        return True

    # ---- prefix cache ------------------------------------------------

    def chain_hashes(self, tokens: np.ndarray) -> List[bytes]:
        return prefix_mod.chain_hashes(tokens, self.block_size)

    def _match_prefix(self, tokens: np.ndarray) -> Tuple[List[bytes], int]:
        """The longest cached chain covering a strict prompt prefix: at
        least one prompt token is left to compute (its logits give the
        first output token)."""
        hashes = self.chain_hashes(tokens)
        cap = (tokens.size - 1) // self.block_size
        m = 0
        for h in hashes[:cap]:
            if h not in self._hash_to_block:
                break
            m += 1
        return hashes, m

    def attach_prefix(self, tokens: np.ndarray):
        """Match and attach the longest cached chain read-only: bump its
        refcounts and touch its LRU order. Returns (hashes, matched block
        ids); a failed admission rolls back with `detach_prefix`."""
        hashes, m = self._match_prefix(tokens)
        matched = [self._hash_to_block[h] for h in hashes[:m]]
        for h, blk in zip(hashes[:m], matched):
            self._block_ref[blk] += 1
            self._hash_to_block.move_to_end(h)  # LRU touch
        return hashes, matched

    def detach_prefix(self, matched) -> None:
        for blk in matched:
            self._block_ref[blk] -= 1

    # ---- slot lifecycle ---------------------------------------------

    def prepare_slot(self, slot: int, req, footprint: int) -> None:
        # The full footprint (prompt + budget + slack) is reserved now:
        # growth mid-decode could exhaust the pool with no victim to
        # evict.
        if not self.prefix_cache:
            if not self.ensure_blocks(slot, footprint):
                raise PoolExhausted()
            return
        eng = self.engine
        hashes, matched = self.attach_prefix(req.tokens)
        m = len(matched)
        if matched:
            self._slot_blocks[slot] = list(matched)
            copy_from_host(eng._cache.tables[slot, :m], matched)
        if not self.ensure_blocks(slot, footprint):
            # Roll the attach back (the blocks stay cached); requeue.
            self.detach_prefix(matched)
            self._slot_blocks[slot] = []
            eng._cache.tables[slot].fill_(0)
            raise PoolExhausted()
        # The slot's own full prompt blocks become matchable only once
        # its prefill has written them (several steps away when
        # chunked): registered by on_prefill_complete.
        self._pending_reg[slot] = [
            (j, hashes[j])
            for j in range(m, req.tokens.size // self.block_size)
        ]
        self._slot_prefix_len[slot] = m * self.block_size
        eng.stats["prefix_hit_tokens"] += m * self.block_size
        eng.stats["prefix_query_tokens"] += req.tokens.size

    def on_prefill_complete(self, slot: int) -> None:
        # The prompt blocks now hold real KV: make them matchable.
        for j, h in self._pending_reg.pop(slot, ()):
            if h in self._hash_to_block:
                continue  # the same chain, cached by an earlier finisher
            blk = self._slot_blocks[slot][j]
            self._hash_to_block[h] = blk
            self._block_ref[blk] = 1

    def release_slot(self, slot: int) -> None:
        self._pending_reg.pop(slot, None)
        if self.prefix_cache:
            for blk in self._slot_blocks[slot]:
                if blk in self._block_ref:
                    # Stays cached, evictable at refcount 0.
                    self._block_ref[blk] -= 1
                else:
                    self._free.append(blk)
        else:
            self._free.extend(reversed(self._slot_blocks[slot]))
        self._slot_blocks[slot] = []
        self._slot_prefix_len[slot] = 0
        self.engine._cache.tables[slot].fill_(0)

    def pre_window(self, active_rows, advance, span: int) -> None:
        # Backstop only: admission reserved the footprint. Lengths are
        # host-known (prompt + generated, projected past any un-synced
        # window in flight by `advance`), so the hot loop never reads
        # the device; writes past a request's footprint land in block 0.
        eng = self.engine
        for i, active in enumerate(active_rows):
            if not active:
                continue
            req = eng._slots[i]
            length = (req.tokens.size + len(req.out)
                      + (advance.get(i, 0) if advance else 0))
            need = min(length + span, eng._slot_footprint(req))
            if not self.ensure_blocks(i, need):
                raise RuntimeError(
                    "paged KV pool exhausted mid-decode; size pool_tokens "
                    "for n_slots concurrent worst-case lengths"
                )

    def prefill_offset(self, slot: int) -> int:
        return self._slot_prefix_len[slot] if self.prefix_cache else 0

    def reset(self) -> None:
        """The free list in constructor order, every slot empty, the
        prefix registry purged."""
        self._free: List[int] = list(range(self.n_blocks - 1, 0, -1))
        self._slot_blocks: List[List[int]] = [
            [] for _ in range(self.n_slots)
        ]
        # Prefix cache state (empty when disabled): hash -> block id,
        # in LRU order (front = least recently used); the refcount of
        # each cached block (slots holding it; 0 = evictable); each
        # slot's matched prefix length; and each slot's prompt blocks
        # waiting for its prefill to settle: slot -> [(index, hash)].
        self._hash_to_block: "OrderedDict[bytes, int]" = OrderedDict()
        self._block_ref: Dict[int, int] = {}
        self._slot_prefix_len: List[int] = [0] * self.n_slots
        self._pending_reg: Dict[int, List[Tuple[int, bytes]]] = {}

    # ---- accounting --------------------------------------------------

    def utilization(self) -> float:
        # Pool blocks out of the free list / pool size (block 0 is
        # scratch).
        pool = self.n_blocks - 1
        return (pool - len(self._free)) / pool

    def residency(self) -> Dict[str, Any]:
        return {
            "backend": self.name,
            "slot_tokens": self._slot_tokens(),
            "slot_blocks": [len(b) for b in self._slot_blocks],
            "block_size": self.block_size,
            "blocks_total": self.n_blocks - 1,  # minus scratch
            "blocks_free": len(self._free),
            "prefix_cached_blocks": len(self._hash_to_block),
        }


class QuantPagedBackend(PagedBackend):
    """The int8 paged pool (`paged-int8`): PagedBackend's allocator over
    int8 value pools and fp32 scale pools that mirror them block for
    block, so the free list and tables are unchanged. Its default block
    size of 64 and the block_size % 32 refusal are the JAX engines'
    (their TPU kernel's tiling); the CUDA kernel itself takes any block
    size."""

    name = "paged-int8"

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int, *,
                 kv_quant: Optional[str] = "int8", block_size: int = 64,
                 pool_tokens: Optional[int] = None,
                 prefix_cache: bool = False):
        if kv_quant != "int8":
            raise ValueError(
                f"QuantPagedBackend is the int8 pool; kv_quant="
                f"{kv_quant!r} wants PagedBackend"
            )
        super().__init__(cfg, n_slots, max_len, kv_quant="int8",
                         block_size=block_size, pool_tokens=pool_tokens,
                         prefix_cache=prefix_cache)
