"""Paged block-pool backend: slots borrow fixed-size blocks and return
them on completion, so resident KV tracks the tokens alive rather than
n_slots x max_len.

Ports `shellac_tpu/inference/cache/paged.py` (`PagedBackend` :45 and
the int8 pool `QuantPagedBackend` :474) without the prefix cache: the
free list in constructor order, `ensure_blocks` :163, `prepare_slot`
:234 (the full footprint is reserved at admission), `release_slot`
:291, `pre_window` :310 (lengths projected past the windows in flight),
`reset`, `utilization` :456 and `residency` :462. All allocator state is
host-side; the device sees only the block tables, which are written in
place, in stream order: a new table segment goes through pinned memory
(`copy_from_host`), so the write never waits for a window in flight.
Block 0 is scratch: free table entries point at it, so an idle slot
(length 0, table row all 0) attends one position of block 0.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from shellac_tpu_torch.config import ModelConfig
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
        if prefix_cache:
            raise NotImplementedError("the prefix cache is not ported yet")
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
        self.prefix_cache = False
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

    def blocks_used(self) -> int:
        return self.n_blocks - 1 - len(self._free)

    def ensure_blocks(self, slot: int, total_tokens: int) -> bool:
        """Grow the slot's table to cover total_tokens; False if the pool
        is short."""
        need = -(-total_tokens // self.block_size)
        have = len(self._slot_blocks[slot])
        if need <= have:
            return True
        if need - have > len(self._free):
            return False
        new_ids = [self._free.pop() for _ in range(need - have)]
        self._slot_blocks[slot].extend(new_ids)
        copy_from_host(self.engine._cache.tables[slot, have:need], new_ids)
        self.peak_blocks_used = max(self.peak_blocks_used, self.blocks_used())
        return True

    # ---- slot lifecycle ---------------------------------------------

    def prepare_slot(self, slot: int, req, footprint: int) -> None:
        # The full footprint (prompt + budget + slack) is reserved now:
        # growth mid-decode could exhaust the pool with no victim to
        # evict.
        if not self.ensure_blocks(slot, footprint):
            raise PoolExhausted()

    def release_slot(self, slot: int) -> None:
        self._free.extend(reversed(self._slot_blocks[slot]))
        self._slot_blocks[slot] = []
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

    def reset(self) -> None:
        """The free list in constructor order, every slot empty."""
        self._free: List[int] = list(range(self.n_blocks - 1, 0, -1))
        self._slot_blocks: List[List[int]] = [
            [] for _ in range(self.n_slots)
        ]

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
            "prefix_cached_blocks": 0,
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
