"""CacheBackend: the storage policy a serving engine holds.

Ports `shellac_tpu/inference/cache/base.py` (`PoolExhausted` :38,
`CacheBackend` :44). The engine holds the decode algorithm (slot
scheduling, the decode window, sampling); a backend holds the storage:
it builds the device cache and the batch-1 prefill scratch, and owns the
host-side slot residency (the paged block allocator lives entirely in
`paged.py`). The engine keeps `engine._cache`; a backend writes into it
for table surgery rather than holding a copy.

Not ported yet: sharding axes (meshes), the prefix-cache hooks
(`on_prefill_complete`, `prefill_offset`, `prefix_manifest`), the
accounting the observability layer reads (`utilization`, `residency`,
`bytes_per_token`) and the int8 and rolling storage.
"""

from __future__ import annotations

from typing import Any

import torch

from shellac_tpu_torch.config import ModelConfig
from shellac_tpu_torch.inference.cache.layout import init_cache


class PoolExhausted(Exception):
    """Raised by `prepare_slot` when the backend cannot admit the request
    now (paged: too few free blocks). The engine requeues it and retries
    after a release."""


class CacheBackend:
    """Base storage policy: one slot row per request, nothing to
    allocate. Subclasses override the hooks their policy needs."""

    name: str = "dense"
    is_paged: bool = False

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.engine: Any = None

    def bind(self, engine) -> None:
        """Attach to the owning engine (one backend, one engine: a shared
        backend would alias allocator state)."""
        if self.engine is not None and self.engine is not engine:
            raise ValueError(
                f"{self.name} backend is already bound to an engine; "
                "construct one backend per engine"
            )
        self.engine = engine

    # ---- device cache construction ----------------------------------

    def init_cache(self, device: torch.device):
        raise NotImplementedError

    def init_mini(self, length: int, device: torch.device):
        """Batch-1 prefill scratch that the engine's prefill scatters
        into this backend's cache: a dense mini cache of `length`."""
        return init_cache(self.cfg, 1, length, device)

    # ---- slot lifecycle (host-side policy) --------------------------

    def prepare_slot(self, slot: int, req, footprint: int) -> None:
        """Reserve residency for `req` (worst case `footprint` tokens)
        before its prefill. May raise PoolExhausted."""

    def release_slot(self, slot: int) -> None:
        """The request left `slot` (finish, cancel or abort)."""

    def pre_window(self, active_rows, span: int) -> None:
        """About to run one decode window writing up to `span` tokens
        per active slot."""

    def reset(self) -> None:
        """abort_all: restore the allocator to its pristine state."""
