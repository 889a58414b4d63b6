"""CacheBackend: the storage policy a serving engine holds.

Ports `shellac_tpu/inference/cache/base.py` (`PoolExhausted` :38,
`CacheBackend` :44). The engine holds the decode algorithm (slot
scheduling, the decode window, sampling); a backend holds the storage:
it builds the device cache and the batch-1 prefill scratch, and owns the
host-side slot residency (the paged block allocator lives entirely in
`paged.py`). The engine keeps `engine._cache`; a backend writes into it
for table surgery rather than holding a copy.

A backend's `kv_quant` (None or "int8") picks the storage: the compute
dtype, or int8 values with per-(token, kv head) fp32 scales;
`bytes_per_token` (:152) prices either.

The accounting the observability layer reads, `utilization` (:141)
and `residency` (:146), comes from host state only.

The slot lifecycle hooks are the reference's: `prepare_slot`,
`on_prefill_complete` (:104, at a prefill's settle), `release_slot`,
`pre_window` (:111, with `advance`, the tokens un-synced windows will
still append), `prefill_offset` (:117), `reset` and `initial_stats`
(:127, the counters a backend adds to the engine's stats).

Not ported yet: sharding axes (meshes), `prefix_manifest` and the
rolling storage.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from shellac_tpu_torch.config import ModelConfig
from shellac_tpu_torch.inference.cache.layout import init_cache_for


class PoolExhausted(Exception):
    """Raised by `prepare_slot` when the backend cannot admit the request
    now (paged: too few free blocks). The engine requeues it and retries
    after a release."""


class CacheBackend:
    """Base storage policy: one slot row per request, nothing to
    allocate. Subclasses override the hooks their policy needs."""

    name: str = "dense"
    is_paged: bool = False

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int, *,
                 kv_quant: Optional[str] = None):
        if kv_quant not in (None, "int8"):
            raise ValueError(f"kv_quant={kv_quant!r}; have None, 'int8'")
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.kv_quant = kv_quant
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
        into this backend's cache: a dense mini cache of `length`, of the
        backend's storage kind."""
        return init_cache_for(self.cfg, 1, length, device, self.kv_quant)

    def bytes_per_token(self) -> int:
        """Resident KV bytes one token costs under this storage (per
        slot; paged block rounding ignored): int8 values plus one fp32
        scale per kv head for k and v, or both in the compute dtype."""
        cfg = self.cfg
        width = cfg.cache_head_dim + cfg.cache_v_head_dim
        if self.kv_quant == "int8":
            return cfg.n_layers * cfg.cache_kv_heads * (width + 2 * 4)
        itemsize = torch.empty((), dtype=cfg.compute_dtype).element_size()
        return cfg.n_layers * cfg.cache_kv_heads * width * itemsize

    # ---- slot lifecycle (host-side policy) --------------------------

    def prepare_slot(self, slot: int, req, footprint: int) -> None:
        """Reserve residency for `req` (worst case `footprint` tokens)
        before its prefill. May raise PoolExhausted."""

    def on_prefill_complete(self, slot: int) -> None:
        """The slot's prompt KV is now real (its prefill settled); the
        prefix cache would register the prompt blocks here."""

    def release_slot(self, slot: int) -> None:
        """The request left `slot` (finish, cancel or abort)."""

    def pre_window(self, active_rows, advance: Optional[Dict[int, int]],
                   span: int) -> None:
        """About to run one decode window writing up to `span` tokens
        per active slot; `advance` maps slot -> tokens an un-synced
        window in flight will still append (overlapped dispatch)."""

    def prefill_offset(self, slot: int) -> int:
        """Tokens already resident when the slot's prefill starts (the
        prefix cache's matched length; 0 without one)."""
        return 0

    def reset(self) -> None:
        """abort_all: restore the allocator to its pristine state."""

    def initial_stats(self) -> Dict[str, int]:
        """Counters this backend adds to the engine's stats at
        construction (the paged prefix cache adds its hit counters)."""
        return {}

    # ---- accounting --------------------------------------------------

    def utilization(self) -> float:
        """Live residency / capacity, in [0, 1] (the kv_utilization
        gauge)."""
        raise NotImplementedError

    def residency(self) -> Dict[str, Any]:
        """JSON-serializable per-slot residency (GET /debug/requests):
        the storage view; the server adds request identity."""
        raise NotImplementedError

    def _slot_tokens(self) -> List[int]:
        """Host-known live tokens per slot (prompt + generated)."""
        return [(r.tokens.size + len(r.out)) if r is not None else 0
                for r in self.engine._slots]
