"""The KV-cache subsystem: storage layouts and pluggable backends.

Ports `shellac_tpu/inference/cache/__init__.py`: the ONE name -> backend
registry (`BACKENDS`, `backend_flags`, `resolve_backend_name`,
`make_backend`, `engine_class`, :37-139) that engines and tests resolve
through: dense and paged, each in the compute dtype or int8. The rolling
storages are registered by name and raise NotImplementedError until
they are ported.
"""

from __future__ import annotations

from typing import Optional

from shellac_tpu_torch.inference.cache.base import CacheBackend, PoolExhausted
from shellac_tpu_torch.inference.cache.dense import DenseBackend
from shellac_tpu_torch.inference.cache.layout import (
    KVCache,
    PagedKVCache,
    QuantKVCache,
    QuantPagedKVCache,
    init_cache,
    init_cache_for,
    init_paged_cache,
    init_quant_cache,
    init_quant_paged_cache,
    kv_field_names,
    paged_gather_layer,
    paged_gather_scales,
    paged_update_layer,
    quant_paged_update_layer,
    quant_update_layer,
    quantize_kv,
    scatter_slot,
    slot_view,
    update_layer,
)
from shellac_tpu_torch.inference.cache.paged import (
    PagedBackend,
    QuantPagedBackend,
)

__all__ = [
    "BACKENDS",
    "CacheBackend",
    "DenseBackend",
    "KVCache",
    "PagedBackend",
    "PagedKVCache",
    "PoolExhausted",
    "QuantKVCache",
    "QuantPagedBackend",
    "QuantPagedKVCache",
    "backend_flags",
    "engine_class",
    "init_cache",
    "init_cache_for",
    "init_paged_cache",
    "init_quant_cache",
    "init_quant_paged_cache",
    "kv_field_names",
    "make_backend",
    "paged_gather_layer",
    "paged_gather_scales",
    "paged_update_layer",
    "quant_paged_update_layer",
    "quant_update_layer",
    "quantize_kv",
    "resolve_backend_name",
    "scatter_slot",
    "slot_view",
    "update_layer",
]

# name -> (backend class, pinned constructor kwargs); None marks a
# storage that is not ported yet. The int8 names pin kv_quant, so one
# name fully determines the storage.
BACKENDS = {
    "dense": (DenseBackend, {}),
    "dense-int8": (DenseBackend, {"kv_quant": "int8"}),
    "paged": (PagedBackend, {}),
    "paged-int8": (QuantPagedBackend, {}),
    "rolling": None,
    "rolling-int8": None,
}

# (is_paged, kv_quant, rolling_window): what the legacy engine flags
# would have been for each name.
_FLAGS = {
    "dense": (False, None, False),
    "dense-int8": (False, "int8", False),
    "paged": (True, None, False),
    "paged-int8": (True, "int8", False),
    "rolling": (False, None, True),
    "rolling-int8": (False, "int8", True),
}


def backend_flags(name: str):
    """(is_paged, kv_quant, rolling_window) for a registry name."""
    if name not in _FLAGS:
        raise ValueError(
            f"unknown cache backend {name!r}; have {sorted(BACKENDS)}"
        )
    return _FLAGS[name]


def resolve_backend_name(
    explicit: Optional[str] = None, *,
    paged: bool = False,
    kv_quant: Optional[str] = None,
    rolling_window: bool = False,
) -> str:
    """Canonical backend name from an explicit choice and/or the legacy
    flags. Combined with an explicit name the flags must agree."""
    if kv_quant not in (None, "int8"):
        raise ValueError(f"kv_quant={kv_quant!r}; have None, 'int8'")
    if paged and rolling_window:
        raise ValueError(
            "rolling_window is a slot-cache feature; the paged pool "
            "sizes memory via its block pool instead"
        )
    kind = "paged" if paged else ("rolling" if rolling_window else "dense")
    legacy = kind + ("-int8" if kv_quant == "int8" else "")
    if explicit is None:
        return legacy
    if explicit not in BACKENDS:
        raise ValueError(
            f"unknown cache backend {explicit!r}; have {sorted(BACKENDS)}"
        )
    exp_paged, exp_quant, exp_rolling = _FLAGS[explicit]
    if ((paged and not exp_paged)
            or (rolling_window and not exp_rolling)
            or (kv_quant is not None and kv_quant != exp_quant)):
        raise ValueError(
            f"cache backend {explicit!r} conflicts with legacy flags "
            f"(paged={paged}, kv_quant={kv_quant!r}, "
            f"rolling_window={rolling_window})"
        )
    return explicit


def make_backend(name: str, cfg, n_slots: int, max_len: int,
                 **opts) -> CacheBackend:
    """Instantiate a registered backend; knobs it does not take are
    rejected by its constructor."""
    if name not in BACKENDS:
        raise ValueError(
            f"unknown cache backend {name!r}; have {sorted(BACKENDS)}"
        )
    entry = BACKENDS[name]
    if entry is None:
        raise NotImplementedError(
            f"the {name!r} cache backend is not ported yet"
        )
    cls, pinned = entry
    return cls(cfg, n_slots, max_len, **pinned, **opts)


def engine_class(name: str, speculative: bool = False):
    """The engine class serving a backend name (imported lazily: the
    engines import this package)."""
    paged, _, _ = backend_flags(name)
    if speculative:
        raise NotImplementedError("speculative engines are not ported yet")
    from shellac_tpu_torch.inference.batching import (
        BatchingEngine,
        PagedBatchingEngine,
    )

    return PagedBatchingEngine if paged else BatchingEngine
