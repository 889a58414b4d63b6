"""Dense slot backend: one (max_len) cache row per slot, in the compute
dtype or int8.

Ports `shellac_tpu/inference/cache/dense.py` (`DenseBackend` :22): every
slot reserves its full row, so there is nothing to allocate or free.
kv_quant="int8" (the `dense-int8` registry name) swaps the row storage
for int8 values with per-token fp32 scales, with no policy change.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from shellac_tpu_torch.config import ModelConfig
from shellac_tpu_torch.inference.cache.base import CacheBackend
from shellac_tpu_torch.inference.cache.layout import init_cache_for


class DenseBackend(CacheBackend):
    name = "dense"

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int, *,
                 kv_quant: Optional[str] = None):
        super().__init__(cfg, n_slots, max_len, kv_quant=kv_quant)
        if kv_quant == "int8":
            self.name = "dense-int8"

    def init_cache(self, device: torch.device):
        return init_cache_for(self.cfg, self.n_slots, self.max_len, device,
                              self.kv_quant)

    def utilization(self) -> float:
        return sum(self._slot_tokens()) / (self.n_slots * self.max_len)

    def residency(self) -> Dict[str, Any]:
        return {
            "backend": self.name,
            "slot_tokens": self._slot_tokens(),
            "capacity_tokens": self.n_slots * self.max_len,
        }
