"""Dense slot backend: one (max_len) cache row per slot.

Ports `shellac_tpu/inference/cache/dense.py` (`DenseBackend` :22) for
the compute-dtype cache; the int8 rows wait for the int8 kernel.
"""

from __future__ import annotations

import torch

from shellac_tpu_torch.inference.cache.base import CacheBackend
from shellac_tpu_torch.inference.cache.layout import init_cache


class DenseBackend(CacheBackend):
    name = "dense"

    def init_cache(self, device: torch.device):
        return init_cache(self.cfg, self.n_slots, self.max_len, device)
