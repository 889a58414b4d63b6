"""shellac_tpu_torch: the PyTorch and CUDA port of shellac_tpu.

A package beside the JAX one. It imports `torch`, never `jax`, and
nothing of `shellac_tpu`; the JAX package stays the reference the port
is held against in the tests. Its kernels are hand-written CUDA for
Hopper (`csrc/`), built from source at first use.
"""

from shellac_tpu_torch.config import ModelConfig
from shellac_tpu_torch.inference.engine import Engine, GenerationResult
from shellac_tpu_torch.models.registry import PRESETS, get_model_config

__all__ = [
    "Engine",
    "GenerationResult",
    "ModelConfig",
    "PRESETS",
    "get_model_config",
]
