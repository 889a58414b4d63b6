from shellac_tpu_torch.models import transformer
from shellac_tpu_torch.models.registry import PRESETS, get_model_config

__all__ = ["transformer", "PRESETS", "get_model_config"]
