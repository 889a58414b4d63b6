from shellac_tpu_torch.inference.cache.layout import (
    KVCache,
    init_cache,
    update_layer,
)

__all__ = ["KVCache", "init_cache", "update_layer"]
