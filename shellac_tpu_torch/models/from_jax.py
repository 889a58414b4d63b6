"""Parameters of the JAX package, as numpy arrays, into the port's layout.

The JAX package keeps a model's layers stacked along a leading axis
({"layers": {name: (L, ...)}}), and an interleaved or first-k-dense MoE
model's in two stacks ({"layers": {"dense": ..., "moe": ...}}: per group
(G, moe_every - 1, ...) and (G, ...), or (first_k_dense, ...) and
(L - first_k_dense, ...)); the port keeps a list of per-layer
dictionaries in layer order. `params_from_jax` takes the JAX params
tree with every leaf already on the host as numpy
(`jax.tree.map(np.asarray, params)`), so this module needs no JAX, and
stores each leaf in the dtype the port's forward reads it in (see
models/transformer.py), or with `master=True` in cfg.params_dtype: the
JAX package's fp32 masters cross unrounded, so both packages train the
same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from shellac_tpu_torch.config import ModelConfig
from shellac_tpu_torch.models.transformer import (
    Params,
    check_supported,
    layer_shapes,
    moe_layers,
    to_storage,
)
from shellac_tpu_torch.ops.dispatch import DeviceLike, resolve_device


def params_from_jax(cfg: ModelConfig, tree, device: DeviceLike = None,
                    master: bool = False) -> Params:
    """Convert a JAX params tree of numpy arrays to port parameters
    (serving storage, or the master copy with `master=True`)."""
    check_supported(cfg)
    dev = resolve_device(device)
    flags = moe_layers(cfg)
    top = {"embed", "layers", "final_norm"}
    if not cfg.tie_embeddings:
        top.add("lm_head")
    if set(tree) != top:
        raise ValueError(f"params keys {sorted(tree)} != {sorted(top)}")
    stacks = tree["layers"]
    two_stacks = cfg.moe is not None and (cfg.moe_every > 1
                                          or cfg.first_k_dense > 0)
    if two_stacks and set(stacks) != {"dense", "moe"}:
        raise ValueError(
            f"layer stacks {sorted(stacks)} != ['dense', 'moe'] for this "
            "config"
        )

    def source(i):
        """Layer i's stack and its index in it."""
        if not two_stacks:
            return stacks, (i,)
        if cfg.first_k_dense > 0:
            kk = cfg.first_k_dense
            return ((stacks["dense"], (i,)) if i < kk
                    else (stacks["moe"], (i - kk,)))
        g, j = divmod(i, cfg.moe_every)
        if j == cfg.moe_every - 1:
            return stacks["moe"], (g,)
        return stacks["dense"], (g, j)

    def conv(name, arr, shape):
        a = np.asarray(arr)
        if a.shape != tuple(shape):
            raise ValueError(f"{name}: shape {a.shape} != {tuple(shape)}")
        t = torch.from_numpy(np.ascontiguousarray(a.astype(np.float32)))
        return to_storage(cfg, name, t, master).to(dev)

    layers = []
    for i, moe in enumerate(flags):
        shapes = layer_shapes(cfg, moe)
        stack, at = source(i)
        if set(stack) != set(shapes):
            raise ValueError(
                f"layer {i} keys {sorted(stack)} != {sorted(shapes)} for "
                "this config"
            )
        layers.append({name: conv(name, stack[name][at], shp)
                       for name, (shp, _) in shapes.items()})
    params: Params = {
        "embed": conv("embed", tree["embed"], (cfg.vocab_size, cfg.d_model)),
        "layers": layers,
        "final_norm": conv("final_norm", tree["final_norm"], (cfg.d_model,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = conv(
            "lm_head", tree["lm_head"], (cfg.d_model, cfg.vocab_size)
        )
    return params
