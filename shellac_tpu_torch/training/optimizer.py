"""The learning-rate schedule and the adamw chain, in functional torch.

Port of `shellac_tpu/training/optimizer.py`: `make_schedule` (:15),
`_decay_mask` (:29) and the adamw branch of `make_optimizer` (:83-136),
which chains, in optax 0.2.6's order:

    clip_by_global_norm -> scale_by_adam -> add_decayed_weights(mask)
    -> scale_by_learning_rate(schedule)

Each step of the chain is written out with `torch._foreach_*` ops over
the parameter leaves, updating the parameters and the moments in place.
The arithmetic follows optax's order of operations as the JAX package's
jitted step computes it: the first moment is stored in mu_dtype, and its
decay term b1 * mu multiplies the stored moment by b1 rounded to
mu_dtype (JAX's weak-typed scalar) in fp32 (XLA keeps the product in
fp32 under jit; only eager JAX rounds it to bf16). The update divides
the fp32 moment (before its cast) by the bias corrections at count + 1,
and the learning rate is the schedule at the count before the update
(0 on the first step, so with warmup the first update is zero). lion,
adafactor and muon are not ported.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from shellac_tpu_torch.config import TrainConfig, resolve_dtype
from shellac_tpu_torch.training.train_state import (
    AdamWState,
    Path,
    map_tree,
    named_leaves,
)


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """Linear warmup from 0 to the peak, then cosine decay to
    min_lr_ratio * peak: optax's join of linear_schedule and
    cosine_decay_schedule at warmup_steps."""
    peak = cfg.learning_rate
    warm = max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    alpha = cfg.min_lr_ratio

    def schedule(count: int) -> float:
        if count < cfg.warmup_steps:
            c = min(max(count, 0), warm)
            return (0.0 - peak) * (1.0 - c / warm) + peak
        c = min(count - cfg.warmup_steps, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return peak * ((1.0 - alpha) * cosine + alpha)

    return schedule


def decays(path: Path, leaf: torch.Tensor) -> bool:
    """Whether weight decay applies to the leaf at `path`.

    The JAX package's rule: exempt any path that names a norm, and any
    leaf of fewer than 2 dims. It is judged on the JAX package's stacked
    layout, where a layer leaf carries a leading (n_layers,) axis: a bias
    `bq` (L, d) or `sinks` (L, H) is decayed there, so it is decayed here
    too, though the port stores it per layer as (d,).
    """
    if any("norm" in str(p) for p in path):
        return False
    stacked = 1 if path and path[0] == "layers" else 0
    return leaf.dim() + stacked >= 2


def check_optimizer(cfg: TrainConfig) -> None:
    if cfg.optimizer != "adamw":
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r} is not ported; only 'adamw'"
        )


def init_adamw(cfg: TrainConfig, params) -> AdamWState:
    """Zero moments mirroring `params` (mu in mu_dtype, nu in fp32)."""
    check_optimizer(cfg)
    mu_dtype = resolve_dtype(cfg.mu_dtype)
    return AdamWState(
        count=0,
        mu=map_tree(lambda p: torch.zeros_like(p, dtype=mu_dtype), params),
        nu=map_tree(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params),
    )


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, fp32, on the device."""
    norms = torch._foreach_norm(list(grads))
    return torch.linalg.vector_norm(torch.stack(norms).float())


def _f32(x: float) -> float:
    return float(np.float32(x))


@torch.no_grad()
def adamw_update(cfg: TrainConfig, params, grads: List[torch.Tensor],
                 state: AdamWState,
                 g_norm: Optional[torch.Tensor] = None) -> AdamWState:
    """Apply one adamw step in place to `params` and `state`.

    grads: fp32 tensors in `named_leaves(params)` order; they are used as
    scratch and overwritten. g_norm: their global norm, if already known.
    Returns the state with its count advanced.
    """
    named = list(named_leaves(params))
    ps = [p for _, p in named]
    mu = [m for _, m in named_leaves(state.mu)]
    nu = [v for _, v in named_leaves(state.nu)]
    g = list(grads)
    if not (len(g) == len(ps) == len(mu) == len(nu)):
        raise ValueError("grads, params and moments differ in length")

    # clip_by_global_norm: t if |g| < max else (t / |g|) * max.
    if g_norm is None:
        g_norm = global_norm(g)
    keep = g_norm < cfg.grad_clip_norm
    one = torch.ones((), dtype=g_norm.dtype, device=g_norm.device)
    torch._foreach_div_(g, torch.where(keep, one, g_norm))
    torch._foreach_mul_(g, torch.where(keep, one, one * cfg.grad_clip_norm))

    # scale_by_adam: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu;
    # b1 mu in fp32 with b1 rounded to mu's dtype (see the module note).
    b1, b2 = cfg.b1, cfg.b2
    b1_mu = float(torch.tensor(b1).to(mu[0].dtype)) if mu else b1
    mu32 = torch._foreach_mul(g, 1.0 - b1)
    b1_term = [m.float() for m in mu]
    torch._foreach_mul_(b1_term, b1_mu)
    torch._foreach_add_(mu32, b1_term)
    del b1_term
    torch._foreach_mul_(g, g)
    torch._foreach_mul_(g, 1.0 - b2)
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, g)
    count = state.count + 1
    bc1 = _f32(np.float32(1.0) - np.float32(b1) ** np.int32(count))
    bc2 = _f32(np.float32(1.0) - np.float32(b2) ** np.int32(count))
    torch._foreach_copy_(mu, mu32)  # stored in mu_dtype
    # update = (mu / bc1) / (sqrt(nu / bc2) + eps), from the fp32 mu.
    torch._foreach_copy_(g, nu)
    torch._foreach_div_(g, bc2)
    torch._foreach_sqrt_(g)
    torch._foreach_add_(g, cfg.eps)
    torch._foreach_div_(mu32, bc1)
    torch._foreach_div_(mu32, g)
    upd = mu32
    del g

    # add_decayed_weights on the masked leaves: update + wd * p.
    idx = [i for i, (path, p) in enumerate(named) if decays(path, p)]
    if idx and cfg.weight_decay:
        torch._foreach_add_(
            [upd[i] for i in idx],
            torch._foreach_mul([ps[i] for i in idx], cfg.weight_decay),
        )

    # scale_by_learning_rate at the pre-update count, then apply.
    lr = make_schedule(cfg)(state.count)
    torch._foreach_mul_(upd, _f32(-lr))
    torch._foreach_add_(ps, upd)
    return AdamWState(count=count, mu=state.mu, nu=state.nu)
