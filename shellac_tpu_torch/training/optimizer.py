"""The learning-rate schedule and the optimizer chains, in functional torch.

Port of `shellac_tpu/training/optimizer.py`: `make_schedule` (:15), the
masks `_decay_mask` (:29), `_muon_mask` (:44) and `_muon_dims` (:58), and
`make_optimizer` (:83-136), whose four chains share, in optax 0.2.6's
order:

    clip_by_global_norm -> scaler -> add_decayed_weights(mask)
    -> scale_by_learning_rate(schedule)

with the scaler one of scale_by_adam (adamw), scale_by_lion (lion),
scale_by_factored_rms (adafactor), or muon's partition: optax.contrib's
scale_by_muon for the stacked matrices and scale_by_adam for the rest.

Each step of a chain is written out with `torch._foreach_*` ops (or per
leaf) over the parameter leaves, updating the parameters and the
moments in place. The arithmetic follows optax's order of operations as
the JAX package's jitted step computes it: a first moment is stored in
mu_dtype, and its decay term b * mu multiplies the stored moment by b
rounded to mu_dtype (JAX's weak-typed scalar) in fp32 (XLA keeps the
product in fp32 under jit; only eager JAX rounds it to bf16). The adam
update divides the fp32 moment (before its cast) by the bias corrections
at count + 1, and the learning rate is the schedule at the count before
the update (0 on the first step, so with warmup the first update is
zero).

The masks are judged on the JAX package's stacked layout, where a layer
leaf carries its stack's leading axes (`models/transformer.py`
`stack_prefixes`; (n_layers,) for one stack) while the port stores
layers as a list: weight decay takes leaves of 2 or more stacked dims
whose path names no norm; muon takes the stacked leaves of 3 or more
dims, and adafactor factors the two largest stacked dims when both are
at least 128. A rule that would couple layers (a muon matrix or a
factored axis along a stack axis) raises NotImplementedError.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from shellac_tpu_torch.config import TrainConfig, resolve_dtype
from shellac_tpu_torch.training.train_state import (
    AdamWState,
    Path,
    map_tree,
    named_leaves,
)

OPTIMIZERS = ("adamw", "lion", "adafactor", "muon")
# optax.contrib.scale_by_muon's defaults, as the reference takes them.
MUON_NS_COEFFS = (3.4445, -4.7750, 2.0315)
MUON_NS_STEPS = 5
MUON_EPS = 1e-8
# optax.scale_by_factored_rms's defaults.
FACTOR_MIN_DIM = 128
FACTOR_EPS = 1e-30


@dataclass
class LionState:
    """scale_by_lion's state: count and the momentum in mu_dtype."""

    count: int
    mu: Any


@dataclass
class FactoredState:
    """scale_by_factored_rms's state, leaf for leaf as optax keeps it: a
    factored leaf's row and column second moments (v a (1,) zero), or an
    unfactored leaf's full v (v_row and v_col (1,) zeros)."""

    count: int
    v_row: Any
    v_col: Any
    v: Any


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


def _prefix(path: Path, prefixes: Optional[Sequence[tuple]]) -> tuple:
    """The leading stack axes of the leaf at `path` in the JAX layout."""
    if not path or path[0] != "layers":
        return ()
    if prefixes is None:
        return (1,)
    return tuple(prefixes[path[1]])


def decays(path: Path, leaf: torch.Tensor,
           prefixes: Optional[Sequence[tuple]] = None) -> bool:
    """Whether weight decay applies to the leaf at `path`.

    The JAX package's rule: exempt any path that names a norm, and any
    leaf of fewer than 2 dims. It is judged on the JAX package's stacked
    layout, where a layer leaf carries a leading (n_layers,) axis: a bias
    `bq` (L, d) or `sinks` (L, H) is decayed there, so it is decayed here
    too, though the port stores it per layer as (d,).
    """
    if any("norm" in str(p) for p in path):
        return False
    return leaf.dim() + len(_prefix(path, prefixes)) >= 2


def muon_dims(path: Path, leaf: torch.Tensor,
              prefixes: Optional[Sequence[tuple]] = None):
    """(reduction axes, output axes) of the leaf's own dims when muon
    takes it (`_muon_mask` and `_muon_dims` on the stacked layout: 3 or
    more stacked dims; MLA's wkv_b_k and wkv_b_v (r, h, dh) map r to the
    (h, dh) pair), else None (adamw takes it)."""
    pre = _prefix(path, prefixes)
    nd = leaf.dim() + len(pre)
    if nd < 3:
        return None
    if path and path[-1] in ("wkv_b_k", "wkv_b_v"):
        red, out = (nd - 3,), (nd - 2, nd - 1)
    else:
        red, out = (nd - 2,), (nd - 1,)
    own = [a - len(pre) for a in red + out]
    if min(own) < 0:
        raise NotImplementedError(
            f"muon at {path}: its matrix would span the layer stack "
            f"(stacked shape {pre + tuple(leaf.shape)})")
    k = len(red)
    return tuple(own[:k]), tuple(own[k:])


def factored_dims(path: Path, leaf: torch.Tensor,
                  prefixes: Optional[Sequence[tuple]] = None):
    """optax's `_factored_dims` on the stacked shape, as the leaf's own
    (d1, d0) (the second largest and the largest dim), or None."""
    pre = _prefix(path, prefixes)
    shape = pre + tuple(leaf.shape)
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < FACTOR_MIN_DIM:
        return None
    d1, d0 = int(sorted_dims[-2]) - len(pre), int(sorted_dims[-1]) - len(pre)
    if d1 < 0 or d0 < 0:
        raise NotImplementedError(
            f"adafactor at {path}: it would factor along the layer stack "
            f"(stacked shape {shape})")
    return d1, d0


def check_optimizer(cfg: TrainConfig) -> None:
    if cfg.optimizer not in OPTIMIZERS:
        raise ValueError(
            f"unknown optimizer {cfg.optimizer!r}; have "
            f"{', '.join(OPTIMIZERS)}"
        )


def init_adamw(cfg: TrainConfig, params) -> AdamWState:
    """Zero moments mirroring `params` (mu in mu_dtype, nu in fp32)."""
    mu_dtype = resolve_dtype(cfg.mu_dtype)
    return AdamWState(
        count=0,
        mu=map_tree(lambda p: torch.zeros_like(p, dtype=mu_dtype), params),
        nu=map_tree(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params),
    )


def init_opt_state(cfg: TrainConfig, params,
                   prefixes: Optional[Sequence[tuple]] = None):
    """The optimizer's zero state over `params` (any device, `meta`
    included): AdamWState for adamw and muon (muon's matrices keep an
    empty nu), LionState, or FactoredState."""
    check_optimizer(cfg)
    mu_dtype = resolve_dtype(cfg.mu_dtype)
    if cfg.optimizer == "adamw":
        return init_adamw(cfg, params)
    if cfg.optimizer == "lion":
        return LionState(count=0, mu=map_tree(
            lambda p: torch.zeros_like(p, dtype=mu_dtype), params))
    if cfg.optimizer == "muon":
        def nu(path, p):
            if muon_dims(path, p, prefixes) is not None:
                return p.new_zeros((0,), dtype=torch.float32)
            return torch.zeros_like(p, dtype=torch.float32)

        return AdamWState(
            count=0,
            mu=map_tree(lambda p: torch.zeros_like(p, dtype=mu_dtype),
                        params),
            nu=_map_named(nu, params))

    def factored(path, p, which):
        dims = factored_dims(path, p, prefixes)
        if dims is None:
            shape = p.shape if which == "v" else (1,)
        elif which == "v":
            shape = (1,)
        else:
            d1, d0 = dims
            drop = d0 if which == "v_row" else d1
            shape = tuple(n for i, n in enumerate(p.shape) if i != drop)
        return p.new_zeros(shape, dtype=p.dtype)

    return FactoredState(
        count=0,
        v_row=_map_named(lambda a, p: factored(a, p, "v_row"), params),
        v_col=_map_named(lambda a, p: factored(a, p, "v_col"), params),
        v=_map_named(lambda a, p: factored(a, p, "v"), params))


def _map_named(fn, tree, prefix: Path = ()):
    """map_tree with the leaf's path: fn(path, leaf)."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, fp32, on the device."""
    norms = torch._foreach_norm(list(grads))
    return torch.linalg.vector_norm(torch.stack(norms).float())


def _f32(x: float) -> float:
    return float(np.float32(x))


def _rounded(b: float, dtype: torch.dtype) -> float:
    """A weak-typed scalar as JAX applies it to a moment of `dtype`."""
    return float(torch.tensor(b).to(dtype))


def _clip(cfg: TrainConfig, g: List[torch.Tensor], g_norm) -> None:
    """clip_by_global_norm in place: t if |g| < max else (t / |g|) * max."""
    keep = g_norm < cfg.grad_clip_norm
    one = torch.ones((), dtype=g_norm.dtype, device=g_norm.device)
    torch._foreach_div_(g, torch.where(keep, one, g_norm))
    torch._foreach_mul_(g, torch.where(keep, one, one * cfg.grad_clip_norm))


def _bias_correction(b: float, count: int) -> float:
    return _f32(np.float32(1.0) - np.float32(b) ** np.int32(count))


def _moment(g: List[torch.Tensor], mu: List[torch.Tensor], b: float):
    """(1 - b) g + b mu in fp32, b rounded to mu's dtype (module note)."""
    out = torch._foreach_mul(g, 1.0 - b)
    if mu:
        # Not in place: .float() of an fp32 moment is the moment itself.
        torch._foreach_add_(out, torch._foreach_mul(
            [m.float() for m in mu], _rounded(b, mu[0].dtype)))
    return out


def _adam_scale(cfg, g, mu, nu, count):
    """scale_by_adam on lists: updates mu and nu in place, returns the
    fp32 updates (g is used as scratch)."""
    mu32 = _moment(g, mu, cfg.b1)
    torch._foreach_mul_(g, g)
    torch._foreach_mul_(g, 1.0 - cfg.b2)
    torch._foreach_mul_(nu, cfg.b2)
    torch._foreach_add_(nu, g)
    bc1 = _bias_correction(cfg.b1, count)
    bc2 = _bias_correction(cfg.b2, count)
    if mu:
        torch._foreach_copy_(mu, mu32)  # stored in mu_dtype
    # update = (mu / bc1) / (sqrt(nu / bc2) + eps), from the fp32 mu.
    torch._foreach_copy_(g, nu)
    torch._foreach_div_(g, bc2)
    torch._foreach_sqrt_(g)
    torch._foreach_add_(g, cfg.eps)
    torch._foreach_div_(mu32, bc1)
    torch._foreach_div_(mu32, g)
    return mu32


def _lion_scale(cfg, g, mu):
    """scale_by_lion: sign((1 - b1) g + b1 mu), then mu = (1 - b2) g +
    b2 mu in mu_dtype."""
    upd = [torch.sign(u) for u in _moment(g, mu, cfg.b1)]
    torch._foreach_copy_(mu, _moment(g, mu, cfg.b2))
    return upd


def _factored_scale(cfg, named, g, state: FactoredState, prefixes):
    """scale_by_factored_rms (decay_rate = b2 as the reference passes it,
    the exponent of optax's `_decay_rate_pow`), leaf by leaf."""
    t = np.float32(state.count + 1)
    decay32 = np.float32(1.0) - t ** np.float32(-cfg.b2)
    decay, keep = _f32(decay32), _f32(np.float32(1.0) - decay32)
    rows = [x for _, x in named_leaves(state.v_row)]
    cols = [x for _, x in named_leaves(state.v_col)]
    vs = [x for _, x in named_leaves(state.v)]
    upd = []
    for i, (path, p) in enumerate(named):
        gi = g[i]
        sq = gi * gi + FACTOR_EPS
        dims = factored_dims(path, p, prefixes)
        if dims is None:
            vs[i].copy_(decay * vs[i] + keep * sq)
            upd.append(gi * vs[i] ** -0.5)
            continue
        d1, d0 = dims
        rows[i].copy_(decay * rows[i] + keep * sq.mean(dim=d0))
        cols[i].copy_(decay * cols[i] + keep * sq.mean(dim=d1))
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_mean = rows[i].mean(dim=reduced_d1, keepdim=True)
        row_factor = (rows[i] / row_mean) ** -0.5
        col_factor = cols[i] ** -0.5
        upd.append(gi * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1))
    return upd


def newton_schulz(x: torch.Tensor, steps: int = MUON_NS_STEPS,
                  coeffs=MUON_NS_COEFFS, eps: float = MUON_EPS
                  ) -> torch.Tensor:
    """optax.contrib's orthogonalization of a batch of matrices (..., m,
    n): each normalized by its Frobenius norm, then `steps` quintic
    Newton-Schulz iterations on the wide orientation."""
    tall = x.shape[-2] > x.shape[-1]
    if tall:
        x = x.transpose(-2, -1)
    x = x / (torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True) + eps)
    c0, c1, c2 = (_f32(c) for c in coeffs)
    for _ in range(steps):
        a = x @ x.transpose(-2, -1)
        b = c1 * a + c2 * (a @ a)
        x = c0 * x + b @ x
    return x.transpose(-2, -1) if tall else x


def _muon_matrix(u: torch.Tensor, red, out):
    """u's batch of (reduction, output) matrices, and the inverse."""
    batch = [a for a in range(u.dim()) if a not in red + out]
    perm = batch + list(red) + list(out)
    moved = u.permute(perm)
    shape = moved.shape
    nb = len(batch)
    m = math.prod(shape[nb:nb + len(red)])
    x = moved.reshape(math.prod(shape[:nb]), m, -1)
    inv = [perm.index(a) for a in range(u.dim())]
    return x, lambda y: y.reshape(shape).permute(inv)


def _muon_scale(cfg, named, g, state: AdamWState, prefixes):
    """muon's partition: scale_by_muon (nesterov, beta = b1) on the
    stacked matrices, scale_by_adam on the rest."""
    mus = [x for _, x in named_leaves(state.mu)]
    nus = [x for _, x in named_leaves(state.nu)]
    dims = [muon_dims(path, p, prefixes) for path, p in named]
    mi = [i for i, d in enumerate(dims) if d is not None]
    ai = [i for i, d in enumerate(dims) if d is None]
    count = state.count + 1
    upd: List[Optional[torch.Tensor]] = [None] * len(named)
    adam = _adam_scale(cfg, [g[i] for i in ai], [mus[i] for i in ai],
                       [nus[i] for i in ai], count)
    for i, u in zip(ai, adam):
        upd[i] = u
    if mi:
        beta = cfg.b1
        gm = [g[i] for i in mi]
        mu32 = _moment(gm, [mus[i] for i in mi], beta)
        bc_mu = _bias_correction(beta, count + 1)
        bc_g = _bias_correction(beta, count)
        for j, i in enumerate(mi):
            hat = beta * (mu32[j] / bc_mu) + (1.0 - beta) * (gm[j] / bc_g)
            red, out = dims[i]
            x, back = _muon_matrix(hat, red, out)
            o = back(newton_schulz(x))
            factor = (math.prod(o.shape[a] for a in out)
                      / math.prod(o.shape[a] for a in red))
            upd[i] = math.sqrt(max(1.0, factor)) * o
            mus[i].copy_(mu32[j])
    return upd


@torch.no_grad()
def opt_update(cfg: TrainConfig, params, grads: List[torch.Tensor], state,
               g_norm: Optional[torch.Tensor] = None,
               prefixes: Optional[Sequence[tuple]] = None):
    """Apply one step of cfg.optimizer's chain in place to `params` and
    `state`.

    grads: fp32 tensors in `named_leaves(params)` order; they are used as
    scratch and overwritten. g_norm: their global norm, if already known.
    prefixes: the layers' stack axes (`stack_prefixes`), for the masks.
    Returns the state with its count advanced.
    """
    check_optimizer(cfg)
    named = list(named_leaves(params))
    ps = [p for _, p in named]
    g = list(grads)
    if len(g) != len(ps):
        raise ValueError("grads and params differ in length")
    if g_norm is None:
        g_norm = global_norm(g)
    _clip(cfg, g, g_norm)
    count = state.count + 1
    if cfg.optimizer == "adamw":
        mu = [m for _, m in named_leaves(state.mu)]
        nu = [v for _, v in named_leaves(state.nu)]
        if not (len(mu) == len(nu) == len(ps)):
            raise ValueError("grads, params and moments differ in length")
        upd = _adam_scale(cfg, g, mu, nu, count)
        new = AdamWState(count=count, mu=state.mu, nu=state.nu)
    elif cfg.optimizer == "lion":
        upd = _lion_scale(cfg, g, [m for _, m in named_leaves(state.mu)])
        new = LionState(count=count, mu=state.mu)
    elif cfg.optimizer == "adafactor":
        upd = _factored_scale(cfg, named, g, state, prefixes)
        new = FactoredState(count=count, v_row=state.v_row,
                            v_col=state.v_col, v=state.v)
    else:
        upd = _muon_scale(cfg, named, g, state, prefixes)
        new = AdamWState(count=count, mu=state.mu, nu=state.nu)
    del g

    # add_decayed_weights on the masked leaves: update + wd * p.
    idx = [i for i, (path, p) in enumerate(named)
           if decays(path, p, prefixes)]
    if idx and cfg.weight_decay:
        torch._foreach_add_(
            [upd[i] for i in idx],
            torch._foreach_mul([ps[i] for i in idx], cfg.weight_decay),
        )

    # scale_by_learning_rate at the pre-update count, then apply.
    lr = make_schedule(cfg)(state.count)
    torch._foreach_mul_(upd, _f32(-lr))
    torch._foreach_add_(ps, upd)
    return new


def adamw_update(cfg: TrainConfig, params, grads: List[torch.Tensor],
                 state: AdamWState,
                 g_norm: Optional[torch.Tensor] = None) -> AdamWState:
    """One adamw step in place (`opt_update` with cfg.optimizer adamw)."""
    if cfg.optimizer != "adamw":
        raise ValueError(f"adamw_update with optimizer {cfg.optimizer!r}")
    return opt_update(cfg, params, grads, state, g_norm)
