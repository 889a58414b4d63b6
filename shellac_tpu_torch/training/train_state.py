"""The training state, and the walk over a parameter tree.

Port of `shellac_tpu/training/train_state.py` `TrainState` as a plain
dataclass: no shardings (the port runs on one card). Parameter trees are
the port's layout (models/transformer.py): dictionaries and lists of
tensors. `named_leaves` fixes one order over them, which the optimizer
state mirrors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterator, List, Optional, Tuple

import torch

Path = Tuple[Any, ...]


def named_leaves(tree, prefix: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) over a tree of dicts and lists, in insertion order."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from named_leaves(sub, prefix + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from named_leaves(sub, prefix + (i,))
    else:
        yield prefix, tree


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in named_leaves(tree)]


def map_tree(fn: Callable[[Any], Any], tree):
    """A tree of the same structure with fn applied to every leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


@dataclass
class AdamWState:
    """The adamw chain's state: optax's ScaleByAdamState (count, mu, nu)
    and the schedule's count, which always equals it.

    count: updates applied so far (a host int: a skipped update leaves it
    unchanged). mu: first moments in TrainConfig.mu_dtype; nu: second
    moments in fp32; both mirror the parameter tree.
    """

    count: int
    mu: Any
    nu: Any


@dataclass
class TrainState:
    """step: train-step calls so far (skipped updates included, as the
    JAX step counts them); params: the fp32 master tree; opt_state: an
    AdamWState; ema_params: the parameters' moving average, or None."""

    step: int
    params: Any
    opt_state: AdamWState
    ema_params: Optional[Any] = None


def clone_tree(tree):
    """A detached copy of every tensor leaf (for checks and snapshots)."""
    return map_tree(
        lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t,
        tree,
    )
