"""Training for the PyTorch port: the losses, the optimizer chains, the
train state, the train step, evaluation and the fit loop (ports of
`shellac_tpu/training/`)."""

from shellac_tpu_torch.config import TrainConfig
from shellac_tpu_torch.training.losses import (
    cross_entropy,
    fused_cross_entropy,
)
from shellac_tpu_torch.training.optimizer import (
    FactoredState,
    LionState,
    adamw_update,
    decays,
    global_norm,
    init_adamw,
    init_opt_state,
    make_schedule,
    opt_update,
)
from shellac_tpu_torch.training.train_state import (
    AdamWState,
    TrainState,
    named_leaves,
)
from shellac_tpu_torch.training.trainer import (
    init_train_state,
    make_train_step,
    train_state_from_params,
)

__all__ = [
    "AdamWState",
    "FactoredState",
    "LionState",
    "fused_cross_entropy",
    "init_opt_state",
    "opt_update",
    "TrainConfig",
    "TrainState",
    "adamw_update",
    "cross_entropy",
    "decays",
    "global_norm",
    "init_adamw",
    "init_train_state",
    "make_schedule",
    "make_train_step",
    "named_leaves",
    "train_state_from_params",
]
