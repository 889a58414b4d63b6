"""Training step construction.

Port of `shellac_tpu/training/trainer.py` (`init_train_state` :33,
`make_train_step` :58-207) for one card: the forward (remat per
cfg.remat and cfg.remat_policy, packed segments, int8 projections under
TrainConfig.quant), the fp32 cross-entropy or the vocab-chunked fused
loss (TrainConfig.fused_loss_chunk), the MoE router's auxiliary loss
added to it, gradients by autograd (the flash and RMSNorm kernels carry
their own backward), the optimizer chain (adamw, lion, adafactor or
muon), gradient accumulation, the parameter EMA and the
non-finite-update guard. The JAX step is jitted with its state donated;
this one updates the state in place and returns it.

Not ported, raising NotImplementedError: a mesh and
pipeline_microbatches (one card).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from shellac_tpu_torch.config import ModelConfig, TrainConfig
from shellac_tpu_torch.models import transformer
from shellac_tpu_torch.ops.dispatch import DeviceLike, check_on, resolve_device
from shellac_tpu_torch.training.losses import (
    cross_entropy,
    fused_cross_entropy,
)
from shellac_tpu_torch.training.optimizer import (
    check_optimizer,
    global_norm,
    init_opt_state,
    opt_update,
)
from shellac_tpu_torch.training.train_state import (
    TrainState,
    clone_tree,
    leaves,
)


def _check_train_config(model_cfg: ModelConfig, train_cfg: TrainConfig):
    check_optimizer(train_cfg)
    if train_cfg.grad_accum < 1:
        raise ValueError(f"grad_accum={train_cfg.grad_accum} must be >= 1")
    transformer.check_supported(model_cfg)


def train_state_from_params(train_cfg: TrainConfig, params,
                            model_cfg: Optional[ModelConfig] = None
                            ) -> TrainState:
    """A fresh TrainState over master `params` (every leaf then requires
    grad): the optimizer's zero state, and an EMA copy when
    train_cfg.ema_decay is set. `model_cfg` gives the layers' stacked
    layout for the optimizer's masks (one stack when omitted)."""
    check_optimizer(train_cfg)
    for p in leaves(params):
        p.requires_grad_(True)
    ema = None
    if train_cfg.ema_decay is not None:
        ema = clone_tree(params)
    prefixes = (None if model_cfg is None
                else transformer.stack_prefixes(model_cfg))
    return TrainState(step=0, params=params,
                      opt_state=init_opt_state(train_cfg, params, prefixes),
                      ema_params=ema)


def init_train_state(model_cfg: ModelConfig, train_cfg: TrainConfig,
                     seed: int = 0, device: DeviceLike = None) -> TrainState:
    """Random master parameters from `seed` (transformer.init_params with
    master=True) and a fresh optimizer state, on `device` (the card by
    default; raises without one unless device="cpu")."""
    _check_train_config(model_cfg, train_cfg)
    dev = resolve_device(device)
    params = transformer.init_params(model_cfg, seed=seed, device=dev,
                                     master=True)
    return train_state_from_params(train_cfg, params, model_cfg)


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                    attn_impl: str = "auto", device: DeviceLike = None,
                    mesh=None, pipeline_microbatches: Optional[int] = None):
    """Build `train_step(state, batch) -> (state, metrics)`.

    batch: {"inputs": (B, S) int, "targets": (B, S) int, "mask": (B, S)
    0/1 (optional), "segment_ids": (B, S) int (optional)}. With
    grad_accum > 1 the batch splits into that many microbatches along
    its first axis; gradients accumulate in fp32 and the metrics are
    their means (tokens times grad_accum).

    metrics (0-dim tensors on the device): loss, perplexity, tokens,
    grad_norm (of the unclipped gradients), update_skipped (1 when the
    gradients or the loss were not finite: the parameters, the optimizer
    state and the EMA then stay exactly as they were), and for an MoE
    model moe_aux_loss (added to the loss), moe_balance_loss,
    moe_router_z_loss and moe_dropped_frac. The state's tensors are
    updated in place.

    TrainConfig.quant runs the dense projections as int8 dots for this
    step only (the model config keeps quant_training unset).
    TrainConfig.fused_loss_chunk takes the vocab-chunked loss, except
    where the reference falls back to the unfused one: a logit softcap,
    or a vocab the chunk does not divide.
    """
    if mesh is not None or pipeline_microbatches is not None:
        raise NotImplementedError(
            "meshes and pipeline microbatches are not ported; the train "
            "step runs on one card"
        )
    _check_train_config(model_cfg, train_cfg)
    if train_cfg.quant is not None:
        model_cfg = model_cfg.replace(
            quant_training=train_cfg.quant).validate()
    dev = resolve_device(device)
    accum = train_cfg.grad_accum
    prefixes = transformer.stack_prefixes(model_cfg)
    fused_chunk = train_cfg.fused_loss_chunk
    if fused_chunk is not None and (
            model_cfg.logit_softcap is not None
            or model_cfg.vocab_size % fused_chunk):
        # Softcap changes the logit function itself; an indivisible vocab
        # has no even chunking. Both take the unfused path (:79-87).
        fused_chunk = None

    def loss_fn(params, batch):
        out, aux = transformer.forward(
            model_cfg, params, batch["inputs"],
            segment_ids=batch.get("segment_ids"), attn_impl=attn_impl,
            device=dev, return_aux=True,
            return_hidden=fused_chunk is not None,
        )
        if fused_chunk is not None:
            loss, metrics = fused_cross_entropy(
                out, transformer.output_weights(model_cfg, params),
                batch["targets"], batch.get("mask"),
                train_cfg.z_loss_weight, vocab_chunk=fused_chunk)
        else:
            loss, metrics = cross_entropy(
                out, batch["targets"], batch.get("mask"),
                train_cfg.z_loss_weight)
        if model_cfg.moe is not None:
            metrics["moe_aux_loss"] = aux["aux"]
            metrics["moe_balance_loss"] = aux["balance_loss"]
            metrics["moe_router_z_loss"] = aux["router_z_loss"]
            metrics["moe_dropped_frac"] = aux["dropped_frac"]
            loss = loss + aux["aux"]
        return loss, metrics

    def grads_of(params, batch):
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves(params))
        return [g.float() for g in grads], {
            k: v.detach() for k, v in metrics.items()}

    def compute_grads(params, batch):
        if accum <= 1:
            return grads_of(params, batch)
        b = batch["inputs"].shape[0]
        if b % accum:
            raise ValueError(f"batch {b} not divisible by grad_accum={accum}")
        mb = b // accum
        acc, per = None, []
        for i in range(accum):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            grads, metrics = grads_of(params, part)
            if acc is None:
                acc = grads
            else:
                torch._foreach_add_(acc, grads)
            per.append(metrics)
            del grads
        torch._foreach_div_(acc, float(accum))
        metrics = {k: torch.stack([m[k] for m in per]).mean()
                   for k in per[0]}
        metrics["tokens"] = metrics["tokens"] * accum
        return acc, metrics

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        check_on(dev, embed=state.params["embed"])
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        grads, metrics = compute_grads(state.params, batch)
        g_norm = global_norm(grads)
        metrics["grad_norm"] = g_norm
        ok = True
        if train_cfg.skip_nonfinite_updates:
            # One host sync. A finite global norm means every element is
            # finite; when it is not, look at the elements (the sum of
            # squares may overflow where every gradient is finite). The
            # loss too: an overflowed loss makes the direction
            # untrustworthy.
            loss_ok = torch.isfinite(metrics["loss"])
            ok = bool((loss_ok & torch.isfinite(g_norm)).item())
            if not ok and bool(loss_ok.item()):
                ok = all(bool(torch.isfinite(g).all().item())
                         for g in grads)
            metrics["update_skipped"] = torch.full(
                (), 0.0 if ok else 1.0, dtype=torch.float32, device=dev)
        opt_state = state.opt_state
        if ok:
            opt_state = opt_update(train_cfg, state.params, grads,
                                   opt_state, g_norm, prefixes)
            if state.ema_params is not None:
                d = train_cfg.ema_decay
                with torch.no_grad():
                    ema = leaves(state.ema_params)
                    torch._foreach_mul_(ema, d)
                    torch._foreach_add_(ema, torch._foreach_mul(
                        leaves(state.params), 1.0 - d))
        del grads
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=opt_state,
                          ema_params=state.ema_params), metrics

    return train_step
