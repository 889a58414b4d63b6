"""Evaluation: token-weighted NLL and perplexity over a data stream.

Port of `shellac_tpu/training/evaluate.py` (`make_eval_step` :20,
`evaluate` :42) under `torch.no_grad`. The eval step returns the summed
negative log-likelihood and the token count, not per-batch means, so the
stream's aggregate is exact with ragged masks or a short last batch.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional

import torch

from shellac_tpu_torch.config import ModelConfig
from shellac_tpu_torch.models import transformer
from shellac_tpu_torch.ops.dispatch import DeviceLike, resolve_device


def make_eval_step(model_cfg: ModelConfig, attn_impl: str = "auto",
                   device: DeviceLike = None, mesh=None):
    """Build `eval_step(params, batch) -> (nll_sum, token_count)`, fp32
    0-dim tensors on the device (the card unless told otherwise)."""
    if mesh is not None:
        raise NotImplementedError(
            "evaluation over a mesh is not ported; it runs on one card")
    dev = resolve_device(device)

    @torch.no_grad()
    def eval_step(params, batch):
        logits = transformer.forward(model_cfg, params, batch["inputs"],
                                     attn_impl=attn_impl, device=dev)
        logp = torch.log_softmax(logits.float(), dim=-1)
        targets = torch.as_tensor(batch["targets"], device=dev)
        nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
        mask = batch.get("mask")
        mask = (torch.ones_like(nll) if mask is None
                else torch.as_tensor(mask, device=dev).float())
        return (nll * mask).sum(), mask.sum()

    return eval_step


def evaluate(model_cfg: ModelConfig, params, data_iter: Iterator[dict], *,
             max_batches: Optional[int] = None, device: DeviceLike = None,
             mesh=None) -> dict:
    """{"loss", "perplexity", "tokens", "batches"} over the stream, on
    `device` (the card unless told otherwise)."""
    step = make_eval_step(model_cfg, device=device, mesh=mesh)
    total_nll = 0.0
    total_tok = 0.0
    batches = 0
    for batch in data_iter:
        nll, tok = step(params, batch)
        total_nll += float(nll)
        total_tok += float(tok)
        batches += 1
        if max_batches is not None and batches >= max_batches:
            break
    if total_tok == 0:
        raise ValueError("evaluate: empty data stream")
    loss = total_nll / total_tok
    return {"loss": loss, "perplexity": math.exp(min(loss, 30.0)),
            "tokens": int(total_tok), "batches": batches}
