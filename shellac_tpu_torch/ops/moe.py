"""Mixture-of-experts routing and expert FFNs.

Ports `shellac_tpu/ops/moe.py` (`expert_capacity` :34, `_group_mask` :40,
`_route_scores` :56, `route` :129, `_expert_act` :179, `moe_ffn` :195,
`moe_ffn_grouped` :270) to plain PyTorch on one device. The mesh check
(`_check_expert_shards`) is left out: meshes raise in the port.

Every shape is static and nothing reads a device value on the host, so
an MoE layer records into a CUDA graph as the dense MLP does:
  - Router math in fp32, as in the reference. Top-k keeps
    `jax.lax.top_k`'s order (`ops/sampling.py` `top_k`: descending, the
    lower index first on ties): the flat assignment order decides which
    tokens a full expert drops.
  - Capacity buckets (E, C, D) are filled by a gather: each assignment's
    bucket slot records its token through an index scatter in which every
    destination is distinct (dropped assignments go to private overflow
    rows past E * C), so the fill is deterministic. The combine gathers
    each assignment's expert output back, a zero row for a drop.
  - Expert FFNs are batched matmuls over the expert axis (bf16 operands
    accumulate in fp32 on the card and round to bf16, as the reference's
    `preferred_element_type=float32` einsums do).
  - The grouped (dropless) path sorts assignments by expert and runs
    `torch._grouped_mm` over the contiguous segments with device offsets,
    the counterpart of `jax.lax.ragged_dot`. It computes the no-drop
    buckets' function on T k rows instead of E T; the model takes it for
    every dropless call on the card in bf16 (`models/transformer.py`
    `moe_experts`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from shellac_tpu_torch.config import MoEConfig
from shellac_tpu_torch.ops.sampling import top_k


def expert_capacity(cfg: MoEConfig, num_tokens: int) -> int:
    cap = int(cfg.capacity_factor * num_tokens * cfg.num_experts_per_token
              / cfg.num_experts)
    return max(cap, 1)


def _group_mask(choice: torch.Tensor, cfg: MoEConfig, group_rank):
    """Zero out experts outside the top `topk_group` groups; `group_rank`
    ranks each group from its members' scores (max for softmax, top-2
    sum for sigmoid, as each HF gate does)."""
    t, e = choice.shape
    g = cfg.n_group
    group_scores = group_rank(choice.reshape(t, g, e // g))
    _, gidx = top_k(group_scores, cfg.topk_group)
    gmask = torch.zeros((t, g), dtype=choice.dtype, device=choice.device)
    gmask.scatter_(1, gidx, 1.0)
    return choice * gmask.repeat_interleave(e // g, dim=1)


def _route_scores(x: torch.Tensor, w_router: torch.Tensor, cfg: MoEConfig,
                  b_router: Optional[torch.Tensor] = None, aux: bool = True):
    """Gate scoring shared by the bucket and grouped paths: (expert_idx
    (T, k) int64, weight (T, k) fp32, aux_loss scalar, metrics without a
    drop fraction). With aux=False the balance and z terms are skipped
    (aux_loss and metrics are None): the cached forward reads neither."""
    e, k = cfg.num_experts, cfg.num_experts_per_token
    logits = x.float() @ w_router.float()
    if cfg.scoring == "softmax_topk" and b_router is not None:
        # GPT-OSS's router bias is part of the logits proper.
        logits = logits + b_router.float()
    probs = None
    if cfg.scoring == "softmax_topk":
        # Top-k over the raw logits, softmax over just the kept values.
        top_vals, expert_idx = top_k(logits, k)
        weight = torch.softmax(top_vals, dim=-1)
    elif cfg.scoring == "sigmoid":
        # DeepSeek-V3: the bias steers selection only; the combine
        # weights come from the raw sigmoid scores.
        scores = torch.sigmoid(logits)
        choice = scores
        if b_router is not None:
            choice = scores + b_router.float()
        if cfg.n_group > 1:
            choice = _group_mask(
                choice, cfg, lambda gsc: top_k(gsc, 2)[0].sum(dim=-1))
        _, expert_idx = top_k(choice, k)
        weight = scores.gather(-1, expert_idx)
        if cfg.norm_topk_prob:
            weight = weight / (weight.sum(dim=-1, keepdim=True) + 1e-20)
    else:
        probs = torch.softmax(logits, dim=-1)
        probs_sel = probs
        if cfg.n_group > 1:
            probs_sel = _group_mask(probs, cfg,
                                    lambda gsc: gsc.amax(dim=-1))
        weight, expert_idx = top_k(probs_sel, k)
        if cfg.norm_topk_prob:
            weight = weight / weight.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    weight = weight * cfg.routed_scaling_factor
    if not aux:
        return expert_idx, weight, None, None

    # Load balance (Switch §2.2): E * sum_e f_e * p_e, f_e the share of
    # tokens whose top-1 is e, p_e the mean router probability.
    if probs is None:
        probs = torch.softmax(logits, dim=-1)
    top1 = _one_hot(expert_idx[:, 0], e).float()
    balance_loss = e * (top1.mean(dim=0) * probs.mean(dim=0)).sum()
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()
    aux_loss = (cfg.router_aux_loss_weight * balance_loss
                + cfg.router_z_loss_weight * z_loss)
    metrics = {"moe_balance_loss": balance_loss,
               "moe_router_z_loss": z_loss}
    return expert_idx, weight, aux_loss, metrics


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(N,) ids -> (N, n) int64 indicator rows, by comparison (no check
    of the ids on the host)."""
    return (idx[:, None] == torch.arange(n, device=idx.device)).long()


def _positions(flat_expert: torch.Tensor, e: int) -> torch.Tensor:
    """Each assignment's position within its expert, in flat order."""
    pos = _one_hot(flat_expert, e).cumsum(dim=0) - 1
    return pos.gather(1, flat_expert[:, None])[:, 0]


def route(x: torch.Tensor, w_router: torch.Tensor, cfg: MoEConfig,
          capacity: Optional[int] = None,
          b_router: Optional[torch.Tensor] = None, aux: bool = True):
    """Top-k routing with capacity buckets: (slot (T, k) int64, a flat
    index into E * C or E * C when dropped; weight (T, k) fp32; aux_loss;
    metrics with moe_dropped_frac). aux=False returns None for the last
    two."""
    t = x.shape[0]
    e = cfg.num_experts
    c = expert_capacity(cfg, t) if capacity is None else capacity
    expert_idx, weight, aux_loss, metrics = _route_scores(
        x, w_router, cfg, b_router, aux)
    flat_expert = expert_idx.reshape(-1)
    pos = _positions(flat_expert, e)
    ok = pos < c
    slot = torch.where(ok, flat_expert * c + pos, e * c)
    slot = slot.reshape(t, -1)
    if aux:
        dropped = (1.0 - ok.float()).mean()
        metrics = dict(metrics, moe_dropped_frac=dropped)
    return slot, weight, aux_loss, metrics


def _expert_act(gate: torch.Tensor, up: torch.Tensor, cfg: MoEConfig):
    """Pre-activation clamp and gated activation, shared by the bucket
    and grouped paths."""
    if cfg.gate_limit is not None:
        # GPT-OSS: gate clamped from above, up on both sides.
        lim = cfg.gate_limit
        gate = gate.clamp(max=lim)
        up = up.clamp(-lim, lim)
    if cfg.expert_act == "gptoss":
        return (up + 1.0) * (gate * torch.sigmoid(1.702 * gate))
    return F.silu(gate) * up


def moe_ffn(
    x: torch.Tensor,  # (B, S, D) compute dtype
    w_router: torch.Tensor,  # (D, E)
    w_gate: torch.Tensor,  # (E, D, F)
    w_up: torch.Tensor,  # (E, D, F)
    w_down: torch.Tensor,  # (E, F, D)
    cfg: MoEConfig,
    *,
    drop_tokens: bool = True,
    b_router: Optional[torch.Tensor] = None,
    b_gate: Optional[torch.Tensor] = None,  # (E, F)
    b_up: Optional[torch.Tensor] = None,  # (E, F)
    b_down: Optional[torch.Tensor] = None,  # (E, D)
    aux: bool = True,
):
    """Returns (out (B, S, D), aux_loss, metrics); with aux=False the last
    two are None.

    drop_tokens=False sizes capacity at T (every token's top-1 on one
    expert) so nothing drops: the cached forward's rule, where a drop
    would zero a token's FFN output and part decode from prefill.
    """
    b, s, d = x.shape
    e = cfg.num_experts
    t = b * s
    c = expert_capacity(cfg, t) if drop_tokens else t
    cdt = x.dtype
    dev = x.device
    x2 = x.reshape(t, d)
    slot, weight, aux_loss, metrics = route(
        x2, w_router, cfg, capacity=c, b_router=b_router, aux=aux)
    k = slot.shape[1]
    n = t * k
    flat_slot = slot.reshape(-1)

    # Each bucket slot's token (t: the zero row for an empty slot). A
    # dropped assignment writes a private row past E * C, so no two
    # writes share a destination.
    assign = torch.arange(n, device=dev)
    dest = torch.where(flat_slot < e * c, flat_slot, e * c + assign)
    owner = torch.full((e * c + n,), t, dtype=torch.int64, device=dev)
    owner.index_copy_(0, dest, assign // k)
    x_pad = torch.cat([x2, x2.new_zeros((1, d))])
    dispatched = x_pad.index_select(0, owner[: e * c]).reshape(e, c, d)

    gate = torch.bmm(dispatched, w_gate.to(cdt))
    up = torch.bmm(dispatched, w_up.to(cdt))
    if b_gate is not None:
        gate = gate + b_gate.to(cdt)[:, None, :]
    if b_up is not None:
        up = up + b_up.to(cdt)[:, None, :]
    act = _expert_act(gate, up, cfg)
    out_e = torch.bmm(act, w_down.to(cdt))
    if b_down is not None:
        # Every routed token gets its expert's output bias; a dropped one
        # reads the zero row below.
        out_e = out_e + b_down.to(cdt)[:, None, :]

    out_flat = torch.cat([out_e.reshape(e * c, d), out_e.new_zeros((1, d))])
    gathered = out_flat.index_select(0, flat_slot).reshape(t, k, d)
    combined = (gathered * weight[..., None].to(cdt)).sum(dim=1)
    return combined.reshape(b, s, d), aux_loss, metrics


def moe_ffn_grouped(
    x: torch.Tensor,  # (B, S, D) compute dtype
    w_router: torch.Tensor,  # (D, E)
    w_gate: torch.Tensor,  # (E, D, F)
    w_up: torch.Tensor,  # (E, D, F)
    w_down: torch.Tensor,  # (E, F, D)
    cfg: MoEConfig,
    *,
    b_router: Optional[torch.Tensor] = None,
    b_gate: Optional[torch.Tensor] = None,
    b_up: Optional[torch.Tensor] = None,
    b_down: Optional[torch.Tensor] = None,
    aux: bool = True,
):
    """Dropless MoE through grouped (sorted-segment) expert products:
    assignments sort by expert id (stable), each expert's contiguous
    segment is multiplied by its weights, and the rows unsort. Nothing
    can drop (moe_dropped_frac is 0 by construction); the work is T * k
    rows, not the E * T of capacity-at-T buckets. On the card the bf16
    product records into a CUDA graph; torch's fp32 product reads the
    offsets on the host, so an fp32 call runs eagerly only."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_token
    t = b * s
    cdt = x.dtype
    x2 = x.reshape(t, d)
    expert_idx, weight, aux_loss, metrics = _route_scores(
        x2, w_router, cfg, b_router, aux)
    flat_e = expert_idx.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    x_sorted = x2.index_select(0, order // k)
    seg_e = flat_e.index_select(0, order)
    sizes = torch.zeros((e,), dtype=torch.int32, device=x.device)
    sizes.index_add_(0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))
    offs = sizes.cumsum(0, dtype=torch.int32)

    gate = torch._grouped_mm(x_sorted, w_gate.to(cdt), offs=offs)
    up = torch._grouped_mm(x_sorted, w_up.to(cdt), offs=offs)
    if b_gate is not None:
        gate = gate + b_gate.to(cdt).index_select(0, seg_e)
    if b_up is not None:
        up = up + b_up.to(cdt).index_select(0, seg_e)
    act = _expert_act(gate, up, cfg)
    down = torch._grouped_mm(act, w_down.to(cdt), offs=offs)
    if b_down is not None:
        down = down + b_down.to(cdt).index_select(0, seg_e)

    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=x.device)
    out_assign = down.index_select(0, inv).reshape(t, k, d)
    combined = (out_assign * weight[..., None].to(cdt)).sum(dim=1)
    if aux:
        metrics = dict(metrics, moe_dropped_frac=torch.zeros(
            (), dtype=torch.float32, device=x.device))
    return combined.reshape(b, s, d), aux_loss, metrics
