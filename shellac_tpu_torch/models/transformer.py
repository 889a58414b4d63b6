"""Decoder-only transformer (LLaMA-style): GQA decoders, dense and MoE.

The port of the JAX package's `models/transformer.py`: GQA and MLA
(DeepSeek's latent attention) models, dense and mixture-of-experts.
Parameters are a plain dictionary:

    {"embed": (V, D), "layers": [per-layer dict, ...], "final_norm": (D,),
     "lm_head": (D, V) when embeddings are untied}

Layers are stored per layer (a list, in layer order) and walked by a
Python loop, where the JAX package stacks them for `lax.scan`;
`models/from_jax.py` converts between the two. A layer's dict holds the
dense MLP's weights or an MoE layer's (router, stacked experts (E, D, F)
and (E, F, D), their biases and shared experts); `moe_layers(cfg)` says
which, for uniform MoE stacks, the interleaved layout (`moe_every`: every
`moe_every`-th layer) and the first-k-dense one (`first_k_dense` dense
layers, then MoE). Two storage layouts, one forward:
  - serving (`master=False`, the default): matmul weights, embeddings
    and biases in the compute dtype, norm scales, attention sinks and the
    router in fp32 (what the JAX forward reads them as);
  - training (`master=True`): every leaf in cfg.params_dtype, the fp32
    master copy the optimizer updates.
The forward casts each weight to the compute dtype at its use, as the
JAX forward does; for stored compute-dtype weights the cast is a no-op.

Compute: bf16 matmuls, fp32 norm statistics, softmax and logits, a bf16
residual stream, as in the JAX package. Under autograd with cfg.remat
each block is recomputed in the backward pass (`torch.utils.checkpoint`,
the JAX package's `jax.checkpoint`); cfg.remat_policy says what the
recompute may keep (`remat_saves`). With cfg.quant_training the dense
projections run as int8 dots (`ops/qtrain.py` `quant_dot`). Packed
`segment_ids` restart RoPE positions per segment and make attention
block-diagonal over segments.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from shellac_tpu_torch.config import ModelConfig
from shellac_tpu_torch.inference.cache.layout import (
    PagedKVCache,
    QuantPagedKVCache,
    cache_quant,
    paged_update_layer,
    quant_paged_update_layer,
    quant_update_layer,
    update_layer,
)
from shellac_tpu_torch.ops.activations import geglu, softcap, swiglu
from shellac_tpu_torch.ops.attention import attention
from shellac_tpu_torch.ops.decode_attention import (
    decode_attention,
    paged_decode_attention,
)
from shellac_tpu_torch.ops.dispatch import DeviceLike, check_on, resolve_device
from shellac_tpu_torch.ops.moe import moe_ffn, moe_ffn_grouped
from shellac_tpu_torch.ops.norms import rms_norm
from shellac_tpu_torch.ops.qtrain import quant_dot
from shellac_tpu_torch.ops.rope import (
    apply_rope,
    apply_rope_interleaved,
    rope_angles,
)

Params = Dict[str, Any]

# Parameters the JAX forward reads in fp32 (norm scales, sinks, the
# router); every other parameter is stored in the compute dtype.
FP32_KEYS = frozenset({
    "attn_norm", "mlp_norm", "final_norm", "q_norm", "k_norm",
    "post_attn_norm", "post_mlp_norm", "sinks", "w_router", "b_router",
    "kv_a_norm", "q_a_norm",
})

# The MoE diagnostics `forward(return_aux=True)` returns beside the summed
# auxiliary loss, each a mean over the router layers.
AUX_KEYS = ("aux", "balance_loss", "router_z_loss", "dropped_frac")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for configurations the port lacks."""
    if cfg.activation not in ("swiglu", "geglu"):
        raise ValueError(
            f"unknown activation {cfg.activation!r}; have swiglu, geglu"
        )


def moe_layers(cfg: ModelConfig) -> List[bool]:
    """Whether each layer is an MoE layer, in layer order: all of them for
    a uniform MoE stack; the last of each group of `moe_every` (the JAX
    package's `grouped_moe` layout, dense first); every layer past the
    first `first_k_dense` (its `first_k_layout`)."""
    if cfg.moe is None:
        return [False] * cfg.n_layers
    if cfg.first_k_dense > 0:
        return [i >= cfg.first_k_dense for i in range(cfg.n_layers)]
    if cfg.n_layers % cfg.moe_every:
        raise ValueError(
            f"n_layers={cfg.n_layers} must divide into groups of "
            f"moe_every={cfg.moe_every}"
        )
    return [(i + 1) % cfg.moe_every == 0 for i in range(cfg.n_layers)]


def stack_prefixes(cfg: ModelConfig) -> List[tuple]:
    """Each layer's leading axes in the JAX package's stacked tree: (L,)
    for one stack; (first_k_dense,) and (L - first_k_dense,) for the
    first-k-dense stacks; (G, moe_every - 1) and (G,) for the interleaved
    ones (G = L / moe_every groups). The optimizer's masks are judged on
    that layout (`training/optimizer.py`)."""
    flags = moe_layers(cfg)
    n = cfg.n_layers
    if cfg.moe is None or (cfg.moe_every == 1 and cfg.first_k_dense == 0):
        return [(n,)] * n
    if cfg.first_k_dense > 0:
        k = cfg.first_k_dense
        return [(k,) if i < k else (n - k,) for i in range(n)]
    g = n // cfg.moe_every
    return [(g,) if moe else (g, cfg.moe_every - 1) for moe in flags]


def layer_shapes(cfg: ModelConfig, moe_layer: bool = False
                 ) -> Dict[str, tuple]:
    """name -> (shape, init) for one layer (dense, or MoE with
    `moe_layer`), in the JAX package's order. init is ("dense", fan_in,
    scale) or ("zeros",)."""
    d, h, hkv, dh, f = (
        cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.dim_per_head, cfg.ff_dim,
    )
    out_scale = (2 * cfg.n_layers) ** -0.5
    if cfg.mla is not None:
        shapes = _mla_shapes(cfg, out_scale)
    else:
        shapes = {
            "attn_norm": ((d,), ("zeros",)),
            "wq": ((d, h * dh), ("dense", d, 1.0)),
            "wk": ((d, hkv * dh), ("dense", d, 1.0)),
            "wv": ((d, hkv * dh), ("dense", d, 1.0)),
            "wo": ((h * dh, d), ("dense", h * dh, out_scale)),
            "mlp_norm": ((d,), ("zeros",)),
        }
    if cfg.qk_norm:
        shapes["q_norm"] = ((dh,), ("zeros",))
        shapes["k_norm"] = ((dh,), ("zeros",))
    if cfg.attn_bias:
        shapes["bq"] = ((h * dh,), ("zeros",))
        shapes["bk"] = ((hkv * dh,), ("zeros",))
        shapes["bv"] = ((hkv * dh,), ("zeros",))
    if cfg.post_norms:
        shapes["post_attn_norm"] = ((d,), ("zeros",))
        shapes["post_mlp_norm"] = ((d,), ("zeros",))
    if cfg.attn_sink:
        shapes["sinks"] = ((h,), ("zeros",))
    if cfg.attn_out_bias:
        shapes["bo"] = ((d,), ("zeros",))
    if not moe_layer:
        shapes["w_gate"] = ((d, f), ("dense", d, 1.0))
        shapes["w_up"] = ((d, f), ("dense", d, 1.0))
        shapes["w_down"] = ((f, d), ("dense", f, out_scale))
        return shapes
    m = cfg.moe
    e, fe = m.num_experts, m.d_ff_expert or f
    shapes["w_router"] = ((d, e), ("dense", d, 1.0))
    shapes["w_gate"] = ((e, d, fe), ("dense", d, 1.0))
    shapes["w_up"] = ((e, d, fe), ("dense", d, 1.0))
    shapes["w_down"] = ((e, fe, d), ("dense", fe, out_scale))
    if m.scoring in ("sigmoid", "softmax_topk"):
        shapes["b_router"] = ((e,), ("zeros",))
    if m.expert_bias:
        shapes["b_gate"] = ((e, fe), ("zeros",))
        shapes["b_up"] = ((e, fe), ("zeros",))
        shapes["b_down"] = ((e, d), ("zeros",))
    if m.num_shared_experts > 0:
        sf = m.num_shared_experts * fe
        shapes["w_gate_shared"] = ((d, sf), ("dense", d, 1.0))
        shapes["w_up_shared"] = ((d, sf), ("dense", d, 1.0))
        shapes["w_down_shared"] = ((sf, d), ("dense", sf, out_scale))
    return shapes


def _mla_shapes(cfg: ModelConfig, out_scale: float) -> Dict[str, tuple]:
    """An MLA layer's attention leaves (JAX init_params :133-165): the
    query projection (full, or low-rank through `q_a_norm`), the latent
    projection `wkv_a` (d -> kv_lora_rank + rope), its norm, and the
    per-head expansions of the latent into no-position keys and values."""
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    r = m.kv_lora_rank
    shapes = {
        "attn_norm": ((d,), ("zeros",)),
        "wkv_a": ((d, m.cache_dim), ("dense", d, 1.0)),
        "kv_a_norm": ((r,), ("zeros",)),
        "wkv_b_k": ((r, h, m.qk_nope_head_dim), ("dense", r, 1.0)),
        "wkv_b_v": ((r, h, m.v_head_dim), ("dense", r, 1.0)),
        "wo": ((h * m.v_head_dim, d),
               ("dense", h * m.v_head_dim, out_scale)),
        "mlp_norm": ((d,), ("zeros",)),
    }
    if m.q_lora_rank is None:
        shapes["wq"] = ((d, h * m.qk_head_dim), ("dense", d, 1.0))
    else:
        shapes["wq_a"] = ((d, m.q_lora_rank), ("dense", d, 1.0))
        shapes["q_a_norm"] = ((m.q_lora_rank,), ("zeros",))
        shapes["wq_b"] = ((m.q_lora_rank, h * m.qk_head_dim),
                          ("dense", m.q_lora_rank, 1.0))
    return shapes


def to_storage(cfg: ModelConfig, name: str, t: torch.Tensor,
               master: bool = False) -> torch.Tensor:
    """Round a master-copy value through cfg.params_dtype; unless
    `master`, store it in the dtype the forward reads it in."""
    t = t.to(cfg.params_dtype)
    if master:
        return t
    return t.to(torch.float32 if name in FP32_KEYS else cfg.compute_dtype)


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None, master: bool = False) -> Params:
    """Random parameters from `seed`, laid out as the JAX package's
    init_params lays them out (same shapes and scales; other numbers,
    since torch's generator is not JAX's). `master=True` keeps every
    leaf in cfg.params_dtype, for training."""
    cfg.validate()
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def make(name, shape, init):
        if init[0] == "zeros":
            t = torch.zeros(shape, dtype=torch.float32, device=dev)
        else:
            _, fan_in, scale = init
            t = torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=dev) * (scale * fan_in ** -0.5)
        return to_storage(cfg, name, t, master)

    flags = moe_layers(cfg)
    shapes = {flag: layer_shapes(cfg, flag) for flag in set(flags)}
    embed = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                        dtype=torch.float32, device=dev) * 0.02
    params: Params = {
        "embed": to_storage(cfg, "embed", embed, master),
        "layers": [
            {n: make(n, shp, init) for n, (shp, init) in shapes[flag].items()}
            for flag in flags
        ],
        "final_norm": make("final_norm", (cfg.d_model,), ("zeros",)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = make(
            "lm_head", (cfg.d_model, cfg.vocab_size),
            ("dense", cfg.d_model, 1.0),
        )
    return params


def _gated_act(cfg: ModelConfig):
    return swiglu if cfg.activation == "swiglu" else geglu


def _embed_tokens(cfg: ModelConfig, params: Params, tokens) -> torch.Tensor:
    cdt = cfg.compute_dtype
    x = params["embed"][tokens].to(cdt)
    if cfg.embed_scale:
        # Gemma convention; the scale is rounded to the compute dtype (on
        # the host, so no device tensor is made per call).
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=cdt))
    return x


def _proj(cfg: ModelConfig, x, w):
    """A dense projection: a compute-dtype matmul, or an int8 dot when the
    training step opted in (cfg.quant_training; the reference's `pdot`,
    :453-456)."""
    return quant_dot(x, w.to(cfg.compute_dtype), cfg.quant_training)


# The matmuls a remat policy may keep: every product for "dots"; for
# "dots_no_batch" only those without a batch dimension (the projections),
# not the batched products (the plain attention's einsums, the capacity
# buckets' expert products). An einsum without batch dimensions runs as
# a bmm of batch 1. The flash kernels and the grouped expert product are
# not dots, as `jax.checkpoint_policies` counts no Pallas call and no
# ragged dot.
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten._int_mm.default}
_BATCHED_DOTS = {torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default}


def remat_saves(policy: str, func, args) -> bool:
    """Whether `policy` keeps the output of the aten op `func` called on
    `args` through a block's recompute (the reference's `_remat_policy`,
    :404-417: checkpoint_dots and checkpoint_dots_with_no_batch_dims)."""
    if func in _DOTS:
        return True
    if func in _BATCHED_DOTS:
        return policy == "dots" or args[0].shape[0] == 1
    return False


def _remat_context(policy: str):
    """The selective-checkpoint context_fn for a remat policy."""
    if policy not in ("dots", "dots_no_batch"):
        raise ValueError(
            f"unknown remat_policy {policy!r}; have none, dots, "
            "dots_no_batch"
        )

    def choose(ctx, func, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if remat_saves(policy, func, args)
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, choose)


def _block(cfg: ModelConfig, attn_impl: str, x, lp, cos, sin, cache=None,
           fresh_cache: bool = False, attn_kind: Optional[str] = None,
           page_tables: Optional[torch.Tensor] = None, segments=None,
           kv_scales=None, moe_layer: bool = False, aux: bool = False):
    """One pre-norm transformer block. x: (B, S, D) in compute dtype.
    Returns (x, the MoE layer's aux dict, or None unless `moe_layer` and
    `aux`).

    With `cache=(cache_k, cache_v, index)` the block writes the new k/v
    at `index` (in place) and attends the cache; with fresh_cache=True
    (prefill into an empty cache) it attends the new chunk causally
    instead. With `page_tables` the cache is one layer's block pool
    (n_blocks, Hkv, bs, Dh), written and read through the tables. With
    `kv_scales=(ks, vs)` the cache (dense or paged) is int8: the new k
    (after RoPE) and v are quantized at write, values and scales, and
    decode reads dequantize them; a fresh prefill still attends the
    exact chunk, so only later reads see the int8 rounding.
    attn_kind "full" drops cfg.attn_window for this layer. `segments`
    (B, S) int32 makes cache-free attention block-diagonal. `moe_layer`
    runs the MLP half as the MoE layer (see `_block_mlp`). An MLA
    model's attention is `_mla_attention`, over a latent cache.
    """
    cdt = cfg.compute_dtype
    hx = rms_norm(x, lp["attn_norm"], cfg.norm_eps).to(cdt)
    attend = _mla_attention if cfg.mla is not None else _gqa_attention
    o = attend(cfg, attn_impl, hx, lp, cos, sin, cache, fresh_cache,
               attn_kind, page_tables, segments, kv_scales)
    o = _proj(cfg, o, lp["wo"])
    if cfg.attn_out_bias:
        o = o + lp["bo"].to(cdt)
    if cfg.post_norms:
        o = rms_norm(o, lp["post_attn_norm"], cfg.norm_eps).to(cdt)
    x = x + o
    return _block_mlp(cfg, x, lp, moe_layer=moe_layer,
                      cached=cache is not None and not fresh_cache, aux=aux)


def _gqa_attention(cfg: ModelConfig, attn_impl: str, hx, lp, cos, sin,
                   cache, fresh_cache, attn_kind, page_tables, segments,
                   kv_scales):
    """A GQA block's attention on the normed hx (B, S, D): q/k/v
    projections, RoPE, the cache write and the attention (see `_block`).
    Returns o (B, S, H * Dh) before the output projection."""
    window = None if attn_kind == "full" else cfg.attn_window
    cdt = cfg.compute_dtype
    b, s, _ = hx.shape
    h, hkv, dh = cfg.n_heads, cfg.kv_heads, cfg.dim_per_head
    q = _proj(cfg, hx, lp["wq"])
    k = _proj(cfg, hx, lp["wk"])
    v = _proj(cfg, hx, lp["wv"])
    if cfg.attn_bias:
        q = q + lp["bq"].to(cdt)
        k = k + lp["bk"].to(cdt)
        v = v + lp["bv"].to(cdt)
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, hkv, dh)
    v = v.reshape(b, s, hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps).to(cdt)
        k = rms_norm(k, lp["k_norm"], cfg.norm_eps).to(cdt)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    v = v.contiguous()
    sinks = lp["sinks"] if cfg.attn_sink else None
    akw = dict(window=window, scale=cfg.attn_scale,
               softcap=cfg.attn_softcap, sinks=sinks)
    if cache is None:
        o = attention(q, k, v, causal=cfg.causal, impl=attn_impl,
                      q_segments=segments, kv_segments=segments, **akw)
    else:
        cache_k, cache_v, index = cache
        scales = _write_cache(cache, k, v, page_tables, kv_scales)
        if fresh_cache:
            # Empty-cache prefill: attend within the new chunk only; every
            # row starts at position 0, so causal masking already excludes
            # the right-pad tail of shorter prompts.
            o = attention(q, k, v, causal=True, impl=attn_impl, **akw)
        elif page_tables is not None:
            o = paged_decode_attention(q, cache_k, cache_v, page_tables,
                                       index, impl=attn_impl, **akw,
                                       **scales)
        else:
            o = decode_attention(q, cache_k, cache_v, index, impl=attn_impl,
                                 **akw, **scales)
    return o.reshape(b, s, h * dh)


def _write_cache(cache, k, v, page_tables, kv_scales):
    """Write the new k, v (B, S, Hkv, Dh) into one layer's cache (dense or
    paged, compute dtype or int8), in place. Returns the decode
    attention's scale keywords: {} or the int8 k_scale and v_scale."""
    cache_k, cache_v, index = cache
    if kv_scales is None:
        if page_tables is not None:
            paged_update_layer(cache_k, cache_v, k, v, index, page_tables)
        else:
            update_layer(cache_k, cache_v, k, v, index)
        return {}
    ks_l, vs_l = kv_scales
    if page_tables is not None:
        quant_paged_update_layer(cache_k, cache_v, ks_l, vs_l, k, v, index,
                                 page_tables)
    else:
        quant_update_layer(cache_k, cache_v, ks_l, vs_l, k, v, index)
    return dict(k_scale=ks_l, v_scale=vs_l)


def _mla_attention(cfg: ModelConfig, attn_impl: str, hx, lp, cos, sin,
                   cache, fresh_cache, attn_kind, page_tables, segments,
                   kv_scales):
    """Multi-head latent attention (DeepSeek) on the normed hx (B, S, D).
    Returns o (B, S, H * v_head_dim) before the output projection.

    Port of the JAX package's `_mla_attention` (models/transformer.py
    :783-940), numerics as HF's DeepseekV2Attention: the qk_rope slice of
    q and the one shared key slice k_pe rotate in adjacent pairs, the
    score scale is qk_head_dim ** -0.5. Two forms:
      - expanded (the cache-free forward and a fresh prefill): the normed
        latent c expands per head into k_nope and v; k = [k_nope, k_pe],
        v padded to the qk width so the flash kernel applies, the pad
        sliced off after;
      - absorbed (decode, chunk continuations, prefix-hit suffixes): the
        cache holds ONE row per token, [c, k_pe] (kv_lora_rank + rope
        wide, cache_kv_heads 1, a zero-width v), and the queries project
        into latent space (q_nope @ W_bk, then q_pe), so attention is MQA
        against the latent with the same cache array as k AND v; the
        weighted sum's first kv_lora_rank lanes re-expand through W_bv.
        Exact algebra, and the cache is n_heads-fold smaller than the
        expanded k/v. An int8 latent cache keeps one scale a row, which
        serves both roles.
    """
    m = cfg.mla
    cdt = cfg.compute_dtype
    b, s, _ = hx.shape
    h, r = cfg.n_heads, m.kv_lora_rank
    scale = m.qk_head_dim ** -0.5
    if m.q_lora_rank is None:
        q = _proj(cfg, hx, lp["wq"])
    else:
        qa = rms_norm(_proj(cfg, hx, lp["wq_a"]), lp["q_a_norm"],
                      cfg.norm_eps).to(cdt)
        q = _proj(cfg, qa, lp["wq_b"])
    q = q.reshape(b, s, h, m.qk_head_dim)
    q_nope = q[..., :m.qk_nope_head_dim]
    q_pe = apply_rope_interleaved(q[..., m.qk_nope_head_dim:], cos, sin)
    ckv = _proj(cfg, hx, lp["wkv_a"])  # (b, s, kv_lora_rank + rope)
    c = rms_norm(ckv[..., :r], lp["kv_a_norm"], cfg.norm_eps).to(cdt)
    k_pe = apply_rope_interleaved(ckv[..., None, r:], cos, sin)  # (b,s,1,·)
    w_bk = lp["wkv_b_k"].to(cdt)  # (r, h, nope)
    w_bv = lp["wkv_b_v"].to(cdt)  # (r, h, v)

    def expanded():
        k_nope = (c @ w_bk.reshape(r, -1)).reshape(b, s, h, -1)
        v = (c @ w_bv.reshape(r, -1)).reshape(b, s, h, -1)
        k = torch.cat([k_nope, k_pe.expand(b, s, h, m.qk_rope_head_dim)],
                      dim=-1)
        qf = torch.cat([q_nope, q_pe], dim=-1)
        vp = torch.nn.functional.pad(v, (0, m.qk_head_dim - m.v_head_dim))
        o = attention(qf, k, vp, causal=True, impl=attn_impl,
                      q_segments=segments, kv_segments=segments)
        return o[..., :m.v_head_dim]

    if cache is None:
        return expanded().reshape(b, s, h * m.v_head_dim)
    latent = torch.cat([c[:, :, None, :], k_pe], dim=-1)  # (b, s, 1, ·)
    scales = _write_cache(cache, latent, latent[..., :0], page_tables,
                          kv_scales)
    if fresh_cache:
        return expanded().reshape(b, s, h * m.v_head_dim)
    if scales:
        scales["v_scale"] = scales["k_scale"]
    cache_k, _, index = cache
    q_lat = torch.cat(
        [torch.einsum("bshn,rhn->bshr", q_nope, w_bk), q_pe], dim=-1)
    if page_tables is not None:
        o_lat = paged_decode_attention(q_lat, cache_k, cache_k, page_tables,
                                       index, scale=scale, impl=attn_impl,
                                       **scales)
    else:
        o_lat = decode_attention(q_lat, cache_k, cache_k, index, scale=scale,
                                 impl=attn_impl, **scales)
    o = torch.einsum("bshr,rhv->bshv", o_lat[..., :r], w_bv)
    return o.reshape(b, s, h * m.v_head_dim)


def _block_mlp(cfg: ModelConfig, x, lp, moe_layer: bool = False,
               cached: bool = False, aux: bool = False):
    """The MLP half of a block: the gated MLP, or with `moe_layer` the
    routed experts (plus shared experts). Returns (x, aux dict or None).

    The reference's rule (`_block_mlp`, shellac_tpu/models/transformer.py
    :641): a cached continuation (`cached`: decode, a chunk continuation,
    a prefix hit's suffix) never drops, since a dropped token's FFN output
    would be zero and decode would part from prefill; a fresh prefill or a
    cache-free forward drops at capacity unless cfg.moe.dropless;
    grouped_dropless takes the sorted-segment path except when cached.
    `moe_experts` picks the path.
    """
    cdt = cfg.compute_dtype
    hx = rms_norm(x, lp["mlp_norm"], cfg.norm_eps).to(cdt)
    moe_out = None
    if moe_layer:
        m = cfg.moe
        down, aux_loss, metrics = moe_experts(cfg, hx, lp, cached, aux)
        if m.num_shared_experts > 0:
            sg = hx @ lp["w_gate_shared"].to(cdt)
            su = hx @ lp["w_up_shared"].to(cdt)
            down = down + _gated_act(cfg)(sg, su) @ lp["w_down_shared"].to(
                cdt)
        if aux:
            moe_out = {
                "aux": aux_loss,
                "balance_loss": metrics["moe_balance_loss"],
                "router_z_loss": metrics["moe_router_z_loss"],
                "dropped_frac": metrics["moe_dropped_frac"],
            }
    else:
        gate = _proj(cfg, hx, lp["w_gate"])
        up = _proj(cfg, hx, lp["w_up"])
        down = _proj(cfg, _gated_act(cfg)(gate, up), lp["w_down"])
    if cfg.post_norms:
        down = rms_norm(down, lp["post_mlp_norm"], cfg.norm_eps).to(cdt)
    return x + down, moe_out


def moe_experts(cfg: ModelConfig, hx, lp, cached: bool, aux: bool = False):
    """An MoE layer's routed experts on hx (B, S, D): (out, aux_loss,
    metrics), by `_block_mlp`'s rule (a cached call never drops).

    Where nothing may drop, the sorted-segment product computes the
    capacity-at-T buckets' function on T k rows instead of E T. On the
    card in bf16 it records into CUDA graphs (torch's fp32 grouped
    product reads its offsets on the host), so there it serves every
    dropless call; elsewhere the reference's choice stands (the buckets,
    or the grouped path under grouped_dropless off the cached path).
    """
    m = cfg.moe
    # Strict lookups: a missing bias is a KeyError, not a silent zero.
    bias_kw = dict(
        b_router=(lp["b_router"]
                  if m.scoring in ("sigmoid", "softmax_topk") else None),
        b_gate=lp["b_gate"] if m.expert_bias else None,
        b_up=lp["b_up"] if m.expert_bias else None,
        b_down=lp["b_down"] if m.expert_bias else None,
    )
    args = (hx, lp["w_router"], lp["w_gate"], lp["w_up"], lp["w_down"], m)
    drop = not (cached or m.dropless)
    if (m.grouped_dropless and not cached) or (
            not drop and hx.is_cuda and hx.dtype == torch.bfloat16):
        return moe_ffn_grouped(*args, aux=aux, **bias_kw)
    return moe_ffn(*args, drop_tokens=drop, aux=aux, **bias_kw)


def _layer_kind(cfg: ModelConfig, i: int) -> Optional[str]:
    if cfg.attn_pattern is None:
        return None
    return cfg.attn_pattern[i % len(cfg.attn_pattern)]


def _rope_tables(cfg: ModelConfig, positions):
    """(cos, sin) for every layer, plus the Gemma-3 local-layer pair."""
    cos, sin = rope_angles(positions, cfg.rope_dim, cfg.rope_theta,
                           yarn=cfg.rope_yarn, llama3=cfg.rope_llama3,
                           linear=cfg.rope_linear)
    if cfg.rope_local_theta is not None:
        local = rope_angles(positions, cfg.rope_dim, cfg.rope_local_theta)
    else:
        local = None
    return (cos, sin), local


def _layer_rope(cfg, i, tables, local):
    if local is not None and _layer_kind(cfg, i) == "window":
        return local
    return tables


def output_weights(cfg: ModelConfig, params: Params) -> torch.Tensor:
    """The LM-head matrix (D, V) in compute dtype (tied or untied),
    rounded through it from a master copy as the JAX package's
    `output_weights(cfg, params, cdt)` does."""
    cdt = cfg.compute_dtype
    if cfg.tie_embeddings:
        return params["embed"].to(cdt).t()
    return params["lm_head"].to(cdt)


@contextlib.contextmanager
def _tf32_matmuls():
    """cuBLAS may take TF32 for fp32 products inside the block only."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


class LMHeadFunction(torch.autograd.Function):
    """logits (N, V) fp32 = x (N, D) @ w (D, V), both bf16: the JAX
    package's einsum with preferred_element_type=float32, and its
    transpose as `jax.make_jaxpr(jax.grad(...))` shows it: dx and dw are
    each a product of the fp32 cotangent with the other bf16 operand,
    summed in fp32 and rounded to bf16.

    On the card the three products run on the tensor cores: the forward
    from the bf16 operands with an fp32 result (`torch.mm(...,
    out_dtype=torch.float32)`), the two backward products in TF32, which
    holds the bf16 operand exactly and the fp32 cotangent to 10 mantissa
    bits. On the CPU all three are fp32 products.
    """

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.is_cuda:
            return torch.mm(x, w, out_dtype=torch.float32)
        return x.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        with _tf32_matmuls() if g.is_cuda else contextlib.nullcontext():
            if ctx.needs_input_grad[0]:
                dx = (g @ w.float().t()).to(x.dtype)
            if ctx.needs_input_grad[1]:
                # In w's own layout, as torch's mm backward gives it: a
                # tied head's w is the transposed embedding, whose
                # gradient must come back contiguous for the optimizer's
                # fused multi-tensor passes.
                if w.stride(0) == 1 and w.stride(1) != 1:
                    dw = (g.t() @ x.float()).to(w.dtype).t()
                else:
                    dw = (x.float().t() @ g).to(w.dtype)
        return dx, dw


def unembed(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Final RMSNorm + output projection (+ logit softcap); fp32 logits.

    The product accumulates in fp32 from compute-dtype operands, as the
    JAX package's preferred_element_type=float32 einsum does: in bf16
    through `LMHeadFunction` (tensor cores on the card), in fp32 as an
    fp32 product.
    """
    cdt = cfg.compute_dtype
    x = rms_norm(x, params["final_norm"], cfg.norm_eps).to(cdt)
    w = output_weights(cfg, params)
    if cdt == torch.bfloat16:
        lead = x.shape[:-1]
        logits = LMHeadFunction.apply(x.reshape(-1, x.shape[-1]), w)
        logits = logits.reshape(*lead, w.shape[-1])
    else:
        logits = x.float() @ w.float()
    if cfg.logit_softcap is not None:
        logits = softcap(logits, cfg.logit_softcap)
    return logits


def _params_device(params: Params) -> torch.device:
    return params["embed"].device


def segment_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """Per-segment position ids: restart at 0 on every segment change.

    segment_ids: (B, S) int, non-decreasing along S within a row. Port of
    `segment_positions` (shellac_tpu/models/transformer.py:943).
    """
    b, s = segment_ids.shape
    ar = torch.arange(s, device=segment_ids.device).expand(b, s)
    changed = torch.cat(
        [torch.ones((b, 1), dtype=torch.bool, device=segment_ids.device),
         segment_ids[:, 1:] != segment_ids[:, :-1]], dim=1,
    )
    start = torch.cummax(torch.where(changed, ar, 0), dim=1).values
    return ar - start


def forward(
    cfg: ModelConfig,
    params: Params,
    tokens,  # (B, S) int
    *,
    positions: Optional[torch.Tensor] = None,  # (B, S) int
    segment_ids: Optional[torch.Tensor] = None,  # (B, S) int — packed docs
    attn_impl: str = "auto",
    device: DeviceLike = None,
    return_aux: bool = False,
    return_hidden: bool = False,
):
    """Full forward pass; returns fp32 logits (B, S, V).

    With return_hidden=True it skips the LM head and returns the
    post-final-norm hidden states (B, S, D) in compute dtype, the seam
    the fused (vocab-chunked) loss uses (the reference's :973-976).

    With segment_ids, rows hold several packed documents: attention is
    block-diagonal over them and RoPE positions restart per segment, so
    each document computes as if it were alone in its row. Under autograd
    with cfg.remat, every block is recomputed in the backward pass.
    With return_aux=True, returns (logits, aux), aux a dict of fp32
    scalars as the reference's (:968, :983): "aux", the MoE auxiliary
    loss summed over the MoE layers (0 for a dense model), and the
    balance loss, router z loss and dropped fraction, each a mean over
    the layers that have a router.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    check_on(dev, embed=params["embed"])
    tokens = torch.as_tensor(tokens, device=dev)
    b, s = tokens.shape
    segments = None
    if segment_ids is not None:
        segments = torch.as_tensor(segment_ids, device=dev).to(
            torch.int32).contiguous()
    if positions is None:
        if segments is not None:
            positions = segment_positions(segments)
        else:
            positions = torch.arange(s, device=dev).expand(b, s)
    else:
        positions = torch.as_tensor(positions, device=dev)
    remat = cfg.remat and torch.is_grad_enabled()
    remat_kw = {}
    if remat and cfg.remat_policy != "none":
        remat_kw["context_fn"] = _remat_context(cfg.remat_policy)
    tables, local = _rope_tables(cfg, positions)
    x = _embed_tokens(cfg, params, tokens)
    flags = moe_layers(cfg)
    acc = None
    for i, lp in enumerate(params["layers"]):
        cos, sin = _layer_rope(cfg, i, tables, local)
        blk = functools.partial(_block, cfg, attn_impl,
                                attn_kind=_layer_kind(cfg, i),
                                segments=segments, moe_layer=flags[i],
                                aux=return_aux)
        if remat:
            x, mo = checkpoint(blk, x, lp, cos, sin, use_reentrant=False,
                               **remat_kw)
        else:
            x, mo = blk(x, lp, cos, sin)
        if mo is not None:
            acc = mo if acc is None else {k: acc[k] + mo[k] for k in acc}
    if return_hidden:
        out = rms_norm(x, params["final_norm"], cfg.norm_eps).to(
            cfg.compute_dtype)
    else:
        out = unembed(cfg, params, x)
    if not return_aux:
        return out
    return out, _mean_aux(cfg, acc, sum(flags), dev)


def _mean_aux(cfg: ModelConfig, acc, routers: int, dev) -> Dict[str, Any]:
    """The summed aux loss and the per-router-layer diagnostics, scaled as
    the reference scales each layout (a dense model's are all 0)."""
    if acc is None:
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        return {k: zero for k in AUX_KEYS}
    if cfg.first_k_dense > 0:
        return {k: v if k == "aux" else v / routers for k, v in acc.items()}
    inv = cfg.moe_every / cfg.n_layers
    return {k: v if k == "aux" else v * inv for k, v in acc.items()}


def forward_with_cache(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,  # (B, S) int — new tokens only
    cache,  # KVCache, PagedKVCache, QuantKVCache or QuantPagedKVCache
    *,
    new_tokens_len: Optional[torch.Tensor] = None,  # (B,) valid counts
    fresh_cache: bool = False,
    attn_impl: str = "auto",
):
    """Incremental forward: consumes `tokens` starting at cache.lengths.

    Returns (logits (B, S, V) fp32, cache). Used for prefill (S =
    padded prompt length, empty cache, new_tokens_len = real prompt
    lengths) and decode (S = 1). The cache's k/v are written in place;
    the returned cache shares them and carries the new lengths
    (index + new_tokens_len, or index + S). A paged cache is written and
    read through its block tables; an int8 cache's values and scales are
    written per layer (quantized after RoPE) and shared the same way. Raises ValueError before writing when
    a write would pass max_len (the positions a slot can address),
    judged by the cache's host-side `max_length`.
    """
    check_supported(cfg)
    if not cfg.causal:
        raise ValueError(
            "KV-cache generation requires a causal model (cfg.causal=True)"
        )
    dev = cache.k.device
    check_on(dev, embed=params["embed"], tokens=tokens)
    b, s = tokens.shape
    if cache.max_length + s > cache.max_len:
        raise ValueError(
            f"cache write of {s} positions at length {cache.max_length} "
            f"passes max_len={cache.max_len}"
        )
    index = cache.lengths
    positions = index[:, None].to(torch.int64) + torch.arange(
        s, device=dev
    )[None, :]
    tables, local = _rope_tables(cfg, positions)
    page_tables = (cache.tables
                   if isinstance(cache, (PagedKVCache, QuantPagedKVCache))
                   else None)
    quant = cache_quant(cache) is not None
    x = _embed_tokens(cfg, params, tokens)
    for i, (lp, moe) in enumerate(zip(params["layers"], moe_layers(cfg))):
        cos, sin = _layer_rope(cfg, i, tables, local)
        x, _ = _block(cfg, attn_impl, x, lp, cos, sin,
                      cache=(cache.k[i], cache.v[i], index),
                      fresh_cache=fresh_cache, attn_kind=_layer_kind(cfg, i),
                      page_tables=page_tables,
                      kv_scales=(cache.ks[i], cache.vs[i]) if quant else None,
                      moe_layer=moe)
    logits = unembed(cfg, params, x)
    if new_tokens_len is None:
        new_lengths = index + s
        grown = s
    else:
        new_tokens_len = torch.as_tensor(new_tokens_len, device=dev)
        new_lengths = index + new_tokens_len.to(torch.int32)
        grown = int(new_tokens_len.max())
    return logits, cache.replace(
        lengths=new_lengths.to(torch.int32),
        max_length=cache.max_length + grown,
    )


def num_params(params: Params) -> int:
    n = sum(t.numel() for k, t in params.items() if k != "layers")
    return n + sum(t.numel() for lp in params["layers"] for t in lp.values())
