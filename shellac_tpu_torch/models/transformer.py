"""Decoder-only transformer (LLaMA-style): the dense GQA path in PyTorch.

The port of the JAX package's `models/transformer.py` for dense models
(no MoE, no MLA). Parameters are a plain dictionary:

    {"embed": (V, D), "layers": [per-layer dict, ...], "final_norm": (D,),
     "lm_head": (D, V) when embeddings are untied}

Layers are stored per layer (a list) and walked by a Python loop, where
the JAX package stacks them for `lax.scan`; `models/from_jax.py` converts
between the two. Storage dtypes follow what the JAX forward computes
with: matmul weights, embeddings and biases are kept in the compute
dtype (the JAX forward casts its fp32 master copy at every use, so one
cast at load is exact), while norm scales and attention sinks stay fp32
because the JAX forward reads them as fp32.

Compute: bf16 matmuls, fp32 norm statistics, softmax and logits, a bf16
residual stream, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from shellac_tpu_torch.config import ModelConfig
from shellac_tpu_torch.inference.cache.layout import (
    PagedKVCache,
    paged_update_layer,
    update_layer,
)
from shellac_tpu_torch.ops.activations import geglu, softcap, swiglu
from shellac_tpu_torch.ops.attention import attention
from shellac_tpu_torch.ops.decode_attention import (
    decode_attention,
    paged_decode_attention,
)
from shellac_tpu_torch.ops.dispatch import DeviceLike, check_on, resolve_device
from shellac_tpu_torch.ops.norms import rms_norm
from shellac_tpu_torch.ops.rope import apply_rope, rope_angles

Params = Dict[str, Any]

# Parameters the JAX forward reads in fp32 (norm scales, sinks); every
# other parameter is stored in the compute dtype.
FP32_KEYS = frozenset({
    "attn_norm", "mlp_norm", "final_norm", "q_norm", "k_norm",
    "post_attn_norm", "post_mlp_norm", "sinks",
})


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for configurations the port lacks."""
    if cfg.moe is not None:
        raise NotImplementedError("MoE models are not ported yet")
    if cfg.mla is not None:
        raise NotImplementedError("MLA models are not ported yet")
    if cfg.quant_training is not None:
        raise NotImplementedError("quantized training dots are not ported")
    if cfg.activation not in ("swiglu", "geglu"):
        raise ValueError(
            f"unknown activation {cfg.activation!r}; have swiglu, geglu"
        )


def layer_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """name -> (shape, init) for one dense layer, in the JAX package's
    order. init is ("dense", fan_in, scale) or ("zeros",)."""
    d, h, hkv, dh, f = (
        cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.dim_per_head, cfg.ff_dim,
    )
    out_scale = (2 * cfg.n_layers) ** -0.5
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
    shapes["w_gate"] = ((d, f), ("dense", d, 1.0))
    shapes["w_up"] = ((d, f), ("dense", d, 1.0))
    shapes["w_down"] = ((f, d), ("dense", f, out_scale))
    return shapes


def to_storage(cfg: ModelConfig, name: str, t: torch.Tensor) -> torch.Tensor:
    """Round a master-copy value through cfg.params_dtype, then store it
    in the dtype the forward reads it in."""
    dtype = torch.float32 if name in FP32_KEYS else cfg.compute_dtype
    return t.to(cfg.params_dtype).to(dtype)


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Params:
    """Random parameters from `seed`, laid out as the JAX package's
    init_params lays them out (same shapes and scales; other numbers,
    since torch's generator is not JAX's)."""
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
        return to_storage(cfg, name, t)

    shapes = layer_shapes(cfg)
    embed = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                        dtype=torch.float32, device=dev) * 0.02
    params: Params = {
        "embed": to_storage(cfg, "embed", embed),
        "layers": [
            {n: make(n, shp, init) for n, (shp, init) in shapes.items()}
            for _ in range(cfg.n_layers)
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


def _block(cfg: ModelConfig, attn_impl: str, x, lp, cos, sin, cache=None,
           fresh_cache: bool = False, attn_kind: Optional[str] = None,
           page_tables: Optional[torch.Tensor] = None):
    """One pre-norm transformer block. x: (B, S, D) in compute dtype.

    With `cache=(cache_k, cache_v, index)` the block writes the new k/v
    at `index` (in place) and attends the cache; with fresh_cache=True
    (prefill into an empty cache) it attends the new chunk causally
    instead. With `page_tables` the cache is one layer's block pool
    (n_blocks, Hkv, bs, Dh), written and read through the tables.
    attn_kind "full" drops cfg.attn_window for this layer.
    """
    window = None if attn_kind == "full" else cfg.attn_window
    cdt = cfg.compute_dtype
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.kv_heads, cfg.dim_per_head

    hx = rms_norm(x, lp["attn_norm"], cfg.norm_eps).to(cdt)
    q = hx @ lp["wq"]
    k = hx @ lp["wk"]
    v = hx @ lp["wv"]
    if cfg.attn_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
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
        o = attention(q, k, v, causal=cfg.causal, impl=attn_impl, **akw)
    else:
        cache_k, cache_v, index = cache
        if page_tables is not None:
            paged_update_layer(cache_k, cache_v, k, v, index, page_tables)
        else:
            update_layer(cache_k, cache_v, k, v, index)
        if fresh_cache:
            # Empty-cache prefill: attend within the new chunk only; every
            # row starts at position 0, so causal masking already excludes
            # the right-pad tail of shorter prompts.
            o = attention(q, k, v, causal=True, impl=attn_impl, **akw)
        elif page_tables is not None:
            o = paged_decode_attention(q, cache_k, cache_v, page_tables,
                                       index, impl=attn_impl, **akw)
        else:
            o = decode_attention(q, cache_k, cache_v, index, impl=attn_impl,
                                 **akw)
    o = o.reshape(b, s, h * dh) @ lp["wo"]
    if cfg.attn_out_bias:
        o = o + lp["bo"]
    if cfg.post_norms:
        o = rms_norm(o, lp["post_attn_norm"], cfg.norm_eps).to(cdt)
    x = x + o
    return _block_mlp(cfg, x, lp)


def _block_mlp(cfg: ModelConfig, x, lp):
    """The dense MLP half of a block."""
    cdt = cfg.compute_dtype
    hx = rms_norm(x, lp["mlp_norm"], cfg.norm_eps).to(cdt)
    gate = hx @ lp["w_gate"]
    up = hx @ lp["w_up"]
    down = _gated_act(cfg)(gate, up) @ lp["w_down"]
    if cfg.post_norms:
        down = rms_norm(down, lp["post_mlp_norm"], cfg.norm_eps).to(cdt)
    return x + down


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
    """The LM-head matrix (D, V) in compute dtype (tied or untied)."""
    if cfg.tie_embeddings:
        return params["embed"].t()
    return params["lm_head"]


def unembed(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Final RMSNorm + output projection (+ logit softcap); fp32 logits.

    The product accumulates in fp32 from compute-dtype operands, as the
    JAX package's preferred_element_type=float32 einsum does.
    """
    cdt = cfg.compute_dtype
    x = rms_norm(x, params["final_norm"], cfg.norm_eps).to(cdt)
    logits = x.float() @ output_weights(cfg, params).float()
    if cfg.logit_softcap is not None:
        logits = softcap(logits, cfg.logit_softcap)
    return logits


def _params_device(params: Params) -> torch.device:
    return params["embed"].device


def forward(
    cfg: ModelConfig,
    params: Params,
    tokens,  # (B, S) int
    *,
    positions: Optional[torch.Tensor] = None,  # (B, S) int
    segment_ids: Optional[torch.Tensor] = None,
    attn_impl: str = "auto",
    device: DeviceLike = None,
) -> torch.Tensor:
    """Full forward pass; returns fp32 logits (B, S, V)."""
    check_supported(cfg)
    if segment_ids is not None:
        raise NotImplementedError("packed segment_ids are not ported yet")
    dev = resolve_device(device)
    check_on(dev, embed=params["embed"])
    tokens = torch.as_tensor(tokens, device=dev)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=dev).expand(b, s)
    else:
        positions = torch.as_tensor(positions, device=dev)
    tables, local = _rope_tables(cfg, positions)
    x = _embed_tokens(cfg, params, tokens)
    for i, lp in enumerate(params["layers"]):
        cos, sin = _layer_rope(cfg, i, tables, local)
        x = _block(cfg, attn_impl, x, lp, cos, sin,
                   attn_kind=_layer_kind(cfg, i))
    return unembed(cfg, params, x)


def forward_with_cache(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,  # (B, S) int — new tokens only
    cache,  # KVCache or PagedKVCache
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
    (index + new_tokens_len, or index + S). A PagedKVCache is written and
    read through its block tables. Raises ValueError before writing when
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
    page_tables = cache.tables if isinstance(cache, PagedKVCache) else None
    x = _embed_tokens(cfg, params, tokens)
    for i, lp in enumerate(params["layers"]):
        cos, sin = _layer_rope(cfg, i, tables, local)
        x = _block(cfg, attn_impl, x, lp, cos, sin,
                   cache=(cache.k[i], cache.v[i], index),
                   fresh_cache=fresh_cache, attn_kind=_layer_kind(cfg, i),
                   page_tables=page_tables)
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
