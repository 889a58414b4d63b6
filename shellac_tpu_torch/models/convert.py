"""HuggingFace checkpoints in and out of the port.

The port of `shellac_tpu/models/convert.py`: `config_from_hf` (:30) with
its family mappings (`_gemma2_config` :145, `_gemma3_config` :189,
`_gptoss_config` :262, `_rope_from_hf` :447, `_hf_attn_window` :499,
`_norm_offset` :527), `params_from_state_dict` (:610), `to_state_dict`
(:861) and `from_hf` (:1026), DeepSeek-V2/V3 (MLA) included:
`_deepseek_config` (:321), the latent attention's weights
(`_collect_mla_layer` :560) and the first-k-dense layout's
(`_first_k_params` :792). As in the reference, an MLA model with MoE
layers imports but does not export (no HF architecture holds DeepSeek
attention beside Mixtral experts); a dense-MLP MLA model exports.

The reference reads a `transformers` config object and state dict; the
port depends on no `transformers`, so a directory is read here directly:
`config.json` through `read_hf_config` (which fills, per model_type, the
defaults and derived values the `transformers` (4.57) config class
would), and the weights through `utils/safetensors.py`. A `transformers`
model instance is still accepted where that package imports (the
tests' case).

Layout: torch `nn.Linear` stores (out, in), the port (in, out); HF RMSNorm
multiplies by w where the port applies (1 + s), so s = w + norm_offset,
added in fp32 before any rounding to the storage dtype, as the reference
adds it in fp32 numpy before its cast. Parameters come out in the port's
per-layer list layout (models/transformer.py), in serving storage, or
with `master=True` every leaf in cfg.params_dtype.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional

import torch

from shellac_tpu_torch.config import (
    Llama3RopeConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    YarnConfig,
)
from shellac_tpu_torch.models.transformer import (
    Params,
    check_supported,
    layer_shapes,
    moe_layers,
    to_storage,
)
from shellac_tpu_torch.ops.dispatch import DeviceLike, resolve_device

# ---------------------------------------------------------------- config.json

# model_type -> the defaults of every key the mapping reads, as each
# `transformers` (4.57) config class's __init__ sets them. A key the class
# does not define is left out, so the mapping's own getattr default holds.
_HF_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "llama": dict(
        num_attention_heads=32, head_dim=None, hidden_size=4096,
        vocab_size=32000, num_hidden_layers=32, num_key_value_heads=None,
        intermediate_size=11008, max_position_embeddings=2048,
        rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=False,
        attention_bias=False, rope_scaling=None),
    "mistral": dict(
        num_attention_heads=32, head_dim=None, hidden_size=4096,
        vocab_size=32000, num_hidden_layers=32, num_key_value_heads=8,
        intermediate_size=14336, max_position_embeddings=131072,
        rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=False,
        sliding_window=4096),
    "mixtral": dict(
        num_attention_heads=32, head_dim=None, hidden_size=4096,
        num_local_experts=8, num_experts_per_tok=2,
        router_aux_loss_coef=0.001, vocab_size=32000, num_hidden_layers=32,
        num_key_value_heads=8, intermediate_size=14336,
        max_position_embeddings=131072, rope_theta=1e6, rms_norm_eps=1e-5,
        tie_word_embeddings=False, sliding_window=None),
    "qwen2": dict(
        num_attention_heads=32, hidden_size=4096, vocab_size=151936,
        num_hidden_layers=32, num_key_value_heads=32,
        intermediate_size=22016, max_position_embeddings=32768,
        rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=False,
        rope_scaling=None, sliding_window=4096, use_sliding_window=False,
        max_window_layers=28, layer_types=None),
    "qwen3": dict(
        num_attention_heads=32, head_dim=128, hidden_size=4096,
        vocab_size=151936, num_hidden_layers=32, num_key_value_heads=32,
        intermediate_size=22016, max_position_embeddings=32768,
        rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=False,
        attention_bias=False, rope_scaling=None, sliding_window=4096,
        use_sliding_window=False, max_window_layers=28, layer_types=None),
    "qwen3_moe": dict(
        num_attention_heads=32, hidden_size=2048, num_experts_per_tok=8,
        router_aux_loss_coef=0.001, mlp_only_layers=None,
        decoder_sparse_step=1, num_experts=128, moe_intermediate_size=768,
        norm_topk_prob=False, vocab_size=151936, num_hidden_layers=24,
        num_key_value_heads=4, intermediate_size=6144,
        max_position_embeddings=32768, rope_theta=10000.0,
        rms_norm_eps=1e-6, tie_word_embeddings=False, attention_bias=False,
        rope_scaling=None, sliding_window=4096, use_sliding_window=False),
    "phi3": dict(
        num_attention_heads=32, hidden_size=3072, partial_rotary_factor=1.0,
        vocab_size=32064, num_hidden_layers=32, num_key_value_heads=None,
        intermediate_size=8192, max_position_embeddings=4096,
        rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False,
        rope_scaling=None, sliding_window=None),
    "gemma": dict(
        num_attention_heads=16, head_dim=256, hidden_size=3072,
        vocab_size=256000, num_hidden_layers=28, num_key_value_heads=16,
        intermediate_size=24576, max_position_embeddings=8192,
        rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=True,
        attention_bias=False),
    "gemma2": dict(
        num_attention_heads=8, head_dim=256, hidden_size=2304,
        vocab_size=256000, num_hidden_layers=26, num_key_value_heads=4,
        intermediate_size=9216, max_position_embeddings=8192,
        rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=True,
        attention_bias=False, sliding_window=4096, layer_types=None,
        query_pre_attn_scalar=256, attn_logit_softcapping=50.0,
        final_logit_softcapping=30.0),
    "gemma3_text": dict(
        num_attention_heads=8, head_dim=256, hidden_size=2304,
        vocab_size=262208, num_hidden_layers=26, num_key_value_heads=4,
        intermediate_size=9216, max_position_embeddings=131072,
        rope_theta=1e6, rms_norm_eps=1e-6, tie_word_embeddings=True,
        attention_bias=False, rope_scaling=None, sliding_window=4096,
        layer_types=None, query_pre_attn_scalar=256,
        attn_logit_softcapping=None, final_logit_softcapping=None,
        rope_local_base_freq=10000.0, use_bidirectional_attention=False),
    "gpt_oss": dict(
        num_attention_heads=64, head_dim=64, hidden_size=2880,
        num_local_experts=128, num_experts_per_tok=4,
        router_aux_loss_coef=0.9, vocab_size=201088, num_hidden_layers=36,
        num_key_value_heads=8, intermediate_size=2880,
        max_position_embeddings=131072, rope_theta=150000.0,
        rms_norm_eps=1e-5, tie_word_embeddings=False,
        rope_scaling={"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
                      "beta_slow": 1.0, "truncate": False,
                      "original_max_position_embeddings": 4096},
        sliding_window=128, layer_types=None, attention_bias=True),
    # DeepSeek, as transformers' DeepseekV2Config and DeepseekV3Config set
    # their defaults (V2 keeps no scoring_func or moe_layer_freq: the
    # mapping's getattr defaults hold).
    "deepseek_v2": dict(
        vocab_size=32000, hidden_size=4096, intermediate_size=11008,
        moe_intermediate_size=1407, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=32, n_shared_experts=2,
        n_routed_experts=64, routed_scaling_factor=1.0, kv_lora_rank=512,
        q_lora_rank=1536, qk_rope_head_dim=64, v_head_dim=128,
        qk_nope_head_dim=128, topk_method="greedy", n_group=None,
        topk_group=None, num_experts_per_tok=None, first_k_dense_replace=0,
        norm_topk_prob=False, max_position_embeddings=2048, rms_norm_eps=1e-6,
        tie_word_embeddings=False, rope_theta=10000.0, rope_scaling=None,
        attention_bias=False),
    "deepseek_v3": dict(
        vocab_size=129280, hidden_size=7168, intermediate_size=18432,
        moe_intermediate_size=2048, num_hidden_layers=61,
        num_attention_heads=128, num_key_value_heads=128, n_shared_experts=1,
        n_routed_experts=256, routed_scaling_factor=2.5, kv_lora_rank=512,
        q_lora_rank=1536, qk_rope_head_dim=64, v_head_dim=128,
        qk_nope_head_dim=128, n_group=8, topk_group=4, num_experts_per_tok=8,
        first_k_dense_replace=3, norm_topk_prob=True,
        max_position_embeddings=4096, rms_norm_eps=1e-6,
        tie_word_embeddings=False, rope_theta=10000.0, rope_scaling=None,
        attention_bias=False),
}
_MLA_TYPES = ("deepseek_v2", "deepseek_v3")


class HFConfig:
    """The attributes of an HF `config.json`, as its `transformers` class
    would hold them: the file's keys over the class defaults, then the
    values the class derives in its __init__. A key neither gives is
    absent (getattr with a default sees its default)."""

    def __init__(self, raw: Dict[str, Any]):
        mt = raw.get("model_type")
        if mt is None:
            raise ValueError("config.json has no model_type")
        if mt == "gemma3":
            text = dict(raw.get("text_config") or {})
            if not raw.get("text_config"):
                raise NotImplementedError(
                    "gemma3 config without a text_config (vision-only?)")
            self.__dict__.update(model_type="gemma3",
                                 text_config=HFConfig(
                                     {**text, "model_type": "gemma3_text"}))
            return
        if mt not in _HF_DEFAULTS:
            raise NotImplementedError(
                f"model_type {mt!r} is not mapped (have "
                f"{', '.join(sorted(_HF_DEFAULTS))})")
        d = {**_HF_DEFAULTS[mt], **raw}
        if d.get("rope_scaling"):
            d["rope_scaling"] = dict(d["rope_scaling"])
        n_layers = d["num_hidden_layers"]
        if mt in ("llama", "phi3", "qwen2", "gpt_oss") and \
                d["num_key_value_heads"] is None:
            d["num_key_value_heads"] = d["num_attention_heads"]
        if mt in ("llama", "gpt_oss") and d["head_dim"] is None:
            d["head_dim"] = d["hidden_size"] // d["num_attention_heads"]
        rs = d.get("rope_scaling")
        if rs and "type" in rs and mt != "phi3":
            rs["rope_type"] = rs["type"]
        if mt == "phi3" and rs and rs.get("type") in ("su", "yarn"):
            rs["type"] = "longrope"
        if mt in ("qwen2", "qwen3", "qwen3_moe"):
            if not d["use_sliding_window"]:
                d["sliding_window"] = None
        if mt in ("qwen2", "qwen3") and d["layer_types"] is None:
            d["layer_types"] = [
                "sliding_attention" if d["sliding_window"] is not None
                and i >= d["max_window_layers"] else "full_attention"
                for i in range(n_layers)]
        if mt == "qwen3_moe" and d["mlp_only_layers"] is None:
            d["mlp_only_layers"] = []
        if mt in ("gemma2", "gpt_oss") and d["layer_types"] is None:
            d["layer_types"] = [
                "sliding_attention" if (i + 1) % 2 else "full_attention"
                for i in range(n_layers)]
        if mt == "gemma3_text":
            if d["use_bidirectional_attention"]:
                d["sliding_window"] = d["sliding_window"] // 2 + 1
            if d["layer_types"] is None:
                p = d.get("sliding_window_pattern", 6)
                d["layer_types"] = [
                    "sliding_attention" if (i + 1) % p else "full_attention"
                    for i in range(n_layers)]
        self.__dict__.update(d)


def read_hf_config(path: str) -> HFConfig:
    """An HF checkpoint directory's (or a file's) config.json."""
    if os.path.isdir(path):
        path = os.path.join(path, "config.json")
    with open(path) as f:
        return HFConfig(json.load(f))


# ------------------------------------------------------------ config mapping


def config_from_hf(hf_cfg) -> ModelConfig:
    """ModelConfig from an HF config: a `transformers` config object, an
    `HFConfig`, or a checkpoint directory (its config.json).

    Mistral's sliding window maps to attn_window; Mixtral's experts map
    to a dropless MoEConfig (exact top-k computation, no capacity drops)
    with every layer MoE.
    """
    if isinstance(hf_cfg, (str, os.PathLike)):
        hf_cfg = read_hf_config(os.fspath(hf_cfg))
    model_type = getattr(hf_cfg, "model_type", "")
    n_heads = hf_cfg.num_attention_heads
    head_dim = getattr(hf_cfg, "head_dim", None) or (
        hf_cfg.hidden_size // n_heads
    )
    is_gemma = model_type == "gemma"
    if model_type in _MLA_TYPES:
        return _deepseek_config(hf_cfg)
    if model_type == "gemma2":
        return _gemma2_config(hf_cfg)
    if model_type in ("gemma3_text", "gemma3"):
        return _gemma3_config(hf_cfg)
    if model_type == "gpt_oss":
        return _gptoss_config(hf_cfg)
    moe = None
    if getattr(hf_cfg, "num_local_experts", None):
        moe = MoEConfig(
            num_experts=hf_cfg.num_local_experts,
            num_experts_per_token=hf_cfg.num_experts_per_tok,
            router_aux_loss_weight=getattr(
                hf_cfg, "router_aux_loss_coef", 0.01
            ),
            dropless=True,
        )
    if model_type == "phi3":
        if getattr(hf_cfg, "partial_rotary_factor", 1.0) != 1.0:
            raise NotImplementedError(
                "phi3 partial_rotary_factor != 1 is not supported"
            )
    is_qwen3 = model_type in ("qwen3", "qwen3_moe")
    if model_type == "qwen3_moe":
        if getattr(hf_cfg, "mlp_only_layers", None):
            raise NotImplementedError(
                "qwen3_moe with mlp_only_layers is a mixed layout we "
                "cannot represent uniformly"
            )
        if getattr(hf_cfg, "decoder_sparse_step", 1) != 1:
            raise NotImplementedError(
                "qwen3_moe decoder_sparse_step != 1 is not representable"
            )
        moe = MoEConfig(
            num_experts=hf_cfg.num_experts,
            num_experts_per_token=hf_cfg.num_experts_per_tok,
            d_ff_expert=hf_cfg.moe_intermediate_size,
            # HF Qwen3MoeConfig defaults norm_topk_prob to False.
            norm_topk_prob=bool(getattr(hf_cfg, "norm_topk_prob", False)),
            router_aux_loss_weight=getattr(
                hf_cfg, "router_aux_loss_coef", 0.01
            ),
            dropless=True,
        )
    return ModelConfig(
        vocab_size=hf_cfg.vocab_size,
        d_model=hf_cfg.hidden_size,
        n_layers=hf_cfg.num_hidden_layers,
        n_heads=n_heads,
        n_kv_heads=getattr(hf_cfg, "num_key_value_heads", None) or n_heads,
        head_dim=head_dim,
        d_ff=hf_cfg.intermediate_size,
        max_seq_len=hf_cfg.max_position_embeddings,
        rope_theta=getattr(hf_cfg, "rope_theta", 10000.0),
        norm_eps=hf_cfg.rms_norm_eps,
        tie_embeddings=bool(getattr(hf_cfg, "tie_word_embeddings", False)),
        attn_window=_hf_attn_window(hf_cfg),
        moe=moe,
        # Gemma: tanh-GeGLU MLP, sqrt(d)-scaled embeddings, and its
        # RMSNorm is already the (1+w) form ours uses.
        activation="geglu" if is_gemma else "swiglu",
        embed_scale=is_gemma,
        # Qwen2 puts biases on q/k/v; Qwen3 dropped them in favour of
        # per-head-dim q/k RMSNorm.
        attn_bias=bool(
            getattr(hf_cfg, "attention_bias", False)
            or model_type == "qwen2"
        ),
        qk_norm=is_qwen3,
        **_rope_from_hf(
            getattr(hf_cfg, "rope_scaling", None),
            hf_cfg.max_position_embeddings,
        ),
    ).validate()


def _deepseek_config(hf_cfg) -> ModelConfig:
    """DeepSeek-V2/V3 (MLA), the reference's `_deepseek_config` (:321):
    MLA attention (yarn rope optional), the first-k-dense layout, V2's
    softmax gate (greedy or group-limited, un-normalized scaled
    probabilities: HF's V2 gate never renormalizes, whatever the config
    says) and V3's sigmoid gate (selection-only correction biases,
    normalized weights), narrow experts and shared experts. What the
    layouts cannot represent raises."""
    n_layers = hf_cfg.num_hidden_layers
    first_k = getattr(hf_cfg, "first_k_dense_replace", n_layers)
    is_v3 = getattr(hf_cfg, "model_type", "") == "deepseek_v3"
    moe = None
    if first_k < n_layers and getattr(hf_cfg, "n_routed_experts", None):
        if getattr(hf_cfg, "moe_layer_freq", 1) != 1:
            raise NotImplementedError(
                "moe_layer_freq != 1 is not representable by the "
                "first_k_dense layout")
        if first_k == 0:
            raise NotImplementedError(
                "all-MoE DeepSeek (first_k_dense_replace=0) conversion is "
                "not wired; every published checkpoint keeps >= 1 dense "
                "layer")
        common = dict(
            num_experts=hf_cfg.n_routed_experts,
            num_experts_per_token=hf_cfg.num_experts_per_tok,
            d_ff_expert=hf_cfg.moe_intermediate_size,
            num_shared_experts=getattr(hf_cfg, "n_shared_experts", 0) or 0,
            routed_scaling_factor=float(
                getattr(hf_cfg, "routed_scaling_factor", 1.0)),
            dropless=True,
        )
        if is_v3:
            declared = getattr(hf_cfg, "scoring_func", "sigmoid")
            if declared != "sigmoid":
                raise NotImplementedError(
                    f"deepseek_v3 with scoring_func={declared!r} (the HF "
                    "reference gate is sigmoid)")
            declared_tm = getattr(hf_cfg, "topk_method", "noaux_tc")
            if declared_tm != "noaux_tc":
                raise NotImplementedError(
                    f"deepseek_v3 with topk_method={declared_tm!r} (the HF "
                    "reference gate is noaux_tc)")
            moe = MoEConfig(
                scoring="sigmoid",
                norm_topk_prob=bool(getattr(hf_cfg, "norm_topk_prob", True)),
                n_group=getattr(hf_cfg, "n_group", 1) or 1,
                topk_group=getattr(hf_cfg, "topk_group", 1) or 1,
                **common,
            )
        else:
            if getattr(hf_cfg, "scoring_func", "softmax") != "softmax":
                raise NotImplementedError(
                    f"DeepSeek-V2 scoring_func={hf_cfg.scoring_func!r} "
                    "(have: softmax)")
            if getattr(hf_cfg, "topk_method", "greedy") not in (
                    "greedy", "group_limited_greedy"):
                raise NotImplementedError(
                    f"DeepSeek topk_method={hf_cfg.topk_method!r}")
            grouped = hf_cfg.topk_method == "group_limited_greedy"
            moe = MoEConfig(
                norm_topk_prob=False,
                n_group=(getattr(hf_cfg, "n_group", 1) or 1) if grouped
                else 1,
                topk_group=(getattr(hf_cfg, "topk_group", 1) or 1)
                if grouped else 1,
                **common,
            )
    elif first_k < n_layers:
        raise NotImplementedError(
            "first_k_dense_replace set but n_routed_experts missing")
    if getattr(hf_cfg, "attention_bias", False):
        raise NotImplementedError(
            "DeepSeek attention_bias=True is not supported; converting "
            "would silently drop the bias tensors")
    return ModelConfig(
        vocab_size=hf_cfg.vocab_size,
        d_model=hf_cfg.hidden_size,
        n_layers=n_layers,
        n_heads=hf_cfg.num_attention_heads,
        d_ff=hf_cfg.intermediate_size,
        max_seq_len=hf_cfg.max_position_embeddings,
        rope_theta=getattr(hf_cfg, "rope_theta", 10000.0),
        norm_eps=hf_cfg.rms_norm_eps,
        tie_embeddings=bool(getattr(hf_cfg, "tie_word_embeddings", False)),
        mla=MLAConfig(
            kv_lora_rank=hf_cfg.kv_lora_rank,
            q_lora_rank=getattr(hf_cfg, "q_lora_rank", None),
            qk_nope_head_dim=hf_cfg.qk_nope_head_dim,
            qk_rope_head_dim=hf_cfg.qk_rope_head_dim,
            v_head_dim=hf_cfg.v_head_dim,
        ),
        moe=moe,
        first_k_dense=first_k if moe is not None else 0,
        **_rope_from_hf(getattr(hf_cfg, "rope_scaling", None),
                        hf_cfg.max_position_embeddings),
    ).validate()


def _pattern_from_layer_types(layer_types) -> tuple:
    """Minimal-period attn_pattern from an HF layer_types list
    ("sliding_attention"/"full_attention" per layer); unknown kinds
    fail loudly."""
    kinds = []
    for t in layer_types:
        if t == "sliding_attention":
            kinds.append("window")
        elif t == "full_attention":
            kinds.append("full")
        else:
            raise NotImplementedError(f"unknown layer_type {t!r}")
    n = len(kinds)
    for p in range(1, n + 1):
        if n % p == 0 and all(kinds[i] == kinds[i % p] for i in range(n)):
            return tuple(kinds[:p])
    return tuple(kinds)


def _window_pattern(hf_cfg, layer_types):
    """(attn_pattern or None, windowed) as Gemma-2 and GPT-OSS map them:
    a uniform window needs no pattern, uniform full attention no window."""
    pattern = _pattern_from_layer_types(layer_types)
    windowed = "window" in pattern
    if set(pattern) == {"window"}:
        pattern = None
    elif set(pattern) == {"full"}:
        pattern, windowed = None, False
    return pattern, windowed


def _gemma2_config(hf_cfg) -> ModelConfig:
    """Gemma-2: alternating local/global attention, tanh soft-capping of
    scores and final logits, sandwich norms, the query_pre_attn_scalar
    score scale, GeGLU and sqrt(d)-scaled embeddings."""
    n_layers = hf_cfg.num_hidden_layers
    layer_types = getattr(hf_cfg, "layer_types", None) or [
        # Older configs predate layer_types; HF's fallback is sliding
        # attention on even layer indices.
        "sliding_attention" if i % 2 == 0 else "full_attention"
        for i in range(n_layers)
    ]
    pattern, windowed = _window_pattern(hf_cfg, layer_types)
    qpas = getattr(hf_cfg, "query_pre_attn_scalar", None)
    return ModelConfig(
        vocab_size=hf_cfg.vocab_size,
        d_model=hf_cfg.hidden_size,
        n_layers=n_layers,
        n_heads=hf_cfg.num_attention_heads,
        n_kv_heads=getattr(hf_cfg, "num_key_value_heads", None)
        or hf_cfg.num_attention_heads,
        head_dim=getattr(hf_cfg, "head_dim", None)
        or hf_cfg.hidden_size // hf_cfg.num_attention_heads,
        d_ff=hf_cfg.intermediate_size,
        max_seq_len=hf_cfg.max_position_embeddings,
        rope_theta=getattr(hf_cfg, "rope_theta", 10000.0),
        norm_eps=hf_cfg.rms_norm_eps,
        tie_embeddings=bool(getattr(hf_cfg, "tie_word_embeddings", True)),
        attn_window=int(hf_cfg.sliding_window) if windowed else None,
        attn_pattern=pattern,
        attn_softcap=getattr(hf_cfg, "attn_logit_softcapping", None),
        logit_softcap=getattr(hf_cfg, "final_logit_softcapping", None),
        attn_scale=None if qpas is None else float(qpas) ** -0.5,
        post_norms=True,
        activation="geglu",
        embed_scale=True,
    ).validate()


def _gemma3_config(hf_cfg) -> ModelConfig:
    """Gemma-3 (text): the Gemma-2 block minus the softcaps, plus q/k
    RMSNorm and dual rope (local layers rope_local_base_freq unscaled,
    global layers rope_theta with the checkpoint's linear scaling)."""
    if getattr(hf_cfg, "model_type", "") == "gemma3":
        # The multimodal wrapper nests the text tower's config.
        inner = getattr(hf_cfg, "text_config", None)
        if inner is None:
            raise NotImplementedError(
                "gemma3 config without a text_config (vision-only?)"
            )
        hf_cfg = inner
    n_layers = hf_cfg.num_hidden_layers
    swp = getattr(hf_cfg, "sliding_window_pattern", None) or 6
    layer_types = getattr(hf_cfg, "layer_types", None) or [
        "full_attention" if (i + 1) % swp == 0 else "sliding_attention"
        for i in range(n_layers)
    ]
    pattern = _pattern_from_layer_types(layer_types)
    windowed = "window" in pattern
    uniform = len(set(pattern)) == 1
    if uniform:
        pattern = None
    rope_kw = _rope_from_hf(
        getattr(hf_cfg, "rope_scaling", None),
        hf_cfg.max_position_embeddings,
    )
    rope_linear = rope_kw.pop("rope_linear", None)
    if rope_kw:
        raise NotImplementedError(
            f"gemma3 with {sorted(rope_kw)} rope scaling (have: linear)"
        )
    qpas = getattr(hf_cfg, "query_pre_attn_scalar", None)
    local_theta = getattr(hf_cfg, "rope_local_base_freq", None)
    rope_theta = getattr(hf_cfg, "rope_theta", 1000000.0)
    if uniform and windowed and local_theta is not None:
        # Every layer is sliding: the local base IS the rope.
        rope_theta, rope_linear = float(local_theta), None
    return ModelConfig(
        vocab_size=hf_cfg.vocab_size,
        d_model=hf_cfg.hidden_size,
        n_layers=n_layers,
        n_heads=hf_cfg.num_attention_heads,
        n_kv_heads=getattr(hf_cfg, "num_key_value_heads", None)
        or hf_cfg.num_attention_heads,
        head_dim=getattr(hf_cfg, "head_dim", None)
        or hf_cfg.hidden_size // hf_cfg.num_attention_heads,
        d_ff=hf_cfg.intermediate_size,
        max_seq_len=hf_cfg.max_position_embeddings,
        rope_theta=rope_theta,
        rope_linear=rope_linear,
        rope_local_theta=(float(local_theta)
                          if windowed and not uniform
                          and local_theta is not None else None),
        norm_eps=hf_cfg.rms_norm_eps,
        tie_embeddings=bool(getattr(hf_cfg, "tie_word_embeddings", True)),
        attn_window=int(hf_cfg.sliding_window) if windowed else None,
        attn_pattern=pattern,
        attn_scale=None if qpas is None else float(qpas) ** -0.5,
        qk_norm=True,
        post_norms=True,
        activation="geglu",
        embed_scale=True,
    ).validate()


def _gptoss_config(hf_cfg) -> ModelConfig:
    """GPT-OSS: alternating sliding/full attention with learned per-head
    sink logits, q/k/v/o biases, yarn rope (truncate False), and an
    all-MoE stack with the softmax-after-top-k gate, biased experts, the
    clamped (up + 1) * glu activation and narrow experts."""
    n_layers = hf_cfg.num_hidden_layers
    layer_types = getattr(hf_cfg, "layer_types", None) or [
        "sliding_attention" if i % 2 == 0 else "full_attention"
        for i in range(n_layers)
    ]
    pattern, windowed = _window_pattern(hf_cfg, layer_types)
    moe = MoEConfig(
        num_experts=hf_cfg.num_local_experts,
        num_experts_per_token=hf_cfg.num_experts_per_tok,
        d_ff_expert=hf_cfg.intermediate_size,
        scoring="softmax_topk",
        expert_bias=True,
        # HF hardcodes these in GptOssExperts (no config fields).
        gate_limit=7.0,
        expert_act="gptoss",
        router_aux_loss_weight=getattr(hf_cfg, "router_aux_loss_coef", 0.9),
        dropless=True,
    )
    return ModelConfig(
        vocab_size=hf_cfg.vocab_size,
        d_model=hf_cfg.hidden_size,
        n_layers=n_layers,
        n_heads=hf_cfg.num_attention_heads,
        n_kv_heads=getattr(hf_cfg, "num_key_value_heads", None)
        or hf_cfg.num_attention_heads,
        head_dim=getattr(hf_cfg, "head_dim", None)
        or hf_cfg.hidden_size // hf_cfg.num_attention_heads,
        d_ff=hf_cfg.intermediate_size,
        max_seq_len=hf_cfg.max_position_embeddings,
        rope_theta=getattr(hf_cfg, "rope_theta", 150000.0),
        norm_eps=hf_cfg.rms_norm_eps,
        tie_embeddings=bool(getattr(hf_cfg, "tie_word_embeddings", False)),
        attn_window=int(hf_cfg.sliding_window) if windowed else None,
        attn_pattern=pattern,
        attn_bias=bool(getattr(hf_cfg, "attention_bias", True)),
        attn_out_bias=bool(getattr(hf_cfg, "attention_bias", True)),
        attn_sink=True,
        moe=moe,
        **_rope_from_hf(
            getattr(hf_cfg, "rope_scaling", None),
            hf_cfg.max_position_embeddings,
        ),
    ).validate()


def _rope_from_hf(rs, max_pos) -> dict:
    """ModelConfig rope-scaling kwargs from an HF rope_scaling dict:
    linear, llama3 and yarn convert exactly; other types fail loudly."""
    if not rs:
        return {}
    kind = rs.get("rope_type", rs.get("type"))
    if kind in ("linear", "default"):
        if kind == "default" or float(rs.get("factor", 1.0)) == 1.0:
            return {}
        return {"rope_linear": float(rs["factor"])}
    if kind == "llama3":
        if not rs.get("original_max_position_embeddings"):
            # Falling back to the post-scaling max would shift both
            # wavelength bands by the factor: silent divergence.
            raise ValueError(
                "llama3 rope_scaling requires "
                "original_max_position_embeddings"
            )
        return {"rope_llama3": Llama3RopeConfig(
            factor=rs["factor"],
            low_freq_factor=rs["low_freq_factor"],
            high_freq_factor=rs["high_freq_factor"],
            original_max_position_embeddings=rs[
                "original_max_position_embeddings"
            ],
        )}
    if kind != "yarn":
        raise NotImplementedError(
            f"rope_scaling type {kind!r} is not supported "
            "(have: linear, yarn, llama3)"
        )
    return {"rope_yarn": YarnConfig(
        factor=rs["factor"],
        original_max_position_embeddings=rs.get(
            "original_max_position_embeddings"
        ) or max_pos,
        beta_fast=rs.get("beta_fast") or 32.0,
        beta_slow=rs.get("beta_slow") or 1.0,
        mscale=rs.get("mscale"),
        mscale_all_dim=rs.get("mscale_all_dim"),
        attention_factor=rs.get("attention_factor"),
        truncate=rs.get("truncate", True),
    )}


def _hf_attn_window(hf_cfg) -> Optional[int]:
    """Sliding-window size, honoring the flags HF checks: Qwen2 configs
    set sliding_window with use_sliding_window False (no window), and a
    per-layer window (the first max_window_layers full, the rest
    windowed) has no uniform equivalent, so it is refused."""
    window = getattr(hf_cfg, "sliding_window", None)
    if window is None or not getattr(hf_cfg, "use_sliding_window", True):
        return None
    mwl = getattr(hf_cfg, "max_window_layers", None)
    if mwl is None or mwl == 0:
        return int(window)
    if mwl >= hf_cfg.num_hidden_layers:
        return None
    raise ValueError(
        f"per-layer sliding window (first max_window_layers={mwl} of "
        f"n_layers={hf_cfg.num_hidden_layers} full, rest windowed) is "
        "not representable as a uniform attn_window; refusing to convert"
    )


_GEMMA_FAMILY = ("gemma", "gemma2", "gemma3", "gemma3_text")


def _norm_offset(hf_cfg) -> float:
    """What to add to HF norm weights for the port's (1 + s): -1.0 for
    Llama-style RMSNorm (multiplies by w), 0.0 for the Gemma family
    (stores (1 + w) already)."""
    return 0.0 if getattr(hf_cfg, "model_type", "") in _GEMMA_FAMILY else -1.0


# ------------------------------------------------------------------ weights

_ATTN_MAP = {
    # ours: (hf suffix, transpose?)
    "wq": ("self_attn.q_proj.weight", True),
    "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True),
    "wo": ("self_attn.o_proj.weight", True),
}

_DENSE_MLP_MAP = {
    "w_gate": ("mlp.gate_proj.weight", True),
    "w_up": ("mlp.up_proj.weight", True),
    "w_down": ("mlp.down_proj.weight", True),
}

# Mixtral experts: w1 = gate, w3 = up, w2 = down.
_EXPERT_MAP = {"w_gate": "w1", "w_up": "w3", "w_down": "w2"}

# Qwen3-MoE experts keep the dense projection names.
_QWEN3_EXPERT_MAP = {"w_gate": "gate_proj", "w_up": "up_proj",
                     "w_down": "down_proj"}

# Qwen2-style attention biases (vectors, no transpose).
_BIAS_MAP = {
    "bq": "self_attn.q_proj.bias",
    "bk": "self_attn.k_proj.bias",
    "bv": "self_attn.v_proj.bias",
}


def params_from_state_dict(
    state_dict: Mapping[str, Any], cfg: ModelConfig,
    device: DeviceLike = None, master: bool = False,
    norm_offset: float = -1.0,
) -> Params:
    """An HF Llama-family state dict as port parameters on `device`.

    Each tensor moves to the device once, in its stored dtype, and is
    widened to fp32 there; norm_offset is added to norm weights in fp32
    (-1.0 for Llama-convention RMSNorm, 0.0 for Gemma: `_norm_offset`).
    """
    check_supported(cfg)
    if cfg.first_k_dense and cfg.mla is None:
        # The reference's `_first_k_params` serves DeepSeek only.
        raise NotImplementedError(
            "first_k_dense conversion is wired for MLA (DeepSeek) "
            "checkpoints only")
    dev = resolve_device(device)
    sd = state_dict
    # Accept both bare and "model."-prefixed keys.
    prefix = "model." if any(k.startswith("model.") for k in sd) else ""

    def get(name) -> torch.Tensor:
        key = f"{prefix}{name}"
        if key not in sd:
            raise KeyError(
                f"missing weight {key!r}; is this a Llama-family checkpoint?"
            )
        return sd[key].detach().to(dev).float()

    moe = cfg.moe is not None
    # Mixtral ships block_sparse_moe.*, Qwen3-MoE keeps the dense
    # projection names under mlp.experts.*, GPT-OSS fuses all experts
    # into single stacked tensors.
    if f"{prefix}layers.0.mlp.experts.gate_up_proj" in sd:
        moe_naming = "gpt_oss"
    elif f"{prefix}layers.0.mlp.experts.0.gate_proj.weight" in sd:
        moe_naming = "qwen3_moe"
    else:
        moe_naming = "mixtral"
    if moe and cfg.moe_every > 1:
        raise NotImplementedError(
            "interleaved dense/MoE stacks (moe_every > 1) have no HF "
            "(Mixtral) checkpoint layout to convert from"
        )
    # Phi3 fuses q/k/v into one qkv_proj and gate/up into gate_up_proj.
    fused_qkv = f"{prefix}layers.0.self_attn.qkv_proj.weight" in sd
    qd = cfg.n_heads * cfg.dim_per_head
    kvd = cfg.kv_heads * cfg.dim_per_head

    def stack(fmt, n):
        return torch.stack([get(fmt.format(j)).T for j in range(n)])

    flags = moe_layers(cfg)
    layers = []
    for i, moe_layer in enumerate(flags):
        base = f"layers.{i}."
        lp: Dict[str, torch.Tensor] = {}
        if cfg.mla is not None:
            lp.update(_mla_layer(cfg, get, base, norm_offset))
        elif fused_qkv:
            w = get(base + "self_attn.qkv_proj.weight").T  # (d, q + 2kv)
            lp["wq"], lp["wk"], lp["wv"] = (
                w[:, :qd], w[:, qd:qd + kvd], w[:, qd + kvd:])
            lp["wo"] = get(base + "self_attn.o_proj.weight").T
        else:
            for ours, (theirs, transpose) in _ATTN_MAP.items():
                w = get(base + theirs)
                lp[ours] = w.T if transpose else w
            if cfg.qk_norm:
                lp["q_norm"] = get(base + "self_attn.q_norm.weight") \
                    + norm_offset
                lp["k_norm"] = get(base + "self_attn.k_norm.weight") \
                    + norm_offset
        if cfg.attn_bias:
            for ours, theirs in _BIAS_MAP.items():
                lp[ours] = get(base + theirs)
        if cfg.attn_out_bias:
            lp["bo"] = get(base + "self_attn.o_proj.bias")
        if cfg.attn_sink:
            lp["sinks"] = get(base + "self_attn.sinks")
        if moe_layer and cfg.first_k_dense:
            # DeepSeek: the router stored (E, D), its V3 correction bias,
            # experts under their dense names, and the shared experts.
            lp["w_router"] = get(base + "mlp.gate.weight").T
            if cfg.moe.scoring == "sigmoid":
                lp["b_router"] = get(
                    base + "mlp.gate.e_score_correction_bias")
            for ours, proj in _QWEN3_EXPERT_MAP.items():
                lp[ours] = stack(base + "mlp.experts.{}." + proj + ".weight",
                                 cfg.moe.num_experts)
            if cfg.moe.num_shared_experts > 0:
                for ours, proj in _QWEN3_EXPERT_MAP.items():
                    lp[ours + "_shared"] = get(
                        base + f"mlp.shared_experts.{proj}.weight").T
        elif moe_layer and moe_naming == "gpt_oss":
            lp["w_router"] = get(base + "mlp.router.weight").T
            lp["b_router"] = get(base + "mlp.router.bias")
            # gate_up (E, D, 2F) interleaves gate and up on the last dim;
            # down is (E, F, D).
            gu = get(base + "mlp.experts.gate_up_proj")
            gub = get(base + "mlp.experts.gate_up_proj_bias")
            lp["w_gate"], lp["w_up"] = gu[..., 0::2], gu[..., 1::2]
            lp["b_gate"], lp["b_up"] = gub[..., 0::2], gub[..., 1::2]
            lp["w_down"] = get(base + "mlp.experts.down_proj")
            lp["b_down"] = get(base + "mlp.experts.down_proj_bias")
        elif moe_layer and moe_naming == "qwen3_moe":
            lp["w_router"] = get(base + "mlp.gate.weight").T
            for ours, proj in _QWEN3_EXPERT_MAP.items():
                lp[ours] = stack(base + "mlp.experts.{}." + proj + ".weight",
                                 cfg.moe.num_experts)
        elif moe_layer:
            lp["w_router"] = get(base + "block_sparse_moe.gate.weight").T
            for ours, theirs in _EXPERT_MAP.items():
                lp[ours] = stack(
                    base + "block_sparse_moe.experts.{}." + theirs
                    + ".weight", cfg.moe.num_experts)
        elif fused_qkv:
            gu = get(base + "mlp.gate_up_proj.weight").T  # (d, 2f)
            f = gu.shape[1] // 2
            lp["w_gate"], lp["w_up"] = gu[:, :f], gu[:, f:]
            lp["w_down"] = get(base + "mlp.down_proj.weight").T
        else:
            for ours, (theirs, transpose) in _DENSE_MLP_MAP.items():
                w = get(base + theirs)
                lp[ours] = w.T if transpose else w
        lp["attn_norm"] = get(base + "input_layernorm.weight") + norm_offset
        if cfg.post_norms:
            # Gemma-2 sandwich norms: HF's post_attention_layernorm is the
            # attention OUTPUT norm; the MLP pre-norm is
            # pre_feedforward_layernorm.
            lp["post_attn_norm"] = get(
                base + "post_attention_layernorm.weight") + norm_offset
            lp["mlp_norm"] = get(
                base + "pre_feedforward_layernorm.weight") + norm_offset
            lp["post_mlp_norm"] = get(
                base + "post_feedforward_layernorm.weight") + norm_offset
        else:
            lp["mlp_norm"] = get(
                base + "post_attention_layernorm.weight") + norm_offset
        layers.append(_stored(cfg, lp, layer_shapes(cfg, moe_layer), i,
                              master))
    top = {"embed": get("embed_tokens.weight"),
           "final_norm": get("norm.weight") + norm_offset}
    shapes = {"embed": ((cfg.vocab_size, cfg.d_model), None),
              "final_norm": ((cfg.d_model,), None)}
    if not cfg.tie_embeddings:
        if "lm_head.weight" not in sd:
            raise KeyError("untied config but no lm_head.weight in "
                           "state_dict")
        top["lm_head"] = sd["lm_head.weight"].detach().to(dev).float().T
        shapes["lm_head"] = ((cfg.d_model, cfg.vocab_size), None)
    params: Params = _stored(cfg, top, shapes, "top", master)
    params["layers"] = layers
    return {k: params[k] for k in ("embed", "layers", "final_norm",
                                   "lm_head") if k in params}


def _mla_layer(cfg, get, base, norm_offset) -> Dict[str, torch.Tensor]:
    """One DeepSeek layer's attention weights (the reference's
    `_collect_mla_layer` :560). HF's kv_b_proj is one (H * (nope + v),
    kv_lora_rank) matrix; the port splits it into the key expansion
    `wkv_b_k` (kv_lora_rank, H, nope) and the value expansion `wkv_b_v`
    (kv_lora_rank, H, v) that the absorbed decode contracts apart."""
    m = cfg.mla
    a = base + "self_attn."
    kv_b = get(a + "kv_b_proj.weight").T.reshape(
        m.kv_lora_rank, cfg.n_heads, m.qk_nope_head_dim + m.v_head_dim)
    lp = {
        "wkv_a": get(a + "kv_a_proj_with_mqa.weight").T,
        "kv_a_norm": get(a + "kv_a_layernorm.weight") + norm_offset,
        "wkv_b_k": kv_b[..., :m.qk_nope_head_dim],
        "wkv_b_v": kv_b[..., m.qk_nope_head_dim:],
        "wo": get(a + "o_proj.weight").T,
    }
    if m.q_lora_rank is None:
        lp["wq"] = get(a + "q_proj.weight").T
    else:
        lp["wq_a"] = get(a + "q_a_proj.weight").T
        lp["q_a_norm"] = get(a + "q_a_layernorm.weight") + norm_offset
        lp["wq_b"] = get(a + "q_b_proj.weight").T
    return lp


def _stored(cfg, found: Dict[str, torch.Tensor], shapes, where,
            master: bool) -> Dict[str, torch.Tensor]:
    """fp32 tensors checked against the port's shapes, in storage."""
    if set(found) != set(shapes):
        raise ValueError(f"layer {where}: converted {sorted(found)} != "
                         f"{sorted(shapes)} for this config")
    out = {}
    for name, (shape, _) in shapes.items():
        t = found[name]
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"layer {where} {name}: shape "
                             f"{tuple(t.shape)} != {tuple(shape)}")
        out[name] = to_storage(cfg, name, t, master).contiguous()
    return out


def to_state_dict(cfg: ModelConfig, params: Params,
                  dtype: torch.dtype = torch.float32
                  ) -> Dict[str, torch.Tensor]:
    """Inverse of params_from_state_dict: HF-named tensors
    ("model."-prefixed) in `dtype` (fp32 by default, as the reference's
    numpy export), on the parameters' device. Norm scales export as
    s + 1 in fp32 (Llama convention) before the cast; MoE models export
    to the Mixtral, Qwen3-MoE or GPT-OSS naming."""
    check_supported(cfg)
    moe = cfg.moe is not None
    if cfg.mla is not None and moe:
        raise NotImplementedError(
            "MLA + MoE export would mix DeepSeek attention names with "
            "Mixtral MLP names, which no HF architecture loads; dense-MLP "
            "MLA models export")
    if moe and cfg.moe.num_shared_experts > 0:
        raise NotImplementedError(
            "shared experts have no HF (Mixtral) state_dict equivalent"
        )
    if moe and cfg.moe_every > 1:
        raise NotImplementedError(
            "interleaved dense/MoE stacks (moe_every > 1) have no HF "
            "(Mixtral) state_dict equivalent"
        )
    if cfg.first_k_dense:
        raise NotImplementedError(
            "first_k_dense export is not wired yet (two-stack tree)"
        )

    def f32(x):
        return x.detach().float()

    # The Gemma family (GeGLU + scaled embeddings, as the import mapping
    # sets it up) stores (1 + w) natively; Llama-convention targets store
    # w, so s exports as s + 1.
    gemma_family = cfg.activation == "geglu" and cfg.embed_scale
    noff = 0.0 if gemma_family else 1.0
    sd: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": f32(params["embed"]),
        "model.norm.weight": f32(params["final_norm"]) + noff,
    }
    for i, lp in enumerate(params["layers"]):
        base = f"model.layers.{i}."
        if cfg.mla is not None:
            sd.update(_mla_export(cfg, lp, base, f32))
        else:
            for ours, (theirs, transpose) in _ATTN_MAP.items():
                w = f32(lp[ours])
                sd[base + theirs] = w.T if transpose else w
        if cfg.qk_norm:
            sd[base + "self_attn.q_norm.weight"] = f32(lp["q_norm"]) + noff
            sd[base + "self_attn.k_norm.weight"] = f32(lp["k_norm"]) + noff
        if cfg.attn_bias:
            for ours, theirs in _BIAS_MAP.items():
                sd[base + theirs] = f32(lp[ours])
        if cfg.attn_out_bias:
            sd[base + "self_attn.o_proj.bias"] = f32(lp["bo"])
        if cfg.attn_sink:
            sd[base + "self_attn.sinks"] = f32(lp["sinks"])
        if moe and (cfg.moe.scoring == "softmax_topk"
                    or cfg.moe.expert_bias):
            if not (cfg.moe.scoring == "softmax_topk"
                    and cfg.moe.expert_bias):
                raise NotImplementedError(
                    "softmax_topk scoring and expert_bias only export "
                    "together (the GPT-OSS layout)"
                )
            # GPT-OSS fused experts: re-interleave gate and up.
            sd[base + "mlp.router.weight"] = f32(lp["w_router"]).T
            sd[base + "mlp.router.bias"] = f32(lp["b_router"])
            sd[base + "mlp.experts.gate_up_proj"] = _interleave(
                f32(lp["w_gate"]), f32(lp["w_up"]))
            sd[base + "mlp.experts.gate_up_proj_bias"] = _interleave(
                f32(lp["b_gate"]), f32(lp["b_up"]))
            sd[base + "mlp.experts.down_proj"] = f32(lp["w_down"])
            sd[base + "mlp.experts.down_proj_bias"] = f32(lp["b_down"])
        elif moe and cfg.qk_norm:
            # qk_norm + MoE is the Qwen3-MoE shape: export its naming.
            sd[base + "mlp.gate.weight"] = f32(lp["w_router"]).T
            for ours, proj in _QWEN3_EXPERT_MAP.items():
                for j, w in enumerate(f32(lp[ours])):
                    sd[base + f"mlp.experts.{j}.{proj}.weight"] = w.T
        elif moe:
            sd[base + "block_sparse_moe.gate.weight"] = f32(
                lp["w_router"]).T
            for ours, theirs in _EXPERT_MAP.items():
                for j, w in enumerate(f32(lp[ours])):
                    sd[base + f"block_sparse_moe.experts.{j}.{theirs}"
                       ".weight"] = w.T
        else:
            for ours, (theirs, transpose) in _DENSE_MLP_MAP.items():
                w = f32(lp[ours])
                sd[base + theirs] = w.T if transpose else w
        sd[base + "input_layernorm.weight"] = f32(lp["attn_norm"]) + noff
        if cfg.post_norms:
            sd[base + "post_attention_layernorm.weight"] = (
                f32(lp["post_attn_norm"]) + noff)
            sd[base + "pre_feedforward_layernorm.weight"] = (
                f32(lp["mlp_norm"]) + noff)
            sd[base + "post_feedforward_layernorm.weight"] = (
                f32(lp["post_mlp_norm"]) + noff)
        else:
            sd[base + "post_attention_layernorm.weight"] = (
                f32(lp["mlp_norm"]) + noff)
    if cfg.tie_embeddings:
        sd["lm_head.weight"] = sd["model.embed_tokens.weight"]
    else:
        sd["lm_head.weight"] = f32(params["lm_head"]).T
    return {k: v.to(dtype).contiguous() for k, v in sd.items()}


def _mla_export(cfg, lp, base, f32) -> Dict[str, torch.Tensor]:
    """An MLA layer's attention under DeepSeek's names: the two
    expansions fused back into HF's kv_b_proj, norms as s + 1."""
    m = cfg.mla
    a = base + "self_attn."
    kv_b = torch.cat([f32(lp["wkv_b_k"]), f32(lp["wkv_b_v"])], dim=-1)
    sd = {
        a + "kv_a_proj_with_mqa.weight": f32(lp["wkv_a"]).T,
        a + "kv_a_layernorm.weight": f32(lp["kv_a_norm"]) + 1.0,
        a + "kv_b_proj.weight": kv_b.reshape(m.kv_lora_rank, -1).T,
        a + "o_proj.weight": f32(lp["wo"]).T,
    }
    if m.q_lora_rank is None:
        sd[a + "q_proj.weight"] = f32(lp["wq"]).T
    else:
        sd[a + "q_a_proj.weight"] = f32(lp["wq_a"]).T
        sd[a + "q_a_layernorm.weight"] = f32(lp["q_a_norm"]) + 1.0
        sd[a + "q_b_proj.weight"] = f32(lp["wq_b"]).T
    return sd


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., F) and (..., F) as (..., 2F) with a at the even positions."""
    return torch.stack([a, b], dim=-1).reshape(*a.shape[:-1], -1)


def from_hf(model_or_path, device: DeviceLike = None,
            master: bool = False):
    """(cfg, params) from a local HF checkpoint directory (config.json
    and safetensors or pytorch_model.bin files), or from a
    `transformers` model instance."""
    if isinstance(model_or_path, (str, os.PathLike)):
        from shellac_tpu_torch.utils.safetensors import CheckpointDir

        path = os.fspath(model_or_path)
        hf_cfg = read_hf_config(path)
        quant = getattr(hf_cfg, "quantization_config", None)
        if quant:
            raise NotImplementedError(
                f"quantized checkpoints ({quant.get('quant_method')}) are "
                "not ported; convert from bf16 or fp32 weights")
        state_dict: Mapping[str, Any] = CheckpointDir(path)
    else:
        hf_cfg = model_or_path.config
        state_dict = model_or_path.state_dict()
    cfg = config_from_hf(hf_cfg)
    params = params_from_state_dict(
        state_dict, cfg, device=device, master=master,
        norm_offset=_norm_offset(hf_cfg),
    )
    return cfg, params
