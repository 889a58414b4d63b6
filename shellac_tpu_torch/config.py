"""Model configuration dataclasses for the PyTorch port.

A copy of the JAX package's `config.py` model dataclasses and its
`TrainConfig` (:476) as plain data, so every preset and recipe parses the
same way in both packages. Only the dtype mapping differs: names resolve
to `torch` dtypes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int8": torch.int8,
}


def resolve_dtype(name):
    """Map a dtype name (or a torch dtype) to the torch dtype object."""
    if isinstance(name, str):
        return _DTYPES[name]
    return name


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts layer configuration."""

    num_experts: int = 8
    num_experts_per_token: int = 2
    # Per-expert capacity = capacity_factor * tokens / num_experts.
    capacity_factor: float = 1.25
    router_aux_loss_weight: float = 0.01
    router_z_loss_weight: float = 1e-3
    # Never drop tokens: capacity is sized to the worst case (T per
    # expert), costing O(E*T*D) dispatch buffers. Exact Mixtral-style
    # computation — use for inference/conversion parity, not large-T
    # training.
    dropless: bool = False
    # Dropless TRAINING: sorted-segment grouped expert matmuls
    # (jax.lax.ragged_dot) — no capacity buckets, nothing drops
    # (moe_dropped_frac == 0 by construction), O(T*k*F) memory like a
    # dense MLP. The loss-sensitive fine-tuning option; decode keeps
    # the capacity-at-T path (ops/moe.py:moe_ffn_grouped).
    grouped_dropless: bool = False
    # DeepSeek-style always-active shared experts: one fused FFN of
    # hidden size num_shared_experts * expert ff width added to the
    # routed output.
    num_shared_experts: int = 0
    # Expert FFN hidden width; None = the model's ff_dim. DeepSeek MoE
    # layers use a much narrower per-expert width than dense layers
    # (moe_intermediate_size).
    d_ff_expert: Optional[int] = None
    # Renormalize the kept top-k probabilities to sum to 1. DeepSeek-V2
    # ships norm_topk_prob=False: raw softmax probabilities are used,
    # scaled by routed_scaling_factor.
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    # Group-limited routing (DeepSeek-V2/V3 big variants): experts are
    # split into n_group groups, the top `topk_group` groups stay live
    # (ranked by max member score under softmax scoring, by top-2-sum
    # under sigmoid scoring — each matching its HF reference), and
    # top-k selects within them. n_group=1 disables.
    n_group: int = 1
    topk_group: int = 1
    # "softmax" (V2), "sigmoid" (V3: sigmoid scores with an additive
    # per-expert selection bias — e_score_correction_bias — that
    # influences WHICH experts are picked, never the combine weights),
    # or "softmax_topk" (GPT-OSS: top-k over raw biased logits, softmax
    # over just the kept values).
    scoring: str = "softmax"
    # Biases on the expert projections (GPT-OSS): b_gate/b_up (E, F)
    # and b_down (E, D) ride alongside the weights.
    expert_bias: bool = False
    # GPT-OSS activation clamp: gate clamps to (-inf, limit], up to
    # [-limit, limit] before the gated product.
    gate_limit: Optional[float] = None
    # Expert FFN activation: "silu" (standard swiglu) or "gptoss"
    # ((up + 1) * gate * sigmoid(1.702 * gate), after the clamp).
    expert_act: str = "silu"


@dataclass(frozen=True)
class YarnConfig:
    """Yarn rope scaling (NTK-by-parts context extension).

    Matches the HF `rope_scaling: {"rope_type": "yarn", ...}` semantics
    exactly (transformers._compute_yarn_parameters): low frequencies
    interpolate by `factor`, high frequencies extrapolate, a linear ramp
    between the beta_fast/beta_slow rotation bounds blends them, and the
    cos/sin tables are multiplied by an attention factor (mscale).
    DeepSeek's long-context checkpoints ship with this.
    """

    factor: float
    original_max_position_embeddings: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: Optional[float] = None
    mscale_all_dim: Optional[float] = None
    attention_factor: Optional[float] = None
    truncate: bool = True


@dataclass(frozen=True)
class Llama3RopeConfig:
    """Llama-3.1 rope scaling (wavelength-banded frequency division).

    Matches HF's `rope_scaling: {"rope_type": "llama3", ...}` exactly:
    wavelengths longer than old_context/low_freq_factor divide by
    `factor`, shorter than old_context/high_freq_factor stay put, and
    the band between interpolates smoothly. No attention factor.
    """

    factor: float
    low_freq_factor: float
    high_freq_factor: float
    original_max_position_embeddings: int


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2/V3 style).

    K and V are generated from a shared low-rank latent: kv_a projects
    the hidden state to `kv_lora_rank` (+ a `qk_rope_head_dim` slice
    that carries position, shared by all heads, MQA-style), and kv_b
    expands the normed latent to per-head no-position keys and values.
    Queries split the same way (optionally low-rank via q_lora_rank).
    The decode cache stores ONLY the latent + roped key slice —
    `kv_lora_rank + qk_rope_head_dim` numbers per token, independent of
    the head count (see models/transformer.py for the absorbed-matrix
    decode that makes this exact).
    """

    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def cache_dim(self) -> int:
        return self.kv_lora_rank + self.qk_rope_head_dim


@dataclass(frozen=True)
class ModelConfig:
    """Decoder-only transformer configuration (LLaMA-style)."""

    vocab_size: int = 32768
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    # Grouped-query attention: n_kv_heads <= n_heads, n_heads % n_kv_heads == 0.
    n_kv_heads: Optional[int] = None
    head_dim: Optional[int] = None
    d_ff: Optional[int] = None
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    # Compute dtype; parameters are kept in param_dtype (fp32 master copy).
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    tie_embeddings: bool = True
    # MLP gate activation: "swiglu" (silu) or "geglu" (tanh-gelu, Gemma).
    activation: str = "swiglu"
    # Scale token embeddings by sqrt(d_model) at input (Gemma-style).
    embed_scale: bool = False
    # Rematerialize each block in the backward pass (memory for FLOPs).
    remat: bool = True
    # What the remat may keep: "none" (recompute everything), "dots"
    # (save matmul outputs — less recompute, more HBM), "dots_no_batch".
    remat_policy: str = "none"
    # Optional sliding-window attention (None = full causal).
    attn_window: Optional[int] = None
    # Per-layer attention kinds, cycled over the depth (Gemma-2/3
    # style): entries are "window" (uses attn_window) or "full".
    # n_layers must divide into whole pattern periods. None = every
    # layer uses attn_window as-is.
    attn_pattern: Optional[tuple] = None
    # Gemma-2 tanh soft-capping of the SCALED attention scores
    # (cap * tanh(s / cap), applied before masking).
    attn_softcap: Optional[float] = None
    # Score scale override (Gemma-2's query_pre_attn_scalar**-0.5);
    # None = head_dim**-0.5.
    attn_scale: Optional[float] = None
    # Sandwich norms (Gemma-2/3): an extra RMSNorm on each residual
    # branch's OUTPUT (post-attention and post-MLP), alongside the usual
    # pre-norms.
    post_norms: bool = False
    # Learned per-head attention-sink logits (GPT-OSS): each row's
    # softmax denominator gains exp(sink_h) so attention mass can drain
    # off the real tokens. Adds a per-layer "sinks" (H,) parameter.
    attn_sink: bool = False
    # Bias on the attention OUTPUT projection (GPT-OSS puts biases on
    # o_proj too; attn_bias alone covers q/k/v).
    attn_out_bias: bool = False
    # False = bidirectional (encoder) attention. Decoder-only features
    # (KV-cache generation) require causal=True.
    causal: bool = True
    # Biases on the q/k/v projections (Qwen2-style); o_proj stays biasless.
    attn_bias: bool = False
    # If set, every `moe_every`-th layer is a MoE layer (1 = all layers).
    moe: Optional[MoEConfig] = None
    moe_every: int = 1
    # DeepSeek layout: the first k layers run dense MLPs, every later
    # layer is MoE. Mutually exclusive with moe_every > 1.
    first_k_dense: int = 0
    logit_softcap: Optional[float] = None
    # Quantized training compute: "int8" runs the dense projections as
    # int8 MXU dots (fwd only; fp32 master params untouched). Usually
    # set via TrainConfig.quant rather than directly. See ops/qtrain.py.
    quant_training: Optional[str] = None
    # Multi-head latent attention (DeepSeek-style). Replaces the
    # standard q/k/v projections; n_kv_heads must be unset (the latent
    # is shared MQA-style) and head_dim is ignored in favour of the
    # MLA dims.
    mla: Optional[MLAConfig] = None
    # Rope scaling for long-context checkpoints (applies to the
    # rope_dim — MLA's qk_rope slice or the full head_dim). At most one
    # of yarn (DeepSeek/Qwen long-context) / llama3 (Llama-3.1 family) /
    # linear (classic position interpolation; Gemma-3 global layers).
    rope_yarn: Optional[YarnConfig] = None
    rope_llama3: Optional[Llama3RopeConfig] = None
    rope_linear: Optional[float] = None
    # Gemma-3 dual rope: "window" layers of an attn_pattern rope with
    # this theta and NO scaling, while "full" layers use rope_theta plus
    # whatever scaling config is set. Requires attn_pattern.
    rope_local_theta: Optional[float] = None
    # Per-head-dim RMSNorm on q and k before rope (Qwen3-style).
    qk_norm: bool = False

    def __post_init__(self):
        # JSON configs arrive with attn_pattern as a list; the frozen
        # dataclass stores the hashable tuple every consumer expects.
        if self.attn_pattern is not None and not isinstance(
            self.attn_pattern, tuple
        ):
            object.__setattr__(self, "attn_pattern", tuple(self.attn_pattern))

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    @property
    def dim_per_head(self) -> int:
        return (
            self.head_dim if self.head_dim is not None else self.d_model // self.n_heads
        )

    @property
    def ff_dim(self) -> int:
        if self.d_ff is not None:
            return self.d_ff
        # SwiGLU sizing: 2/3 * 4 * d_model, rounded up to a multiple of 128
        # so the MXU tiles cleanly (128 lanes).
        raw = int(8 * self.d_model / 3)
        return ((raw + 127) // 128) * 128

    @property
    def rope_dim(self) -> int:
        """Width of the rotary tables: MLA ropes only its qk_rope slice."""
        return (self.mla.qk_rope_head_dim if self.mla is not None
                else self.dim_per_head)

    @property
    def cache_kv_heads(self) -> int:
        """KV-cache head count: MLA caches ONE shared latent row."""
        return 1 if self.mla is not None else self.kv_heads

    @property
    def cache_head_dim(self) -> int:
        """Per-token cache width: latent + roped key slice under MLA."""
        return self.mla.cache_dim if self.mla is not None else self.dim_per_head

    @property
    def cache_v_head_dim(self) -> int:
        """V-cache width: 0 under MLA (values re-expand from the SAME
        latent the key cache stores — no second copy exists)."""
        return 0 if self.mla is not None else self.dim_per_head

    @property
    def compute_dtype(self):
        return resolve_dtype(self.dtype)

    @property
    def params_dtype(self):
        return resolve_dtype(self.param_dtype)

    def validate(self) -> "ModelConfig":
        if self.n_heads % self.kv_heads != 0:
            raise ValueError(
                f"n_heads={self.n_heads} must be divisible by n_kv_heads={self.kv_heads}"
            )
        if self.head_dim is None and self.d_model % self.n_heads != 0:
            raise ValueError(
                f"d_model={self.d_model} must be divisible by n_heads={self.n_heads}"
            )
        if self.moe is not None and self.moe_every < 1:
            raise ValueError("moe_every must be >= 1")
        if self.attn_pattern is not None:
            if not self.attn_pattern:
                raise ValueError(
                    "attn_pattern must be a non-empty tuple or None"
                )
            bad = set(self.attn_pattern) - {"window", "full"}
            if bad:
                raise ValueError(
                    f"attn_pattern entries must be 'window' or 'full'; "
                    f"got {sorted(bad)}"
                )
            if "window" in self.attn_pattern and self.attn_window is None:
                raise ValueError(
                    "attn_pattern uses 'window' layers but attn_window "
                    "is unset"
                )
            if self.n_layers % len(self.attn_pattern):
                raise ValueError(
                    f"n_layers={self.n_layers} must divide into whole "
                    f"attn_pattern periods (len {len(self.attn_pattern)})"
                )
            if self.moe_every > 1 or self.first_k_dense:
                raise ValueError(
                    "attn_pattern with interleaved dense/MoE layouts is "
                    "not supported yet (uniform layers or full MoE only)"
                )
        if self.first_k_dense:
            if self.moe is None:
                raise ValueError("first_k_dense needs a MoEConfig")
            if self.moe_every > 1:
                raise ValueError(
                    "first_k_dense and moe_every > 1 are different "
                    "layouts; pick one"
                )
            if not 0 < self.first_k_dense < self.n_layers:
                raise ValueError(
                    f"first_k_dense={self.first_k_dense} must be in "
                    f"(0, n_layers={self.n_layers})"
                )
        if self.moe is not None and self.moe.scoring not in (
            "softmax", "sigmoid", "softmax_topk",
        ):
            raise ValueError(
                f"moe.scoring={self.moe.scoring!r}; have softmax, "
                "sigmoid, softmax_topk"
            )
        if self.moe is not None and self.moe.expert_act not in (
            "silu", "gptoss",
        ):
            raise ValueError(
                f"moe.expert_act={self.moe.expert_act!r}; have silu, gptoss"
            )
        if (self.moe is not None and self.moe.scoring == "softmax_topk"
                and self.moe.n_group > 1):
            raise ValueError(
                "softmax_topk scoring has no group-limited variant"
            )
        if (self.moe is not None and self.moe.scoring == "sigmoid"
                and self.moe.n_group > 1
                and self.moe.num_experts // self.moe.n_group < 2):
            raise ValueError(
                "sigmoid scoring ranks groups by top-2 sum; groups need "
                ">= 2 experts"
            )
        if self.moe is not None and self.moe.n_group > 1:
            if self.moe.num_experts % self.moe.n_group:
                raise ValueError(
                    f"num_experts={self.moe.num_experts} must divide "
                    f"into n_group={self.moe.n_group} groups"
                )
            if not 1 <= self.moe.topk_group <= self.moe.n_group:
                raise ValueError(
                    f"topk_group={self.moe.topk_group} must be in "
                    f"[1, n_group={self.moe.n_group}]"
                )
        if self.quant_training not in (None, "int8", "int8_bwd"):
            raise ValueError(
                f"quant_training={self.quant_training!r}; "
                "have None, 'int8', 'int8_bwd'"
            )
        if sum(x is not None for x in (
            self.rope_yarn, self.rope_llama3, self.rope_linear,
        )) > 1:
            raise ValueError(
                "rope_yarn / rope_llama3 / rope_linear are exclusive"
            )
        if self.rope_local_theta is not None and (
            self.attn_pattern is None or "window" not in self.attn_pattern
        ):
            raise ValueError(
                "rope_local_theta needs an attn_pattern with 'window' "
                "layers (a uniform model just sets rope_theta)"
            )
        if self.mla is not None:
            if self.n_kv_heads is not None:
                raise ValueError(
                    "MLA shares one latent across heads (MQA-style); "
                    "leave n_kv_heads unset"
                )
            if self.attn_window is not None:
                raise ValueError("MLA with sliding windows is not defined")
            if self.attn_softcap is not None or self.attn_scale is not None:
                # The absorbed latent decode uses its own exact algebra
                # and scale; capping/rescaling would silently diverge
                # between the training forward and cached decode.
                raise ValueError(
                    "attn_softcap/attn_scale are not defined for MLA "
                    "models (the absorbed decode fixes the score scale)"
                )
            if self.attn_sink or self.attn_out_bias:
                raise ValueError(
                    "attn_sink/attn_out_bias are not defined for MLA "
                    "models"
                )
            if self.attn_bias:
                raise ValueError("MLA attn_bias is not supported yet")
            if not self.causal:
                raise ValueError("MLA is decoder-only (causal=True)")
            if self.mla.qk_rope_head_dim % 2:
                raise ValueError("qk_rope_head_dim must be even (rope pairs)")
            if self.qk_norm:
                raise ValueError("qk_norm does not apply to MLA models")
        return self

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer / schedule / loop configuration (the JAX package's
    defaults; options the port does not take raise in
    `training.make_train_step`)."""

    learning_rate: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    # "adamw" (ported); "lion", "adafactor", "muon" (not ported).
    optimizer: str = "adamw"
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip_norm: float = 1.0
    # Dtype of adam's first moment as stored; the update is computed from
    # the fp32 moment before the cast. The second moment stays fp32.
    mu_dtype: str = "bfloat16"
    # Number of microbatches accumulated per optimizer step (1 = no accum).
    grad_accum: int = 1
    z_loss_weight: float = 0.0
    # Skip the whole param/opt update when any gradient (or the loss) is
    # non-finite.
    skip_nonfinite_updates: bool = True
    # Quantized training compute: None only (int8 dots are not ported).
    quant: Optional[str] = None
    # Vocab-chunked fused cross-entropy: None only (not ported).
    fused_loss_chunk: Optional[int] = None
    # Exponential moving average of parameters (e.g. 0.999), kept in
    # TrainState.ema_params; None disables.
    ema_decay: Optional[float] = None
    seed: int = 0

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
