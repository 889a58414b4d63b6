"""Named model presets (a verbatim copy of the JAX package's registry)."""

from __future__ import annotations

from shellac_tpu_torch.config import MLAConfig, ModelConfig, MoEConfig

# fmt: off
PRESETS = {
    # test-scale configs (CPU-friendly)
    "tiny": ModelConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                        max_seq_len=128, remat=False),
    "tiny-gqa": ModelConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                            n_kv_heads=2, max_seq_len=128, remat=False),
    "tiny-moe": ModelConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                            max_seq_len=128, remat=False,
                            moe=MoEConfig(num_experts=4, num_experts_per_token=2)),
    "tiny-moe-shared": ModelConfig(vocab_size=256, d_model=64, n_layers=2,
                                   n_heads=4, max_seq_len=128, remat=False,
                                   moe=MoEConfig(num_experts=4,
                                                 num_experts_per_token=2,
                                                 num_shared_experts=1)),
    "tiny-moe-interleaved": ModelConfig(vocab_size=256, d_model=64,
                                        n_layers=4, n_heads=4,
                                        max_seq_len=128, remat=False,
                                        moe=MoEConfig(num_experts=4,
                                                      num_experts_per_token=2),
                                        moe_every=2),
    "tiny-encoder": ModelConfig(vocab_size=256, d_model=64, n_layers=2,
                                n_heads=4, max_seq_len=128, remat=False,
                                causal=False),
    # The full GPT-OSS shape in miniature: attention sinks, q/k/v/o
    # biases, alternating sliding/full layers, softmax-after-top-k MoE
    # with biased experts and the clamped (up+1)*glu activation.
    "tiny-gptoss": ModelConfig(vocab_size=256, d_model=64, n_layers=4,
                               n_heads=4, n_kv_heads=2, max_seq_len=128,
                               remat=False, attn_window=16,
                               attn_pattern=("window", "full"),
                               attn_sink=True, attn_bias=True,
                               attn_out_bias=True, tie_embeddings=False,
                               moe=MoEConfig(num_experts=4,
                                             num_experts_per_token=2,
                                             d_ff_expert=96,
                                             scoring="softmax_topk",
                                             expert_bias=True,
                                             gate_limit=7.0,
                                             expert_act="gptoss",
                                             dropless=True)),
    # The full Gemma-3 (text) shape in miniature: 5:1 local/global
    # pattern, dual rope (unscaled local theta / linear-scaled global),
    # qk-norm, sandwich norms, no softcaps.
    "tiny-gemma3": ModelConfig(vocab_size=256, d_model=64, n_layers=6,
                               n_heads=4, n_kv_heads=2, max_seq_len=128,
                               remat=False, attn_window=16,
                               attn_pattern=("window",) * 5 + ("full",),
                               rope_theta=1_000_000.0,
                               rope_local_theta=10_000.0, rope_linear=8.0,
                               attn_scale=16 ** -0.5, qk_norm=True,
                               post_norms=True, activation="geglu",
                               embed_scale=True),
    # The full Gemma-2 shape in miniature: alternating local/global
    # attention, score + final-logit tanh capping, sandwich norms, a
    # query_pre_attn_scalar score scale, GeGLU, scaled embeddings.
    "tiny-gemma2": ModelConfig(vocab_size=256, d_model=64, n_layers=4,
                               n_heads=4, n_kv_heads=2, max_seq_len=128,
                               remat=False, attn_window=16,
                               attn_pattern=("window", "full"),
                               attn_softcap=50.0, logit_softcap=30.0,
                               attn_scale=16 ** -0.5, post_norms=True,
                               activation="geglu", embed_scale=True),
    "tiny-mla": ModelConfig(vocab_size=256, d_model=64, n_layers=2,
                            n_heads=4, max_seq_len=128, remat=False,
                            mla=MLAConfig(kv_lora_rank=32, q_lora_rank=24,
                                          qk_nope_head_dim=16,
                                          qk_rope_head_dim=8, v_head_dim=16)),
    # The full DeepSeek-V2 shape in miniature: MLA + first-k-dense +
    # narrow routed experts + a shared expert, un-normalized scaled
    # top-k routing.
    "tiny-deepseek": ModelConfig(vocab_size=256, d_model=64, n_layers=3,
                                 n_heads=4, max_seq_len=128, remat=False,
                                 mla=MLAConfig(kv_lora_rank=32,
                                               q_lora_rank=24,
                                               qk_nope_head_dim=16,
                                               qk_rope_head_dim=8,
                                               v_head_dim=16),
                                 first_k_dense=1,
                                 moe=MoEConfig(num_experts=4,
                                               num_experts_per_token=2,
                                               d_ff_expert=48,
                                               num_shared_experts=1,
                                               norm_topk_prob=False,
                                               routed_scaling_factor=1.0,
                                               # DeepSeek computes every
                                               # routed token (and only
                                               # dropless MoE keeps the
                                               # serving parity invariant
                                               # under prompt padding).
                                               dropless=True)),
    # DeepSeek-V2-Lite shape, dense-MLP variant (MLA decode cache:
    # 576 per token vs 16*(192+128) = 5120 expanded — an 8.9x shrink).
    "shellac-mla-2b": ModelConfig(vocab_size=32768, d_model=2048,
                                  n_layers=20, n_heads=16,
                                  max_seq_len=4096,
                                  mla=MLAConfig(kv_lora_rank=512,
                                                q_lora_rank=None,
                                                qk_nope_head_dim=128,
                                                qk_rope_head_dim=64,
                                                v_head_dim=128)),
    # single-chip bench scale (v5e: 16 GiB HBM)
    "shellac-270m": ModelConfig(vocab_size=32768, d_model=1024, n_layers=12,
                                n_heads=8, n_kv_heads=8, head_dim=128,
                                max_seq_len=2048),
    "shellac-1b": ModelConfig(vocab_size=32768, d_model=2048, n_layers=16,
                              n_heads=16, n_kv_heads=8, head_dim=128,
                              max_seq_len=2048),
    # multi-chip flagship shape (sharded over a mesh)
    "shellac-7b": ModelConfig(vocab_size=32768, d_model=4096, n_layers=32,
                              n_heads=32, n_kv_heads=8, head_dim=128,
                              max_seq_len=4096),
}
# fmt: on


def get_model_config(name: str) -> ModelConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown model {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]
