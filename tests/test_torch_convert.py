"""HF checkpoints through the port (`shellac_tpu_torch/models/convert.py`,
`utils/safetensors.py`, the `convert` command and `--native-dir`),
held against the JAX package's `models/convert.py` on the CPU.

Each family is a tiny `transformers` model built from a seed (its norm
weights, biases and sinks perturbed so that the offsets and bias paths
carry real numbers) and saved with `save_pretrained` to a directory, once
per module. For each family the port's `config_from_hf(dir)` equals the
JAX package's field by field; the port's `from_hf(dir)` gives exactly
`params_from_jax` of the JAX `from_hf` parameters, in fp32 masters and in
serving storage; the port's fp32 forward gives the `transformers` logits
within LOGITS_ATOL; `to_state_dict` equals the JAX export; and a
config.json with every key that equals its class default deleted maps to
the config `AutoConfig` gives. DeepSeek-V2 and V3 (MLA; first-k-dense
MoE, the V3 gate's correction biases, low-rank queries) convert as the
JAX package converts them and give transformers' logits, and export where
the reference exports (dense-MLP MLA only). Also: a sharded directory,
what DeepSeek conversion still refuses, the missing-weight message, the
safetensors reader and writer against the `safetensors` package both
ways, `convert` then `generate --native-dir` through `cli.main`, a
config.json written by the JAX `convert` rehydrating in the port, and
`chip_smoke.py`'s GPT-OSS-20B config, built from the published keys
through the port's mapping, equal to the JAX package's mapping of them and
to the config that was written there by hand.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import dataclasses
import io
import json
import os
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch
import transformers

from shellac_tpu.models import convert as jconv
from shellac_tpu_torch import cli
from shellac_tpu_torch.inference.engine import Engine
from shellac_tpu_torch.models import convert as tconv
from shellac_tpu_torch.models import transformer as tt
from shellac_tpu_torch.models.from_jax import params_from_jax
from shellac_tpu_torch.utils import safetensors as st

CPU = "cpu"
# fp32 logits of two implementations of the same tiny model on the CPU
# (measured within 3e-6).
LOGITS_ATOL = 1e-4

_TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=176,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=256,
             rms_norm_eps=1e-5, attn_implementation="eager")

# name -> (config class, model class, config kwargs over _TINY, seed)
FAMILIES = {
    "llama-gqa": ("LlamaConfig", "LlamaForCausalLM", {}, 0),
    "llama-tied": ("LlamaConfig", "LlamaForCausalLM",
                   dict(num_key_value_heads=4, tie_word_embeddings=True), 1),
    "mistral": ("MistralConfig", "MistralForCausalLM",
                dict(sliding_window=4), 2),
    "mixtral": ("MixtralConfig", "MixtralForCausalLM",
                dict(intermediate_size=112, num_local_experts=4,
                     num_experts_per_tok=2, sliding_window=None), 3),
    "qwen2": ("Qwen2Config", "Qwen2ForCausalLM",
              dict(sliding_window=None, use_sliding_window=False,
                   rms_norm_eps=1e-6), 4),
    "qwen3": ("Qwen3Config", "Qwen3ForCausalLM", dict(head_dim=16), 5),
    "qwen3-moe": ("Qwen3MoeConfig", "Qwen3MoeForCausalLM",
                  dict(head_dim=16, moe_intermediate_size=48, num_experts=4,
                       num_experts_per_tok=2, norm_topk_prob=True,
                       mlp_only_layers=[], decoder_sparse_step=1), 6),
    "phi3": ("Phi3Config", "Phi3ForCausalLM",
             dict(sliding_window=None, pad_token_id=0), 7),
    "gemma": ("GemmaConfig", "GemmaForCausalLM",
              dict(intermediate_size=128, head_dim=16, rms_norm_eps=1e-6,
                   hidden_act="gelu_pytorch_tanh",
                   hidden_activation="gelu_pytorch_tanh"), 8),
    "gemma2": ("Gemma2Config", "Gemma2ForCausalLM",
               dict(num_hidden_layers=4, intermediate_size=128, head_dim=16,
                    sliding_window=8, attn_logit_softcapping=50.0,
                    final_logit_softcapping=30.0, query_pre_attn_scalar=20,
                    rms_norm_eps=1e-6), 9),
    "gemma3": ("Gemma3TextConfig", "Gemma3ForCausalLM",
               dict(vocab_size=151, hidden_size=48, intermediate_size=96,
                    num_hidden_layers=6, head_dim=16, sliding_window=8,
                    rope_theta=1e6, rope_local_base_freq=1e4,
                    query_pre_attn_scalar=24,
                    rope_scaling={"rope_type": "linear", "factor": 8.0}),
               10),
    "gptoss": ("GptOssConfig", "GptOssForCausalLM",
               dict(vocab_size=173, intermediate_size=96, num_hidden_layers=4,
                    head_dim=16, sliding_window=8, num_local_experts=6,
                    num_experts_per_tok=2, rope_theta=150000.0), 11),
    "llama3-rope": ("LlamaConfig", "LlamaForCausalLM",
                    dict(rope_scaling={
                        "rope_type": "llama3", "factor": 8.0,
                        "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                        "original_max_position_embeddings": 64}), 12),
    "linear-rope": ("LlamaConfig", "LlamaForCausalLM",
                    dict(rope_scaling={"rope_type": "linear",
                                       "factor": 4.0}), 13),
    "yarn-rope": ("LlamaConfig", "LlamaForCausalLM",
                  dict(rope_scaling={"rope_type": "yarn", "factor": 4.0,
                                     "original_max_position_embeddings": 64}),
                  14),
}


def _model(name):
    cfg_cls, model_cls, over, seed = FAMILIES[name]
    hf_cfg = getattr(transformers, cfg_cls)(**{**_TINY, **over})
    torch.manual_seed(seed)
    model = getattr(transformers, model_cls)(hf_cfg).eval()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if any(s in pname for s in ("norm", "bias", "sinks")):
                p.add_(0.3 * torch.randn(p.shape, generator=gen))
    return model


def _tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _tree_equal(g, w, f"{path}/{i}")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(got, want), path


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request, tmp_path_factory):
    """One saved directory per family, with the JAX package's view of it
    (config_from_hf on AutoConfig, and from_hf's params as numpy)."""
    name = request.param
    model = _model(name)
    path = str(tmp_path_factory.mktemp(name))
    model.save_pretrained(path, safe_serialization=True)
    jcfg, jparams = jconv.from_hf(path)
    return dict(name=name, model=model, dir=path, jcfg=jcfg,
                jparams=jax.tree.map(np.asarray, jparams))


def test_config_matches_jax(family):
    got = tconv.config_from_hf(family["dir"])
    want = jconv.config_from_hf(transformers.AutoConfig.from_pretrained(
        family["dir"]))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got) == dataclasses.asdict(family["jcfg"])
    # A transformers config object maps the same way.
    assert tconv.config_from_hf(family["model"].config) == got


def test_params_match_jax(family):
    cfg, master = tconv.from_hf(family["dir"], device=CPU, master=True)
    _tree_equal(master, params_from_jax(cfg, family["jparams"], device=CPU,
                                        master=True))
    _, serving = tconv.from_hf(family["dir"], device=CPU)
    _tree_equal(serving, params_from_jax(cfg, family["jparams"],
                                         device=CPU))
    # A live transformers model converts to the same parameters.
    _tree_equal(tconv.from_hf(family["model"], device=CPU, master=True)[1],
                master)


def test_logits_match_transformers(family):
    cfg, params = tconv.from_hf(family["dir"], device=CPU, master=True)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 12)))
    with torch.no_grad():
        want = family["model"](tokens).logits
        got = tt.forward(cfg.replace(dtype="float32"), params, tokens,
                         device=CPU)
    torch.testing.assert_close(got, want, atol=LOGITS_ATOL, rtol=0)


def test_to_state_dict_matches_jax(family):
    cfg, params = tconv.from_hf(family["dir"], device=CPU, master=True)
    got = tconv.to_state_dict(cfg, params)
    want = jconv.to_state_dict(family["jcfg"], jax.tree.map(
        np.asarray, family["jparams"]))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # It loads back into the transformers model strictly, but for Phi3,
    # whose fused q/k/v and gate/up the reference exports unfused.
    if family["name"] == "phi3":
        assert set(got) != set(family["model"].state_dict())
    else:
        family["model"].load_state_dict(got)


def test_defaults_deleted_config_matches_autoconfig(family, tmp_path):
    """A config.json without the keys that equal its class's defaults
    (as tools other than transformers may write it) maps to the config
    AutoConfig gives: the reader fills each family's defaults."""
    with open(os.path.join(family["dir"], "config.json")) as f:
        raw = json.load(f)
    cls = transformers.CONFIG_MAPPING[raw["model_type"]]
    defaults = cls().to_dict()
    keep = {"model_type", "architectures"}
    pruned = {k: v for k, v in raw.items()
              if k in keep or k not in defaults or defaults[k] != v}
    assert len(pruned) < len(raw)
    (tmp_path / "config.json").write_text(json.dumps(pruned))
    want = jconv.config_from_hf(transformers.AutoConfig.from_pretrained(
        str(tmp_path)))
    got = tconv.config_from_hf(str(tmp_path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_sharded_directory_loads_as_one(tmp_path):
    model = _model("mixtral")
    model.save_pretrained(str(tmp_path), safe_serialization=True,
                          max_shard_size="100KB")
    assert os.path.exists(tmp_path / st.SAFE_INDEX)
    assert len([n for n in os.listdir(tmp_path)
                if n.endswith(".safetensors")]) > 1
    cfg, got = tconv.from_hf(str(tmp_path), device=CPU, master=True)
    _tree_equal(got, tconv.from_hf(model, device=CPU, master=True)[1])
    # pytorch_model.bin directories load too.
    bin_dir = tmp_path / "bin"
    model.save_pretrained(str(bin_dir), safe_serialization=False)
    _tree_equal(tconv.from_hf(str(bin_dir), device=CPU, master=True)[1],
                got)


def test_deepseek_raises(tmp_path):
    """DeepSeek converts (tests/test_torch_mla.py), but what the reference
    cannot represent still raises, as it does there: an all-MoE stack, an
    attention bias, and a quantized checkpoint."""
    tiny = dict(vocab_size=128, hidden_size=64, intermediate_size=176,
                num_hidden_layers=2, num_attention_heads=4, kv_lora_rank=16,
                q_lora_rank=None, qk_nope_head_dim=16, qk_rope_head_dim=8,
                v_head_dim=16, first_k_dense_replace=2)
    for over, match in ((dict(first_k_dense_replace=0), "all-MoE"),
                        (dict(attention_bias=True), "attention_bias")):
        hf = transformers.DeepseekV2Config(**{**tiny, **over})
        with pytest.raises(NotImplementedError, match=match):
            jconv.config_from_hf(hf)
        with pytest.raises(NotImplementedError, match=match):
            tconv.config_from_hf(hf)
    hf = transformers.DeepseekV2Config(**tiny)
    hf.quantization_config = {"quant_method": "fp8"}
    hf.save_pretrained(str(tmp_path))
    with pytest.raises(NotImplementedError, match="quantized"):
        tconv.from_hf(str(tmp_path), device=CPU)


# --------------------------------------------------------------------------
# DeepSeek conversion
# --------------------------------------------------------------------------

_DS_TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=96,
                num_hidden_layers=3, num_attention_heads=4,
                num_key_value_heads=4, kv_lora_rank=32,
                qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                moe_intermediate_size=32, max_position_embeddings=256,
                rms_norm_eps=1e-6, attn_implementation="eager")

# name -> (config class, model class, config kwargs over _DS_TINY, seed)
DEEPSEEK = {
    # V2: greedy softmax gate, full-rank queries, first layer dense.
    "deepseek-v2": ("DeepseekV2Config", "DeepseekV2ForCausalLM",
                    dict(q_lora_rank=None, first_k_dense_replace=1,
                         n_routed_experts=4, num_experts_per_tok=2,
                         n_shared_experts=1, routed_scaling_factor=1.5),
                    20),
    # V3: sigmoid gate with correction biases and groups, low-rank q.
    "deepseek-v3": ("DeepseekV3Config", "DeepseekV3ForCausalLM",
                    dict(q_lora_rank=24, first_k_dense_replace=1,
                         n_routed_experts=8, num_experts_per_tok=2,
                         n_shared_experts=1, n_group=2, topk_group=1,
                         routed_scaling_factor=2.5), 21),
    # Every layer dense: the MLA model that exports back.
    "deepseek-v2-dense": ("DeepseekV2Config", "DeepseekV2ForCausalLM",
                          dict(q_lora_rank=24, first_k_dense_replace=3,
                               n_routed_experts=4, num_experts_per_tok=2),
                          22),
}


@pytest.fixture(scope="module", params=sorted(DEEPSEEK))
def deepseek(request, tmp_path_factory):
    """A tiny DeepSeek model built from its transformers class (nothing
    downloaded), saved once, with the JAX package's conversion of it."""
    name = request.param
    cfg_cls, model_cls, over, seed = DEEPSEEK[name]
    hf_cfg = getattr(transformers, cfg_cls)(**{**_DS_TINY, **over})
    torch.manual_seed(seed)
    model = getattr(transformers, model_cls)(hf_cfg).eval()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if "norm" in pname:
                p.add_(0.3 * torch.randn(p.shape, generator=gen))
        for pname, b in model.named_buffers():
            if "e_score_correction_bias" in pname:
                b.copy_(0.1 * torch.randn(b.shape, generator=gen))
    path = str(tmp_path_factory.mktemp(name))
    model.save_pretrained(path, safe_serialization=True)
    jcfg, jparams = jconv.from_hf(path)
    return dict(name=name, model=model, dir=path, jcfg=jcfg, 
                jparams=jax.tree.map(np.asarray, jparams))


def test_deepseek_from_hf_matches_jax_and_transformers(deepseek):
    """The DeepSeek config and weights convert as the JAX package converts
    them (the two-stack tree of a first-k-dense model lands per layer),
    and the port's forward on them gives transformers' logits."""
    cfg, params = tconv.from_hf(deepseek["dir"], device=CPU, master=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(deepseek["jcfg"])
    assert tconv.config_from_hf(deepseek["model"].config) == cfg
    want = params_from_jax(cfg, deepseek["jparams"], device=CPU, master=True)
    for got_l, want_l in zip(params["layers"], want["layers"]):
        assert set(got_l) == set(want_l)
        for k in want_l:
            assert torch.equal(got_l[k], want_l[k]), k
    for k in ("embed", "final_norm", "lm_head"):
        assert torch.equal(params[k], want[k]), k
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 12)))
    with torch.no_grad():
        ref = deepseek["model"](tokens).logits
        got = tt.forward(cfg.replace(dtype="float32"), params, tokens,
                         device=CPU)
    torch.testing.assert_close(got, ref, atol=LOGITS_ATOL, rtol=0)


def test_deepseek_to_state_dict_matches_jax(deepseek):
    """A dense-MLP MLA model exports under DeepSeek's names, as the JAX
    package exports it, and loads back into transformers strictly; MLA
    with MoE layers is refused by both."""
    cfg, params = tconv.from_hf(deepseek["dir"], device=CPU, master=True)
    jtree = jax.tree.map(np.asarray, deepseek["jparams"])
    if cfg.moe is not None:
        with pytest.raises(NotImplementedError):
            jconv.to_state_dict(deepseek["jcfg"], jtree)
        with pytest.raises(NotImplementedError, match="MLA"):
            tconv.to_state_dict(cfg, params)
        return
    got = tconv.to_state_dict(cfg, params)
    want = jconv.to_state_dict(deepseek["jcfg"], jtree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    deepseek["model"].load_state_dict(got)



def test_deepseek_convert_then_generate_native_dir(deepseek, tmp_path):
    """`convert` of a DeepSeek directory writes a native one that
    `generate --native-dir` serves over the latent cache: the tokens of
    Engine on from_hf's parameters."""
    out = str(tmp_path / "native")
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main(["convert", "--hf-dir", deepseek["dir"], "--out",
                         out, "--device", CPU]) == 0
        assert cli.main(["generate", "--device", CPU, "--native-dir", out,
                         "--prompt", "5,9,2,31", "--max-new", "6",
                         "--temperature", "0"]) == 0
    _, gen = [json.loads(x) for x in buf.getvalue().splitlines()]
    cfg, params = tconv.from_hf(deepseek["dir"], device=CPU)
    ncfg, nparams = cli._load_native(out, CPU)
    assert ncfg == cfg and ncfg.mla is not None
    _tree_equal(nparams, params)
    want = Engine(cfg, params, temperature=0.0, device=CPU).generate(
        torch.tensor([[5, 9, 2, 31]]), max_new_tokens=6)
    assert gen["tokens"] == want.tokens[0].tolist()

def test_missing_key_message():
    model = _model("llama-gqa")
    cfg = tconv.config_from_hf(model.config)
    sd = {k: v for k, v in model.state_dict().items() if "q_proj" not in k}
    with pytest.raises(KeyError, match="q_proj"):
        tconv.params_from_state_dict(sd, cfg, device=CPU)
    with pytest.raises(ValueError, match="model_type"):
        tconv.HFConfig({"hidden_size": 64})


def _tensors(seed):
    g = torch.Generator().manual_seed(seed)
    return {
        "f32": torch.randn(3, 4, generator=g),
        "f16": torch.randn(2, 5, generator=g).half(),
        "bf16": torch.randn(7, generator=g).bfloat16(),
        "i64": torch.arange(-3, 3).reshape(2, 3),
        "i32": torch.arange(5, dtype=torch.int32),
        "i8": torch.tensor([-128, 0, 127], dtype=torch.int8),
        "u8": torch.tensor([0, 255], dtype=torch.uint8),
        "bool": torch.tensor([True, False, True]),
        "empty": torch.empty(0, 4),
        "empty_bf16": torch.empty(3, 0, dtype=torch.bfloat16),
        "scalar": torch.tensor(2.5),
    }


@pytest.mark.parametrize("direction", ["write", "read"])
def test_safetensors_against_the_package(tmp_path, direction):
    """Every dtype, empty tensors and metadata: the port's files load in
    `safetensors`, and its files load in the port."""
    from safetensors import safe_open
    from safetensors.torch import load_file, save_file

    want = _tensors(1)
    path = str(tmp_path / "x.safetensors")
    meta = {"format": "pt", "note": "ünïcode"}
    if direction == "write":
        st.save_file(want, path, meta)
        got = load_file(path)
        with safe_open(path, "pt") as f:
            assert f.metadata() == meta
    else:
        save_file(want, path, metadata=meta)
        f = st.SafetensorsFile(path)
        got = {k: f.tensor(k) for k in f.keys()}
        assert f.metadata == meta
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_save_sharded_writes_an_index(tmp_path):
    want = _tensors(2)
    files = st.save_sharded(want, str(tmp_path), shards=2)
    assert files[-1] == st.SAFE_INDEX and len(files) == 3
    sd = st.CheckpointDir(str(tmp_path))
    assert sorted(sd) == sorted(want)
    for k in want:
        assert torch.equal(sd[k], want[k]), k


def test_convert_then_generate_native_dir(tmp_path):
    """`convert` writes a native directory that `generate --native-dir`
    serves: the tokens of Engine on from_hf's parameters."""
    model = _model("llama-gqa")
    hf_dir, out = str(tmp_path / "hf"), str(tmp_path / "native")
    model.save_pretrained(hf_dir, safe_serialization=True)
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main(["convert", "--hf-dir", hf_dir, "--out", out,
                         "--device", CPU]) == 0
        assert cli.main(["generate", "--device", CPU, "--native-dir", out,
                         "--prompt", "5,9,2,31", "--max-new", "6",
                         "--temperature", "0"]) == 0
    report, gen = [json.loads(x) for x in buf.getvalue().splitlines()]
    assert report["out"] == out and report["model_type"] == "dense"
    cfg, params = tconv.from_hf(hf_dir, device=CPU)
    assert report["params"] == sum(
        t.numel() for t in [params["embed"], params["final_norm"],
                            params["lm_head"]]
        + [t for lp in params["layers"] for t in lp.values()])
    ncfg, nparams = cli._load_native(out, CPU)
    assert ncfg == cfg
    _tree_equal(nparams, params)
    want = Engine(cfg, params, temperature=0.0, device=CPU).generate(
        torch.tensor([[5, 9, 2, 31]]), max_new_tokens=6)
    assert gen["tokens"] == want.tokens[0].tolist()


@pytest.mark.parametrize("name", ["gptoss", "llama3-rope"])
def test_jax_convert_config_rehydrates(tmp_path, name):
    """The config.json the JAX package's `convert` writes (nested MoE,
    yarn and llama3 configs as dicts) rehydrates to the port's config."""
    from shellac_tpu import cli as jcli

    hf_dir = str(tmp_path / "hf")
    _model(name).save_pretrained(hf_dir, safe_serialization=True)
    with redirect_stdout(io.StringIO()):
        jcli.main(["convert", "--hf-dir", hf_dir, "--out",
                   str(tmp_path / "native")])
    with open(tmp_path / "native" / "config.json") as f:
        got = cli._native_config(json.load(f))
    assert got == tconv.config_from_hf(hf_dir)


def test_chip_smoke_gptoss_20b_from_the_published_keys():
    import chip_smoke
    from shellac_tpu_torch.config import ModelConfig, MoEConfig, YarnConfig

    got = chip_smoke.gptoss_20b()
    by_hand = ModelConfig(
        vocab_size=201088, d_model=2880, n_layers=24, n_heads=64,
        n_kv_heads=8, head_dim=64, d_ff=2880, max_seq_len=131072,
        rope_theta=150000.0, norm_eps=1e-5, tie_embeddings=False,
        attn_window=128, attn_pattern=("window", "full"), attn_bias=True,
        attn_out_bias=True, attn_sink=True, remat=False,
        rope_yarn=YarnConfig(factor=32.0,
                             original_max_position_embeddings=4096,
                             beta_fast=32.0, beta_slow=1.0, truncate=False),
        moe=MoEConfig(num_experts=32, num_experts_per_token=4,
                      d_ff_expert=2880, scoring="softmax_topk",
                      expert_bias=True, gate_limit=7.0, expert_act="gptoss",
                      router_aux_loss_weight=0.9, dropless=True),
    ).validate()
    assert got == by_hand
    want = jconv.config_from_hf(transformers.GptOssConfig(
        **{k: v for k, v in chip_smoke.GPTOSS_20B_HF.items()
           if k not in ("architectures", "model_type")}))
    assert dataclasses.asdict(got.replace(remat=True)) == \
        dataclasses.asdict(want)
