"""The PyTorch port's model and engine against the JAX package's, on the CPU.

Parameters come from the JAX package's init_params (made non-trivial
with seeded numpy noise on norms, biases and sinks), cross to the port as
numpy through `params_from_jax`, and both packages run the same token
inputs in fp32. Logits agree to atol 1e-4 (fp32 through a few layers,
summation order only differs). Greedy tokens are compared where the JAX
top-2 logit margin is at least twice that tolerance — there logits
within 1e-4 cannot swap the argmax — up to each row's first step below
it, and most steps must qualify; a mismatch is then a real divergence,
not backend greedy drift.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shellac_tpu.inference.engine import Engine as JEngine
from shellac_tpu.inference.kvcache import init_cache as jinit_cache
from shellac_tpu.models import transformer as jt
from shellac_tpu.models.registry import get_model_config as jget
from shellac_tpu_torch.inference.cache import init_cache
from shellac_tpu_torch.inference.engine import Engine
from shellac_tpu_torch.models import transformer as tt
from shellac_tpu_torch.models.from_jax import params_from_jax
from shellac_tpu_torch.models.registry import get_model_config

import jax_params

REPO = Path(__file__).resolve().parent.parent
LOGIT_ATOL = 1e-4
MARGIN = 2 * LOGIT_ATOL
CPU = "cpu"


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


_PAIRS = {}


def _pair(name, **over):
    """(jax cfg, port cfg, jax params, port params) for a preset in fp32,
    made once per (name, overrides) and shared by the tests."""
    key = (name, tuple(sorted(over.items())))
    if key not in _PAIRS:
        _PAIRS[key] = _make_pair(name, **over)
    return _PAIRS[key]


def _make_pair(name, **over):
    jc = jget(name).replace(dtype="float32", **over)
    tc = get_model_config(name).replace(dtype="float32", **over)
    p = jax_params.init_params(jc)
    rng = _rng("params", name)
    for k, v in p["layers"].items():
        if k in ("sinks", "bq", "bk", "bv", "bo") or k.endswith("norm"):
            p["layers"][k] = (0.3 * rng.standard_normal(v.shape)).astype(
                np.float32)
    p["final_norm"] = (0.3 * rng.standard_normal(
        p["final_norm"].shape)).astype(np.float32)
    return jc, tc, jax.tree.map(jnp.asarray, p), params_from_jax(tc, p, CPU)


def _tokens(rng, vocab, b, s):
    return rng.integers(0, vocab, size=(b, s)).astype(np.int32)


def test_params_from_jax_round_trip():
    """Every JAX leaf lands, per layer, with the storage dtype the port's
    forward reads (matmul weights in the compute dtype, norms fp32)."""
    name = "tiny-gemma2"
    jc = jget(name)  # bf16 compute, fp32 master params
    tc = get_model_config(name)
    # The JAX layout (eval_shape, no draw to compile) filled from numpy.
    rng = _rng("round_trip", name)
    p = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype),
        jax.eval_shape(lambda: jt.init_params(jc, jax.random.PRNGKey(1))))
    tp = params_from_jax(tc, p, CPU)
    assert len(tp["layers"]) == tc.n_layers
    np.testing.assert_array_equal(
        tp["embed"].float().numpy(),
        p["embed"].astype(jnp.bfloat16).astype(np.float32))
    for i, lp in enumerate(tp["layers"]):
        assert set(lp) == set(p["layers"])
        for k, t in lp.items():
            src = p["layers"][k][i]
            if k in tt.FP32_KEYS:
                assert t.dtype == torch.float32
                np.testing.assert_array_equal(t.numpy(), src)
            else:
                assert t.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    t.float().numpy(),
                    src.astype(jnp.bfloat16).astype(np.float32))
    bad = dict(p, layers={k: v for k, v in p["layers"].items()
                          if k != "wq"})
    with pytest.raises(ValueError):
        params_from_jax(tc, bad, CPU)


def test_init_params_layout_matches_jax():
    jc, tc = jget("tiny-gemma3"), get_model_config("tiny-gemma3")
    # The layout alone: shapes from eval_shape, with no draw to compile.
    jp = jax.eval_shape(lambda: jt.init_params(jc, jax.random.PRNGKey(0)))
    tp = tt.init_params(tc, seed=0, device=CPU)
    assert tp["embed"].shape == jp["embed"].shape
    for k, v in jp["layers"].items():
        assert tuple(tp["layers"][0][k].shape) == v.shape[1:], k
    assert tt.num_params(tp) == sum(x.size for x in jax.tree.leaves(jp))


_PRESETS = ["tiny", "tiny-gqa", "tiny-gemma2", "tiny-gemma3"]


@pytest.mark.parametrize("name", _PRESETS)
def test_forward_and_cached_logits_match_jax(name):
    jc, tc, jp, tp = _pair(name)
    rng = _rng("fwd", name)
    b, s, max_len = 2, 24, 40
    toks = _tokens(rng, tc.vocab_size, b, s)
    want = np.asarray(jax.jit(lambda p, t: jt.forward(jc, p, t))(jp, toks))
    got = tt.forward(tc, tp, torch.from_numpy(toks), device=CPU).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL)

    # Ragged prefill into an empty cache, then single-token decode steps
    # (the JAX references jitted: one compile each).
    plen = np.array([s, 13], np.int32)
    prefill = jax.jit(lambda p, t, c, n: jt.forward_with_cache(
        jc, p, t, c, new_tokens_len=n, fresh_cache=True))
    decode = jax.jit(lambda p, t, c: jt.forward_with_cache(jc, p, t, c))
    jl, jcache = prefill(jp, toks, jinit_cache(jc, b, max_len), plen)
    tcache = init_cache(tc, b, max_len, torch.device(CPU))
    tl, tcache = tt.forward_with_cache(
        tc, tp, torch.from_numpy(toks), tcache,
        new_tokens_len=torch.from_numpy(plen), fresh_cache=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    for _ in range(3):
        nxt = _tokens(rng, tc.vocab_size, b, 1)
        jl, jcache = decode(jp, nxt, jcache)
        tl, tcache = tt.forward_with_cache(tc, tp, torch.from_numpy(nxt),
                                           tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
    np.testing.assert_array_equal(tcache.lengths.numpy(),
                                  np.asarray(jcache.lengths))
    # The port writes the cache in place, in the JAX head-major layout.
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               atol=1e-5)


def _greedy_margins(jc, jp, toks, plen, gen_tokens, penalty):
    """The JAX top-2 margin of the (penalized) logits behind every greedy
    token, from one full forward of each row's prompt plus its generated
    tokens (right-padded into one batch; causal rows ignore the pad)."""
    from shellac_tpu.ops.sampling import repetition_penalty

    b, steps = gen_tokens.shape
    seqs = np.zeros((b, toks.shape[1] + steps - 1), np.int32)
    for r in range(b):
        n = int(plen[r])
        seqs[r, :n + steps - 1] = np.concatenate(
            [toks[r, :n], gen_tokens[r, :-1]])
    logits = np.asarray(jax.jit(lambda p, t: jt.forward(jc, p, t))(jp, seqs))
    margins = np.zeros((b, steps), np.float32)
    for r in range(b):
        n = int(plen[r])
        for t in range(steps):
            seen = np.zeros(jc.vocab_size, bool)
            seen[seqs[r, :n + t]] = True
            row = np.asarray(repetition_penalty(
                jnp.asarray(logits[r, n - 1 + t]), jnp.asarray(seen),
                penalty))
            top2 = np.sort(row)[-2:]
            margins[r, t] = top2[1] - top2[0]
    return margins


@pytest.mark.parametrize("name,penalty", [("tiny", 1.0), ("tiny-gqa", 1.0),
                                          ("tiny-gqa", 1.3)])
def test_engine_greedy_matches_jax(name, penalty):
    jc, tc, jp, tp = _pair(name)
    rng = _rng("gen", name, penalty)
    b, s, steps = 3, 16, 8
    toks = _tokens(rng, tc.vocab_size, b, s)
    plen = np.array([16, 5, 11], np.int32)
    want = JEngine(jc, jp, temperature=0.0, max_len=48,
                   repetition_penalty=penalty).generate(
        jnp.asarray(toks), jnp.asarray(plen), max_new_tokens=steps)
    got = Engine(tc, tp, temperature=0.0, max_len=48,
                 repetition_penalty=penalty, device=CPU).generate(
        torch.from_numpy(toks), torch.from_numpy(plen), max_new_tokens=steps)
    jtoks, jlp = np.asarray(want.tokens), np.asarray(want.logprobs)
    low = _greedy_margins(jc, jp, toks, plen, jtoks, penalty) < MARGIN
    upto = np.where(low.any(1), low.argmax(1) + 1, steps)
    assert upto.sum() >= 0.75 * b * steps, upto
    for r in range(b):
        n = upto[r]
        np.testing.assert_array_equal(got.tokens[r, :n].numpy(), jtoks[r, :n])
        np.testing.assert_allclose(got.logprobs[r, :n].numpy(), jlp[r, :n],
                                   atol=LOGIT_ATOL)


_STATIC_STEPS = [1, 2, 5]
_STATIC = {}


def _static_reference():
    """The static-step cases' prompts and the JAX engine's greedy run of
    the most steps over them, with its top-2 margins, made once and
    shared: a greedy run of fewer steps is its prefix."""
    if not _STATIC:
        jc, tc, jp, _ = _pair("tiny-gqa")
        toks = _tokens(_rng("static"), tc.vocab_size, 3, 12)
        plen = np.array([12, 4, 9], np.int32)
        want = JEngine(jc, jp, temperature=0.0, max_len=32).generate(
            jnp.asarray(toks), jnp.asarray(plen),
            max_new_tokens=max(_STATIC_STEPS))
        jtoks = np.asarray(want.tokens)
        _STATIC.update(toks=toks, plen=plen, jtoks=jtoks,
                       jlp=np.asarray(want.logprobs),
                       margins=_greedy_margins(jc, jp, toks, plen, jtoks,
                                               1.0))
    return _STATIC


@pytest.mark.parametrize("steps", _STATIC_STEPS)
def test_engine_static_step_matches_jax(steps):
    """Engine.generate's decode step reads its input token from a fixed
    tensor and writes the cache, `seen`, the next token and its logprob in
    place (what its CUDA graph replays on the card): the first step, the
    warm-up step and the steps after it give the JAX engine's tokens and
    logprobs, and the cache keeps its tensors."""
    jc, tc, jp, tp = _pair("tiny-gqa")
    ref = _static_reference()
    toks, plen = ref["toks"], ref["plen"]
    eng = Engine(tc, tp, temperature=0.0, max_len=32, device=CPU)
    first, cache, seen = eng._prefill_impl(torch.from_numpy(toks),
                                           torch.from_numpy(plen))
    held = [(t, t.data_ptr()) for t in (cache.k, cache.v, cache.lengths,
                                        seen)]
    got = eng._decode_impl(first, cache, steps,
                           torch.Generator().manual_seed(0), seen)
    assert all(t.data_ptr() == p for t, p in held)
    np.testing.assert_array_equal(cache.lengths.numpy(), plen + steps - 1)
    assert got.tokens.dtype == torch.int32 and got.tokens.is_contiguous()
    jtoks, jlp = ref["jtoks"][:, :steps], ref["jlp"][:, :steps]
    low = ref["margins"][:, :steps] < MARGIN
    upto = np.where(low.any(1), low.argmax(1) + 1, steps)
    assert upto.sum() >= 0.75 * 3 * steps, upto
    for r in range(3):
        n = upto[r]
        np.testing.assert_array_equal(got.tokens[r, :n].numpy(), jtoks[r, :n])
        np.testing.assert_allclose(got.logprobs[r, :n].numpy(), jlp[r, :n],
                                   atol=LOGIT_ATOL)
        # Every token, at or past the margin, is in the seen mask.
        assert bool(seen[r, got.tokens[r].long()].all())


def test_engine_decode_past_max_len_raises_before_writing():
    """The whole decode is checked against max_len before its first step
    (on the card the step's own guard runs at capture only)."""
    tc = get_model_config("tiny")
    eng = Engine(tc, tt.init_params(tc, device=CPU), max_len=16,
                 temperature=0.0, device=CPU)
    toks = torch.zeros((1, 12), dtype=torch.int64)
    first, cache, seen = eng._prefill_impl(
        toks, torch.tensor([12], dtype=torch.int32))
    with pytest.raises(ValueError, match="max_len"):
        eng._decode_impl(first, cache, 6, None, seen)
    assert int(cache.lengths[0]) == 12
    assert eng.generate(toks, max_new_tokens=5).tokens.shape == (1, 5)


def test_engine_seen_mask_is_a_logical_or_scatter():
    """A token id repeated in the pad tail must not clear the hit a real
    prompt position set (the JAX .at[].max scatter)."""
    tc = get_model_config("tiny")
    eng = Engine(tc, tt.init_params(tc, device=CPU), device=CPU)
    toks = torch.tensor([[7, 9, 9, 7, 3]])
    _, _, seen = eng._prefill_impl(toks, torch.tensor([2], dtype=torch.int32))
    assert seen[0, 7] and seen[0, 9] and not seen[0, 3]
    assert int(seen.sum()) == 2


def test_engine_sampling_self_consistent_and_topk1_is_greedy():
    jc, tc, jp, tp = _pair("tiny-gqa")
    toks = torch.from_numpy(_tokens(_rng("samp"), tc.vocab_size, 2, 12))

    def run(**kw):
        g = torch.Generator().manual_seed(11)
        return Engine(tc, tp, max_len=32, device=CPU, **kw).generate(
            toks, max_new_tokens=6, generator=g).tokens

    assert torch.equal(run(temperature=0.9, top_p=0.9),
                       run(temperature=0.9, top_p=0.9))
    assert torch.equal(run(temperature=0.9, top_k=1),
                       run(temperature=0.0))


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card path is moot")
    cfg = get_model_config("tiny")
    params = tt.init_params(cfg, device=CPU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, params, device=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.forward(cfg, params, torch.zeros(1, 4, dtype=torch.int64))
    # Any tree of the layout: zeros, with no draw to compile.
    jp = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), jax.eval_shape(
        lambda: jt.init_params(jget("tiny"), jax.random.PRNGKey(0))))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(cfg, jp)


@pytest.mark.parametrize("name", ["tiny-deepseek", "tiny-mla"])
def test_unported_models_raise(name):
    """The MLA presets the port once refused construct and run: a forward,
    and a prefill then a decode step through their latent cache, whose
    last logits equal the forward's over the same tokens."""
    cfg = get_model_config(name).replace(dtype="float32")
    params = tt.init_params(cfg, device=CPU)
    toks = torch.arange(1, 8).reshape(1, 7)
    full = tt.forward(cfg, params, toks, device=CPU)
    assert full.shape == (1, 7, cfg.vocab_size)
    cache = init_cache(cfg, 1, 16, torch.device(CPU))
    assert cache.k.shape[2:] == (1, 16, cfg.mla.cache_dim)
    _, cache = tt.forward_with_cache(cfg, params, toks[:, :6], cache,
                                     fresh_cache=True)
    step, _ = tt.forward_with_cache(cfg, params, toks[:, 6:], cache)
    torch.testing.assert_close(step[0, -1], full[0, -1], atol=1e-4, rtol=0)


def test_unported_options_raise():
    cfg = get_model_config("tiny")
    params = tt.init_params(cfg, device=CPU)
    for kw in ({"kv_quant": "int8", "rolling_window": True},
               {"rolling_window": True}, {"mesh": object()}):
        with pytest.raises(NotImplementedError):
            Engine(cfg, params, device=CPU, **kw)
    assert Engine(cfg, params, kv_quant="int8", device=CPU).kv_quant == "int8"


def test_cache_write_past_max_len_raises():
    cfg = get_model_config("tiny")
    params = tt.init_params(cfg, device=CPU)
    cache = init_cache(cfg, 1, 8, torch.device(CPU))
    _, cache = tt.forward_with_cache(
        cfg, params, torch.zeros(1, 6, dtype=torch.int64), cache,
        fresh_cache=True)
    with pytest.raises(ValueError, match="max_len"):
        tt.forward_with_cache(cfg, params,
                              torch.zeros(1, 3, dtype=torch.int64), cache)


def test_import_leaves_jax_out():
    """Every module of the port, found by walking the package, imports
    without pulling in jax, optax, flax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys, shellac_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "shellac_tpu_torch.__path__, 'shellac_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "roots = ('jax', 'jaxlib', 'optax', 'flax', 'shellac_tpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in roots]\n"
        "need = {'shellac_tpu_torch.' + n for n in ('models.convert', "
        "'utils.safetensors', 'training.checkpoint', "
        "'training.resilience', 'training.tokenizer', 'ops.qtrain', "
        "'training.data', 'training.evaluate', 'training.loop', "
        "'obs.train', 'utils.metrics', 'utils.tracing')}\n"
        "print(len(names), bad, need - set(names))\n"
        "sys.exit(1 if bad or need - set(names) or len(names) < 20 "
        "else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=torch_threads.ENV,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _unembed_pair(name, over, seed):
    """The bf16-compute head of a preset in both packages (fp32 masters,
    the final norm made non-trivial) and seeded inputs: x (2, 5, D) in
    bf16 and an fp32 cotangent for the logits."""
    jc = jget(name).replace(**over)
    tc = get_model_config(name).replace(**over)
    p = jax.tree.map(np.asarray, jt.init_params(jc, jax.random.PRNGKey(seed)))
    rng = _rng("unembed", name, seed)
    p["final_norm"] = (1.0 + 0.3 * rng.standard_normal(
        p["final_norm"].shape)).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((2, 5, jc.d_model)),
                    dtype=jnp.bfloat16)
    g = rng.standard_normal((2, 5, jc.vocab_size)).astype(np.float32)
    return jc, tc, p, x, g


# The head sums the same bf16 products in fp32 in both packages, in
# another order: logits within 1e-5 of their largest magnitude (measured
# about 2e-7). The gradients are fp32 sums rounded to bf16, so an
# element near a rounding boundary may land one bf16 ulp (2^-8 of
# itself) apart: 2e-3 of their largest magnitude (measured 3e-4 at most).
_HEAD_TOL = {"logits": (1e-5, 0.0), "grad": (2e-3, 0.0)}


def _graph_nodes(t):
    """Names of the autograd nodes that produced t."""
    seen, todo = {}, [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None and id(fn) not in seen:
            seen[id(fn)] = type(fn).__name__
            todo.extend(f for f, _ in fn.next_functions)
    return set(seen.values())


def _head_close(got, want, kind, what):
    atol, rtol = _HEAD_TOL[kind]
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("name,over", [("tiny", {}),
                                       ("tiny", {"tie_embeddings": False}),
                                       ("tiny-gemma2", {})])
def test_unembed_bf16_and_its_gradients_match_jax(name, over):
    """The LM head in the bf16 compute dtype (`LMHeadFunction`): logits
    and the gradients of sum(logits * g) with respect to x, the output
    weights (tied embedding or lm_head, fp32 masters) and the final norm,
    against the JAX package's `unembed` and `jax.grad` of it."""
    jc, tc, p, x, g = _unembed_pair(name, over, seed=3)
    wkey = "embed" if jc.tie_embeddings else "lm_head"

    def jloss(x, w, norm):
        jp = dict(p, **{wkey: w, "final_norm": norm})
        logits = jt.unembed(jc, jp, x)
        return jnp.sum(logits * g), logits

    (_, jlogits), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        x, jnp.asarray(p[wkey]), jnp.asarray(p["final_norm"]))

    tp = params_from_jax(tc, p, CPU, master=True)
    xt = torch.from_numpy(np.asarray(x, dtype=np.float32)).to(
        torch.bfloat16).requires_grad_()
    leaves = [xt, tp[wkey].requires_grad_(),
              tp["final_norm"].requires_grad_()]
    logits = tt.unembed(tc, tp, xt)
    assert "LMHeadFunctionBackward" in _graph_nodes(logits)
    assert logits.dtype == torch.float32
    tgrads = torch.autograd.grad((logits * torch.from_numpy(g)).sum(),
                                 leaves)
    _head_close(logits.detach(), jlogits, "logits", "logits")
    assert tgrads[0].dtype == torch.bfloat16
    # The weights' gradient in their own layout (a tied head reads the
    # embedding transposed), as torch's mm backward gives it: the
    # optimizer's fused multi-tensor passes need it contiguous.
    assert tgrads[1].is_contiguous()
    for what, got, want in zip(("dx", "d" + wkey, "dfinal_norm"), tgrads,
                               jgrads):
        _head_close(got.float(), want, "grad", what)


def test_unembed_fp32_keeps_the_fp32_product():
    """An fp32 compute dtype takes the plain fp32 product (no
    `LMHeadFunction`), bitwise equal to x @ w in fp32."""
    _, tc, p, x, _ = _unembed_pair("tiny", {"dtype": "float32"}, seed=4)
    tp = params_from_jax(tc, p, CPU)
    xt = torch.from_numpy(np.asarray(x, dtype=np.float32))
    with torch.no_grad():
        logits = tt.unembed(tc, tp, xt)
        h = tt.rms_norm(xt, tp["final_norm"], tc.norm_eps)
        want = h @ tt.output_weights(tc, tp)
    xt.requires_grad_()
    nodes = _graph_nodes(tt.unembed(tc, tp, xt))
    assert "MmBackward0" in nodes and "LMHeadFunctionBackward" not in nodes
    assert logits.dtype == torch.float32
    assert torch.equal(logits, want)
