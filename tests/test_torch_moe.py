"""The port's mixture-of-experts layers against the JAX package's, on the CPU.

Ops (`ops/moe.py`): routing, the capacity-bucket FFN with and without
drops, the grouped (sorted-segment) FFN, the three scorings, group-limited
routing and the GPT-OSS activation run the same numpy-seeded fp32 inputs
through both packages; slots agree exactly, values to 1e-5. Router
weights with two equal columns make every token's scores tie, so the
top-k order on ties (the lower expert first, as `jax.lax.top_k`) decides
the slots.

Models: the MoE presets (uniform, shared experts, interleaved, GPT-OSS's
shape, and a first-k-dense sigmoid layout) through `forward(return_aux=
True)` and the cached forward, logits to 1e-4, aux terms to 1e-5. Engines:
`Engine.generate` and `PagedBatchingEngine` (with a chunk continuation
and a prefix hit) against the JAX engines on `tiny-gptoss` (dropless) and
`tiny-moe` (fresh prefills drop, padding tokens included), greedy tokens
compared while the JAX top-2 margin is at least twice the logit tolerance.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shellac_tpu.config import MoEConfig as JMoE
from shellac_tpu.inference import batching as jbatching
from shellac_tpu.inference.engine import Engine as JEngine
from shellac_tpu.inference.kvcache import init_cache as jinit_cache
from shellac_tpu.models import transformer as jt
from shellac_tpu.models.registry import get_model_config as jget
from shellac_tpu.ops import moe as jmoe
from shellac_tpu_torch.config import MoEConfig
from shellac_tpu_torch.inference import batching
from shellac_tpu_torch.inference.cache import init_cache
from shellac_tpu_torch.inference.engine import Engine
from shellac_tpu_torch.models import transformer as tt
from shellac_tpu_torch.models.from_jax import params_from_jax
from shellac_tpu_torch.models.registry import get_model_config
from shellac_tpu_torch.ops import moe
from shellac_tpu_torch.ops.sampling import top_k

CPU = "cpu"
TOL = 1e-5
LOGIT_ATOL = 1e-4
MARGIN = 2 * LOGIT_ATOL


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _t(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------------------
# ops
# --------------------------------------------------------------------------

# name -> (MoEConfig fields, experts with a duplicated router column)
_ROUTES = {
    "softmax": dict(num_experts=4, num_experts_per_token=2),
    "softmax_unnormed_scaled": dict(num_experts=4, num_experts_per_token=2,
                                    norm_topk_prob=False,
                                    routed_scaling_factor=2.5),
    "softmax_groups": dict(num_experts=8, num_experts_per_token=2,
                           n_group=2, topk_group=1),
    "sigmoid_bias_groups": dict(num_experts=8, num_experts_per_token=3,
                                scoring="sigmoid", n_group=2, topk_group=1),
    "sigmoid": dict(num_experts=4, num_experts_per_token=2,
                    scoring="sigmoid", norm_topk_prob=False),
    "softmax_topk_bias": dict(num_experts=4, num_experts_per_token=2,
                              scoring="softmax_topk"),
}


def _route_inputs(case, t=24, d=16):
    kw = _ROUTES[case]
    rng = _rng("route", case)
    e = kw["num_experts"]
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = rng.standard_normal((d, e)).astype(np.float32)
    w[:, 1] = w[:, 0]  # experts 0 and 1 tie for every token
    b = (0.5 * rng.standard_normal(e)).astype(np.float32)
    if kw.get("scoring") not in ("sigmoid", "softmax_topk"):
        b = None
    return kw, x, w, b


_CAPACITIES = [None, 2]
_JAX_ROUTES = {}


def _jax_route(case):
    """The JAX routing of a case's inputs at every capacity, from one
    jitted call (one compile), shared by the capacity cases."""
    if case not in _JAX_ROUTES:
        kw, x, w, b = _route_inputs(case)
        jcfg = JMoE(**kw)
        _JAX_ROUTES[case] = jax.jit(lambda x, w, b: [
            jmoe.route(x, w, jcfg, capacity=c, b_router=b)
            for c in _CAPACITIES])(x, w, b)
    return _JAX_ROUTES[case]


@pytest.mark.parametrize("capacity", _CAPACITIES)
@pytest.mark.parametrize("case", sorted(_ROUTES))
def test_route_matches_jax(case, capacity):
    kw, x, w, b = _route_inputs(case)
    slot, weight, aux, metrics = _jax_route(case)[
        _CAPACITIES.index(capacity)]
    tslot, tweight, taux, tmetrics = moe.route(
        _t(x), _t(w), MoEConfig(**kw), capacity=capacity,
        b_router=None if b is None else _t(b))
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(slot))
    np.testing.assert_allclose(tweight.numpy(), np.asarray(weight),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(taux), float(aux), atol=TOL, rtol=TOL)
    assert set(tmetrics) == set(metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(tmetrics[k]), float(v), atol=TOL,
                                   rtol=TOL)
    if capacity == 2:
        assert float(tmetrics["moe_dropped_frac"]) > 0
    # Without aux the routing is the same and nothing else is computed.
    s2, w2, a2, m2 = moe.route(_t(x), _t(w), MoEConfig(**kw),
                               capacity=capacity,
                               b_router=None if b is None else _t(b),
                               aux=False)
    assert torch.equal(s2, tslot) and torch.equal(w2, tweight)
    assert a2 is None and m2 is None


def test_top_k_orders_ties_as_jax():
    rng = _rng("ties")
    x = rng.integers(-3, 4, size=(50, 16)).astype(np.float32) / 2
    x[0, :3] = [0.0, -0.0, 0.0]
    vals, idx = jax.lax.top_k(jnp.asarray(x), 5)
    tv, ti = top_k(_t(x), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(vals))


def test_top_k_orders_signed_zeros_as_jax():
    """`jax.lax.top_k` ranks +0.0 above -0.0; rows whose top k cuts
    through mixed signed zeros (and rows with NaNs of both signs) must
    give its indices."""
    rng = _rng("signed zeros")
    rows = [
        [-0.0, -0.0, -0.0, 0.0, 0.0, 0.0, -0.0, 0.0],
        [0.0, -0.0, 0.0, -0.0, 0.0, -0.0, 0.0, -0.0],
        [-1.0, -0.0, 2.0, 0.0, -0.0, 0.0, -3.0, 1.0],
        [-0.0, -1e-45, 0.0, 1e-45, -0.0, -1e-45, 0.0, 1e-45],
        [np.nan, -0.0, -np.nan, 0.0, -0.0, 0.0, 1.0, -1.0],
    ]
    signs = np.where(rng.random((11, 8)) < 0.5, -0.0, 0.0)
    x = np.concatenate([np.asarray(rows, np.float32),
                        signs.astype(np.float32)])
    for k in (1, 3, 5, 8):
        vals, idx = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = top_k(_t(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(idx), str(k))
        np.testing.assert_array_equal(np.signbit(tv.numpy()),
                                      np.signbit(np.asarray(vals)), str(k))


# name -> MoEConfig fields of the FFN cases.
_FFNS = {
    "silu": dict(num_experts=4, num_experts_per_token=2,
                 capacity_factor=0.75),
    "gptoss": dict(num_experts=4, num_experts_per_token=2,
                   scoring="softmax_topk", expert_bias=True, gate_limit=0.5,
                   expert_act="gptoss"),
    "sigmoid_groups": dict(num_experts=8, num_experts_per_token=2,
                           scoring="sigmoid", n_group=2, topk_group=2,
                           capacity_factor=0.5),
}


def _ffn_inputs(case, b=2, s=9, d=16, f=24):
    kw = _FFNS[case]
    rng = _rng("ffn", case)
    e = kw["num_experts"]

    def r(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    args = dict(x=r(b, s, d), w_router=r(d, e), w_gate=r(e, d, f, scale=0.3),
                w_up=r(e, d, f, scale=0.3), w_down=r(e, f, d, scale=0.3))
    args["w_router"][:, 1] = args["w_router"][:, 0]
    bias = {}
    if kw.get("scoring") in ("sigmoid", "softmax_topk"):
        bias["b_router"] = r(e, scale=0.5)
    if kw.get("expert_bias"):
        bias.update(b_gate=r(e, f, scale=0.5), b_up=r(e, f, scale=0.5),
                    b_down=r(e, d, scale=0.5))
    return kw, args, bias


_JAX_FFNS = {}


def _jax_ffns(case):
    """The JAX moe_ffn of a case's inputs with and without drops and its
    moe_ffn_grouped, from one jitted call, shared by the cases:
    {drop_tokens or "grouped": (out, aux, metrics)}."""
    if case not in _JAX_FFNS:
        kw, args, bias = _ffn_inputs(case)
        jcfg = JMoE(**kw)
        a = [args[k] for k in ("x", "w_router", "w_gate", "w_up", "w_down")]

        def run(a, b):
            return [jmoe.moe_ffn(*a, jcfg, drop_tokens=True, **b),
                    jmoe.moe_ffn(*a, jcfg, drop_tokens=False, **b),
                    jmoe.moe_ffn_grouped(*a, jcfg, **b)]

        _JAX_FFNS[case] = {
            k: (np.asarray(out), float(aux),
                {m: float(v) for m, v in metrics.items()})
            for k, (out, aux, metrics) in zip(
                (True, False, "grouped"), jax.jit(run)(a, bias))}
    return _JAX_FFNS[case]


def _torch_ffn(fn, kw, args, bias, **extra):
    out, aux, metrics = fn(
        *(_t(args[k]) for k in ("x", "w_router", "w_gate", "w_up",
                                "w_down")),
        MoEConfig(**kw), **{k: _t(v) for k, v in bias.items()}, **extra)
    return out.numpy(), float(aux), {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("drop", [True, False])
@pytest.mark.parametrize("case", sorted(_FFNS))
def test_moe_ffn_matches_jax(case, drop):
    kw, args, bias = _ffn_inputs(case)
    want = _jax_ffns(case)[drop]
    got = _torch_ffn(moe.moe_ffn, kw, args, bias, drop_tokens=drop)
    np.testing.assert_allclose(got[0], want[0], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got[1], want[1], atol=TOL, rtol=TOL)
    assert got[2].keys() == want[2].keys()
    for k in want[2]:
        np.testing.assert_allclose(got[2][k], want[2][k], atol=TOL, rtol=TOL)
    assert (want[2]["moe_dropped_frac"] > 0) == drop


@pytest.mark.parametrize("case", sorted(_FFNS))
def test_moe_ffn_grouped_matches_jax(case):
    kw, args, bias = _ffn_inputs(case)
    want = _jax_ffns(case)["grouped"]
    got = _torch_ffn(moe.moe_ffn_grouped, kw, args, bias)
    np.testing.assert_allclose(got[0], want[0], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got[1], want[1], atol=TOL, rtol=TOL)
    assert got[2] == pytest.approx(want[2], abs=TOL, rel=TOL)
    # Dropless: the grouped product computes the capacity-at-T buckets'
    # function.
    nodrop = _torch_ffn(moe.moe_ffn, kw, args, bias, drop_tokens=False)
    np.testing.assert_allclose(got[0], nodrop[0], atol=TOL, rtol=TOL)


# --------------------------------------------------------------------------
# models
# --------------------------------------------------------------------------

# name -> (preset, config overrides on both packages)
_MODELS = {
    "tiny-moe": ("tiny-moe", {}),
    "tiny-moe-shared": ("tiny-moe-shared", {}),
    "tiny-moe-interleaved": ("tiny-moe-interleaved", {}),
    # GPT-OSS's layer pair (window, full) once.
    "tiny-gptoss": ("tiny-gptoss", dict(n_layers=2)),
    # The first-k-dense layout with the sigmoid gate and a shared expert.
    "first-k-sigmoid": ("tiny-moe", dict(n_layers=3, first_k_dense=1, moe=dict(
        num_experts=4, num_experts_per_token=2, scoring="sigmoid",
        num_shared_experts=1, d_ff_expert=48, capacity_factor=1.0))),
}

_PAIRS = {}


def _pair(name):
    """(jax cfg, port cfg, jax params, port params) in fp32. The JAX tree
    takes its layout from `jax.eval_shape` of the JAX init (no JAX random
    numbers are drawn) and its values from a seeded numpy generator:
    matrices at fan-in scale, norms, biases and sinks as noise, so none is
    trivial."""
    if name in _PAIRS:
        return _PAIRS[name]
    preset, over = _MODELS[name]
    over = dict(over)
    mkw = over.pop("moe", None)
    jc = jget(preset).replace(dtype="float32", **over)
    tc = get_model_config(preset).replace(dtype="float32", **over)
    if mkw is not None:
        jc, tc = jc.replace(moe=JMoE(**mkw)), tc.replace(moe=MoEConfig(**mkw))
    rng = _rng("params", name)
    shapes = jax.eval_shape(lambda: jt.init_params(jc, jax.random.PRNGKey(0)))

    def fill(path, leaf):
        key = jax.tree_util.keystr(path)
        vector = (key.endswith("norm']") or "sinks" in key
                  or "['b" in key)
        # Matrices are (..., fan_in, fan_out) behind their stack axes.
        scale = 0.3 if vector else leaf.shape[-2] ** -0.5
        return (scale * rng.standard_normal(leaf.shape)).astype(np.float32)

    p = jax.tree_util.tree_map_with_path(fill, shapes)
    _PAIRS[name] = (jc, tc, jax.tree.map(jnp.asarray, p),
                    params_from_jax(tc, p, CPU))
    return _PAIRS[name]


def test_params_from_jax_unstacks_two_stack_layouts():
    """Interleaved and first-k-dense trees land per layer, in layer order,
    each layer with its kind's leaves."""
    for name in ("tiny-moe-interleaved", "first-k-sigmoid"):
        jc, tc, jp, tp = _pair(name)
        flags = tt.moe_layers(tc)
        assert flags == ([False, True, False, True] if jc.moe_every > 1
                         else [False, True, True])
        dense = moe_i = 0
        for i, (lp, is_moe) in enumerate(zip(tp["layers"], flags)):
            assert set(lp) == set(tt.layer_shapes(tc, is_moe))
            if is_moe:
                src = jax.tree.map(lambda a: a[moe_i], jp["layers"]["moe"])
                moe_i += 1
            elif jc.moe_every > 1:
                g, j = divmod(i, jc.moe_every)
                src = jax.tree.map(lambda a: a[g, j], jp["layers"]["dense"])
            else:
                src = jax.tree.map(lambda a: a[dense], jp["layers"]["dense"])
                dense += 1
            for k, t in lp.items():
                np.testing.assert_array_equal(t.numpy(), np.asarray(src[k]))
        tpi = tt.init_params(tc, seed=0, device=CPU)
        assert tt.num_params(tpi) == sum(x.size for x in jax.tree.leaves(jp))
    bad = jax.tree.map(np.asarray, jp)
    bad["layers"] = bad["layers"]["moe"]
    with pytest.raises(ValueError):
        params_from_jax(tc, bad, CPU)


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_forward_aux_matches_jax(name):
    jc, tc, jp, tp = _pair(name)
    rng = _rng("fwd", name)
    toks = rng.integers(0, tc.vocab_size, size=(2, 20)).astype(np.int32)
    want, jaux = jax.jit(lambda p, t: jt.forward(jc, p, t, return_aux=True))(
        jp, toks)
    got, taux = tt.forward(tc, tp, _t(toks), device=CPU, return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), atol=TOL,
                                   rtol=TOL)
    if not jc.moe.dropless:
        assert float(taux["dropped_frac"]) > 0


# The engine tests cover the cached forward of tiny-gptoss and tiny-moe.
@pytest.mark.parametrize("name", ["tiny-moe-interleaved", "first-k-sigmoid"])
def test_cached_forward_matches_jax(name):
    """A ragged fresh prefill (pads take capacity and drop), then decode
    steps, which never drop, through the two-stack layouts."""
    jc, tc, jp, tp = _pair(name)
    rng = _rng("cached", name)
    b, s, max_len = 2, 20, 32
    toks = rng.integers(0, tc.vocab_size, size=(b, s)).astype(np.int32)
    plen = np.array([s, 11], np.int32)
    prefill = jax.jit(lambda p, t, c, n: jt.forward_with_cache(
        jc, p, t, c, new_tokens_len=n, fresh_cache=True))
    decode = jax.jit(lambda p, t, c: jt.forward_with_cache(jc, p, t, c))
    jl, jcache = prefill(jp, toks, jinit_cache(jc, b, max_len), plen)
    tcache = init_cache(tc, b, max_len, torch.device(CPU))
    tl, tcache = tt.forward_with_cache(
        tc, tp, _t(toks), tcache, new_tokens_len=_t(plen), fresh_cache=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    for _ in range(2):
        nxt = rng.integers(0, tc.vocab_size, size=(b, 1)).astype(np.int32)
        jl, jcache = decode(jp, nxt, jcache)
        tl, tcache = tt.forward_with_cache(tc, tp, _t(nxt), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)


def test_dense_forward_aux_is_zero():
    tc = get_model_config("tiny").replace(dtype="float32")
    tp = tt.init_params(tc, device=CPU)
    _, aux = tt.forward(tc, tp, torch.zeros(1, 4, dtype=torch.int64),
                        device=CPU, return_aux=True)
    assert set(aux) == set(tt.AUX_KEYS)
    assert all(float(v) == 0.0 for v in aux.values())


# --------------------------------------------------------------------------
# engines
# --------------------------------------------------------------------------


def _margins(tc, tp, toks, plen, out, max_len):
    """The top-2 margin behind each greedy token of Engine.generate, from
    the port's cached forward stepped on `out` (the fresh prefill drops
    as the engine's does; decode never drops). The forward test holds the
    port's logits within LOGIT_ATOL of the JAX package's, so where this
    margin is at least MARGIN + 2 * LOGIT_ATOL the JAX margin is at least
    MARGIN (the JAX engine's own margins would cost a second JAX run)."""
    b, steps = out.shape
    cache = init_cache(tc, b, max_len, torch.device(CPU))
    logits, cache = tt.forward_with_cache(
        tc, tp, _t(toks), cache, new_tokens_len=_t(plen), fresh_cache=True)
    rows = logits[torch.arange(b), _t(plen).long() - 1]
    margins = np.zeros((b, steps), np.float32)
    for t in range(steps):
        top2 = rows.topk(2, dim=-1).values
        margins[:, t] = (top2[:, 0] - top2[:, 1]).numpy()
        if t + 1 < steps:
            logits, cache = tt.forward_with_cache(
                tc, tp, _t(out[:, t:t + 1]).long(), cache)
            rows = logits[:, 0]
    return margins


@pytest.mark.parametrize("name", ["tiny-gptoss", "tiny-moe"])
def test_engine_generate_matches_jax(name):
    jc, tc, jp, tp = _pair(name)
    rng = _rng("gen", name)
    b, s, steps, max_len = 3, 16, 6, 32
    toks = rng.integers(0, tc.vocab_size, size=(b, s)).astype(np.int32)
    plen = np.array([16, 5, 11], np.int32)
    want = JEngine(jc, jp, temperature=0.0, max_len=max_len).generate(
        jnp.asarray(toks), jnp.asarray(plen), max_new_tokens=steps)
    got = Engine(tc, tp, temperature=0.0, max_len=max_len,
                 device=CPU).generate(_t(toks), _t(plen),
                                      max_new_tokens=steps)
    jtoks, jlp = np.asarray(want.tokens), np.asarray(want.logprobs)
    low = _margins(tc, tp, toks, plen, jtoks, max_len) \
        < MARGIN + 2 * LOGIT_ATOL
    upto = np.where(low.any(1), low.argmax(1) + 1, steps)
    assert upto.sum() >= 0.75 * b * steps, upto
    for r in range(b):
        n = upto[r]
        np.testing.assert_array_equal(got.tokens[r, :n].numpy(), jtoks[r, :n])
        np.testing.assert_allclose(got.logprobs[r, :n].numpy(), jlp[r, :n],
                                   atol=LOGIT_ATOL)


def _serving_requests(vocab):
    """Six requests over 3 slots: two share a 24-token prefix (a hit for
    the later one), one is longer than the 16-token chunk (a chunk
    continuation), the rest ragged."""
    rng = _rng("serving", vocab)
    shared = rng.integers(0, vocab, 24)
    prompts = [np.concatenate([shared, rng.integers(0, vocab, 5)]),
               rng.integers(0, vocab, 9), rng.integers(0, vocab, 37),
               np.concatenate([shared, rng.integers(0, vocab, 3)]),
               rng.integers(0, vocab, 3), rng.integers(0, vocab, 14)]
    new = [6, 4, 5, 7, 3, 5]
    return [(f"r{i}", p.astype(np.int32), m)
            for i, (p, m) in enumerate(zip(prompts, new))]


@pytest.mark.parametrize("name", ["tiny-gptoss", "tiny-moe"])
def test_paged_engine_matches_jax(name):
    jc, tc, jp, tp = _pair(name)
    reqs = _serving_requests(tc.vocab_size)
    kw = dict(n_slots=3, max_len=64, block_size=8, pool_tokens=160,
              prefix_cache=True, prefill_chunk=16, logprobs=True,
              top_logprobs=2, temperature=0.0)
    jeng = jbatching.PagedBatchingEngine(jc, jp, **kw)
    teng = batching.PagedBatchingEngine(tc, tp, device=CPU, **kw)
    want, got = jeng.run(reqs), teng.run(reqs)
    assert set(got) == set(want) == {r[0] for r in reqs}
    compared = total = 0
    for rid, w in want.items():
        margins = [lps[0] - lps[1]
                   for _, lps in jeng.finished_top_logprobs[rid]]
        low = [i for i, m in enumerate(margins) if m < MARGIN]
        upto = low[0] if low else len(w)
        assert list(got[rid][:upto]) == list(w[:upto]), rid
        np.testing.assert_allclose(teng.finished_logprobs[rid][:upto],
                                   jeng.finished_logprobs[rid][:upto],
                                   atol=LOGIT_ATOL)
        compared += upto
        total += len(w)
    assert compared >= 0.75 * total, (compared, total)
    assert teng.stats["prefix_hit_tokens"] == int(
        jeng.stats["prefix_hit_tokens"]) > 0
