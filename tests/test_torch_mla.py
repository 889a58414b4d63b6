"""The port's MLA (DeepSeek latent attention) models against the JAX
package's, on the CPU.

`tiny-mla` (low-rank queries) and `tiny-deepseek` (MLA with first-k-dense
MoE) run numpy-seeded fp32 weights through both packages: the
interleaved rope to 1e-6, the forward's logits and the cached forward's
absorbed decode to 1e-4, the plain decode at the latent width 576 to
2e-5 against the reference attention, and `Engine.generate` and both
batching engines over all four latent caches (dense, dense-int8, paged,
paged-int8), greedy tokens compared while the JAX engine's top-2 margin
is at least twice the logit tolerance, and beam search over the latent
caches. One JAX engine serves every case that compares the same math.
DeepSeek's HF conversion is held to the JAX package's and to
transformers' DeepseekV2/V3 models in tests/test_torch_convert.py, where
the transformers import is already paid.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import importlib
import json
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shellac_tpu.inference import batching as jbatching
from shellac_tpu.inference.engine import Engine as JEngine
from shellac_tpu.inference.kvcache import init_cache as jinit_cache
from shellac_tpu.models import transformer as jt
from shellac_tpu.models.registry import get_model_config as jget
from shellac_tpu_torch.inference import batching
from shellac_tpu_torch.inference.cache import (
    init_cache,
    init_cache_for,
    init_paged_cache,
    init_quant_paged_cache,
    paged_update_layer,
    quant_paged_update_layer,
    quant_update_layer,
    quantize_kv,
    update_layer,
)
from shellac_tpu_torch.inference.engine import Engine
from shellac_tpu_torch.models import transformer as tt
from shellac_tpu_torch.models.from_jax import params_from_jax
from shellac_tpu_torch.models.registry import get_model_config
from shellac_tpu_torch.ops import decode_attention as da
from shellac_tpu_torch.ops.attention import attention_ref
from shellac_tpu_torch.ops.rope import apply_rope_interleaved, rope_angles

jrope = importlib.import_module("shellac_tpu.ops.rope")
jda = importlib.import_module("shellac_tpu.ops.decode_attention")

CPU = "cpu"
ROPE_TOL = 1e-6
ATTN_TOL = 2e-5
LOGIT_ATOL = 1e-4
MARGIN = 2 * LOGIT_ATOL
NAMES = ("tiny-mla", "tiny-deepseek")


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _t(x):
    return torch.from_numpy(np.array(x))


_PAIRS = {}


def _pair(name):
    """(jax cfg, port cfg, jax params, port params) in fp32. The JAX tree
    takes its layout from `jax.eval_shape` of the JAX init and its values
    from a seeded numpy generator: matrices at fan-in scale, norm scales
    as noise, so no norm is trivial."""
    if name in _PAIRS:
        return _PAIRS[name]
    jc = jget(name).replace(dtype="float32")
    tc = get_model_config(name).replace(dtype="float32")
    rng = _rng("params", name)
    shapes = jax.eval_shape(lambda: jt.init_params(jc, jax.random.PRNGKey(0)))

    def fill(path, leaf):
        key = jax.tree_util.keystr(path)
        if key.endswith("norm']"):
            return (0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan_in = leaf.shape[-3] if "wkv_b" in key else leaf.shape[-2]
        return (fan_in ** -0.5
                * rng.standard_normal(leaf.shape)).astype(np.float32)

    p = jax.tree_util.tree_map_with_path(fill, shapes)
    _PAIRS[name] = (jc, tc, jax.tree.map(jnp.asarray, p),
                    params_from_jax(tc, p, CPU))
    return _PAIRS[name]


# --------------------------------------------------------------------------
# ops
# --------------------------------------------------------------------------


def test_rope_interleaved_matches_jax():
    rng = _rng("rope")
    x = rng.standard_normal((2, 7, 3, 64)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(40, 47)]).astype(np.int32)
    cos, sin = rope_angles(_t(pos), 64)
    jcos, jsin = jrope.rope_angles(jnp.asarray(pos), 64)
    want = jrope.apply_rope_interleaved(jnp.asarray(x), jcos, jsin)
    got = apply_rope_interleaved(_t(x), cos, sin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ROPE_TOL)
    # bf16 in, bf16 out, rotated in fp32 as the JAX function does.
    got16 = apply_rope_interleaved(_t(x).to(torch.bfloat16), cos, sin)
    want16 = jrope.apply_rope_interleaved(jnp.asarray(x, jnp.bfloat16),
                                          jcos, jsin)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_array_equal(got16.float().numpy(),
                                  np.asarray(want16, np.float32))


def _latent_case(seed, b=3, h=16, d=576, length=80):
    rng = _rng("latent", seed)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    cache = rng.standard_normal((b, 1, length, d)).astype(np.float32)
    index = np.array([0, 37, length - 1], np.int32)[:b]
    return q, cache, index


def test_plain_decode_at_576_matches_reference():
    """The absorbed decode's shape: 16 query heads against ONE latent row
    a token, 576 wide, the same array as k and v. The plain decode, dense
    and through a paged pool, against the reference attention."""
    q, cache, index = _latent_case(0)
    b, _, h, d = q.shape
    scale = 192 ** -0.5
    got = da.decode_attention(_t(q), _t(cache), _t(cache), _t(index),
                              scale=scale)
    kv = _t(cache).transpose(1, 2)  # (B, L, 1, D)
    length = cache.shape[2]
    kv_pos = torch.arange(length).expand(b, length)
    want = attention_ref(
        _t(q), kv, kv, scale=scale, q_positions=_t(index)[:, None].long(),
        kv_positions=kv_pos, kv_mask=kv_pos <= _t(index)[:, None])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATTN_TOL)
    # The JAX package's reference decode on the same inputs.
    jwant = jda.decode_attention(jnp.asarray(q), jnp.asarray(cache),
                                 jnp.asarray(cache), jnp.asarray(index),
                                 scale=scale, impl="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant),
                               atol=ATTN_TOL)
    # Paged: 16-row pages dealt out of order.
    bs = 16
    n_pages = length // bs
    perm = _rng("perm").permutation(b * n_pages) + 1
    tables = perm.reshape(b, n_pages).astype(np.int32)
    pool = np.zeros((b * n_pages + 1, 1, bs, d), np.float32)
    for s in range(b):
        for p in range(n_pages):
            pool[tables[s, p], 0] = cache[s, 0, p * bs:(p + 1) * bs]
    pgot = da.paged_decode_attention(_t(q), _t(pool), _t(pool), _t(tables),
                                     _t(index), scale=scale)
    np.testing.assert_allclose(pgot.numpy(), want.numpy(), atol=ATTN_TOL)


def test_int8_latent_writes_one_scale_a_row():
    """An int8 latent cache: the latent row quantizes with one scale and
    the zero-width v with unit scales, as the JAX package writes them;
    dense and paged writes land the same values."""
    rng = _rng("int8-latent")
    lat = rng.standard_normal((2, 3, 1, 576)).astype(np.float32)
    kq, ks = quantize_kv(_t(lat))
    vq, vs = quantize_kv(_t(lat)[..., :0])
    assert ks.shape == (2, 3, 1) and vq.shape == (2, 3, 1, 0)
    np.testing.assert_array_equal(vs.numpy(), np.ones((2, 3, 1)))
    jkq, jks = importlib.import_module(
        "shellac_tpu.inference.kvcache").quantize_kv(jnp.asarray(lat))
    np.testing.assert_array_equal(kq.numpy(), np.asarray(jkq))
    np.testing.assert_allclose(ks.numpy(), np.asarray(jks), rtol=1e-7)
    tc = get_model_config("tiny-mla").replace(dtype="float32")
    assert (tc.cache_kv_heads, tc.cache_head_dim, tc.cache_v_head_dim) == \
        (1, 40, 0)
    dense = init_cache_for(tc, 2, 16, torch.device(CPU), "int8")
    pool = init_quant_paged_cache(tc, 2, 5, 8, 2, torch.device(CPU))
    assert dense.v.shape == (2, 2, 1, 16, 0) and pool.v.shape[-1] == 0
    lat40 = _t(lat[..., :40])
    index = _t(np.array([2, 9], np.int32))
    tables = _t(np.array([[3, 1], [4, 2]], np.int32))
    quant_update_layer(dense.k[0], dense.v[0], dense.ks[0], dense.vs[0],
                       lat40, lat40[..., :0], index)
    quant_paged_update_layer(pool.k[0], pool.v[0], pool.ks[0], pool.vs[0],
                             lat40, lat40[..., :0], index, tables)
    for s, i in enumerate((2, 9)):
        for j in range(3):
            p = i + j
            blk = int(tables[s, p // 8])
            assert torch.equal(dense.k[0, s, 0, p], pool.k[0, blk, 0, p % 8])
            assert dense.ks[0, s, 0, p] == pool.ks[0, blk, 0, p % 8]
            assert dense.vs[0, s, 0, p] == 1.0
    # Compute-dtype writes take the same rows.
    bcache = init_cache(tc, 2, 16, torch.device(CPU))
    bpool = init_paged_cache(tc, 2, 5, 8, 2, torch.device(CPU))
    update_layer(bcache.k[0], bcache.v[0], lat40, lat40[..., :0], index)
    paged_update_layer(bpool.k[0], bpool.v[0], lat40, lat40[..., :0], index,
                       tables)
    assert torch.equal(bcache.k[0, 1, 0, 9], bpool.k[0, 2, 0, 1])


# --------------------------------------------------------------------------
# models
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_params_from_jax_round_trip(name):
    """Every JAX leaf lands in its layer (the two stacks of tiny-deepseek
    in layer order) with the port's own init layout, unrounded in fp32."""
    jc, tc, jp, tp = _pair(name)
    flags = tt.moe_layers(tc)
    stacks = jp["layers"]
    dense = moe_i = 0
    for lp, is_moe in zip(tp["layers"], flags):
        assert set(lp) == set(tt.layer_shapes(tc, is_moe))
        if "dense" in stacks:
            src = stacks["moe" if is_moe else "dense"]
            at = moe_i if is_moe else dense
            moe_i, dense = moe_i + is_moe, dense + (not is_moe)
        else:
            src, at = stacks, dense
            dense += 1
        for k, t in lp.items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(src[k][at]))
    tpi = tt.init_params(tc, seed=0, device=CPU)
    assert {k: v.shape for lp in tpi["layers"] for k, v in lp.items()} == \
        {k: v.shape for lp in tp["layers"] for k, v in lp.items()}
    assert tt.num_params(tpi) == sum(x.size for x in jax.tree.leaves(jp))
    assert tpi["layers"][0]["kv_a_norm"].dtype == torch.float32


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name):
    jc, tc, jp, tp = _pair(name)
    toks = _rng("fwd", name).integers(0, tc.vocab_size, size=(2, 21))
    want = jax.jit(lambda p, t: jt.forward(jc, p, t))(jp, toks)
    got = tt.forward(tc, tp, _t(toks), device=CPU)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_absorbed_decode_matches_jax_and_expanded(name):
    """A ragged fresh prefill (the expanded form) into a latent cache, then
    decode steps (the absorbed form): each step's logits equal the JAX
    cached forward's and the port's own cache-free forward's (the
    expanded form over the whole sequence) at the same positions."""
    jc, tc, jp, tp = _pair(name)
    rng = _rng("cached", name)
    b, s, max_len, steps = 2, 12, 24, 3
    toks = rng.integers(0, tc.vocab_size, size=(b, s)).astype(np.int32)
    plen = np.array([s, 7], np.int32)
    prefill = jax.jit(lambda p, t, c, n: jt.forward_with_cache(
        jc, p, t, c, new_tokens_len=n, fresh_cache=True))
    decode = jax.jit(lambda p, t, c: jt.forward_with_cache(jc, p, t, c))
    jl, jcache = prefill(jp, toks, jinit_cache(jc, b, max_len), plen)
    tcache = init_cache(tc, b, max_len, torch.device(CPU))
    assert tcache.k.shape == (tc.n_layers, b, 1, max_len, 40)
    tl, tcache = tt.forward_with_cache(
        tc, tp, _t(toks), tcache, new_tokens_len=_t(plen), fresh_cache=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    seqs = [list(toks[r, :plen[r]]) for r in range(b)]
    for _ in range(steps):
        nxt = rng.integers(0, tc.vocab_size, size=(b, 1)).astype(np.int32)
        jl, jcache = decode(jp, nxt, jcache)
        tl, tcache = tt.forward_with_cache(tc, tp, _t(nxt), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
        for r in range(b):
            seqs[r].append(int(nxt[r, 0]))
            full = tt.forward(tc, tp, _t(np.array([seqs[r]])), device=CPU)
            np.testing.assert_allclose(tl[r, 0].numpy(), full[0, -1].numpy(),
                                       atol=LOGIT_ATOL)


def _margins(tc, tp, toks, plen, out, max_len):
    """The top-2 margin behind each greedy token of Engine.generate, from
    the port's cached forward stepped on `out`. The forward tests hold
    the port's logits within LOGIT_ATOL of the JAX package's, so where
    this margin is at least MARGIN + 2 * LOGIT_ATOL the JAX margin is at
    least MARGIN."""
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


@pytest.mark.parametrize("name", NAMES)
def test_engine_generate_matches_jax(name):
    jc, tc, jp, tp = _pair(name)
    rng = _rng("gen", name)
    b, s, steps, max_len = 3, 12, 6, 32
    toks = rng.integers(0, tc.vocab_size, size=(b, s)).astype(np.int32)
    plen = np.array([12, 4, 9], np.int32)
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
    """Four requests over 2 slots: two share a 32-token prefix (a hit for
    the later one on a prefix-caching pool of 8- or 32-token blocks), two
    longer than the 16-token chunk (chunk continuations), one short."""
    rng = _rng("serving", vocab)
    shared = rng.integers(0, vocab, 32)
    prompts = [np.concatenate([shared, rng.integers(0, vocab, 4)]),
               rng.integers(0, vocab, 7),
               np.concatenate([shared, rng.integers(0, vocab, 3)]),
               rng.integers(0, vocab, 3)]
    new = [5, 4, 5, 3]
    return [(f"r{i}", p.astype(np.int32), m)
            for i, (p, m) in enumerate(zip(prompts, new))]


# backend -> (engine class name, its keyword arguments)
_BACKENDS = {
    "dense": ("BatchingEngine", {}),
    "dense-int8": ("BatchingEngine", dict(kv_quant="int8")),
    "paged": ("PagedBatchingEngine",
              dict(block_size=8, pool_tokens=160, prefix_cache=True)),
    "paged-int8": ("PagedBatchingEngine",
                   dict(block_size=32, pool_tokens=256, prefix_cache=True,
                        kv_quant="int8")),
}
# The JAX engine each backend is held to. The bf16-storage pool is held to
# the dense engine, which the JAX package's own tests hold its paged
# engine to token for token (tests/test_mla.py TestServing); the int8
# pool to the JAX int8 pool, whose 32-token blocks align its chunks and
# whose prefix hits read their prefix quantized.
_REFERENCE = {"dense": "dense", "paged": "dense",
              "dense-int8": "dense-int8", "paged-int8": "paged-int8"}
_CASES = [("tiny-mla", be) for be in _BACKENDS] + [("tiny-deepseek", "paged")]
_SERVING_KW = dict(n_slots=2, max_len=64, prefill_chunk=16, logprobs=True,
                   top_logprobs=2, temperature=0.0)
_JAX_SERVING = {}


def _jax_serving(name, backend):
    """A JAX batching engine's greedy outputs on the serving requests,
    once per (configuration, backend): its tokens, logprobs, top-2
    margins and prefix-hit tokens."""
    key = (name, backend)
    if key not in _JAX_SERVING:
        jc, _, jp, _ = _pair(name)
        cls, extra = _BACKENDS[backend]
        eng = getattr(jbatching, cls)(jc, jp, **_SERVING_KW, **extra)
        out = eng.run(_serving_requests(jc.vocab_size))
        _JAX_SERVING[key] = ({
            rid: (list(out[rid]), eng.finished_logprobs[rid],
                  [lps[0] - lps[1]
                   for _, lps in eng.finished_top_logprobs[rid]])
            for rid in out}, eng.stats.get("prefix_hit_tokens", 0))
    return _JAX_SERVING[key]


@pytest.mark.parametrize("name,backend", _CASES)
def test_batching_engines_match_jax(name, backend):
    """Both batching engines over the four latent caches against the JAX
    engines (`_REFERENCE`) on the same requests: chunk continuations and
    prefix-hit suffixes take the absorbed form through the plain
    attention, as in the reference; the pools reuse latent blocks on a
    hit, as many tokens as the JAX pool does."""
    _, tc, _, tp = _pair(name)
    cls, extra = _BACKENDS[backend]
    want, hits = _jax_serving(name, _REFERENCE[backend])
    reqs = _serving_requests(tc.vocab_size)
    teng = getattr(batching, cls)(tc, tp, device=CPU, **_SERVING_KW,
                                  **extra)
    got = teng.run(reqs)
    assert set(got) == set(want) == {r[0] for r in reqs}
    compared = total = 0
    for rid, (w, wlp, margins) in want.items():
        low = [i for i, m in enumerate(margins) if m < MARGIN]
        upto = low[0] if low else len(w)
        assert list(got[rid][:upto]) == w[:upto], rid
        np.testing.assert_allclose(teng.finished_logprobs[rid][:upto],
                                   wlp[:upto], atol=LOGIT_ATOL)
        compared += upto
        total += len(w)
    assert compared >= 0.75 * total, (compared, total)
    if extra.get("prefix_cache"):
        assert teng.stats["prefix_hit_tokens"] >= 32
        if backend == _REFERENCE[backend]:
            assert teng.stats["prefix_hit_tokens"] == hits


def test_beam_search_over_latent_caches_matches_jax():
    """Beam search runs over the latent caches as in the JAX package: the
    single-request engine's beams and scores equal the JAX engine's, and
    the paged engine's copy-on-write search over a latent pool (bf16
    behind a prefix hit, and int8, where a hit would read the prefix
    quantized where a fresh prefill reads it exact) and the dense
    engine's equal the port's own single-request search over the same
    storage."""
    jc, tc, jp, tp = _pair("tiny-mla")
    prompt = _rng("beam").integers(0, tc.vocab_size, 37).astype(np.int32)
    kw = dict(num_beams=3, max_new_tokens=5)
    jseqs, jscores = JEngine(jc, jp, max_len=64).beam_search(
        jnp.asarray(prompt), **kw)
    seqs, scores = Engine(tc, tp, max_len=64, device=CPU).beam_search(
        prompt, **kw)
    assert seqs == [list(map(int, s)) for s in jseqs]
    np.testing.assert_allclose(scores, np.asarray(jscores),
                               atol=LOGIT_ATOL)
    for q in (None, "int8"):
        single = Engine(tc, tp, max_len=64, kv_quant=q, device=CPU)
        want = single.beam_search(prompt, **kw)
        paged = batching.PagedBatchingEngine(
            tc, tp, n_slots=2, max_len=64, block_size=32, pool_tokens=512,
            prefix_cache=True, kv_quant=q, device=CPU)
        if q is None:
            paged.run([("warm", prompt[:33], 1)])  # a 32-token block
        got = paged.beam_search(prompt, **kw)
        assert (paged.stats["prefix_hit_tokens"] > 0) == (q is None)
        assert got[0] == want[0]
        np.testing.assert_allclose(got[1], want[1], atol=LOGIT_ATOL)
        dense = batching.BatchingEngine(tc, tp, n_slots=2, max_len=64,
                                        kv_quant=q, device=CPU)
        assert dense.beam_search(prompt, **kw)[0] == want[0]


def test_cli_generate_serves_an_mla_preset(capsys):
    """`generate --model tiny-mla` runs (the CLI's refusal is gone) and
    gives the greedy tokens of Engine on the same seeded parameters."""
    from shellac_tpu_torch import cli

    capsys.readouterr()
    assert cli.main(["generate", "--device", CPU, "--model", "tiny-mla",
                     "--seed", "4", "--prompt", "5,6,7", "--max-new", "6",
                     "--temperature", "0"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg = get_model_config("tiny-mla")
    params = tt.init_params(cfg, seed=4, device=CPU)
    want = Engine(cfg, params, temperature=0.0, device=CPU).generate(
        np.asarray([[5, 6, 7]], np.int32), max_new_tokens=6)
    assert got["tokens"] == want.tokens[0].tolist()
