"""The port's int8 KV cache against the JAX package's, on the CPU.

Inputs come from seeded numpy generators and run through both packages
in fp32. Quantization and the cache writes agree exactly (int8 values
equal, scales equal to 1e-7 relative: the same fp32 division). The plain
int8 decode versions, dense and paged, agree with the JAX reference and
with the JAX Pallas kernels in interpret mode to atol/rtol 2e-5
(summation order only differs). Cached forwards agree to logits atol 1e-4.
Greedy engine tokens are compared where the JAX top-2 margin is at least
twice that tolerance, as in tests/test_torch_model.py.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import importlib
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shellac_tpu.inference import batching as jbatching
from shellac_tpu.inference.cache import layout as jlayout
from shellac_tpu.inference.cache import make_backend as jmake_backend
from shellac_tpu.inference.engine import Engine as JEngine
from shellac_tpu.models import transformer as jt
from shellac_tpu.models.registry import get_model_config as jget
from shellac_tpu_torch.inference import batching
from shellac_tpu_torch.inference.cache import (
    DenseBackend,
    PagedBackend,
    QuantKVCache,
    QuantPagedBackend,
    engine_class,
    init_quant_cache,
    init_quant_paged_cache,
    make_backend,
    paged_gather_scales,
    quant_paged_update_layer,
    quant_update_layer,
    quantize_kv,
    scatter_slot,
)
from shellac_tpu_torch.inference.engine import Engine
from shellac_tpu_torch.models import transformer as tt
from shellac_tpu_torch.models.from_jax import params_from_jax
from shellac_tpu_torch.models.registry import get_model_config
from shellac_tpu_torch.ops import decode_attention as da

import jax_params

jda = importlib.import_module("shellac_tpu.ops.decode_attention")
# The JAX cached forward, jitted: one compile per shape runs faster here
# than op-by-op dispatch.
jfwd = jax.jit(jt.forward_with_cache, static_argnums=(0,),
               static_argnames=("fresh_cache",))

CPU = "cpu"
ATTN_TOL = 2e-5
LOGIT_ATOL = 1e-4
MARGIN = 2 * LOGIT_ATOL


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


# --------------------------------------------------------------------------
# (a) quantization and the cache writes, exactly
# --------------------------------------------------------------------------


def test_quantize_kv_matches_jax():
    rng = _rng("quantize")
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    x *= np.exp(rng.uniform(-6, 6, (2, 5, 3, 1))).astype(np.float32)
    x[0, 1, 2] = 0.0  # a zero row: unit scale, zero values
    x[1, 3, 0, :] = 0.0
    x[1, 3, 0, 5] = -1e-30  # a tiny amax
    jq, js = jlayout.quantize_kv(jnp.asarray(x))
    tq, ts = quantize_kv(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7, atol=0)
    assert ts[0, 1, 2] == 1.0 and not tq[0, 1, 2].any()
    assert tq.abs().max() <= 127
    # Half-way values round to even, as jnp.round does.
    h = np.array([[[[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]]]], np.float32)
    np.testing.assert_array_equal(quantize_kv(_t(h))[0].numpy(),
                                  np.asarray(jlayout.quantize_kv(h)[0]))
    # Zero width: a zero-width int8 array and unit scales.
    zq, zs = quantize_kv(torch.zeros(2, 3, 4, 0))
    jzq, jzs = jlayout.quantize_kv(jnp.zeros((2, 3, 4, 0)))
    assert zq.shape == jzq.shape and zq.dtype == torch.int8
    np.testing.assert_array_equal(zs.numpy(), np.asarray(jzs))


def test_quant_update_layer_matches_jax():
    rng = _rng("quant_update")
    b, hkv, length, d, s = 3, 2, 24, 16, 5
    ck = rng.integers(-127, 128, (b, hkv, length, d)).astype(np.int8)
    cv = rng.integers(-127, 128, (b, hkv, length, d)).astype(np.int8)
    cks = rng.uniform(0.1, 1, (b, hkv, length)).astype(np.float32)
    cvs = rng.uniform(0.1, 1, (b, hkv, length)).astype(np.float32)
    k_new = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v_new = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    index = np.array([0, 11, length - s], np.int32)  # ragged
    want = jlayout.quant_update_layer(
        *(jnp.asarray(a) for a in (ck, cv, cks, cvs, k_new, v_new, index)))
    got = [_t(a) for a in (ck, cv, cks, cvs)]
    out = quant_update_layer(*got, _t(k_new), _t(v_new), _t(index))
    assert all(o is g for o, g in zip(out, got))  # written in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_quant_paged_update_and_gather_match_jax():
    rng = _rng("quant_paged_update")
    nb, hkv, bs, d, b, s, mb = 14, 2, 4, 16, 2, 6, 3
    pools = [rng.integers(-127, 128, (nb, hkv, bs, d)).astype(np.int8)
             for _ in range(2)]
    pools += [rng.uniform(0.1, 1, (nb, hkv, bs)).astype(np.float32)
              for _ in range(2)]
    # Pages out of table order, writes spanning page boundaries.
    tables = rng.permutation(np.arange(1, nb))[:b * mb].reshape(b, mb)
    tables = tables.astype(np.int32)
    k_new = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v_new = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    index = np.array([1, 5], np.int32)
    want = jlayout.quant_paged_update_layer(
        *(jnp.asarray(a) for a in (*pools, k_new, v_new, index, tables)))
    got = [_t(a) for a in pools]
    quant_paged_update_layer(*got, _t(k_new), _t(v_new), _t(index),
                             _t(tables))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        paged_gather_scales(got[2], _t(tables)).numpy(),
        np.asarray(jlayout.paged_gather_scales(want[2], jnp.asarray(tables))))


def test_scatter_slot_carries_scales():
    rng = _rng("quant_scatter")
    full, mini = (2, 3, 2, 16, 4), (2, 1, 2, 8, 4)
    vals = [rng.integers(-127, 128, sh).astype(np.int8)
            for sh in (full, full, mini, mini)]
    scales = [rng.uniform(0.1, 1, sh[:-1]).astype(np.float32)
              for sh in (full, full, mini, mini)]
    lengths = np.array([5, 9, 2], np.int32)

    def jcache(i, lens):
        return jlayout.QuantKVCache(
            k=jnp.asarray(vals[i]), v=jnp.asarray(vals[i + 1]),
            ks=jnp.asarray(scales[i]), vs=jnp.asarray(scales[i + 1]),
            lengths=jnp.asarray(lens))

    def tcache(i, lens):
        return QuantKVCache(k=_t(vals[i]), v=_t(vals[i + 1]),
                            ks=_t(scales[i]), vs=_t(scales[i + 1]),
                            lengths=_t(lens))

    want = jlayout.scatter_slot(jcache(0, lengths),
                                jcache(2, np.array([7], np.int32)), 1)
    got = scatter_slot(tcache(0, lengths), tcache(2, np.array([7], np.int32)),
                       1)
    for name in ("k", "v", "ks", "vs", "lengths"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


# --------------------------------------------------------------------------
# (b) the plain int8 decode versions against JAX's ref and Pallas kernels
# --------------------------------------------------------------------------


def _quant_cache(rng, b, hkv, length, d):
    """Head-major int8 k/v (B, Hkv, L, D) and (B, Hkv, L) scales made by
    quantizing seeded normals, as a cache write would."""
    out = []
    for _ in range(2):
        x = rng.standard_normal((b, length, hkv, d)).astype(np.float32)
        q, s = jlayout.quantize_kv(jnp.asarray(x))
        out.append((np.asarray(q).transpose(0, 2, 1, 3),
                    np.asarray(s).transpose(0, 2, 1)))
    (ck, ks), (cv, vs) = out
    return ck, cv, ks, vs


# (s, window, softcap, sinks)
_DENSE = {
    "s1": (1, None, None, False),
    "s2_window_softcap_sinks": (2, 17, 20.0, True),
}


@pytest.mark.parametrize("case", sorted(_DENSE))
def test_quant_decode_plain_matches_jax(case):
    s, window, cap, sink = _DENSE[case]
    b, h, hkv, length, d = 3, 4, 2, 128, 128
    rng = _rng("quant_decode", case)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    ck, cv, ks, vs = _quant_cache(rng, b, hkv, length, d)
    index = np.array([0, 37, length - s], np.int32)  # empty, mid, full
    sinks = rng.standard_normal((h,)).astype(np.float32) if sink else None
    kw = dict(window=window, softcap=cap)
    got = da.decode_attention(_t(q), _t(ck), _t(cv), _t(index),
                              sinks=None if sinks is None else _t(sinks),
                              k_scale=_t(ks), v_scale=_t(vs), **kw).numpy()
    jargs = (jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
             jnp.asarray(index))
    jkw = dict(kw, sinks=_j(sinks), k_scale=jnp.asarray(ks),
               v_scale=jnp.asarray(vs))
    ref = np.asarray(jda.decode_attention(*jargs, impl="ref", **jkw))
    flash = np.asarray(jda.decode_attention(
        *jargs, impl="flash", block_k=64, interpret=True, **jkw))
    np.testing.assert_allclose(got, ref, atol=ATTN_TOL, rtol=ATTN_TOL)
    np.testing.assert_allclose(got, flash, atol=ATTN_TOL, rtol=ATTN_TOL)


_PAGED = {
    "bs64_two_groups": dict(bs=64, length=640),
    "bs32_window_softcap_sinks": dict(bs=32, length=128, window=50,
                                      softcap=20.0, sinks=True),
}


@pytest.mark.parametrize("case", sorted(_PAGED))
def test_quant_paged_decode_plain_matches_jax(case):
    c = dict(_PAGED[case])
    bs, length = c.pop("bs"), c.pop("length")
    b, s, h, hkv, d = 3, 1, 4, 2, 128
    rng = _rng("quant_paged", case)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    ck, cv, ks, vs = _quant_cache(rng, b, hkv, length, d)
    mb = length // bs
    n_blocks = b * mb + 3  # block 0 and two unowned blocks hold noise
    tables = rng.permutation(np.arange(1, n_blocks))[:b * mb]
    tables = tables.reshape(b, mb).astype(np.int32)
    pk = rng.integers(-127, 128, (n_blocks, hkv, bs, d)).astype(np.int8)
    pv = rng.integers(-127, 128, (n_blocks, hkv, bs, d)).astype(np.int8)
    pks = rng.uniform(0.1, 1, (n_blocks, hkv, bs)).astype(np.float32)
    pvs = rng.uniform(0.1, 1, (n_blocks, hkv, bs)).astype(np.float32)
    for bi in range(b):
        for j in range(mb):
            page, sl = tables[bi, j], slice(j * bs, (j + 1) * bs)
            pk[page], pv[page] = ck[bi, :, sl], cv[bi, :, sl]
            pks[page], pvs[page] = ks[bi, :, sl], vs[bi, :, sl]
    index = np.array([0, 37, length - s], np.int32)
    if c.pop("sinks", False):
        c["sinks"] = rng.standard_normal((h,)).astype(np.float32)
    sinks = c.pop("sinks", None)
    if d % 128 == 0 and bs == 64:
        assert mb // jda._paged_group(jnp.asarray(tables),
                                      jnp.asarray(pk)) > 1
    got = da.paged_decode_attention(
        _t(q), _t(pk), _t(pv), _t(tables), _t(index),
        sinks=None if sinks is None else _t(sinks), k_scale=_t(pks),
        v_scale=_t(pvs), **c).numpy()
    jargs = tuple(jnp.asarray(a) for a in (q, pk, pv, tables, index))
    jkw = dict(c, sinks=_j(sinks), k_scale=jnp.asarray(pks),
               v_scale=jnp.asarray(pvs))
    ref = np.asarray(jda.paged_decode_attention(*jargs, impl="ref", **jkw))
    flash = np.asarray(jda.paged_decode_attention(
        *jargs, impl="flash", interpret=True, **jkw))
    np.testing.assert_allclose(got, ref, atol=ATTN_TOL, rtol=ATTN_TOL)
    np.testing.assert_allclose(got, flash, atol=ATTN_TOL, rtol=ATTN_TOL)
    # The pool's plain version is the dense one over the same int8 rows.
    dense = da.decode_attention(
        _t(q), _t(ck), _t(cv), _t(index),
        sinks=None if sinks is None else _t(sinks), k_scale=_t(ks),
        v_scale=_t(vs), **c)
    np.testing.assert_allclose(got, dense.numpy(), atol=ATTN_TOL,
                               rtol=ATTN_TOL)


def test_scales_come_together():
    q = torch.zeros(1, 1, 2, 64)
    c = torch.zeros(1, 2, 8, 64, dtype=torch.int8)
    sc = torch.ones(1, 2, 8)
    idx = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="come together"):
        da.decode_attention(q, c, c, idx, k_scale=sc)
    with pytest.raises(ValueError, match="come together"):
        da.paged_decode_attention(q, c, c, torch.zeros(1, 1,
                                                       dtype=torch.int32),
                                  idx, v_scale=sc)
    # The CUDA gate: D 64 and 128 take the int8 kernel, and any block
    # size (the TPU's 32-aligned pages are not a Hopper constraint).
    pool = torch.zeros(5, 2, 16, 64, dtype=torch.int8)
    assert da.paged_decode_supported(q, pool, quant=True)
    assert not da.paged_decode_supported(q, pool)
    assert not da.paged_decode_supported(q, pool[..., :32], quant=True)


# --------------------------------------------------------------------------
# (c) the cached forward and the engines
# --------------------------------------------------------------------------


def _pair(name):
    """(jax cfg, port cfg, jax params, port params) in fp32, with seeded
    noise on the norms so they are not trivial."""
    jc = jget(name).replace(dtype="float32")
    tc = get_model_config(name).replace(dtype="float32")
    p = jax_params.init_params(jc)
    rng = _rng("params", name)
    for k, v in p["layers"].items():
        if k.endswith("norm"):
            p["layers"][k] = (0.3 * rng.standard_normal(v.shape)).astype(
                np.float32)
    return jc, tc, jax.tree.map(jnp.asarray, p), params_from_jax(tc, p, CPU)


_PAIRS = {}


def _cached_pair(name):
    if name not in _PAIRS:
        _PAIRS[name] = _pair(name)
    return _PAIRS[name]


def _assert_caches_equal(tcache, jcache):
    """The same int8 values and lengths; the scales (amax / 127 of k and
    v, whose projections sum in another order in the two packages) to
    1e-5 relative."""
    for name in ("k", "v", "lengths"):
        np.testing.assert_array_equal(getattr(tcache, name).numpy(),
                                      np.asarray(getattr(jcache, name)),
                                      err_msg=name)
    for name in ("ks", "vs"):
        np.testing.assert_allclose(getattr(tcache, name).numpy(),
                                   np.asarray(getattr(jcache, name)),
                                   rtol=1e-5, atol=0, err_msg=name)


@pytest.mark.parametrize("paged", [False, True])
def test_forward_with_cache_int8_matches_jax(paged):
    """A ragged prefill then three decodes through an int8 cache, dense
    or paged (pages out of table order): logits within 1e-4 of JAX's and
    the same int8 values in the cache, with its scales."""
    jc, tc, jp, tp = _cached_pair("tiny-gqa")
    rng = _rng("quant_fwd", paged)
    b, s, max_len = 2, 12, 32
    toks = rng.integers(0, tc.vocab_size, (b, s)).astype(np.int32)
    plen = np.array([s, 7], np.int32)
    if paged:
        bs, mb = 8, 4
        n_blocks = b * mb + 2
        tables = rng.permutation(np.arange(1, n_blocks))[:b * mb]
        tables = tables.reshape(b, mb).astype(np.int32)
        jcache = jlayout.init_quant_paged_cache(jc, b, n_blocks, bs, mb)
        jcache = jcache.replace(tables=jnp.asarray(tables))
        tcache = init_quant_paged_cache(tc, b, n_blocks, bs, mb,
                                        torch.device(CPU))
        tcache.tables.copy_(_t(tables))
    else:
        jcache = jlayout.init_quant_cache(jc, b, max_len)
        tcache = init_quant_cache(tc, b, max_len, torch.device(CPU))
    jl, jcache = jfwd(
        jc, jp, jnp.asarray(toks), jcache, new_tokens_len=jnp.asarray(plen),
        fresh_cache=True)
    tl, tcache = tt.forward_with_cache(
        tc, tp, _t(toks).long(), tcache, new_tokens_len=_t(plen),
        fresh_cache=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    for _ in range(3):
        nxt = rng.integers(0, tc.vocab_size, (b, 1)).astype(np.int32)
        jl, jcache = jfwd(jc, jp, jnp.asarray(nxt), jcache)
        tl, tcache = tt.forward_with_cache(tc, tp, _t(nxt).long(), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
    _assert_caches_equal(tcache, jcache)


def _int8_margins(jc, jp, toks, plen, gen_tokens, max_len):
    """The JAX top-2 logit margin behind every greedy token of an int8
    Engine run: its prefill and decodes replayed through an int8 cache."""
    b, steps = gen_tokens.shape
    cache = jlayout.init_quant_cache(jc, b, max_len)
    logits, cache = jfwd(
        jc, jp, jnp.asarray(toks), cache, new_tokens_len=jnp.asarray(plen),
        fresh_cache=True)
    rows = np.asarray(logits)[np.arange(b), plen - 1]
    margins = np.zeros((b, steps), np.float32)
    for t in range(steps):
        top2 = np.sort(rows, axis=-1)[:, -2:]
        margins[:, t] = top2[:, 1] - top2[:, 0]
        if t + 1 < steps:
            logits, cache = jfwd(
                jc, jp, jnp.asarray(gen_tokens[:, t:t + 1]), cache)
            rows = np.asarray(logits)[:, 0]
    return margins


def test_engine_int8_greedy_matches_jax():
    jc, tc, jp, tp = _cached_pair("tiny-gqa")
    rng = _rng("quant_gen")
    b, s, steps, max_len = 3, 16, 8, 48
    toks = rng.integers(0, tc.vocab_size, (b, s)).astype(np.int32)
    plen = np.array([16, 5, 11], np.int32)
    want = JEngine(jc, jp, temperature=0.0, max_len=max_len,
                   kv_quant="int8").generate(
        jnp.asarray(toks), jnp.asarray(plen), max_new_tokens=steps)
    eng = Engine(tc, tp, temperature=0.0, max_len=max_len, kv_quant="int8",
                 device=CPU)
    got = eng.generate(_t(toks).long(), _t(plen), max_new_tokens=steps)
    jtoks, jlp = np.asarray(want.tokens), np.asarray(want.logprobs)
    low = _int8_margins(jc, jp, toks, plen, jtoks, max_len) < MARGIN
    upto = np.where(low.any(1), low.argmax(1), steps)
    assert upto.sum() >= 0.75 * b * steps, upto
    for r in range(b):
        n = upto[r]
        np.testing.assert_array_equal(got.tokens[r, :n].numpy(), jtoks[r, :n])
        np.testing.assert_allclose(got.logprobs[r, :n].numpy(), jlp[r, :n],
                                   atol=LOGIT_ATOL)


def _requests(vocab):
    """7 ragged requests with mixed budgets over 3 slots, so slots
    recycle and blocks return."""
    rng = _rng("quant_requests")
    lens = [3, 17, 9, 24, 5, 12, 30]
    max_new = [6, 9, 1, 12, 4, 10, 8]
    return [(f"r{i}", rng.integers(0, vocab, n).astype(np.int32), m)
            for i, (n, m) in enumerate(zip(lens, max_new))]


_JAX_INT8_RUN = {}


def _jax_int8_run(jc, jp, reqs):
    """The JAX dense-int8 batching engine's run of `reqs`, made once: its
    greedy tokens and logprobs are its paged-int8 engine's too (the same
    write-point quantization; the JAX package's tests hold them
    bit-equal), so it serves both cases."""
    if not _JAX_INT8_RUN:
        jeng = jbatching.BatchingEngine(
            jc, jp, n_slots=3, max_len=64, cache_backend="dense-int8",
            logprobs=True, top_logprobs=2)
        _JAX_INT8_RUN["run"] = jeng.run(reqs), jeng
    return _JAX_INT8_RUN["run"]


@pytest.mark.parametrize("backend", ["dense-int8", "paged-int8"])
def test_batching_int8_greedy_matches_jax(backend):
    """The int8 batching engines against the JAX package's dense-int8
    engine on the same requests (compared while the JAX top-2 logprob
    margin allows), and each request against the port's single-request
    int8 Engine."""
    jc, tc, jp, tp = _cached_pair("tiny-gqa")
    reqs = _requests(tc.vocab_size)
    kw = dict(n_slots=3, max_len=64, cache_backend=backend, logprobs=True,
              top_logprobs=2)
    if backend == "paged-int8":
        kw.update(block_size=32, pool_tokens=128)
        tcls = batching.PagedBatchingEngine
    else:
        tcls = batching.BatchingEngine
    want, jeng = _jax_int8_run(jc, jp, reqs)
    teng = tcls(tc, tp, device=CPU, **kw)
    assert teng.cache_backend.name == backend and teng.kv_quant == "int8"
    got = teng.run(reqs)
    assert set(got) == set(want) == {r[0] for r in reqs}
    compared = total = 0
    for rid, _, _ in reqs:
        margins = np.array([lps[0] - lps[1] for _, lps in
                            jeng.finished_top_logprobs[rid]])
        low = np.flatnonzero(margins < MARGIN)
        upto = int(low[0]) if low.size else len(want[rid])
        assert got[rid][:upto] == want[rid][:upto], rid
        np.testing.assert_allclose(teng.finished_logprobs[rid][:upto],
                                   jeng.finished_logprobs[rid][:upto],
                                   atol=LOGIT_ATOL)
        compared += upto
        total += len(want[rid])
    assert compared >= 0.75 * total, (compared, total)
    if backend == "paged-int8":
        be = teng.cache_backend
        assert len(be._free) == be.n_blocks - 1
        assert int(teng._cache.tables.abs().sum()) == 0
    # Scheduling is invisible to the math: both quantize at the same
    # write points, so each request equals the single-request Engine's.
    single = Engine(tc, tp, temperature=0.0, max_len=64, kv_quant="int8",
                    device=CPU)
    for rid, toks, m in reqs:
        one = single.generate(_t(toks[None]).long(), max_new_tokens=m)
        assert got[rid] == one.tokens[0].tolist(), rid


# --------------------------------------------------------------------------
# (d) the registry, the defaults and the refusals
# --------------------------------------------------------------------------


def test_int8_registry_and_refusals():
    cfg = get_model_config("tiny")
    jcfg = jget("tiny")
    dense = make_backend("dense-int8", cfg, 2, 64)
    assert isinstance(dense, DenseBackend) and dense.name == "dense-int8"
    assert dense.kv_quant == "int8"
    paged = make_backend("paged-int8", cfg, 2, 256)
    assert isinstance(paged, QuantPagedBackend) and paged.block_size == 64
    assert make_backend("paged-int8", cfg, 2, 256, block_size=32) \
        .block_size == 32
    with pytest.raises(ValueError, match="block_size % 32"):
        make_backend("paged-int8", cfg, 2, 256, block_size=16)
    with pytest.raises(ValueError, match="block_size % 32"):
        PagedBackend(cfg, 2, 256, kv_quant="int8", block_size=48)
    with pytest.raises(ValueError, match="int8 pool"):
        QuantPagedBackend(cfg, 2, 256, kv_quant=None)
    for name in ("rolling", "rolling-int8"):
        with pytest.raises(NotImplementedError):
            make_backend(name, cfg, 2, 64)
    assert engine_class("dense-int8") is batching.BatchingEngine
    assert engine_class("paged-int8") is batching.PagedBatchingEngine
    # bytes_per_token as the JAX package prices it: L Hkv (Dk + Dv + 8)
    # for int8.
    for name in ("dense", "dense-int8", "paged", "paged-int8"):
        want = jmake_backend(name, jcfg, 2, 256).bytes_per_token()
        assert make_backend(name, cfg, 2, 256).bytes_per_token() == want
    assert dense.bytes_per_token() == cfg.n_layers * cfg.kv_heads * (
        2 * cfg.dim_per_head + 8)
    # The engines resolve the legacy flag, and refuse a conflict.
    params = tt.init_params(cfg, device=CPU)
    eng = batching.PagedBatchingEngine(cfg, params, n_slots=2, max_len=256,
                                       kv_quant="int8", device=CPU)
    assert eng.cache_backend.name == "paged-int8" and eng.block_size == 64
    eng = batching.BatchingEngine(cfg, params, n_slots=2, max_len=64,
                                  kv_quant="int8", device=CPU)
    assert eng.cache_backend.name == "dense-int8"
    with pytest.raises(ValueError):
        batching.BatchingEngine(cfg, params, cache_backend="dense",
                                kv_quant="int8", device=CPU)
    with pytest.raises(ValueError):
        batching.BatchingEngine(cfg, params, n_slots=2, max_len=64,
                                cache_backend=DenseBackend(cfg, 2, 64),
                                kv_quant="int8", device=CPU)
    with pytest.raises(ValueError):
        Engine(cfg, params, kv_quant="fp8", device=CPU)
