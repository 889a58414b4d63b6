"""The port's continuous batching against the JAX package's, on the CPU.

Paged decode attention, the paged cache writes and the engines run the
same numpy-seeded inputs through both packages in fp32 (weights cross as
numpy through `params_from_jax`). Attention agrees to atol/rtol 2e-5
(summation order only differs); cache writes and the batched logit
filter agree exactly. Greedy engine tokens are compared where the JAX
engine's own top-2 logprob margin is at least twice the logit tolerance
of 1e-4, so a token cannot flip on fp32 summation order; most tokens
must qualify.
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
from shellac_tpu.models.registry import get_model_config as jget
from shellac_tpu_torch.inference import batching
from shellac_tpu_torch.inference.cache import (
    KVCache,
    PagedBackend,
    engine_class,
    make_backend,
    paged_gather_layer,
    paged_update_layer,
    scatter_slot,
)
from shellac_tpu_torch.models import transformer as tt
from shellac_tpu_torch.models.from_jax import params_from_jax
from shellac_tpu_torch.models.registry import get_model_config
from shellac_tpu_torch.obs import Registry, ServeMetrics
from shellac_tpu_torch.ops import decode_attention as da
from shellac_tpu_torch.ops import sampling

import jax_params

jda = importlib.import_module("shellac_tpu.ops.decode_attention")
jsampling = importlib.import_module("shellac_tpu.ops.sampling")

CPU = "cpu"
ATTN_TOL = 2e-5
MARGIN = 2 * 1e-4


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _t(x):
    return torch.from_numpy(np.asarray(x))


# --------------------------------------------------------------------------
# (a) paged decode attention: plain version vs the JAX Pallas kernels
# --------------------------------------------------------------------------


def _scatter_pool(rng, dense_k, dense_v, bs, extra=3):
    """Head-major dense caches (B, Hkv, L, D) into a shuffled pool and
    tables; block 0 and `extra` unowned blocks hold noise."""
    b, hkv, length, d = dense_k.shape
    mb = length // bs
    n_blocks = b * mb + 1 + extra
    tables = rng.permutation(np.arange(1, n_blocks))[:b * mb].reshape(b, mb)
    pool_k = rng.standard_normal((n_blocks, hkv, bs, d)).astype(np.float32)
    pool_v = rng.standard_normal((n_blocks, hkv, bs, d)).astype(np.float32)
    for bi in range(b):
        for j in range(mb):
            pool_k[tables[bi, j]] = dense_k[bi, :, j * bs:(j + 1) * bs]
            pool_v[tables[bi, j]] = dense_v[bi, :, j * bs:(j + 1) * bs]
    return pool_k, pool_v, tables.astype(np.int32)


_PAGED = {
    # D 128 with a table of several page groups (two of 24 pages): kernel 7.
    "grouped": dict(s=1, h=4, hkv=2, d=128, length=768, bs=16),
    "grouped_window_softcap_sinks": dict(s=1, h=4, hkv=2, d=128,
                                         length=768, bs=16, window=100,
                                         softcap=20.0, sinks=True),
    # A block size that is no power of two and does not divide the CUDA
    # kernel's 32-position tiles (the JAX kernels take bs % 8 == 0 only).
    "grouped_bs24": dict(s=1, h=4, hkv=2, d=128, length=720, bs=24),
    # D 64 takes the one-page kernel: kernel 8.
    "one_page_d64": dict(s=1, h=4, hkv=2, d=64, length=256, bs=16),
    "one_page_d64_s2_bs8": dict(s=2, h=4, hkv=4, d=64, length=128, bs=8),
    # A window whose first live position falls mid-page (37 - 26 = 11,
    # 127 - 26 = 101: offsets 3 and 5 of 8-token pages).
    "one_page_d64_bs8_window_mid_page": dict(s=1, h=4, hkv=2, d=64,
                                             length=128, bs=8, window=27),
}


@pytest.mark.parametrize("case", sorted(_PAGED))
def test_paged_decode_attention_matches_jax_kernels(case):
    c = dict(_PAGED[case])
    s, h, hkv, d, length, bs = (c.pop(k) for k in
                                ("s", "h", "hkv", "d", "length", "bs"))
    rng = _rng("paged", case)
    b = 3
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    dk = rng.standard_normal((b, hkv, length, d)).astype(np.float32)
    dv = rng.standard_normal((b, hkv, length, d)).astype(np.float32)
    pool_k, pool_v, tables = _scatter_pool(rng, dk, dv, bs)
    index = np.array([0, 37, length - s], np.int32)
    if c.pop("sinks", False):
        c["sinks"] = rng.standard_normal((h,)).astype(np.float32)
    kw = dict(c, scale=d ** -0.5)
    if d % 128 == 0:
        assert tables.shape[1] // jda._paged_group(
            jnp.asarray(tables), jnp.asarray(pool_k)) > 1
    want = np.asarray(jda.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v),
        jnp.asarray(tables), jnp.asarray(index), impl="flash",
        interpret=True,
        **{k: jnp.asarray(v) if k == "sinks" else v for k, v in kw.items()}))
    got = da.paged_decode_attention(
        _t(q), _t(pool_k), _t(pool_v), _t(tables), _t(index),
        **{k: _t(v) if k == "sinks" else v for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_TOL,
                               rtol=ATTN_TOL)
    # The plain version is the gather plus the dense plain version.
    dense = da.decode_attention(_t(q), _t(dk), _t(dv), _t(index),
                                **{k: _t(v) if k == "sinks" else v
                                   for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=ATTN_TOL,
                               rtol=ATTN_TOL)


def test_paged_decode_supported_and_unported_scales():
    """The kernel's gate (int8 pools take it with quant=True, at any
    block size) and the scales' both-or-neither rule."""
    q = torch.zeros(2, 1, 16, 128)
    pool = torch.zeros(9, 8, 16, 128)
    assert da.paged_decode_supported(q, pool)
    assert da.paged_decode_supported(q[..., :64], pool[..., :64])
    assert not da.paged_decode_supported(q[..., :96], pool[..., :96])
    assert not da.paged_decode_supported(q, pool, quant=True)
    assert da.paged_decode_supported(q, pool.to(torch.int8), quant=True)
    assert not da.paged_decode_supported(q, pool.to(torch.int8))
    assert not da.paged_decode_supported(torch.zeros(2, 9, 16, 128), pool)
    assert not da.paged_decode_supported(q.half(), pool.half())
    with pytest.raises(ValueError, match="come together"):
        da.paged_decode_attention(q, pool, pool,
                                  torch.zeros(2, 4, dtype=torch.int32),
                                  torch.zeros(2, dtype=torch.int32),
                                  k_scale=pool[..., 0])


# --------------------------------------------------------------------------
# (b) cache writes and gathers, exactly
# --------------------------------------------------------------------------


def test_paged_update_and_gather_match_jax():
    rng = _rng("paged_update")
    nb, hkv, bs, d, b, s, mb = 13, 2, 4, 8, 2, 5, 3
    pool_k = rng.standard_normal((nb, hkv, bs, d)).astype(np.float32)
    pool_v = rng.standard_normal((nb, hkv, bs, d)).astype(np.float32)
    tables = rng.permutation(np.arange(1, nb))[:b * mb].reshape(b, mb)
    tables = tables.astype(np.int32)
    k_new = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v_new = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    index = np.array([0, 6], np.int32)  # writes span page boundaries
    jk, jv = jlayout.paged_update_layer(
        jnp.asarray(pool_k), jnp.asarray(pool_v), jnp.asarray(k_new),
        jnp.asarray(v_new), jnp.asarray(index), jnp.asarray(tables))
    tk, tv = _t(pool_k.copy()), _t(pool_v.copy())
    out = paged_update_layer(tk, tv, _t(k_new), _t(v_new), _t(index),
                             _t(tables))
    assert out[0] is tk and out[1] is tv  # written in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    gk, gv = jlayout.paged_gather_layer(jk, jv, jnp.asarray(tables))
    pk, pv = paged_gather_layer(tk, tv, _t(tables))
    np.testing.assert_array_equal(pk.numpy(), np.asarray(gk))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(gv))
    # A position past the table raises instead of clamping.
    with pytest.raises((IndexError, RuntimeError)):
        paged_update_layer(tk, tv, _t(k_new), _t(v_new),
                           torch.tensor([0, mb * bs - 2], dtype=torch.int32),
                           _t(tables))


def test_scatter_slot_matches_jax():
    rng = _rng("scatter_slot")
    shape, mini_shape = (2, 3, 2, 16, 4), (2, 1, 2, 8, 4)
    ck, cv, mk, mv = (rng.standard_normal(x).astype(np.float32)
                      for x in (shape, shape, mini_shape, mini_shape))
    lengths = np.array([5, 9, 2], np.int32)
    jc = jlayout.scatter_slot(
        jlayout.KVCache(k=jnp.asarray(ck), v=jnp.asarray(cv),
                        lengths=jnp.asarray(lengths)),
        jlayout.KVCache(k=jnp.asarray(mk), v=jnp.asarray(mv),
                        lengths=jnp.asarray([7], jnp.int32)), 1)
    tc = scatter_slot(
        KVCache(k=_t(ck.copy()), v=_t(cv.copy()), lengths=_t(lengths.copy())),
        KVCache(k=_t(mk), v=_t(mv), lengths=torch.tensor([7],
                                                         dtype=torch.int32)),
        1)
    for name in ("k", "v", "lengths"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))


# --------------------------------------------------------------------------
# (c) the engines, greedy, against the JAX engines
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


def _requests(name, vocab):
    """8 ragged requests with mixed budgets over 3 slots, so slots
    recycle and blocks return."""
    rng = _rng("requests", name)
    lens = [3, 17, 9, 24, 5, 12, 30, 7]
    max_new = [6, 9, 1, 12, 4, 10, 8, 5]
    return [(f"r{i}", rng.integers(0, vocab, n).astype(np.int32), m)
            for i, (n, m) in enumerate(zip(lens, max_new))]


def _eos_and_stop(tc, tp, reqs):
    """An EOS id and a stop sequence taken from a greedy probe run, so
    both fire in the compared runs."""
    probe = batching.BatchingEngine(tc, tp, n_slots=3, max_len=64,
                                    device=CPU).run(reqs)
    eos = probe["r3"][4]
    stop = probe["r5"][3:5]
    return eos, stop


def _drive(eng, reqs, stop):
    """Submit, then step to empty; returns (results, per-step slot block
    lists (paged) and per-step occupant outputs)."""
    for rid, toks, m in reqs:
        eng.submit(rid, toks, m, stop=[stop] if rid in ("r5", "r6") else None)
    results, blocks, outs = {}, [], []
    while eng.pending:
        for rid, out in eng.step():
            results[rid] = list(out)
        blocks.append([list(b) for b in eng.cache_backend._slot_blocks]
                      if eng.cache_backend.is_paged else None)
        outs.append([(r.rid, list(r.out)) if r is not None else None
                     for r in eng._slots])
    return results, blocks, outs


_JAX_ENGINES = {}


def _jax_engine(name, paged, kw):
    """The JAX engine of (name, paged), built once and shared by the
    tick counts (its prefill programs do not depend on them): reset to a
    pristine allocator and set to this case's decode_ticks."""
    key = (name, paged)
    if key not in _JAX_ENGINES:
        jc, _, jp, _ = _cached_pair(name)
        cls = (jbatching.PagedBatchingEngine if paged
               else jbatching.BatchingEngine)
        _JAX_ENGINES[key] = cls(jc, jp, **kw)
    jeng = _JAX_ENGINES[key]
    assert jeng.eos_id == kw["eos_id"]
    jeng.abort_all()
    jeng.set_decode_ticks(kw["decode_ticks"])
    return jeng


@pytest.mark.parametrize("ticks", [1, 3])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("name", ["tiny", "tiny-gqa"])
def test_engines_greedy_match_jax(name, paged, ticks):
    jc, tc, jp, tp = _cached_pair(name)
    reqs = _requests(name, tc.vocab_size)
    eos, stop = _eos_and_stop(tc, tp, reqs)
    kw = dict(n_slots=3, max_len=64, eos_id=eos, decode_ticks=ticks,
              logprobs=True, top_logprobs=2)
    if paged:
        kw.update(block_size=8, pool_tokens=96)
    tcls = batching.PagedBatchingEngine if paged else batching.BatchingEngine
    jeng = _jax_engine(name, paged, kw)
    teng = tcls(tc, tp, device=CPU, **kw)
    want, jblocks, jouts = _drive(jeng, reqs, stop)
    got, tblocks, touts = _drive(teng, reqs, stop)
    assert set(got) == set(want) == {r[0] for r in reqs}
    compared = total = 0
    for rid, _, _ in reqs:
        tl = jeng.finished_top_logprobs[rid]
        margins = np.array([lps[0] - lps[1] for _, lps in tl])
        n = len(want[rid])
        low = np.flatnonzero(margins < MARGIN)
        upto = int(low[0]) if low.size else n
        assert got[rid][:upto] == want[rid][:upto], rid
        np.testing.assert_allclose(teng.finished_logprobs[rid][:upto],
                                   jeng.finished_logprobs[rid][:upto],
                                   atol=1e-4)
        compared += upto
        total += n
    assert compared >= 0.75 * total, (compared, total)
    # EOS and the stop sequence both ended a request.
    assert any(out and out[-1] == eos for out in want.values())
    assert len(want["r5"]) < 10 or len(want["r6"]) < 8
    # While every occupant's output agrees, the allocators agree block
    # for block; at the end every block is back.
    agree = 0
    while agree < min(len(jouts), len(touts)) \
            and jouts[agree] == touts[agree]:
        agree += 1
    assert agree >= len(jouts) // 2, (agree, len(jouts))
    assert tblocks[:agree] == jblocks[:agree]
    if paged:
        assert teng.cache_backend._free == jeng.cache_backend._free \
            or agree < len(jouts)
        assert len(teng.cache_backend._free) == teng.cache_backend.n_blocks - 1
        assert int(teng._cache.tables.abs().sum()) == 0


def test_engines_match_single_request_engine():
    """Scheduling is invisible to the math: each request's greedy output
    equals the single-request Engine's, dense and paged, with slots
    recycling and the pool too small for every slot at once."""
    from shellac_tpu_torch.inference.engine import Engine

    _, tc, _, tp = _cached_pair("tiny-gqa")
    reqs = _requests("single", tc.vocab_size)
    runs = [
        batching.BatchingEngine(tc, tp, n_slots=3, max_len=64, device=CPU),
        batching.PagedBatchingEngine(tc, tp, n_slots=3, max_len=64,
                                     block_size=16, pool_tokens=64,
                                     decode_ticks=2, device=CPU),
    ]
    results = [eng.run(reqs) for eng in runs]
    assert runs[1].stats["pool_exhausted"] > 0
    single = Engine(tc, tp, temperature=0.0, max_len=64, device=CPU)
    for rid, toks, m in reqs:
        want = single.generate(_t(toks[None].astype(np.int64)),
                               max_new_tokens=m).tokens[0].tolist()
        assert results[0][rid] == want == results[1][rid], rid


@pytest.mark.parametrize("backend", ["dense", "paged", "dense-int8",
                                     "paged-int8"])
def test_window_state_keeps_its_tensors(backend):
    """What the decode window's CUDA graph replays against: across
    windows, releases and refills, every tensor the window reads or
    writes keeps its storage, and its device lengths agree with the
    host's."""
    _, tc, _, tp = _cached_pair("tiny")
    paged = backend.startswith("paged")
    cls = batching.PagedBatchingEngine if paged else batching.BatchingEngine
    eng = cls(tc, tp, n_slots=2, max_len=64, cache_backend=backend,
              decode_ticks=2, device=CPU)
    names = (["lengths", "k", "v"] + (["tables"] if paged else [])
             + (["ks", "vs"] if backend.endswith("int8") else []))
    fixed = [getattr(eng._cache, n) for n in names] + [
        eng._cur, eng._smin, eng._srem, eng._sdone, eng._active,
        eng._stemp, eng._stopk, eng._stopp, eng._sminp]
    ptrs = [t.data_ptr() for t in fixed]
    cache = eng._cache
    rng = _rng("identity", backend)
    for i, (n, m) in enumerate([(5, 3), (9, 6), (3, 2), (7, 5), (4, 3)]):
        eng.submit(f"r{i}", rng.integers(0, tc.vocab_size, n), m)
    finished, windows = 0, 0
    while eng.pending:
        finished += len(eng.step())
        windows = eng.stats["decode_windows"]
        assert eng._cache is cache
        assert [t.data_ptr() for t in fixed] == ptrs
        assert eng._cache.lengths.tolist() == eng._host_len
    assert finished == 5 and windows >= 3
    assert eng.stats["prefills"] == 5 > eng.n_slots
    assert eng.stats["decode_graphs"] == 0  # the CPU runs windows eagerly


# --------------------------------------------------------------------------
# (d) batched sampling
# --------------------------------------------------------------------------


def test_filter_logits_batched_matches_jax():
    rng = _rng("filter")
    v = 64
    logits = (3 * rng.standard_normal((6, v))).astype(np.float32)
    temperature = np.array([0.0, 0.7, 1.3, 1.0, 0.5, 2.0], np.float32)
    top_k = np.array([v, 5, 1, 12, v, 40], np.int32)
    top_p = np.array([1.0, 0.9, 1.0, 0.5, 0.8, 1.0], np.float32)
    min_p = np.array([0.0, 0.0, 0.1, 0.05, 0.0, 0.2], np.float32)
    want = np.asarray(jsampling.filter_logits_batched(
        *(jnp.asarray(x) for x in (logits, temperature, top_k, top_p,
                                   min_p))))
    got = sampling.filter_logits_batched(
        *(_t(x) for x in (logits, temperature, top_k, top_p, min_p)))
    np.testing.assert_array_equal(got.numpy(), want)
    # Greedy rows take the argmax; a top_k=1 row can only draw its top.
    gen = torch.Generator().manual_seed(3)
    ids = sampling.sample_batched(
        gen, _t(logits), *(_t(x) for x in (temperature, top_k, top_p,
                                           min_p)))
    assert ids[0] == int(np.argmax(logits[0]))
    assert ids[2] == int(np.argmax(logits[2]))
    # A masked or non-finite row still draws (Gumbel-max, no raise).
    bad = torch.full((2, v), sampling.NEG_INF)
    bad[1] = float("nan")
    sampling.sample_batched(gen, bad, torch.ones(2), torch.full((2,), v),
                            torch.ones(2), torch.zeros(2))


def test_sampled_engine_runs_are_self_consistent():
    _, tc, _, tp = _cached_pair("tiny-gqa")
    reqs = _requests("sampled", tc.vocab_size)

    def run(**kw):
        eng = batching.PagedBatchingEngine(tc, tp, n_slots=3, max_len=64,
                                           seed=7, device=CPU, **kw)
        for rid, toks, m in reqs:
            eng.submit(rid, toks, m, top_k=1 if rid == "r1" else None)
        out = {}
        while eng.pending:
            out.update(eng.step())
        return out

    a = run(temperature=0.9, top_p=0.95)
    assert a == run(temperature=0.9, top_p=0.95)
    greedy = batching.BatchingEngine(tc, tp, n_slots=3, max_len=64,
                                     device=CPU).run(reqs)
    assert a["r1"] == greedy["r1"]
    assert a != greedy


def test_min_tokens_bans_eos_until_reached():
    _, tc, _, tp = _cached_pair("tiny")
    reqs = _requests("min_tokens", tc.vocab_size)
    probe = batching.BatchingEngine(tc, tp, n_slots=2, max_len=64,
                                    device=CPU).run(reqs)
    eos = probe["r3"][1]
    eng = batching.BatchingEngine(tc, tp, n_slots=2, max_len=64, eos_id=eos,
                                  device=CPU)
    eng.submit("free", reqs[3][1], 12)
    eng.submit("held", reqs[3][1], 12, min_tokens=6)
    out = eng.run()
    assert out["free"] == probe["r3"][:2]
    assert len(out["held"]) >= 6 and eos not in out["held"][:5]


# --------------------------------------------------------------------------
# (e) the engine owns the cache's host length bookkeeping
# --------------------------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True])
def test_recycled_slot_runs_past_max_len_ticks(paged):
    """One slot, max_len 64, six 20 + 20 requests in a row: about 114
    decode ticks, past max_len, although no request comes near it."""
    cfg = get_model_config("tiny")
    params = tt.init_params(cfg, device=CPU)
    cls = batching.PagedBatchingEngine if paged else batching.BatchingEngine
    eng = cls(cfg, params, n_slots=1, max_len=64, device=CPU)
    rng = _rng("recycle")
    reqs = [(i, rng.integers(0, cfg.vocab_size, 20), 20) for i in range(6)]
    out = eng.run(reqs)
    assert sorted(out) == list(range(6))
    assert all(len(v) == 20 for v in out.values())
    assert eng.stats["decode_windows"] == 6 * 19 > 64


# --------------------------------------------------------------------------
# (f) devices, the registry and what is not ported
# --------------------------------------------------------------------------


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card path is moot")
    cfg = get_model_config("tiny")
    params = tt.init_params(cfg, device=CPU)
    for cls in (batching.BatchingEngine, batching.PagedBatchingEngine):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(cfg, params)
        cls(cfg, params, device=CPU)


def test_cache_registry():
    cfg = get_model_config("tiny")
    assert engine_class("dense") is batching.BatchingEngine
    assert engine_class("paged") is batching.PagedBatchingEngine
    for name in ("rolling", "rolling-int8"):
        with pytest.raises(NotImplementedError):
            make_backend(name, cfg, 2, 64)
    assert make_backend("dense-int8", cfg, 2, 64).kv_quant == "int8"
    assert make_backend("paged-int8", cfg, 2, 64).block_size == 64
    with pytest.raises(NotImplementedError):
        engine_class("paged", speculative=True)
    with pytest.raises(ValueError):
        make_backend("nope", cfg, 2, 64)
    pb = make_backend("paged", cfg, 4, 100, block_size=16)
    assert isinstance(pb, PagedBackend)
    assert pb.max_blocks_per_slot == 7 and pb.n_blocks == 14
    params = tt.init_params(cfg, device=CPU)
    with pytest.raises(ValueError):
        batching.BatchingEngine(cfg, params, cache_backend="paged",
                                device=CPU)
    with pytest.raises(ValueError):
        batching.PagedBatchingEngine(cfg, params, cache_backend="dense",
                                     device=CPU)


_ENGINE_OPTS = [
    {"mesh": object()}, {"pp_pipeline": True},
    {"kv_quant": "int8", "rolling_window": True}, {"rolling_window": True},
]
_SUBMIT_OPTS = [
    {"prefill_only": True},
    {"tenant": "a"}, {"qos_class": 0}, {"qos_weight": 2.0},
]
# Ported since constrained decoding landed: a constraint that is not a
# compiled TokenDFA is a bad request, as in the reference.
_BAD_PORTED_SUBMIT_OPTS = [{"constraint": object()}]
# Ported since the prefix cache and sampling controls landed.
_PORTED_SUBMIT_OPTS = [
    {"logit_bias": {1: 2.0}}, {"presence_penalty": 0.5},
    {"frequency_penalty": 0.5}, {"seed": 0}, {"prompt_logprobs": True},
]


@pytest.mark.parametrize("paged", [False, True])
def test_unported_options_raise(paged):
    cfg = get_model_config("tiny")
    params = tt.init_params(cfg, device=CPU)
    cls = batching.PagedBatchingEngine if paged else batching.BatchingEngine
    for kw in _ENGINE_OPTS:
        with pytest.raises(NotImplementedError):
            cls(cfg, params, device=CPU, **kw)
    eng = cls(cfg, params, n_slots=2, max_len=32, device=CPU)
    for kw in _SUBMIT_OPTS:
        with pytest.raises(NotImplementedError):
            eng.submit("x", [1, 2, 3], 4, **kw)
    for kw in _BAD_PORTED_SUBMIT_OPTS:
        with pytest.raises(ValueError, match="TokenDFA"):
            eng.submit("x", [1, 2, 3], 4, **kw)
    for fn in (lambda: eng.preempt("x"), lambda: eng.release_frozen("x")):
        with pytest.raises(NotImplementedError):
            fn()
    # The off values of those options are accepted, and so are the
    # ported controls.
    eng.submit("ok", [1, 2, 3], 2, presence_penalty=0.0, logit_bias={},
               prompt_logprobs=False)
    for i, kw in enumerate(_PORTED_SUBMIT_OPTS):
        eng.submit(f"c{i}", [1, 2, 3], 2, **kw)
    assert eng.pending == 1 + len(_PORTED_SUBMIT_OPTS)
    # The admission and decode pipelines and chunked prefill are ported.
    eng = cls(cfg, params, n_slots=2, max_len=32, overlap_decode=True,
              overlap_prefill=True, prefill_chunk=16, device=CPU)
    assert eng.run([("p", [1, 2, 3], 2)])["p"]
    # The observability hooks are ported: an engine takes a registry and
    # a request takes a trace.
    reg = Registry()
    eng = cls(cfg, params, n_slots=2, max_len=32, registry=reg, device=CPU)
    eng.submit("t", [1, 2, 3], 2, trace=ServeMetrics(reg).trace())
    assert eng.pending == 1 and eng.obs.registry is reg


@pytest.mark.parametrize("paged", [False, True])
def test_cancel_and_abort_all_return_every_block(paged):
    _, tc, _, tp = _cached_pair("tiny")
    cls = batching.PagedBatchingEngine if paged else batching.BatchingEngine
    eng = cls(tc, tp, n_slots=2, max_len=64, device=CPU)
    for rid, toks, m in _requests("cancel", tc.vocab_size):
        eng.submit(rid, toks, m)
    eng.step()
    running = [r.rid for r in eng._slots if r is not None]
    assert eng.cancel(running[0]) and eng.cancel("r7")
    assert not eng.cancel("nope")
    eng.step()
    assert sorted(eng.abort_all()) == sorted(
        set(r[0] for r in _requests("cancel", tc.vocab_size))
        - {running[0], "r7"} - set(eng.finished_timings))
    assert eng.pending == 0 and int(eng._cache.lengths.abs().sum()) == 0
    if paged:
        be = eng.cache_backend
        assert be._free == list(range(be.n_blocks - 1, 0, -1))
        assert int(eng._cache.tables.abs().sum()) == 0
