"""The port's chunked prefill against the JAX package's, on the CPU.

The reference's cases (`tests/test_chunked_prefill.py:39-186`) without
the prefix cache and speculative decoding, which the port lacks: a long
prompt prefills chunk by chunk (the first chunk fresh, every later one
attending the resident rows through the plain attention, as the JAX
engine pins it), the chunk and prefill counts are the reference's, a
running request keeps decoding while a long prompt prefills, and chunks
under way keep their share of the prefill budget. The same numpy-seeded
weights (tiny preset, fp32, through `params_from_jax`) and prompts go
through the JAX and the port's chunked engines; tokens are compared
while the JAX engine's own top-2 logprob margin is at least twice the
logit tolerance of 1e-4, and logprobs there to 1e-4
(`tests/test_torch_batching.py`'s rule). Chunking is invisible to the
math up to fp32 summation order: the port's chunked tokens also equal
its whole-prompt engine's where that margin allows.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shellac_tpu.inference import batching as jbatching
from shellac_tpu.models.registry import get_model_config as jget
from shellac_tpu_torch.inference import batching
from shellac_tpu_torch.models.from_jax import params_from_jax
from shellac_tpu_torch.models.registry import get_model_config

import jax_params

CPU = "cpu"
MARGIN = 2 * 1e-4


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


@pytest.fixture(scope="module")
def pair():
    jc = jget("tiny").replace(dtype="float32")
    tc = get_model_config("tiny").replace(dtype="float32")
    p = jax_params.init_params(jc)
    return jc, tc, jax.tree.map(jnp.asarray, p), params_from_jax(tc, p, CPU)


_JAX_ENGINES = {}


def _engines(pair, backend="dense", **kw):
    """(JAX engine, port engine) of one configuration, with the JAX
    engine's top-2 logprobs for the margin rule. The JAX engine of a
    configuration is built once (its compiled programs shared by the
    tests), drained and its chunk and prefill counters zeroed for each."""
    jc, tc, jp, tp = pair
    paged = backend.startswith("paged")
    if paged:
        kw.setdefault("block_size", 32 if backend == "paged-int8" else 8)
    kw.update(cache_backend=backend, logprobs=True, top_logprobs=2)
    jcls = jbatching.PagedBatchingEngine if paged else jbatching.BatchingEngine
    tcls = batching.PagedBatchingEngine if paged else batching.BatchingEngine
    key = tuple(sorted(kw.items()))
    if key not in _JAX_ENGINES:
        _JAX_ENGINES[key] = jcls(jc, jp, **kw)
    jeng = _JAX_ENGINES[key]
    jeng.abort_all()
    for k in ("prefill_chunks", "prefills"):
        jeng.stats[k] = 0
    return jeng, tcls(tc, tp, device=CPU, **kw)


def _agree(jeng, want, teng, got):
    """Tokens (and logprobs) equal while the JAX top-2 margin allows;
    most tokens must qualify."""
    compared = total = 0
    for rid, w in want.items():
        margins = [lps[0] - lps[1]
                   for _, lps in jeng.finished_top_logprobs[rid]]
        low = [i for i, m in enumerate(margins) if m < MARGIN]
        upto = low[0] if low else len(w)
        assert list(got[rid][:upto]) == list(w[:upto]), rid
        np.testing.assert_allclose(teng.finished_logprobs[rid][:upto],
                                   jeng.finished_logprobs[rid][:upto],
                                   atol=1e-4)
        compared += upto
        total += len(w)
    assert compared >= 0.75 * total, (compared, total)


@pytest.mark.parametrize("backend", ["dense", "paged", "dense-int8",
                                     "paged-int8"])
def test_long_prompt_matches_jax(pair, backend):
    """50 tokens at chunk 16: four chunk programs and one prefill, both
    engines; the tokens agree. (One prefill a step, as the tests below:
    the dense JAX engine is theirs.)"""
    prompt = _rng("long", backend).integers(0, pair[1].vocab_size,
                                            50).astype(np.int32)
    jeng, teng = _engines(pair, backend, n_slots=2, max_len=96,
                          prefill_chunk=16, max_prefills_per_step=1)
    want = jeng.run([("x", prompt, 8)])
    got = teng.run([("x", prompt, 8)])
    _agree(jeng, want, teng, got)
    for eng in (jeng, teng):
        assert eng.stats["prefill_chunks"] == 4
        assert eng.stats["prefills"] == 1


def test_chunking_is_invisible_to_the_math(pair):
    """The port's chunked engine gives its whole-prompt engine's tokens,
    dense and paged, where the margin allows."""
    _, tc, _, tp = pair
    prompt = _rng("invisible").integers(0, tc.vocab_size, 50).astype(np.int32)
    for cls in (batching.BatchingEngine, batching.PagedBatchingEngine):
        kw = dict(n_slots=2, max_len=96, logprobs=True, top_logprobs=2,
                  device=CPU)
        whole = cls(tc, tp, **kw)
        want = whole.run([("x", prompt, 8)])
        got = cls(tc, tp, prefill_chunk=16, **kw).run([("x", prompt, 8)])
        margins = [lps[0] - lps[1]
                   for _, lps in whole.finished_top_logprobs["x"]]
        low = [i for i, m in enumerate(margins) if m < MARGIN]
        upto = low[0] if low else 8
        assert got["x"][:upto] == want["x"][:upto] and upto >= 6


def test_short_prompt_runs_one_program(pair):
    jeng, teng = _engines(pair, n_slots=1, max_len=64, prefill_chunk=16)
    prompt = np.array([1, 2, 3], np.int32)
    want = jeng.run([("x", prompt, 6)])
    got = teng.run([("x", prompt, 6)])
    _agree(jeng, want, teng, got)
    assert teng.stats["prefill_chunks"] == jeng.stats["prefill_chunks"] == 0


def test_decode_continues_during_chunked_prefill(pair):
    """A running request keeps emitting every step while a long prompt
    prefills chunk by chunk under a budget of one program a step."""
    vocab = pair[1].vocab_size
    rng = _rng("continues")
    short = rng.integers(0, vocab, 4).astype(np.int32)
    long = rng.integers(0, vocab, 48).astype(np.int32)
    results = {}
    for which, eng in zip(("jax", "port"), _engines(
            pair, n_slots=2, max_len=96, prefill_chunk=16,
            max_prefills_per_step=1)):
        eng.submit("short", short, 10)
        eng.step()
        eng.submit("long", long, 6)
        before = len(eng._slots[0].out)
        got, chunked_steps = {}, 0
        while eng.pending:
            got.update(eng.step())
            if eng._prefilling:
                chunked_steps += 1
                cur = next(r for r in eng._slots
                           if r is not None and r.rid == "short")
                assert len(cur.out) > before
                before = len(cur.out)
        assert chunked_steps >= 2
        results[which] = (eng, got)
    (jeng, want), (teng, got) = results["jax"], results["port"]
    _agree(jeng, want, teng, got)


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_many_long_prompts_churn(pair, backend):
    vocab = pair[1].vocab_size
    rng = _rng("churn", backend)
    reqs = [(i, rng.integers(0, vocab, 30 + i).astype(np.int32), 5)
            for i in range(5)]
    jeng, teng = _engines(pair, backend, n_slots=2, max_len=96,
                          prefill_chunk=8, max_prefills_per_step=2)
    want = jeng.run(reqs)
    got = teng.run(reqs)
    _agree(jeng, want, teng, got)
    assert teng.stats["prefill_chunks"] == jeng.stats["prefill_chunks"]
    assert teng.stats["prefills"] == jeng.stats["prefills"] == 5


def test_chunks_advance_under_short_prompt_stream(pair):
    """A stream of short prompts does not starve a chunked prefill under
    way: chunks take the step's budget first."""
    vocab = pair[1].vocab_size
    rng = _rng("stream")
    long = rng.integers(0, vocab, 48).astype(np.int32)
    shorts = [rng.integers(0, vocab, 3).astype(np.int32) for _ in range(8)]
    runs = {}
    for which, eng in zip(("jax", "port"), _engines(
            pair, n_slots=2, max_len=96, prefill_chunk=16,
            max_prefills_per_step=1)):
        eng.submit("long", long, 4)
        eng.step()  # admits long and runs its first chunk
        for i, s in enumerate(shorts):
            eng.submit(f"s{i}", s, 2)
        results, steps = {}, 0
        while eng.pending and steps < 60:
            results.update(eng.step())
            steps += 1
        assert len(results) == 9
        runs[which] = (eng, results)
    (jeng, want), (teng, got) = runs["jax"], runs["port"]
    _agree(jeng, want, teng, got)


@pytest.mark.parametrize("chunk", [0, -3, "fast"])
def test_bad_chunk_size_is_refused(pair, chunk):
    _, tc, _, tp = pair
    with pytest.raises(ValueError, match="prefill_chunk"):
        batching.BatchingEngine(tc, tp, prefill_chunk=chunk, device=CPU)
