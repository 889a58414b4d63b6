"""The port's per-request sampling controls against the JAX package's, on
the CPU.

Logit bias, presence and frequency penalties, per-request seeds and
prompt logprobs, through `submit` of both batching engines over the four
caches (the reference's `tests/test_sampling_extras.py` and
`tests/test_logprobs.py` are the oracles). The same numpy-seeded weights
(tiny preset, fp32, through `params_from_jax`) and prompts go through the
JAX and the port's engines (the JAX engine over the dense cache of each
storage, whose logits its paged cache computes too):

  - greedy tokens under bias and penalties equal the JAX engine's up to
    the first position whose top-2 margin under the controls (the raw
    logits plus the bias, less the penalties over the tokens generated
    before it, from a plain fp32 forward) is under twice the logit
    tolerance of 1e-4; raw logprobs there agree to 1e-4;
  - prompt logprobs equal the JAX engine's within 1e-4, whole and
    chunked;
  - a seed cannot give the JAX engine's tokens (threefry against the
    port's counter hash), so seeded requests are held to themselves:
    alone or among neighbours, in another slot, at another decode_ticks,
    under the pipelines and over the paged pool; an unseeded row is
    unmoved by a seeded neighbour; seeded draws over many seeds, and
    over many positions of one seed, follow the softmax (a chi-square
    test on 8 tokens);
  - `Engine.generate` keeps its programs across calls: a second call with
    the same seed gives the first call's tokens, and a fresh engine's.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shellac_tpu.inference import batching as jbatching
from shellac_tpu.models.registry import get_model_config as jget
from shellac_tpu_torch.inference import batching
from shellac_tpu_torch.inference.engine import Engine
from shellac_tpu_torch.models import transformer as tt
from shellac_tpu_torch.models.from_jax import params_from_jax
from shellac_tpu_torch.models.registry import get_model_config
from shellac_tpu_torch.ops.sampling import sample_batched

import jax_params

CPU = "cpu"
MARGIN = 2 * 1e-4
# The chi-square statistic's 99.9% quantile at 7 degrees of freedom.
CHI2_7_999 = 24.32


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


@pytest.fixture(scope="module")
def pair():
    jc = jget("tiny").replace(dtype="float32")
    tc = get_model_config("tiny").replace(dtype="float32")
    p = jax_params.init_params(jc)
    return jc, tc, jax.tree.map(jnp.asarray, p), params_from_jax(tc, p, CPU)


def _classes(backend):
    if backend.startswith("paged"):
        return jbatching.PagedBatchingEngine, batching.PagedBatchingEngine
    return jbatching.BatchingEngine, batching.BatchingEngine


def _kw(backend, **kw):
    kw = dict(kw, cache_backend=backend)
    if backend.startswith("paged"):
        kw.setdefault("block_size", 32 if backend == "paged-int8" else 8)
    return kw


def _adjusted_upto(tc, tp, prompt, out, bias=None, pres=0.0, freq=0.0):
    """How many leading greedy tokens of `out` have a top-2 margin of at
    least MARGIN under the controls."""
    ids = np.asarray([list(prompt) + list(out)], np.int64)
    logits = tt.forward(tc, tp, ids, device=CPU)[0].detach().numpy()
    counts = np.zeros((tc.vocab_size,), np.float32)
    for j, tok in enumerate(out):
        row = logits[len(prompt) + j - 1].copy()
        for k, v in (bias or {}).items():
            row[k] += v
        row -= pres * (counts > 0) + freq * counts
        top = np.sort(row)[-2:]
        if top[1] - top[0] < MARGIN:
            return j
        counts[tok] += 1
    return len(out)


def _control_requests(vocab):
    rng = _rng("controls")
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n in (9, 14, 12, 10, 15)]
    ctl = [{}, {"presence_penalty": 1.2},
           {"logit_bias": {5: 1.5, 17: -2.0, 40: 0.7}},
           {"frequency_penalty": 0.8, "presence_penalty": 0.3},
           {"logit_bias": {3: 0.9}, "frequency_penalty": 1.5}]
    return [(f"r{i}", p, 10, c) for i, (p, c) in enumerate(zip(prompts, ctl))]


# The JAX engine's runs, by the storage they read (the dense and paged
# caches of one storage compute the same logits): built once.
_JAX_RUNS = {}


def _jax_run(pair, key, backend, reqs, **kw):
    """(results, JAX engine) of `reqs` on the JAX engine over `backend`,
    each request a (rid, prompt, max_new, submit options)."""
    if key not in _JAX_RUNS:
        jc, _, jp, _ = pair
        jeng = _classes(backend)[0](jc, jp, **_kw(backend, **kw))
        for rid, p, n, c in reqs:
            jeng.submit(rid, p, n, **c)
        _JAX_RUNS[key] = jeng.run(), jeng
    return _JAX_RUNS[key]


@pytest.mark.parametrize("backend", ["dense", "paged", "dense-int8",
                                     "paged-int8"])
def test_bias_and_penalties_match_jax(pair, backend):
    """Greedy requests with and without controls share one window (2
    ticks a window): each gives the tokens of the JAX engine over the
    dense cache of the same storage under the margin rule, and the raw
    logprobs agree."""
    _, tc, _, tp = pair
    tcls = _classes(backend)[1]
    kw = dict(n_slots=5, max_len=64, decode_ticks=2, logprobs=True)
    reqs = _control_requests(tc.vocab_size)
    dense = "dense-int8" if backend.endswith("int8") else "dense"
    want, jeng = _jax_run(pair, ("controls", dense), dense, reqs, **kw)
    kw = _kw(backend, **kw)
    engines = (jeng, tcls(tc, tp, device=CPU, **kw))
    for rid, p, n, c in reqs:
        engines[1].submit(rid, p, n, **c)
    got = engines[1].run()
    compared = 0
    for rid, p, n, c in reqs:
        upto = _adjusted_upto(tc, tp, p, want[rid],
                              bias=c.get("logit_bias"),
                              pres=c.get("presence_penalty", 0.0),
                              freq=c.get("frequency_penalty", 0.0))
        assert got[rid][:upto] == want[rid][:upto], rid
        np.testing.assert_allclose(
            engines[1].finished_logprobs[rid][:upto],
            engines[0].finished_logprobs[rid][:upto], atol=1e-4)
        compared += upto
    assert compared >= 0.75 * 10 * len(reqs), compared
    # The controls moved the tokens; their slots' bias rows were cleared
    # on release, and a plain request on a reused slot inherits no bias
    # and no counts (the reference's test_sampling_extras.py:216).
    plain = tcls(tc, tp, device=CPU, **kw)
    want_plain = plain.run([(rid, p, n) for rid, p, n, _ in reqs])
    assert all(want_plain[rid] != got[rid] for rid, _, _, c in reqs if c)
    eng = engines[1]
    assert not any(eng._slot_pen) and eng._slot_bias == [None] * 5
    assert not eng._sbias.any()
    assert eng.run([(rid, p, n) for rid, p, n, _ in reqs]) == want_plain


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_prompt_logprobs_match_jax(pair, backend):
    """Prompt logprobs of whole prompts and of prompts prefilled in
    chunks of 16 equal the JAX engine's whole-prompt scores (over the
    dense cache) within 1e-4; a request without them gets none."""
    _, tc, _, tp = pair
    tcls = _classes(backend)[1]
    rng = _rng("plp")
    prompts = [rng.integers(0, tc.vocab_size, n).astype(np.int32)
               for n in (1, 12, 37, 50)]
    _, jeng = _jax_run(pair, ("plp",), "dense",
                       [(i, p, 3, {"prompt_logprobs": True})
                        for i, p in enumerate(prompts)],
                       n_slots=2, max_len=96)
    kw = _kw(backend, n_slots=2, max_len=96)
    for chunk in (None, 16):
        teng = tcls(tc, tp, device=CPU, prefill_chunk=chunk, **kw)
        for i, p in enumerate(prompts):
            teng.submit(i, p, 3, prompt_logprobs=True)
        teng.submit("none", prompts[1], 3)
        teng.run()
        for i, p in enumerate(prompts):
            got = teng.finished_prompt_logprobs[i]
            assert len(got) == p.size and got[0] == 0.0
            np.testing.assert_allclose(
                got, jeng.finished_prompt_logprobs[i], atol=1e-4,
                err_msg=f"prompt {i} chunk {chunk}")
        assert "none" not in teng.finished_prompt_logprobs
    assert teng.stats["prefill_chunks"] == 3 + 4


def _seeded_tokens(tc, tp, backend="dense", neighbours=(), **kw):
    """The tokens of seeded request "s" (temperature 0.8, seed 7), after
    `neighbours` were submitted ahead of it."""
    cls = _classes(backend)[1]
    eng = cls(tc, tp, device=CPU, seed=11, **_kw(backend, n_slots=4,
                                                   max_len=64, **kw))
    for rid, p, c in neighbours:
        eng.submit(rid, p, 12, temperature=0.9, **c)
    eng.submit("s", np.arange(3, 14, dtype=np.int32), 14, temperature=0.8,
               seed=7)
    return eng.run()["s"]


def test_seeded_requests_are_self_consistent(pair):
    """A seeded request's tokens depend on its seed alone: the same alone
    in slot 0, among neighbours (seeded and not) in slot 3, at 1 and 3
    ticks a window, under both pipelines, and over the paged pool."""
    _, tc, _, tp = pair
    rng = _rng("neighbours")
    neighbours = [(f"n{i}", rng.integers(0, tc.vocab_size, 5 + 6 * i)
                   .astype(np.int32), {"seed": 100 + i} if i % 2 else {})
                  for i in range(3)]
    want = _seeded_tokens(tc, tp)
    assert len(set(want)) > 3
    variants = {
        "neighbours": dict(neighbours=neighbours, decode_ticks=3),
        "pipelines": dict(neighbours=neighbours[:1], overlap_decode=True,
                          overlap_prefill=True, decode_ticks=2),
        "paged": dict(backend="paged", neighbours=neighbours[1:]),
    }
    for name, kw in variants.items():
        assert _seeded_tokens(tc, tp, **kw) == want, name


def test_unseeded_rows_are_unmoved_by_a_seeded_neighbour(pair):
    """Two unseeded sampled requests draw the same tokens whether their
    neighbour is seeded or not: the shared stream keeps its shape."""
    _, tc, _, tp = pair
    rng = _rng("unmoved")
    prompts = [rng.integers(0, tc.vocab_size, 6 + 5 * i).astype(np.int32)
               for i in range(3)]
    outs = []
    for seed in (None, 21):
        eng = batching.BatchingEngine(tc, tp, n_slots=3, max_len=64,
                                      temperature=1.0, seed=4, device=CPU,
                                      decode_ticks=2)
        eng.submit("a", prompts[0], 12)
        eng.submit("b", prompts[1], 12)
        eng.submit("c", prompts[2], 12, seed=seed)
        outs.append(eng.run())
    assert outs[0]["a"] == outs[1]["a"] and outs[0]["b"] == outs[1]["b"]
    assert outs[0]["c"] != outs[1]["c"]


def test_seeded_draws_follow_the_softmax():
    """Over 4000 seeds at one position, and 4000 positions of one seed,
    the draws' counts on 8 tokens pass a chi-square test against the
    softmax (99.9% quantile); a draw is a function of (seed, gen_idx,
    logits) alone: the same in any row, with any neighbours, from any
    generator state."""
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 0.3, 1.5])
    probs = torch.softmax(logits, 0).numpy()
    n = 4000
    ones = torch.ones((n,))
    samp = (ones, torch.full((n,), 8), ones, torch.zeros((n,)))
    rows = logits.expand(n, 8)
    for seed, gen_idx in ((torch.arange(n), torch.zeros(n, dtype=torch.long)),
                          (torch.full((n,), 7), torch.arange(n))):
        draws = sample_batched(torch.Generator().manual_seed(0), rows,
                               *samp, seed=seed, gen_idx=gen_idx)
        counts = np.bincount(draws.numpy(), minlength=8)
        chi2 = float(((counts - n * probs) ** 2 / (n * probs)).sum())
        assert chi2 < CHI2_7_999, (chi2, counts)
        again = sample_batched(torch.Generator().manual_seed(99),
                               rows.flip(0), *samp, seed=seed.flip(0),
                               gen_idx=gen_idx.flip(0))
        assert torch.equal(again.flip(0), draws)


def test_submit_validates_controls(pair):
    """The reference's checks (:1167-1204): malformed and out-of-vocab
    biases, negative seeds and non-finite penalties are refused; a
    63-bit seed is folded to 31 bits."""
    _, tc, _, tp = pair
    eng = batching.BatchingEngine(tc, tp, n_slots=2, max_len=32, device=CPU)
    for bad in ({"logit_bias": {"x": 1.0}}, {"logit_bias": [1, 2]},
                {"logit_bias": {tc.vocab_size: 1.0}}, {"seed": -1},
                {"presence_penalty": float("inf")},
                {"frequency_penalty": float("nan")}):
        with pytest.raises(ValueError):
            eng.submit("x", [1, 2], 2, **bad)
    eng.submit("y", [1, 2], 2, seed=(1 << 40) + 5, logit_bias={"3": 2})
    req = eng._queue[-1]
    assert req.seed == ((1 << 40) + 5) & 0x7FFFFFFF
    assert req.logit_bias == {3: 2.0}


def test_generate_keeps_its_programs_across_calls(pair):
    """A second sampled call with the same seed gives the first call's
    tokens (the engine's programs and generator are reused across calls),
    so does a fresh engine, another seed gives others, and the caller's
    generator leaves each call in the same state."""
    _, tc, _, tp = pair
    rng = _rng("generate")
    toks = torch.from_numpy(rng.integers(0, tc.vocab_size, (2, 12)))
    lens = torch.tensor([12, 7], dtype=torch.int32)

    def run(eng, seed):
        g = torch.Generator().manual_seed(seed)
        out = eng.generate(toks, lens, max_new_tokens=10, generator=g)
        return out.tokens, g.get_state()

    eng = Engine(tc, tp, max_len=32, temperature=1.0, device=CPU)
    first, state = run(eng, 9)
    again, state2 = run(eng, 9)
    assert torch.equal(first, again) and torch.equal(state, state2)
    assert torch.equal(run(Engine(tc, tp, max_len=32, temperature=1.0,
                                  device=CPU), 9)[0], first)
    assert not torch.equal(run(eng, 10)[0], first)
    st = eng._batches[2]
    assert list(st.prefills) == [12] and st.step is not None
    assert len(eng._batches) == 1
