"""The port's startup autotuner against the JAX package's, on the CPU.

The reference's cases (`tests/test_overlap_decode.py:271-355`,
`tests/test_overlap_prefill.py:306-392`) with a scripted clock: the
same script drives the JAX tuner and the port's on the same tiny fp32
weights, and both elect the same candidate with the same measured rates
(their timed drains cover the same tokens: the port's un-timed warm
request, which takes its window graph through its capture, adds none).
Under `serve`'s defaults the timed drain replays steady windows over
every probe slot and admits nothing. "auto" is
inert until tuned; a tune leaves the engine idle with its generator
state and counters restored; a tuned engine serves a pinned engine's
tokens; fixed settings are not tuned; a tight cache narrows the sweep
instead of failing.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shellac_tpu.inference import autotune as jautotune
from shellac_tpu.inference import batching as jbatching
from shellac_tpu.models.registry import get_model_config as jget
from shellac_tpu_torch.inference import autotune, batching
from shellac_tpu_torch.models.from_jax import params_from_jax
from shellac_tpu_torch.models.registry import get_model_config

import jax_params

CPU = "cpu"


@pytest.fixture(scope="module")
def pair():
    jc = jget("tiny").replace(dtype="float32")
    tc = get_model_config("tiny").replace(dtype="float32")
    p = jax_params.init_params(jc)
    return jc, tc, jax.tree.map(jnp.asarray, p), params_from_jax(tc, p, CPU)


def _port(pair, **kw):
    _, tc, _, tp = pair
    return batching.BatchingEngine(tc, tp, device=CPU, **kw)


def _jax(pair, **kw):
    jc, _, jp, _ = pair
    return jbatching.BatchingEngine(jc, jp, **kw)


def _ticks_clock(eng, elapsed):
    """Two calls per candidate: t0, then t0 + the candidate's scripted
    elapsed seconds."""
    clock = {"t": 0.0, "pending": None}

    def timer():
        if clock["pending"] is None:
            clock["pending"] = clock["t"] + elapsed[eng.decode_ticks]
            return clock["t"]
        clock["t"], clock["pending"] = clock["pending"], None
        return clock["t"]

    return timer


def _chunk_clock(eng, elapsed):
    """Three calls per candidate (t0, first token, t1): the scripted
    elapsed seconds land on the last."""
    clock = {"t": 0.0, "n": 0}

    def timer():
        clock["n"] += 1
        if clock["n"] % 3 == 0:
            clock["t"] += elapsed[eng.prefill_chunk]
        return clock["t"]

    return timer


def test_auto_is_inert_until_tuned(pair):
    eng = _port(pair, n_slots=2, max_len=64, decode_ticks="auto",
                prefill_chunk="auto")
    assert eng.decode_ticks == 1 and eng.decode_ticks_requested == "auto"
    assert eng.decode_ticks_source == "auto"
    assert eng.stats["decode_ticks"] == 1
    assert eng.prefill_chunk is None
    assert eng.prefill_chunk_requested == "auto"
    assert eng.prefill_chunk_source == "auto"
    assert eng.stats["prefill_chunk"] == 0


@pytest.mark.parametrize("kw", [{"decode_ticks": "fast"},
                                {"prefill_chunk": "fast"}])
def test_bad_strings_are_refused(pair, kw):
    with pytest.raises(ValueError, match="auto"):
        _port(pair, **kw)


def test_decode_ticks_sweep_elects_what_jax_elects(pair):
    """Rates, not elapsed times, elect: K=4 wins although K=1's drain is
    the shortest; the port measures the JAX tuner's rates."""
    elapsed = {1: 1.0, 2: 1.5, 4: 2.5, 8: 6.0}
    res = {}
    for which, eng, mod in (
            ("jax", _jax(pair, n_slots=2, max_len=128, decode_ticks="auto"),
             jautotune),
            ("port", _port(pair, n_slots=2, max_len=128,
                           decode_ticks="auto"), autotune)):
        res[which] = mod.autotune_decode_ticks(
            eng, candidates=(1, 2, 4, 8), probe_windows=1,
            timer=_ticks_clock(eng, elapsed))
        assert eng.decode_ticks == 4 and eng.stats["decode_ticks"] == 4
        assert eng.decode_ticks_source == "auto-tuned"
    assert res["port"].best == res["jax"].best == 4
    assert res["port"].measurements == pytest.approx(
        res["jax"].measurements)


def test_prefill_chunk_sweep_elects_what_jax_elects(pair):
    elapsed = {None: 5.0, 8: 3.0, 16: 0.5, 48: 4.0}
    res = {}
    for which, eng, mod in (
            ("jax", _jax(pair, n_slots=2, max_len=128, seed=3,
                         prefill_chunk="auto"), jautotune),
            ("port", _port(pair, n_slots=2, max_len=128, seed=3,
                           prefill_chunk="auto"), autotune)):
        res[which] = mod.autotune_prefill_chunk(
            eng, candidates=(None, 8, 16, 48),
            timer=_chunk_clock(eng, elapsed))
        assert eng.prefill_chunk == 16 and eng.stats["prefill_chunk"] == 16
        assert eng.prefill_chunk_source == "auto-tuned"
    assert res["port"].best == res["jax"].best == 16
    assert set(res["port"].measurements) == {None, 8, 16, 48}
    assert res["port"].measurements == pytest.approx(
        res["jax"].measurements)


@pytest.mark.parametrize("sweep", ["decode_ticks", "prefill_chunk"])
def test_tune_leaves_the_engine_idle_and_restored(pair, sweep):
    eng = _port(pair, n_slots=2, max_len=128, seed=7, decode_ticks="auto",
                prefill_chunk="auto", overlap_decode=True,
                overlap_prefill=True, max_prefills_per_step=1)
    gen0 = eng._gen.get_state().clone()
    stats0 = dict(eng.stats)
    if sweep == "decode_ticks":
        autotune.autotune_decode_ticks(eng, candidates=(1, 2),
                                       probe_windows=1)
    else:
        autotune.autotune_prefill_chunk(eng, candidates=(None, 16))
    assert eng.pending == 0 and not eng._windows and not eng._pflights
    assert torch.equal(eng._gen.get_state(), gen0)
    for k in ("requests_completed", "tokens_generated", "prefills",
              "engine_steps", "decode_windows"):
        assert eng.stats[k] == stats0[k], k
    assert eng.obs.registry.enabled


@pytest.mark.parametrize("sweep", ["decode_ticks", "prefill_chunk"])
def test_tuned_engine_serves_a_pinned_engines_tokens(pair, sweep):
    prompt = np.random.default_rng(11).integers(0, pair[1].vocab_size, 40)
    eng = _port(pair, n_slots=2, max_len=128, seed=3, decode_ticks="auto",
                prefill_chunk="auto", overlap_decode=True,
                overlap_prefill=True)
    if sweep == "decode_ticks":
        autotune.autotune_decode_ticks(eng, candidates=(1, 2, 4),
                                       probe_windows=1)
    else:
        autotune.autotune_prefill_chunk(eng, candidates=(None, 16))
    got = eng.run([("r", prompt, 8)])
    ref = _port(pair, n_slots=2, max_len=128, seed=3,
                decode_ticks=eng.decode_ticks,
                prefill_chunk=eng.prefill_chunk)
    assert got == ref.run([("r", prompt, 8)])


def test_maybe_autotune_skips_fixed_settings(pair):
    eng = _port(pair, n_slots=2, max_len=128, decode_ticks=2,
                prefill_chunk=8)
    assert autotune.maybe_autotune(eng) is None
    assert autotune.maybe_autotune_prefill_chunk(eng) is None
    assert eng.decode_ticks == 2 and eng.prefill_chunk == 8


def test_tight_cache_degrades_instead_of_failing(pair):
    eng = _port(pair, n_slots=1, max_len=24, decode_ticks="auto")
    res = autotune.autotune_decode_ticks(eng, candidates=(1, 64),
                                         probe_windows=3)
    assert res.best == 1 and eng.decode_ticks == 1
    assert set(res.measurements) == {1}


@pytest.mark.parametrize("paged", [False, True])
def test_timed_drain_replays_steady_windows(pair, paged):
    """Under `serve`'s defaults (both pipelines, one prefill a step) each
    candidate's timed drain starts with every probe slot decoding and its
    window graph past its eager run and its capture, and admits nothing:
    the tuner times replays of steady windows, not the admission ramp."""
    _, tc, _, tp = pair
    cls = batching.PagedBatchingEngine if paged else batching.BatchingEngine
    kw = dict(block_size=8) if paged else {}
    eng = cls(tc, tp, n_slots=4, max_len=128, device=CPU,
              decode_ticks="auto", overlap_decode=True, overlap_prefill=True,
              max_prefills_per_step=1, **kw)
    seen = []

    def timer():
        runner = eng._window_graphs.get(
            (eng.decode_ticks, True, False, False, False, False))
        seen.append(dict(
            k=eng.decode_ticks, runner=runner,
            calls=runner.calls if runner is not None else 0,
            queued=len(eng._queue), flights=len(eng._pflights),
            decoding=sum(r is not None and bool(r.out) for r in eng._slots),
            prefills=eng.stats["prefills"]))
        return float(len(seen))

    res = autotune.autotune_decode_ticks(eng, candidates=(1, 2, 4),
                                         probe_windows=2, timer=timer)
    assert set(res.measurements) == {1, 2, 4}
    assert len(seen) == 6
    for t0, t1 in zip(seen[::2], seen[1::2]):
        assert t0["k"] == t1["k"]
        assert t0["queued"] == t0["flights"] == 0
        assert t0["decoding"] == eng.n_slots
        # Calls 1 and 2 (the eager run and the capture) came before t0.
        assert t0["calls"] >= 2 and t1["runner"] is t0["runner"]
        assert t1["calls"] > t0["calls"]
        assert t1["prefills"] == t0["prefills"]
    assert eng.max_prefills_per_step == 1
