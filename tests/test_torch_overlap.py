"""The port's admission and decode pipelines against its strict engine and
the JAX package's pipelined engine, on the CPU.

The same numpy-seeded weights (tiny preset, fp32, through
`params_from_jax`) and requests go through the port's engines in strict
ordering and under `overlap_decode`, `overlap_prefill` and both, dense
and paged, at 1 and 4 ticks a window: greedy tokens and logprobs must
equal the strict engine's exactly (the pipelines reorder host work, not
math). Against the JAX engine with both pipelines (over its dense cache,
for both caches of the port: greedy tokens do not depend on the
storage), tokens are compared while the JAX engine's own top-2 logprob
margin is at least twice the logit tolerance of 1e-4 (as
`tests/test_torch_batching.py` does), and logprobs there to 1e-4. The
lifecycle cases are the reference's
(`tests/test_overlap_decode.py:189-270`,
`tests/test_overlap_prefill.py:176-255`): cancel and abort_all with
windows and prefills in flight, the trailing window after the last
request, a request finished by its prefill alone, TTFT marked at the
settle. `SimulatedHostLatency` leaves outputs unchanged and calls its
hooks in pipeline order (its wall-clock savings are not asserted: the
JAX twin of that check has flaked under load).
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
from shellac_tpu_torch.inference.autotune import SimulatedHostLatency
from shellac_tpu_torch.models.from_jax import params_from_jax
from shellac_tpu_torch.models.registry import get_model_config
from shellac_tpu_torch.obs import Registry, ServeMetrics

import jax_params

CPU = "cpu"
MARGIN = 2 * 1e-4
PIPELINES = {
    "decode": dict(overlap_decode=True),
    "prefill": dict(overlap_prefill=True),
    "both": dict(overlap_decode=True, overlap_prefill=True),
}


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, port cfg, jax params, port params): tiny in fp32 with
    seeded noise on the norms."""
    jc = jget("tiny").replace(dtype="float32")
    tc = get_model_config("tiny").replace(dtype="float32")
    p = jax_params.init_params(jc)
    rng = _rng("params")
    for k, v in p["layers"].items():
        if k.endswith("norm"):
            p["layers"][k] = (0.3 * rng.standard_normal(v.shape)).astype(
                np.float32)
    return jc, tc, jax.tree.map(jnp.asarray, p), params_from_jax(tc, p, CPU)


def _requests(vocab):
    rng = _rng("requests")
    lens = [3, 17, 9, 24, 5, 12, 30, 7]
    max_new = [6, 9, 1, 12, 4, 10, 8, 5]
    return [(f"r{i}", rng.integers(0, vocab, n).astype(np.int32), m)
            for i, (n, m) in enumerate(zip(lens, max_new))]


def _cls(paged, jax_engine=False):
    mod = jbatching if jax_engine else batching
    return mod.PagedBatchingEngine if paged else mod.BatchingEngine


def _kw(paged, **kw):
    kw = dict(n_slots=3, max_len=64, logprobs=True, top_logprobs=2, **kw)
    if paged:
        kw.update(block_size=8, pool_tokens=96)
    return kw


def _run(eng, reqs, stop=None):
    for rid, toks, m in reqs:
        eng.submit(rid, toks, m,
                   stop=[stop] if stop is not None and rid == "r5" else None)
    out = {}
    while eng.pending:
        for rid, toks in eng.step():
            out[rid] = list(toks)
    return out


def _drain(eng):
    out = {}
    while eng.pending:
        for rid, toks in eng.step():
            out[rid] = list(toks)
    return out


def _strict(tc, tp, **kw):
    return batching.BatchingEngine(tc, tp, n_slots=1, max_len=64, device=CPU,
                                   **kw)


# The JAX engine's run under both pipelines over its dense cache: its
# greedy tokens depend neither on decode_ticks nor on dense versus paged
# storage (tests/test_torch_batching.py holds the port's engines against
# both JAX engines), so one reference serves every case.
_JAX_RUNS = {}


def _jax_reference(pair, eos, stop, reqs):
    if not _JAX_RUNS:
        jc, _, jp, _ = pair
        jeng = _cls(False, jax_engine=True)(
            jc, jp, **_kw(False, eos_id=eos, decode_ticks=4,
                          **PIPELINES["both"]))
        _JAX_RUNS["dense"] = _run(jeng, reqs, stop), jeng
    return _JAX_RUNS["dense"]


@pytest.mark.parametrize("ticks", [1, 4])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_greedy_pipelines_match_strict_and_jax(pair, paged, ticks):
    _, tc, _, tp = pair
    reqs = _requests(tc.vocab_size)
    probe = batching.BatchingEngine(tc, tp, n_slots=3, max_len=64,
                                    device=CPU).run(reqs)
    eos, stop = probe["r3"][4], probe["r5"][3:5]
    cls = _cls(paged)
    strict = cls(tc, tp, device=CPU, **_kw(paged, eos_id=eos,
                                           decode_ticks=ticks))
    want = _run(strict, reqs, stop)
    assert set(want) == {r[0] for r in reqs}
    for name, pipe in PIPELINES.items():
        eng = cls(tc, tp, device=CPU, **_kw(paged, eos_id=eos,
                                            decode_ticks=ticks, **pipe))
        assert _run(eng, reqs, stop) == want, name
        assert eng.finished_logprobs == strict.finished_logprobs, name
        assert (eng.finished_top_logprobs
                == strict.finished_top_logprobs), name
        if paged:
            be = eng.cache_backend
            assert sorted(be._free) == list(range(1, be.n_blocks)), name
    jwant, jeng = _jax_reference(pair, eos, stop, reqs)
    compared = total = 0
    for rid, _, _ in reqs:
        margins = np.array([lps[0] - lps[1]
                            for _, lps in jeng.finished_top_logprobs[rid]])
        low = np.flatnonzero(margins < MARGIN)
        upto = int(low[0]) if low.size else len(jwant[rid])
        assert want[rid][:upto] == jwant[rid][:upto], rid
        np.testing.assert_allclose(strict.finished_logprobs[rid][:upto],
                                   jeng.finished_logprobs[rid][:upto],
                                   atol=1e-4)
        compared += upto
        total += len(jwant[rid])
    assert compared >= 0.75 * total, (compared, total)


def test_cancel_with_window_in_flight(pair):
    """A slot cancelled while its window is in flight must not leak that
    window's tokens into the slot's next tenant."""
    _, tc, _, tp = pair
    prompt = _rng("cancel-window").integers(0, tc.vocab_size, 6)
    eng = _strict(tc, tp, decode_ticks=2, overlap_decode=True)
    eng.submit("c1", prompt, 10)
    eng.step()
    eng.step()  # a window is in flight
    assert eng._windows
    assert eng.cancel("c1")
    eng.submit("c2", prompt[:4], 5)
    assert _drain(eng) == _strict(tc, tp, decode_ticks=2).run(
        [("c2", prompt[:4], 5)])


def test_cancel_mid_prefill_flight(pair):
    _, tc, _, tp = pair
    prompt = _rng("cancel-prefill").integers(0, tc.vocab_size, 6)
    eng = _strict(tc, tp, decode_ticks=2, overlap_prefill=True,
                  overlap_decode=True)
    eng.submit("c1", prompt, 10)
    eng.step()  # the prefill is queued, not settled
    assert eng._pflights
    assert eng.cancel("c1")
    eng.submit("c2", prompt[:4], 5)
    assert _drain(eng) == _strict(tc, tp, decode_ticks=2).run(
        [("c2", prompt[:4], 5)])


def test_abort_all_drains_windows_and_flights(pair):
    """abort_all with a window and prefills in flight drains and discards
    them, restores the pool, and the next tenant gets strict output."""
    _, tc, _, tp = pair
    prompt = _rng("abort").integers(0, tc.vocab_size, 8)
    eng = batching.PagedBatchingEngine(
        tc, tp, n_slots=2, max_len=64, block_size=8, decode_ticks=2,
        overlap_decode=True, overlap_prefill=True, device=CPU)
    free0 = list(eng.cache_backend._free)
    eng.submit("a", prompt, 8)
    eng.step()
    eng.step()  # a's window in flight
    eng.submit("b", prompt[:3], 6)
    eng.step()  # b's prefill in flight, a window in flight
    assert eng._windows and eng._pflights
    assert sorted(eng.abort_all()) == ["a", "b"]
    assert not eng._windows and not eng._pflights
    assert eng.cache_backend._free == free0
    assert int(eng._cache.tables.abs().sum()) == 0
    eng.submit("fresh", prompt[:5], 4)
    assert _drain(eng) == _strict(tc, tp, decode_ticks=2).run(
        [("fresh", prompt[:5], 4)])


def test_trailing_window_is_discarded_on_next_submit(pair):
    """The last request's finish leaves one window in flight; the next
    request's run discards it."""
    _, tc, _, tp = pair
    prompt = _rng("trailing").integers(0, tc.vocab_size, 5)
    eng = _strict(tc, tp, decode_ticks=2, overlap_decode=True)
    eng.submit("one", prompt, 4)
    first = _drain(eng)
    assert eng._windows  # the trailing window
    eng.submit("two", prompt[:3], 5)
    second = _drain(eng)
    ref = _strict(tc, tp, decode_ticks=2)
    assert first == ref.run([("one", prompt, 4)])
    assert second == ref.run([("two", prompt[:3], 5)])


def test_request_finished_by_its_prefill_settles_next_boundary(pair):
    """max_new=1 requests complete at their settle; the freed slots are
    reused and every output is the strict engine's."""
    _, tc, _, tp = pair
    rng = _rng("max-new-1")
    reqs = [(i, rng.integers(0, tc.vocab_size, 3 + i), 1) for i in range(5)]
    outs = []
    for overlap in (False, True):
        eng = batching.BatchingEngine(tc, tp, n_slots=2, max_len=64,
                                      overlap_prefill=overlap, device=CPU)
        outs.append(eng.run(reqs))
        if overlap:
            assert eng.stats["prefills"] == 5
    assert outs[0] == outs[1]
    assert all(len(v) == 1 for v in outs[0].values())


def test_ttft_is_marked_at_the_settle(pair):
    """Under overlap_prefill the span's first-token mark lands at the
    step boundary that settles the prefill, not at its dispatch."""
    _, tc, _, tp = pair
    reg = Registry()
    eng = batching.BatchingEngine(tc, tp, n_slots=1, max_len=64,
                                  overlap_prefill=True, registry=reg,
                                  device=CPU)
    tr = ServeMetrics(reg).trace()
    eng.submit("t", np.arange(5, dtype=np.int32), 4, trace=tr)
    eng.step()  # dispatch
    h = reg.get("shellac_ttft_seconds")
    assert (h is None or h.count == 0) and eng._slots[0].out == []
    eng.step()  # settle
    h = reg.get("shellac_ttft_seconds")
    assert h is not None and h.count == 1
    assert len(eng._slots[0].out) >= 1
    _drain(eng)


class _Recording(SimulatedHostLatency):
    """The latency shim, recording the order of its hook calls."""

    def __init__(self, engine, **kw):
        super().__init__(engine, **kw)
        self.calls = []

    def on_dispatch(self, window):
        self.calls.append(("dispatch", id(window)))
        super().on_dispatch(window)

    def before_sync(self, window):
        self.calls.append(("sync", id(window)))
        super().before_sync(window)

    def on_prefill_dispatch(self, flight):
        self.calls.append(("prefill-dispatch", id(flight)))
        super().on_prefill_dispatch(flight)

    def before_prefill_sync(self, flights):
        self.calls.append(("prefill-sync", tuple(id(f) for f in flights)))
        super().before_prefill_sync(flights)


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["strict", "pipelined"])
def test_latency_shim_leaves_outputs_and_orders_hooks(pair, overlap):
    _, tc, _, tp = pair
    rng = _rng("shim")
    reqs = [(i, rng.integers(0, tc.vocab_size, 4 + 3 * i), 5)
            for i in range(4)]
    kw = dict(n_slots=2, max_len=64, decode_ticks=2, device=CPU)
    if overlap:
        kw.update(overlap_decode=True, overlap_prefill=True)
    eng = batching.BatchingEngine(tc, tp, **kw)
    shim = _Recording(eng, device_s=0.002, dispatch_s=0.0005,
                      prefill_s=0.002)
    got = eng.run(reqs)
    shim.uninstall()
    assert eng._window_hooks is None and eng._prefill_hooks is None
    assert got == batching.BatchingEngine(tc, tp, n_slots=2, max_len=64,
                                          decode_ticks=2,
                                          device=CPU).run(reqs)
    # Every window is synced after its dispatch, oldest first; every
    # prefill settles in a batch after its dispatch.
    windows = [w for kind, w in shim.calls if kind == "dispatch"]
    synced = [w for kind, w in shim.calls if kind == "sync"]
    assert synced == windows[:len(synced)] and len(windows) >= 4
    seen = set()
    for kind, ident in shim.calls:
        if kind in ("dispatch", "prefill-dispatch"):
            seen.add(ident)
        elif kind == "sync":
            assert ident in seen
        else:
            assert set(ident) <= seen
    flights = [f for kind, f in shim.calls if kind == "prefill-dispatch"]
    settled = [f for kind, fs in shim.calls if kind == "prefill-sync"
               for f in fs]
    assert settled == flights and len(flights) == 4
    if overlap:
        # Under the pipeline a window is queued before the previous one
        # is synced: some dispatch follows a dispatch directly.
        kinds = [kind for kind, _ in shim.calls
                 if kind in ("dispatch", "sync")]
        assert ("dispatch", "dispatch") in set(zip(kinds, kinds[1:]))


def test_engine_stats_expose_the_pipeline_config(pair):
    _, tc, _, tp = pair
    eng = batching.BatchingEngine(tc, tp, n_slots=1, max_len=64,
                                  decode_ticks=2, overlap_decode=True,
                                  overlap_prefill=True, prefill_chunk=8,
                                  device=CPU)
    assert eng.stats["decode_ticks"] == 2
    assert eng.stats["overlap_depth"] == 2
    assert eng.stats["overlap_prefill"] == 1
    assert eng.stats["prefill_chunk"] == 8
    eng2 = batching.BatchingEngine(tc, tp, n_slots=1, max_len=64,
                                   decode_ticks=3, device=CPU)
    assert eng2.stats["overlap_depth"] == 1
    assert eng2.stats["overlap_prefill"] == 0
    assert eng2.stats["prefill_chunk"] == 0


@pytest.mark.parametrize("pipe", ["strict", "both"])
def test_window_guard_admits_requests_tight_to_max_len(pair, pipe):
    """A request whose prompt + max_new + 1 is exactly max_len runs to its
    end at 4 ticks a window, strict and pipelined (the window's write
    guard counts each slot's budget and the windows in flight), and its
    tokens are the JAX engine's where the margin allows."""
    jc, tc, jp, tp = pair
    prompt = _rng("tight").integers(0, tc.vocab_size, 20).astype(np.int32)
    kw = dict(n_slots=2, max_len=27, decode_ticks=4, logprobs=True,
              top_logprobs=2)
    reqs = [("a", prompt, 6), ("b", prompt[:7], 19)]
    got = batching.BatchingEngine(
        tc, tp, device=CPU, **kw,
        **(PIPELINES["both"] if pipe == "both" else {})).run(reqs)
    # The JAX engine's run is the same for both cases: made once.
    if "tight" not in _JAX_RUNS:
        jeng = jbatching.BatchingEngine(jc, jp, **kw)
        _JAX_RUNS["tight"] = jeng.run(reqs), jeng
    want, jeng = _JAX_RUNS["tight"]
    for rid in ("a", "b"):
        margins = [lps[0] - lps[1]
                   for _, lps in jeng.finished_top_logprobs[rid]]
        low = [i for i, m in enumerate(margins) if m < MARGIN]
        upto = low[0] if low else len(want[rid])
        assert len(got[rid]) == len(want[rid])
        assert got[rid][:upto] == list(want[rid][:upto]), rid
