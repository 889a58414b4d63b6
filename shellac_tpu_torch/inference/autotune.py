"""Startup autotuning of the decode window length and the prefill chunk
size, and the simulated host-latency harness that lets CPU tests shape a
remote device's clock.

The port's copy of `shellac_tpu/inference/autotune.py`:
`SimulatedHostLatency` (:66) over the engine's `_window_hooks` and
`_prefill_hooks` seams, `autotune_decode_ticks` (:157),
`autotune_prefill_chunk` (:298), `maybe_autotune_prefill_chunk` and
`maybe_autotune` (:420-471). The tuners run probe traffic through the
LIVE engine at each candidate, measure tokens per second on the host
clock (`timer`, injectable so selection is testable with a scripted
clock), write the winner back, and leave the engine idle with its
random generator's state restored, so a seeded deployment stays
reproducible.

What differs from the reference: the engine's programs run as CUDA
graphs on the card, and a program's first call runs eagerly and its
second captures (with a device sync). So before its probes are admitted,
each candidate runs an un-timed warm request that takes the window graph
the timed drain replays through its eager run and its capture
(`_warm_window`); the prefill sweep likewise prefills its long prompt
twice, un-timed, so the whole-prompt candidate times a replay. And the
probes are admitted with the cap on prefills per step lifted, then
stepped un-timed until every one has settled its prefill
(`_admit_probes`): under `serve`'s defaults (both pipelines, one prefill
a step) the timed drain would otherwise cover the admission ramp, and a
short probe would finish before the last was admitted. The timed drain
thus replays steady windows over every probe slot, as the reference's
one un-timed step leaves its drain. The generator is restored with
`get_state`/`set_state` (the reference restores its PRNG key). The
reference's skips for speculative engines, multi-host wrappers and
rolling rings are left out with those engines and caches, which the
port does not have yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: Candidate window lengths swept by default: the bench_decode sweep's
#: range, capped where per-token latency jitter starts to hurt serving.
DEFAULT_CANDIDATES: Tuple[int, ...] = (1, 2, 4, 8, 16)


@dataclass
class AutotuneResult:
    """One decode_ticks sweep: the winner and the per-candidate
    evidence (tokens/s as measured, wall seconds of the timed region)."""

    best: int
    measurements: Dict[int, float] = field(default_factory=dict)  # K -> tok/s
    elapsed: Dict[int, float] = field(default_factory=dict)  # K -> seconds

    def summary(self) -> Dict[str, object]:
        return {
            "decode_ticks": self.best,
            "candidates": {
                str(k): round(v, 1) for k, v in self.measurements.items()
            },
        }


class SimulatedHostLatency:
    """Shape an engine's decode-window AND prefill clocks like a
    remote device.

    Installed via the engine's `_window_hooks` seam (and, when
    `prefill_s` or `prefill_token_s` is set, its `_prefill_hooks` twin):

      - `on_dispatch(window)`: sleeps `dispatch_s` (a host-blocking
        submit RPC) and stamps when the window's results will be
        "ready" (`device_s` after dispatch — the simulated device/fetch
        round trip).
      - `before_sync(window)`: sleeps out whatever of `device_s` the
        host has not already spent elsewhere — exactly the wait a real
        sync would block for.
      - `on_prefill_dispatch(flight)` / `before_prefill_sync(flights)`:
        the same clock shaping for prefill programs — each flight's
        results become available `prefill_s` after its dispatch, plus
        `prefill_token_s` for each token it computes, so an
        inline (non-overlapped) settle blocks the admission for the
        full round trip while the overlapped batched settle pays only
        whatever of it the host has not already spent on other work.

    The real programs still run (their CPU time happens inside
    the window span, like real device time); only the availability
    clock is stretched. Overlapped dispatch hides host work inside
    `device_s`/`prefill_s`; strict ordering pays host + device
    serially — the measurable contrast the perf gate asserts on.
    """

    def __init__(self, engine, *, device_s: float = 0.0,
                 dispatch_s: float = 0.0, prefill_s: float = 0.0,
                 prefill_token_s: float = 0.0):
        self.engine = engine
        self.device_s = float(device_s)
        self.dispatch_s = float(dispatch_s)
        self.prefill_s = float(prefill_s)
        # A per-token prefill cost on top of the fixed prefill_s, charged
        # only for the tokens a prefill computes (the prompt past the
        # prefix cache's offset): what lets a CPU run show a prefix
        # hit's saving as wall time, as a card would.
        self.prefill_token_s = float(prefill_token_s)
        self._ready: Dict[int, float] = {}
        engine._window_hooks = self
        if self.prefill_s or self.prefill_token_s:
            engine._prefill_hooks = self

    def on_dispatch(self, window) -> None:
        if self.dispatch_s:
            time.sleep(self.dispatch_s)
        self._ready[id(window)] = time.monotonic() + self.device_s

    def before_sync(self, window) -> None:
        ready = self._ready.pop(id(window), None)
        if ready is not None:
            delay = ready - time.monotonic()
            if delay > 0:
                time.sleep(delay)

    def on_prefill_dispatch(self, flight) -> None:
        if self.dispatch_s:
            time.sleep(self.dispatch_s)
        self._ready[id(flight)] = time.monotonic() + self.prefill_cost(
            flight)

    def prefill_cost(self, flight) -> float:
        """Seconds until a prefill flight's results are available:
        prefill_s, plus prefill_token_s for each token it computes."""
        computed = flight.req.tokens.size - (
            self.engine.cache_backend.prefill_offset(flight.slot))
        return self.prefill_s + self.prefill_token_s * max(0, computed)

    def before_prefill_sync(self, flights) -> None:
        # The batched settle becomes available when the LAST of its
        # flights does; already-elapsed host time is not re-paid.
        ready = [r for r in (self._ready.pop(id(fl), None)
                             for fl in flights) if r is not None]
        if ready:
            delay = max(ready) - time.monotonic()
            if delay > 0:
                time.sleep(delay)

    def uninstall(self) -> None:
        if self.engine._window_hooks is self:
            self.engine._window_hooks = None
        if getattr(self.engine, "_prefill_hooks", None) is self:
            self.engine._prefill_hooks = None
        self._ready.clear()


def _window_key(engine) -> Tuple[int, bool, bool, bool, bool, bool]:
    """The window graph that probes at the engine's default sampling
    replay (`BatchingEngine._decode_impl`'s key: no bias, penalties,
    seeds or constraints)."""
    return (engine.decode_ticks, engine._defaults["temperature"] == 0.0,
            False, False, False, False)


def _warm_window(engine) -> None:
    """Un-timed: unless the window graph that the probes will replay has
    already been captured, run one request through it until it has (its
    first, eager window and its capture), then drop it."""
    runner = engine._window_graphs.get(_window_key(engine))
    if runner is not None and runner.calls >= 2:
        return
    k = engine.decode_ticks
    max_new = 2 * k + 1
    engine.submit(("__autotune__", "warm", k), np.zeros(8, np.int64),
                  max_new, **({"min_tokens": max_new}
                              if engine.eos_id is not None else {}))
    while engine.pending:
        engine.step()
    engine.abort_all()


def _admit_probes(engine) -> None:
    """Un-timed: admit every queued probe in one step (the cap on
    prefills per step is lifted meanwhile) and step until each has
    settled its prefill, so the timed drain sees no admission."""
    cap = engine.max_prefills_per_step
    engine.max_prefills_per_step = None
    try:
        while engine.pending and (
                engine._queue or engine._pflights or engine._prefilling
                or any(r is not None and not r.out for r in engine._slots)):
            engine.step()
    finally:
        engine.max_prefills_per_step = cap
    if engine._queue:
        raise RuntimeError(
            "autotune probes found no room to start together (cache pool "
            "too small for one probe per slot)")


def autotune_decode_ticks(
    engine,
    *,
    candidates: Sequence[int] = DEFAULT_CANDIDATES,
    probe_windows: int = 3,
    prompt_len: int = 32,
    timer: Callable[[], float] = time.perf_counter,
) -> AutotuneResult:
    """Measure churn tokens/s at each candidate decode_ticks on the
    LIVE engine (its model, its kernels, its real dispatch path)
    and write the winner back via `engine.set_decode_ticks`.

    Per candidate: the window graph is warmed (`_warm_window`), every
    slot gets a probe request sized for `probe_windows` full windows
    past one warm-up window (EOS banned via min_tokens when the engine
    has one, so probes cannot end early), the probes are admitted
    together and their prefills settled (`_admit_probes`, un-timed, the
    warm-up window with them), and the drain to completion is timed
    with `timer` (two calls — injectable, so selection is unit-testable
    with a scripted clock). Probes are aborted and the
    generator state restored afterwards: a seeded engine leaves the tune
    exactly as reproducible as it entered, and `abort_all` restores
    allocator state on paged pools.

    Returns the AutotuneResult; `engine.decode_ticks` is the winner and
    `engine.decode_ticks_source` is "auto-tuned".
    """
    if engine.pending:
        raise RuntimeError(
            "autotune_decode_ticks needs an idle engine (it runs probe "
            "traffic and aborts it); tune before admitting requests"
        )
    candidates = sorted({int(k) for k in candidates})
    if not candidates or candidates[0] < 1:
        raise ValueError(f"bad candidates {candidates!r}: need ints >= 1")
    # Probes must fit the cache (submit's prompt + max_new + 1 bound):
    # shrink the probe prompt on tight caches and drop candidates that
    # still cannot fit, rather than failing serving startup — a replica
    # with a 96-token cache simply tunes over a smaller range.
    prompt_len = min(prompt_len, max(8, engine.max_len // 4))
    candidates = [
        k for k in candidates
        if prompt_len + (1 + probe_windows) * k + 2 <= engine.max_len
    ]
    if not candidates:
        return AutotuneResult(best=engine.decode_ticks)
    rng = np.random.default_rng(0)
    gen0 = engine._gen.get_state()
    original = engine.decode_ticks
    result = AutotuneResult(best=original)
    best_rate = -1.0
    # Probe traffic must not leak into serving observability: the tier
    # scores replicas on the very shellac_engine_* gauges and decode-
    # window histograms the sweep would otherwise pollute (a fresh
    # replica would look loaded, with histogram samples taken at the
    # REJECTED candidate K values). Point engine.obs at a disabled
    # scratch registry for the sweep's duration and roll the stats
    # counters back afterwards.
    from shellac_tpu_torch.obs import EngineMetrics, Registry

    stats0 = dict(engine.stats)
    obs0 = engine.obs
    engine.obs = EngineMetrics(Registry(enabled=False))
    try:
        for k in candidates:
            engine.set_decode_ticks(k)
            _warm_window(engine)
            max_new = (1 + probe_windows) * k + 1
            # Bound re-checked against the submit rule (prompt +
            # max_new + 1 <= max_len) by submit itself below.
            kw = {}
            if engine.eos_id is not None:
                # A probe ending on a sampled EOS would under-measure
                # the candidate; ban EOS for the probe's whole budget.
                kw["min_tokens"] = max_new
            for slot in range(engine.n_slots):
                prompt = rng.integers(
                    0, engine.cfg.vocab_size, size=prompt_len,
                    dtype=np.int64,
                )
                engine.submit(("__autotune__", k, slot), prompt,
                              max_new, **kw)
            _admit_probes(engine)
            tokens0 = engine.stats["tokens_generated"] + sum(
                len(r.out) for r in engine._slots if r is not None
            )
            t0 = timer()
            while engine.pending:
                engine.step()
            t1 = timer()
            tokens1 = engine.stats["tokens_generated"]
            elapsed = max(t1 - t0, 1e-9)
            rate = (tokens1 - tokens0) / elapsed
            result.measurements[k] = rate
            result.elapsed[k] = elapsed
            if rate > best_rate:
                best_rate, result.best = rate, k
    finally:
        engine.abort_all()
        engine._gen.set_state(gen0)
        engine.obs = obs0
        engine.stats.clear()
        engine.stats.update(stats0)
    engine.set_decode_ticks(result.best)
    engine.decode_ticks_source = "auto-tuned"
    return result


#: prefill_chunk candidates swept by default: whole prompts (None) vs
#: the chunk sizes a production scheduler actually picks between. The
#: sweep drops candidates larger than the engine's cache.
PREFILL_CHUNK_CANDIDATES: Tuple[Optional[int], ...] = (None, 64, 128,
                                                       256, 512)


@dataclass
class PrefillChunkResult:
    """One prefill_chunk sweep: the winner plus per-candidate evidence
    (mixed-workload tokens/s, and the long prompt's TTFT under each
    candidate — the two sides of the TTFT-vs-TPOT fairness knob, both
    measured rather than guessed)."""

    best: Optional[int]
    measurements: Dict[Optional[int], float] = field(
        default_factory=dict)  # chunk -> tok/s
    ttft: Dict[Optional[int], float] = field(default_factory=dict)

    def summary(self) -> Dict[str, object]:
        return {
            "prefill_chunk": self.best,
            "candidates": {
                str(k): round(v, 1) for k, v in self.measurements.items()
            },
            "long_prompt_ttft_s": {
                str(k): round(v, 4) for k, v in self.ttft.items()
            },
        }


def autotune_prefill_chunk(
    engine,
    *,
    candidates: Sequence[Optional[int]] = PREFILL_CHUNK_CANDIDATES,
    probe_steps: int = 3,
    timer: Callable[[], float] = time.perf_counter,
) -> PrefillChunkResult:
    """Measure a MIXED workload — steady decoders plus a long-prompt
    admission — at each candidate prefill_chunk on the LIVE engine and
    write the winner back via `engine.set_prefill_chunk`.

    This is the TTFT-vs-TPOT fairness knob: whole-prompt prefill
    (None) minimizes the long request's TTFT but stalls every active
    decoder for the whole program; small chunks keep decoders ticking
    but stretch the long prompt's admission. Which side wins depends
    on the host/device latency profile, so — same TVM stance as the
    decode_ticks sweep — it is searched, not guessed. Per candidate:
    all but one slot decode steadily (EOS banned), one long prompt is
    admitted mid-drain, and total generated tokens/s over the timed
    drain decides. The long prompt's TTFT is recorded per candidate as
    evidence. Probes are aborted and the PRNG key restored; a seeded
    deployment stays exactly as reproducible as it entered.
    """
    if engine.pending:
        raise RuntimeError(
            "autotune_prefill_chunk needs an idle engine (it runs "
            "probe traffic and aborts it); tune before admitting "
            "requests"
        )
    if engine.n_slots < 2:
        # The fairness question needs a decoder to stall.
        return PrefillChunkResult(best=engine.prefill_chunk)
    # A long prompt that spans several chunks of the largest surviving
    # candidate, capped so prompt + budget fit the cache.
    ticks = max(1, engine.decode_ticks)
    budget = max(2 * ticks, 8)
    long_len = min(engine.max_len - budget - 2,
                   engine.max_len * 3 // 4)
    if long_len < 32:
        # A cache this tight has no long-prompt problem to tune.
        return PrefillChunkResult(best=engine.prefill_chunk)
    keep: List[Optional[int]] = []
    for c in candidates:
        if c is not None and (c < 1 or c >= long_len):
            continue  # chunk >= prompt degenerates to whole-prompt
        if c not in keep:
            keep.append(c)
    rng = np.random.default_rng(0)
    gen0 = engine._gen.get_state()
    chunk0 = engine.prefill_chunk
    result = PrefillChunkResult(best=chunk0)
    best_rate = -1.0
    from shellac_tpu_torch.obs import EngineMetrics, Registry

    stats0 = dict(engine.stats)
    obs0 = engine.obs
    engine.obs = EngineMetrics(Registry(enabled=False))
    try:
        if None in keep:
            # Un-timed: the long prompt's bucket prefills eagerly, then
            # captures, so the whole-prompt candidate times a replay.
            engine.set_prefill_chunk(None)
            for i in range(2):
                engine.submit(("__chunktune__", "warm", i),
                              np.zeros(long_len, np.int64), 1)
                while engine.pending:
                    engine.step()
            engine.abort_all()
        _warm_window(engine)
        for c in keep:
            engine.set_prefill_chunk(c)
            kw = {}
            if engine.eos_id is not None:
                kw["min_tokens"] = budget + long_len
            # Steady decoders on all but one slot.
            for slot in range(engine.n_slots - 1):
                prompt = rng.integers(0, engine.cfg.vocab_size, size=8,
                                      dtype=np.int64)
                engine.submit(("__chunktune__", str(c), slot), prompt,
                              budget + probe_steps * ticks, **kw)
            _admit_probes(engine)  # un-timed, the window's warm-up too

            def tokens_seen():
                return engine.stats["tokens_generated"] + sum(
                    len(r.out) for r in engine._slots if r is not None
                )

            rid_long = ("__chunktune__", str(c), "long")
            prompt = rng.integers(0, engine.cfg.vocab_size,
                                  size=long_len, dtype=np.int64)
            tokens0 = tokens_seen()
            t0 = timer()
            engine.submit(rid_long, prompt, 2,
                          **({"min_tokens": 2} if engine.eos_id
                             is not None else {}))
            t_first = None
            while engine.pending:
                done = engine.step()
                if t_first is None:
                    long_req = next(
                        (r for r in engine._slots
                         if r is not None and r.rid == rid_long), None)
                    if ((long_req is not None and long_req.out)
                            or any(rid == rid_long for rid, _ in done)):
                        t_first = timer()
            t1 = timer()
            rate = (tokens_seen() - tokens0) / max(t1 - t0, 1e-9)
            engine.abort_all()  # reset for the next candidate
            result.measurements[c] = rate
            if t_first is not None:
                result.ttft[c] = max(t_first - t0, 0.0)
            if rate > best_rate:
                best_rate, result.best = rate, c
    finally:
        engine.abort_all()
        engine._gen.set_state(gen0)
        engine.obs = obs0
        engine.stats.clear()
        engine.stats.update(stats0)
    engine.set_prefill_chunk(result.best)
    engine.prefill_chunk_source = "auto-tuned"
    return result


def maybe_autotune_prefill_chunk(
    engine, log: Optional[Callable[[str], None]] = None, **kw
) -> Optional[PrefillChunkResult]:
    """Tune iff the engine was built with prefill_chunk="auto" — the
    serving entry points' one-liner, mirroring maybe_autotune. Returns
    the result, or None when nothing was tuned."""
    if engine.prefill_chunk_requested != "auto":
        return None
    res = autotune_prefill_chunk(engine, **kw)
    if log is not None:
        log(f"prefill_chunk auto-tune: {res.summary()}")
    return res


def maybe_autotune(engine, log: Optional[Callable[[str], None]] = None,
                   **kw) -> Optional[AutotuneResult]:
    """Tune iff the engine was built with decode_ticks="auto" — the
    serving entry points' one-liner. Returns the result, or None when
    nothing was tuned."""
    if engine.decode_ticks_requested != "auto":
        return None
    res = autotune_decode_ticks(engine, **kw)
    if log is not None:
        log(f"decode_ticks auto-tune: {res.summary()}")
    return res


__all__: List[str] = [
    "AutotuneResult",
    "DEFAULT_CANDIDATES",
    "PREFILL_CHUNK_CANDIDATES",
    "PrefillChunkResult",
    "SimulatedHostLatency",
    "autotune_decode_ticks",
    "autotune_prefill_chunk",
    "maybe_autotune",
    "maybe_autotune_prefill_chunk",
]
