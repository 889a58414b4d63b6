"""Continuous batching: many requests share one fixed device batch.

Ports `shellac_tpu/inference/batching.py` (`BatchingEngine` :183,
`PagedBatchingEngine` :2439) in strict ordering. The engine keeps a
fixed-shape slot batch on the device and multiplexes requests onto it:

  - a free slot is filled by prefilling one request's prompt into a
    batch-1 dense mini cache (prompt lengths bucket to powers of two) and
    scattering it into the slot: a dense row (`scatter_slot`), or the
    slot's pages of the block pool through its table row;
  - every decode window runs `decode_ticks` single-token forwards over
    ALL slots; idle slots compute values that are discarded, and a slot
    that finishes inside the window (EOS or budget) freezes on the
    device, so shapes never change; the host syncs once per window. The
    window reads and writes only tensors that keep their identity for
    the engine's life (the cache, the next tokens, the stop state, the
    sampling settings, the active mask), so on the card it runs as a
    CUDA graph (`inference/graphs.py`), the counterpart of the JAX
    package's jitted `lax.scan`: one graph per window variant (greedy
    only, or sampling), whose first window runs eagerly and every later
    one replays the graph. On the CPU every window runs eagerly;
  - a request leaves its slot on EOS, a stop sequence or its max_new
    budget, and the slot is refillable at once.

Greedy output for any request is what the single-request Engine gives:
the scheduling is invisible to the math.

The host owns the cache's length bookkeeping: it knows each slot's
length (prompt + tokens written) and sets the cache's `max_length` to
the true maximum before each window, so a long-running engine whose
slots recycle never trips the write guard that `forward_with_cache`
keeps for a growing batch. A released slot's device length is reset to
0, so an idle slot attends one position.

The cache backend is dense or paged, in the compute dtype or int8
(`dense-int8`, `paged-int8`, or the legacy `kv_quant="int8"`): the
prefill quantizes into an int8 mini and scatters values and scales.

Observability (`obs/`): the engine writes its `EngineMetrics` (prefill
section and decode window seconds, host overhead, step phases, batch
occupancy, slots busy, queue depth, KV utilization) into `registry`
(the process default unless given one) once per `step()`, on the host
after the window's one sync; a request submitted with `trace=` (an
`obs.RequestTrace`) gets the JAX engine's marks: queue at submit,
prefill_start at admission, first_token when the prefill's token is on
the host, window-dispatch and window-settle per window, and
abort("cancelled") on cancel. Nothing is recorded inside the captured
window.

Not ported yet; each raises NotImplementedError: overlapped decode and
prefill, chunked prefill, meshes and pipeline stages, rolling caches,
the prefix cache, beam search, preemption, and at `submit` logit bias,
presence and frequency penalties, per-request seeds, constraints,
prompt logprobs, prefill-only requests and QoS tags.
"""

from __future__ import annotations

import functools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from shellac_tpu_torch.config import ModelConfig
from shellac_tpu_torch.inference.cache import (
    CacheBackend,
    PoolExhausted,
    kv_field_names,
    make_backend,
    resolve_backend_name,
    scatter_slot,
)
from shellac_tpu_torch.inference.graphs import StepGraph
from shellac_tpu_torch.models import transformer
from shellac_tpu_torch.obs import EngineMetrics, get_registry
from shellac_tpu_torch.ops.dispatch import DeviceLike, check_on, resolve_device
from shellac_tpu_torch.ops.sampling import NEG_INF, sample_batched


def _unported(**opts) -> None:
    """Raise NotImplementedError for an option set to anything but its
    off value (None or False)."""
    for name, value in opts.items():
        if value is not None and value is not False:
            raise NotImplementedError(f"{name}={value!r} is not ported yet")


@dataclass
class _Request:
    rid: Any
    tokens: np.ndarray  # (S,) int32 prompt
    max_new: int
    stop: Optional[List[List[int]]] = None  # token-id stop sequences
    # Sampling settings resolved at submit (top_k >= 1; vocab = off).
    temperature: float = 0.0
    top_k: int = 1
    top_p: float = 1.0
    min_p: float = 0.0
    # EOS is banned from sampling until this many tokens are emitted.
    min_tokens: int = 0
    # Generated tokens so far; grows only, except that a stop-sequence
    # match removes the matched suffix once, at completion.
    out: List[int] = field(default_factory=list)
    # Raw-distribution logprob of each emitted token (logprobs=True).
    lps: List[float] = field(default_factory=list)
    # Per emitted token, the top-K alternatives as ([ids], [logprobs]).
    tlp: Optional[List] = None
    # Host clock (time.perf_counter): queued, admitted to a slot, first
    # token on the host.
    t_queued: float = 0.0
    t_admitted: float = 0.0
    t_first: float = 0.0
    # The request's span (obs.RequestTrace), or None when not traced.
    trace: Optional[Any] = None

    def hit_stop(self) -> Optional[int]:
        """Length of the matched stop suffix of `out`, or None."""
        for seq in self.stop or ():
            n = len(seq)
            if n and len(self.out) >= n and self.out[-n:] == seq:
                return n
        return None


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class BatchingEngine:
    """Fixed-slot continuous batching over one model on one device (the
    card by default).

    Storage is delegated to a cache backend (`inference/cache`):
    `cache_backend` takes a registry name or a constructed CacheBackend.
    """

    # Backend families this class drives; the paged subclass overrides.
    _backend_family: Tuple[str, ...] = ("dense", "dense-int8")
    # Extra per-slot residency past prompt + max_new + 1 a window may
    # write.
    _footprint_slack = 0

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        n_slots: int = 8,
        max_len: Optional[int] = None,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        min_p: Optional[float] = None,
        eos_id: Optional[int] = None,
        seed: int = 0,
        attn_impl: str = "auto",
        decode_ticks="auto",
        overlap_decode: bool = False,
        overlap_prefill: bool = False,
        max_prefills_per_step: Optional[int] = None,
        prefill_chunk=None,
        logprobs: bool = False,
        top_logprobs: int = 0,
        mesh=None,
        kv_quant: Optional[str] = None,
        rolling_window: bool = False,
        pp_pipeline: bool = False,
        cache_backend=None,
        registry=None,
        device: DeviceLike = None,
    ):
        _unported(overlap_decode=overlap_decode,
                  overlap_prefill=overlap_prefill,
                  prefill_chunk=None if prefill_chunk == "auto"
                  else prefill_chunk,
                  mesh=mesh,
                  rolling_window=rolling_window, pp_pipeline=pp_pipeline)
        top_logprobs = int(top_logprobs or 0)
        if top_logprobs < 0 or top_logprobs > 32:
            raise ValueError(
                f"top_logprobs={top_logprobs}: must be in [0, 32]"
            )
        if top_logprobs and not logprobs:
            raise ValueError("top_logprobs needs logprobs=True")
        # "auto" runs as 1 until an autotuner (not ported) rewrites it.
        if decode_ticks == "auto":
            decode_ticks = 1
        elif isinstance(decode_ticks, str):
            raise ValueError(
                f"decode_ticks={decode_ticks!r}: need an int >= 1 or 'auto'"
            )
        if decode_ticks < 1:
            raise ValueError(f"decode_ticks must be >= 1, got {decode_ticks}")
        if max_prefills_per_step is not None and max_prefills_per_step < 1:
            raise ValueError("max_prefills_per_step must be >= 1")
        transformer.check_supported(cfg)
        self.device = resolve_device(device)
        check_on(self.device, embed=params["embed"])
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len or cfg.max_seq_len
        self.eos_id = eos_id
        self.attn_impl = attn_impl
        self.decode_ticks = decode_ticks
        self.max_prefills_per_step = max_prefills_per_step
        self.logprobs = logprobs
        self.top_logprobs = top_logprobs

        if isinstance(cache_backend, CacheBackend):
            if kv_quant is not None and kv_quant != cache_backend.kv_quant:
                raise ValueError(
                    f"kv_quant={kv_quant!r} conflicts with the "
                    f"{cache_backend.name!r} backend instance"
                )
            if (cache_backend.n_slots != n_slots
                    or cache_backend.max_len != self.max_len):
                raise ValueError(
                    f"{cache_backend.name!r} backend instance geometry "
                    f"(n_slots={cache_backend.n_slots}, "
                    f"max_len={cache_backend.max_len}) does not match the "
                    f"engine (n_slots={n_slots}, max_len={self.max_len})"
                )
            backend = cache_backend
        else:
            backend = make_backend(
                resolve_backend_name(cache_backend, kv_quant=kv_quant), cfg,
                n_slots, self.max_len)
        if backend.name not in self._backend_family:
            raise ValueError(
                f"{type(self).__name__} drives cache backends "
                f"{self._backend_family}, not {backend.name!r}; "
                "inference.cache.engine_class names the engine for a backend"
            )
        backend.bind(self)
        self.cache_backend = backend
        self.kv_quant = backend.kv_quant

        self._defaults = {
            "temperature": float(temperature),
            # top_k resolves once, here: None (disabled) = full vocab.
            "top_k": int(top_k) if top_k is not None else cfg.vocab_size,
            "top_p": float(top_p) if top_p is not None else 1.0,
            "min_p": float(min_p) if min_p is not None else 0.0,
        }
        self._validate_sampling(self._defaults, "engine defaults")
        dev, n = self.device, n_slots

        def full(value, dtype):
            return torch.full((n,), value, dtype=dtype, device=dev)

        # Per-slot sampling settings the decode window samples with, so
        # one tick serves greedy and sampled requests side by side.
        self._stemp = full(self._defaults["temperature"], torch.float32)
        self._stopk = full(self._defaults["top_k"], torch.int64)
        self._stopp = full(self._defaults["top_p"], torch.float32)
        self._sminp = full(self._defaults["min_p"], torch.float32)
        # Device-side stop state threaded through the window: remaining
        # min_tokens (EOS ban), remaining max_new budget, a sticky done
        # flag; and each slot's next input token.
        self._smin = full(0, torch.int32)
        self._srem = full(0, torch.int32)
        self._sdone = full(False, torch.bool)
        self._cur = full(0, torch.int64)
        # The slots a window advances, copied in before each window.
        self._active = full(False, torch.bool)
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(int(seed))
        # The decode window's runner per variant (greedy_only).
        self._windows: Dict[bool, StepGraph] = {}

        self._cache = backend.init_cache(dev)
        # Host copy of each slot's cache length (positions written).
        self._host_len: List[int] = [0] * n_slots
        self._queue: Deque[_Request] = deque()
        self._slots: List[Optional[_Request]] = [None] * n_slots
        self.finished_logprobs: Dict[Any, List[float]] = {}
        self.finished_top_logprobs: Dict[Any, List] = {}
        # rid -> (queued, admitted, first token, finished), host clock.
        self.finished_timings: Dict[Any, Tuple[float, ...]] = {}
        self.stats: Dict[str, int] = {
            "requests_completed": 0,
            "tokens_generated": 0,
            "engine_steps": 0,
            "prefills": 0,
            "requests_cancelled": 0,
            # Admissions put back because the backend had no room.
            "pool_exhausted": 0,
            "decode_windows": 0,
            # Window variants captured as CUDA graphs (the card only).
            "decode_graphs": 0,
        }
        # Engine instruments over the shared registry, written once per
        # step on the host (never inside the captured window).
        self.obs = EngineMetrics(
            registry if registry is not None else get_registry())
        # Per-step phase seconds (obs.STEP_PHASES) and the time blocked
        # in the window's sync, reset by each step().
        self._phase_s: Dict[str, float] = {}
        self._sync_block_s = 0.0

    # ---- sampling ----------------------------------------------------

    @staticmethod
    def _validate_sampling(d: Dict[str, Any], label) -> None:
        if d["temperature"] < 0:
            raise ValueError(f"{label}: temperature must be >= 0")
        if d["top_k"] < 1:
            raise ValueError(f"{label}: top_k must be >= 1 (or None)")
        if not 0 < d["top_p"] <= 1:
            raise ValueError(f"{label}: top_p must be in (0, 1]")
        if not 0 <= d["min_p"] < 1:
            raise ValueError(f"{label}: min_p must be in [0, 1)")

    def _adjust_logits(self, logits, min_rem):
        """The min_tokens EOS ban on a (B, V) fp32 logit block; sampling
        consumes the result while logprobs keep the raw distribution."""
        x = logits.float()
        if self.eos_id is None:
            return x
        x = x.clone()
        x[:, self.eos_id] = torch.where(min_rem > 0, NEG_INF,
                                        x[:, self.eos_id])
        return x

    def _sample_first(self, last, req: _Request):
        """The prefill's first output token from the adjusted logits of
        the last prompt position, its raw logprob, and its top-K."""
        adj = self._adjust_logits(
            last[None], torch.full((1,), req.min_tokens, device=self.device))
        if req.temperature == 0.0:
            first = torch.argmax(adj, dim=-1)
        else:
            def one(value, dtype):
                return torch.full((1,), value, dtype=dtype,
                                  device=self.device)

            first = sample_batched(
                self._gen, adj, one(req.temperature, torch.float32),
                one(req.top_k, torch.int64), one(req.top_p, torch.float32),
                one(req.min_p, torch.float32))
        lsm = torch.log_softmax(last.float(), dim=-1)
        tl = (torch.topk(lsm[None], self.top_logprobs, dim=-1)
              if self.top_logprobs else None)
        return first[0], lsm[first[0]], tl

    # ---- admission ---------------------------------------------------

    def submit(self, rid, tokens, max_new: int, stop=None, *,
               temperature=None, top_k=None, top_p=None, min_p=None,
               min_tokens=None, logit_bias=None, presence_penalty=None,
               frequency_penalty=None, prompt_logprobs=False, seed=None,
               constraint=None, trace=None, prefill_only: bool = False,
               tenant=None, qos_class=None, qos_weight=None) -> None:
        """Queue a request. `stop`: token-id sequences; generation ends
        when the output ends with one, and the match is removed from the
        returned tokens. temperature/top_k/top_p/min_p override the
        engine defaults for this request only. `trace` (an
        obs.RequestTrace) receives the request's lifecycle marks."""
        _unported(logit_bias=logit_bias or None,
                  presence_penalty=presence_penalty or None,
                  frequency_penalty=frequency_penalty or None,
                  prompt_logprobs=prompt_logprobs, seed=seed,
                  constraint=constraint,
                  prefill_only=prefill_only, tenant=tenant,
                  qos_class=qos_class, qos_weight=qos_weight)
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.size == 0:
            raise ValueError(f"request {rid!r}: empty prompt")
        if max_new < 1:
            raise ValueError(f"request {rid!r}: max_new must be >= 1")
        if tokens.size + max_new + 1 > self.max_len:
            raise ValueError(
                f"request {rid!r}: prompt {tokens.size} + max_new {max_new} "
                f"exceeds max_len {self.max_len}"
            )
        if stop is not None:
            stop = [list(map(int, s)) for s in stop]
            if any(len(s) == 0 for s in stop):
                raise ValueError(f"request {rid!r}: empty stop sequence")
        d = self._defaults
        samp = {
            "temperature": float(
                temperature if temperature is not None else d["temperature"]
            ),
            "top_k": int(top_k) if top_k is not None else d["top_k"],
            "top_p": float(top_p) if top_p is not None else d["top_p"],
            "min_p": float(min_p) if min_p is not None else d["min_p"],
        }
        self._validate_sampling(samp, f"request {rid!r}")
        min_tokens = int(min_tokens) if min_tokens is not None else 0
        if min_tokens < 0:
            raise ValueError(f"request {rid!r}: min_tokens must be >= 0")
        if min_tokens > 0 and self.eos_id is None:
            raise ValueError(
                f"request {rid!r}: min_tokens needs the engine's eos_id"
            )
        self._queue.append(_Request(
            rid, tokens, max_new, stop=stop, min_tokens=min_tokens,
            t_queued=time.perf_counter(), trace=trace, **samp,
        ))
        if trace is not None:
            # The request entered the admission queue (queue wait ends
            # at the span's prefill_start).
            trace.record("queue", src="engine", rid=rid,
                         queue_depth=len(self._queue))

    def _slot_footprint(self, req: _Request) -> int:
        """Worst-case token residency of `req`: prompt + budget + 1 plus
        the engine's window slack. The backend reserves it at admission."""
        return req.tokens.size + req.max_new + 1 + self._footprint_slack

    def _release_slot(self, slot: int) -> None:
        """A request left `slot`: the backend releases its storage and
        the slot's device length returns to 0."""
        self.cache_backend.release_slot(slot)
        self._cache.lengths[slot] = 0
        self._host_len[slot] = 0

    def _set_slot_sampling(self, slot: int, req: _Request) -> None:
        self._stemp[slot] = req.temperature
        self._stopk[slot] = req.top_k
        self._stopp[slot] = req.top_p
        self._sminp[slot] = req.min_p
        self._smin[slot] = req.min_tokens

    def _prefill_mini(self, tokens, s: int):
        """Prefill a batch-1 dense mini cache of the pad length; returns
        (last real position's logits, mini)."""
        mini = self.cache_backend.init_mini(tokens.shape[1], self.device)
        logits, mini = transformer.forward_with_cache(
            self.cfg, self.params, tokens, mini,
            new_tokens_len=torch.full((1,), s, dtype=torch.int32,
                                      device=self.device),
            fresh_cache=True, attn_impl=self.attn_impl,
        )
        return logits[0, s - 1], mini

    def _prefill_impl(self, tokens, s: int, slot: int):
        """Prefill one request and scatter it into `slot`'s dense row;
        returns the last prompt position's logits."""
        last, mini = self._prefill_mini(tokens, s)
        scatter_slot(self._cache, mini, slot)
        return last

    def _add_phase(self, phase: str, seconds: float) -> None:
        self._phase_s[phase] = self._phase_s.get(phase, 0.0) + seconds

    def _run_prefill(self, slot: int, req: _Request) -> None:
        t0 = time.perf_counter()
        s = req.tokens.size
        # Cap the bucket at max_len: a larger pad would index past the
        # slot's row or its block table.
        pad = min(_bucket(s), self.max_len)
        padded = torch.zeros((1, pad), dtype=torch.int64)
        padded[0, :s] = torch.from_numpy(req.tokens)
        last = self._prefill_impl(padded.to(self.device), s, slot)
        first, lp, tl = self._sample_first(last, req)
        t1 = time.perf_counter()
        first_tok = int(first)  # the prefill's one host sync
        req.t_first = time.perf_counter()
        self._host_len[slot] = s
        self._cur[slot] = first_tok
        # The prefill token is the first of max_new; the window may emit
        # max_new - 1 more. It also used one unit of the EOS ban.
        self._srem[slot] = req.max_new - 1
        self._sdone[slot] = False
        if req.min_tokens > 0:
            self._smin[slot] = req.min_tokens - 1
        req.out.append(first_tok)
        if self.logprobs:
            req.lps.append(float(lp))
        if tl is not None:
            req.tlp = [(tl[1][0].tolist(), tl[0][0].tolist())]
        if req.trace is not None:
            # The first token is a host value: the request's TTFT point.
            req.trace.first_token()
        # Phase attribution: the prefill's launches, then its sync and
        # the host bookkeeping after it.
        self._add_phase("prefill_dispatch", t1 - t0)
        self._add_phase("prefill_settle", time.perf_counter() - t1)

    def _fill_slots(self, budget: Optional[int] = None) -> None:
        done = 0
        for i in range(self.n_slots):
            if self._slots[i] is not None or not self._queue:
                continue
            if budget is not None and done >= budget:
                break
            done += 1
            req = self._queue.popleft()
            try:
                self.cache_backend.prepare_slot(i, req,
                                                self._slot_footprint(req))
            except PoolExhausted:
                # No room: the request waits at the head of the queue and
                # retries after a slot frees its storage.
                self._queue.appendleft(req)
                self.stats["pool_exhausted"] += 1
                break
            req.t_admitted = time.perf_counter()
            if req.trace is not None:
                # Queue wait ends here (after prepare_slot: a pool miss
                # requeues the request, so its wait goes on).
                req.trace.prefill_start()
            self._set_slot_sampling(i, req)
            self._slots[i] = req
            self.stats["prefills"] += 1
            self._run_prefill(i, req)

    def _finish_check(self, finished) -> None:
        for i, req in enumerate(self._slots):
            if req is None or not req.out:
                continue
            last = req.out[-1]
            nstop = req.hit_stop()
            if nstop is not None:
                req.out = req.out[:-nstop]
                req.lps = req.lps[:len(req.out)]
                if req.tlp is not None:
                    req.tlp = req.tlp[:len(req.out)]
            if nstop is not None or (
                self.eos_id is not None and last == self.eos_id
            ) or len(req.out) >= req.max_new:
                finished.append((req.rid, req.out))
                if self.logprobs:
                    self.finished_logprobs[req.rid] = req.lps[:len(req.out)]
                if self.top_logprobs and req.tlp is not None:
                    self.finished_top_logprobs[req.rid] = (
                        req.tlp[:len(req.out)]
                    )
                self.finished_timings[req.rid] = (
                    req.t_queued, req.t_admitted, req.t_first,
                    time.perf_counter(),
                )
                self.stats["requests_completed"] += 1
                self.stats["tokens_generated"] += len(req.out)
                self._slots[i] = None
                self._release_slot(i)

    # ---- the engine step ---------------------------------------------

    def step(self) -> List[Tuple[Any, List[int]]]:
        """Fill free slots, run one decode window (decode_ticks ticks);
        returns the finished requests. One host sync per window. The
        engine's metrics are written here, on the host, after the sync."""
        finished: List[Tuple[Any, List[int]]] = []
        self.stats["engine_steps"] += 1
        t_step0 = time.perf_counter()
        self._sync_block_s = 0.0
        self._phase_s = {}
        synced = False
        prefills0 = self.stats["prefills"]
        # Fill and check until stable: a request satisfied by its prefill
        # alone (max_new=1, instant EOS, a stop completed by the first
        # token) frees its slot for the next queued request. The prefill
        # budget is shared across the loop.
        remaining = self.max_prefills_per_step
        while True:
            before = self.stats["prefills"]
            self._fill_slots(remaining)
            if remaining is not None:
                remaining -= self.stats["prefills"] - before
            n_done = len(finished)
            self._finish_check(finished)
            if len(finished) == n_done or (
                remaining is not None and remaining <= 0
            ):
                break
        if self.stats["prefills"] > prefills0:
            # The prefill section's wall time, on steps that prefilled.
            self.obs.prefill_seconds.observe(time.perf_counter() - t_step0)
        # Admission: the fill section minus the prefills' own time.
        self._phase_s["admission"] = max(
            0.0, time.perf_counter() - t_step0
            - self._phase_s.get("prefill_dispatch", 0.0)
            - self._phase_s.get("prefill_settle", 0.0))
        active_rows = self._active_rows()
        if any(active_rows):
            self.obs.occupancy.observe(sum(active_rows) / self.n_slots)
            pairs = [(i, self._slots[i])
                     for i in range(self.n_slots) if active_rows[i]]
            decoded = self._decode_tokens(active_rows)
            self._phase_s["decode_sync"] = self._sync_block_s
            t_settle0 = time.perf_counter()
            self._apply_pairs(pairs, *decoded)
            self._finish_check(finished)
            self._phase_s["settle"] = time.perf_counter() - t_settle0
            synced = True
        self._observe_cache_gauges()
        if synced:
            # The host's share of the step: wall time minus the time
            # blocked awaiting the window's results.
            self.obs.host_overhead.observe(max(
                0.0, time.perf_counter() - t_step0 - self._sync_block_s))
        self._observe_step_phases(t_step0, synced, finished, prefills0)
        return finished

    def _observe_step_phases(self, t_step0: float, synced: bool,
                             finished, prefills0: int) -> None:
        """Deposit this step's phase attribution (obs.STEP_PHASES), only
        for steps that did work; host_bookkeeping is the remainder, so
        the phases add up to the step's wall time."""
        did_work = (synced or bool(finished)
                    or self.stats["prefills"] > prefills0)
        if not did_work or not self.obs.registry.enabled:
            return
        attributed = 0.0
        for phase in ("admission", "prefill_dispatch", "prefill_settle",
                      "decode_sync", "settle"):
            v = self._phase_s.get(phase, 0.0)
            attributed += v
            self.obs.step_phase.labels(phase=phase).observe(v)
        self.obs.step_phase.labels(phase="host_bookkeeping").observe(
            max(0.0, time.perf_counter() - t_step0 - attributed))

    def _observe_cache_gauges(self) -> None:
        """Per-step utilization gauges from host state only."""
        obs = self.obs
        if not obs.registry.enabled:
            return
        obs.slots_busy.set(sum(r is not None for r in self._slots))
        obs.queue_depth.set(len(self._queue))
        obs.kv_util.set(self.cache_backend.utilization())

    def _active_rows(self) -> List[bool]:
        """Slots a decode window advances: the occupied ones."""
        return [r is not None for r in self._slots]

    def _decode_tokens(self, active_rows):
        """Run one window over every slot and sync it once; returns
        (tokens per slot, logprobs per slot or None, top-K per slot or
        None), each cut to the slot's valid ticks."""
        self.cache_backend.pre_window(active_rows, self.decode_ticks)
        top = max(self._host_len)
        # The write guard forward_with_cache keeps runs at capture only,
        # so the window is checked here.
        if top + self.decode_ticks > self._cache.max_len:
            raise ValueError(
                f"cache write of {self.decode_ticks} positions at length "
                f"{top} passes max_len={self._cache.max_len}"
            )
        self._cache.max_length = top
        greedy_only = all(
            r is None or r.temperature == 0.0 for r in self._slots
        )
        self._active.copy_(torch.tensor(active_rows))
        t0 = time.perf_counter()
        toks, lps, tlv, tli, acts = self._decode_impl(greedy_only)
        self.stats["decode_windows"] += 1
        for i, req in enumerate(self._slots):
            if active_rows[i] and req.trace is not None:
                req.trace.record("window-dispatch", src="engine",
                                 rid=req.rid, slot=i,
                                 ticks=self.decode_ticks, depth=1)
        t1 = time.perf_counter()
        packed = torch.cat([toks, acts.to(torch.int64)]).cpu().numpy()
        t2 = time.perf_counter()
        self._sync_block_s += t2 - t1
        # Window wall time, dispatch to results on the host.
        self.obs.decode_window_seconds.observe(t2 - t0)
        host_toks, host_acts = packed[:len(toks)], packed[len(toks):]
        # Valid ticks are a prefix (done is sticky): each slot's tokens
        # are a slice, and its cache grew by as many positions.
        n_valid = host_acts.sum(axis=0)
        for i in range(self.n_slots):
            self._host_len[i] += int(n_valid[i])
        per_slot = [host_toks[:n_valid[i], i].tolist()
                    for i in range(self.n_slots)]
        if not self.logprobs:
            return per_slot, None, None
        host_lps = lps.cpu().numpy()
        per_lps = [host_lps[:n_valid[i], i].tolist()
                   for i in range(self.n_slots)]
        if not self.top_logprobs:
            return per_slot, per_lps, None
        host_tlv, host_tli = tlv.cpu().numpy(), tli.cpu().numpy()
        per_tl = [
            [(host_tli[j, i].tolist(), host_tlv[j, i].tolist())
             for j in range(n_valid[i])]
            for i in range(self.n_slots)
        ]
        return per_slot, per_lps, per_tl

    def _graph(self, fn, generator):
        """The runner of a window program `fn`: a CUDA graph on the card."""
        return StepGraph(fn, self.device, generator)

    def _decode_impl(self, greedy_only: bool):
        """One window through its variant's runner (a graph replay on the
        card, after the variant's first, eager window)."""
        window = self._windows.get(greedy_only)
        if window is None:
            window = self._windows[greedy_only] = self._graph(
                functools.partial(self._window, greedy_only), self._gen)
        out = window()
        self.stats["decode_graphs"] = sum(
            w.graph is not None for w in self._windows.values())
        return out

    def _window(self, greedy_only: bool):
        """decode_ticks single-token forwards over every slot. A slot
        whose sampled token is EOS, or whose budget runs out, sets its
        sticky done flag and freezes (length, stop state, token) for the
        rest of the window. The cache, the next tokens and the stop state
        are written back in place. Returns (tokens, logprobs, top-K values,
        top-K ids, validity flags), each stacked (ticks, n_slots, ...)."""
        cache, cur, active = self._cache, self._cur, self._active
        min_rem, rem, done = self._smin, self._srem, self._sdone
        outs = []
        for _ in range(self.decode_ticks):
            act = active & ~done
            logits, grown = transformer.forward_with_cache(
                self.cfg, self.params, cur[:, None], cache,
                attn_impl=self.attn_impl,
            )
            cache.lengths.copy_(
                torch.where(act, grown.lengths, cache.lengths))
            cache.max_length = grown.max_length
            nxt, new_min, lp, tlv, tli = self._row_decode_step(
                logits[:, 0], cur, act, min_rem, greedy_only)
            # This token ends the request when it is EOS (min_tokens has
            # banned EOS while its countdown runs) or the last of the
            # budget.
            fin = act & (rem <= 1)
            if self.eos_id is not None:
                fin = fin | (act & (nxt == self.eos_id))
            rem.copy_(torch.where(act, (rem - 1).clamp_min(0), rem))
            done.logical_or_(fin)
            min_rem.copy_(new_min)
            cur.copy_(nxt)
            outs.append((nxt, lp, tlv, tli, act))
        return tuple(torch.stack(x) for x in zip(*outs))

    def _row_decode_step(self, logits, cur, act, min_rem, greedy_only):
        """One tick's exit math over (n_slots, V) raw fp32 logits: the
        EOS ban, sampling (greedy rows take the argmax), and logprob and
        top-K extraction from the raw distribution."""
        adj = self._adjust_logits(logits, min_rem)
        if greedy_only:
            nxt = torch.argmax(adj, dim=-1)
        else:
            nxt = sample_batched(self._gen, adj, self._stemp, self._stopk,
                                 self._stopp, self._sminp)
        nxt = torch.where(act, nxt, cur)
        min_rem = torch.where(act, (min_rem - 1).clamp_min(0), min_rem)
        n = nxt.shape[0]
        lp = torch.zeros((n,), dtype=torch.float32, device=self.device)
        tlv = torch.zeros((n, 0), dtype=torch.float32, device=self.device)
        tli = torch.zeros((n, 0), dtype=torch.int64, device=self.device)
        if self.logprobs:
            lsm = torch.log_softmax(logits.float(), dim=-1)
            lp = torch.gather(lsm, 1, nxt[:, None])[:, 0]
            if self.top_logprobs:
                tlv, tli = torch.topk(lsm, self.top_logprobs, dim=-1)
        return nxt, min_rem, lp, tlv, tli

    def _apply_pairs(self, pairs, per_slot, per_lps, per_tl) -> None:
        """Append a window's valid tokens to the requests that owned the
        slots, stopping at the host-only finish conditions (stop
        sequences; EOS and budget were cut on the device and are checked
        again as the single source of truth)."""
        for slot, req in pairs:
            if req.trace is not None:
                req.trace.record("window-settle", src="engine",
                                 rid=req.rid, slot=slot,
                                 n_tokens=len(per_slot[slot]))
            for j, tok in enumerate(per_slot[slot]):
                req.out.append(int(tok))
                if per_lps is not None:
                    req.lps.append(float(per_lps[slot][j]))
                if per_tl is not None:
                    if req.tlp is None:
                        req.tlp = []
                    req.tlp.append(per_tl[slot][j])
                if (self.eos_id is not None and tok == self.eos_id) or (
                    len(req.out) >= req.max_new
                ) or req.hit_stop() is not None:
                    break

    # ---- cancellation and draining -----------------------------------

    def cancel(self, rid) -> bool:
        """Drop a queued or running request; its slot frees at once."""
        for i, req in enumerate(self._slots):
            if req is not None and req.rid == rid:
                self._slots[i] = None
                self._release_slot(i)
                self.finished_logprobs.pop(rid, None)
                self.finished_top_logprobs.pop(rid, None)
                self.stats["requests_cancelled"] += 1
                if req.trace is not None:
                    req.trace.abort("cancelled")
                return True
        for req in list(self._queue):
            if req.rid == rid:
                self._queue.remove(req)
                self.stats["requests_cancelled"] += 1
                if req.trace is not None:
                    req.trace.abort("cancelled")
                return True
        return False

    def abort_all(self) -> List[Any]:
        """Drop every queued and running request; returns their rids.
        The backend's allocator returns to its pristine state."""
        dropped = []
        for req in self._queue:
            dropped.append(req.rid)
            if req.trace is not None:
                req.trace.abort("cancelled")
        self._queue.clear()
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            dropped.append(req.rid)
            if req.trace is not None:
                req.trace.abort("cancelled")
            self._slots[i] = None
            self._release_slot(i)
        self.finished_logprobs.clear()
        self.finished_top_logprobs.clear()
        self.cache_backend.reset()
        self.stats["requests_cancelled"] += len(dropped)
        return dropped

    @property
    def pending(self) -> int:
        return len(self._queue) + sum(r is not None for r in self._slots)

    def close(self) -> None:
        """Drop the captured decode graphs and the device cache, so
        their memory returns to the allocator; the engine cannot step
        afterwards. Call it on the thread that drives the engine, or
        once that thread has exited: freeing a graph is a CUDA call,
        which a capture running on another thread would refuse."""
        self._windows = {}
        self._cache = None

    def run(self, requests=None) -> Dict[Any, List[int]]:
        """Drain: submit (rid, tokens, max_new) triples, step to empty."""
        for r in requests or ():
            self.submit(*r)
        results: Dict[Any, List[int]] = {}
        while self.pending:
            for rid, out in self.step():
                results[rid] = out
        return results

    # ---- not ported yet ----------------------------------------------

    def beam_search(self, *args, **kw):
        raise NotImplementedError("beam search is not ported yet")

    def preempt(self, rid):
        raise NotImplementedError("preemption is not ported yet")

    def release_frozen(self, rid):
        raise NotImplementedError("frozen slots are not ported yet")


class PagedBatchingEngine(BatchingEngine):
    """Continuous batching over a shared block pool (paged KV cache).

    Slots borrow `block_size`-token blocks from one pool and return them
    on completion; `pool_tokens` (default: half the dense footprint) is
    the capacity knob, and admission waits in the queue while the pool
    cannot cover a request's footprint. Block 0 is scratch. Decode
    attends through the block tables (`paged_decode_attention`). An int8
    pool (`paged-int8`) defaults to 64-token blocks.
    """

    _backend_family = ("paged", "paged-int8")

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        n_slots: int = 8,
        max_len: Optional[int] = None,
        block_size: Optional[int] = None,
        pool_tokens: Optional[int] = None,
        prefix_cache: bool = False,
        cache_backend=None,
        kv_quant: Optional[str] = None,
        **kw,
    ):
        _unported(prefix_cache=prefix_cache)
        if not isinstance(cache_backend, CacheBackend):
            name = resolve_backend_name(cache_backend,
                                        paged=cache_backend is None,
                                        kv_quant=kv_quant)
            if name not in self._backend_family:
                raise ValueError(
                    f"{type(self).__name__} drives cache backends "
                    f"{self._backend_family}; {name!r} needs a different "
                    "engine class (inference.cache.engine_class)"
                )
            if block_size is None:
                # The JAX engines' defaults: int8 pools take 64-token
                # blocks, the others 16.
                block_size = 64 if name == "paged-int8" else 16
            cache_backend = make_backend(
                name, cfg, n_slots, max_len or cfg.max_seq_len,
                block_size=block_size, pool_tokens=pool_tokens,
            )
        elif (block_size is not None
              and block_size != cache_backend.block_size) \
                or pool_tokens is not None:
            raise ValueError(
                "block_size and pool_tokens cannot reshape a constructed "
                f"{cache_backend.name!r} backend; pass them to its "
                "constructor"
            )
        super().__init__(cfg, params, n_slots=n_slots, max_len=max_len,
                         cache_backend=cache_backend, kv_quant=kv_quant,
                         **kw)
        self.block_size = self.cache_backend.block_size

    def _prefill_impl(self, tokens, s: int, slot: int):
        """Dense mini prefill, then a scatter of its pad positions through
        the slot's table row (positions past the slot's blocks land in
        scratch block 0). An int8 mini's scales scatter through the same
        (block, offset) coordinates."""
        last, mini = self._prefill_mini(tokens, s)
        cache, bs = self._cache, self.block_size
        pos = torch.arange(tokens.shape[1], device=self.device)
        blocks = cache.tables[slot].to(torch.int64)[pos // bs]
        offs = pos % bs
        # Advanced indices at dims 1 and 3 (split by the head slice) put
        # the token rows first: the target is (S, L, Hkv[, Dh]), from the
        # mini's (L, Hkv, S[, Dh]).
        for name in kv_field_names(self.kv_quant):
            src = getattr(mini, name)[:, 0]
            getattr(cache, name)[:, blocks, :, offs] = src.movedim(2, 0)
        cache.lengths[slot:slot + 1] = mini.lengths
        return last
