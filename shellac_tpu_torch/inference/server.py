"""HTTP serving on top of the port's continuous-batching engine.

Ports `shellac_tpu/inference/server.py`: `InferenceServer` (:274),
`make_http_server` (:3234) and `serve` (:3746), stdlib only
(`http.server`). One scheduler thread owns the engine and is the ONLY
thread that touches torch's CUDA state: it submits, steps, and settles
requests. Handler threads parse JSON, enqueue work and wait on
per-request events; tokens reach them as Python lists (the engine's
host copy of each request's output), so no handler thread ever makes a
CUDA call. That matters on the card: the engine captures its decode
windows and prefills as CUDA graphs on the thread that drives it, in
the "thread_local" capture mode, and no other thread may launch work
while a capture runs (`inference/graphs.py`). The engine may be built on
the caller's thread; with `autotune=True` (:506-523) the startup sweep
of decode_ticks (and of prefill_chunk, when it is "auto") runs there too,
before the scheduler thread starts, and a rebuilt generation inherits
the tuned values. Every later program runs on the scheduler thread.

A SUPERVISOR wraps the scheduler in engine generations (:167): when the
step watchdog trips (`step_timeout`, :1109) or the scheduler thread
dies, every in-flight request fails loudly, the stale generation's
results are discarded, and within the restart budget a fresh engine is
rebuilt from `engine_factory` (:959). A watchdog cannot interrupt a
running kernel, so a rebuilt engine allocates its cache and graph pool
beside the abandoned one; `close()` frees the graphs and caches of every
generation whose thread has exited. Admission is bounded
(`max_pending` -> 429 + Retry-After, `ServerUnavailable` :152), a
request's client timeout rides its submit tuple as a deadline that the
scheduler sheds on (:1185), a client that disconnects mid-stream
cancels its request, and `drain` / `resume_admission` (:592, :604) flip
readiness for a planned stop.

API (as the reference): GET /v1/models, /health, /stats, /metrics,
/debug/requests, /debug/request/<trace id>; POST /generate (blocking or
"stream": true ndjson, with stop-length holdback), /v1/completions,
/v1/chat/completions (blocking or SSE), /drain. Every response carries
`x-request-id`, the trace id adopted from `x-shellac-trace` or minted.
`n`/`best_of`, logprobs, top logprobs and the per-request controls
(`logit_bias`, `presence_penalty`, `frequency_penalty`, `seed`,
`prompt_logprobs`, and /v1/completions' `echo` with `logprobs`) work as
in the reference (:2165-2189); prompt logprobs come back as
`prompt_logprobs`, position 0 null (`_render_plp` :127).

Constrained output and tool calling work as in the reference: the
native `constraint` ({"regex"}, {"json_schema"} or {"json_object"}),
the OpenAI `response_format` (json_object, json_schema) and `tools` /
`tool_choice` / `parallel_tool_calls` compile to a token DFA on the
handler thread (`_compile_constraint` :2198, an LRU of 32 per pattern,
feeding `shellac_constraint_compile_seconds` and
`shellac_constraint_cache_total`), which the engine enforces inside its
programs. A tool-enabled request's output is parsed back into
`tool_calls` (`_format_completion` :2947; streamed through one
`ToolCallStreamParser`, :3044-3098) and counted in
`shellac_tool_requests_total`. Compiling needs a server-side tokenizer
and the engine's `eos_id`.

Beam search works as in the reference: a request with `num_beams`
(`_handle_beam` :2307, and `length_penalty`, a `constraint` or an OpenAI
`response_format`) runs one search on the scheduler thread between
engine steps (`_run_beam` :1293; the dense caches' single-request
delegate or the paged engine's copy-on-write search, whose faults fail
only that request) and answers the ranked beams with their
`beam_score`s. Sampling, streaming and logprob knobs must keep their
neutral values (`_BEAM_NEUTRAL`), tools and streaming refuse it, and
`num_beams` is capped at max(4 x slots, 16).

Not ported yet; configuring any of these raises NotImplementedError, and
an HTTP request for one gets a 501 whose body says so: the KV import /
seed / push / migrate / adopt / park / resume paths (`/kv/*`,
`prefill_only`, `adopt`, `resume`), preemption and parking
(`preempt_after`, `park_dir`), QoS tenants (`tenant_config`; the
x-shellac-tenant header still labels the request counters, as it does in
the reference without a tenant config), `profile_dir` and
/debug/profile, `incident_dir` and /debug/incident(s), `spool_dir`, and
a `role` other than "monolith".
"""

from __future__ import annotations

import functools
import itertools
import json
import queue
import random
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from shellac_tpu_torch.config import ModelConfig
from shellac_tpu_torch.inference.batching import BatchingEngine, _unported
from shellac_tpu_torch.inference.constraints import (
    compile_token_dfa,
    constraint_pattern,
)
from shellac_tpu_torch.inference.openai_api import (
    StreamTranslator,
    chat_to_native,
    completion_response,
    completion_to_native,
    stream_error_payload,
)
from shellac_tpu_torch.inference.tools import (
    ToolCallStreamParser,
    events_to_stream,
    parse_payload_tools,
    parse_tool_calls,
    safe_stream_text,
)
from shellac_tpu_torch.obs import (
    REQUEST_ID_HEADER,
    TRACE_HEADER,
    FlightRecorder,
    Registry,
    ServeMetrics,
    adopt_trace,
    get_registry,
    new_trace_id,
)
from shellac_tpu_torch.utils.failure import Heartbeat, RestartBudget

#: Replica roles of disaggregated serving; only "monolith" is ported.
ROLES = ("monolith", "prefill", "decode")
#: Request header naming the tenant (`shellac_tpu/inference/qos.py:42`).
TENANT_HEADER = "x-shellac-tenant"


def retry_after(lo: float, hi: float) -> float:
    """A Retry-After value drawn uniformly from [lo, hi], so rejected
    clients do not all come back at the same instant."""
    return random.uniform(lo, hi)


class ServerUnavailable(RuntimeError):
    """The server pushed back instead of serving: over the pending cap
    (HTTP 429), mid-recovery, draining, or a request shed on an expired
    deadline (HTTP 503). A RuntimeError so programmatic callers that only
    know the fatal contract still fail loudly."""

    def __init__(self, msg: str, *, http_status: int = 503,
                 retry_after: float = 1.0):
        super().__init__(msg)
        self.http_status = http_status
        self.retry_after = retry_after


# "Never tuned", as distinct from a prefill_chunk tuned to None.
_UNTUNED = object()


def _render_plp(plp):
    """Prompt logprobs for a response: position 0 has no predictor and
    renders as null (the OpenAI convention)."""
    return [None] + plp[1:]


class _Generation:
    """One scheduler-thread + engine incarnation. The supervisor replaces
    the whole object on recovery, so a wedged thread keeps its own
    engine, submit queue and stop event and can never consume a
    successor's work."""

    __slots__ = ("gen", "engine", "submit_q", "stop", "step_started",
                 "thread", "dead")

    def __init__(self, gen: int, engine):
        self.gen = gen
        self.engine = engine
        self.submit_q: queue.Queue = queue.Queue()
        self.stop = threading.Event()
        # Monotonic start of the engine step in flight (None between
        # steps); the watchdog reads it cross-thread.
        self.step_started: Optional[float] = None
        self.thread: Optional[threading.Thread] = None
        # Set (under the server lock) once the supervisor replaces it.
        self.dead = False


class _Pending:
    __slots__ = ("event", "result", "error", "chunks", "emitted", "holdback",
                 "lps", "plp", "tlp", "rid", "deadline", "kind", "trace",
                 "tenant")

    def __init__(self, rid, stream: bool = False, holdback: int = 0,
                 deadline: Optional[float] = None, trace=None,
                 tenant: Optional[str] = None):
        self.rid = rid
        self.tenant = tenant
        # The request's span (obs.RequestTrace), settled wherever the
        # request settles.
        self.trace = trace
        # Absolute monotonic deadline mirroring the client's timeout.
        self.deadline = deadline
        # How `error` surfaces: "error" (400), "fault" (500), "shed"
        # (503, retryable), "unported" (501).
        self.kind = "error"
        self.event = threading.Event()
        self.result = None
        self.error: Optional[str] = None
        # Streaming requests get a chunk queue: lists of new token ids,
        # then a None sentinel at completion.
        self.chunks: Optional[queue.Queue] = queue.Queue() if stream else None
        self.emitted = 0
        # Tokens withheld from deltas: a stop match truncates up to the
        # longest stop length at the end of the output.
        self.holdback = holdback
        self.lps = None
        self.plp = None  # the prompt's per-token logprobs (prompt_logprobs)
        self.tlp = None

    def finish(self):
        if self.chunks is not None:
            self.chunks.put(None)
        self.event.set()


class InferenceServer:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        tokenizer=None,
        engine: Optional[BatchingEngine] = None,
        model_name: str = "shellac_tpu",
        step_timeout: Optional[float] = None,
        max_pending: Optional[int] = None,
        restart_budget: int = 0,
        restart_window: float = 300.0,
        engine_factory: Optional[Callable[[], Any]] = None,
        heartbeat_path: Optional[str] = None,
        registry: Optional[Registry] = None,
        metrics: bool = True,
        autotune: bool = False,
        debug: bool = True,
        debug_include_text: bool = False,
        profile_dir: Optional[str] = None,
        recorder: Optional[FlightRecorder] = None,
        role: str = "monolith",
        spool_dir: Optional[str] = None,
        incident_dir: Optional[str] = None,
        park_dir: Optional[str] = None,
        tenant_config: Optional[Any] = None,
        preempt_after: Optional[float] = None,
        **engine_kw,
    ):
        if role not in ROLES:
            raise ValueError(f"role={role!r}; have {ROLES}")
        _unported(role=None if role == "monolith" else role,
                  profile_dir=profile_dir,
                  spool_dir=spool_dir, incident_dir=incident_dir,
                  park_dir=park_dir, tenant_config=tenant_config,
                  preempt_after=preempt_after)
        self.role = role
        # Every span and counter lands in `registry`, the process
        # default unless the caller isolates one; metrics=False swaps in
        # a disabled registry (writes no-op, /metrics answers 404).
        if registry is None:
            registry = get_registry() if metrics else Registry(enabled=False)
        self._registry = registry
        self._m = ServeMetrics(registry)
        # The flight recorder feeds /debug/requests and
        # /debug/request/<id>; debug=False 404s them and stops recording.
        self._debug = bool(debug)
        self._debug_text = bool(debug_include_text)
        self._recorder = (recorder if recorder is not None
                          else FlightRecorder(registry=registry,
                                              enabled=self._debug))
        self._t0 = time.monotonic()
        # Validate BEFORE starting the scheduler thread.
        if step_timeout is not None and step_timeout <= 0:
            raise ValueError("step_timeout must be > 0 seconds")
        if max_pending is not None and max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        if restart_budget < 0:
            raise ValueError("restart_budget must be >= 0")
        if restart_budget > 0 and engine is not None and engine_factory is None:
            raise ValueError(
                "restart_budget > 0 with a prebuilt engine needs an "
                "engine_factory: the server cannot rebuild an engine "
                "it did not construct"
            )
        if engine is None:
            # Engines this server builds share its registry, so engine
            # gauges and request spans expose through one scrape.
            engine_kw.setdefault("registry", registry)
            engine = BatchingEngine(cfg, params, **engine_kw)
            if engine_factory is None:
                # The retained cfg/params/engine_kw rebuild an identical
                # engine on recovery; params are shared (never written).
                engine_factory = functools.partial(
                    BatchingEngine, cfg, params, **engine_kw
                )
        self.model_name = model_name
        self.tokenizer = tokenizer
        self._pending: Dict[int, _Pending] = {}
        # Compiled constraints by pattern, least recently used first.
        self._constraint_cache: "OrderedDict[str, Any]" = OrderedDict()
        self._ids = itertools.count()
        # Serializes admission against the supervisor's generation swap
        # and pending sweep. Never held across an engine step.
        self._lock = threading.Lock()
        self._closed = threading.Event()
        self._fatal: Optional[str] = None
        self._recovering = False
        self._draining = False
        self.step_timeout = step_timeout
        self.max_pending = max_pending
        self._engine_factory = engine_factory
        self._budget = (
            RestartBudget(restart_budget, restart_window)
            if restart_budget > 0 and engine_factory is not None else None
        )
        self.restarts = 0   # generations rebuilt by the supervisor
        self.shed = 0       # requests shed on an expired deadline
        # One-way flag: the per-step shed sweep early-outs while no
        # request has ever carried a deadline.
        self._saw_deadline = False
        # Replaced generations whose engines still hold device memory,
        # freed once their threads have exited (on the scheduler thread
        # or in close()).
        self._retired: List[_Generation] = []
        # Startup autotune (serve --decode-ticks auto, the CLI default;
        # --prefill-chunk auto): sweep against the live engine BEFORE the
        # scheduler thread exists (the engine has one owner here), write
        # the winners back, and remember them so a rebuilt generation
        # inherits them instead of sweeping mid-recovery. The sentinel
        # tells "never tuned" from "tuned to whole prompts (None)".
        self._tuned_ticks: Optional[int] = None
        self._tuned_chunk: Any = _UNTUNED
        if autotune:
            from shellac_tpu_torch.inference.autotune import (
                maybe_autotune,
                maybe_autotune_prefill_chunk,
            )

            res = maybe_autotune(engine)
            if res is not None:
                self._tuned_ticks = res.best
            cres = maybe_autotune_prefill_chunk(engine)
            if cres is not None:
                self._tuned_chunk = cres.best
        self._hb = Heartbeat(heartbeat_path) if heartbeat_path else None
        self._hb_last = 0.0
        self._hb_lock = threading.Lock()
        self._g = self._start_generation(0, engine)
        self._g.thread.start()
        if step_timeout is not None:
            threading.Thread(target=self._watchdog, daemon=True,
                             name="shellac-watchdog").start()

    # The engine and scheduler thread of the CURRENT generation.
    @property
    def engine(self):
        return self._g.engine

    @property
    def _thread(self) -> threading.Thread:
        return self._g.thread

    @property
    def status(self) -> str:
        """"ok" | "recovering" | "draining" | "failed"."""
        if self._fatal is not None:
            return "failed"
        if self._recovering or self._g.dead:
            return "recovering"
        if self._draining:
            return "draining"
        return "ok"

    def health(self) -> Dict[str, Any]:
        """Readiness snapshot served at /health (host ints and strings:
        possibly stale, never torn)."""
        g = self._g
        info: Dict[str, Any] = {
            "status": self.status,
            "ok": self.status == "ok",
            "role": self.role,
            "pending": len(self._pending),
            "queue_depth": g.submit_q.qsize(),
            "engine_pending": g.engine.pending,
            "generation": g.gen,
            "restarts": self.restarts,
            "restart_budget_used": (self._budget.used
                                    if self._budget is not None else None),
            "shed": self.shed,
            "max_pending": self.max_pending,
            "draining": self._draining,
        }
        if self._fatal is not None:
            info["error"] = self._fatal
        return info

    # ---- graceful drain ---------------------------------------------

    def drain(self) -> Dict[str, Any]:
        """Flip readiness (/health answers 503 "draining"), refuse new
        admissions with 503 + Retry-After, and let every in-flight
        request complete. Idempotent."""
        with self._lock:
            self._draining = True
            self._m.draining.set(1)
        return self.health()

    def resume_admission(self) -> Dict[str, Any]:
        """Cancel a drain (a no-op on a fatal server)."""
        with self._lock:
            self._draining = False
            self._m.draining.set(0)
        return self.health()

    @property
    def draining(self) -> bool:
        return self._draining

    # ---- observability ----------------------------------------------

    @property
    def metrics_enabled(self) -> bool:
        return self._registry.enabled

    @property
    def uptime_s(self) -> float:
        return time.monotonic() - self._t0

    def metrics_text(self) -> str:
        """Prometheus text exposition of the shared registry, with the
        scrape-time gauges (engine stats, supervisor state, uptime)
        refreshed first."""
        m = self._m
        g = self._g
        for k, v in g.engine.stats.items():
            if isinstance(v, (int, float)):
                m.engine_stat(k).set(v)
        m.cache_backend_info.labels(
            backend=g.engine.cache_backend.name).set(1)
        m.role_info.labels(role=self.role).set(1)
        m.generation.set(g.gen)
        m.uptime.set(self.uptime_s)
        m.pending.set(len(self._pending))
        return self._registry.render()

    def latency_summary(self) -> Dict[str, Any]:
        """p50/p90/p99 digests (seconds) of the request-span histograms
        for /stats, from the series /metrics exposes."""
        return {
            "ttft_s": self._m.ttft.summary(),
            "e2e_s": self._m.e2e.summary(),
            "queue_wait_s": self._m.queue_wait.summary(),
        }

    # ---- debug introspection (flight recorder) ----------------------

    @property
    def debug_enabled(self) -> bool:
        return self._debug

    @property
    def recorder(self) -> FlightRecorder:
        return self._recorder

    def debug_requests(self) -> Dict[str, Any]:
        """The GET /debug/requests snapshot: the in-flight table, the
        cache backend's per-slot residency, histogram exemplars and the
        recorder's ring stats; host reads only. Prompt and generated
        text appear only with debug_include_text."""
        g = self._g
        eng = g.engine
        slots = list(getattr(eng, "_slots", ()) or ())
        prefilling = set(getattr(eng, "_prefilling", ()) or ())
        slot_of = {req.rid: i for i, req in enumerate(slots)
                   if req is not None}
        now = time.monotonic()
        rows = []
        for rid, p in list(self._pending.items()):
            t = p.trace
            slot = slot_of.get(rid)
            row: Dict[str, Any] = {
                "rid": rid,
                "trace_id": getattr(t, "trace_id", None),
                "slot": slot,
                "state": ("queued" if slot is None
                          else "prefilling" if slot in prefilling
                          else "decoding"),
                "tenant": p.tenant,
                "stream": p.chunks is not None,
                "age_s": (round(now - t.t_submit, 3)
                          if t is not None else None),
                "deadline_in_s": (round(p.deadline - now, 3)
                                  if p.deadline is not None else None),
            }
            req = slots[slot] if slot is not None else None
            if req is not None and req.rid == rid:
                row["tokens_out"] = len(req.out)
                if self._debug_text:
                    prompt = [int(x) for x in req.tokens[:256]]
                    out = list(req.out)
                    row["prompt_text"] = (
                        self.tokenizer.decode(prompt)
                        if self.tokenizer is not None else prompt)
                    row["output_text"] = (
                        self.tokenizer.decode(out)
                        if self.tokenizer is not None else out)
            rows.append(row)
        out: Dict[str, Any] = {
            "in_flight": rows,
            "pending": len(self._pending),
            "overlap_window_depth": len(getattr(eng, "_windows", ())
                                        or ()),
            "generation": g.gen,
            "recorder": self._recorder.stats(),
            "exemplars": {
                "ttft": self._m.ttft.bucket_exemplars(),
                "e2e": self._m.e2e.bucket_exemplars(),
                "queue_wait": self._m.queue_wait.bucket_exemplars(),
                "tpot": self._m.tpot.bucket_exemplars(),
            },
        }
        try:
            out["slots"] = eng.cache_backend.residency()
        except Exception:  # noqa: BLE001 — introspection must not 500
            out["slots"] = None
        return out

    def debug_request(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """The GET /debug/request/<trace_id> timeline, or None for an
        id the ring no longer (or never) holds."""
        events = self._recorder.events_for(trace_id)
        if not events:
            return None
        return {"trace_id": trace_id, "events": events, "source": "ring"}

    # ---- supervisor --------------------------------------------------

    def _start_generation(self, gen: int, engine) -> _Generation:
        g = _Generation(gen, engine)
        g.thread = threading.Thread(
            target=self._loop, args=(g,), daemon=True,
            name=f"shellac-scheduler-gen{gen}",
        )
        return g

    def _fail_pending_locked(self, msg: str) -> None:
        """Fail every pending request loudly and drain the current
        generation's submit queue (caller holds the lock). Settlement is
        arbitrated by the dict pop, so a just-delivered result is never
        clobbered with an error."""
        while self._pending:
            _, p = self._pending.popitem()
            p.error = msg
            p.kind = "fault"
            if p.trace is not None:
                p.trace.abort("fault")
            p.finish()
        while True:
            try:
                self._g.submit_q.get_nowait()
            except queue.Empty:
                break

    def _recover(self, g: _Generation, msg: str,
                 wedged: bool = False) -> None:
        """Supervisor transition out of a dead or wedged generation: fail
        everything in flight loudly, then rebuild a fresh engine under a
        new generation (within the restart budget) or stay fatal. Called
        from the watchdog (wedge) or the dying scheduler thread;
        idempotent per generation. The abandoned engine keeps its device
        memory until its thread exits (a rebuild needs room for two)."""
        with self._lock:
            if g.dead or g is not self._g:
                return  # this generation is already being replaced
            g.dead = True
            g.stop.set()  # a wedged thread that ever returns exits
            self._retired.append(g)
            self._fail_pending_locked(msg)
            recover = (self._budget is not None
                       and not self._closed.is_set()
                       and self._budget.allow())
            if not recover:
                if self._budget is not None and not self._closed.is_set():
                    msg += (f" [restart budget exhausted: "
                            f"{self._budget.max_restarts} restart(s) per "
                            f"{self._budget.window:g}s]")
                self._fatal = msg
            else:
                self._recovering = True
                self.restarts += 1
                self._m.restarts.inc()
        if not recover:
            return
        # Rebuild OUTSIDE the lock: construction allocates device memory,
        # and /health + admission must keep answering "recovering".
        stop_beat = threading.Event()
        if self._hb is not None:
            def _rebuild_beater():
                while not stop_beat.wait(0.5):
                    self._beat(g)

            threading.Thread(target=_rebuild_beater, daemon=True).start()
        try:
            engine = self._engine_factory()
            if (self._tuned_ticks is not None
                    and engine.decode_ticks_requested == "auto"):
                # The rebuilt generation inherits the startup tune; a
                # fresh sweep mid-recovery would stretch the outage.
                engine.set_decode_ticks(self._tuned_ticks)
                engine.decode_ticks_source = "auto-tuned"
            if (self._tuned_chunk is not _UNTUNED
                    and engine.prefill_chunk_requested == "auto"):
                engine.set_prefill_chunk(self._tuned_chunk)
                engine.prefill_chunk_source = "auto-tuned"
        except Exception as e:  # noqa: BLE001 — any rebuild fault is fatal
            with self._lock:
                self._recovering = False
                self._fatal = (f"{msg}; engine rebuild failed: "
                               f"{type(e).__name__}: {e}")
            return
        finally:
            stop_beat.set()
        with self._lock:
            self._recovering = False
            if self._closed.is_set():
                self._fatal = "server closed during recovery"
                return
            self._g = self._start_generation(g.gen + 1, engine)
            self._g.thread.start()

    def _reap_retired(self) -> None:
        """Free the graphs and caches of replaced generations whose
        threads have exited. Runs on the current scheduler thread (or in
        close() after it exited), never beside a capture."""
        for g in list(self._retired):
            if g.thread is not None and g.thread.is_alive():
                continue
            self._retired.remove(g)
            g.engine.close()

    def _watchdog(self) -> None:
        """Detect a wedged engine step from outside the scheduler thread;
        follows the supervisor across generations until the server
        closes or goes fatal."""
        poll = min(self.step_timeout / 4, 1.0)
        while not self._closed.wait(poll):
            if self._fatal is not None:
                return
            g = self._g
            self._beat(g)
            started = g.step_started
            if (g.dead or started is None
                    or time.monotonic() - started <= self.step_timeout):
                continue
            self._recover(
                g,
                f"engine step exceeded step_timeout={self.step_timeout}s "
                "(wedged engine step)",
                wedged=True,
            )

    # ---- scheduler thread (sole owner of its generation's engine) ---

    def _loop(self, g: _Generation) -> None:
        try:
            self._run(g)
        except BaseException as e:  # noqa: BLE001
            # If the only consumer dies silently every pending request
            # blocks forever: hand the generation to the supervisor.
            self._recover(g, f"scheduler died: {type(e).__name__}: {e}")

    def _beat(self, g: _Generation) -> None:
        """Touch the liveness file at most once a second."""
        if self._hb is None:
            return
        with self._hb_lock:
            now = time.monotonic()
            if now - self._hb_last < 1.0:
                return
            self._hb_last = now
            try:
                self._hb.beat(g.engine.stats.get("engine_steps", 0))
            except OSError:
                pass

    def _shed(self, rid, p: _Pending) -> None:
        """Settle one request as shed (deadline expired before prefill)."""
        if self._pending.pop(rid, None) is None:
            return
        self.shed += 1
        if p.trace is not None:
            p.trace.shed()
        p.error = ("request shed: deadline expired before prefill "
                   "(server saturated past the client timeout)")
        p.kind = "shed"
        p.finish()

    def _shed_expired(self, g: _Generation) -> None:
        """Drop engine-QUEUED requests whose client deadline passed;
        requests already in a slot keep running."""
        if not self._saw_deadline:
            return
        now = time.monotonic()
        queued = None
        for rid, p in list(self._pending.items()):
            if p.deadline is None or now <= p.deadline:
                continue
            if queued is None:
                queued = {r.rid for r in g.engine._queue}
            if rid not in queued:
                continue
            g.engine.cancel(rid)
            self._shed(rid, p)

    def _settle_error(self, rid, msg: str, kind: str,
                      outcome: str = "error") -> None:
        p = self._pending.pop(rid, None)
        if p is not None:
            p.error = msg
            p.kind = kind
            if p.trace is not None:
                p.trace.abort(outcome)
            p.finish()

    def _process_item(self, g: _Generation, item) -> None:
        rid, tokens, max_new, stop, samp, deadline = item
        if tokens is None:
            # Cancellation marker: drop queued or in-flight work of an
            # abandoned client request.
            g.engine.cancel(rid)
            p = self._pending.pop(rid, None)
            if p is not None:
                p.error = "cancelled"
                if p.trace is not None:
                    p.trace.abort("cancelled")
                p.finish()
            return
        if deadline is not None and time.monotonic() > deadline:
            p = self._pending.get(rid)
            if p is not None:
                self._shed(rid, p)
            return
        if samp and "_beam" in samp:
            # A beam request runs whole on the scheduler thread (the
            # engine's owner), like a long prefill: the search is the
            # request, with no slot to multiplex.
            self._run_beam(g, rid, tokens, max_new, samp["_beam"])
            return
        pend = self._pending.get(rid)
        try:
            g.engine.submit(
                rid, tokens, max_new, stop=stop,
                trace=pend.trace if pend is not None else None, **samp,
            )
        except NotImplementedError as e:
            self._settle_error(rid, str(e), "unported")
        except (ValueError, TypeError) as e:
            # A bad request, not a scheduler-killing fault.
            self._settle_error(rid, str(e), "error")

    def _run_beam(self, g: _Generation, rid, tokens, max_new: int,
                  beam: Dict[str, Any]) -> None:
        """Run one beam-search request on the scheduler thread and settle
        its pending. Engine faults stay with the request: a paged search
        whose pool is exhausted (RuntimeError) fails this request loudly
        instead of killing the scheduler."""
        p = self._pending.get(rid)
        if p is not None and p.trace is not None:
            p.trace.prefill_start()
        try:
            seqs, scores = g.engine.beam_search(
                tokens, num_beams=beam["num_beams"], max_new_tokens=max_new,
                eos_id=getattr(g.engine, "eos_id", None),
                length_penalty=beam["length_penalty"],
                constraint=beam.get("constraint"),
            )
        except NotImplementedError as e:
            self._settle_error(rid, str(e), "unported")
            return
        except (ValueError, TypeError) as e:
            self._settle_error(rid, str(e), "error")
            return
        except Exception as e:  # noqa: BLE001 — a request-scoped fault
            self._settle_error(
                rid, f"beam search failed: {type(e).__name__}: {e}",
                "fault", outcome="fault")
            return
        p = self._pending.pop(rid, None)
        if p is None:
            return  # cancelled or swept while the search ran
        if p.trace is not None:
            p.trace.first_token()
            p.trace.finish(sum(len(q) for q in seqs))
        p.result = {"beams": seqs, "scores": scores}
        p.finish()

    def _run(self, g: _Generation) -> None:
        engine = g.engine
        while not g.stop.is_set():
            drained = False
            while True:
                try:
                    item = g.submit_q.get_nowait()
                except queue.Empty:
                    break
                drained = True
                self._process_item(g, item)
            self._shed_expired(g)
            self._beat(g)
            if engine.pending:
                g.step_started = time.monotonic()
                try:
                    finished = engine.step() or []
                finally:
                    # Clear the clock even when the step raises, so the
                    # watchdog cannot misread a dying scheduler.
                    g.step_started = None
                if g.dead or g is not self._g:
                    # Stale generation: its results are discarded (the
                    # pendings they would resolve were failed loudly).
                    return
                fin = {rid for rid, _ in finished}
                # Stream deltas for requests still in flight, holding
                # back the longest stop length from the tail.
                for req in engine._slots:
                    if req is None or req.rid in fin:
                        continue
                    p = self._pending.get(req.rid)
                    if p is None or p.chunks is None:
                        continue
                    upto = max(p.emitted, len(req.out) - p.holdback)
                    if upto > p.emitted:
                        p.chunks.put(list(req.out[p.emitted:upto]))
                        p.emitted = upto
                self._deliver_finished(g, finished)
            elif not drained:
                if self._retired:
                    self._reap_retired()
                # Idle: block briefly on the queue instead of spinning.
                try:
                    self._process_item(g, g.submit_q.get(timeout=0.05))
                except queue.Empty:
                    pass

    def _deliver_finished(self, g: _Generation, finished) -> None:
        """Settle every (rid, out) the engine finished this step."""
        engine = g.engine
        lp_store = getattr(engine, "finished_logprobs", {})
        plp_store = getattr(engine, "finished_prompt_logprobs", {})
        tl_store = getattr(engine, "finished_top_logprobs", {})
        timings = getattr(engine, "finished_timings", {})
        for rid, out in finished:
            # The request's span holds its clocks; the engine's copy
            # would grow for the server's life.
            timings.pop(rid, None)
            p = self._pending.pop(rid, None)
            if p is not None:
                p.result = out
                if p.trace is not None:
                    p.trace.finish(len(out))
                p.lps = lp_store.pop(rid, None)
                p.plp = plp_store.pop(rid, None)
                p.tlp = tl_store.pop(rid, None)
                if p.chunks is not None and len(out) > p.emitted:
                    p.chunks.put(list(out[p.emitted:]))
                p.finish()
            else:
                lp_store.pop(rid, None)
                plp_store.pop(rid, None)
                tl_store.pop(rid, None)

    # ---- client surface ---------------------------------------------

    def _submit(self, tokens, max_new: int, stop, samp, *, stream: bool,
                deadline: Optional[float] = None,
                trace_ctx: Optional[Tuple[str, int]] = None,
                tenant: Optional[str] = None) -> _Pending:
        # Every admitted request has exactly one trace id: the header's,
        # or a fresh one for direct library callers.
        tid, attempt = (trace_ctx if trace_ctx is not None
                        else (new_trace_id(), 0))
        tenant = str(tenant) if tenant else None
        # The span clock starts at admission, so queue wait covers
        # everything the client waits through server-side.
        trace = self._m.trace(trace_id=tid, recorder=self._recorder,
                              tenant=tenant)
        tokens = np.asarray(tokens, np.int32)
        admit_fields: Dict[str, Any] = {
            "src": "server", "attempt": attempt,
            "prompt_len": int(tokens.size), "max_new": int(max_new),
            "stream": stream,
        }
        if tenant is not None:
            admit_fields["tenant"] = tenant
        if self._debug_text and self.tokenizer is not None:
            admit_fields["prompt_text"] = self.tokenizer.decode(
                [int(t) for t in tokens[:256]]
            )
        with self._lock:
            if self._fatal is not None:
                raise RuntimeError(self._fatal)
            if self._closed.is_set():
                raise RuntimeError("server closed")
            g = self._g
            if self._recovering or g.dead:
                self._m.rejects.labels(reason="recovering",
                                       tenant=tenant or "").inc()
                raise ServerUnavailable(
                    "server recovering from an engine fault; retry",
                    http_status=503, retry_after=retry_after(3.0, 8.0),
                )
            if self._draining:
                self._m.rejects.labels(reason="draining",
                                       tenant=tenant or "").inc()
                raise ServerUnavailable(
                    "server draining: not admitting new requests "
                    "(in-flight work is completing); retry elsewhere",
                    http_status=503, retry_after=retry_after(1.0, 4.0),
                )
            if (self.max_pending is not None
                    and len(self._pending) >= self.max_pending):
                self._m.rejects.labels(reason="overloaded",
                                       tenant=tenant or "").inc()
                raise ServerUnavailable(
                    f"server overloaded: {len(self._pending)} requests "
                    f"pending (max_pending={self.max_pending})",
                    http_status=429, retry_after=retry_after(1.0, 3.0),
                )
            rid = next(self._ids)
            holdback = max((len(s) for s in stop), default=0) if stop else 0
            if deadline is not None:
                self._saw_deadline = True
            p = _Pending(rid, stream=stream, holdback=holdback,
                         deadline=deadline, trace=trace, tenant=tenant)
            self._pending[rid] = p
            # Recorded before the scheduler can see the request, so the
            # timeline's first event is always admit.
            trace.record("admit", rid=rid, pending=len(self._pending),
                         **admit_fields)
            g.submit_q.put(
                (rid, tokens, max_new, stop, dict(samp or {}), deadline)
            )
        return p

    def _raise(self, p: _Pending):
        # Server faults are 500, sheds a retryable 503, an unported
        # option 501, anything else a bad request (400).
        if p.kind == "fault":
            raise RuntimeError(p.error)
        if p.kind == "shed":
            raise ServerUnavailable(p.error, http_status=503,
                                    retry_after=retry_after(1.0, 3.0))
        if p.kind == "unported":
            raise NotImplementedError(p.error)
        raise ValueError(p.error)

    def _await(self, p: _Pending, deadline: Optional[float]) -> _Pending:
        remaining = (None if deadline is None
                     else max(deadline - time.monotonic(), 0.0))
        if not p.event.wait(remaining):
            raise TimeoutError("request timed out")
        if p.error is not None:
            self._raise(p)
        return p

    def _cancel(self, p: _Pending) -> None:
        """Ask the scheduler to drop an unfinished request (the tokens=
        None marker): its slot frees instead of generating unread
        tokens."""
        if not p.event.is_set():
            self._g.submit_q.put((p.rid, None, 0, None, None, None))

    @staticmethod
    def _deadline(timeout) -> Optional[float]:
        return None if timeout is None else time.monotonic() + timeout

    def generate(self, tokens, max_new: int, timeout: Optional[float] = None,
                 stop=None, return_logprobs: bool = False,
                 trace_ctx: Optional[Tuple[str, int]] = None,
                 tenant: Optional[str] = None, **samp):
        """Blocking generation; the timeout doubles as the request's
        deadline (shed if it expires before prefill)."""
        deadline = self._deadline(timeout)
        p = self._submit(tokens, max_new, stop, samp, stream=False,
                         deadline=deadline, trace_ctx=trace_ctx,
                         tenant=tenant)
        try:
            self._await(p, deadline)
        except TimeoutError:
            self._cancel(p)
            raise
        if return_logprobs:
            return p.result, p.lps, p.plp, p.tlp
        return p.result

    def generate_stream(self, tokens, max_new: int,
                        timeout: Optional[float] = None, stop=None,
                        return_logprobs: bool = False,
                        trace_ctx: Optional[Tuple[str, int]] = None,
                        tenant: Optional[str] = None, **samp):
        """Yield ("delta", [token ids]) as generation progresses, then
        ("done", output), or ("done", (output, logprobs, prompt logprobs,
        top logprobs)) with return_logprobs=True. `timeout` bounds the wait
        per chunk and doubles as the admission deadline. Abandoning the
        generator cancels the request."""
        p = self._submit(tokens, max_new, stop, samp, stream=True,
                         deadline=self._deadline(timeout),
                         trace_ctx=trace_ctx, tenant=tenant)
        finished = False
        try:
            while True:
                try:
                    chunk = p.chunks.get(timeout=timeout)
                except queue.Empty:
                    raise TimeoutError("request timed out mid-stream")
                if chunk is None:
                    break
                yield ("delta", chunk)
            if p.error is not None:
                self._raise(p)
            finished = True
            yield ("done",
                   (p.result, p.lps, p.plp, p.tlp) if return_logprobs
                   else p.result)
        finally:
            if not finished:
                self._cancel(p)

    @staticmethod
    def _refuse_unported(payload: dict) -> None:
        """NotImplementedError (HTTP 501) for a request that asks for a
        feature this slice does not port."""
        for key, what in (
            ("prefill_only", "prefill-only KV migration"),
            ("migrate_to", "KV migration"),
            ("park", "KV parking"),
            ("adopt", "KV adoption"),
            ("resume", "park-spool resume"),
        ):
            v = payload.get(key)
            if v is not None and v is not False:
                raise NotImplementedError(
                    f"{key} ({what}) is not ported yet")

    def _parse(self, payload: dict):
        self._refuse_compositions(payload, self._tool_context(payload))
        self._refuse_unported(payload)
        if "tokens" in payload:
            tokens = np.asarray(payload["tokens"], np.int32)
        elif "text" in payload:
            if self.tokenizer is None:
                raise ValueError('"text" needs a server-side tokenizer')
            tokens = self.tokenizer.encode(payload["text"])
        else:
            raise ValueError('need "tokens" or "text"')
        max_new = int(payload.get("max_new", 32))
        stop = payload.get("stop")
        if stop is not None:
            try:
                parsed = []
                for s in stop:
                    if isinstance(s, str):
                        if self.tokenizer is None:
                            raise ValueError(
                                "string stop sequences need a server-side "
                                "tokenizer"
                            )
                        parsed.append(
                            list(map(int, self.tokenizer.encode(s)))
                        )
                    else:
                        parsed.append(list(map(int, s)))
            except (TypeError, ValueError) as e:
                raise ValueError(f"bad stop sequences: {e}")
            stop = parsed
        # Per-request sampling overrides (validated by engine.submit;
        # whitelisted so unknown payload keys cannot reach **kwargs).
        try:
            samp = {
                k: float(payload[k])
                for k in ("temperature", "top_p", "min_p",
                          "presence_penalty", "frequency_penalty")
                if payload.get(k) is not None
            }
            for key in ("top_k", "min_tokens", "seed"):
                if payload.get(key) is not None:
                    v = float(payload[key])
                    if not v.is_integer():
                        raise ValueError(
                            f"{key} must be an integer, got {v}"
                        )
                    samp[key] = int(v)
            if payload.get("prompt_logprobs"):
                samp["prompt_logprobs"] = True
            if payload.get("logit_bias") is not None:
                lb = payload["logit_bias"]
                if not isinstance(lb, dict):
                    raise ValueError(
                        "logit_bias must be a {token id: bias} object"
                    )
                samp["logit_bias"] = lb  # entries validated by submit
            if payload.get("constraint") is not None:
                samp["constraint"] = self._compile_constraint(
                    payload["constraint"]
                )
        except (TypeError, ValueError) as e:
            raise ValueError(f"bad sampling parameters: {e}")
        return tokens, max_new, stop, samp

    def _compile_constraint(self, spec):
        """Compile a constraint spec ({"regex"|"json_schema"|
        "json_object"}) to a TokenDFA over this server's tokenizer, on
        the handler thread, cached per pattern (an LRU of 32): the
        compile walks the whole vocab, so a repeated schema pays it
        once."""
        if self.tokenizer is None:
            raise ValueError(
                "constrained decoding needs a server-side tokenizer "
                "(the grammar compiles against token strings)"
            )
        eos_id = getattr(self.engine, "eos_id", None)
        if eos_id is None:
            raise ValueError(
                "constrained decoding needs the engine's eos_id (serve "
                "--eos-id or a tokenizer that defines one)"
            )
        pattern = constraint_pattern(spec)
        with self._lock:
            cached = self._constraint_cache.get(pattern)
            if cached is not None:
                self._constraint_cache.move_to_end(pattern)
        if cached is None:
            self._m.constraint_cache.labels(result="miss").inc()
            t0 = time.monotonic()
            cached = compile_token_dfa(
                pattern, self.tokenizer, self.engine.cfg.vocab_size, eos_id,
            )
            self._m.constraint_compile.observe(time.monotonic() - t0)
            with self._lock:
                self._constraint_cache[pattern] = cached
                while len(self._constraint_cache) > 32:
                    self._constraint_cache.popitem(last=False)
        else:
            self._m.constraint_cache.labels(result="hit").inc()
        return cached

    def _tool_context(self, payload: dict):
        """Validate `tools`/`tool_choice` on a native payload and return
        the ToolContext (None when the request declares no tools). The
        native surface takes the OpenAI tool shapes verbatim but does not
        render tools into the prompt: a native caller owns its prompt."""
        ctx = parse_payload_tools(payload)
        if ctx is None:
            return None
        if self.tokenizer is None:
            raise ValueError(
                "tools need a server-side tokenizer (the tool grammar "
                "compiles against token strings)"
            )
        if payload.get("constraint") is not None:
            raise ValueError(
                "tools do not compose with an explicit constraint "
                "(the tool grammar IS the request's constraint)"
            )
        return ctx

    def _tool_constraint(self, samp: dict, tool_ctx) -> None:
        if tool_ctx is not None and tool_ctx.pattern is not None:
            samp["constraint"] = self._compile_constraint(
                {"regex": tool_ctx.pattern}
            )

    def _tool_outcome(self, text: str, calls) -> None:
        # The grammar's free-text branch can never start with '<'
        # (entering the sentinel commits to the tool branch), so any
        # unparsed '<'-prefixed output is a truncated call.
        outcome = ("call" if calls is not None
                   else "truncated" if text.startswith("<")
                   else "text")
        self._m.tool_requests.labels(outcome=outcome).inc()

    def _refuse_compositions(self, payload: dict, tool_ctx) -> None:
        """The reference's 400s for options that do not compose with
        tools or a constraint, ahead of the 501 for the unported option
        itself (:2843-2866, :2702)."""
        if payload.get("prefill_only"):
            if tool_ctx is not None:
                raise ValueError(
                    "tools do not compose with prefill_only (tool "
                    "grammar state does not migrate)"
                )
            if payload.get("constraint") is not None:
                raise ValueError(
                    "constraint does not compose with prefill_only (the "
                    "compiled DFA table does not migrate)"
                )

    def _check_logprobs(self, payload) -> bool:
        want = bool(payload.get("logprobs"))
        if want and not getattr(self.engine, "logprobs", False):
            raise ValueError(
                "logprobs requested but the server engine was not built "
                "with logprobs=True (serve --logprobs)"
            )
        return want

    def _check_top_logprobs(self, payload, want_lps: bool) -> int:
        """Per-request k of alternatives to render (0 = none); the
        engine records its configured cap and k slices it."""
        k = payload.get("top_logprobs")
        if k in (None, 0, False):
            return 0
        k = int(k)
        cap = getattr(self.engine, "top_logprobs", 0)
        if k == 1 and cap == 0 and payload.get("top_logprobs_soft"):
            # OpenAI completions' `logprobs: 1` on a server without
            # alternatives keeps its old meaning (the chosen token's
            # logprob only).
            return 0
        if k < 1 or k > cap:
            raise ValueError(
                f"top_logprobs={k}: this server records "
                f"{cap or 'no'} alternatives (serve --top-logprobs N)"
            )
        if not want_lps:
            raise ValueError("top_logprobs needs logprobs=true")
        return k

    @staticmethod
    def _render_tlp(tlp, k):
        """[(ids, lps)] per token -> [[{'id', 'logprob'}] * k]."""
        return [
            [{"id": int(i), "logprob": float(v)}
             for i, v in zip(ids[:k], vals[:k])]
            for ids, vals in tlp
        ]

    # Knobs that do not compose with beam search, with their neutral
    # values: beam decode is deterministic and returns whole ranked
    # sequences, so a non-neutral sampling or streaming knob would be
    # silently ignored; it is a 400 instead (the reference's :2296).
    _BEAM_NEUTRAL = {
        "stream": (None, False), "n": (None, 1), "best_of": (None, 1),
        "logprobs": (None, False), "top_logprobs": (None, 0),
        "min_tokens": (None, 0), "logit_bias": (None,),
        "presence_penalty": (None, 0, 0.0),
        "frequency_penalty": (None, 0, 0.0), "seed": (None,),
        "prompt_logprobs": (None, False), "stop": (None,),
        "temperature": (None, 0, 0.0), "top_p": (None, 1, 1.0),
        "top_k": (None,), "min_p": (None, 0, 0.0),
    }

    def _handle_beam(self, payload: dict,
                     trace_ctx: Optional[Tuple[str, int]] = None,
                     tenant: Optional[str] = None) -> dict:
        """A native beam-search request: `num_beams` (and optionally
        `length_penalty`, `constraint`) answers the ranked beams as
        {"choices": [{"tokens", "beam_score", "text"?}], "num_beams"}."""
        try:
            nb = int(payload["num_beams"])
            lp = float(payload.get("length_penalty", 1.0))
        except (TypeError, ValueError) as e:
            raise ValueError(f"bad num_beams/length_penalty: {e}")
        if nb < 1:
            raise ValueError(f"num_beams must be >= 1, got {nb}")
        cap = max(4 * getattr(self.engine, "n_slots", 8), 16)
        if nb > cap:
            raise ValueError(
                f"num_beams={nb} exceeds this server's cap of {cap}"
            )
        for key, neutral in self._BEAM_NEUTRAL.items():
            if key in payload and payload[key] not in neutral:
                raise ValueError(
                    f"{key}={payload[key]!r} does not compose with "
                    "num_beams (beam search is deterministic and "
                    "unstreamed)"
                )
        tokens, max_new, _, samp = self._parse(payload)
        deadline = self._deadline(payload.get("timeout"))
        p = self._submit(
            tokens, max_new, None,
            {"_beam": {"num_beams": nb, "length_penalty": lp,
                       "constraint": samp.get("constraint")}},
            stream=False, deadline=deadline, trace_ctx=trace_ctx,
            tenant=tenant,
        )
        try:
            self._await(p, deadline)
        except TimeoutError:
            self._cancel(p)
            raise
        choices = []
        for seq, score in zip(p.result["beams"], p.result["scores"]):
            c: Dict[str, Any] = {"tokens": seq,
                                 "beam_score": round(float(score), 6)}
            if self.tokenizer is not None:
                c["text"] = self.tokenizer.decode(seq)
            choices.append(c)
        return {"choices": choices, "num_beams": nb}

    def handle(self, payload: dict,
               trace_ctx: Optional[Tuple[str, int]] = None,
               tenant: Optional[str] = None) -> dict:
        # One trace id for the whole request, fan-out included.
        if trace_ctx is None:
            trace_ctx = (new_trace_id(), 0)
        tool_ctx = self._tool_context(payload)
        if payload.get("num_beams") is not None:
            if tool_ctx is not None:
                raise ValueError(
                    "tools do not compose with num_beams (a beam is a "
                    "ranked whole sequence, not an assistant turn)"
                )
            result = self._handle_beam(payload, trace_ctx=trace_ctx,
                                       tenant=tenant)
            result["trace_id"] = trace_ctx[0]
            return result
        tokens, max_new, stop, samp = self._parse(payload)
        self._tool_constraint(samp, tool_ctx)
        want_lps = self._check_logprobs(payload)
        tlk = self._check_top_logprobs(payload, want_lps)
        n, best_of = self._parse_n(payload, samp)
        if n == 1 and best_of == 1:
            out, lps, plp, tlp = self.generate(
                tokens, max_new, timeout=payload.get("timeout"), stop=stop,
                return_logprobs=True, trace_ctx=trace_ctx, tenant=tenant,
                **samp,
            )
            result = self._format_completion(out, lps, want_lps, plp=plp,
                                             tlp=tlp, tlk=tlk,
                                             tool_ctx=tool_ctx)
            result["trace_id"] = trace_ctx[0]
            return result
        # Parallel sampling: best_of independent completions share the
        # slot batch; the n best by mean token logprob come back as
        # "choices", under one overall deadline. The prompt is the same
        # for all, so its logprobs are computed once, by the first.
        rest_samp = {k: v for k, v in samp.items()
                     if k != "prompt_logprobs"}
        deadline = self._deadline(payload.get("timeout"))
        pendings = []
        try:
            for i in range(best_of):
                pendings.append(self._submit(
                    tokens, max_new, stop, samp if i == 0 else rest_samp,
                    stream=False, deadline=deadline, trace_ctx=trace_ctx,
                    tenant=tenant,
                ))
        except RuntimeError:
            for p in pendings:
                self._cancel(p)
            raise
        choices = []
        plp = None
        try:
            for p in pendings:
                self._await(p, deadline)
                choices.append((p.result, p.lps, p.tlp))
                if p.plp is not None:
                    plp = p.plp
        except (TimeoutError, ValueError, RuntimeError):
            for p in pendings:
                self._cancel(p)
            raise
        if best_of > n:
            # Rank by mean logprob; an empty completion ranks last.
            def score(c):
                return (sum(c[1]) / len(c[1])) if c[1] else float("-inf")

            choices.sort(key=score, reverse=True)
        result: Dict[str, Any] = {"choices": [
            self._format_completion(out, lps, want_lps, tlp=tlp, tlk=tlk,
                                    tool_ctx=tool_ctx)
            for out, lps, tlp in choices[:n]
        ]}
        if plp is not None:
            result["prompt_logprobs"] = _render_plp(plp)
        result["trace_id"] = trace_ctx[0]
        return result

    def _format_completion(self, out, lps, want_lps, plp=None, tlp=None,
                           tlk=0, tool_ctx=None) -> Dict[str, Any]:
        result: Dict[str, Any] = {"tokens": out}
        if want_lps:
            result["logprobs"] = lps
        if tlk and tlp is not None:
            result["top_logprobs"] = self._render_tlp(tlp, tlk)
        if plp is not None:
            result["prompt_logprobs"] = _render_plp(plp)
        if self.tokenizer is not None:
            result["text"] = self.tokenizer.decode(out)
            if tool_ctx is not None and tool_ctx.pattern is not None:
                content, calls = parse_tool_calls(result["text"],
                                                  tool_ctx.mode)
                self._tool_outcome(result["text"], calls)
                if calls is not None:
                    result["tool_calls"] = calls
                else:
                    # Free text (auto) or a length-truncated call: the
                    # content, never a fabricated call.
                    result["content"] = content
        return result

    def _parse_n(self, payload: dict, samp: dict):
        """Validate n (completions returned) and best_of (sampled)."""
        try:
            n = int(payload.get("n", 1))
            best_of = int(payload.get("best_of", n))
        except (TypeError, ValueError) as e:
            raise ValueError(f"bad n/best_of: {e}")
        if n < 1 or best_of < n:
            raise ValueError(f"need best_of >= n >= 1, got n={n}, "
                             f"best_of={best_of}")
        cap = max(4 * getattr(self.engine, "n_slots", 8), 16)
        if best_of > cap:
            raise ValueError(
                f"best_of={best_of} exceeds this server's cap of {cap} "
                "(4x slot count): one request would monopolize the "
                "engine for every other client"
            )
        if best_of == 1:
            return n, best_of
        temp = samp.get("temperature",
                        getattr(self.engine, "_defaults", {}).get(
                            "temperature", 0.0))
        if temp == 0.0:
            raise ValueError(
                "n/best_of > 1 with greedy sampling would return "
                "identical completions; set a temperature"
            )
        if best_of > n and not getattr(self.engine, "logprobs", False):
            raise ValueError(
                "best_of > n ranks completions by logprob; start the "
                "server with logprobs enabled (serve --logprobs)"
            )
        return n, best_of

    def handle_stream(self, payload: dict,
                      trace_ctx: Optional[Tuple[str, int]] = None,
                      tenant: Optional[str] = None):
        """Yield response dicts for a streaming request: delta lines
        {"tokens": [...]}, then {"done": true, "tokens", "text"?,
        "logprobs"?}; every record carries the request's trace_id. Parse
        errors raise before the first yield (a clean 400 or 501). A
        tool-enabled stream's records also carry `tool_stream`, the
        incremental OpenAI tool_calls deltas or decided free text of one
        ToolCallStreamParser, and its final record the parsed
        `tool_calls` (:3044-3098)."""
        if trace_ctx is None:
            trace_ctx = (new_trace_id(), 0)
        if payload.get("num_beams") is not None:
            raise ValueError(
                "num_beams does not compose with streaming (beams are "
                "ranked whole sequences; request them unstreamed)"
            )
        tool_ctx = self._tool_context(payload)
        tokens, max_new, stop, samp = self._parse(payload)
        self._tool_constraint(samp, tool_ctx)
        want_lps = self._check_logprobs(payload)
        tlk = self._check_top_logprobs(payload, want_lps)
        n, best_of = self._parse_n(payload, samp)
        if n != 1 or best_of != 1:
            raise ValueError("streaming does not support n/best_of > 1")
        scanner = None
        streamed: list = []
        if tool_ctx is not None and tool_ctx.pattern is not None:
            scanner = ToolCallStreamParser(tool_ctx.mode)
        stream = self.generate_stream(
            tokens, max_new, timeout=payload.get("timeout"), stop=stop,
            return_logprobs=True, trace_ctx=trace_ctx, tenant=tenant,
            **samp,
        )
        tid = trace_ctx[0]
        for kind, val in stream:
            if kind == "delta":
                rec: Dict[str, Any] = {"tokens": val, "trace_id": tid}
                if scanner is not None:
                    streamed.extend(val)
                    ts = events_to_stream(scanner.feed(safe_stream_text(
                        self.tokenizer.decode(streamed)
                    )))
                    if ts is not None:
                        rec["tool_stream"] = ts
                yield rec
            else:
                out, lps, plp, tlp = val
                final: Dict[str, Any] = {"done": True, "tokens": out,
                                         "trace_id": tid}
                if want_lps:
                    final["logprobs"] = lps
                if tlk and tlp is not None:
                    final["top_logprobs"] = self._render_tlp(tlp, tlk)
                if plp is not None:
                    final["prompt_logprobs"] = _render_plp(plp)
                if self.tokenizer is not None:
                    final["text"] = self.tokenizer.decode(out)
                    if scanner is not None:
                        # The final (stop-trimmed) text settles the scan:
                        # tail events ride the final record with the
                        # complete parsed call list.
                        ts = events_to_stream(scanner.feed(final["text"]))
                        if ts is not None:
                            final["tool_stream"] = ts
                        calls = scanner.result()
                        self._tool_outcome(final["text"], calls)
                        if calls is not None:
                            final["tool_calls"] = calls
                yield final

    # ---- OpenAI-compatible facade -----------------------------------

    def _to_native(self, payload: dict, chat: bool,
                   tenant: Optional[str]):
        # OpenAI requests may carry the tenant as `user`; the header wins.
        if tenant is None and payload.get("user"):
            tenant = str(payload["user"])
        native = (chat_to_native(payload, self.tokenizer) if chat
                  else completion_to_native(payload, self.tokenizer))
        return native, tenant

    def _prompt_lp_capable(self) -> bool:
        """Whether the engine scores prompts: a prefix-cached prefill
        skips exactly the forward passes that would score the prefix."""
        return (hasattr(self.engine, "finished_prompt_logprobs")
                and not getattr(self.engine, "prefix_cache", False))

    def handle_openai(self, payload: dict, chat: bool,
                      trace_ctx: Optional[Tuple[str, int]] = None,
                      tenant: Optional[str] = None) -> dict:
        native, tenant = self._to_native(payload, chat, tenant)
        echo = bool(native.pop("echo", False))
        if native.get("prompt_logprobs") and not self._prompt_lp_capable():
            raise ValueError(
                "echo with logprobs is unavailable on this server: the "
                "engine cannot score prompts (a prefix-cached prefill "
                "skips the scoring forwards)"
            )
        tokens = self._parse(native)[0]
        # Hand handle() the ids so the prompt is not tokenized twice.
        native.pop("text", None)
        native["tokens"] = [int(t) for t in tokens]
        max_new = int(native.get("max_new", 32))
        result = self.handle(native, trace_ctx=trace_ctx, tenant=tenant)
        return completion_response(
            result, model=self.model_name, prompt_tokens=len(tokens),
            max_new=max_new, tokenizer=self.tokenizer, chat=chat,
            echo=echo, prompt_ids=[int(t) for t in tokens],
        )

    def handle_openai_stream(self, payload: dict, chat: bool,
                             trace_ctx: Optional[Tuple[str, int]] = None,
                             tenant: Optional[str] = None):
        """Yield OpenAI SSE chunk objects (the HTTP layer frames them as
        `data:` lines and appends [DONE]); each carries the trace_id."""
        if trace_ctx is None:
            trace_ctx = (new_trace_id(), 0)
        native, tenant = self._to_native(payload, chat, tenant)
        if native.pop("echo", False):
            raise ValueError(
                "echo does not compose with streaming (the prompt is "
                "known to the client; request it unstreamed)"
            )
        native.pop("prompt_logprobs", None)
        max_new = int(native.get("max_new", 32))
        translator = StreamTranslator(
            model=self.model_name, tokenizer=self.tokenizer, chat=chat,
            # Tool-enabled chat streams translate the server's
            # tool_stream scan, not the raw token text.
            tool_mode=bool(native.get("tools"))
            and native.get("tool_choice") != "none",
        )
        for record in self.handle_stream(native, trace_ctx=trace_ctx,
                                         tenant=tenant):
            for chunk in translator.feed(record, max_new):
                chunk["trace_id"] = trace_ctx[0]
                yield chunk

    def close(self):
        """Stop the scheduler, fail whatever is still pending, and free
        the graphs and caches of every generation whose thread exited."""
        with self._lock:
            self._closed.set()
            g = self._g
            g.stop.set()
        g.thread.join(timeout=2)
        with self._lock:
            self._fail_pending_locked(
                "server closed before the request completed"
            )
            if g not in self._retired:
                self._retired.append(g)
        self._reap_retired()


def make_http_server(server: InferenceServer, host: str = "127.0.0.1",
                     port: int = 0) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, obj: dict, headers: dict = None):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_unavailable(self, e: ServerUnavailable,
                              openai: bool = False,
                              trace_id: Optional[str] = None):
            err = ({"error": {"message": str(e),
                              "type": "overloaded_error"}}
                   if openai else {"error": str(e)})
            headers = {
                "Retry-After": str(max(1, int(round(e.retry_after)))),
            }
            if trace_id is not None:
                headers[REQUEST_ID_HEADER] = trace_id
            self._send(e.http_status, err, headers=headers)

        def _send_unported(self, e: NotImplementedError,
                           openai: bool = False,
                           trace_id: Optional[str] = None):
            msg = str(e) or "not ported yet"
            err = ({"error": {"message": msg,
                              "type": "not_implemented_error"}}
                   if openai else {"error": msg})
            self._send(501, err, headers=(
                {REQUEST_ID_HEADER: trace_id} if trace_id else None))

        def do_GET(self):
            rid_hdr = {REQUEST_ID_HEADER:
                       adopt_trace(self.headers.get(TRACE_HEADER))[0]}
            if self.path == "/v1/models":
                self._send(200, {
                    "object": "list",
                    "data": [{
                        "id": server.model_name, "object": "model",
                        "owned_by": "shellac_tpu",
                    }],
                }, headers=rid_hdr)
            elif self.path == "/health":
                # 200 only while serving; recovering, draining and
                # failed answer 503 with the reason in the body.
                h = server.health()
                self._send(200 if h["ok"] else 503, h, headers=rid_hdr)
            elif self.path == "/stats":
                eng = server.engine
                self._send(200, {
                    **eng.stats,
                    "pending": eng.pending,
                    "slots_busy": sum(r is not None for r in eng._slots),
                    "n_slots": eng.n_slots,
                    "cache_backend": eng.cache_backend.name,
                    "decode_ticks": eng.decode_ticks,
                    "decode_ticks_source": getattr(
                        eng, "decode_ticks_source", "fixed"),
                    "overlap_decode": bool(
                        getattr(eng, "overlap_decode", False)),
                    "overlap_prefill": bool(
                        getattr(eng, "overlap_prefill", False)),
                    "prefill_chunk_source": getattr(
                        eng, "prefill_chunk_source", "fixed"),
                    # Supervisor state: /stats stays 200 through an
                    # outage; readiness lives at /health.
                    "role": server.role,
                    "status": server.status,
                    "fatal": server._fatal,
                    "restarts": server.restarts,
                    "generation": server._g.gen,
                    "shed": server.shed,
                    "uptime_s": round(server.uptime_s, 3),
                    # QoS tenants are not ported: the reference's
                    # untenanted answer.
                    "qos": {},
                    **server.latency_summary(),
                }, headers=rid_hdr)
            elif self.path == "/metrics":
                if not server.metrics_enabled:
                    self._send(404, {
                        "error": "metrics disabled (serve --no-metrics)",
                    }, headers=rid_hdr)
                    return
                body = server.metrics_text().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8",
                )
                self.send_header("Content-Length", str(len(body)))
                for k, v in rid_hdr.items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)
            elif self.path.startswith("/kv/"):
                self._send_unported(NotImplementedError(
                    "the KV fabric (/kv/*) is not ported yet"),
                    trace_id=rid_hdr[REQUEST_ID_HEADER])
            elif self.path.startswith("/debug/"):
                if not server.debug_enabled:
                    self._send(404, {
                        "error": "debug endpoints disabled "
                                 "(serve --no-debug)",
                    }, headers=rid_hdr)
                elif self.path == "/debug/requests":
                    self._send(200, server.debug_requests(),
                               headers=rid_hdr)
                elif self.path.startswith("/debug/incident"):
                    self._send_unported(NotImplementedError(
                        "incident bundles are not ported yet"),
                        trace_id=rid_hdr[REQUEST_ID_HEADER])
                elif self.path.startswith("/debug/request/"):
                    tid = self.path[len("/debug/request/"):]
                    out = server.debug_request(tid)
                    if out is None:
                        self._send(404, {
                            "error": f"no recorded events for trace id "
                                     f"{tid!r} (finished long ago, "
                                     "evicted from the ring, or never "
                                     "seen)",
                        }, headers=rid_hdr)
                    else:
                        self._send(200, out, headers=rid_hdr)
                else:
                    self._send(404, {"error": "not found"},
                               headers=rid_hdr)
            else:
                self._send(404, {"error": "not found"}, headers=rid_hdr)

        def _stream(self, payload: dict, tctx: Tuple[str, int],
                    tenant: Optional[str] = None):
            # Newline-delimited JSON, no Content-Length: the connection
            # closes at the end of the stream.
            lines = server.handle_stream(payload, trace_ctx=tctx,
                                         tenant=tenant)
            try:
                first = next(lines)  # parse errors surface before 200
            except StopIteration:
                first = None
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header(REQUEST_ID_HEADER, tctx[0])
            self.end_headers()
            rest = (itertools.chain([first], lines) if first is not None
                    else lines)
            try:
                for obj in rest:
                    self.wfile.write((json.dumps(obj) + "\n").encode())
                    self.wfile.flush()
            except OSError:
                # The client hung up mid-stream (the cancel path: the
                # generator's teardown posts the cancel marker).
                pass
            except (ValueError, TimeoutError, RuntimeError) as e:
                # Headers are gone: report in-band and close.
                try:
                    self.wfile.write(
                        (json.dumps(stream_error_payload(
                            e, trace_id=tctx[0])) + "\n").encode()
                    )
                except OSError:
                    pass
            finally:
                lines.close()

        def _stream_sse(self, payload: dict, chat: bool,
                        tctx: Tuple[str, int],
                        tenant: Optional[str] = None):
            # OpenAI Server-Sent Events: one `data: <json>` line per
            # chunk, blank-line separated, closed by `data: [DONE]`.
            chunks = server.handle_openai_stream(payload, chat,
                                                 trace_ctx=tctx,
                                                 tenant=tenant)
            try:
                first = next(chunks, None)  # errors surface before 200
            except (ValueError, TimeoutError) as e:
                self._send(400, {"error": {"message": str(e),
                                           "type": "invalid_request_error"}},
                           headers={REQUEST_ID_HEADER: tctx[0]})
                return
            except ServerUnavailable as e:
                self._send_unavailable(e, openai=True, trace_id=tctx[0])
                return
            except NotImplementedError as e:
                self._send_unported(e, openai=True, trace_id=tctx[0])
                return
            except RuntimeError as e:
                self._send(500, {"error": {"message": str(e),
                                           "type": "server_error"}},
                           headers={REQUEST_ID_HEADER: tctx[0]})
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header(REQUEST_ID_HEADER, tctx[0])
            self.end_headers()
            rest = (itertools.chain([first], chunks) if first is not None
                    else chunks)
            try:
                for obj in rest:
                    self.wfile.write(
                        f"data: {json.dumps(obj)}\n\n".encode()
                    )
                    self.wfile.flush()
                self.wfile.write(b"data: [DONE]\n\n")
            except OSError:
                pass  # client hung up: the engine-side cancel fires
            except (ValueError, TimeoutError, RuntimeError) as e:
                try:
                    err = stream_error_payload(e, trace_id=tctx[0])
                    self.wfile.write(f"data: {json.dumps(err)}\n\n".encode())
                except OSError:
                    pass
            finally:
                chunks.close()

        def do_POST(self):
            # The trace id is adopted from x-shellac-trace or minted, and
            # echoed on every response as x-request-id.
            tctx = adopt_trace(self.headers.get(TRACE_HEADER))
            rid_hdr = {REQUEST_ID_HEADER: tctx[0]}
            tenant = (self.headers.get(TENANT_HEADER) or "").strip() or None
            if self.path.startswith("/debug/"):
                if not server.debug_enabled:
                    self._send(404, {"error": "debug endpoints disabled "
                                              "(serve --no-debug)"},
                               headers=rid_hdr)
                else:
                    self._send_unported(NotImplementedError(
                        f"POST {self.path.split('?')[0]} (profiles and "
                        "incident bundles) is not ported yet"),
                        trace_id=tctx[0])
                return
            if self.path.startswith("/kv/"):
                self._send_unported(NotImplementedError(
                    "the KV fabric (/kv/*) is not ported yet"),
                    trace_id=tctx[0])
                return
            if self.path == "/drain":
                # Begin (or with {"resume": true} cancel) a graceful
                # drain; callers poll /health until pending reaches 0.
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:
                    payload = None
                if not isinstance(payload, dict):
                    self._send(400, {"error": "bad drain payload"},
                               headers=rid_hdr)
                    return
                self._send(200, server.resume_admission()
                           if payload.get("resume") else server.drain(),
                           headers=rid_hdr)
                return
            openai_routes = {
                "/v1/completions": False,
                "/v1/chat/completions": True,
            }
            if self.path not in ("/generate", *openai_routes):
                self._send(404, {"error": "not found"}, headers=rid_hdr)
                return
            openai = self.path in openai_routes
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("payload must be a JSON object")
                if openai:
                    chat = openai_routes[self.path]
                    if payload.get("stream"):
                        self._stream_sse(payload, chat, tctx,
                                         tenant=tenant)
                    else:
                        self._send(200,
                                   server.handle_openai(
                                       payload, chat, trace_ctx=tctx,
                                       tenant=tenant),
                                   headers=rid_hdr)
                elif payload.get("stream"):
                    self._stream(payload, tctx, tenant=tenant)
                else:
                    self._send(200,
                               server.handle(payload, trace_ctx=tctx,
                                             tenant=tenant),
                               headers=rid_hdr)
            except (ValueError, TimeoutError) as e:
                err = {"error": str(e)}
                if openai:
                    # OpenAI clients expect the nested error shape.
                    err = {"error": {"message": str(e),
                                     "type": "invalid_request_error"}}
                self._send(400, err, headers=rid_hdr)
            except ServerUnavailable as e:
                # Backpressure: 429 or 503 with Retry-After, before the
                # RuntimeError arm would misreport it as a 500.
                self._send_unavailable(e, openai=openai, trace_id=tctx[0])
            except NotImplementedError as e:
                # A feature this port does not have yet: 501, before the
                # RuntimeError arm (NotImplementedError is one).
                self._send_unported(e, openai=openai, trace_id=tctx[0])
            except RuntimeError as e:
                self._send(500, {"error": str(e)}, headers=rid_hdr)

    return ThreadingHTTPServer((host, port), Handler)


def serve(cfg: ModelConfig, params, *, host="127.0.0.1", port=8000,
          tokenizer=None, **engine_kw):
    """Blocking entry point used by the CLI: prints one
    {"serving": "http://host:port"} line, then serves until interrupted."""
    srv = InferenceServer(cfg, params, tokenizer=tokenizer, **engine_kw)
    httpd = make_http_server(srv, host, port)
    print(json.dumps({"serving": f"http://{host}:{httpd.server_address[1]}"}),
          flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        srv.close()
