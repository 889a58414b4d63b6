"""Request-trace spans and the serving/engine instrument bundles.

A `RequestTrace` rides one request through the serving pipeline —
submit -> queue wait -> prefill -> first token -> per-token decode ->
finish/shed/abort — and deposits the derived latency histograms
(queue-wait, TTFT, time-per-output-token, end-to-end) on settlement.
Every timestamp is host-side `time.monotonic()` captured at an event
the host already observes (queue pop, post-sync token arrival), so
tracing adds no host-device syncs anywhere, let alone inside a captured
decode graph.

`ServeMetrics` / `EngineMetrics` bundle the instruments each layer
writes so the metric names and bucket layouts are defined exactly once;
both are cheap to construct repeatedly over the same registry
(registration is idempotent).

The port's own copy of `shellac_tpu/obs/trace.py` (`ServeMetrics` :66,
`RequestTrace` :277, `EngineMetrics` :515): the same metric names, help
strings, labels and buckets (`docs/observability.md` is their catalog).
`TierMetrics` belongs to the fleet layer and is not ported yet.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from shellac_tpu_torch.obs.metrics import (
    Registry,
    linear_buckets,
    log_buckets,
)

#: Latency buckets shared by the request-span histograms: ~1ms..60s.
LATENCY_BUCKETS = log_buckets(0.001, 60.0, per_decade=4)
#: Per-output-token pace is faster than request latency: ~0.1ms..10s.
TPOT_BUCKETS = log_buckets(0.0001, 10.0, per_decade=4)
#: Batch occupancy is a ratio; eighths resolve typical slot counts.
OCCUPANCY_BUCKETS = linear_buckets(0.125, 0.125, 8)

#: Step-time phases (the `phase` label of shellac_step_phase_seconds).
#: Every engine step's wall time decomposes into exactly these, so
#: sum-over-phases ≈ step wall time and "where does the tick go" is a
#: committed measurement (the disaggregation question's input):
#:   admission        — queue pops, slot prep, finish checks in the
#:                      fill loop (everything admission-side that is
#:                      NOT the prefill programs themselves)
#:   prefill_dispatch — prefill/chunk program dispatches (host-side
#:                      dispatch cost only; with overlapped prefill
#:                      the sync moved to prefill_settle)
#:   prefill_settle   — time blocked in the prefill settle's one
#:                      batched host pull plus its host bookkeeping
#:                      (inline per admission without overlap_prefill;
#:                      one batched pull per step boundary with it)
#:   decode_sync      — time blocked in the decode window's one
#:                      packed host pull
#:   settle           — applying synced window results: detokenize
#:                      appends, finish checks, slot release
#:   host_bookkeeping — the remainder (dispatch bookkeeping, gauge
#:                      updates, scheduler glue)
STEP_PHASES = ("admission", "prefill_dispatch", "prefill_settle",
               "decode_sync", "settle", "host_bookkeeping")

#: Request outcomes (the `outcome` label of shellac_requests_total).
#: ok: completed; shed: deadline expired before prefill; cancelled:
#: client abandoned it; error: bad request; fault: server-side failure
#: (scheduler death, wedge, close) — the supervisor's loud-failure arm.
OUTCOMES = ("ok", "shed", "cancelled", "error", "fault")


class ServeMetrics:
    """The serving-layer instruments over one registry."""

    def __init__(self, registry: Registry):
        self.registry = registry
        h, c, g = registry.histogram, registry.counter, registry.gauge
        self.ttft = h(
            "shellac_ttft_seconds",
            "Time from request submit to its first generated token",
            buckets=LATENCY_BUCKETS,
        )
        self.tpot = h(
            "shellac_tpot_seconds",
            "Mean time per output token after the first, per request",
            buckets=TPOT_BUCKETS,
        )
        self.queue_wait = h(
            "shellac_queue_wait_seconds",
            "Time from request submit to the start of its prefill",
            buckets=LATENCY_BUCKETS,
        )
        self.e2e = h(
            "shellac_e2e_seconds",
            "End-to-end request latency (submit to completion)",
            buckets=LATENCY_BUCKETS,
        )
        # The tenant label is "" for traffic that carried no tenant id
        # (matching Registry.get's empty-string default, so untenanted
        # deployments keep their exact-key lookups and dashboards).
        self.requests = c(
            "shellac_requests_total",
            "Requests settled, by outcome (ok|shed|cancelled|error|"
            "fault) and tenant (empty for untenanted traffic)",
            labels=("outcome", "tenant"),
        )
        self.sheds = c(
            "shellac_requests_shed_total",
            "Requests shed on an expired deadline before prefill",
        )
        self.rejects = c(
            "shellac_admission_rejects_total",
            "Submissions refused at admission, by reason "
            "(overloaded|recovering|draining|throttled) and tenant "
            "(empty for untenanted traffic)",
            labels=("reason", "tenant"),
        )
        self.restarts = c(
            "shellac_supervisor_restarts_total",
            "Engine generations rebuilt by the serving supervisor",
        )
        self.generation = g(
            "shellac_engine_generation",
            "Current engine generation (bumps on supervisor rebuild)",
        )
        self.draining = g(
            "shellac_draining",
            "1 while a graceful drain is in progress (admission "
            "refused, in-flight requests completing), else 0",
        )
        self.uptime = g(
            "shellac_uptime_seconds", "Seconds since the server started"
        )
        self.pending = g(
            "shellac_pending_requests", "Requests currently pending"
        )
        self.constraint_compile = h(
            "shellac_constraint_compile_seconds",
            "Schema/regex -> token-DFA compile latency (paid on "
            "constraint-cache misses only)",
            buckets=LATENCY_BUCKETS,
        )
        self.constraint_cache = c(
            "shellac_constraint_cache_total",
            "Constraint DFA cache lookups, by result (hit|miss)",
            labels=("result",),
        )
        self.cache_backend_info = g(
            "shellac_engine_cache_backend_info",
            "Info gauge: always 1, labeled with the engine's active "
            "KV-cache storage backend (registry name, e.g. dense, "
            "paged-int8) so dashboards can group replicas by storage "
            "policy",
            labels=("backend",),
        )
        self.tool_requests = c(
            "shellac_tool_requests_total",
            "Tool-enabled requests by resolution: call (tool_calls "
            "parsed), text (auto chose free text), truncated (tool "
            "branch cut by the token budget)",
            labels=("outcome",),
        )
        self.role_info = g(
            "shellac_engine_role_info",
            "Info gauge: always 1, labeled with this replica's serving "
            "role (prefill | decode | monolith) — the tier's "
            "disaggregated pair scheduler groups replicas by it",
            labels=("role",),
        )
        self.migrations = c(
            "shellac_migrations_total",
            "KV-migration legs by outcome. Replica-side: export / "
            "export_failed (serialize+push from a prefill replica), "
            "import / import_failed (adoption on a decode replica). "
            "Tier-side: ok (full disaggregated path served), "
            "fallback_* (served monolithically: no_pair | cost | "
            "feature | failed)",
            labels=("outcome",),
        )
        self.kv_transfer_seconds = h(
            "shellac_kv_transfer_seconds",
            "Wall time of one KV-migration push (serialize excluded: "
            "POST /kv/import dispatch to the decode replica's ack)",
            buckets=LATENCY_BUCKETS,
        )
        self.kv_transfer_bytes = h(
            "shellac_kv_transfer_bytes",
            "Serialized size of one KV-migration blob (header + "
            "chunked device-block payload)",
            buckets=log_buckets(1e3, 1e9, per_decade=2),
        )
        self.fabric_seeded = c(
            "shellac_fabric_seeded_blocks_total",
            "Prefix-cache blocks registered from fleet seed pushes "
            "(POST /kv/seed) — KV this replica now serves without "
            "ever having prefilled it",
        )
        self.fabric_seed_rejects = c(
            "shellac_fabric_seed_rejects_total",
            "Seed blobs refused at the door with the registry "
            "untouched, by reason (corrupt|mismatch|exhausted|fault)",
            labels=("reason",),
        )
        self.fabric_parked = c(
            "shellac_fabric_parked_total",
            "Frozen sessions exported to the KV park spool",
        )
        self.fabric_resumed = c(
            "shellac_fabric_resumed_total",
            "Park-spool resume attempts, by outcome (ok: imported and "
            "adopted; missing: unknown park id; torn: blob failed "
            "integrity read-back and was quarantined)",
            labels=("outcome",),
        )
        self.fabric_park_bytes = g(
            "shellac_fabric_park_bytes",
            "Bytes currently resident in this replica's KV park spool "
            "(size-capped; LRU-trimmed on write)",
        )
        # Per-tenant QoS series. Unlike the widened request/reject
        # counters above, these key the RESOLVED tenant ("anonymous"
        # when no id rode the request), so a tenants dashboard always
        # accounts for every token served.
        self.tenant_tokens = c(
            "shellac_tenant_tokens_admitted_total",
            "Tokens admitted past per-tenant quota (prompt + budgeted "
            "max_new, the same cost the token bucket charges), by "
            "resolved tenant",
            labels=("tenant",),
        )
        self.tenant_throttles = c(
            "shellac_tenant_throttles_total",
            "Per-tenant quota rejections (HTTP 429 + Retry-After), by "
            "tenant and exhausted budget (rate|concurrency)",
            labels=("tenant", "reason"),
        )
        self.tenant_preemptions = c(
            "shellac_tenant_preemptions_total",
            "Requests frozen mid-decode and parked so a higher-"
            "priority class could take the slot, by victim tenant",
            labels=("tenant",),
        )
        self.tenant_parked_bytes = g(
            "shellac_tenant_parked_bytes",
            "Bytes of preempted KV currently parked awaiting resume, "
            "by victim tenant (measured blob size, the preemption "
            "cost model's input)",
            labels=("tenant",),
        )
        self.tenant_sheds = c(
            "shellac_tenant_sheds_total",
            "Deadline sheds by resolved tenant (the unlabeled "
            "shellac_requests_shed_total keeps the fleet total)",
            labels=("tenant",),
        )
        self._engine_stats: Dict[str, object] = {}

    def trace(self, trace_id: Optional[str] = None,
              recorder=None, tenant: Optional[str] = None
              ) -> "RequestTrace":
        """A span for one request. `trace_id` links the span to the
        distributed trace (the tier/header id); `recorder` is the
        server's FlightRecorder — when both are set the span's event
        methods also deposit timeline events, and the latency
        histograms retain the id as a per-bucket exemplar. `tenant`
        (None for untenanted traffic) labels the settlement counters."""
        return RequestTrace(self, trace_id=trace_id, recorder=recorder,
                            tenant=tenant)

    def engine_stat(self, key: str):
        """Scrape-time gauge mirroring one engine `stats` counter as
        `shellac_engine_<key>` (keys are code-side identifiers, so the
        name is exposition-safe by construction)."""
        gauge = self._engine_stats.get(key)
        if gauge is None:
            gauge = self.registry.gauge(
                f"shellac_engine_{key}", f"Engine stats counter {key!r}"
            )
            self._engine_stats[key] = gauge
        return gauge


class RequestTrace:
    """Span recorder for ONE request. Event methods are idempotent (the
    first call wins) and `finish`/`shed`/`abort` settle the trace
    exactly once — late duplicate settlement from racing sweeps (close
    vs a final delivery) is ignored, mirroring the server's own
    pop-arbitrated settlement."""

    __slots__ = ("_m", "t_submit", "t_prefill", "t_first", "t_done",
                 "n_tokens", "outcome", "trace_id", "recorder", "tenant")

    def __init__(self, metrics: ServeMetrics,
                 trace_id: Optional[str] = None, recorder=None,
                 tenant: Optional[str] = None):
        self._m = metrics
        # Distributed-trace identity (obs.events.new_trace_id shape) and
        # the flight recorder the span's events feed. Both optional:
        # a bare trace()/RequestTrace() records spans only, exactly the
        # pre-tracing behavior.
        self.trace_id = trace_id
        self.recorder = recorder
        # Tenant id the request carried (None when untenanted): labels
        # the settlement counters and surfaces in /debug/requests.
        self.tenant = tenant
        self.t_submit = time.monotonic()
        self.t_prefill: Optional[float] = None
        self.t_first: Optional[float] = None
        self.t_done: Optional[float] = None
        self.n_tokens = 0
        self.outcome: Optional[str] = None

    def record(self, event: str, **fields) -> None:
        """Deposit one flight-recorder event under this span's trace
        id. A no-op without a recorder, so engine/server call sites
        need no branching."""
        if self.recorder is not None:
            self.recorder.record(self.trace_id, event, **fields)

    # ---- pipeline events (called by the engine-owning thread) --------

    def prefill_start(self) -> None:
        """Queue wait ends: the scheduler popped this request into a
        slot and is about to prefill it."""
        if self.t_prefill is not None:
            return
        self.t_prefill = time.monotonic()
        wait = self.t_prefill - self.t_submit
        self._m.queue_wait.observe(wait, exemplar=self.trace_id)
        self.record("prefill", src="engine", queue_wait_s=round(wait, 6))

    def first_token(self) -> None:
        """The first generated token exists host-side (prefill sampled
        it): the TTFT point."""
        if self.t_first is not None:
            return
        self.t_first = time.monotonic()
        ttft = self.t_first - self.t_submit
        self._m.ttft.observe(ttft, exemplar=self.trace_id)
        self.record("first-token", src="engine", ttft_s=round(ttft, 6))

    # ---- settlement --------------------------------------------------

    def _settle(self, outcome: str) -> bool:
        if self.outcome is not None:
            return False
        self.outcome = outcome
        self.t_done = time.monotonic()
        self._m.requests.labels(outcome=outcome,
                                tenant=self.tenant or "").inc()
        return True

    def finish(self, n_tokens: int) -> None:
        """Completed normally with `n_tokens` generated tokens."""
        if not self._settle("ok"):
            return
        self.n_tokens = int(n_tokens)
        e2e = self.t_done - self.t_submit
        self._m.e2e.observe(e2e, exemplar=self.trace_id)
        if self.t_first is not None and self.n_tokens > 1:
            self._m.tpot.observe(
                (self.t_done - self.t_first) / (self.n_tokens - 1),
                exemplar=self.trace_id,
            )
        self.record("finish", src="server", n_tokens=self.n_tokens,
                    e2e_s=round(e2e, 6))

    def shed(self) -> None:
        """Deadline expired before prefill; the scheduler dropped it."""
        if self._settle("shed"):
            self._m.sheds.inc()
            if self.tenant:
                self._m.tenant_sheds.labels(tenant=self.tenant).inc()
            self.record("shed", src="server")

    def abort(self, outcome: str = "cancelled") -> None:
        """Any non-ok, non-shed settlement: cancelled | error | fault."""
        if self._settle(outcome):
            self.record(outcome, src="server")


class EngineMetrics:
    """The engine-layer instruments: batch occupancy, prefill vs decode
    section durations, and cache-utilization gauges. All writes happen
    from the engine-owning thread, once per engine STEP (host code,
    after the step's own host sync) — never per token and never inside
    a captured decode graph."""

    def __init__(self, registry: Registry):
        self.registry = registry
        h, g = registry.histogram, registry.gauge
        self.prefill_seconds = h(
            "shellac_prefill_seconds",
            "Wall time of one engine step's prefill section (all "
            "prefill/chunk programs it ran)",
            buckets=LATENCY_BUCKETS,
        )
        self.decode_window_seconds = h(
            "shellac_decode_window_seconds",
            "Wall time of one decode window, dispatch to results-on-"
            "host (under overlapped dispatch this spans the host work "
            "interleaved with the window — the overlapped reality)",
            buckets=LATENCY_BUCKETS,
        )
        self.host_overhead = h(
            "shellac_decode_host_overhead_seconds",
            "Per engine step that synced a decode window: step wall "
            "time minus time blocked awaiting window results — the "
            "host-side share of the tick (scheduling, settlement, "
            "prefill dispatch). A replica whose overhead rivals its "
            "window time is host-bound, not device-bound",
            buckets=LATENCY_BUCKETS,
        )
        self.step_phase = h(
            "shellac_step_phase_seconds",
            "Per engine step: wall time attributed to one phase of "
            "the tick (admission | prefill_dispatch | prefill_settle "
            "| decode_sync | settle | host_bookkeeping — see "
            "obs.STEP_PHASES). "
            "Observed once per phase per non-idle step, so the "
            "per-phase _sum series divide the step loop's wall time "
            "exactly and 'prefill stalls decode windows' is a "
            "measurement, not a claim",
            labels=("phase",),
            buckets=TPOT_BUCKETS,
        )
        self.occupancy = h(
            "shellac_batch_occupancy",
            "Active slots / n_slots at each decode window",
            buckets=OCCUPANCY_BUCKETS,
        )
        self.slots_busy = g(
            "shellac_slots_busy", "Slots currently holding a request"
        )
        self.queue_depth = g(
            "shellac_engine_queue_depth",
            "Requests admitted but not yet in a slot",
        )
        self.kv_util = g(
            "shellac_kv_utilization",
            "Live KV tokens / capacity (dense) or pool blocks in use / "
            "pool size (paged)",
        )
        self.prefix_blocks = g(
            "shellac_prefix_cache_blocks",
            "Blocks currently registered in the prefix cache (paged "
            "engines with prefix_cache=True)",
        )
