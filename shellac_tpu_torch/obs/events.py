"""Flight recorder + trace-id plumbing for distributed request tracing.

The port's own copy of `shellac_tpu/obs/events.py` (`new_trace_id` :49,
the header helpers, `adopt_trace` :90, `FlightRecorder` :99), kept as a
copy because the port imports nothing of the JAX package.

Two small, dependency-free pieces:

  trace ids — every request is identified by one W3C-traceparent-shaped
    id (`00-<32 hex>-<16 hex>-01`) minted by whichever layer sees the
    request first (the tier router, the HTTP handler, or `_submit` for
    direct library callers). The id travels replica-ward in an
    `x-shellac-trace` request header carrying the tier's attempt
    number (`<traceparent>;attempt=N`) and client-ward in an
    `x-request-id` response header and inside ndjson/SSE stream
    records — so the tier's attempt log, the replica's request span,
    the flight-recorder timeline, and the client's error report all
    quote the SAME id.

  `FlightRecorder` — a bounded ring buffer of structured lifecycle
    events (admit / queue / prefill / first-token / window-dispatch /
    window-settle / finish / shed / cancelled / error / fault, plus the
    tier's tier-attempt / retry / eject family). Appends are a lock +
    deque op; when the ring is full the OLDEST event is dropped and a
    counter (`shellac_flight_recorder_dropped_total`) says so — the
    recorder degrades by forgetting history, never by blocking the
    serving path. `GET /debug/requests` reads the ring's stats and
    tail; `GET /debug/request/<trace_id>` filters it into one
    request's timeline.

Events deliberately carry NO prompt or generated text unless the
server was started with `--debug-include-text` (redaction by default:
a debug endpoint must not become a transcript exfiltration path).
"""

from __future__ import annotations

import os
import re
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

#: Request-header name the tier forwards (and any front-end may set).
TRACE_HEADER = "x-shellac-trace"
#: Response-header name every layer echoes the trace id back on.
REQUEST_ID_HEADER = "x-request-id"

_TRACEPARENT_RE = re.compile(r"^00-[0-9a-f]{32}-[0-9a-f]{16}-[0-9a-f]{2}$")


def new_trace_id() -> str:
    """Mint a W3C-traceparent-shaped trace id: version 00, a 16-byte
    random trace-id field, an 8-byte random parent-id field, sampled
    flag set. Shaped like traceparent so a fronting proxy that speaks
    W3C trace context can adopt it verbatim; no OpenTelemetry
    dependency is involved."""
    return f"00-{os.urandom(16).hex()}-{os.urandom(8).hex()}-01"


def is_trace_id(value: str) -> bool:
    return bool(_TRACEPARENT_RE.match(value or ""))


def format_trace_header(trace_id: str, attempt: int = 0) -> str:
    """The `x-shellac-trace` wire value: the id plus the tier attempt
    number (0 = first attempt), so a replica's logs say not just WHICH
    request hit it but which retry leg it served."""
    return f"{trace_id};attempt={int(attempt)}"


def parse_trace_header(value: Optional[str]) -> Tuple[Optional[str], int]:
    """Parse an `x-shellac-trace` value -> (trace_id, attempt).
    Returns (None, 0) when absent or malformed — the caller mints a
    fresh id instead of 400ing: tracing must never reject traffic."""
    if not value:
        return None, 0
    parts = str(value).strip().split(";")
    tid = parts[0].strip().lower()
    if not is_trace_id(tid):
        return None, 0
    attempt = 0
    for part in parts[1:]:
        part = part.strip()
        if part.startswith("attempt="):
            try:
                attempt = max(0, int(part[len("attempt="):]))
            except ValueError:
                pass
    return tid, attempt


def adopt_trace(value: Optional[str]) -> Tuple[str, int]:
    """Adopt the incoming header's (trace_id, attempt), minting a fresh
    id when the header is absent or malformed."""
    tid, attempt = parse_trace_header(value)
    if tid is None:
        return new_trace_id(), attempt
    return tid, attempt


class FlightRecorder:
    """Bounded ring of structured lifecycle events.

    Writers (admission, the scheduler/engine thread, tier request
    threads, the health poller) call `record()`; readers (the /debug
    endpoints, tests) call `events_for()` / `tail()` / `stats()`.
    Everything is guarded by one lock — appends are O(1) and reads
    copy, so a scrape can never tear a writer.

    `enabled=False` (serve --no-debug) turns every record() into a
    single attribute check, mirroring the disabled-Registry pattern.

    `spool` (an obs.spool.EventSpool) is the durable half: every
    recorded event is also appended to the on-disk JSONL spool, so a
    SIGKILL'd replica's in-flight timelines survive to disk and can
    be recovered (`top --trace <id> --spool <dir>`). The ring stays
    authoritative for the live /debug endpoints; the spool is the
    black-box recording an incident review reads after the crash.
    """

    def __init__(self, capacity: int = 2048, registry=None,
                 enabled: bool = True, spool=None):
        if capacity < 1:
            raise ValueError("recorder capacity must be >= 1")
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self.spool = spool
        self._lock = threading.Lock()
        self._events: deque = deque()
        self._seq = 0
        self.dropped = 0
        # Exposition: the ring forgetting history is an operator-visible
        # condition (a timeline may be truncated), so the drop count
        # rides /metrics next to everything else.
        self._dropped_c = None
        self._recorded_c = None
        if registry is not None:
            self._dropped_c = registry.counter(
                "shellac_flight_recorder_dropped_total",
                "Flight-recorder events evicted because the ring was "
                "full (a /debug/request timeline may be truncated)",
            )
            self._recorded_c = registry.counter(
                "shellac_flight_recorder_events_total",
                "Flight-recorder events appended",
            )

    def record(self, trace_id: Optional[str], event: str,
               **fields: Any) -> None:
        """Append one event. `trace_id=None` records a system-scoped
        event (e.g. a tier ejection) that appears in the tail feed but
        belongs to no request timeline. Extra fields must be
        JSON-serializable — they are served verbatim by /debug."""
        if not self.enabled:
            return
        with self._lock:
            self._seq += 1
            if len(self._events) >= self.capacity:
                self._events.popleft()
                self.dropped += 1
                if self._dropped_c is not None:
                    self._dropped_c.inc()
            rec: Dict[str, Any] = {
                "seq": self._seq,
                "ts": time.time(),
                "trace": trace_id,
                "event": event,
            }
            rec.update(fields)
            self._events.append(rec)
        if self._recorded_c is not None:
            self._recorded_c.inc()
        if self.spool is not None:
            # Outside the ring lock: the spool serializes itself, and
            # file IO must not extend the ring's critical section. The
            # `seq` field keeps global order recoverable either way.
            self.spool.append(rec)

    def events_for(self, trace_id: str) -> List[Dict[str, Any]]:
        """Every retained event for one trace id, oldest first ([] for
        unknown ids — and for None: system events are not a timeline).
        Falls back to the lowercased id on a miss: header adoption
        normalizes ids to lowercase, so a client that sent (and then
        queries with) uppercase hex still finds its timeline."""
        if not trace_id:
            return []
        with self._lock:
            evs = [dict(e) for e in self._events
                   if e["trace"] == trace_id]
            if not evs and trace_id.lower() != trace_id:
                low = trace_id.lower()
                evs = [dict(e) for e in self._events
                       if e["trace"] == low]
        return evs

    def tail(self, n: int = 256) -> List[Dict[str, Any]]:
        """The most recent `n` events, oldest first."""
        with self._lock:
            evs = list(self._events)
        return [dict(e) for e in evs[-max(0, int(n)):]]

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "events": len(self._events),
                "capacity": self.capacity,
                "dropped": self.dropped,
                "recorded": self._seq,
            }
