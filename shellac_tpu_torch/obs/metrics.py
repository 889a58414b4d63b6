"""Dependency-free metrics core: counters, gauges, histograms, and a
process-global registry with Prometheus text exposition.

The port's own copy of `shellac_tpu/obs/metrics.py` (`Counter` :91,
`Gauge` :108, `Histogram` :131, `_Family` :247, `Registry` :296,
`get_registry` :486): the same writes render the same exposition text,
byte for byte (`tests/test_torch_obs.py`). Kept as a copy because the
port imports nothing of the JAX package.

Design constraints (this is serving/training observability, not a
general TSDB client):

  - stdlib only — the serving path must not grow a dependency;
  - writes are cheap and host-side: an `observe()` is a bisect plus a
    few adds under a per-instrument lock, so instrumenting once per
    engine STEP (never per token, never inside a captured graph) costs
    nothing measurable;
  - a disabled registry turns every write into a single attribute
    check, so `serve --no-metrics` has near-zero overhead without any
    call-site branching;
  - registration is idempotent: asking for the same (name, kind,
    labels) returns the same instrument, so engines and servers built
    repeatedly in one process (tests, supervisor rebuilds) share
    series instead of colliding.

Histograms use fixed log-spaced buckets (`log_buckets`): latency
distributions span decades, and fixed buckets mean exposition never
reshapes under load (Prometheus requires bucket stability to compute
rates across scrapes).
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


def log_buckets(lo: float = 0.001, hi: float = 60.0,
                per_decade: int = 4) -> Tuple[float, ...]:
    """Log-spaced bucket upper bounds from `lo` to >= `hi`.

    Bounds land on 10^(k/per_decade): with the defaults that is ~1ms to
    60s at 4 buckets per decade (~20 buckets) — wide enough for TTFT on
    a cold compile and fine enough that p50/p99 interpolation is
    meaningful.
    """
    if lo <= 0 or hi <= lo:
        raise ValueError(f"need 0 < lo < hi, got lo={lo}, hi={hi}")
    if per_decade < 1:
        raise ValueError("per_decade must be >= 1")
    out: List[float] = []
    k = math.floor(math.log10(lo) * per_decade + 0.5)
    while True:
        b = 10.0 ** (k / per_decade)
        out.append(float(f"{b:.6g}"))  # kill float noise: 0.001, not 0.00099..
        if b >= hi:
            break
        k += 1
    return tuple(out)


def linear_buckets(lo: float, width: float, count: int) -> Tuple[float, ...]:
    """`count` upper bounds: lo, lo+width, ... (occupancy-style ratios)."""
    if count < 1:
        raise ValueError("count must be >= 1")
    return tuple(float(f"{lo + i * width:.6g}") for i in range(count))


def _fmt(v: float) -> str:
    """Prometheus sample value: integral floats print as integers."""
    if v != v:  # NaN
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _Instrument:
    """Common base: every instrument knows its registry so a disabled
    registry short-circuits writes with one attribute check."""

    __slots__ = ("_registry", "_lock")

    def __init__(self, registry: "Registry"):
        self._registry = registry
        self._lock = threading.Lock()


class Counter(_Instrument):
    kind = "counter"
    __slots__ = ("value",)

    def __init__(self, registry: "Registry"):
        super().__init__(registry)
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if not self._registry.enabled:
            return
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self.value += amount


class Gauge(_Instrument):
    kind = "gauge"
    __slots__ = ("value",)

    def __init__(self, registry: "Registry"):
        super().__init__(registry)
        self.value = 0.0

    def set(self, v: float) -> None:
        if not self._registry.enabled:
            return
        self.value = float(v)

    def inc(self, amount: float = 1.0) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class Histogram(_Instrument):
    """Fixed-bucket histogram with cumulative Prometheus exposition and
    host-side percentile estimates (for /stats summaries)."""

    kind = "histogram"
    __slots__ = ("uppers", "counts", "sum", "count", "_max", "exemplars")

    def __init__(self, registry: "Registry", buckets: Sequence[float]):
        super().__init__(registry)
        ups = tuple(float(b) for b in buckets)
        if not ups:
            raise ValueError("histogram needs at least one bucket")
        if any(b2 <= b1 for b1, b2 in zip(ups, ups[1:])):
            raise ValueError(f"buckets must strictly increase: {ups}")
        if any(not math.isfinite(b) for b in ups):
            raise ValueError("buckets must be finite (+Inf is implicit)")
        self.uppers = ups
        self.counts = [0] * (len(ups) + 1)  # last = +Inf overflow
        self.sum = 0.0
        self.count = 0
        self._max = float("-inf")
        # Last exemplar (an opaque label, in practice a trace id) per
        # bucket — allocated lazily on the first exemplar'd observe, so
        # histograms that never carry exemplars pay one None check.
        self.exemplars: Optional[List[Optional[str]]] = None

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        if not self._registry.enabled:
            return
        v = float(v)
        idx = bisect.bisect_left(self.uppers, v)
        with self._lock:
            self.counts[idx] += 1
            self.sum += v
            self.count += 1
            if v > self._max:
                self._max = v
            if exemplar is not None:
                if self.exemplars is None:
                    self.exemplars = [None] * (len(self.uppers) + 1)
                self.exemplars[idx] = exemplar

    def bucket_exemplars(self) -> Dict[str, str]:
        """{bucket le: last exemplar observed into that bucket} for
        buckets that have one. The resolution path from a latency
        outlier to a concrete request: the `+Inf`/top-bucket entry of a
        TTFT histogram is a trace id whose flight-recorder timeline
        (`GET /debug/request/<id>`) explains the outlier."""
        with self._lock:
            if self.exemplars is None:
                return {}
            out: Dict[str, str] = {}
            for i, ex in enumerate(self.exemplars):
                if ex is None:
                    continue
                le = ("+Inf" if i == len(self.uppers)
                      else _fmt(self.uppers[i]))
                out[le] = ex
            return out

    def cumulative_pairs(self) -> List[Tuple[float, float]]:
        """Cumulative `(le, count)` pairs including the `+Inf` edge —
        the same shape a scrape-side parser produces, so host-side
        histograms and scraped ones feed one quantile/SLO code path."""
        with self._lock:
            counts = list(self.counts)
        out: List[Tuple[float, float]] = []
        cum = 0
        for upper, c in zip(self.uppers, counts[:-1]):
            cum += c
            out.append((float(upper), float(cum)))
        out.append((float("inf"), float(cum + counts[-1])))
        return out

    def percentile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (0 < q <= 1) by linear interpolation
        within the containing bucket; None when empty. Values in the
        +Inf overflow bucket report the observed max (the honest upper
        edge a fixed-bucket histogram can state)."""
        if not 0 < q <= 1:
            raise ValueError(f"q must be in (0, 1], got {q}")
        with self._lock:
            n = self.count
            if n == 0:
                return None
            target = q * n
            cum = 0
            lo = 0.0
            for i, c in enumerate(self.counts):
                if c and cum + c >= target:
                    if i == len(self.uppers):  # overflow bucket
                        return self._max
                    hi = self.uppers[i]
                    frac = (target - cum) / c
                    return min(lo + (hi - lo) * frac, self._max)
                cum += c
                if i < len(self.uppers):
                    lo = self.uppers[i]
            return self._max  # unreachable in practice (counts sum to n)

    def summary(self) -> Dict[str, Optional[float]]:
        """The /stats-style digest: count, mean, p50/p90/p99."""
        with self._lock:
            n, s = self.count, self.sum
        return {
            "count": n,
            "mean": (s / n) if n else None,
            "p50": self.percentile(0.50),
            "p90": self.percentile(0.90),
            "p99": self.percentile(0.99),
        }


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One metric name: a kind, a help string, label names, and a
    series per label-value tuple. With no labels there is exactly one
    series, keyed by the empty tuple."""

    __slots__ = ("name", "kind", "help", "labelnames", "buckets",
                 "series", "_registry", "_lock")

    def __init__(self, registry: "Registry", name: str, kind: str,
                 help: str, labelnames: Tuple[str, ...],
                 buckets: Optional[Tuple[float, ...]]):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = labelnames
        self.buckets = buckets
        self.series: Dict[Tuple[str, ...], _Instrument] = {}
        self._registry = registry
        self._lock = threading.Lock()

    def labels(self, **labelvalues) -> _Instrument:
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(labelvalues))}"
            )
        key = tuple(str(labelvalues[ln]) for ln in self.labelnames)
        inst = self.series.get(key)
        if inst is None:
            with self._lock:
                inst = self.series.get(key)
                if inst is None:
                    inst = self._make()
                    self.series[key] = inst
        return inst

    def _make(self) -> _Instrument:
        if self.kind == "histogram":
            return Histogram(self._registry, self.buckets)
        return _KINDS[self.kind](self._registry)

    def _default(self) -> _Instrument:
        """The unlabeled series (only valid for label-free families)."""
        return self.labels()


_DEFAULT_BUCKETS = log_buckets()


class Registry:
    """Named metric families with thread-safe idempotent registration,
    Prometheus text exposition, and a JSON-able snapshot."""

    def __init__(self, enabled: bool = True):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}
        self.enabled = enabled

    def disable(self) -> None:
        """Turn every write into a no-op (`serve --no-metrics`).
        Registration still works, so call sites need no branching."""
        self.enabled = False

    def enable(self) -> None:
        self.enabled = True

    # ---- registration ------------------------------------------------

    def _family(self, name: str, kind: str, help: str,
                labels: Iterable[str],
                buckets: Optional[Sequence[float]] = None) -> _Family:
        labelnames = tuple(labels)
        bk = tuple(float(b) for b in buckets) if buckets is not None else None
        if kind == "histogram" and bk is None:
            bk = _DEFAULT_BUCKETS
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(self, name, kind, help, labelnames, bk)
                self._families[name] = fam
                return fam
        if fam.kind != kind:
            raise ValueError(
                f"{name} already registered as {fam.kind}, not {kind}"
            )
        if fam.labelnames != labelnames:
            raise ValueError(
                f"{name} already registered with labels {fam.labelnames}, "
                f"not {labelnames}"
            )
        if kind == "histogram" and fam.buckets != bk:
            raise ValueError(
                f"{name} already registered with buckets {fam.buckets}"
            )
        return fam

    def counter(self, name: str, help: str = "", labels: Iterable[str] = ()):
        """A Counter (no labels) or a labeled family exposing
        `.labels(**values)`."""
        fam = self._family(name, "counter", help, labels)
        return fam if fam.labelnames else fam._default()

    def gauge(self, name: str, help: str = "", labels: Iterable[str] = ()):
        fam = self._family(name, "gauge", help, labels)
        return fam if fam.labelnames else fam._default()

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (),
                  buckets: Optional[Sequence[float]] = None):
        fam = self._family(name, "histogram", help, labels, buckets)
        return fam if fam.labelnames else fam._default()

    # ---- reads -------------------------------------------------------

    def get(self, name: str, **labelvalues) -> Optional[_Instrument]:
        """The live instrument for (name, labels), or None. A read-side
        helper for tests and /stats — never creates series."""
        fam = self._families.get(name)
        if fam is None:
            return None
        key = tuple(str(labelvalues.get(ln, "")) for ln in fam.labelnames)
        return fam.series.get(key)

    def value(self, name: str, **labelvalues) -> Optional[float]:
        inst = self.get(name, **labelvalues)
        if inst is None:
            return None
        return inst.count if isinstance(inst, Histogram) else inst.value

    def total(self, name: str) -> Optional[float]:
        """Sum of a family's series values across ALL label
        combinations (counters/gauges: value; histograms: observation
        count). None when the family was never registered. The read
        surface for "how many X happened, regardless of label" — the
        tier's /stats uses it — so callers never walk internals."""
        fam = self._families.get(name)
        if fam is None:
            return None
        with fam._lock:
            insts = list(fam.series.values())
        return float(sum(
            i.count if isinstance(i, Histogram) else i.value
            for i in insts
        ))

    def family_names(self) -> List[str]:
        """Registered family names (the tier's federated exposition
        uses this to avoid duplicate # TYPE headers for families both
        the tier and its replicas expose)."""
        with self._lock:
            return list(self._families)

    # ---- exposition --------------------------------------------------

    @staticmethod
    def _labelstr(names: Tuple[str, ...], values: Tuple[str, ...],
                  extra: str = "") -> str:
        parts = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def render(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: List[str] = []
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        for fam in fams:
            # Snapshot the series dict under the family lock: another
            # thread settling a request can insert a new labeled series
            # (first 'cancelled' outcome, say) mid-scrape, and
            # iterating the live dict would raise.
            with fam._lock:
                series = sorted(fam.series.items())
            if not series:
                continue
            if fam.help:
                lines.append(f"# HELP {fam.name} {_escape(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, inst in series:
                if isinstance(inst, Histogram):
                    with inst._lock:
                        counts = list(inst.counts)
                        total, s = inst.count, inst.sum
                    cum = 0
                    for upper, c in zip(fam.buckets, counts):
                        cum += c
                        ls = self._labelstr(fam.labelnames, key,
                                            f'le="{_fmt(upper)}"')
                        lines.append(f"{fam.name}_bucket{ls} {cum}")
                    ls = self._labelstr(fam.labelnames, key, 'le="+Inf"')
                    lines.append(f"{fam.name}_bucket{ls} {total}")
                    ls = self._labelstr(fam.labelnames, key)
                    lines.append(f"{fam.name}_sum{ls} {_fmt(s)}")
                    lines.append(f"{fam.name}_count{ls} {total}")
                else:
                    ls = self._labelstr(fam.labelnames, key)
                    lines.append(f"{fam.name}{ls} {_fmt(inst.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> Dict[str, dict]:
        """JSON-able dump (bench output files): per family, the kind
        and every series' value — histograms carry their full bucket
        counts plus a p50/p90/p99 digest so distribution shape survives
        into BENCH_* artifacts."""
        out: Dict[str, dict] = {}
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        for fam in fams:
            series = []
            with fam._lock:  # same insertion race as render()
                rows_src = sorted(fam.series.items())
            for key, inst in rows_src:
                row: Dict[str, object] = {
                    "labels": dict(zip(fam.labelnames, key)),
                }
                if isinstance(inst, Histogram):
                    with inst._lock:
                        row["buckets"] = {
                            _fmt(u): c
                            for u, c in zip(fam.buckets, inst.counts)
                        }
                        row["overflow"] = inst.counts[-1]
                        row["sum"] = inst.sum
                    row.update(inst.summary())
                else:
                    row["value"] = inst.value
                series.append(row)
            if series:
                out[fam.name] = {"type": fam.kind, "series": series}
        return out


# Process-global default: every engine, server, and training loop in a
# process deposits into one registry unless handed its own, so a single
# /metrics scrape (or snapshot) sees the whole picture.
_default_registry = Registry()


def get_registry() -> Registry:
    return _default_registry


def set_default_registry(registry: Registry) -> Registry:
    """Swap the process default (tests); returns the previous one."""
    global _default_registry
    old = _default_registry
    _default_registry = registry
    return old
