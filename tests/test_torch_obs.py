"""The port's observability core against the JAX package's, on the CPU.

`shellac_tpu_torch/obs` is a copy of the reference's metrics core,
request span and instrument bundles: the same writes into the port's and
the reference's `Registry` must render byte-identical Prometheus text
(and equal snapshots), and after the same requests through both servers
(tiny, fp32, the JAX params carried across by `params_from_jax`) the
registries hold the same metric families (names, types, help strings,
label names and buckets), the request histograms count every request,
and a request's flight-recorder timeline has the same events in the same
order.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import json
import math
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shellac_tpu.inference.server import InferenceServer as JServer
from shellac_tpu.inference.server import make_http_server as jmake_http
from shellac_tpu.models.registry import get_model_config as jget
from shellac_tpu.obs import metrics as jmetrics
from shellac_tpu.obs import trace as jtrace
from shellac_tpu_torch.inference.server import InferenceServer
from shellac_tpu_torch.inference.server import make_http_server
from shellac_tpu_torch.models.from_jax import params_from_jax
from shellac_tpu_torch.models.registry import get_model_config
from shellac_tpu_torch.obs import metrics, trace
from shellac_tpu_torch.training.tokenizer import ByteTokenizer

import jax_params

CPU = "cpu"


# --------------------------------------------------------------------------
# (a) the metrics core: identical writes, identical exposition
# --------------------------------------------------------------------------


def _writes_counters(m):
    r = m.Registry()
    c = r.counter("shellac_a_total", "plain counter")
    c.inc()
    c.inc(2.5)
    fam = r.counter("shellac_b_total", 'with "quotes", \\ and\nnewline',
                    labels=("outcome", "tenant"))
    fam.labels(outcome="ok", tenant="").inc(3)
    fam.labels(outcome="err", tenant='x"y\\z\nw').inc()
    fam.labels(outcome="ok", tenant="t1").inc(1e20)
    r.counter("shellac_unused_total", "registered, never written",
              labels=("k",))
    return r


def _writes_gauges(m):
    r = m.Registry()
    g = r.gauge("shellac_g", "gauge")
    g.set(-3.25)
    g.inc(0.25)
    g.dec(10)
    h = r.gauge("shellac_h", labels=("backend",))
    h.labels(backend="paged").set(1)
    h.labels(backend="dense").set(float("nan"))
    r.gauge("shellac_inf").set(float("inf"))
    r.gauge("shellac_tiny").set(1e-7)
    r.gauge("shellac_third").set(1 / 3)
    return r


def _writes_histograms(m):
    r = m.Registry()
    h = r.histogram("shellac_lat_seconds", "latency")
    for v in (0.0005, 0.001, 0.0011, 0.02, 0.5, 3.0, 59.9, 61.0, 1e4):
        h.observe(v, exemplar=f"id{v}")
    fam = r.histogram("shellac_phase_seconds", "phases", labels=("phase",),
                      buckets=m.log_buckets(0.0001, 10.0, per_decade=4))
    for i, ph in enumerate(("settle", "admission", "decode_sync")):
        for j in range(5):
            fam.labels(phase=ph).observe(1e-4 * (i + 1) * 3 ** j)
    occ = r.histogram("shellac_occ", "occupancy",
                      buckets=m.linear_buckets(0.125, 0.125, 8))
    for v in (0.125, 0.5, 1.0, 0.3):
        occ.observe(v)
    r.histogram("shellac_empty_seconds", "never observed")
    return r


def _writes_serve_bundles(m, t):
    """The instrument bundles' own writes: spans settled every way, the
    engine gauges and histograms."""
    r = m.Registry()
    sm = t.ServeMetrics(r)
    em = t.EngineMetrics(r)
    for i, outcome in enumerate(("ok", "ok", "cancelled", "error", "fault",
                                 "shed")):
        tr = sm.trace(trace_id=f"tid{i}", tenant="a" if i % 2 else None)
        tr.t_submit -= 0.01 * (i + 1)  # spans of distinct lengths
        tr.prefill_start()
        tr.first_token()
        if outcome == "ok":
            tr.finish(5 + i)
        elif outcome == "shed":
            tr.shed()
        else:
            tr.abort(outcome)
    sm.rejects.labels(reason="overloaded", tenant="").inc()
    sm.engine_stat("prefills").set(7)
    sm.cache_backend_info.labels(backend="paged").set(1)
    em.occupancy.observe(0.5)
    em.slots_busy.set(3)
    em.kv_util.set(0.125)
    for ph in trace.STEP_PHASES:
        em.step_phase.labels(phase=ph).observe(0.002)
    return r


_SCRIPTS = {
    "counters": _writes_counters,
    "gauges": _writes_gauges,
    "histograms": _writes_histograms,
}


@pytest.mark.parametrize("script", sorted(_SCRIPTS))
def test_registry_exposition_is_byte_identical(script):
    port = _SCRIPTS[script](metrics).render()
    ref = _SCRIPTS[script](jmetrics).render()
    assert port == ref
    assert port.endswith("\n")


@pytest.mark.parametrize("script", sorted(_SCRIPTS))
def test_registry_snapshot_and_reads_match(script):
    port = _SCRIPTS[script](metrics)
    ref = _SCRIPTS[script](jmetrics)
    # NaN != NaN: compare the JSON text of the snapshots.
    assert (json.dumps(port.snapshot(), sort_keys=True)
            == json.dumps(ref.snapshot(), sort_keys=True))
    assert port.family_names() == ref.family_names()
    for name in port.family_names():
        pv, rv = port.total(name), ref.total(name)
        assert (pv == rv) or (math.isnan(pv) and math.isnan(rv))


def test_instrument_bundles_render_the_reference_families():
    port = _writes_serve_bundles(metrics, trace)
    ref = _writes_serve_bundles(jmetrics, jtrace)
    assert port.family_names() == ref.family_names()
    for name in port.family_names():
        pf, rf = port._families[name], ref._families[name]
        assert (pf.kind, pf.help, pf.labelnames, pf.buckets) == (
            rf.kind, rf.help, rf.labelnames, rf.buckets), name
        assert sorted(pf.series) == sorted(rf.series), name
    # Every series but the span clocks' sums and buckets renders alike.
    def stable(text):
        return [ln for ln in text.splitlines()
                if not ln.startswith(("shellac_ttft", "shellac_tpot",
                                      "shellac_queue_wait", "shellac_e2e"))]
    assert stable(port.render()) == stable(ref.render())
    for name in ("shellac_ttft_seconds", "shellac_e2e_seconds",
                 "shellac_tpot_seconds", "shellac_queue_wait_seconds"):
        assert port.value(name) == ref.value(name), name


def test_bucket_helpers_match():
    for args in ((), (0.0001, 10.0), (1e3, 1e9, 2)):
        assert metrics.log_buckets(*args) == jmetrics.log_buckets(*args)
    assert (metrics.linear_buckets(0.125, 0.125, 8)
            == jmetrics.linear_buckets(0.125, 0.125, 8))
    for m in (metrics, jmetrics):
        with pytest.raises(ValueError):
            m.log_buckets(0.0, 1.0)
        with pytest.raises(ValueError):
            m.Registry().counter("shellac_c_total").inc(-1)
    for v in (0, 1.0, -2.0, 0.1, 1e15, 1e16, float("nan"), float("inf"),
              float("-inf"), 123456789.25):
        assert metrics._fmt(v) == jmetrics._fmt(v)


def test_registration_conflicts_raise_alike():
    renders = []
    for m in (metrics, jmetrics):
        r = m.Registry()
        r.counter("shellac_x_total", labels=("a",))
        with pytest.raises(ValueError):
            r.gauge("shellac_x_total")
        with pytest.raises(ValueError):
            r.counter("shellac_x_total", labels=("b",))
        r.histogram("shellac_h", buckets=(1.0, 2.0))
        with pytest.raises(ValueError):
            r.histogram("shellac_h", buckets=(1.0, 3.0))
        # A disabled registry registers but never writes.
        d = m.Registry(enabled=False)
        d.counter("shellac_y_total").inc()
        d.histogram("shellac_z_seconds").observe(1.0)
        assert d.value("shellac_y_total") == 0.0
        renders.append(d.render())
    assert renders[0] == renders[1]


# --------------------------------------------------------------------------
# (b) the same requests through both servers
# --------------------------------------------------------------------------

# Families the port's registry has that the reference's lacks: the
# /metrics mirrors (shellac_engine_<key>) of the port engine's own stats
# keys (tests/test_torch_server.py lists them).
_PORT_ONLY = {"shellac_engine_pool_exhausted", "shellac_engine_decode_windows",
              "shellac_engine_decode_graphs"}
# Families the reference's registry has that the port's lacks: the
# mirrors of the JAX engine's stats keys that the port's engine leaves
# out (tests/test_torch_server.py's UNPORTED_STATS).
_UNPORTED = {"shellac_engine_" + k for k in (
    "kv_exports", "kv_imports", "kv_bytes_per_token", "preemptions")}

_PROMPTS = ["hello", "ab", "the quick", "zz top", "x"]


def _post(base, payload):
    req = urllib.request.Request(
        f"{base}/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.headers.get("x-request-id"), r.read()


def _drive(srv, make_http):
    """Five blocking requests, one streamed, one bad request and one
    recorded timeline, all over HTTP; then a /metrics scrape."""
    httpd = make_http(srv)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        tids = [_post(base, {"text": p, "max_new": 4 + i})[0]
                for i, p in enumerate(_PROMPTS)]
        _post(base, {"text": "stream me", "max_new": 5, "stream": True})
        with pytest.raises(urllib.error.HTTPError):
            _post(base, {"tokens": [1], "max_new": 2, "top_p": 0.0})
        with urllib.request.urlopen(f"{base}/debug/request/{tids[0]}",
                                    timeout=30) as r:
            timeline = [e["event"] for e in json.loads(r.read())["events"]]
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            text = r.read().decode()
    finally:
        httpd.shutdown()
        srv.close()
    return timeline, text


@pytest.fixture(scope="module")
def served():
    jc = jget("tiny").replace(dtype="float32")
    tc = get_model_config("tiny").replace(dtype="float32")
    jp = jax.tree.map(jnp.asarray, jax_params.init_params(jc))
    tp = params_from_jax(tc, jax.tree.map(np.asarray, jp), device=CPU)
    kw = dict(tokenizer=ByteTokenizer(), n_slots=2, max_len=64,
              temperature=0.0)
    jreg, treg = jmetrics.Registry(), metrics.Registry()
    jt_line, jtext = _drive(JServer(jc, jp, registry=jreg, **kw), jmake_http)
    tt_line, ttext = _drive(
        InferenceServer(tc, tp, registry=treg, device=CPU, **kw),
        make_http_server)
    return (jreg, jtext, jt_line), (treg, ttext, tt_line)


def test_server_registries_hold_the_reference_families(served):
    (jreg, _, _), (treg, _, _) = served
    jn, tn = set(jreg.family_names()), set(treg.family_names())
    assert tn - jn == _PORT_ONLY
    assert jn - tn == _UNPORTED
    for name in sorted(jn - _UNPORTED):
        pf, rf = treg._families[name], jreg._families[name]
        assert (pf.kind, pf.help, pf.labelnames, pf.buckets) == (
            rf.kind, rf.help, rf.labelnames, rf.buckets), name


def test_server_series_and_exposition_match(served):
    (jreg, jtext, _), (treg, ttext, _) = served
    for name in set(jreg.family_names()) - _UNPORTED:
        assert sorted(treg._families[name].series) == sorted(
            jreg._families[name].series), name
    def header_lines(text):
        return [ln for ln in text.splitlines() if ln.startswith("#")
                and ln.split()[2] not in _PORT_ONLY | _UNPORTED]
    assert header_lines(ttext) == header_lines(jtext)


def test_histogram_counts_equal_the_request_count(served):
    (jreg, _, _), (treg, _, _) = served
    answered = len(_PROMPTS) + 1
    for reg in (jreg, treg):
        assert reg.value("shellac_requests_total", outcome="ok",
                         tenant="") == answered
        assert reg.value("shellac_requests_total", outcome="error",
                         tenant="") == 1
        for name in ("shellac_ttft_seconds", "shellac_e2e_seconds",
                     "shellac_queue_wait_seconds", "shellac_tpot_seconds"):
            assert reg.value(name) == answered, name
        # The engine step histograms saw work on every window.
        assert reg.value("shellac_batch_occupancy") > 0
        assert reg.value("shellac_prefill_seconds") > 0
        assert reg.value("shellac_decode_host_overhead_seconds") > 0
        assert reg.value("shellac_step_phase_seconds",
                         phase="decode_sync") > 0


def test_request_timeline_matches_the_reference(served):
    (_, _, jline), (_, _, tline) = served
    assert tline == jline
    assert tline[:4] == ["admit", "queue", "prefill", "first-token"]
    assert tline[-1] == "finish"
    assert "window-dispatch" in tline and "window-settle" in tline
