"""The engines' decode loops and prefills as CUDA graphs, and the
batching engines' pipelines, on a card.

Marked `gpu`: each test skips in its body when no CUDA device is present.
On a card:

    python -m pytest -m gpu tests/test_torch_graphs.py --noconftest

At shellac-1b's width cut to 2 layers, in bf16 (random weights from a
seed), over the dense and paged caches in bf16 and int8: greedy tokens
through the graphs equal the eager loop's (the same tick code run
without a graph) exactly, and so do the kernels' launch counts; each
prefill bucket's graph gives the eager prefill's tokens, logprobs and
launch counts; two windows in flight (replays of one graph) keep their
own results, and so do prefill graphs of two buckets replayed in turns
(they share one memory pool); sampled
windows draw fresh numbers on every replay and the same numbers from the
same seed; a capture that fails raises. The HTTP server over the paged
engine gives the engine's tokens while a stream is in flight over the
engine's first capture, which runs on the server's scheduler thread.
`Engine.generate` keeps its graphs across calls (the third call at a
shape captures nothing); the continuation programs (chunked prefill, and
the prefix cache's suffix prefills over the pools) and the windows with
logit bias, penalties and seeds give their eager programs' tokens and
launch counts; a seeded request's replayed windows draw per position and
the same numbers for the same (seed, position) in any slot. Constrained
windows and first tokens through their graphs give the eager programs'
tokens, logprobs and launch counts, across a growth of the resident DFA
table while a window is in flight (the graphs of the old table dropped
and captured anew), and every output walks its DFA. MoE layers (the
GPT-OSS layer and a model whose fresh prefills drop at capacity) inside
Engine.generate's graphs, the window graphs and the prefill graphs give
the eager programs' tokens, logprobs and launch counts.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import numpy as np
import pytest
import torch

from shellac_tpu_torch.config import YarnConfig
from shellac_tpu_torch.inference import batching
from shellac_tpu_torch.inference.engine import Engine
from shellac_tpu_torch.inference.graphs import StepGraph, counted_wrappers
from shellac_tpu_torch.models import transformer
from shellac_tpu_torch.models.registry import get_model_config

pytestmark = pytest.mark.gpu

BACKENDS = ["dense", "paged", "dense-int8", "paged-int8"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


_MODEL = {}


def _model(dev):
    """shellac-1b's width, 2 layers, bf16, random weights from a seed."""
    if "m" not in _MODEL:
        cfg = get_model_config("shellac-1b").replace(n_layers=2)
        _MODEL["m"] = cfg, transformer.init_params(cfg, seed=3, device=dev)
    return _MODEL["m"]


class _EagerEngine(Engine):
    """Engine whose programs run eagerly: the loop the graph replaces."""

    def _graph(self, fn, generator, pool=None):
        return fn


def _eager(cls, prefill=True, windows=True):
    """A batching engine class whose windows and prefills run eagerly
    (each, or both)."""

    class Eager(cls):
        if windows:
            def _decode_impl(self, greedy_only, ctl=batching._NO_CTL):
                return self._window(greedy_only, ctl)

        if prefill:
            def _prefill_replay(self, key):
                return self._program(key)

    return Eager


def _prefill_graphs(eng):
    return sum(g.graph is not None for g in eng._prefill_graphs.values())


def _counts():
    return {w.__name__: w.launches for w in counted_wrappers()}


def _reset():
    for w in counted_wrappers():
        w.launches = 0


def _prompts(vocab, b=4, s=96):
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, vocab, (b, s)).astype(np.int64))
    lens = torch.tensor([96, 17, 50, 64][:b], dtype=torch.int32)
    return toks, lens


def _requests(vocab, n=7):
    rng = np.random.default_rng(11)
    return [(f"r{i}", rng.integers(0, vocab, int(rng.integers(5, 120))),
             int(rng.integers(3, 20))) for i in range(n)]


def _engine_kw(backend):
    kw = dict(n_slots=3, max_len=256, cache_backend=backend)
    if backend == "paged":
        kw["block_size"] = 16
    return kw


def _batching_cls(backend):
    return (batching.PagedBatchingEngine if backend.startswith("paged")
            else batching.BatchingEngine)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_engine_graph_matches_eager(kv_quant):
    dev = _card()
    cfg, params = _model(dev)
    toks, lens = _prompts(cfg.vocab_size)
    out, counts = {}, {}
    for name, cls in (("eager", _EagerEngine), ("graph", Engine)):
        eng = cls(cfg, params, max_len=256, temperature=0.0,
                  kv_quant=kv_quant, device=dev)
        _reset()
        captured = StepGraph.captures
        out[name] = eng.generate(toks.to(dev), lens.to(dev),
                                 max_new_tokens=12)
        torch.cuda.synchronize()
        counts[name] = _counts()
        assert StepGraph.captures - captured == (name == "graph")
    assert torch.equal(out["graph"].tokens, out["eager"].tokens)
    assert torch.equal(out["graph"].logprobs, out["eager"].logprobs)
    assert counts["graph"] == counts["eager"]
    decode = ("decode_attention_quant_cuda" if kv_quant
              else "decode_attention_cuda")
    assert counts["graph"][decode] == cfg.n_layers * 11
    assert counts["graph"]["rms_norm_cuda"] == (2 * cfg.n_layers + 1) * 12


@pytest.mark.parametrize("ticks", [1, 3])
@pytest.mark.parametrize("backend", BACKENDS)
def test_batching_graph_matches_eager(backend, ticks):
    """Greedy windows through the graph: the same tokens and logprobs as
    the eager windows, through slot churn, and the same launch counts."""
    dev = _card()
    cfg, params = _model(dev)
    reqs = _requests(cfg.vocab_size)
    cls = _batching_cls(backend)
    out, counts, engines = {}, {}, {}
    for name, c in (("eager", _eager(cls)), ("graph", cls)):
        eng = c(cfg, params, decode_ticks=ticks, logprobs=True, device=dev,
                **_engine_kw(backend))
        _reset()
        out[name] = eng.run(reqs)
        torch.cuda.synchronize()
        counts[name], engines[name] = _counts(), eng
    assert out["graph"] == out["eager"]
    for rid, _, _ in reqs:
        assert (engines["graph"].finished_logprobs[rid]
                == engines["eager"].finished_logprobs[rid])
    assert counts["graph"] == counts["eager"]
    windows = engines["graph"].stats["decode_windows"]
    assert windows == engines["eager"].stats["decode_windows"] > 2
    assert engines["graph"].stats["decode_graphs"] == 1
    assert engines["eager"].stats["decode_graphs"] == 0
    decode = {"dense": "decode_attention_cuda",
              "dense-int8": "decode_attention_quant_cuda",
              "paged": "paged_decode_attention_cuda",
              "paged-int8": "paged_decode_attention_quant_cuda"}[backend]
    assert counts["graph"][decode] == cfg.n_layers * ticks * windows


@pytest.mark.parametrize("backend", BACKENDS)
def test_prefill_graph_matches_eager_prefill(backend):
    """Every bucket's prefill after its first runs as a graph replay, with
    the eager prefill's first tokens, logprobs and launch counts (the
    windows run eagerly in both, so only the prefill differs)."""
    dev = _card()
    cfg, params = _model(dev)
    rng = np.random.default_rng(5)
    # Three prompts in each of the buckets 32 and 128, two in 16.
    lens = [20, 100, 30, 9, 120, 25, 70, 12]
    reqs = [(f"p{i}", rng.integers(0, cfg.vocab_size, n), 4)
            for i, n in enumerate(lens)]
    cls = _batching_cls(backend)
    out, counts, engines = {}, {}, {}
    for name, c in (("eager", _eager(cls)),
                    ("graph", _eager(cls, prefill=False))):
        eng = c(cfg, params, logprobs=True, top_logprobs=2, device=dev,
                **_engine_kw(backend))
        _reset()
        out[name] = eng.run(reqs)
        torch.cuda.synchronize()
        counts[name], engines[name] = _counts(), eng
    g, e = engines["graph"], engines["eager"]
    assert out["graph"] == out["eager"]
    for rid, _, _ in reqs:
        assert g.finished_logprobs[rid] == e.finished_logprobs[rid]
        assert g.finished_top_logprobs[rid] == e.finished_top_logprobs[rid]
    assert counts["graph"] == counts["eager"]
    assert counts["graph"]["flash_attention_cuda"] == cfg.n_layers * 8
    assert _prefill_graphs(g) == 3 and _prefill_graphs(e) == 0


@pytest.mark.parametrize("backend", ["paged", "dense-int8"])
def test_two_windows_in_flight_keep_their_results(backend):
    """Under overlap_decode two windows are in flight, both replays of one
    graph whose outputs the second overwrites: each window's results are
    its own (they were copied out at dispatch)."""
    dev = _card()
    cfg, params = _model(dev)
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, 40)
    cls = _batching_cls(backend)
    want = cls(cfg, params, decode_ticks=2, device=dev,
               **_engine_kw(backend)).run([("a", prompt, 40)])["a"]
    eng = cls(cfg, params, decode_ticks=2, overlap_decode=True, device=dev,
              **_engine_kw(backend))
    eng.submit("a", prompt, 40)
    for _ in range(4):  # the first window runs eagerly, the second captures
        eng.step()
    assert eng.stats["decode_graphs"] == 1 and len(eng._windows) == 1
    eng._dispatch_window(eng._active_rows())
    windows = list(eng._windows)
    eng._windows.clear()
    slot = windows[0].pairs[0][0]
    k = len(eng._slots[slot].out)
    results = [eng._sync_window(w) for w in windows]
    assert results[0][0][slot] == want[k:k + 2]
    assert results[1][0][slot] == want[k + 2:k + 4]
    for w, res in zip(windows, results):
        eng._apply_pairs(w.pairs, *res)
    got = {}
    while eng.pending:
        got.update(eng.step())
    assert got["a"] == want


def test_prefill_buckets_alternate_over_a_shared_pool():
    """Prefill graphs of two buckets share one memory pool. Admitted in
    turns, with every prefill of a step in flight at once (no cap), each
    flight settles to the eager prefill's first token and logprob."""
    dev = _card()
    cfg, params = _model(dev)
    rng = np.random.default_rng(8)
    reqs = [(f"q{i}", rng.integers(0, cfg.vocab_size, n), 3)
            for i, n in enumerate([20, 100] * 4)]
    cls = batching.PagedBatchingEngine
    kw = dict(n_slots=4, max_len=256, logprobs=True, device=dev)
    want_eng = _eager(cls)(cfg, params, **kw)
    want = want_eng.run(reqs)
    eng = cls(cfg, params, overlap_prefill=True, overlap_decode=True, **kw)
    got = eng.run(reqs)
    assert got == want
    assert eng._prefill_pool is not None and _prefill_graphs(eng) == 2
    for rid, _, _ in reqs:
        assert eng.finished_logprobs[rid] == want_eng.finished_logprobs[rid]


def _uniform(dev):
    """The 2-layer model with a final norm that zeroes every logit, so a
    sampled token depends on the random numbers alone."""
    cfg, params = _model(dev)
    flat = dict(params, final_norm=torch.full_like(params["final_norm"],
                                                   -1.0))
    return cfg, flat


@pytest.mark.parametrize("backend", ["dense", "paged-int8"])
def test_sampled_windows_draw_fresh_numbers(backend):
    """Uniform logits: a replay that reused its capture's numbers would
    repeat one token. Consecutive window replays draw different tokens,
    and so do the sampling prefill graph's replays (four prompts of
    bucket 16: one eager prefill, the capture's replay, two more
    replays); a fresh engine with the same seed draws the same ones."""
    dev = _card()
    cfg, params = _uniform(dev)
    reqs = [("a", np.arange(1, 9), 24), ("b", np.arange(3, 40), 24),
            ("c", np.arange(5, 15), 24), ("d", np.arange(7, 19), 24),
            ("e", np.arange(2, 16), 24)]
    outs = []
    for _ in range(2):
        eng = _batching_cls(backend)(cfg, params, temperature=1.0, seed=5,
                                     device=dev, **_engine_kw(backend))
        outs.append(eng.run(reqs))
        assert eng.stats["decode_graphs"] == 1
        bucket = eng._prefill_graphs[batching._Program("fresh", 16,
                                                        greedy=False)]
        assert bucket.calls == 4 and bucket.graph is not None
    assert outs[0] == outs[1]
    for rid, _, _ in reqs:
        toks = outs[0][rid]
        assert len(set(toks)) > len(toks) // 2, toks
        assert sum(a != b for a, b in zip(toks, toks[1:])) > len(toks) // 2
    assert outs[0]["a"] != outs[0]["b"]
    # The replayed prefills' first tokens (prompts c, d, e).
    assert len({outs[0][rid][0] for rid in "cde"}) == 3


def test_sampled_generate_draws_fresh_numbers():
    dev = _card()
    cfg, params = _uniform(dev)
    toks, lens = _prompts(cfg.vocab_size, b=2)
    eng = Engine(cfg, params, max_len=256, temperature=1.0, device=dev)

    def run(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return eng.generate(toks.to(dev), lens.to(dev), max_new_tokens=16,
                            generator=g).tokens

    first = run(9)
    assert torch.equal(first, run(9))
    assert not torch.equal(first, run(10))
    for row in first.tolist():
        assert len(set(row)) > len(row) // 2, row


def _syncing(fn):
    """fn, with a host sync whenever a CUDA graph is being captured."""

    def wrapped(*args, **kw):
        if torch.cuda.is_current_stream_capturing():
            torch.cuda.synchronize()
        return fn(*args, **kw)

    return wrapped


def test_failed_capture_raises(monkeypatch):
    """No eager fallback on the card: a capture that fails raises, on
    every window that tries it, and the launch counters stay as the eager
    windows left them."""
    dev = _card()
    cfg, params = _model(dev)
    monkeypatch.setattr(batching.transformer, "forward_with_cache",
                        _syncing(transformer.forward_with_cache))
    eng = batching.BatchingEngine(cfg, params, device=dev,
                                  **_engine_kw("dense"))
    eng.submit("a", np.arange(1, 9), 8)
    eng.step()  # the first window runs eagerly
    before = _counts()
    for _ in range(2):
        with pytest.raises(RuntimeError):
            eng.step()
        assert _counts() == before
    assert eng.stats["decode_graphs"] == 0
    toks, lens = _prompts(cfg.vocab_size, b=2)
    with pytest.raises(RuntimeError):
        Engine(cfg, params, max_len=256, temperature=0.0,
               device=dev).generate(toks.to(dev), lens.to(dev),
                                    max_new_tokens=4)
    # The failed captures handed the allocator back.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def test_http_server_streams_through_the_first_capture():
    """The HTTP server over PagedBatchingEngine (2 layers of shellac-1b,
    bf16): greedy tokens over HTTP equal the engine run in process. The
    first request streams alone, so the engine's first eager window and
    its capture run on the server's scheduler thread while handler
    threads serve the stream and the other requests arrive; no handler
    thread touches the card."""
    import json
    import threading
    import urllib.request

    from shellac_tpu_torch.inference.server import (
        InferenceServer,
        make_http_server,
    )
    from shellac_tpu_torch.obs import Registry

    dev = _card()
    cfg, params = _model(dev)
    reqs = _requests(cfg.vocab_size, n=10)

    def engine():
        return batching.PagedBatchingEngine(
            cfg, params, n_slots=3, max_len=256, block_size=16,
            decode_ticks=1, temperature=0.0, device=dev)

    want = engine().run(reqs)
    eng = engine()
    srv = InferenceServer(cfg, params, engine=eng, registry=Registry())
    httpd = make_http_server(srv)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    got, errors, first = {}, [], threading.Event()

    def post(rid, toks, m, stream=False):
        try:
            req = urllib.request.Request(
                base + "/generate",
                data=json.dumps({"tokens": [int(t) for t in toks],
                                 "max_new": m, "stream": stream}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                if not stream:
                    got[rid] = json.loads(r.read())["tokens"]
                    return
                for raw in r:
                    first.set()
                    rec = json.loads(raw)
                    if rec.get("done"):
                        got[rid] = rec["tokens"]
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"{rid}: {e!r}")

    try:
        threads = [threading.Thread(target=post, args=(*reqs[0], True))]
        threads[0].start()
        assert first.wait(120)
        threads += [threading.Thread(target=post, args=r) for r in reqs[1:]]
        for t in threads[1:]:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errors, errors
        assert eng.stats["decode_graphs"] == 1
        assert got == want
    finally:
        httpd.shutdown()
        srv.close()
    assert not srv._thread.is_alive()


# --------------------------------------------------------------------------
# generate's programs kept across calls, the continuation graphs, and the
# windows with per-request controls
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_generate_replays_its_graphs_on_later_calls(kv_quant):
    """The second call at a (batch, pad) captures its prefill, the third
    captures nothing; every call gives the eager engine's tokens and
    logprobs and its launch counts."""
    dev = _card()
    cfg, params = _model(dev)
    toks, lens = _prompts(cfg.vocab_size)
    eager = _EagerEngine(cfg, params, max_len=256, temperature=0.0,
                         kv_quant=kv_quant, device=dev)
    _reset()
    want = eager.generate(toks.to(dev), lens.to(dev), max_new_tokens=12)
    torch.cuda.synchronize()
    want_counts = _counts()
    eng = Engine(cfg, params, max_len=256, temperature=0.0,
                 kv_quant=kv_quant, device=dev)
    for call, captures in enumerate((1, 1, 0)):
        _reset()
        captured = StepGraph.captures
        got = eng.generate(toks.to(dev), lens.to(dev), max_new_tokens=12)
        torch.cuda.synchronize()
        assert StepGraph.captures - captured == captures, call
        assert torch.equal(got.tokens, want.tokens), call
        assert torch.equal(got.logprobs, want.logprobs), call
        assert _counts() == want_counts, call


def _chunked_requests(vocab):
    rng = np.random.default_rng(12)
    shared = rng.integers(0, vocab, 80)
    return [(f"c{i}", np.concatenate([shared, rng.integers(0, vocab, n)]),
             5) for i, n in enumerate([30, 45, 9, 60, 20, 77])]


@pytest.mark.parametrize("backend", BACKENDS)
def test_continuation_graphs_match_eager(backend):
    """Chunked prefill (32-token chunks) and, over the paged pools, the
    prefix cache's suffix prefills: every continuation program after its
    key's first runs as a graph replay, with the eager programs' tokens,
    logprobs and launch counts."""
    dev = _card()
    cfg, params = _model(dev)
    reqs = _chunked_requests(cfg.vocab_size)
    cls = _batching_cls(backend)
    kw = dict(_engine_kw(backend), prefill_chunk=32, logprobs=True)
    if backend.startswith("paged"):
        kw["prefix_cache"] = True
    out, counts, engines = {}, {}, {}
    for name, c in (("eager", _eager(cls)),
                    ("graph", _eager(cls, prefill=False))):
        eng = c(cfg, params, device=dev, **kw)
        _reset()
        out[name] = {}
        for r in reqs:  # one at a time: later prompts hit the cache
            out[name].update(eng.run([r]))
        torch.cuda.synchronize()
        counts[name], engines[name] = _counts(), eng
    g, e = engines["graph"], engines["eager"]
    assert out["graph"] == out["eager"]
    for rid, _, _ in reqs:
        assert g.finished_logprobs[rid] == e.finished_logprobs[rid]
    assert counts["graph"] == counts["eager"]
    chunk_graphs = [k for k, r in g._prefill_graphs.items()
                    if k.kind == "chunk" and r.graph is not None]
    assert chunk_graphs and g.stats["prefill_chunks"] > len(reqs)
    if backend.startswith("paged"):
        assert g.stats["prefix_hit_tokens"] > 0


@pytest.mark.parametrize("backend", ["paged", "dense-int8"])
def test_control_windows_match_eager(backend):
    """Windows and prefills with logit bias, penalties and seeds through
    their graphs: the eager programs' tokens and launch counts, and the
    window graphs the keys name."""
    dev = _card()
    cfg, params = _model(dev)
    reqs = _requests(cfg.vocab_size, n=8)
    ctl = [{}, {"logit_bias": {7: 2.0, 11: -3.0}},
           {"presence_penalty": 0.8, "frequency_penalty": 0.4},
           {"temperature": 0.9, "seed": 5}, {"temperature": 0.7},
           {"logit_bias": {3: 1.0}, "temperature": 1.1, "seed": 9},
           {"frequency_penalty": 1.0}, {}]
    cls = _batching_cls(backend)
    out, counts, engines = {}, {}, {}
    for name, c in (("eager", _eager(cls)), ("graph", cls)):
        eng = c(cfg, params, decode_ticks=2, device=dev, seed=3,
                **_engine_kw(backend))
        _reset()
        for (rid, p, m), k in zip(reqs, ctl):
            eng.submit(rid, p, m, **k)
        out[name] = eng.run()
        torch.cuda.synchronize()
        counts[name], engines[name] = _counts(), eng
    assert out["graph"] == out["eager"]
    assert counts["graph"] == counts["eager"]
    # (ticks, greedy_only, bias, penalties, seeds, constraints): variants
    # with each control were captured.
    keys = [k for k, r in engines["graph"]._window_graphs.items()
            if r.graph is not None]
    assert any(k[2] for k in keys) and any(k[3] for k in keys)
    assert any(k[4] for k in keys)


def test_seeded_graphs_draw_per_position():
    """Uniform logits: a seeded request's replayed windows draw fresh
    numbers at every position and the same numbers for the same (seed,
    position), alone or beside other requests in another slot."""
    dev = _card()
    cfg, params = _uniform(dev)

    def run(neighbours):
        eng = batching.PagedBatchingEngine(
            cfg, params, temperature=1.0, seed=1, device=dev,
            **_engine_kw("paged"))
        for i in range(neighbours):
            eng.submit(f"n{i}", np.arange(2, 12 + i), 24, seed=40 + i)
        eng.submit("s", np.arange(1, 9), 24, seed=77)
        return eng.run(), eng

    alone, eng = run(0)
    assert eng.stats["decode_graphs"] == 1
    toks = alone["s"]
    assert len(set(toks)) > len(toks) // 2, toks
    assert run(2)[0]["s"] == toks
    other = batching.PagedBatchingEngine(cfg, params, temperature=1.0,
                                         device=dev, **_engine_kw("paged"))
    other.submit("s", np.arange(1, 9), 24, seed=78)
    assert other.run()["s"] != toks


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("overlap", [False, True])
def test_constrained_graphs_match_eager_across_a_restack(backend, overlap):
    """A 60-letter grammar (61 rows, live for 61 tokens) and a schema
    placed first grow the resident table to 128 rows; a third grammar
    admitted while the first decodes grows it to 256 (with a window in
    flight under the pipelines), which drops the constrained graphs of
    the old table. The graph engine's tokens, logprobs and launch counts
    equal the eager engine's, and every output walks its DFA."""
    from shellac_tpu_torch.inference.constraints import (
        compile_token_dfa,
        constraint_pattern,
    )
    from shellac_tpu_torch.training.tokenizer import ByteTokenizer

    dev = _card()
    cfg, params = _model(dev)
    tok, eos = ByteTokenizer(), ByteTokenizer.EOS
    dfas = [compile_token_dfa(p, tok, cfg.vocab_size, eos) for p in (
        "[a-z]{60}",
        constraint_pattern({"json_schema": {
            "type": "object", "properties": {
                "k": {"enum": ["a", "bb", "ccc"]}, "ok": {"type": "boolean"}},
            "required": ["k", "ok"]}}),
        constraint_pattern({"json_schema": {
            "type": "object", "properties": {
                "a": {"type": "string", "format": "date-time"},
                "b": {"type": "string", "format": "uuid"}},
            "required": ["a", "b"]}}))]
    assert dfas[0].n_states + dfas[1].n_states <= 128
    assert dfas[0].n_states + dfas[2].n_states > 128
    rng = np.random.default_rng(13)
    plan = [(0, 64), (1, 40), (None, 4), (None, 6), (2, 60), (None, 5)]
    prompts = [rng.integers(0, cfg.vocab_size, 40 + 9 * i)
               for i in range(len(plan))]
    cls = _batching_cls(backend)
    kw = dict(_engine_kw(backend), decode_ticks=2, logprobs=True, eos_id=eos)
    if overlap:
        kw.update(overlap_decode=True, overlap_prefill=True,
                  max_prefills_per_step=1)
    out, counts, engines, grown = {}, {}, {}, {}
    for name, c in (("eager", _eager(cls)), ("graph", cls)):
        eng = c(cfg, params, device=dev, **kw)
        grown[name] = []
        grow = eng._grow_table

        def counting(rows, grow=grow, log=grown[name], eng=eng):
            log.append(bool(eng._windows))
            grow(rows)

        eng._grow_table = counting
        _reset()
        for i, ((d, m), p) in enumerate(zip(plan, prompts)):
            eng.submit(f"c{i}", p, m,
                       **({"constraint": dfas[d]} if d is not None else {}))
        out[name] = eng.run()
        torch.cuda.synchronize()
        counts[name], engines[name] = _counts(), eng
    g, e = engines["graph"], engines["eager"]
    assert out["graph"] == out["eager"]
    assert g.finished_logprobs == e.finished_logprobs
    assert counts["graph"] == counts["eager"]
    assert grown["graph"] == grown["eager"] and len(grown["graph"]) == 3
    assert g._ctrans.shape[0] == 256
    if overlap:
        assert grown["graph"][-1]
    assert any(k[5] and r.graph is not None
               for k, r in g._window_graphs.items())
    for i, (d, _) in enumerate(plan):
        if d is None:
            continue
        st = 0
        for t in out["graph"][f"c{i}"]:
            st = int(dfas[d].trans[st, -1 if t == eos else t])
            assert st >= 0


@pytest.mark.parametrize("constrained", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
def test_beam_search_graphs_match_eager(backend, constrained):
    """Beam search's prefill and step programs through their graphs (the
    dense caches through the single-request delegate) give the eager
    programs' beams and scores bit for bit; the first search at a key
    captures both (its prefill runs an eager warm-up first, one prefill's
    launches more than the eager engine's), later ones capture nothing."""
    from shellac_tpu_torch.inference.constraints import compile_token_dfa
    from shellac_tpu_torch.training.tokenizer import ByteTokenizer

    dev = _card()
    cfg, params = _model(dev)
    eos = ByteTokenizer.EOS
    dfa = (compile_token_dfa(r"(yes|no|maybe)( (yes|no|maybe)){0,3}",
                             ByteTokenizer(), cfg.vocab_size, eos)
           if constrained else None)
    prompt = np.random.default_rng(17).integers(0, 256, 150)
    cls = _batching_cls(backend)

    class Eager(_eager(cls)):
        def _graph(self, fn, generator, pool=None):
            return fn

    out, counts, captured = {}, {}, {}
    for name, c in (("eager", Eager), ("graph", cls)):
        kw = _engine_kw(backend)
        if backend == "paged-int8":
            kw["pool_tokens"] = 1024  # 64-token blocks: the search's 7
        eng = c(cfg, params, eos_id=eos, device=dev, **kw)
        _reset()
        out[name], captured[name] = [], []
        for _ in range(3):
            before = StepGraph.captures
            out[name].append(eng.beam_search(prompt, num_beams=4,
                                             max_new_tokens=20,
                                             constraint=dfa))
            captured[name].append(StepGraph.captures - before)
        torch.cuda.synchronize()
        counts[name] = _counts()
    L = cfg.n_layers
    warm = {"rms_norm_cuda": 2 * L + 1,
            "flash_attention_cuda": L}
    assert out["graph"] == out["eager"]
    assert counts["graph"] == {n: c + warm.get(n, 0)
                               for n, c in counts["eager"].items()}
    assert captured == {"eager": [0, 0, 0], "graph": [2, 0, 0]}


# --------------------------------------------------------------------------
# MoE layers inside the graphs
# --------------------------------------------------------------------------

_MOE = {}


def _moe_model(dev, name):
    """An MoE preset at head_dim 64 (the kernels' width), 2 layers, bf16:
    tiny-gptoss (GPT-OSS's layer: sinks, q/k/v/o biases, the window
    pattern, the biased softmax-after-top-k gate, dropless; and GPT-OSS's
    yarn rope, whose table must not be copied from the host inside a
    capture) and tiny-moe (a fresh prefill drops at capacity, its padding
    tokens included)."""
    if name not in _MOE:
        cfg = get_model_config(name).replace(
            d_model=256, n_heads=4, head_dim=64, n_layers=2,
            max_seq_len=512)
        if name == "tiny-gptoss":
            cfg = cfg.replace(rope_yarn=YarnConfig(
                factor=32.0, original_max_position_embeddings=4096,
                truncate=False))
        _MOE[name] = cfg, transformer.init_params(cfg, seed=5, device=dev)
    return _MOE[name]


def test_yarn_graph_replays_after_17_other_tables():
    """A program captured over a yarn table replays bit-equal after 17
    other (dim, base, yarn) keys were used: the table it reads is never
    freed or reused."""
    from shellac_tpu_torch.ops import rope

    dev = _card()
    yarn = YarnConfig(factor=32.0, original_max_position_embeddings=4096,
                      truncate=False)
    pos = torch.arange(1024, device=dev)
    x = torch.randn(1024, 4, 64, device=dev, dtype=torch.bfloat16)

    def program():
        cos, sin = rope.rope_angles(pos, 64, 150000.0, yarn=yarn)
        return rope.apply_rope(x, cos, sin)

    step = StepGraph(program, dev)
    want = step().clone()
    torch.testing.assert_close(step(), want, rtol=0, atol=0)
    for i in range(17):
        other = YarnConfig(factor=2.0 + i,
                           original_max_position_embeddings=4096)
        rope.rope_angles(pos, 64, 1000.0 + i, yarn=other)
        # Fill memory the allocator might hand out again.
        torch.full((64 * 1024,), float("nan"), device=dev)
    torch.cuda.synchronize()
    torch.testing.assert_close(step(), want, rtol=0, atol=0)


def test_moe_generate_graphs_match_eager():
    """Engine.generate over MoE layers: the prefill and decode-step
    graphs give the eager programs' tokens, logprobs and launch counts,
    and a later call captures nothing."""
    dev = _card()
    cfg, params = _moe_model(dev, "tiny-gptoss")
    toks, lens = _prompts(cfg.vocab_size)
    eager = _EagerEngine(cfg, params, max_len=256, temperature=0.0,
                         device=dev)
    _reset()
    want = eager.generate(toks.to(dev), lens.to(dev), max_new_tokens=12)
    torch.cuda.synchronize()
    want_counts = _counts()
    eng = Engine(cfg, params, max_len=256, temperature=0.0, device=dev)
    for call, captures in enumerate((1, 1, 0)):
        _reset()
        captured = StepGraph.captures
        got = eng.generate(toks.to(dev), lens.to(dev), max_new_tokens=12)
        torch.cuda.synchronize()
        assert StepGraph.captures - captured == captures, call
        assert torch.equal(got.tokens, want.tokens), call
        assert torch.equal(got.logprobs, want.logprobs), call
        assert _counts() == want_counts, call
    assert want_counts["decode_attention_cuda"] == cfg.n_layers * 11


@pytest.mark.parametrize("backend", ["dense", "paged"])
@pytest.mark.parametrize("name", ["tiny-gptoss", "tiny-moe"])
def test_moe_window_graphs_match_eager(name, backend):
    """Decode windows over MoE layers (3 ticks, both pipelines): the
    graph's tokens, logprobs and launch counts equal the eager windows'
    through slot churn."""
    dev = _card()
    cfg, params = _moe_model(dev, name)
    reqs = _requests(cfg.vocab_size)
    cls = _batching_cls(backend)
    out, counts, engines = {}, {}, {}
    for key, c in (("eager", _eager(cls)), ("graph", cls)):
        eng = c(cfg, params, decode_ticks=3, logprobs=True, device=dev,
                overlap_decode=True, overlap_prefill=True,
                **_engine_kw(backend))
        _reset()
        out[key] = eng.run(reqs)
        torch.cuda.synchronize()
        counts[key], engines[key] = _counts(), eng
    assert out["graph"] == out["eager"]
    for rid, _, _ in reqs:
        assert (engines["graph"].finished_logprobs[rid]
                == engines["eager"].finished_logprobs[rid])
    assert counts["graph"] == counts["eager"]
    assert engines["graph"].stats["decode_graphs"] == 1
    assert engines["graph"].stats["decode_windows"] > 2


@pytest.mark.parametrize("backend", ["dense", "paged"])
@pytest.mark.parametrize("name", ["tiny-gptoss", "tiny-moe"])
def test_moe_prefill_graphs_match_eager(name, backend):
    """Every bucket's prefill after its first runs as a graph replay over
    MoE layers, with the eager prefill's first tokens, logprobs and
    launch counts (tiny-moe's fresh prefills drop at capacity in both)."""
    dev = _card()
    cfg, params = _moe_model(dev, name)
    rng = np.random.default_rng(5)
    lens = [20, 100, 30, 9, 120, 25, 70, 12]
    reqs = [(f"p{i}", rng.integers(0, cfg.vocab_size, n), 4)
            for i, n in enumerate(lens)]
    cls = _batching_cls(backend)
    out, counts, engines = {}, {}, {}
    for key, c in (("eager", _eager(cls)),
                   ("graph", _eager(cls, prefill=False))):
        eng = c(cfg, params, logprobs=True, top_logprobs=2, device=dev,
                **_engine_kw(backend))
        _reset()
        out[key] = eng.run(reqs)
        torch.cuda.synchronize()
        counts[key], engines[key] = _counts(), eng
    g, e = engines["graph"], engines["eager"]
    assert out["graph"] == out["eager"]
    for rid, _, _ in reqs:
        assert g.finished_logprobs[rid] == e.finished_logprobs[rid]
        assert g.finished_top_logprobs[rid] == e.finished_top_logprobs[rid]
    assert counts["graph"] == counts["eager"]
    assert counts["graph"]["flash_attention_cuda"] == cfg.n_layers * 8
    assert _prefill_graphs(g) == 3 and _prefill_graphs(e) == 0


# --------------------------------------------------------------------------
# MLA (latent caches) inside the graphs
# --------------------------------------------------------------------------

_MLA = {}


def _mla_model(dev):
    """shellac-mla-2b's width (16 heads, latent 512 + rope 64: the decode
    kernels at D 576, the flash forward at 192), 2 layers, bf16."""
    if "m" not in _MLA:
        cfg = get_model_config("shellac-mla-2b").replace(n_layers=2)
        _MLA["m"] = cfg, transformer.init_params(cfg, seed=9, device=dev)
    return _MLA["m"]


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_mla_generate_graphs_match_eager(kv_quant):
    """Engine.generate over the dense latent cache: the decode-step graph
    replays give the eager loop's tokens, logprobs and launch counts, the
    decode through the D 576 kernel and the prefill through kernel 2 at
    192."""
    dev = _card()
    cfg, params = _mla_model(dev)
    toks, lens = _prompts(cfg.vocab_size)
    out, counts = {}, {}
    for key, cls in (("eager", _EagerEngine), ("graph", Engine)):
        eng = cls(cfg, params, max_len=256, temperature=0.0,
                  kv_quant=kv_quant, device=dev)
        eng.generate(toks.to(dev), lens.to(dev), max_new_tokens=10)
        _reset()
        out[key] = eng.generate(toks.to(dev), lens.to(dev),
                                max_new_tokens=10)
        torch.cuda.synchronize()
        counts[key] = _counts()
    assert torch.equal(out["graph"].tokens, out["eager"].tokens)
    assert torch.equal(out["graph"].logprobs, out["eager"].logprobs)
    assert counts["graph"] == counts["eager"]
    decode = ("decode_attention_quant_cuda" if kv_quant
              else "decode_attention_cuda")
    assert counts["graph"][decode] == cfg.n_layers * 9
    assert counts["graph"]["flash_attention_cuda"] == cfg.n_layers


@pytest.mark.parametrize("backend", BACKENDS)
def test_mla_window_graphs_match_eager(backend):
    """Decode windows over the four latent caches (3 ticks, both
    pipelines): the graph's tokens, logprobs and launch counts equal the
    eager windows' through slot churn."""
    dev = _card()
    cfg, params = _mla_model(dev)
    reqs = _requests(cfg.vocab_size)
    cls = _batching_cls(backend)
    out, counts, engines = {}, {}, {}
    for key, c in (("eager", _eager(cls)), ("graph", cls)):
        eng = c(cfg, params, decode_ticks=3, logprobs=True, device=dev,
                overlap_decode=True, overlap_prefill=True,
                **_engine_kw(backend))
        _reset()
        out[key] = eng.run(reqs)
        torch.cuda.synchronize()
        counts[key], engines[key] = _counts(), eng
    assert out["graph"] == out["eager"]
    for rid, _, _ in reqs:
        assert (engines["graph"].finished_logprobs[rid]
                == engines["eager"].finished_logprobs[rid])
    assert counts["graph"] == counts["eager"]
    assert engines["graph"].stats["decode_graphs"] == 1
    assert engines["graph"].stats["decode_windows"] > 2


def test_profiled_engine_steps_keep_their_device_time(monkeypatch):
    """`chip_smoke.profile_call` over engine steps under the reference
    serve's pipelines (a decode window in flight at each profile's
    start), as chip_smoke's serve, prefix-serve and mla phases profile
    them. On the H100 host about 1 in 130 such profiles held the step's
    runtime calls but no device activity, and the phase stopped with
    "the trace holds no device time". Every step must report device
    time from its trace, without the window's opening kernel, or say that
    CUPTI lost the trace: no device ms, and the CUDA events' span beside
    it (a lost trace simulated by a profiler that records nothing)."""
    import chip_smoke

    dev = _card()
    cfg, params = _model(dev)
    eng = batching.PagedBatchingEngine(
        cfg, params, n_slots=4, max_len=512, block_size=16, decode_ticks=1,
        device=dev, overlap_decode=True, overlap_prefill=True,
        max_prefills_per_step=1)
    rng = np.random.default_rng(5)
    for i in range(4):
        eng.submit(f"r{i}", rng.integers(0, cfg.vocab_size, 64), 400)
    while eng._queue or eng._pflights or any(
            r is not None and not r.out for r in eng._slots):
        eng.step()
    for _ in range(100):
        p = chip_smoke.profile_call(eng.step)
        assert p["event_ms"] > 0
        if p["trace_lost"]:
            assert p["device_ms"] is None and p["launches"] is None
        else:
            assert p["device_ms"] > 0 and p["device_ms_by_kind"]
            assert not any("spin_kernel" in r["kernel"] for r in p["top"])

    class Lost:
        """A profile window that recorded no device activity."""

        def __init__(self, **kw):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return []

    monkeypatch.setattr(torch.profiler, "profile", Lost)
    p = chip_smoke.profile_call(eng.step)
    assert p["trace_lost"] and p["device_ms"] is None and p["event_ms"] > 0
    eng.abort_all()
    eng.close()
