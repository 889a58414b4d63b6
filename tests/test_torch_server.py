"""The port's HTTP server against the JAX package's, on the CPU.

Both servers run the tiny preset in fp32 on the same weights (the JAX
params carried across by `params_from_jax`), with the byte tokenizer,
2 slots, greedy sampling, logprobs and 2 top logprobs. The contracts of
`tests/test_server.py` and `tests/test_openai_api.py` are held on the
port's server, against the JAX server where the two can be compared:

  - greedy tokens over /generate (blocking and streamed),
    /v1/completions (text and token prompts, blocking and SSE) and
    /v1/chat/completions (blocking and SSE) equal the JAX server's,
    compared up to the first position where the JAX engine's own top-2
    logprob margin is under twice the logit tolerance of 1e-4
    (tests/test_torch_model.py's rule), so fp32 summation order cannot
    flip a token;
  - bad requests get the JAX server's status codes and error shapes;
  - response key sets equal the JAX server's, minus the keys this slice
    does not port (named per surface below);
  - stop holdback, cancellation on disconnect, max_pending's 429, drain,
    deadline shedding and the supervisor work on the port's server;
  - logit bias and the penalties give the JAX server's greedy tokens
    (compared up to the first position whose top-2 margin under the
    controls is under MARGIN), prompt logprobs (native and echo) its
    scores within 1e-4, and a seed the same tokens on every ask;
  - an option this slice does not port answers 501 (and raises
    NotImplementedError where it is a constructor argument).

Its card counterpart (the server over PagedBatchingEngine at 2 layers
of shellac-1b, a stream in flight over the first graph capture) is in
tests/test_torch_graphs.py, which imports no JAX.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import json
import socket
import threading
import time
import urllib.error
import urllib.request
from urllib.parse import urlparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from shellac_tpu.inference import openai_api as jopenai
from shellac_tpu.inference.server import InferenceServer as JServer
from shellac_tpu.inference.server import make_http_server as jmake_http
from shellac_tpu.models.registry import get_model_config as jget
from shellac_tpu.obs import metrics as jmetrics
from shellac_tpu_torch.inference import batching, openai_api
from shellac_tpu_torch.inference.server import (
    InferenceServer,
    ServerUnavailable,
    make_http_server,
)
from shellac_tpu_torch.models import transformer as tt
from shellac_tpu_torch.models.from_jax import params_from_jax
from shellac_tpu_torch.models.registry import get_model_config
from shellac_tpu_torch.obs import Registry
from shellac_tpu_torch.training.tokenizer import ByteTokenizer

import jax_params

CPU = "cpu"
MARGIN = 2 * 1e-4
TOK = ByteTokenizer()

# The port engine's own stats keys, beside the JAX
# engine's: pool requeues, decode windows, decode graphs captured.
PORT_ONLY_STATS = {"pool_exhausted", "decode_windows", "decode_graphs"}
# The JAX engine's stats keys the port's engine leaves out: counters of
# unported features (KV export and import, preemption) and the per-token
# KV price, which would only hold constants. /stats answers
# cache_backend from the engine's backend.
UNPORTED_STATS = {"kv_exports", "kv_imports", "kv_bytes_per_token",
                  "preemptions"}


def _start(srv, make_http):
    httpd = make_http(srv)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def pair():
    jc = jget("tiny").replace(dtype="float32")
    tc = get_model_config("tiny").replace(dtype="float32")
    jp = jax.tree.map(jnp.asarray, jax_params.init_params(jc))
    tp = params_from_jax(tc, jax.tree.map(np.asarray, jp), device=CPU)
    kw = dict(tokenizer=TOK, model_name="tiny", n_slots=2, max_len=64,
              temperature=0.0, logprobs=True, top_logprobs=2)
    jsrv = JServer(jc, jp, registry=jmetrics.Registry(), **kw)
    tsrv = InferenceServer(tc, tp, registry=Registry(), device=CPU, **kw)
    jhttpd, jbase = _start(jsrv, jmake_http)
    thttpd, tbase = _start(tsrv, make_http_server)
    yield {"jax": jbase, "port": tbase, "tsrv": tsrv, "tc": tc, "tp": tp}
    for httpd, srv in ((jhttpd, jsrv), (thttpd, tsrv)):
        httpd.shutdown()
        srv.close()


def _request(base, path, payload=None, raw=None, method=None):
    """(status, headers, body bytes); HTTP errors are returned."""
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(
        base + path, data=data, method=method,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _json(base, path, payload=None):
    status, _, body = _request(base, path, payload)
    assert status == 200, (path, status, body)
    return json.loads(body)


def _lines(base, path, payload):
    status, headers, body = _request(base, path, payload)
    assert status == 200, (status, body)
    return headers, body.decode().splitlines()


def _ndjson(base, payload):
    headers, lines = _lines(base, "/generate", dict(payload, stream=True))
    assert headers["Content-Type"] == "application/x-ndjson"
    return [json.loads(ln) for ln in lines if ln]


def _sse(base, path, payload):
    headers, lines = _lines(base, path, dict(payload, stream=True))
    assert headers["Content-Type"] == "text/event-stream"
    data = [ln[len("data: "):] for ln in lines if ln.startswith("data: ")]
    assert data[-1] == "[DONE]"
    return [json.loads(d) for d in data[:-1]]


# --------------------------------------------------------------------------
# greedy tokens against the JAX server
# --------------------------------------------------------------------------

_PROMPTS = ["hello there", "ab", "the quick brown"]
_CHATS = [[{"role": "user", "content": "hi"}],
          [{"role": "system", "content": "be brief"},
           {"role": "user", "content": "go on"}]]
_MAX_NEW = 8
_REF = {}


def _reference(pair, text):
    """The JAX server's greedy tokens for a text prompt and how many of
    them lead with a top-2 margin >= MARGIN."""
    if text not in _REF:
        out = _json(pair["jax"], "/generate",
                    {"text": text, "max_new": _MAX_NEW, "logprobs": True,
                     "top_logprobs": 2})
        margins = [t[0]["logprob"] - t[1]["logprob"]
                   for t in out["top_logprobs"]]
        low = [i for i, m in enumerate(margins) if m < MARGIN]
        _REF[text] = out["tokens"], (low[0] if low else len(margins))
    return _REF[text]


def _stable(tokens, n):
    """The longest k <= n such that every prefix of tokens[:k] decodes to
    a prefix of its text. A stream's text is assembled from cumulative
    decodes, so where a later byte completes a multi-byte character the
    text depends on where the deltas split; within k it cannot."""
    k = 0
    while k < n and all(TOK.decode(tokens[:j]) == TOK.decode(
            tokens[:k + 1])[:len(TOK.decode(tokens[:j]))]
            for j in range(k + 1)):
        k += 1
    return k


def _chat_text(msgs):
    rendered = openai_api.render_chat(msgs, TOK)
    assert rendered == jopenai.render_chat(msgs, TOK)
    return rendered


def _route_tokens(base, route, text, n):
    """Greedy output of `n` tokens of one route, as token ids (native
    routes) or text (OpenAI routes)."""
    if route == "generate":
        return _json(base, "/generate", {"text": text, "max_new": n})["tokens"]
    if route == "generate_stream":
        recs = _ndjson(base, {"text": text, "max_new": n})
        streamed = [t for r in recs[:-1] for t in r["tokens"]]
        assert recs[-1]["done"] and streamed == recs[-1]["tokens"][
            :len(streamed)]
        return recs[-1]["tokens"]
    if route == "completions_tokens":
        out = _json(base, "/v1/completions",
                    {"prompt": [int(t) for t in TOK.encode(text)],
                     "max_tokens": n, "temperature": 0})
        return out["choices"][0]["text"]
    if route == "completions_text":
        out = _json(base, "/v1/completions",
                    {"prompt": text, "max_tokens": n, "temperature": 0})
        return out["choices"][0]["text"]
    if route == "completions_stream":
        chunks = _sse(base, "/v1/completions",
                      {"prompt": text, "max_tokens": n, "temperature": 0})
        return "".join(c["choices"][0]["text"] for c in chunks)
    raise ValueError(route)


def _chat_route(base, route, msgs, n):
    payload = {"messages": msgs, "max_tokens": n, "temperature": 0}
    if route == "chat":
        return _json(base, "/v1/chat/completions",
                     payload)["choices"][0]["message"]["content"]
    chunks = _sse(base, "/v1/chat/completions", payload)
    assert chunks[0]["choices"][0]["delta"].get("role") == "assistant"
    return "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks)


@pytest.mark.parametrize("route", ["generate", "generate_stream",
                                   "completions_tokens", "completions_text",
                                   "completions_stream", "chat",
                                   "chat_stream"])
def test_greedy_tokens_match_the_jax_server(pair, route):
    chat = route.startswith("chat")
    cases = ([(_chat_text(m), m) for m in _CHATS] if chat
             else [(p, None) for p in _PROMPTS])
    compared = 0
    for text, msgs in cases:
        want, upto = _reference(pair, text)
        if not route.startswith("generate"):
            upto = _stable(want, upto)
        if upto == 0:
            continue
        compared += upto
        got = {}
        for side in ("jax", "port"):
            got[side] = (_chat_route(pair[side], route, msgs, upto) if chat
                         else _route_tokens(pair[side], route, text, upto))
        if isinstance(got["port"], str):
            assert got["port"] == got["jax"] == TOK.decode(want[:upto])
        else:
            assert got["port"][:upto] == got["jax"][:upto] == want[:upto]
    assert compared >= _MAX_NEW // 2, compared


def test_sampled_fanout_and_logprobs(pair):
    """n/best_of on the port: ranked choices with logprobs; greedy n > 1
    is refused as in the reference."""
    out = _json(pair["port"], "/generate",
                {"text": "xy", "max_new": 4, "temperature": 1.1, "n": 2,
                 "best_of": 3, "logprobs": True})
    assert len(out["choices"]) == 2
    means = [np.mean(c["logprobs"]) for c in out["choices"]]
    assert means[0] >= means[1]
    assert all(len(c["tokens"]) == 4 for c in out["choices"])
    oai = _json(pair["port"], "/v1/completions",
                {"prompt": "xy", "max_tokens": 4, "temperature": 1.1,
                 "n": 2})
    assert [c["index"] for c in oai["choices"]] == [0, 1]
    assert oai["usage"]["completion_tokens"] == 8


# --------------------------------------------------------------------------
# bad requests: the JAX server's status codes and error shapes
# --------------------------------------------------------------------------

_BAD = {
    "no_prompt": ("/generate", {"max_new": 4}),
    "top_p_zero": ("/generate", {"tokens": [1, 2], "top_p": 0.0}),
    "temperature_text": ("/generate", {"tokens": [1], "temperature": "warm"}),
    "fractional_top_k": ("/generate", {"tokens": [1], "top_k": 0.9}),
    "min_tokens_no_eos": ("/generate", {"tokens": [1], "min_tokens": 2}),
    "greedy_n": ("/generate", {"tokens": [1], "n": 2}),
    "top_logprobs_over_cap": ("/generate", {"tokens": [1], "logprobs": True,
                                            "top_logprobs": 5}),
    "empty_stop": ("/generate", {"tokens": [1], "stop": [[]]}),
    "too_long": ("/generate", {"tokens": [1] * 70, "max_new": 4}),
    "stream_no_prompt": ("/generate", {"stream": True, "max_new": 4}),
    "stream_n": ("/generate", {"tokens": [1], "stream": True, "n": 2,
                               "temperature": 1.0}),
    "suffix": ("/v1/completions", {"prompt": "a", "suffix": "tail"}),
    "no_oai_prompt": ("/v1/completions", {"max_tokens": 2}),
    "bad_logprobs": ("/v1/completions", {"prompt": "a", "logprobs": 9}),
    "empty_messages": ("/v1/chat/completions", {"messages": []}),
    "alien_role": ("/v1/chat/completions",
                   {"messages": [{"role": "alien", "content": "x"}]}),
    "no_role_stream": ("/v1/chat/completions",
                       {"messages": [{"content": "x"}], "stream": True}),
    "chat_best_of": ("/v1/chat/completions",
                     {"messages": [{"role": "user", "content": "x"}],
                      "best_of": 2}),
    "not_found": ("/nope", {"x": 1}),
    "drain_list": ("/drain", [1]),
}


def _shape(status, body, openai):
    out = json.loads(body)
    if openai and status != 404:
        return status, sorted(out["error"]), out["error"]["type"]
    return status, sorted(out), type(out["error"]).__name__


@pytest.mark.parametrize("case", sorted(_BAD))
def test_bad_requests_answer_as_the_jax_server(pair, case):
    path, payload = _BAD[case]
    got = {side: _request(pair[side], path, payload)
           for side in ("jax", "port")}
    openai = path.startswith("/v1/")
    shapes = {side: _shape(s, b, openai) for side, (s, _, b) in got.items()}
    assert shapes["port"] == shapes["jax"]
    assert 400 <= shapes["port"][0] < 500
    assert got["port"][1].get("x-request-id")


def test_get_paths_answer_as_the_jax_server(pair):
    for path in ("/nope", "/debug/request/00-unknown", "/v1/models",
                 "/health", "/stats"):
        codes = [_request(pair[s], path)[0] for s in ("jax", "port")]
        assert codes[0] == codes[1], path


# --------------------------------------------------------------------------
# response key sets
# --------------------------------------------------------------------------


def _keys(pair, fn):
    return {side: fn(pair[side]) for side in ("jax", "port")}


def _surfaces():
    lp = {"text": "ab", "max_new": 3, "logprobs": True, "top_logprobs": 2}

    def generate(b):
        return set(_json(b, "/generate", {"text": "ab", "max_new": 3}))

    def generate_logprobs(b):
        return set(_json(b, "/generate", lp))

    def stream_records(b):
        recs = _ndjson(b, lp)
        return {frozenset(r) for r in recs}

    def completion(b):
        out = _json(b, "/v1/completions",
                    {"prompt": "ab", "max_tokens": 3, "logprobs": 2})
        return (set(out), set(out["choices"][0]),
                set(out["choices"][0]["logprobs"]), set(out["usage"]))

    def chat(b):
        out = _json(b, "/v1/chat/completions",
                    {"messages": [{"role": "user", "content": "a"}],
                     "max_tokens": 3, "logprobs": True, "top_logprobs": 2})
        c = out["choices"][0]
        return (set(out), set(c), set(c["message"]),
                set(c["logprobs"]["content"][0]))

    def sse(b):
        chunks = _sse(b, "/v1/chat/completions",
                      {"messages": [{"role": "user", "content": "a"}],
                       "max_tokens": 3})
        return {frozenset(c) for c in chunks}, {
            frozenset(c["choices"][0]) for c in chunks}

    def stats(b):
        return set(_json(b, "/stats"))

    def health(b):
        return set(_json(b, "/health"))

    def debug_requests(b):
        return set(_json(b, "/debug/requests"))

    def models(b):
        return _json(b, "/v1/models")

    return {k: v for k, v in locals().items() if k != "lp"}


_SURFACES = _surfaces()


@pytest.mark.parametrize("surface", sorted(_SURFACES))
def test_response_keys_match_the_jax_server(pair, surface):
    keys = _keys(pair, _SURFACES[surface])
    if surface == "stats":
        assert keys["port"] == (keys["jax"] - UNPORTED_STATS) | PORT_ONLY_STATS
    else:
        assert keys["port"] == keys["jax"]


def test_stats_count_the_port_engine(pair):
    before = _json(pair["port"], "/stats")
    _json(pair["port"], "/generate", {"tokens": [1, 2, 3], "max_new": 4})
    after = _json(pair["port"], "/stats")
    assert after["requests_completed"] == before["requests_completed"] + 1
    assert after["tokens_generated"] == before["tokens_generated"] + 4
    assert after["prefills"] == before["prefills"] + 1
    assert after["n_slots"] == 2 and after["cache_backend"] == "dense"
    assert after["ttft_s"]["count"] == before["ttft_s"]["count"] + 1


# --------------------------------------------------------------------------
# streaming, cancellation, admission, drain
# --------------------------------------------------------------------------


def test_prefix_cached_stats_keys_match_the_reference(pair):
    """Over a prefix-cached paged engine /stats (the engine's stats and
    the server's fixed keys) carries the reference's prefix counters:
    the engine's keys are the JAX engine's minus UNPORTED_STATS plus the
    port's own, and the shellac_prefix_cache_blocks gauge counts the
    cached blocks after a hit."""
    from shellac_tpu.inference.batching import PagedBatchingEngine as JPaged

    jc = jget("tiny").replace(dtype="float32")
    kw = dict(n_slots=2, max_len=64, block_size=8, prefix_cache=True)
    jeng = JPaged(jc, jax.tree.map(jnp.asarray,
                                   jax_params.init_params(jc)), **kw)
    reg = Registry()
    teng = batching.PagedBatchingEngine(pair["tc"], pair["tp"], device=CPU,
                                        registry=reg, **kw)
    assert {k for k in jeng.stats if k.startswith("prefix_")} == {
        "prefix_hit_tokens", "prefix_query_tokens", "prefix_evictions",
        "prefix_seeded_blocks"}
    # /stats adds cache_backend beside the engine's stats.
    assert set(teng.stats) | {"cache_backend"} == (
        set(jeng.stats) - UNPORTED_STATS) | PORT_ONLY_STATS
    prompt = list(range(1, 21))
    teng.run([("a", prompt, 2)])
    teng.run([("b", prompt, 2)])
    assert teng.stats["prefix_hit_tokens"] == 16
    assert reg.value("shellac_prefix_cache_blocks") == len(
        teng.cache_backend._hash_to_block) == 2


def test_stream_stop_holdback(pair):
    """Stop-truncated tokens are never streamed: every delta token is
    part of the final (truncated) output."""
    srv = pair["tsrv"]
    prompt = [5, 6]
    ref = srv.generate(prompt, max_new=12)
    stop = [ref[3:5]]
    want = srv.generate(prompt, max_new=12, stop=stop)
    assert want == ref[:3]
    got, final = [], None
    for kind, val in srv.generate_stream(prompt, max_new=12, stop=stop,
                                         timeout=120):
        if kind == "delta":
            got.extend(val)
        else:
            final = val
    assert final == want
    assert got == final[:len(got)]


def _cancelled(base):
    return _json(base, "/stats")["requests_cancelled"]


def _wait_cancelled(base, before):
    deadline = time.time() + 30
    while time.time() < deadline and _cancelled(base) == before:
        time.sleep(0.05)
    return _cancelled(base)


def test_socket_disconnect_mid_stream_cancels(pair):
    base = pair["port"]
    before = _cancelled(base)
    u = urlparse(base)
    body = json.dumps({"tokens": [1, 2], "max_new": 56,
                       "stream": True}).encode()
    s = socket.create_connection((u.hostname, u.port), timeout=30)
    s.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\n"
              b"Content-Type: application/json\r\nContent-Length: "
              + str(len(body)).encode() + b"\r\n\r\n" + body)
    s.recv(1)  # the response started; hang up
    s.close()
    assert _wait_cancelled(base, before) == before + 1
    out = _json(base, "/generate", {"tokens": [9, 9], "max_new": 4})
    assert len(out["tokens"]) == 4


def test_abandoned_sse_stream_frees_the_slot(pair):
    base = pair["port"]
    before = _cancelled(base)
    req = urllib.request.Request(
        f"{base}/v1/completions",
        data=json.dumps({"prompt": "ab", "max_tokens": 56, "temperature": 0,
                         "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    r = urllib.request.urlopen(req, timeout=60)
    r.readline()  # the first chunk arrived; generation is in flight
    r.close()
    assert _wait_cancelled(base, before) == before + 1


class _WedgingEngine(batching.BatchingEngine):
    """A batching engine whose step() blocks until released after
    `good_steps` steps (the observable behaviour of a wedged step)."""

    def __init__(self, *a, good_steps=0, **kw):
        super().__init__(*a, **kw)
        self._good = good_steps
        self.wedged = threading.Event()
        self.release = threading.Event()

    def step(self):
        if self._good <= 0:
            self.wedged.set()
            self.release.wait(120)
            return []
        self._good -= 1
        return super().step()


class _GatedEngine(batching.BatchingEngine):
    """A batching engine whose step() waits for the test's go-ahead."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.gate = threading.Event()

    def step(self):
        self.gate.wait(120)
        return super().step()


def _tiny():
    cfg = get_model_config("tiny").replace(dtype="float32")
    return cfg, tt.init_params(cfg, device=CPU)


def _engine(cls, cfg, params, **kw):
    return cls(cfg, params, n_slots=2, max_len=64, temperature=0.0,
               device=CPU, **kw)


def test_max_pending_answers_429():
    cfg, params = _tiny()
    eng = _engine(_WedgingEngine, cfg, params)
    srv = InferenceServer(cfg, params, engine=eng, max_pending=2,
                          registry=Registry())
    httpd, base = _start(srv, make_http_server)
    try:
        for _ in range(2):
            srv._submit([1, 2], 4, None, {}, stream=False)
        with pytest.raises(ServerUnavailable) as e:
            srv._submit([1, 2], 4, None, {}, stream=False)
        assert e.value.http_status == 429 and "max_pending=2" in str(e.value)
        status, headers, body = _request(base, "/generate",
                                         {"tokens": [1, 2], "max_new": 4})
        assert status == 429 and headers.get("Retry-After") is not None
        assert "overloaded" in json.loads(body)["error"]
        h = _json(base, "/health")
        assert h["pending"] == 2 and h["max_pending"] == 2
    finally:
        httpd.shutdown()
        eng.release.set()
        srv.close()
        assert not srv._thread.is_alive()


def test_drain_refuses_then_resumes():
    cfg, params = _tiny()
    srv = InferenceServer(cfg, params, n_slots=2, max_len=64,
                          temperature=0.0, registry=Registry(), device=CPU)
    httpd, base = _start(srv, make_http_server)
    try:
        assert _request(base, "/drain", {})[0] == 200
        status, _, body = _request(base, "/health")
        assert status == 503 and json.loads(body)["status"] == "draining"
        status, headers, _ = _request(base, "/generate",
                                      {"tokens": [1], "max_new": 2})
        assert status == 503 and headers.get("Retry-After")
        assert _json(base, "/drain", {"resume": True})["status"] == "ok"
        assert len(_json(base, "/generate",
                         {"tokens": [1], "max_new": 2})["tokens"]) == 2
    finally:
        httpd.shutdown()
        srv.close()


def test_expired_deadline_is_shed_before_prefill():
    cfg, params = _tiny()
    eng = _engine(_GatedEngine, cfg, params)
    srv = InferenceServer(cfg, params, engine=eng, registry=Registry())
    try:
        results = []
        t = threading.Thread(target=lambda: results.append(
            srv.generate([1, 2, 3], max_new=4, timeout=120)))
        t.start()
        deadline = time.monotonic() + 60
        while not srv._pending and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)  # the scheduler waits at the gate inside step()
        with pytest.raises(TimeoutError):
            srv.generate([5, 6], max_new=4, timeout=0.2)
        time.sleep(0.1)
        eng.gate.set()
        t.join(timeout=120)
        assert results and len(results[0]) == 4
        deadline = time.monotonic() + 60
        while srv.shed < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert srv.shed == 1 and eng.stats["prefills"] == 1
    finally:
        eng.gate.set()
        srv.close()
        assert not srv._thread.is_alive()


def test_wedged_step_fails_loudly_then_the_supervisor_rebuilds():
    cfg, params = _tiny()
    eng = _engine(_WedgingEngine, cfg, params)
    rebuilt = []

    def factory():
        rebuilt.append(_engine(batching.BatchingEngine, cfg, params))
        return rebuilt[-1]

    reg = Registry()
    srv = InferenceServer(cfg, params, engine=eng, step_timeout=1.0,
                          restart_budget=1, engine_factory=factory,
                          registry=reg)
    gen0 = srv._thread
    try:
        with pytest.raises(RuntimeError, match="step_timeout"):
            srv.generate([1, 2, 3], max_new=4, timeout=60)
        deadline = time.monotonic() + 60
        while srv.status != "ok" and time.monotonic() < deadline:
            time.sleep(0.05)
        assert srv.status == "ok" and srv.restarts == 1 and srv._g.gen == 1
        want = _engine(batching.BatchingEngine, cfg, params).run(
            [("r", np.array([4, 5, 6], np.int32), 4)])["r"]
        assert srv.generate([4, 5, 6], max_new=4, timeout=60) == want
        assert reg.value("shellac_supervisor_restarts_total") == 1
        assert reg.value("shellac_requests_total", outcome="fault",
                         tenant="") == 1
    finally:
        eng.release.set()
        gen0.join(timeout=60)
        srv.close()
    # close() freed the abandoned and the current generation's caches.
    assert eng._cache is None and rebuilt[0]._cache is None
    assert not srv._thread.is_alive() and not gen0.is_alive()


def test_close_fails_pending_loudly():
    cfg, params = _tiny()
    eng = _engine(_WedgingEngine, cfg, params)
    srv = InferenceServer(cfg, params, engine=eng, registry=Registry())
    errors = []

    def call():
        try:
            srv.generate([1, 2], max_new=4, timeout=60)
        except RuntimeError as e:
            errors.append(str(e))

    t = threading.Thread(target=call)
    t.start()
    assert eng.wedged.wait(30)
    srv.close()
    t.join(timeout=30)
    assert errors and "server closed" in errors[0]
    eng.release.set()
    srv._thread.join(timeout=30)


def test_no_metrics_and_no_debug_answer_404():
    cfg, params = _tiny()
    srv = InferenceServer(cfg, params, n_slots=2, max_len=64, metrics=False,
                          debug=False, device=CPU)
    httpd, base = _start(srv, make_http_server)
    try:
        assert _request(base, "/metrics")[0] == 404
        assert _request(base, "/debug/requests")[0] == 404
        assert len(_json(base, "/generate",
                         {"tokens": [1], "max_new": 2})["tokens"]) == 2
    finally:
        httpd.shutdown()
        srv.close()


# --------------------------------------------------------------------------
# what this slice does not port: 501 over HTTP, NotImplementedError here
# --------------------------------------------------------------------------

_UNPORTED_HTTP = {
    "prefill_only": ("/generate", {"tokens": [1, 2], "prefill_only": True,
                                   "migrate_to": "http://x"}),
    "adopt": ("/generate", {"adopt": "00-abc"}),
    "resume": ("/generate", {"resume": "park-1"}),
    "kv_import": ("/kv/import", {}),
    "profile": ("/debug/profile?seconds=1", {}),
    "incident": ("/debug/incident", {}),
}


@pytest.mark.parametrize("case", sorted(_UNPORTED_HTTP))
def test_unported_requests_answer_501(pair, case):
    path, payload = _UNPORTED_HTTP[case]
    status, headers, body = _request(pair["port"], path, payload)
    assert status == 501, (status, body)
    err = json.loads(body)["error"]
    msg = err["message"] if isinstance(err, dict) else err
    assert "not ported yet" in msg
    assert headers.get("x-request-id")


def test_num_beams_answers_the_engine_beams(pair):
    """Ported since beam search landed: /generate with num_beams answers
    the ranked beams of the port's Engine on the same weights, with their
    scores (tests/test_torch_beam_search.py holds those against the JAX
    package's)."""
    from shellac_tpu_torch.inference.engine import Engine

    status, headers, body = _request(
        pair["port"], "/generate",
        {"tokens": [1, 2], "num_beams": 2, "max_new": 6})
    assert status == 200, body
    got = json.loads(body)
    seqs, scores = Engine(pair["tc"], pair["tp"], max_len=64,
                          device=CPU).beam_search([1, 2], num_beams=2,
                                                  max_new_tokens=6)
    assert got["num_beams"] == 2 and got["trace_id"]
    assert [c["tokens"] for c in got["choices"]] == seqs
    assert [c["beam_score"] for c in got["choices"]] == [
        round(x, 6) for x in scores]
    assert [c["text"] for c in got["choices"]] == [TOK.decode(q)
                                                   for q in seqs]
    assert headers.get("x-request-id")


# Ported since constrained decoding and tool calling landed: each answers
# as the JAX server does. This pair's engines have no eos_id, which a
# constraint needs, so both answer 400 with the same message (the 200
# answers over an engine with an eos_id are in test_torch_tools.py).
_PORTED_HTTP = {
    "constraint": ("/generate", {"tokens": [1], "constraint": {"regex": "a"}}),
    "tools": ("/v1/chat/completions",
              {"messages": [{"role": "user", "content": "x"}],
               "tools": [{"type": "function",
                          "function": {"name": "f", "parameters": {}}}]}),
    "response_format": ("/v1/chat/completions",
                        {"messages": [{"role": "user", "content": "x"}],
                         "response_format": {"type": "json_object"}}),
    "sse_response_format": ("/v1/completions",
                            {"prompt": "a", "stream": True,
                             "response_format": {"type": "json_object"}}),
}


@pytest.mark.parametrize("case", sorted(_PORTED_HTTP))
def test_formerly_unported_requests_answer_as_the_reference(pair, case):
    path, payload = _PORTED_HTTP[case]
    want = _request(pair["jax"], path, payload)
    got = _request(pair["port"], path, payload)
    assert got[0] == want[0] == 400, (got, want)
    assert json.loads(got[2]) == json.loads(want[2])
    assert got[1].get("x-request-id")


def _adjusted_upto(pair, prompt, out, bias=None, pres=0.0, freq=0.0):
    """How many leading greedy tokens of `out` have a top-2 margin of at
    least MARGIN under the controls (the raw logits plus the bias, less
    the penalties over the tokens generated before each), from a plain
    fp32 forward of the port's model over prompt + out."""
    tc, tp = pair["tc"], pair["tp"]
    ids = list(prompt) + list(out)
    logits = tt.forward(tc, tp, np.asarray([ids], np.int64),
                        device=CPU)[0].detach().numpy()
    counts = np.zeros((tc.vocab_size,), np.float32)
    for j, tok in enumerate(out):
        row = logits[len(prompt) + j - 1].copy()
        for k, v in (bias or {}).items():
            row[int(k)] += v
        row -= pres * (counts > 0) + freq * counts
        top = np.sort(row)[-2:]
        if top[1] - top[0] < MARGIN:
            return j
        counts[tok] += 1
    return len(out)


_TEXT = "hello there"
# (path, payload, controls for the margin rule); each answer is held to
# the JAX server's under the margin rule.
_CONTROLS = {
    "logit_bias": ("/generate", {"text": _TEXT, "max_new": 8,
                                 "logit_bias": {"202": -5.0, "91": 0.1}},
                   dict(bias={202: -5.0, 91: 0.1})),
    "presence_penalty": ("/generate", {"text": _TEXT, "max_new": 8,
                                       "presence_penalty": 1.5},
                         dict(pres=1.5)),
    "frequency_penalty": ("/v1/completions",
                          {"prompt": _TEXT, "max_tokens": 8,
                           "temperature": 0, "frequency_penalty": 0.7,
                           "logit_bias": {"108": 1.0}},
                          dict(freq=0.7, bias={108: 1.0})),
}


@pytest.mark.parametrize("case", sorted(_CONTROLS))
def test_controls_match_the_jax_server(pair, case):
    """Greedy answers under logit bias and the penalties: the JAX
    server's tokens, up to the first position whose adjusted top-2
    margin is under MARGIN (most positions qualify)."""
    path, payload, ctl = _CONTROLS[case]
    got = {side: _json(pair[side], path, payload) for side in ("jax", "port")}
    prompt = [int(t) for t in TOK.encode(_TEXT)]
    if path == "/generate":
        want = got["jax"]["tokens"]
        upto = _adjusted_upto(pair, prompt, want, **ctl)
        assert got["port"]["tokens"][:upto] == want[:upto]
    else:
        text = got["jax"]["choices"][0]["text"]
        want = [int(t) for t in TOK.encode(text)]
        upto = _stable(want, _adjusted_upto(pair, prompt, want, **ctl))
        assert (got["port"]["choices"][0]["text"][:len(TOK.decode(
            want[:upto]))] == TOK.decode(want[:upto]))
    assert upto >= 4, upto


@pytest.mark.parametrize("route", ["seed", "stream_seed"])
def test_seeded_answers_are_self_consistent(pair, route):
    """A seed's tokens cannot be the JAX server's (threefry against the
    port's counter hash), so both servers answer, and the port gives the
    same tokens for the same seed, blocking or streamed, and other
    tokens for another seed."""
    body = {"text": _TEXT, "max_new": 12, "temperature": 1.0}

    def port(seed, stream=False):
        payload = dict(body, seed=seed)
        if stream:
            return _ndjson(pair["port"], payload)[-1]["tokens"]
        return _json(pair["port"], "/generate", payload)["tokens"]

    if route == "seed":
        oa = {"prompt": _TEXT, "max_tokens": 12, "temperature": 1.0,
              "seed": 3}
        for side in ("jax", "port"):
            assert len(_json(pair[side], "/v1/completions",
                             oa)["choices"]) == 1
        first = port(3)
        assert port(3) == first and port(4) != first
    else:
        assert _ndjson(pair["jax"], dict(body, seed=3))[-1]["done"]
        assert port(3, stream=True) == port(3)


@pytest.mark.parametrize("route", ["echo_logprobs", "prompt_logprobs"])
def test_prompt_logprobs_match_the_jax_server(pair, route):
    """The prompt's logprobs, over /v1/completions' echo with logprobs
    and the native prompt_logprobs, equal the JAX server's within 1e-4
    (the first position null)."""
    if route == "echo_logprobs":
        payload = {"prompt": _TEXT, "echo": True, "logprobs": 1,
                   "max_tokens": 2, "temperature": 0}
        got = {side: _json(pair[side], "/v1/completions", payload)
               for side in ("jax", "port")}
        n = len(TOK.encode(_TEXT))
        lps = {side: got[side]["choices"][0]["logprobs"]["token_logprobs"][:n]
               for side in got}
        for side in got:
            assert got[side]["choices"][0]["text"].startswith(_TEXT)
    else:
        payload = {"text": _TEXT, "max_new": 2, "prompt_logprobs": True}
        lps = {side: _json(pair[side], "/generate",
                           payload)["prompt_logprobs"]
               for side in ("jax", "port")}
    assert lps["port"][0] is None and lps["jax"][0] is None
    np.testing.assert_allclose(lps["port"][1:], lps["jax"][1:], atol=1e-4)
    assert len(lps["port"]) == len(TOK.encode(_TEXT))


def test_unported_get_paths_answer_501(pair):
    for path in ("/kv/prefixes", "/debug/incidents"):
        status, _, body = _request(pair["port"], path)
        assert status == 501 and b"not ported yet" in body, path


@pytest.mark.parametrize("opt", [
    {"profile_dir": "p"}, {"spool_dir": "s"},
    {"incident_dir": "i"}, {"park_dir": "k"}, {"tenant_config": {}},
    {"preempt_after": 1.0}, {"role": "decode"},
])
def test_unported_server_options_raise(opt):
    cfg, params = _tiny()
    with pytest.raises(NotImplementedError):
        InferenceServer(cfg, params, n_slots=2, max_len=64, device=CPU,
                        registry=Registry(), **opt)


@pytest.mark.parametrize("opt", [
    {"autotune": True, "decode_ticks": "auto"},
    {"overlap_decode": True, "overlap_prefill": True},
    {"prefill_chunk": 4, "max_prefills_per_step": 1},
])
def test_pipeline_server_options_serve_the_engine_tokens(opt):
    """The options this server once refused: the startup autotune, the
    overlap pipelines and chunked prefill serve the tokens of a strict
    engine, and the autotune's winner is what the engine runs."""
    cfg, params = _tiny()
    srv = InferenceServer(cfg, params, n_slots=2, max_len=64, device=CPU,
                          registry=Registry(), **opt)
    try:
        got = [srv.generate(p, 6)
               for p in ([1, 2, 3], list(range(5, 17)))]
        eng = srv.engine
        if opt.get("autotune"):
            assert eng.decode_ticks_source == "auto-tuned"
            assert eng.stats["decode_ticks"] == eng.decode_ticks
    finally:
        srv.close()
    want = _engine(batching.BatchingEngine, cfg, params).run(
        [(0, [1, 2, 3], 6), (1, list(range(5, 17)), 6)])
    assert got == [want[0], want[1]]
