"""The port's tool calling and constrained output against the JAX
package's, on the CPU.

`shellac_tpu_torch/inference/tools.py` is a copy of the reference's pure
Python module: its grammars, payload validation (with the same error
messages), stream parser events at several chunk sizes, parse-back,
rendering and prompt block equal the reference's on the same inputs
(call ids, random per call, compared by shape).

Over the port's HTTP server (tiny preset, fp32, vocab 259 so the byte
tokenizer's EOS 257 is a real row, greedy): `response_format`
json_schema and a native tools request give the JAX `BatchingEngine`'s
constrained greedy tokens (compared while the top-2 margin among the
tokens the DFA allows is at least twice the logit tolerance of 1e-4),
and JSON that parses; tools `required`, a named tool, `auto` over a
multi-turn chat with a `tool` turn, and `none` behave as
tests/test_tools.py::TestToolCallingHTTP expects of the reference;
streamed tool-call deltas reassemble into the non-streamed call; the bad
compositions answer 400; the constraint and tool metric families are
exported. Schemas are bounded (enums), so greedy decoding ends with EOS.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shellac_tpu.inference import batching as jbatching
from shellac_tpu.inference import constraints as jcon
from shellac_tpu.inference import openai_api as jopenai
from shellac_tpu.inference import tools as jtools
from shellac_tpu.models.registry import get_model_config as jget
from shellac_tpu_torch.inference import constraints as tcon
from shellac_tpu_torch.inference import openai_api, tools
from shellac_tpu_torch.inference.server import (
    InferenceServer,
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
EOS = ByteTokenizer.EOS  # 257
VOCAB = ByteTokenizer.vocab_size  # 259


def _fn(name, params, description=""):
    return {"type": "function", "function": {
        "name": name, "description": description, "parameters": params,
    }}


WEATHER = _fn("get_weather", {
    "type": "object",
    "properties": {"city": {"enum": ["oslo", "rio"]},
                   "days": {"enum": [1, 2, 3]}},
    "required": ["city", "days"],
}, description="weather lookup")
CALC = _fn("calc", {
    "type": "object",
    "properties": {"op": {"enum": ["add", "mul"]}},
    "required": ["op"],
})
PICK = _fn("pick", {
    "$defs": {"c": {"enum": ["oslo", "rio"]}}, "type": "object",
    "properties": {"city": {"$ref": "#/$defs/c"}}, "required": ["city"]})
LOG = _fn("log", None)
CALL = '{"name":"get_weather","arguments":{"city":"oslo","days":2}}'
SURFACE = (tools.SENTINEL + "[" + CALL + ","
           + '{"name":"calc","arguments":{"op":"mul"}}' + "]")


# --------------------------------------------------------------------------
# the pure functions
# --------------------------------------------------------------------------


_PAYLOADS = {
    "none_given": {},
    "auto": {"tools": [WEATHER, CALC]},
    "required": {"tools": [WEATHER, CALC], "tool_choice": "required"},
    "named": {"tools": [WEATHER, CALC], "tool_choice": {
        "type": "function", "function": {"name": "calc"}}},
    "serial": {"tools": [WEATHER], "tool_choice": "required",
               "parallel_tool_calls": False},
    "off": {"tools": [WEATHER], "tool_choice": "none"},
    "ref_params": {"tools": [PICK], "tool_choice": "required"},
    "undeclared_params": {"tools": [LOG], "tool_choice": "required"},
    "bad_empty": {"tools": []},
    "bad_type": {"tools": [{"type": "retrieval"}]},
    "bad_name": {"tools": [_fn("bad name!", None)]},
    "bad_duplicate": {"tools": [_fn("a", None), _fn("a", None)]},
    "bad_schema": {"tools": [_fn("a", "not-a-schema")]},
    "bad_unknown": {"tools": [WEATHER], "tool_choice": {
        "type": "function", "function": {"name": "ghost"}}},
    "bad_choice": {"tools": [WEATHER], "tool_choice": "sometimes"},
    "bad_parallel": {"tools": [WEATHER], "parallel_tool_calls": "yes"},
    "bad_choice_alone": {"tool_choice": "required"},
    "bad_cyclic": {"tools": [_fn("loopy", {
        "$defs": {"a": {"$ref": "#/$defs/a"}}, "type": "object",
        "properties": {"x": {"$ref": "#/$defs/a"}}, "required": ["x"]})],
        "tool_choice": "required"},
}


def _ctx(parse, payload):
    """A ToolContext as plain fields, or the error's type and message."""
    try:
        ctx = parse(payload)
        if ctx is None:
            return None
        return (ctx.mode, ctx.pattern, ctx.functions, ctx.forced_name,
                ctx.parallel)
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("case", sorted(_PAYLOADS))
def test_payloads_and_grammars_equal_the_reference(case):
    payload = _PAYLOADS[case]
    got = _ctx(tools.parse_payload_tools, payload)
    assert got == _ctx(jtools.parse_payload_tools, payload)
    if got is not None and got[0] != "error":
        for parallel in (True, False):
            assert (tools.tool_grammar(got[2], got[0], got[3], parallel)
                    == jtools.tool_grammar(got[2], got[0], got[3], parallel))
        assert (tools.tools_prompt_block(got[2])
                == jtools.tools_prompt_block(got[2]))


def _no_ids(events):
    """Stream events with the per-call random ids replaced by their
    shape."""
    out = []
    for kind, val in events:
        if isinstance(val, dict) and "id" in val:
            assert val["id"].startswith("call_")
            val = dict(val, id="call_")
        out.append((kind, val))
    return out


def _feed(mod, mode, text, size):
    p = mod.ToolCallStreamParser(mode)
    events = []
    for i in range(size, len(text) + size, size):
        events.extend(p.feed(mod.safe_stream_text(text[:i])))
    events.extend(p.feed(text))
    calls = p.result()
    if calls is not None:
        calls = [dict(c, id="call_") for c in calls]
    return _no_ids(events), calls, p.broken


_TEXTS = {
    "required": ("required", SURFACE),
    "auto_text": ("auto", "well, hello <b> there"),
    "auto_call": ("auto", tools.SENTINEL + "[" + CALL + "]"),
    "withheld": ("auto", "<too"),
    "truncated": ("required", tools.SENTINEL + "[" + CALL[:20]),
    "broken": ("required", tools.SENTINEL + "[oops]"),
    "unicode": ("auto", "да, 日本 ok"),
}


@pytest.mark.parametrize("size", [1, 3, 7, 1000])
def test_stream_parser_equals_the_reference(size):
    for mode, text in _TEXTS.values():
        got = _feed(tools, mode, text, size)
        assert got == _feed(jtools, mode, text, size)
        content, calls = tools.parse_tool_calls(text, mode)
        jcontent, jcalls = jtools.parse_tool_calls(text, mode)
        assert content == jcontent
        assert ((calls is None and jcalls is None)
                or [dict(c, id="") for c in calls]
                == [dict(c, id="") for c in jcalls])
        ev = got[0]
        assert tools.events_to_stream(ev) == jtools.events_to_stream(ev)


def test_rendering_equals_the_reference():
    calls = [{"id": "call_1", "type": "function", "function": {
        "name": "get_weather", "arguments": '{"city":"oslo","days":2}'}},
        {"id": "call_2", "type": "function", "function": {
            "name": "calc", "arguments": {"op": "add"}}}]
    assert tools.render_tool_calls(calls) == jtools.render_tool_calls(calls)
    for text in ("ab�", "ab", "", "�"):
        assert tools.safe_stream_text(text) == jtools.safe_stream_text(text)
    fns = tools.parse_payload_tools({"tools": [WEATHER, CALC]}).functions
    for msgs in (_MULTI_TURN, _user("hi")):
        assert (openai_api.render_chat(msgs, TOK, tools=fns)
                == jopenai.render_chat(msgs, TOK, tools=fns))
    body = _chat(_MULTI_TURN, tool_choice="auto")
    assert (openai_api.chat_to_native(body, TOK)
            == jopenai.chat_to_native(body, TOK))
    rf = {"messages": _user("x"), "response_format": _SCHEMA_FORMAT}
    assert (openai_api.chat_to_native(rf, TOK)
            == jopenai.chat_to_native(rf, TOK))


# --------------------------------------------------------------------------
# over the port's HTTP server
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    jc = jget("tiny").replace(dtype="float32", vocab_size=VOCAB)
    tc = get_model_config("tiny").replace(dtype="float32", vocab_size=VOCAB)
    p = jax_params.init_params(jc)
    return jc, tc, jax.tree.map(jnp.asarray, p), params_from_jax(tc, p, CPU)


@pytest.fixture(scope="module")
def http_srv(model):
    _, tc, _, tp = model
    srv = InferenceServer(tc, tp, tokenizer=TOK, model_name="tiny",
                          n_slots=2, max_len=1024, temperature=0.0,
                          eos_id=EOS, registry=Registry(), device=CPU)
    httpd = make_http_server(srv)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    srv.close()


def _post(base, path, payload):
    req = urllib.request.Request(
        base + path, json.dumps(payload).encode(),
        {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _status(base, path, payload):
    try:
        _post(base, path, payload)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()
    return 200, ""


def _stream(base, path, payload):
    """SSE chunks (OpenAI routes) or ndjson records (/generate)."""
    req = urllib.request.Request(
        base + path, json.dumps(dict(payload, stream=True)).encode(),
        {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        lines = r.read().decode().splitlines()
    if path == "/generate":
        return [json.loads(ln) for ln in lines if ln]
    data = [ln[len("data: "):] for ln in lines if ln.startswith("data: ")]
    assert data[-1] == "[DONE]"
    return [json.loads(d) for d in data[:-1]]


def _chat(messages, **kw):
    return {"messages": messages, "max_tokens": 120,
            "tools": [WEATHER, CALC], "parallel_tool_calls": False, **kw}


def _user(text):
    return [{"role": "user", "content": text}]


_MULTI_TURN = [
    {"role": "user", "content": "weather in oslo?"},
    {"role": "assistant", "content": None, "tool_calls": [
        {"id": "call_h1", "type": "function", "function": {
            "name": "get_weather",
            "arguments": '{"city":"oslo","days":1}'}}]},
    {"role": "tool", "tool_call_id": "call_h1", "content": "sunny, 21C"},
]
_SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"}, "mood": {"enum": ["calm", "glad"]}},
    "required": ["ok", "mood"]}
_SCHEMA_FORMAT = {"type": "json_schema",
                  "json_schema": {"name": "out", "schema": _SCHEMA}}


def _reassemble(chunks):
    """OpenAI-client reassembly: index-keyed calls, id and name from the
    head delta, arguments concatenated across fragments."""
    calls, content, finish = {}, "", None
    for c in chunks:
        choice = c["choices"][0]
        finish = choice["finish_reason"] or finish
        d = choice["delta"]
        content += d.get("content") or ""
        for item in d.get("tool_calls", []):
            slot = calls.setdefault(item["index"],
                                    {"id": None, "name": None, "args": ""})
            if "id" in item:
                slot["id"] = item["id"]
                slot["name"] = item["function"]["name"]
            slot["args"] += item["function"].get("arguments", "")
    return calls, content, finish


def _walk(dfa, tokens):
    """Walk `tokens` through the DFA: every token legal, every state's
    mask non-trivial."""
    st = 0
    for t in tokens:
        row = dfa.trans[st]
        assert (row[:-1] < 0).any()
        nxt = row[-1] if t == EOS else row[t]
        assert nxt >= 0, (st, t)
        st = int(nxt)


_JAX = {}


def _jax_greedy(model, prompt, pattern, max_new):
    """The JAX engine's constrained greedy tokens for one request, and
    how many lead with a top-2 margin >= MARGIN among the allowed tokens
    (from a plain fp32 forward of the port's model)."""
    jc, tc, jp, tp = model
    if "jax" not in _JAX:
        _JAX["jax"] = jbatching.BatchingEngine(
            jc, jp, n_slots=1, max_len=256, temperature=0.0, eos_id=EOS,
            decode_ticks=8)
    eng = _JAX["jax"]
    dfa = jcon.compile_token_dfa(pattern, TOK, VOCAB, EOS)
    eng.submit("r", prompt, max_new, constraint=dfa)
    out = eng.run()["r"]
    ids = np.asarray([list(prompt) + out], np.int64)
    logits = tt.forward(tc, tp, ids, device=CPU)[0].detach().numpy()
    st, upto = 0, len(out)
    for j, tok in enumerate(out):
        allowed = dfa.trans[st, :-1] >= 0
        allowed[EOS] = dfa.trans[st, -1] >= 0
        row = np.where(allowed, logits[len(prompt) + j - 1], -np.inf)
        top = np.sort(row)[-2:]
        if top[1] - top[0] < MARGIN:
            upto = j
            break
        st = int(dfa.trans[st, -1 if tok == EOS else tok])
    return out, upto


def test_response_format_json_schema_matches_jax(model, http_srv):
    body = {"messages": _user("emit json"), "max_tokens": 60,
            "temperature": 0, "response_format": _SCHEMA_FORMAT}
    r = _post(http_srv, "/v1/chat/completions", body)
    content = r["choices"][0]["message"]["content"]
    v = json.loads(content)
    assert set(v) == {"ok", "mood"} and isinstance(v["ok"], bool)
    prompt = TOK.encode(openai_api.render_chat(body["messages"], TOK))
    pattern = tcon.constraint_pattern({"json_schema": _SCHEMA})
    want, upto = _jax_greedy(model, prompt, pattern, 60)
    assert want[-1] == EOS and upto >= len(want) // 2
    got = TOK.encode(content).tolist() + [EOS]
    assert got[:upto] == want[:upto]
    # The same schema streamed reassembles to the same JSON.
    chunks = _stream(http_srv, "/v1/chat/completions", body)
    text = "".join(c["choices"][0]["delta"].get("content") or ""
                   for c in chunks)
    assert text == content


def test_native_tools_match_jax_and_walk_the_dfa(model, http_srv):
    payload = {"text": "weather? ", "max_new": 120, "tools": [WEATHER],
               "tool_choice": "required", "parallel_tool_calls": False}
    r = _post(http_srv, "/generate", payload)
    (call,) = r["tool_calls"]
    args = json.loads(call["function"]["arguments"])
    assert args["city"] in ("oslo", "rio") and args["days"] in (1, 2, 3)
    ctx = tools.parse_payload_tools(payload)
    _walk(tcon.compile_token_dfa(ctx.pattern, TOK, VOCAB, EOS),
          r["tokens"])
    want, upto = _jax_greedy(model, TOK.encode("weather? "), ctx.pattern,
                             120)
    assert upto >= len(want) // 2
    assert r["tokens"][:upto] == want[:upto]
    # ndjson: the tool_stream deltas reassemble into the call.
    recs = _stream(http_srv, "/generate", payload)
    assert recs[-1]["done"] and recs[-1]["tokens"] == r["tokens"]
    args = "".join(
        item["function"].get("arguments", "")
        for rec in recs for item in (rec.get("tool_stream") or {})
        .get("tool_calls", []))
    assert args == call["function"]["arguments"]
    assert recs[-1]["tool_calls"][0]["function"] == call["function"]


@pytest.mark.parametrize("choice", ["required", "named", "auto_multi_turn",
                                    "none"])
def test_tool_choice_over_chat(http_srv, choice):
    if choice == "named":
        for name in ("get_weather", "calc"):
            r = _post(http_srv, "/v1/chat/completions", _chat(
                _user("do something"), tool_choice={
                    "type": "function", "function": {"name": name}}))
            (tc,) = r["choices"][0]["message"]["tool_calls"]
            assert tc["function"]["name"] == name
        return
    if choice == "none":
        r = _post(http_srv, "/v1/chat/completions",
                  _chat(_user("hi"), tool_choice="none"))
        msg = r["choices"][0]["message"]
        assert isinstance(msg["content"], str) and "tool_calls" not in msg
        return
    msgs = _MULTI_TURN if choice == "auto_multi_turn" else _user(
        "weather in oslo?")
    body = _chat(msgs, tool_choice=choice.split("_")[0])
    ch = _post(http_srv, "/v1/chat/completions", body)["choices"][0]
    msg = ch["message"]
    if choice == "required":
        assert ch["finish_reason"] == "tool_calls"
    if ch["finish_reason"] == "tool_calls":
        assert msg["content"] is None
        (tc,) = msg["tool_calls"]
        assert tc["type"] == "function" and tc["id"].startswith("call_")
        args = json.loads(tc["function"]["arguments"])
        if tc["function"]["name"] == "get_weather":
            assert set(args) == {"city", "days"}
        else:
            assert args["op"] in ("add", "mul")
    else:
        assert isinstance(msg["content"], str) and "tool_calls" not in msg
    # Streamed: the deltas reassemble to the non-streamed turn.
    calls, content, finish = _reassemble(
        _stream(http_srv, "/v1/chat/completions", body))
    assert finish == ch["finish_reason"]
    if finish == "tool_calls":
        assert content == ""
        assert calls[0]["name"] == tc["function"]["name"]
        assert calls[0]["args"] == tc["function"]["arguments"]
    else:
        assert content == msg["content"] and not calls


_BAD = {
    "tools_on_completions": ("/v1/completions",
                             {"prompt": "x", "tools": [WEATHER]},
                             "chat-completions"),
    "tools_with_num_beams": ("/v1/chat/completions",
                             {"messages": _user("x"), "tools": [WEATHER],
                              "num_beams": 2}, "num_beams"),
    "tools_with_constraint": ("/generate",
                              {"text": "x", "tools": [WEATHER],
                               "constraint": {"regex": "a+"}},
                              "constraint"),
    "tool_choice_alone": ("/v1/chat/completions",
                          {"messages": _user("x"),
                           "tool_choice": "required"}, "tools"),
    "tools_with_prefill_only": ("/generate",
                                {"text": "x", "tools": [WEATHER],
                                 "prefill_only": True,
                                 "migrate_to": "http://x"},
                                "prefill_only"),
    "constraint_with_prefill_only": ("/generate",
                                     {"text": "x", "prefill_only": True,
                                      "migrate_to": "http://x",
                                      "constraint": {"regex": "a+"}},
                                     "prefill_only"),
    "bad_regex": ("/generate", {"text": "x", "max_new": 4,
                                "constraint": {"regex": "(unclosed"}},
                  "unclosed"),
    "bad_schema_block": ("/v1/chat/completions",
                         {"messages": _user("x"), "response_format": {
                             "type": "json_schema", "json_schema": {}}},
                         "json_schema"),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_bad_compositions_answer_400(http_srv, case):
    path, payload, msg = _BAD[case]
    status, body = _status(http_srv, path, payload)
    assert status == 400, (status, body)
    assert msg in body


def test_constraint_and_tool_metrics_exported(http_srv):
    # A repeated pattern compiles once: a miss, then hits.
    for _ in range(2):
        _post(http_srv, "/generate", {"text": "x", "max_new": 6,
                                      "constraint": {"regex": "[ab]{2,4}"}})
    with urllib.request.urlopen(http_srv + "/metrics", timeout=30) as r:
        body = r.read().decode()
    assert "shellac_tool_requests_total" in body
    assert "shellac_constraint_compile_seconds_count" in body
    hits = [ln for ln in body.splitlines()
            if ln.startswith('shellac_constraint_cache_total{result="hit"}')]
    misses = [ln for ln in body.splitlines()
              if ln.startswith('shellac_constraint_cache_total{result="miss"}')]
    assert hits and float(hits[0].split()[-1]) >= 1
    assert misses and float(misses[0].split()[-1]) >= 1
