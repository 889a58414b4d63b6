"""OpenAI-compatible API translation for the inference server.

Pure request/response translators: OpenAI `/v1/completions` and
`/v1/chat/completions` payloads map onto the native `/generate` payload
schema (inference/server.py), and native results map back into OpenAI
response shapes — so the whole battle-tested native path (continuous
batching, stop sequences, per-request sampling, n/best_of fan-out,
logprobs, streaming cancel, presence/frequency penalties) is reused
rather than reimplemented.

Scope honesty: knobs the engine genuinely implements translate;
accepted-but-ignored knobs are limited to no-op values (e.g. an empty
`suffix`) — a non-neutral unsupported knob is a loud 400, not a
silently different sampling distribution.

The port's own copy of `shellac_tpu/inference/openai_api.py`
(`stream_error_payload` :28, `completion_to_native` :136, `render_chat`
:201, `chat_to_native` :279, `completion_response` :379,
`StreamTranslator` :458), kept as a copy because the port imports
nothing of the JAX package. Tool calling (`tools`, `tool_choice`,
`parallel_tool_calls`, assistant turns carrying `tool_calls`, :202-302,
:409-417, and their streamed deltas) and constrained output
(`response_format` json_object / json_schema, :115-130) translate as in
the reference, through the port's `inference/tools.py`. The sampling
controls (logit_bias, the penalties, seed), echo with logprobs
(:162-172) and `num_beams` with `length_penalty` (:100-105; with a
`response_format` it is a constrained beam search, and each choice
carries its `beam_score`, :404-407) reach the engine.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Dict, List, Optional

from shellac_tpu_torch.inference.tools import (
    parse_payload_tools,
    render_tool_calls,
    tools_prompt_block,
)


def _bad(msg: str):
    raise ValueError(msg)


def stream_error_payload(exc: BaseException,
                         trace_id: Optional[str] = None) -> dict:
    """In-band error record for a stream that already sent its 200.

    Once a stream's headers are gone the HTTP status can no longer
    classify the failure, so the record itself must: `type` follows the
    OpenAI error taxonomy, and `retryable` tells a fronting router
    whether re-issuing the request on ANOTHER replica could succeed.
    Only backpressure outcomes (`ServerUnavailable`: shed deadline,
    draining, recovering — all of which fire before the first token)
    are retryable; a fault or timeout after tokens flowed is not — the
    client has a partial completion a retry would silently duplicate,
    so it must fail loudly instead. ServerUnavailable is duck-typed by
    its `http_status` attribute to keep this module import-free.

    `trace_id` rides the record so a post-200 failure is attributable
    from the client's capture alone: the id resolves to the replica's
    flight-recorder timeline (`GET /debug/request/<id>`) and the
    tier's attempt log."""
    retryable = hasattr(exc, "http_status")
    if retryable:
        etype = "overloaded_error"
    elif isinstance(exc, ValueError):
        etype = "invalid_request_error"
    elif isinstance(exc, TimeoutError):
        etype = "timeout_error"
    else:
        etype = "server_error"
    err: Dict[str, Any] = {"message": str(exc), "type": etype,
                           "retryable": retryable}
    if trace_id is not None:
        err["trace_id"] = trace_id
    return {"error": err}


def _check_unsupported(payload: dict):
    for key, neutral in (
        ("suffix", (None, "")),
    ):
        if key in payload and payload[key] not in neutral:
            _bad(
                f"{key}={payload[key]!r} is not supported by this server "
                "(only the neutral value is accepted)"
            )


def _common_sampling(payload: dict, native: dict):
    if payload.get("temperature") is not None:
        native["temperature"] = float(payload["temperature"])
    if payload.get("top_p") is not None:
        native["top_p"] = float(payload["top_p"])
    if payload.get("top_k") is not None:  # OpenAI-adjacent extension
        native["top_k"] = payload["top_k"]
    if payload.get("seed") is not None:
        native["seed"] = int(payload["seed"])
    stop = payload.get("stop")
    if stop is not None:
        native["stop"] = [stop] if isinstance(stop, str) else list(stop)
    if payload.get("max_tokens") is not None:
        native["max_new"] = int(payload["max_tokens"])
    if payload.get("max_completion_tokens") is not None:
        native["max_new"] = int(payload["max_completion_tokens"])
    n = payload.get("n")
    if n is not None:
        native["n"] = int(n)
    if payload.get("best_of") is not None:
        native["best_of"] = int(payload["best_of"])
    if payload.get("logit_bias") is not None:
        native["logit_bias"] = payload["logit_bias"]
    for key in ("presence_penalty", "frequency_penalty"):
        if payload.get(key) is not None:
            native[key] = float(payload[key])
    if payload.get("num_beams") is not None:
        # OpenAI-adjacent extension (like top_k): deterministic beam
        # search; the ranked beams come back as the choices, each with
        # a `beam_score`. Composes with response_format constraints.
        native["num_beams"] = int(payload["num_beams"])
        if payload.get("length_penalty") is not None:
            native["length_penalty"] = float(payload["length_penalty"])
    if payload.get("timeout") is not None:
        # Native extension: the request deadline. The serving tier
        # forwards each attempt's REMAINING budget through this field
        # so the replica's deadline shedder agrees with the tier on
        # when the request stops being worth prefilling — dropping it
        # here would leave OpenAI-route requests deadline-less on the
        # replica while the tier has already given up and retried.
        native["timeout"] = float(payload["timeout"])
    rf = payload.get("response_format")
    if rf is not None:
        t = rf.get("type") if isinstance(rf, dict) else None
        if t == "json_object":
            native["constraint"] = {"json_object": True}
        elif t == "json_schema":
            js = (rf.get("json_schema") or {})
            schema = js.get("schema") if isinstance(js, dict) else None
            if schema is None:
                _bad(
                    'response_format.json_schema needs a "json_schema": '
                    '{"schema": {...}} block'
                )
            native["constraint"] = {"json_schema": schema}
        elif t not in (None, "text"):
            _bad(f"response_format type {t!r} not supported "
                 "(text, json_object, json_schema)")
    if payload.get("stream"):
        native["stream"] = True


def completion_to_native(payload: dict, tokenizer) -> dict:
    """/v1/completions -> native /generate payload."""
    _check_unsupported(payload)
    for key in ("tools", "tool_choice", "parallel_tool_calls"):
        if payload.get(key) is not None:
            _bad(f"{key} is a chat-completions parameter")
    prompt = payload.get("prompt")
    if prompt is None:
        _bad('"prompt" is required')
    native: Dict[str, Any] = {}
    if isinstance(prompt, str):
        if tokenizer is None:
            _bad("string prompts need a server-side tokenizer")
        native["text"] = prompt
    elif isinstance(prompt, list) and all(
        isinstance(t, int) for t in prompt
    ):
        native["tokens"] = prompt
    else:
        _bad(
            "prompt must be a string or a flat token-id list "
            "(batched prompts are not supported)"
        )
    if payload.get("echo"):
        # Echo returns the prompt in the completion text; with logprobs
        # it additionally scores every prompt token (the engine's
        # prompt_logprobs path). Identity checks: logprobs=0 is a valid
        # OpenAI value (0 == False would silently skip it).
        native["echo"] = True
        _lp = payload.get("logprobs")
        if _lp is not None and _lp is not False:
            native["prompt_logprobs"] = True
    lp = payload.get("logprobs")
    if lp is not None and lp is not False:
        # OpenAI's int-valued logprobs asks for top-k alternatives per
        # position; the engine records them when built with
        # --top-logprobs (the server validates k against that cap).
        # NOTE True == 1 in Python: test booleans FIRST or integer 1
        # would never reach the alternatives branch.
        if lp is True or (not isinstance(lp, bool) and lp == 0):
            native["logprobs"] = True
        elif (not isinstance(lp, bool) and isinstance(lp, int)
              and 1 <= lp <= 5):
            # OpenAI semantics: integer N = the N most-likely tokens
            # per position, N=1 included. "soft": a server that
            # records no alternatives serves N=1 in the pre-top_k
            # sense (chosen token only) instead of 400ing a request
            # shape that always worked.
            native["logprobs"] = True
            native["top_logprobs"] = lp
            native["top_logprobs_soft"] = True
        else:
            _bad(
                f"logprobs={lp!r}: use true/0..5 (k alternatives need "
                "a server built with --top-logprobs >= k)"
            )
    _common_sampling(payload, native)
    return native


# Minimal readable chat rendering for tokenizers without a template
# (the byte tokenizer): stable markers, trailing generation prompt.
_FALLBACK_TEMPLATE_ROLES = ("system", "user", "assistant", "tool")


def render_chat(messages: List[dict], tokenizer,
                tools: Optional[List[dict]] = None) -> str:
    """Messages -> prompt text, via the tokenizer's chat template when
    it has one (HF tokenizers), else a plain fallback format.

    Tool-aware: `tools` (validated function specs) render as a leading
    system turn stating the wire contract (the sentinel + calls-array
    surface the tool grammar enforces). History messages compose the
    other direction: an assistant turn carrying `tool_calls` renders
    back into the exact surface the model emits, and `tool` turns carry
    their `tool_call_id` inline."""
    if not messages:
        _bad('"messages" must be non-empty')
    def content_text(m):
        c = m["content"]
        if isinstance(c, str):
            return c
        if isinstance(c, list):
            # OpenAI content-parts form: text parts concatenate;
            # anything else (images, audio) is refused, not repr()'d
            # into the prompt.
            texts = []
            for part in c:
                if not isinstance(part, dict) or part.get("type") != "text":
                    _bad(
                        "only text content parts are supported; got "
                        f"{part.get('type') if isinstance(part, dict) else part!r}"
                    )
                texts.append(part["text"])
            return "".join(texts)
        _bad(f"message content must be a string or parts list, got {c!r}")

    norm = []
    for m in messages:
        if not isinstance(m, dict) or "role" not in m:
            _bad('each message needs "role" and "content"')
        role = m["role"]
        if role not in _FALLBACK_TEMPLATE_ROLES:
            _bad(f"unknown role {role!r}")
        if role == "assistant" and m.get("tool_calls"):
            # Multi-turn agentic history: the model sees its own past
            # calls in the format it produces (content, when present,
            # precedes them).
            text = content_text(m) if m.get("content") is not None else ""
            calls = render_tool_calls(m["tool_calls"])
            norm.append({"role": role,
                         "content": (text + "\n" + calls) if text
                         else calls})
            continue
        if m.get("content") is None:
            _bad('each message needs "role" and "content" (content may '
                 'be omitted only on assistant turns with tool_calls)')
        text = content_text(m)
        if role == "tool" and m.get("tool_call_id"):
            text = f"[{m['tool_call_id']}] {text}"
        norm.append({"role": role, "content": text})
    if tools:
        norm.insert(0, {"role": "system",
                        "content": tools_prompt_block(tools)})
    if getattr(tokenizer, "chat_template", None):
        try:
            return tokenizer.apply_chat_template(
                norm, add_generation_prompt=True)
        except NotImplementedError:
            raise  # no jinja2 here: a 501, never another rendering
        except Exception as e:
            # A template without a `tool` role (or other rendering
            # fault) must surface as a 400, not a 500.
            _bad(f"chat template failed to render: {e}")
    parts = [f"<|{m['role']}|>\n{m['content']}\n" for m in norm]
    return "".join(parts) + "<|assistant|>\n"


def chat_to_native(payload: dict, tokenizer) -> dict:
    """/v1/chat/completions -> native /generate payload."""
    _check_unsupported(payload)
    if tokenizer is None:
        _bad("chat completions need a server-side tokenizer")
    # Tool calling: validate the OpenAI shapes here (clean 400s),
    # render the tool definitions into the prompt, and forward the keys
    # verbatim; the server compiles the grammar through its DFA cache
    # and parses the constrained output back into tool_calls.
    tool_ctx = parse_payload_tools(payload)
    native: Dict[str, Any] = {
        "text": render_chat(
            payload.get("messages"), tokenizer,
            tools=tool_ctx.functions if tool_ctx is not None else None,
        )
    }
    if tool_ctx is not None:
        native["tools"] = payload["tools"]
        if payload.get("tool_choice") is not None:
            native["tool_choice"] = payload["tool_choice"]
        if payload.get("parallel_tool_calls") is not None:
            native["parallel_tool_calls"] = payload["parallel_tool_calls"]
    if payload.get("logprobs"):
        native["logprobs"] = True
    tl = payload.get("top_logprobs")
    if tl not in (None, 0):
        if not payload.get("logprobs"):
            _bad("top_logprobs needs logprobs=true")
        native["top_logprobs"] = int(tl)
    if payload.get("echo"):
        _bad("echo is a completions-API parameter")
    if payload.get("best_of") is not None:
        _bad("best_of is a completions-API parameter")
    _common_sampling(payload, native)
    return native


def _finish_reason(tokens: list, max_new: int) -> str:
    return "length" if len(tokens) >= max_new else "stop"


def _usage(prompt_tokens: int, completions: List[list]) -> dict:
    out = sum(len(c) for c in completions)
    return {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": out,
        "total_tokens": prompt_tokens + out,
    }


def _lp_block(tokens, lps, tokenizer, tlp=None):
    def tok(t):
        return tokenizer.decode([t]) if tokenizer else str(t)

    top = None
    if tlp is not None:
        # Per position: {token_str: logprob} over the k alternatives
        # (the classic completions-API shape). Distinct ids can decode
        # to the same string (untrained specials, byte fragments) — a
        # plain dict comprehension would silently drop entries, so
        # collide onto an id-tagged key instead.
        def entry_dict(entries):
            d = {}
            for e in entries:
                key = tok(e["id"])
                if not key or key in d:
                    key = f"{key}<id:{e['id']}>"
                d[key] = e["logprob"]
            return d

        top = [entry_dict(entries) for entries in tlp]
    return {
        "tokens": [tok(t) for t in tokens],
        "token_logprobs": list(lps),
        "top_logprobs": top,
        "text_offset": None,
    }


def _chat_content(tokens, lps, tlp, tokenizer):
    """OpenAI chat logprobs content list: {token, logprob[,
    top_logprobs]} per position — the one function both the blocking
    response and the SSE finish chunk use."""
    def tok(t):
        return tokenizer.decode([t]) if tokenizer else str(t)

    content = []
    for j, (t, l) in enumerate(zip(tokens, lps)):
        item = {"token": t, "logprob": l}
        if tlp is not None:
            item["top_logprobs"] = [
                {"token": tok(e["id"]), "logprob": e["logprob"]}
                for e in tlp[j]
            ]
        content.append(item)
    return content


def completion_response(
    native_result: dict, *, model: str, prompt_tokens: int, max_new: int,
    tokenizer, chat: bool, echo: bool = False, prompt_ids=None,
) -> dict:
    """Native handle() result -> OpenAI response object.

    echo (completions only): the prompt text prepends each choice's
    text, and — when the native result carries prompt_logprobs — the
    logprobs block covers prompt tokens too (first token null, the
    OpenAI convention)."""
    raw_choices = native_result.get("choices") or [native_result]
    choices = []
    prompt_text = ""
    if echo and prompt_ids is not None:
        prompt_text = (tokenizer.decode(prompt_ids) if tokenizer
                       else str(prompt_ids))
    for i, c in enumerate(raw_choices):
        toks = c["tokens"]
        text = c.get("text")
        if text is None:
            text = tokenizer.decode(toks) if tokenizer else str(toks)
        entry: Dict[str, Any] = {
            "index": i,
            "finish_reason": _finish_reason(toks, max_new),
        }
        if "beam_score" in c:
            # num_beams: the beam's length-penalized score rides its
            # choice.
            entry["beam_score"] = c["beam_score"]
        if chat:
            if c.get("tool_calls") is not None:
                # The DFA-constrained tool branch parsed back into calls:
                # a null-content assistant message and finish_reason
                # "tool_calls" (the parse only succeeds on a complete
                # calls array).
                entry["message"] = {"role": "assistant", "content": None,
                                    "tool_calls": c["tool_calls"]}
                entry["finish_reason"] = "tool_calls"
            else:
                # Tool-enabled requests carry the decided free text in
                # "content" (a truncated tool branch falls back here
                # rather than fabricating a call).
                entry["message"] = {"role": "assistant",
                                    "content": c.get("content", text)}
        else:
            entry["text"] = (prompt_text + text) if echo else text
        if c.get("logprobs") is not None:
            tlp = c.get("top_logprobs")
            lp = _lp_block(toks, c["logprobs"], tokenizer, tlp=tlp)
            if echo and native_result.get("prompt_logprobs") is not None:
                plp = native_result["prompt_logprobs"]
                pl = _lp_block(prompt_ids or [], plp, tokenizer)
                lp = {
                    "tokens": pl["tokens"] + lp["tokens"],
                    "token_logprobs": (pl["token_logprobs"]
                                       + lp["token_logprobs"]),
                    "top_logprobs": ([None] * len(pl["tokens"])
                                     + lp["top_logprobs"]
                                     if lp["top_logprobs"] else None),
                    "text_offset": None,
                }
            if chat:
                entry["logprobs"] = {"content": _chat_content(
                    lp["tokens"], lp["token_logprobs"], tlp, tokenizer
                )}
            else:
                entry["logprobs"] = lp
        choices.append(entry)
    return {
        "id": ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:24],
        "object": "chat.completion" if chat else "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": choices,
        "usage": _usage(prompt_tokens, [c["tokens"] for c in raw_choices]),
    }


class StreamTranslator:
    """Accumulates native stream records into OpenAI SSE chunk objects.

    Text deltas come from cumulative decode (decode(all) minus what was
    already emitted) so multi-token characters never split mid-byte.

    tool_mode (chat with tools, tool_choice != "none"): the native
    records' `tool_stream` field, produced by the server's one
    incremental scanner, replaces the raw-text delta path: decided free
    text arrives as `delta.content`, call fragments as OpenAI
    `delta.tool_calls` items, and a final record carrying the complete
    `tool_calls` finishes with `finish_reason: "tool_calls"`.
    """

    def __init__(self, *, model: str, tokenizer, chat: bool,
                 tool_mode: bool = False):
        self.model = model
        self.tokenizer = tokenizer
        self.chat = chat
        self.tool_mode = tool_mode
        self.id = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:24]
        self.created = int(time.time())
        self._tokens: List[int] = []
        self._emitted = ""
        self.first = True

    def _chunk(self, delta_text: Optional[str], finish: Optional[str]):
        if self.chat:
            delta: Dict[str, Any] = {}
            if self.first and delta_text is not None:
                delta["role"] = "assistant"
            if delta_text:
                delta["content"] = delta_text
            choice = {"index": 0, "delta": delta, "finish_reason": finish}
        else:
            choice = {
                "index": 0, "text": delta_text or "", "finish_reason": finish,
            }
        self.first = False
        return {
            "id": self.id,
            "object": ("chat.completion.chunk" if self.chat
                       else "text_completion"),
            "created": self.created,
            "model": self.model,
            "choices": [choice],
        }

    def _tool_chunk(self, tool_stream: Optional[dict],
                    finish: Optional[str] = None):
        delta: Dict[str, Any] = {}
        if self.first and finish is None:
            delta["role"] = "assistant"
        if tool_stream:
            if tool_stream.get("content"):
                delta["content"] = tool_stream["content"]
            if tool_stream.get("tool_calls"):
                delta["tool_calls"] = tool_stream["tool_calls"]
        choice = {"index": 0, "delta": delta, "finish_reason": finish}
        self.first = False
        return {
            "id": self.id,
            "object": "chat.completion.chunk",
            "created": self.created,
            "model": self.model,
            "choices": [choice],
        }

    def _feed_tools(self, record: dict, max_new: int):
        out = []
        ts = record.get("tool_stream")
        if ts:
            out.append(self._tool_chunk(ts))
        if not record.get("done"):
            return out
        self._tokens = list(record["tokens"])
        finish = self._tool_chunk(
            None,
            ("tool_calls" if record.get("tool_calls") is not None
             else _finish_reason(self._tokens, max_new)),
        )
        if record.get("logprobs") is not None:
            tlp = record.get("top_logprobs")
            lp = _lp_block(self._tokens, record["logprobs"],
                           self.tokenizer, tlp=tlp)
            finish["choices"][0]["logprobs"] = {
                "content": _chat_content(
                    lp["tokens"], lp["token_logprobs"], tlp,
                    self.tokenizer,
                )
            }
        out.append(finish)
        return out

    def feed(self, record: dict, max_new: int):
        """Native stream record -> list of SSE chunk objects."""
        if self.tool_mode:
            return self._feed_tools(record, max_new)
        if record.get("done"):
            # The engine's final record carries the authoritative token
            # list (stop-sequence holdback may have trimmed the tail).
            self._tokens = list(record["tokens"])
            out = []
            if self.tokenizer is not None:
                text = self.tokenizer.decode(self._tokens)
                if len(text) > len(self._emitted):
                    out.append(self._chunk(text[len(self._emitted):], None))
                    self._emitted = text
            # else: per-delta debug strings are not prefix-additive, so
            # there is no reconcilable tail to emit.
            finish = self._chunk(
                None, _finish_reason(self._tokens, max_new)
            )
            if record.get("logprobs") is not None:
                # Requested logprobs ride the finish chunk (the engine
                # delivers them once, on the final record).
                tlp = record.get("top_logprobs")
                lp = _lp_block(self._tokens, record["logprobs"],
                               self.tokenizer, tlp=tlp)
                if self.chat:
                    finish["choices"][0]["logprobs"] = {
                        "content": _chat_content(
                            lp["tokens"], lp["token_logprobs"], tlp,
                            self.tokenizer,
                        )
                    }
                else:
                    finish["choices"][0]["logprobs"] = lp
            out.append(finish)
            return out
        self._tokens.extend(record["tokens"])
        if self.tokenizer is None:
            return [self._chunk(str(record["tokens"]), None)]
        text = self.tokenizer.decode(self._tokens)
        if len(text) <= len(self._emitted):
            return []
        delta, self._emitted = text[len(self._emitted):], text
        return [self._chunk(delta, None)]
