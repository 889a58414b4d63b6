"""OpenAI tool calling over the byte-DFA constraint engine.

The port's own copy of `shellac_tpu/inference/tools.py` (`ToolContext`,
`tool_grammar` :180, `parse_payload_tools` :195, `tools_prompt_block`
:240, `render_tool_calls` :264, `ToolCallStreamParser` :290,
`parse_tool_calls` :474, `events_to_stream` :489, `safe_stream_text`
:509), kept as a copy because the port imports nothing of the JAX
package; it compiles through the port's `inference/constraints.py`.

The subsystem that turns `tools` / `tool_choice` on a chat (or native)
request into a GRAMMAR, not a prayer: every tool call the model emits
is constrained token-by-token by the same schema->DFA compiler that
powers `response_format` (inference/constraints.py), so `arguments`
always parse as JSON and always validate against the declared
parameter schema — enforcement happens in the logit mask, not in a
retry loop.

Wire shape (the constrained model output):

    <tool_call>[{"name":"get_weather","arguments":{"city":"oslo"}}]

- A SENTINEL prefix marks the tool branch. `tool_choice: "required"`
  (or a named tool) compiles to `sentinel + calls-array` — the model
  CANNOT answer with free text. `"auto"` compiles to
  `(sentinel + calls-array | free-text)` where free-text is any
  output that does not start with the sentinel's first character:
  the model keeps its choice, but the instant it starts the sentinel
  it is committed to a well-formed call. `"none"` compiles nothing.
- The calls array is non-empty (`[call]` or `[call(,call)*]` with
  `parallel_tool_calls`), each call an anyOf over the declared tools:
  `{"name": <const>, "arguments": <declared parameter schema>}` in
  fixed property order — which is what makes incremental parsing
  trivial and exact.

Parsing back is a small character machine (`ToolCallStreamParser`)
shared by the non-streamed response, ndjson streaming, and SSE
streaming, so the streamed `arguments` fragments concatenate to
byte-identical JSON with the non-streamed result.
"""

from __future__ import annotations

import json
import re
import uuid
from typing import Any, Dict, List, Optional, Tuple

# Same escape set the constraint compiler uses for literals; the
# sentinel must pass through _Regex verbatim.
from shellac_tpu_torch.inference.constraints import (
    _escape_literal as _escape_regex,
)
from shellac_tpu_torch.inference.constraints import constraint_pattern

#: The tool-branch marker. Chosen printable-ASCII so every tokenizer's
#: byte surface covers it; '<' as the first character is what the
#: "auto" free-text branch excludes (see tool_grammar).
SENTINEL = "<tool_call>"

# Free text = anything NOT starting the sentinel (or nothing). Only
# the FIRST character is excluded — '<' later in the text is fine —
# so entering the sentinel is an explicit first-token decision.
_FREE_TEXT = r"([^<][\s\S]*)?"

# OpenAI function-name contract (letters, digits, _ . -, <= 64). Also
# what keeps the grammar and the stream parser simple: json.dumps of a
# valid name contains no escape sequences.
_NAME_RE = re.compile(r"^[A-Za-z0-9_.\-]{1,64}$")


class ToolContext:
    """Validated per-request tool state: the declared functions, the
    resolved choice mode, and the grammar pattern (None when
    `tool_choice: "none"` — tools are rendered into the prompt but
    the output is unconstrained and never parsed).

    `pattern` builds LAZILY on first access: the OpenAI facade parses
    the payload only to validate shapes and render the prompt, then
    the server parses it again to compile the constraint — per-tool
    schema lowering is the expensive half, and only the server's copy
    needs it. Schema errors therefore surface at pattern access; both
    call sites turn ValueError into a 400."""

    __slots__ = ("functions", "mode", "forced_name", "parallel",
                 "_pattern")

    def __init__(self, functions: List[dict], mode: str,
                 forced_name: Optional[str], parallel: bool):
        self.functions = functions
        self.mode = mode            # "auto" | "required" | "named" | "none"
        self.forced_name = forced_name
        self.parallel = parallel
        self._pattern: Optional[str] = None

    @property
    def pattern(self) -> Optional[str]:
        if self.mode == "none":
            return None
        if self._pattern is None:
            self._pattern = tool_grammar(
                self.functions, self.mode, self.forced_name,
                self.parallel,
            )
        return self._pattern


def _validate_functions(tools: Any) -> List[dict]:
    if not isinstance(tools, list) or not tools:
        raise ValueError('"tools" must be a non-empty list')
    out: List[dict] = []
    seen = set()
    for t in tools:
        if not isinstance(t, dict):
            raise ValueError(f"bad tool entry {t!r}")
        if t.get("type", "function") != "function":
            raise ValueError(
                f"tool type {t.get('type')!r} not supported (function)"
            )
        fn = t.get("function")
        if not isinstance(fn, dict) or "name" not in fn:
            raise ValueError(
                'each tool needs {"type": "function", "function": '
                '{"name": ...}}'
            )
        name = fn["name"]
        if not isinstance(name, str) or not _NAME_RE.match(name):
            raise ValueError(
                f"bad tool name {name!r} (letters, digits, _ . -, "
                "max 64 chars)"
            )
        if name in seen:
            raise ValueError(f"duplicate tool name {name!r}")
        seen.add(name)
        params = fn.get("parameters")
        if params is not None and not isinstance(params, dict):
            raise ValueError(
                f"tool {name!r}: parameters must be a JSON schema object"
            )
        out.append({
            "name": name,
            "description": fn.get("description") or "",
            "parameters": params,
        })
    return out


def _shift_local_refs(node: Any, prefix: str) -> Any:
    """Rewrite every local `$ref` (`#/...`) by `prefix` so a schema
    embedded at that location inside a synthesized wrapper document
    still resolves its references against ITS OWN root, per JSON
    Schema semantics — `#/$defs/x` in a tool's parameters must not be
    looked up in the wrapper."""
    if isinstance(node, dict):
        return {
            k: ("#" + prefix + v[1:]
                if k == "$ref" and isinstance(v, str)
                and v.startswith("#")
                else _shift_local_refs(v, prefix))
            for k, v in node.items()
        }
    if isinstance(node, list):
        return [_shift_local_refs(x, prefix) for x in node]
    return node


def _call_regex(fn: dict) -> str:
    """One call object `{"name": <const>, "arguments": <schema>}` as a
    regex, via the SAME schema->regex lowering `response_format` uses
    (fixed property order, $ref/format/additionalProperties rules and
    depth limit included — docs/structured_output.md)."""
    params = fn["parameters"]
    if params is None:
        # Undeclared parameters: any JSON object (depth-limited
        # generic grammar), the OpenAI default.
        params = {"type": "object"}
    # The parameters schema lands under /properties/arguments of the
    # wrapper document; its local refs must follow it there.
    params = _shift_local_refs(params, "/properties/arguments")
    return constraint_pattern({"json_schema": {
        "type": "object",
        "properties": {"name": {"const": fn["name"]},
                       "arguments": params},
        "required": ["name", "arguments"],
    }})


def tool_grammar(functions: List[dict], mode: str,
                 forced_name: Optional[str] = None,
                 parallel: bool = True) -> str:
    """The full output grammar for one request's tool configuration."""
    fns = functions
    if mode == "named":
        fns = [f for f in functions if f["name"] == forced_name]
    call = "(" + "|".join(_call_regex(f) for f in fns) + ")"
    arr = r"\[" + call + ("(," + call + ")*" if parallel else "") + r"\]"
    pat = _escape_regex(SENTINEL) + arr
    if mode == "auto":
        pat = "(" + pat + "|" + _FREE_TEXT + ")"
    return pat


def parse_payload_tools(payload: dict) -> Optional[ToolContext]:
    """Validate `tools` / `tool_choice` / `parallel_tool_calls` on a
    request payload. Returns None when the request declares no tools;
    raises ValueError (-> HTTP 400) on malformed shapes."""
    tools = payload.get("tools")
    choice = payload.get("tool_choice")
    if tools is None:
        if choice not in (None, "none"):
            raise ValueError("tool_choice needs a non-empty tools list")
        return None
    functions = _validate_functions(tools)
    parallel = payload.get("parallel_tool_calls")
    if parallel is None:
        parallel = True
    if not isinstance(parallel, bool):
        raise ValueError("parallel_tool_calls must be a boolean")
    forced = None
    if choice is None or choice == "auto":
        mode = "auto"
    elif choice == "none":
        mode = "none"
    elif choice == "required":
        mode = "required"
    elif isinstance(choice, dict):
        fn = choice.get("function")
        if (choice.get("type", "function") != "function"
                or not isinstance(fn, dict) or "name" not in fn):
            raise ValueError(
                'named tool_choice must be {"type": "function", '
                '"function": {"name": ...}}'
            )
        forced = fn["name"]
        if forced not in {f["name"] for f in functions}:
            raise ValueError(
                f"tool_choice names unknown tool {forced!r}"
            )
        mode = "named"
    else:
        raise ValueError(
            f"bad tool_choice {choice!r} "
            '(auto | none | required | {"type": "function", ...})'
        )
    return ToolContext(functions, mode, forced, parallel)


def tools_prompt_block(functions: List[dict]) -> str:
    """Deterministic tool-definition block rendered into the chat
    prompt (the fallback template injects it as a system turn; HF
    templates that accept `tools=` render their own)."""
    lines = [
        "# Tools",
        "You may call one or more of the functions below. To call "
        "functions, reply with",
        SENTINEL + '[{"name": <function-name>, '
        '"arguments": <arguments-object>}, ...]',
        "and nothing else. Available functions:",
    ]
    for f in functions:
        # No sort_keys: the schema must render in DECLARATION order —
        # the same property order the compiled grammar enforces — or
        # the prompt would steer the model against its own logit mask.
        lines.append(json.dumps(
            {"name": f["name"], "description": f["description"],
             "parameters": f["parameters"]},
            ensure_ascii=False,
        ))
    return "\n".join(lines)


def render_tool_calls(tool_calls: List[dict]) -> str:
    """An assistant history message's tool_calls rendered back into
    the SAME surface the model emits (multi-turn consistency: the
    model sees its own past calls in the format it produces)."""
    calls = []
    for tc in tool_calls:
        fn = tc.get("function") or {}
        args = fn.get("arguments", "{}")
        if isinstance(args, str):
            try:
                args = json.loads(args)
            except ValueError:
                raise ValueError(
                    f"assistant tool_calls arguments are not JSON: "
                    f"{args!r}"
                )
        calls.append({"name": fn.get("name", ""), "arguments": args})
    return SENTINEL + json.dumps(
        calls, ensure_ascii=False, separators=(",", ":")
    )


def _new_call_id() -> str:
    return "call_" + uuid.uuid4().hex[:24]


class ToolCallStreamParser:
    """Incremental scanner over the (constrained) model output.

    feed(text) takes the CUMULATIVE decoded output and returns the
    newly discovered events, each one of:

      ("content", str)                        — free-text delta
      ("tool_delta", {"index", "id"?, "type"?, "function": {...}})
                                              — OpenAI-shaped
                                                tool_calls delta item

    The first tool_delta of a call carries id/type/name and an empty
    arguments string; subsequent deltas carry raw `arguments`
    fragments that CONCATENATE to the exact JSON of the non-streamed
    result. Because the grammar fixes property order
    (`{"name": ..., "arguments": ...}`) and forbids whitespace, the
    machine is a strict expected-literal walk plus one depth-tracked
    value scan — no lookahead, no buffering beyond the current feed.

    The grammar guarantees well-formed input; anything that still
    diverges (an UNconstrained caller, a length-truncated tail) flips
    `broken` and stops emission — `result()` then returns None and
    the caller falls back to plain content.
    """

    def __init__(self, mode: str):
        self.mode = mode
        self.decided: Optional[str] = None  # None | "text" | "tool"
        self.broken = False
        self.calls: List[Dict[str, Any]] = []
        self._content_emitted = 0
        self._pos = 0                # chars consumed past the sentinel
        self._state = "array_start"
        self._expect = ""            # pending literal to match
        self._after = ""             # state after the literal matches
        self._depth = 0
        self._in_str = False
        self._esc = False

    # -- state helpers --

    def _expect_literal(self, lit: str, after: str) -> None:
        self._expect = lit
        self._after = after
        self._state = "literal"

    def _begin_call(self) -> None:
        self.calls.append({"id": _new_call_id(), "name": "",
                           "args": [], "done": False})
        self._expect_literal('"name":"', "name")

    def _flush_args(self, events: List[tuple], buf: List[str]) -> None:
        if buf:
            frag = "".join(buf)
            self.calls[-1]["args"].append(frag)
            events.append(("tool_delta", {
                "index": len(self.calls) - 1,
                "function": {"arguments": frag},
            }))
            buf.clear()

    # -- the machine --

    def feed(self, text: str) -> List[tuple]:
        events: List[tuple] = []
        if self.decided is None:
            if text.startswith(SENTINEL):
                self.decided = "tool"
            elif SENTINEL.startswith(text):
                return events  # still an ambiguous sentinel prefix
            else:
                self.decided = "text"
        if self.decided == "text":
            if len(text) > self._content_emitted:
                events.append(("content", text[self._content_emitted:]))
                self._content_emitted = len(text)
            return events
        payload = text[len(SENTINEL):]
        buf: List[str] = []
        for ch in payload[self._pos:]:
            if self.broken:
                break
            self._pos += 1
            st = self._state
            if st == "literal":
                if ch != self._expect[0]:
                    self.broken = True
                    break
                self._expect = self._expect[1:]
                if not self._expect:
                    self._state = self._after
            elif st == "array_start":
                if ch != "[":
                    self.broken = True
                    break
                self._state = "pre_call"
            elif st == "pre_call":
                if ch == "{":
                    self._begin_call()
                elif ch == "]" and self.calls:
                    self._state = "end"
                else:
                    self.broken = True
                    break
            elif st == "name":
                if ch == '"':
                    call = self.calls[-1]
                    events.append(("tool_delta", {
                        "index": len(self.calls) - 1,
                        "id": call["id"], "type": "function",
                        "function": {"name": call["name"],
                                     "arguments": ""},
                    }))
                    self._expect_literal(',"arguments":', "value")
                    self._depth = 0
                    self._in_str = False
                    self._esc = False
                else:
                    self.calls[-1]["name"] += ch
            elif st == "value":
                if self._in_str:
                    buf.append(ch)
                    if self._esc:
                        self._esc = False
                    elif ch == "\\":
                        self._esc = True
                    elif ch == '"':
                        self._in_str = False
                elif ch == "}" and self._depth == 0:
                    # The call object's closing brace, not part of the
                    # arguments value.
                    self._flush_args(events, buf)
                    self.calls[-1]["done"] = True
                    self._state = "post_call"
                else:
                    buf.append(ch)
                    if ch == '"':
                        self._in_str = True
                    elif ch in "{[":
                        self._depth += 1
                    elif ch in "}]":
                        self._depth -= 1
                        if self._depth < 0:
                            self.broken = True
                            break
            elif st == "post_call":
                if ch == ",":
                    self._state = "pre_call2"
                elif ch == "]":
                    self._state = "end"
                else:
                    self.broken = True
                    break
            elif st == "pre_call2":
                # After a comma only another call may follow.
                if ch == "{":
                    self._begin_call()
                else:
                    self.broken = True
                    break
            else:  # "end": the grammar allows nothing after ']'
                self.broken = True
                break
        # Mid-value chars scanned this feed are definitively part of
        # arguments — stream them now (result() falls back to None if
        # the call never completes, but a live stream must not buffer
        # a long arguments object until its closing brace).
        self._flush_args(events, buf)
        return events

    def result(self) -> Optional[List[dict]]:
        """The complete OpenAI tool_calls list — None unless the scan
        decided "tool" and reached a clean end of the calls array."""
        if (self.decided != "tool" or self.broken
                or self._state != "end" or not self.calls):
            return None
        return [
            {"id": c["id"], "type": "function",
             "function": {"name": c["name"],
                          "arguments": "".join(c["args"])}}
            for c in self.calls
        ]


def parse_tool_calls(text: str, mode: str
                     ) -> Tuple[Optional[str], Optional[List[dict]]]:
    """Non-streamed detection/parse of a finished output.

    Returns (content, tool_calls): exactly one is non-None. A
    length-truncated or out-of-grammar tool branch falls back to the
    RAW text as content (scope honesty: never fabricate a call)."""
    p = ToolCallStreamParser(mode)
    p.feed(text)
    calls = p.result()
    if calls is not None:
        return None, calls
    return text, None


def events_to_stream(events: List[tuple]) -> Optional[Dict[str, Any]]:
    """Collapse one feed()'s events into the `tool_stream` field a
    native streaming record carries: {"content": str?,
    "tool_calls": [delta, ...]?} — None when the feed produced
    nothing (the record then omits the field)."""
    content: List[str] = []
    deltas: List[dict] = []
    for kind, val in events:
        if kind == "content":
            content.append(val)
        else:
            deltas.append(val)
    out: Dict[str, Any] = {}
    if content:
        out["content"] = "".join(content)
    if deltas:
        out["tool_calls"] = deltas
    return out or None


def safe_stream_text(text: str) -> str:
    """Trim trailing replacement characters before feeding a CUMULATIVE
    decode to the parser: a byte-level tokenizer mid-way through a
    multi-byte UTF-8 character decodes the partial tail as U+FFFD, and
    the parser consumes each character exactly once — feeding it a
    placeholder that the next token retroactively changes would
    corrupt the scan. The final (complete) text is fed unconditionally
    at finish, so a legitimate trailing U+FFFD is only DELAYED."""
    return text.rstrip("�")
