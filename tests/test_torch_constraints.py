"""The port's constrained decoding against the JAX package's, on the CPU.

`shellac_tpu_torch/inference/constraints.py` is a copy of the reference's
pure numpy compiler: its token tables and patterns must equal the
reference's bit for bit (byte tokenizer, and a stub tokenizer whose
tokens have multi-byte surfaces that split UTF-8 characters), and its
guards raise the reference's messages.

The engines: the same numpy-seeded weights (tiny preset, fp32, vocab 259
so the byte tokenizer's EOS 257 is a real row, through `params_from_jax`)
and requests (constrained and free, sharing slots) go through the JAX
`BatchingEngine` once per storage (fp32, int8; greedy tokens do not
depend on the schedule or on dense versus paged storage) and through the
port's engines over all four caches, at 1 tick a window and under a
prefix hit, and at 4 ticks with both pipelines and chunked prefill.
Tokens are compared while the top-2 margin among the tokens the DFA
allows (from a plain fp32 forward) is at least twice the logit tolerance
of 1e-4 (tests/test_torch_model.py's rule); every port output walks its
DFA without meeting -1.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shellac_tpu.inference import batching as jbatching
from shellac_tpu.inference import constraints as jcon
from shellac_tpu.models.registry import get_model_config as jget
from shellac_tpu_torch.inference import batching
from shellac_tpu_torch.inference import constraints as tcon
from shellac_tpu_torch.models import transformer as tt
from shellac_tpu_torch.models.from_jax import params_from_jax
from shellac_tpu_torch.models.registry import get_model_config
from shellac_tpu_torch.training.tokenizer import ByteTokenizer

import jax_params

CPU = "cpu"
MARGIN = 2 * 1e-4
TOK = ByteTokenizer()
EOS = ByteTokenizer.EOS  # 257
VOCAB = ByteTokenizer.vocab_size  # 259


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


class _MultiByteTokenizer:
    """Byte ids 0..255, then tokens whose surfaces are several bytes:
    ASCII pairs, whole Cyrillic and CJK characters, and lone lead and
    continuation bytes that split them; EOS and one special have none."""

    SURFACES = [b"ab", b"yes", b"no", b'{"', b'":', b"true", b"false",
                "да".encode(), "нет".encode(), "д".encode(),
                "日本".encode(), b"\xd0", b"\xb4", b"\xe6\x97",
                b"\xa5", b"0123", b'"}', b"oslo", b"rio", b"-0"]
    vocab_size = 256 + len(SURFACES) + 2
    eos_id = vocab_size - 1

    def token_bytes(self, tid):
        if tid < 256:
            return bytes([tid])
        if tid - 256 < len(self.SURFACES):
            return self.SURFACES[tid - 256]
        return None


_PATTERNS = {
    "counted": r'\{"x":[0-9]{1,4}\}',
    "alternation": r"(yes|no|maybe)( (yes|no|maybe)){0,3}",
    "unicode_class": r"[а-яё]{1,3}|[぀-ヿ]+|日本",
    "negated": r"[^a-c\s]{2}[\s\S]?",
}
_SCHEMAS = {
    "anyof_const": {"anyOf": [{"const": "да"}, {"type": "integer"},
                              {"enum": [True, None, 2.5]}]},
    "ref": {"$defs": {"c": {"enum": ["oslo", "rio"]}}, "type": "object",
            "properties": {"city": {"$ref": "#/$defs/c"},
                           "n": {"type": "number"}},
            "required": ["city"]},
    "format": {"type": "object", "properties": {
        "when": {"type": "string", "format": "date"},
        "id": {"type": "string", "format": "uuid"}}},
    "additional": {"type": "object", "properties": {
        "ok": {"type": "boolean"}}, "additionalProperties": True},
    "array": {"type": "array", "items": {"enum": ["a", "b"]},
              "minItems": 1, "maxItems": 3},
}
_SPECS = ([{"regex": p} for p in _PATTERNS.values()]
          + [{"json_schema": s} for s in _SCHEMAS.values()]
          + [{"json_object": True}])
_SPEC_IDS = list(_PATTERNS) + list(_SCHEMAS) + ["json_object"]
# Seconds a compile on the CPU: the generic-JSON grammars take their
# tables over the byte tokenizer only (about 1 s a compile), and
# json_object (about 2.5 s) its pattern only.
_BYTE_ONLY = ("additional",)
_PATTERN_ONLY = ("json_object",)


@pytest.mark.parametrize("spec", _SPECS, ids=_SPEC_IDS)
def test_tables_equal_the_reference(spec, request):
    pattern = tcon.constraint_pattern(spec)
    assert pattern == jcon.constraint_pattern(spec)
    case = request.node.callspec.id
    if case in _PATTERN_ONLY:
        return
    mb = _MultiByteTokenizer()
    toks = [(TOK, VOCAB, EOS)]
    if case not in _BYTE_ONLY:
        toks.append((mb, mb.vocab_size, mb.eos_id))
    for tok, vocab, eos in toks:
        want = jcon.compile_token_dfa(pattern, tok, vocab, eos)
        got = tcon.compile_token_dfa(pattern, tok, vocab, eos)
        assert got.trans.dtype == want.trans.dtype == np.int32
        np.testing.assert_array_equal(got.trans, want.trans)
        assert got.eos_id == want.eos_id and got.n_states == want.n_states


def test_multibyte_walk_and_budget_path(monkeypatch):
    """The multi-byte tokens move the DFA mid-character (a lone lead
    byte is allowed where the character's continuation can follow), and
    the walk-budget path (one state at a time over a padded byte
    matrix) gives the fast path's table in both packages."""
    mb = _MultiByteTokenizer()
    pattern = tcon.constraint_pattern(
        {"json_schema": {"enum": ["да", "нет", "日本"]}})
    fast = tcon.compile_token_dfa(pattern, mb, mb.vocab_size, mb.eos_id)
    lead = 256 + _MultiByteTokenizer.SURFACES.index(b"\xd0")
    whole = 256 + _MultiByteTokenizer.SURFACES.index("да".encode())
    after_quote = fast.trans[0, ord('"')]
    assert fast.trans[after_quote, lead] >= 0
    assert fast.trans[after_quote, whole] >= 0
    for mod in (tcon, jcon):
        monkeypatch.setattr(mod, "MAX_WALK_ENTRIES", 0)
    slow = tcon.compile_token_dfa(pattern, mb, mb.vocab_size, mb.eos_id)
    np.testing.assert_array_equal(slow.trans, fast.trans)
    np.testing.assert_array_equal(
        slow.trans,
        jcon.compile_token_dfa(pattern, mb, mb.vocab_size, mb.eos_id).trans)


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", [
    "unclosed", "unterminated", "dangling", "empty_class", "empty_spec",
    "regex_type",
    "cyclic_ref", "unknown_required", "states", "table"])
def test_guards_raise_the_reference_messages(case, monkeypatch):
    if case in ("states", "table"):
        for mod in (tcon, jcon):
            if case == "states":
                monkeypatch.setattr(mod, "MAX_DFA_STATES", 4)
            else:
                monkeypatch.setattr(mod, "MAX_TABLE_ENTRIES", 3 * (VOCAB + 1))
        calls = [lambda m=m: m.compile_token_dfa("[a-z]{8}", TOK, VOCAB, EOS)
                 for m in (tcon, jcon)]
    elif case in ("unclosed", "unterminated", "dangling", "empty_class"):
        pat = {"unclosed": "(ab", "unterminated": "a{2", "dangling": "*a",
               "empty_class": "[]"}[case]
        calls = [lambda m=m: m.compile_token_dfa(pat, TOK, VOCAB, EOS)
                 for m in (tcon, jcon)]
    else:
        spec = {
            "empty_spec": {},
            "regex_type": {"regex": 3},
            "cyclic_ref": {"json_schema": {
                "$defs": {"a": {"$ref": "#/$defs/a"}},
                "$ref": "#/$defs/a"}},
            "unknown_required": {"json_schema": {
                "type": "object", "properties": {"a": {"type": "null"}},
                "required": ["b"]}},
        }[case]
        calls = [lambda m=m: m.constraint_pattern(spec)
                 for m in (tcon, jcon)]
    assert _message(calls[0]) == _message(calls[1])


# --------------------------------------------------------------------------
# the engines
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    jc = jget("tiny").replace(dtype="float32", vocab_size=VOCAB)
    tc = get_model_config("tiny").replace(dtype="float32", vocab_size=VOCAB)
    p = jax_params.init_params(jc)
    return jc, tc, jax.tree.map(jnp.asarray, p), params_from_jax(tc, p, CPU)


_CON_PATTERNS = [_PATTERNS["counted"], _PATTERNS["alternation"],
                 tcon.constraint_pattern({"json_schema": _SCHEMAS["ref"]}),
                 r"[a-z]{3,8}"]
_DFAS = {}


def _dfas(pattern):
    """(port TokenDFA, JAX TokenDFA) of a pattern, compiled once."""
    if pattern not in _DFAS:
        _DFAS[pattern] = (tcon.compile_token_dfa(pattern, TOK, VOCAB, EOS),
                          jcon.compile_token_dfa(pattern, TOK, VOCAB, EOS))
    return _DFAS[pattern]


def _requests():
    """10 requests over 3 slots: six constrained over four grammars,
    four free; five prompts over 32 tokens (chunked at 16), three of
    which share a 40-token prefix (a prefix hit on the paged engines).
    Two prompt buckets (16 and 64) keep the JAX engine's compiles few."""
    rng = _rng("requests")
    shared = rng.integers(1, 250, 40)
    out = []
    for i in range(10):
        if i in (2, 5, 8):
            prompt = np.concatenate([shared, rng.integers(1, 250, 3 + i)])
        else:
            prompt = rng.integers(1, 250, (4, 9, 37, 6, 12, 50, 5)[i % 7])
        pattern = _CON_PATTERNS[i % 4] if i % 5 < 3 else None
        out.append((f"r{i}", prompt.astype(np.int32), 14, pattern))
    return out


def _submit(eng, reqs, jax_side=False, **extra):
    for rid, prompt, max_new, pattern in reqs:
        kw = dict(extra)
        if pattern is not None:
            kw["constraint"] = _dfas(pattern)[1 if jax_side else 0]
        eng.submit(rid, prompt, max_new, **kw)


_REF = {}


def _reference(model, storage):
    """The JAX engine's greedy tokens of `_requests()` over the dense
    cache of `storage` (fp32 or int8), run once."""
    if storage not in _REF:
        jc, _, jp, _ = model
        eng = jbatching.BatchingEngine(
            jc, jp, n_slots=3, max_len=96, temperature=0.0, eos_id=EOS,
            decode_ticks=4,
            cache_backend="dense-int8" if storage == "int8" else "dense")
        _submit(eng, _requests(), jax_side=True)
        _REF[storage] = eng.run()
    return _REF[storage]


def _walk(dfa, tokens):
    """The DFA states along `tokens`; asserts no token is disallowed."""
    st = 0
    for t in tokens:
        row = dfa.trans[st]
        nxt = row[-1] if t == EOS else row[t]
        assert nxt >= 0, (st, t)
        st = int(nxt)
    return st


_UPTO = {}


def _masked_upto(model, rid, prompt, out, pattern):
    """How many leading greedy tokens of `out` have a top-2 margin of at
    least MARGIN among the tokens the DFA allows, from a plain fp32
    forward of the port's model over prompt + out."""
    if rid not in _UPTO:
        _, tc, _, tp = model
        ids = np.asarray([list(prompt) + list(out)], np.int64)
        logits = tt.forward(tc, tp, ids, device=CPU)[0].detach().numpy()
        dfa = _dfas(pattern)[0] if pattern is not None else None
        st, upto = 0, len(out)
        for j, tok in enumerate(out):
            row = logits[len(prompt) + j - 1].astype(np.float64)
            if dfa is not None:
                allowed = dfa.trans[st, :-1] >= 0
                allowed[EOS] = dfa.trans[st, -1] >= 0
                row = np.where(allowed, row, -np.inf)
                st = int(dfa.trans[st, -1 if tok == EOS else tok])
            top = np.sort(row)[-2:]
            if top[1] - top[0] < MARGIN:
                upto = j
                break
        _UPTO[rid] = upto
    return _UPTO[rid]


def _engine(model, backend, **kw):
    _, tc, _, tp = model
    paged = backend.startswith("paged")
    cls = batching.PagedBatchingEngine if paged else batching.BatchingEngine
    if paged:
        kw.setdefault("block_size", 32 if backend == "paged-int8" else 8)
    else:
        kw.pop("prefix_cache", None)
    return cls(tc, tp, n_slots=3, max_len=96, temperature=0.0, eos_id=EOS,
               cache_backend=backend, device=CPU, **kw)


_RUNS = {
    "ticks1_prefix": dict(decode_ticks=1, prefix_cache=True),
    "ticks4_pipelined_chunked": dict(decode_ticks=4, overlap_decode=True,
                                     overlap_prefill=True, prefill_chunk=16),
}


@pytest.mark.parametrize("backend", ["dense", "paged", "dense-int8",
                                     "paged-int8"])
@pytest.mark.parametrize("run", sorted(_RUNS))
def test_constrained_greedy_matches_jax(model, backend, run):
    reqs = _requests()
    want = _reference(model, "int8" if backend.endswith("int8") else "fp32")
    eng = _engine(model, backend, **_RUNS[run])
    _submit(eng, reqs)
    got = eng.run()
    compared = total = 0
    for rid, prompt, _, pattern in reqs:
        upto = _masked_upto(model, rid, prompt, want[rid], pattern)
        assert got[rid][:upto] == want[rid][:upto], rid
        compared += upto
        total += len(want[rid])
        if pattern is not None:
            st = _walk(_dfas(pattern)[0], got[rid])
            if got[rid][-1] == EOS:
                assert _dfas(pattern)[0].trans[st, -1] >= 0
    assert compared >= 0.75 * total, (compared, total)
    if run == "ticks1_prefix" and backend.startswith("paged"):
        assert eng.stats["prefix_hit_tokens"] > 0
    if run.endswith("chunked"):
        assert eng.stats["prefill_chunks"] > 0
    # Released slots carry no DFA; the tables stay resident.
    assert eng._coff.tolist() == [-1] * 3 and eng._slot_dfa == [None] * 3
    _check_resident(eng)


def _check_resident(eng):
    """Each resident table's rows hold its TokenDFA, and no two overlap."""
    at = 0
    for off, dfa in sorted((o, d) for d, o in eng._cres.values()):
        assert off >= at
        at = off + dfa.n_states
        np.testing.assert_array_equal(eng._ctrans[off:at].numpy(), dfa.trans)
    assert at <= eng._ctrans.shape[0]


def test_grammar_beats_the_bias_and_seeds_repeat(model):
    """A +100 bias toward a token the grammar never allows loses (the
    mask is applied after the bias); an allowed token's bias still
    steers. Seeded sampled constrained runs repeat themselves, at 4
    ticks a window, and conform."""
    pattern = r"[a-z]{3,8}"
    dfa = _dfas(pattern)[0]
    prompt = np.arange(5, 17, dtype=np.int32)
    eng = _engine(model, "dense", decode_ticks=4)
    out = eng.run([("plain", prompt, 10)])
    eng.submit("banned", prompt, 10, constraint=dfa,
               logit_bias={ord("Z"): 100.0, ord("7"): 100.0})
    eng.submit("steered", prompt, 10, constraint=dfa,
               logit_bias={ord("q"): 100.0})
    out.update(eng.run())
    _walk(dfa, out["banned"])
    assert ord("Z") not in out["banned"] and ord("7") not in out["banned"]
    assert out["steered"][:8] == [ord("q")] * 8
    assert out["steered"][8] == EOS
    runs = []
    for _ in range(2):
        eng = _engine(model, "paged", decode_ticks=4)
        for i in range(3):
            eng.submit(i, prompt + i, 12, constraint=dfa, temperature=1.0,
                       seed=11 + i)
        runs.append(eng.run())
    assert runs[0] == runs[1]
    for toks in runs[0].values():
        _walk(dfa, toks)


def test_submit_guards_match_the_reference(model):
    jc, tc, jp, tp = model
    dfa, jdfa = _dfas(r"[a-z]{3,8}")
    port = _engine(model, "dense")
    ref = jbatching.BatchingEngine(jc, jp, n_slots=3, max_len=96,
                                   eos_id=EOS)
    other = tcon.compile_token_dfa("a", TOK, VOCAB, 256)
    jother = jcon.compile_token_dfa("a", TOK, VOCAB, 256)
    narrow = tcon.compile_token_dfa("a", TOK, 200, EOS)
    jnarrow = jcon.compile_token_dfa("a", TOK, 200, EOS)
    for kw, jkw in (({"constraint": {"regex": "a"}},
                     {"constraint": {"regex": "a"}}),
                    ({"constraint": narrow}, {"constraint": jnarrow}),
                    ({"constraint": other}, {"constraint": jother}),
                    ({"constraint": dfa, "min_tokens": 2},
                     {"constraint": jdfa, "min_tokens": 2})):
        assert (_message(lambda: port.submit("x", [1, 2], 4, **kw))
                == _message(lambda: ref.submit("x", [1, 2], 4, **jkw)))
    no_eos = batching.BatchingEngine(tc, tp, n_slots=2, max_len=32,
                                     device=CPU)
    assert "eos_id" in _message(lambda: no_eos.submit("x", [1], 4,
                                                      constraint=dfa))
    with pytest.raises(NotImplementedError):
        port.submit("x", [1, 2], 4, constraint=dfa, prefill_only=True)
    assert port.pending == 0


def test_table_residency_and_growth(model):
    """One copy of each distinct TokenDFA: repeated grammars share rows,
    released tables stay resident and a later request reuses them
    without an upload; a table past the buffer drops the tables no slot
    uses, grows the buffer to a power of two and drops the window and
    prefill programs that read the old one. The tokens stay a fresh
    engine's throughout."""
    small = [_dfas(p)[0] for p in (r"[a-z]{3,8}", r"(yes|no)")]
    big = _dfas(tcon.constraint_pattern({"json_schema": {
        "type": "object", "properties": {
            "a": {"type": "string", "format": "date-time"},
            "b": {"type": "string", "format": "uuid"}}}}))[0]
    assert big.n_states > 64
    prompt = np.arange(3, 11, dtype=np.int32)
    eng = _engine(model, "paged", decode_ticks=2, overlap_decode=True,
                  overlap_prefill=True)
    for i in range(4):
        eng.submit(f"s{i}", prompt + i, 8, constraint=small[i % 2])
    got = eng.run()
    buf, res = eng._ctrans, dict(eng._cres)
    assert buf.shape == (64, VOCAB + 1)
    assert sorted(o for _, o in res.values()) == [0, small[0].n_states]
    _check_resident(eng)
    eng.submit("again", prompt + 1, 8, constraint=small[1])
    got.update(eng.run())
    assert eng._ctrans is buf and eng._cres == res
    old = {k: g for k, g in eng._window_graphs.items() if k[5]}
    old_pf = {k: g for k, g in eng._prefill_graphs.items() if k.ctl.con}
    assert old and old_pf
    # The growth comes while s0b decodes with a window in flight: s0b's
    # rows move, and its offset with them.
    eng.submit("s0b", prompt, 8, constraint=small[0])
    while not eng._windows:
        eng.step()
    eng.submit("big", prompt, 30, constraint=big)
    got.update(eng.run())
    assert eng._ctrans is not buf
    assert eng._ctrans.shape[0] == batching._bucket(
        big.n_states + small[0].n_states, 64)
    assert set(eng._cres) == {id(big), id(small[0])}
    _check_resident(eng)
    assert all(eng._window_graphs.get(k) is not g for k, g in old.items())
    assert all(eng._prefill_graphs.get(k) is not g
               for k, g in old_pf.items())
    fresh = _engine(model, "paged", decode_ticks=2)
    fresh.submit("big", prompt, 30, constraint=big)
    for i in range(4):
        fresh.submit(f"s{i}", prompt + i, 8, constraint=small[i % 2])
    want = fresh.run()
    assert {k: got[k] for k in want} == want
    assert got["again"] == got["s1"] and got["s0b"] == got["s0"]
    _walk(big, got["big"])
