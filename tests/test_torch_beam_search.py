"""The port's beam search against the JAX package's, on the CPU.

The same numpy-seeded weights (tiny preset, fp32, vocab 259 so the byte
tokenizer's EOS 257 is a real row, through `params_from_jax`) and
prompts go through the JAX package's searches, computed once for the
module, and through the port's: `Engine.beam_search` over the dense and
int8 caches and `PagedBatchingEngine.beam_search` over the bf16 pool
(4-token blocks, so the beams' tails cross blocks and are copied on
write) and the int8 pool (32-token blocks, a prompt of 30), with an EOS
that freezes a beam, at length penalties 1 and 0, under a regex
constraint, with a prefix-cache hit (its prefix stats equal the JAX
engine's), and with a prompt that fills the whole block table. The JAX
searches over its dense cache and over its pool give the same beams (its
own tests hold them bit-equal), so each port search is held against the
JAX search of the same settings on either. K = 3, 5 steps, max_len 48.

Tolerance: sequences equal and scores within 1e-4. Every selection is
compared only where the JAX search itself leaves a margin: an unrolled
copy of the JAX search (the JAX engine's own prefill and cached forward
with the package's `beam_first_expand` / `beam_expand`, whose beams must
equal its `beam_search`'s) asserts that at each expansion the K-th and
(K+1)-th real candidates differ by at least 2e-4, twice the logit
tolerance (tests/test_torch_model.py's rule), and that the final scores
of the returned beams differ by as much. Candidates at the junk score
-1e30 tie exactly and both packages take the lower flat index first.
The prompts are fixed, and a prompt whose JAX search breaks the margin
rule fails the module's fixture: nothing is skipped. The port's dense and
paged searches give the same sequences and scores within 1e-5 (bit-equal
in fp32: the plain attention reads the same values through the tables).

Also: one beam is greedy decoding; a pool that cannot cover a search
raises the reference's RuntimeError and leaves the free list as it was;
searches between the steps of a pipelined, prefix-cached engine leave
its requests' tokens and its pool as they were; the guards raise the
reference's messages; the HTTP server's `num_beams` (/generate, the
OpenAI routes, a `response_format` constraint) answers the engine's
beams with their `beam_score`, and refuses what does not compose with
beams; `generate --num-beams` prints the engine's beams.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import functools
import json
import threading
import urllib.error
import urllib.request
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shellac_tpu.inference import batching as jbatching
from shellac_tpu.inference import constraints as jcon
from shellac_tpu.inference import engine as jengine
from shellac_tpu.models import transformer as jt
from shellac_tpu.models.registry import get_model_config as jget
from shellac_tpu_torch import cli
from shellac_tpu_torch.inference import batching
from shellac_tpu_torch.inference import constraints as tcon
from shellac_tpu_torch.inference.engine import Engine
from shellac_tpu_torch.inference.openai_api import render_chat
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
TOL = 1e-4
MARGIN = 2 * TOL
TOK = ByteTokenizer()
EOS = ByteTokenizer.EOS  # 257
VOCAB = ByteTokenizer.vocab_size  # 259
K, STEPS, MAX_LEN = 3, 5, 48
REGEX = r"(yes|no|maybe)( (yes|no|maybe)){0,3}"


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _ids(n, *key):
    return _rng(*key).integers(1, 250, n).astype(np.int32).tolist()


# The prompts: P (6 tokens), P30 for the int8 pool's 32-token blocks, a
# constrained prompt, a prefix-cache hit (12 cached tokens, 3 blocks),
# and one that fills the whole table (45 tokens, 12 of 12 blocks).
P = _ids(6, "p")
P30 = _ids(30, "p30", 2)
CP = TOK.encode("Q: yes or no? A: ").tolist()
PREFIX = _ids(12, "prefix")
SEED = PREFIX + [5, 7]
PP = PREFIX + [9, 11, 13]
WHOLE = _ids(45, "whole")


@pytest.fixture(scope="module")
def model():
    jc = jget("tiny").replace(dtype="float32", vocab_size=VOCAB)
    tc = get_model_config("tiny").replace(dtype="float32", vocab_size=VOCAB)
    p = jax_params.init_params(jc)
    return jc, tc, jax.tree.map(jnp.asarray, p), params_from_jax(tc, p, CPU)


@functools.lru_cache(maxsize=None)
def _dfas():
    """(port TokenDFA, JAX TokenDFA) of REGEX."""
    return (tcon.compile_token_dfa(REGEX, TOK, VOCAB, EOS),
            jcon.compile_token_dfa(REGEX, TOK, VOCAB, EOS))


def _walk(dfa, tokens):
    """Walk `tokens` through the DFA; asserts each one is allowed and an
    EOS ends in an accepting state."""
    st = 0
    for t in tokens:
        nxt = dfa.trans[st, -1 if t == EOS else t]
        assert nxt >= 0, (st, t)
        st = int(nxt)


def _log_softmax(x):
    x = np.asarray(x, np.float64)
    m = x.max(axis=-1, keepdims=True)
    return (x - m - np.log(np.exp(x - m).sum(axis=-1, keepdims=True))
            ).astype(np.float32)


def _margins(jeng, step, prompt, k, steps, eos, trans=None):
    """The JAX search unrolled on the host: logits from the JAX engine's
    own prefill and its cached forward (`step`), its cache reordered by
    the engine's `_reorder_cache`, and the expansion of
    `beam_first_expand` / `beam_expand` in numpy. Returns (the gap
    between the K-th and (K+1)-th real candidate at each expansion, the
    ranked (sequences, scores) at length penalty 1)."""
    neg, invalid = np.float32(jengine.BEAM_NEG), jengine.BEAM_INVALID
    first, cache, _ = jeng._prefill(
        jeng.params, jnp.asarray([prompt], jnp.int32),
        jnp.full((1,), len(prompt), jnp.int32))
    v = first.shape[-1]

    def masked(lp, state):
        if trans is None:
            return lp
        row = trans[state]
        allowed = row[:, :-1] >= 0
        allowed[:, eos] = row[:, -1] >= 0
        return np.where(allowed, lp, neg)

    def advance(state, tok, keep):
        if trans is None:
            return state
        col = np.where(tok == eos, v, tok)
        return np.where(keep, state, np.maximum(trans[state, col], 0))

    gaps = []
    scores = np.where(np.arange(k) == 0, 0.0, neg).astype(np.float32)
    lp = masked(_log_softmax(np.asarray(first[:1])), np.zeros(1, np.int64))
    finished = np.zeros(k, bool)
    state = np.zeros(k, np.int64)
    out = np.zeros((k, steps), np.int64)
    lens = np.zeros(k, np.int64)
    tok = None
    for i in range(steps):
        if i:
            logits, cache = step(jeng.params, jnp.asarray(tok[:, None],
                                                          jnp.int32), cache)
            lp = masked(_log_softmax(np.asarray(logits[:, 0])), state)
            if eos is not None:
                frozen = np.full(v, neg, np.float32)
                frozen[eos] = 0.0
                lp = np.where(finished[:, None], frozen[None], lp)
        cand = (scores[:, None] + lp).reshape(-1)
        # jax.lax.top_k's order: value descending, lower index first.
        flat = np.lexsort((np.arange(cand.size), -cand))[:k]
        c = np.sort(cand)[::-1]
        if c[k - 1] > invalid and c[k] > invalid:
            gaps.append(float(c[k - 1]) - float(c[k]))
        beam, tok = flat // v, flat % v
        scores = cand[flat]
        was_done = finished[beam]
        out = out[beam]
        out[:, i] = tok
        lens = np.where(was_done, lens[beam], lens[beam] + 1)
        finished = was_done | ((tok == eos) if eos is not None else False)
        state = advance(state[beam], tok, was_done)
        cache = jeng._reorder_cache(cache, jnp.asarray(beam, jnp.int32))
        if i:
            cache = cache.replace(lengths=jnp.where(
                jnp.asarray(was_done), cache.lengths - 1, cache.lengths))
    ranked = {}
    for alpha in (0.0, 1.0):
        norm = scores / np.power(lens.astype(np.float32), np.float32(alpha))
        order = np.argsort(-norm, kind="stable")
        ranked[alpha] = jengine.beam_filter_invalid(
            out[order], norm[order], lens[order])
    return gaps, ranked


_REF = {}


@pytest.fixture(scope="module")
def ref(model):
    """The JAX package's searches, each computed once: dense and int8
    `Engine`s and one prefix-cached pool (4-token blocks), with the
    margins of every search compared."""
    if _REF:
        return _REF
    jc, _, jp, _ = model
    jd = jengine.Engine(jc, jp, temperature=0.0, max_len=MAX_LEN)
    jq = jengine.Engine(jc, jp, temperature=0.0, max_len=MAX_LEN,
                        kv_quant="int8")
    step = jax.jit(functools.partial(jt.forward_with_cache, jc))
    jpg = jbatching.PagedBatchingEngine(
        jc, jp, n_slots=2, max_len=MAX_LEN, block_size=4, pool_tokens=2048,
        temperature=0.0, eos_id=EOS, prefix_cache=True)

    def eos_of(jeng, prompt):
        # The prompt's greedy first token: its beam freezes at once.
        first = jeng._prefill(jeng.params, jnp.asarray([prompt], jnp.int32),
                              jnp.full((1,), len(prompt), jnp.int32))[0]
        return int(jnp.argmax(first[0]))

    e, e30 = eos_of(jd, P), eos_of(jq, P30)
    r = _REF
    r["eos"], r["eos30"] = e, e30
    margins = {
        "p": _margins(jd, step, P, K, STEPS, e),
        "p30": _margins(jq, step, P30, K, STEPS, e30),
        "con": _margins(jd, step, CP, K, 8, EOS,
                        _dfas()[1].trans.astype(np.int64)),
        "pp": _margins(jd, step, PP, K, STEPS, None),
        "whole": _margins(jd, step, WHOLE, K, 2, None),
    }
    r["dense-lp1"] = jd.beam_search(P, num_beams=K, max_new_tokens=STEPS,
                                    eos_id=e, length_penalty=1.0)
    r["paged-lp0"] = jpg.beam_search(P, num_beams=K, max_new_tokens=STEPS,
                                     eos_id=e, length_penalty=0.0)
    r["int8"] = jq.beam_search(P30, num_beams=K, max_new_tokens=STEPS,
                               eos_id=e30)
    r["con"] = jd.beam_search(CP, num_beams=K, max_new_tokens=8,
                              constraint=_dfas()[1])
    r["whole"] = jpg.beam_search(WHOLE, num_beams=K, max_new_tokens=2)
    jpg.run([("seed", np.asarray(SEED, np.int32), 1)])
    before = dict(jpg.stats)
    r["prefix"] = jpg.beam_search(PP, num_beams=K, max_new_tokens=STEPS)
    r["prefix_stats"] = {k: jpg.stats[k] - before[k]
                         for k in ("prefix_hit_tokens", "prefix_query_tokens",
                                   "prefix_evictions")}
    # The unrolled copies are the searches whose margins were read.
    for name, key, alpha in (
            ("p", "dense-lp1", 1.0), ("p", "paged-lp0", 0.0),
            ("p30", "int8", 1.0), ("con", "con", 1.0),
            ("pp", "prefix", 1.0), ("whole", "whole", 1.0)):
        gaps, ranked = margins[name]
        seqs, scores = ranked[alpha]
        assert seqs == r[key][0], name
        assert min(gaps) >= MARGIN, (name, gaps)
        assert all(a - b >= MARGIN for a, b in zip(scores, scores[1:])), (
            name, scores)
    return r


def _same(got, want):
    """Sequences equal, scores within TOL."""
    assert got[0] == want[0], (got, want)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=TOL)


def _paged(model, backend="paged", **kw):
    _, tc, _, tp = model
    kw.setdefault("block_size", 32 if backend == "paged-int8" else 4)
    kw.setdefault("pool_tokens", 2048)
    kw.setdefault("n_slots", 2)
    return batching.PagedBatchingEngine(
        tc, tp, max_len=MAX_LEN, temperature=0.0, eos_id=EOS,
        cache_backend=backend, device=CPU, **kw)


def _search(eng, prompt, steps=STEPS, **kw):
    return eng.beam_search(prompt, num_beams=K, max_new_tokens=steps, **kw)


# (cache, length penalty) -> (the JAX search held against, prompt, eos key)
_CASES = {
    "lp1": ("dense-lp1", P, "eos", 1.0),
    "lp0": ("paged-lp0", P, "eos", 0.0),
    "int8": ("int8", P30, "eos30", 1.0),
}


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_beams_match_jax(model, ref, paged, case):
    """Engine.beam_search (dense caches) and PagedBatchingEngine.
    beam_search (pools) against the JAX search. The prompt's greedy first
    token is the EOS: the beam that takes it freezes at length 1 with
    the first step's logprob (at penalty 0 it ranks first: every longer
    beam only adds negative logprobs)."""
    _, tc, _, tp = model
    want_key, prompt, eos_key, lp = _CASES[case]
    kvq = "int8" if case == "int8" else None
    if paged:
        eng = _paged(model, "paged-int8" if kvq else "paged")
    else:
        eng = Engine(tc, tp, max_len=MAX_LEN, kv_quant=kvq, device=CPU)
    eos = ref[eos_key]
    got = _search(eng, prompt, eos_id=eos, length_penalty=lp)
    _same(got, ref[want_key])
    assert [eos] in got[0]
    if lp == 0.0:
        assert got[0][0] == [eos]
    if paged:
        assert (len(eng.cache_backend._free)
                == eng.cache_backend.n_blocks - 1)
    else:
        # The dense and paged searches agree: the same sequences, scores
        # within 1e-5 (the plain attention sums a dense row and a table
        # gather of other lengths; bit-equal in fp32 here).
        other = _search(_paged(model, "paged-int8" if kvq else "paged"),
                        prompt, eos_id=eos, length_penalty=lp)
        assert other[0] == got[0]
        np.testing.assert_allclose(other[1], got[1], rtol=0, atol=1e-5)
        if kvq is None:
            assert other == got


def test_prefix_hit_matches_jax(model, ref):
    """A beam prompt sharing a cached prefix attaches the cached blocks
    read-only and computes only the suffix: the JAX beams, the JAX
    engine's prefix stats, refcounts and the free list restored."""
    eng = _paged(model, prefix_cache=True)
    eng.run([("seed", np.asarray(SEED, np.int32), 1)])
    be = eng.cache_backend
    refs, free = dict(be._block_ref), list(be._free)
    before = dict(eng.stats)
    got = _search(eng, PP)
    _same(got, ref["prefix"])
    assert {k: eng.stats[k] - before[k]
            for k in ref["prefix_stats"]} == ref["prefix_stats"]
    assert ref["prefix_stats"]["prefix_hit_tokens"] == 12
    assert be._block_ref == refs and sorted(be._free) == sorted(free)


def test_prompt_filling_the_table_matches_jax(model, ref):
    """A prompt whose blocks fill the whole table and whose pad bucket
    (64) passes max_len: the pad is capped at the table."""
    got = _search(_paged(model), WHOLE, steps=2)
    _same(got, ref["whole"])


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_constrained_beams_match_jax(model, ref, paged):
    """Every beam walks the grammar, the beams and the number pruned
    equal the JAX search's."""
    _, tc, _, tp = model
    eng = (_paged(model) if paged
           else Engine(tc, tp, max_len=MAX_LEN, device=CPU))
    got = _search(eng, CP, steps=8, constraint=_dfas()[0])
    _same(got, ref["con"])
    for seq in got[0]:
        _walk(_dfas()[0], seq)
    assert any(seq[-1] == EOS for seq in got[0])


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_one_beam_is_greedy(model, paged):
    _, tc, _, tp = model
    greedy = Engine(tc, tp, max_len=MAX_LEN, temperature=0.0,
                    device=CPU).generate(np.asarray([P], np.int32),
                                         max_new_tokens=6).tokens[0]
    eng = (_paged(model) if paged
           else Engine(tc, tp, max_len=MAX_LEN, device=CPU))
    seqs, _ = eng.beam_search(P, num_beams=1, max_new_tokens=6)
    assert seqs == [greedy.tolist()]


@pytest.mark.parametrize("prefix", [False, True])
def test_pool_exhaustion_is_loud(model, prefix):
    eng = _paged(model, pool_tokens=32, prefix_cache=prefix)
    if prefix:
        eng.run([("seed", np.asarray(SEED, np.int32), 1)])
    be = eng.cache_backend
    state = (list(be._free), dict(be._block_ref), dict(eng.stats))
    with pytest.raises(RuntimeError, match="paged pool exhausted"):
        eng.beam_search(PP, num_beams=8, max_new_tokens=30)
    assert (list(be._free), dict(be._block_ref), dict(eng.stats)) == state


def test_searches_between_pipelined_steps_leave_the_engine_as_it_was(
        model):
    """Beam searches between the steps of a prefix-cached engine with
    both pipelines (windows and prefills in flight): every search gives
    the standalone search's beams, every request the tokens of a run
    without searches, and the pool returns to where it started."""
    reqs = [(i, np.asarray(_ids(5 + 3 * i, "churn", i), np.int32), 6)
            for i in range(4)]
    kw = dict(prefix_cache=True, overlap_decode=True, overlap_prefill=True,
              decode_ticks=2, pool_tokens=160)
    want_reqs = _paged(model, **kw).run(reqs)
    want = _search(_paged(model), P)
    eng = _paged(model, **kw)
    be = eng.cache_backend
    free = len(be._free) + be.evictable()
    for r in reqs:
        eng.submit(*r)
    got, searches = {}, 0
    while eng.pending:
        for rid, out in eng.step():
            got[rid] = out
        assert _search(eng, P) == want
        searches += 1
    assert got == want_reqs and searches > 2
    assert len(be._free) + be.evictable() == free


_GUARDS = [
    dict(num_beams=0),
    dict(max_new_tokens=0),
    dict(prompt=list(range(1, 40)), max_new_tokens=9),
    dict(constraint="a+"),
    dict(constraint="table"),
    dict(constraint="dfa", eos_id=3),
    dict(constraint="eos"),
]


@pytest.mark.parametrize("case", range(len(_GUARDS)),
                         ids=["beams", "max_new", "max_len", "not_a_dfa",
                              "table_width", "eos_mismatch", "eos_vocab"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_guards_raise_the_reference_messages(model, paged, case):
    jc, tc, jp, tp = model
    kw = dict(_GUARDS[case])
    prompt = kw.pop("prompt", [1, 2])
    con = kw.pop("constraint", None)
    dfas = {
        "a+": ("a+", "a+"),
        "table": tuple(type(d)(d.trans[:, :-1], EOS) for d in _dfas()),
        "dfa": _dfas(),
        "eos": tuple(type(d)(d.trans, VOCAB + 4) for d in _dfas()),
    }
    args = dict(dict(num_beams=2, max_new_tokens=4), **kw)
    if paged:
        eng, jeng = _paged(model), jbatching.PagedBatchingEngine(
            jc, jp, n_slots=2, max_len=MAX_LEN, block_size=4,
            temperature=0.0, eos_id=EOS)
    else:
        eng = Engine(tc, tp, max_len=MAX_LEN, device=CPU)
        jeng = jengine.Engine(jc, jp, max_len=MAX_LEN)
    with pytest.raises(ValueError) as want:
        jeng.beam_search(prompt, constraint=None if con is None
                         else dfas[con][1], **args)
    with pytest.raises(ValueError) as got:
        eng.beam_search(prompt, constraint=None if con is None
                        else dfas[con][0], **args)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------
# the server and the CLI
# --------------------------------------------------------------------------

SCHEMA = {"type": "object", "properties": {"a": {"type": "boolean"}},
          "required": ["a"]}


@pytest.fixture(scope="module")
def http(model):
    """The port's server over a paged engine (8 slots) and a twin engine
    of the same settings for the expected beams."""
    _, tc, _, tp = model
    srv = InferenceServer(tc, tp, tokenizer=TOK, registry=Registry(),
                          engine=_paged(model, n_slots=8))
    httpd = make_http_server(srv)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    twin = _paged(model)
    yield f"http://127.0.0.1:{httpd.server_address[1]}", twin
    httpd.shutdown()
    srv.close()


def _post(base, path, payload):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _schema_dfa():
    return tcon.compile_token_dfa(
        tcon.constraint_pattern({"json_schema": SCHEMA}), TOK, VOCAB, EOS)


@pytest.mark.parametrize("route", ["generate", "completions", "chat",
                                   "completions_json_schema"])
def test_http_beams_equal_the_engine(http, route):
    base, twin = http
    msgs = [{"role": "user", "content": "hi"}]
    rf = {"type": "json_schema", "json_schema": {"schema": SCHEMA}}
    path, payload, prompt, kw = {
        "generate": ("/generate", {"tokens": P, "max_new": STEPS,
                                   "num_beams": K, "length_penalty": 0.0},
                     P, dict(length_penalty=0.0)),
        "completions": ("/v1/completions",
                        {"prompt": "ab", "max_tokens": STEPS,
                         "num_beams": K, "temperature": 0},
                        TOK.encode("ab").tolist(), {}),
        "chat": ("/v1/chat/completions",
                 {"messages": msgs, "max_tokens": STEPS, "num_beams": K},
                 TOK.encode(render_chat(msgs, TOK)).tolist(), {}),
        "completions_json_schema": (
            "/v1/completions", {"prompt": "ab", "max_tokens": 12,
                                "num_beams": K, "response_format": rf},
            TOK.encode("ab").tolist(), dict(constraint=_schema_dfa())),
    }[route]
    steps = payload.get("max_new", payload.get("max_tokens"))
    status, body = _post(base, path, payload)
    assert status == 200, body
    choices = json.loads(body)["choices"]
    seqs, scores = twin.beam_search(prompt, num_beams=K,
                                    max_new_tokens=steps, eos_id=EOS, **kw)
    assert [c["beam_score"] for c in choices] == [round(s, 6)
                                                 for s in scores]
    if route == "generate":
        assert [c["tokens"] for c in choices] == seqs
        assert [c["text"] for c in choices] == [TOK.decode(s) for s in seqs]
        return
    texts = [c["message"]["content"] if route == "chat" else c["text"]
             for c in choices]
    assert texts == [TOK.decode(s) for s in seqs]
    if route == "completions_json_schema":
        done = [json.loads(t) for s, t in zip(seqs, texts) if s[-1] == EOS]
        assert done and all(set(d) == {"a"} for d in done)


_REFUSED = {
    **{f"neutral_{k}": ("/generate", {k: v})
       for k, v in (("stream", True), ("n", 2), ("best_of", 2),
                    ("logprobs", True), ("top_logprobs", 1),
                    ("min_tokens", 2), ("logit_bias", {"1": 1.0}),
                    ("presence_penalty", 0.5), ("frequency_penalty", 0.5),
                    ("seed", 1), ("prompt_logprobs", True), ("stop", ["x"]),
                    ("temperature", 0.7), ("top_p", 0.9), ("top_k", 5),
                    ("min_p", 0.1))},
    "stream_sse": ("/v1/completions", {"stream": True}),
    "tools": ("/v1/chat/completions", {"tools": [
        {"type": "function", "function": {"name": "f", "parameters": {}}}]}),
    "over_the_cap": ("/generate", {"num_beams": 33}),
    "zero_beams": ("/generate", {"num_beams": 0}),
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_http_beam_refusals_answer_400(http, case):
    base, _ = http
    path, extra = _REFUSED[case]
    payload = ({"messages": [{"role": "user", "content": "x"}]}
               if "chat" in path else {"prompt": "x"} if "/v1" in path
               else {"tokens": [1, 2]})
    payload.update({"num_beams": 2}, **extra)
    payload["max_tokens" if "/v1" in path else "max_new"] = 3
    status, body = _post(base, path, payload)
    assert status == 400, body
    assert b"not ported" not in body


def test_generate_cli_prints_the_engine_beams(model, capsys, tmp_path):
    conf = tmp_path / "cfg.json"
    conf.write_text(json.dumps({"preset": "tiny", "vocab_size": VOCAB,
                                "dtype": "float32"}))
    base = ["generate", "--device", "cpu", "--config", str(conf),
            "--seed", "2", "--max-new", "12", "--num-beams", str(K)]
    _, tc, _, _ = model
    eng = Engine(tc, tt.init_params(tc, seed=2, device=CPU), device=CPU)
    for extra, kw in (
        (["--prompt", "5,6,7", "--length-penalty", "0"],
         dict(prompt=[5, 6, 7], length_penalty=0.0)),
        (["--text", "ab", "--eos-id", str(EOS), "--json-schema",
          json.dumps(SCHEMA)],
         dict(prompt=TOK.encode("ab").tolist(), eos_id=EOS,
              constraint=_schema_dfa())),
    ):
        capsys.readouterr()
        assert cli.main(base + extra) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        seqs, scores = eng.beam_search(kw.pop("prompt"), num_beams=K,
                                       max_new_tokens=12, **kw)
        assert out["tokens"] == seqs[0]
        assert out["beam_scores"] == [round(s, 4) for s in scores]
        if "constraint" in kw:
            assert json.loads(out["text"]) in ({"a": True}, {"a": False})
    with pytest.raises(SystemExit, match="--eos-id"):
        cli.main(base + ["--prompt", "1", "--json-schema", "{}"])
    with pytest.raises(SystemExit, match="--num-beams"):
        cli.main(["generate", "--device", "cpu", "--prompt", "1",
                  "--json-schema", "{}", "--eos-id", "1"])
