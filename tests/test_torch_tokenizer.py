"""The port's BPE and HF tokenizers (`shellac_tpu_torch/training/
tokenizer.py`) and chat templates, held against the JAX package's
(`shellac_tpu/training/tokenizer.py`, over `tokenizers` and
`transformers`) on the CPU.

One byte-level BPE is trained per module by the reference's
`BPETokenizer.train` on a corpus written in the test, and saved as an HF
directory by `PreTrainedTokenizerFast.save_pretrained` with a chat
template. Both port tokenizers give the reference's ids and texts over
ASCII, contractions, digit runs, whitespace runs (U+001C-U+001F, which
are Python whitespace but not Unicode White_Space, U+00A0, U+0085,
U+3000), CJK, combining marks, emoji and special tokens inside text; ids
at or past the vocab decode as the reference's do (dropped). The chat
template renders as `transformers`' `apply_chat_template`; the DFA tables
`compile_token_dfa` builds over the port's BPE equal the reference's; the
committed fixture (`tests/fixtures/tokenizer`, which `chip_smoke.py`
serves with) agrees with `transformers`; components the port does not
read raise NotImplementedError; and `serve --native-dir --tokenizer
<dir>` builds its server over the directory's tokenizer.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import json
import os
import random

import numpy as np
import pytest

from shellac_tpu.inference import constraints as jcons
from shellac_tpu.training import tokenizer as jtok
from shellac_tpu_torch import cli
from shellac_tpu_torch.inference import constraints as tcons
from shellac_tpu_torch.inference import openai_api
from shellac_tpu_torch.training import tokenizer as ttok

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tokenizer")

CHAT_TEMPLATE = (
    "{{ bos_token }}{% for m in messages %}"
    "{% if m['role'] not in ['system', 'user', 'assistant', 'tool'] %}"
    "{{ raise_exception('bad role ' + m['role']) }}{% endif %}"
    "{%- if loop.first and m['role'] != 'system' %}<|system|>\n"
    "default{{ eos_token }}\n{% endif %}"
    "<|{{ m['role'] }}|>\n{{ m['content'] | trim }}{{ eos_token }}\n"
    "{% endfor %}{% if add_generation_prompt %}<|assistant|>\n{% endif %}"
    "{{ {'meta': '<&>', 'n': 1} | tojson }}"
)

CORPUS = (
    "The quick brown fox jumps over the lazy dog. It's 2024; don't panic.\n"
    "We'll see they're here, I've been, she'd go, you'll know 'quoted'.\n"
    "Numbers 0123456789 3.14159 1,000,000 and x2 y10z.\n"
    "Tabs\tand  double  spaces\n\n\nnew paragraphs. nbsp　ideo\n"
    "日本語のテキストと中文字符。 한국어 문장. Ελληνικά и русский.\n"
    "Combining: é à ñ; emoji 😀👍🏽🇯🇵 x‍y.\n"
)

CASES = {
    "ascii": ["Hello world!", "The quick brown fox.", "a b  c   d",
              "snake_case and CamelCase", "(x) [y] {z} <w>"],
    "contractions": ["don't won't I'll they've she'd 'sup",
                     "IT'S 'S 'LL'Ve ''", "a's b't c're d've e'm f'll g'd"],
    "digits": ["123 4567 89,000.5", "x1y22z333", "½ Ⅻ ²³ ٣٤", "2024-01-01"],
    "whitespace": ["  leading and trailing   ", "a\n\nb\n \n c\t\td",
                   "x\x1cy\x1d z\x1e\x1f w", "\x1c\x1d", " ", "\n", "",
                   "nb sp  x", "line\u0085next", "wide　sp",
                   "tab\t\t\tend   ", "᠎​﻿z"],
    "cjk": ["日本語 中文字符", "한국어 문장입니다", "混合 mixed テキスト"],
    "combining": ["é à ñ", "Zalgo: z̵̴a",
                  "é vs é"],
    "emoji": ["😀👍🏽 🇯🇵 x‍y", "👨‍👩‍👧 family", "smile😀smile"],
    "specials": ["<|bos|>hi<|eos|> <|pad|>", "x<|bos|><|bos|>y",
                 "<|eos|", "<|bos|><|eos|>"],
}


def _random_cases(n=60, seed=0):
    rng = random.Random(seed)
    alphabet = (list("ab c'\n\t.,!09") + ["\x1c", " ", "é", "日", "😀",
                "́", "　", "<|eos|>", "'s", " 1"])
    return ["".join(rng.choice(alphabet) for _ in range(rng.randint(0, 24)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def toks(tmp_path_factory):
    """The reference's and the port's tokenizers over one trained BPE:
    its .json file and the HF directory saved from it."""
    from transformers import PreTrainedTokenizerFast

    d = tmp_path_factory.mktemp("bpe")
    corpus = d / "corpus.txt"
    corpus.write_text(CORPUS * 4, encoding="utf-8")
    path = str(d / "bpe.json")
    ref_bpe = jtok.BPETokenizer.train([str(corpus)], 400, path)
    fast = PreTrainedTokenizerFast(tokenizer_file=path, bos_token="<|bos|>",
                                   eos_token="<|eos|>", pad_token="<|pad|>")
    fast.chat_template = CHAT_TEMPLATE
    hf_dir = str(d / "hf")
    fast.save_pretrained(hf_dir)
    return dict(path=path, hf_dir=hf_dir, ref_bpe=ref_bpe,
                bpe=ttok.BPETokenizer(path), ref_hf=jtok.HFTokenizer(hf_dir),
                hf=ttok.HFTokenizer(hf_dir))


@pytest.mark.parametrize("group", sorted(CASES) + ["random"])
def test_bpe_matches_reference(toks, group):
    texts = _random_cases() if group == "random" else CASES[group]
    for text in texts:
        want = toks["ref_bpe"].encode(text, bos=True, eos=True)
        got = toks["bpe"].encode(text, bos=True, eos=True)
        np.testing.assert_array_equal(got, want, err_msg=repr(text))
        assert toks["bpe"].decode(want) == toks["ref_bpe"].decode(want), \
            repr(text)


@pytest.mark.parametrize("group", sorted(CASES) + ["random"])
def test_hf_matches_reference(toks, group):
    texts = _random_cases(seed=1) if group == "random" else CASES[group]
    vocab = toks["ref_hf"].vocab_size
    for text in texts:
        for flags in ({}, {"bos": True, "eos": True}):
            want = toks["ref_hf"].encode(text, **flags)
            got = toks["hf"].encode(text, **flags)
            np.testing.assert_array_equal(got, want, err_msg=repr(text))
        # Specials, and ids at and past the vocab, as generated ids.
        ids = list(want) + [0, 1, 2, vocab, vocab + 7, 32767]
        assert toks["hf"].decode(ids) == toks["ref_hf"].decode(ids), \
            repr(text)


def _long_runs():
    rng = random.Random(2)
    letters = "".join(c for c in CORPUS.lower() if c.isascii() and
                      c.isalpha())
    return {
        "words": "thequickbrownfoxjumpsoverthelazydog" * 600,
        "letters": "".join(rng.choice(letters) for _ in range(20000)),
        "dashes": "-" * 20000,
        "spaces": " " * 20000 + "x",
    }


@pytest.mark.parametrize("run", sorted(_long_runs()))
def test_long_single_class_run_matches_reference(toks, run):
    """A 20k-character run of one character class is one GPT-2 piece:
    both port tokenizers give the reference's ids within a time budget
    (the merge is O(n log n), tens of ms on a CPU; a rescan of the piece
    after each merge took seconds), and
    such a piece stays out of the bounded cache."""
    import time

    text = _long_runs()[run]
    for a, b in (("bpe", "ref_bpe"), ("hf", "ref_hf")):
        cache = toks[a]._tok._cached_ids
        before = cache.cache_info().currsize
        t0 = time.perf_counter()
        got = toks[a].encode(text)
        seconds = time.perf_counter() - t0
        np.testing.assert_array_equal(got, toks[b].encode(text))
        assert seconds < 1.0, (a, seconds)
        assert cache.cache_info().currsize <= before + 1
        assert cache.cache_info().maxsize == 10_000


def test_piece_cache_is_bounded(toks):
    """Distinct pieces past the cache's 10k evict the oldest; the ids
    stay the reference's."""
    tok = ttok.BPETokenizer(toks["path"])
    words = " ".join(f"w{i:05d}x" for i in range(10_050))
    np.testing.assert_array_equal(tok.encode(words),
                                  toks["ref_bpe"].encode(words))
    assert tok._tok._cached_ids.cache_info().currsize == 10_000


def test_vocab_and_specials_match_reference(toks):
    for a, b in (("bpe", "ref_bpe"), ("hf", "ref_hf")):
        assert toks[a].vocab_size == toks[b].vocab_size
    for attr in ("bos_id", "eos_id", "pad_id"):
        assert getattr(toks["bpe"], attr) == getattr(toks["ref_bpe"], attr)
    assert toks["hf"].bos_token_id == toks["ref_hf"]._tok.bos_token_id
    assert toks["hf"].eos_token_id == toks["ref_hf"]._tok.eos_token_id
    docs = ["first doc", "second 😀", ""]
    for a, b in (("bpe", "ref_bpe"), ("hf", "ref_hf")):
        np.testing.assert_array_equal(toks[a].encode_documents(docs),
                                      toks[b].encode_documents(docs))
    assert not hasattr(toks["bpe"], "token_bytes")
    assert not hasattr(toks["hf"], "token_bytes")
    with pytest.raises(NotImplementedError):
        ttok.BPETokenizer.train(["x"], 300, "y.json")


def test_bpe_file_without_specials_is_refused(toks, tmp_path):
    """A tokenizer.json that BPETokenizer.train did not write (no
    <|bos|>/<|eos|>/<|pad|>) is refused as the reference refuses it."""
    with open(toks["path"]) as f:
        spec = json.load(f)
    drop = {"<|eos|>", "<|pad|>"}
    spec["added_tokens"] = [t for t in spec["added_tokens"]
                            if t["content"] not in drop]
    spec["model"]["vocab"] = {t: i for t, i in spec["model"]["vocab"].items()
                              if t not in drop}
    path = tmp_path / "plain.json"
    path.write_text(json.dumps(spec))
    with pytest.raises(ValueError) as want:
        jtok.BPETokenizer(str(path))
    with pytest.raises(ValueError) as got:
        ttok.BPETokenizer(str(path))
    assert str(got.value) == str(want.value)


CHATS = [
    [{"role": "user", "content": "Hi <there> & \"you\""}],
    [{"role": "system", "content": "  Be brief.  "},
     {"role": "user", "content": "日本語? 😀"},
     {"role": "assistant", "content": "Sure."},
     {"role": "user", "content": "Again\n\nplease"}],
]


@pytest.mark.parametrize("gen_prompt", [True, False])
def test_chat_template_matches_transformers(toks, gen_prompt):
    ref = toks["ref_hf"]._tok
    for chat in CHATS:
        want = ref.apply_chat_template(chat, tokenize=False,
                                       add_generation_prompt=gen_prompt)
        got = toks["hf"].apply_chat_template(
            chat, add_generation_prompt=gen_prompt)
        assert got == want
    # render_chat, as /v1/chat/completions calls it, takes the template.
    text = openai_api.render_chat(CHATS[1], toks["hf"])
    assert text == ref.apply_chat_template(
        CHATS[1], tokenize=False, add_generation_prompt=True)
    import jinja2

    with pytest.raises(jinja2.TemplateError, match="bad role"):
        toks["hf"].apply_chat_template([{"role": "robot", "content": "x"}])


def test_chat_template_without_jinja2_is_unported(toks, monkeypatch):
    """Without jinja2 a template raises NotImplementedError (a 501 from
    the server), never a different rendering."""
    import sys

    # A tokenizer of its own: the module's has its template compiled.
    tok = ttok.HFTokenizer(toks["hf_dir"])
    monkeypatch.setitem(sys.modules, "jinja2", None)
    with pytest.raises(NotImplementedError, match="jinja2"):
        openai_api.render_chat(CHATS[0], tok)


@pytest.mark.parametrize("kind", ["json", "regex"])
def test_dfa_tables_match_reference(toks, kind):
    """compile_token_dfa over the port's BPE (the decode fallback: no
    token_bytes) gives the reference's table, ids past the tokenizer's
    vocab disabled."""
    spec = ({"json_schema": {"type": "object", "properties": {
        "name": {"type": "string"}, "n": {"type": "integer"}},
        "required": ["name", "n"]}} if kind == "json"
        else {"regex": "(yes|no)[0-9]{1,3}"})
    vocab = toks["bpe"].vocab_size + 24
    eos = toks["bpe"].eos_id
    want = jcons.compile_token_dfa(jcons.constraint_pattern(spec),
                                   toks["ref_bpe"], vocab, eos)
    got = tcons.compile_token_dfa(tcons.constraint_pattern(spec),
                                  toks["bpe"], vocab, eos)
    np.testing.assert_array_equal(got.trans, want.trans)
    assert got.eos_id == want.eos_id


def test_fixture_matches_transformers():
    """The committed tokenizer directory that chip_smoke.py serves with:
    ids, texts, chat rendering and specials as `transformers` reads it."""
    ref = jtok.HFTokenizer(FIXTURE)
    tok = ttok.get_tokenizer(FIXTURE)
    assert isinstance(tok, ttok.HFTokenizer)
    assert tok.vocab_size == ref.vocab_size == 4096
    for text in [c for group in CASES.values() for c in group]:
        want = ref.encode(text, bos=True)
        np.testing.assert_array_equal(tok.encode(text, bos=True), want,
                                      err_msg=repr(text))
        assert tok.decode(list(want) + [5000]) == ref.decode(want)
    chat = CHATS[1]
    assert tok.apply_chat_template(chat, add_generation_prompt=True) == \
        ref._tok.apply_chat_template(chat, tokenize=False,
                                     add_generation_prompt=True)


@pytest.mark.parametrize("variant", ["add_prefix_space", "no_regex",
                                     "ignore_merges"])
def test_byte_level_options_match_tokenizers(toks, variant):
    """The ByteLevel pre-tokenizer's add_prefix_space and use_regex and
    the BPE model's ignore_merges, as `tokenizers` applies them."""
    from tokenizers import Tokenizer

    with open(toks["path"]) as f:
        spec = json.load(f)
    if variant == "add_prefix_space":
        spec["pre_tokenizer"]["add_prefix_space"] = True
    elif variant == "no_regex":
        spec["pre_tokenizer"]["use_regex"] = False
    else:
        spec["model"]["ignore_merges"] = True
    ref = Tokenizer.from_str(json.dumps(spec))
    mine = ttok.ByteLevelBPE(spec)
    for text in [c for g in CASES.values() for c in g] + _random_cases(30):
        assert mine.encode(text) == ref.encode(text).ids, repr(text)


def test_hf_clean_up_tokenization_spaces(toks, tmp_path):
    """A directory whose tokenizer_config asks for the clean-up decodes
    as transformers decodes it."""
    import shutil

    d = tmp_path / "hf"
    shutil.copytree(toks["hf_dir"], d)
    cfg_path = d / "tokenizer_config.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["clean_up_tokenization_spaces"] = True
    cfg_path.write_text(json.dumps(cfg))
    ref, mine = jtok.HFTokenizer(str(d)), ttok.HFTokenizer(str(d))
    for text in ["a , b . c ! d ?", "I do n't know , you 're 's 've 'm",
                 "x ' y", "fine."]:
        ids = ref.encode(text)
        assert mine.decode(ids) == ref.decode(ids), repr(text)


def _spec(tmp_path, **over):
    with open(os.path.join(FIXTURE, "tokenizer.json")) as f:
        spec = json.load(f)
    for key, value in over.items():
        if key.startswith("model."):
            spec["model"][key[6:]] = value
        else:
            spec[key] = value
    path = tmp_path / "t.json"
    path.write_text(json.dumps(spec))
    return str(path)


UNSUPPORTED = {
    "split": dict(pre_tokenizer={"type": "Sequence", "pretokenizers": [
        {"type": "Split", "pattern": {"Regex": "\\d"},
         "behavior": "Isolated"}]}),
    "metaspace": dict(pre_tokenizer={"type": "Metaspace", "replacement": "▁",
                                     "prepend_scheme": "always"}),
    "unigram": {"model": {"type": "Unigram", "vocab": [["a", 0.0]]}},
    "wordpiece": {"model": {"type": "WordPiece", "vocab": {"a": 0}}},
    "byte_fallback": {"model.byte_fallback": True},
    "normalizer": dict(normalizer={"type": "NFC"}),
}


@pytest.mark.parametrize("component", sorted(UNSUPPORTED))
def test_unsupported_components_raise(tmp_path, component):
    path = _spec(tmp_path, **UNSUPPORTED[component])
    with pytest.raises(NotImplementedError):
        ttok.get_tokenizer(path)
    os.makedirs(tmp_path / "dir")
    os.replace(path, tmp_path / "dir" / "tokenizer.json")
    with pytest.raises(NotImplementedError):
        ttok.get_tokenizer(str(tmp_path / "dir"))


def test_serve_with_native_dir_and_tokenizer_dir(tmp_path, monkeypatch):
    """`serve --native-dir ... --tokenizer <dir>` builds its engine over
    the native directory's model and hands the server the directory's
    tokenizer, whose chat template /v1/chat/completions renders."""
    import dataclasses

    from shellac_tpu_torch.inference import server
    from shellac_tpu_torch.models import transformer as tt
    from shellac_tpu_torch.models.registry import get_model_config
    from shellac_tpu_torch.utils.safetensors import save_file

    cfg = get_model_config("tiny").replace(vocab_size=4096)
    params = tt.init_params(cfg, seed=1, device="cpu")
    save_file(cli.native_tensors(params), str(tmp_path / cli.NATIVE_PARAMS))
    (tmp_path / "config.json").write_text(json.dumps(
        dataclasses.asdict(cfg)))
    seen = {}
    monkeypatch.setattr(server, "serve",
                        lambda c, p, **kw: seen.update(kw, cfg=c, params=p))
    assert cli.main(["serve", "--device", "cpu", "--port", "0",
                     "--native-dir", str(tmp_path), "--tokenizer",
                     FIXTURE]) == 0
    assert seen["cfg"] == cfg
    assert seen["engine"].params["embed"].equal(params["embed"])
    tok = seen["tokenizer"]
    native = openai_api.chat_to_native(
        {"messages": CHATS[0], "max_tokens": 4}, tok)
    assert native["text"].startswith("<|bos|><|user|>\n")
    assert native["text"].endswith("<|assistant|>\n")
