"""Tokenizers: byte-level, trained BPE files and HF tokenizer directories.

The port's own copy of `shellac_tpu/training/tokenizer.py` (`ByteTokenizer`
:19, `HFTokenizer` :63, `get_tokenizer` :104, `BPETokenizer` :113), kept as
a copy because the port imports nothing of the JAX package. The
reference wraps the `tokenizers` and `transformers` packages, which the
port does not depend on, so it reads `tokenizer.json` itself:

  - the byte-level BPE that `BPETokenizer.train` writes and
    `PreTrainedTokenizerFast.save_pretrained` saves from it: the `BPE`
    model (merges by rank, `ignore_merges`), the GPT-2 `ByteLevel`
    pre-tokenizer (its regex as a scanner over `unicodedata` categories:
    `re` has no \\p{L}, and the port does not depend on `regex`) and
    decoder, and added and special tokens split out before
    pre-tokenizing;
  - anything else raises NotImplementedError naming the component: a
    normalizer, `Split` or other pre-tokenizers (Llama-3, o200k),
    `Metaspace`, `Unigram`, `WordPiece`, `byte_fallback`, BPE dropout,
    added tokens that strip or match single words.

`HFTokenizer` reads a directory's `tokenizer.json`, `tokenizer_config.json`
(BOS/EOS, added tokens, `clean_up_tokenization_spaces`) and chat template
(`chat_template.jinja`, or the config's `chat_template`), and renders the
template as `transformers`' `apply_chat_template` does (jinja2, which
torch depends on). Neither BPE tokenizer has `token_bytes`, as the
reference's lack it, so constrained decoding takes the decode fallback
(`inference/constraints.py` `_token_bytes`) and compiles the same tables.
`BPETokenizer.train` needs `tokenizers` and raises.
"""

from __future__ import annotations

import functools
import heapq
import json
import os
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


class ByteTokenizer:
    """UTF-8 bytes as token ids; specials above the byte range."""

    BOS = 256
    EOS = 257
    PAD = 258

    vocab_size = 259

    def encode(self, text: str, *, bos: bool = False,
               eos: bool = False) -> np.ndarray:
        ids: List[int] = list(text.encode("utf-8"))
        if bos:
            ids.insert(0, self.BOS)
        if eos:
            ids.append(self.EOS)
        return np.asarray(ids, dtype=np.int32)

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(int(i) for i in np.asarray(ids).reshape(-1)
                     if int(i) < 256)
        return data.decode("utf-8", errors="replace")

    def token_bytes(self, tid: int):
        """Exact surface bytes of one token (None for specials)."""
        return bytes([tid]) if 0 <= tid < 256 else None

    def encode_documents(
        self, docs: Iterable[str], *, eos_between: bool = True
    ) -> np.ndarray:
        """Concatenate documents into one token stream (EOS-separated)."""
        return _join_documents(self, docs, self.EOS if eos_between else None)


def _join_documents(tok, docs: Iterable[str], sep: Optional[int]):
    parts = []
    for d in docs:
        parts.append(tok.encode(d))
        if sep is not None:
            parts.append(np.asarray([sep], np.int32))
    if not parts:
        return np.zeros((0,), np.int32)
    return np.concatenate(parts)


# ------------------------------------------------------- byte-level BPE


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's map of the 256 bytes onto printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


_BYTE_CHAR = _bytes_to_unicode()
_CHAR_BYTE = {c: b for b, c in _BYTE_CHAR.items()}

# Unicode White_Space: what `\s` matches in the regex engine `tokenizers`
# uses. Python's str.isspace() also takes U+001C-U+001F, which this does
# not.
_WHITE_SPACE = frozenset(
    [chr(c) for c in range(0x09, 0x0E)]
    + [chr(c) for c in (0x20, 0x85, 0xA0, 0x1680)]
    + [chr(c) for c in range(0x2000, 0x200B)]
    + [chr(c) for c in (0x2028, 0x2029, 0x202F, 0x205F, 0x3000)])
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# `tokenizers`' BPE cache: this many pieces, none longer than this.
_CACHE_SIZE = 10_000
_CACHE_MAX_PIECE = 256


def _kind(c: str) -> str:
    """'s' (White_Space), 'L' (\\p{L}), 'N' (\\p{N}) or 'o' (the rest)."""
    if c in _WHITE_SPACE:
        return "s"
    cat = unicodedata.category(c)[0]
    return cat if cat in ("L", "N") else "o"


def gpt2_split(text: str) -> List[str]:
    """The pieces of the GPT-2 pattern
    's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+
    matched left to right over `text` (every character lands in one)."""
    kinds = [_kind(c) for c in text]
    n = len(text)
    out = []
    i = 0
    while i < n:
        j = None
        if text[i] == "'":
            for c in _CONTRACTIONS:
                if text.startswith(c, i):
                    j = i + len(c)
                    break
        if j is None:
            # ` ?X+` for X in letters, numbers, other: the space (U+0020
            # only) joins a run of the class that follows it.
            k = i + 1 if text[i] == " " and i + 1 < n else i
            cls = kinds[k]
            if cls != "s" and (k == i or kinds[i] == "s"):
                j = k + 1
                while j < n and kinds[j] == cls:
                    j += 1
        if j is None:
            # A whitespace run; `\s+(?!\S)` leaves its last character to
            # the next piece when a non-space follows, unless the run is
            # one character long (then `\s+` takes it).
            j = i + 1
            while j < n and kinds[j] == "s":
                j += 1
            if j < n and j - i > 1:
                j -= 1
        out.append(text[i:j])
        i = j
    return out


def _unsupported(what: str):
    raise NotImplementedError(
        f"tokenizer.json {what} is not supported by the port (it reads "
        "byte-level BPE: the BPE model with the ByteLevel pre-tokenizer "
        "and decoder)")


class ByteLevelBPE:
    """The byte-level BPE of one `tokenizer.json` (dict `spec`)."""

    def __init__(self, spec: dict):
        model = spec.get("model") or {}
        if model.get("type") != "BPE":
            _unsupported(f"model {model.get('type')!r}")
        if model.get("byte_fallback"):
            _unsupported("BPE byte_fallback")
        if model.get("dropout"):
            _unsupported("BPE dropout")
        for key in ("continuing_subword_prefix", "end_of_word_suffix"):
            if model.get(key):
                _unsupported(f"BPE {key}")
        if spec.get("normalizer") is not None:
            _unsupported(f"normalizer {spec['normalizer'].get('type')!r}")
        pre = spec.get("pre_tokenizer") or {}
        if pre.get("type") != "ByteLevel":
            _unsupported(f"pre_tokenizer {pre.get('type')!r}")
        dec = spec.get("decoder") or {}
        if dec.get("type") != "ByteLevel":
            _unsupported(f"decoder {dec.get('type')!r}")
        post = spec.get("post_processor")
        if post is not None and post.get("type") != "ByteLevel":
            self.post_processor = post.get("type")
        else:
            self.post_processor = None
        self.add_prefix_space = bool(pre.get("add_prefix_space"))
        self.use_regex = bool(pre.get("use_regex", True))
        self.ignore_merges = bool(model.get("ignore_merges"))
        self.vocab: Dict[str, int] = dict(model["vocab"])
        self.ranks: Dict[Tuple[str, str], int] = {}
        for r, m in enumerate(model.get("merges") or []):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self.ranks.setdefault((a, b), r)
        self.unk = model.get("unk_token")
        self.added: Dict[str, int] = {}
        self.special_ids = set()
        for t in spec.get("added_tokens") or []:
            for flag in ("lstrip", "rstrip", "single_word"):
                if t.get(flag):
                    _unsupported(f"added token {t['content']!r} with {flag}")
            self.added[t["content"]] = t["id"]
            if t.get("special"):
                self.special_ids.add(t["id"])
        # Non-normalized added tokens split the text first, then the
        # normalized ones (with no normalizer, over the same text).
        self._passes = [
            sorted((t["content"] for t in spec.get("added_tokens") or []
                    if bool(t.get("normalized", True)) == norm), key=len,
                   reverse=True)
            for norm in (False, True)]
        self.id_to_token: Dict[int, str] = {i: t for t, i in
                                            self.vocab.items()}
        self.id_to_token.update({i: t for t, i in self.added.items()})
        # A bounded LRU of pieces' ids, per tokenizer.
        self._cached_ids = functools.lru_cache(maxsize=_CACHE_SIZE)(
            self._word_ids)

    @property
    def vocab_size(self) -> int:
        """Every id, added tokens included (`get_vocab_size()`)."""
        return len(self.id_to_token)

    def token_to_id(self, token: str) -> Optional[int]:
        if token in self.added:
            return self.added[token]
        return self.vocab.get(token)

    def _split_added(self, text: str) -> List[Tuple[str, bool]]:
        """(piece, is an added token) pieces, leftmost-longest matches of
        each pass in turn."""
        pieces = [(text, False)]
        for tokens in self._passes:
            if not tokens:
                continue
            out = []
            for piece, fixed in pieces:
                if fixed:
                    out.append((piece, True))
                    continue
                at = 0
                while at < len(piece):
                    best = None
                    for t in tokens:
                        k = piece.find(t, at)
                        if k >= 0 and (best is None or k < best[0]
                                       or (k == best[0]
                                           and len(t) > len(best[1]))):
                            best = (k, t)
                    if best is None:
                        out.append((piece[at:], False))
                        break
                    k, t = best
                    if k > at:
                        out.append((piece[at:k], False))
                    out.append((t, True))
                    at = k + len(t)
            pieces = out
        return pieces

    def _bpe(self, word: str) -> Tuple[int, ...]:
        # Long pieces (a base64 blob, a row of dashes) skip the cache, as
        # in `tokenizers`, so that user text cannot fill it.
        if len(word) > _CACHE_MAX_PIECE:
            return self._word_ids(word)
        return self._cached_ids(word)

    def _word_ids(self, word: str) -> Tuple[int, ...]:
        if self.ignore_merges and word in self.vocab:
            return (self.vocab[word],)
        ids = []
        for s in self._merge(word):
            if s in self.vocab:
                ids.append(self.vocab[s])
            elif self.unk is not None and self.unk in self.vocab:
                ids.append(self.vocab[self.unk])
            else:
                raise ValueError(f"BPE symbol {s!r} is not in the "
                                 "vocab and there is no unk_token")
        return tuple(ids)

    def _merge(self, word: str) -> List[str]:
        """`tokenizers`' merge of one piece: a heap of (rank, position)
        pairs, the lowest rank and then the leftmost first, over a linked
        list of symbols; a popped pair that no longer stands is skipped.
        O(n log n) in the piece's length."""
        syms: List[Optional[str]] = list(word)
        n = len(syms)
        nxt = list(range(1, n + 1))
        prev = list(range(-1, n - 1))
        ranks = self.ranks
        heap = [(r, k) for k in range(n - 1)
                if (r := ranks.get((syms[k], syms[k + 1]))) is not None]
        heapq.heapify(heap)
        while heap:
            r, k = heapq.heappop(heap)
            j = nxt[k]
            if syms[k] is None or j >= n or \
                    ranks.get((syms[k], syms[j])) != r:
                continue
            syms[k] += syms[j]
            syms[j] = None
            nxt[k] = nxt[j]
            if nxt[k] < n:
                prev[nxt[k]] = k
                r2 = ranks.get((syms[k], syms[nxt[k]]))
                if r2 is not None:
                    heapq.heappush(heap, (r2, k))
            if prev[k] >= 0:
                r2 = ranks.get((syms[prev[k]], syms[k]))
                if r2 is not None:
                    heapq.heappush(heap, (r2, prev[k]))
        return [s for s in syms if s is not None]

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece, added in self._split_added(text):
            if added:
                ids.append(self.added[piece])
                continue
            if self.add_prefix_space and not piece.startswith(" "):
                piece = " " + piece
            words = gpt2_split(piece) if self.use_regex else [piece]
            for w in words:
                mapped = "".join(_BYTE_CHAR[b] for b in w.encode("utf-8"))
                ids.extend(self._bpe(mapped))
        return ids

    def decode(self, ids: Iterable[int], skip_special: bool = True) -> str:
        """Ids the vocab lacks are dropped; specials too, with
        `skip_special`. A token any of whose characters lies outside the
        byte map contributes its own UTF-8 bytes."""
        data = bytearray()
        for i in ids:
            tok = self.id_to_token.get(int(i))
            if tok is None or (skip_special and int(i) in self.special_ids):
                continue
            try:
                data.extend(_CHAR_BYTE[c] for c in tok)
            except KeyError:
                data.extend(tok.encode("utf-8"))
        return data.decode("utf-8", errors="replace")


def _load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


class BPETokenizer:
    """Byte-level BPE from a single JSON file written by `train` (the
    reference's `tokenizers` format): specials <|bos|>, <|eos|>, <|pad|>."""

    BOS_TOKEN = "<|bos|>"
    EOS_TOKEN = "<|eos|>"
    PAD_TOKEN = "<|pad|>"

    def __init__(self, path: str):
        self._tok = ByteLevelBPE(_load_json(path))
        if self._tok.post_processor is not None:
            _unsupported(f"post_processor {self._tok.post_processor!r}")
        self.vocab_size = self._tok.vocab_size
        self.bos_id = self._tok.token_to_id(self.BOS_TOKEN)
        self.eos_id = self._tok.token_to_id(self.EOS_TOKEN)
        self.pad_id = self._tok.token_to_id(self.PAD_TOKEN)
        missing = [t for t, i in (
            (self.BOS_TOKEN, self.bos_id), (self.EOS_TOKEN, self.eos_id),
            (self.PAD_TOKEN, self.pad_id),
        ) if i is None]
        if missing:
            raise ValueError(
                f"{path} lacks the specials {missing} — not a tokenizer "
                "trained by BPETokenizer.train (for HF tokenizer.json "
                "files, pass the tokenizer DIRECTORY instead)"
            )

    @classmethod
    def train(cls, files: Sequence[str], vocab_size: int,
              out_path: str) -> "BPETokenizer":
        raise NotImplementedError(
            "BPETokenizer.train needs the `tokenizers` package; train with "
            "the JAX package's `tokenize --train-bpe` and load the file")

    def encode(self, text: str, *, bos: bool = False,
               eos: bool = False) -> np.ndarray:
        ids = self._tok.encode(text)
        if bos:
            ids = [self.bos_id] + ids
        if eos:
            ids = ids + [self.eos_id]
        return np.asarray(ids, dtype=np.int32)

    def decode(self, ids: Sequence[int]) -> str:
        specials = {self.bos_id, self.eos_id, self.pad_id}
        return self._tok.decode(
            int(i) for i in np.asarray(ids).reshape(-1)
            if int(i) not in specials)

    def encode_documents(
        self, docs: Iterable[str], *, eos_between: bool = True
    ) -> np.ndarray:
        return _join_documents(self, docs,
                               self.eos_id if eos_between else None)


_SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token",
                 "pad_token", "cls_token", "mask_token")


def _token_text(v) -> Optional[str]:
    if isinstance(v, dict):
        return v.get("content")
    return v


class HFTokenizer:
    """A local HF tokenizer directory (`save_pretrained`'s files)."""

    def __init__(self, path: str):
        self.path = path
        self._tok = ByteLevelBPE(_load_json(os.path.join(path,
                                                         "tokenizer.json")))
        config: dict = {}
        for name in ("special_tokens_map.json", "tokenizer_config.json"):
            p = os.path.join(path, name)
            if os.path.exists(p):
                config.update(_load_json(p))
        for i, t in (config.get("added_tokens_decoder") or {}).items():
            self._tok.id_to_token.setdefault(int(i), t["content"])
            self._tok.added.setdefault(t["content"], int(i))
            if t.get("special"):
                self._tok.special_ids.add(int(i))
        # special_tokens_map: the named specials as text, which the chat
        # template sees (bos_token, eos_token, ...).
        self.special_tokens_map: Dict[str, object] = {}
        for key in _SPECIAL_KEYS:
            text = _token_text(config.get(key))
            if text is not None:
                self.special_tokens_map[key] = text
                tid = self._tok.token_to_id(text)
                if tid is not None:
                    self._tok.special_ids.add(tid)
        extra = [_token_text(t) for t in
                 config.get("additional_special_tokens") or []]
        if extra:
            self.special_tokens_map["additional_special_tokens"] = extra
            self._tok.special_ids.update(
                i for i in map(self._tok.token_to_id, extra) if i is not None)
        self.bos_token_id = self._id_of("bos_token")
        self.eos_token_id = self._id_of("eos_token")
        self.clean_up_tokenization_spaces = bool(
            config.get("clean_up_tokenization_spaces", False))
        self.chat_template = _chat_template(path, config)
        self._template = None
        self.vocab_size = self._tok.vocab_size

    def _id_of(self, key: str) -> Optional[int]:
        text = self.special_tokens_map.get(key)
        return None if text is None else self._tok.token_to_id(text)

    def encode(self, text: str, *, bos: bool = False,
               eos: bool = False) -> np.ndarray:
        ids = self._tok.encode(text)
        if bos and self.bos_token_id is not None:
            ids = [self.bos_token_id] + ids
        if eos and self.eos_token_id is not None:
            ids = ids + [self.eos_token_id]
        return np.asarray(ids, dtype=np.int32)

    def decode(self, ids: Sequence[int]) -> str:
        text = self._tok.decode(
            (int(i) for i in np.asarray(ids).reshape(-1)), skip_special=True)
        if self.clean_up_tokenization_spaces:
            text = _clean_up_tokenization(text)
        return text

    def encode_documents(
        self, docs: Iterable[str], *, eos_between: bool = True
    ) -> np.ndarray:
        return _join_documents(
            self, docs, self.eos_token_id if eos_between else None)

    def apply_chat_template(self, messages: List[dict],
                            add_generation_prompt: bool = False,
                            tools: Optional[List[dict]] = None,
                            documents: Optional[List[dict]] = None,
                            **kwargs) -> str:
        """The chat template rendered as `transformers`'
        `apply_chat_template(..., tokenize=False)` renders it."""
        if not self.chat_template:
            raise ValueError(f"{self.path} has no chat template")
        if self._template is None:
            # Compiled once per tokenizer, as transformers caches it.
            self._template = _compile_chat_template(self.chat_template)
        return self._template.render(
            messages=messages, tools=tools, documents=documents,
            add_generation_prompt=add_generation_prompt,
            **{**self.special_tokens_map, **kwargs})


def _chat_template(path: str, config: dict) -> Optional[str]:
    p = os.path.join(path, "chat_template.jinja")
    if os.path.exists(p):
        with open(p, encoding="utf-8") as f:
            return f.read()
    t = config.get("chat_template")
    if isinstance(t, list):
        named = {d["name"]: d["template"] for d in t}
        return named.get("default")
    return t


def _clean_up_tokenization(text: str) -> str:
    """transformers' `clean_up_tokenization`: no space before
    punctuation and English contractions."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                 (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"),
                 (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(a, b)
    return text


def _compile_chat_template(source: str):
    """A jinja2 template in `transformers`' environment: sandboxed and
    immutable, trim_blocks, lstrip_blocks, loop controls, the
    `{% generation %}` tag, `tojson` without HTML escaping,
    `raise_exception` and `strftime_now`."""
    try:
        import jinja2
        import jinja2.ext
        from jinja2.sandbox import ImmutableSandboxedEnvironment
    except ImportError as e:
        raise NotImplementedError(
            "chat templates need jinja2, which is not installed") from e
    from datetime import datetime

    class Generation(jinja2.ext.Extension):
        tags = {"generation"}

        def parse(self, parser):
            lineno = next(parser.stream).lineno
            body = parser.parse_statements(("name:endgeneration",),
                                           drop_needle=True)
            return jinja2.nodes.CallBlock(
                self.call_method("_render"), [], [], body).set_lineno(lineno)

        def _render(self, caller):
            return caller()

    def raise_exception(message):
        raise jinja2.exceptions.TemplateError(message)

    def tojson(x, ensure_ascii=False, indent=None, separators=None,
               sort_keys=False):
        return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent,
                          separators=separators, sort_keys=sort_keys)

    env = ImmutableSandboxedEnvironment(
        trim_blocks=True, lstrip_blocks=True,
        extensions=[Generation, jinja2.ext.loopcontrols])
    env.filters["tojson"] = tojson
    env.globals["raise_exception"] = raise_exception
    env.globals["strftime_now"] = lambda fmt: datetime.now().strftime(fmt)
    return env.from_string(source)


def get_tokenizer(spec: str = "byte"):
    """"byte", a trained BPE .json file, or a local HF tokenizer dir."""
    if spec == "byte":
        return ByteTokenizer()
    if spec.endswith(".json"):
        return BPETokenizer(spec)
    return HFTokenizer(spec)
