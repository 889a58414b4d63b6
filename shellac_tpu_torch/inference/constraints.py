"""Structured (grammar-constrained) decoding.

The port's own copy of `shellac_tpu/inference/constraints.py` (the regex
engine `_Regex` and `CharDFA`, the byte DFA `_byte_dfa` and its
minimization `_minimize`, `TokenDFA` :542, `compile_token_dfa` :596, the
JSON-schema lowering `_schema_regex` :750 with local `$ref`s and string
formats, and `constraint_pattern` :934), kept as a copy because the port
imports nothing of the JAX package. Pure numpy and Python: its tables
equal the reference's bit for bit, and its guards (`MAX_DFA_STATES`,
`MAX_TABLE_ENTRIES`, dead states) raise with the same messages.

The idea (Outlines/JSONformer): compile a grammar to a finite automaton
over the TOKEN alphabet, then mask logits each step.

  1. A small regex engine compiles a pattern to an NFA over UTF-8
     BYTES (Thompson construction): character classes are codepoint
     RANGES lowered to byte-sequence range chains (the standard
     UTF-8 range decomposition), so the full Unicode plane constrains
     exactly, and byte-level tokenizers whose tokens split multi-byte
     characters advance the automaton mid-character.
  2. The byte NFA is determinized, MINIMIZED (Moore partition
     refinement over the 256-byte alphabet), then lifted to the token
     alphabet: walking every vocab token's bytes through the byte DFA
     yields one token-level transition table `trans (S, V+1) int32`
     (-1 = disallowed; the last column is EOS, allowed exactly in
     accepting states).
  3. The batching engines keep the table on the device. Each decode
     tick does two gathers inside the window's CUDA graph: `row =
     trans[off + state]` masks the logits, and `state = row[sampled]`
     advances, with no host sync (inference/batching.py).

JSON-schema support generates a regex for a schema subset: optional
properties (the `required` list is honored; undeclared = optional),
anyOf/oneOf alternation, const/enum with any Unicode content, nested
arrays/objects, local `$ref` (`#/$defs/...`, cycle-detected), common
string `format`s (date-time, date, uuid, email), and
`additionalProperties: true`. Property ORDER stays fixed.

The table is DENSE (S x V+1 int32): minimization plus a total-entries
budget (MAX_TABLE_ENTRIES) bound its memory; the budget, not the state
cap alone, is what protects device memory for large vocabularies.
"""

from __future__ import annotations

import json
from typing import Any, Dict, FrozenSet, List, Optional, Tuple

import numpy as np

# Compilation guards: a pathological pattern must fail loudly at
# submit time, not hang the scheduler or blow HBM.
MAX_DFA_STATES = 8192          # token-level states per constraint
MAX_BYTE_STATES = 65536        # byte-level exploration bound
MAX_TABLE_ENTRIES = 32_000_000  # S * (V+1) budget (~128 MB int32)
# Token-walk precompute budget (vocab x byte-states). Over budget,
# compilation switches to per-state walking — slower per discovered
# state, bounded memory.
MAX_WALK_ENTRIES = 32_000_000

_MAX_CP = 0x10FFFF
# '.' excludes newline (standard default); surrogates are not valid
# codepoints.
_DOT_RANGES = ((0x00, 0x09), (0x0B, 0xD7FF), (0xE000, _MAX_CP))
# The full universe, newline included. Negated classes ([^x]) and the
# complemented escapes (\D \W \S) complement within THIS universe —
# standard regex semantics, where only '.' excludes newline.
_ANY_RANGES = ((0x00, 0xD7FF), (0xE000, _MAX_CP))

Ranges = Tuple[Tuple[int, int], ...]


def _norm_ranges(pairs) -> Ranges:
    """Sort + merge overlapping/adjacent codepoint ranges."""
    pairs = sorted((lo, hi) for lo, hi in pairs if lo <= hi)
    out: List[Tuple[int, int]] = []
    for lo, hi in pairs:
        if out and lo <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return tuple(out)


def _ranges_from_chars(chars) -> Ranges:
    return _norm_ranges((ord(c), ord(c)) for c in chars)


def _intersect(a: Ranges, b: Ranges) -> Ranges:
    out = []
    for lo1, hi1 in a:
        for lo2, hi2 in b:
            lo, hi = max(lo1, lo2), min(hi1, hi2)
            if lo <= hi:
                out.append((lo, hi))
    return _norm_ranges(out)


def _complement(a: Ranges, universe: Ranges = _ANY_RANGES) -> Ranges:
    out = []
    for ulo, uhi in universe:
        cur = ulo
        for lo, hi in a:
            if hi < cur or lo > uhi:
                continue
            if lo > cur:
                out.append((cur, lo - 1))
            cur = max(cur, hi + 1)
            if cur > uhi:
                break
        if cur <= uhi:
            out.append((cur, uhi))
    return _norm_ranges(out)


def _utf8(cp: int) -> bytes:
    return chr(cp).encode("utf-8")


def _utf8_seqs(lo: int, hi: int) -> List[Tuple[Tuple[int, int], ...]]:
    """Decompose a codepoint range into UTF-8 byte-range sequences.

    Returns chains of per-byte (lo, hi) ranges whose concatenated
    byte strings cover exactly the UTF-8 encodings of [lo, hi] — the
    standard decomposition (public: Lucene UTF32ToUTF8 /
    regex-automata), re-derived here."""

    def seq(lo_b: bytes, hi_b: bytes) -> List[Tuple[Tuple[int, int], ...]]:
        n = len(lo_b)
        if n == 1:
            return [((lo_b[0], hi_b[0]),)]
        if lo_b[0] == hi_b[0]:
            return [((lo_b[0], lo_b[0]),) + tail
                    for tail in seq(lo_b[1:], hi_b[1:])]
        mins = bytes([0x80] * (n - 1))
        maxs = bytes([0xBF] * (n - 1))
        res: List[Tuple[Tuple[int, int], ...]] = []
        lo_first = lo_b[0]
        if lo_b[1:] != mins:
            res += [((lo_b[0], lo_b[0]),) + tail
                    for tail in seq(lo_b[1:], maxs)]
            lo_first = lo_b[0] + 1
        hi_first = hi_b[0]
        tail_part: List[Tuple[Tuple[int, int], ...]] = []
        if hi_b[1:] != maxs:
            tail_part = [((hi_b[0], hi_b[0]),) + t
                         for t in seq(mins, hi_b[1:])]
            hi_first = hi_b[0] - 1
        if lo_first <= hi_first:
            res.append(((lo_first, hi_first),)
                       + tuple((0x80, 0xBF) for _ in range(n - 1)))
        return res + tail_part

    out: List[Tuple[Tuple[int, int], ...]] = []
    # Split by encoded length first (1..4 bytes).
    for a, b in ((0x00, 0x7F), (0x80, 0x7FF), (0x800, 0xFFFF),
                 (0x10000, _MAX_CP)):
        s, e = max(lo, a), min(hi, b)
        if s <= e:
            out.extend(seq(_utf8(s), _utf8(e)))
    return out


# ---------------------------------------------------------------------------
# regex -> byte-level NFA (Thompson construction)
# ---------------------------------------------------------------------------


class _Regex:
    """Recursive-descent parser for a practical regex subset:
    literals (full Unicode), '.', escapes (\\d \\w \\s \\n \\t \\r +
    punctuation), [...] classes with ranges/negation, (...) groups,
    '|', and the postfix operators * + ? {m} {m,} {m,n}. Anchored
    implicitly (the whole output must match the whole pattern). The
    NFA alphabet is UTF-8 BYTES: each character-class edge lowers to
    byte-range chains via _utf8_seqs."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        # NFA: edges[state] = list of (byte_lo, byte_hi, target);
        # eps[state] = epsilon targets.
        self.eps: List[List[int]] = []
        self.edges: List[List[Tuple[int, int, int]]] = []

    # -- NFA building blocks --

    def _state(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1

    def _frag_char(self, ranges: Ranges) -> Tuple[int, int]:
        if not ranges:
            raise ValueError(
                f"empty character class in {self.p!r} (negation left "
                "nothing matchable)"
            )
        a, b = self._state(), self._state()
        for lo, hi in ranges:
            for chain in _utf8_seqs(lo, hi):
                cur = a
                for j, (blo, bhi) in enumerate(chain):
                    nxt = b if j == len(chain) - 1 else self._state()
                    self.edges[cur].append((blo, bhi, nxt))
                    cur = nxt
        return a, b

    def _frag_concat(self, f1, f2) -> Tuple[int, int]:
        self.eps[f1[1]].append(f2[0])
        return f1[0], f2[1]

    def _frag_alt(self, frags) -> Tuple[int, int]:
        a, b = self._state(), self._state()
        for f in frags:
            self.eps[a].append(f[0])
            self.eps[f[1]].append(b)
        return a, b

    def _frag_star(self, f) -> Tuple[int, int]:
        a, b = self._state(), self._state()
        self.eps[a] += [f[0], b]
        self.eps[f[1]] += [f[0], b]
        return a, b

    def _frag_eps(self) -> Tuple[int, int]:
        a, b = self._state(), self._state()
        self.eps[a].append(b)
        return a, b

    # -- parsing --

    _CLASSES = {
        "d": _ranges_from_chars("0123456789"),
        "w": _ranges_from_chars(
            "abcdefghijklmnopqrstuvwxyz"
            "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"
        ),
        "s": _ranges_from_chars(" \t\n\r\f\v"),
    }

    def _peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def _next(self) -> str:
        ch = self.p[self.i]
        self.i += 1
        return ch

    def _escape(self) -> Ranges:
        ch = self._next()
        if ch in self._CLASSES:
            return self._CLASSES[ch]
        if ch in ("D", "W", "S"):
            return _complement(self._CLASSES[ch.lower()])
        lit = {"n": "\n", "t": "\t", "r": "\r",
               "f": "\f", "v": "\v"}.get(ch, ch)
        return _ranges_from_chars(lit)

    def _charclass(self) -> Ranges:
        neg = False
        if self._peek() == "^":
            self._next()
            neg = True
        pairs: List[Tuple[int, int]] = []
        while True:
            ch = self._peek()
            if ch is None:
                raise ValueError(f"unterminated [ in {self.p!r}")
            if ch == "]":
                self._next()
                break
            self._next()
            if ch == "\\":
                pairs.extend(self._escape())
                continue
            if self._peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                self._next()
                hi = self._next()
                if hi == "\\":
                    sub = self._escape()
                    if len(sub) != 1 or sub[0][0] != sub[0][1]:
                        raise ValueError(
                            f"range endpoint must be a single char in "
                            f"{self.p!r}"
                        )
                    hi_cp = sub[0][0]
                else:
                    hi_cp = ord(hi)
                if ord(ch) > hi_cp:
                    # Standard engines reject [z-a]; silently narrowing
                    # the class would change the constrained language
                    # with no error at submit time.
                    raise ValueError(
                        f"bad character range {ch}-{chr(hi_cp)} in "
                        f"{self.p!r} (reversed endpoints)"
                    )
                pairs.append((ord(ch), hi_cp))
            else:
                pairs.append((ord(ch), ord(ch)))
        ranges = _intersect(_norm_ranges(pairs), _ANY_RANGES)
        return _complement(ranges) if neg else ranges

    def _repeat(self, frag, lo: int, hi: Optional[int], atom_src):
        """Expand {lo,hi} by cloning the atom (re-parsing the source
        slice — simple and correct for this subset's sizes)."""
        out = self._frag_eps()
        for _ in range(lo):
            out = self._frag_concat(out, self._clone(atom_src))
        if hi is None:
            out = self._frag_concat(out, self._frag_star(self._clone(atom_src)))
        else:
            for _ in range(hi - lo):
                opt = self._clone(atom_src)
                a, b = self._frag_eps()
                self.eps[a].append(opt[0])
                self.eps[opt[1]].append(b)
                out = self._frag_concat(out, (a, b))
        return out

    def _clone(self, src: str):
        save_p, save_i = self.p, self.i
        self.p, self.i = src, 0
        frag = self._parse_alt()
        self.p, self.i = save_p, save_i
        return frag

    def _parse_atom(self):
        start_i = self.i
        ch = self._next()
        if ch == "(":
            frag = self._parse_alt()
            if self._peek() != ")":
                raise ValueError(f"unbalanced ( in {self.p!r}")
            self._next()
        elif ch == "[":
            frag = self._frag_char(self._charclass())
        elif ch == ".":
            frag = self._frag_char(_DOT_RANGES)
        elif ch == "\\":
            frag = self._frag_char(self._escape())
        elif ch in ")|*+?{":
            raise ValueError(f"unexpected {ch!r} at {self.i} in {self.p!r}")
        else:
            frag = self._frag_char(_ranges_from_chars(ch))
        return frag, self.p[start_i:self.i]

    def _parse_concat(self):
        frag = self._frag_eps()
        while self._peek() not in (None, "|", ")"):
            atom, src = self._parse_atom()
            ch = self._peek()
            if ch == "*":
                self._next()
                atom = self._frag_star(atom)
            elif ch == "+":
                self._next()
                atom = self._frag_concat(atom, self._frag_star(self._clone(src)))
            elif ch == "?":
                self._next()
                a, b = self._frag_eps()
                self.eps[a].append(atom[0])
                self.eps[atom[1]].append(b)
                atom = (a, b)
            elif ch == "{":
                self._next()
                spec = ""
                while self._peek() not in (None, "}"):
                    spec += self._next()
                if self._peek() != "}":
                    raise ValueError(f"unterminated {{ in {self.p!r}")
                self._next()
                if "," in spec:
                    lo_s, hi_s = spec.split(",", 1)
                    lo = int(lo_s)
                    hi = int(hi_s) if hi_s else None
                else:
                    lo = hi = int(spec)
                atom = self._repeat(None, lo, hi, src)
            frag = self._frag_concat(frag, atom)
        return frag

    def _parse_alt(self):
        frags = [self._parse_concat()]
        while self._peek() == "|":
            self._next()
            frags.append(self._parse_concat())
        return frags[0] if len(frags) == 1 else self._frag_alt(frags)

    def compile(self):
        frag = self._parse_alt()
        if self.i != len(self.p):
            raise ValueError(f"trailing {self.p[self.i:]!r} in {self.p!r}")
        return frag


class CharDFA:
    """Lazily-determinized automaton over the byte NFA.

    The public API stays character-level (`step(state, ch)` walks the
    char's UTF-8 bytes) so callers and tests are alphabet-agnostic;
    `step_byte` exposes the byte granularity the token lifting uses."""

    def __init__(self, pattern: str):
        rx = _Regex(pattern)
        start, accept = rx.compile()
        self._eps = rx.eps
        self._edges = rx.edges
        self._accept_nfa = accept
        self.start = self._closure(frozenset({start}))
        self._memo: Dict[Tuple[FrozenSet[int], int],
                         Optional[FrozenSet[int]]] = {}

    def _closure(self, states: FrozenSet[int]) -> FrozenSet[int]:
        out, stack = set(states), list(states)
        while stack:
            s = stack.pop()
            for t in self._eps[s]:
                if t not in out:
                    out.add(t)
                    stack.append(t)
        return frozenset(out)

    def step_byte(self, state: FrozenSet[int],
                  b: int) -> Optional[FrozenSet[int]]:
        key = (state, b)
        if key in self._memo:
            return self._memo[key]
        nxt = set()
        for s in state:
            for lo, hi, t in self._edges[s]:
                if lo <= b <= hi:
                    nxt.add(t)
        res = self._closure(frozenset(nxt)) if nxt else None
        self._memo[key] = res
        return res

    def step(self, state: FrozenSet[int],
             ch: str) -> Optional[FrozenSet[int]]:
        cur = state
        for b in ch.encode("utf-8"):
            cur = self.step_byte(cur, b)
            if cur is None:
                return None
        return cur

    def accepting(self, state: FrozenSet[int]) -> bool:
        return self._accept_nfa in state


# ---------------------------------------------------------------------------
# explicit byte DFA + minimization
# ---------------------------------------------------------------------------


def _byte_dfa(cdfa: CharDFA) -> Tuple[np.ndarray, np.ndarray]:
    """Exhaustively determinize: (trans (S, 256) int32 with -1 dead,
    accept (S,) bool). State 0 is the start."""
    index: Dict[FrozenSet[int], int] = {cdfa.start: 0}
    order = [cdfa.start]
    rows: List[np.ndarray] = []
    qi = 0
    while qi < len(order):
        st = order[qi]
        qi += 1
        row = np.full((256,), -1, np.int32)
        for b in range(256):
            nxt = cdfa.step_byte(st, b)
            if nxt is None:
                continue
            if nxt not in index:
                if len(index) >= MAX_BYTE_STATES:
                    raise ValueError(
                        f"constraint byte DFA exceeds {MAX_BYTE_STATES} "
                        f"states; simplify the pattern"
                    )
                index[nxt] = len(order)
                order.append(nxt)
            row[b] = index[nxt]
        rows.append(row)
    trans = np.stack(rows, axis=0)
    accept = np.asarray([cdfa.accepting(st) for st in order], bool)
    return trans, accept


def _minimize(trans: np.ndarray,
              accept: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Moore partition refinement over the 256-byte alphabet.

    Equivalent states (same acceptance, transitions into the same
    blocks for every byte) merge; counting patterns and schema
    compilations shrink several-fold, which is what buys token-table
    capacity under the dense-row memory budget."""
    s = trans.shape[0]
    block = accept.astype(np.int64).copy()  # initial split: accepting?
    # Map -1 (dead) to a fixed sentinel block forever.
    while True:
        # Signature: own block + successor blocks per byte.
        succ = np.where(trans >= 0, block[np.clip(trans, 0, None)], -1)
        sig = np.concatenate([block[:, None], succ], axis=1)
        _, new_block = np.unique(sig, axis=0, return_inverse=True)
        if (new_block == block).all() or len(np.unique(new_block)) == s:
            block = new_block
            break
        block = new_block
    n_blocks = int(block.max()) + 1
    # Representative per block; remap start (state 0) to block order
    # with the start's block first for determinism.
    remap = np.full((n_blocks,), -1, np.int64)
    new_ids = []
    next_id = 0
    for st in range(s):
        b = block[st]
        if remap[b] < 0:
            remap[b] = next_id
            new_ids.append(st)
            next_id += 1
    reps = np.asarray(new_ids)
    new_trans = trans[reps]
    new_trans = np.where(
        new_trans >= 0,
        remap[block[np.clip(new_trans, 0, None)]].astype(np.int32),
        -1,
    ).astype(np.int32)
    new_accept = accept[reps]
    return new_trans, new_accept


# ---------------------------------------------------------------------------
# token-level lifting
# ---------------------------------------------------------------------------


class TokenDFA:
    """Token-level automaton: trans (S, V+1) int32, -1 = disallowed.

    Column V (the last) is the EOS column: allowed exactly in
    accepting states (its target is the state itself; the engine
    finishes the request on EOS as usual). Built by BFS over the
    minimized byte DFA — each discovered state walks every token's
    bytes.
    """

    def __init__(self, trans: np.ndarray, eos_id: int):
        self.trans = trans
        self.eos_id = eos_id

    @property
    def n_states(self) -> int:
        return self.trans.shape[0]


def _token_bytes(tokenizer, vocab_size: int,
                 eos_id: int) -> List[Optional[bytes]]:
    """Each id's surface BYTES; None disables the token (specials,
    undecodable, and EOS itself — EOS is the dedicated last column).

    Tokenizers may expose `token_bytes(tid) -> bytes | None` for exact
    byte surfaces (byte-level vocabularies whose tokens split UTF-8
    characters NEED this — decode() replaces partial sequences with
    U+FFFD). The fallback decodes and re-encodes, disabling any token
    whose decode was lossy."""
    has_tb = hasattr(tokenizer, "token_bytes")
    out: List[Optional[bytes]] = []
    for tid in range(vocab_size):
        if tid == eos_id:
            out.append(None)
            continue
        if has_tb:
            try:
                out.append(tokenizer.token_bytes(tid) or None)
            except Exception:
                out.append(None)
            continue
        try:
            s = tokenizer.decode([tid])
        except Exception:
            out.append(None)
            continue
        if not s or "�" in s:
            # Lossy decode: the true bytes are unknowable here.
            out.append(None)
            continue
        out.append(s.encode("utf-8"))
    return out


def compile_token_dfa(pattern: str, tokenizer, vocab_size: int,
                      eos_id: int) -> TokenDFA:
    """pattern -> TokenDFA over this tokenizer's vocab.

    eos_id comes from the caller (the engine's configured EOS), not
    sniffed off the tokenizer — the two must agree or EOS masking
    would silently diverge from request termination.

    Cache externally on (pattern, id(tokenizer)) — the engine does.
    """
    btrans, baccept = _minimize(*_byte_dfa(CharDFA(pattern)))
    toks = _token_bytes(tokenizer, vocab_size, eos_id)

    max_states = min(MAX_DFA_STATES,
                     max(MAX_TABLE_ENTRIES // (vocab_size + 1), 1))

    n_b = btrans.shape[0]
    if vocab_size * n_b <= MAX_WALK_ENTRIES:
        # Fast path: precompute each token's byte-walk over ALL byte
        # states at once (vectorized over states; tokens loop
        # host-side once). walk[tid] maps byte-state -> byte-state
        # after the token (-1 dead).
        walk = np.full((vocab_size, n_b), -1, np.int32)
        ids = np.arange(n_b, dtype=np.int32)
        for tid, bs in enumerate(toks):
            if bs is None:
                continue
            cur = ids
            for b in bs:
                cur = np.where(
                    cur >= 0, btrans[np.clip(cur, 0, None), b], -1
                )
            walk[tid] = cur

        def targets_from(st: int) -> np.ndarray:
            return walk[:, st]
    else:
        # Budget path (huge vocab x many byte states would blow the
        # walk matrix): walk all tokens from ONE state at a time,
        # vectorized over tokens via a padded byte matrix. Only
        # DISCOVERED token states pay this cost.
        lmax = max((len(b) for b in toks if b is not None), default=1)
        tok_mat = np.full((vocab_size, lmax), -1, np.int16)
        for tid, bs in enumerate(toks):
            if bs is None:
                continue
            tok_mat[tid, :len(bs)] = np.frombuffer(bs, np.uint8)
        enabled = np.asarray([b is not None for b in toks], bool)

        def targets_from(st: int) -> np.ndarray:
            cur = np.where(enabled, st, -1).astype(np.int32)
            for j in range(lmax):
                bj = tok_mat[:, j]
                step = np.where(
                    cur >= 0,
                    btrans[np.clip(cur, 0, None), np.clip(bj, 0, None)],
                    -1,
                )
                cur = np.where(bj >= 0, step, cur)
            return cur

    states: Dict[int, int] = {0: 0}
    order: List[int] = [0]
    rows: List[np.ndarray] = []
    qi = 0
    while qi < len(order):
        st = order[qi]
        qi += 1
        tgt = targets_from(st)  # (V,) byte-state after each token
        row = np.full((vocab_size + 1,), -1, np.int32)
        for tid in np.nonzero(tgt >= 0)[0]:
            nxt = int(tgt[tid])
            if nxt not in states:
                if len(states) >= max_states:
                    raise ValueError(
                        f"constraint DFA exceeds {max_states} states "
                        f"(cap {MAX_DFA_STATES}, table budget "
                        f"{MAX_TABLE_ENTRIES} entries at vocab "
                        f"{vocab_size}); simplify the pattern"
                    )
                states[nxt] = len(order)
                order.append(nxt)
            row[tid] = states[nxt]
        if baccept[st]:
            row[vocab_size] = states[st]  # EOS allowed, self-loop
        rows.append(row)
    trans = np.stack(rows, axis=0)
    # A state from which nothing (not even EOS) is allowed would wedge
    # a slot; they are unreachable in well-formed patterns but guard
    # anyway.
    dead = ~(trans >= 0).any(axis=1)
    if dead.any():
        raise ValueError("constraint DFA contains dead states")
    return TokenDFA(trans, eos_id)


# ---------------------------------------------------------------------------
# JSON schema -> regex
# ---------------------------------------------------------------------------

# Compact strings, no escape sequences. Control bytes (0x00-0x1F) are
# excluded explicitly: they live inside the regex engine's negated-
# class universe, but JSON forbids them raw in strings — a constraint-
# conforming output must stay json.loads-able.
_CTRL = "".join(chr(c) for c in range(0x20))
_STR = '"[^"\\\\' + _CTRL + ']*"'
_INT = r"-?(0|[1-9][0-9]*)"
_NUM = _INT + r"(\.[0-9]+)?([eE][-+]?[0-9]+)?"
_BOOL = r"(true|false)"
_NULL = r"null"

# String `format`s lowered to regex fragments (the body between the
# quotes). These are the high-traffic tool-schema formats; unknown
# formats stay annotations (JSON-Schema's default vocabulary) and fall
# back to the free string grammar.
_TIME_BODY = (r"([01][0-9]|2[0-3]):[0-5][0-9]:[0-5][0-9](\.[0-9]+)?"
              r"(Z|[+\-]([01][0-9]|2[0-3]):[0-5][0-9])")
_DATE_BODY = r"[0-9]{4}-(0[1-9]|1[0-2])-(0[1-9]|[12][0-9]|3[01])"
_FORMAT_BODIES = {
    "date": _DATE_BODY,
    "date-time": _DATE_BODY + "T" + _TIME_BODY,
    "uuid": (r"[0-9a-fA-F]{8}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-"
             r"[0-9a-fA-F]{4}-[0-9a-fA-F]{12}"),
    "email": (r"[A-Za-z0-9._%+\-]+@[A-Za-z0-9.\-]+\.[A-Za-z]{2,}"),
}


def _resolve_ref(root: dict, ref: str) -> dict:
    """Resolve a LOCAL JSON-pointer reference ('#/$defs/name',
    '#/definitions/name', or any '#/...' path) against the root
    schema. Remote/URL refs are refused loudly — this compiler has no
    retrieval layer, and silently treating them as free strings would
    change the constrained language."""
    if not isinstance(ref, str) or not ref.startswith("#"):
        raise ValueError(
            f"$ref {ref!r}: only local '#/...' references are supported"
        )
    node: Any = root
    for part in ref[1:].split("/"):
        if not part:
            continue
        part = part.replace("~1", "/").replace("~0", "~")
        if isinstance(node, dict) and part in node:
            node = node[part]
        elif isinstance(node, list) and part.isdigit() \
                and int(part) < len(node):
            node = node[int(part)]
        else:
            raise ValueError(f"$ref {ref!r}: path not found in schema")
    if not isinstance(node, dict):
        raise ValueError(f"$ref {ref!r}: target is not a schema object")
    return node


def _schema_regex(schema: dict, depth: int = 3, root: Optional[dict] = None,
                  seen: Tuple[str, ...] = ()) -> str:
    # `root` anchors $ref resolution ('#/...' points at the top-level
    # schema); `seen` is the ref chain of THIS path, so a reference
    # cycle (A -> B -> A) fails loudly instead of recursing forever —
    # a regex cannot express a recursive grammar.
    if root is None:
        root = schema
    if "$ref" in schema:
        ref = schema["$ref"]
        if ref in seen:
            raise ValueError(
                f"cyclic $ref chain {' -> '.join(seen + (ref,))}: a "
                "recursive schema cannot be regex-bounded"
            )
        return _schema_regex(
            _resolve_ref(root, ref), depth, root, seen + (ref,)
        )
    t = schema.get("type")
    for alt_key in ("anyOf", "oneOf"):
        if alt_key in schema:
            # Alternation. oneOf's exclusivity is NOT enforced (a
            # regex cannot count matches); it behaves as anyOf, the
            # public structured-output norm.
            subs = schema[alt_key]
            if not isinstance(subs, list) or not subs:
                raise ValueError(f"{alt_key} must be a non-empty list")
            return ("(" + "|".join(
                _schema_regex(s, depth, root, seen) for s in subs
            ) + ")")
    if "const" in schema:
        return _escape_literal(
            json.dumps(schema["const"], ensure_ascii=False,
                       separators=(",", ":"))
        )
    if "enum" in schema:
        alts = []
        for v in schema["enum"]:
            # ensure_ascii=False keeps non-Latin enum values as their
            # UTF-8 selves — the byte-level DFA constrains them
            # exactly (ASCII \\uXXXX escapes would force the model to
            # emit escape sequences instead of the actual characters).
            alts.append(_escape_literal(
                json.dumps(v, ensure_ascii=False, separators=(",", ":"))
            ))
        return "(" + "|".join(alts) + ")"
    if t == "string":
        if "pattern" in schema:
            # Group the user pattern: a top-level '|' must stay scoped
            # to the string body, not split the whole grammar.
            return '"(' + schema["pattern"] + ')"'
        fmt = schema.get("format")
        if fmt in _FORMAT_BODIES:
            return '"' + _FORMAT_BODIES[fmt] + '"'
        return _STR
    if t == "integer":
        return _INT
    if t == "number":
        return _NUM
    if t == "boolean":
        return _BOOL
    if t == "null":
        return _NULL
    if t == "array":
        if depth <= 0:
            raise ValueError("schema nests deeper than supported")
        item = _schema_regex(schema.get("items", {}), depth - 1, root,
                             seen)
        return r"\[(" + item + r"(," + item + r")*)?\]"
    if t == "object" or "properties" in schema:
        if depth <= 0:
            raise ValueError("schema nests deeper than supported")
        ap = schema.get("additionalProperties", False)
        extra_pair: Optional[str] = None
        if ap is not False and ap is not None:
            # Open object: undeclared pairs append AFTER the declared
            # (fixed-order) sequence. additionalProperties: true values
            # use the depth-limited generic-JSON grammar; a schema
            # constrains them like any declared property. The regex
            # cannot forbid an extra pair from re-using a declared
            # name — json.loads keeps the LAST occurrence (documented
            # in docs/structured_output.md).
            val = (_generic_json_regex(depth - 1, kind="value")
                   if ap is True
                   else _schema_regex(ap, depth - 1, root, seen))
            extra_pair = _STR + ":" + val
        props = schema.get("properties", {})
        if not props:
            # Free-form object: depth-limited generic JSON (with an
            # additionalProperties SCHEMA, its grammar types the
            # values).
            if extra_pair is not None and ap is not True:
                return (r"\{(" + extra_pair
                        + "(," + extra_pair + r")*)?\}")
            return _generic_json_regex(depth - 1, kind="object")
        required = schema.get("required")
        if required is None:
            # Back-compat with the fixed-order v1 compiler AND the
            # OpenAI structured-output norm: no `required` list means
            # every declared property is required. An explicit list
            # makes the others optional (JSON-Schema semantics).
            required = list(props.keys())
        req = set(required)
        unknown = req - set(props)
        if unknown:
            raise ValueError(
                f"required names {sorted(unknown)} not in properties"
            )
        parts = []
        for name, sub in props.items():
            key = _escape_literal(
                json.dumps(name, ensure_ascii=False)
            )
            parts.append((key + ":"
                          + _schema_regex(sub, depth - 1, root, seen),
                          name in req))
        # Fixed property order (the public structured-output norm for
        # regex-compiled schemas), compact separators; optional
        # properties may be absent, commas only between present ones.
        nonempty, can_empty = _prop_core(parts)
        if extra_pair is not None:
            tail = "(," + extra_pair + ")*"
            declared = "(" + nonempty + ")" + tail
            alone = extra_pair + tail
            if can_empty:
                return r"\{(" + declared + "|" + alone + r")?\}"
            return r"\{" + declared + r"\}"
        return (r"\{(" + nonempty + r")?\}" if can_empty
                else r"\{" + nonempty + r"\}")
    if t is None and not schema:
        return _generic_json_regex(depth - 1, kind="value")
    raise ValueError(f"unsupported schema fragment: {schema!r}")


def _prop_core(parts: List[Tuple[str, bool]]) -> Tuple[str, bool]:
    """Regex for fixed-order, comma-separated properties where
    optional ones may be absent: returns (regex of the NON-EMPTY
    realizations, may-the-whole-sequence-be-empty).

    Built right-to-left: for each suffix of the property list, compose
    (a) the regex of its non-empty realizations and (b) whether it may
    be empty. A required property anchors its suffix non-empty; an
    optional one alternates 'present (with correctly-placed comma)'
    against the rest."""
    nonempty: Optional[str] = None
    can_empty = True
    for body, required in reversed(parts):
        if nonempty is None:
            core = body
        elif can_empty:
            core = body + "(," + nonempty + ")?"
        else:
            core = body + "," + nonempty
        if required:
            nonempty = core
            can_empty = False
        else:
            nonempty = ("(" + core + "|" + nonempty + ")"
                        if nonempty is not None else core)
            # can_empty unchanged: this property may be skipped.
    assert nonempty is not None
    return nonempty, can_empty


def _escape_literal(s: str) -> str:
    return "".join(
        "\\" + c if c in r"\.[]{}()*+?|^$" else c for c in s
    )


def _generic_json_regex(depth: int, kind: str = "value") -> str:
    """Depth-limited generic JSON value (regular approximation of the
    recursive grammar; depth levels of nesting)."""
    scalar = f"({_STR}|{_NUM}|{_BOOL}|{_NULL})"
    value = scalar
    for _ in range(max(depth, 0)):
        obj = r"\{(" + _STR + ":" + value + "(," + _STR + ":" + value + r")*)?\}"
        arr = r"\[(" + value + "(," + value + r")*)?\]"
        value = f"({scalar}|{obj}|{arr})"
    if kind == "object":
        return r"\{(" + _STR + ":" + value + "(," + _STR + ":" + value + r")*)?\}"
    return value


def constraint_pattern(spec: dict) -> str:
    """Normalize a user constraint spec into one regex pattern.

    spec: {"regex": ...} | {"json_schema": {...}} | {"json_object": true}
    (the native API shape; the OpenAI response_format translates onto
    this in the server).
    """
    if not isinstance(spec, dict):
        raise ValueError("constraint must be an object")
    keys = [k for k in ("regex", "json_schema", "json_object") if k in spec]
    if len(keys) != 1:
        raise ValueError(
            "constraint needs exactly one of regex/json_schema/json_object"
        )
    if keys[0] == "regex":
        if not isinstance(spec["regex"], str):
            raise ValueError("constraint.regex must be a string")
        return spec["regex"]
    if keys[0] == "json_schema":
        return _schema_regex(spec["json_schema"])
    return _generic_json_regex(2, kind="object")
