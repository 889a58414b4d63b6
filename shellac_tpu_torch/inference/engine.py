"""Autoregressive generation engine.

Prefill consumes the whole right-padded prompt batch in one cached
forward (flash attention within the chunk); decode is `steps - 1`
single-token steps (cached forward with flash-decode over the dense
cache, repetition penalty, sampling, the `seen` update, the logprob),
where the JAX package runs a jitted `lax.scan`. The engine keeps, per
batch size, fixed buffers (the padded tokens of each prompt width, the
prompt lengths, the (B, max_len) cache, `seen`, the next token and the
output rows) and, over them, one prefill program per (batch, padded
length) and one decode-step program per batch: the counterpart of the
JAX `Engine`'s prefill and decode jitted once per shape (:94-118). On
the card each program's first run is eager and every later one replays
its CUDA graph (`inference/graphs.py`), on this call and every later call
of the same shape; on the CPU every program runs eagerly. A call resets
the lengths and `seen` in place (positions past a row's length are never
read). The programs draw from one engine-owned generator registered with
their graphs: the caller's generator state is carried into it at the
start of a call and back out at the end, so a seed gives the same tokens
on every call. The first token comes from the prefill logits, so no
trailing forward is wasted.
Same sampling contract as the JAX package's `Engine`: repetition
penalty over a `seen` mask of the prompt and every sampled token, and
the log-probability of each chosen token under the penalized
(untempered) logits. `kv_quant="int8"` keeps the cache in int8 with
per-token scales (JAX `engine.py:71-83`): the prefill attends its exact
chunk, and every decode reads the int8 cache through its int8 kernel.

Beam search (`Engine.beam_search`, JAX `engine.py:203-320`) decodes one
prompt with K beams: the prompt prefills once at B = 1 (kernel 2) into
row 0 of a (K, length) beam cache and is broadcast to the K rows; each
step is one cached forward at B = K (kernels 5 or 6), the flat top-k
over (K, V), the reorder of the cache rows and the EOS-freeze length
rollback. Per key (K, the cache length bucket of prompt + steps, EOS,
constrained) the engine keeps fixed buffers and a prefill program per
pad and one step program over them, each a `StepGraph` kept across calls
(the search state, the step index included, lives in device tensors
updated in place; the prefill's eager warm-up and capture both happen at
the key's first search, so a second search captures nothing); the keys
kept stay under BEAM_RESIDENT_BYTES of cache. The expansion math
(`beam_first_expand`, `beam_expand`, `beam_rank`, the DFA mask, JAX
:322-488) is shared with the paged engine's copy-on-write search, so the
two cannot drift apart. `torch.topk` promises no order among equal
values and `jax.lax.top_k` takes the lower index first, so the top-k
here ranks an order-preserving integer key of each score joined with its
index (`ops/sampling.py` `top_k`).
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from shellac_tpu_torch.config import ModelConfig
from shellac_tpu_torch.inference.cache.layout import (
    cache_quant,
    init_cache_for,
    kv_field_names,
)
from shellac_tpu_torch.inference.graphs import (
    HostPull,
    StepGraph,
    call_captured,
)
from shellac_tpu_torch.models import transformer
from shellac_tpu_torch.ops.dispatch import (
    DeviceLike,
    check_on,
    copy_from_host,
    resolve_device,
)
from shellac_tpu_torch.ops.sampling import repetition_penalty, sample, top_k


@dataclass
class GenerationResult:
    tokens: torch.Tensor  # (B, max_new_tokens) int32
    logprobs: torch.Tensor  # (B, max_new_tokens) fp32 — of each sampled token


@dataclass
class _Batch:
    """One batch size's fixed buffers and the programs over them."""

    cache: object  # (B, max_len) KVCache or QuantKVCache
    seen: torch.Tensor  # (B, V) bool
    plen: torch.Tensor  # (B,) int32 prompt lengths
    cur: torch.Tensor  # (B,) int64 next input token
    toks: torch.Tensor  # (max_len, B) int64 output rows
    lps: torch.Tensor  # (max_len, B) fp32
    at: torch.Tensor  # (1,) int64 the output row a step writes
    tokens: Dict[int, torch.Tensor] = field(default_factory=dict)  # pad ->
    prefills: Dict[int, object] = field(default_factory=dict)  # pad ->
    step: object = None


@dataclass
class _Beam:
    """One beam-search key's fixed buffers and the programs over them:
    the search state the step program updates in place."""

    cache: object  # (K, length) KVCache or QuantKVCache
    cur: torch.Tensor  # (K,) int64 each beam's next input token
    scores: torch.Tensor  # (K,) fp32 summed logprobs
    finished: torch.Tensor  # (K,) bool
    out: torch.Tensor  # (K, length) int64 generated tokens
    lens: torch.Tensor  # (K,) int32 generated lengths
    cstate: torch.Tensor  # (K,) int64 DFA states
    at: torch.Tensor  # (1,) int64 the step index (out column written)
    plen: torch.Tensor  # (1,) int64 the prompt length
    zero: torch.Tensor  # (1,) int32 the prefill view's lengths
    ctrans: Optional[torch.Tensor]  # (rows, V + 1) int32 DFA table
    nbytes: int  # the cache's bytes
    dfa: object = None  # the TokenDFA whose rows ctrans holds
    tokens: Dict[int, torch.Tensor] = field(default_factory=dict)  # pad ->
    prefills: Dict[int, object] = field(default_factory=dict)  # pad ->
    step: object = None


#: Beam caches kept across calls, in bytes: the least recently used keys
#: are dropped past it (a key larger than it alone is dropped after its
#: call).
BEAM_RESIDENT_BYTES = 1 << 30


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class Engine:
    """Generation over one model on one device (the card by default)."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        max_len: Optional[int] = None,
        temperature: float = 1.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        min_p: Optional[float] = None,
        repetition_penalty: float = 1.0,
        attn_impl: str = "auto",
        device: DeviceLike = None,
        mesh=None,
        kv_quant: Optional[str] = None,
        rolling_window: bool = False,
    ):
        if mesh is not None:
            raise NotImplementedError("meshes are not ported yet")
        if kv_quant not in (None, "int8"):
            raise ValueError(f"kv_quant={kv_quant!r}; have None, 'int8'")
        if rolling_window:
            raise NotImplementedError("rolling caches are not ported yet")
        transformer.check_supported(cfg)
        self.device = resolve_device(device)
        check_on(self.device, embed=params["embed"])
        self.cfg = cfg
        self.params = params
        self.kv_quant = kv_quant
        self.max_len = max_len or cfg.max_seq_len
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.min_p = min_p
        self.repetition_penalty = repetition_penalty
        self.attn_impl = attn_impl
        # Per batch size, fixed buffers and the programs over them; the
        # generator their graphs draw from.
        self._batches: Dict[int, _Batch] = {}
        self._gen = torch.Generator(device=self.device)
        # Beam-search keys (K, cache length, eos_id, constrained), least
        # recently used first.
        self._beams: "OrderedDict[tuple, _Beam]" = OrderedDict()

    def _sample(self, generator, logits):
        return sample(generator, logits, temperature=self.temperature,
                      top_k=self.top_k, top_p=self.top_p, min_p=self.min_p)

    def _batch(self, b: int) -> _Batch:
        """The fixed buffers of batch size `b`, built at its first call."""
        st = self._batches.get(b)
        if st is None:
            dev, v = self.device, self.cfg.vocab_size
            st = self._batches[b] = _Batch(
                cache=init_cache_for(self.cfg, b, self.max_len, dev,
                                     self.kv_quant),
                seen=torch.zeros((b, v), dtype=torch.bool, device=dev),
                plen=torch.zeros((b,), dtype=torch.int32, device=dev),
                cur=torch.zeros((b,), dtype=torch.int64, device=dev),
                toks=torch.zeros((self.max_len, b), dtype=torch.int64,
                                 device=dev),
                lps=torch.zeros((self.max_len, b), dtype=torch.float32,
                                device=dev),
                at=torch.zeros((1,), dtype=torch.int64, device=dev))
        return st

    def _stage(self, tokens, prompt_len):
        """Copy a call's prompts and lengths into its batch's buffers;
        returns (the batch, the padded width, the longest prompt)."""
        tokens = torch.as_tensor(tokens)
        b, s = tokens.shape
        st = self._batch(b)
        buf = st.tokens.get(s)
        if buf is None:
            buf = st.tokens[s] = torch.zeros((b, s), dtype=torch.int64,
                                             device=self.device)
        buf.copy_(tokens)
        st.plen.copy_(torch.as_tensor(prompt_len))
        top = int(torch.as_tensor(prompt_len).max())
        return st, s, top

    def _prefill_forward(self, st: _Batch, pad: int):
        """The padded prompts through a fresh forward into the batch's
        cache, its lengths set to the prompts' and `seen` rebuilt, in
        place. Returns the last real position's logits (B, V)."""
        tokens, plen, cache = st.tokens[pad], st.plen, st.cache
        b = tokens.shape[0]
        cache.lengths.zero_()
        logits, _ = transformer.forward_with_cache(
            self.cfg, self.params, tokens, cache.replace(max_length=0),
            fresh_cache=True, attn_impl=self.attn_impl,
        )
        cache.lengths.copy_(plen)
        rows = torch.arange(b, device=self.device)
        last = logits[rows, plen.to(torch.int64) - 1]
        # Token-presence mask over the valid prompt: a logical-OR scatter,
        # so a token id repeated in the pad tail cannot clear a real hit.
        valid = torch.arange(pad, device=self.device)[None, :] \
            < plen[:, None]
        seen = torch.zeros((b, self.cfg.vocab_size), dtype=torch.int32,
                           device=self.device)
        seen.scatter_reduce_(1, tokens, valid.to(torch.int32), reduce="amax")
        st.seen.copy_(seen.bool())
        return last

    def _prefill_impl(self, tokens, prompt_len):
        """Prefill (eagerly) into the batch's buffers: tokens (B, S_pad)
        right-padded, prompt_len (B,) real lengths. Returns (the last
        real position's logits, the cache, the seen mask)."""
        st, pad, top = self._stage(tokens, prompt_len)
        last = self._prefill_forward(st, pad)
        st.cache.max_length = top
        return last, st.cache, st.seen

    def _choose(self, generator, logits, seen, rows):
        logits = repetition_penalty(logits, seen, self.repetition_penalty)
        tok = self._sample(generator, logits)
        # The True is a device tensor: a host scalar would be copied in,
        # which a CUDA graph capture refuses.
        seen.index_put_((rows, tok), seen.new_ones(()))
        lp = torch.log_softmax(logits.float(), dim=-1).gather(
            1, tok[:, None]
        )[:, 0]
        return tok, lp

    def _first(self, st: _Batch, logits) -> None:
        """The first token from the prefill logits, into output row 0."""
        rows = torch.arange(st.cur.shape[0], device=self.device)
        tok, lp = self._choose(self._gen, logits, st.seen, rows)
        st.cur.copy_(tok)
        st.toks[0].copy_(tok)
        st.lps[0].copy_(lp)
        st.at.fill_(1)

    def _prefill_program(self, st: _Batch, pad: int) -> None:
        """One (batch, pad) prefill and its first token, over the
        batch's fixed buffers only."""
        self._first(st, self._prefill_forward(st, pad))

    def _step_program(self, st: _Batch) -> None:
        """One decode step over the batch's fixed buffers: the input
        token `cur`, the cache, `seen`; writes output row `at`."""
        cache = st.cache
        rows = torch.arange(st.cur.shape[0], device=self.device)
        logits, grown = transformer.forward_with_cache(
            self.cfg, self.params, st.cur[:, None], cache,
            attn_impl=self.attn_impl,
        )
        cache.lengths.copy_(grown.lengths)
        cache.max_length = grown.max_length
        tok, lp = self._choose(self._gen, logits[:, 0], st.seen, rows)
        st.cur.copy_(tok)
        st.toks.index_copy_(0, st.at, tok[None])
        st.lps.index_copy_(0, st.at, lp[None])
        st.at.add_(1)

    def _graph(self, fn, generator, pool=None):
        """The runner of a program `fn`: a CUDA graph on the card."""
        return StepGraph(fn, self.device, generator, pool)

    def _seed_from(self, generator: Optional[torch.Generator]) -> None:
        """Carry the caller's generator state into the engine's."""
        if generator is None:
            self._gen.manual_seed(0)
        else:
            self._gen.set_state(generator.get_state())

    def _check_room(self, top: int, steps: int) -> None:
        """The write guard forward_with_cache keeps runs at capture only,
        so a call's whole decode is checked here, before it writes."""
        if top + steps - 1 > self.max_len:
            raise ValueError(
                f"cache write of {steps - 1} positions at length {top} "
                f"passes max_len={self.max_len}"
            )

    def _decode_loop(self, st: _Batch, steps: int,
                     generator: Optional[torch.Generator]):
        """steps - 1 decode steps through the batch's step program; the
        results, and the engine's generator state carried back into the
        caller's."""
        if steps > 1:
            if st.step is None:
                st.step = self._graph(
                    functools.partial(self._step_program, st), self._gen)
            for _ in range(steps - 1):
                st.step()
        if generator is not None:
            generator.set_state(self._gen.get_state())
        return GenerationResult(
            tokens=st.toks[:steps].t().contiguous().to(torch.int32),
            logprobs=st.lps[:steps].t().contiguous(),
        )

    def _decode_impl(self, first_token_logits, cache, steps, generator, seen):
        """The decode from a `_prefill_impl`'s outputs (its cache and
        seen are its batch's): the first token, then the step program."""
        st = self._batches.get(first_token_logits.shape[0])
        if st is None or cache is not st.cache or seen is not st.seen:
            raise ValueError("_decode_impl takes this engine's "
                             "_prefill_impl outputs")
        self._check_room(cache.max_length, steps)
        self._seed_from(generator)
        self._first(st, first_token_logits)
        return self._decode_loop(st, steps, generator)

    @torch.inference_mode()
    def generate(
        self,
        prompt_tokens,  # (B, S) int, right-padded
        prompt_len=None,  # (B,) int
        *,
        max_new_tokens: int = 32,
        generator: Optional[torch.Generator] = None,
    ) -> GenerationResult:
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        tokens = torch.as_tensor(prompt_tokens)
        b, s = tokens.shape
        if prompt_len is None:
            prompt_len = torch.full((b,), s, dtype=torch.int32)
        st, pad, top = self._stage(tokens, prompt_len)
        self._check_room(top, max_new_tokens)
        self._seed_from(generator)
        prefill = st.prefills.get(pad)
        if prefill is None:
            prefill = st.prefills[pad] = self._graph(
                functools.partial(self._prefill_program, st, pad), self._gen)
        prefill()
        st.cache.max_length = top
        return self._decode_loop(st, max_new_tokens, generator)

    # ---- beam search (JAX engine.py:203-320) ------------------------

    @staticmethod
    def _reorder_cache(cache, idx) -> None:
        """Gather the cache rows (values, scales and lengths) by beam
        index, in place: each field is gathered into a temporary first,
        so a row that another row adopts is read before it is
        overwritten. The gather moves 8-byte words (a bf16 or int8 row
        viewed as int64), which index_select copies several times faster
        than 1- or 2-byte elements. An MLA cache's zero-width v has no
        words to move."""
        for name in kv_field_names(cache_quant(cache)):
            t = getattr(cache, name)
            if t.numel() == 0:
                continue
            if t.shape[-1] * t.element_size() % 8 == 0:
                t = t.view(torch.int64)
            t.copy_(t.index_select(1, idx))
        cache.lengths.copy_(cache.lengths.index_select(0, idx))

    def _beam_state(self, k: int, length: int, eos_id: Optional[int],
                    dfa) -> _Beam:
        """The key's buffers, built at its first call; the DFA's rows
        uploaded when another table than the resident one is asked for
        (a table larger than the key's buffer rebuilds the key)."""
        key = (k, length, eos_id, dfa is not None)
        st = self._beams.get(key)
        if st is not None and dfa is not None \
                and st.ctrans.shape[0] < dfa.n_states:
            del self._beams[key]
            st = None
        if st is None:
            dev = self.device
            cache = init_cache_for(self.cfg, k, length, dev, self.kv_quant)

            def zeros(*shape, dtype):
                return torch.zeros(shape, dtype=dtype, device=dev)

            st = self._beams[key] = _Beam(
                cache=cache, cur=zeros(k, dtype=torch.int64),
                scores=zeros(k, dtype=torch.float32),
                finished=zeros(k, dtype=torch.bool),
                out=zeros(k, length, dtype=torch.int64),
                lens=zeros(k, dtype=torch.int32),
                cstate=zeros(k, dtype=torch.int64),
                at=zeros(1, dtype=torch.int64),
                plen=zeros(1, dtype=torch.int64),
                zero=zeros(1, dtype=torch.int32),
                ctrans=_dfa_table(dfa, self.cfg.vocab_size, dev),
                nbytes=sum(getattr(cache, n).nbytes for n in
                           kv_field_names(self.kv_quant)))
        self._beams.move_to_end(key)
        _upload_dfa(st, dfa)
        return st

    def _trim_beams(self) -> None:
        """Drop the least recently used beam keys past
        BEAM_RESIDENT_BYTES (their buffers and graphs)."""
        total = sum(b.nbytes for b in self._beams.values())
        while self._beams and total > BEAM_RESIDENT_BYTES:
            total -= self._beams.popitem(last=False)[1].nbytes

    def _beam_prefill_program(self, st: _Beam, pad: int,
                              eos_id: Optional[int]) -> None:
        """The padded prompt into cache row 0 (kernel 2), broadcast to
        every beam, and the first expansion from its last real
        position's logits (JAX :281-300): every beam holds the same
        prompt, so the K-way cache is one prefill, not K."""
        cache, k = st.cache, st.cur.shape[0]
        names = kv_field_names(self.kv_quant)
        row0 = cache.replace(**{n: getattr(cache, n)[:, :1] for n in names},
                             lengths=st.zero, max_length=0)
        logits, _ = transformer.forward_with_cache(
            self.cfg, self.params, st.tokens[pad], row0, fresh_cache=True,
            attn_impl=self.attn_impl,
        )
        for n in names:
            t = getattr(cache, n)[:, :, :, :pad]
            t[:, 1:].copy_(t[:, :1])
        cache.lengths.copy_(st.plen.to(torch.int32).expand(k))
        last = logits[0].index_select(0, st.plen - 1)[0]
        # beam0 is 0 for every beam (only beam 0's candidates are real),
        # and the rows are equal: the reference's reorder is a no-op.
        scores, _, tok, cstate = beam_first_expand(last, k, st.ctrans,
                                                   eos_id)
        st.scores.copy_(scores)
        st.cur.copy_(tok)
        if eos_id is not None:
            torch.eq(tok, eos_id, out=st.finished)
        else:
            st.finished.zero_()
        st.out.zero_()
        st.out[:, 0].copy_(tok)
        st.lens.fill_(1)
        st.cstate.copy_(cstate)
        st.at.fill_(1)

    def _beam_step_program(self, st: _Beam, eos_id: Optional[int]) -> None:
        """One beam step over the key's buffers (JAX `_beam_impl`'s scan
        body :244-263): the cached forward at B = K, the expansion, the
        row reorder, and a frozen beam's length rolled back (its EOS
        refeed wrote a row past it)."""
        cache = st.cache
        logits, grown = transformer.forward_with_cache(
            self.cfg, self.params, st.cur[:, None], cache,
            attn_impl=self.attn_impl,
        )
        (scores, beam, tok, out, lens, finished, was_done,
         cstate) = beam_expand(logits[:, 0], st.scores, st.finished, st.out,
                               st.lens, st.at, eos_id, st.ctrans, st.cstate)
        lengths = grown.lengths.index_select(0, beam)
        self._reorder_cache(cache, beam)
        cache.lengths.copy_(torch.where(was_done, lengths - 1, lengths))
        st.cur.copy_(tok)
        st.scores.copy_(scores)
        st.finished.copy_(finished)
        st.out.copy_(out)
        st.lens.copy_(lens)
        st.cstate.copy_(cstate)
        st.at.add_(1)

    @torch.inference_mode()
    def beam_search(
        self,
        prompt_tokens,  # (S,) or (1, S) int
        *,
        num_beams: int = 4,
        max_new_tokens: int = 32,
        eos_id: Optional[int] = None,
        length_penalty: float = 1.0,
        constraint=None,
    ):
        """Deterministic beam decode of ONE prompt.

        Returns (sequences, scores): up to num_beams token lists (EOS
        included when hit, best first) and their length-penalized
        log-probabilities (scores / len**length_penalty). With a
        compiled `constraint` (constraints.TokenDFA), every beam's
        candidates are masked through its own DFA state before scoring,
        and beams forced onto masked candidates are pruned, so fewer
        than num_beams may return. For block pools,
        PagedBatchingEngine.beam_search reorders through copy-on-write
        tables instead of cache rows.
        """
        if num_beams < 1:
            raise ValueError("num_beams must be >= 1")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        dfa, eos_id = check_beam_constraint(constraint, eos_id,
                                            self.cfg.vocab_size)
        toks = np.asarray(prompt_tokens, np.int64).reshape(-1)
        s, steps, k = int(toks.size), int(max_new_tokens), int(num_beams)
        if s + steps + 1 > self.max_len:
            raise ValueError(
                f"prompt {s} + max_new {steps} exceeds max_len {self.max_len}"
            )
        # Positions past the prompt's pad and s + steps - 1 are never
        # written nor read: the beam cache's length is their bucket.
        length = min(_bucket(s + steps), self.max_len)
        pad = min(_bucket(s), length)
        st = self._beam_state(k, length, eos_id, dfa)
        buf = st.tokens.get(pad)
        if buf is None:
            buf = st.tokens[pad] = torch.zeros((1, pad), dtype=torch.int64,
                                               device=self.device)
        padded = np.zeros((1, pad), np.int64)
        padded[0, :s] = toks
        copy_from_host(buf, padded)
        copy_from_host(st.plen, [s])
        # The write guard forward_with_cache keeps runs at capture only;
        # the whole search was checked to fit above.
        st.cache.max_length = s
        prefill = st.prefills.get(pad)
        if prefill is None:
            prefill = st.prefills[pad] = self._graph(functools.partial(
                self._beam_prefill_program, st, pad, eos_id), None)
        # Captured at the key's first search, so a second one captures
        # nothing (the step is captured at its second call).
        call_captured(prefill)
        if steps > 1:
            if st.step is None:
                st.step = self._graph(functools.partial(
                    self._beam_step_program, st, eos_id), None)
            for _ in range(steps - 1):
                st.step()
        out, norm, lens = beam_rank(st.scores, st.out[:, :steps], st.lens,
                                    length_penalty)
        got = _pull_beams(out, norm, lens)
        self._trim_beams()
        return beam_filter_invalid(*got)


# ---- beam search: the shared math (JAX engine.py:322-488) -------------

#: Junk-beam score: a beam forced onto a constraint-masked candidate
#: (fewer legal continuations than beams) carries this; the host-side
#: BEAM_INVALID filter drops it from the returned set.
BEAM_NEG = -1e30
BEAM_INVALID = -1e20  # host-side validity threshold on final scores


def _beam_mask(lp, row, eos_id):
    """Mask a (K, V) logprob block by each beam's DFA row ((K, V+1);
    -1 = disallowed, last column = EOS legality). Disallowed entries
    drop to BEAM_NEG, so the flat top-k picks them only when fewer than
    K legal candidates exist; those beams rank (and are pruned) as
    invalid."""
    allowed = row[:, :-1] >= 0
    if eos_id is not None:
        allowed[:, eos_id] = row[:, -1] >= 0
    return torch.where(allowed, lp, BEAM_NEG)


def _beam_advance_state(row, cstate, tok, keep, eos_id):
    """Advance each beam's DFA state past its selected token (`row`: the
    pre-selection (K, V+1) table rows, gathered by beam). `keep` marks
    beams whose state must not move (frozen EOS self-loops). Clipped at
    0, so an invalid (masked-candidate) beam stays traversable; its
    BEAM_NEG score already prunes it."""
    col = tok
    if eos_id is not None:
        col = torch.where(tok == eos_id, row.shape[1] - 1, tok)
    nxt = row.gather(1, col[:, None])[:, 0].to(cstate.dtype)
    return torch.where(keep, cstate, nxt.clamp(min=0))


def beam_first_expand(last_logits, k, ctrans=None, eos_id=None):
    """First beam expansion from ONE distribution (every beam holds the
    same prefill): masking all but beam 0 keeps the flat top-k from
    picking duplicate (beam, token) pairs. last_logits: (V,). With a
    constraint table `ctrans`, the DFA's start row masks the
    distribution and the returned states advance past each selected
    token. Returns (scores, beam0, tok0, cstate0), each (k,)."""
    lp0 = torch.log_softmax(last_logits.float(), dim=-1)
    v, dev = lp0.shape[0], lp0.device
    if ctrans is not None:
        lp0 = _beam_mask(lp0[None], ctrans[:1], eos_id)[0]
    scores0 = torch.where(torch.arange(k, device=dev) == 0, 0.0, BEAM_NEG)
    cand = (scores0[:, None] + lp0[None, :]).reshape(-1)
    scores, flat = top_k(cand, k)
    tok0 = flat % v
    cstate0 = torch.zeros((k,), dtype=torch.int64, device=dev)
    if ctrans is not None:
        row = ctrans[:1].expand(k, -1)
        cstate0 = _beam_advance_state(
            row, cstate0, tok0, torch.zeros((k,), dtype=torch.bool,
                                            device=dev), eos_id)
    return scores, flat // v, tok0, cstate0


def beam_expand(logits, scores, finished, out, lens, i, eos_id,
                ctrans=None, cstate=None):
    """One beam-search expansion: frozen-EOS self-loop, flat top-k over
    (K, V) candidates, and the out/lens/finished bookkeeping, shared by
    the dense loop (Engine._beam_step_program) and the paged
    copy-on-write loop (PagedBatchingEngine._beam_paged_impl) so their
    beams cannot drift. `i`: the (1,) int64 out column to write. With
    (ctrans, cstate), each live beam's logprobs are masked by its own
    DFA row before scoring and the returned states advance with the
    beam reorder (frozen beams keep the EOS self-loop regardless: they
    terminated in an accepting state). Returns (scores, beam, tok, out,
    lens, finished, was_done, cstate), new tensors; the caller owns the
    cache reorder and length rollback."""
    k = scores.shape[0]
    v = logits.shape[-1]
    lp = torch.log_softmax(logits.float(), dim=-1)
    row = None
    if ctrans is not None:
        row = ctrans.index_select(0, cstate)  # (K, V+1)
        lp = _beam_mask(lp, row, eos_id)
    if eos_id is not None:
        # Finished beams persist unchanged: their only continuation is
        # a zero-cost EOS self-loop (it wins over the constraint mask).
        frozen = torch.full((v,), BEAM_NEG, dtype=torch.float32,
                            device=lp.device)
        frozen[eos_id:eos_id + 1].fill_(0.0)
        lp = torch.where(finished[:, None], frozen[None], lp)
    cand = (scores[:, None] + lp).reshape(-1)
    scores, flat = top_k(cand, k)
    beam = flat // v
    tok = flat % v
    out = out.index_select(0, beam)
    out.index_copy_(1, i, tok[:, None].to(out.dtype))
    was_done = finished[beam]
    lens = torch.where(was_done, lens[beam], lens[beam] + 1)
    finished = was_done | (tok == eos_id) if eos_id is not None else was_done
    if ctrans is not None:
        cstate = _beam_advance_state(row[beam], cstate[beam], tok, was_done,
                                     eos_id)
    elif cstate is not None:
        cstate = cstate[beam]
    return scores, beam, tok, out, lens, finished, was_done, cstate


def beam_rank(scores, out, lens, length_penalty):
    """Length-penalized final ranking (HF/GNMT convention: divide by
    len**alpha; alpha 0 is the raw sum of logprobs, 1 the mean), a
    stable sort as `jnp.argsort`'s."""
    norm = scores / torch.pow(lens.float(), float(length_penalty))
    order = torch.sort(-norm, stable=True).indices
    return out[order], norm[order], lens[order]


def _dfa_table(dfa, vocab_size: int, device):
    """A beam key's DFA table: (a power of two >= 64 of rows, V + 1)
    int32, all -1, or None for an unconstrained key."""
    if dfa is None:
        return None
    return torch.full((_bucket(dfa.n_states, 64), vocab_size + 1), -1,
                      dtype=torch.int32, device=device)


def _upload_dfa(st, dfa) -> None:
    """Copy a TokenDFA's rows into the key's table `st.ctrans`, unless
    they are the resident ones (`st.dfa`)."""
    if dfa is not None and st.dfa is not dfa:
        copy_from_host(st.ctrans[:dfa.n_states], dfa.trans)
        st.dfa = dfa


def _pull_beams(out, norm, lens):
    """The ranked beams on the host: (out int64 (K, steps), norm fp32
    (K,), lens int (K,)) through one pinned copy (`HostPull`)."""
    k = out.shape[0]
    host = HostPull(torch.cat([out.double().reshape(-1), norm.double(),
                               lens.double()])).get()
    n = out.numel()
    return (host[:n].reshape(k, -1).astype(np.int64),
            host[n:n + k].astype(np.float32), host[n + k:].astype(np.int64))


def check_beam_constraint(constraint, eos_id, vocab_size):
    """Validate a beam-search constraint and resolve the EOS id the
    search must use. Returns (the TokenDFA or None, eos_id): the
    submit-time contract of the batching engines. Termination (EOS
    finishing a beam) and the DFA's EOS column must agree, or the mask
    would silently diverge from the search."""
    if constraint is None:
        return None, eos_id
    from shellac_tpu_torch.inference.constraints import TokenDFA

    if not isinstance(constraint, TokenDFA):
        raise ValueError(
            "beam constraint must be a compiled constraints.TokenDFA "
            "(the server compiles specs; library users call "
            "compile_token_dfa)"
        )
    if constraint.trans.shape[1] != vocab_size + 1:
        raise ValueError(
            f"beam constraint table covers "
            f"{constraint.trans.shape[1] - 1} tokens, model vocab is "
            f"{vocab_size}"
        )
    if eos_id is None:
        eos_id = constraint.eos_id
    elif eos_id != constraint.eos_id:
        raise ValueError(
            f"beam constraint eos_id {constraint.eos_id} must equal "
            f"the requested eos_id {eos_id} (termination and EOS "
            "masking must agree)"
        )
    if not 0 <= eos_id < vocab_size:
        raise ValueError(
            f"constraint eos_id {eos_id} is outside the model vocab "
            f"({vocab_size}); the model cannot emit it"
        )
    return constraint, eos_id


def beam_filter_invalid(out, norm, lens):
    """Host-side post-pass shared by the dense and paged searches: drop
    beams whose score shows they were forced onto a masked candidate (a
    constrained search with fewer legal continuations than beams). The
    best beam always survives: the compiled DFA has no dead states, so
    a legal path exists whenever the grammar is non-empty."""
    seqs, scores = [], []
    for row, n, s in zip(out, lens, norm):
        if float(s) <= BEAM_INVALID:
            continue
        seqs.append(row[:n].tolist())
        scores.append(float(s))
    return seqs, scores
