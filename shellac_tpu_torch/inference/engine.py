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
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from shellac_tpu_torch.config import ModelConfig
from shellac_tpu_torch.inference.cache.layout import init_cache_for
from shellac_tpu_torch.inference.graphs import StepGraph
from shellac_tpu_torch.models import transformer
from shellac_tpu_torch.ops.dispatch import DeviceLike, check_on, resolve_device
from shellac_tpu_torch.ops.sampling import repetition_penalty, sample


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
