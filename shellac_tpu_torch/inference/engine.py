"""Autoregressive generation engine.

Prefill consumes the whole right-padded prompt batch in one cached
forward (flash attention within the chunk); decode is `steps - 1`
single-token steps (cached forward with flash-decode over the dense
cache, repetition penalty, sampling, the `seen` update, the logprob),
where the JAX package runs a jitted `lax.scan`. A step reads its input
token from a fixed tensor and writes the cache, the next token and its
logprob in place, so on the card the first step runs eagerly and every
later one replays its CUDA graph (`inference/graphs.py`, captured once
per `generate` call); on the CPU every step runs eagerly. The first
token comes from the prefill logits, so no trailing forward is wasted.
Same sampling contract as the JAX package's `Engine`: repetition
penalty over a `seen` mask of the prompt and every sampled token, and
the log-probability of each chosen token under the penalized
(untempered) logits. `kv_quant="int8"` keeps the cache in int8 with
per-token scales (JAX `engine.py:71-83`): the prefill attends its exact
chunk, and every decode reads the int8 cache through its int8 kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

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

    def _sample(self, generator, logits):
        return sample(generator, logits, temperature=self.temperature,
                      top_k=self.top_k, top_p=self.top_p, min_p=self.min_p)

    def _prefill_impl(self, tokens, prompt_len):
        """tokens: (B, S_pad) right-padded; prompt_len: (B,) real lengths.
        Returns (last real position's logits, cache, seen mask)."""
        b, s = tokens.shape
        cache = init_cache_for(self.cfg, b, self.max_len, self.device,
                               self.kv_quant)
        logits, cache = transformer.forward_with_cache(
            self.cfg, self.params, tokens, cache, new_tokens_len=prompt_len,
            fresh_cache=True, attn_impl=self.attn_impl,
        )
        rows = torch.arange(b, device=self.device)
        last = logits[rows, prompt_len.to(torch.int64) - 1]
        # Token-presence mask over the valid prompt: a logical-OR scatter,
        # so a token id repeated in the pad tail cannot clear a real hit.
        valid = torch.arange(s, device=self.device)[None, :] \
            < prompt_len[:, None]
        seen = torch.zeros((b, self.cfg.vocab_size), dtype=torch.int32,
                           device=self.device)
        seen.scatter_reduce_(1, tokens.to(torch.int64), valid.to(torch.int32),
                             reduce="amax")
        return last, cache, seen.bool()

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

    def _graph(self, fn, generator):
        """The runner of the decode step `fn`: a CUDA graph on the card."""
        return StepGraph(fn, self.device, generator)

    def _decode_impl(self, first_token_logits, cache, steps, generator, seen):
        b = first_token_logits.shape[0]
        dev = self.device
        rows = torch.arange(b, device=dev)
        toks = torch.empty((steps, b), dtype=torch.int64, device=dev)
        lps = torch.empty((steps, b), dtype=torch.float32, device=dev)
        cur, lp = self._choose(generator, first_token_logits, seen, rows)
        toks[0], lps[0] = cur, lp
        if steps > 1:
            # The write guard forward_with_cache keeps runs at capture
            # only, so the whole decode is checked here.
            if cache.max_length + steps - 1 > cache.max_len:
                raise ValueError(
                    f"cache write of {steps - 1} positions at length "
                    f"{cache.max_length} passes max_len={cache.max_len}"
                )
            at = torch.ones((1,), dtype=torch.int64, device=dev)

            def step():
                """One decode step over fixed tensors: the input token
                `cur`, the cache, `seen`; writes row `at` of toks/lps."""
                logits, grown = transformer.forward_with_cache(
                    self.cfg, self.params, cur[:, None], cache,
                    attn_impl=self.attn_impl,
                )
                cache.lengths.copy_(grown.lengths)
                cache.max_length = grown.max_length
                tok, lp = self._choose(generator, logits[:, 0], seen, rows)
                cur.copy_(tok)
                toks.index_copy_(0, at, tok[None])
                lps.index_copy_(0, at, lp[None])
                at.add_(1)

            run = self._graph(step, generator)
            for _ in range(steps - 1):
                run()
        return GenerationResult(
            tokens=toks.t().contiguous().to(torch.int32),
            logprobs=lps.t().contiguous(),
        )

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
        tokens = torch.as_tensor(prompt_tokens, device=self.device)
        b, s = tokens.shape
        if prompt_len is None:
            prompt_len = torch.full((b,), s, dtype=torch.int32)
        prompt_len = torch.as_tensor(prompt_len, device=self.device).to(
            torch.int32
        )
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        first_logits, cache, seen = self._prefill_impl(tokens, prompt_len)
        return self._decode_impl(first_logits, cache, max_new_tokens,
                                 generator, seen)
