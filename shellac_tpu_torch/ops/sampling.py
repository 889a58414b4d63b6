"""Token sampling: temperature, top-k, nucleus (top-p), min-p, greedy.

Ports `shellac_tpu/ops/sampling.py`, including the per-row batched
sampler (`filter_logits_batched` :86, `sample_batched` :131 with its
per-row seeds) that the batching engines use. All filtering happens in
fp32 logit space with masks. Random draws come from an explicit
`torch.Generator`, or for a seeded row from a counter-based hash
(`seeded_uniform`); neither can match JAX's threefry bits, so sampled
tokens agree with the JAX package in distribution, not token for token.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` over the last axis of an fp32 tensor: the k
    largest values, largest first, equal values in index order. Each
    value maps to an int32 that orders as the float does (negative floats
    flip their magnitude bits, so -0.0 maps to -1, just below +0.0's 0,
    as `jax.lax.top_k` ranks them), joined above its reversed index into
    one int64, so every key in a row is distinct and the integer top-k is
    exact. Returns (values, indices)."""
    n = x.shape[-1]
    bits = x.float().contiguous().view(torch.int32)
    key = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    rev = n - 1 - torch.arange(n, device=x.device)
    idx = torch.topk(key * (1 << 32) + rev, k, dim=-1).indices
    return x.gather(-1, idx), idx


def top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask all but the k largest logits per row (ties at the kth value
    are kept). k >= vocab is a no-op; k < 1 is rejected."""
    if k < 1:
        raise ValueError(f"top_k must be >= 1, got {k}")
    k = min(k, logits.shape[-1])
    kth = torch.sort(logits, dim=-1).values[..., -k][..., None]
    return torch.where(logits < kth, NEG_INF, logits)


def top_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest set with cumulative prob >= p."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # Keep entries whose *previous* cumulative mass is < p (always keeps
    # the top-1).
    keep_sorted = (cum - probs) < p
    kth = torch.where(keep_sorted, sorted_logits, torch.inf).amin(
        dim=-1, keepdim=True
    )
    return torch.where(logits < kth, NEG_INF, logits)


def min_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Keep tokens whose prob >= p * max prob (scale-adaptive cutoff)."""
    probs = torch.softmax(logits, dim=-1)
    cutoff = p * probs.amax(dim=-1, keepdim=True)
    return torch.where(probs < cutoff, NEG_INF, logits)


def repetition_penalty(
    logits: torch.Tensor,  # (..., V)
    seen: torch.Tensor,  # (..., V) bool — tokens already in the context
    penalty: float,
) -> torch.Tensor:
    """HF-convention penalty: seen tokens' logits /p if >0 else *p."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def sample(
    generator: Optional[torch.Generator],
    logits: torch.Tensor,  # (..., V)
    *,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    min_p: Optional[float] = None,
) -> torch.Tensor:
    """Sample token ids (int64). temperature == 0 means greedy."""
    logits = logits.float()
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k is not None:
        logits = top_k_mask(logits, top_k)
    if top_p is not None:
        logits = top_p_mask(logits, top_p)
    if min_p is not None:
        logits = min_p_mask(logits, min_p)
    probs = torch.softmax(logits, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    draws = torch.multinomial(flat, 1, generator=generator)
    return draws.reshape(probs.shape[:-1])


def filter_logits_batched(
    logits: torch.Tensor,  # (B, V)
    temperature: torch.Tensor,  # (B,) fp32; <= 0 rows temper at 1.0
    top_k: torch.Tensor,  # (B,) int; >= V disables
    top_p: torch.Tensor,  # (B,) fp32; 1.0 disables
    min_p: torch.Tensor,  # (B,) fp32; 0.0 disables
) -> torch.Tensor:
    """The tempered, top-k/top-p/min-p-masked fp32 logits the batched
    sampler draws from, with per-row settings. Same masks, in the same
    order, as `sample`'s scalar path; greedy rows (temperature <= 0) are
    tempered at 1.0 and filtered like any row."""
    x = logits.float()
    v = x.shape[-1]
    t = torch.where(temperature <= 0.0, 1.0, temperature)[:, None]
    x = x / t
    # top-k: per-row kth-largest threshold (ties at the boundary kept).
    k = top_k.to(torch.int64).clamp(1, v)
    asc = torch.sort(x, dim=-1).values
    kth = torch.gather(asc, 1, (v - k)[:, None])
    x = torch.where(x < kth, NEG_INF, x)
    # top-p on the top-k-filtered rows, as top_p_mask does.
    desc = torch.sort(x, dim=-1, descending=True).values
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p[:, None]
    kth_p = torch.where(keep, desc, torch.inf).amin(dim=-1, keepdim=True)
    x = torch.where(x < kth_p, NEG_INF, x)
    # min-p relative to each row's current max.
    probs_x = torch.softmax(x, dim=-1)
    cutoff = min_p[:, None] * probs_x.amax(dim=-1, keepdim=True)
    return torch.where(probs_x < cutoff, NEG_INF, x)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a 32-bit constant,
    in two 16-bit halves so no product leaves the int64 range."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (lowbias32) over int64 values in
    [0, 2**32): every output bit depends on every input bit."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def seeded_uniform(seed: torch.Tensor, gen_idx: torch.Tensor,
                   vocab: int) -> torch.Tensor:
    """(B, vocab) fp32 uniforms in (0, 1), a pure function of each row's
    (seed, gen_idx) and the vocabulary index: a counter-based hash in
    int64 tensor ops, so it runs inside a CUDA graph with no host sync
    and gives the same bits on the CPU and on the card. It stands in
    for the JAX package's fold_in(PRNGKey(seed), gen_idx) stream, whose
    threefry bits cannot be matched."""
    s = seed.to(torch.int64).clamp_min(0) & 0xFFFFFFFF
    g = gen_idx.to(torch.int64) & 0xFFFFFFFF
    row = _mix32(_mix32(s) ^ g)[:, None]
    col = _mix32(torch.arange(vocab, dtype=torch.int64,
                              device=seed.device) + 0x9E3779B9)[None, :]
    bits = _mix32(row ^ col) >> 8  # 24 bits: exact in fp32
    return (bits.to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def sample_batched(
    generator: Optional[torch.Generator],
    logits: torch.Tensor,  # (B, V)
    temperature: torch.Tensor,  # (B,) fp32; 0 = greedy
    top_k: torch.Tensor,  # (B,) int; >= V disables
    top_p: torch.Tensor,  # (B,) fp32; 1.0 disables
    min_p: torch.Tensor,  # (B,) fp32; 0.0 disables
    seed: Optional[torch.Tensor] = None,  # (B,) int; < 0 = unseeded
    gen_idx: Optional[torch.Tensor] = None,  # (B,) int; tokens generated
) -> torch.Tensor:
    """`sample` with per-row settings (int64 ids): greedy rows take the
    argmax of their unfiltered logits, the others draw from their
    filtered logits.

    The draw is Gumbel-max, argmax(x + G) with G = -log(-log(U)): the
    categorical distribution of softmax(x), and unlike torch.multinomial
    it never raises on a row that is all masked or not finite, which the
    engines' idle slots produce.

    seed/gen_idx (the reference's :131-170): a row with seed >= 0 draws
    its U from `seeded_uniform(seed, gen_idx)`, so its token depends only
    on (seed, gen_idx, its filtered logits), never on its slot, its
    neighbours or the generator. Rows with seed < 0 keep the generator's
    stream, which is drawn at full shape either way, so a seeded
    neighbour does not move an unseeded row.
    """
    logits = logits.float()
    x = filter_logits_batched(logits, temperature, top_k, top_p, min_p)
    u = torch.rand(x.shape, generator=generator, device=x.device)
    if seed is not None:
        u = torch.where(seed[:, None] >= 0,
                        seeded_uniform(seed, gen_idx, x.shape[-1]), u)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    sampled = torch.argmax(x + gumbel, dim=-1)
    return torch.where(temperature <= 0.0, torch.argmax(logits, dim=-1),
                       sampled)
