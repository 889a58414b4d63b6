"""The port's prefix cache against the JAX package's, on the CPU.

The cases of `tests/test_prefix_cache.py` on `PagedBatchingEngine(
prefix_cache=True)` of both packages, over `paged` and `paged-int8`: the
same numpy-seeded weights (tiny preset, fp32, through `params_from_jax`)
and prompts go through both engines. Tokens and logprobs are compared
while the JAX engine's own top-2 logprob margin is at least twice the
logit tolerance of 1e-4 (`tests/test_torch_batching.py`'s rule; a hit's
suffix attends the cached prefix through the plain paged attention, the
fresh prefill through the flash attention, so they differ by summation
order only). The `prefix_*` stats, the LRU order of the cached blocks,
the refcounts and the free list must be equal outright: the hashing
(`chain_hashes`, byte-equal to the reference's) and the allocator are
host code. Also: a prefix hit lowers the simulated prefill cost
(`SimulatedHostLatency(prefill_token_s=)`) by the matched tokens.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shellac_tpu.inference import batching as jbatching
from shellac_tpu.inference import prefix as jprefix
from shellac_tpu.models.registry import get_model_config as jget
from shellac_tpu_torch.inference import batching, prefix
from shellac_tpu_torch.inference.autotune import SimulatedHostLatency
from shellac_tpu_torch.inference.cache import PagedBackend
from shellac_tpu_torch.models.from_jax import params_from_jax
from shellac_tpu_torch.models.registry import get_model_config

import jax_params

CPU = "cpu"
MARGIN = 2 * 1e-4
BACKENDS = ["paged", "paged-int8"]
PREFIX_KEYS = ("prefix_hit_tokens", "prefix_query_tokens",
               "prefix_evictions", "prefix_seeded_blocks")


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


@pytest.fixture(scope="module")
def pair():
    jc = jget("tiny").replace(dtype="float32")
    tc = get_model_config("tiny").replace(dtype="float32")
    p = jax_params.init_params(jc)
    return jc, tc, jax.tree.map(jnp.asarray, p), params_from_jax(tc, p, CPU)


_ENGINES = {}


def _engines(pair, backend, **kw):
    """(JAX engine, port engine) with the prefix cache, built once per
    configuration (the JAX engine keeps its compiled programs) and reset
    to a pristine allocator and registry for each test."""
    key = (backend, tuple(sorted(kw.items())))
    if key not in _ENGINES:
        jc, tc, jp, tp = pair
        kw = dict(kw, cache_backend=backend, prefix_cache=True,
                  logprobs=True, top_logprobs=2, temperature=0.0)
        kw.setdefault("n_slots", 4)
        kw.setdefault("max_len", 128)
        kw.setdefault("block_size", 32 if backend == "paged-int8" else 8)
        _ENGINES[key] = (jbatching.PagedBatchingEngine(jc, jp, **kw),
                         batching.PagedBatchingEngine(tc, tp, device=CPU,
                                                      **kw))
    engines = _ENGINES[key]
    for eng in engines:
        eng.abort_all()
        for k in PREFIX_KEYS:
            eng.stats[k] = 0
    return engines


def _run_both(jeng, teng, reqs):
    """Run the requests through both engines; their tokens and logprobs
    agree while the margin allows, and their prefix stats are equal."""
    want, got = jeng.run(reqs), teng.run(reqs)
    compared = total = 0
    for rid, w in want.items():
        margins = [lps[0] - lps[1]
                   for _, lps in jeng.finished_top_logprobs[rid]]
        low = [i for i, m in enumerate(margins) if m < MARGIN]
        upto = low[0] if low else len(w)
        assert list(got[rid][:upto]) == list(w[:upto]), rid
        np.testing.assert_allclose(teng.finished_logprobs[rid][:upto],
                                   jeng.finished_logprobs[rid][:upto],
                                   atol=1e-4)
        compared += upto
        total += len(w)
    assert compared >= 0.75 * total, (compared, total)
    assert ({k: teng.stats[k] for k in PREFIX_KEYS}
            == {k: int(jeng.stats[k]) for k in PREFIX_KEYS})
    return got


def _prompts(vocab, shared_len=40, n=4, tail=6, key=3):
    rng = _rng("prompts", shared_len, n, tail, key)
    shared = rng.integers(0, vocab, size=shared_len)
    return [np.concatenate([shared, rng.integers(0, vocab, size=tail)])
            .astype(np.int32) for _ in range(n)]


def _allocator(eng):
    """The allocator's host state: cached blocks in LRU order with their
    refcounts, and the free list."""
    be = eng.cache_backend
    return ([(h, b, be._block_ref[b]) for h, b in be._hash_to_block.items()],
            list(be._free))


def test_chain_hashes_equal_the_reference():
    rng = _rng("hashes")
    for bs in (1, 8, 16, 64):
        toks = rng.integers(0, 32768, size=3 * bs + 5).astype(np.int32)
        want = jprefix.chain_hashes(toks, bs)
        assert prefix.chain_hashes(toks, bs) == want
        assert prefix.chain_hashes(toks.tolist(), bs) == want
        assert len(want) == toks.size // bs
    assert prefix.chain_hashes(np.arange(5), 8) == []


@pytest.mark.parametrize("backend", BACKENDS)
def test_reuse_matches_jax(pair, backend):
    """The reference's reuse cases in one engine pair: a repeated prompt,
    tails on one shared prefix, all of them in flight at once, a prompt
    of whole blocks (its last block is not matched) and a prompt too
    short to match. Each run equals the JAX engine's; after the drain
    every block is free or cached at refcount 0, in the JAX engine's
    LRU order and free-list order."""
    jeng, teng = _engines(pair, backend)
    vocab = pair[1].vocab_size
    bs = teng.block_size
    prompt = _prompts(vocab, shared_len=2 * bs + 8, n=1)[0]
    _run_both(jeng, teng, [("a", prompt, 6)])
    assert teng.stats["prefix_hit_tokens"] == 0
    _run_both(jeng, teng, [("b", prompt, 6)])
    assert teng.stats["prefix_hit_tokens"] == (prompt.size - 1) // bs * bs
    tails = _prompts(vocab, shared_len=2 * bs, n=4, key=4)
    _run_both(jeng, teng, [("t", tails[0], 4)])
    _run_both(jeng, teng, [(f"c{i}", p, 4) for i, p in enumerate(tails)])
    whole = _prompts(vocab, shared_len=3 * bs, n=1, tail=0, key=5)[0]
    hits = teng.stats["prefix_hit_tokens"]
    _run_both(jeng, teng, [("w1", whole, 4)])
    _run_both(jeng, teng, [("w2", whole, 4)])
    assert teng.stats["prefix_hit_tokens"] - hits == 2 * bs
    hits = teng.stats["prefix_hit_tokens"]
    short = np.arange(1, bs + 1, dtype=np.int32)
    _run_both(jeng, teng, [("s1", short, 4)])
    _run_both(jeng, teng, [("s2", short, 4)])
    assert teng.stats["prefix_hit_tokens"] == hits
    cached, free = _allocator(teng)
    assert (cached, free) == _allocator(jeng)
    assert all(r == 0 for _, _, r in cached)
    blocks = {b for _, b, _ in cached}
    assert not blocks & set(free)
    assert len(blocks | set(free)) == teng.cache_backend.n_blocks - 1
    assert teng.cache_backend.residency()["prefix_cached_blocks"] == len(
        cached)


# Small pools, shared by the eviction and exhaustion cases: (block_size,
# max_len, pool_tokens, shared, tail). Two prompts of the exhaustion case
# share one block, and the pool holds one footprint and a part of
# another.
_EXHAUST = {"paged": (8, 64, 96, 8, 20), "paged-int8": (32, 128, 128, 32, 36)}


@pytest.mark.parametrize("backend", BACKENDS)
def test_lru_eviction_matches_jax(pair, backend):
    """A pool too small to cache every prompt evicts the least recently
    used chain: the eviction count, the LRU order and the free list
    equal the JAX engine's; the evicted first prompt then misses and
    still gives the JAX tokens."""
    bs, max_len, pool, _, _ = _EXHAUST[backend]
    jeng, teng = _engines(pair, backend, n_slots=2, max_len=max_len,
                          pool_tokens=pool)
    rng = _rng("evict", backend)
    prompts = [rng.integers(0, pair[1].vocab_size, size=2 * bs + 1)
               .astype(np.int32) for _ in range(6)]
    for i, p in enumerate(prompts):
        _run_both(jeng, teng, [(i, p, 4)])
        assert _allocator(teng) == _allocator(jeng), i
    assert teng.stats["prefix_evictions"] > 0
    hits = teng.stats["prefix_hit_tokens"]
    _run_both(jeng, teng, [("re", prompts[0], 4)])
    assert teng.stats["prefix_hit_tokens"] == hits


@pytest.mark.parametrize("backend", BACKENDS)
def test_deep_hit_near_max_len(pair, backend):
    """A hit that leaves a short suffix near max_len: the suffix's pad is
    capped at the table space left, and the tokens are the JAX
    engine's."""
    jeng, teng = _engines(pair, backend)
    bs, max_len = teng.block_size, teng.max_len
    rng = _rng("deep", backend)
    base = rng.integers(0, pair[1].vocab_size, size=max_len - 7)
    long = np.concatenate([base[:(max_len - 8) // bs * bs],
                           rng.integers(0, pair[1].vocab_size, size=6)])
    _run_both(jeng, teng, [("w", base.astype(np.int32), 1)])
    hits = teng.stats["prefix_hit_tokens"]
    _run_both(jeng, teng, [("x", long.astype(np.int32), 1)])
    assert teng.stats["prefix_hit_tokens"] - hits == (max_len - 8) // bs * bs


@pytest.mark.parametrize("backend", BACKENDS)
def test_pool_exhaustion_requeues_with_prefix(pair, backend):
    """An admission that cannot cover its footprint rolls its attach back
    and waits; every request completes with the JAX tokens, the requeues
    are counted and the refcounts return to 0."""
    bs, max_len, pool, n_shared, tail = _EXHAUST[backend]
    jeng, teng = _engines(pair, backend, n_slots=2, max_len=max_len,
                          pool_tokens=pool)
    rng = _rng("exhaust", backend)
    vocab = pair[1].vocab_size
    shared = rng.integers(0, vocab, size=n_shared)
    prompts = [np.concatenate([shared, rng.integers(0, vocab, size=tail)])
               .astype(np.int32) for _ in range(4)]
    before = teng.stats["pool_exhausted"]
    _run_both(jeng, teng, [(i, p, 24) for i, p in enumerate(prompts)])
    assert teng.stats["pool_exhausted"] > before
    assert teng.stats["prefix_hit_tokens"] > 0
    assert all(r == 0 for r in teng.cache_backend._block_ref.values())
    assert _allocator(teng) == _allocator(jeng)


def test_chunked_prompt_starts_at_the_hit(pair):
    """With chunked prefill, a hit's prompt is chunked from the matched
    offset: the JAX engine's chunk count and tokens."""
    jeng, teng = _engines(pair, "paged", prefill_chunk=16)
    prompts = _prompts(pair[1].vocab_size, shared_len=48, n=2, tail=20,
                       key=6)
    _run_both(jeng, teng, [("a", prompts[0], 6)])
    chunks = {id(e): e.stats["prefill_chunks"] for e in (jeng, teng)}
    _run_both(jeng, teng, [("b", prompts[1], 6)])
    assert (teng.stats["prefill_chunks"] - chunks[id(teng)]
            == jeng.stats["prefill_chunks"] - chunks[id(jeng)] == 2)


def test_option_checks(pair):
    """The reference's refusals: a backend instance built without the
    prefix cache, and prompt logprobs on a prefix-cached engine."""
    _, tc, _, tp = pair
    be = PagedBackend(tc, 2, 64, block_size=8)
    with pytest.raises(ValueError, match="prefix_cache"):
        batching.PagedBatchingEngine(tc, tp, n_slots=2, max_len=64,
                                     cache_backend=be, prefix_cache=True,
                                     device=CPU)
    eng = batching.PagedBatchingEngine(tc, tp, n_slots=2, max_len=64,
                                       prefix_cache=True, device=CPU)
    with pytest.raises(ValueError, match="prefix cache"):
        eng.submit("x", [1, 2, 3], 2, prompt_logprobs=True)
    plain = batching.PagedBatchingEngine(tc, tp, n_slots=2, max_len=64,
                                         block_size=8, device=CPU)
    assert not any(k.startswith("prefix_") for k in plain.stats)
    assert plain.cache_backend.prefill_offset(0) == 0


def test_prefix_hit_lowers_the_simulated_prefill_cost(pair):
    """SimulatedHostLatency charges prefill_token_s for each token a
    prefill computes: a hit's flight costs the matched tokens less."""
    _, tc, _, tp = pair
    eng = batching.PagedBatchingEngine(tc, tp, n_slots=2, max_len=128,
                                       block_size=8, prefix_cache=True,
                                       device=CPU)
    shim = SimulatedHostLatency(eng, prefill_s=0.001,
                                prefill_token_s=0.0001)
    costs = []
    real = shim.on_prefill_dispatch

    def record(flight):
        costs.append(shim.prefill_cost(flight))
        real(flight)

    shim.on_prefill_dispatch = record
    prompt = _prompts(tc.vocab_size, shared_len=40, n=1)[0]
    eng.run([("a", prompt, 2)])
    eng.run([("b", prompt, 2)])
    assert eng.stats["prefix_hit_tokens"] == 40
    assert costs[0] == pytest.approx(0.001 + 0.0001 * prompt.size)
    assert costs[0] - costs[1] == pytest.approx(0.0001 * 40)
