"""The PyTorch port's ops against the JAX package's, on the CPU.

The same inputs, drawn from a seeded numpy generator, go through the JAX
function and the port's counterpart. Where the JAX function is a Pallas
kernel, it runs in interpret mode, as the JAX package's own tests run it
on the CPU. On CPU tensors every port wrapper takes its plain PyTorch
version, so these tests hold the plain versions — which the card's
kernels are held against in tests/test_torch_kernels.py and
chip_smoke.py — to the JAX package.

Tolerances: fp32 throughout; attention atol/rtol 2e-5 as
tests/test_decode_attention.py uses; norms and rope 1e-5 (elementwise
fp32 with a reduction); sampling masks exact.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import functools
import importlib
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shellac_tpu.config import Llama3RopeConfig as JLlama3
from shellac_tpu.config import YarnConfig as JYarn
from shellac_tpu_torch.config import Llama3RopeConfig, YarnConfig
from shellac_tpu_torch.ops import activations as tact
from shellac_tpu_torch.ops import attention as tatt
from shellac_tpu_torch.ops import decode_attention as tda
from shellac_tpu_torch.ops import flash_attention as tfa
from shellac_tpu_torch.ops import norms as tnorms
from shellac_tpu_torch.ops import rope as trope
from shellac_tpu_torch.ops import sampling as tsamp

# The JAX ops package re-exports functions under some module names
# (ops.flash_attention is a function there), so load the modules by path.
jda, jfa, jnorms, jrope, jsamp = (
    importlib.import_module(f"shellac_tpu.ops.{m}")
    for m in ("decode_attention", "flash_attention", "norms", "rope",
              "sampling")
)

ATOL = RTOL = 2e-5


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- norms


# (16, 2048) and (4, 16, 128): the widths of the card kernel's
# register-resident instances (the residual stream; q/k norms).
@pytest.mark.parametrize("shape", [(4, 7, 128), (3, 256), (2, 5, 100),
                                   (16, 2048), (4, 16, 128)])
def test_rms_norm_ref_matches_pallas_interpret(shape):
    rng = _rng("rms", shape)
    x, scale = _randn(rng, *shape), 0.3 * _randn(rng, shape[-1])
    want = np.asarray(jnorms.rms_norm_pallas(
        jnp.asarray(x), jnp.asarray(scale), 1e-5, True))
    got = tnorms.rms_norm_ref(_t(x), _t(scale), 1e-5).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # On a CPU tensor the dispatcher takes the plain version.
    assert torch.equal(tnorms.rms_norm(_t(x), _t(scale), 1e-5),
                       tnorms.rms_norm_ref(_t(x), _t(scale), 1e-5))


def test_rms_norm_ref_bf16_output_dtype():
    rng = _rng("rms-bf16")
    x = _t(_randn(rng, 3, 64)).to(torch.bfloat16)
    out = tnorms.rms_norm_ref(x, _t(_randn(rng, 64)))
    assert out.dtype == torch.bfloat16


def test_layer_norm_ref_matches_jax():
    rng = _rng("ln")
    x, s, b = _randn(rng, 5, 96), _randn(rng, 96), _randn(rng, 96)
    want = np.asarray(jnorms.layer_norm_ref(*map(jnp.asarray, (x, s, b))))
    got = tnorms.layer_norm_ref(_t(x), _t(s), _t(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# ----------------------------------------------------------------- rope

_SCALINGS = {
    "plain": ({}, {}),
    "yarn": (
        {"yarn": JYarn(factor=4.0, original_max_position_embeddings=64,
                       mscale=1.0, mscale_all_dim=0.5)},
        {"yarn": YarnConfig(factor=4.0, original_max_position_embeddings=64,
                            mscale=1.0, mscale_all_dim=0.5)},
    ),
    "llama3": (
        {"llama3": JLlama3(factor=8.0, low_freq_factor=1.0,
                           high_freq_factor=4.0,
                           original_max_position_embeddings=64)},
        {"llama3": Llama3RopeConfig(factor=8.0, low_freq_factor=1.0,
                                    high_freq_factor=4.0,
                                    original_max_position_embeddings=64)},
    ),
    "linear": ({"linear": 8.0}, {"linear": 8.0}),
}


def test_yarn_tables_outlive_other_keys():
    """A yarn table, which captured graphs read without holding it, stays
    the same object after 17 other (dim, base, yarn, device) keys."""
    yarn = YarnConfig(factor=32.0, original_max_position_embeddings=4096,
                      truncate=False)
    first = trope._yarn_table(64, 150000.0, yarn, torch.device("cpu"))
    for i in range(17):
        trope._yarn_table(64, 1000.0 + i, yarn, torch.device("cpu"))
    again = trope._yarn_table(64, 150000.0, yarn, torch.device("cpu"))
    assert again is first and again[0] is first[0]


@pytest.mark.parametrize("kind", sorted(_SCALINGS))
def test_rope_matches_jax(kind):
    jkw, tkw = _SCALINGS[kind]
    rng = _rng("rope", kind)
    pos = rng.integers(0, 500, size=(2, 9)).astype(np.int32)
    jc, js = jrope.rope_angles(jnp.asarray(pos), 64, 10000.0, **jkw)
    tc, ts = trope.rope_angles(_t(pos), 64, 10000.0, **tkw)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5,
                               rtol=1e-5)
    x = _randn(rng, 2, 9, 4, 64)
    want = np.asarray(jrope.apply_rope(jnp.asarray(x), jc, js))
    got = trope.apply_rope(_t(x), tc, ts).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_activations_match_jax():
    from shellac_tpu.ops import activations as jact

    rng = _rng("act")
    g, u = _randn(rng, 4, 33), _randn(rng, 4, 33)
    for name in ("swiglu", "geglu"):
        want = np.asarray(getattr(jact, name)(jnp.asarray(g), jnp.asarray(u)))
        got = getattr(tact, name)(_t(g), _t(u)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    want = np.asarray(jact.softcap(jnp.asarray(5 * g), 3.0))
    np.testing.assert_allclose(tact.softcap(_t(5 * g), 3.0).numpy(), want,
                               atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ attention

# (causal, window, softcap, sinks, h, hkv, d, s)
_FLASH_CASES = {
    "causal_gqa_d128": (True, None, None, False, 4, 2, 128, 48),
    "noncausal_d64": (False, None, None, False, 4, 4, 64, 40),
    "window": (True, 11, None, False, 4, 2, 64, 48),
    "softcap": (True, None, 20.0, False, 4, 2, 128, 40),
    "sinks": (True, None, None, True, 4, 2, 64, 40),
    # S = 40 is not a multiple of the 16-row blocks: the JAX kernel falls
    # to 8-row blocks (it needs S % 8 == 0; the CUDA kernel takes any S,
    # see test_attention_ref_odd_length_matches_jax).
    "window_softcap_sinks_ragged": (True, 9, 30.0, True, 4, 2, 128, 40),
    "mha_ragged_d64": (True, None, None, False, 2, 2, 64, 40),
}


@pytest.mark.parametrize("case", sorted(_FLASH_CASES))
def test_flash_plain_matches_jax_flash_interpret(case):
    causal, window, cap, sink, h, hkv, d, s = _FLASH_CASES[case]
    rng = _rng("flash", case)
    q, k, v = (_randn(rng, 2, s, h, d), _randn(rng, 2, s, hkv, d),
               _randn(rng, 2, s, hkv, d))
    sinks = _randn(rng, h) if sink else None
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, softcap=cap,
        sinks=None if sinks is None else jnp.asarray(sinks),
        block_q=16, block_k=16, interpret=True,
    ))
    tq, tk, tv = _t(q), _t(k), _t(v)
    ts = None if sinks is None else _t(sinks)
    got = tfa.flash_attention(tq, tk, tv, causal=causal, window=window,
                              softcap=cap, sinks=ts)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    # The dispatcher takes the same plain version on a CPU tensor.
    via = tatt.attention(tq, tk, tv, causal=causal, window=window,
                         softcap=cap, sinks=ts)
    assert torch.equal(via, got)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_odd_length_matches_jax(causal):
    """An S no block divides (the CUDA kernel masks the ragged tail
    itself): the port's plain version against the JAX reference."""
    from shellac_tpu.ops.attention import attention_ref as jref

    rng = _rng("attn-odd", causal)
    q, k, v = (_randn(rng, 2, 37, 4, 64), _randn(rng, 2, 37, 2, 64),
               _randn(rng, 2, 37, 2, 64))
    sinks = _randn(rng, 4)
    kw = dict(causal=causal, softcap=30.0,
              window=9 if causal else None)
    want = np.asarray(jax.jit(functools.partial(jref, **kw))(
        *map(jnp.asarray, (q, k, v)), sinks=jnp.asarray(sinks)))
    got = tfa.flash_attention(_t(q), _t(k), _t(v), sinks=_t(sinks), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_attention_ref_positions_and_mask_match_jax():
    from shellac_tpu.ops.attention import attention_ref as jref

    rng = _rng("attn-pos")
    q, k, v = _randn(rng, 2, 3, 4, 64), _randn(rng, 2, 20, 2, 64), \
        _randn(rng, 2, 20, 2, 64)
    qp = np.array([[5, 6, 7], [17, 18, 19]], np.int32)
    kp = np.tile(np.arange(20, dtype=np.int32), (2, 1))
    km = kp < np.array([[8], [20]])
    want = np.asarray(jax.jit(functools.partial(jref, window=4))(
        *map(jnp.asarray, (q, k, v)), q_positions=jnp.asarray(qp),
        kv_positions=jnp.asarray(kp), kv_mask=jnp.asarray(km)))
    got = tatt.attention_ref(_t(q), _t(k), _t(v), window=4,
                             q_positions=_t(qp), kv_positions=_t(kp),
                             kv_mask=_t(km))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_sink_rebase_matches_jax():
    rng = _rng("sink")
    m, l, s = _randn(rng, 6), np.abs(_randn(rng, 6)) + 0.1, _randn(rng, 6)
    want = jfa.sink_rebase(*map(jnp.asarray, (m, l, s)))
    got = tfa.sink_rebase(_t(m), _t(l), _t(s))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6)


# (s, window, softcap, sinks, d)
_DECODE_CASES = {
    "s1": (1, None, None, False, 128),
    "s4": (4, None, None, False, 128),
    "s1_window": (1, 20, None, False, 64),
    "s4_window_softcap": (4, 20, 30.0, False, 128),
    "s1_sinks_d64": (1, None, None, True, 64),
    "s4_all": (4, 13, 25.0, True, 64),
    "g8_s2_split_edges": (2, 40, 25.0, True, 64),
}
# (h, hkv, index) where a case differs from 8, 4 and lengths 0, 37 and
# max_len - s (empty, mid, full). The card's split-K decode body deals
# 32-position tiles to the CTAs of a cluster; its plain version is held
# to JAX at G 8 and s 2 (16 rows) with one slot shorter than a tile, one
# full to the last position and one whose window starts mid-range.
_DECODE_SHAPES = {"g8_s2_split_edges": (16, 2, [3, 126, 90])}


@pytest.mark.parametrize("case", sorted(_DECODE_CASES))
def test_decode_plain_matches_jax_decode_interpret(case):
    s, window, cap, sink, d = _DECODE_CASES[case]
    b, max_len = 3, 128
    h, hkv, lengths = _DECODE_SHAPES.get(case, (8, 4, [0, 37, max_len - s]))
    rng = _rng("decode", case)
    q = _randn(rng, b, s, h, d)
    ck, cv = _randn(rng, b, hkv, max_len, d), _randn(rng, b, hkv, max_len, d)
    index = np.array(lengths, np.int32)
    sinks = _randn(rng, h) if sink else None
    want = np.asarray(jda.decode_attention(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(index),
        window=window, softcap=cap,
        sinks=None if sinks is None else jnp.asarray(sinks),
        impl="flash", block_k=64, interpret=True,
    ))
    got = tda.decode_attention(
        _t(q), _t(ck), _t(cv), _t(index), window=window, softcap=cap,
        sinks=None if sinks is None else _t(sinks),
    )
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_decode_rejects_int8_scales():
    """A lone scale is refused; both scales dequantize an int8 cache (in
    fp32, cast to q's dtype) before the plain attention."""
    rng = _rng("decode-int8-scales")
    q = _t(_randn(rng, 1, 1, 2, 64))
    c = torch.from_numpy(rng.integers(-127, 128, (1, 2, 8, 64)).astype(
        np.int8))
    sc = _t(rng.uniform(0.01, 0.1, (1, 2, 8)).astype(np.float32))
    idx = torch.tensor([5], dtype=torch.int32)
    with pytest.raises(ValueError, match="come together"):
        tda.decode_attention(q, c, c, idx, k_scale=sc)
    got = tda.decode_attention(q, c, c, idx, k_scale=sc, v_scale=sc)
    deq = c.float() * sc[..., None]
    torch.testing.assert_close(got, tda.decode_attention(q, deq, deq, idx),
                               atol=0, rtol=0)


@pytest.mark.parametrize("wrapper", ["rms", "flash", "decode"])
def test_cuda_wrappers_refuse_cpu_tensors(wrapper):
    """A kernel wrapper launches on CUDA tensors or raises; it never
    computes a CPU tensor itself."""
    x = torch.zeros(2, 4, 2, 64)
    with pytest.raises(ValueError):
        if wrapper == "rms":
            tnorms.rms_norm_cuda(x, torch.zeros(64))
        elif wrapper == "flash":
            tfa.flash_attention_cuda(x, x, x)
        else:
            tda.decode_attention_cuda(x[:, :1], torch.zeros(2, 2, 8, 64),
                                      torch.zeros(2, 2, 8, 64),
                                      torch.zeros(2, dtype=torch.int32))


# ------------------------------------------------------------- sampling


def _logits(rng, shape=(4, 50)):
    return _randn(rng, *shape) * 3


@pytest.mark.parametrize("k", [1, 5, 50, 80])
def test_top_k_mask_matches_jax(k):
    x = _logits(_rng("topk", k))
    want = np.asarray(jsamp.top_k_mask(jnp.asarray(x), k))
    assert np.array_equal(tsamp.top_k_mask(_t(x), k).numpy(), want)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_top_p_and_min_p_masks_match_jax(p):
    x = _logits(_rng("topp", p))
    want = np.asarray(jsamp.top_p_mask(jnp.asarray(x), p))
    got = tsamp.top_p_mask(_t(x), p).numpy()
    # Boundary rows could differ by cumsum rounding; none do at this seed.
    assert np.array_equal(got, want)
    want = np.asarray(jsamp.min_p_mask(jnp.asarray(x), p))
    assert np.array_equal(tsamp.min_p_mask(_t(x), p).numpy(), want)


def test_repetition_penalty_matches_jax():
    rng = _rng("rep")
    x = _logits(rng)
    seen = rng.random(x.shape) < 0.3
    want = np.asarray(jsamp.repetition_penalty(jnp.asarray(x),
                                               jnp.asarray(seen), 1.3))
    got = tsamp.repetition_penalty(_t(x), _t(seen), 1.3).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_sample_greedy_topk1_and_seeded_self_consistency():
    x = _t(_logits(_rng("sample"), (6, 40)))
    greedy = tsamp.sample(None, x, temperature=0.0)
    assert torch.equal(greedy, x.argmax(-1))
    g = torch.Generator().manual_seed(3)
    assert torch.equal(tsamp.sample(g, x, temperature=0.7, top_k=1), greedy)

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return tsamp.sample(g, x, temperature=1.2, top_k=10, top_p=0.9,
                            min_p=0.05)

    assert torch.equal(draw(7), draw(7))
    # Support check: every draw lies inside the filtered set.
    filt = tsamp.min_p_mask(tsamp.top_p_mask(
        tsamp.top_k_mask(x / 1.2, 10), 0.9), 0.05)
    for seed in range(5):
        tok = draw(seed)
        assert (filt.gather(1, tok[:, None]) > tsamp.NEG_INF / 2).all()
