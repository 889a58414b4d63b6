"""The PyTorch port's training path against the JAX package's, on the CPU.

Both packages run the same numpy-seeded inputs in fp32: the plain
versions of the flash backward kernels against the JAX Pallas backward in
interpret mode, the autograd Functions of flash attention and RMSNorm
(with their plain implementations injected) against `jax.grad`, the loss,
the adamw chain against optax, and three train steps of `make_train_step`
against the JAX step on the same master weights (`params_from_jax(...,
master=True)`).

Tolerances (fp32 on both sides, summation order differs):
  - flash backward outputs: atol/rtol 2e-5, as the port's attention
    parity tests use;
  - RMSNorm and loss gradients: atol/rtol 1e-5;
  - the adamw chain: params atol 1e-6 + rtol 1e-5, nu rtol 1e-5, mu (held
    in bf16) within one bf16 ulp (rtol 2^-7) with most entries equal;
  - train steps: loss and grad_norm rtol 2e-5 per step; params after the
    last step atol 2e-5 relative to each leaf's max-abs.
A first moment stored in bf16 makes an fp32 moment that differs in its
last bit between the two packages round, now and then, to the
neighbouring bf16 value; that element's update then differs by up to
lr * 2^-7, and over a few steps the flips compound through the
gradients. So the adamw chain (identical gradients on both sides) is
held with bf16 moments, allowing such flips in 0.5% of a leaf's elements
(each within 2 * lr * 2^-7, and mu within 3 bf16 ulps, 99% of it equal),
while the train steps are held with fp32 moments. There too adam's
update m / (sqrt(v) + eps) magnifies the summation-order difference of
a gradient element near eps, so 0.1% of a leaf's elements may leave the
atol (each still within 2 * lr * 2^-7).
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import importlib
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shellac_tpu.config import TrainConfig as JTrainConfig
from shellac_tpu.models import transformer as jt
from shellac_tpu.models.registry import get_model_config as jget
from shellac_tpu.ops.norms import rms_norm_ref as j_rms_norm_ref
from shellac_tpu.training.losses import cross_entropy as j_cross_entropy
from shellac_tpu.training.optimizer import make_optimizer as j_make_optimizer
from shellac_tpu.training.optimizer import make_schedule as j_make_schedule
from shellac_tpu.training.train_state import TrainState as JTrainState
from shellac_tpu.training.trainer import make_train_step as j_make_step
from shellac_tpu_torch.config import TrainConfig
from shellac_tpu_torch.models import transformer as tt
from shellac_tpu_torch.models.from_jax import params_from_jax
from shellac_tpu_torch.models.registry import get_model_config
from shellac_tpu_torch.ops import decode_attention as tda
from shellac_tpu_torch.ops import flash_attention as tfa
from shellac_tpu_torch.ops import norms as tnorms
from shellac_tpu_torch.training import (
    adamw_update,
    cross_entropy,
    init_train_state,
    make_schedule,
    make_train_step,
    named_leaves,
    train_state_from_params,
)
from shellac_tpu_torch.training.train_state import clone_tree

# The module, not the function of the same name that shellac_tpu.ops
# re-exports.
jfa = importlib.import_module("shellac_tpu.ops.flash_attention")
CPU = "cpu"
FLASH_TOL = dict(atol=2e-5, rtol=2e-5)


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable, contiguous copy


def _packed(b, s, bounds):
    seg = np.zeros((b, s), np.int32)
    for i in range(len(bounds) - 1):
        seg[:, bounds[i]:bounds[i + 1]] = i
    return seg


# ----------------------------------------------- (a) backward plain versions

# (b, s, h, hkv, d, causal, window, segments, softcap, sinks, block)
_BWD_CASES = {
    "causal_mha_d128": (1, 64, 2, 2, 128, True, None, None, None, False, 32),
    "window_gqa": (1, 96, 4, 2, 64, True, 20, None, None, False, 32),
    "segments": (2, 64, 4, 2, 64, True, None, (0, 21, 37, 64), None, False,
                 32),
    "window_segments": (1, 96, 4, 2, 64, True, 24, (0, 40, 49, 96), None,
                        False, 32),
    "softcap_sinks": (2, 64, 4, 2, 64, True, None, None, 20.0, True, 32),
}


def _bwd_inputs(case):
    b, s, h, hkv, d, causal, window, bounds, cap, sink, blk = \
        _BWD_CASES[case]
    rng = _rng("bwd", case)
    q, do = _randn(rng, b, s, h, d), _randn(rng, b, s, h, d)
    k, v = _randn(rng, b, s, hkv, d), _randn(rng, b, s, hkv, d)
    seg = None if bounds is None else _packed(b, s, bounds)
    sinks = _randn(rng, h) if sink else None
    kw = dict(causal=causal, window=window, softcap=cap)
    return q, k, v, do, seg, sinks, kw, blk


@pytest.mark.parametrize("case", sorted(_BWD_CASES))
def test_flash_backward_plain_matches_jax_interpret(case):
    q, k, v, do, seg, sinks, kw, blk = _bwd_inputs(case)
    b, s, h, d = q.shape
    scale = d ** -0.5
    jseg = None if seg is None else jnp.asarray(seg)
    jsinks = None if sinks is None else jnp.asarray(sinks)
    out, lse = jfa._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jseg, kw["causal"],
        scale, kw["window"], blk, blk, True, kw["softcap"], jsinks)
    jdq, jdk, jdv, jds = jfa._flash_backward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jseg, out, lse,
        jnp.asarray(do), kw["causal"], scale, kw["window"], blk, blk, True,
        kw["softcap"], jsinks)
    tq, tk, tv, tdo = _t(q), _t(k), _t(v), _t(do)
    tseg = None if seg is None else _t(seg)
    # The port's plain forward gives the same out and lse.
    tout, tlse = tfa.flash_forward_ref(
        tq, tk, tv, scale=scale, sinks=None if sinks is None else _t(sinks),
        segments=tseg, **kw)
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), **FLASH_TOL)
    np.testing.assert_allclose(tlse.numpy(),
                               np.asarray(lse).reshape(b, h, s), **FLASH_TOL)
    lse_t = _t(np.asarray(lse).reshape(b, h, s))
    delta = torch.einsum("bshd,bshd->bhs", tdo, _t(np.asarray(out)))
    dk, dv = tfa.flash_bwd_dkdv_ref(tq, tk, tv, tdo, lse_t, delta,
                                    scale=scale, segments=tseg, **kw)
    dq = tfa.flash_bwd_dq_ref(tq, tk, tv, tdo, lse_t, delta, scale=scale,
                              segments=tseg, **kw)
    for name, got, want in (("dq", dq, jdq), ("dk", dk, jdk),
                            ("dv", dv, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **FLASH_TOL)
    if sinks is not None:
        got = tfa.flash_bwd_dsinks(_t(sinks), lse_t, delta)
        np.testing.assert_allclose(got.numpy(), np.asarray(jds), **FLASH_TOL)


# ------------------------------------------------ (b) the flash Function

_FN_CASES = {
    "causal_gqa": dict(s=64, h=4, hkv=2, d=128, causal=True),
    "window_segments": dict(s=64, h=4, hkv=2, d=64, causal=True, window=24,
                            bounds=(0, 25, 33, 64)),
    "softcap_sinks": dict(s=64, h=4, hkv=2, d=64, causal=True,
                          softcap=20.0, sinks=True),
}


@pytest.mark.parametrize("case", sorted(_FN_CASES))
def test_flash_function_plain_matches_jax_grad(case):
    c = dict(_FN_CASES[case])
    s, h, hkv, d = (c.pop(k) for k in ("s", "h", "hkv", "d"))
    bounds, sink = c.pop("bounds", None), c.pop("sinks", False)
    rng = _rng("fn", case)
    q, k, v = (_randn(rng, 2, s, h, d), _randn(rng, 2, s, hkv, d),
               _randn(rng, 2, s, hkv, d))
    w = _randn(rng, 2, s, h, d)  # the loss weights: sum(out * w)
    seg = None if bounds is None else _packed(2, s, bounds)
    sinks = _randn(rng, h) if sink else None

    def jloss(q, k, v, sinks):
        out = jfa.flash_attention(
            q, k, v, segments=None if seg is None else jnp.asarray(seg),
            sinks=sinks, block_q=32, block_k=32, interpret=True, **c)
        return jnp.sum(out * jnp.asarray(w))

    argn = (0, 1, 2, 3) if sink else (0, 1, 2)
    want = jax.jit(jax.grad(jloss, argnums=argn))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if sinks is None else jnp.asarray(sinks))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    ts = None if sinks is None else _t(sinks).requires_grad_()
    out = tfa.FlashAttentionFunction.apply(
        tq, tk, tv, None if seg is None else _t(seg), ts, c["causal"],
        d ** -0.5, c.get("window"), c.get("softcap"), tfa.PLAIN)
    (out * _t(w)).sum().backward()
    got = [tq.grad, tk.grad, tv.grad] + ([ts.grad] if sink else [])
    for name, g, jg in zip(("dq", "dk", "dv", "dsinks"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), err_msg=name,
                                   **FLASH_TOL)


# --------------------------------------------------- (c) RMSNorm Function


@pytest.mark.parametrize("shape", [(3, 5, 64), (7, 128)])
def test_rms_norm_function_grads_match_jax(shape):
    rng = _rng("rms", shape)
    x, w = _randn(rng, *shape), _randn(rng, *shape)
    scale = _randn(rng, shape[-1], scale=0.3)

    def jloss(x, s):
        return jnp.sum(j_rms_norm_ref(x, s, 1e-5) * jnp.asarray(w))

    jdx, jds = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(x),
                                               jnp.asarray(scale))
    tx, ts = _t(x).requires_grad_(), _t(scale).requires_grad_()
    y = tnorms.RMSNormFunction.apply(tx, ts, 1e-5, tnorms.rms_norm_ref)
    (y * _t(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jds), atol=1e-5,
                               rtol=1e-5)


# -------------------------------------------------------------- (d) loss


@pytest.mark.parametrize("masked,z", [(False, 0.0), (True, 1e-3)])
def test_cross_entropy_matches_jax(masked, z):
    rng = _rng("ce", masked, z)
    logits = _randn(rng, 3, 7, 50, scale=3.0)
    targets = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.7).astype(np.float32) if masked else None

    def jloss(lg):
        return j_cross_entropy(lg, jnp.asarray(targets),
                               None if mask is None else jnp.asarray(mask),
                               z)

    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(logits))
    tl = _t(logits).requires_grad_()
    loss, metrics = cross_entropy(tl, _t(targets),
                                  None if mask is None else _t(mask), z)
    loss.backward()
    for k in ("loss", "perplexity", "tokens"):
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(jm[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jg), atol=1e-5,
                               rtol=1e-5)


# ------------------------------------------------------- (e) adamw chain


def _jax_master(name, **over):
    """JAX-layout fp32 master params drawn with numpy (the layout from
    jax.eval_shape of the JAX init, which costs no compile): dense
    weights at 1/sqrt(fan_in), the embedding at 0.02, and seeded noise on
    norms, biases and sinks (zero at init). Returns (jax cfg, port cfg,
    numpy tree, port master tree)."""
    jc = jget(name).replace(dtype="float32", **over)
    tc = get_model_config(name).replace(dtype="float32", **over)
    shapes = jax.eval_shape(lambda: jt.init_params(jc, jax.random.PRNGKey(0)))
    rng = _rng("params", name)

    def draw(path, leaf):
        key = str(getattr(path[-1], "key", path[-1]))
        if key == "embed":
            return _randn(rng, *leaf.shape, scale=0.02)
        if key in ("sinks", "bq", "bk", "bv", "bo") or key.endswith("norm"):
            return _randn(rng, *leaf.shape, scale=0.3)
        return _randn(rng, *leaf.shape, scale=leaf.shape[-2] ** -0.5)

    p = jax.tree_util.tree_map_with_path(draw, shapes)
    return jc, tc, p, params_from_jax(tc, p, CPU, master=True)


def _assert_params_close(got, want, atol, rtol, lr, frac, what):
    """All but `frac` of the elements within atol + rtol |want|, and every
    element within 2 lr 2^-7 (see the module note)."""
    err = np.abs(got - want)
    off = err > atol + rtol * np.abs(want)
    assert off.mean() <= frac, (what, int(off.sum()), err.max())
    assert err.max() <= 2 * lr * 2 ** -7, (what, err.max())


def _bf16_ulps(got, want):
    """|got - want| in units of the bf16 spacing at |want|."""
    mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    return np.abs(got - want) / np.exp2(np.floor(np.log2(mag)) - 7)


def _jax_leaf(tree, path):
    """The port leaf at `path` read from a stacked JAX tree."""
    if path[0] == "layers":
        return np.asarray(tree["layers"][path[2]])[path[1]]
    return np.asarray(tree[path[0]])


def test_adamw_chain_matches_optax():
    """Three steps on the same gradients: the first clipped (norm 40 > 1),
    the others not; mu stored in bf16; attn_bias leaves (ndim 1 per layer,
    2 stacked) decayed by the stacked rule; the schedule at every step.
    The optax update is jitted, as the JAX train step runs it (eager JAX
    would round b1 * mu to bf16, jitted XLA keeps it in fp32)."""
    jc, tc, jp, tp = _jax_master("tiny", attn_bias=True)
    cfg = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10)
    jcfg = JTrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10)
    opt = j_make_optimizer(jcfg)
    jupdate = jax.jit(opt.update)
    jparams = jax.tree.map(jnp.asarray, jp)
    jstate = opt.init(jparams)
    state = train_state_from_params(cfg, tp)
    rng = _rng("adamw")
    sched, jsched = make_schedule(cfg), j_make_schedule(jcfg)
    for step, total in enumerate((40.0, 0.5, 0.8)):
        np.testing.assert_allclose(sched(step), float(jsched(step)),
                                   rtol=1e-6, atol=1e-12)
        jg = jax.tree.map(lambda a: _randn(rng, *a.shape), jp)
        norm = np.sqrt(sum(float(np.sum(np.square(g)))
                           for g in jax.tree.leaves(jg)))
        jg = jax.tree.map(lambda g: g * (total / norm), jg)
        upd, jstate = jupdate(jax.tree.map(jnp.asarray, jg), jstate,
                              jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, upd)
        grads = [_t(_jax_leaf(jg, path)).clone()
                 for path, _ in named_leaves(state.params)]
        state.opt_state = adamw_update(cfg, state.params, grads,
                                       state.opt_state)
    adam = jstate[1]
    assert state.opt_state.count == int(adam.count) == 3
    mu_equal = mu_total = 0
    for path, p in named_leaves(state.params):
        _assert_params_close(p.detach().numpy(), _jax_leaf(jparams, path),
                             1e-6, 1e-5, cfg.learning_rate, 0.005, path)
        nu = dict(named_leaves(state.opt_state.nu))[path]
        np.testing.assert_allclose(nu.numpy(), _jax_leaf(adam.nu, path),
                                   rtol=1e-5, atol=1e-12, err_msg=str(path))
        mu = dict(named_leaves(state.opt_state.mu))[path]
        assert mu.dtype == torch.bfloat16
        jmu = _jax_leaf(adam.mu, path).astype(np.float32)
        assert _bf16_ulps(mu.float().numpy(), jmu).max() <= 3, path
        mu_equal += int((mu.float().numpy() == jmu).sum())
        mu_total += jmu.size
    assert mu_equal >= 0.99 * mu_total


def test_decay_mask_follows_the_stacked_layout():
    from shellac_tpu.training.optimizer import _decay_mask

    from shellac_tpu_torch.training import decays

    jc, tc, jp, tp = _jax_master("tiny", attn_bias=True, attn_sink=True,
                                 attn_out_bias=True, post_norms=True)
    jmask = _decay_mask(jax.tree.map(jnp.asarray, jp))
    for path, p in named_leaves(tp):
        want = (bool(jmask["layers"][path[2]]) if path[0] == "layers"
                else bool(jmask[path[0]]))
        assert decays(path, p) == want, path
    assert decays(("layers", 0, "bq"), tp["layers"][0]["bq"])
    assert not decays(("layers", 0, "attn_norm"),
                      tp["layers"][0]["attn_norm"])


# ----------------------------------------------------- (f) the train step

# (preset, packed, remat, grad_accum, ema_decay). tiny-gemma2 is cut to
# its two-layer pattern period (window and full) to keep the compile short.
_STEP_CASES = {
    "tiny_ema": ("tiny", False, False, 1, 0.9),
    "tiny_packed_remat_accum2": ("tiny", True, True, 2, None),
    "gqa_remat": ("tiny-gqa", False, True, 1, None),
    "gqa_packed_accum2": ("tiny-gqa", True, False, 2, None),
    "gemma2": ("tiny-gemma2", False, False, 1, None),
    "gemma2_packed_remat": ("tiny-gemma2", True, True, 1, None),
}


@pytest.mark.parametrize("case", sorted(_STEP_CASES))
def test_train_step_matches_jax(case):
    name, packed, remat, accum, ema = _STEP_CASES[case]
    over = dict(remat=remat)
    if name == "tiny-gemma2":
        over["n_layers"] = 2
    jc, tc, jp, tp = _jax_master(name, **over)
    kw = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10,
              grad_accum=accum, mu_dtype="float32", ema_decay=ema)
    jcfg, cfg = JTrainConfig(**kw), TrainConfig(**kw)
    jparams = jax.tree.map(jnp.asarray, jp)
    jstate = JTrainState(
        step=jnp.zeros((), jnp.int32), params=jparams,
        opt_state=j_make_optimizer(jcfg).init(jparams),
        ema_params=None if ema is None else jax.tree.map(
            lambda x: jnp.array(x, copy=True), jparams))
    jstep = j_make_step(jc, jcfg)
    state = train_state_from_params(cfg, tp)
    step = make_train_step(tc, cfg, device=CPU)
    rng = _rng("step", case)
    b, s = 4, 32
    for i in range(3):
        toks = rng.integers(0, tc.vocab_size, size=(b, s + 1)).astype(
            np.int32)
        batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
        if packed:
            batch["segment_ids"] = _packed(b, s, (0, 13, 20, 21, s))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, {k: _t(v) for k, v in batch.items()})
        for key in ("loss", "grad_norm", "tokens"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=2e-5, err_msg=f"{key} step {i}")
        assert float(m["update_skipped"]) == float(jm["update_skipped"]) == 0
    trees = [(state.params, jstate.params)]
    if ema is not None:
        trees.append((state.ema_params, jstate.ema_params))
    for ours, theirs in trees:
        theirs = jax.tree.map(np.asarray, theirs)
        for path, p in named_leaves(ours):
            want = _jax_leaf(theirs, path)
            scale = max(float(np.abs(want).max()), 1e-6)
            _assert_params_close(p.detach().numpy(), want, 2e-5 * scale,
                                 0.0, cfg.learning_rate, 0.001, path)
    assert state.step == int(jstate.step) == 3


# ------------------------------------------------ (g) non-finite updates


def test_nonfinite_batch_leaves_the_state_bit_identical():
    tc = get_model_config("tiny").replace(dtype="float32")
    cfg = TrainConfig(warmup_steps=1, ema_decay=0.99)
    state = init_train_state(tc, cfg, seed=3, device=CPU)
    step = make_train_step(tc, cfg, device=CPU)
    toks = torch.from_numpy(_rng("nf").integers(0, 256, size=(2, 17)))
    good = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    state, m = step(state, good)
    assert float(m["update_skipped"]) == 0.0
    before = (clone_tree(state.params), clone_tree(state.opt_state.mu),
              clone_tree(state.opt_state.nu), clone_tree(state.ema_params))
    count = state.opt_state.count
    # An inf mask weight makes the loss and every gradient non-finite.
    bad = dict(good, mask=torch.full((2, 16), float("inf")))
    state, m = step(state, bad)
    assert float(m["update_skipped"]) == 1.0
    assert not np.isfinite(float(m["loss"]))
    after = (state.params, state.opt_state.mu, state.opt_state.nu,
             state.ema_params)
    for old, new in zip(before, after):
        for (path, a), (_, b) in zip(named_leaves(old), named_leaves(new)):
            assert torch.equal(a, b), path
    assert state.opt_state.count == count and state.step == 2


# ------------------------------------ (h) devices and unported options


def test_training_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card path is moot")
    tc = get_model_config("tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(tc, TrainConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(tc, TrainConfig())


def test_unported_train_step_arguments_raise():
    tc = get_model_config("tiny")
    with pytest.raises(NotImplementedError):
        make_train_step(tc, TrainConfig(), device=CPU, mesh=object())
    with pytest.raises(NotImplementedError):
        make_train_step(tc, TrainConfig(), device=CPU,
                        pipeline_microbatches=2)


def test_decode_wrappers_are_inference_only():
    """Under autograd the decode kernels' wrappers raise before anything
    else (CPU tensors that require grad reach the check first)."""
    q = torch.zeros(1, 1, 2, 64, requires_grad=True)
    c = torch.zeros(1, 2, 8, 64)
    idx = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="inference-only"):
        tda.decode_attention_cuda(q, c, c, idx)
    pool = torch.zeros(3, 2, 8, 64)
    tab = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="inference-only"):
        tda.paged_decode_attention_cuda(q, pool, pool, tab, idx)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        tda.decode_attention_cuda(q, c, c, idx)


def test_master_params_from_jax_are_unrounded():
    jc, tc, p, tp = _jax_master("tiny-gemma2")
    for path, t in named_leaves(tp):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), _jax_leaf(p, path))
    served = params_from_jax(get_model_config("tiny-gemma2"), p, CPU)
    assert served["layers"][0]["wq"].dtype == torch.bfloat16
    ti = tt.init_params(tc, seed=0, device=CPU, master=True)
    assert all(t.dtype == torch.float32 for _, t in named_leaves(ti))
