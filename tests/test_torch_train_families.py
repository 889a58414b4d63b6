"""The port's train step on the MoE and MLA families against the JAX
package's jitted step, on the CPU.

Three steps of `make_train_step` from the same fp32 master weights
(`params_from_jax(..., master=True)`, the two-stack trees included) on
the same numpy-seeded batches: tiny-moe over the capacity buckets and
over the grouped (dropless) product, tiny-gptoss (dropless softmax_topk
routing, sinks, a window pattern, biases), tiny-mla (MLA's expanded
attention under autograd: q and k 192-wide in the full-size models, v
padded to the qk width) and tiny-deepseek (MLA and MoE, the first layer
dense), with and without remat. The JAX attention here is its reference
attention (the CPU has no Pallas kernel outside interpret mode), as the
port's is its plain version.

Also here: the plain versions of kernels 3 and 4 at MLA's head width 192
(q and k 192 wide, v padded from 128), through `FlashAttentionFunction`
with the plain implementations, against `jax.grad` through the JAX
package's flash attention in interpret mode (which pads 192 to 256):
causal, packed segments, GQA with a window, and a ragged S (37, where
the JAX flash kernel needs S % 8 == 0, against `jax.grad` of its
reference attention).
Tolerance atol/rtol 2e-5, as every port attention parity test.

Tolerances of the steps (fp32 on both sides, summation order differs): loss,
grad_norm and the MoE metrics (aux loss, balance loss, router z loss,
dropped fraction) rtol 2e-5 (atol 1e-6) at every step; params and EMA
after the last step by `_assert_params_close` (atol 2e-5 of each leaf's
max-abs, 0.5% of a leaf's elements may leave it, each within 2 lr 2^-7;
see tests/test_torch_training.py's note: here the tied embedding's rows
that few tokens reach carry gradients near adam's eps, whose updates
the summation order moves most).
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import dataclasses
import functools

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shellac_tpu.config import TrainConfig as JTrainConfig
from shellac_tpu.models import transformer as jt
from shellac_tpu.models.registry import get_model_config as jget
from shellac_tpu.training.optimizer import make_optimizer as j_make_optimizer
from shellac_tpu.training.train_state import TrainState as JTrainState
from shellac_tpu.training.trainer import make_train_step as j_make_step
from shellac_tpu_torch.config import TrainConfig
from shellac_tpu_torch.models.from_jax import params_from_jax
from shellac_tpu_torch.models.registry import get_model_config
from shellac_tpu_torch.ops import flash_attention as tfa
from shellac_tpu_torch.training import (
    make_train_step,
    named_leaves,
    train_state_from_params,
)
from test_torch_training import (
    _assert_params_close,
    _jax_leaf,
    _packed,
    _randn,
    _rng,
    _t,
)

jfa = importlib.import_module("shellac_tpu.ops.flash_attention")
jatt = importlib.import_module("shellac_tpu.ops.attention")
CPU = "cpu"
MOE_KEYS = ("moe_aux_loss", "moe_balance_loss", "moe_router_z_loss",
            "moe_dropped_frac")
STEP_KW = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10,
               mu_dtype="float32")


def configs(name, moe=None, **over):
    """The JAX and port configs of a preset in fp32, with `over` and the
    MoE fields `moe` replaced on both."""
    jc = jget(name).replace(dtype="float32", **over)
    tc = get_model_config(name).replace(dtype="float32", **over)
    if moe:
        jc = jc.replace(moe=dataclasses.replace(jc.moe, **moe))
        tc = tc.replace(moe=dataclasses.replace(tc.moe, **moe))
    return jc, tc


@functools.lru_cache(maxsize=None)
def _master_draw(name, over_key, moe_key):
    jc, _ = configs(name, moe=dict(moe_key) or None, **dict(over_key))
    shapes = jax.eval_shape(lambda: jt.init_params(jc, jax.random.PRNGKey(0)))
    rng = _rng("params", name)

    def draw(path, leaf):
        k = str(getattr(path[-1], "key", path[-1]))
        if k == "embed":
            return _randn(rng, *leaf.shape, scale=0.02)
        if k in ("sinks", "bq", "bk", "bv", "bo", "b_router", "b_gate",
                 "b_up", "b_down") or k.endswith("norm"):
            return _randn(rng, *leaf.shape, scale=0.3)
        return _randn(rng, *leaf.shape, scale=leaf.shape[-2] ** -0.5)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def master(name, moe=None, **over):
    """(jax cfg, port cfg, numpy JAX tree, port master tree): seeded
    numpy draws in the JAX layout (norms, biases and sinks noisy, not
    zero), the same numbers in the port's layout."""
    jc, tc = configs(name, moe=moe, **over)
    p = jax.tree.map(np.array, _master_draw(name, _key(over), _key(moe or {})))
    return jc, tc, p, params_from_jax(tc, p, CPU, master=True)


def _key(over):
    return tuple(sorted(over.items()))


@functools.lru_cache(maxsize=None)
def _jax_step(name, model_key, moe_key, train_key):
    """One jitted JAX step a (preset, option) pair, shared by the cases."""
    jc, _ = configs(name, moe=dict(moe_key) or None, **dict(model_key))
    return j_make_step(jc, JTrainConfig(**dict(train_key)))


def step_parity(name, *, moe=None, train=None, packed=False, steps=3,
                b=4, s=32, metric_rtol=2e-5, params_frac=0.005,
                check_params=True, **over):
    """Run `steps` steps of both packages from the same masters on the
    same batches; hold every step's metrics and (with `check_params`)
    the params and EMA after. Returns the port's last state and
    metrics."""
    kw = dict(STEP_KW, **(train or {}))
    jc, tc, jp, tp = master(name, moe=moe, **over)
    jcfg, cfg = JTrainConfig(**kw), TrainConfig(**kw)
    jparams = jax.tree.map(jnp.asarray, jp)
    ema = kw.get("ema_decay")
    jstate = JTrainState(
        step=jnp.zeros((), jnp.int32), params=jparams,
        opt_state=j_make_optimizer(jcfg).init(jparams),
        ema_params=None if ema is None else jax.tree.map(
            lambda x: jnp.array(x, copy=True), jparams))
    jstep = _jax_step(name, _key(over), _key(moe or {}), _key(kw))
    state = train_state_from_params(cfg, tp, tc)
    step = make_train_step(tc, cfg, device=CPU)
    rng = _rng("families", name, _key(over), _key(kw))
    keys = ("loss", "grad_norm", "tokens") + (
        MOE_KEYS if tc.moe is not None else ())
    for i in range(steps):
        toks = rng.integers(0, tc.vocab_size, size=(b, s + 1)).astype(
            np.int32)
        batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
        if packed:
            batch["segment_ids"] = _packed(b, s, (0, 13, 20, 21, s))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, {k: _t(v) for k, v in batch.items()})
        for key in keys:
            np.testing.assert_allclose(
                float(m[key]), float(jm[key]), rtol=metric_rtol, atol=1e-6,
                err_msg=f"{key} step {i}")
        assert float(m["update_skipped"]) == float(jm["update_skipped"]) == 0
    trees = [(state.params, jstate.params)] if check_params else []
    if ema is not None and check_params:
        trees.append((state.ema_params, jstate.ema_params))
    for ours, theirs in trees:
        theirs = jax.tree.map(np.asarray, theirs)
        for path, p in named_leaves(ours):
            want = jax_leaf(theirs, path, tc)
            scale = max(float(np.abs(want).max()), 1e-6)
            _assert_params_close(p.detach().numpy(), want, 2e-5 * scale,
                                 0.0, cfg.learning_rate, params_frac, path)
    assert state.step == int(jstate.step) == steps
    return state, m


def jax_leaf(tree, path, tc):
    """The port leaf at `path` read from a JAX tree, two-stack layouts
    included (first_k_dense: {"dense", "moe"} stacks in layer order)."""
    stacks = tree["layers"] if path[0] == "layers" else None
    if stacks is None or "dense" not in stacks:
        return _jax_leaf(tree, path)
    i, k = path[1], tc.first_k_dense
    if tc.first_k_dense <= 0:
        raise NotImplementedError("interleaved stacks are not read here")
    stack, j = (stacks["dense"], i) if i < k else (stacks["moe"], i - k)
    return np.asarray(stack[path[2]])[j]


# (preset, moe fields, model fields, train fields, packed)
_CASES = {
    "moe_buckets": ("tiny-moe", None, {}, {}, False),
    "moe_buckets_remat_packed": ("tiny-moe", None, {"remat": True}, {},
                                 True),
    "moe_grouped": ("tiny-moe", {"grouped_dropless": True}, {}, {}, False),
    "gptoss": ("tiny-gptoss", None, {"n_layers": 2}, {}, False),
    "mla": ("tiny-mla", None, {}, {}, False),
    "mla_remat_packed": ("tiny-mla", None, {"remat": True}, {}, True),
    "deepseek": ("tiny-deepseek", None, {}, {"ema_decay": 0.9}, False),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_train_step_matches_jax(case):
    name, moe, over, train, packed = _CASES[case]
    state, m = step_parity(name, moe=moe, train=train, packed=packed, **over)
    if moe and moe.get("grouped_dropless"):
        assert float(m["moe_dropped_frac"]) == 0.0


def test_moe_aux_loss_reaches_the_router():
    """The router's balance and z terms are live in the graph: with their
    weights zeroed the aux loss is 0 and the router's gradient changes."""
    toks = torch.from_numpy(_rng("aux").integers(0, 256, size=(2, 17)))
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    grads = []
    for moe in (None, dict(router_aux_loss_weight=0.0,
                           router_z_loss_weight=0.0)):
        _, tc, _, tp = master("tiny-moe", moe=moe)
        cfg = TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=2)
        state = train_state_from_params(cfg, tp, tc)
        captured = {}
        state.params["layers"][0]["w_router"].register_hook(
            lambda g: captured.setdefault("g", g.clone()))
        _, m = make_train_step(tc, cfg, device=CPU)(state, batch)
        grads.append(captured["g"])
        assert (float(m["moe_aux_loss"]) == 0.0) == (moe is not None)
    assert not torch.allclose(grads[0], grads[1])


# --------------------------------------------- kernels 3 and 4 at 192

# (s, segment bounds or None, q heads over kv heads, window); v 128 wide
# padded to 192; H = Hkv as MLA, and a GQA case with a window (the bf16
# kernels take both at 192).
_BWD_192 = {
    "causal": (32, None, (2, 2), None),
    "segments": (32, (0, 11, 12, 32), (2, 2), None),
    "ragged_s37": (37, (0, 20, 37), (2, 2), None),
    "gqa_window": (32, None, (4, 2), 9),
}


@pytest.mark.parametrize("case", sorted(_BWD_192))
def test_flash_backward_at_192_matches_jax(case):
    s, bounds, (h, hkv), window = _BWD_192[case]
    rng = _rng("bwd192", case)
    b = 1
    q, k = _randn(rng, b, s, h, 192), _randn(rng, b, s, hkv, 192)
    v = np.pad(_randn(rng, b, s, hkv, 128), ((0, 0),) * 3 + ((0, 64),))
    w = _randn(rng, b, s, h, 192)  # the loss weights: sum(out * w)
    seg = None if bounds is None else _packed(b, s, bounds)
    jseg = None if seg is None else jnp.asarray(seg)

    def jloss(q, k, v):
        if s % 8 == 0:
            out = jfa.flash_attention(q, k, v, window=window, segments=jseg,
                                      block_q=32, block_k=32, interpret=True)
        else:
            out = jatt.attention_ref(q, k, v, causal=True, window=window,
                                     q_segments=jseg, kv_segments=jseg)
        return jnp.sum(out * jnp.asarray(w))

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = tfa.FlashAttentionFunction.apply(
        tq, tk, tv, None if seg is None else _t(seg), None, True,
        192 ** -0.5, window, None, tfa.PLAIN)
    (out * _t(w)).sum().backward()
    for name, g, jg in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                           want):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), err_msg=name,
                                   atol=2e-5, rtol=2e-5)
