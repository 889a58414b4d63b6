"""The train step's options against the JAX package, on the CPU: the int8
training dots, the fused (vocab-chunked) loss and its fallbacks, the
remat policies, and the lion, adafactor and muon chains.

  - `ops/qtrain.py` against `shellac_tpu/ops/qtrain.py` (values and both
    backward rules), and three steps with TrainConfig.quant "int8" and
    "int8_bwd" against the jitted JAX step;
  - `fused_cross_entropy` against the reference's (loss and gradients),
    and three steps with fused_loss_chunk against the JAX step, where it
    applies (tiny, 256 = 4 x 64) and where the reference falls back to
    the unfused loss (a logit softcap; a chunk that does not divide the
    vocab);
  - remat "dots" and "dots_no_batch": the same gradients as "none", and
    fewer matmuls recomputed in the backward (they keep different
    tensors);
  - lion, adafactor and muon: three updates against the jitted optax
    update on the same gradients, over trees whose matrices are 128 wide
    or more (adafactor factors only dims of at least 128), with stacked
    expert leaves, MLA's (r, h, dh) expansions and 1-D leaves.

Tolerances: the qtrain dots atol 1e-5 relative to the output's scale
(the quantization rounds the same fp32 values on both sides; the int32
sums are exact); the fused loss rtol 1e-6 and its gradients atol 1e-6;
the train steps as tests/test_torch_train_families.py holds them; the
remat gradients bit-equal; the optimizer chains as
tests/test_torch_training.py holds adamw (params atol 1e-6 + rtol 1e-5,
all but 0.5% of a leaf, each element within 2 lr 2^-7; the moments in
bf16 within 3 bf16 ulps or 2^-8 of the leaf's scale); lion's sign may flip in at most 1e-5 of the
elements (an error of 2 lr each); the int8 train steps as their
docstrings say (a rounding on the other side of a half moves a product
by a quantum).
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from shellac_tpu.config import TrainConfig as JTrainConfig
from shellac_tpu.training.losses import (
    fused_cross_entropy as j_fused_cross_entropy,
)
from shellac_tpu.training.optimizer import make_optimizer as j_make_optimizer
from shellac_tpu_torch.config import TrainConfig
from shellac_tpu_torch.models import transformer as tt
from shellac_tpu_torch.ops import qtrain
from shellac_tpu_torch.training import (
    cross_entropy,
    fused_cross_entropy,
    named_leaves,
    opt_update,
    train_state_from_params,
)
from test_torch_train_families import jax_leaf, master, step_parity
from test_torch_training import (
    _assert_params_close,
    _randn,
    _rng,
    _t,
)

jq = importlib.import_module("shellac_tpu.ops.qtrain")
CPU = "cpu"


# ------------------------------------------------------ int8 training dots


@pytest.mark.parametrize("kind", ["int8", "int8_bwd"])
def test_quant_dot_matches_jax(kind):
    rng = _rng("qdot", kind)
    x, w, g = (_randn(rng, 3, 24, 64), _randn(rng, 64, 40, scale=0.1),
               _randn(rng, 3, 24, 40))
    x[0, 0] = 0.0  # an all-zero row takes scale 1, as in the reference
    jout, vjp = jax.vjp(lambda a, b: jq.quant_dot(a, b, kind),
                        jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    out = qtrain.quant_dot(tx, tw, kind)
    dx, dw = torch.autograd.grad(out, (tx, tw), _t(g))
    for got, want in ((out, jout), (dx, jdx), (dw, jdw)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    # The forward is not the unquantized product.
    assert not torch.allclose(out, tx @ tw, atol=1e-6)
    with pytest.raises(ValueError, match="quant_training"):
        qtrain.quant_dot(tx, tw, "fp8")


def test_quant_train_step_matches_jax():
    """int8: the params after the first update (the warmup's first step
    has lr 0) to the fp32 rule, then three steps' metrics.

    An int8 rounding that lands the other side of a half between the
    packages (their fp32 inputs differ in summation order) moves a
    product by one quantum, amax / 127 of its row: once the params have
    moved by an update, such flips appear, and adam turns a gradient
    element near zero that a flip moves into a difference of up to lr
    in its update. So past the first update the metrics are held to
    1e-3, and the params are not held."""
    step_parity("tiny", train={"quant": "int8"}, steps=2)
    step_parity("tiny", train={"quant": "int8"}, metric_rtol=1e-3,
                check_params=False)


def test_quant_bwd_train_step_matches_jax():
    """int8_bwd quantizes the gradients too, each row or channel to 127
    levels; the flips of `test_quant_train_step_matches_jax` then appear
    from the first backward (gradients at equal params agree to about
    0.5%, test_quant_dot_matches_jax holds the dots themselves): three
    steps' metrics to 5e-3."""
    step_parity("tiny", train={"quant": "int8_bwd"}, metric_rtol=5e-3,
                check_params=False)


def test_quant_leaves_the_model_config_alone():
    """quant applies to the step only, as the reference's replace does;
    the projections' int8 dots show in the counts of aten._int_mm."""
    _, tc, _, tp = master("tiny")
    cfg = TrainConfig(quant="int8", warmup_steps=1)
    state = train_state_from_params(cfg, tp, tc)
    from shellac_tpu_torch.training import make_train_step

    toks = torch.from_numpy(_rng("q").integers(0, 256, size=(2, 17)))
    with _Count() as c:
        make_train_step(tc, cfg, device=CPU)(
            state, {"inputs": toks[:, :-1], "targets": toks[:, 1:]})
    assert tc.quant_training is None
    # 7 projections a layer (q, k, v, o, gate, up, down), 2 layers.
    assert c.counts.get("_int_mm", 0) == 14


# ---------------------------------------------------------- the fused loss


@pytest.mark.parametrize("masked,z", [(False, 0.0), (True, 1e-3)])
def test_fused_cross_entropy_matches_jax(masked, z):
    rng = _rng("fused", masked, z)
    h, w = _randn(rng, 2, 9, 32), _randn(rng, 32, 96, scale=0.3)
    tgt = rng.integers(0, 96, size=(2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) > 0.3).astype(np.float32) if masked else None

    def jloss(a, b):
        return j_fused_cross_entropy(
            a, b, jnp.asarray(tgt), None if mask is None else
            jnp.asarray(mask), z, vocab_chunk=32)[0]

    jl, (jdh, jdw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th, tw = _t(h).requires_grad_(), _t(w).requires_grad_()
    tmask = None if mask is None else _t(mask)
    loss, m = fused_cross_entropy(th, tw, _t(tgt), tmask, z, vocab_chunk=32)
    dh, dw = torch.autograd.grad(loss, (th, tw))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), atol=1e-6)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), atol=1e-6)
    # ... and the unfused loss on the whole logits.
    ref, _ = cross_entropy(th.detach() @ tw.detach(), _t(tgt), tmask, z)
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-6)
    assert set(m) == {"loss", "perplexity", "tokens"}
    with pytest.raises(ValueError, match="divisible"):
        fused_cross_entropy(th, tw, _t(tgt), vocab_chunk=40)


# (preset, chunk, model fields): the chunk divides the vocab; the two
# fallbacks to the unfused loss (a logit softcap; 256 % 96 != 0).
_FUSED = {
    "tiny_chunk64": ("tiny", 64, {}),
    "gemma2_softcap_falls_back": ("tiny-gemma2", 64, {"n_layers": 2}),
    "indivisible_falls_back": ("tiny", 96, {}),
}


@pytest.mark.parametrize("case", sorted(_FUSED))
def test_fused_loss_train_step_matches_jax(case):
    name, chunk, over = _FUSED[case]
    step_parity(name, train={"fused_loss_chunk": chunk}, **over)


def test_fused_loss_step_never_builds_the_logits():
    """With the fused loss, no tensor of the (N, V) logits' size is made
    in the step: the largest vocab-wide product is one chunk."""
    _, tc, _, tp = master("tiny", d_ff=192)
    cfg = TrainConfig(fused_loss_chunk=64, warmup_steps=1)
    state = train_state_from_params(cfg, tp, tc)
    from shellac_tpu_torch.training import make_train_step

    toks = torch.from_numpy(_rng("f").integers(0, 256, size=(2, 17)))
    with _Count() as c:
        make_train_step(tc, cfg, device=CPU)(
            state, {"inputs": toks[:, :-1], "targets": toks[:, 1:]})
    assert c.widest_mm == 192 < tc.vocab_size and c.counts["mm"] > 0


# ------------------------------------------------------- remat policies


class _Count(TorchDispatchMode):
    """Counts the aten ops dispatched (by name) and the widest mm output's
    last dim."""

    def __init__(self):
        super().__init__()
        self.counts = {}
        self.widest_mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.counts[name] = self.counts.get(name, 0) + 1
        out = func(*args, **(kwargs or {}))
        if name == "mm":
            self.widest_mm = max(self.widest_mm, out.shape[-1])
        return out


def _remat_grads(policy):
    _, tc, _, tp = master("tiny-moe", remat=True, remat_policy=policy)
    for _, p in named_leaves(tp):
        p.requires_grad_(True)
    toks = torch.from_numpy(_rng("remat").integers(0, 256, size=(2, 17)))
    logits = tt.forward(tc, tp, toks[:, :-1], device=CPU)
    loss, _ = cross_entropy(logits, toks[:, 1:])
    ps = [p for _, p in named_leaves(tp)]
    with _Count() as c:
        grads = torch.autograd.grad(loss, ps)
    return grads, c.counts


def test_remat_policies_keep_the_gradients_and_save_differently():
    """tiny-moe over the capacity buckets (batched expert products) and
    the plain attention (batched einsums): "dots" keeps every matmul's
    output, "dots_no_batch" the projections only, "none" nothing; so the
    backward recomputes fewer products under each, and the gradients are
    bit-equal."""
    grads, mms = {}, {}
    for policy in ("none", "dots", "dots_no_batch"):
        grads[policy], counts = _remat_grads(policy)
        mms[policy] = {k: counts.get(k, 0) for k in ("mm", "bmm")}
    for policy in ("dots", "dots_no_batch"):
        for a, b in zip(grads["none"], grads[policy]):
            assert torch.equal(a, b), policy
    total = {p: sum(v.values()) for p, v in mms.items()}
    assert total["none"] > total["dots_no_batch"] > total["dots"], mms
    # The projections (mm) are kept by both; the batched products (bmm)
    # only by "dots".
    assert mms["dots"]["mm"] == mms["dots_no_batch"]["mm"] < mms["none"]["mm"]
    assert mms["dots"]["bmm"] < mms["dots_no_batch"]["bmm"] \
        == mms["none"]["bmm"]


def test_remat_saves_follows_the_reference_policies():
    x = torch.zeros(1, 4, 4)
    xb = torch.zeros(3, 4, 4)
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert tt.remat_saves("dots", mm, (x[0], x[0]))
    assert tt.remat_saves("dots_no_batch", mm, (x[0], x[0]))
    assert tt.remat_saves("dots", bmm, (xb, xb))
    assert not tt.remat_saves("dots_no_batch", bmm, (xb, xb))
    assert tt.remat_saves("dots_no_batch", bmm, (x, x))  # batch-free einsum
    assert not tt.remat_saves("dots", torch.ops.aten.add.Tensor, (x, x))
    with pytest.raises(ValueError, match="remat_policy"):
        tt._remat_context("all")


# ------------------------------------------------- lion, adafactor, muon


def _jax_tree_grads(rng, jp, scale):
    g = jax.tree.map(lambda a: _randn(rng, *a.shape), jp)
    norm = np.sqrt(sum(float(np.sum(np.square(x)))
                       for x in jax.tree.leaves(g)))
    return jax.tree.map(lambda x: x * (scale / norm), g)


# (optimizer, preset, model fields): d_model 128 so adafactor factors the
# projections (its rule needs two dims of at least 128); tiny-moe's
# stacked experts (L, E, 128, F) and tiny-mla's (r, h, dh) expansions.
_OPT = {
    "lion_moe": ("lion", "tiny-moe", {}),
    "adafactor_moe": ("adafactor", "tiny-moe", {}),
    "adafactor_mla": ("adafactor", "tiny-mla", {}),
    "muon_moe": ("muon", "tiny-moe", {}),
    "muon_mla": ("muon", "tiny-mla", {}),
}


@pytest.mark.parametrize("case", sorted(_OPT))
def test_optimizer_chain_matches_optax(case):
    opt_name, name, over = _OPT[case]
    jc, tc, jp, tp = master(name, d_model=128, **over)
    kw = dict(optimizer=opt_name, learning_rate=1e-2, warmup_steps=2,
              total_steps=10)
    cfg, jcfg = TrainConfig(**kw), JTrainConfig(**kw)
    opt = j_make_optimizer(jcfg)
    jupdate = jax.jit(opt.update)
    jparams = jax.tree.map(jnp.asarray, jp)
    jstate = opt.init(jparams)
    state = train_state_from_params(cfg, tp, tc)
    prefixes = tt.stack_prefixes(tc)
    rng = _rng("opt", case)
    for total in (40.0, 0.5, 0.8):  # the first clipped, the others not
        jg = _jax_tree_grads(rng, jp, total)
        upd, jstate = jupdate(jax.tree.map(jnp.asarray, jg), jstate,
                              jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, upd)
        grads = [_t(jax_leaf(jg, path, tc)).clone()
                 for path, _ in named_leaves(state.params)]
        state.opt_state = opt_update(cfg, state.params, grads,
                                     state.opt_state, prefixes=prefixes)
    assert state.opt_state.count == 3
    jparams = jax.tree.map(np.asarray, jparams)
    flips = size = 0
    for path, p in named_leaves(state.params):
        got, want = p.detach().numpy(), jax_leaf(jparams, path, tc)
        if opt_name == "lion":
            # lion's update is lr * sign(.): where the sign's argument
            # sits within an ulp of 0 the packages may take opposite
            # signs, an error of 2 lr in that element.
            err = np.abs(got - want)
            flip = err > 2 * cfg.learning_rate * 2 ** -7
            assert err.max() <= 2.0001 * cfg.learning_rate, (case, path)
            flips += int(flip.sum())
            size += flip.size
            got = np.where(flip, want, got)
        _assert_params_close(got, want, 1e-6, 1e-5, cfg.learning_rate,
                             0.005, (case, path))
    assert flips <= 1e-5 * max(size, 1), flips
    if opt_name == "lion":
        for path, mu in named_leaves(state.opt_state.mu):
            jmu = jax_leaf(jax.tree.map(np.asarray, jstate[1].mu), path, tc)
            assert mu.dtype == torch.bfloat16
            # 3 bf16 ulps, or where the moment cancels to near zero one
            # bf16 rounding (2^-8) of the leaf's scale: it sums terms each
            # rounded to bf16 at its own size.
            jmu = jmu.astype(np.float32)
            np.testing.assert_allclose(
                mu.float().numpy(), jmu, rtol=3 * 2 ** -7,
                atol=2 ** -8 * np.abs(jmu).max(), err_msg=str(path))
    if opt_name == "adafactor":
        # The factored leaves are the ones both packages factor.
        jv = jax.tree.map(np.asarray, jstate[1].v_row)
        factored = 0
        for path, row in named_leaves(state.opt_state.v_row):
            stacked = jv["layers"][path[2]] if path[0] == "layers" \
                else jv[path[0]]
            if stacked.shape == (1,):  # unfactored in the reference
                assert row.shape == (1,), path
                continue
            want = stacked[path[1]] if path[0] == "layers" else stacked
            np.testing.assert_allclose(row.numpy(), want, rtol=1e-5,
                                       atol=1e-12, err_msg=str(path))
            factored += 1
        assert factored > 0


def test_muon_and_adafactor_masks_follow_the_stacked_layout():
    from shellac_tpu.training.optimizer import _muon_mask

    from shellac_tpu_torch.training.optimizer import muon_dims

    jc, tc, jp, tp = master("tiny-deepseek", d_model=128)
    labels = _muon_mask(jax.tree.map(jnp.asarray, jp))
    prefixes = tt.stack_prefixes(tc)
    seen = set()
    for path, p in named_leaves(tp):
        if path[0] == "layers":
            k = tc.first_k_dense
            stack = labels["layers"]["dense" if path[1] < k else "moe"]
            want = stack[path[2]]
        else:
            want = labels[path[0]]
        got = "muon" if muon_dims(path, p, prefixes) is not None else "adamw"
        assert got == want, path
        seen.add(got)
    assert seen == {"muon", "adamw"}
    # A 1-D leaf of an interleaved dense stack (G, moe_every - 1, d) is a
    # muon matrix across layers in the reference: the port refuses it.
    _, ti, _, tpi = master("tiny-moe", moe_every=2, n_layers=4)
    with pytest.raises(NotImplementedError, match="span the layer stack"):
        muon_dims(("layers", 0, "attn_norm"), tpi["layers"][0]["attn_norm"],
                  tt.stack_prefixes(ti))
