"""The port's Checkpointer (`shellac_tpu_torch/training/checkpoint.py`)
on the CPU, case for case with the reference's checkpoint tests
(`tests/test_checkpoint_and_loop.py` `TestCheckpoint`,
`TestCheckpointIntegrity`): a TrainState's round trip (every leaf's bits
and dtype), an asynchronous save that snapshots the state when called,
restores across a mu_dtype change, max_to_keep and save_interval_steps,
the manifests and `verify`, quarantine and `fallback=True` with the
resilience series, the sweep of interrupted saves and orphan manifests, a
requested-structure mismatch, a re-quarantined step, `latest_step_on_disk`,
a step whose payload is gone, `mesh=` raising, one train step from a
restored state equal to one from the live state, and `--ckpt-dir` /
`--ema` through `cli.main`. Where the reference corrupts orbax files
(`training/chaos.py`), these tests damage the port's `state.pt` the same
ways: scrambled bytes of the same length, a deleted payload, a tampered
manifest, a backdated tmp directory.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import io
import json
import os
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from shellac_tpu_torch import cli
from shellac_tpu_torch.config import TrainConfig
from shellac_tpu_torch.inference.engine import Engine
from shellac_tpu_torch.models import transformer as tt
from shellac_tpu_torch.models.registry import get_model_config
from shellac_tpu_torch.obs import Registry, set_default_registry
from shellac_tpu_torch.training import init_train_state, make_train_step
from shellac_tpu_torch.training.checkpoint import (
    ITEM,
    TMP_DIR_MARKER,
    Checkpointer,
    abstract_train_state,
    latest_step_on_disk,
)
from shellac_tpu_torch.training.train_state import named_leaves

CPU = "cpu"


def _cfg():
    return get_model_config("tiny").replace(dtype="float32")


def _state(tcfg=None, seed=0, cfg=None):
    tcfg = tcfg or TrainConfig(warmup_steps=0)
    return init_train_state(cfg or _cfg(), tcfg, seed=seed, device=CPU)


def _leaves(state):
    out = [("step", state.step), ("count", state.opt_state.count)]
    for name in ("params", "ema_params"):
        out += [((name,) + p, x) for p, x in
                named_leaves(getattr(state, name) or {})]
    out += [(("mu",) + p, x) for p, x in named_leaves(state.opt_state.mu)]
    out += [(("nu",) + p, x) for p, x in named_leaves(state.opt_state.nu)]
    return out


def _assert_same(got, want):
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), path
        else:
            assert a == b, path


def _scramble(d, step):
    """Overwrite a step's payload with garbage of the same length."""
    path = os.path.join(d, str(step), ITEM)
    n = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.write(np.random.default_rng(0).integers(
            0, 256, size=n, dtype=np.uint8).tobytes())


def _tamper(d, step, **overrides):
    path = os.path.join(d, "manifests", f"{step}.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest.update(overrides)
    with open(path, "w") as f:
        json.dump(manifest, f)


def _debris(d, step, age_s=2 * 3600.0):
    path = os.path.join(d, f"{step}{TMP_DIR_MARKER}1234567890")
    os.makedirs(path)
    with open(os.path.join(path, ITEM), "wb") as f:
        f.write(b"PK")  # truncated on purpose
    old = time.time() - age_s
    os.utime(path, (old, old))
    return path


@pytest.fixture
def fresh_registry():
    """The process-wide registry swapped for this test's own."""
    reg = Registry()
    old = set_default_registry(reg)
    yield reg
    set_default_registry(old)


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        state = _state(TrainConfig(warmup_steps=0, ema_decay=0.9))
        state.step, state.opt_state.count = 7, 5
        ckpt = Checkpointer(str(tmp_path / "ckpt"))
        assert ckpt.save(7, state, wait=True)
        restored = ckpt.restore(device=CPU)
        _assert_same(restored, state)
        assert all(p.requires_grad for _, p in named_leaves(restored.params))
        ckpt.close()

    def test_async_save_snapshots_at_the_call(self, tmp_path,
                                              fresh_registry):
        """save() returns with the state copied: a later in-place update
        of the live state is not in the checkpoint, and the gauge moves
        only once the save has committed (at wait)."""
        state = _state()
        want = _state()
        ckpt = Checkpointer(str(tmp_path / "ckpt"))
        assert ckpt.save(1, state)
        with torch.no_grad():
            for _, p in named_leaves(state.params):
                p.add_(1.0)
        assert fresh_registry.value("shellac_train_last_good_step") is None
        ckpt.wait()
        assert fresh_registry.value("shellac_train_last_good_step") == 1
        _assert_same(ckpt.restore(device=CPU), want)

    def test_restore_across_mu_dtype_change(self, tmp_path):
        """A checkpoint written with fp32 mu restores under a bf16-mu
        request: saved dtypes are cast to the requested ones."""
        cfg = _cfg()
        old = TrainConfig(warmup_steps=0, mu_dtype="float32")
        state = _state(old)
        ckpt = Checkpointer(str(tmp_path / "ckpt"))
        ckpt.save(0, state, wait=True)
        new = TrainConfig(warmup_steps=0, mu_dtype="bfloat16")
        abstract = abstract_train_state(cfg, new)
        restored = ckpt.restore(abstract_state=abstract, device=CPU)
        for (_, want), (_, got) in zip(named_leaves(abstract.opt_state.mu),
                                       named_leaves(restored.opt_state.mu)):
            assert got.dtype == want.dtype == torch.bfloat16
        for (_, a), (_, b) in zip(named_leaves(state.params),
                                  named_leaves(restored.params)):
            assert torch.equal(a, b)

    def test_restore_missing_raises(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path / "empty"))
        with pytest.raises(FileNotFoundError):
            ckpt.restore(device=CPU)

    def test_max_to_keep_and_interval(self, tmp_path):
        d = str(tmp_path / "ck")
        state = _state()
        ckpt = Checkpointer(d, max_to_keep=2, save_interval_steps=2)
        saved = [s for s in range(1, 8) if ckpt.save(s, state, wait=True)]
        # The first save, then every second step.
        assert saved == [1, 2, 4, 6]
        assert ckpt.all_steps() == [4, 6]
        # The manifests of the steps max_to_keep deleted stay until a
        # construction finds them orphaned past DEBRIS_TTL_S.
        mdir = os.path.join(d, "manifests")
        assert sorted(os.listdir(mdir)) == [
            "1.json", "2.json", "4.json", "6.json"]
        old = time.time() - 2 * 3600.0
        for name in os.listdir(mdir):
            os.utime(os.path.join(mdir, name), (old, old))
        ckpt = Checkpointer(d, max_to_keep=2, save_interval_steps=2)
        assert sorted(os.listdir(mdir)) == ["4.json", "6.json"]
        assert not ckpt.save(6, state)  # already saved
        assert not ckpt.save(5, state)  # below the latest
        assert ckpt.save(5, state, force=True, wait=True)
        assert ckpt.all_steps() == [5, 6]

    def test_mesh_raises(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path / "ck"))
        with pytest.raises(NotImplementedError, match="mesh"):
            ckpt.restore(mesh=object(), device=CPU)


class TestCheckpointIntegrity:
    """The manifest / verify / quarantine / fallback-restore contract."""

    def _saved(self, tmp_path, steps=(1, 2, 3)):
        state = _state()
        d = str(tmp_path / "ck")
        ckpt = Checkpointer(d, max_to_keep=len(steps) + 2)
        for s in steps:
            ckpt.save(s, state, wait=True)
        return d, ckpt, state, abstract_train_state(
            _cfg(), TrainConfig(warmup_steps=0))

    def test_manifest_roundtrip_and_verify(self, tmp_path):
        d, ckpt, _, _ = self._saved(tmp_path)
        for s in (1, 2, 3):
            assert os.path.exists(os.path.join(d, "manifests", f"{s}.json"))
            assert ckpt.verify(s) is None
        assert ckpt.verify(99) is not None

    def test_verify_rejects_tampered_manifest(self, tmp_path):
        d, ckpt, _, _ = self._saved(tmp_path)
        _tamper(d, 2, leaf_count=999)
        assert "leaf count" in ckpt.verify(2)
        _tamper(d, 3, tree_digest="deadbeef")
        assert ckpt.verify(3) is not None
        assert ckpt.verify(1) is None

    def test_fallback_quarantines_corrupt_latest(self, tmp_path,
                                                 fresh_registry):
        d, ckpt, state, abstract = self._saved(tmp_path)
        _scramble(d, 3)
        restored = ckpt.restore(abstract_state=abstract, fallback=True,
                                device=CPU)
        _assert_same(restored, state)
        assert ckpt.latest_step() == 2
        assert os.path.isdir(os.path.join(d, "3.corrupt"))
        assert os.path.exists(os.path.join(d, "3.corrupt",
                                           "QUARANTINE.json"))
        assert fresh_registry.value(
            "shellac_train_ckpt_quarantined_total") == 1
        assert fresh_registry.value(
            "shellac_train_ckpt_fallback_restores_total") == 1
        assert fresh_registry.value("shellac_train_last_good_step") == 2
        ckpt2 = Checkpointer(d)
        assert ckpt2.latest_step() == 2
        assert ckpt2.verify(3) is not None

    def test_fallback_exhausted_raises(self, tmp_path, fresh_registry):
        d, ckpt, _, abstract = self._saved(tmp_path, steps=(1, 2))
        _scramble(d, 1)
        _scramble(d, 2)
        with pytest.raises(FileNotFoundError, match="no intact"):
            ckpt.restore(abstract_state=abstract, fallback=True, device=CPU)
        assert fresh_registry.value(
            "shellac_train_ckpt_quarantined_total") == 2

    def test_startup_sweep_removes_interrupted_save_debris(self, tmp_path):
        d, ckpt, _, _ = self._saved(tmp_path)
        debris = _debris(d, 9)
        orphan = os.path.join(d, "manifests", "7.json")
        with open(orphan, "w") as f:
            f.write("{}")
        old = time.time() - 2 * 3600
        os.utime(orphan, (old, old))
        # Young debris may be a concurrent process's live save.
        live = _debris(d, 11, age_s=0.0)
        ckpt2 = Checkpointer(d)
        assert not os.path.exists(debris)
        assert not os.path.exists(orphan)
        assert os.path.exists(live)
        assert ckpt2.latest_step() == 3
        assert ckpt2.verify(3) is None

    def test_request_mismatch_raises_instead_of_quarantining(
            self, tmp_path, fresh_registry):
        d, ckpt, _, _ = self._saved(tmp_path, steps=(1, 2))
        other = _cfg().replace(d_model=128, vocab_size=512)
        bad = abstract_train_state(other, TrainConfig(warmup_steps=0))
        with pytest.raises(ValueError, match="does not match"):
            ckpt.restore(abstract_state=bad, fallback=True, device=CPU)
        with pytest.raises(ValueError, match="does not match"):
            ckpt.restore(abstract_state=bad, device=CPU)
        assert ckpt.latest_step() == 2
        assert ckpt.verify(2) is None
        assert not os.path.isdir(os.path.join(d, "2.corrupt"))
        assert not fresh_registry.value(
            "shellac_train_ckpt_quarantined_total")

    def test_requarantine_of_resaved_step_gets_unique_name(
            self, tmp_path, fresh_registry):
        d, ckpt, state, abstract = self._saved(tmp_path, steps=(1, 2))
        _scramble(d, 2)
        ckpt.restore(abstract_state=abstract, fallback=True, device=CPU)
        assert os.path.isdir(os.path.join(d, "2.corrupt"))
        assert ckpt.save(2, state, wait=True)
        assert ckpt.latest_step() == 2
        _scramble(d, 2)
        ckpt.restore(abstract_state=abstract, fallback=True, device=CPU)
        assert ckpt.latest_step() == 1
        assert os.path.isdir(os.path.join(d, "2.corrupt.2"))
        assert Checkpointer(d).latest_step() == 1

    def test_latest_step_on_disk(self, tmp_path):
        assert latest_step_on_disk(str(tmp_path / "nope")) is None
        d, _, _, _ = self._saved(tmp_path)
        assert latest_step_on_disk(d) == 3
        os.rename(os.path.join(d, "3"), os.path.join(d, "3.corrupt"))
        _debris(d, 9)
        assert latest_step_on_disk(d) == 2

    def test_structural_corruption_surfaces_original_error(self, tmp_path):
        """A step whose payload is gone raises the load's own error, not
        one from the dtype probe."""
        d, ckpt, _, abstract = self._saved(tmp_path, steps=(1,))
        os.remove(os.path.join(d, "1", ITEM))
        with pytest.raises(FileNotFoundError, match=ITEM):
            ckpt.restore(1, abstract_state=abstract, device=CPU)


def test_step_after_restore_equals_the_live_step(tmp_path):
    """One train step from a restored state is bit-equal to one step from
    the state that was saved."""
    cfg = _cfg()
    tcfg = TrainConfig(warmup_steps=0, learning_rate=1e-2)
    step_fn = make_train_step(cfg, tcfg, device=CPU)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    batch = {"inputs": tokens, "targets": tokens}
    live, _ = step_fn(_state(tcfg, seed=4), batch)
    ckpt = Checkpointer(str(tmp_path / "ck"))
    ckpt.save(1, live, wait=True)
    restored = ckpt.restore(abstract_state=abstract_train_state(cfg, tcfg),
                            device=CPU)
    a, ma = step_fn(live, batch)
    b, mb = step_fn(restored, batch)
    assert float(ma["loss"]) == float(mb["loss"])
    _assert_same(b, a)


def test_cli_ckpt_dir_and_ema(tmp_path):
    """`generate --ckpt-dir` serves the newest step's weights, and
    `--ema` its EMA weights: Engine's tokens on each, in serving
    storage."""
    cfg = get_model_config("tiny")
    tcfg = TrainConfig(warmup_steps=0, ema_decay=0.5)
    state = init_train_state(cfg, tcfg, seed=2, device=CPU)
    state.ema_params = tt.init_params(cfg, seed=9, device=CPU, master=True)
    d = str(tmp_path / "ck")
    Checkpointer(d).save(3, state, wait=True)
    for flag, tree in (([], state.params), (["--ema"], state.ema_params)):
        buf = io.StringIO()
        with redirect_stdout(buf):
            cli.main(["generate", "--device", CPU, "--ckpt-dir", d,
                      "--prompt", "1,2,3", "--max-new", "5",
                      "--temperature", "0", *flag])
        serving = {k: tt.to_storage(cfg, k, v.detach())
                   for k, v in tree.items() if k != "layers"}
        serving["layers"] = [{n: tt.to_storage(cfg, n, t.detach())
                              for n, t in lp.items()}
                             for lp in tree["layers"]]
        want = Engine(cfg, serving, temperature=0.0, device=CPU).generate(
            torch.tensor([[1, 2, 3]]), max_new_tokens=5)
        assert json.loads(buf.getvalue())["tokens"] == \
            want.tokens[0].tolist(), flag
    # A checkpoint without EMA weights refuses --ema.
    plain = str(tmp_path / "plain")
    Checkpointer(plain).save(1, _state(cfg=cfg), wait=True)
    with pytest.raises(SystemExit, match="EMA"):
        cli.main(["generate", "--device", CPU, "--ckpt-dir", plain,
                  "--prompt", "1", "--ema"])


# ---- the reference's decisions, scenario for scenario ----------------


class _Side:
    """One Checkpointer (the reference's over orbax, or the port's) with
    its own state, abstract state and obs registry, driven through the
    same calls."""

    SERIES = ("shellac_train_ckpt_quarantined_total",
              "shellac_train_ckpt_fallback_restores_total",
              "shellac_train_last_good_step")

    def __init__(self, ref, root, **kw):
        self.ref, self.root = ref, root
        if ref:
            from shellac_tpu.obs import Registry as JRegistry
            from shellac_tpu.obs import set_default_registry as jset
            from shellac_tpu.training.checkpoint import Checkpointer as JCk

            self.registry, self._set = JRegistry(), jset
            state = _jax_state()
            self._state = lambda s: state.__class__(
                step=state.step * 0 + s, params=state.params,
                opt_state=state.opt_state, ema_params=state.ema_params)
            self._abstract = _jax_abstract
            self._make = JCk
        else:
            self.registry, self._set = Registry(), set_default_registry
            state = _state()

            def at(s):
                state.step = s
                return state

            self._state = at
            self._abstract = lambda over: abstract_train_state(
                _cfg().replace(**over), TrainConfig(warmup_steps=0))
            self._make = Checkpointer
        self.old = self._set(self.registry)
        self.ck = self._make(root, **kw)

    def reopen(self, **kw):
        self.ck.close()
        self.ck = self._make(self.root, **kw)

    def save(self, step, **kw):
        return bool(self.ck.save(step, self._state(step), wait=True, **kw))

    def restore(self, step=None, other=False, **kw):
        """The landed step; `other` asks for a wider model's state."""
        kw["abstract_state"] = self._abstract(
            dict(d_model=128, vocab_size=512) if other else {})
        if not self.ref:
            kw["device"] = CPU
        return int(self.ck.restore(step, **kw).step)

    def series(self):
        return {s: self.registry.value(s) for s in self.SERIES}

    def corrupt_dirs(self):
        return sorted(n for n in os.listdir(self.root) if "corrupt" in n)

    def close(self):
        self.ck.close()
        self._set(self.old)


_JAX_STATE = []


def _jax_abstract(over=None):
    """The reference's TrainState of `tiny` in fp32 (with `over` on its
    config), as shapes and dtypes."""
    import jax

    from shellac_tpu.config import TrainConfig as JTrainConfig
    from shellac_tpu.models.registry import get_model_config as jcfg
    from shellac_tpu.training import init_train_state as jinit

    return jax.eval_shape(lambda: jinit(
        jcfg("tiny").replace(dtype="float32", **(over or {})),
        JTrainConfig(warmup_steps=0), jax.random.PRNGKey(0)))


def _jax_state():
    """A reference TrainState to save, made once: zeros in its
    structure (what the Checkpointer decides depends on the structure
    alone), so no initializer is compiled."""
    if not _JAX_STATE:
        import jax
        import jax.numpy as jnp

        _JAX_STATE.append(jax.tree.map(
            lambda a: jnp.zeros(a.shape, a.dtype), _jax_abstract()))
    return _JAX_STATE[0]


def _outcome(fn):
    """fn()'s value, or its error's type and message."""
    try:
        return fn()
    except Exception as e:
        return type(e).__name__, str(e)


def _scenario_interval(side, chaos):
    out = [(s, force, side.save(s, force=force), side.ck.all_steps(),
            latest_step_on_disk(side.root))
           for s, force in ((1, False), (2, False), (3, False), (4, False),
                            (4, False), (3, False), (5, True), (6, False),
                            (7, False), (8, False), (9, True))]
    out.append(sorted(os.listdir(os.path.join(side.root, "manifests"))))
    return out


def _saved(side, steps=(1, 2, 3)):
    for s in steps:
        side.save(s)


def _scenario_scramble_newest(side, chaos):
    _saved(side)
    chaos.scramble_step(side.root, 3)
    landed = side.restore(fallback=True)
    out = [landed, side.ck.all_steps(), side.ck.verify(3),
           side.ck.verify(2), side.corrupt_dirs(), side.series()]
    side.reopen()
    return out + [side.ck.latest_step(), side.ck.verify(3) is not None]


def _scenario_tampered_digest(side, chaos):
    _saved(side)
    chaos.tamper_manifest(side.root, 3, tree_digest="deadbeef")
    reason = side.ck.verify(3)
    return [reason, side.restore(fallback=True), side.corrupt_dirs(),
            side.series()]


def _scenario_rotten_manifest(side, chaos):
    _saved(side)
    with open(os.path.join(side.root, "manifests", "3.json"), "w") as f:
        f.write("{")
    return [side.ck.verify(3), side.restore(fallback=True),
            side.corrupt_dirs(), side.series()]


def _scenario_exhausted(side, chaos):
    _saved(side, (1, 2, 3))
    for s in (1, 2):
        chaos.scramble_step(side.root, s)
    return [_outcome(lambda: side.restore(2, fallback=True)),
            side.ck.all_steps(), side.corrupt_dirs(), side.series()]


def _scenario_mismatch(side, chaos):
    _saved(side, (1, 2))
    return [_outcome(lambda: side.restore(other=True, fallback=True)),
            # Without the walk, orbax's own error: its type only.
            _outcome(lambda: side.restore(other=True))[0],
            side.ck.all_steps(), side.ck.verify(2), side.corrupt_dirs(),
            side.series()]


def _scenario_requarantine(side, chaos):
    _saved(side, (1, 2))
    chaos.scramble_step(side.root, 2)
    out = [side.restore(fallback=True), side.save(2), side.ck.latest_step()]
    chaos.scramble_step(side.root, 2)
    out += [side.restore(fallback=True), side.corrupt_dirs(), side.series()]
    side.reopen()
    return out + [side.ck.latest_step()]


def _scenario_empty(side, chaos):
    return [_outcome(lambda: side.restore()),
            _outcome(lambda: side.restore(fallback=True)), side.series()]


SCENARIOS = {
    "interval": (_scenario_interval,
                 dict(max_to_keep=2, save_interval_steps=2)),
    "scramble_newest": (_scenario_scramble_newest, dict(max_to_keep=5)),
    "tampered_digest": (_scenario_tampered_digest, dict(max_to_keep=5)),
    "rotten_manifest": (_scenario_rotten_manifest, dict(max_to_keep=5)),
    "exhausted": (_scenario_exhausted, dict(max_to_keep=5)),
    "mismatch": (_scenario_mismatch, dict(max_to_keep=5)),
    "requarantine": (_scenario_requarantine, dict(max_to_keep=5)),
    "empty": (_scenario_empty, {}),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_decisions_match_reference(tmp_path, scenario):
    """The reference's Checkpointer (orbax) and the port's through the
    same calls: which saves are taken, which steps stand, which step a
    fallback lands on, which are quarantined and under what name, the
    reasons and error messages (the directory's name aside) and the
    shellac_train_* series."""
    from shellac_tpu.training import chaos

    fn, kw = SCENARIOS[scenario]
    got = {}
    for ref in (True, False):
        root = str(tmp_path / ("ref" if ref else "port"))
        side = _Side(ref, root, **kw)
        try:
            got[ref] = json.loads(json.dumps(fn(side, chaos)).replace(
                root, "<dir>"))
        finally:
            side.close()
    assert got[False] == got[True]
