"""The port's training loop and its periphery against the JAX package, on
the CPU: `fit` (steps, checkpoints, a resume, a sentinel rollback), the
anomaly sentinel, the data pipeline (the token shard format both ways,
the batch samplers, document packing, `device_prefetch`), evaluation,
the metrics logger and step timer, and the `train`, `eval` and
`tokenize` commands run in process.

Both packages start from the same weights: the port's `fit` and `train`
draw their init from `init_train_state`, which the tests replace with
the JAX package's init (`tests/jax_params.py`, the JAX `fit`'s
`PRNGKey(train_cfg.seed)` draw) through `params_from_jax(...,
master=True)`. Everything runs in fp32 on the tiny preset.

Tolerances: losses rtol 2e-5 at every logged step; params after N steps
by `_assert_params_close` (atol 2e-5 of each leaf's max-abs, all but 0.5%
of a leaf, each element within 2 lr 2^-7; tests/test_torch_training.py's
note); a resumed or rolled-back run against the port's unfaulted run:
bit-equal.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import importlib
import json

import jax
import numpy as np
import pytest
import torch

import jax_params
from shellac_tpu import cli as jcli
from shellac_tpu.config import TrainConfig as JTrainConfig
from shellac_tpu.models.registry import get_model_config as jget
from shellac_tpu.training import data as jdata
from shellac_tpu.training.loop import fit as jfit
from shellac_tpu.training.resilience import AnomalySentinel as JSentinel
from shellac_tpu.utils import metrics as jmetrics
from shellac_tpu_torch import cli
from shellac_tpu_torch.config import TrainConfig
from shellac_tpu_torch.models.from_jax import params_from_jax
from shellac_tpu_torch.models.registry import get_model_config
from shellac_tpu_torch.training import (
    data,
    evaluate,
    loop,
    named_leaves,
    resilience,
    train_state_from_params,
)
from shellac_tpu_torch.utils import metrics, tracing
from shellac_tpu_torch.utils.failure import RestartBudget
from test_torch_train_families import jax_leaf
from test_torch_training import _assert_params_close

# The module, not the function of the same name that the package
# re-exports.
jevaluate = importlib.import_module("shellac_tpu.training.evaluate")
CPU = "cpu"
TRAIN = dict(learning_rate=1e-2, warmup_steps=2, total_steps=6,
             mu_dtype="float32", seed=3)


def _configs():
    return (jget("tiny").replace(dtype="float32"),
            get_model_config("tiny").replace(dtype="float32"))


@pytest.fixture
def jax_init(monkeypatch):
    """The port's fit starts from the JAX fit's init (same seed)."""
    jc, tc = _configs()

    def init(model_cfg, train_cfg, seed=0, device=None):
        p = jax_params.init_params(jc, seed)
        return train_state_from_params(
            train_cfg, params_from_jax(model_cfg, p, device, master=True),
            model_cfg)

    monkeypatch.setattr(loop, "init_train_state", init)
    return jc, tc


def _corpus(seed=0, n=4096, vocab=256):
    rng = np.random.default_rng(seed)
    base = np.arange(n, dtype=np.int32) % 97
    noise = rng.integers(0, vocab, size=n)
    return np.where(rng.random(n) < 0.1, noise, base).astype(np.int32)


def _factory(corpus, poison_at=None):
    """step -> batches past `step`; with `poison_at` the batch of that
    step carries an inf mask on its first pass only (a transient fault)."""
    poisoned = []

    def factory(step):
        it = data.token_batches(corpus, batch_size=2, seq_len=16, seed=1,
                                skip=step)
        for i, batch in enumerate(it, start=step):
            if i == poison_at and not poisoned:
                poisoned.append(i)
                batch = dict(batch, mask=np.full((2, 16), np.inf,
                                                  np.float32))
            yield batch

    factory.poisoned = poisoned
    return factory


def _params_equal(a, b):
    for (path, x), (_, y) in zip(named_leaves(a), named_leaves(b)):
        assert torch.equal(x, y), path


def test_fit_matches_jax_fit_and_resumes(jax_init, tmp_path):
    """Six steps of the JAX fit against the port's fit run as three steps,
    a checkpoint, and a resume to six from it (the stream rebuilt from
    the restored step): the losses at every step and the params after
    agree; and the resumed run equals an uninterrupted port run."""
    jc, tc = jax_init
    corpus = _corpus()
    jlog, tlog = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    jstate = jfit(jc, JTrainConfig(**TRAIN), None, log_path=str(jlog),
                  log_every=1, data_factory=_factory(corpus),
                  handle_preemption=False)
    ck = tmp_path / "ck"
    part = loop.fit(tc, TrainConfig(**dict(TRAIN, total_steps=3)), None,
                    device=CPU, checkpoint_dir=str(ck), checkpoint_every=3,
                    log_path=str(tlog), log_every=1,
                    data_factory=_factory(corpus), handle_preemption=False)
    assert part.step == 3
    state = loop.fit(tc, TrainConfig(**TRAIN), None, device=CPU,
                     checkpoint_dir=str(ck), checkpoint_every=3,
                     log_path=str(tlog), log_every=1,
                     data_factory=_factory(corpus), handle_preemption=False)
    assert state.step == int(jstate.step) == 6
    jl = [json.loads(x) for x in jlog.read_text().splitlines()]
    tl = [json.loads(x) for x in tlog.read_text().splitlines()]
    assert [r["step"] for r in tl] == [r["step"] for r in jl] == list(
        range(1, 7))
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=2e-5)
    theirs = jax.tree.map(np.asarray, jstate.params)
    for path, p in named_leaves(state.params):
        want = jax_leaf(theirs, path, tc)
        _assert_params_close(p.detach().numpy(), want,
                             2e-5 * float(np.abs(want).max()), 0.0,
                             TRAIN["learning_rate"], 0.005, path)
    whole = loop.fit(tc, TrainConfig(**TRAIN), None, device=CPU,
                     log_every=1, data_factory=_factory(corpus),
                     handle_preemption=False)
    _params_equal(state.params, whole.params)
    assert sorted(int(p.name) for p in ck.iterdir() if p.name.isdigit()) \
        == [3, 6]


def test_rollback_after_a_nan_batch_ends_identical(jax_init, tmp_path):
    """A batch that makes the loss non-finite at step 5 (its update is
    skipped in the step), a rollback to the step-4 checkpoint, the stream
    rebuilt from there: the run ends identical to an unfaulted one, with
    one rollback counted; the JAX fit recovers the same way."""
    jc, tc = jax_init
    corpus = _corpus(1)
    kw = dict(device=CPU, checkpoint_every=2, log_every=1,
              handle_preemption=False)
    clean = loop.fit(tc, TrainConfig(**TRAIN), None,
                     data_factory=_factory(corpus), **kw)
    faulty = _factory(corpus, poison_at=4)
    sentinel = resilience.AnomalySentinel(action="rollback")
    log = tmp_path / "t.jsonl"
    state = loop.fit(tc, TrainConfig(**TRAIN), None,
                     checkpoint_dir=str(tmp_path / "ck"), log_path=str(log),
                     data_factory=faulty, sentinel=sentinel, **kw)
    assert faulty.poisoned == [4]
    assert state.step == clean.step == 6
    _params_equal(state.params, clean.params)
    _params_equal(state.opt_state.mu, clean.opt_state.mu)
    rows = [json.loads(x) for x in log.read_text().splitlines()]
    assert any(r.get("anomaly_kind") == "nonfinite_loss"
               and r.get("anomaly_action") == "rollback" for r in rows)
    assert any("restored_after" in r and r["step"] == 4 for r in rows)
    jfaulty = _factory(corpus, poison_at=4)
    jstate = jfit(jc, JTrainConfig(**TRAIN), None,
                  checkpoint_dir=str(tmp_path / "jck"), checkpoint_every=2,
                  log_every=1, data_factory=jfaulty,
                  handle_preemption=False)
    assert jfaulty.poisoned == [4] and int(jstate.step) == 6
    theirs = jax.tree.map(np.asarray, jstate.params)
    for path, p in named_leaves(state.params):
        want = jax_leaf(theirs, path, tc)
        _assert_params_close(p.detach().numpy(), want,
                             2e-5 * float(np.abs(want).max()), 0.0,
                             TRAIN["learning_rate"], 0.005, path)


def test_rollback_without_a_checkpoint_and_fatal_raise(jax_init):
    _, tc = jax_init
    corpus = _corpus(2)
    for action, match in (("rollback", "no checkpoint"), ("fatal", "fatal")):
        with pytest.raises(RuntimeError, match=match):
            loop.fit(tc, TrainConfig(**TRAIN), None, device=CPU,
                     log_every=1, anomaly_action=action,
                     data_factory=_factory(corpus, poison_at=1),
                     handle_preemption=False)


# ------------------------------------------------------- the sentinel

_STREAM = [5.0, 4.9, 4.8, 4.7, 4.6, 4.5, 60.0, 4.4, float("nan"), 4.3,
           4.2, 80.0, 4.1]


@pytest.mark.parametrize("action,patience", [("warn", 1), ("skip", 1),
                                             ("rollback", 2)])
def test_sentinel_matches_reference(action, patience):
    """The same verdicts, kinds, details and escalations as the JAX
    package's sentinel over a stream with spikes and a NaN."""
    ours = resilience.AnomalySentinel(
        action=action, patience=patience, warmup=3,
        budget=RestartBudget(1, window=3600.0))
    from shellac_tpu.utils.failure import RestartBudget as JBudget

    theirs = JSentinel(action=action, patience=patience, warmup=3,
                       budget=JBudget(1, window=3600.0))
    for step, loss in enumerate(_STREAM):
        gn = float("inf") if step == 9 else 1.0
        a, b = ours.observe(step, loss, gn), theirs.observe(step, loss, gn)
        assert (a is None) == (b is None), step
        if a is not None:
            assert (a.kind, a.detail, a.action) == (b.kind, b.detail,
                                                    b.action)
        assert ours.loss_ema == theirs.loss_ema
    with pytest.raises(ValueError):
        resilience.AnomalySentinel(action="retry")


# ---------------------------------------------------------- the data


def test_token_shards_cross_both_ways(tmp_path):
    tokens = np.random.default_rng(0).integers(0, 2 ** 31 - 1, size=1001,
                                               dtype=np.int64)
    data.write_token_shard(str(tmp_path / "t.bin"), tokens)
    jdata.write_token_shard(str(tmp_path / "j.bin"), tokens)
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin") \
        .read_bytes()
    np.testing.assert_array_equal(
        jdata.read_token_shard(str(tmp_path / "t.bin")), tokens)
    np.testing.assert_array_equal(
        data.read_token_shard(str(tmp_path / "j.bin")), tokens)
    (tmp_path / "bad.bin").write_bytes(b"XXXX" + bytes(12))
    with pytest.raises(ValueError, match="magic"):
        data.read_token_shard(str(tmp_path / "bad.bin"))


def test_batch_streams_match_reference(tmp_path):
    corpus = _corpus(3)
    for skip in (0, 5):
        ours = data.token_batches(corpus, batch_size=3, seq_len=9, seed=4,
                                  num_batches=4, skip=skip)
        theirs = jdata.token_batches(corpus, batch_size=3, seq_len=9,
                                     seed=4, num_batches=4, skip=skip)
        for a, b in zip(ours, theirs, strict=True):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"s{i}.bin"))
        data.write_token_shard(paths[-1], _corpus(10 + i, n=300))
    ours = data.shard_batches(paths, batch_size=2, seq_len=8, seed=1,
                              num_batches=3, skip=2)
    theirs = jdata.shard_batches(paths, batch_size=2, seq_len=8, seed=1,
                                 num_batches=3, skip=2, use_native=False)
    for a, b in zip(ours, theirs, strict=True):
        np.testing.assert_array_equal(a["inputs"], b["inputs"])
    docs = [np.arange(n) + 1 for n in (5, 9, 1, 14, 3, 30)]
    rows = list(data.batch_rows(data.pack_documents(docs, seq_len=12), 2))
    jrows = list(jdata.batch_rows(jdata.pack_documents(docs, seq_len=12),
                                  2))
    assert len(rows) == len(jrows) > 0
    for a, b in zip(rows, jrows):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(NotImplementedError):
        next(data.distribute_batches(iter([]), mesh=object()))
    with pytest.raises(NotImplementedError):
        next(data.shard_batches(paths, batch_size=2, seq_len=8,
                                mesh=object()))


def test_device_prefetch_on_the_cpu_converts_in_order():
    batches = list(data.token_batches(_corpus(), batch_size=2, seq_len=5,
                                      num_batches=3))
    got = list(data.device_prefetch(iter(batches), device=CPU))
    assert len(got) == 3
    for a, b in zip(got, batches):
        assert isinstance(a["inputs"], torch.Tensor)
        np.testing.assert_array_equal(a["inputs"].numpy(), b["inputs"])


# ----------------------------------------- evaluation, metrics, timing


def test_evaluate_matches_reference():
    jc, tc = _configs()
    p = jax_params.init_params(jc, 0)
    batches = list(data.token_batches(_corpus(), batch_size=2, seq_len=16,
                                      num_batches=3))
    batches[1] = dict(batches[1], mask=(np.arange(16) % 3 > 0)[None]
                      .repeat(2, 0).astype(np.float32))
    ours = evaluate.evaluate(tc, params_from_jax(tc, p, CPU), iter(batches),
                             device=CPU)
    theirs = jevaluate.evaluate(jc, jax.tree.map(np.asarray, p),
                                iter(batches))
    assert ours["tokens"] == theirs["tokens"] and ours["batches"] == 3
    np.testing.assert_allclose(ours["loss"], theirs["loss"], rtol=2e-5)


def test_metrics_logger_and_flops(tmp_path, capsys):
    from shellac_tpu_torch.obs.metrics import Registry

    reg = Registry()
    path = tmp_path / "m.jsonl"
    with metrics.MetricsLogger(str(path), registry=reg, every=2) as log:
        log.log(1, {"loss": torch.tensor(1.5)})
        log.log(2, {"loss": torch.tensor(2.5), "kind": "x"})
    rows = [json.loads(x) for x in path.read_text().splitlines()]
    assert [(r["step"], r["loss"], r["kind"]) for r in rows] == [
        (2, 2.5, "x")]
    assert "loss=2.5" in capsys.readouterr().err
    assert "shellac_train_loss 2.5" in reg.render()
    args = (1_000_000, 4, 256, 512)
    assert metrics.train_flops_per_token(*args) == \
        jmetrics.train_flops_per_token(*args)


def test_step_timer_discards_warmup():
    timer = tracing.StepTimer(tokens_per_step=100, warmup=1)
    assert timer.tick() is None and timer.tick() is None
    assert timer.tick() > 0 and timer.tokens_per_sec > 0
    with tracing.annotate("region"):
        pass


# --------------------------------------------------- the commands


def test_cli_train_eval_tokenize_match_reference(jax_init, tmp_path,
                                                 capsys):
    """`train` on the same flags in both packages: the same final step
    and per-step losses (the same init and synthetic stream); then `eval`
    on the port's checkpoint, and `tokenize` into a shard that the JAX
    reader reads."""
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"preset": "tiny", "dtype": "float32"}))
    flags = ["train", "--config", str(cfg), "--steps", "4", "--batch", "2",
             "--seq", "16", "--log-every", "1", "--warmup-steps", "1",
             "--learning-rate", "1e-2", "--seed", "0"]
    assert jcli.main(flags + ["--log-path", str(tmp_path / "j.jsonl")]) == 0
    jout = capsys.readouterr().out.strip().splitlines()[-1]
    ck = tmp_path / "ck"
    assert cli.main(flags + ["--device", "cpu", "--ckpt-dir", str(ck),
                             "--log-path", str(tmp_path / "t.jsonl")]) == 0
    tout = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(tout) == json.loads(jout) == {"final_step": 4}
    jl = [json.loads(x) for x in (tmp_path / "j.jsonl").read_text()
          .splitlines()]
    tl = [json.loads(x) for x in (tmp_path / "t.jsonl").read_text()
          .splitlines()]
    for a, b in zip(tl, jl, strict=True):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=2e-5)
    assert cli.main(["eval", "--config", str(cfg), "--device", "cpu",
                     "--ckpt-dir", str(ck), "--batch", "2", "--seq", "16",
                     "--batches", "2"]) == 0
    ev = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ev["tokens"] == 64 and ev["batches"] == 2
    assert 0 < ev["loss"] < 6
    text = tmp_path / "a.txt"
    text.write_text("hello shard\n")
    assert cli.main(["tokenize", "--input", str(text), "--output",
                     str(tmp_path / "s.bin")]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    shard = jdata.read_token_shard(str(tmp_path / "s.bin"))
    assert out["tokens"] == shard.size == len("hello shard\n") + 1


@pytest.mark.parametrize("argv", [
    ["train", "--mesh", "dp=2"],
    ["train", "--lora-rank", "4"],
    ["train", "--base-ckpt", "x"],
    ["eval", "--lora-dir", "x"],
    ["tokenize", "--input", "x", "--output", "y", "--train-bpe", "300"],
])
def test_cli_unported_options_raise(argv):
    extra = [] if argv[0] == "tokenize" else ["--device", "cpu"]
    with pytest.raises(NotImplementedError, match="not ported"):
        cli.main(argv + extra)


def test_loop_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card path is moot")
    _, tc = _configs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.fit(tc, TrainConfig(), iter([]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.make_eval_step(tc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(data.device_prefetch(iter([{"inputs": np.zeros(2)}])))


def test_fit_refuses_a_mesh():
    _, tc = _configs()
    with pytest.raises(NotImplementedError):
        loop.fit(tc, TrainConfig(), iter([]), device=CPU, mesh=object())
