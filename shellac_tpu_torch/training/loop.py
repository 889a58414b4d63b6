"""The training loop: steps, checkpoints, metrics and failure recovery.

Port of `shellac_tpu/training/loop.py` `fit` (:43-348) for one card, over
the port's Checkpointer (`training/checkpoint.py`). The loop reads
scalars from the card only every `log_every` steps, so the card's queue
stays full between reads; the anomaly sentinel therefore reacts within
one log interval.

Failure semantics: every log-boundary loss and grad norm feeds an
`AnomalySentinel`. Its rollback restores the last-good checkpoint
(walking past corrupt steps, `restore(fallback=True)`), rebuilds the data
stream from the restored step (`data_factory`) and resumes, so a
transient fault finishes identical to an unfaulted run; repeated
anomalies drain the sentinel's RestartBudget and escalate to fatal.
SIGTERM stops the loop at the next step boundary and writes a final
checkpoint. Batches reach the card through `device_prefetch` (pinned
staging, one step ahead).

Not ported: `fit_lora` (:349), and meshes (a mesh or
pipeline_microbatches raises NotImplementedError).
"""

from __future__ import annotations

import signal
import threading
import time
from typing import Callable, Iterator, Optional

from shellac_tpu_torch.config import ModelConfig, TrainConfig
from shellac_tpu_torch.obs.train import train_interval_histogram
from shellac_tpu_torch.ops.dispatch import DeviceLike, resolve_device
from shellac_tpu_torch.training.data import device_prefetch
from shellac_tpu_torch.training.resilience import AnomalySentinel
from shellac_tpu_torch.training.trainer import (
    init_train_state,
    make_train_step,
)
from shellac_tpu_torch.utils.failure import Heartbeat, RestartBudget
from shellac_tpu_torch.utils.metrics import MetricsLogger
from shellac_tpu_torch.utils.tracing import StepTimer


def fit(model_cfg: ModelConfig, train_cfg: TrainConfig,
        data_iter: Optional[Iterator[dict]], *, device: DeviceLike = None,
        mesh=None, checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 500, log_path: Optional[str] = None,
        log_every: int = 10, resume: bool = True,
        heartbeat_path: Optional[str] = None, max_restores: int = 2,
        pipeline_microbatches: Optional[int] = None,
        handle_preemption: bool = True,
        sentinel: Optional[AnomalySentinel] = None,
        anomaly_action: str = "rollback",
        data_factory: Optional[Callable[[int], Iterator[dict]]] = None):
    """Train until train_cfg.total_steps on `device` (the card unless told
    otherwise); returns the final TrainState.

    `data_iter` yields batches (numpy or tensors); or pass `data_factory`
    (step -> an iterator positioned past `step` batches), which the loop
    calls at the step the run starts from (after a resume) and again
    after every rollback. `sentinel` (or a default `AnomalySentinel`
    with `anomaly_action` and a RestartBudget of `max_restores`
    recoveries an hour) judges every log-boundary loss. With
    `heartbeat_path` the loop beats a liveness file at 1 Hz at step
    boundaries, with forced beats around every restore. With
    `handle_preemption` (on the main thread), SIGTERM stops at the next
    step boundary and saves.
    """
    if mesh is not None or pipeline_microbatches is not None:
        raise NotImplementedError(
            "fit over a mesh or pipeline microbatches is not ported; it "
            "trains on one card")
    dev = resolve_device(device)

    ckpt = None
    if checkpoint_dir is not None:
        from shellac_tpu_torch.training.checkpoint import Checkpointer

        ckpt = Checkpointer(checkpoint_dir)

    heartbeat = Heartbeat(heartbeat_path) if heartbeat_path else None
    hb_last = [0.0]

    def beat(at_step: int, force: bool = False) -> None:
        # 1 Hz at the step boundary, so fast steps make no fsync storm;
        # forced beats around a restore give a watchdog its full window.
        if heartbeat is None:
            return
        now = time.monotonic()
        if force or now - hb_last[0] >= 1.0:
            heartbeat.beat(at_step)
            hb_last[0] = now

    def restore():
        from shellac_tpu_torch.training.checkpoint import (
            abstract_train_state,
        )

        return ckpt.restore(
            abstract_state=abstract_train_state(model_cfg, train_cfg),
            device=dev, fallback=True)

    if ckpt is not None and resume and ckpt.latest_step() is not None:
        beat(ckpt.latest_step() or 0, force=True)
        state = restore()
        if data_factory is not None:
            # A fallback walk may have landed below the latest step.
            data_iter = data_factory(int(state.step))
    else:
        state = init_train_state(model_cfg, train_cfg, seed=train_cfg.seed,
                                 device=dev)
    if data_iter is None:
        if data_factory is None:
            raise ValueError("fit needs data_iter or data_factory")
        data_iter = data_factory(int(state.step))
    batches = device_prefetch(data_iter, device=dev)

    step_fn = make_train_step(model_cfg, train_cfg, device=dev)
    logger = MetricsLogger(log_path, every=1)
    if sentinel is None:
        sentinel = AnomalySentinel(
            action=anomaly_action,
            budget=RestartBudget(max_restores, window=3600.0))
    timer = StepTimer(histogram=train_interval_histogram())
    restores = 0

    preempted = threading.Event()
    old_handler = None
    install_handler = (handle_preemption and threading.current_thread()
                       is threading.main_thread())
    if install_handler:
        def _on_term(signum, frame):
            preempted.set()

        old_handler = signal.signal(signal.SIGTERM, _on_term)

    step = int(state.step)
    stop = False
    try:
        with logger:
            while step < train_cfg.total_steps and not stop:
                try:
                    batch = next(batches)
                except StopIteration:
                    break
                state, metrics = step_fn(state, batch)
                step += 1
                beat(step)
                if preempted.is_set():
                    stop = True
                if step % log_every == 0 or step >= train_cfg.total_steps:
                    host_metrics = {k: float(v) for k, v in metrics.items()}
                    pending = sentinel.detect(
                        step, host_metrics["loss"],
                        grad_norm=host_metrics.get("grad_norm"))
                    dt = timer.tick()
                    if dt is not None:
                        host_metrics["steps_per_sec"] = log_every / dt
                    logger.log(step, host_metrics)
                    beat(step)

                    if pending is not None:
                        anomaly = sentinel.flag(step, *pending)
                        # Logged before any raise: the terminal anomaly
                        # lands in the JSONL log, not only the exception.
                        logger.log(step, {"anomaly_kind": anomaly.kind,
                                          "anomaly_action": anomaly.action})
                        if anomaly.action == "rollback" and ckpt is not None:
                            # An async save may still be in flight; let
                            # it commit before restoring.
                            ckpt.wait()
                        if anomaly.action == "rollback" and (
                                ckpt is None or ckpt.latest_step() is None):
                            raise RuntimeError(
                                f"training anomaly: {anomaly}; rollback "
                                "requested but there is no checkpoint to "
                                "restore")
                        if anomaly.action == "fatal":
                            raise RuntimeError(
                                f"training anomaly: {anomaly}; action=fatal")
                        if anomaly.action == "rollback":
                            restores += 1
                            sentinel.metrics.rollbacks.inc()
                            beat(step, force=True)  # entering recovery
                            state = None  # free the diverged state first
                            state = restore()
                            step = int(state.step)
                            if data_factory is not None:
                                # Replay exactly the batches the rolled
                                # back steps consumed.
                                batches.close()
                                batches = device_prefetch(
                                    data_factory(step), device=dev)
                            sentinel.reset()
                            beat(step, force=True)
                            logger.log(step, {
                                "restored_after": str(anomaly),
                                "restores": restores})
                            continue
                        # warn/skip: keep training (skip already drew from
                        # the budget inside flag()).

                if ckpt is not None and step % checkpoint_every == 0:
                    ckpt.save(step, state)

            if ckpt is not None:
                # The final save waits: returning with the write in
                # flight is how truncated checkpoints are made.
                ckpt.save(int(state.step), state, force=True, wait=True)
            if preempted.is_set():
                logger.log(step, {"preempted": 1})
    finally:
        batches.close()
        if install_handler:
            signal.signal(signal.SIGTERM, old_handler)
        if ckpt is not None:
            ckpt.close()
    return state
