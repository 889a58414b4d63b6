"""Fault-tolerant training: the anomaly sentinel and its rollback
contract.

Port of `shellac_tpu/training/resilience.py` (`Anomaly` :54,
`AnomalySentinel` :73-196) for one process. The fit loop feeds every
log-boundary loss and grad norm to an `AnomalySentinel`, which detects a
non-finite loss, a non-finite gradient norm, and loss spikes (above
`spike_factor` times a warmed-up moving average of the healthy losses),
and resolves an action per anomaly:

  warn      count it and keep training (anomalous losses never enter
            the average, so detection stays armed);
  skip      tolerate the step, drawing one token from the recovery
            budget;
  rollback  restore the last-good checkpoint (the fallback walk past
            corrupt steps), re-derive the data stream from the restored
            step, and resume; budgeted too;
  fatal     raise.

Each skip or rollback records one attempt in a `RestartBudget`; once the
sliding window's budget is spent the action becomes fatal. Detection
(`detect`) is split from resolution (`flag`) as in the reference. Every
event lands in the shared registry as `shellac_train_*` series
(`obs/train.py`, whose `ResilienceMetrics` this module re-exports).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from shellac_tpu_torch.obs.train import ResilienceMetrics  # noqa: F401
from shellac_tpu_torch.utils.failure import RestartBudget

ACTIONS = ("warn", "skip", "rollback", "fatal")


@dataclasses.dataclass(frozen=True)
class Anomaly:
    """One training anomaly with its resolved action."""

    step: int
    kind: str  # nonfinite_loss | nonfinite_grad | loss_spike
    detail: str
    action: str  # one of ACTIONS; escalation may turn skip/rollback fatal

    def __str__(self) -> str:
        return f"{self.kind} at step {self.step} ({self.detail})"


def _nonfinite(x) -> bool:
    try:
        return not math.isfinite(float(x))
    except (TypeError, ValueError):
        return True


class AnomalySentinel:
    """Host-side anomaly verdict over the training loss stream.

    `observe(step, loss, grad_norm)` detects and, for an anomaly
    sustained over `patience` consecutive observations, resolves and
    records it.
    """

    def __init__(self, *, action: str = "rollback", patience: int = 1,
                 spike_factor: float = 10.0, ema_decay: float = 0.98,
                 warmup: int = 5, budget: Optional[RestartBudget] = None,
                 registry=None):
        if action not in ACTIONS:
            raise ValueError(f"action must be one of {ACTIONS}, got {action!r}")
        if spike_factor <= 1.0:
            raise ValueError("spike_factor must be > 1")
        if not 0.0 < ema_decay < 1.0:
            raise ValueError("ema_decay must be in (0, 1)")
        self.action = action
        self.patience = max(1, patience)
        self.spike_factor = spike_factor
        self.ema_decay = ema_decay
        self.warmup = max(0, warmup)
        # A handful of recoveries an hour by default: a tight loop of
        # anomalies (poisoned data, a replay that diverges again at the
        # same step) spends it and goes fatal.
        self.budget = budget if budget is not None else RestartBudget(
            2, window=3600.0)
        self.metrics = ResilienceMetrics(registry)
        self._ema: Optional[float] = None
        self._healthy = 0
        self._streak = 0

    @property
    def loss_ema(self) -> Optional[float]:
        return self._ema

    def detect(self, step: int, loss: float,
               grad_norm: Optional[float] = None
               ) -> Optional[Tuple[str, str]]:
        """Detection only: (kind, detail) or None. Never draws from the
        budget and emits no metric."""
        kind = detail = None
        if _nonfinite(loss):
            kind, detail = "nonfinite_loss", f"loss={loss}"
        elif grad_norm is not None and _nonfinite(grad_norm):
            kind, detail = "nonfinite_grad", f"grad_norm={grad_norm}"
        elif (self._ema is not None and self._healthy >= self.warmup
              and loss > self.spike_factor * max(self._ema, 1e-6)):
            kind = "loss_spike"
            detail = (f"loss {loss:.4g} > {self.spike_factor:g}x EMA "
                      f"{self._ema:.4g}")
        if kind is None:
            self._streak = 0
            self._healthy += 1
            d = self.ema_decay
            self._ema = loss if self._ema is None else (
                d * self._ema + (1.0 - d) * loss)
            return None
        # Anomalous losses never fold into the average: a slow ramp of
        # bad values must not drag the reference up.
        self._streak += 1
        if self._streak < self.patience:
            return None
        return kind, detail

    def flag(self, step: int, kind: str, detail: str,
             record: bool = True) -> Anomaly:
        """Record an anomaly and resolve its action: skip and rollback
        draw from the budget and escalate to fatal once it is spent."""
        action = self.action
        if action in ("skip", "rollback") and not self.budget.allow():
            detail = f"{detail}; recovery budget spent"
            action = "fatal"
        self._streak = 0
        anomaly = Anomaly(step=step, kind=kind, detail=detail, action=action)
        if record:
            self.record(anomaly)
        return anomaly

    def record(self, anomaly: Anomaly) -> None:
        """Count the anomaly under its resolved action."""
        self.metrics.anomalies.labels(kind=anomaly.kind,
                                      action=anomaly.action).inc()

    def observe(self, step: int, loss: float,
                grad_norm: Optional[float] = None) -> Optional[Anomaly]:
        """Detect, then flag on detection."""
        pending = self.detect(step, loss, grad_norm)
        if pending is None:
            return None
        return self.flag(step, *pending)

    def reset(self) -> None:
        """Clear detection state after a rollback (the loss stream
        restarts at the restored step). The budget is kept: escalation
        must survive rollbacks."""
        self._ema = None
        self._healthy = 0
        self._streak = 0
