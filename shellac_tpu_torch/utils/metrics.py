"""Scalar metrics logging (JSONL file and stderr) and model FLOPs.

Port of `shellac_tpu/utils/metrics.py`: `train_flops_per_token` (:28)
and `MetricsLogger` (:45). Every scalar logged is also routed into the
port's shared registry as a `shellac_train_<name>` gauge (its latest
value), beside the serving series; the JSONL file is the durable
per-step record.
"""

from __future__ import annotations

import json
import re
import sys
import time
from typing import IO, Optional

from shellac_tpu_torch.obs.metrics import get_registry


def train_flops_per_token(n_params: int, n_layers: int, d_model: int,
                          seq: int) -> int:
    """Model FLOPs per trained token: 6 x params (the forward and backward
    matmuls) plus the causal-attention term. For an MoE model pass the
    parameters a token activates."""
    return 6 * n_params + 12 * n_layers * d_model * seq


def _scalar(x):
    """A 0-dim tensor or numpy value as a Python float; others as they
    are."""
    if hasattr(x, "dtype") and hasattr(x, "item"):
        return float(x.item())
    return x


def _metric_name(key: str) -> str:
    """A logged key as a Prometheus-safe metric name suffix."""
    return re.sub(r"[^a-zA-Z0-9_]", "_", key)


class MetricsLogger:
    """JSONL + stderr scalar logger, usable as a context manager so the
    file is closed (and flushed) even when the training loop raises."""

    def __init__(self, path: Optional[str] = None, *, stdout: bool = True,
                 every: int = 1, registry=None,
                 prefix: str = "shellac_train_"):
        self._file: Optional[IO] = open(path, "a") if path else None
        self._stdout = stdout
        self._every = max(every, 1)
        self._registry = registry if registry is not None else get_registry()
        self._prefix = prefix
        self._gauges: dict = {}
        self._steps = self._registry.counter(
            f"{prefix}log_steps_total",
            "Training steps that reached the metrics logger",
        )

    def _route(self, record: dict) -> None:
        """Mirror the record's scalars into the registry as latest-value
        gauges."""
        if not self._registry.enabled:
            return
        self._steps.inc()
        for k, v in record.items():
            if k == "time" or not isinstance(v, (int, float)):
                continue
            gauge = self._gauges.get(k)
            if gauge is None:
                gauge = self._registry.gauge(
                    f"{self._prefix}{_metric_name(k)}",
                    f"Latest logged training scalar {k!r}",
                )
                self._gauges[k] = gauge
            gauge.set(float(v))

    def log(self, step: int, metrics: dict) -> None:
        if step % self._every:
            return
        record = {"step": int(step), "time": time.time(),
                  **{k: _scalar(v) for k, v in metrics.items()}}
        self._route(record)
        line = json.dumps(record)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        if self._stdout:
            shown = " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in record.items() if k != "time")
            print(shown, file=sys.stderr)

    def close(self) -> None:
        if self._file:
            self._file.flush()
            self._file.close()
            self._file = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
