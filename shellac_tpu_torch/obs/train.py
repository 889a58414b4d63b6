"""The `shellac_train_*` metric bundles of the training stack.

Port of `shellac_tpu/obs/train.py`: `ResilienceMetrics` (:16, the
anomaly, rollback and checkpoint-integrity series) and
`train_interval_histogram` (:49), registered idempotently against the
port's shared registry (`obs/metrics.py`) under the reference's names
and help strings. `training/resilience.py` re-exports
`ResilienceMetrics`.
"""

from __future__ import annotations

from shellac_tpu_torch.obs.metrics import get_registry, log_buckets


class ResilienceMetrics:
    """The `shellac_train_*` resilience series, registered once
    (idempotently) against the shared registry (or `registry`), so the
    fit loop, the checkpointer and tests deposit into the same
    instruments."""

    def __init__(self, registry=None):
        reg = registry if registry is not None else get_registry()
        self.anomalies = reg.counter(
            "shellac_train_anomalies_total",
            "Training anomalies by kind and resolved action",
            labels=("kind", "action"),
        )
        self.rollbacks = reg.counter(
            "shellac_train_rollbacks_total",
            "Checkpoint rollbacks performed by the training loop",
        )
        self.quarantined = reg.counter(
            "shellac_train_ckpt_quarantined_total",
            "Checkpoint steps renamed *.corrupt after failing "
            "verification or restore",
        )
        self.fallback_restores = reg.counter(
            "shellac_train_ckpt_fallback_restores_total",
            "Restores that had to walk past the newest step to an "
            "older intact one",
        )
        self.last_good_step = reg.gauge(
            "shellac_train_last_good_step",
            "Newest checkpoint step believed intact (set on save and "
            "on every restore)",
        )


def train_interval_histogram(registry=None):
    """The wall time between log boundaries, in the shared registry, so
    training pace is scraped beside serving latency."""
    reg = registry if registry is not None else get_registry()
    return reg.histogram(
        "shellac_train_log_interval_seconds",
        "Wall time between metric log boundaries (log_every steps)",
        buckets=log_buckets(0.001, 600.0),
    )
