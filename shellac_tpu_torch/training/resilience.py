"""The checkpoint half of the training resilience series.

The port's copy of what `shellac_tpu/training/checkpoint.py` deposits
through `ResilienceMetrics` (`shellac_tpu/obs/train.py:16`, re-exported
by `shellac_tpu/training/resilience.py`): the `last_good_step` gauge and
the `quarantined` and `fallback_restores` counters, under the reference's
names and help strings, in the port's registry (`obs/metrics.py`). The
anomaly sentinel, its rollback counters and the fit loop are not ported
yet.
"""

from __future__ import annotations

from shellac_tpu_torch.obs.metrics import get_registry


class ResilienceMetrics:
    """The `shellac_train_*` checkpoint series, registered idempotently
    against the shared registry (or `registry`)."""

    def __init__(self, registry=None):
        reg = registry if registry is not None else get_registry()
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
