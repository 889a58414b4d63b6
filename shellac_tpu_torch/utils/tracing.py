"""Profiling and step timing.

Port of `shellac_tpu/utils/tracing.py` over `torch.profiler`: `trace`
(:18) records the host and, on the card, the device timeline (CUDA
activity through CUPTI) into a Chrome trace under `log_dir`; `annotate`
(:27) labels a region on it (`torch.profiler.record_function`);
`StepTimer` (:32) times step boundaries on the host clock with a warmup
discard and a moving average.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a profiler trace (host, and the card when there is one)
    into `log_dir/trace.json`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A context manager labelling a region on the profiler timeline."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock step timing with warmup discard and an EMA.

    Synchronization is the caller's job: read a scalar of the step's
    output before `tick()`, or the card's queue hides the step's time.
    """

    def __init__(self, tokens_per_step: Optional[int] = None,
                 warmup: int = 2, histogram=None):
        self.tokens_per_step = tokens_per_step
        self.warmup = warmup
        self._count = 0
        self._last: Optional[float] = None
        self._ema: Optional[float] = None
        # Optional obs Histogram: post-warmup step times are observed
        # into it, so their distribution reaches the registry.
        self._hist = histogram

    def tick(self) -> Optional[float]:
        """Mark a step boundary; the step's time, or None in warmup."""
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return None
        dt = now - self._last
        self._last = now
        self._count += 1
        if self._count <= self.warmup:
            return None
        self._ema = dt if self._ema is None else 0.9 * self._ema + 0.1 * dt
        if self._hist is not None:
            self._hist.observe(dt)
        return dt

    @property
    def step_time(self) -> Optional[float]:
        return self._ema

    @property
    def tokens_per_sec(self) -> Optional[float]:
        if self._ema is None or not self.tokens_per_step:
            return None
        return self.tokens_per_step / self._ema
