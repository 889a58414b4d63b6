"""Failure recovery hooks of the serving supervisor.

The port's own copy of the parts of `shellac_tpu/utils/failure.py` that
need no JAX: `RestartBudget` (:104), the sliding-window circuit breaker
over in-process engine rebuilds, and the liveness file (`heartbeat_age`
:226, `Heartbeat` :237) that the serving scheduler beats for external
watchdogs. The heartbeat's process index is this process's rank in
`torch.distributed` when it is initialized, else 0.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class RestartBudget:
    """Sliding-window circuit breaker over restart attempts.

    `allow()` records one restart attempt and returns whether it is
    within budget: at most `max_restarts` attempts inside the trailing
    `window` seconds. A crash-looping component exhausts the budget and
    stays down (the caller declares it fatal) instead of rebuilding
    state it will immediately wedge again; isolated faults spread
    further apart than the window recover forever.
    """

    def __init__(self, max_restarts: int, window: float = 300.0):
        if max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        if window <= 0:
            raise ValueError("window must be > 0 seconds")
        self.max_restarts = max_restarts
        self.window = window
        self._attempts: list[float] = []

    def allow(self, now: Optional[float] = None) -> bool:
        """Record a restart attempt; True iff it fits the budget."""
        t = time.monotonic() if now is None else now
        cutoff = t - self.window
        self._attempts = [a for a in self._attempts if a > cutoff]
        if len(self._attempts) >= self.max_restarts:
            return False
        self._attempts.append(t)
        return True

    @property
    def used(self) -> int:
        """Attempts currently inside the window (a monitoring read)."""
        cutoff = time.monotonic() - self.window
        return sum(1 for a in self._attempts if a > cutoff)


def heartbeat_age(path: str) -> Optional[float]:
    """Seconds since the heartbeat file at `path` was last beaten, or
    None when the file is missing/corrupt (callers treat None as
    stale)."""
    try:
        with open(path) as f:
            return time.time() - json.load(f)["time"]
    except (FileNotFoundError, json.JSONDecodeError, KeyError):
        return None


def _process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class Heartbeat:
    """Liveness file for external watchdogs."""

    def __init__(self, path: str, *, process_index: Optional[int] = None):
        self.path = path
        self.process_index = (process_index if process_index is not None
                              else _process_index())
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def beat(self, step: int) -> None:
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            json.dump(
                {"step": int(step), "time": time.time(),
                 "process": self.process_index}, f
            )
        os.replace(tmp, self.path)

    def age(self) -> Optional[float]:
        """Seconds since the last beat, or None if never beaten."""
        return heartbeat_age(self.path)

    @staticmethod
    def is_stale(path: str, timeout: float) -> bool:
        age = heartbeat_age(path)
        return age is None or age > timeout
