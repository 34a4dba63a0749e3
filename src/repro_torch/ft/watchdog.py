"""Straggler / stall detection and preemption handling.

StepWatchdog keeps a rolling window of step wall-times; a step beyond
``zmax`` sigmas (or ``hard_timeout``) flags a straggler — the serve tier
counts it and the router marks the replica SUSPECT. PreemptionHandler turns
SIGTERM (a cloud's preemption warning) into a final synchronous checkpoint
and an exit-intent flag, so a restart loses no step; the trainer
(``launch/train.py``) installs it for the length of a run.
"""
from __future__ import annotations

import signal
import threading
import time
from collections import deque
from typing import Callable, Deque, Optional

__all__ = ["StepWatchdog", "PreemptionHandler"]


class StepWatchdog:
    def __init__(self, window: int = 50, zmax: float = 4.0, hard_timeout: float = 600.0):
        self.times: Deque[float] = deque(maxlen=window)
        self.zmax = zmax
        self.hard_timeout = hard_timeout
        self.flags = 0
        self._t0: Optional[float] = None

    def step_start(self):
        self._t0 = time.perf_counter()

    def step_end(self) -> bool:
        """Record a step; returns True if this step looked like a straggler."""
        if self._t0 is None:
            return False  # unmatched step_end (e.g. fault path skipped start)
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return self.record(dt)

    def record(self, dt: float) -> bool:
        """Record an externally timed step. The continuous serve tier uses
        this instead of step_start/step_end because two flushes can be in
        flight at once (double buffering) and the single ``_t0`` latch would
        cross their timings."""
        straggler = False
        if dt > self.hard_timeout:
            straggler = True
        elif len(self.times) >= 10:
            mean = sum(self.times) / len(self.times)
            var = sum((t - mean) ** 2 for t in self.times) / len(self.times)
            std = max(var**0.5, 1e-6, 0.05 * mean)
            straggler = (dt - mean) / std > self.zmax
        self.times.append(dt)
        self.flags += int(straggler)
        return straggler


class PreemptionHandler:
    """SIGTERM -> on_preempt() (checkpoint) -> exit-intent flag."""

    def __init__(self, on_preempt: Callable[[], None]):
        self.requested = threading.Event()
        self._cb = on_preempt
        self._installed = False

    def install(self):
        def handler(signum, frame):
            self.requested.set()

        signal.signal(signal.SIGTERM, handler)
        self._installed = True

    def poll(self) -> bool:
        """Call between steps; runs the checkpoint callback once if preempted."""
        if self.requested.is_set():
            self._cb()
            return True
        return False
