"""Fault tolerance for the training loop: failure detection, straggler
mitigation, and restart bookkeeping (a textual copy of the JAX package's
``distributed/fault.py``, which is pure Python).

On a real multi-host deployment the failure signal comes from the
coordinator's heartbeats; here the same policy objects are driven either
by wall-clock measurements (real plane) or injected events (tests/benches).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


class InjectedFailure(RuntimeError):
    """Raised by the failure injector to simulate a node loss mid-run (and
    by the serving plane's injected faults, ``serving/faults.py``)."""


@dataclasses.dataclass
class FailureInjector:
    fail_at_step: Optional[int] = None
    fired: bool = False

    def check(self, step: int):
        if self.fail_at_step is not None and step == self.fail_at_step \
                and not self.fired:
            self.fired = True
            raise InjectedFailure(f"injected node failure at step {step}")


class StragglerDetector:
    """Flags steps whose duration exceeds ``threshold`` x rolling median.

    A persistent straggler means a degraded host: the mitigation hook (e.g.
    Controller rebind / mesh shrink) is invoked after ``patience``
    consecutive slow steps.
    """

    def __init__(self, threshold: float = 2.0, patience: int = 3,
                 on_straggler: Optional[Callable[[int], None]] = None):
        self.threshold = threshold
        self.patience = patience
        self.on_straggler = on_straggler
        self.durations: list[float] = []
        self.slow_streak = 0
        self.events: list[int] = []

    def record(self, step: int, duration_s: float) -> bool:
        self.durations.append(duration_s)
        hist = sorted(self.durations[-50:])
        med = hist[len(hist) // 2]
        slow = len(self.durations) > 5 and duration_s > self.threshold * med
        self.slow_streak = self.slow_streak + 1 if slow else 0
        if self.slow_streak >= self.patience:
            self.events.append(step)
            self.slow_streak = 0
            if self.on_straggler:
                self.on_straggler(step)
            return True
        return False


class StepTimer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.duration = time.perf_counter() - self.t0
