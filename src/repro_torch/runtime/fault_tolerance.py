"""Fault-tolerance runtime: preemption handling, straggler detection, restarts
(a copy of ``repro/runtime/fault_tolerance.py``, which is plain Python).

Single-host CI exercises the *logic*; the cluster actions (re-scheduling a
slow host, draining a pod) are the documented policy hooks.

* :class:`PreemptionHandler` — SIGTERM/SIGINT flip a flag; the train loop
  checkpoints and exits cleanly at the next step boundary (the standard
  maintenance-event dance on a cluster).
* :class:`StragglerMonitor` — per-step wall-times in a ring buffer; a step
  slower than ``factor`` x the rolling p50 raises the alarm, with a policy
  callback (default: log; a cluster deployment wires eviction/re-dispatch).
* :func:`run_with_restarts` — supervisor that restarts a failing step loop
  from the latest committed checkpoint, up to ``max_restarts`` times
  (exercised in tests with injected faults).
"""

from __future__ import annotations

import collections
import signal
import time
from typing import Callable, Deque, Optional

import numpy as np


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._flag = False
        self._prev = {}
        self._signals = signals

    def install(self) -> "PreemptionHandler":
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()

    def _handler(self, signum, frame):
        self._flag = True

    @property
    def preempted(self) -> bool:
        return self._flag

    def simulate(self) -> None:  # tests
        self._flag = True


class StragglerMonitor:
    """Rolling-median step-time alarm.

    On a cluster, per-host step times arrive via the coordination service; the
    same rule applies per host and the policy callback names the offender.
    """

    def __init__(
        self,
        window: int = 50,
        factor: float = 3.0,
        min_samples: int = 10,
        policy: Optional[Callable[[float, float], None]] = None,
    ):
        self.window = window
        self.factor = factor
        self.min_samples = min_samples
        self.times: Deque[float] = collections.deque(maxlen=window)
        self.alarms = 0
        self.policy = policy
        self._t0: Optional[float] = None

    def start_step(self) -> None:
        self._t0 = time.perf_counter()

    def end_step(self) -> bool:
        """Record; return True if this step was a straggler."""
        if self._t0 is None:
            return False
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return self.record(dt)

    def record(self, dt: float) -> bool:
        is_straggler = False
        if len(self.times) >= self.min_samples:
            p50 = float(np.median(self.times))
            if dt > self.factor * p50:
                is_straggler = True
                self.alarms += 1
                if self.policy is not None:
                    self.policy(dt, p50)
        self.times.append(dt)
        return is_straggler

    @property
    def median(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0


def run_with_restarts(
    make_state: Callable[[], object],
    step_loop: Callable[[object], object],
    *,
    max_restarts: int = 3,
    on_restart: Optional[Callable[[int, BaseException], None]] = None,
):
    """Supervisor: (re)build state (restoring the latest checkpoint inside
    ``make_state``) and run ``step_loop`` until it returns, restarting on
    exceptions up to ``max_restarts`` times."""
    attempt = 0
    while True:
        state = make_state()
        try:
            return step_loop(state)
        except KeyboardInterrupt:
            raise
        except BaseException as e:
            attempt += 1
            if attempt > max_restarts:
                raise
            if on_restart is not None:
                on_restart(attempt, e)
