"""Straggler detection: a rolling latency distribution per replica.

A copy of ``repro.runtime.straggler``.  The watchdog keeps a rolling
distribution of step (or request) times; one slower than ``threshold x
median`` flags a straggler event.  ``engine.fleet`` keeps one per replica
over completed-request latencies and hedges the requests of a replica it
flags.

* log + counter (always);
* ``on_straggler`` callback;
* optional deadline — a step exceeding a hard deadline raises.
"""

from __future__ import annotations

import collections
import dataclasses
import statistics
from typing import Callable


@dataclasses.dataclass
class StragglerWatchdog:
    window: int = 50
    threshold: float = 2.0
    deadline_s: float | None = None
    on_straggler: Callable | None = None
    #: Observations required before the median is trusted; below this the
    #: watchdog never flags (a cold replica must not look like a straggler).
    min_samples: int = 10

    def __post_init__(self):
        self._times = collections.deque(maxlen=self.window)
        self.events = 0

    def observe(self, step: int, dt: float) -> bool:
        """Record a step time; returns True if flagged as straggler."""
        flagged = False
        if len(self._times) >= self.min_samples:
            med = statistics.median(self._times)
            if dt > self.threshold * med:
                self.events += 1
                flagged = True
                if self.on_straggler:
                    self.on_straggler(step, dt, med)
        if self.deadline_s is not None and dt > self.deadline_s:
            raise RuntimeError(
                f"step {step} exceeded deadline {self.deadline_s}s ({dt:.1f}s)")
        self._times.append(dt)
        return flagged

    def classify(self, dt: float) -> str:
        """Non-mutating probe: would ``dt`` flag against the current
        distribution?  Returns ``"slow"`` / ``"healthy"`` (``"healthy"``
        while under ``min_samples`` — no baseline yet)."""
        if len(self._times) >= self.min_samples:
            if dt > self.threshold * statistics.median(self._times):
                return "slow"
        return "healthy"

    def reset(self) -> None:
        """Drop history (e.g. after a replica restart: the post-warm-up
        latency distribution is a different population)."""
        self._times.clear()

    @property
    def samples(self) -> int:
        return len(self._times)

    @property
    def median(self) -> float:
        return statistics.median(self._times) if self._times else 0.0
