"""Retry and restart schedules for the serving runtime.

The port's part of ``repro.runtime.fault_tolerance``:
:func:`decorrelated_jitter`, which ``engine.server`` retries transient
dispatch failures with, and :class:`RestartPolicy`, which ``engine.fleet``
restarts dead replicas with.  ``repro``'s training ``Supervisor`` (with
``SupervisorConfig`` and ``Preempted``) needs the checkpoint manager and is
not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def decorrelated_jitter(rng: np.random.Generator, base: float, prev: float,
                        cap: float = 30.0) -> float:
    """One step of AWS-style decorrelated-jitter backoff.

    ``delay = min(cap, uniform(base, prev * 3))`` — grows roughly
    geometrically like plain exponential backoff but with a full-width
    random spread, so two clients that failed *together* do not retry
    together (deterministic ``base * 2**attempt`` schedules re-collide
    every attempt).  Pass the previous delay back in as ``prev``; seed the
    first call with ``prev=base``.
    """
    if prev < base:
        prev = base
    return min(cap, float(rng.uniform(base, max(prev * 3.0, base))))


@dataclasses.dataclass
class RestartPolicy:
    """Bounded, jittered restart schedule for a dead replica.

    The fleet asks ``next_delay()`` before each rebuild; ``give_up`` turns
    True once ``max_restarts`` is exhausted (the replica stays dead and its
    keys remain remapped).  ``reset()`` forgives history.
    """

    max_restarts: int = 5
    base_delay_s: float = 0.05
    cap_s: float = 5.0
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._prev = self.base_delay_s
        self.restarts = 0

    @property
    def give_up(self) -> bool:
        return self.restarts >= self.max_restarts

    def next_delay(self) -> float:
        self.restarts += 1
        self._prev = decorrelated_jitter(
            self._rng, self.base_delay_s, self._prev, self.cap_s)
        return self._prev

    def reset(self) -> None:
        self._prev = self.base_delay_s
        self.restarts = 0
