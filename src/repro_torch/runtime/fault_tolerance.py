"""Retry schedules for the serving runtime.

The port's part of ``repro.runtime.fault_tolerance``: only
:func:`decorrelated_jitter`, which ``engine.server`` retries transient
dispatch failures with.
"""

from __future__ import annotations

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
