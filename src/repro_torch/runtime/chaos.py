"""Deterministic, seedable fault injection for the serving path.

The port's copy of ``repro.runtime.chaos`` (numpy and threading only): the
same points draw from the same seeded generator in the same order, so one
seed injects at the same points in both packages.

``EeiServer(chaos=ChaosMonkey(ChaosConfig(seed=..., rate=...)))`` arms a
set of named injection points inside the server's dispatch/retire machinery.
Each point draws from one seeded ``numpy`` Generator under a lock, so a
given ``(seed, request stream)`` pair replays the *same* fault schedule —
the property the chaos conformance tests lean on: the every-future-
resolves-exactly-once invariant must hold under faults, and a failure must
be reproducible from its seed.

Injection points (all off unless the config enables them):

    compile       raise ``ChaosFailure`` where the server fetches a program
                  from the ``ProgramCache`` (models a transient compile /
                  allocation failure).
    launch        raise ``ChaosFailure`` after program fetch, at dispatch
                  (models a device launch failure).
    nan           poison the retired eigenvector block of one stack row
                  with NaN (models the clamped-denominator garbage the
                  verify stage exists to catch).
    slow_retire   sleep ``slow_s`` inside retire (models a straggler
                  device; exercises latency accounting, not correctness).
    thread        raise ``ChaosError`` in the admission / retire loop body
                  (models a crashed service thread; exercises the server's
                  bounded restart machinery).

Replica-level points (fired by ``EeiFleet`` per routed dispatch, not by
the server — a fleet is required for them to mean anything):

    replica_kill  kill the replica the request just routed to (process
                  death / OOM-kill); the fleet must redispatch its
                  unresolved work and restart it.
    replica_hang  wedge the replica (accepts work, never answers) — only
                  the deadline probe can catch this one.
    replica_slow  slow the replica by ``replica_slow_s`` per request —
                  the health watchdog should classify it slow and hedge.

``ChaosFailure`` subclasses ``RuntimeError`` and is marked *transient* —
the server's retry/backoff path treats it like a recoverable device error.
``ChaosError`` is *not* retried as transient: it models a genuine thread
crash.  Both are distinguishable from real faults by type, so tests can
assert nothing chaos-injected ever escapes to a caller unresolved.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np


class ChaosFailure(RuntimeError):
    """Injected *transient* fault (compile / launch).  The server's retry
    machinery treats it like any other transient dispatch error."""


class ChaosError(RuntimeError):
    """Injected *thread* fault — models a crashed admission/retire loop."""


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """What to inject, how often, from which seed.

    ``rate`` is the default per-point firing probability; a per-point
    override (``compile_rate`` etc.) of ``None`` inherits it.  Points fire
    independently.  All rates in [0, 1].
    """

    seed: int = 0
    rate: float = 0.05
    compile_rate: Optional[float] = None
    launch_rate: Optional[float] = None
    nan_rate: Optional[float] = None
    slow_retire_rate: Optional[float] = None
    thread_rate: Optional[float] = None
    #: Replica-level points default OFF even when ``rate`` is set: a chaos
    #: monkey armed on a single server must not try to kill replicas that
    #: do not exist.  ``EeiFleet`` chaos configs set them explicitly.
    replica_kill_rate: float = 0.0
    replica_hang_rate: float = 0.0
    replica_slow_rate: float = 0.0
    #: Sleep injected by a ``slow_retire`` firing, seconds.
    slow_s: float = 0.05
    #: Per-request delay while a ``replica_slow`` action is active, seconds.
    replica_slow_s: float = 0.05
    #: How long a ``replica_hang`` wedges the replica, seconds (bounded so
    #: soaks terminate; the deadline probe should fire well before this).
    replica_hang_s: float = 2.0

    def rate_for(self, point: str) -> float:
        override = getattr(self, f"{point}_rate", None)
        return self.rate if override is None else override


class ChaosMonkey:
    """Armed injection points over one seeded generator.

    Thread-safe: the generator draw sits under a lock (the server calls in
    from its admission, dispatch, and retire threads).  Counters record
    every firing per point — exposed through ``EeiServer.stats()`` as
    ``chaos_injected`` so soak runs can report the realized fault rate.
    """

    def __init__(self, config: Optional[ChaosConfig] = None, **kwargs):
        if config is None:
            config = ChaosConfig(**kwargs)
        elif kwargs:
            raise TypeError("pass either a ChaosConfig or kwargs, not both")
        self.config = config
        self._rng = np.random.default_rng(config.seed)
        self._lock = threading.Lock()
        self.injected = {
            "compile": 0, "launch": 0, "nan": 0, "slow_retire": 0,
            "thread": 0, "replica_kill": 0, "replica_hang": 0,
            "replica_slow": 0,
        }

    def _fire(self, point: str) -> bool:
        rate = self.config.rate_for(point)
        if rate <= 0.0:
            return False
        with self._lock:
            hit = self._rng.random() < rate
            if hit:
                self.injected[point] += 1
            return hit

    def counts(self) -> dict:
        with self._lock:
            return dict(self.injected)

    # -- injection points ---------------------------------------------------

    def on_compile(self) -> None:
        """Before the ProgramCache fetch.  Raises ChaosFailure on a hit."""
        if self._fire("compile"):
            raise ChaosFailure("chaos: injected compile failure")

    def on_launch(self) -> None:
        """At dispatch, after program fetch.  Raises ChaosFailure."""
        if self._fire("launch"):
            raise ChaosFailure("chaos: injected launch failure")

    def on_result(self, vecs: np.ndarray) -> np.ndarray:
        """At retire, on the host copy of the eigenvector block.  On a hit,
        poisons one row of the stack with NaN (in a copy) — the verify /
        fallback path must catch it before any caller sees it."""
        if not self._fire("nan"):
            return vecs
        vecs = np.array(vecs, copy=True)
        with self._lock:
            row = int(self._rng.integers(vecs.shape[0]))
        vecs[row] = np.nan
        return vecs

    def on_retire_sleep(self) -> None:
        """Inside retire.  Sleeps ``slow_s`` on a hit (straggler device)."""
        if self._fire("slow_retire"):
            time.sleep(self.config.slow_s)

    def on_thread(self, which: str) -> None:
        """In the admission / retire loop body.  Raises ChaosError on a hit
        — the loop's bounded-restart machinery must absorb it."""
        if self._fire("thread"):
            raise ChaosError(f"chaos: injected {which} thread crash")

    def on_replica(self, rid) -> Optional[str]:
        """Per fleet-routed dispatch, for replica ``rid``.  Draws the three
        replica points independently and returns the most severe hit
        (``"kill"`` > ``"hang"`` > ``"slow"``) or ``None``.  The *fleet*
        executes the action (outside its lock) — the monkey only decides,
        so the schedule stays a pure function of the seed and the dispatch
        sequence whichever kind of replica is in use."""
        action = None
        if self._fire("replica_slow"):
            action = "slow"
        if self._fire("replica_hang"):
            action = "hang"
        if self._fire("replica_kill"):
            action = "kill"
        return action
