"""Fault tolerance: retry schedules and supervised training.

The twin of ``repro.runtime.fault_tolerance``:
:func:`decorrelated_jitter`, which ``engine.server`` retries transient
dispatch failures with; :class:`RestartPolicy`, which ``engine.fleet``
restarts dead replicas with; and the training :class:`Supervisor`, which
owns the trainer's failure policy:

* periodic async checkpoints (params + optimizer + data-iterator step),
  and a blocking step-0 checkpoint before the first step;
* SIGTERM/SIGINT = preemption notice -> blocking checkpoint, then
  :class:`Preempted`;
* step-level retry: a transient failure (``RuntimeError``, which CUDA
  errors are) restores the latest checkpoint and replays; the
  deterministic data pipeline makes the replay exact;
* NaN/overflow quarantine: a non-finite loss rolls back to the last
  checkpoint and skips the offending data window.
"""

from __future__ import annotations

import dataclasses
import logging
import signal
import time
from typing import Any, Callable

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager

log = logging.getLogger("repro_torch.runtime")


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


@dataclasses.dataclass
class SupervisorConfig:
    checkpoint_every: int = 50
    max_retries: int = 3
    nan_skip_window: int = 1  # steps to skip after a NaN rollback


class Preempted(Exception):
    pass


class Supervisor:
    def __init__(self, manager: CheckpointManager,
                 cfg: SupervisorConfig = SupervisorConfig()):
        self.manager = manager
        self.cfg = cfg
        self._preempt = False
        self._orig_handlers = {}

    def install_signal_handlers(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._orig_handlers[sig] = signal.signal(sig, self._on_signal)

    def _on_signal(self, signum, frame):
        log.warning("preemption signal %s received", signum)
        self._preempt = True

    def run(
        self,
        state: Any,
        data_iter,
        step_fn: Callable,  # (state, batch) -> (state, metrics)
        n_steps: int,
        state_shardings=None,
        on_metrics: Callable | None = None,
    ):
        """Run to ``n_steps`` with retry/rollback. Returns final state.
        ``state_shardings`` places a rolled-back state on its mesh
        (``CheckpointManager.restore(shardings=)``)."""
        retries = 0
        step = int(_get_step(state))
        if self.manager.latest_step() is None:
            # A step-0 checkpoint before the loop: a failure before the
            # first periodic checkpoint then rolls back and replays exactly.
            # Blocking: it must be restorable before the first step runs.
            self.manager.save(step, state,
                              extra={"data_step": data_iter.state()["step"]},
                              blocking=True)
        while step < n_steps:
            if self._preempt:
                self.manager.save(step, state,
                                  extra={"data_step": data_iter.state()["step"]},
                                  blocking=True)
                raise Preempted(f"checkpointed at step {step}")
            try:
                batch = next(data_iter)
                t0 = time.monotonic()
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at step {step}")
                dt = time.monotonic() - t0
                if on_metrics:
                    on_metrics(step, metrics, dt)
                retries = 0
                step += 1
                if step % self.cfg.checkpoint_every == 0:
                    self.manager.save(
                        step, state,
                        extra={"data_step": data_iter.state()["step"]})
            except (RuntimeError, FloatingPointError) as e:
                retries += 1
                log.error("step %d failed (%s); retry %d/%d", step, e,
                          retries, self.cfg.max_retries)
                if retries > self.cfg.max_retries:
                    raise
                latest = self.manager.latest_step()
                if latest is not None:
                    state, extra = self.manager.restore(
                        state, shardings=state_shardings)
                    step = latest
                    skip = extra.get("data_step", step)
                    if isinstance(e, FloatingPointError):
                        skip += self.cfg.nan_skip_window
                    data_iter = _reset_iter(data_iter, skip)
        self.manager.wait()
        return state


def _get_step(state):
    return state.step if hasattr(state, "step") else state["step"]


def _reset_iter(data_iter, step: int):
    from repro_torch.data.pipeline import PrefetchIterator

    data_iter.close()
    return PrefetchIterator(data_iter.source, start_step=step,
                            host=data_iter.host, n_hosts=data_iter.n_hosts)
