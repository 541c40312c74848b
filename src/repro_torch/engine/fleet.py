"""EeiFleet — fault-tolerant multi-replica front-end over ``EeiServer``.

The twin of ``repro.engine.fleet`` on the port's server.  The fleet owns N
replicas (each one ``EeiServer``, in-process or in a worker process behind
the same driver interface) and routes every request by its coalesce key:

    submit(a, k, largest) ──> route: rendezvous-hash (bucket_n, largest)
         │                    over the live replica set — each replica's
         │                    ProgramCache stays small and hot, and keys
         ▼                    remap minimally when the set changes
    replica driver ──> internal Future (the replica's own); the fleet owns
         │             the *caller-facing* Future — replica futures are an
         ▼             implementation detail
    completion ──> exactly-once resolution: the first successful attempt
                   wins; failed attempts redispatch to a healthy replica

Robustness core:

* **health** — a monitor thread probes each replica: liveness
  (``driver.alive()``), a *deadline* on the oldest unresolved request
  (the only probe that catches a hung replica: it accepts work and never
  answers), and a per-replica ``StragglerWatchdog`` over completed-request
  latencies that classifies a replica *slow* relative to its own history.
* **failover** — every request carries provenance (its input, its
  attempts); when a replica dies or misses the deadline, the death fails
  its internal futures with :class:`ReplicaDied`, and each unresolved
  request redispatches to a healthy replica (bounded by
  ``max_redispatch``).  The caller future resolves exactly once no matter
  how many attempts raced.
* **hedging** — requests stuck on a *slow* (but live) replica past
  ``hedge_age_s`` get a second attempt on a healthy replica;
  first-result-wins, the loser's internal future is cancelled.
* **restart** — a dead replica rebuilds through its
  :class:`~repro_torch.runtime.fault_tolerance.RestartPolicy` (bounded,
  jittered delays); in-process rebuilds share the fleet's ``ProgramCache``
  so the restart is warm.  Rendezvous routing restores the replica's
  bucket ownership automatically the moment it is healthy again — there
  is no routing table to rebuild.
* **chaos** — ``ChaosMonkey.on_replica`` points (``replica_kill`` /
  ``replica_hang`` / ``replica_slow``) fire per routed dispatch, decided
  by the monkey (so the schedule is a pure function of the seed and the
  dispatch sequence) and *executed by the fleet* outside its lock.

Lock order: fleet lock → driver lock → server lock → cache lock, never the
reverse.  The fleet lock is re-entrant (a driver that fails a future
inline re-enters ``_on_internal_done`` on the same thread) and is **never
held across a blocking driver call** (kill / close / join) — the monitor
collects actions under the lock and executes them outside it.

Devices: ``server_kwargs`` carry ``device`` to every replica's server.
With none, each replica runs on the card and, with no card, raises, so a
fleet never carries on on the CPU unless it was asked to.  In-process
replicas share one device and its current stream; a worker process holds
a CUDA context of its own.
"""

from __future__ import annotations

import itertools
import logging
import os
import pickle
import struct
import subprocess
import sys
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Callable, Optional

import numpy as np

from repro_torch.engine import engine as engine_mod
from repro_torch.engine.server import (
    DegradedResult,
    EeiServer,
    ProgramCache,
    ServerClosed,
)
from repro_torch.runtime.chaos import ChaosFailure, ChaosMonkey
from repro_torch.runtime.elastic import route_key
from repro_torch.runtime.fault_tolerance import RestartPolicy
from repro_torch.runtime.straggler import StragglerWatchdog

log = logging.getLogger("repro_torch.engine.fleet")

HEALTHY = "healthy"
SLOW = "slow"
DEAD = "dead"
RESTARTING = "restarting"


class FleetClosed(RuntimeError):
    """The fleet has been closed; the request was not (or will not be)
    served.  Mirrors :class:`~repro_torch.engine.server.ServerClosed`."""


class ReplicaDied(RuntimeError):
    """An internal (replica-side) failure: the replica died, hung past its
    deadline, or was closed under a request.  Never reaches a caller —
    it is the signal that routes the request to another replica."""


def _redispatchable(exc: BaseException) -> bool:
    """Failures that indict the *replica*, not the request: another replica
    should be tried.  Anything else (a genuine per-request error that
    survived the server's own fallback chain) resolves the caller."""
    return isinstance(exc, (ReplicaDied, ServerClosed, ChaosFailure)) or \
        bool(getattr(exc, "transient", False))


class _FleetRequest:
    """Provenance for one caller request: enough to redispatch it from
    scratch on any replica, plus every attempt in flight."""

    __slots__ = ("a", "n", "k", "largest", "future", "t_submit",
                 "attempts", "redispatches", "hedged")

    def __init__(self, a, k, largest):
        self.a = a
        self.n = a.shape[0]
        self.k = int(k)
        self.largest = bool(largest)
        self.future = Future()
        self.t_submit = time.monotonic()
        self.attempts = []  # [(rid, internal Future, t_dispatch), ...]
        self.redispatches = 0
        self.hedged = False


class _FleetSession:
    """Fleet-side record for one sticky session.

    ``a_host`` is a float64 mirror of the session matrix, updated eagerly
    at submit (before dispatch): it is the failover state — when the owning
    replica dies, the session reopens on another replica *from the mirror*
    (a full solve), so no update is ever lost with the replica.
    ``generation`` counts reopens; a dispatch records the generation it ran
    under so a burst of failures triggers one reopen, not one per update.
    """

    __slots__ = ("sid", "rid", "replica_sid", "a_host", "k", "largest",
                 "config", "generation", "lock")

    def __init__(self, sid, rid, replica_sid, a_host, k, largest, config):
        self.sid = sid
        self.rid = rid
        self.replica_sid = replica_sid
        self.a_host = a_host
        self.k = k
        self.largest = largest
        self.config = config
        self.generation = 0
        self.lock = threading.Lock()


# -- replica drivers --------------------------------------------------------


class InProcessReplica:
    """One in-process ``EeiServer`` behind the driver interface.

    A forwarder thread decouples the fleet's dispatch from the replica's
    behavior (the same decoupling a network hop gives a remote replica),
    which is also where chaos *hang* (stop forwarding) and *slow* (delay
    each forward) act — the server underneath is untouched, exactly like a
    wedged or overloaded process whose internals are fine.
    """

    def __init__(self, rid: int, server_factory: Callable[[], EeiServer]):
        self.rid = rid
        self._server = server_factory()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._inbox: "deque[tuple]" = deque()  # (a, k, largest, fut, t)
        self._dead = False
        self._hang_until = 0.0
        self._slow_until = 0.0
        self._slow_per_req_s = 0.0
        self._forwarder = threading.Thread(
            target=self._forward_loop, name=f"eei-replica-{rid}", daemon=True)
        self._forwarder.start()

    # fleet-facing ----------------------------------------------------------

    def submit(self, a, k: int, largest: bool) -> Future:
        fut = Future()
        with self._cv:
            if self._dead:
                fut.set_exception(ReplicaDied(
                    f"replica {self.rid} is dead"))
                return fut
            self._inbox.append((a, k, largest, fut, time.monotonic()))
            self._cv.notify_all()
        return fut

    def alive(self) -> bool:
        with self._cv:
            if self._dead:
                return False
        return self._server.alive()

    def oldest_unresolved_age_s(self) -> Optional[float]:
        now = time.monotonic()
        ages = []
        with self._cv:
            if self._inbox:
                ages.append(now - self._inbox[0][4])
        server_age = self._server.oldest_unresolved_age_s(now)
        if server_age is not None:
            ages.append(server_age)
        return max(ages) if ages else None

    def kill(self) -> None:
        """Abrupt death: fail everything queued here, close the server
        without draining (its unresolved futures fail with ServerClosed,
        which chains out to the internal futures the fleet watches)."""
        with self._cv:
            if self._dead:
                return
            self._dead = True
            inbox = list(self._inbox)
            self._inbox.clear()
            self._cv.notify_all()
        for *_, fut, _t in inbox:
            _set(fut, error=ReplicaDied(f"replica {self.rid} killed"))
        # timeout=0: don't wait on the daemon threads; stragglers that do
        # resolve later chain out normally and lose the exactly-once race.
        stranded = self._server.close(drain=False, timeout=0)
        for fut in stranded:
            _set(fut, error=ReplicaDied(f"replica {self.rid} killed"))

    def hang(self, seconds: float) -> None:
        """Wedge the forwarder: accepted work sits in the inbox unanswered.
        Only the fleet's deadline probe can see this failure mode."""
        with self._cv:
            self._hang_until = time.monotonic() + seconds
            self._cv.notify_all()

    def slow(self, per_request_s: float, duration_s: float) -> None:
        with self._cv:
            self._slow_per_req_s = per_request_s
            self._slow_until = time.monotonic() + duration_s
            self._cv.notify_all()

    def close(self, drain: bool = True, timeout: Optional[float] = None
              ) -> list:
        with self._cv:
            self._dead = True
            inbox = list(self._inbox)
            self._inbox.clear()
            self._cv.notify_all()
        for *_, fut, _t in inbox:
            _set(fut, error=ReplicaDied(
                f"replica {self.rid} closed before forwarding"))
        return self._server.close(drain=drain, timeout=timeout)

    def stats(self) -> dict:
        return self._server.stats()

    # Sessions delegate directly to the server (not through the forwarder
    # inbox): session updates are stateful and sticky, so the decoupling
    # the inbox buys stateless submits — absorb hang/slow without touching
    # the server — has nothing to protect here; a dead replica is the one
    # fault that matters, and the dead-check below catches it.

    def open_session(self, a, k: int, largest: bool = True,
                     config=None) -> str:
        with self._cv:
            if self._dead:
                raise ReplicaDied(f"replica {self.rid} is dead")
        return self._server.open_session(a, k, largest, config=config)

    def submit_update(self, session_id: str, u, sign: int = 1) -> Future:
        with self._cv:
            if self._dead:
                fut = Future()
                fut.set_exception(ReplicaDied(
                    f"replica {self.rid} is dead"))
                return fut
        return self._server.submit_update(session_id, u, sign)

    def session_result(self, session_id: str):
        return self._server.session_result(session_id)

    def close_session(self, session_id: str) -> None:
        self._server.close_session(session_id)

    # internals -------------------------------------------------------------

    def _forward_loop(self) -> None:
        while True:
            with self._cv:
                while not self._inbox and not self._dead:
                    self._cv.wait()
                if self._dead:
                    return
                now = time.monotonic()
                if now < self._hang_until:
                    self._cv.wait(timeout=self._hang_until - now)
                    continue
                delay = self._slow_per_req_s if now < self._slow_until \
                    else 0.0
                a, k, largest, fut, _t = self._inbox.popleft()
            if delay:
                time.sleep(delay)  # outside the lock
            try:
                sfut = self._server.submit(a, k, largest)
            except Exception as exc:
                _set(fut, error=exc)
                continue
            sfut.add_done_callback(
                lambda sf, fut=fut: _chain(sf, fut))
            # First-result-wins cancellation flows the other way too: a
            # cancelled internal future withdraws the server request if it
            # is still pending there.
            fut.add_done_callback(
                lambda f, sf=sfut: sf.cancel() if f.cancelled() else None)


def _set(future: Future, *, result=None, error=None) -> bool:
    try:
        if error is not None:
            future.set_exception(error)
        else:
            future.set_result(result)
        return True
    except InvalidStateError:
        return False


def _chain(src: Future, dst: Future) -> None:
    """Copy a resolved future's outcome onto another, tolerating a dst
    already resolved (hedge loser) or a cancelled src."""
    if src.cancelled():
        dst.cancel()
        return
    exc = src.exception()
    if exc is not None:
        _set(dst, error=exc)
    else:
        _set(dst, result=src.result())


# -- subprocess driver ------------------------------------------------------

def _write_frame(pipe, obj) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    pipe.write(struct.pack("<I", len(payload)))
    pipe.write(payload)
    pipe.flush()


def _read_frame(pipe):
    header = pipe.read(4)
    if len(header) < 4:
        return None
    (size,) = struct.unpack("<I", header)
    payload = pipe.read(size)
    if len(payload) < size:
        return None
    return pickle.loads(payload)


class SubprocessReplica:
    """One ``EeiServer`` in its own process
    (``repro_torch.engine.fleet_worker``), spoken to over length-prefixed
    pickle frames on the worker's stdin and stdout.

    True process isolation: a kill here is ``SIGKILL``, a hang is a worker
    that stops reading, and the parent-side reader thread converts EOF
    into :class:`ReplicaDied` on every outstanding internal future — the
    same failover path the in-process driver exercises.  Each worker limits
    its CPU threads (see ``fleet_worker``) so N workers scale on N cores
    instead of fighting over one; on the card each holds a CUDA context of
    its own.  A worker that exits before it is ready (no card, say) raises
    :class:`ReplicaDied` at once instead of after ``start_timeout_s``.
    """

    def __init__(self, rid: int, server_kwargs: Optional[dict] = None,
                 env: Optional[dict] = None, start_timeout_s: float = 120.0):
        self.rid = rid
        self._lock = threading.Lock()
        self._outstanding: "dict[int, tuple[Future, float]]" = {}
        self._ids = itertools.count()
        self._dead = False
        worker_env = dict(os.environ)
        src_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        worker_env["PYTHONPATH"] = src_root + os.pathsep + \
            worker_env.get("PYTHONPATH", "")
        if env:
            worker_env.update(env)
        t0 = time.monotonic()
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.engine.fleet_worker"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            env=worker_env)
        self._ready = threading.Event()
        self._reader = threading.Thread(
            target=self._read_loop, name=f"eei-subreplica-{rid}",
            daemon=True)
        self._reader.start()
        try:
            _write_frame(self._proc.stdin, {
                "op": "init", "server_kwargs": server_kwargs or {}})
        except (OSError, ValueError):
            pass  # the worker is gone already: the reader sees its EOF
        if not self._ready.wait(start_timeout_s):
            self.kill()
            raise ReplicaDied(
                f"replica {rid} worker failed to start in {start_timeout_s}s")
        if self._dead:
            self.kill()
            raise ReplicaDied(
                f"replica {rid} worker exited before it was ready "
                f"(exit code {self._proc.wait()})")
        #: Seconds from spawning the worker to its ``ready`` frame.
        self.start_s = time.monotonic() - t0

    def submit(self, a, k: int, largest: bool) -> Future:
        fut = Future()
        with self._lock:
            if self._dead:
                fut.set_exception(ReplicaDied(
                    f"replica {self.rid} is dead"))
                return fut
            req_id = next(self._ids)
            self._outstanding[req_id] = (fut, time.monotonic())
        try:
            _write_frame(self._proc.stdin, {
                "op": "submit", "id": req_id, "a": np.asarray(a),
                "k": int(k), "largest": bool(largest)})
        except (OSError, ValueError):  # broken pipe: worker died under us
            self._fail_all(ReplicaDied(f"replica {self.rid} pipe broken"))
        return fut

    def alive(self) -> bool:
        with self._lock:
            if self._dead:
                return False
        return self._proc.poll() is None

    def oldest_unresolved_age_s(self) -> Optional[float]:
        now = time.monotonic()
        with self._lock:
            if not self._outstanding:
                return None
            return now - min(t for _, t in self._outstanding.values())

    def kill(self) -> None:
        self._proc.kill()
        self._fail_all(ReplicaDied(f"replica {self.rid} killed"))

    def hang(self, seconds: float) -> None:
        try:
            _write_frame(self._proc.stdin, {"op": "hang", "s": seconds})
        except (OSError, ValueError):
            pass

    def slow(self, per_request_s: float, duration_s: float) -> None:
        try:
            _write_frame(self._proc.stdin, {
                "op": "slow", "s": per_request_s, "duration_s": duration_s})
        except (OSError, ValueError):
            pass

    def close(self, drain: bool = True, timeout: Optional[float] = None
              ) -> list:
        try:
            _write_frame(self._proc.stdin, {"op": "close", "drain": drain})
        except (OSError, ValueError):
            pass
        try:
            self._proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self._proc.kill()
        with self._lock:
            stranded = [fut for fut, _ in self._outstanding.values()
                        if not fut.done()]
        self._fail_all(ReplicaDied(f"replica {self.rid} closed"))
        return stranded

    def stats(self) -> dict:
        return {"rid": self.rid, "subprocess": True,
                "pid": self._proc.pid, "alive": self.alive()}

    def open_session(self, a, k: int, largest: bool = True,
                     config=None) -> str:
        # Stateful sessions need device-resident state the frame protocol
        # doesn't ship; the fleet routes sessions to in-process replicas.
        raise NotImplementedError(
            "stateful sessions require in-process replicas")

    def _fail_all(self, exc: Exception) -> None:
        with self._lock:
            self._dead = True
            outstanding = list(self._outstanding.values())
            self._outstanding.clear()
        for fut, _t in outstanding:
            _set(fut, error=exc)

    def _read_loop(self) -> None:
        while True:
            try:
                msg = _read_frame(self._proc.stdout)
            except Exception:
                msg = None
            if msg is None:  # EOF: the worker died
                self._fail_all(ReplicaDied(
                    f"replica {self.rid} worker exited"))
                self._ready.set()  # wake a constructor still waiting
                return
            op = msg.get("op")
            if op == "ready":
                self._ready.set()
            elif op == "result":
                with self._lock:
                    entry = self._outstanding.pop(msg["id"], None)
                if entry is None:
                    continue
                fut, _t = entry
                if msg.get("ok"):
                    lam, vec = msg["lam"], msg["vec"]
                    if msg.get("degraded"):
                        res = DegradedResult(
                            lam, vec, fallback=msg.get("fallback", ""))
                    else:
                        res = engine_mod.TopkResult(lam, vec)
                    _set(fut, result=res)
                else:
                    _set(fut, error=ReplicaDied(
                        f"replica {self.rid}: {msg.get('error', '?')}")
                        if msg.get("replica_fault")
                        else RuntimeError(msg.get("error", "?")))


# -- the fleet --------------------------------------------------------------


class _Replica:
    """Fleet-side bookkeeping for one replica slot."""

    __slots__ = ("rid", "driver", "state", "watchdog", "policy",
                 "outstanding", "restart_at", "last_slow_flag",
                 "kills", "restarts")

    def __init__(self, rid, driver, watchdog, policy):
        self.rid = rid
        self.driver = driver
        self.state = HEALTHY
        self.watchdog = watchdog
        self.policy = policy
        self.outstanding: "set[_FleetRequest]" = set()
        self.restart_at = 0.0
        self.last_slow_flag = 0.0
        self.kills = 0
        self.restarts = 0


class EeiFleet:
    """Front-end router over N replica ``EeiServer``s.

    ``submit(a, k, largest)`` returns a caller-facing Future that resolves
    exactly once — through whichever replica attempt wins.  See the module
    docstring for the health / failover / hedging / restart semantics.

    ``replica_mode='inprocess'`` (default) builds threaded ``EeiServer``s
    sharing one :class:`ProgramCache` (``server_factory`` overrides the
    construction); ``'subprocess'`` runs each replica in its own process
    via :class:`SubprocessReplica` — real parallelism and real process
    death, at the cost of a CUDA context, a kernel-library load and a
    program cache per process.

    ``chaos`` arms the replica-level injection points; actions fire per
    routed dispatch *against the replica that dispatch routed to* and are
    executed outside the fleet lock.
    """

    def __init__(
        self,
        n_replicas: int = 3,
        *,
        replica_mode: str = "inprocess",
        server_factory: Optional[Callable[[], EeiServer]] = None,
        server_kwargs: Optional[dict] = None,
        cache: Optional[ProgramCache] = None,
        salt: int = 0,
        deadline_s: Optional[float] = 30.0,
        probe_interval_s: float = 0.02,
        hedge_age_s: float = 0.25,
        max_redispatch: int = 3,
        slow_cooldown_s: float = 1.0,
        straggler_kwargs: Optional[dict] = None,
        restart_policy_kwargs: Optional[dict] = None,
        chaos: Optional[ChaosMonkey] = None,
        subprocess_env: Optional[dict] = None,
    ):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if replica_mode not in ("inprocess", "subprocess"):
            raise ValueError(f"unknown replica_mode {replica_mode!r}")
        self.n_replicas = n_replicas
        self.replica_mode = replica_mode
        self.salt = salt
        self.deadline_s = deadline_s
        self.probe_interval_s = probe_interval_s
        self.hedge_age_s = hedge_age_s
        self.max_redispatch = max_redispatch
        self.slow_cooldown_s = slow_cooldown_s
        self.chaos = chaos
        self._subprocess_env = subprocess_env
        self._server_kwargs = dict(server_kwargs or {})
        self._server_kwargs.setdefault("linger_ms", 2.0)
        # In-process replicas share one cache: a restarted replica's first
        # request after failover hits warm programs instead of recompiling
        # (subprocess replicas each own theirs — separate address spaces).
        self.cache = cache if cache is not None else ProgramCache()
        self._server_factory = server_factory
        self._straggler_kwargs = dict(straggler_kwargs or {})
        self._straggler_kwargs.setdefault("threshold", 3.0)
        self._straggler_kwargs.setdefault("min_samples", 8)
        self._restart_kwargs = dict(restart_policy_kwargs or {})
        if server_factory is None:
            # No device: every replica runs on the card, and with no card
            # the fleet refuses here (a worker process would say so only
            # on its own stderr).
            engine_mod._resolve_device(self._server_kwargs.get("device"))

        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._closed = False
        self._chaos_paused = False
        self._parked: "deque[_FleetRequest]" = deque()
        self._unresolved: "set[_FleetRequest]" = set()
        self.requests_submitted = 0
        self.requests_completed = 0
        self.requests_failed = 0
        self.requests_rejected = 0
        self.redispatches = 0
        self.hedges = 0
        self.hedge_wasted = 0
        self.replicas_killed = 0
        self.replicas_restarted = 0
        self.deadline_deaths = 0
        self.latencies_ms: list = []
        self._sessions: "dict[str, _FleetSession]" = {}
        self._session_ids = itertools.count()
        self.sessions_opened = 0
        self.session_updates = 0
        self.session_failovers = 0

        self._replicas = {}
        try:
            for rid in range(n_replicas):
                self._replicas[rid] = _Replica(
                    rid, self._build_driver(rid), self._build_watchdog(),
                    self._build_policy(rid))
        except BaseException:
            # No card, or a worker that would not start: stop what was
            # built (threads, worker processes) before raising.
            for replica in self._replicas.values():
                replica.driver.kill()
            raise
        self._monitor = threading.Thread(
            target=self._monitor_main, name="eei-fleet-monitor", daemon=True)
        self._monitor.start()

    # -- construction helpers ----------------------------------------------

    def _build_driver(self, rid: int):
        if self.replica_mode == "subprocess":
            return SubprocessReplica(rid, server_kwargs=self._server_kwargs,
                                     env=self._subprocess_env)
        factory = self._server_factory
        if factory is None:
            kwargs = dict(self._server_kwargs)
            kwargs.setdefault("cache", self.cache)
            factory = lambda: EeiServer(**kwargs)  # noqa: E731
        return InProcessReplica(rid, factory)

    def _build_watchdog(self) -> StragglerWatchdog:
        return StragglerWatchdog(**self._straggler_kwargs)

    def _build_policy(self, rid: int) -> RestartPolicy:
        kwargs = dict(self._restart_kwargs)
        kwargs.setdefault("seed", self.salt * 1000 + rid)
        return RestartPolicy(**kwargs)

    # -- routing ------------------------------------------------------------

    def _routable_locked(self) -> list:
        return [r.rid for r in self._replicas.values()
                if r.state in (HEALTHY, SLOW)]

    def _route_locked(self, freq: _FleetRequest,
                      exclude: tuple = ()) -> Optional[int]:
        candidates = [rid for rid in self._routable_locked()
                      if rid not in exclude]
        if not candidates:
            candidates = self._routable_locked()  # better a retry than a park
        if not candidates:
            return None
        key = (freq.n, freq.largest)
        return route_key(key, candidates, self.salt)

    # -- submission ----------------------------------------------------------

    def submit(self, a, k: int, largest: bool = True) -> Future:
        """Admit one ``(n, n)`` top-k query; returns a caller future that
        resolves exactly once, surviving replica death/hang/slowdown."""
        a = np.asarray(a)
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"expected one (n, n) matrix, got {a.shape}")
        if k < 1 or k > a.shape[0]:
            raise ValueError(f"k={k} out of range for n={a.shape[0]}")
        freq = _FleetRequest(a, k, largest)
        action = rid = None
        with self._cv:
            if self._closed:
                self.requests_rejected += 1
                freq.future.set_exception(FleetClosed(
                    "EeiFleet is closed; request was rejected"))
                return freq.future
            self.requests_submitted += 1
            self._unresolved.add(freq)
            rid = self._route_locked(freq)
            if rid is None:
                self._parked.append(freq)
            if rid is not None and self.chaos is not None \
                    and not self._chaos_paused:
                action = self.chaos.on_replica(rid)
        if rid is not None:
            self._dispatch_to(freq, rid)
            if action is not None:
                self._apply_chaos(rid, action)
        return freq.future

    def _dispatch_to(self, freq: _FleetRequest, rid: int) -> None:
        replica = self._replicas[rid]
        with self._cv:
            replica.outstanding.add(freq)
        fut = replica.driver.submit(freq.a, freq.k, freq.largest)
        with self._cv:
            freq.attempts.append((rid, fut, time.monotonic()))
        fut.add_done_callback(
            lambda f, freq=freq, rid=rid: self._on_internal_done(
                freq, rid, f))

    # -- resolution (exactly-once) ------------------------------------------

    def _on_internal_done(self, freq: _FleetRequest, rid: int,
                          fut: Future) -> None:
        replica = self._replicas.get(rid)
        with self._cv:
            if replica is not None:
                replica.outstanding.discard(freq)
            already_done = freq.future.done()
        if fut.cancelled():
            return  # we cancelled a hedge loser ourselves
        if already_done:
            if fut.exception() is None:
                with self._cv:
                    self.hedge_wasted += 1
            return
        exc = fut.exception()
        if exc is None:
            result = fut.result()
            dt_ms = None
            with self._cv:
                if freq in self._unresolved:
                    dt_ms = (time.monotonic() - freq.t_submit) * 1e3
            if _set(freq.future, result=result):
                with self._cv:
                    self._unresolved.discard(freq)
                    self.requests_completed += 1
                    if dt_ms is not None:
                        self.latencies_ms.append(dt_ms)
                    self._cv.notify_all()
                self._observe_latency(rid, freq, fut)
                self._cancel_losers(freq, fut)
            return
        # A failed attempt: replica fault -> redispatch elsewhere; genuine
        # per-request error -> resolve the caller with it.
        if _redispatchable(exc):
            self._redispatch(freq, exclude_rid=rid, cause=exc)
        else:
            if _set(freq.future, error=exc):
                with self._cv:
                    self._unresolved.discard(freq)
                    self.requests_failed += 1
                    self._cv.notify_all()
                self._cancel_losers(freq, fut)

    def _observe_latency(self, rid: int, freq: _FleetRequest,
                         fut: Future) -> None:
        replica = self._replicas.get(rid)
        if replica is None:
            return
        t_dispatch = None
        with self._cv:
            for arid, afut, t in freq.attempts:
                if afut is fut:
                    t_dispatch = t
                    break
            if t_dispatch is None or replica.state not in (HEALTHY, SLOW):
                return
            dt = time.monotonic() - t_dispatch
            flagged = replica.watchdog.observe(0, dt)
            if flagged:
                replica.last_slow_flag = time.monotonic()
                if replica.state == HEALTHY:
                    replica.state = SLOW
                    log.warning("fleet: replica %d classified SLOW "
                                "(dt=%.3fs median=%.3fs)", rid, dt,
                                replica.watchdog.median)

    def _cancel_losers(self, freq: _FleetRequest, winner: Future) -> None:
        with self._cv:
            losers = [fut for _, fut, _t in freq.attempts
                      if fut is not winner and not fut.done()]
        for fut in losers:
            fut.cancel()

    def _redispatch(self, freq: _FleetRequest, exclude_rid: int,
                    cause: Exception) -> None:
        with self._cv:
            if freq.future.done():
                return
            if freq.redispatches >= self.max_redispatch:
                # An infra failure does not indict the *request* — never
                # surface a replica's death to the caller while the fleet
                # can still restart replicas.  After max_redispatch rapid
                # failovers (flapping replicas: a kill fails a whole
                # bucket's outstanding work at once), the request takes a
                # breather in the parking lot; the monitor re-routes it at
                # probe cadence with a fresh budget.
                freq.redispatches = 0
                self._parked.append(freq)
                self._cv.notify_all()
                log.warning(
                    "fleet: (n=%d k=%d) exhausted %d redispatches (%s); "
                    "parked", freq.n, freq.k, self.max_redispatch, cause)
                return
            freq.redispatches += 1
            self.redispatches += 1
            target = self._route_locked(freq, exclude=(exclude_rid,))
            if target is None:
                self._parked.append(freq)
                self._cv.notify_all()
        if target is not None:
            log.info("fleet: redispatching (n=%d k=%d) %d -> %d after %s",
                     freq.n, freq.k, exclude_rid, target, cause)
            self._dispatch_to(freq, target)

    # -- stateful sessions ----------------------------------------------------

    def _route_session_locked(self, sid: str, generation: int,
                              exclude: tuple = ()) -> Optional[int]:
        candidates = [rid for rid in self._routable_locked()
                      if rid not in exclude]
        if not candidates:
            candidates = self._routable_locked()
        if not candidates:
            return None
        # Generation in the key: each reopen rendezvouses afresh, so a
        # session whose owner died doesn't deterministically re-pick it.
        return route_key(("session", sid, generation), candidates, self.salt)

    def open_session(self, a, k: int, largest: bool = True,
                     config=None) -> str:
        """Open a sticky stateful session; returns a fleet session id.

        The session lives on one replica (rendezvous-routed); every
        update routes there until the replica dies, at which point the
        session reopens on a healthy replica from the fleet's host
        mirror — a full solve, never a silent loss of updates.
        """
        a = np.asarray(a, dtype=np.float64)
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"expected one (n, n) matrix, got {a.shape}")
        with self._cv:
            if self._closed:
                raise FleetClosed("EeiFleet is closed")
            sid = f"fs{next(self._session_ids)}"
            rid = self._route_session_locked(sid, 0)
        if rid is None:
            raise FleetClosed("no routable replica for session")
        replica_sid = self._replicas[rid].driver.open_session(
            a, k, largest, config=config)
        rec = _FleetSession(sid, rid, replica_sid, a.copy(), int(k),
                            bool(largest), config)
        with self._cv:
            self._sessions[sid] = rec
            self.sessions_opened += 1
        return sid

    def submit_update(self, session_id: str, u, sign: int = 1) -> Future:
        """Apply a rank-1 update to a sticky session; returns a caller
        future resolving to the refreshed window.  Survives the owning
        replica's death by reopening from the host mirror."""
        with self._cv:
            rec = self._sessions.get(session_id)
        if rec is None:
            raise KeyError(f"no session {session_id!r}")
        u64 = np.asarray(u, dtype=np.float64)
        caller = Future()
        with rec.lock:
            # Mirror BEFORE dispatch: whatever happens to the replica, the
            # failover state already includes this update.
            rec.a_host += int(sign) * np.outer(u64, u64)
            rid, gen = rec.rid, rec.generation
        with self._cv:
            self.session_updates += 1
        try:
            fut = self._replicas[rid].driver.submit_update(
                rec.replica_sid, u, sign)
        except Exception as exc:
            self._session_recover(rec, gen, caller, exc)
            return caller
        fut.add_done_callback(
            lambda f, rec=rec, gen=gen, caller=caller:
                self._on_session_done(rec, gen, caller, f))
        return caller

    def _on_session_done(self, rec: _FleetSession, gen: int,
                         caller: Future, fut: Future) -> None:
        if fut.cancelled():
            caller.cancel()
            return
        exc = fut.exception()
        if exc is None:
            _set(caller, result=fut.result())
            return
        if _redispatchable(exc):
            self._session_recover(rec, gen, caller, exc)
        else:
            _set(caller, error=exc)

    def _session_recover(self, rec: _FleetSession, gen: int,
                         caller: Future, cause: Exception) -> None:
        """Reopen a session whose replica failed and resolve the caller
        from the reopened window.

        The mirror already contains every submitted update (including the
        failed one), so the reopen's seed solve *is* the correct current
        window — the caller gets it as a :class:`DegradedResult` (full
        solve instead of the warm path).  One reopen per failure burst:
        concurrent failures of the same generation reuse the first
        reopen."""
        with rec.lock:
            if rec.generation == gen:
                # First failure of this generation: reopen elsewhere.
                with self._cv:
                    if self._closed:
                        _set(caller, error=cause)
                        return
                    target = self._route_session_locked(
                        rec.sid, gen + 1, exclude=(rec.rid,))
                if target is None:
                    _set(caller, error=cause)
                    return
                log.warning("fleet: session %s failing over %d -> %d (%s)",
                            rec.sid, rec.rid, target, cause)
                try:
                    replica_sid = self._replicas[target].driver.open_session(
                        rec.a_host, rec.k, rec.largest, config=rec.config)
                except Exception:
                    _set(caller, error=cause)
                    return
                rec.rid = target
                rec.replica_sid = replica_sid
                rec.generation = gen + 1
                with self._cv:
                    self.session_failovers += 1
            rid, replica_sid = rec.rid, rec.replica_sid
        try:
            res = self._replicas[rid].driver.session_result(replica_sid)
        except Exception:
            _set(caller, error=cause)
            return
        _set(caller, result=DegradedResult(
            np.asarray(res.eigenvalues), np.asarray(res.vectors),
            fallback="session_reopen"))

    def session_result(self, session_id: str):
        with self._cv:
            rec = self._sessions.get(session_id)
        if rec is None:
            raise KeyError(f"no session {session_id!r}")
        with rec.lock:
            rid, replica_sid = rec.rid, rec.replica_sid
        return self._replicas[rid].driver.session_result(replica_sid)

    def close_session(self, session_id: str) -> None:
        with self._cv:
            rec = self._sessions.pop(session_id, None)
        if rec is None:
            return
        with rec.lock:
            rid, replica_sid = rec.rid, rec.replica_sid
        try:
            self._replicas[rid].driver.close_session(replica_sid)
        except Exception:
            pass  # the replica is gone; the session went with it

    # -- chaos ----------------------------------------------------------------

    def _apply_chaos(self, rid: int, action: str) -> None:
        cfg = self.chaos.config
        replica = self._replicas.get(rid)
        if replica is None:
            return
        log.warning("fleet: chaos %s on replica %d", action, rid)
        if action == "kill":
            self._kill_replica(rid, reason="chaos kill")
        elif action == "hang":
            replica.driver.hang(cfg.replica_hang_s)
        elif action == "slow":
            replica.driver.slow(cfg.replica_slow_s,
                                duration_s=max(10 * cfg.replica_slow_s, 0.5))

    def _kill_replica(self, rid: int, reason: str) -> None:
        """Mark a replica dead and kill its driver.  The kill fails every
        internal future the replica owed, and those failures redispatch
        through `_on_internal_done` — one failover path for chaos kills,
        organic deaths, and deadline expiries alike."""
        with self._cv:
            replica = self._replicas.get(rid)
            if replica is None or replica.state in (DEAD, RESTARTING):
                return
            replica.state = DEAD
            replica.kills += 1
            self.replicas_killed += 1
            self._cv.notify_all()
        log.warning("fleet: replica %d dead (%s)", rid, reason)
        replica.driver.kill()  # outside the fleet lock

    # -- health monitor -------------------------------------------------------

    def _monitor_main(self) -> None:
        while True:
            with self._cv:
                if self._closed and not self._unresolved:
                    return
                states = {rid: r.state for rid, r in self._replicas.items()}
            kills = []
            now = time.monotonic()
            for rid, state in states.items():
                replica = self._replicas[rid]
                if state in (HEALTHY, SLOW):
                    if not replica.driver.alive():
                        kills.append((rid, "driver died"))
                        continue
                    age = replica.driver.oldest_unresolved_age_s()
                    if self.deadline_s is not None and age is not None \
                            and age > self.deadline_s:
                        with self._cv:
                            self.deadline_deaths += 1
                        kills.append((rid, f"deadline {age:.2f}s"))
                        continue
                    if state == SLOW:
                        self._hedge_replica(replica, now)
                        with self._cv:
                            if now - replica.last_slow_flag > \
                                    self.slow_cooldown_s:
                                replica.state = HEALTHY
                                replica.watchdog.reset()
                elif state == DEAD:
                    self._schedule_restart(replica, now)
                elif state == RESTARTING and now >= replica.restart_at:
                    self._restart_replica(replica)
            for rid, reason in kills:
                self._kill_replica(rid, reason)
            self._flush_parked()
            with self._cv:
                self._cv.wait(timeout=self.probe_interval_s)

    def _hedge_replica(self, replica: _Replica, now: float) -> None:
        """Second attempt on a healthy replica for requests stuck on a
        slow one past ``hedge_age_s``; first result wins, the loser's
        internal future is cancelled at resolution."""
        to_hedge = []
        with self._cv:
            for freq in list(replica.outstanding):
                if freq.hedged or freq.future.done():
                    continue
                last_dispatch = freq.attempts[-1][2] if freq.attempts \
                    else freq.t_submit
                if now - last_dispatch < self.hedge_age_s:
                    continue
                target = self._route_locked(freq, exclude=(replica.rid,))
                if target is None or target == replica.rid:
                    continue
                freq.hedged = True
                self.hedges += 1
                to_hedge.append((freq, target))
        for freq, target in to_hedge:
            log.info("fleet: hedging (n=%d k=%d) from slow replica %d "
                     "to %d", freq.n, freq.k, replica.rid, target)
            self._dispatch_to(freq, target)

    def _schedule_restart(self, replica: _Replica, now: float) -> None:
        with self._cv:
            if replica.state != DEAD:
                return
            if replica.policy.give_up:
                return  # stays dead; rendezvous keeps it out of routing
            if self._closed and not self._unresolved:
                return  # nothing left that a restart could serve
            delay = replica.policy.next_delay()
            replica.restart_at = now + delay
            replica.state = RESTARTING
        log.warning("fleet: replica %d restarting in %.3fs (restart %d)",
                    replica.rid, delay, replica.policy.restarts)

    def _restart_replica(self, replica: _Replica) -> None:
        with self._cv:
            if self._closed and not self._unresolved:
                return  # don't spawn a replica the close will never reap
        try:
            driver = self._build_driver(replica.rid)
        except Exception as exc:
            log.error("fleet: replica %d rebuild failed: %s",
                      replica.rid, exc)
            with self._cv:
                replica.state = DEAD  # next tick reschedules (bounded)
            return
        with self._cv:
            replica.driver = driver
            replica.watchdog.reset()
            replica.state = HEALTHY
            replica.restarts += 1
            self.replicas_restarted += 1
            self._cv.notify_all()
        log.warning("fleet: replica %d restarted", replica.rid)

    def _flush_parked(self) -> None:
        """Re-route requests parked while no replica was routable."""
        while True:
            with self._cv:
                if not self._parked:
                    return
                freq = self._parked[0]
                if freq.future.done():
                    self._parked.popleft()
                    continue
                rid = self._route_locked(freq)
                if rid is None:
                    return  # still nowhere to go
                self._parked.popleft()
            self._dispatch_to(freq, rid)

    # -- lifecycle ------------------------------------------------------------

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until every admitted request has resolved (or ``timeout``
        expires; returns False then)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._unresolved:
                left = None if deadline is None else \
                    deadline - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._cv.wait(timeout=min(left, 0.1) if left is not None
                              else 0.1)
        return True

    def close(self, drain: bool = True, timeout: Optional[float] = None
              ) -> list:
        """Shut the fleet down.  Returns the caller futures still
        unresolved at return — empty on a clean drain (mirrors
        ``EeiServer.close``).  ``drain=False`` fails parked/queued work
        with :class:`FleetClosed` but still lets in-flight attempts land.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            first = not self._closed
            self._closed = True
            self._chaos_paused = True  # no new faults while draining
            parked = list(self._parked) if not drain else []
            if not drain:
                self._parked.clear()
            self._cv.notify_all()
        for freq in parked:
            if _set(freq.future, error=FleetClosed(
                    "EeiFleet closed before this request was dispatched")):
                with self._cv:
                    self._unresolved.discard(freq)
                    self.requests_failed += 1
        if drain and first:
            self.flush(timeout=timeout)
        with self._cv:
            self._cv.notify_all()
        self._monitor.join(
            None if deadline is None else
            max(deadline - time.monotonic(), 0.05))
        for replica in self._replicas.values():
            left = None if deadline is None else \
                max(deadline - time.monotonic(), 0.0)
            if replica.state in (HEALTHY, SLOW):
                replica.driver.close(drain=drain, timeout=left)
        with self._cv:
            stranded = [freq.future for freq in self._unresolved]
        if stranded:
            log.error("fleet: close() leaving %d future(s) unresolved",
                      len(stranded))
        return stranded

    def __enter__(self) -> "EeiFleet":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- observability --------------------------------------------------------

    def stats(self) -> dict:
        with self._cv:
            lat = sorted(self.latencies_ms)
            snap = {
                "n_replicas": self.n_replicas,
                "replica_states": {
                    r.rid: r.state for r in self._replicas.values()},
                "requests_submitted": self.requests_submitted,
                "requests_completed": self.requests_completed,
                "requests_failed": self.requests_failed,
                "requests_rejected": self.requests_rejected,
                "requests_unresolved": len(self._unresolved),
                "requests_parked": len(self._parked),
                "redispatches": self.redispatches,
                "hedges": self.hedges,
                "hedge_wasted": self.hedge_wasted,
                "replicas_killed": self.replicas_killed,
                "replicas_restarted": self.replicas_restarted,
                "deadline_deaths": self.deadline_deaths,
                "sessions_open": len(self._sessions),
                "sessions_opened": self.sessions_opened,
                "session_updates": self.session_updates,
                "session_failovers": self.session_failovers,
                "chaos_injected": (
                    self.chaos.counts() if self.chaos is not None else {}),
            }
            per_replica = {}
            for r in self._replicas.values():
                try:
                    per_replica[r.rid] = r.driver.stats()
                except Exception:
                    per_replica[r.rid] = {"unavailable": True}

        def pct(p):
            if not lat:
                return 0.0
            return lat[min(len(lat) - 1, int(p / 100.0 * len(lat)))]

        snap.update({
            "p50_latency_ms": pct(50),
            "p99_latency_ms": pct(99),
            "per_replica": per_replica,
        })
        return snap
