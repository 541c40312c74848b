"""EeiServer: concurrent continuous-batching serving runtime for EEI top-k.

The twin of ``repro.engine.server`` on the port's engine:

    submit() ──> request queues (heterogeneous n, k, largest; thread-safe
         │       from any number of producer threads, with optional
         │       ``max_pending`` backpressure: block or raise QueueFull)
         ▼  coalesce: FIFO groups sharing a key (bucket_n, largest)
    admission ──> dynamic stacks (full stacks immediately; *partial* stacks
         │        once their oldest request has lingered ``linger_ms``,
         ▼        so sparse streams drain with no explicit flush())
    ProgramCache (bucket -> built program; hit / miss / compile counters;
         │        internally locked, shareable between servers)
         ▼
    dispatch (≤ max_inflight stacks of device buffers outstanding)
         │
         ▼
    retire ──> completion futures (per-request slices out of the padded
               stack; guard rows never escape; a failed dispatch or a
               closed server resolves futures with the error, so callers
               blocked on ``future.result()`` are never stranded)

Two run modes share every dispatch, retire and cache path:

* **caller-driven** (``linger_ms=None``, the default): no background
  threads.  ``submit()`` dispatches full stacks inline (via ``pump()``)
  and ``flush()`` drains partial stacks and blocks until every future
  resolves.
* **threaded** (``linger_ms`` set): a background *admission* thread forms
  stacks (full groups at once, partial groups once their oldest request
  has waited ``linger_ms``) and a *retire* thread copies the oldest
  in-flight stack to the host and resolves its futures.  ``flush()`` is a
  drain barrier; ``close()`` drains everything, joins both threads and
  resolves any late ``submit()`` with :class:`ServerClosed`.

One re-entrant server lock guards the queues, the in-flight deque and all
counters; one condition variable (``_cv``) carries every wakeup.  The
``ProgramCache`` lock is a leaf: lock order is server lock -> cache lock,
never the reverse.  The admission thread builds and launches outside the
server lock.

The engine's programs run host-driven loops (the Householder reduce, the
recurrences, Lanczos's convergence checks), so a launch runs most of a
solve before it returns; the retire step's device-to-host copy is the
sync, and a device error surfaces either at the launch or at that copy.
Both paths split and fall back alike.

Shape bucketing bounds the programs built: every request runs through one
of a few padded shapes.  ``n`` rounds up to the block-grid granule
(``N_ALIGN``); ``b`` and ``k`` round to powers of two.  Matrices pad from
``(n, n)`` to ``(bn, bn)`` as ``diag(A, c I)`` with the guard ``c``
strictly outside the spectrum (Gershgorin) on the side *away* from the
requested extreme, so no guard eigenvalue enters a top-k (or bottom-k)
window and the A-block eigenpairs are preserved exactly (the padded block
decouples at an exactly-zero junction).

The server runs on ``device``: the card unless the caller names another,
and with no card it raises, as ``SolverEngine`` does.  With a ``mesh``
(``EeiServer(mesh=)``) each bucket plans with it, so a stack that puts a
matrix on every device of the mesh's data axis takes the ``sharded``
backend, and its pow2 bucket rounds up to a multiple of that axis; the
server then runs on the mesh's first device.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import threading
import time
import weakref
from collections import OrderedDict, deque
from concurrent.futures import Future, InvalidStateError
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.engine import engine as engine_mod
from repro_torch.engine import registry
from repro_torch.engine.plan import (
    SolverPlan,
    fallback_chain,
    packed_plan_for,
    plan_for,
    resolved_pack_n_max,
)
from repro_torch.engine.verify import verify_topk_host
from repro_torch.kernels import blocks
from repro_torch.runtime.chaos import ChaosError, ChaosFailure, ChaosMonkey
from repro_torch.runtime.fault_tolerance import decorrelated_jitter

log = logging.getLogger("repro_torch.engine.server")

#: Default matrix-size granule for shape buckets (``repro``'s f32 sublane
#: granule, kept so that both packages bucket alike).
N_ALIGN = 8

_SERVER_DTYPES = (np.dtype(np.float32), np.dtype(np.float64))


def _np_dtype(dtype) -> np.dtype:
    """The numpy dtype for a torch, numpy or string float32/float64."""
    if isinstance(dtype, torch.dtype):
        dtype = torch.empty((), dtype=dtype).numpy().dtype
    dtype = np.dtype(dtype)
    if dtype not in _SERVER_DTYPES:
        raise TypeError(f"expected float32 or float64, got {dtype}")
    return dtype


class ServerClosed(RuntimeError):
    """The server has been closed; the request was not (or will not be)
    served.  Late ``submit()`` calls get a future with this error already
    set rather than an exception at the call site, so producer loops that
    race ``close()`` observe a uniformly-resolved future either way."""


class QueueFull(RuntimeError):
    """``max_pending`` backpressure bound hit under ``pending_policy
    ='except'``."""


class VerifyFailed(RuntimeError):
    """A served result failed post-solve verification (non-finite entries,
    residual above tolerance, broken norm or bracket order).  It is the
    *cause* that routes a request down the fallback chain; it resolves a
    future only when every fallback (the eigh oracle too) also failed, or
    with ``fallback=False``."""


class DegradedResult(engine_mod.TopkResult):
    """A :class:`~repro_torch.engine.engine.TopkResult` served by the
    fallback chain instead of the request's bucket program.

    Still a 2-tuple (``eigenvalues, vectors``); ``degraded`` is ``True``
    and ``fallback`` names the chain link that produced it (for example
    ``"eigh_oracle"``).  It passed host verification before it resolved.
    """

    degraded = True

    def __new__(cls, eigenvalues, vectors, fallback: str = ""):
        self = super().__new__(cls, eigenvalues, vectors)
        self.fallback = fallback
        return self


def _is_transient(exc: BaseException) -> bool:
    """Whether a dispatch failure is worth retrying in place: an injected
    :class:`ChaosFailure`, or anything with a truthy ``transient``."""
    return isinstance(exc, ChaosFailure) or bool(
        getattr(exc, "transient", False))


def _eigh_oracle(a: np.ndarray, k: int, largest: bool):
    """Terminal fallback: numpy float64 LAPACK eigh on the host, the one
    link that shares no failure mode with the device path.  Returns
    ``(lam (k,), vecs (k, n))`` ascending at the requested extreme."""
    lam, v = np.linalg.eigh(np.asarray(a, dtype=np.float64))
    if largest:
        return lam[-k:], v[:, -k:].T
    return lam[:k], v[:, :k].T


def _bucket_n(n: int, align: int) -> int:
    """Matrix-size bucket: ``n`` rounded up to the block-grid granule."""
    return -(-n // align) * align


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def make_eei_stream(
    requests: int, n: int, k: int, seed: int = 0, mixed: bool = False
) -> list:
    """Pre-generated request stream: ``[(a (n_i, n_i) np.float32, k_i), ...]``.

    Generated outside any timed region.  ``mixed`` samples ``n_i`` from
    ``{max(8, n // 2), n, n + max(8, n // 2)}`` and ``k_i`` from ``1..k``
    per request; otherwise every request is ``(n, k)``.  The same draws as
    ``repro``'s, so a seed gives both packages the same stream.
    """
    rng = np.random.default_rng(seed)
    sizes = sorted({max(8, n // 2), n, n + max(8, n // 2)}) if mixed else [n]
    stream = []
    for _ in range(requests):
        n_i = int(rng.choice(sizes))
        k_i = int(rng.integers(1, k + 1)) if mixed else k
        a = rng.standard_normal((n_i, n_i)).astype(np.float32)
        stream.append(((a + a.T) / 2, min(k_i, n_i)))
    return stream


class ShapeBucket(NamedTuple):
    """One padded program shape: every request executes through one of these."""

    b: int  # stack size (power of two)
    n: int  # matrix size (block-grid aligned)
    k: int  # top-k (power of two, <= n)
    largest: bool

    @classmethod
    def for_requests(cls, count: int, n: int, k: int, largest: bool,
                     n_align: int = N_ALIGN) -> "ShapeBucket":
        bn = _bucket_n(n, n_align)
        return cls(
            b=blocks.pow2_bucket(count),
            n=bn,
            k=min(blocks.pow2_bucket(k), bn),
            largest=bool(largest),
        )


class PackedBucket(NamedTuple):
    """One segment-packed program shape: ``b`` block-diagonal rows of width
    ``n``, each carrying up to ``s`` request segments, solved through the
    engine's ``packed_topk`` program (``k`` lanes per slot).  A tuple of
    another arity than :class:`ShapeBucket`, so the two never collide as
    :class:`ProgramCache` keys."""

    b: int  # stack size (power of two)
    n: int  # packed row width (block-grid aligned)
    s: int  # slot lanes per row (power of two)
    k: int  # per-slot window (power of two, >= every rider's k)
    largest: bool


def _bucket_label(bucket) -> str:
    """Human-readable stats key for either bucket type."""
    tail = "L" if bucket.largest else "S"
    if isinstance(bucket, PackedBucket):
        return f"pack:b{bucket.b}n{bucket.n}s{bucket.s}k{bucket.k}{tail}"
    return f"b{bucket.b}n{bucket.n}k{bucket.k}{tail}"


class _PendingProgram:
    """In-flight build: later same-bucket getters wait on the event."""

    __slots__ = ("event", "program", "error")

    def __init__(self):
        self.event = threading.Event()
        self.program = None
        self.error = None


class ProgramCache:
    """Bucket -> built program, with observable counters.

    A build (``topk_program`` / ``packed_topk_program`` for the bucket's
    plan, window and verify flag) is an explicit, countable event: a mixed
    stream builds at most one program per distinct bucket.  The CUDA
    kernels themselves are compiled once per process at their first launch
    (``kernels/build.py``), not per bucket.

    Thread-safe, and the lock is never held across a build: a miss installs
    a per-key placeholder under the lock and builds outside it, so gets
    for other buckets stay one dict probe while same-bucket racers wait on
    the placeholder's event.  A *successful* build happens at most once
    per bucket (``compiles == distinct buckets`` when every build
    succeeds), and ``hits + misses`` always equals the number of ``get()``
    calls (a waiter counts as a hit).  A failed build is re-raised to every
    waiter and evicted, so the next ``get()`` retries it as a fresh miss.
    One cache may be shared between servers (``EeiServer(cache=...)``).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._programs: "OrderedDict[tuple, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    @property
    def compiles(self) -> int:
        """Number of programs built (== misses: one build per miss)."""
        return self.misses

    def __len__(self) -> int:
        return len(self._programs)

    def buckets(self) -> list:
        """The distinct buckets built so far (insertion order)."""
        with self._lock:
            return [key[0] for key in self._programs]

    def reset_counters(self) -> None:
        """Zero the hit/miss counters, keeping the built programs."""
        with self._lock:
            self.hits = 0
            self.misses = 0

    def get(self, bucket, plan: SolverPlan, dtype, *,
            verify: bool = False) -> object:
        key = (bucket, plan, _np_dtype(dtype).name, bool(verify))
        with self._lock:
            found = self._programs.get(key)
            if found is None:
                self.misses += 1  # this caller owns the build
                entry = _PendingProgram()
                self._programs[key] = entry
            else:
                self.hits += 1
                if not isinstance(found, _PendingProgram):
                    return found
        if found is not None:
            # Same-bucket racer: wait for the owner's build.
            found.event.wait()
            if found.error is not None:
                raise found.error
            return found.program
        try:
            if isinstance(bucket, PackedBucket):
                prog = engine_mod.packed_topk_program(
                    plan, bucket.k, bucket.largest, bool(verify))
            else:
                prog = engine_mod.topk_program(
                    plan, bucket.k, bucket.largest, bool(verify))
        except BaseException as exc:
            entry.error = exc
            with self._lock:
                if self._programs.get(key) is entry:
                    del self._programs[key]  # next get() retries the build
            entry.event.set()
            raise
        entry.program = prog
        with self._lock:
            self._programs[key] = prog
        entry.event.set()
        return prog


@dataclasses.dataclass(eq=False)  # identity equality: queue removal by object
class _Request:
    a: np.ndarray  # (n, n) symmetric, already cast to the server dtype
    n: int
    k: int
    largest: bool
    future: Future
    t_submit: float


@dataclasses.dataclass
class _InflightStack:
    result: object  # the program's output tensors on the server's device
    requests: list  # the _Requests whose slices ride in this stack
    bucket: object  # ShapeBucket, or PackedBucket for segment-packed stacks
    # Packed stacks only: per-request ``(row, slot, offset)`` parallel to
    # ``requests``; retire slices each request's window out of its slot.
    layout: Optional[list] = None


@dataclasses.dataclass
class DispatchRecord:
    """One dispatched stack, as the conformance checks replay it: the exact
    padded input, the plan and bucket it ran under, and the requests whose
    futures were resolved from its rows.  Recorded only when the server is
    constructed with ``record_dispatches=True``."""

    bucket: object  # ShapeBucket, or PackedBucket for packed dispatches
    plan: SolverPlan
    stack: np.ndarray  # the assembled (bucket.b, bucket.n, bucket.n) input
    requests: list  # [_Request, ...] in row (packed: layout) order
    #: ``time.monotonic()`` when the group left the admission queue.
    t_dispatch: float = 0.0
    # Packed dispatches only: the (b, s) int32 segment layout operands and
    # the per-request (row, slot, offset) triples parallel to ``requests``.
    seg_off: Optional[np.ndarray] = None
    seg_len: Optional[np.ndarray] = None
    layout: Optional[list] = None


@dataclasses.dataclass(eq=False)
class _ServerSession:
    """Server-side record of one stateful spectral session.

    ``a_host`` is a float64 numpy mirror of the session matrix, updated on
    every submitted update; the degrade rung rebuilds from it, so it never
    lags the stream.  ``lock`` serializes updates and snapshot reads per
    session (the engine's ``SpectralSession`` is not thread-safe)."""

    sid: str
    engine: object  # SolverEngine
    session: object  # repro_torch.engine.session.SpectralSession
    a_host: np.ndarray
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)
    closed: bool = False


class EeiServer:
    """Concurrent continuous-batching server for heterogeneous EEI queries.

    ``submit(a, k, largest)`` enqueues one query over a single symmetric
    matrix and returns a ``concurrent.futures.Future`` resolving to a
    ``TopkResult`` of numpy arrays with the *request's* shapes (``(k,)``
    eigenvalues, ``(k, n)`` vectors); bucket padding never leaks.
    ``submit`` is safe from any number of producer threads in both modes.

    With ``linger_ms=None`` (default) dispatch is caller-driven: ``pump()``
    dispatches every coalesce group that fills a whole ``max_batch`` stack
    (``submit`` pumps automatically) and ``flush()`` drains everything and
    blocks until all futures resolve.  With ``linger_ms`` set, a background
    admission thread dispatches full stacks at once and partial stacks once
    their oldest request has waited ``linger_ms``, and a retire thread
    resolves futures off the producers' path; ``close()`` (or the context
    manager) drains and joins the threads.

    ``max_pending`` bounds the queued-but-undispatched requests:
    ``pending_policy='block'`` makes ``submit`` wait (caller-driven mode
    drains inline instead), ``'except'`` raises :class:`QueueFull`.

    ``plan`` pins one :class:`SolverPlan` for every bucket; by default each
    bucket gets ``plan_for((b, n, n), k=..., mesh=mesh)``, so small buckets
    may route to ``eigh`` and larger ones to the EEI chains, and, with a
    ``mesh`` whose data axis holds more than one device, stacks at least
    that large to the ``sharded`` backend (buckets round up to the axis).
    ``device`` is where the stacks run: the card by default (no card:
    ``RuntimeError``), the mesh's first device with a mesh or a sharded
    ``plan`` (another ``device`` is refused).

    **Fault tolerance** (on by default): ``verify=True`` appends the
    engine's ``verify`` stage to every bucket program, so each row is
    checked before its future resolves.  A dispatch failure retries
    transients up to ``max_retries`` with decorrelated-jitter backoff, then
    bisects the stack to isolate the poisoned request(s); an isolated
    failing request (and any row failing verify) escalates through
    ``plan.fallback_chain()`` and a numpy eigh oracle and resolves as a
    :class:`DegradedResult`.  ``fallback=False`` fails fast instead.
    ``chaos`` arms deterministic fault injection
    (:class:`~repro_torch.runtime.chaos.ChaosMonkey`).
    """

    def __init__(
        self,
        plan: Optional[SolverPlan] = None,
        *,
        device=None,
        mesh=None,
        max_batch: int = 64,
        max_inflight: int = 2,
        n_align: int = N_ALIGN,
        dtype=np.float32,
        linger_ms: Optional[float] = None,
        max_pending: int = 0,
        pending_policy: str = "block",
        cache: Optional[ProgramCache] = None,
        record_dispatches: bool = False,
        pack: str = "never",
        pack_row_n: int = 64,
        pack_k: int = 8,
        verify: bool = True,
        fallback: bool = True,
        max_retries: int = 2,
        retry_backoff_s: float = 0.005,
        retry_backoff_cap_s: float = 1.0,
        retry_jitter_seed: Optional[int] = None,
        chaos: Optional[ChaosMonkey] = None,
        adaptive_linger: bool = True,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        if linger_ms is not None and linger_ms < 0:
            raise ValueError(f"linger_ms must be >= 0, got {linger_ms}")
        if max_pending < 0:
            raise ValueError(f"max_pending must be >= 0, got {max_pending}")
        if pending_policy not in ("block", "except"):
            raise ValueError(
                f"pending_policy must be 'block' or 'except', "
                f"got {pending_policy!r}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if pack not in ("auto", "never", "always"):
            raise ValueError(
                f"pack must be 'auto', 'never' or 'always', got {pack!r}")
        if pack_row_n < n_align:
            raise ValueError(
                f"pack_row_n must be >= n_align ({n_align}), got {pack_row_n}")
        if pack_k < 1:
            raise ValueError(f"pack_k must be >= 1, got {pack_k}")
        for m in (mesh, plan.mesh if plan is not None else None):
            if m is None:
                continue
            if device is not None and not engine_mod._same_device(
                    torch.device(device), m.first_device):
                raise ValueError(
                    f"a server on a mesh runs on its first device "
                    f"{m.first_device}, not {device}")
            device = m.first_device
        self.device = engine_mod._resolve_device(device)
        self._plan = plan
        self._mesh = mesh
        # Stack buckets are powers of two, so a non-pow2 bound would round
        # *up* past the operator's limit: floor it (48 serves stacks of 32).
        self.max_batch = 1 << (max_batch.bit_length() - 1)
        self.max_inflight = max_inflight
        self.n_align = n_align
        self.dtype = _np_dtype(dtype)
        self.linger_ms = linger_ms
        self.max_pending = max_pending
        self.pending_policy = pending_policy
        self.pack = pack
        self.pack_row_n = _bucket_n(pack_row_n, n_align)
        self.pack_k = int(pack_k)
        # Slot lanes per packed row: bounded by the smallest footprint a
        # segment can occupy (one align granule).
        self._pack_max_slots = max(1, self.pack_row_n // n_align)
        self.cache = cache if cache is not None else ProgramCache()
        self.record_dispatches = record_dispatches
        self.dispatch_log: "list[DispatchRecord]" = []
        self.verify = bool(verify)
        self.fallback = bool(fallback)
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.retry_backoff_cap_s = float(retry_backoff_cap_s)
        # Decorrelated jitter, so stacks that failed together do not retry
        # together; seedable, drawn under the server lock (numpy Generators
        # are not thread-safe), and recorded in ``retry_delays_s``.
        self._retry_rng = np.random.default_rng(retry_jitter_seed)
        self.retry_delays_s: list = []
        self.chaos = chaos

        # One re-entrant lock guards queues, in-flight state and counters;
        # one condition variable carries every wakeup (notify_all on any
        # state change).  Re-entrant so that a future callback re-entering
        # submit() from a server thread cannot self-deadlock.
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        # Coalesce key -> FIFO deque of requests.
        self._queues: "OrderedDict[tuple, deque]" = OrderedDict()
        self._inflight: "deque[_InflightStack]" = deque()
        # Every admitted-but-unresolved caller future -> its submit time,
        # kept by the done callback across every resolution path;
        # ``close(timeout=...)`` returns its keys when a drain wedges.
        self._unresolved: "dict[Future, float]" = {}
        self._pending = 0  # queued, not yet popped for dispatch
        self._dispatching = 0  # groups popped but not yet in-flight/failed
        self._retiring = 0  # stacks popped by the retire thread, syncing
        self._draining = 0  # flush() barriers forcing partial dispatch
        self._closed = False
        self._admission_done = False
        self.requests_submitted = 0
        self.requests_completed = 0
        self.requests_failed = 0
        self.requests_rejected = 0  # late submits after close()
        self.requests_cancelled = 0  # caller-cancelled while still pending
        self.stacks_dispatched = 0
        self.packed_stacks_dispatched = 0
        self.packed_requests_completed = 0
        # Pad waste: every grid cell of a stack (b * n^2) against the cells
        # of real request data, counted once per *successfully retired*
        # stack (see ``stats()``).
        self.grid_cells_total = 0
        self.grid_cells_real = 0
        self._pad_cells_by_bucket: dict = {}  # bucket -> [real, total]
        self.latencies_ms: list = []
        # Robustness counters (see stats()).
        self.verify_failed = 0
        self.retries = 0
        self.stack_splits = 0
        self.requests_degraded = 0
        self.fallbacks_by_plan: dict = {}  # chain link name -> resolutions

        # Adaptive linger: per-coalesce-key EWMA of inter-arrival gaps.  A
        # hot key shrinks its effective linger toward the time its stack
        # would plausibly still take to fill; ``linger_ms`` stays the upper
        # bound.  The rate state survives reset_stats(); the trim counter
        # does not.
        self.adaptive_linger = bool(adaptive_linger)
        self._key_rate: dict = {}  # key -> [ewma_gap_s, last_t, gap_samples]
        self.linger_trims = 0

        # Stateful spectral sessions.  Threaded mode runs updates on a lazy
        # session thread (serial per server, so per-session order is
        # dispatch order); caller-driven mode runs them inline.
        self._sessions: dict = {}  # sid -> _ServerSession
        self._session_ids = itertools.count()
        self._session_ops: "deque[tuple]" = deque()
        self._session_busy = 0
        self._session_thread: Optional[threading.Thread] = None
        self.sessions_opened = 0
        self.session_updates = 0
        self.session_fast_updates = 0
        self.session_full_resolves = 0
        self.session_degraded = 0

        # The thread topology is fixed at construction (the linger *value*
        # is re-read each admission round).
        self._threaded = linger_ms is not None
        self._admission_thread: Optional[threading.Thread] = None
        self._retire_thread: Optional[threading.Thread] = None
        if self._threaded:
            self._admission_thread = threading.Thread(
                target=self._admission_main, name="eei-admission", daemon=True)
            self._retire_thread = threading.Thread(
                target=self._retire_main, name="eei-retire", daemon=True)
            self._admission_thread.start()
            self._retire_thread.start()

    # -- admission ---------------------------------------------------------

    def submit(self, a, k: int, largest: bool = True) -> Future:
        """Admit one ``(n, n)`` top-k query; returns its completion future.

        Thread-safe.  After ``close()`` the returned future already carries
        a :class:`ServerClosed` error.  With ``max_pending`` set, blocks or
        raises :class:`QueueFull` per ``pending_policy``.
        """
        a = np.asarray(a, dtype=self.dtype)
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"expected one (n, n) matrix, got {a.shape}")
        n = a.shape[0]
        if k < 1 or k > n:
            raise ValueError(f"k={k} out of range for n={n}")
        req = _Request(a=a, n=n, k=int(k), largest=bool(largest),
                       future=Future(), t_submit=time.monotonic())
        with self._cv:
            if self._closed:
                return self._reject_locked(req)
            if self.max_pending and self._pending >= self.max_pending:
                if self.pending_policy == "except":
                    raise QueueFull(
                        f"{self._pending} requests pending "
                        f"(max_pending={self.max_pending})")
                if not self._threaded:
                    # No admission thread to make space: drain inline.
                    self.flush()
                else:
                    while self._pending >= self.max_pending:
                        self._cv.wait()
                        if self._closed:
                            return self._reject_locked(req)
            key = self._coalesce_key(req)
            self._queues.setdefault(key, deque()).append(req)
            self._pending += 1
            self.requests_submitted += 1
            req.t_submit = time.monotonic()  # linger clock starts at enqueue
            self._unresolved[req.future] = req.t_submit
            self._observe_arrival_locked(key, req.t_submit)
            self._cv.notify_all()
        # A cancel() while the request is still pending pulls it out of its
        # group.  The callback holds a weakref only: a Future keeps its done
        # callbacks, and a strong capture would pin the input matrix.
        req_ref = weakref.ref(req)
        req.future.add_done_callback(
            lambda fut, ref=req_ref: self._on_future_done(ref, fut))
        if not self._threaded:
            self.pump()
        return req.future

    def _on_future_done(self, req_ref, fut: Future) -> None:
        """Retire a resolved future from ``_unresolved``, and dequeue a
        request whose caller cancelled it while still pending.  A cancel
        after the group was popped rides along (retire tolerates the
        pre-resolved future)."""
        with self._cv:
            self._unresolved.pop(fut, None)
        if not fut.cancelled():
            return
        req = req_ref()
        if req is None:
            return
        with self._cv:
            q = self._queues.get(self._coalesce_key(req))
            if q is None or req not in q:
                return  # already dispatched (or being popped): rides along
            q.remove(req)
            if not q:
                del self._queues[self._coalesce_key(req)]
            self._pending -= 1
            self.requests_cancelled += 1
            self._cv.notify_all()  # backpressure space; linger re-evaluates

    def _reject_locked(self, req: _Request) -> Future:
        self.requests_rejected += 1
        req.future.set_exception(ServerClosed(
            "EeiServer is closed; request was rejected"))
        return req.future

    def _coalesce_key(self, req: _Request) -> tuple:
        # k is not part of the key: mixed-k requests stack together under
        # the group's max k and each future slices its own k back out.
        # Packable requests of any n share one key per extreme.
        if self._packable(req):
            return ("pack", req.largest)
        return (_bucket_n(req.n, self.n_align), req.largest)

    def _packable(self, req: _Request) -> bool:
        """Whether a request rides the segment-packed path: ``"auto"``
        packs footprints up to the calibrated
        :func:`~repro_torch.engine.plan.resolved_pack_n_max` (and half a
        row), ``"always"`` anything that fits a row; ``k`` stays within
        ``pack_k``."""
        if self.pack == "never" or req.k > self.pack_k:
            return False
        footprint = _bucket_n(req.n, self.n_align)
        if self.pack == "always":
            return footprint <= self.pack_row_n
        return footprint <= min(resolved_pack_n_max(), self.pack_row_n // 2)

    def _group_cap(self, key: tuple) -> int:
        """Requests forming a *full* stack for this coalesce key: packed
        keys fill ``max_batch`` rows of up to ``_pack_max_slots`` segments,
        bucketed keys one request per row."""
        if key[0] == "pack":
            return self.max_batch * self._pack_max_slots
        return self.max_batch

    def _pop_group_locked(self, key: tuple) -> list:
        q = self._queues[key]
        group = [q.popleft()
                 for _ in range(min(len(q), self._group_cap(key)))]
        if not q:
            del self._queues[key]
        self._pending -= len(group)
        self._cv.notify_all()  # space for backpressured producers
        return group

    def _pop_all_locked(self) -> list:
        """Every queued group (each at most one stack), queues emptied."""
        groups = []
        while self._queues:
            groups.append(self._pop_group_locked(next(iter(self._queues))))
        return groups

    # -- dispatch ----------------------------------------------------------

    def _guard_value(self, a: np.ndarray, largest: bool) -> float:
        """Diagonal guard for the padded block: strictly outside the
        spectrum, on the side away from the requested extreme."""
        radius = np.sum(np.abs(a), axis=1) - np.abs(np.diagonal(a))
        diag = np.diagonal(a)
        lo = float(np.min(diag - radius))
        hi = float(np.max(diag + radius))
        margin = max(1.0, 0.01 * (hi - lo))
        return lo - margin if largest else hi + margin

    def _assemble(self, group: list, bucket: ShapeBucket) -> np.ndarray:
        stack = np.zeros((bucket.b, bucket.n, bucket.n), dtype=self.dtype)
        for row, req in enumerate(group):
            stack[row, : req.n, : req.n] = req.a
            if req.n < bucket.n:
                guard = self._guard_value(req.a, req.largest)
                idx = np.arange(req.n, bucket.n)
                stack[row, idx, idx] = guard
        # Batch padding repeats the first padded row (real data, never an
        # all-zero input); retire slices it off.
        stack[len(group):] = stack[0]
        return stack

    def _plan_bucket(self, group: list) -> tuple:
        bucket = ShapeBucket.for_requests(
            len(group), max(r.n for r in group), max(r.k for r in group),
            group[0].largest, n_align=self.n_align)
        # The plan is a function of the bucket alone, so one bucket never
        # runs under two plans.
        plan = self._plan
        if plan is None:
            plan = plan_for((bucket.b, bucket.n, bucket.n), k=bucket.k,
                            mesh=self._mesh)
        # The sharded stages split the stack evenly over the mesh's batch
        # axis (SolverEngine._run_chunk pads for the same reason): round the
        # pow2 bucket up to the next multiple.
        mult = plan.batch_axis_size
        if bucket.b % mult:
            bucket = bucket._replace(b=bucket.b + (-bucket.b) % mult)
        return bucket, plan

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        # A copy: the recorded stack stays the program's exact input.
        return torch.tensor(x, device=self.device)

    def _launch(self, bucket, plan: SolverPlan, operands: tuple):
        """Fetch the bucket program and run it on ``operands`` (one stack
        for bucketed programs; stack + the two ``(b, s)`` segment arrays for
        packed ones), retrying *transient* failures up to ``max_retries``
        with decorrelated-jitter backoff.  The chaos compile and launch
        points sit here, upstream of the retry logic, like the failures
        they model."""
        prev_delay = self.retry_backoff_s
        for attempt in range(self.max_retries + 1):
            try:
                if self.chaos is not None:
                    self.chaos.on_compile()
                program = self.cache.get(
                    bucket, plan, self.dtype, verify=self.verify)
                if self.chaos is not None:
                    self.chaos.on_launch()
                return program(*operands)
            except Exception as exc:
                if attempt >= self.max_retries or not _is_transient(exc):
                    raise
                with self._cv:
                    self.retries += 1
                    prev_delay = decorrelated_jitter(
                        self._retry_rng, self.retry_backoff_s, prev_delay,
                        self.retry_backoff_cap_s)
                    self.retry_delays_s.append(prev_delay)
                    self._cv.notify_all()
                log.warning("EEI dispatch retry %d/%d after transient: %s",
                            attempt + 1, self.max_retries, exc)
                time.sleep(prev_delay)  # outside the lock

    def _dispatch(self, group: list) -> None:
        """Assemble, fetch the program, launch.  Never raises: a failure
        (planning, assembly, build, launch) is retried, split or escalated
        down the fallback chain, or resolves the group's futures with the
        error.  Appends to ``_inflight`` under the lock.  Groups whose every
        member is packable take the packed path (re-derived here, so
        bisection halves of a packed stack re-pack consistently).  Pad-waste
        cells are counted at retire, not here."""
        t_disp = time.monotonic()
        if group and all(self._packable(req) for req in group):
            self._dispatch_packed(group, t_disp)
            return
        try:
            bucket, plan = self._plan_bucket(group)
            stack = self._assemble(group, bucket)
            result = self._launch(bucket, plan, (self._to_device(stack),))
        except Exception as exc:  # build/launch failure after retries:
            self._handle_group_failure(group, exc)  # split / fallback / fail
            return
        with self._cv:
            self._inflight.append(_InflightStack(result, list(group), bucket))
            self.stacks_dispatched += 1
            if self.record_dispatches:
                self.dispatch_log.append(DispatchRecord(
                    bucket=bucket, plan=plan, stack=stack,
                    requests=list(group), t_dispatch=t_disp))
            self._cv.notify_all()

    def _packed_plan(self) -> SolverPlan:
        """The plan packed stacks run under: a pinned ``plan=`` whose method
        registers a ``packed_topk`` chain, else
        :func:`~repro_torch.engine.plan.packed_plan_for` at
        ``pack_row_n``."""
        plan = self._plan
        if plan is not None:
            try:
                chain = registry.composition_for(
                    plan.method, plan.spectrum == "windowed").packed_topk
                if chain is None:
                    chain = registry.composition_for(
                        plan.method, False).packed_topk
            except KeyError:
                chain = None
            if chain is not None:
                return plan
            log.debug("pinned plan %s has no packed chain; using "
                      "packed_plan_for(%d)", plan, self.pack_row_n)
        return packed_plan_for(self.pack_row_n)

    def _dispatch_packed(self, group: list, t_disp: float = 0.0) -> None:
        """Segment-packed dispatch: first-fit pack the group's matrices
        into block-diagonal rows of width ``pack_row_n``, chunk the rows
        into stacks of at most ``max_batch`` and launch each chunk through
        the ``packed_topk`` program (stack + ``(b, s)`` segment layout).
        Each chunk is its own in-flight stack, so a failure bisects or
        escalates only its own riders."""
        try:
            rows = blocks.pack_segments(
                [req.n for req in group], self.pack_row_n,
                self._pack_max_slots, align=self.n_align)
            plan = self._packed_plan()
        except Exception as exc:
            self._handle_group_failure(group, exc)
            return
        for start in range(0, len(rows), self.max_batch):
            chunk = rows[start:start + self.max_batch]
            sub = [group[i] for row in chunk for i, _, _ in row]
            try:
                bucket, stack, seg_off, seg_len, layout = \
                    self._assemble_packed(group, chunk)
                result = self._launch(
                    bucket, plan,
                    (self._to_device(stack), self._to_device(seg_off),
                     self._to_device(seg_len)))
            except Exception as exc:
                self._handle_group_failure(sub, exc)
                continue
            with self._cv:
                self._inflight.append(_InflightStack(
                    result, sub, bucket, layout=layout))
                self.stacks_dispatched += 1
                self.packed_stacks_dispatched += 1
                if self.record_dispatches:
                    self.dispatch_log.append(DispatchRecord(
                        bucket=bucket, plan=plan, stack=stack,
                        requests=sub, seg_off=seg_off, seg_len=seg_len,
                        layout=layout, t_dispatch=t_disp))
                self._cv.notify_all()

    def _assemble_packed(self, group: list, chunk: list):
        """Build one packed stack from ``chunk``: a list of packed rows,
        each ``[(group_index, offset, length), ...]`` from
        :func:`~repro_torch.kernels.blocks.pack_segments`.

        Returns ``(bucket, stack, seg_off, seg_len, layout)``; ``layout``
        holds per-request ``(row, slot, offset)`` triples in ride order.
        Diagonal cells outside every segment carry spaced, distinct guards
        strictly outside the row's union Gershgorin interval, on the side
        away from the requested extreme.  Batch-pad rows repeat row 0 with
        every ``seg_len`` zero: empty slots verify vacuously and retire
        nothing."""
        largest = group[0].largest
        b = blocks.pow2_bucket(len(chunk))
        s = blocks.pow2_bucket(max(len(row) for row in chunk))
        kmax = max(group[i].k for row in chunk for i, _, _ in row)
        n = self.pack_row_n
        bucket = PackedBucket(
            b=b, n=n, s=s, k=min(blocks.pow2_bucket(kmax), n),
            largest=largest)
        stack = np.zeros((b, n, n), dtype=self.dtype)
        seg_off = np.zeros((b, s), dtype=np.int32)
        seg_len = np.zeros((b, s), dtype=np.int32)
        layout = []
        for row, segs in enumerate(chunk):
            lo, hi = np.inf, -np.inf
            covered = np.zeros(n, dtype=bool)
            for slot, (i, off, length) in enumerate(segs):
                a = group[i].a
                stack[row, off:off + length, off:off + length] = a
                seg_off[row, slot] = off
                seg_len[row, slot] = length
                layout.append((row, slot, off))
                radius = np.sum(np.abs(a), axis=1) - np.abs(np.diagonal(a))
                diag = np.diagonal(a)
                lo = min(lo, float(np.min(diag - radius)))
                hi = max(hi, float(np.max(diag + radius)))
                covered[off:off + length] = True
            idx = np.where(~covered)[0]
            if idx.size:
                margin = max(1.0, 0.01 * (hi - lo))
                step = margin / idx.size
                if largest:
                    vals = lo - margin - step * np.arange(idx.size)
                else:
                    vals = hi + margin + step * np.arange(idx.size)
                stack[row, idx, idx] = vals
        stack[len(chunk):] = stack[0]
        return bucket, stack, seg_off, seg_len, layout

    @staticmethod
    def _set(future: Future, *, result=None, error=None) -> bool:
        """Resolve a future, tolerating a caller-side ``cancel()``: raising
        out of a server thread here would poison the thread's other
        requests."""
        try:
            if error is not None:
                future.set_exception(error)
            else:
                future.set_result(result)
            return True
        except InvalidStateError:
            return False

    def _fail(self, requests: list, exc: Exception) -> None:
        """Resolve a group's futures with the error.  Counters update
        before the futures resolve (see ``_retire``)."""
        log.error("EEI stack dispatch failed for %d request(s): %s",
                  len(requests), exc)
        with self._cv:
            self.requests_failed += len(requests)
            self._cv.notify_all()
        for req in requests:
            self._set(req.future, error=exc)

    def _handle_group_failure(self, group: list, exc: Exception) -> None:
        """A stack failed (dispatch error after retries, or a device error
        at retire).  With the fallback chain on, bisect multi-request groups
        (each half re-dispatches through the normal path) and escalate
        isolated requests down the chain; with ``fallback=False``, fail."""
        if not self.fallback:
            self._fail(group, exc)
            return
        if len(group) > 1:
            log.warning("EEI stack of %d failed (%s); bisecting",
                        len(group), exc)
            with self._cv:
                self.stack_splits += 1
                self._cv.notify_all()
            mid = len(group) // 2
            self._dispatch(group[:mid])
            self._dispatch(group[mid:])
            return
        self._fallback_request(group[0], exc)

    def _fallback_request(self, req: _Request, cause: Exception) -> None:
        """Escalate one isolated request down the fallback chain.

        Each link re-solves the request's *unpadded* matrix on the server's
        device and is host-verified before it may resolve the future; the
        terminal link is the numpy eigh oracle.  Resolves a
        :class:`DegradedResult` at the first verified link, or the original
        cause if every link fails (a non-finite input, say)."""
        a = req.a
        for name, plan in fallback_chain():
            try:
                res = engine_mod.SolverEngine(plan, self.device).topk(
                    self._to_device(a), req.k, req.largest)
                lam = _host(res.eigenvalues)
                vec = _host(res.vectors)
            except Exception as exc:
                log.debug("fallback %s raised for n=%d k=%d: %s",
                          name, req.n, req.k, exc)
                continue
            if not bool(verify_topk_host(a, lam, vec).ok):
                log.debug("fallback %s failed verification (n=%d k=%d)",
                          name, req.n, req.k)
                continue
            self._resolve_degraded(req, lam, vec, name, cause)
            return
        try:
            lam, vec = _eigh_oracle(a, req.k, req.largest)
        except Exception as exc:
            self._fail([req], exc)
            return
        if not bool(verify_topk_host(a, lam, vec).ok):
            # Even LAPACK gave no verifiable answer: the input itself is
            # poisoned.  Surface the original cause, not garbage.
            self._fail([req], cause)
            return
        self._resolve_degraded(req, lam, vec, "eigh_oracle", cause)

    def _resolve_degraded(self, req: _Request, lam: np.ndarray,
                          vec: np.ndarray, name: str,
                          cause: Exception) -> None:
        log.info("EEI request (n=%d, k=%d) resolved degraded via %s "
                 "(cause: %s)", req.n, req.k, name, cause)
        t_done = time.monotonic()
        with self._cv:
            self.requests_degraded += 1
            self.requests_completed += 1
            self.fallbacks_by_plan[name] = \
                self.fallbacks_by_plan.get(name, 0) + 1
            self.latencies_ms.append((t_done - req.t_submit) * 1e3)
            self._cv.notify_all()
        self._set(req.future, result=DegradedResult(
            lam.astype(self.dtype), vec.astype(self.dtype), fallback=name))

    def _retire(self, inflight: _InflightStack) -> None:
        """Copy one stack's results to the host, verify, and resolve its
        requests' futures.

        Called with the lock held in caller-driven mode and without it from
        the retire thread.  With ``verify`` on the program returned
        ``(result, VerifyFlags)``: rows whose flags fail, or whose host
        slices are non-finite (the chaos NaN lands on the host copy, like a
        corrupted transfer), escalate down the fallback chain.  A device
        error at the copy re-enters the split/fallback path."""
        result = inflight.result
        flags_ok = None
        try:
            if self.verify:
                result, flags = result
                flags_ok = _host(flags.ok)  # sync point
            lam = _host(result.eigenvalues)  # sync point (verify off)
            vec = _host(result.vectors)
        except Exception as exc:  # device-side failure surfaces here
            self._handle_group_failure(inflight.requests, exc)
            return
        if self.chaos is not None:
            vec = self.chaos.on_result(vec)
            self.chaos.on_retire_sleep()
        t_done = time.monotonic()
        results = []
        escalate = []
        if inflight.layout is not None:
            # Packed stack: lam (b, S, K), vec (b, S, K, N), flags (b, S).
            # Each request slices its k pairs out of its own slot's window
            # and its n columns out of its segment's offset.
            for req, (row, slot, off) in zip(inflight.requests,
                                             inflight.layout):
                if req.largest:
                    lam_r = lam[row, slot, -req.k:]
                    vec_r = vec[row, slot, -req.k:, off:off + req.n]
                else:
                    lam_r = lam[row, slot, : req.k]
                    vec_r = vec[row, slot, : req.k, off:off + req.n]
                if flags_ok is not None and not (
                        bool(flags_ok[row, slot])
                        and np.all(np.isfinite(lam_r))
                        and np.all(np.isfinite(vec_r))):
                    escalate.append(req)
                    continue
                results.append((req, engine_mod.TopkResult(lam_r, vec_r)))
        else:
            for row, req in enumerate(inflight.requests):
                # `bucket.k` ascending pairs at the requested extreme, the
                # guards on the far side: the request's k pairs are the
                # last k for largest, the first k for smallest.
                if req.largest:
                    lam_r = lam[row, -req.k:]
                    vec_r = vec[row, -req.k:, : req.n]
                else:
                    lam_r = lam[row, : req.k]
                    vec_r = vec[row, : req.k, : req.n]
                if flags_ok is not None and not (
                        bool(flags_ok[row])
                        and np.all(np.isfinite(lam_r))
                        and np.all(np.isfinite(vec_r))):
                    escalate.append(req)
                    continue
                results.append((req, engine_mod.TopkResult(lam_r, vec_r)))
        # Counters update BEFORE futures resolve: a caller woken by
        # future.result() may read stats() at once.
        with self._cv:
            self.latencies_ms.extend(
                (t_done - req.t_submit) * 1e3 for req, _ in results)
            self.requests_completed += len(results)
            if inflight.layout is not None:
                self.packed_requests_completed += len(results)
            self.verify_failed += len(escalate)
            self._account_retired_locked(inflight)
            self._cv.notify_all()
        for req, res in results:
            self._set(req.future, result=res)
        for req in escalate:
            cause = VerifyFailed(
                f"result for (n={req.n}, k={req.k}) failed verification")
            if self.fallback:
                self._fallback_request(req, cause)
            else:
                self._fail([req], cause)

    def _account_retired_locked(self, inflight: _InflightStack) -> None:
        """Pad-waste cells, once per *successfully retired* stack: a
        request that rides a retried or bisected stack counts once, and
        requests served by the (unpadded) fallback chain add nothing."""
        bucket = inflight.bucket
        total = bucket.b * bucket.n * bucket.n
        real = sum(req.n * req.n for req in inflight.requests)
        self.grid_cells_total += total
        self.grid_cells_real += real
        cells = self._pad_cells_by_bucket.setdefault(bucket, [0, 0])
        cells[0] += real
        cells[1] += total

    def _make_room_locked(self) -> None:
        """Caller-driven mode: retire the oldest stack(s) until a launch
        keeps at most ``max_inflight`` stacks of device buffers live."""
        while len(self._inflight) >= self.max_inflight:
            self._retire(self._inflight.popleft())

    # -- background threads ------------------------------------------------

    #: Inter-arrival gaps a key must show before its EWMA can shrink the
    #: linger window.
    _LINGER_MIN_SAMPLES = 4
    #: EWMA smoothing factor for inter-arrival gaps.
    _LINGER_EWMA_ALPHA = 0.3
    #: Effective linger = ``_LINGER_GAP_FACTOR * ewma_gap * remaining
    #: slots``: the time the stack would still take to fill at the observed
    #: rate, with 2x slack for jitter.
    _LINGER_GAP_FACTOR = 2.0

    def _observe_arrival_locked(self, key: tuple, t: float) -> None:
        rate = self._key_rate.get(key)
        if rate is None:
            self._key_rate[key] = [0.0, t, 0]
            return
        # A gap longer than the base linger means the key went idle, not
        # that the rate is that slow: clamp it, which also heals a
        # stale-hot estimate after a burst.
        gap = max(t - rate[1], 0.0)
        if self.linger_ms:
            gap = min(gap, self.linger_ms / 1e3)
        alpha = self._LINGER_EWMA_ALPHA
        rate[0] = gap if rate[2] == 0 else (1 - alpha) * rate[0] + alpha * gap
        rate[1] = t
        rate[2] += 1

    def _effective_linger_locked(self, key: tuple, qlen: int,
                                 base_s: float) -> float:
        """Per-key linger window: the base, shrunk for hot keys to about
        the time their stack would take to fill.  Shrink-only."""
        if not self.adaptive_linger:
            return base_s
        rate = self._key_rate.get(key)
        if rate is None or rate[2] < self._LINGER_MIN_SAMPLES:
            return base_s
        remaining = max(self._group_cap(key) - qlen, 1)
        return min(base_s, self._LINGER_GAP_FACTOR * rate[0] * remaining)

    def _ready_key_locked(self, now: float):
        """Dispatchable coalesce key, or ``(None, deadline)`` where
        ``deadline`` is the next linger expiry (``None`` if no queue).

        Among ready keys (full, linger-expired or force-drained) the one
        with the oldest head request wins (FIFO across keys), so a
        continuously full key cannot starve another key's expired partial
        group.  A dispatch made earlier than the base window because of an
        adaptive trim counts in ``linger_trims``."""
        force = self._closed or self._draining > 0
        linger_s = (self.linger_ms or 0.0) / 1e3
        best_key = best_t = deadline = None
        best_trim = False
        for key, q in self._queues.items():
            head_t = q[0].t_submit
            eff = self._effective_linger_locked(key, len(q), linger_s)
            expiry = head_t + eff
            full = len(q) >= self._group_cap(key)
            if full or force or now >= expiry:
                if best_t is None or head_t < best_t:
                    best_key, best_t = key, head_t
                    best_trim = (not full and not force
                                 and eff < linger_s
                                 and now < head_t + linger_s)
            elif best_key is None:
                deadline = expiry if deadline is None else \
                    min(deadline, expiry)
        if best_key is not None and best_trim:
            self.linger_trims += 1
        return best_key, (None if best_key is not None else deadline)

    def _admission_loop(self) -> None:
        while True:
            if self.chaos is not None:
                # Before any group is held: a chaos crash kills the thread
                # between stacks and the restart resumes with nothing lost.
                self.chaos.on_thread("admission")
            with self._cv:
                while True:
                    key, deadline = self._ready_key_locked(time.monotonic())
                    if key is not None:
                        group = self._pop_group_locked(key)
                        self._dispatching += 1
                        break
                    if self._closed and not self._queues:
                        return
                    timeout = None
                    if deadline is not None:
                        timeout = max(deadline - time.monotonic(), 0.0) + 1e-4
                    self._cv.wait(timeout)
            try:
                with self._cv:
                    # Capacity gate: at most max_inflight stacks of device
                    # buffers outstanding (on device + being retired).
                    while len(self._inflight) + self._retiring >= \
                            self.max_inflight:
                        if not self._retire_thread.is_alive():
                            # Retirement is gone for good: fail the held
                            # group instead of waiting forever.
                            raise ServerClosed(
                                "retire thread died; cannot dispatch")
                        self._cv.wait(timeout=0.1)
                # Outside the lock: assembly, program lookup and the launch
                # never block producers or the retire thread.
                self._dispatch(group)
            except BaseException as exc:
                # _dispatch absorbs Exceptions, so this is a crash or the
                # capacity gate's escape: resolve the popped group first.
                self._fail(group, ServerClosed(
                    f"admission thread crashed: {exc!r}"))
                raise
            finally:
                with self._cv:
                    self._dispatching -= 1
                    self._cv.notify_all()

    def _admission_main(self) -> None:
        try:
            while True:
                try:
                    self._admission_loop()
                    return
                except ChaosError:
                    # Injected between stacks, nothing held: restart.
                    log.warning(
                        "EEI admission thread: injected crash; restarting")
        except BaseException as exc:  # never die silently: fail the queue
            log.exception("EEI admission thread crashed")
            with self._cv:
                # Nothing drains the queues any more: close, so that later
                # submits are rejected instead of stranded.
                self._closed = True
                groups = self._pop_all_locked()
            for group in groups:
                self._fail(group, ServerClosed(
                    f"admission thread crashed: {exc!r}"))
        finally:
            with self._cv:
                self._admission_done = True
                self._cv.notify_all()

    def _retire_loop(self) -> None:
        while True:
            if self.chaos is not None:
                # Before any stack is popped, so a crash strands nothing.
                self.chaos.on_thread("retire")
            with self._cv:
                while not self._inflight:
                    if self._admission_done and not self._dispatching:
                        return
                    self._cv.wait()
                stack = self._inflight.popleft()
                self._retiring += 1
                self._cv.notify_all()
            try:
                self._retire(stack)
            except BaseException as exc:
                # _retire absorbs Exceptions; the popped stack is no longer
                # in _inflight, so resolve it here.
                self._fail(stack.requests, ServerClosed(
                    f"retire thread crashed: {exc!r}"))
                raise
            finally:
                with self._cv:
                    self._retiring -= 1
                    self._cv.notify_all()

    def _retire_main(self) -> None:
        # A few restarts: a crash fails the stacks it held and keeps
        # retiring what admission still launches.  Injected ChaosErrors fire
        # between stacks and restart in place without using the budget.
        crashes = 0
        while crashes < 8:
            try:
                self._retire_loop()
                return
            except ChaosError:
                log.warning("EEI retire thread: injected crash; restarting")
            except BaseException as exc:
                crashes += 1
                log.exception("EEI retire thread crashed")
                with self._cv:
                    self._closed = True  # stop admitting: retirement is sick
                    stacks = list(self._inflight)
                    self._inflight.clear()
                    self._cv.notify_all()
                for stack in stacks:
                    self._fail(stack.requests, ServerClosed(
                        f"retire thread crashed: {exc!r}"))

    # -- stateful sessions -------------------------------------------------

    def _session_plan(self, n: int, k: int) -> SolverPlan:
        plan = self._plan
        if plan is None:
            bn = _bucket_n(n, self.n_align)
            plan = plan_for((1, bn, bn), k=k, mesh=self._mesh)
        return plan

    def open_session(self, a, k: int, largest: bool = True,
                     config=None) -> str:
        """Open a stateful spectral session over one ``(n, n)`` matrix on
        the server's device.  Seeds it with a full solve (synchronous, a
        setup call) and returns a session id for :meth:`submit_update`,
        :meth:`session_result` and :meth:`close_session`."""
        a = np.asarray(a, dtype=np.float64)
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"expected one (n, n) matrix, got {a.shape}")
        with self._cv:
            if self._closed:
                raise ServerClosed("EeiServer is closed")
        eng = engine_mod.SolverEngine(self._session_plan(a.shape[0], k),
                                      self.device)
        session = eng.open_session(a, k, largest, config=config)
        with self._cv:
            if self._closed:
                raise ServerClosed("EeiServer is closed")
            sid = f"s{next(self._session_ids)}"
            self._sessions[sid] = _ServerSession(
                sid=sid, engine=eng, session=session, a_host=a.copy())
            self.sessions_opened += 1
            if self._threaded and self._session_thread is None:
                self._session_thread = threading.Thread(
                    target=self._session_main, name="eei-session",
                    daemon=True)
                self._session_thread.start()
            self._cv.notify_all()
        return sid

    def _get_session(self, session_id: str) -> _ServerSession:
        with self._cv:
            rec = self._sessions.get(session_id)
        if rec is None:
            raise KeyError(f"no session {session_id!r}")
        return rec

    def submit_update(self, session_id: str, u, sign: int = 1) -> Future:
        """Apply ``A <- A + sign * u u^T`` to a session; returns a future
        resolving to the refreshed top-k window (numpy arrays, like
        :meth:`submit`).  Per-session updates resolve in submission order.
        A fast-path failure degrades to a full host solve from the mirror
        and resolves a :class:`DegradedResult`."""
        rec = self._get_session(session_id)
        u = np.asarray(u, dtype=self.dtype)
        fut = Future()
        with self._cv:
            if self._closed or rec.closed:
                fut.set_exception(ServerClosed(
                    f"session {session_id!r} is closed"))
                return fut
            if self._threaded:
                self._session_ops.append((rec, u, int(sign), fut))
                self._cv.notify_all()
                return fut
        self._session_exec_update(rec, u, int(sign), fut)
        return fut

    def session_result(self, session_id: str):
        """Snapshot of a session's current top-k window (numpy arrays)."""
        rec = self._get_session(session_id)
        with rec.lock:
            res = rec.session.result()
            return engine_mod.TopkResult(
                _host(res.eigenvalues), _host(res.vectors))

    def session_stats(self, session_id: str) -> dict:
        rec = self._get_session(session_id)
        with rec.lock:
            return rec.session.stats()

    def close_session(self, session_id: str) -> None:
        """Drop a session.  Updates already queued for it resolve with
        :class:`ServerClosed`; an update in execution finishes normally."""
        with self._cv:
            rec = self._sessions.pop(session_id, None)
            if rec is not None:
                rec.closed = True
                self._cv.notify_all()

    def _session_exec_update(self, rec: _ServerSession, u: np.ndarray,
                             sign: int, fut: Future) -> None:
        """Run one update under the session lock; never raises.  A
        malformed request (bad shape, non-finite input) fails its future;
        anything else degrades to a host full solve from the mirror."""
        from repro_torch.engine import session as session_mod

        u64 = np.asarray(u, dtype=np.float64)
        with rec.lock:
            try:
                before = rec.session.full_resolves
                res = rec.engine.update(
                    rec.session, session_mod.Rank1Update(u, sign))
                rec.a_host += sign * np.outer(u64, u64)
            except ValueError as exc:  # malformed request: fail, don't mask
                with self._cv:
                    self.requests_failed += 1
                    self._cv.notify_all()
                self._set(fut, error=exc)
                return
            except Exception as exc:
                self._session_degrade(rec, u64, sign, fut, exc)
                return
            lam = _host(res.eigenvalues)
            vec = _host(res.vectors)
            full = rec.session.full_resolves > before
        with self._cv:
            self.session_updates += 1
            if full:
                self.session_full_resolves += 1
            else:
                self.session_fast_updates += 1
            self._cv.notify_all()
        self._set(fut, result=engine_mod.TopkResult(lam, vec))

    def _session_degrade(self, rec: _ServerSession, u64: np.ndarray,
                         sign: int, fut: Future, cause: Exception) -> None:
        """Terminal session rung: host eigh full solve from the mirror.
        Called with ``rec.lock`` held and the mirror not yet updated for
        this ``u`` (the engine commits state only on success)."""
        from repro_torch.engine import session as session_mod

        log.warning("session %s update degrading to host solve (%s)",
                    rec.sid, cause)
        if not self.fallback:
            with self._cv:
                self.requests_failed += 1
                self._cv.notify_all()
            self._set(fut, error=cause)
            return
        try:
            rec.a_host += sign * np.outer(u64, u64)
            session_mod.host_reseed(rec.session, torch.as_tensor(
                rec.a_host, device=rec.session.device))
            res = rec.session.result()
            lam = _host(res.eigenvalues)
            vec = _host(res.vectors)
        except Exception:
            with self._cv:
                self.requests_failed += 1
                self._cv.notify_all()
            self._set(fut, error=cause)
            return
        with self._cv:
            self.session_updates += 1
            self.session_full_resolves += 1
            self.session_degraded += 1
            self._cv.notify_all()
        self._set(fut, result=DegradedResult(
            lam, vec, fallback="host_reseed"))

    def _session_main(self) -> None:
        """Session executor (threaded mode): drains ``_session_ops``
        serially; exits once the server is closed and the queue is empty."""
        while True:
            with self._cv:
                while not self._session_ops:
                    if self._closed:
                        return
                    self._cv.wait()
                rec, u, sign, fut = self._session_ops.popleft()
                self._session_busy += 1
                self._cv.notify_all()
            try:
                if rec.closed:
                    self._set(fut, error=ServerClosed(
                        f"session {rec.sid!r} is closed"))
                else:
                    self._session_exec_update(rec, u, sign, fut)
            finally:
                with self._cv:
                    self._session_busy -= 1
                    self._cv.notify_all()

    # -- draining ----------------------------------------------------------

    def pump(self) -> None:
        """Dispatch every coalesce group that fills a whole stack; partial
        groups keep accumulating in their own key.  In threaded mode this
        is only a wakeup for the admission thread."""
        if self._threaded:
            with self._cv:
                self._cv.notify_all()
            return
        with self._cv:
            for key in [k for k, q in self._queues.items()
                        if len(q) >= self._group_cap(k)]:
                while len(self._queues.get(key, ())) >= self._group_cap(key):
                    self._make_room_locked()
                    self._dispatch(self._pop_group_locked(key))

    def flush(self) -> None:
        """Drain: dispatch all queued requests (partial stacks too) and
        block until every in-flight stack has retired.  Idempotent; in
        threaded mode a barrier (the admission thread dispatches)."""
        if self._threaded:
            with self._cv:
                self._draining += 1
                self._cv.notify_all()
                try:
                    while (self._queues or self._dispatching
                           or self._inflight or self._retiring
                           or self._session_ops or self._session_busy):
                        if self._admission_done and not (
                                self._retire_thread
                                and self._retire_thread.is_alive()):
                            break  # threads gone; nothing will drain more
                        self._cv.wait(timeout=0.1)
                finally:
                    self._draining -= 1
                    self._cv.notify_all()
            return
        with self._cv:
            while self._queues:
                self._make_room_locked()
                key = next(iter(self._queues))
                self._dispatch(self._pop_group_locked(key))
            while self._inflight:
                self._retire(self._inflight.popleft())

    def close(self, drain: bool = True, timeout: Optional[float] = None
              ) -> list:
        """Shut the server down.  Idempotent.  Returns the caller futures
        still unresolved when it returns: **empty on a clean drain**.

        ``drain=True`` dispatches everything still queued and waits for
        every future; ``drain=False`` resolves queued requests with
        :class:`ServerClosed` (stacks already launched still retire).  In
        threaded mode ``timeout`` bounds the whole call: if the drain
        wedges, ``close`` returns the unresolved futures instead of
        hanging.
        """
        with self._cv:
            first = not self._closed
            self._closed = True
            groups = self._pop_all_locked() if first and not drain else []
            session_ops = []
            if first and not drain:
                session_ops = list(self._session_ops)
                self._session_ops.clear()
            self._cv.notify_all()
        for group in groups:
            self._fail(group, ServerClosed(
                "EeiServer closed before this request was dispatched"))
        for _rec, _u, _sign, fut in session_ops:
            self._set(fut, error=ServerClosed(
                "EeiServer closed before this update was applied"))
        if self._threaded:
            deadline = None if timeout is None else \
                time.monotonic() + timeout
            threads = [self._admission_thread, self._retire_thread]
            if self._session_thread is not None:
                threads.append(self._session_thread)
            for thread in threads:
                left = None if deadline is None else \
                    max(deadline - time.monotonic(), 0.0)
                thread.join(left)
            if (self._admission_thread.is_alive()
                    or self._retire_thread.is_alive()):
                with self._cv:
                    stranded = list(self._unresolved)
                log.error(
                    "EeiServer.close(): drain did not finish within %ss; "
                    "%d future(s) still unresolved", timeout, len(stranded))
                return stranded
        elif first:
            if drain:
                self.flush()
            else:
                # Stacks already launched still retire: their futures must
                # resolve.
                with self._cv:
                    while self._inflight:
                        self._retire(self._inflight.popleft())
        return []

    def __enter__(self) -> "EeiServer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- replica introspection (read by EeiFleet) --------------------------

    def alive(self) -> bool:
        """Whether this server can still make progress on admitted work.
        A closed server, or a threaded server whose service threads died
        (bounded restarts exhausted), is not alive."""
        with self._cv:
            if self._closed:
                return False
        if self._threaded:
            return (self._admission_thread.is_alive()
                    and self._retire_thread.is_alive())
        return True

    def unresolved_futures(self) -> list:
        """Snapshot of every admitted caller future not yet resolved, in
        submit order."""
        with self._cv:
            return sorted(self._unresolved, key=self._unresolved.get)

    def oldest_unresolved_age_s(self, now: Optional[float] = None
                                ) -> Optional[float]:
        """Age of the oldest admitted-but-unresolved request (None when
        idle) — the fleet's deadline probe: a hung replica accepts work
        and never answers, so *only* this age keeps growing."""
        with self._cv:
            if not self._unresolved:
                return None
            oldest = min(self._unresolved.values())
        return (time.monotonic() if now is None else now) - oldest

    def pending_manifest(self) -> list:
        """Queued-but-undispatched requests: ``[{n, k, largest, age_s}]``."""
        now = time.monotonic()
        with self._cv:
            return [
                {"n": r.n, "k": r.k, "largest": r.largest,
                 "age_s": now - r.t_submit}
                for q in self._queues.values() for r in q
            ]

    def inflight_manifest(self) -> list:
        """Dispatched-but-unretired stacks: ``[{bucket, rows, oldest_age_s}]``
        (``bucket`` labelled as ``repro`` labels it)."""
        now = time.monotonic()
        with self._cv:
            return [
                {"bucket": f"b{s.bucket.b}n{s.bucket.n}k{s.bucket.k}"
                           + ("L" if s.bucket.largest else "S"),
                 "rows": len(s.requests),
                 "oldest_age_s": now - min(r.t_submit for r in s.requests)}
                for s in self._inflight
            ]

    # -- observability -----------------------------------------------------

    def reset_stats(self) -> None:
        """Zero request/stack/latency counters and the cache's hit counter,
        keeping built programs: warm with one pass, reset, time the next."""
        with self._cv:
            self.requests_submitted = 0
            self.requests_completed = 0
            self.requests_failed = 0
            self.requests_rejected = 0
            self.requests_cancelled = 0
            self.stacks_dispatched = 0
            self.packed_stacks_dispatched = 0
            self.packed_requests_completed = 0
            self.grid_cells_total = 0
            self.grid_cells_real = 0
            self._pad_cells_by_bucket = {}
            self.latencies_ms = []
            self.dispatch_log = []
            self.verify_failed = 0
            self.retries = 0
            self.retry_delays_s = []
            self.stack_splits = 0
            self.requests_degraded = 0
            self.fallbacks_by_plan = {}
            self.linger_trims = 0
            self.sessions_opened = 0
            self.session_updates = 0
            self.session_fast_updates = 0
            self.session_full_resolves = 0
            self.session_degraded = 0
        self.cache.reset_counters()

    def stats(self) -> dict:
        """Counter snapshot, with ``repro``'s keys.

        Pad waste (``grid_cells_*``, ``pad_waste_*``) counts cells once per
        *successfully retired* stack; requests served by the fallback chain
        add nothing, so ``stacks_dispatched`` (launches) may exceed the
        retired stacks under chaos while the cell counters match the clean
        run.  ``pad_waste_bucketed_frac`` / ``pad_waste_packed_frac`` split
        the waste by path; the packed one charges a block-diagonal row for
        its off-block zeros, so compare each against its own history."""
        with self._cv:
            lat = sorted(self.latencies_ms)
            packed_real = packed_total = buck_real = buck_total = 0
            for bk, (real, total) in self._pad_cells_by_bucket.items():
                if isinstance(bk, PackedBucket):
                    packed_real += real
                    packed_total += total
                else:
                    buck_real += real
                    buck_total += total
            snap = {
                "requests_submitted": self.requests_submitted,
                "requests_completed": self.requests_completed,
                "requests_failed": self.requests_failed,
                "requests_rejected": self.requests_rejected,
                "requests_cancelled": self.requests_cancelled,
                "requests_pending": self._pending,
                "requests_unresolved": len(self._unresolved),
                "stacks_dispatched": self.stacks_dispatched,
                "packed_stacks_dispatched": self.packed_stacks_dispatched,
                "packed_requests_completed": self.packed_requests_completed,
                "grid_cells_total": self.grid_cells_total,
                "grid_cells_real": self.grid_cells_real,
                "pad_waste_frac": (
                    1.0 - self.grid_cells_real / self.grid_cells_total
                    if self.grid_cells_total else 0.0),
                "pad_waste_bucketed_frac": (
                    1.0 - buck_real / buck_total if buck_total else 0.0),
                "pad_waste_packed_frac": (
                    1.0 - packed_real / packed_total
                    if packed_total else 0.0),
                "pad_waste_by_bucket": {
                    _bucket_label(bk):
                        round(1.0 - real / total, 6) if total else 0.0
                    for bk, (real, total)
                    in sorted(self._pad_cells_by_bucket.items(),
                              key=lambda kv: _bucket_label(kv[0]))},
                "verify_failed": self.verify_failed,
                "retries": self.retries,
                "stack_splits": self.stack_splits,
                "requests_degraded": self.requests_degraded,
                "fallbacks_by_plan": dict(self.fallbacks_by_plan),
                "linger_trims": self.linger_trims,
                "sessions_open": len(self._sessions),
                "sessions_opened": self.sessions_opened,
                "session_updates": self.session_updates,
                "session_fast_updates": self.session_fast_updates,
                "session_full_resolves": self.session_full_resolves,
                "session_degraded": self.session_degraded,
                "chaos_injected": (
                    self.chaos.counts() if self.chaos is not None else {}),
            }

        def pct(p):
            if not lat:
                return 0.0
            return lat[min(len(lat) - 1, int(p / 100.0 * len(lat)))]

        snap.update({
            "program_compiles": self.cache.compiles,
            "program_hits": self.cache.hits,
            "distinct_buckets": len(self.cache),
            "p50_latency_ms": pct(50),
            "p99_latency_ms": pct(99),
        })
        return snap
