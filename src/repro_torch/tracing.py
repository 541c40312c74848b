"""Spans and counters inside the program.

``span(name)`` marks a region of a call.  With no torch profiler recording
it is one shared null context, so a span costs one boolean test; while one
records (``torch.autograd._profiler_enabled()``) it is a
``torch.profiler.record_function(name)``, so the region lands in the same
trace as the CUDA kernels it launches, on one clock.  Each span closed
while a profiler records also adds to :func:`spans` its host seconds and
its self seconds, those not inside a span opened within it on the same
thread.

``count(name, n)`` adds to a plain integer counter, always on.  The path of
``solve`` and ``topk`` counts ``host_sync`` at every point where a call on
the card waits for the device: a value read back, a copy from the host, an
index by a boolean mask.  The count is made on any device, so a call on the
CPU counts the waits of its twin on the card.

Span names:

* ``stage/<role>/<name>`` around each stage of a program call
  (``engine.Program.__call__``);
* ``lanczos/step`` around each Lanczos step (on the card's graph path,
  around each chunk of steps up to a residual check: one graph replay,
  the check included, and its wait) and ``lanczos/sync`` around each wait in the
  Lanczos reduce (``linalg.lanczos``), so the self time of
  ``lanczos/step`` is the host's time issuing the steps;
* ``session/fast`` around a session update's fast path, from the update
  norm's read to the state commit, and ``session/resolve`` around each full
  re-solve of a session, its host verify and host reseed included
  (``engine.session``).

Counters besides ``host_sync``: ``lanczos_graph_chunk``, one a chunk of
Lanczos steps replayed as a CUDA graph, and ``lanczos_eager_chunk``, one
a chunk run again with a wait a step after a breakdown in it;
``session_fast_update``, one a committed fast update, ``session_resolve``,
one a full re-solve of any cause but a session's opening, and
``session_host_reseed``, one a window rebuilt by the host's ``eigh``.  A
session also counts ``host_sync`` at its own waits: the update norm's read,
the verify flag's read, each copy to the host (the host verify's and the
Frobenius norm's).  ``minor_det_kernel``, one a launch of the
minor-determinant kernel (a CUDA graph's replayed ones included), and
``minor_det_plain``, one a call of its plain version through its wrapper
(``kernels.minor_det.kernel``).
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

_NULL = contextlib.nullcontext()
_counts: dict = {}
_spans: dict = {}
_local = threading.local()
#: Guards ``_counts`` and ``_spans``: servers call the engine from several
#: threads.
_lock = threading.Lock()


def _open() -> list:
    """This thread's recorded spans, innermost last."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Recorded:
    """A ``record_function`` that also adds its host and self seconds to
    :func:`spans`."""

    __slots__ = ("_name", "_fn", "_t0", "_inner")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        self._fn = torch.profiler.record_function(self._name)
        self._fn.__enter__()
        self._inner = 0.0
        _open().append(self)
        self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self._t0
        self._fn.__exit__(*exc)
        stack = _open()
        stack.pop()
        if stack:
            stack[-1]._inner += seconds
        with _lock:
            entry = _spans.setdefault(self._name,
                                      {"n": 0, "s": 0.0, "self_s": 0.0})
            entry["n"] += 1
            entry["s"] += seconds
            entry["self_s"] += seconds - self._inner
        return False


def span(name: str):
    """A context manager around one region named ``name``: the null context
    unless a torch profiler is recording."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return _Recorded(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counts() -> dict:
    """A copy of every counter: ``{name: int}``."""
    with _lock:
        return dict(_counts)


def spans() -> dict:
    """A copy of every span closed while a profiler recorded: ``{name:
    {"n": times closed, "s": host seconds, "self_s": host seconds outside
    the spans nested in it}}``."""
    with _lock:
        return {name: dict(entry) for name, entry in _spans.items()}


def reset() -> None:
    """Clear the counters and the spans."""
    with _lock:
        _counts.clear()
        _spans.clear()
