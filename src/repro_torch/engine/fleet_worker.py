"""Subprocess replica worker: one ``EeiServer`` behind a pipe protocol.

Launched by :class:`repro_torch.engine.fleet.SubprocessReplica` as
``python -m repro_torch.engine.fleet_worker``.  Speaks ``repro``'s
length-prefixed pickle frames on stdin and stdout:

    parent -> worker:  {"op": "init", "server_kwargs": {...}}
                       {"op": "submit", "id": int, "a": ndarray,
                        "k": int, "largest": bool}
                       {"op": "hang", "s": float}
                       {"op": "slow", "s": float, "duration_s": float}
                       {"op": "close", "drain": bool}
    worker -> parent:  {"op": "ready"}
                       {"op": "result", "id": int, "ok": True,
                        "lam": ndarray, "vec": ndarray,
                        "degraded": bool, "fallback": str}
                       {"op": "result", "id": int, "ok": False,
                        "error": str, "replica_fault": bool}

The stdin reader thread only *enqueues*; a processor thread forwards to
the server — so a chaos ``hang`` (processor sleeps) never backs the pipe
up into the parent's dispatch path, and a chaos ``slow`` delays each
forward like an overloaded process would.  Results are written from the
server's retire-thread callbacks under one write lock.

The frames travel on a private duplicate of the worker's stdout: fd 1
itself is pointed at stderr before anything else is imported, so a stray
write to it (a library's warning, a build's message) cannot corrupt the
protocol.  The worker limits PyTorch to one CPU thread unless the parent's
environment sets a thread count (``OMP_NUM_THREADS``): a fleet of N
workers should scale by *process* parallelism, not have each worker fight
over every core.  The server's device comes from ``server_kwargs``; with
none it runs on the card and, with no card, the worker exits before it is
ready.
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time


def _frame_streams():
    """``(stdin, frames_out)``: the binary stdin, and a private duplicate
    of fd 1 for the frames; fd 1 itself then points at stderr."""
    frames_out = os.fdopen(os.dup(1), "wb")
    sys.stdout.flush()
    os.dup2(2, 1)
    return sys.stdin.buffer, frames_out


def main() -> int:
    stdin, stdout = _frame_streams()
    # Imports after the fd swap, so nothing they print reaches the frames.
    import numpy as np
    import torch

    if "OMP_NUM_THREADS" not in os.environ:
        torch.set_num_threads(1)

    from repro_torch.engine.fleet import _read_frame, _write_frame
    from repro_torch.engine.server import EeiServer, ServerClosed

    write_lock = threading.Lock()

    def send(obj) -> None:
        with write_lock:
            _write_frame(stdout, obj)

    init = _read_frame(stdin)
    if init is None or init.get("op") != "init":
        return 2
    kwargs = dict(init.get("server_kwargs") or {})
    kwargs.setdefault("linger_ms", 2.0)
    server = EeiServer(**kwargs)
    send({"op": "ready"})

    inbox: "queue.Queue" = queue.Queue()
    state = {"hang_until": 0.0, "slow_until": 0.0, "slow_s": 0.0}

    def on_done(req_id: int, fut) -> None:
        if fut.cancelled():
            send({"op": "result", "id": req_id, "ok": False,
                  "error": "cancelled", "replica_fault": True})
            return
        exc = fut.exception()
        if exc is not None:
            send({"op": "result", "id": req_id, "ok": False,
                  "error": f"{type(exc).__name__}: {exc}",
                  "replica_fault": isinstance(exc, ServerClosed)})
            return
        res = fut.result()
        send({"op": "result", "id": req_id, "ok": True,
              "lam": np.asarray(res.eigenvalues),
              "vec": np.asarray(res.vectors),
              "degraded": bool(getattr(res, "degraded", False)),
              "fallback": str(getattr(res, "fallback", ""))})

    def process_loop() -> None:
        while True:
            msg = inbox.get()
            if msg is None or msg.get("op") == "close":
                drain = bool(msg.get("drain", True)) if msg else False
                server.close(drain=drain, timeout=30.0)
                os._exit(0)
            now = time.monotonic()
            if now < state["hang_until"]:
                time.sleep(state["hang_until"] - now)
            if time.monotonic() < state["slow_until"]:
                time.sleep(state["slow_s"])
            req_id = msg["id"]
            try:
                fut = server.submit(msg["a"], msg["k"], msg["largest"])
            except Exception as exc:
                send({"op": "result", "id": req_id, "ok": False,
                      "error": f"{type(exc).__name__}: {exc}",
                      "replica_fault": False})
                continue
            fut.add_done_callback(
                lambda f, req_id=req_id: on_done(req_id, f))

    processor = threading.Thread(target=process_loop, daemon=True)
    processor.start()

    while True:
        msg = _read_frame(stdin)
        if msg is None:  # parent went away: shut down
            inbox.put(None)
            processor.join(timeout=60.0)
            return 0
        op = msg.get("op")
        if op == "submit" or op == "close":
            inbox.put(msg)
            if op == "close":
                processor.join(timeout=60.0)
                return 0
        elif op == "hang":
            state["hang_until"] = time.monotonic() + float(msg["s"])
        elif op == "slow":
            state["slow_s"] = float(msg["s"])
            state["slow_until"] = time.monotonic() + \
                float(msg.get("duration_s", 1.0))


if __name__ == "__main__":
    sys.exit(main())
