"""Spans from the benchmark's own files, and the reduction of a profiler
trace and a stage split to the record that ``bench/metrics/*.py`` read.

The spans: one ``record_function`` around the traced window and one around
each stage of the stage chain of each program the cell's call runs (the
stages are wrapped on the cached program objects the engine runs, and
unwrapped after).  A kernel belongs to the stage whose span was open on the
host when it was launched (the launch's correlation id ties the two).
"""

import bisect
import contextlib
import json
import os
import tempfile
import time

import torch

WINDOW = "bench.window"
STAGE = "bench.stage/"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
#: Entries of each breakdown list.
TOP = 10


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def annotated(*progs):
    """Wrap each stage of each program in ``progs`` in a span named after
    its role and implementation for the duration of the block.  A program
    listed twice is wrapped once."""

    def wrap(sig, fn):
        label = f"{STAGE}{sig.role}/{sig.name}"

        def run(state):
            with torch.profiler.record_function(label):
                return fn(state)

        return run

    saved = []
    for prog in {id(p): p for p in progs}.values():
        saved.append((prog, prog.stages))
        prog.stages = tuple((sig, wrap(sig, fn)) for sig, fn in prog.stages)
    try:
        yield
    finally:
        for prog, stages in saved:
            prog.stages = stages


def profile(loop, device):
    """Run ``loop()`` (which ends in a synchronise) under ``torch.profiler``
    inside the window span; returns its value and the trace's events."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(WINDOW):
            out = loop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return out, events


def split(prog, args: tuple, device, stage_ms: dict):
    """One call of ``prog`` on ``args`` (its ``initial_state``'s arguments:
    ``(stack,)`` for a plain program) walking its stages with a synchronise
    around each; adds each stage's wall ms to ``stage_ms`` under
    ``role/name`` and returns the result."""
    state = prog.initial_state(*args)
    for sig, fn in prog.stages:
        sync(device)
        t = time.perf_counter()
        state.update(fn(state))
        sync(device)
        key = f"{sig.role}/{sig.name}"
        ms = (time.perf_counter() - t) * 1e3
        stage_ms[key] = stage_ms.get(key, 0.0) + ms
    return prog.result(state)


def _merge(intervals):
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def _top(totals: dict) -> list:
    return [[name, sec] for name, sec in
            sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]


def reduce(events: list) -> dict:
    """Window length, device busy time, kernels by stage and the breakdown
    from a chrome trace's events (timestamps in microseconds)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = next(e for e in xs
               if e.get("cat") == "user_annotation" and e["name"] == WINDOW)
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    stages = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len(STAGE):])
                    for e in xs if e.get("cat") == "user_annotation"
                    and e["name"].startswith(STAGE))
    starts = [s[0] for s in stages]

    def stage_at(ts):
        if ts is None:
            return None
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= stages[i][1]:
            return stages[i][2]
        return None

    launched = {e["args"]["correlation"]: e["ts"] for e in xs
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    kernels, busy, by_op = [], [], {}
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if t <= s:
            continue
        corr = e.get("args", {}).get("correlation")
        kernels.append({"name": e["name"], "cat": e["cat"],
                        "stage": stage_at(launched.get(corr)),
                        "dur_s": (t - s) * 1e-6})
        busy.append((s, t))
        op = e["name"][:120]
        by_op[op] = by_op.get(op, 0.0) + (t - s) * 1e-6
    merged = _merge(busy)
    busy_s = sum(t - s for s, t in merged) * 1e-6

    # Idle gaps on the device, named by the innermost host event open at
    # each gap's midpoint (on the thread that ran the window) and by the
    # stage around it.  Events of one thread nest, so each one's parent is
    # found by a sweep, and a point's innermost event by walking up from
    # the last event that started before it.
    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
                   if e.get("cat") in HOST_CATS and e["name"] != WINDOW
                   and not e["name"].startswith(STAGE)
                   and (e.get("pid"), e.get("tid")) == (win.get("pid"),
                                                        win.get("tid"))),
                  key=lambda h: (h[0], -h[1]))
    parent, open_ = [], []
    for i, (s, t, _) in enumerate(host):
        while open_ and host[open_[-1]][1] < s:
            open_.pop()
        parent.append(open_[-1] if open_ else -1)
        open_.append(i)
    host_starts = [h[0] for h in host]
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    idle = {}
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        j = bisect.bisect_right(host_starts, mid) - 1
        while j >= 0 and host[j][1] < mid:
            j = parent[j]
        what = host[j][2] if j >= 0 else "python"
        name = f"{stage_at(mid) or 'between stages'}: {what}"[:120]
        idle[name] = idle.get(name, 0.0) + (g1 - g0) * 1e-6
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
            "kernels": kernels,
            "breakdown": {"device_ops": _top(by_op), "idle_gaps": _top(idle)}}


# -- helpers of the readers in bench/metrics/ -------------------------------


def stage_ms(record: dict, role: str, name: str = None):
    """Wall ms a call of the stages with this role (and implementation),
    from the stage split; None where the chain has no such stage."""
    keys = [k for k in record["stage_ms"]
            if k.split("/")[0] == role and (name is None
                                            or k.split("/")[1] == name)]
    if not keys:
        return None
    return sum(record["stage_ms"][k] for k in keys) / record["split_calls"]


def kernel_s(record: dict, role: str, contains: str):
    """Device seconds a traced call of the kernels launched inside a stage
    of this role whose name contains ``contains``; None where none ran."""
    durs = [k["dur_s"] for k in record["kernels"]
            if k["cat"] == "kernel" and k["stage"] is not None
            and k["stage"].split("/")[0] == role and contains in k["name"]]
    if not durs:
        return None
    return sum(durs) / record["calls"]
