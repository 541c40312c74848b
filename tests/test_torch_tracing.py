"""The port's spans and counters (``repro_torch.tracing``) on the CPU.

The stage spans of a program call in chain order, the Lanczos step and sync
spans, the ``host_sync`` count at each of the sites that wait for the card,
and outputs bitwise equal with the profiler on and off.  ``tracing`` has no
twin in ``repro``.  Small n, one thread.
"""

import contextlib
import json
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import SolverEngine, SolverPlan, tracing
from repro_torch.engine.engine import ProgramSpec, program
from repro_torch.linalg import lanczos

SOLVE = SolverPlan(method="eei_tridiag", backend="cuda")
KRYLOV = SolverPlan(method="eei_krylov", backend="cuda", krylov_m=64)


@pytest.fixture(autouse=True)
def one_thread():
    """The stacks are small; parallel workers would each start a thread a
    core."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _stack(b: int, n: int, seed: int) -> torch.Tensor:
    x = torch.randn(b, n, n, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(seed))
    return x + x.transpose(-1, -2)


def _calls():
    """``(name, program, call)`` of a solve and of a Krylov top-k."""
    a_solve, a_topk = _stack(2, 24, 1), _stack(2, 96, 2)
    solve = SolverEngine(SOLVE, device="cpu")
    topk = SolverEngine(KRYLOV, device="cpu")
    return [
        ("solve", program(SOLVE, ProgramSpec("solve")),
         lambda: solve.solve(a_solve)),
        ("topk", program(KRYLOV, ProgramSpec("topk", 4, True)),
         lambda: topk.topk(a_topk, 4)),
    ]


def test_span_is_the_shared_null_context_without_a_profiler():
    tracing.reset()
    assert not torch.autograd._profiler_enabled()
    first, second = tracing.span("a"), tracing.span("b")
    assert first is second
    assert isinstance(first, contextlib.nullcontext)
    with first:
        pass
    assert tracing.spans() == {}


@pytest.mark.parametrize("case", [0, 1], ids=["solve", "topk"])
def test_stage_spans_in_chain_order(case, tmp_path):
    _, prog, call = _calls()[case]
    call()
    tracing.reset()
    with torch.profiler.profile() as prof:
        call()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    stages = sorted((e["ts"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith("stage/"))
    want = [f"stage/{sig.role}/{sig.name}" for sig, _ in prog.stages]
    assert [name for _, name in stages] == want
    call()  # after the profile: no span is kept
    spans = tracing.spans()
    assert {name: spans[name]["n"] for name in want} == dict.fromkeys(want, 1)
    # No span is opened inside the stages of a solve or of Krylov's later
    # stages, so their self time is their time.
    for name in want:
        if name != "stage/reduce/krylov":
            assert spans[name]["self_s"] == spans[name]["s"]


def _check_steps(check_every: int, k: int, last: int) -> int:
    """Residual checks of a loop that ran ``last`` steps."""
    return sum(1 for j1 in range(check_every, last + 1, check_every)
               if j1 >= k + 1)


@pytest.mark.parametrize("profiled", [False, True])
def test_lanczos_steps_and_host_syncs(profiled):
    a = _stack(2, 96, 3)
    m, check_every, k = 64, 32, 4
    tracing.reset()
    with torch.profiler.profile() if profiled else contextlib.nullcontext():
        out = lanczos.lanczos_iterate(a, m, window=(k, True),
                                      check_every=check_every)
    steps = out[3]
    assert steps.tolist() == [m, m]  # float64 runs every step here
    # The start vector's copy, a breakdown test a step, the convergence
    # test at each check; the matrices leave after the loop with no wait.
    # Each check takes its magnitudes through the minor-determinant op,
    # whose plain version runs on the CPU.
    checks = _check_steps(check_every, k, m)
    want = 1 + m + checks
    assert tracing.counts() == {"host_sync": want, "minor_det_plain": checks}
    spans = tracing.spans()
    if not profiled:
        assert spans == {}
        return
    assert set(spans) == {"lanczos/step", "lanczos/sync"}
    assert spans["lanczos/step"]["n"] == m
    assert spans["lanczos/sync"]["n"] == want
    # Each step's waits are nested in it; the one before the loop is not.
    step = spans["lanczos/step"]
    assert 0 < step["self_s"] < step["s"]
    assert spans["lanczos/sync"]["self_s"] == spans["lanczos/sync"]["s"]


def _staggered_stack(n: int) -> torch.Tensor:
    """Matrices that converge at different residual checks: wide top gaps
    first, then a narrower one, a GOE last."""
    rng = np.random.default_rng(21)
    q = np.linalg.qr(rng.standard_normal((n, n)))[0]

    def with_top(*top):
        lam = np.concatenate([np.linspace(0, 1, n - len(top)), top])
        return q @ np.diag(lam) @ q.T

    g = rng.standard_normal((n, n))
    return torch.from_numpy(np.stack(
        [g + g.T, with_top(10.0, 20.0), with_top(1.5, 2.0),
         with_top(10.0, 20.0)]))


def test_a_retire_is_one_counted_wait():
    a = _staggered_stack(48)
    m, check_every, k, rtol = 40, 8, 2, 1e-8
    tracing.reset()
    out = lanczos.lanczos_iterate(a, m, window=(k, True),
                                  check_every=check_every, rtol=rtol)
    steps, resid = out[3].tolist(), out[4]
    assert len(set(steps)) >= 3, steps  # rows leave at several checks
    # One wait for each check at which matrices converged and left.
    left = {s for s, done in zip(steps, (resid <= rtol).all(dim=-1).tolist())
            if done}
    last = max(steps)
    checks = _check_steps(check_every, k, last)
    want = 1 + last + checks + len(left)
    assert tracing.counts() == {"host_sync": want, "minor_det_plain": checks}


@pytest.mark.parametrize("case", [0, 1], ids=["solve", "topk"])
def test_outputs_bitwise_equal_with_the_profiler_on_and_off(case):
    _, _, call = _calls()[case]
    off = call()
    with torch.profiler.profile():
        on = call()
    assert all(torch.equal(x, y) for x, y in zip(off, on))


def test_counts_are_not_lost_between_threads():
    tracing.reset()
    threads, each = 8, 5000
    was = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda: [tracing.count("x") for _ in range(each)])
            for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(was)
    assert tracing.counts() == {"x": threads * each}
    counts = tracing.counts()
    counts["x"] = 0
    assert tracing.counts() == {"x": threads * each}  # a copy
    tracing.reset()
    assert tracing.counts() == {}
