"""The port's streaming session against a plain reference of its stream.

A seeded sliding-window stream of rank-1 updates (``plain_stream.py``: the
first ``W`` samples enter, then the oldest leaves and the next enters, in
turn) goes through the port's session (``cuda`` backend on the CPU, where
the kernels take their plain versions; float64) at n = 48, k = 4, W = 8.
After every update the session's window and matrix are held to the plain
reference: float64 ``eigh`` of ``A_0 + sum over the window of x x^T``,
rebuilt from the terms.  The first stream crosses drift re-solves, the
second hits the cadence cap.  No JAX: the reference is plain PyTorch.

Tolerances, from this file's streams (largest reading of the session over
every step; smallest of the stale answer, the one from before each update;
drift stream / cadence stream):

* ``EIG_TOL`` 1e-6 of the spectral norm: the session read 1.6e-8 / 7.1e-9,
  the stale answer 1.0e-3 / 1.8e-4.  A fast update's eigenvalues are Ritz
  values of a 12-row frame, exact only up to what that frame misses, not
  to rounding.
* ``VEC_TOL`` 2e-3 (2-norm distance of a signed unit vector): the session
  read 2.6e-4 / 1.5e-4, the stale answer 4.8e-3 / 2.5e-3.  A Ritz vector's
  error is about the square root of its Ritz value's.
* ``MAT_TOL`` 1e-13 (Frobenius distance over the reference's norm): the
  session's matrix is a running float64 sum of the terms and read 1.8e-16
  / 1.7e-16; the matrix from before an update is ``rho / ||A||_F``, 4.9e-3,
  off.
"""

import numpy as np
import pytest
import torch

import plain_stream
from repro_torch import (
    Rank1Update,
    SessionConfig,
    SolverEngine,
    SolverPlan,
    tracing,
)

N, K, W = 48, 4, 8
EIG_TOL, VEC_TOL, MAT_TOL = 1e-6, 2e-3, 1e-13
#: ``rho / ||A_0||_F`` of the drift stream: the drift bound (0.25) forces
#: a re-solve every 50 updates; 150 updates cross two.
DRIFT_SHARE, DRIFT_STEPS = 0.005, 150
#: The cadence stream: the same updates under a cap of 40, which fires
#: before the drift bound can.
CADENCE_SHARE, CADENCE_STEPS, CADENCE_CAP = DRIFT_SHARE, 100, 40


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _spiked(n: int, spikes: int, gen: torch.Generator) -> torch.Tensor:
    """A GOE bulk (edge 2) plus ``spikes`` planted directions, theta 2-6."""
    g = torch.randn(n, n, generator=gen, dtype=torch.float64)
    a = (g + g.T) * (0.5 / n) ** 0.5
    u, _ = torch.linalg.qr(torch.randn(n, spikes, generator=gen,
                                       dtype=torch.float64))
    theta = torch.linspace(2.0, 6.0, spikes, dtype=torch.float64)
    return a + (u * theta) @ u.T


def _stream(share: float, steps: int, config: SessionConfig, seed: int):
    """Run a stream through the port's session; returns the reference's
    answers and the session's answers, matrices, stats, counter deltas and
    the ``host_sync`` count each update added."""
    gen = torch.Generator().manual_seed(seed)
    a0 = _spiked(N, 4, gen)
    g = torch.randn(steps, N, generator=gen, dtype=torch.float64)
    samples = plain_stream.samples(a0, g, share)
    engine = SolverEngine(SolverPlan(method="eei_tridiag", backend="cuda",
                                     precision="float64"), device="cpu")
    session = engine.open_session(a0, K, True, config)
    before = tracing.counts()
    answers, matrices, syncs = [], [], []
    for s in range(steps):
        sample, sign = plain_stream.step(s, W)
        n_sync = tracing.counts().get("host_sync", 0)
        out = engine.update(session, Rank1Update(samples[sample], sign))
        syncs.append(tracing.counts()["host_sync"] - n_sync)
        answers.append((out.eigenvalues.clone(), out.vectors.clone()))
        matrices.append(session.a.clone())
    after = tracing.counts()
    counted = {name: after.get(name, 0) - before.get(name, 0)
               for name in ("session_fast_update", "session_resolve",
                            "session_host_reseed")}
    refs = [plain_stream.topk(plain_stream.matrix_after(a0, samples, s, W),
                              K) for s in range(steps)]
    ref_a = [plain_stream.matrix_after(a0, samples, s, W)
             for s in range(steps)]
    return {"refs": refs, "ref_a": ref_a, "answers": answers,
            "matrices": matrices, "stats": session.stats(),
            "counted": counted, "syncs": syncs}


def _errors(answer, ref) -> tuple:
    """``(eig_err, vec_err)`` of one answer: the largest eigenvalue error
    over the spectral norm, and the largest 2-norm distance of a unit
    vector under the sign it is free to take."""
    (lam, vecs), (lam_ref, vecs_ref) = answer, ref
    eig = float((lam - lam_ref).abs().max() / lam_ref.abs().max())
    flip = torch.where((vecs * vecs_ref).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    vec = float(torch.linalg.vector_norm(vecs - flip * vecs_ref, dim=-1).max())
    return eig, vec


def _mat_err(a, a_ref) -> float:
    return float(torch.linalg.matrix_norm(a - a_ref)
                 / torch.linalg.matrix_norm(a_ref))


@pytest.fixture(scope="module")
def streams():
    return {
        "drift": _stream(DRIFT_SHARE, DRIFT_STEPS, SessionConfig(), seed=0),
        "cadence": _stream(CADENCE_SHARE, CADENCE_STEPS,
                           SessionConfig(max_updates=CADENCE_CAP), seed=1),
    }


def test_the_stream_schedule_slides_its_window():
    # The first W steps bring samples in; then one leaves, one enters.
    assert [plain_stream.step(s, 3) for s in range(7)] == [
        (0, 1), (1, 1), (2, 1), (0, -1), (3, 1), (1, -1), (4, 1)]
    assert [list(plain_stream.window_after(s, 3)) for s in range(7)] == [
        [0], [0, 1], [0, 1, 2], [1, 2], [1, 2, 3], [2, 3], [2, 3, 4]]


def test_the_streams_cross_their_re_solves(streams):
    drift = streams["drift"]["stats"]
    assert drift["resolves_by_cause"] == {"drift": 2}
    assert drift["fast_updates"] == DRIFT_STEPS - 2
    cadence = streams["cadence"]["stats"]
    assert cadence["resolves_by_cause"] == {
        "cadence": CADENCE_STEPS // (CADENCE_CAP + 1)}


@pytest.mark.parametrize("name", ["drift", "cadence"])
def test_every_answer_matches_the_plain_stream(streams, name):
    run = streams[name]
    errors = np.array([_errors(answer, ref) for answer, ref
                       in zip(run["answers"], run["refs"])])
    assert errors[:, 0].max() <= EIG_TOL
    assert errors[:, 1].max() <= VEC_TOL
    mats = [_mat_err(a, ref) for a, ref in zip(run["matrices"],
                                               run["ref_a"])]
    assert max(mats) <= MAT_TOL


@pytest.mark.parametrize("name", ["drift", "cadence"])
def test_the_stale_answer_fails_every_tolerance(streams, name):
    """The answer and matrix from before each update, held to the
    reference after it, fail each tolerance at every step."""
    run = streams[name]
    stale = np.array([_errors(answer, ref) for answer, ref
                      in zip(run["answers"][:-1], run["refs"][1:])])
    assert stale[:, 0].min() > EIG_TOL
    assert stale[:, 1].min() > VEC_TOL
    mats = [_mat_err(a, ref) for a, ref in zip(run["matrices"][:-1],
                                               run["ref_a"][1:])]
    assert min(mats) > MAT_TOL


@pytest.mark.parametrize("name", ["drift", "cadence"])
def test_the_counters_add_up_to_the_updates(streams, name):
    run = streams[name]
    counted, stats = run["counted"], run["stats"]
    assert counted["session_fast_update"] == stats["fast_updates"]
    assert counted["session_resolve"] == stats["full_resolves"]
    assert (counted["session_fast_update"] + counted["session_resolve"]
            == stats["updates_total"] == len(run["answers"]))
    assert counted["session_host_reseed"] == 0
    # Every update waits at least for its norm; a fast one also for its
    # verify flag; a re-solve copies the matrix and its window to the host.
    assert min(run["syncs"]) >= 2


def test_both_spans_close_under_a_cpu_profiler():
    gen = torch.Generator().manual_seed(2)
    a0 = _spiked(N, 4, gen)
    engine = SolverEngine(SolverPlan(method="eei_tridiag", backend="cuda",
                                     precision="float64"), device="cpu")
    session = engine.open_session(a0, K, True, SessionConfig(max_updates=2))
    x = torch.randn(3, N, generator=gen, dtype=torch.float64) * 0.1
    tracing.reset()
    with torch.profiler.profile() as prof:
        for row in x:
            engine.update(session, Rank1Update(row, 1))
    spans = tracing.spans()
    tracing.reset()
    # Updates 1 and 2 are fast; the cap re-solves the third.
    assert spans["session/fast"]["n"] == 3
    assert spans["session/resolve"]["n"] == 1
    assert spans["session/fast"]["s"] > 0 and spans["session/resolve"]["s"] > 0
    names = {e.key for e in prof.key_averages()}
    assert {"session/fast", "session/resolve",
            "stage/reduce/warm_project"} <= names
