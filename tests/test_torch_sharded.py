"""The sharded backend on a device mesh against repro's, on the CPU.

``repro_torch``'s mesh is a grid of ``torch.device``s, and a logical
two-device data axis on this host is the CPU twice (``repro``'s tests force
XLA host devices instead).  The same numpy-seeded stacks go through the
port's ``sharded`` backend on 1x1 and 2x1 CPU meshes and through
``repro``'s on its 1x1 host mesh, at ``repro``'s tolerances
(``tests/test_system.py:98-135``, ``tests/test_engine.py:125-135``); the
port's sharded results are also held to its unsharded ``cuda`` backend
(1e-12 in float64, bitwise on one device).  Also: the mesh, the planner,
sessions, the server and the launcher on a mesh, and the minor and term
axes.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_parity import align_rows, assert_close, np_of, sym_stack

import repro.engine as r_engine
from repro.core import distributed as r_distributed
from repro.core import identity as r_identity
from repro.engine import autotune as r_autotune
from repro.runtime import elastic as r_elastic
from repro_torch import (
    EeiServer,
    SolverEngine,
    SolverPlan,
    make_local_mesh,
    plan_for,
)
from repro_torch.core import distributed, identity
from repro_torch.engine import autotune, backends, registry
from repro_torch.engine import engine as engine_mod
from repro_torch.engine import session as session_mod
from repro_torch.engine.plan import resolved_crossovers
from repro_torch.interop import plan_from_reference
from repro_torch.launch.mesh import Mesh, chips, mesh_axes, parse_mesh
from repro_torch.runtime import best_grid, make_elastic_mesh

pytestmark = pytest.mark.usefixtures("x64")

CPU = torch.device("cpu")
MESHES = {"1x1": make_local_mesh(1, 1, devices=[CPU]),
          "2x1": make_local_mesh(2, 1, devices=[CPU, CPU])}
B, N, K = 3, 12, 3
WAIT_S = 120


def _r_mesh():
    return jax.make_mesh((1, 1), ("data", "model"))


def _fields(plan) -> dict:
    """A ``repro`` plan's fields (``dataclasses.asdict`` cannot copy a
    mesh of JAX devices)."""
    return {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


def test_local_mesh_needs_cards_or_named_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices, found 0"):
        make_local_mesh(2, 1)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        parse_mesh("2x1")
    mesh = MESHES["2x1"]
    assert mesh.shape == {"data": 2, "model": 1}
    assert mesh.axis_names == ("data", "model")
    assert mesh.size == chips(mesh) == 2
    assert mesh.first_device == CPU
    assert mesh.axis_devices("data") == (CPU, CPU)
    assert mesh.axis_devices("model") == (CPU,)
    assert mesh == make_local_mesh(2, 1, devices=["cpu", "cpu", "cpu"])
    assert hash(mesh) == hash(parse_mesh("2x1", "cpu"))
    assert dict(_r_mesh().shape) == MESHES["1x1"].shape
    assert parse_mesh("1x2", "cpu").shape == {"data": 1, "model": 2}
    for bad in (lambda: make_local_mesh(2, 1, devices=[CPU]),
                lambda: make_local_mesh(0, 1, devices=[CPU]),
                lambda: mesh_axes("2x"), lambda: mesh_axes("2x1x2"),
                lambda: mesh_axes("0x1"), lambda: Mesh(()),
                lambda: Mesh(((CPU,), (CPU, CPU))),
                lambda: Mesh(((CPU,),), ("data", "data")),
                lambda: mesh.axis_devices("pod")):
        with pytest.raises(ValueError):
            bad()


def test_elastic_grids_match_repro():
    for n_devices in range(1, 17):
        for tp in (1, 2, 4, 8, 16):
            assert best_grid(n_devices, tp) == \
                r_elastic.best_grid(n_devices, tp)
    mesh = make_elastic_mesh(16, devices=[CPU] * 12)
    assert mesh.shape == {"data": 3, "model": 4}


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------


def test_plan_validation():
    """``tests/test_engine.py:196-210`` on the port, and the batch axis."""
    with pytest.raises(ValueError):
        SolverPlan(method="nope")
    with pytest.raises(ValueError):
        SolverPlan(backend="nope")
    with pytest.raises(ValueError, match="requires a mesh"):
        SolverPlan(backend="sharded")
    with pytest.raises(ValueError, match="batch_axis"):
        SolverPlan(backend="sharded", mesh=MESHES["2x1"], batch_axis="pod")
    with pytest.raises(ValueError):
        SolverEngine(SolverPlan(), device="cpu").topk(
            torch.zeros((0, 4, 4)), 0)
    assert SolverPlan().batch_axis_size == 1
    assert SolverPlan(mesh=MESHES["2x1"]).batch_axis_size == 1
    assert SolverPlan(backend="sharded",
                      mesh=MESHES["2x1"]).batch_axis_size == 2
    assert SolverPlan(backend="sharded", mesh=MESHES["2x1"],
                      batch_axis="model").batch_axis_size == 1
    assert "sharded" in registry.available_backends()


def test_planner_shards_only_a_multi_device_data_axis(monkeypatch):
    """``tests/test_engine.py:171-173``: a one-device data axis is not worth
    sharding; ``repro``'s planner makes the same plan on its 1x1 mesh."""
    monkeypatch.setattr(r_autotune, "get_table", lambda: None)
    monkeypatch.setattr(autotune, "get_table", lambda: None)
    big = 100
    got = plan_for((4, big, big), mesh=MESHES["1x1"])
    ref = r_engine.plan_for((4, big, big), mesh=_r_mesh())
    assert got.backend == "cuda" and got.mesh is None
    assert got == dataclasses.replace(
        plan_from_reference(_fields(ref)), backend="cuda")
    mesh = MESHES["2x1"]
    sharded = plan_for((4, big, big), k=2, mesh=mesh)
    assert (sharded.backend, sharded.mesh, sharded.batch_axis,
            sharded.minor_axis, sharded.spectrum) == \
        ("sharded", mesh, "data", "model", "windowed")
    assert plan_for((2, big, big), mesh=mesh).backend == "sharded"
    assert plan_for((1, big, big), mesh=mesh) == plan_for((1, big, big))
    assert plan_for((big, big), mesh=mesh).mesh is None
    assert plan_for((1, big, big), mesh=mesh,
                    backend="sharded").mesh == mesh


def test_sharded_crossovers_resolve_as_repro_s():
    """``sharded`` reads the table's unkernelled pair in both packages."""
    fields = dict(eigh_crossover_n=10, dense_crossover_n=20)
    autotune.set_table(autotune.CalibrationTable(
        **fields, cuda_eigh_crossover_n=30, cuda_dense_crossover_n=40))
    r_autotune.set_table(r_autotune.CalibrationTable(
        **fields, pallas_eigh_crossover_n=30, pallas_dense_crossover_n=40,
        prod_diff_blocks=(64, 64, 64), sturm_blocks=(16, 128)))
    try:
        assert resolved_crossovers("sharded") == (10, 20) == \
            r_engine.resolved_crossovers("sharded")
        assert resolved_crossovers("cuda") == (30, 40)
    finally:
        autotune.set_table(None)
        r_autotune.set_table(None)


def test_plan_from_reference_takes_the_port_mesh():
    r_plan = r_engine.SolverPlan(method="eei_tridiag", backend="sharded",
                                 mesh=_r_mesh(), spectrum="windowed")
    plan = plan_from_reference(_fields(r_plan), mesh=MESHES["1x1"])
    assert plan == SolverPlan(method="eei_tridiag", backend="sharded",
                              mesh=MESHES["1x1"], spectrum="windowed")
    with pytest.raises(ValueError, match="mesh="):
        plan_from_reference(_fields(r_plan))
    with pytest.raises(ValueError, match="shapes differ"):
        plan_from_reference(_fields(r_plan), mesh=MESHES["2x1"])


# ---------------------------------------------------------------------------
# The engine on a mesh
# ---------------------------------------------------------------------------

#: program -> (spectrum, call).
PROGRAMS = {
    "solve": ("full", lambda eng, a: eng.solve(a)),
    "topk_windowed": ("windowed", lambda eng, a: eng.topk(a, K)),
    "topk_full": ("full", lambda eng, a: eng.topk(a, K)),
    "eigenvalues": ("full", lambda eng, a: eng.eigenvalues(a)),
    "eigenvalues_k": ("windowed", lambda eng, a: eng.eigenvalues(a, k=K)),
}
#: Against float64 eigh, repro's tolerances: float64 tests/test_engine.py:
#: 125-135 (the indivisible stack), float32 tests/test_system.py:118-135
#: (whose input, seed 1, is this stack).  Against repro itself the parity
#: harness's (``test_torch_parity.TOL``: test_engine's in float64, and the
#: logged float32 component bound of 2e-3).
EIGH_TOL = {"float64": {"eigenvalues": (1e-6, 1e-8),
                        "magnitudes": (1e-4, 1e-7)},
            "float32": {"eigenvalues": (1e-4, 1e-4),
                        "magnitudes": (1e-3, 1e-4)}}


def _plan(mesh, spectrum, dtype=None):
    return SolverPlan(method="eei_tridiag", backend="sharded", mesh=mesh,
                      spectrum=spectrum, precision=dtype)


@functools.lru_cache(maxsize=None)
def _repro_result(program: str, dtype: str):
    spectrum, call = PROGRAMS[program]
    plan = r_engine.SolverPlan(method="eei_tridiag", backend="sharded",
                               mesh=_r_mesh(), spectrum=spectrum,
                               precision=dtype)
    out = call(r_engine.SolverEngine(plan),
               jnp.asarray(sym_stack(1, B, N, dtype)))
    return jax.tree.map(np.asarray, out)


def _check(program, a, got, ref, dtype):
    lam, v = np.linalg.eigh(a.astype(np.float64))
    tol = EIGH_TOL[dtype]
    if program == "solve":
        assert_close(got.eigenvalues, ref.eigenvalues, "eigenvalues", dtype)
        assert_close(got.magnitudes, ref.magnitudes, "magnitudes", dtype)
        np.testing.assert_allclose(np_of(got.eigenvalues), lam,
                                   *tol["eigenvalues"])
        np.testing.assert_allclose(np_of(got.magnitudes),
                                   np.swapaxes(v * v, -1, -2),
                                   *tol["magnitudes"])
    elif program.startswith("topk"):
        assert_close(got.eigenvalues, ref.eigenvalues, "eigenvalues", dtype)
        assert_close(align_rows(got.vectors, ref.vectors), ref.vectors,
                     "magnitudes", dtype)
        np.testing.assert_allclose(np_of(got.eigenvalues), lam[:, -K:],
                                   *tol["eigenvalues"])
    else:
        assert_close(got, ref, "eigenvalues", dtype)
        np.testing.assert_allclose(np_of(got), lam, *tol["eigenvalues"])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("program", ["solve", "topk_windowed",
                                     "eigenvalues"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_engine_matches_repro(mesh, program, dtype):
    """A stack of 3 (padded to 4 on the 2x1 mesh, sliced back)."""
    spectrum, call = PROGRAMS[program]
    a = sym_stack(1, B, N, dtype)
    got = call(SolverEngine(_plan(MESHES[mesh], spectrum, dtype)),
               torch.as_tensor(a))
    _check(program, a, got, _repro_result(program, dtype), dtype)


@pytest.mark.parametrize("program", sorted(PROGRAMS))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_matches_the_unsharded_backend(mesh, program):
    """1e-12 of the ``cuda`` backend in float64; on one device the wrapper
    adds no arithmetic, so the results are the inner library's bits."""
    spectrum, call = PROGRAMS[program]
    a = torch.as_tensor(sym_stack(1, B, N))
    got = call(SolverEngine(_plan(MESHES[mesh], spectrum)), a)
    ref = call(SolverEngine(SolverPlan(method="eei_tridiag",
                                       spectrum=spectrum), device="cpu"), a)
    for x, y in zip(*((got, ref) if isinstance(got, tuple)
                      else ((got,), (ref,)))):
        assert x.shape == y.shape and x.dtype == y.dtype
        if mesh == "1x1":
            assert torch.equal(x, y)
        torch.testing.assert_close(x, y, rtol=1e-12, atol=1e-12)


def test_each_stage_runs_once_a_shard(monkeypatch):
    """On 2x1 every stage of the chain runs once on each half of the padded
    stack; the windowed ``idx`` goes whole to both; verify is not split."""
    calls = []
    make_cuda = backends.make_cuda_backend

    def recording(plan):
        lib = make_cuda(plan)

        def wrap(name, fn):
            def run(*args):
                calls.append((name, [tuple(x.shape) for x in args
                                     if torch.is_tensor(x)]))
                return fn(*args)
            return run

        return registry.StageLibrary("cuda", {
            name: wrap(name, fn) for name, fn in lib._stages.items()})

    monkeypatch.setattr(backends, "make_cuda_backend", recording)
    engine_mod.program.cache_clear()
    try:
        plan = _plan(MESHES["2x1"], "full")
        a = torch.as_tensor(sym_stack(2, B, N))
        SolverEngine(plan).topk(a, K)
        names = [name for name, _ in calls]
        assert names == [
            "tridiagonalize", "tridiagonalize", "tridiag_eigenvalues",
            "tridiag_eigenvalues", "tridiag_minor_spectra",
            "tridiag_minor_spectra", "magnitudes", "magnitudes",
            "tridiag_signs", "tridiag_signs"]
        assert all(shapes[0][0] == 2 for _, shapes in calls)
        calls.clear()
        SolverEngine(_plan(MESHES["2x1"], "windowed")).solve(a)
        assert [n for n, _ in calls].count("magnitudes") == 2
        calls.clear()
        dense = SolverPlan(method="eei_dense", backend="sharded",
                           mesh=MESHES["2x1"], spectrum="windowed")
        engine_mod.topk_program(dense, K, True, verify=True)(
            torch.cat([a, a[:1]]))
        win = [shapes for name, shapes in calls
               if name == "magnitudes_windowed"]
        assert win == [[(2, N), (2, N, N - 1), (K,)]] * 2
        assert [s for n, s in calls if n == "verify_topk"] == \
            [[(4, N, N), (4, K), (4, K, N)]]
    finally:
        engine_mod.program.cache_clear()


def test_sharded_stages_refuse_an_indivisible_stack_and_other_devices():
    lib = registry.get_backend(_plan(MESHES["2x1"], "full"))
    d = torch.zeros((3, 5), dtype=torch.float64)
    e = torch.zeros((3, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="does not split"):
        lib.tridiag_eigenvalues(d, e)
    plan = _plan(MESHES["2x1"], "full")
    assert SolverEngine(plan).device == CPU
    assert SolverEngine(plan, device="cpu").device == CPU
    with pytest.raises(ValueError, match="first device"):
        SolverEngine(plan, device="cuda")


# ---------------------------------------------------------------------------
# Sessions on a two-device plan
# ---------------------------------------------------------------------------


def test_session_on_a_two_device_plan_matches_repro(monkeypatch):
    """3 fast updates at n = 16 on the 2x1 plan: the program runs a batch
    of 2 (the session's row repeated), and the window is the unsharded
    session's to 1e-12, and repro's session on its 1x1 sharded plan's to
    1e-8 of ||A||_F (vectors |<v, v'>| >= 1 - 1e-6)."""
    lifted = []
    pad = session_mod._pad_batch
    monkeypatch.setattr(session_mod, "_pad_batch", lambda eng, x: (
        lifted.append(tuple(pad(eng, x).shape)) or pad(eng, x)))
    rng = np.random.default_rng(5)
    a = sym_stack(5, 1, 16)[0]
    steps = [rng.standard_normal(16) * 0.2 for _ in range(3)]
    engines = [SolverEngine(dataclasses.replace(
        _plan(MESHES["2x1"], "windowed"), precision="float64")),
        SolverEngine(SolverPlan(method="eei_tridiag", spectrum="windowed",
                                precision="float64"), device="cpu")]
    sessions = [eng.open_session(torch.as_tensor(a), K) for eng in engines]
    r_eng = r_engine.SolverEngine(r_engine.SolverPlan(
        method="eei_tridiag", backend="sharded", mesh=_r_mesh(),
        spectrum="windowed", precision="float64"))
    r_sess = r_eng.open_session(jnp.asarray(a), K)
    a_now = a.copy()
    for u in steps:
        a_now = a_now + np.outer(u, u)
        got, ref = (eng.update(s, (u, 1))
                    for eng, s in zip(engines, sessions))
        torch.testing.assert_close(got.eigenvalues, ref.eigenvalues,
                                   rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(got.vectors, ref.vectors, rtol=1e-12,
                                   atol=1e-12)
        r_res = r_eng.update(r_sess, (u, 1))
        scale = np.linalg.norm(a_now)
        np.testing.assert_allclose(np_of(got.eigenvalues),
                                   np.asarray(r_res.eigenvalues),
                                   atol=1e-8 * scale, rtol=0)
        dots = np.abs(np.sum(np_of(got.vectors)
                             * np.asarray(r_res.vectors), axis=-1))
        assert np.all(dots >= 1 - 1e-6), dots
    assert sessions[0].fast_updates == r_sess.fast_updates == 3
    assert lifted and all(shape[0] == 2 for shape in lifted[:4])


# ---------------------------------------------------------------------------
# The server and the launcher on a mesh
# ---------------------------------------------------------------------------


def _sym32(rng, n):
    a = rng.standard_normal((n, n)).astype(np.float32)
    return (a + a.T) / 2


def test_bucket_rounds_up_to_mesh_batch_axis(monkeypatch):
    """``tests/test_server.py:281-297``: a partial group's pow2 bucket
    rounds up to the batch axis (the engine pads its chunks alike)."""
    monkeypatch.setattr(SolverPlan, "batch_axis_size",
                        property(lambda self: 8))
    plan = SolverPlan(method="eei_tridiag")
    rng = np.random.default_rng(11)
    stream = [(_sym32(rng, 16), 2) for _ in range(3)]
    server = EeiServer(plan, device="cpu", max_batch=16)
    futs = [server.submit(a, k) for a, k in stream]
    server.flush()
    results = [f.result(timeout=WAIT_S) for f in futs]
    server.close()
    assert server.cache.buckets()[0].b == 8  # pow2(3) = 4, padded to 8
    engine = SolverEngine(plan, device="cpu")
    for (a, k), res in zip(stream, results):
        np.testing.assert_allclose(
            res.eigenvalues, np_of(engine.topk(torch.as_tensor(a),
                                               k).eigenvalues),
            rtol=1e-5, atol=1e-5)


def test_sharded_server_on_a_two_device_cpu_mesh():
    """``tests/test_server.py:803-838`` in process: the linger thread
    serves a sharded plan, every bucket is even, and every request is
    bitwise the sharded engine's top-k of the recorded stack.  Per-bucket
    planning with ``mesh=`` shards stacks of two or more only."""
    mesh = MESHES["2x1"]
    plan = SolverPlan(method="eei_tridiag", backend="sharded", mesh=mesh)
    assert plan_for((4, 48, 48), k=2, mesh=mesh).backend == "sharded"
    rng = np.random.default_rng(0)
    with EeiServer(plan, max_batch=4, linger_ms=5,
                   record_dispatches=True) as server:
        assert server.device == CPU
        futs = [server.submit(_sym32(rng, n), 2) for n in (12, 12, 16, 12, 9)]
        for f in futs:
            f.result(timeout=WAIT_S)  # no flush: the linger thread
        assert server.stats()["requests_completed"] == 5
    for rec in server.dispatch_log:
        assert rec.bucket.b % 2 == 0, rec.bucket
        ref = SolverEngine(rec.plan).topk(torch.as_tensor(rec.stack),
                                          rec.bucket.k, rec.bucket.largest)
        for row, req in enumerate(rec.requests):
            res = req.future.result()
            np.testing.assert_array_equal(
                res.eigenvalues, np_of(ref.eigenvalues[row, -req.k:]))
            np.testing.assert_array_equal(
                res.vectors, np_of(ref.vectors[row, -req.k:, :req.n]))

    with pytest.raises(ValueError, match="first device"):
        EeiServer(mesh=mesh, device="cuda")
    server = EeiServer(mesh=mesh, device="cpu", max_batch=4,
                       record_dispatches=True)
    stream = [(_sym32(rng, 40), 2) for _ in range(5)]
    futs = [server.submit(a, k) for a, k in stream]
    server.flush()
    for (a, k), f in zip(stream, futs):
        res = f.result(timeout=WAIT_S)
        np.testing.assert_allclose(res.eigenvalues,
                                   np.linalg.eigvalsh(a)[-k:], rtol=1e-5,
                                   atol=1e-5)
    server.close()
    backends_by_b = {rec.bucket.b: rec.plan.backend
                     for rec in server.dispatch_log}
    assert backends_by_b == {4: "sharded", 1: "cuda"}
    assert server._session_plan(40, 2).mesh is None  # a session is b = 1


def test_serve_cli_sharded_on_a_two_device_cpu_mesh():
    """``tests/test_server.py:841-857``: ``serve.py --eei --sharded --mesh
    2x1`` through the linger thread, the mesh the CPU twice."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--eei",
         "--sharded", "--mesh", "2x1", "--device", "cpu", "--requests", "5",
         "--n", "16", "--k", "2", "--batch", "4", "--linger-ms", "5"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "backend=sharded" in proc.stderr
    assert "served 5 requests" in proc.stderr


# ---------------------------------------------------------------------------
# Minor and term axes
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _repro_axes(dtype: str):
    """repro's minor-axis table and term-axis component (i = 2, j = 3) on
    its 1x1 mesh, and the spectra they came from."""
    a = jnp.asarray(sym_stack(0, 1, 8, dtype)[0])
    r_mesh = _r_mesh()
    lam = r_identity.matrix_spectrum(a)
    mu = r_identity.minor_spectra(a)
    with r_mesh:
        table = r_distributed.minor_sharded_magnitudes(a, r_mesh)
        comp = r_distributed.term_sharded_component(lam, mu[3], 2, r_mesh)
    return np.asarray(table), float(comp), np.array(lam), np.array(mu[3])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mesh", ["1x1", "1x2"])
def test_minor_and_term_axes_match_repro(mesh, dtype):
    """``tests/test_system.py:98-116``: rtol 1e-4, atol 1e-5 against
    repro's axes on its 1x1 mesh; the 1x2 mesh splits the minors in two
    column blocks and the 7 terms (padded to 8) in two halves."""
    mesh_ = parse_mesh(mesh, "cpu")
    a = sym_stack(0, 1, 8, dtype)[0]
    ref, r_comp, lam, mu_3 = _repro_axes(dtype)
    got = distributed.minor_sharded_magnitudes(torch.as_tensor(a), mesh_)
    assert got.shape == (8, 8) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(np_of(got), ref, rtol=1e-4, atol=1e-5)
    whole = identity.eigenmatrix_magnitudes(torch.as_tensor(a))
    np.testing.assert_allclose(np_of(got), np_of(whole), rtol=1e-4,
                               atol=1e-5)
    assert distributed.sharded_magnitudes is \
        distributed.minor_sharded_magnitudes
    comp = distributed.term_sharded_component(
        torch.as_tensor(lam), torch.as_tensor(mu_3), 2, mesh_)
    np.testing.assert_allclose(float(comp), r_comp, rtol=1e-4)
    np.testing.assert_allclose(float(comp), float(np_of(whole)[2, 3]),
                               rtol=1e-4)
    if mesh == "1x2":
        with pytest.raises(ValueError, match="does not split"):
            distributed.minor_sharded_magnitudes(
                torch.as_tensor(sym_stack(0, 1, 7, dtype)[0]), mesh_)
