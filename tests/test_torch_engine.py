"""The port's main path: SolverEngine on the cuda backend against repro's.

The port runs on the CPU here (``device="cpu"``), where the kernel
wrappers take their plain versions; ``repro`` runs its pallas backend in
interpret mode.  Both get the same plan (``interop.plan_from_reference``)
and the same seeded stack.  Also: the planner, the registry, microbatching,
and that every method builds and runs.
"""

import dataclasses

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from test_torch_parity import (  # noqa: E402
    DTYPES,
    align_rows,
    assert_close,
    np_of,
    sym_stack,
)

import repro.engine as r_engine  # noqa: E402
from repro.engine import autotune as r_autotune  # noqa: E402
from repro_torch import SolverEngine, SolverPlan, plan_for  # noqa: E402
from repro_torch.engine import autotune  # noqa: E402
from repro_torch.engine import registry  # noqa: E402
from repro_torch.interop import plan_from_reference, stack_from_numpy  # noqa: E402

B, N, K = 3, 16, 3


def run_both(backend, dtype, spectrum, call, seed=0):
    """One program through repro and through the port on one stack."""
    r_plan = r_engine.SolverPlan(method="eei_tridiag", backend=backend,
                                 spectrum=spectrum, precision=dtype)
    plan = plan_from_reference(dataclasses.asdict(r_plan))
    a = sym_stack(seed, B, N)
    ref = call(r_engine.SolverEngine(r_plan), jnp.asarray(a))
    got = call(SolverEngine(plan, device="cpu"),
               stack_from_numpy(a, "cpu"))
    return a, got, ref


def check_program(kind, got, ref, dtype):
    if kind == "solve":
        assert got.eigenvalues.dtype == getattr(torch, dtype)
        assert_close(got.eigenvalues, ref.eigenvalues, "eigenvalues", dtype)
        assert_close(got.magnitudes, ref.magnitudes, "magnitudes", dtype)
    elif kind == "topk":
        assert_close(got.eigenvalues, ref.eigenvalues, "eigenvalues", dtype)
        assert_close(align_rows(got.vectors, ref.vectors), ref.vectors,
                     "magnitudes", dtype)
    else:
        assert_close(got, ref, "eigenvalues", dtype)


PROGRAMS = {
    "solve": ("full", lambda eng, a: eng.solve(a)),
    "topk_full": ("full", lambda eng, a: eng.topk(a, K)),
    "topk_windowed": ("windowed", lambda eng, a: eng.topk(a, K)),
    "topk_smallest": ("windowed", lambda eng, a: eng.topk(a, K, largest=False)),
    "eigenvalues": ("full", lambda eng, a: eng.eigenvalues(a)),
    "eigenvalues_k": ("full", lambda eng, a: eng.eigenvalues(a, k=K)),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_cuda_backend_matches_repro_pallas(program, dtype):
    spectrum, call = PROGRAMS[program]
    _, got, ref = run_both("pallas", dtype, spectrum, call)
    check_program(program.split("_")[0], got, ref, dtype)


@pytest.mark.parametrize("program", ["solve", "topk_full", "topk_windowed"])
def test_float32_components_are_as_accurate_as_repro(program):
    """Against the float64 eigenvectors of the float32 input, the port's
    float32 components are no further off than repro's (within 2x)."""
    spectrum, call = PROGRAMS[program]
    a, got, ref = run_both("pallas", "float32", spectrum, call)
    lam, v = np.linalg.eigh(a.astype(np.float32).astype(np.float64))
    if program == "solve":
        truth = np.swapaxes(v * v, -1, -2)
        port_err = np.abs(np_of(got.magnitudes) - truth).max()
        repro_err = np.abs(np.asarray(ref.magnitudes) - truth).max()
    else:
        truth = np.swapaxes(v[..., -K:], -1, -2)
        port_err = np.abs(align_rows(got.vectors, truth) - truth).max()
        repro_err = np.abs(align_rows(ref.vectors, truth) - truth).max()
    assert port_err <= 2 * repro_err + 1e-6, (port_err, repro_err)


def test_solve_and_topk_match_eigh():
    a = sym_stack(1, B, N)
    lam_ref, v_ref = np.linalg.eigh(a)
    eng = SolverEngine(SolverPlan(backend="cuda"), device="cpu")
    lam, mags = eng.solve(a)
    assert_close(lam, lam_ref, "eigenvalues", "float64")
    assert_close(mags, np.swapaxes(v_ref ** 2, -1, -2), "magnitudes", "float64")
    win = SolverEngine(SolverPlan(backend="cuda", spectrum="windowed"),
                       device="cpu").topk(a, K)
    ref = np.swapaxes(v_ref[..., -K:], -1, -2)
    assert_close(align_rows(win.vectors, ref), ref, "magnitudes", "float64")
    res = np.einsum("bij,bkj->bki", a, np_of(win.vectors)) - \
        np_of(win.eigenvalues)[..., None] * np_of(win.vectors)
    assert np.abs(res).max() < 1e-5


def test_single_matrix_and_numpy_input():
    a = sym_stack(2, 1, N)[0]
    eng = SolverEngine(SolverPlan(), device="cpu")
    lam, mags = eng.solve(a)
    assert lam.shape == (N,) and mags.shape == (N, N)
    ev, vecs = eng.topk(torch.as_tensor(a), 2)
    assert ev.shape == (2,) and vecs.shape == (2, N)
    assert eng.eigenvalues(a, k=2).shape == (2,)


def test_microbatching_pads_the_tail_and_matches():
    a = sym_stack(3, 5, N)
    whole = SolverEngine(SolverPlan(), device="cpu").solve(a)
    chunked = SolverEngine(SolverPlan(max_batch=2), device="cpu").solve(a)
    assert chunked.magnitudes.shape == (5, N, N)
    np.testing.assert_allclose(np_of(chunked.eigenvalues),
                               np_of(whole.eigenvalues), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(np_of(chunked.magnitudes),
                               np_of(whole.magnitudes), rtol=1e-9, atol=1e-12)


def test_precision_casts_the_input():
    a = sym_stack(4, 2, N)
    lam = SolverEngine(SolverPlan(precision="float32"),
                       device="cpu").eigenvalues(a)
    assert lam.dtype == torch.float32
    with pytest.raises(TypeError):
        SolverEngine(SolverPlan(), device="cpu").eigenvalues(
            np.zeros((2, 4, 4), np.int64))


@pytest.mark.parametrize("method", ["eei_dense", "eei_krylov", "eei_krylov_si"])
def test_every_method_builds_and_runs(method):
    """The methods ROADMAP item 8 brought build through the normal entry
    point and run a small stack (each one's parity with repro is in
    test_torch_dense.py and test_torch_lanczos.py)."""
    a = sym_stack(7, 2, 20)
    lam = np.linalg.eigvalsh(a)
    eng = SolverEngine(SolverPlan(method=method), device="cpu")
    top = eng.topk(a, 2)
    assert_close(top.eigenvalues, lam[:, -2:], "eigenvalues", "float64")
    assert_close(eng.eigenvalues(a, k=2), lam[:, -2:], "eigenvalues",
                 "float64")


def test_eigh_composition_is_the_oracle():
    a = sym_stack(5, 2, 10)
    lam_ref, v_ref = np.linalg.eigh(a)
    eng = SolverEngine(SolverPlan(method="eigh"), device="cpu")
    assert_close(eng.eigenvalues(a), lam_ref, "eigenvalues", "float64")
    assert_close(eng.eigenvalues(a, k=2), lam_ref[:, -2:], "eigenvalues",
                 "float64")
    assert_close(eng.solve(a).magnitudes, np.swapaxes(v_ref ** 2, -1, -2),
                 "magnitudes", "float64")
    top = eng.topk(a, 2)
    ref = np.swapaxes(v_ref[..., -2:], -1, -2)
    assert_close(align_rows(top.vectors, ref), ref, "magnitudes", "float64")


@pytest.mark.parametrize("shape,k", [
    ((4, 16, 16), None), ((4, 40, 40), None), ((4, 40, 40), 3),
    ((2, 600, 600), None), ((16, 600, 600), 8), ((2, 600, 600), 300),
    ((2, 600, 600), 600), ((1, 2048, 2048), 8), ((1, 2048, 2048), 1000)])
def test_plan_for_matches_repro_static_planner(shape, k, monkeypatch):
    """With no calibration table both packages plan on the same static
    constants."""
    monkeypatch.setattr(r_autotune, "get_table", lambda: None)
    monkeypatch.setattr(autotune, "get_table", lambda: None)
    ref = r_engine.plan_for(shape, k=k, backend="pallas")
    assert plan_for(shape, k=k) == plan_from_reference(dataclasses.asdict(ref))


def test_plan_for_picks_the_main_path_at_the_slice_shape():
    plan = plan_for((16, 600, 600), k=8)
    assert (plan.method, plan.spectrum, plan.backend) == \
        ("eei_tridiag", "windowed", "cuda")
    assert plan_for((16, 600, 600)).spectrum == "full"


def test_plan_from_reference_maps_backends_and_refuses_sharding():
    for r_name, name in (("reference", "reference"), ("jnp", "torch"),
                         ("pallas", "cuda")):
        fields = dataclasses.asdict(r_engine.SolverPlan(backend=r_name))
        assert plan_from_reference(fields).backend == name
    fields = dataclasses.asdict(r_engine.SolverPlan(
        method="eei_krylov", backend="pallas", krylov_m=64))
    assert plan_from_reference(fields) == SolverPlan(
        method="eei_krylov", backend="cuda", krylov_m=64)
    fields = dataclasses.asdict(r_engine.SolverPlan(backend="jnp"))
    fields["backend"] = "sharded"
    with pytest.raises(ValueError, match="the port's mesh"):
        plan_from_reference(fields)


def test_stack_from_numpy_keeps_or_casts_the_dtype():
    a = sym_stack(6, 2, 4)
    assert stack_from_numpy(a, "cpu").dtype == torch.float64
    assert stack_from_numpy(a, "cpu", torch.float32).dtype == torch.float32


def test_registered_compositions_validate():
    assert registry.available_compositions() == [
        "eei_dense", "eei_dense_windowed", "eei_krylov", "eei_krylov_si",
        "eei_tridiag", "eei_tridiag_windowed", "eigh"]
    for name in ("eei_krylov", "eei_krylov_si"):
        assert registry.composition_for(name).solve is None
    assert registry.available_backends() == ["cuda", "reference", "sharded",
                                             "torch"]
    bad = registry.Composition(
        name="bad", method="eei_tridiag", windowed=False,
        topk=(registry.StageSig("spectrum", "tridiag_full", ("d", "e"),
                                ("lam",)),))
    with pytest.raises(ValueError, match="requires"):
        bad.validate()
    with pytest.raises(ValueError, match="role"):
        registry.StageSig("sort", "x", (), ())
