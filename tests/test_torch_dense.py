"""The dense compositions (``eei_dense``, ``eei_dense_windowed``) and the
inverse-iteration signs, against ``repro``.

The same seeded numpy stacks go through ``repro`` (its ``pallas`` backend in
interpret mode, and ``reference`` / ``jnp``) and through the port's three
backends on the CPU (``cuda`` runs the kernels' plain versions there), with
``repro``'s tolerances (``tests/test_engine.py:47-75``): eigenvalues rtol
1e-6 / atol 1e-8, magnitudes rtol 1e-4 / atol 1e-7, vectors 1e-5 up to sign
in float64.
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
    t,
)

import repro.engine as r_engine  # noqa: E402
from repro.core import directions as r_directions  # noqa: E402
from repro_torch import SolverEngine, SolverPlan  # noqa: E402
from repro_torch.core import directions, identity  # noqa: E402
from repro_torch.engine import registry  # noqa: E402
from repro_torch.interop import plan_from_reference, stack_from_numpy  # noqa: E402

B, N, K = 3, 16, 3
BACKENDS = {"reference": "reference", "jnp": "torch", "pallas": "cuda"}

PROGRAMS = {
    "solve": ("full", lambda eng, a: eng.solve(a)),
    "topk_full": ("full", lambda eng, a: eng.topk(a, K)),
    "topk_windowed": ("windowed", lambda eng, a: eng.topk(a, K)),
    "topk_smallest": ("windowed",
                      lambda eng, a: eng.topk(a, K, largest=False)),
    "eigenvalues": ("full", lambda eng, a: eng.eigenvalues(a)),
    "eigenvalues_k": ("windowed", lambda eng, a: eng.eigenvalues(a, k=K)),
}


def _run_both(r_backend, dtype, spectrum, call, seed=0):
    r_plan = r_engine.SolverPlan(method="eei_dense", backend=r_backend,
                                 spectrum=spectrum, precision=dtype)
    plan = plan_from_reference(dataclasses.asdict(r_plan))
    assert plan.backend == BACKENDS[r_backend]
    a = sym_stack(seed, B, N)
    ref = call(r_engine.SolverEngine(r_plan), jnp.asarray(a))
    got = call(SolverEngine(plan, device="cpu"), stack_from_numpy(a, "cpu"))
    return a, got, ref


def _assert_vectors(got, ref, dtype):
    got, ref = np_of(got), np.asarray(ref)
    if dtype == "float64":
        err = np.minimum(np.abs(got - ref), np.abs(got + ref)).max(axis=-1)
        assert err.max() < 1e-5, err.max()
    else:
        assert_close(align_rows(got, ref), ref, "magnitudes", dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("r_backend", sorted(BACKENDS))
@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_dense_programs_match_repro(program, r_backend, dtype):
    spectrum, call = PROGRAMS[program]
    _, got, ref = _run_both(r_backend, dtype, spectrum, call)
    kind = program.split("_")[0]
    if kind == "solve":
        assert got.eigenvalues.dtype == getattr(torch, dtype)
        assert_close(got.eigenvalues, ref.eigenvalues, "eigenvalues", dtype)
        assert_close(got.magnitudes, ref.magnitudes, "magnitudes", dtype)
    elif kind == "topk":
        assert_close(got.eigenvalues, ref.eigenvalues, "eigenvalues", dtype)
        _assert_vectors(got.vectors, ref.vectors, dtype)
    else:
        assert_close(got, ref, "eigenvalues", dtype)


@pytest.mark.parametrize("spectrum", ["full", "windowed"])
def test_dense_topk_matches_eigh(spectrum):
    a = sym_stack(1, B, N)
    lam, v = np.linalg.eigh(a)
    eng = SolverEngine(SolverPlan(method="eei_dense", spectrum=spectrum),
                       device="cpu")
    top = eng.topk(a, K)
    assert_close(top.eigenvalues, lam[:, -K:], "eigenvalues", "float64")
    _assert_vectors(top.vectors, np.swapaxes(v[..., -K:], -1, -2), "float64")
    res = np.einsum("bij,bkj->bki", a, np_of(top.vectors)) \
        - np_of(top.eigenvalues)[..., None] * np_of(top.vectors)
    assert np.abs(res).max() < 1e-5


@pytest.mark.parametrize("backend", ["reference", "torch", "cuda"])
def test_windowed_rows_equal_the_full_rows(backend):
    """The windowed components stage evaluates only the selected rows, and
    they are the full table's rows: bitwise on the reference and cuda
    backends (kernel 2's contract; its plain version on the CPU), within
    float64 rounding on torch, whose ones-contraction is a matrix product
    that may block differently for fewer rows."""
    a = t(sym_stack(2, B, N))
    lib = registry.get_backend(SolverPlan(method="eei_dense",
                                          backend=backend))
    lam = lib.dense_eigenvalues(a)
    mu = lib.dense_minor_spectra(a)
    idx = torch.arange(N - K, N)
    rows = lib.magnitudes_windowed(lam, mu, idx)
    full = lib.magnitudes(lam, mu)[:, idx]
    if backend == "torch":
        np.testing.assert_allclose(np_of(rows), np_of(full), rtol=1e-13,
                                   atol=0)
    else:
        assert torch.equal(rows, full)


def test_minor_spectra_match_repro():
    a = sym_stack(3, B, N)
    from repro.core import identity as r_identity

    ref = jax.vmap(r_identity.minor_spectra)(jnp.asarray(a))
    assert_close(identity.minor_spectra(t(a)), ref, "eigenvalues", "float64")
    assert_close(identity.matrix_spectrum(t(a)),
                 jax.vmap(r_identity.matrix_spectrum)(jnp.asarray(a)),
                 "eigenvalues", "float64")


def _assert_same_signs(got, ref):
    """The same signs everywhere, and the same ``sqrt(mags)`` up to the last
    bit of float32 (XLA's and PyTorch's square roots may round apart)."""
    got, ref = np_of(got), np.asarray(ref)
    np.testing.assert_array_equal(np.sign(got), np.sign(ref))
    np.testing.assert_allclose(got, ref, rtol=2e-7, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_inverse_iteration_signs_match_repro(dtype):
    a = sym_stack(4, B, N, dtype)
    lam, v = np.linalg.eigh(a.astype(np.float64))
    lam_sel = lam[:, -K:].astype(dtype)
    mags = (np.swapaxes(v[..., -K:], -1, -2) ** 2).astype(dtype)
    ref = r_directions.inverse_iteration_signs_batched(
        jnp.asarray(a), jnp.asarray(lam_sel), jnp.asarray(mags))
    got = directions.inverse_iteration_signs_batched(t(a), t(lam_sel),
                                                     t(mags))
    _assert_same_signs(got, ref)
    for b in range(B):
        for i in range(K):
            one = directions.inverse_iteration_signs(
                t(a[b]), t(lam_sel[b, i]), t(mags[b, i]))
            r_one = r_directions.inverse_iteration_signs(
                jnp.asarray(a[b]), jnp.asarray(lam_sel[b, i]),
                jnp.asarray(mags[b, i]))
            _assert_same_signs(one, r_one)
            np.testing.assert_array_equal(np_of(one), np_of(got[b, i]))


def test_singular_shifted_system_is_not_refused():
    """``lam + delta`` exactly on an eigenvalue: the LU has a zero pivot.
    ``torch.linalg.lu_factor`` would raise; neither package refuses it, and
    both orient the vector the same way."""
    a = np.diag([2.0, 1.0, 3.0, 5.0])[None]
    lam = np.array([[2.0]])
    mags = np.array([[[1.0, 0.0, 0.0, 0.0]]])
    with pytest.raises(RuntimeError):
        torch.linalg.lu_factor(t(a[0]) - 2.0 * torch.eye(4))
    got = directions.inverse_iteration_signs_batched(t(a), t(lam), t(mags),
                                                     shift_eps=0.0)
    ref = r_directions.inverse_iteration_signs_batched(
        jnp.asarray(a), jnp.asarray(lam), jnp.asarray(mags), shift_eps=0.0)
    np.testing.assert_array_equal(np_of(got), np.asarray(ref))
    np.testing.assert_array_equal(np_of(got)[0, 0], [1.0, 0.0, 0.0, 0.0])
    one = directions.inverse_iteration_signs(t(a[0]), 2.0, t(mags[0, 0]),
                                             shift_eps=0.0)
    np.testing.assert_array_equal(np_of(one), np_of(got)[0, 0])


def test_sign_rule_zero_is_plus_and_the_largest_entry_is_positive():
    """``sign(x) == 0`` counts as +1, and of two equal largest magnitudes
    the first is made positive (argmax's first index), as in ``repro``."""
    x = torch.tensor([[[0.0, -2.0, 3.0, -1.0]]])
    mags = torch.tensor([[[0.25, 0.25, 0.25, 0.25]]])
    out = directions._orient(x, mags)
    np.testing.assert_array_equal(np_of(out)[0, 0], [0.5, -0.5, 0.5, -0.5])
    x = torch.tensor([[[-1.0, 2.0, 3.0, 4.0]]])
    out = directions._orient(x, mags)
    np.testing.assert_array_equal(np_of(out)[0, 0], [0.5, -0.5, -0.5, -0.5])
