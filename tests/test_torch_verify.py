"""The port's verify stage against repro's, and the verified top-k program.

``verify_topk`` (torch) and ``verify_topk_host`` (numpy) of the port take
the same seeded results as ``repro.engine.verify``'s twins: sound ones
from eigh, and ones broken on purpose (a NaN, a scaled row, a wrong
eigenvalue, crossed order).  The flags must agree, and the residual (in
units of ``||A||_F``) within 1e-12 in float64.  A ``verify=True`` top-k
program returns the plain program's result bitwise, with the flags of
repro's verified program.
"""

import dataclasses

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from test_torch_parity import DTYPES, np_of, sym_stack, t  # noqa: E402

import repro.engine as r_engine  # noqa: E402
from repro.engine import engine as r_engine_mod  # noqa: E402
from repro.engine import verify as r_verify  # noqa: E402
from repro_torch.engine import engine as engine_mod  # noqa: E402
from repro_torch.engine import verify  # noqa: E402
from repro_torch.interop import plan_from_reference  # noqa: E402

B, N, K = 6, 12, 3
RESIDUAL_TOL = {"float64": 1e-12, "float32": 1e-5}


def _results(dtype, seed=0):
    """A seeded stack and its top-K eigenpairs from eigh, with matrices 1-5
    broken on purpose; matrix 0 stays sound."""
    a = sym_stack(seed, B, N)
    lam, v = np.linalg.eigh(a)
    lam = lam[:, -K:].copy()
    vecs = np.swapaxes(v[:, :, -K:], 1, 2).copy()
    vecs[1, 0, 3] = np.nan                      # not finite
    vecs[2, 1] *= 1.5                           # not unit norm
    lam[3, 2] += 0.5                            # residual too large
    lam[4] = lam[4, ::-1]                       # crossed order
    vecs[5, 2] = np.roll(vecs[5, 2], 1)         # wrong vector
    return a.astype(dtype), lam.astype(dtype), vecs.astype(dtype)


def _assert_flags(got, ref, dtype):
    for name in verify.VerifyFlags._fields:
        g, r = np_of(getattr(got, name)), np.asarray(getattr(ref, name))
        if name == "residual":
            np.testing.assert_allclose(g, r, rtol=0,
                                       atol=RESIDUAL_TOL[dtype])
        else:
            np.testing.assert_array_equal(g, r, err_msg=name)


@pytest.mark.parametrize("dtype", DTYPES)
def test_verify_topk_matches_repro(x64, dtype):
    a, lam, vecs = _results(dtype)
    got = verify.verify_topk(t(a), t(lam), t(vecs))
    ref = r_verify.verify_topk(jnp.asarray(a), jnp.asarray(lam),
                               jnp.asarray(vecs))
    _assert_flags(got, ref, dtype)
    assert np_of(got.ok).tolist() == [True] + [False] * 5
    assert got.residual.dtype == getattr(torch, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_verify_topk_host_matches_repro_and_the_device_form(x64, dtype):
    a, lam, vecs = _results(dtype, seed=1)
    got = verify.verify_topk_host(a, lam, vecs)
    _assert_flags(got, r_verify.verify_topk_host(a, lam, vecs), dtype)
    _assert_flags(verify.verify_topk(t(a), t(lam), t(vecs)), got, dtype)
    one = verify.verify_topk_host(a[0], lam[0], vecs[0])
    assert bool(one.ok) and np.ndim(one.ok) == 0


def test_verify_single_lane_is_ordered():
    a, lam, vecs = _results("float64")
    got = verify.verify_topk(t(a), t(lam[:, :1]), t(vecs[:, :1]))
    assert bool(got.ordered.all())
    host = verify.verify_topk_host(a, lam[:, :1], vecs[:, :1])
    np.testing.assert_array_equal(np_of(got.ok), host.ok)


def test_tolerances_are_repros():
    assert verify.DEFAULT_TOL == r_verify.DEFAULT_TOL == 2e-3
    assert verify.DEFAULT_NORM_TOL == r_verify.DEFAULT_NORM_TOL == 1e-3


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spectrum", ["full", "windowed"])
def test_verified_topk_program_is_bitwise_the_plain_one(x64, spectrum, dtype):
    r_plan = r_engine.SolverPlan(method="eei_tridiag", backend="pallas",
                                 spectrum=spectrum, precision=dtype)
    plan = plan_from_reference(dataclasses.asdict(r_plan))
    a = sym_stack(3, 2, 16).astype(dtype)
    plain = engine_mod.topk_program(plan, K, True)(t(a))
    res, flags = engine_mod.topk_program(plan, K, True, verify=True)(t(a))
    assert torch.equal(res.eigenvalues, plain.eigenvalues)
    assert torch.equal(res.vectors, plain.vectors)
    _, r_flags = r_engine_mod.topk_program(r_plan, K, True, verify=True)(
        jnp.asarray(a))
    for name in ("ok", "finite", "residual_ok", "norm_ok", "ordered"):
        np.testing.assert_array_equal(np_of(getattr(flags, name)),
                                      np.asarray(getattr(r_flags, name)))
    assert bool(flags.ok.all())
    if dtype == "float64":  # float32 residuals sit at 1e-4 of ||A||_F
        assert float(flags.residual.max()) < 1e-2 * verify.DEFAULT_TOL


def test_verify_is_refused_on_other_kinds():
    plan = plan_from_reference(dataclasses.asdict(
        r_engine.SolverPlan(method="eei_tridiag", backend="pallas")))
    with pytest.raises(ValueError, match="verify"):
        engine_mod.program(plan, engine_mod.ProgramSpec("solve", verify=True))
