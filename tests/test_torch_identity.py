"""The paper's component ladder and its NumPy reference, against repro's.

Every variant of ``repro_torch.core.identity`` (plain PyTorch on the CPU)
and ``repro_torch.core.numpy_ref`` takes the same numpy-seeded matrices as
its ``repro`` twin, in float64 (the ``x64`` fixture), at the tolerances of
``tests/test_identity.py``: single components rtol 1e-8 / atol 1e-12
(``:33-40``), whole tables rtol 1e-6 / atol 1e-10 (``:43-49``), the NumPy
algorithms rtol 1e-10 / 1e-8 (``:52-64``) and the n = 200 overflow case
rtol 1e-6 (``:67-90``).
"""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import identity as r_identity
from repro.core import minors as r_minors
from repro.core import numpy_ref as r_numpy_ref
from repro_torch.core import identity, minors, numpy_ref

pytestmark = pytest.mark.usefixtures("x64")

VARIANTS = ["baseline", "cached", "vectorized", "batched", "parallel",
            "logspace"]


def _sym(seed: int, n: int, scale: float = 1.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * scale
    return (a + a.T) / 2


def _close(got, ref, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=atol)


def test_variant_table_names_the_ladder():
    assert list(identity.VARIANTS) == VARIANTS == list(r_identity.VARIANTS)
    with pytest.raises(ValueError, match="unknown variant"):
        identity.component(torch.eye(3, dtype=torch.float64), 0, 0, "nope")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n", [2, 5, 12])
def test_single_component_matches_repro(variant, n):
    a = _sym(n, n)
    _, v = np.linalg.eigh(a)
    for i, j in [(0, 0), (n // 2, n - 1), (n - 1, 0)]:
        ref = float(r_identity.component(jnp.asarray(a), i, j,
                                         variant=variant, batch_size=3))
        for fn in (identity.component, identity.component_jit):
            got = fn(torch.as_tensor(a), i, j, variant=variant, batch_size=3)
            assert got.dtype == torch.float64 and got.shape == ()
            _close(float(got), ref, 1e-8, 1e-12)
        _close(ref, v[j, i] ** 2, 1e-8, 1e-12)


@pytest.mark.parametrize("logspace", [True, False])
def test_full_matrix_and_rows_match_repro(logspace):
    a = _sym(3, 16)
    got = identity.eigenmatrix_magnitudes(torch.as_tensor(a),
                                          logspace=logspace)
    ref = r_identity.eigenmatrix_magnitudes(jnp.asarray(a),
                                            logspace=logspace)
    _close(got, ref, 1e-6, 1e-10)
    _, v = np.linalg.eigh(a)
    _close(got, (v * v).T, 1e-6, 1e-10)
    for i in (0, 7, 15):
        row = identity.eigenvector_magnitudes(torch.as_tensor(a), i,
                                              logspace=logspace)
        _close(row, r_identity.eigenvector_magnitudes(
            jnp.asarray(a), i, logspace=logspace), 1e-6, 1e-10)


def test_products_match_repro():
    a = _sym(2, 12)
    lam = np.linalg.eigvalsh(a)
    mu = np.stack([np.linalg.eigvalsh(np.delete(np.delete(a, j, 0), j, 1))
                   for j in range(12)])
    _close(identity.denominator_products(torch.as_tensor(lam)),
           r_identity.denominator_products(jnp.asarray(lam)), 1e-12)
    _close(identity.numerator_products(torch.as_tensor(lam),
                                       torch.as_tensor(mu)),
           r_identity.numerator_products(jnp.asarray(lam), jnp.asarray(mu)),
           1e-12, 1e-300)
    # Batched over a leading axis, as the port's tables are.
    both = identity.denominator_products(torch.as_tensor(np.stack([lam,
                                                                   -lam])))
    _close(both[0], r_identity.denominator_products(jnp.asarray(lam)), 1e-12)


def test_delete_index_and_minor_stack_match_repro():
    x = np.arange(7.0)
    for j in range(7):
        np.testing.assert_array_equal(
            minors.delete_index(torch.as_tensor(x), j).numpy(),
            np.asarray(r_minors.delete_index(jnp.asarray(x), jnp.asarray(j))))
    a = torch.as_tensor(_sym(1, 6))
    stack = minors.minor_stack(a, torch.tensor([4, 1]))
    assert torch.equal(stack, minors.all_minors(a)[[4, 1]])


def test_numpy_reference_is_repro_s_and_matches_the_ladder():
    """``tests/test_identity.py:52-64`` on the port: the NumPy Algorithms
    1 and 2 agree with each other and with the port's log-space variant,
    and the port's copy returns repro's bits."""
    a = _sym(4, 10)
    for i, j in [(0, 3), (9, 9), (5, 0)]:
        base = numpy_ref.eigen_component_baseline(a, i, j)
        opt = numpy_ref.eigen_component_optimized(a, i, j, batch_size=4)
        port = float(identity.component(torch.as_tensor(a), i, j))
        _close(base, opt, 1e-10)
        _close(base, port, 1e-8)
        assert base == r_numpy_ref.eigen_component_baseline(a, i, j)
        assert opt == r_numpy_ref.eigen_component_optimized(a, i, j,
                                                             batch_size=4)
        lam = np.linalg.eigvalsh(a)
        mu = np.linalg.eigvalsh(np.delete(np.delete(a, j, 0), j, 1))
        for name in ("eigen_component_cached", "eigen_component_vectorized"):
            assert getattr(numpy_ref, name)(lam, mu, i) == \
                getattr(r_numpy_ref, name)(lam, mu, i)
    with ThreadPoolExecutor(max_workers=2) as pool:
        threaded = numpy_ref.eigen_component_optimized(a, 5, 0, batch_size=4,
                                                       executor=pool)
    assert threaded == numpy_ref.eigen_component_optimized(a, 5, 0,
                                                           batch_size=4)
    np.testing.assert_array_equal(numpy_ref.eigenvector_magnitudes(a, 2),
                                  r_numpy_ref.eigenvector_magnitudes(a, 2))
    lam, v = numpy_ref.numpy_full_eigh(a)
    np.testing.assert_array_equal(lam, np.linalg.eigh(a)[0])


@pytest.mark.parametrize("variant", VARIANTS)
def test_overflow_case_matches_repro(variant):
    """``tests/test_identity.py:67-90``: at n = 200 (x10) the unpaired
    products over- or underflow in both packages, while the paired
    batches and log space stay within 1e-6 of eigh."""
    n = 200
    a = _sym(0, n, scale=10.0)
    got = float(identity.component(torch.as_tensor(a), n // 2, 0,
                                   variant=variant))
    ref = float(r_identity.component(jnp.asarray(a), n // 2, 0,
                                     variant=variant))
    if variant in ("baseline", "cached", "vectorized"):
        assert not np.isfinite(got) and not np.isfinite(ref)
        return
    _, v = np.linalg.eigh(a)
    _close(got, v[0, n // 2] ** 2, 1e-6)
    _close(got, ref, 1e-6)


def test_variants_take_a_float32_matrix():
    a = torch.as_tensor(_sym(5, 8), dtype=torch.float32)
    vals = {v: float(identity.component(a, 3, 2, variant=v))
            for v in VARIANTS}
    assert all(np.isfinite(x) for x in vals.values())
    _close(list(vals.values()), [vals["logspace"]] * len(vals), 1e-3, 1e-5)
