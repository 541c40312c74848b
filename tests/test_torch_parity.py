"""Parity harness shared by the repro_torch tests, and its own checks.

The port's tests build one input from a seed with numpy, pass it to a
``repro`` function (Pallas in interpret mode, as ``repro``'s own tests run
it) and to its ``repro_torch`` twin on the CPU, and compare the two here.
Tolerances are ``repro``'s own (``tests/test_kernels.py``,
``tests/test_engine.py``).
"""

import numpy as np
import pytest
import torch

#: (rtol, atol) per comparison and dtype name.
TOL = {
    # tests/test_kernels.py:31 (prod-diff grid) and :185 (Sturm)
    "prod_diff": {"float64": (1e-10, 1e-10), "float32": (1e-4, 1e-4)},
    "sturm": {"float64": (1e-10, 1e-10), "float32": (2e-5, 2e-5)},
    # tests/test_engine.py:56-59 (engine against eigh)
    "eigenvalues": {"float64": (1e-6, 1e-8), "float32": (2e-5, 2e-5)},
    "magnitudes": {"float64": (1e-4, 1e-7), "float32": (0.0, 2e-3)},
}
# float32 engine components: repro's engine tests set no float32 bound.  At
# n = 16 the float32 EEI components of both packages are 4e-4 to 6e-4 from
# the float64 truth, so they are held to the residual tolerance of repro's
# verify stage, 2e-3 (engine/verify.py), and test_torch_engine.py checks
# that the port is as accurate as repro against that truth.

DTYPES = ("float64", "float32")


def sym_stack(seed: int, b: int, n: int, dtype: str = "float64") -> np.ndarray:
    """Seeded stack of ``b`` symmetric ``n x n`` matrices."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((b, n, n))
    return ((a + np.swapaxes(a, 1, 2)) / 2).astype(dtype)


def bands(seed: int, b: int, n: int, dtype: str = "float64"):
    """Seeded tridiagonal bands ``d (b, n)``, ``e (b, n-1)``."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n)).astype(dtype),
            rng.standard_normal((b, n - 1)).astype(dtype))


def t(x) -> torch.Tensor:
    """A numpy array as a CPU tensor of the same dtype."""
    return torch.as_tensor(np.ascontiguousarray(x))


def np_of(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(port, ref, kind: str, dtype: str) -> None:
    """Port result against the reference with ``TOL[kind][dtype]``."""
    rtol, atol = TOL[kind][dtype]
    port, ref = np_of(port), np_of(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port.astype(np.float64), ref.astype(np.float64),
                               rtol=rtol, atol=atol)


def align_rows(v: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Flip each row of ``v`` so its sign agrees with ``ref`` at the
    reference row's largest component (sign recovery is discrete)."""
    v, ref = np_of(v), np_of(ref)
    j = np.argmax(np.abs(ref), axis=-1)[..., None]
    flip = np.sign(np.take_along_axis(v, j, -1)) != \
        np.sign(np.take_along_axis(ref, j, -1))
    return np.where(flip, -v, v)


# ---------------------------------------------------------------------------
# Checks of the harness itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_assert_close_flags_a_mismatch(dtype):
    """The harness must fail a result off by more than the tolerance."""
    ref = np.linspace(-3.0, 3.0, 7).astype(dtype)
    assert_close(t(ref), ref, "prod_diff", dtype)
    bad = ref.copy()
    bad[3] += 1e-3
    with pytest.raises(AssertionError):
        assert_close(t(bad), ref, "prod_diff", dtype)


def test_align_rows_fixes_only_the_sign():
    ref = np.array([[0.1, -0.9, 0.2], [0.7, 0.1, -0.1]])
    v = np.array([[-0.1, 0.9, -0.2], [0.7, 0.1, -0.1]])
    np.testing.assert_array_equal(align_rows(v, ref), ref)
    np.testing.assert_array_equal(align_rows(t(ref), ref), ref)


def test_sym_stack_is_symmetric_and_seeded():
    a = sym_stack(3, 2, 5, "float32")
    assert a.dtype == np.float32
    np.testing.assert_array_equal(a, np.swapaxes(a, 1, 2))
    np.testing.assert_array_equal(a, sym_stack(3, 2, 5, "float32"))
