"""repro_torch linalg and core modules against their repro twins.

Sturm bisection (cold and from warm brackets), the interlacing brackets, the
Householder reduce, minors, the log-space identity and the tridiagonal sign
recurrence: the same seeded numpy inputs through
``repro`` and through the port on the CPU.
"""

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from hypothesis_compat import given, settings, st  # noqa: E402
from test_torch_parity import (  # noqa: E402
    DTYPES,
    align_rows,
    assert_close,
    bands,
    np_of,
    sym_stack,
    t,
)

from repro.core import directions as r_directions  # noqa: E402
from repro.core import identity as r_identity  # noqa: E402
from repro.core import minors as r_minors  # noqa: E402
from repro.linalg import householder as r_householder  # noqa: E402
from repro.linalg import interlace as r_interlace  # noqa: E402
from repro.linalg import sturm as r_sturm  # noqa: E402
from repro_torch.core import directions, identity, minors  # noqa: E402
from repro_torch.linalg import householder, interlace, sturm  # noqa: E402

# -- linalg/sturm ------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_bounds_and_pivmin_match_repro(dtype):
    d, e = bands(1, 3, 9, dtype)
    lo, hi = sturm.gershgorin_bounds(t(d), t(e))
    piv = sturm._pivmin(t(d), t(e))
    for i in range(3):
        rlo, rhi = r_sturm.gershgorin_bounds(jnp.asarray(d[i]), jnp.asarray(e[i]))
        assert_close(lo[i], rlo, "sturm", dtype)
        assert_close(hi[i], rhi, "sturm", dtype)
        assert_close(piv[i], r_sturm._pivmin(jnp.asarray(d[i]), jnp.asarray(e[i])),
                     "sturm", dtype)


def test_sturm_count_matches_repro():
    d, e = bands(2, 2, 12)
    x = np.linspace(-4.0, 4.0, 17)
    got = sturm.sturm_count(t(d), t(e), t(np.broadcast_to(x, (2, 17))))
    for i in range(2):
        ref = r_sturm.sturm_count(jnp.asarray(d[i]), jnp.asarray(e[i]),
                                  jnp.asarray(x))
        np.testing.assert_array_equal(np_of(got[i]), np.asarray(ref))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 2, 5, 16, 40])
def test_bisect_eigenvalues_match_repro(n, dtype):
    d, e = bands(n, 2, n, dtype)
    got = sturm.bisect_eigenvalues_batched(t(d), t(e))
    ref = r_sturm.bisect_eigenvalues_batched(jnp.asarray(d), jnp.asarray(e))
    assert_close(got, ref, "sturm", dtype)
    single = sturm.bisect_eigenvalues(t(d[0]), t(e[0]))
    assert_close(single, r_sturm.bisect_eigenvalues(
        jnp.asarray(d[0]), jnp.asarray(e[0])), "sturm", dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("largest", [True, False])
def test_bisect_windowed_match_repro(largest, dtype):
    d, e = bands(3, 3, 21, dtype)
    k = 4
    got = sturm.bisect_eigenvalues_windowed_batched(t(d), t(e), k,
                                                    largest=largest)
    ref = r_sturm.bisect_eigenvalues_windowed_batched(
        jnp.asarray(d), jnp.asarray(e), k, largest=largest)
    assert_close(got, ref, "sturm", dtype)
    full = sturm.bisect_eigenvalues_batched(t(d), t(e))
    assert torch.equal(got, full[:, -k:] if largest else full[:, :k])
    with pytest.raises(ValueError):
        sturm.bisect_eigenvalues_windowed(t(d), t(e), 22)


# -- linalg/householder -------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 8, 33])
def test_tridiagonalize_matches_repro(n):
    a = sym_stack(n, 1, n)[0]
    d, e, q = householder.tridiagonalize(t(a))
    rd, re, rq = r_householder.tridiagonalize(jnp.asarray(a))
    assert_close(d, rd, "sturm", "float64")
    assert_close(e, re, "sturm", "float64")
    assert_close(q, rq, "sturm", "float64")
    tri = householder.tridiagonal_matrix(d, e)
    np.testing.assert_allclose(np_of(q.T @ t(a) @ q), np_of(tri), atol=1e-10)
    d2, e2, q2 = householder.tridiagonalize(t(a), with_q=False)
    assert q2 is None
    assert torch.equal(d2, d) and torch.equal(e2, e)


@pytest.mark.parametrize("dtype", DTYPES)
def test_tridiagonalize_batched_matches_repro(dtype):
    a = sym_stack(4, 3, 14, dtype)
    d, e, q = householder.tridiagonalize_batched(t(a))
    rd, re, rq = r_householder.tridiagonalize_batched(jnp.asarray(a))
    assert d.dtype == t(a).dtype
    kind = "sturm" if dtype == "float64" else "prod_diff"
    for got, ref in ((d, rd), (e, re), (q, rq)):
        assert_close(got, ref, kind, dtype)


def test_tridiagonal_matrix_matches_repro():
    d, e = bands(5, 1, 6)
    got = householder.tridiagonal_matrix(t(d[0]), t(e[0]))
    ref = r_householder.tridiagonal_matrix(jnp.asarray(d[0]), jnp.asarray(e[0]))
    np.testing.assert_array_equal(np_of(got), np.asarray(ref))


# -- core/minors --------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 9])
def test_minor_bands_match_repro(n):
    d, e = bands(n, 2, n)
    dm, em = minors.all_tridiagonal_minor_bands_batched(t(d), t(e))
    rdm, rem = r_minors.all_tridiagonal_minor_bands_batched(
        jnp.asarray(d), jnp.asarray(e))
    np.testing.assert_array_equal(np_of(dm), np.asarray(rdm))
    np.testing.assert_array_equal(np_of(em), np.asarray(rem))
    r_bands = jax.jit(r_minors.tridiagonal_minor_bands)
    for j in range(n):
        dj, ej = minors.tridiagonal_minor_bands(t(d[0]), t(e[0]), j)
        rdj, rej = r_bands(jnp.asarray(d[0]), jnp.asarray(e[0]), jnp.asarray(j))
        np.testing.assert_array_equal(np_of(dj), np.asarray(rdj))
        np.testing.assert_array_equal(np_of(ej), np.asarray(rej))


def test_dense_minors_match_repro():
    a = sym_stack(6, 2, 7)
    got = minors.all_minors(t(a))
    assert got.shape == (2, 7, 6, 6)
    for i in range(2):
        ref = r_minors.all_minors(jnp.asarray(a[i]))
        np.testing.assert_array_equal(np_of(got[i]), np.asarray(ref))
        np.testing.assert_array_equal(
            np_of(minors.minor(t(a[i]), 3)),
            np.asarray(r_minors.minor(jnp.asarray(a[i]), jnp.asarray(3))))


# -- core/identity (log-space part) ----------------------------------------------


def _spectra(seed, b, n, dtype="float64"):
    """Eigenvalues of seeded matrices and of their minors (numpy eigh)."""
    a = sym_stack(seed, b, n, dtype)
    lam = np.linalg.eigvalsh(a.astype(np.float64)).astype(dtype)
    sel = np.array([[p + (p >= j) for p in range(n - 1)] for j in range(n)])
    minors_np = a[:, sel[:, :, None], sel[:, None, :]]
    mu = np.linalg.eigvalsh(minors_np.astype(np.float64)).astype(dtype)
    return a, lam, mu


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reduce", ["sum", "dot"])
@pytest.mark.parametrize("rows", [None, (9, 10, 11)])
def test_magnitudes_from_spectra_match_repro(rows, reduce, dtype):
    _, lam, mu = _spectra(7, 3, 12, dtype)
    idx = None if rows is None else np.array(rows)
    got = identity.magnitudes_from_spectra(
        t(lam), t(mu), reduce=reduce,
        rows=None if idx is None else torch.as_tensor(idx))
    ref = jax.jit(lambda lm, m: r_identity.magnitudes_from_spectra(
        lm, m, reduce=reduce, rows=None if idx is None else jnp.asarray(idx)))(
        jnp.asarray(lam), jnp.asarray(mu))
    assert_close(got, ref, "prod_diff", dtype)
    if idx is not None:
        full = identity.magnitudes_from_spectra(t(lam), t(mu), reduce=reduce)
        assert torch.equal(got, full[:, idx])


@pytest.mark.parametrize("dtype", DTYPES)
def test_logabs_sums_match_repro(dtype):
    _, lam, mu = _spectra(8, 1, 10, dtype)
    lam, mu = lam[0], mu[0]
    jl, jm = jnp.asarray(lam), jnp.asarray(mu)
    assert_close(identity.logabs_numerator(t(lam), t(mu)),
                 r_identity.logabs_numerator(jl, jm), "prod_diff", dtype)
    assert_close(identity.logabs_numerator_dot(t(lam), t(mu), floor=1e-6),
                 r_identity.logabs_numerator_dot(jl, jm, floor=1e-6),
                 "prod_diff", dtype)
    assert_close(identity.logabs_denominator(t(lam)),
                 r_identity.logabs_denominator(jl), "prod_diff", dtype)
    assert_close(identity.logabs_denominator_dot(t(lam)),
                 r_identity.logabs_denominator_dot(jl), "prod_diff", dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 2, 11])
def test_minor_logdets_and_windowed_magnitudes_match_repro(n, dtype):
    d, e = bands(n + 20, 2, n, dtype)
    lam = np.linalg.eigvalsh(np_of(householder.tridiagonal_matrix(
        t(d.astype(np.float64)), t(e.astype(np.float64))))).astype(dtype)
    x = lam[:, -min(n, 3):]
    got = identity.tridiag_minor_logdets(t(d), t(e), t(x))
    got_w = identity.tridiag_windowed_magnitudes_batched(t(d), t(e), t(x))
    ref_w = jax.jit(r_identity.tridiag_windowed_magnitudes_batched)(
        jnp.asarray(d), jnp.asarray(e), jnp.asarray(x))
    assert_close(got_w, ref_w, "prod_diff", dtype)
    r_logdets = jax.jit(r_identity.tridiag_minor_logdets)
    for i in range(2):
        ref = r_logdets(jnp.asarray(d[i]), jnp.asarray(e[i]), jnp.asarray(x[i]))
        assert_close(got[i], ref, "prod_diff", dtype)
        assert_close(identity.tridiag_windowed_magnitudes(
            t(d[i]), t(e[i]), t(x[i])), ref_w[i], "prod_diff", dtype)


# -- core/directions ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_tridiagonal_signs_match_repro(dtype):
    d, e = bands(30, 2, 10, dtype)
    tri = np_of(householder.tridiagonal_matrix(t(d), t(e))).astype(np.float64)
    lam, v = np.linalg.eigh(tri)
    lam = lam[:, -4:].astype(dtype)
    mags = np.swapaxes(v[..., -4:] ** 2, -1, -2).astype(dtype)
    got = directions.tridiagonal_signs(t(d), t(e), t(lam), t(mags))
    inner = jax.vmap(r_directions.tridiagonal_signs, in_axes=(None, None, 0, 0))
    ref = np.asarray(jax.jit(jax.vmap(inner))(
        jnp.asarray(d), jnp.asarray(e), jnp.asarray(lam), jnp.asarray(mags)))
    assert_close(got, ref, "prod_diff", dtype)
    # and the signs are those of the true eigenvectors
    truth = np.swapaxes(v[..., -4:], -1, -2)
    assert_close(align_rows(np_of(got), truth), truth, "prod_diff", "float32")


# -- linalg/sturm: warm brackets ------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("largest", [True, False])
def test_bisect_bracketed_matches_repro_with_stale_lanes(largest, dtype):
    """Sound brackets from the spectrum itself on matrices 0-1, stale ones
    (a shifted spectrum) on matrix 2: every lane lands on its eigenvalue."""
    d, e = bands(12, 3, 14, dtype)
    k = 4
    lam = np.asarray(r_sturm.bisect_eigenvalues_batched(jnp.asarray(d),
                                                        jnp.asarray(e)))
    win = lam[:, -k:] if largest else lam[:, :k]
    lo = (win - 0.05).astype(dtype)
    hi = (win + 0.05).astype(dtype)
    lo[2] += 3.0
    hi[2] += 3.0
    got = sturm.bisect_eigenvalues_bracketed_batched(
        t(d), t(e), t(lo), t(hi), k, largest=largest)
    ref = r_sturm.bisect_eigenvalues_bracketed_batched(
        jnp.asarray(d), jnp.asarray(e), jnp.asarray(lo), jnp.asarray(hi), k,
        largest=largest)
    assert_close(got, ref, "sturm", dtype)
    assert_close(got, win, "sturm", dtype)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 10_000), n=st.integers(3, 16),
       k=st.integers(1, 3), shift=st.sampled_from([-5.0, 0.0, 5.0]))
def test_property_bracketed_bisection_distrusts_stale_brackets(seed, n, k,
                                                               shift):
    """tests/test_linalg.py:178-199 mirrored: brackets from the shifted
    spectrum of another matrix still give the index-correct eigenvalues."""
    rng = np.random.default_rng(seed)
    k = min(k, n)
    d = rng.standard_normal(n)
    e = rng.standard_normal(n - 1)
    ref = np.linalg.eigvalsh(np_of(householder.tridiagonal_matrix(t(d),
                                                                   t(e))))
    stale = np.sort(rng.standard_normal(n)) + shift
    lo, hi = interlace.rank1_update_brackets(t(stale), 0.1)
    got = sturm.bisect_eigenvalues_bracketed(t(d), t(e), lo[-k:], hi[-k:], k,
                                             largest=True)
    np.testing.assert_allclose(np_of(got), ref[-k:], atol=1e-8)


def test_bracketed_segment_of_the_whole_band_is_the_window():
    """With one full-band segment and the Gershgorin bracket, the segmented
    plain bisection is bitwise the windowed one (kernel 3 vs kernel 1)."""
    d, e = (t(x) for x in bands(8, 3, 19))
    k = 5
    lo, hi = sturm.gershgorin_bounds(d, e)
    lanes = lambda x: x.unsqueeze(-1).expand(3, k)  # noqa: E731
    targets = torch.arange(19 - k, 19, dtype=torch.int32).expand(3, k)
    got = sturm.bisect_lanes_segmented(
        d, e, lanes(lo), lanes(hi), lanes(sturm._pivmin(d, e)),
        torch.zeros_like(targets), torch.full_like(targets, 19), targets, 64)
    assert torch.equal(got, sturm.bisect_eigenvalues_windowed(d, e, k))


# -- linalg/interlace -----------------------------------------------------------


def _spectrum(seed, shape, dtype="float64"):
    rng = np.random.default_rng(seed)
    return np.sort(rng.standard_normal(shape), axis=-1).astype(dtype)


def test_interlacing_checks_match_repro():
    a = sym_stack(0, 1, 9)[0]
    lam = np.linalg.eigvalsh(a)
    mu = np.linalg.eigvalsh(a[1:, 1:])
    theta = np.linalg.eigvalsh(np.linalg.qr(
        np.random.default_rng(1).standard_normal((9, 4)))[0].T
        @ a @ np.linalg.qr(np.random.default_rng(1).standard_normal(
            (9, 4)))[0])
    for got, ref in (
            (interlace.interlacing_holds(t(lam), t(mu)),
             r_interlace.interlacing_holds(jnp.asarray(lam), jnp.asarray(mu))),
            (interlace.interlacing_holds(t(lam), t(mu + 1.0)),
             r_interlace.interlacing_holds(jnp.asarray(lam),
                                           jnp.asarray(mu + 1.0))),
            (interlace.ritz_interlacing_holds(t(lam), t(theta)),
             r_interlace.ritz_interlacing_holds(jnp.asarray(lam),
                                                jnp.asarray(theta))),
            (interlace.ritz_interlacing_holds(t(lam), t(theta * 3.0)),
             r_interlace.ritz_interlacing_holds(jnp.asarray(lam),
                                                jnp.asarray(theta * 3.0)))):
        assert bool(got) == bool(ref)
    assert bool(interlace.interlacing_holds(t(lam), t(mu)))
    assert not bool(interlace.interlacing_holds(t(lam), t(mu + 1.0)))


@pytest.mark.parametrize("rtol", [0.0, 1e-7, 0.5])
def test_interlacing_brackets_match_repro(rtol):
    lam = _spectrum(2, (3, 8))
    lam[0, 3:6] = lam[0, 3]  # a repeated eigenvalue: zero-width brackets
    lo, hi = interlace.interlacing_brackets(t(lam), rtol=rtol)
    rlo, rhi = r_interlace.interlacing_brackets(jnp.asarray(lam), rtol=rtol)
    np.testing.assert_allclose(np_of(lo), np.asarray(rlo), rtol=0, atol=1e-12)
    np.testing.assert_allclose(np_of(hi), np.asarray(rhi), rtol=0, atol=1e-12)


@pytest.mark.parametrize("rho", [0.7, -0.4, 0.0, "batched"])
def test_rank1_update_brackets_match_repro(rho):
    lam = _spectrum(3, (3, 6))
    if rho == "batched":
        rho = np.array([0.3, -1.2, 0.0])
    slack = np.array([[1e-3], [0.0], [2e-2]])
    got = interlace.rank1_update_brackets(t(lam), t(np.asarray(rho)),
                                          drift_bound=t(slack))
    ref = r_interlace.rank1_update_brackets(
        jnp.asarray(lam), jnp.asarray(rho), drift_bound=jnp.asarray(slack))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np_of(g), np.asarray(r), rtol=0,
                                   atol=1e-12)
    plain = interlace.rank1_update_brackets(t(lam[0]), 0.25)
    rplain = r_interlace.rank1_update_brackets(jnp.asarray(lam[0]), 0.25)
    for g, r in zip(plain, rplain):
        np.testing.assert_allclose(np_of(g), np.asarray(r), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("rho", [0.9, -0.6])
def test_secular_refine_matches_repro_and_contains_the_roots(rho):
    """With the full-space weights the secular roots are the updated
    spectrum, and refinement keeps containing it."""
    rng = np.random.default_rng(5)
    lam = np.sort(rng.standard_normal(7))
    z = rng.standard_normal(7)
    z /= np.linalg.norm(z)
    lam_new = np.linalg.eigvalsh(np.diag(lam) + rho * np.outer(z, z))
    lo, hi = interlace.rank1_update_brackets(t(lam), rho)
    got = interlace.secular_bracket_refine(t(lam), t(z * z), rho, lo, hi)
    rlo, rhi = r_interlace.rank1_update_brackets(jnp.asarray(lam), rho)
    ref = r_interlace.secular_bracket_refine(
        jnp.asarray(lam), jnp.asarray(z * z), rho, rlo, rhi)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np_of(g), np.asarray(r), rtol=0,
                                   atol=1e-12)
    assert (lam_new >= np_of(got[0]) - 1e-12).all()
    assert (lam_new <= np_of(got[1]) + 1e-12).all()
    assert (np_of(got[1] - got[0]) <= np_of(hi - lo) + 1e-15).all()
    # Batched, with every midpoint exactly on a pole (the guard's case):
    # zero-width brackets at the old eigenvalues, and wide ones.
    lam_b = np.stack([lam, lam + 1.0])
    z2_b = np.stack([z * z, np.roll(z * z, 2)])
    rho_b = np.array([rho, -rho])
    lo_b = np.stack([lam, lam])
    hi_b = np.stack([lam, lam + 2.0])
    got = interlace.secular_bracket_refine(t(lam_b), t(z2_b), t(rho_b),
                                           t(lo_b), t(hi_b))
    ref = r_interlace.secular_bracket_refine(
        jnp.asarray(lam_b), jnp.asarray(z2_b), jnp.asarray(rho_b),
        jnp.asarray(lo_b), jnp.asarray(hi_b))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np_of(g), np.asarray(r), rtol=0,
                                   atol=1e-12)


def test_degenerate_spectrum_bracketed_end_to_end():
    """tests/test_linalg.py:202-213 mirrored: all-equal spectrum."""
    n = 10
    d = torch.full((n,), 3.0, dtype=torch.float64)
    e = torch.zeros((n - 1,), dtype=torch.float64)
    lo, hi = interlace.rank1_update_brackets(
        torch.full((n,), 3.0, dtype=torch.float64), 0.0)
    assert bool((hi - lo > 0).all())
    got = sturm.bisect_eigenvalues_bracketed(d, e, lo[-4:], hi[-4:], 4)
    np.testing.assert_allclose(np_of(got), np.full(4, 3.0), atol=1e-10)
