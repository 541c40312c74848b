"""The Lanczos partial band and the Krylov compositions (``eei_krylov``,
``eei_krylov_si``) against ``repro``.

``repro``'s property tests (``tests/test_lanczos.py``) are mirrored on the
port, over fixed seeds in place of hypothesis draws: orthonormal basis,
Poincare interlacing, the breakdown restart, the guard fill, the shift
outside the spectrum and the default band sizes.  The band itself is held
against ``repro.linalg.lanczos`` given ``repro``'s own start vector, with
the same ``steps`` per matrix on a stack whose matrices stop at different
checks.  The engine's Krylov programs meet ``repro``'s and the eigh oracle
within ``repro``'s tolerances: eigenvalues within 1e-10 of the span and
vector dots above 1 - 1e-8 in float64 (``tests/test_lanczos.py:196-246``).
"""

import dataclasses

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from test_torch_parity import np_of, t  # noqa: E402

import repro.engine as r_engine  # noqa: E402
from repro.linalg import lanczos as r_lanczos  # noqa: E402
from repro_torch import Rank1Update, SolverEngine, SolverPlan  # noqa: E402
from repro_torch.interop import plan_from_reference  # noqa: E402
from repro_torch.linalg import lanczos  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """This file's tests on one torch and one OpenBLAS thread: with
    parallel test workers, each would otherwise start a thread a core of
    each, and the oversubscribed cores ran its heaviest test 17-35x
    slower than alone."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # the limit on torch's threads still holds
        limits = None
    else:
        limits = threadpool_limits(limits=1, user_api="blas")
    yield
    if limits is not None:
        limits.restore_original_limits()
    torch.set_num_threads(was)


BACKENDS = ["reference", "torch", "cuda"]
R_BACKENDS = {"reference": "reference", "torch": "jnp", "cuda": "pallas"}
KINDS = ("goe", "spd", "clustered", "rank_deficient")


def _matrix(kind: str, n: int, seed: int) -> np.ndarray:
    """``tests/test_lanczos.py``'s matrix classes."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    if kind == "goe":
        return a
    q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    if kind == "spd":
        lam = rng.uniform(0.1, 10.0, n)
    elif kind == "clustered":
        lam = np.concatenate([np.linspace(0.0, 1.0, n - 3),
                              2.0 + 1e-8 * np.arange(3.0)])
    else:
        lam = np.concatenate([np.zeros(n - max(2, n // 4)),
                              rng.uniform(1.0, 5.0, max(2, n // 4))])
    return q @ np.diag(lam) @ q.T


def _repro_v0(n: int) -> np.ndarray:
    """The start vector ``repro``'s ``lanczos_iterate`` draws (seed 0)."""
    v0 = jax.random.normal(jax.random.PRNGKey(0), (n,), jnp.float64)
    return np.asarray(v0 / jnp.linalg.norm(v0))


#: (kind, n, m, k, seed) draws for the property tests.
CASES = [(kind, n, m, k, seed)
         for seed, (n, m, k) in enumerate([(8, 8, 1), (23, 11, 4),
                                           (40, 40, 40), (31, 2, 2)])
         for kind in KINDS]


@pytest.mark.parametrize("kind,n,m,k,seed", CASES)
def test_reorthogonalization_keeps_basis_orthonormal(kind, n, m, k, seed):
    res = lanczos.lanczos_partial(t(_matrix(kind, n, seed)), m, k)
    steps = int(res.steps)
    assert 1 <= steps <= m
    q = np_of(res.q)[:, :steps]
    assert np.max(np.abs(q.T @ q - np.eye(steps))) < 1e-12
    assert not np.any(np_of(res.q)[:, steps:])


@pytest.mark.parametrize("kind,n,m,k,seed", CASES)
def test_ritz_values_interlace_full_spectrum(kind, n, m, k, seed):
    """Poincare separation ``lam[i] <= theta[i] <= lam[i + n - m]``."""
    a = _matrix(kind, n, seed)
    res = lanczos.lanczos_partial(t(a), m, min(2, m))
    steps = int(res.steps)
    d, e = np_of(res.d)[:steps], np_of(res.e)[:steps - 1]
    theta = np.linalg.eigvalsh(np.diag(d) + np.diag(e, 1) + np.diag(e, -1))
    lam = np.linalg.eigvalsh(a)
    tol = 1e-9 * max(1.0, np.abs(lam).max())
    assert np.all(theta >= lam[:steps] - tol)
    assert np.all(theta <= lam[n - steps:] + tol)


def test_breakdown_restart_fills_window_past_rank():
    n, r, k = 48, 4, 8
    rng = np.random.default_rng(3)
    low = rng.standard_normal((n, r))
    a = low @ low.T
    lam = np.linalg.eigvalsh(a)
    out = SolverEngine(SolverPlan(method="eei_krylov", backend="torch"),
                       device="cpu").topk(a, k)
    np.testing.assert_allclose(np_of(out.eigenvalues), lam[-k:],
                               atol=1e-8 * lam[-1])
    # The band broke down (an exact invariant subspace) and restarted
    # through a zero junction.
    res = lanczos.lanczos_partial(t(a), 16, k)
    assert int(res.steps) == 16
    assert np.any(np_of(res.e) == 0.0)


@pytest.mark.parametrize("largest", [True, False])
def test_guard_filled_band_entries_stay_out_of_the_window(largest):
    n, m, k = 24, 16, 2
    a = _staggered_stack(n)[1] * (1 if largest else -1)
    res = lanczos.lanczos_partial(t(a), m, k, largest=largest,
                                  check_every=4, rtol=1e-6)
    steps = int(res.steps)
    assert steps < m  # converged early: the tail is guard-filled
    d = np_of(res.d)
    if largest:
        assert np.all(d[steps:] < d[:steps].min())
    else:
        assert np.all(d[steps:] > d[:steps].max())
    assert not np.any(np_of(res.e)[steps - 1:])
    r = r_lanczos.lanczos_partial(jnp.asarray(a), m, k, largest,
                                  check_every=4, rtol=1e-6)
    assert int(r.steps) == steps


def test_shift_invert_sigma_sits_outside_the_spectrum():
    a = _matrix("goe", 32, 11)
    lam = np.linalg.eigvalsh(a)
    for largest in (True, False):
        sigma = float(lanczos.shift_invert_sigma(t(a), largest))
        assert sigma > lam[-1] if largest else sigma < lam[0]
        np.testing.assert_allclose(
            sigma, float(r_lanczos.shift_invert_sigma(jnp.asarray(a),
                                                      largest)), rtol=1e-14)


def test_default_band_sizes():
    assert lanczos.default_m(4096, 16) == r_lanczos.default_m(4096, 16) == 256
    assert lanczos.default_m(4096, 1) == 128
    assert lanczos.default_m(64, 16) == 64
    assert lanczos.default_si_m(4096, 16) == 128
    d, e, q = lanczos.krylov_reduce(t(_matrix("goe", 32, 0)), 2, True, m=8)
    assert d.shape == (8,) and e.shape == (7,) and q.shape == (32, 8)


# ---------------------------------------------------------------------------
# The band against repro's, given repro's start vector
# ---------------------------------------------------------------------------


def _staggered_stack(n: int) -> np.ndarray:
    """Matrices that converge at different residual checks: a wide top gap
    converges first, a GOE last."""
    rng = np.random.default_rng(21)
    q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    fast = q @ np.diag(np.concatenate([np.linspace(0, 1, n - 2),
                                       [10.0, 20.0]])) @ q.T
    mid = q @ np.diag(np.concatenate([np.linspace(0, 1, n - 2),
                                      [1.5, 2.0]])) @ q.T
    return np.stack([_matrix("goe", n, 5), fast, mid])


@pytest.mark.parametrize("largest", [True, False])
def test_band_matches_repro_with_its_start_vector(largest):
    n, m, k = 48, 48, 2
    a = _staggered_stack(n)
    if not largest:
        a = -a
    v0 = _repro_v0(n)
    ref = jax.vmap(lambda x: r_lanczos.lanczos_partial(
        x, m, k, largest, check_every=8, rtol=1e-8))(jnp.asarray(a))
    got = lanczos.lanczos_partial(t(a), m, k, largest, check_every=8,
                                  rtol=1e-8, v0=t(v0))
    steps = np_of(got.steps)
    np.testing.assert_array_equal(steps, np.asarray(ref.steps))
    assert len(set(steps.tolist())) == 3, steps  # three different stops
    for b, s in enumerate(steps):
        np.testing.assert_allclose(np_of(got.d)[b, :s],
                                   np.asarray(ref.d)[b, :s], atol=1e-10)
        np.testing.assert_allclose(np_of(got.e)[b, :s - 1],
                                   np.asarray(ref.e)[b, :s - 1], atol=1e-10)
        np.testing.assert_allclose(np_of(got.q)[b, :, :s],
                                   np.asarray(ref.q)[b, :, :s], atol=1e-9)
    # The guard fill and the zeros beyond each matrix's own steps.
    np.testing.assert_allclose(np_of(got.d), np.asarray(ref.d), atol=1e-9)
    np.testing.assert_array_equal(np_of(got.e) == 0, np.asarray(ref.e) == 0)


def test_iterate_matches_repro_without_a_window():
    n, m = 30, 12
    a = _matrix("spd", n, 4)
    d, e, q, j, _ = r_lanczos.lanczos_iterate(jnp.asarray(a), m)
    d2, e2, q2, j2, _ = lanczos.lanczos_iterate(t(a), m, v0=t(_repro_v0(n)))
    assert int(j) == int(j2) == m
    np.testing.assert_allclose(np_of(d2), np.asarray(d), atol=1e-10)
    np.testing.assert_allclose(np_of(e2), np.asarray(e), atol=1e-10)
    np.testing.assert_allclose(np_of(q2), np.asarray(q), atol=1e-9)


# ---------------------------------------------------------------------------
# The engine's Krylov programs
# ---------------------------------------------------------------------------


def _goe_stack(b: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((b, n, n))
    return (a + np.swapaxes(a, 1, 2)) / 2


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("method", ["eei_krylov", "eei_krylov_si"])
def test_krylov_topk_matches_repro_and_eigh(method, backend):
    b, n, k = 2, 96, 4
    a = _goe_stack(b, n, 5)
    lam_o, v_o = np.linalg.eigh(a)
    span = float(np.max(lam_o[:, -1] - lam_o[:, 0]))
    r_plan = r_engine.SolverPlan(method=method, backend=R_BACKENDS[backend])
    plan = plan_from_reference(dataclasses.asdict(r_plan))
    assert plan.backend == backend
    out = SolverEngine(plan, device="cpu").topk(a, k)
    ref = r_engine.SolverEngine(r_plan).topk(jnp.asarray(a), k)
    assert out.eigenvalues.shape == (b, k) and out.vectors.shape == (b, k, n)
    for lam in (lam_o[:, -k:], np.asarray(ref.eigenvalues)):
        assert np.max(np.abs(np_of(out.eigenvalues) - lam)) / span < 1e-10
    for vecs in (np.swapaxes(v_o[:, :, -k:], -1, -2), np.asarray(ref.vectors)):
        dots = np.abs(np.sum(np_of(out.vectors) * vecs, axis=-1))
        assert dots.min() > 1.0 - 1e-8, dots


@pytest.mark.parametrize("method", ["eei_krylov", "eei_krylov_si"])
def test_krylov_eigenvalues_program(method):
    a = _matrix("spd", 72, 2)
    lam = np.linalg.eigvalsh(a)
    eng = SolverEngine(SolverPlan(method=method, backend="torch"),
                       device="cpu")
    r_eng = r_engine.SolverEngine(r_engine.SolverPlan(method=method,
                                                      backend="jnp"))
    atol = 1e-9 * (lam[-1] - lam[0])
    ev = eng.eigenvalues(a, k=4)
    np.testing.assert_allclose(np_of(ev), lam[-4:], atol=atol)
    np.testing.assert_allclose(np_of(ev), np.asarray(
        r_eng.eigenvalues(jnp.asarray(a), k=4)), atol=atol)
    # k = 0: the whole band, whose width is the Lanczos m (here n).
    full = eng.eigenvalues(a)
    np.testing.assert_allclose(np_of(full), lam, atol=atol)


@pytest.mark.parametrize("method", ["eei_krylov", "eei_krylov_si"])
def test_krylov_smallest_window(method):
    a = _matrix("goe", 80, 9)
    lam = np.linalg.eigvalsh(a)
    out = SolverEngine(SolverPlan(method=method, backend="cuda"),
                       device="cpu").topk(a, 3, largest=False)
    np.testing.assert_allclose(np_of(out.eigenvalues), lam[:3],
                               atol=1e-9 * (lam[-1] - lam[0]))
    ref = r_engine.SolverEngine(r_engine.SolverPlan(
        method=method, backend="jnp")).topk(jnp.asarray(a), 3, largest=False)
    dots = np.abs(np.sum(np_of(out.vectors) * np.asarray(ref.vectors), -1))
    assert dots.min() > 1.0 - 1e-8


def test_krylov_clustered_spectrum_shift_invert():
    a = _matrix("clustered", 64, 13)
    lam = np.linalg.eigvalsh(a)
    out = SolverEngine(SolverPlan(method="eei_krylov_si", backend="cuda"),
                       device="cpu").topk(a, 3)
    np.testing.assert_allclose(np_of(out.eigenvalues), lam[-3:],
                               atol=1e-9 * (lam[-1] - lam[0]))


def test_krylov_solve_raises():
    eng = SolverEngine(SolverPlan(method="eei_krylov"), device="cpu")
    with pytest.raises(ValueError, match="no 'solve' chain"):
        eng.solve(_matrix("goe", 16, 0))


def test_krylov_m_override_runs_and_carries_across():
    """At m = 24 < n = 48 the band has not converged, so how close it comes
    depends on the start vector: ``repro``'s draw reaches 1e-6 of the span
    here (``tests/test_lanczos.py:249-256``), the port's 2.5e-6."""
    r_plan = r_engine.SolverPlan(method="eei_krylov", backend="jnp",
                                 krylov_m=24)
    plan = plan_from_reference(dataclasses.asdict(r_plan))
    assert plan.krylov_m == 24
    hash(plan)
    a = _matrix("goe", 48, 1)
    lam = np.linalg.eigvalsh(a)
    out = SolverEngine(plan, device="cpu").topk(a, 2)
    np.testing.assert_allclose(np_of(out.eigenvalues), lam[-2:],
                               atol=1e-5 * (lam[-1] - lam[0]))
    d, _, q = lanczos.krylov_reduce(t(a), 2, True, m=24)
    assert d.shape == (24,) and q.shape == (48, 24)


# ---------------------------------------------------------------------------
# Sessions opened on the new plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["eei_dense", "eei_krylov"])
def test_session_on_new_plans_matches_repro(method, x64):
    """The two sessions agree to 1e-8 of ||A||_F and their vectors to
    1 - 1e-6 after every update, and both meet the eigh oracle within
    ``tests/test_session.py``'s 5e-3 of ||A||_F (a warm update is a
    projection, not a full solve)."""
    rng = np.random.default_rng(8)
    n, k = 40, 3
    a = _matrix("goe", n, 8)
    r_plan = r_engine.SolverPlan(method=method, backend="pallas",
                                 precision="float64")
    eng = SolverEngine(plan_from_reference(dataclasses.asdict(r_plan)),
                       device="cpu")
    r_eng = r_engine.SolverEngine(r_plan)
    sess = eng.open_session(a, k)
    r_sess = r_eng.open_session(a, k)
    for step in range(4):
        u = rng.standard_normal(n) * (0.2 if step % 2 else 0.8)
        a = a + np.outer(u, u)
        got = eng.update(sess, Rank1Update(u, 1))
        ref = r_eng.update(r_sess, r_engine.Rank1Update(u, 1))
        lam = np.linalg.eigvalsh(a)[-k:]
        scale = np.linalg.norm(a)
        np.testing.assert_allclose(np_of(got.eigenvalues),
                                   np.asarray(ref.eigenvalues), rtol=0,
                                   atol=1e-8 * scale)
        for ev in (np_of(got.eigenvalues), np.asarray(ref.eigenvalues)):
            np.testing.assert_allclose(ev, lam, rtol=0, atol=5e-3 * scale)
        dots = np.abs(np.sum(np_of(got.vectors) * np.asarray(ref.vectors),
                             axis=-1))
        assert dots.min() >= 1 - 1e-6, dots
    assert sess.stats()["fast_updates"] == r_sess.stats()["fast_updates"] >= 1
    assert got.eigenvalues.dtype == torch.float64


def test_shift_invert_default_band_on_the_lane_matrix_matches_repro():
    """On the throughput lane's Krylov matrix (``benchmarks/throughput.py``
    633-637: n = 4096, k = 16, here in float64) shift-and-invert at its
    default band ``default_si_m = 128`` leaves ~2e-2 of the span in
    ``repro`` and in the port alike, above the lane's ``KRYLOV_TOL`` of
    5e-3: the Gershgorin shift sits ~25x the spectral radius away, so the
    inverted operator separates nothing.  The port's error is within 1.5x
    of ``repro``'s (their start vectors differ); ``chip_smoke.py`` runs the
    mode at the direct leg's m = 256."""
    n, k = 4096, 16
    raw = np.random.default_rng(n + k).standard_normal((n, n))
    a = (raw + raw.T) / 2
    lam = np.linalg.eigvalsh(a)
    span = lam[-1] - lam[0]
    got = SolverEngine(SolverPlan(method="eei_krylov_si"),
                       device="cpu").topk(a[None], k)
    ref = r_engine.SolverEngine(r_engine.SolverPlan(
        method="eei_krylov_si", backend="jnp")).topk(jnp.asarray(a)[None], k)
    err = np.abs(np_of(got.eigenvalues)[0] - lam[-k:]).max() / span
    r_err = np.abs(np.asarray(ref.eigenvalues)[0] - lam[-k:]).max() / span
    assert err > 5e-3 and r_err > 5e-3, (err, r_err)
    assert err <= 1.5 * r_err, (err, r_err)
