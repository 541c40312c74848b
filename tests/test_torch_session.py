"""The port's streaming sessions against repro's, and the drift monitor.

The same seeded rank-1 streams go through ``repro``'s session (pallas
backend in interpret mode) and through the port's (``cuda`` backend on the
CPU, where the segmented Sturm kernel's wrapper takes its plain version).
In float64 the two windows agree to 1e-8 of ``||A||_F`` after every step,
their vectors to ``|<v, v'>| >= 1 - 1e-6`` (rows up to sign: QR and the
Householder reduce may flip a row's sign), and their monitors take the same
decisions.  In float32 both are held to the eigh oracle of
``tests/test_session.py``.  Each of the monitor's three triggers gets a test.
"""

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from test_torch_parity import np_of  # noqa: E402

import repro.engine as r_engine  # noqa: E402
from repro_torch import (  # noqa: E402
    Rank1Update,
    SessionConfig,
    SolverEngine,
    SolverPlan,
    verify_topk_host,
)
from repro_torch.engine import engine as engine_mod  # noqa: E402
from repro_torch.engine import registry  # noqa: E402
from repro_torch.engine import session as session_mod  # noqa: E402
from repro_torch.kernels.sturm import kernel as st_kernel  # noqa: E402


def _plan(precision=None):
    return SolverPlan(method="eei_tridiag", backend="cuda",
                      precision=precision)


def _engine(precision=None):
    return SolverEngine(_plan(precision), device="cpu")


def _sym(rng, n):
    a = rng.standard_normal((n, n))
    return (a + a.T) / 2


def _assert_conformant(a, res, k, largest=True, rtol=5e-3):
    """tests/test_session.py:65-79: eigenvalues within ``rtol`` of the
    spectral scale of the float64 eigh oracle, and the residual check."""
    lam = np_of(res.eigenvalues).astype(np.float64)
    vec = np_of(res.vectors).astype(np.float64)
    ref = np.linalg.eigvalsh(np.asarray(a, np.float64))
    ref = ref[-k:] if largest else ref[:k]
    scale = max(np.linalg.norm(a), 1e-30)
    np.testing.assert_allclose(lam, ref, atol=rtol * scale, rtol=0)
    flags = verify_topk_host(np.asarray(a), lam, vec)
    assert bool(np.all(flags.ok)), f"window failed verification: {flags}"


def _mixed_stream(seed=0):
    """The stream of tests/test_session.py:86-107 (n = 16, k = 3)."""
    rng = np.random.default_rng(seed)
    a = _sym(rng, 16)
    steps = []
    for step in range(6):
        u = rng.standard_normal(16) * (0.3 if step % 2 else 1.5)
        steps.append((u, -1 if step == 4 else 1))
    return a, steps, 3, SessionConfig()


def _swap_stream(seed=0):
    """tests/test_session.py:110-133: an update along the eigenvector of the
    smallest eigenvalue lifts it above the window (n = 12, k = 2)."""
    rng = np.random.default_rng(seed)
    a = _sym(rng, 12)
    lam, v = np.linalg.eigh(a)
    u = np.sqrt(lam[-1] - lam[0] + 5.0) * v[:, 0]
    return a, [(u, 1)], 2, SessionConfig(buffer=2, drift_bound=100.0)


def _counts(stats):
    return {key: stats[key] for key in (
        "updates_total", "fast_updates", "full_resolves", "resolves_by_cause")}


def _run_both(stream, precision):
    a, steps, k, cfg = stream
    r_plan = r_engine.SolverPlan(method="eei_tridiag", backend="pallas",
                                 precision=precision)
    r_eng = r_engine.SolverEngine(r_plan)
    eng = _engine(precision)
    r_sess = r_eng.open_session(a, k, config=cfg)
    sess = eng.open_session(a, k, config=cfg)
    yield a, sess.result(), r_sess.result(), sess, r_sess
    for u, sign in steps:
        a = a + sign * np.outer(u, u)
        got = eng.update(sess, Rank1Update(u, sign))
        ref = r_eng.update(r_sess, r_engine.Rank1Update(u, sign))
        yield a, got, ref, sess, r_sess


STREAMS = {"mixed": _mixed_stream, "swap": _swap_stream}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_float64_session_matches_repro(x64, stream):
    k = STREAMS[stream]()[2]
    for a, got, ref, sess, r_sess in _run_both(STREAMS[stream](), "float64"):
        assert got.eigenvalues.dtype == torch.float64
        scale = np.linalg.norm(a)
        np.testing.assert_allclose(np_of(got.eigenvalues),
                                   np.asarray(ref.eigenvalues),
                                   rtol=0, atol=1e-8 * scale)
        dots = np.abs(np.sum(np_of(got.vectors) * np.asarray(ref.vectors),
                             axis=-1))
        assert dots.min() >= 1 - 1e-6, dots
        assert _counts(sess.stats()) == _counts(r_sess.stats())
        np.testing.assert_allclose(sess.stats()["drift"],
                                   r_sess.stats()["drift"], rtol=1e-12)
        _assert_conformant(a, got, k)
    assert sess.stats()["updates_total"] == len(STREAMS[stream]()[1])
    if stream == "mixed":
        assert sess.stats()["fast_updates"] >= 1


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_float32_session_is_as_conformant_as_repro(stream):
    """No precision in the plan: both packages run the session in float32."""
    _, _, k, _ = STREAMS[stream]()
    for a, got, ref, _, _ in _run_both(STREAMS[stream](), None):
        assert got.eigenvalues.dtype == torch.float32
        _assert_conformant(a, got, k)
        _assert_conformant(a, ref, k)


def test_update_runs_one_segmented_launch_per_fast_update_on_card_only():
    """On the CPU the wrapper takes its plain version and counts nothing."""
    a, steps, k, cfg = _mixed_stream(3)
    eng = _engine("float64")
    sess = eng.open_session(a, k, config=cfg)
    before = st_kernel.sturm_segmented.launches
    for u, sign in steps:
        eng.update(sess, Rank1Update(u, sign))
    assert sess.stats()["fast_updates"] >= 1
    assert st_kernel.sturm_segmented.launches == before


# -- the drift monitor's three triggers ---------------------------------------


def test_drift_trigger_matches_repro(x64):
    """Updates past the drift bound each force a full re-solve, in both
    packages alike (tests/test_session.py:171-187)."""
    rng = np.random.default_rng(0)
    a = _sym(rng, 12)
    us = [rng.standard_normal(12) for _ in range(3)]
    cfg = SessionConfig(drift_bound=1e-9)
    stream = (a, [(u, 1) for u in us], 2, cfg)
    for a_t, got, _, sess, r_sess in _run_both(stream, "float64"):
        _assert_conformant(a_t, got, 2)
    assert _counts(sess.stats()) == _counts(r_sess.stats())
    assert sess.stats()["fast_updates"] == 0
    assert sess.stats()["resolves_by_cause"] == {"drift": 3}


def test_cadence_trigger_matches_repro(x64):
    """``max_updates`` fast updates force a re-solve even with drift and
    verify green (tests/test_session.py:210-225)."""
    rng = np.random.default_rng(0)
    a = _sym(rng, 12) * 100.0
    us = [rng.standard_normal(12) * 1e-3 for _ in range(6)]
    cfg = SessionConfig(drift_bound=1e9, max_updates=2)
    stream = (a, [(u, 1) for u in us], 2, cfg)
    for a_t, got, _, sess, r_sess in _run_both(stream, "float64"):
        _assert_conformant(a_t, got, 2)
    assert _counts(sess.stats()) == _counts(r_sess.stats())
    assert sess.stats()["resolves_by_cause"] == {"cadence": 2}
    assert sess.stats()["fast_updates"] == 4


def _broken_bracketed(monkeypatch):
    """Make the cuda backend's bracketed bisection answer 1.0 too high, so
    that every fast update fails its verify stage."""
    factory = registry._REGISTRY["cuda"]

    def broken(plan):
        lib = factory(plan)
        good = lib.tridiag_eigenvalues_bracketed

        def shifted(d, e, lo, hi, k, largest):
            return good(d, e, lo, hi, k, largest) + 1.0

        return registry.StageLibrary(
            "cuda", {**lib._stages, "tridiag_eigenvalues_bracketed": shifted})

    monkeypatch.setitem(registry._REGISTRY, "cuda", broken)
    engine_mod.program.cache_clear()


def test_verify_trigger_resolves_on_the_engine(monkeypatch):
    rng = np.random.default_rng(1)
    a = _sym(rng, 12)
    eng = _engine("float64")
    sess = eng.open_session(a, 2)
    reseeds = []
    monkeypatch.setattr(session_mod, "host_reseed",
                        lambda *args, **kw: reseeds.append(args))
    _broken_bracketed(monkeypatch)
    try:
        for _ in range(2):
            u = rng.standard_normal(12) * 0.1
            a = a + np.outer(u, u)
            _assert_conformant(a, eng.update(sess, Rank1Update(u, 1)), 2)
    finally:
        engine_mod.program.cache_clear()
    assert sess.stats()["resolves_by_cause"] == {"verify": 2}
    assert sess.stats()["fast_updates"] == 0
    assert not reseeds  # the engine's own re-solve passed verify


def test_verify_off_keeps_the_broken_fast_answer(monkeypatch):
    """``verify=False`` skips the residual leg: the fault shows."""
    rng = np.random.default_rng(1)
    a = _sym(rng, 12)
    eng = _engine("float64")
    sess = eng.open_session(a, 2, config=SessionConfig(verify=False))
    _broken_bracketed(monkeypatch)
    try:
        u = rng.standard_normal(12) * 0.1
        res = eng.update(sess, Rank1Update(u, 1))
    finally:
        engine_mod.program.cache_clear()
    assert sess.stats()["fast_updates"] == 1
    with pytest.raises(AssertionError):
        _assert_conformant(a + np.outer(u, u), res, 2)


def test_host_reseed_is_the_last_rung(monkeypatch):
    """A re-solve that fails verify escalates to float64 eigh on the host."""
    rng = np.random.default_rng(4)
    a = _sym(rng, 10)
    eng = _engine("float32")
    sess = eng.open_session(a, 2, config=SessionConfig(drift_bound=1e-9))
    good_topk = SolverEngine.topk

    def garbage_topk(self, a_in, k, largest=True):
        res = good_topk(self, a_in, k, largest)
        return type(res)(res.eigenvalues + 10.0, res.vectors)

    monkeypatch.setattr(SolverEngine, "topk", garbage_topk)
    u = rng.standard_normal(10)
    a = a + np.outer(u, u)
    res = eng.update(sess, Rank1Update(u, 1))
    _assert_conformant(a, res, 2)
    assert sess.stats()["resolves_by_cause"] == {"drift": 1}
    assert res.eigenvalues.dtype == torch.float32


# -- the request surface -------------------------------------------------------


def test_session_dtype_follows_the_plan():
    rng = np.random.default_rng(0)
    a = _sym(rng, 8)
    assert _engine().open_session(a, 2).dtype == torch.float32
    assert _engine("float64").open_session(a, 2).dtype == torch.float64


def test_update_request_forms_and_rejections():
    rng = np.random.default_rng(5)
    n = 8
    a = _sym(rng, n)
    eng = _engine("float64")
    sess = eng.open_session(a, 2)
    with pytest.raises(ValueError, match="shape"):
        eng.update(sess, Rank1Update(np.ones(n + 1)))
    with pytest.raises(ValueError, match="finite"):
        eng.update(sess, Rank1Update(np.full(n, np.nan)))
    with pytest.raises(ValueError, match="sign"):
        eng.update(sess, Rank1Update(np.ones(n), 2))
    before = sess.stats()["drift"]
    eng.update(sess, Rank1Update(np.zeros(n)))
    assert sess.stats()["drift"] == before
    us = [rng.standard_normal(n) for _ in range(3)]
    signs = [1, -1, 1]
    for u, s in zip(us, signs):
        a = a + s * np.outer(u, u)
    # A list is r rank-1 updates in turn; a tuple is (u, sign); an array is u.
    eng.update(sess, [Rank1Update(u, s) for u, s in zip(us[:2], signs[:2])])
    res = eng.update(sess, (us[2], 1))
    assert sess.stats()["updates_total"] == 4
    _assert_conformant(a, res, 2)
    w = rng.standard_normal(n)
    _assert_conformant(a + np.outer(w, w), eng.update(sess, w), 2)
    with pytest.raises(ValueError, match="k="):
        eng.open_session(a, n + 1)
    with pytest.raises(ValueError):
        SessionConfig(drift_bound=0.0)


def test_update_program_validates_and_always_verifies():
    plan = _plan("float64")
    for comp in ("eigh", "eei_tridiag", "eei_tridiag_windowed"):
        registry._COMPOSITIONS[comp].validate()
        assert registry._COMPOSITIONS[comp].update is not None
    prog = engine_mod.update_program(plan, 2, True, 6, 4)
    assert [sig.role for sig, _ in prog.stages][-1] == "verify"
    with pytest.raises(ValueError, match="always verify"):
        engine_mod.program(plan, engine_mod.ProgramSpec("update", 2))


def test_float32_spike_resolve_falls_to_the_host_in_both_packages(
        monkeypatch):
    """A large update leaves a dominant eigenvalue, and at n = 64 the
    float32 EEI re-solve of the top window misses the verify bound in both
    packages alike (residual ~2.4e-3 of ||A||_F): each session then takes
    the host rung, float64 eigh, and keeps a conformant window."""
    from repro.engine import session as r_session_mod

    n, k = 64, 4
    rng = np.random.default_rng(0)
    a = _sym(rng, n)
    u = rng.standard_normal(n) * np.sqrt(3.0 * np.linalg.norm(a) / n)
    rungs = {"port": 0, "repro": 0}

    def counting(mod, key):
        real = mod.host_reseed

        def counted(*args, **kwargs):
            rungs[key] += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(mod, "host_reseed", counted)

    counting(session_mod, "port")
    counting(r_session_mod, "repro")
    cfg = SessionConfig(drift_bound=0.5)
    r_eng = r_engine.SolverEngine(r_engine.SolverPlan(
        method="eei_tridiag", backend="pallas", precision="float32"))
    eng = _engine("float32")
    sess = eng.open_session(a, k, config=cfg)
    r_sess = r_eng.open_session(a, k, config=cfg)
    res = eng.update(sess, Rank1Update(u, 1))
    r_eng.update(r_sess, r_engine.Rank1Update(u, 1))
    assert rungs == {"port": 1, "repro": 1}
    assert _counts(sess.stats()) == _counts(r_sess.stats())
    assert sess.stats()["resolves_by_cause"] == {"drift": 1}
    a_new = a + np.outer(u, u)
    _assert_conformant(a_new, res, k)
    engine_res = eng.topk(a_new, sess.m_keep)
    flags = verify_topk_host(a_new, np_of(engine_res.eigenvalues),
                             np_of(engine_res.vectors))
    assert not bool(flags.ok) and 2e-3 < float(flags.residual) < 5e-3


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_float32_resolve_of_the_chip_smoke_matrix_misses_verify_in_both_packages(
        capsys):
    """chip_smoke.py lets its float32 session take the host rung for the
    re-solve after its first large update, and only where the card's own
    re-solve of that matrix fails verify.  This rebuilds that n = 600
    matrix from the script's seed and stream and shows that ``repro``'s
    float32 re-solve (eei_tridiag, pallas in interpret mode) misses the
    bound there too, with the same residual as the port's (on the CPU)."""
    smoke = _chip_smoke()
    rng = np.random.default_rng(smoke.SEED)
    a = rng.standard_normal((smoke.B, smoke.N, smoke.N))
    a = (a + np.swapaxes(a, 1, 2))[0] / 2
    n, fro = smoke.N, float(np.linalg.norm(a))
    rng = np.random.default_rng(smoke.SEED + 4)
    for scale in ([0.01] * (smoke.SESSION_WARMUP + smoke.SESSION_STREAM)
                  + [0.6]):
        u = rng.standard_normal(n) * np.sqrt(scale * fro / n)
        a = a + np.outer(u, u)
    a32 = a.astype(np.float32)
    m_keep = smoke.K + SessionConfig().buffer

    res = _engine("float32").topk(torch.as_tensor(a32), m_keep)
    port = verify_topk_host(a32, np_of(res.eigenvalues), np_of(res.vectors))
    r_res = r_engine.SolverEngine(r_engine.SolverPlan(
        method="eei_tridiag", backend="pallas",
        precision="float32")).topk(a32, m_keep)
    ref = verify_topk_host(a32, np.asarray(r_res.eigenvalues),
                           np.asarray(r_res.vectors))
    with capsys.disabled():
        print(f"\nfloat32 top-{m_keep} of chip_smoke.py's matrix after its "
              f"first large update: residual {float(port.residual):.6e} "
              f"(port), {float(ref.residual):.6e} (repro) of ||A||_F")
    assert not bool(np.all(ref.ok)) and not bool(np.all(port.ok))
    assert float(ref.residual) > 2e-3
    np.testing.assert_allclose(float(port.residual), float(ref.residual),
                               rtol=1e-2)
