"""The port's serving runtime against repro's.

``repro_torch.engine.EeiServer`` (``device="cpu"``: the kernels' plain
versions) and ``repro.engine.EeiServer`` (``jnp``, as ``tests/test_server.py``
runs it) serve the same seeded numpy streams.  Both planners read one table
(``_TABLE_FIELDS``), so each bucket picks the same method in both packages.  Held
to ``repro``'s server-test tolerances (``tests/test_server.py:128-149``):
eigenvalues rtol/atol 1e-5, vectors up to sign within 5e-3.  Also the
server's own contracts on the port (bitwise the engine program, guard and
batch padding, the program cache, linger, close, backpressure, the fallback
chain), the chaos schedule of one seed in both packages, packed dispatch,
sessions, the launcher, and that nothing runs without a card by default.
Every wait carries a timeout.
"""

import jax

jax.config.update("jax_enable_x64", True)

import threading  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.engine as r_engine  # noqa: E402
from repro.engine import autotune as r_autotune  # noqa: E402
from repro.engine import server as r_server  # noqa: E402
from repro.runtime import ChaosConfig as RChaosConfig  # noqa: E402
from repro.runtime import ChaosMonkey as RChaosMonkey  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    DegradedResult,
    EeiServer,
    ProgramCache,
    QueueFull,
    ServerClosed,
    ShapeBucket,
    SolverPlan,
    autotune,
    fallback_chain,
    get_composition,
    topk_program,
)
from repro_torch.engine import server as server_mod  # noqa: E402
from repro_torch.engine.server import PackedBucket, make_eei_stream  # noqa: E402
from repro_torch.runtime import ChaosConfig, ChaosMonkey  # noqa: E402

PLAN = SolverPlan(method="eei_tridiag", backend="cuda")
R_PLAN = r_engine.SolverPlan(method="eei_tridiag", backend="jnp")
WAIT_S = 120

#: One table for both planners: eigh at n <= 8, dense minors to 16, the
#: tridiagonal chain above, windowed for k <= n / 8, no Krylov, packing to
#: 16 and the packed tridiagonal chain above rows of 32.
_TABLE_FIELDS = dict(eigh_crossover_n=8, dense_crossover_n=16,
                     windowed_k_frac=0.125, krylov_n_min=1 << 30,
                     pack_n_max=16, packed_eigh_n_max=32)

#: One cache per package across the module: built programs (repro's
#: compiled executables) are reused between tests.
R_CACHE = r_server.ProgramCache()
CACHE = ProgramCache()


@pytest.fixture(autouse=True)
def _one_table():
    """Both packages plan on ``_TABLE_FIELDS`` during each test."""
    autotune.set_table(autotune.CalibrationTable(**_TABLE_FIELDS))
    r_autotune.set_table(r_autotune.CalibrationTable(
        prod_diff_blocks=(64, 64, 64), sturm_blocks=(16, 128),
        **_TABLE_FIELDS))
    yield
    autotune.set_table(None)
    r_autotune.set_table(None)


def _sym(rng, n: int, dtype=np.float32) -> np.ndarray:
    a = rng.standard_normal((n, n)).astype(dtype)
    return (a + a.T) / 2


def _serve(server, stream, largest=True):
    futs = [server.submit(a, k, largest=largest) for a, k in stream]
    server.flush()
    return [f.result(timeout=WAIT_S) for f in futs]


def _assert_close_to_repro(got, ref, what=""):
    """``repro``'s server-test tolerances: eigenvalues rtol/atol 1e-5,
    vectors up to sign within 5e-3."""
    lam, vec = np.asarray(got.eigenvalues), np.asarray(got.vectors)
    lam_r, vec_r = np.asarray(ref.eigenvalues), np.asarray(ref.vectors)
    assert lam.shape == lam_r.shape and vec.shape == vec_r.shape, what
    np.testing.assert_allclose(lam, lam_r, rtol=1e-5, atol=1e-5,
                               err_msg=what)
    err = np.minimum(np.abs(vec - vec_r), np.abs(vec + vec_r)).max()
    assert err < 5e-3, (what, err)


def _assert_stream_conformant(server) -> None:
    """Every dispatched stack bitwise the port's ``topk_program`` on the
    recorded stack, sliced per request (``tests/test_server.py:64-81``)."""
    for rec in server.dispatch_log:
        ref, _ = topk_program(rec.plan, rec.bucket.k, rec.bucket.largest,
                              verify=True)(torch.as_tensor(rec.stack))
        lam, vec = ref.eigenvalues.numpy(), ref.vectors.numpy()
        for row, req in enumerate(rec.requests):
            res = req.future.result(timeout=WAIT_S)
            if req.largest:
                lam_e, vec_e = lam[row, -req.k:], vec[row, -req.k:, : req.n]
            else:
                lam_e, vec_e = lam[row, : req.k], vec[row, : req.k, : req.n]
            np.testing.assert_array_equal(res.eigenvalues, lam_e)
            np.testing.assert_array_equal(res.vectors, vec_e)


_COUNTERS = ("requests_completed", "requests_failed", "stacks_dispatched",
             "packed_stacks_dispatched", "program_compiles",
             "distinct_buckets", "grid_cells_total", "grid_cells_real",
             "pad_waste_frac", "pad_waste_by_bucket", "verify_failed",
             "requests_degraded", "fallbacks_by_plan")


def _counters(stats: dict) -> dict:
    return {key: stats[key] for key in _COUNTERS}


# ---------------------------------------------------------------------------
# The numerical contract
# ---------------------------------------------------------------------------


def test_full_stack_bitwise_equals_the_engine_program():
    """One full stack of mixed-k requests equals ``topk_program`` on the
    same stack, and ``repro``'s server on it within tolerance."""
    rng = np.random.default_rng(0)
    stream = list(zip([_sym(rng, 16) for _ in range(8)],
                      [4, 2, 1, 3, 4, 4, 2, 3]))
    server = EeiServer(PLAN, device="cpu", max_batch=8, cache=CACHE)
    results = _serve(server, stream)
    assert server.stats()["stacks_dispatched"] == 1
    ref, flags = topk_program(PLAN, 4, True, verify=True)(
        torch.as_tensor(np.stack([a for a, _ in stream])))
    assert bool(flags.ok.all())
    r_results = _serve(r_server.EeiServer(R_PLAN, max_batch=8,
                                          cache=R_CACHE), stream)
    for i, ((_, k), res, r_res) in enumerate(zip(stream, results,
                                                 r_results)):
        assert res.eigenvalues.shape == (k,) and res.vectors.shape == (k, 16)
        np.testing.assert_array_equal(res.eigenvalues,
                                      ref.eigenvalues[i, -k:].numpy())
        np.testing.assert_array_equal(res.vectors,
                                      ref.vectors[i, -k:].numpy())
        _assert_close_to_repro(res, r_res, f"request {i}")


def test_mixed_stream_buckets_plans_and_counters_match_repro():
    """A mixed stream, caller-driven, through both servers: the same bucket
    sequence, method and spectrum per bucket, the same counters, and every
    result within ``repro``'s tolerances."""
    stream = make_eei_stream(16, 16, 4, seed=7, mixed=True)
    r_stream = r_server.make_eei_stream(16, 16, 4, seed=7, mixed=True)
    assert all(np.array_equal(a, b) and k == j
               for (a, k), (b, j) in zip(stream, r_stream))
    server = EeiServer(device="cpu", max_batch=4, record_dispatches=True)
    r_srv = r_server.EeiServer(max_batch=4, record_dispatches=True)
    results = _serve(server, stream)
    r_results = _serve(r_srv, stream)
    got = [(tuple(rec.bucket), rec.plan.method, rec.plan.spectrum)
           for rec in server.dispatch_log]
    want = [(tuple(rec.bucket), rec.plan.method, rec.plan.spectrum)
            for rec in r_srv.dispatch_log]
    assert got == want
    assert {m for _, m, _ in got} == {"eigh", "eei_dense", "eei_tridiag"}
    assert {s for _, _, s in got} == {"full", "windowed"}
    assert _counters(server.stats()) == _counters(r_srv.stats())
    for i, (res, r_res) in enumerate(zip(results, r_results)):
        _assert_close_to_repro(res, r_res, f"request {i}")
    _assert_stream_conformant(server)


@pytest.mark.parametrize("largest", [True, False])
def test_guard_rows_never_leak(largest):
    """Unaligned n pads with guard diagonals and a partial stack with
    repeated rows; results carry only the request's own eigenpairs (the
    eigh oracle) and match ``repro``'s server."""
    rng = np.random.default_rng(2)
    stream = [(_sym(rng, n), 3) for n in (9, 13, 17, 21, 30, 9, 13)]
    server = EeiServer(PLAN, device="cpu", max_batch=4, cache=CACHE)
    results = _serve(server, stream, largest)
    r_results = _serve(r_server.EeiServer(R_PLAN, max_batch=4,
                                          cache=R_CACHE), stream, largest)
    assert server.stats()["requests_completed"] == len(stream)
    for (a, k), res, r_res in zip(stream, results, r_results):
        n = a.shape[0]
        assert res.eigenvalues.shape == (k,) and res.vectors.shape == (k, n)
        w = np.linalg.eigvalsh(a.astype(np.float64))
        np.testing.assert_allclose(res.eigenvalues, w[-k:] if largest
                                   else w[:k], rtol=1e-4, atol=1e-4)
        _assert_close_to_repro(res, r_res, f"n={n}")


# ---------------------------------------------------------------------------
# The program cache
# ---------------------------------------------------------------------------


def test_program_cache_counters_match_repro():
    cache, r_cache = ProgramCache(), r_server.ProgramCache()
    for bucket in (ShapeBucket(2, 16, 2, True), ShapeBucket(2, 16, 2, True),
                   ShapeBucket(2, 16, 2, False)):
        p = cache.get(bucket, PLAN, np.float32)
        r_cache.get(r_server.ShapeBucket(*bucket), R_PLAN, jnp.float32)
    assert p is topk_program(PLAN, 2, False, verify=False)
    assert (cache.hits, cache.misses, cache.compiles, len(cache)) == \
        (r_cache.hits, r_cache.misses, r_cache.compiles, len(r_cache)) == \
        (1, 2, 2, 2)
    assert cache.buckets() == [ShapeBucket(2, 16, 2, True),
                               ShapeBucket(2, 16, 2, False)]
    assert cache.get(ShapeBucket(2, 16, 2, True), PLAN, torch.float32) \
        is cache.get(ShapeBucket(2, 16, 2, True), PLAN, "float32")
    cache.reset_counters()
    assert (cache.hits, cache.misses, len(cache)) == (0, 0, 2)


def test_program_cache_concurrent_gets_build_once(monkeypatch):
    """Racing gets of one bucket build once (the others wait on the
    placeholder) and all return the same program; a failed build reaches
    every waiter and is retried by the next get."""
    cache = ProgramCache()
    bucket = ShapeBucket(2, 16, 2, True)
    builds, release = [], threading.Event()
    real = server_mod.engine_mod.topk_program

    def slow_build(*args):
        builds.append(args)
        release.wait(WAIT_S)
        if len(builds) == 1:
            raise RuntimeError("transient build failure")
        return real(*args)

    monkeypatch.setattr(server_mod.engine_mod, "topk_program", slow_build)
    results = [None] * 4
    barrier = threading.Barrier(4)

    def work(i):
        barrier.wait(WAIT_S)
        try:
            results[i] = cache.get(bucket, PLAN, np.float32)
        except RuntimeError as exc:
            results[i] = exc

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    # Release the build once every getter is inside get(): one owner and
    # three waiters on its placeholder.
    deadline = threading.Event()
    for _ in range(WAIT_S * 1000):
        with cache._lock:
            if cache.hits + cache.misses == 4:
                break
        deadline.wait(0.001)
    release.set()
    for t in threads:
        t.join(timeout=WAIT_S)
        assert not t.is_alive()
    assert len(builds) == 1
    assert all(isinstance(r, RuntimeError) for r in results)
    assert cache.hits + cache.misses == 4 and len(cache) == 0
    prog = cache.get(bucket, PLAN, np.float32)  # retried: a fresh miss
    assert prog is real(PLAN, 2, True, False) and len(builds) == 2
    assert (cache.misses, len(cache)) == (2, 1)


# ---------------------------------------------------------------------------
# The runtime: linger, close, backpressure, failures
# ---------------------------------------------------------------------------


def test_linger_dispatches_a_partial_stack_without_flush():
    rng = np.random.default_rng(20)
    with EeiServer(PLAN, device="cpu", max_batch=8, linger_ms=20,
                   cache=CACHE, record_dispatches=True) as server:
        futs = [server.submit(_sym(rng, 12), 2) for _ in range(3)]
        results = [f.result(timeout=WAIT_S) for f in futs]  # no flush
        assert all(r.eigenvalues.shape == (2,) for r in results)
        stats = server.stats()
        assert stats["requests_completed"] == 3
        assert stats["stacks_dispatched"] >= 1
        _assert_stream_conformant(server)
    assert server.close(timeout=WAIT_S) == []


@pytest.mark.parametrize("threaded", [False, True], ids=["caller", "linger"])
def test_close_drains_and_rejects_later_submits(threaded):
    """close() before the linger expires still serves the queued partial
    group; a submit after close gets a future holding ServerClosed."""
    rng = np.random.default_rng(23)
    kwargs = dict(linger_ms=60_000) if threaded else {}
    server = EeiServer(PLAN, device="cpu", max_batch=8, cache=CACHE,
                       **kwargs)
    futs = [server.submit(_sym(rng, 12), 2) for _ in range(3)]
    assert server.close(timeout=WAIT_S) == []
    for f in futs:
        assert f.done() and f.result(timeout=0).eigenvalues.shape == (2,)
    late = server.submit(_sym(rng, 8), 1)
    assert late.done()
    with pytest.raises(ServerClosed):
        late.result(timeout=0)
    stats = server.stats()
    assert (stats["requests_completed"], stats["requests_rejected"]) == (3, 1)
    assert server.close(timeout=WAIT_S) == []  # idempotent


def test_queue_full_under_the_except_policy():
    rng = np.random.default_rng(26)
    server = EeiServer(PLAN, device="cpu", max_batch=8, max_pending=2,
                       pending_policy="except", cache=CACHE)
    server.submit(_sym(rng, 8), 1)
    server.submit(_sym(rng, 8), 1)
    with pytest.raises(QueueFull):
        server.submit(_sym(rng, 8), 1)
    server.flush()
    fut = server.submit(_sym(rng, 8), 1)
    server.flush()
    assert fut.result(timeout=WAIT_S).eigenvalues.shape == (1,)


class _FailingFlags:
    """Verify flags whose copy to the host fails, as a device error does
    at the retire step's sync."""

    @property
    def ok(self):
        raise RuntimeError("synthetic device error at the copy")


@pytest.mark.parametrize("fault", ["build", "copy"])
@pytest.mark.parametrize("fallback", [True, False])
def test_failed_dispatch_degrades_or_fails_fast(fallback, fault,
                                                monkeypatch):
    """A persistent failure, at the build or at the retire step's copy to
    the host (which no chaos point reaches on the card), bisects the stack
    and resolves every isolated request through the fallback chain, on the
    server's device; with ``fallback=False`` the futures hold the error.
    Never stranded, and the server serves normally afterwards."""
    rng = np.random.default_rng(12)
    server = EeiServer(PLAN, device="cpu", max_batch=4, fallback=fallback)
    devices = []
    real_engine = server_mod.engine_mod.SolverEngine
    real_get = server.cache.get

    def engine_on(plan, device=None):
        devices.append(device)
        return real_engine(plan, device)

    def boom(*args, **kwargs):
        raise RuntimeError("synthetic build failure")

    def poisoned(*args, **kwargs):
        program = real_get(*args, **kwargs)
        return lambda *operands: (program(*operands)[0], _FailingFlags())

    monkeypatch.setattr(server.cache, "get",
                        boom if fault == "build" else poisoned)
    monkeypatch.setattr(server_mod.engine_mod, "SolverEngine", engine_on)
    futs = [server.submit(_sym(rng, 16), 2) for _ in range(4)]
    server.flush()
    assert all(f.done() for f in futs)
    stats = server.stats()
    if fallback:
        for f in futs:
            res = f.result(timeout=0)
            assert isinstance(res, DegradedResult) and res.degraded
            assert res.fallback == "eei_windowed"
            assert res.eigenvalues.shape == (2,)
            assert np.all(np.isfinite(res.vectors))
        assert stats["requests_degraded"] == 4 and stats["requests_failed"] == 0
        assert stats["stack_splits"] == 3  # 4 -> 2 + 2 -> 1 + 1 + 1 + 1
        assert stats["fallbacks_by_plan"] == {"eei_windowed": 4}
        assert devices == [torch.device("cpu")] * 4
    else:
        with pytest.raises(RuntimeError, match="synthetic"):
            futs[0].result(timeout=0)
        assert stats["requests_failed"] == 4 and devices == []
    monkeypatch.undo()
    ok = server.submit(_sym(rng, 16), 2)
    server.flush()
    assert not ok.result(timeout=WAIT_S).degraded
    assert server.close(timeout=WAIT_S) == []


def test_fallback_chain_names_repro_links_on_the_cuda_backend():
    """The chain's links, in ``repro``'s order, with the port's ``cuda``
    backend where ``repro`` names ``jnp`` (ROADMAP queue 3)."""
    got = [(name, p.method, p.spectrum, p.backend)
           for name, p in fallback_chain()]
    want = [(name, p.method, p.spectrum, p.backend)
            for name, p in r_engine.fallback_chain()]
    assert [g[:3] for g in got] == [w[:3] for w in want]
    assert [g[3] for g in got] == ["cuda"] * 4
    assert [w[3] for w in want] == ["jnp"] * 4
    for name in r_engine.available_compositions():
        comp, r_comp = get_composition(name), r_engine.get_composition(name)
        for kind in ("topk", "solve", "eigenvalues", "packed_topk", "update"):
            sigs = getattr(comp, kind)
            r_sigs = getattr(r_comp, kind)
            assert (None if sigs is None else [s.name for s in sigs]) == \
                (None if r_sigs is None else [s.name for s in r_sigs])
    with pytest.raises(KeyError):
        get_composition("no-such-composition")


def test_same_chaos_seed_injects_the_same_faults_as_repro():
    """Caller-driven, one chaos seed: both packages inject at the same
    points, take the same fallbacks, and fail no request."""
    stream = make_eei_stream(16, 16, 4, seed=3, mixed=True)
    cfg = dict(seed=5, rate=0.15, slow_s=0.0)
    server = EeiServer(PLAN, device="cpu", max_batch=4, cache=CACHE,
                       chaos=ChaosMonkey(ChaosConfig(**cfg)),
                       retry_jitter_seed=0, retry_backoff_s=1e-4)
    r_srv = r_server.EeiServer(R_PLAN, max_batch=4, cache=R_CACHE,
                               chaos=RChaosMonkey(RChaosConfig(**cfg)),
                               retry_jitter_seed=0, retry_backoff_s=1e-4)
    results = _serve(server, stream)
    r_results = _serve(r_srv, stream)
    stats, r_stats = server.stats(), r_srv.stats()
    assert stats["chaos_injected"] == r_stats["chaos_injected"]
    assert sum(stats["chaos_injected"].values()) >= 3
    for key in ("fallbacks_by_plan", "requests_degraded", "retries",
                "stack_splits", "verify_failed", "requests_completed"):
        assert stats[key] == r_stats[key], key
    assert server.retry_delays_s == r_srv.retry_delays_s
    assert stats["requests_failed"] == r_stats["requests_failed"] == 0
    for (a, k), res, r_res in zip(stream, results, r_results):
        assert np.all(np.isfinite(res.vectors))
        assert float(server_mod.verify_topk_host(
            a, res.eigenvalues, res.vectors).residual) <= 2e-2
        _assert_close_to_repro(res, r_res)


# ---------------------------------------------------------------------------
# Packed dispatch and sessions
# ---------------------------------------------------------------------------


def test_packed_stream_matches_repro():
    """``pack="always"``: the same packed buckets, segment layouts and
    counters as ``repro``'s server (float64, the packed tridiagonal chain
    with the segmented Sturm kernel at row width 64), results within
    tolerance."""
    rng = np.random.default_rng(61)
    stream = [(_sym(rng, n, np.float64), k)
              for n, k in [(8, 2), (12, 1), (16, 3), (5, 2), (24, 2),
                           (9, 4), (30, 1), (16, 2), (11, 3), (7, 1)]]
    server = EeiServer(device="cpu", max_batch=2, pack="always",
                       dtype=torch.float64, record_dispatches=True)
    r_srv = r_server.EeiServer(max_batch=2, pack="always",
                               dtype=jnp.float64, record_dispatches=True)
    results = _serve(server, stream)
    r_results = _serve(r_srv, stream)
    assert [tuple(r.bucket) for r in server.dispatch_log] == \
        [tuple(r.bucket) for r in r_srv.dispatch_log]
    assert all(isinstance(r.bucket, PackedBucket)
               for r in server.dispatch_log)
    for rec, r_rec in zip(server.dispatch_log, r_srv.dispatch_log):
        assert (rec.plan.method, rec.plan.spectrum) == \
            (r_rec.plan.method, r_rec.plan.spectrum) == \
            ("eei_tridiag", "windowed")
        np.testing.assert_array_equal(rec.seg_off, r_rec.seg_off)
        np.testing.assert_array_equal(rec.seg_len, r_rec.seg_len)
        assert rec.layout == r_rec.layout
        np.testing.assert_array_equal(rec.stack, r_rec.stack)
    assert _counters(server.stats()) == _counters(r_srv.stats())
    assert server.stats()["packed_requests_completed"] == len(stream)
    for i, (res, r_res) in enumerate(zip(results, r_results)):
        _assert_close_to_repro(res, r_res, f"request {i}")


@pytest.mark.parametrize("threaded", [False, True], ids=["caller", "linger"])
def test_session_through_the_server_matches_repro(threaded):
    n, k = 12, 2
    rng = np.random.default_rng(4)
    a = _sym(rng, n, np.float64)
    us = [0.3 * rng.standard_normal(n) for _ in range(4)]
    kwargs = dict(linger_ms=1.0) if threaded else {}
    out = {}
    for name, make in (
            ("port", lambda: EeiServer(PLAN, device="cpu", cache=CACHE,
                                       **kwargs)),
            ("repro", lambda: r_server.EeiServer(R_PLAN, cache=R_CACHE,
                                                 **kwargs))):
        with make() as srv:
            sid = srv.open_session(a, k)
            futs = [srv.submit_update(sid, u) for u in us]
            out[name] = ([f.result(timeout=WAIT_S) for f in futs],
                         srv.session_result(sid), srv.session_stats(sid),
                         srv.stats())
            srv.close_session(sid)
            with pytest.raises(KeyError):
                srv.submit_update(sid, us[0])
    (res, snap, sstats, stats), (r_res, r_snap, r_sstats, r_stats) = \
        out["port"], out["repro"]
    for i, (got, ref) in enumerate(zip(res + [snap], r_res + [r_snap])):
        _assert_close_to_repro(got, ref, f"update {i}")
    for key in ("updates_total", "fast_updates", "full_resolves"):
        assert sstats[key] == r_sstats[key], key
    for key in ("session_updates", "session_fast_updates",
                "session_full_resolves", "session_degraded",
                "sessions_opened", "requests_failed"):
        assert stats[key] == r_stats[key], key
    assert stats["session_updates"] == 4


def test_session_degrades_to_the_host_rung():
    rng = np.random.default_rng(5)
    n, k = 10, 2
    with EeiServer(PLAN, device="cpu", cache=CACHE) as server:
        a = _sym(rng, n, np.float64)
        sid = server.open_session(a, k)

        class _Broken:
            def update(self, *args, **kwargs):
                raise RuntimeError("backend down")

        rec = server._sessions[sid]
        engine, rec.engine = rec.engine, _Broken()
        u = rng.standard_normal(n)
        res = server.submit_update(sid, u).result(timeout=WAIT_S)
        assert isinstance(res, DegradedResult)
        assert res.fallback == "host_reseed"
        w = np.linalg.eigvalsh(a + np.outer(u, u))
        np.testing.assert_allclose(res.eigenvalues, w[-k:], rtol=1e-5,
                                   atol=1e-5)
        rec.engine = engine
        with pytest.raises(ValueError):  # malformed: fails, never degrades
            server.submit_update(sid, np.ones(n + 3)).result(timeout=WAIT_S)
        stats = server.stats()
        assert (stats["session_degraded"], stats["requests_failed"]) == (1, 1)


# ---------------------------------------------------------------------------
# No card: the server and the launcher refuse to run by default
# ---------------------------------------------------------------------------


def test_server_and_launcher_need_a_card_by_default(monkeypatch):
    from repro_torch.launch import serve as serve_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EeiServer()
    for extra in ([], ["--sync"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve_cli.main(["--eei", "--requests", "0", "--n", "12",
                            "--k", "2", *extra])


# ---------------------------------------------------------------------------
# The launcher (tests/test_server.py:1418-1435 on the port)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [[], ["--sync"], ["--linger-ms", "1"],
                                   ["--pack", "always"]],
                         ids=["server", "sync", "linger", "packed"])
def test_serve_cli_zero_request_stream(extra):
    from repro_torch.launch import serve as serve_cli

    assert serve_cli.main(["--eei", "--requests", "0", "--n", "12",
                           "--k", "2", "--device", "cpu", *extra]) is None


def test_serve_cli_packed_stream_smoke():
    from repro_torch.launch import serve as serve_cli

    out = serve_cli.main(["--eei", "--requests", "6", "--n", "16", "--k",
                          "2", "--mixed", "--pack", "always", "--device",
                          "cpu"])
    assert out is not None and np.all(np.isfinite(out.eigenvalues))


@pytest.mark.parametrize("args, said", [
    (["--eei", "--sharded"], "needs a data axis of at least 2"),
    (["--eei", "--mesh", "2x"], "bad mesh spec"),
    (["--eei", "--mesh", "2x1x1"], "the EEI server takes DxM"),
    ([], "--eei is required")])
def test_serve_cli_refuses_what_is_not_ported(args, said, capsys):
    from repro_torch.launch import serve as serve_cli

    with pytest.raises(SystemExit) as exc:
        serve_cli.main(["--requests", "0", "--device", "cpu", *args])
    assert exc.value.code == 2
    assert said in capsys.readouterr().err


@pytest.mark.parametrize("args, requests", [
    (["--replicas", "3", "--device", "cpu", "--mixed", "--requests", "16"],
     16),
    (["--replicas", "2", "--replica-mode", "subprocess", "--device", "cpu",
      "--requests", "8"], 8),
    (["--replicas", "3", "--chaos-replicas", "--chaos", "7", "--device",
      "cpu", "--requests", "16"], 16)],
    ids=["fleet", "subprocess", "replica-chaos"])
def test_serve_cli_fleet_serves(args, requests, caplog):
    """``--replicas`` serves through ``EeiFleet`` (the replica fleet is
    ported): every request resolves, none fails, nothing is left at close."""
    from repro_torch.launch import serve as serve_cli

    with caplog.at_level("INFO", logger="repro_torch.serve"):
        out = serve_cli.main(["--eei", "--n", "16", "--k", "3", *args])
    assert out is not None and np.all(np.isfinite(out.eigenvalues))
    said = [r.getMessage() for r in caplog.records
            if r.name == "repro_torch.serve"]
    assert any(m.startswith(f"fleet served {requests} requests")
               and m.endswith("| 0 unresolved at close") for m in said), said
    if "--chaos-replicas" in args:
        assert any(m.startswith("chaos injected:")
                   and m.endswith("requests_failed=0") for m in said), said
