"""The port's replica fleet against repro's.

``repro_torch.engine.EeiFleet`` (replicas on ``device="cpu"``: the kernels'
plain versions) is held against ``repro.engine.EeiFleet`` on the same
seeded numpy inputs: the rendezvous hash, the restart schedule, the
straggler watchdog, the server's replica probes, and one stream through
both packages' 3-replica fleets with both planners on one table (as
``tests/test_torch_server.py`` sets them).  Results are held to
``tests/test_fleet.py``'s tolerance (5e-3 of ``eigvalsh``, ``:165-183``).
Then a twin of each of ``tests/test_fleet.py``'s contract tests runs on the
port (its two ``slow`` tests stay ``slow``), one subprocess fleet with a
SIGKILL runs on the CPU under a time limit of its own, and a fleet with no
``device`` refuses to run without a card.  Every wait carries a timeout.
"""

import itertools
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

import repro.engine as r_engine
from hypothesis_compat import given, settings, st
from repro.engine import autotune as r_autotune
from repro.engine import server as r_server
from repro.runtime import RestartPolicy as RRestartPolicy
from repro.runtime import StragglerWatchdog as RStragglerWatchdog
from repro.runtime import route_key as r_route_key
from repro_torch.engine import (
    EeiFleet,
    EeiServer,
    FleetClosed,
    ProgramCache,
    SolverPlan,
    autotune,
    verify_topk_host,
)
from repro_torch.engine.fleet import HEALTHY, SLOW
from repro_torch.engine.server import make_eei_stream
from repro_torch.runtime import (
    ChaosConfig,
    ChaosMonkey,
    RestartPolicy,
    StragglerWatchdog,
    route_key,
)
from repro_torch.runtime.fault_tolerance import decorrelated_jitter

PLAN = SolverPlan(method="eei_tridiag", backend="cuda")
R_PLAN = r_engine.SolverPlan(method="eei_tridiag", backend="jnp")
WAIT_S = 120

#: One cache across the module (as in tests/test_fleet.py): every
#: in-process fleet shares it, and restarted replicas come back warm.
SHARED_CACHE = ProgramCache()

#: The planners' shared table, as in tests/test_torch_server.py.
_TABLE_FIELDS = dict(eigh_crossover_n=8, dense_crossover_n=16,
                     windowed_k_frac=0.125, krylov_n_min=1 << 30,
                     pack_n_max=16, packed_eigh_n_max=32)


def _sym(rng, n: int) -> np.ndarray:
    a = rng.standard_normal((n, n)).astype(np.float32)
    return (a + a.T) / 2


def _fleet(n_replicas: int = 3, **kwargs) -> EeiFleet:
    # A fixed plan, so warm-up traffic and the shared cache hit the same
    # program keys across tests; the plain versions on the CPU.
    kwargs.setdefault("server_kwargs", dict(plan=PLAN, device="cpu"))
    kwargs.setdefault("cache", SHARED_CACHE)
    kwargs.setdefault("probe_interval_s", 0.01)
    return EeiFleet(n_replicas, **kwargs)


def _warm(n: int = 8, k: int = 2, largest: bool = True) -> None:
    """Build the ``(b=1, n, k, largest)`` bucket into SHARED_CACHE before
    tests with tight deadlines."""
    rng = np.random.default_rng(99)
    with EeiServer(PLAN, device="cpu", max_batch=1,
                   cache=SHARED_CACHE) as s:
        fut = s.submit(_sym(rng, n), k, largest=largest)
        s.flush()
        fut.result(timeout=WAIT_S)


def _assert_fleet_safe(reqs, stats) -> None:
    """``reqs`` is ``[(a, k, future), ...]``: every caller future resolved
    exactly once with a finite, non-garbage result, and the counters
    account for the stream (``tests/test_fleet.py:71-91``)."""
    for a, k, fut in reqs:
        assert fut.done(), "a submitted future never resolved"
        res = fut.result(timeout=0)
        lam, vec = np.asarray(res.eigenvalues), np.asarray(res.vectors)
        assert lam.shape == (k,) and vec.shape == (k, a.shape[0])
        assert np.all(np.isfinite(lam)) and np.all(np.isfinite(vec))
        flags = verify_topk_host(a, lam, vec)
        assert float(flags.residual) <= 2e-2, (
            f"garbage reached a caller: residual={float(flags.residual)}")
    assert stats["requests_failed"] == 0
    assert stats["requests_completed"] == len(reqs)
    assert stats["requests_unresolved"] == 0


def _wait_for(predicate, timeout_s: float, what: str) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.01)
    pytest.fail(f"timed out after {timeout_s}s waiting for {what}")


def _served_keys(servers) -> dict:
    """``{(n, largest): rid}`` from each replica server's dispatch log;
    fails if a key was served by two replicas."""
    owner = {}
    for rid, server in servers.items():
        for rec in server.dispatch_log:
            for req in rec.requests:
                key = (req.n, req.largest)
                assert owner.setdefault(key, rid) == rid, key
    return owner


# ---------------------------------------------------------------------------
# The building blocks against repro's
# ---------------------------------------------------------------------------


def test_route_key_places_like_repro():
    """The same owner as ``repro`` for every key ``(n, largest)``, n = 8 to
    512 in steps of 8, over every candidate subset of {0..4}, salts 0-3."""
    keys = [(n, largest) for n in range(8, 513, 8)
            for largest in (True, False)]
    subsets = [list(c) for r in range(1, 6)
               for c in itertools.combinations(range(5), r)]
    for salt in range(4):
        for cands in subsets:
            got = [route_key(key, cands, salt) for key in keys]
            assert got == [r_route_key(key, cands, salt) for key in keys], \
                (salt, cands)
    with pytest.raises(ValueError):
        route_key((8, True), [])


@pytest.mark.parametrize("seed", range(4))
def test_restart_policy_gives_repros_delays(seed):
    pol, r_pol = RestartPolicy(seed=seed), RRestartPolicy(seed=seed)
    got, want = [], []
    while not pol.give_up:
        got.append(pol.next_delay())
        want.append(r_pol.next_delay())
    assert r_pol.give_up and got == want and len(got) == 5
    pol.reset()
    r_pol.reset()
    assert pol.next_delay() == r_pol.next_delay()


def test_straggler_watchdog_flags_like_repro():
    """A seeded latency sequence with spikes: the same flags, events,
    classifications and medians as ``repro``'s watchdog, at the fleet's
    settings and at the defaults."""
    rng = np.random.default_rng(5)
    dts = np.abs(rng.normal(0.02, 0.004, 200))
    dts[rng.integers(0, 200, 20)] *= rng.uniform(2.0, 6.0, 20)
    for kwargs in (dict(threshold=3.0, min_samples=8), {}):
        dog, r_dog = StragglerWatchdog(**kwargs), \
            RStragglerWatchdog(**kwargs)
        got = [(dog.observe(i, dt), dog.classify(2 * dt), dog.median)
               for i, dt in enumerate(dts)]
        want = [(r_dog.observe(i, dt), r_dog.classify(2 * dt), r_dog.median)
                for i, dt in enumerate(dts)]
        assert got == want
        assert dog.events == r_dog.events > 0
        dog.reset()
        assert dog.samples == 0 and dog.classify(1e9) == "healthy"
    dog = StragglerWatchdog(deadline_s=0.5)
    with pytest.raises(RuntimeError, match="deadline"):
        dog.observe(0, 1.0)


def test_server_probes_match_repro():
    """The five replica probes on the same caller-driven state in both
    packages (ages aside): idle; one full stack in flight and two requests
    queued; closed."""
    rng = np.random.default_rng(3)
    stream = [(_sym(rng, 8), 2) for _ in range(4)] + \
        [(_sym(rng, 12), 3) for _ in range(2)]
    server = EeiServer(PLAN, device="cpu", max_batch=4, cache=SHARED_CACHE)
    r_srv = r_server.EeiServer(R_PLAN, max_batch=4)

    def probes(s):
        pending = [{k: v for k, v in m.items() if k != "age_s"}
                   for m in s.pending_manifest()]
        inflight = [{k: v for k, v in m.items() if k != "oldest_age_s"}
                    for m in s.inflight_manifest()]
        return (s.alive(), len(s.unresolved_futures()),
                s.oldest_unresolved_age_s() is not None, pending, inflight)

    assert probes(server) == probes(r_srv) == (True, 0, False, [], [])
    futs = [server.submit(a, k) for a, k in stream]
    r_futs = [r_srv.submit(a, k) for a, k in stream]
    got = probes(server)
    assert got == probes(r_srv)
    assert got == (True, 6, True, [{"n": 12, "k": 3, "largest": True}] * 2,
                   [{"bucket": "b4n8k2L", "rows": 4}])
    assert server.unresolved_futures() == futs  # submit order
    assert [f.done() for f in r_srv.unresolved_futures()] == [False] * 6
    assert server.oldest_unresolved_age_s(
        now=time.monotonic() + 10.0) >= 10.0
    assert all(m["age_s"] >= 0 for m in server.pending_manifest())
    server.close()
    r_srv.close()
    assert probes(server) == probes(r_srv) == (False, 0, False, [], [])
    assert all(f.done() for f in futs + r_futs)
    threaded = EeiServer(PLAN, device="cpu", linger_ms=1.0,
                         cache=SHARED_CACHE)
    assert threaded.alive()
    threaded.close(timeout=WAIT_S)
    assert not threaded.alive()


def test_seeded_stream_through_both_fleets_matches_repro():
    """One mixed stream through a 3-replica fleet of each package, both
    planners on one table: the same key -> replica placement (the
    rendezvous owner), results within 5e-3 of ``eigvalsh`` and of
    ``repro``'s, and the same ``stats()`` keys."""
    autotune.set_table(autotune.CalibrationTable(**_TABLE_FIELDS))
    r_autotune.set_table(r_autotune.CalibrationTable(
        prod_diff_blocks=(64, 64, 64), sturm_blocks=(16, 128),
        **_TABLE_FIELDS))
    try:
        stream = make_eei_stream(18, 16, 4, seed=11, mixed=True)
        r_stream = r_server.make_eei_stream(18, 16, 4, seed=11, mixed=True)
        assert all(np.array_equal(a, b) and k == j
                   for (a, k), (b, j) in zip(stream, r_stream))
        # A long linger: each key's requests ride one stack (fewer of
        # repro's compiles); the fleet, not the linger, is under test.  No
        # replica is ever classified slow, so no hedge puts a key's second
        # attempt on another replica: the placement is the rendezvous one.
        kwargs = dict(max_batch=8, linger_ms=50.0, record_dispatches=True)
        never_slow = dict(min_samples=1 << 30)
        fleet = EeiFleet(3, salt=2, straggler_kwargs=never_slow,
                         server_kwargs=dict(kwargs, device="cpu"))
        r_fleet = r_engine.EeiFleet(3, salt=2, straggler_kwargs=never_slow,
                                    server_kwargs=kwargs)
        try:
            futs = [fleet.submit(a, k) for a, k in stream]
            r_futs = [r_fleet.submit(a, k) for a, k in stream]
            results = [f.result(timeout=WAIT_S) for f in futs]
            r_results = [f.result(timeout=WAIT_S) for f in r_futs]
        finally:
            assert fleet.close(timeout=WAIT_S) == []
            assert r_fleet.close(timeout=WAIT_S) == []
        owner = _served_keys({rid: r.driver._server
                              for rid, r in fleet._replicas.items()})
        r_owner = _served_keys({rid: r.driver._server
                                for rid, r in r_fleet._replicas.items()})
        assert owner == r_owner
        assert owner == {key: route_key(key, [0, 1, 2], 2) for key in owner}
        assert len(set(owner.values())) > 1
        for i, ((a, k), res, r_res) in enumerate(zip(stream, results,
                                                     r_results)):
            lam, vec = np.asarray(res.eigenvalues), np.asarray(res.vectors)
            ref = np.linalg.eigvalsh(a.astype(np.float64))[-k:]
            np.testing.assert_allclose(lam, ref, rtol=5e-3, atol=5e-3,
                                       err_msg=f"request {i}")
            np.testing.assert_allclose(lam, np.asarray(r_res.eigenvalues),
                                       rtol=5e-3, atol=5e-3,
                                       err_msg=f"request {i}")
            r_vec = np.asarray(r_res.vectors)
            assert vec.shape == r_vec.shape == (k, a.shape[0])
            err = np.minimum(np.abs(vec - r_vec), np.abs(vec + r_vec)).max()
            assert err < 5e-3, (i, err)
        stats, r_stats = fleet.stats(), r_fleet.stats()
        assert set(stats) == set(r_stats)
        for key in ("requests_submitted", "requests_completed",
                    "requests_failed", "redispatches", "replicas_killed"):
            assert stats[key] == r_stats[key], key
    finally:
        autotune.set_table(None)
        r_autotune.set_table(None)


# ---------------------------------------------------------------------------
# Twins of tests/test_fleet.py: building blocks
# ---------------------------------------------------------------------------


def test_route_key_deterministic_and_minimal_remap():
    candidates = [0, 1, 2, 3]
    keys = [(n, largest) for n in range(4, 40) for largest in (True, False)]
    owner = {k: route_key(k, candidates, salt=7) for k in keys}
    assert owner == {k: route_key(k, candidates, salt=7) for k in keys}
    assert any(owner[k] != route_key(k, candidates, salt=8) for k in keys)
    dead = 2
    survivors = [c for c in candidates if c != dead]
    for k in keys:
        new = route_key(k, survivors, salt=7)
        if owner[k] != dead:
            assert new == owner[k], "removal of a non-owner remapped a key"
    assert {k: route_key(k, candidates, salt=7) for k in keys} == owner


def test_decorrelated_jitter_bounds_and_seed():
    rng = np.random.default_rng(3)
    base, cap, prev = 0.01, 0.5, 0.01
    seen = []
    for _ in range(50):
        prev = decorrelated_jitter(rng, base, prev, cap)
        assert base <= prev <= cap
        seen.append(prev)
    rng2 = np.random.default_rng(3)
    prev2 = 0.01
    replay = []
    for _ in range(50):
        prev2 = decorrelated_jitter(rng2, base, prev2, cap)
        replay.append(prev2)
    assert seen == replay
    assert len(set(seen)) > 10


def test_restart_policy_bounded_and_jittered():
    pol = RestartPolicy(max_restarts=3, base_delay_s=0.01, cap_s=1.0, seed=5)
    delays = []
    while not pol.give_up:
        delays.append(pol.next_delay())
    assert len(delays) == 3
    assert all(0.01 <= d <= 1.0 for d in delays)
    pol.reset()
    assert not pol.give_up
    assert pol.next_delay() > 0.0


# ---------------------------------------------------------------------------
# Twins: routing and plain serving
# ---------------------------------------------------------------------------


def test_fleet_basic_serve_and_exactly_once():
    rng = np.random.default_rng(0)
    reqs = []
    with _fleet(3) as fleet:
        for _ in range(18):
            n = int(rng.integers(4, 13))
            k = 1 + int(rng.integers(0, n))
            a = _sym(rng, n)
            reqs.append((a, k, fleet.submit(a, k, largest=True)))
        assert fleet.flush(timeout=WAIT_S)
        stats = fleet.stats()
    _assert_fleet_safe(reqs, stats)
    assert stats["requests_submitted"] == len(reqs)
    for a, k, fut in reqs:
        lam = np.sort(np.asarray(fut.result().eigenvalues))
        ref = np.linalg.eigvalsh(a.astype(np.float64))[-k:]
        np.testing.assert_allclose(lam, ref, rtol=5e-3, atol=5e-3)


def test_fleet_routes_one_key_to_one_replica():
    rng = np.random.default_rng(1)
    with _fleet(3, salt=4) as fleet:
        futs = [fleet.submit(_sym(rng, 8), 2) for _ in range(10)]
        for f in futs:
            f.result(timeout=WAIT_S)
        per = fleet.stats()["per_replica"]
        served = [rid for rid, s in per.items()
                  if s.get("requests_submitted", 0) > 0]
    assert served == [route_key((8, True), [0, 1, 2], salt=4)]


def test_fleet_submit_validation_and_closed():
    with _fleet(1) as fleet:
        with pytest.raises(ValueError):
            fleet.submit(np.zeros((3, 4), dtype=np.float32), 1)
        with pytest.raises(ValueError):
            fleet.submit(np.eye(4, dtype=np.float32), 5)
    fut = fleet.submit(np.eye(4, dtype=np.float32), 1)
    with pytest.raises(FleetClosed):
        fut.result(timeout=10)
    assert fleet.stats()["requests_rejected"] == 1


# ---------------------------------------------------------------------------
# Twins: failover, restart, deadline, hedging
# ---------------------------------------------------------------------------


def test_fleet_failover_on_kill_and_restart():
    rng = np.random.default_rng(2)
    _warm()
    fleet = _fleet(3, salt=1,
                   restart_policy_kwargs=dict(base_delay_s=0.01, cap_s=0.1))
    try:
        a0 = _sym(rng, 8)
        reqs = [(a0, 2, fleet.submit(a0, 2))]
        reqs[0][2].result(timeout=WAIT_S)
        owner = route_key((8, True), [0, 1, 2], salt=1)
        reqs += [(a := _sym(rng, 8), 2, fleet.submit(a, 2))
                 for _ in range(6)]
        fleet._kill_replica(owner, reason="test kill")
        for _, _, f in reqs:
            f.result(timeout=WAIT_S)
        stats = fleet.stats()
        _assert_fleet_safe(reqs, stats)
        assert stats["replicas_killed"] >= 1
        _wait_for(lambda: fleet.stats()["replica_states"][owner] == HEALTHY,
                  60, "killed replica to restart")
        assert fleet.stats()["replicas_restarted"] >= 1
        fleet.submit(_sym(rng, 8), 2).result(timeout=WAIT_S)
        assert fleet._replicas[owner].driver.stats()[
            "requests_submitted"] >= 1
    finally:
        assert fleet.close(timeout=WAIT_S) == []


def test_fleet_deadline_catches_hung_replica():
    rng = np.random.default_rng(3)
    _warm()
    fleet = _fleet(2, salt=0, deadline_s=0.6,
                   restart_policy_kwargs=dict(base_delay_s=0.01, cap_s=0.1))
    try:
        for _ in range(2):
            fleet.submit(_sym(rng, 8), 2).result(timeout=WAIT_S)
        owner = route_key((8, True), [0, 1], salt=0)
        fleet._replicas[owner].driver.hang(30.0)
        a = _sym(rng, 8)
        res = fleet.submit(a, 2).result(timeout=60)
        assert float(verify_topk_host(
            a, np.asarray(res.eigenvalues),
            np.asarray(res.vectors)).residual) <= 2e-2
        stats = fleet.stats()
        assert stats["deadline_deaths"] >= 1
        assert stats["replicas_killed"] >= 1
    finally:
        fleet.close(timeout=WAIT_S)


def test_fleet_hedges_slow_replica_first_result_wins():
    rng = np.random.default_rng(4)
    _warm()
    fleet = _fleet(2, salt=0, hedge_age_s=0.05, slow_cooldown_s=30.0)
    try:
        for _ in range(2):
            fleet.submit(_sym(rng, 8), 2).result(timeout=WAIT_S)
        owner = route_key((8, True), [0, 1], salt=0)
        replica = fleet._replicas[owner]
        replica.driver.slow(1.0, duration_s=30.0)
        with fleet._cv:
            replica.state = SLOW
            replica.last_slow_flag = time.monotonic()
        a = _sym(rng, 8)
        fut = fleet.submit(a, 2)
        t0 = time.monotonic()
        res = fut.result(timeout=60)
        assert float(verify_topk_host(
            a, np.asarray(res.eigenvalues),
            np.asarray(res.vectors)).residual) <= 2e-2
        assert time.monotonic() - t0 < 0.9
        assert fleet.stats()["hedges"] >= 1
    finally:
        fleet.close(timeout=WAIT_S)


def test_fleet_parks_when_no_replica_routable_then_recovers():
    rng = np.random.default_rng(5)
    fleet = _fleet(2, restart_policy_kwargs=dict(base_delay_s=0.05,
                                                 cap_s=0.2))
    try:
        fleet.submit(_sym(rng, 8), 2).result(timeout=WAIT_S)
        for rid in (0, 1):
            fleet._kill_replica(rid, reason="test: total outage")
        with fleet._cv:
            dead_now = all(r.state != HEALTHY
                           for r in fleet._replicas.values())
        assert dead_now
        a = _sym(rng, 8)
        res = fleet.submit(a, 2).result(timeout=WAIT_S)
        assert float(verify_topk_host(
            a, np.asarray(res.eigenvalues),
            np.asarray(res.vectors)).residual) <= 2e-2
        assert fleet.stats()["replicas_restarted"] >= 1
    finally:
        assert fleet.close(timeout=WAIT_S) == []


def test_session_fails_over_from_the_host_mirror():
    """A session whose replica dies reopens on another one from the fleet's
    host mirror: the caller gets a ``DegradedResult(fallback=
    "session_reopen")`` holding the current window, and later updates run
    warm on the new owner."""
    rng = np.random.default_rng(6)
    n, k = 24, 3
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    fleet = _fleet(3, server_kwargs=dict(device="cpu"),
                   restart_policy_kwargs=dict(base_delay_s=0.01, cap_s=0.1))
    try:
        sid = fleet.open_session(a, k)
        a_now = a.copy()
        for step in range(4):
            u = rng.standard_normal(n) * 0.1
            a_now += np.outer(u, u)
            res = fleet.submit_update(sid, u).result(timeout=WAIT_S)
            if step == 1:
                owner = fleet._sessions[sid].rid
                fleet._kill_replica(owner, reason="test kill")
            if step == 2:
                assert res.degraded and res.fallback == "session_reopen"
                assert fleet._sessions[sid].rid != owner
            w = np.linalg.eigvalsh(a_now)[-k:]
            np.testing.assert_allclose(res.eigenvalues, w, rtol=5e-3,
                                       atol=5e-3, err_msg=f"step {step}")
        assert fleet.stats()["session_failovers"] == 1
    finally:
        fleet.close(timeout=WAIT_S)


# ---------------------------------------------------------------------------
# Twin: the chaos conformance fuzz
# ---------------------------------------------------------------------------

_FREQ = st.tuples(st.integers(4, 12), st.integers(0, 1), st.booleans(),
                  st.integers(0, 2))


@settings(max_examples=3, deadline=None)
@given(ops=st.lists(_FREQ, min_size=4, max_size=14),
       rate=st.sampled_from([0.05, 0.1]),
       seed=st.integers(0, 999), chaos_seed=st.integers(0, 999))
def test_fleet_chaos_stream_conformance_fuzz(ops, rate, seed, chaos_seed):
    chaos = ChaosMonkey(ChaosConfig(
        seed=chaos_seed, rate=0.0, replica_kill_rate=rate,
        replica_hang_rate=rate / 2, replica_slow_rate=rate,
        replica_slow_s=0.01, replica_hang_s=0.3))
    fleet = _fleet(3, chaos=chaos, deadline_s=30.0,
                   restart_policy_kwargs=dict(
                       max_restarts=10_000, base_delay_s=0.01, cap_s=0.1))
    rng = np.random.default_rng(seed)
    reqs = []
    try:
        for n, k_raw, largest, action in ops:
            a, k = _sym(rng, n), 1 + k_raw % n
            reqs.append((a, k, fleet.submit(a, k, largest=largest)))
            if action == 1:
                time.sleep(0.002)
        for _, _, f in reqs:
            f.result(timeout=WAIT_S)
    finally:
        stranded = fleet.close(timeout=WAIT_S)
    assert stranded == []
    stats = fleet.stats()
    _assert_fleet_safe(reqs, stats)
    assert stats["chaos_injected"] == chaos.counts()


# ---------------------------------------------------------------------------
# Twins: retry jitter, close-timeout semantics, shared program cache
# ---------------------------------------------------------------------------


def _all_launches_fail_server(jitter_seed, chaos_seed=11):
    return EeiServer(
        PLAN, device="cpu", max_batch=1, retry_backoff_s=0.001,
        retry_backoff_cap_s=0.01, retry_jitter_seed=jitter_seed,
        cache=ProgramCache(),
        chaos=ChaosMonkey(ChaosConfig(seed=chaos_seed, rate=0.0,
                                      launch_rate=1.0)))


def _burn_retries(server, n_stacks=3):
    rng = np.random.default_rng(9)
    reqs = [(a := _sym(rng, 8), server.submit(a, 2)) for _ in range(n_stacks)]
    server.flush()
    for a, f in reqs:
        res = f.result(timeout=WAIT_S)
        assert res.degraded
    return list(server.retry_delays_s)


def test_retry_jitter_seedable_and_schedules_diverge():
    d1 = _burn_retries(_all_launches_fail_server(jitter_seed=1))
    d2 = _burn_retries(_all_launches_fail_server(jitter_seed=2))
    d1_again = _burn_retries(_all_launches_fail_server(jitter_seed=1))
    assert len(d1) == len(d2) == len(d1_again) == 6
    assert all(0.001 <= d <= 0.01 for d in d1 + d2)
    assert d1 == d1_again, "same seed must replay the same schedule"
    assert d1 != d2, "different seeds must decorrelate the schedules"
    assert len(set(d1)) > 1, "delays within one schedule must vary"


def test_close_timeout_returns_unresolved_futures():
    chaos = ChaosMonkey(ChaosConfig(seed=3, rate=0.0, slow_retire_rate=1.0,
                                    slow_s=1.0))
    server = EeiServer(PLAN, device="cpu", max_batch=1, linger_ms=1.0,
                       cache=SHARED_CACHE, chaos=chaos)
    rng = np.random.default_rng(6)
    futs = [server.submit(_sym(rng, 8), 2) for _ in range(4)]
    t0 = time.monotonic()
    stranded = server.close(drain=True, timeout=0.2)
    assert time.monotonic() - t0 < 5.0, "close() must respect its timeout"
    assert stranded, "slow-retired tail should still be unresolved"
    assert set(stranded) <= set(futs)
    assert not server.alive()
    for f in futs:
        f.result(timeout=WAIT_S)
    assert server.stats()["requests_unresolved"] == 0


def test_clean_close_returns_empty_list():
    rng = np.random.default_rng(7)
    server = EeiServer(PLAN, device="cpu", max_batch=2, linger_ms=1.0,
                       cache=SHARED_CACHE)
    futs = [server.submit(_sym(rng, 8), 2) for _ in range(3)]
    assert server.close(drain=True, timeout=WAIT_S) == []
    assert all(f.done() for f in futs)


def test_cross_server_shared_cache_compiles_once_per_bucket():
    cache = ProgramCache()
    servers = [EeiServer(PLAN, device="cpu", max_batch=1, cache=cache)
               for _ in range(2)]
    rng = np.random.default_rng(8)
    mats = [_sym(rng, 8) for _ in range(6)]
    barrier = threading.Barrier(2)
    results = [None, None]

    def drive(i):
        barrier.wait(WAIT_S)
        futs = [servers[i].submit(a, 2) for a in mats]
        servers[i].flush()
        results[i] = [f.result(timeout=WAIT_S) for f in futs]

    threads = [threading.Thread(target=drive, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
        assert not t.is_alive()
    assert cache.compiles == 1 and len(cache) == 1
    assert cache.hits + cache.misses == 12
    for x, y in zip(results[0], results[1]):
        np.testing.assert_array_equal(x.eigenvalues, y.eigenvalues)
    for s in servers:
        s.close()


# ---------------------------------------------------------------------------
# Subprocess replicas on the CPU, and no card
# ---------------------------------------------------------------------------

#: The subprocess fleet's own time limit (s): two workers start, one is
#: SIGKILLed and restarts, 10 requests of n = 8.
SUBPROCESS_LIMIT_S = 90


def _subprocess_sigkill_run(n_warm, n_after, server_kwargs):
    """2 subprocess replicas: warm both, submit ``n_after`` more, SIGKILL
    worker 0 mid-stream; every request resolves once and ``close()``
    strands nothing."""
    rng = np.random.default_rng(13)
    fleet = EeiFleet(
        2, replica_mode="subprocess", probe_interval_s=0.02,
        server_kwargs=server_kwargs,
        restart_policy_kwargs=dict(max_restarts=100, base_delay_s=0.05,
                                   cap_s=0.5))
    reqs = []
    try:
        for _ in range(n_warm):
            a = _sym(rng, 8)
            reqs.append((a, 2, fleet.submit(a, 2)))
        for _, _, f in reqs:
            f.result(timeout=60)
        victim = fleet._replicas[0]
        for _ in range(n_after):
            a = _sym(rng, 8)
            reqs.append((a, 2, fleet.submit(a, 2)))
        os.kill(victim.driver._proc.pid, signal.SIGKILL)
        for _, _, f in reqs:
            f.result(timeout=60)
        # The kill may land after the requests resolved (a fast plan on a
        # CPU): the monitor's liveness probe must still see it.
        _wait_for(lambda: fleet.stats()["replicas_killed"] >= 1, 30,
                  "the monitor to see the SIGKILLed worker")
    finally:
        stranded = fleet.close(timeout=60)
    assert stranded == []
    _assert_fleet_safe(reqs, fleet.stats())
    return fleet


def test_fleet_subprocess_sigkill_on_cpu_within_its_limit():
    """The tier-1 CPU check of ``fleet_worker``: 2 workers on
    ``device="cpu"``, 10 requests of n = 8, one SIGKILL; it runs in a thread
    and fails if it does not finish within ``SUBPROCESS_LIMIT_S``."""
    out = {}

    def body():
        try:
            out["fleet"] = _subprocess_sigkill_run(
                4, 6, dict(device="cpu", plan=PLAN, max_batch=4,
                           linger_ms=2.0))
        except BaseException as exc:  # re-raised on the test's thread
            out["error"] = exc

    t0 = time.monotonic()
    runner = threading.Thread(target=body, daemon=True)
    runner.start()
    runner.join(SUBPROCESS_LIMIT_S)
    assert not runner.is_alive(), \
        f"the subprocess fleet ran past its {SUBPROCESS_LIMIT_S} s limit"
    if "error" in out:
        raise out["error"]
    fleet = out["fleet"]
    for replica in fleet._replicas.values():
        assert replica.driver._proc.poll() is not None  # no worker left
    print(f"subprocess fleet: {time.monotonic() - t0:.1f} s")


def test_fleet_and_launcher_need_a_card_by_default(monkeypatch):
    """No ``device`` and no card: the fleet refuses in both replica modes
    (no worker is started), and so does the launcher's ``--replicas``."""
    from repro_torch.launch import serve as serve_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spawned = []
    monkeypatch.setattr(
        "repro_torch.engine.fleet.subprocess.Popen",
        lambda *a, **kw: spawned.append(a) or pytest.fail("spawned"))
    for mode in ("inprocess", "subprocess"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            EeiFleet(2, replica_mode=mode)
    assert spawned == []
    for extra in ([], ["--replica-mode", "subprocess"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve_cli.main(["--eei", "--requests", "0", "--n", "12",
                            "--k", "2", "--replicas", "3", *extra])


# ---------------------------------------------------------------------------
# Stress lane (-m slow): the twins of tests/test_fleet.py's slow tests
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_fleet_chaos_soak_kill_restart_resume():
    chaos = ChaosMonkey(ChaosConfig(
        seed=7, rate=0.0, replica_kill_rate=0.08, replica_hang_rate=0.04,
        replica_slow_rate=0.08, replica_slow_s=0.01, replica_hang_s=0.3))
    fleet = _fleet(3, chaos=chaos, deadline_s=30.0,
                   restart_policy_kwargs=dict(
                       max_restarts=10_000, base_delay_s=0.01, cap_s=0.1))
    rng = np.random.default_rng(12)
    reqs = []
    try:
        for i in range(60):
            n = int(rng.integers(4, 13))
            k = 1 + int(rng.integers(0, n))
            a = _sym(rng, n)
            reqs.append((a, k, fleet.submit(a, k, largest=bool(i % 2))))
            if i % 7 == 0:
                time.sleep(0.005)
        for _, _, f in reqs:
            f.result(timeout=WAIT_S)
    finally:
        stranded = fleet.close(timeout=WAIT_S)
    assert stranded == []
    stats = fleet.stats()
    _assert_fleet_safe(reqs, stats)
    assert stats["replicas_killed"] >= 1, "soak never exercised a kill"
    assert stats["replicas_restarted"] >= 1
    assert stats["redispatches"] >= 1
    assert stats["chaos_injected"]["replica_kill"] >= 1


@pytest.mark.slow
def test_fleet_subprocess_replica_sigkill_failover():
    """``tests/test_fleet.py``'s slow subprocess lane on the port: the
    workers plan per bucket, as ``repro``'s do."""
    _subprocess_sigkill_run(4, 6, dict(device="cpu", max_batch=4,
                                       linger_ms=2.0))
