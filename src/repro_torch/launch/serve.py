"""Serving launcher: streams of EEI top-k queries through ``EeiServer``.

    PYTHONPATH=src python -m repro_torch.launch.serve --eei --batch 8 \
        --n 64 --k 4 --requests 64 [--mixed] [--sync] [--linger-ms 2] \
        [--gap-ms 1] [--pack auto|never|always] \
        [--spectrum auto|full|windowed] [--chaos SEED] [--chaos-rate 0.05] \
        [--replicas 3 [--replica-mode subprocess] [--chaos-replicas]] \
        [--device cpu]

The twin of ``python -m repro.launch.serve --eei``.  ``--mixed`` samples
``n`` and ``k`` per request (the heterogeneous stream the server buckets);
``--sync`` runs the per-request loop instead (one ``engine.topk`` and one
host copy per matrix), the baseline the server is compared with.
``--linger-ms`` turns on the threaded runtime, whose admission thread
dispatches partial stacks once their oldest request has lingered that long
(pair it with ``--gap-ms``, the mean inter-arrival sleep).  ``--chaos
SEED`` injects faults deterministically at ``--chaos-rate`` per point; the
stream must still complete.  ``--replicas N`` serves through an
``EeiFleet`` of N replica servers (rendezvous-hashed routing, health
probes, failover redispatch, restart); ``--replica-mode subprocess`` runs
each replica in a worker process of its own, and ``--chaos-replicas`` arms
the replica-level kill / hang / slow points (at ``--chaos-rate``, seeded by
``--chaos``), so replicas die mid-stream while every request must still
resolve.  The stream is made before the timed region.

The server (every replica's, with ``--replicas``) runs on the card unless
``--device`` names another device; with no card and no ``--device`` it
refuses to run.  Not ported yet, and refused when asked for: the sharded
serve path (``--sharded``, ``--mesh``) and the language-model path
(``--arch``).
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

log = logging.getLogger("repro_torch.serve")

#: Flags of ``repro``'s launcher whose feature the port does not have yet:
#: dest -> (the feature, the values that ask for nothing beyond one server
#: on one device).
_UNPORTED = {
    "sharded": ("the sharded serve path", (False,)),
    "mesh": ("the sharded serve path", (None, "1x1")),
    "arch": ("the language-model path", (None,)),
}


def serve_eei(args):
    """Serve a pre-generated stream of top-k spectral queries: continuous
    batching through ``EeiServer``, or with ``--sync`` the per-request
    loop.  Returns the last request's result (None for an empty stream)."""
    from repro_torch.engine import (
        EeiServer,
        SolverEngine,
        TopkResult,
        autotune,
        plan_for,
        resolved_crossovers,
    )
    from repro_torch.engine.server import make_eei_stream

    if args.calibration:
        autotune.set_table(autotune.load_table(args.calibration))
    table = autotune.get_table()

    plan = plan_for((args.batch, args.n, args.n), k=args.k,
                    spectrum=None if args.spectrum == "auto" else
                    args.spectrum)
    eigh_x, dense_x = resolved_crossovers(plan.backend)
    log.info("plan calibration: %s (backend=%s eigh_crossover_n=%d "
             "dense_crossover_n=%d)",
             table.source if table else "static fallback constants",
             plan.backend, eigh_x, dense_x)
    mode = "sync-loop" if args.sync else (
        f"continuous-batching linger={args.linger_ms}ms"
        if args.linger_ms is not None else "continuous-batching")
    if args.mixed and not args.sync:
        # The server plans per shape bucket; the plan above is only the
        # log's reference point for the nominal (batch, n, k).
        log.info("eei serve: per-bucket planning, max_batch=%d nominal "
                 "n=%d k=%d mode=%s mixed-shapes", args.batch, args.n,
                 args.k, mode)
    else:
        log.info("eei serve plan: method=%s backend=%s spectrum=%s "
                 "max_batch=%d n=%d k=%d mode=%s", plan.method, plan.backend,
                 plan.spectrum, args.batch, args.n, args.k, mode)

    stream = make_eei_stream(args.requests, args.n, args.k,
                             seed=args.seed, mixed=args.mixed)

    gap_s = (args.gap_ms or 0.0) / 1e3
    rng = np.random.default_rng(args.seed)
    if args.sync:
        engine = SolverEngine(plan, args.device)
        # Warm-up outside the timed region (the kernels build at their
        # first launch): one request of each (n, k) in the stream.
        seen = {}
        for a, k_i in stream:
            seen.setdefault((a.shape[0], k_i), a)
        for (_, k_i), a in sorted(seen.items(), key=lambda kv: kv[0]):
            engine.topk(torch.as_tensor(a, device=engine.device),
                        k_i).eigenvalues.cpu()
        t0 = time.monotonic()
        out = None
        for a, k_i in stream:
            if gap_s:
                # The sync baseline pays the same arrival gaps as the
                # server path.
                time.sleep(rng.exponential(gap_s))
            res = engine.topk(torch.as_tensor(a, device=engine.device), k_i)
            out = TopkResult(res.eigenvalues.cpu().numpy(),
                             res.vectors.cpu().numpy())
        dt = time.monotonic() - t0
        log.info("sync loop served %d requests in %.3fs (%.1f solves/s, "
                 "%.1f requests/s)", len(stream), dt,
                 len(stream) / max(dt, 1e-9), len(stream) / max(dt, 1e-9))
        return out

    if args.replicas > 1:
        return _serve_eei_fleet(args, stream, gap_s, rng)

    chaos = None
    if args.chaos is not None:
        from repro_torch.runtime import ChaosConfig, ChaosMonkey

        chaos = ChaosMonkey(ChaosConfig(seed=args.chaos,
                                        rate=args.chaos_rate))
        log.info("chaos soak: seed=%d rate=%.3f (deterministic injection "
                 "at compile/launch/result/retire/thread points)",
                 args.chaos, args.chaos_rate)
    # --mixed plans per bucket (plan=None); a fixed shape pins the plan.
    server = EeiServer(None if args.mixed else plan, device=args.device,
                       max_batch=args.batch, max_inflight=args.inflight,
                       linger_ms=args.linger_ms, pack=args.pack, chaos=chaos)
    t0 = time.monotonic()
    futures = []
    for a, k_i in stream:
        if gap_s:
            time.sleep(rng.exponential(gap_s))  # sparse Poisson-ish arrivals
        futures.append(server.submit(a, k_i))
    if args.linger_ms is not None:
        # The stream drains with no explicit flush: wait on the futures.
        for f in futures:
            f.result(timeout=600)
    else:
        server.flush()
    dt = time.monotonic() - t0
    server.close()
    stats = server.stats()
    log.info("served %d requests in %.3fs (%.1f solves/s, %.1f requests/s)",
             len(stream), dt, len(stream) / max(dt, 1e-9),
             len(stream) / max(dt, 1e-9))
    log.info("latency p50=%.1fms p99=%.1fms | %d stacks, %d program "
             "compiles over %d distinct buckets, %d cache hits",
             stats["p50_latency_ms"], stats["p99_latency_ms"],
             stats["stacks_dispatched"], stats["program_compiles"],
             stats["distinct_buckets"], stats["program_hits"])
    per_bucket = ", ".join(
        f"{name}={frac:.3f}"
        for name, frac in sorted(stats["pad_waste_by_bucket"].items()))
    log.info("pad waste %.3f (%d of %d grid cells padding) | per bucket: %s",
             stats["pad_waste_frac"],
             stats["grid_cells_total"] - stats["grid_cells_real"],
             stats["grid_cells_total"], per_bucket or "none")
    if stats["packed_stacks_dispatched"]:
        log.info("packed dispatch (--pack=%s): %d of %d stacks packed, "
                 "%d requests packed | pad waste packed=%.3f bucketed=%.3f",
                 args.pack, stats["packed_stacks_dispatched"],
                 stats["stacks_dispatched"],
                 stats["packed_requests_completed"],
                 stats["pad_waste_packed_frac"],
                 stats["pad_waste_bucketed_frac"])
    by_plan = ", ".join(f"{name}={count}" for name, count in
                        sorted(stats["fallbacks_by_plan"].items()))
    log.info("robustness: %d verify failures, %d retries, %d stack splits, "
             "%d degraded | fallbacks: %s",
             stats["verify_failed"], stats["retries"], stats["stack_splits"],
             stats["requests_degraded"], by_plan or "none")
    if chaos is not None:
        injected = ", ".join(f"{point}={count}" for point, count in
                             sorted(stats["chaos_injected"].items()))
        log.info("chaos injected: %s | requests_failed=%d",
                 injected or "none", stats["requests_failed"])
    # An empty stream (--requests 0) has no futures to return.
    return futures[-1].result() if futures else None


def _serve_eei_fleet(args, stream, gap_s, rng):
    """Serve the stream through an ``EeiFleet`` of ``--replicas`` servers.

    ``--chaos-replicas`` arms the replica-level injection points
    (kill / hang / slow, kill and slow at ``--chaos-rate`` and hang at half
    of it, seeded by ``--chaos``): replicas die *while serving* and the
    stream must still complete, with the failover counters logged at the
    end.
    """
    from repro_torch.engine import EeiFleet

    chaos = None
    if args.chaos_replicas:
        from repro_torch.runtime import ChaosConfig, ChaosMonkey

        seed = args.chaos if args.chaos is not None else 0
        chaos = ChaosMonkey(ChaosConfig(
            seed=seed, rate=0.0, replica_kill_rate=args.chaos_rate,
            replica_hang_rate=args.chaos_rate / 2,
            replica_slow_rate=args.chaos_rate))
        log.info("replica chaos soak: seed=%d kill/slow rate=%.3f "
                 "hang rate=%.3f", seed, args.chaos_rate,
                 args.chaos_rate / 2)
    fleet = EeiFleet(
        args.replicas,
        replica_mode=args.replica_mode,
        server_kwargs=dict(
            device=args.device, max_batch=args.batch,
            max_inflight=args.inflight,
            linger_ms=args.linger_ms if args.linger_ms is not None else 2.0,
            pack=args.pack),
        chaos=chaos,
        restart_policy_kwargs=dict(max_restarts=1000),
    )
    log.info("eei fleet: %d %s replicas, max_batch=%d", args.replicas,
             args.replica_mode, args.batch)
    t0 = time.monotonic()
    futures = []
    for a, k_i in stream:
        if gap_s:
            time.sleep(rng.exponential(gap_s))
        futures.append(fleet.submit(a, k_i))
    for f in futures:
        f.result(timeout=600)
    dt = time.monotonic() - t0
    stranded = fleet.close(timeout=120)
    stats = fleet.stats()
    log.info("fleet served %d requests in %.3fs (%.1f requests/s) | "
             "%d unresolved at close", len(stream), dt,
             len(stream) / max(dt, 1e-9), len(stranded))
    log.info("fleet latency p50=%.1fms p99=%.1fms | states=%s",
             stats["p50_latency_ms"], stats["p99_latency_ms"],
             stats["replica_states"])
    log.info("failover: %d redispatches, %d hedges (%d wasted), "
             "%d kills, %d restarts, %d deadline deaths",
             stats["redispatches"], stats["hedges"], stats["hedge_wasted"],
             stats["replicas_killed"], stats["replicas_restarted"],
             stats["deadline_deaths"])
    if chaos is not None:
        injected = ", ".join(f"{point}={count}" for point, count in
                             sorted(stats["chaos_injected"].items())
                             if count)
        log.info("chaos injected: %s | requests_failed=%d",
                 injected or "none", stats["requests_failed"])
    return futures[-1].result() if futures else None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--eei", action="store_true",
                    help="serve batched EEI top-k queries (the only mode "
                    "ported)")
    ap.add_argument("--n", type=int, default=64, help="EEI matrix size")
    ap.add_argument("--k", type=int, default=4, help="EEI top-k per query")
    ap.add_argument("--requests", type=int, default=64,
                    help="EEI requests (single-matrix queries) to serve")
    ap.add_argument("--mixed", action="store_true",
                    help="sample n and k per request (heterogeneous stream "
                    "through the shape-bucketed server)")
    ap.add_argument("--sync", action="store_true",
                    help="synchronous per-request loop instead of the "
                    "continuous-batching server (baseline)")
    ap.add_argument("--pack", choices=["auto", "never", "always"],
                    default="never",
                    help="segment-packed dispatch: 'auto' packs below the "
                    "calibrated crossover, 'always' anything that fits a "
                    "row, 'never' (default) keeps the shape-bucketed path")
    ap.add_argument("--spectrum", choices=["auto", "full", "windowed"],
                    default="auto",
                    help="pin the composition ('windowed': only the k "
                    "requested rows; 'full': the whole table; 'auto': the "
                    "planner picks per bucket)")
    ap.add_argument("--inflight", type=int, default=2,
                    help="max in-flight stacks (double buffering = 2)")
    ap.add_argument("--linger-ms", type=float, default=None,
                    help="threaded runtime: dispatch partial stacks after "
                    "this linger timeout (no explicit flush)")
    ap.add_argument("--gap-ms", type=float, default=0.0,
                    help="mean inter-arrival sleep between submits")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="soak mode: inject faults deterministically from "
                    "this seed and log the robustness counters")
    ap.add_argument("--chaos-rate", type=float, default=0.05,
                    help="per-injection-point chaos probability (default "
                    "0.05; only with --chaos)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through an EeiFleet of this many replica "
                    "servers (health-probed routing, failover redispatch, "
                    "restart); 1 = single server")
    ap.add_argument("--replica-mode", choices=["inprocess", "subprocess"],
                    default="inprocess",
                    help="fleet replica driver: in-process servers sharing "
                    "one program cache, or one worker process per replica")
    ap.add_argument("--chaos-replicas", action="store_true",
                    help="fleet: arm replica-level chaos (kill/hang/slow at "
                    "--chaos-rate, seeded by --chaos); the fleet must still "
                    "answer every request")
    ap.add_argument("--calibration", default=None,
                    help="path to a calibration table (JSON); default: "
                    "env/cache/repo-default resolution chain")
    ap.add_argument("--batch", type=int, default=4,
                    help="max requests per stack")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to serve on, every replica's with "
                    "--replicas (default: the card; 'cpu' runs the "
                    "kernels' plain versions)")
    # Flags of the reference launcher whose features are not ported: named
    # so that asking for one is refused, not silently ignored.
    ap.add_argument("--sharded", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--mesh", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--arch", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for dest, (feature, single) in _UNPORTED.items():
        if getattr(args, dest) not in single:
            flag = "--" + dest.replace("_", "-")
            ap.error(f"{flag}: {feature} is not ported to repro_torch yet")
    if not args.eei:
        ap.error("--eei is required: the EEI serving path is the only one "
                 "ported")
    logging.basicConfig(level=logging.INFO)
    return serve_eei(args)


if __name__ == "__main__":
    main()
