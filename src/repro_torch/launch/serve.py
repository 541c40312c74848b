"""Serving launcher: streams of EEI top-k queries through ``EeiServer``.

    PYTHONPATH=src python -m repro_torch.launch.serve --eei --batch 8 \
        --n 64 --k 4 --requests 64 [--mixed] [--sync] [--linger-ms 2] \
        [--gap-ms 1] [--pack auto|never|always] \
        [--spectrum auto|full|windowed] [--chaos SEED] [--chaos-rate 0.05] \
        [--replicas 3 [--replica-mode subprocess] [--chaos-replicas]] \
        [--mesh 2x1 [--sharded]] [--device cpu]

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
resolve.  ``--mesh DxM`` serves on a mesh of the first ``D*M`` cards (with
``--device``, that device repeated ``D*M`` times: ``--device cpu``, or
``--device cuda:0`` for a logical mesh on one card): buckets of at least
``D`` requests take the sharded backend, rounded up to a multiple of ``D``;
``--sharded`` pins it (and needs ``D >= 2``).  The stream is made before
the timed region.

The server (every replica's, with ``--replicas``) runs on the card unless
``--device`` names another device; with no card and no ``--device`` it
refuses to run.

The language-model path, the twin of ``repro``'s ``--arch`` mode:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        [--reduced] [--batch 4] [--prompt-len 32] [--gen 16] \
        [--dtype float32|bfloat16] [--seed 0] [--device cpu] [--mesh DxM]

builds the config's ``LanguageModel`` with weights drawn from ``--seed``,
prefills ``--batch`` seeded prompts of ``--prompt-len`` tokens (whisper's
frames and llama-vision's images are seeded too), decodes ``--gen`` tokens
greedily, and prints the ``(batch, gen)`` token ids as a JSON list.  The
parameters are cast to ``--dtype`` once, before the decode loop.  It runs
on the card unless ``--device`` names another device.  Every config of the
registry runs.  With ``--mesh DxM`` (``--device`` repeated, as for
``--eei``) the parameters are placed on the mesh by ``repro``'s specs and
served through ``train.steps.build_programs`` (prefill and ``serve_step``
over sharded caches); the mesh and the bytes each of its devices holds
are logged.  ``--mesh PxDxM`` (``repro``'s pod axis) is refused: it waits
for the dry-run slice with ``make_production_mesh``.
"""

from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np
import torch

log = logging.getLogger("repro_torch.serve")

def lm_batch(cfg, batch: int, prompt_len: int, seed: int, device) -> dict:
    """The launcher's seeded prompts: ``tokens`` (and ``labels``, the same)
    of ``(batch, prompt_len)``, plus whisper's ``frames`` and llama-vision's
    ``images`` (N(0, 1) * 0.02, ``repro``'s scale), drawn in that order
    from a CPU ``torch.Generator`` seeded with ``seed`` and put on
    ``device``."""
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen)
    out = {"tokens": tokens, "labels": tokens}
    if cfg.family == "audio":
        out["frames"] = torch.randn(batch, cfg.enc_seq, cfg.d_model,
                                    generator=gen) * 0.02
    if cfg.family == "vlm":
        out["images"] = torch.randn(batch, cfg.img_seq, cfg.d_model,
                                    generator=gen) * 0.02
    return {k: v.to(device) for k, v in out.items()}


def serve_lm(args, cfg):
    """Greedy batched decode of ``cfg``'s model: prefill fills the caches,
    then ``serve_step`` decodes one token at a time.  Returns the
    ``(batch, gen)`` token ids as a numpy array."""
    from repro_torch.models import LanguageModel
    from repro_torch.train.steps import cast_tree, make_serve_step

    from repro_torch.launch.mesh import parse_mesh

    compute_dtype = (torch.bfloat16 if args.dtype == "bfloat16"
                     else torch.float32)
    smax = args.prompt_len + args.gen
    mesh = parse_mesh(args.mesh, args.device) if args.mesh != "1x1" else None
    if mesh is not None and mesh.size > 1:
        return _serve_lm_mesh(args, cfg, mesh, compute_dtype, smax)
    with torch.inference_mode():
        model = LanguageModel(cfg, device=args.device)
        dev = model.device
        card = (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
                else "")
        log.info("lm serve: %s, %d parameters on %s%s, %s, batch=%d "
                 "prompt=%d gen=%d", cfg.name, model.n_params(), dev, card,
                 args.dtype, args.batch, args.prompt_len, args.gen)
        model.init(torch.Generator(device=dev).manual_seed(args.seed))
        batch = lm_batch(cfg, args.batch, args.prompt_len, args.seed, dev)
        # One cast before the loop: serve_step's own cast is then free.
        params = cast_tree(model.param_dict(), compute_dtype)
        serve_step = make_serve_step(model, compute_dtype)

        t0 = time.monotonic()
        logits, caches = model.prefill(params, batch, smax)
        tok = torch.argmax(logits, dim=-1)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        log.info("prefill %.3fs (B=%d, S=%d)", time.monotonic() - t0,
                 args.batch, args.prompt_len)
        out_tokens = [tok]
        t0 = time.monotonic()
        for i in range(args.gen - 1):
            tok, caches = serve_step(params, caches, tok, args.prompt_len + i)
            out_tokens.append(tok)
        gen = torch.stack(out_tokens, dim=1).cpu().numpy()
        dt = time.monotonic() - t0
    log.info("decode %d tokens x %d seqs in %.3fs (%.1f tok/s) on %s%s",
             gen.shape[1], gen.shape[0], dt, gen.size / max(dt, 1e-9), dev,
             card)
    print(json.dumps(gen.tolist()))
    return gen


def _serve_lm_mesh(args, cfg, mesh, compute_dtype, smax):
    """:func:`serve_lm` on a mesh, through ``build_programs``."""
    from repro_torch.launch.mesh import log_mesh_bytes
    from repro_torch.models import LanguageModel
    from repro_torch.sharding.placement import put_tree
    from repro_torch.train.steps import build_programs, cast_tree

    dev = mesh.first_device
    with torch.inference_mode():
        model = LanguageModel(cfg, device=dev)
        card = (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
                else "")
        programs = build_programs(model, mesh, compute_dtype=compute_dtype)
        log.info("lm serve: %s, %d parameters on a %dx%d mesh of %s%s, %s, "
                 "fsdp=%s, batch=%d prompt=%d gen=%d", cfg.name,
                 model.n_params(), mesh.shape["data"], mesh.shape["model"],
                 dev, card, args.dtype, programs.fsdp, args.batch,
                 args.prompt_len, args.gen)
        model.init(torch.Generator(device=dev).manual_seed(args.seed))
        params = cast_tree(put_tree(model.stacked_dict(),
                                    programs.state_shardings.params),
                           compute_dtype)
        model.release()
        log_mesh_bytes(log, mesh, params, "parameters")
        batch = lm_batch(cfg, args.batch, args.prompt_len, args.seed, dev)
        t0 = time.monotonic()
        logits, caches = programs.prefill(params, batch, smax)
        tok = torch.argmax(logits, dim=-1)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        log.info("prefill %.3fs (B=%d, S=%d)", time.monotonic() - t0,
                 args.batch, args.prompt_len)
        log_mesh_bytes(log, mesh, caches, "caches")
        out_tokens = [tok]
        t0 = time.monotonic()
        for i in range(args.gen - 1):
            tok, caches = programs.serve_step(params, caches, tok,
                                              args.prompt_len + i)
            out_tokens.append(tok)
        gen = torch.stack(out_tokens, dim=1).cpu().numpy()
        dt = time.monotonic() - t0
    log.info("decode %d tokens x %d seqs in %.3fs (%.1f tok/s) on %s%s",
             gen.shape[1], gen.shape[0], dt, gen.size / max(dt, 1e-9), dev,
             card)
    print(json.dumps(gen.tolist()))
    return gen


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
    from repro_torch.launch.mesh import mesh_axes, parse_mesh

    if args.calibration:
        autotune.set_table(autotune.load_table(args.calibration))
    table = autotune.get_table()

    data, model = mesh_axes(args.mesh)
    serve_mesh = (parse_mesh(args.mesh, args.device) if data * model > 1
                  else None)
    plan = plan_for((args.batch, args.n, args.n), k=args.k, mesh=serve_mesh,
                    backend="sharded" if args.sharded else None,
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
    # --mixed plans per bucket (plan=None, with the mesh); a fixed shape
    # pins the plan.
    server = EeiServer(None if args.mixed else plan, device=args.device,
                       mesh=serve_mesh if args.mixed else None,
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
                    help="serve batched EEI top-k queries")
    ap.add_argument("--arch", default=None,
                    help="serve this config's language model (greedy "
                    "decode), unless --eei is given")
    ap.add_argument("--reduced", action="store_true",
                    help="LM: the config's reduced (smoke) version")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="LM: prompt tokens a sequence")
    ap.add_argument("--gen", type=int, default=16,
                    help="LM: tokens to generate a sequence")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="LM: compute dtype (the parameters are cast once)")
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
                    help="EEI: max requests per stack; LM: sequences")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to serve on, every replica's with "
                    "--replicas (default: the card; 'cpu' runs the "
                    "kernels' plain versions, or the LM on the CPU)")
    ap.add_argument("--mesh", default="1x1",
                    help="DxM device mesh: the first D*M cards, or with "
                    "--device that device repeated; --eei: buckets of at "
                    "least D requests take the sharded backend; --arch: "
                    "the model's parameters and caches are sharded on it")
    ap.add_argument("--sharded", action="store_true",
                    help="serve through the sharded backend on the --mesh "
                    "data axis (stack buckets round up to it; needs D >= 2)")
    args = ap.parse_args(argv)
    from repro_torch.launch.mesh import POD_MESH_REFUSAL, mesh_axes

    if args.mesh.count("x") == 2:
        ap.error(POD_MESH_REFUSAL.format(args.mesh))
    try:
        data, model = mesh_axes(args.mesh)
    except ValueError as exc:
        ap.error(f"--mesh: {exc}")
    if args.sharded and data < 2:
        ap.error("--sharded needs a data axis of at least 2 devices: pass "
                 "--mesh DxM with D >= 2 (with --device, that device "
                 "repeated)")
    if args.eei:
        logging.basicConfig(level=logging.INFO)
        return serve_eei(args)
    if args.arch is None:
        ap.error("--eei is required unless --arch is given")
    from repro_torch.configs import get_config, reduced_config

    try:
        cfg = get_config(args.arch)
    except KeyError as exc:
        ap.error(f"--arch: {exc.args[0]}")
    if args.reduced:
        cfg = reduced_config(cfg)
    logging.basicConfig(level=logging.INFO)
    return serve_lm(args, cfg)


if __name__ == "__main__":
    main()
