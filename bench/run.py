"""The port's benchmark: one cell of ``BENCHMARK.json`` on one card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration (``bench/configs/<config>.json``: the matrix
ensemble, its size and precision) and has a traffic file
(``bench/workloads/<cell>.json``: the operation, ``k``, the stack size
``b``, the pool and the loop).  The operation is ``bench/ops/<op>.py`` and
every metric ``bench/metrics/<metric>.py``; each is found by its name.

A run loads the port (``repro_torch`` from this checkout's ``src/``),
builds its kernels (cached in ``build/`` inside the checkout), draws the
pool of distinct input stacks on the card from the seed, and warms up with
one call on each stack: that is ``setup_s``.  Then it drives the public
call ``SolverEngine(plan_for(shape, k=k, precision=...)).solve(stack)`` (or
``.topk(stack, k)``) in a closed loop of one caller, each call synchronised
before the next is sent, cycling through the pool.

``--trace 0`` measures for ``--seconds`` and prints the cell's end-to-end
metrics.  ``--trace 1`` profiles ``trace_calls`` calls made as in the
window, with a span around each stage (device idle share, kernel rooflines,
MFU), then walks ``split_calls`` calls stage by stage with a synchronise
around each (stage times), and prints the cell's per-layer metrics.

After the window every result is compared with the plain reference
(``bench/reference.py``) of its input; each compared number is printed
beside its limit, on the last lines of standard error and under the last
key of the result line, the last line of standard output.

The op contract.  An op module (``bench/ops/<op>.py``) always gives
``CHECKS`` (the compared numbers' names, the keys of the traffic's
``limits``), ``call`` (one call of the timed path; set-up's warm calls, the
window, the traced calls), ``flops_per_matrix(config, traffic, levels)``
(``eei_mfu``) and ``compare(result, ref)`` (one number a matrix for each
of ``CHECKS``).  Each function below is optional: ``load_op`` fills in the
default, in brackets, of each one the op lacks, and ``run_cell`` and
``_judge`` call every one of them.  The defaults are the whole path of the
``solve`` and ``topk`` ops.

``plan(shape, config, traffic)``
    the ``SolverPlan`` of the engine (``plan_for(shape, k=op.plan_k(
    traffic), precision=config["precision"])``).  ``run_cell`` calls it
    once in set-up; the ``bench info`` line prints its pick.
``draw(config, traffic, gen, device)``
    the op's inputs beyond the pool, drawn in set-up from ``gen``, the
    pool's generator, after the pool (None).  Whatever it returns is handed,
    as ``inputs``, to every ``call(engine, stack, traffic, inputs)`` and
    ``split``; the window draws nothing.  An op that draws nothing gives
    ``call(engine, stack, traffic)``.  The op may keep its running state in
    ``inputs``: the reference is handed a copy made before the first call.
``reference_key(idx, ordinal, inputs)``
    the key under which the reference of a kept call is cached, or None
    where the call is not compared (``idx``).  ``idx`` is the call's pool
    stack and ``ordinal`` the number of calls made on that stack before it,
    set-up's warm call counted: the first kept call on a stack is 1.
    ``_judge`` walks the kept calls in call order.
``reference_for(idx, ordinal, pool, inputs, traffic)``
    the reference of a kept call, from the pool and the copy of the op's
    drawn inputs alone (``reference(pool[idx], traffic)``: once a pool
    stack).
``programs(engine, plan, traffic)``
    the cached program objects a call runs; ``trace.annotated`` spans the
    stages of each in the traced calls (``[program(plan,
    op.program_spec(traffic))]``).
``split(engine, stack, inputs, traffic, walk)``
    one stage-split call, which runs each program as ``walk(prog, *args)``
    (``args``: the program's ``initial_state`` arguments) and returns the
    call's result (``walk(programs[0], stack)``).  Stage times add up under
    ``role/name``, whichever program ran the stage.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Run as a script, this file's folder heads sys.path, where bench/trace.py
# would shadow the standard library's module of that name.
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "bench":
    sys.path.pop(0)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: Top-level module names that may not be loaded when the result is printed.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_manifest(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(root: Path, name: str) -> dict:
    """The cell ``name``: its ``BENCHMARK.json`` entry, traffic file and
    configuration file, held to agree with one another."""
    manifest = load_manifest(root)
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf_entry = next(c for c in manifest["configs"]
                      if c["name"] == entry["config"])
    traffic = json.loads(
        (root / "bench" / "workloads" / f"{name}.json").read_text())
    config = json.loads((root / conf_entry["file"]).read_text())
    if (traffic["config"], traffic["traffic"]) != (entry["config"],
                                                   entry["traffic"]):
        raise ValueError(
            f"bench/workloads/{name}.json names {traffic['config']}/"
            f"{traffic['traffic']}, BENCHMARK.json {entry['config']}/"
            f"{entry['traffic']}")
    if config["name"] != entry["config"]:
        raise ValueError(f"{conf_entry['file']} is {config['name']!r}")
    if traffic["loop"] != "closed":
        raise ValueError("the harness drives a closed loop of one caller")
    return {"name": name, "root": root, "manifest": manifest, "entry": entry,
            "traffic": traffic, "config": config}


def _load(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(tag, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_op(cell: dict):
    """The cell's op module, with the default of each optional function
    it lacks (the op contract, above)."""
    name = cell["traffic"]["op"]
    op = _load(cell["root"] / "bench" / "ops" / f"{name}.py",
               f"bench_op_{name}")
    from repro_torch import plan_for
    from repro_torch.engine.engine import program

    if not hasattr(op, "draw"):
        call = op.call
        op.call = (lambda engine, stack, traffic, inputs=None:
                   call(engine, stack, traffic))
        op.draw = lambda config, traffic, gen, device: None
    defaults = {
        "plan": lambda shape, config, traffic: plan_for(
            shape, k=op.plan_k(traffic), precision=config["precision"]),
        "reference_key": lambda idx, ordinal, inputs: idx,
        "reference_for": lambda idx, ordinal, pool, inputs, traffic:
            op.reference(pool[idx], traffic),
        "programs": lambda engine, plan, traffic:
            [program(plan, op.program_spec(traffic))],
        "split": lambda engine, stack, inputs, traffic, walk:
            walk(op.programs(engine, engine.plan, traffic)[0], stack),
    }
    for key, fn in defaults.items():
        if not hasattr(op, key):
            setattr(op, key, fn)
    return op


def load_reader(cell: dict, metric: str):
    return _load(cell["root"] / "bench" / "metrics" / f"{metric}.py",
                 "bench_metric_" + metric.replace(".", "_").replace("-", "_"))


def metrics_for(cell: dict, trace_on: bool) -> list:
    """The metric entries this cell reports: with ``--trace 0`` its
    end-to-end metrics, with ``--trace 1`` its per-layer ones."""
    manifest, name = cell["manifest"], cell["name"]
    e2e = [m for m in manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace_on:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def _launch_counters():
    """The kernel wrappers' launch counts (every wrapper function of the
    port's kernel modules that carries a ``launches`` count)."""
    from repro_torch.kernels.prod_diff import kernel as pd
    from repro_torch.kernels.sturm import kernel as st

    return {f"{mod.__name__.split('.')[-2]}.{name}": fn
            for mod in (st, pd) for name, fn in vars(mod).items()
            if callable(fn) and hasattr(fn, "launches")}


def _plan_pick(plan, config: dict, traffic: dict) -> dict:
    pick = {"method": plan.method, "spectrum": plan.spectrum,
            "backend": plan.backend, "precision": plan.precision}
    if plan.method.startswith("eei_krylov"):
        from repro_torch.linalg import lanczos

        n, k = int(config["n"]), int(traffic["k"])
        pick["m"] = plan.krylov_m or (
            lanczos.default_si_m(n, k) if plan.method == "eei_krylov_si"
            else lanczos.default_m(n, k))
    return pick


def _draw(op, config: dict, traffic: dict, seed: int, device):
    """The pool (the stacks ``ensembles.draw`` makes of ``seed``), the
    op's inputs drawn after it from the same generator, and a copy of
    those inputs for the reference."""
    import torch

    from bench import ensembles

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    make = ensembles.ENSEMBLES[config["ensemble"]]
    pool = [make(config, int(traffic["b"]), gen, device)
            for _ in range(int(traffic["pool"]))]
    inputs = op.draw(config, traffic, gen, device)
    return pool, inputs, copy.deepcopy(inputs)


def _judge(op, pool: list, kept: list, traffic: dict, b: int, device,
           inputs=None):
    """Every kept result against the plain reference of its call, walked
    in call order: the largest reading of each compared number beside its
    limit, how many matrices read beyond a limit, and how many calls were
    compared."""
    import torch

    limits = traffic["limits"]
    worst = {name: 0.0 for name in op.CHECKS}
    failed = compared = 0
    refs = {}
    # Set-up made one call a stack, and ``kept`` holds every later call.
    made = [1] * len(pool)
    for idx, out in kept:
        ordinal = made[idx]
        made[idx] += 1
        key = op.reference_key(idx, ordinal, inputs)
        if key is None:
            continue
        if key not in refs:
            refs[key] = op.reference_for(idx, ordinal, pool, inputs, traffic)
        compared += 1
        numbers = op.compare(out, refs[key])
        bad = torch.zeros(b, dtype=torch.bool, device=device)
        for name in op.CHECKS:
            x = numbers[name]
            bad |= ~(x <= limits[name])
            # A NaN or an infinity is no number: it reads as None.
            top = float(x.amax()) if bool(torch.isfinite(x).all()) else None
            if worst[name] is not None:
                worst[name] = None if top is None else max(worst[name], top)
        failed += int(bad.sum())
    checks = {name: {"value": worst[name], "limit": limits[name]}
              for name in op.CHECKS}
    return checks, failed, compared


def run_cell(cell: dict, seed: int, seconds: float, trace_on: bool, device,
             t_start: float) -> dict:
    """One run of ``cell`` on ``device``: set-up, the window (or the traced
    calls), then the comparison.  Returns the result line's fields and the
    earlier line's (``info``)."""
    import torch

    from repro_torch import SolverEngine
    from repro_torch.engine import autotune

    from bench import roofline, trace

    marks = [("imports", time.perf_counter())]
    device = torch.device(device)
    config, traffic = cell["config"], cell["traffic"]
    op = load_op(cell)
    precision = config["precision"]
    b, pool_n = int(traffic["b"]), int(traffic["pool"])

    # The planner reads the committed calibration, never a user cache.
    autotune.set_table(autotune.load_table(autotune.REPO_DEFAULT_PATH))
    if device.type == "cuda":
        from repro_torch.kernels import build

        build.library()
        torch.cuda.init()
    marks.append(("kernels_and_context", time.perf_counter()))
    pool, inputs, drawn = _draw(op, config, traffic, seed, device)
    trace.sync(device)
    marks.append(("pool", time.perf_counter()))
    plan = op.plan(tuple(pool[0].shape), config, traffic)
    engine = SolverEngine(plan, device=device)
    for stack in pool:
        op.call(engine, stack, traffic, inputs)
    trace.sync(device)
    marks.append(("warm_calls", time.perf_counter()))
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    setup_s = time.perf_counter() - t_start

    kept = []  # (pool index, result) of every call made after set-up
    record = {"setup_s": setup_s}
    if not trace_on:
        lat = []
        t0 = t1 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            idx = len(lat) % pool_n
            ts = time.perf_counter()
            out = op.call(engine, pool[idx], traffic, inputs)
            trace.sync(device)
            t1 = time.perf_counter()
            lat.append(t1 - ts)
            kept.append((idx, out))
        record.update(latencies_s=lat, matrices_per_call=b, window_s=t1 - t0)
        calls = len(lat)
    else:
        progs = op.programs(engine, plan, traffic)
        n_traced = int(traffic["trace_calls"])

        def loop():
            outs = []
            for i in range(n_traced):
                outs.append((i % pool_n,
                             op.call(engine, pool[i % pool_n], traffic,
                                     inputs)))
                trace.sync(device)
            return outs

        with trace.annotated(*progs):
            outs, events = trace.profile(loop, device)
        kept += outs
        reduced = trace.reduce(events)
        del events
        stage_ms = {}
        n_split = int(traffic["split_calls"])

        def walk(prog, *args):
            return trace.split(prog, args, device, stage_ms)

        for i in range(n_split):
            kept.append((i % pool_n, op.split(engine, pool[i % pool_n],
                                              inputs, traffic, walk)))
        levels = roofline.LEVELS[precision]
        record.update(
            reduced, stage_ms=stage_ms, split_calls=n_split, calls=n_traced,
            flops=n_traced * b * op.flops_per_matrix(config, traffic, levels),
            config=config, traffic=traffic, precision=precision,
            levels=levels, device_type=device.type)
        calls = n_traced + n_split
    trace.sync(device)
    launches = {name: fn.launches / max(calls, 1)
                for name, fn in counters.items() if fn.launches}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    metrics = {}
    for spec in metrics_for(cell, trace_on):
        value = load_reader(cell, spec["name"]).read(record)
        if value is not None:
            metrics[spec["name"]] = {"value": float(value),
                                     "unit": spec["unit"]}

    # The comparison, once the window has closed and the peak is read.
    del engine
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, failed, compared = _judge(op, pool, kept, traffic, b, device,
                                      drawn)
    correct = compared > 0 and failed == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": int(cell["entry"]["chips"]),
           "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": calls * b,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace_on:
        dev["busy_s"] = record["busy_s"]
        dev["window_s"] = record["window_s"]
        result["breakdown"] = record["breakdown"]
    result["checks"] = checks
    info = {"workload": cell["name"], "seed": seed, "calls": calls,
            "setup_s": setup_s, "plan": _plan_pick(plan, config, traffic),
            "launches_per_call": launches, "memory_peak_bytes": int(peak),
            "setup_parts_s": {name: t - prev for (name, t), (_, prev)
                              in zip(marks, [("start", t_start)] + marks)}}
    if not trace_on and lat:
        ms = sorted(x * 1e3 for x in lat)
        info["call_ms_min_median_max"] = [ms[0], ms[len(ms) // 2], ms[-1]]
    if trace_on:
        staged = sum(k["stage"] is not None for k in record["kernels"])
        info["device_ops_in_a_stage"] = [staged, len(record["kernels"])]
        info["stage_ms"] = {key: ms / max(n_split, 1)
                            for key, ms in stage_ms.items()}
    return {"result": result, "info": info}


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        f"not read (exit {out.returncode})")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = load_cell(ROOT, args.workload)
    import torch

    chips = int(cell["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell needs {chips} CUDA card(s); this process "
              f"sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    import repro_torch

    if not Path(repro_torch.__file__).resolve().is_relative_to(ROOT / "src"):
        print(f"bench: repro_torch was loaded from {repro_torch.__file__}, "
              f"not from this checkout's src/", file=sys.stderr)
        return 3

    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), T_START)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if loaded:
        print(f"bench: modules that may not be loaded: {loaded}",
              file=sys.stderr)
        return 4
    out["info"]["card"] = _card()
    print("bench info " + json.dumps(out["info"]), flush=True)
    result = out["result"]
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
