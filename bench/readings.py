"""The readings that a cell's limits are set from, at the cell's own size.

    python3 bench/readings.py --workload <cell> --seeds 11,12,... \\
        --control-seeds 21,22,23 [--calls 4]

For each seed the program runs ``--calls`` calls of the cell's timed path
(the public call under the cell's plan, cycling through the seed's pool)
and each result is compared with the plain reference.  The control is the
program's own path one precision down (the configuration's float64 stacks
through a float32 plan, as a later change might be tempted to run them),
compared with the same float64 reference.  One JSON line per seed and a
summary: the largest reading of the program and the smallest of the
control for every compared number.  The benchmark's runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "bench":
    sys.path.pop(0)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: The precision a control runs in: the nearest below the configuration's.
LOWER = {"float64": "float32"}


def readings(cell: dict, seed: int, precision: str, calls: int,
             device) -> dict:
    """The compared numbers (largest over the calls) of ``calls`` calls of
    the cell's timed path under a plan of ``precision``, on the pool of
    ``seed``."""
    import torch

    from repro_torch import SolverEngine, plan_for
    from repro_torch.engine import autotune

    from bench import ensembles, run

    op = run.load_op(cell)
    traffic = cell["traffic"]
    autotune.set_table(autotune.load_table(autotune.REPO_DEFAULT_PATH))
    pool = ensembles.draw(cell["config"], traffic, seed, device)
    engine = SolverEngine(plan_for(tuple(pool[0].shape),
                                   k=op.plan_k(traffic), precision=precision),
                          device=device)
    outs = [(i % len(pool), op.call(engine, pool[i % len(pool)], traffic))
            for i in range(calls)]
    refs = {}
    worst = {name: 0.0 for name in op.CHECKS}
    for idx, out in outs:
        if idx not in refs:
            refs[idx] = op.reference(pool[idx], traffic)
        for name, x in op.compare(out, refs[idx]).items():
            finite = bool(torch.isfinite(x).all())
            worst[name] = max(worst[name],
                              float(x.amax()) if finite else float("inf"))
    return worst


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--calls", type=int, default=4)
    args = parser.parse_args(argv)

    import torch

    from bench import run

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 3
    cell = run.load_cell(ROOT, args.workload)
    device = torch.device("cuda", 0)
    precision = cell["config"]["precision"]
    summary = {"program": {}, "control": {}}
    for kind, seeds, prec in (
            ("program", args.seeds, precision),
            ("control", args.control_seeds, LOWER[precision])):
        for seed in [int(s) for s in seeds.split(",") if s]:
            worst = readings(cell, seed, prec, args.calls, device)
            print(json.dumps({"workload": args.workload, "kind": kind,
                              "precision": prec, "seed": seed, **worst}),
                  flush=True)
            agg = summary[kind]
            pick = max if kind == "program" else min
            for name, v in worst.items():
                agg[name] = pick(agg.get(name, v), v)
            torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
