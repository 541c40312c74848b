"""The readings that the ``update`` cell's limits are set from.

    python3 bench/update_controls.py --seeds 11,12,13 [--seconds 20] \\
        [--workload update.spiked_n600_f64] [--kinds program,float32]

For each seed the cell runs as the benchmark runs it (``run.run_cell``
with ``--trace 0`` for ``--seconds``), then once as each control (or only
the ``--kinds`` named):

* ``stale``: each compared call answers the window from before its update
  (with the updated matrix), as a session that failed to refresh would;
* ``float32``: the session under the float32 plan, the nearest precision
  below the configuration's;
* ``reference32``: the plain reference computed in float32 (``eigh`` of
  the session's matrix rounded to float32, and that matrix) in place of
  each compared answer.

One JSON line a run (the largest reading of each compared number, the
compared calls, ``correct``) and a summary: the program's largest reading
and each control's smallest, for every compared number.  The benchmark's
runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "bench":
    sys.path.pop(0)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _stale(op):
    call = op.call

    def stale_call(engine, stack, traffic, inputs):
        stream = inputs["streams"].get(id(stack))
        before = stream["session"].result() if stream else None
        out = call(engine, stack, traffic, inputs)
        return out if out is None or before is None else (before, out[1])

    op.call = stale_call
    return op


def _float32(op):
    from repro_torch import plan_for

    op.plan = lambda shape, config, traffic: plan_for(
        shape, k=op.plan_k(traffic), precision="float32")
    return op


def _reference32(op):
    import torch

    from repro_torch.engine.engine import TopkResult

    call = op.call

    def reference32_call(engine, stack, traffic, inputs):
        out = call(engine, stack, traffic, inputs)
        if out is None:
            return None
        a = out[1].to(torch.float32)
        lam, v = torch.linalg.eigh(a)
        k = int(traffic["k"])
        sel = slice(-k, None) if traffic["largest"] else slice(0, k)
        return TopkResult(lam[sel], v[:, sel].T), a

    op.call = reference32_call
    return op


CONTROLS = {"program": lambda op: op, "stale": _stale, "float32": _float32,
            "reference32": _reference32}


def reading(cell: dict, seed: int, seconds: float, kind: str,
            device) -> dict:
    """One run of ``cell`` with the op as ``kind`` makes it."""
    import time

    from bench import run

    load_op = run.load_op
    run.load_op = lambda c: CONTROLS[kind](load_op(c))
    try:
        out = run.run_cell(cell, seed, seconds, False, device,
                           time.perf_counter())
    finally:
        run.load_op = load_op
    result = out["result"]
    return {"kind": kind, "seed": seed, "correct": result["correct"],
            "failed": result["failed"], "calls": out["info"]["calls"],
            **{name: c["value"] for name, c in result["checks"].items()}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", default="update.spiked_n600_f64")
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=20.0)
    parser.add_argument("--kinds", default=",".join(CONTROLS))
    args = parser.parse_args(argv)

    import torch

    from bench import run

    if not torch.cuda.is_available():
        print("update_controls: no CUDA card", file=sys.stderr)
        return 3
    cell = run.load_cell(ROOT, args.workload)
    device = torch.device("cuda", 0)
    kinds = [kind for kind in args.kinds.split(",") if kind]
    summary = {kind: {} for kind in kinds}
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        for kind in kinds:
            line = reading(cell, seed, args.seconds, kind, device)
            print(json.dumps({"workload": args.workload, **line}),
                  flush=True)
            pick = max if kind == "program" else min
            for name, value in line.items():
                if name in cell["traffic"]["limits"]:
                    value = float("inf") if value is None else value
                    agg = summary[kind]
                    agg[name] = pick(agg.get(name, value), value)
            torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
