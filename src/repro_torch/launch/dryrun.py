"""Multi-pod dry run, the twin of ``python -m repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \
        --shape decode_32k [--multipod] [--roofline] [--no-full]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--roofline]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --paper-eei \
        [--eei-n 4096] [--eei-reduce sum|dot|dot_bf16]

Builds each (arch x shape) cell's program on ``repro``'s production mesh
(``make_production_mesh``: 16x16, or 2x16x16 with ``--multipod``) and runs
it on ``"meta"`` tensors, counting its memory per position, FLOPs, bytes
and collective bytes (``launch.dryrun_lib``); ``--roofline`` adds the
roofline terms on the H100 constants (``roofline.constants``).  It writes
one JSON artifact a cell under ``--out``.

The dry run runs on no device by design, as ``repro``'s runs on
placeholder host devices: a ``"meta"`` tensor has a shape and no storage,
so the launchers' rule of running on the card unless asked for the CPU
does not apply, and no ``XLA_FLAGS``-like device count is needed.  One
process drives all 256 (512) positions, so a production cell takes
minutes; ``--all`` runs every cell.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import dryrun_lib
from repro_torch.launch import mesh as mesh_lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Multi-pod dry run: build and count every "
                    "(arch x shape x mesh) cell on meta tensors.")
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multipod", action="store_true",
                    help="use the (pod=2, data=16, model=16) mesh")
    ap.add_argument("--roofline", action="store_true",
                    help="also run the L-extrapolation cells for roofline "
                    "terms")
    ap.add_argument("--no-full", action="store_true",
                    help="skip the full-depth run (roofline runs only)")
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--paper-eei", action="store_true",
                    help="count the paper's own EEI workload on the mesh")
    ap.add_argument("--eei-n", type=int, default=4096)
    ap.add_argument("--eei-reduce", default="sum",
                    choices=["sum", "dot", "dot_bf16"],
                    help="numerator reduction form (dot = contraction with "
                    "a ones-vector)")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)

    mesh = mesh_lib.make_production_mesh(multi_pod=args.multipod)

    if args.paper_eei:
        result = dryrun_lib.dryrun_paper_eei(mesh, n=args.eei_n,
                                             reduce=args.eei_reduce)
        result["shape"] = f"eei_n{args.eei_n}_{args.eei_reduce}"
        path = dryrun_lib.save_artifact(result, args.out)
        rl = result["roofline"]
        print(f"[OK     ] paper-eei n={args.eei_n} chips={result['chips']}"
              f" dominant={rl['dominant']}"
              f" tC={rl['t_compute_s']:.4f}s tM={rl['t_memory_s']:.4f}s"
              f" tX={rl['t_collective_s']:.4f}s -> {path}")
        return 0
    cells = (dryrun_lib.all_cells() if args.all
             else [(args.arch, args.shape)])
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("--arch and --shape are required unless --all")

    failures = 0
    for arch, shape in cells:
        t0 = time.monotonic()
        tag = f"{arch} x {shape} x {'multipod' if args.multipod else 'pod'}"
        try:
            result = dryrun_lib.dryrun_cell(
                arch, shape, mesh,
                roofline=args.roofline, full_compile=not args.no_full)
        except Exception:
            failures += 1
            print(f"[FAIL] {tag}")
            traceback.print_exc()
            result = {"arch": arch, "shape": shape, "status": "failed",
                      "chips": mesh.size,
                      "error": traceback.format_exc(limit=3)}
            dryrun_lib.save_artifact(result, args.out)
            continue
        path = dryrun_lib.save_artifact(result, args.out)
        dt = time.monotonic() - t0
        status = result["status"]
        line = f"[{status.upper():7s}] {tag}  ({dt:.1f}s) -> {path}"
        if status == "ok" and "full" in result:
            mem = result["full"].get("memory", {})
            cost = result["full"].get("cost", {})
            coll = result["full"].get("collectives", {})
            line += (f"\n  flops={cost.get('flops', 0):.3e}"
                     f" bytes={cost.get('bytes accessed', 0):.3e}"
                     f" coll={coll.get('total', 0):.3e}"
                     f" args={mem.get('argument_size_in_bytes', 0):.3e}B"
                     f" temp={mem.get('temp_size_in_bytes', 0):.3e}B")
            print(line)
            print("  memory_analysis:", json.dumps(mem))
            print("  cost_analysis(flops)=", cost.get("flops"))
        else:
            print(line)
            if status == "skipped":
                print("  reason:", result.get("reason"))
    print(f"done: {len(cells)} cells, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
