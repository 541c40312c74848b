"""Roofline report of the port's dry run, the twin of
``benchmarks/roofline_report.py``.

    PYTHONPATH=src python tools/roofline_report.py [--dir artifacts/dryrun_torch]

Reads ``<dir>/*__pod.json`` (written by ``python -m
repro_torch.launch.dryrun ... --roofline``) into rows of (cell,
bound_time_us, "dominant=<term> frac=<roofline fraction> ...") and prints
them as CSV.  The terms are the dry run's counts over the H100 constants
(``repro_torch.roofline.constants``): no time on any device is measured
here.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys

ART_DIR = "artifacts/dryrun_torch"


@dataclasses.dataclass
class Row:
    name: str
    us: float
    derived: str = ""

    def csv(self) -> str:
        return f"{self.name},{self.us:.1f},{self.derived}"


def load_cells(art_dir: str = ART_DIR, pattern: str = "*__pod.json") -> list:
    out = []
    for path in sorted(glob.glob(os.path.join(art_dir, pattern))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def run(art_dir: str = ART_DIR) -> list[Row]:
    rows = []
    for cell in load_cells(art_dir):
        name = f"roofline/{cell['arch']}/{cell['shape']}"
        if cell.get("status") == "skipped":
            rows.append(Row(name, 0.0, f"skipped: {cell.get('reason', '')}"))
            continue
        rl = cell.get("roofline")
        if not rl:
            continue
        bound_us = max(rl["t_compute_s"], rl["t_memory_s"],
                       rl["t_collective_s"]) * 1e6
        rows.append(Row(
            name, bound_us,
            f"dominant={rl['dominant']}"
            f" frac={rl['roofline_fraction']:.3f}"
            f" useful={rl['useful_flops_ratio']:.3f}"
            f" tC={rl['t_compute_s'] * 1e3:.2f}ms"
            f" tM={rl['t_memory_s'] * 1e3:.2f}ms"
            f" tX={rl['t_collective_s'] * 1e3:.2f}ms"))
    if not rows:
        rows.append(Row("roofline/missing", 0.0,
                        "run: python -m repro_torch.launch.dryrun --all "
                        "--roofline"))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=ART_DIR,
                    help="the dry run's artifact directory")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    for row in run(args.dir):
        print(row.csv())
    return 0


if __name__ == "__main__":
    sys.exit(main())
