"""Fixtures of the benchmark's own tests: the checkout on ``sys.path`` and a
copy of the benchmark with two small cells added as new files, which runs
on the CPU through the plain versions of the kernels."""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for path in (str(ROOT / "src"), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)
# The small cells' tensors are too small to share out over threads, and a
# busy host makes idle threads spin.
torch.set_num_threads(1)

#: Small cells on a small configuration: n above the planner's eigh
#: crossover for solve, and n >= 256 with k <= n / 64 so that top-k plans
#: the windowed Krylov chain, as the real cells do.
SMALL_CONFIG = {"name": "small_spiked_f64", "ensemble": "spiked_wigner",
                "n": 136, "spikes": 4, "theta": [2.0, 6.0],
                "precision": "float64", "reduced": [], "source": "test"}
SMALL_TOPK_CONFIG = dict(SMALL_CONFIG, name="small_spiked_n260_f64", n=260)
SMALL_CELLS = {
    "solve.small": {"config": "small_spiked_f64", "traffic": "solve.b2",
                    "op": "solve", "b": 2, "pool": 2, "loop": "closed",
                    "trace_calls": 1, "split_calls": 1,
                    "limits": {"eig_err": 1e-9, "mag_err": 1e-4}},
    "topk4.small": {"config": "small_spiked_n260_f64", "traffic": "topk4.b2",
                    "op": "topk", "k": 4, "largest": True, "m": 128, "b": 2,
                    "pool": 2, "loop": "closed", "trace_calls": 1, "split_calls": 1,
                    "limits": {"eig_err": 1e-9, "vec_err": 1e-4}},
}
#: A per-layer metric that exists only as a new file.
EXTRA_METRIC = '''"""Traced calls of the run (a test's extra metric)."""


def read(record):
    return record["calls"]
'''


@pytest.fixture(scope="session")
def small_root(tmp_path_factory) -> Path:
    """A copy of ``BENCHMARK.json`` and ``bench/`` with the small cells,
    their configurations and one extra per-layer metric added as new
    files and entries; no existing file of the copy is edited but the
    manifest."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for conf in (SMALL_CONFIG, SMALL_TOPK_CONFIG):
        path = f"bench/configs/{conf['name']}.json"
        (root / path).write_text(json.dumps(conf))
        manifest["configs"].append({"name": conf["name"], "source": "test",
                                    "file": path, "reduced": [],
                                    "why": "small"})
    for name, traffic in SMALL_CELLS.items():
        (root / "bench" / "workloads" / f"{name}.json").write_text(
            json.dumps(traffic))
        manifest["workloads"].append({
            "name": name, "config": traffic["config"],
            "traffic": traffic["traffic"], "chips": 1, "why": "small"})
        for metric in manifest["end_to_end"] + manifest["per_layer"]:
            if "workloads" in metric:
                metric["workloads"].append(name)
    (root / "bench" / "metrics" / "traced_calls.py").write_text(EXTRA_METRIC)
    manifest["per_layer"].append({
        "name": "traced_calls", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "whole call",
        "moves": "matrices_per_s", "workloads": list(SMALL_CELLS)})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root
