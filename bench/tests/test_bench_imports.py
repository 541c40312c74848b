"""What the harness and the reference load, each in a fresh process, and
what the command does without a card or without the program."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

_HARNESS = f"""
import json, sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
import importlib.util, pathlib
from bench import run, ensembles, flops, reference, roofline, trace, readings
import repro_torch
from repro_torch import SolverEngine, plan_for
for kind in ("ops", "metrics"):
    folder = pathlib.Path({str(ROOT)!r}) / "bench" / kind
    for path in sorted(folder.glob("*.py")):
        run._load(path, "loaded_" + kind + "_" + path.stem.replace(".", "_"))
print(json.dumps(sorted(sys.modules)))
"""

_REFERENCE = f"""
import json, sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from bench import reference
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _top_level(modules) -> set:
    return {m.split(".")[0] for m in modules}


def test_harness_loads_no_jax_and_no_jax_package():
    top = _top_level(_modules(_HARNESS))
    assert "repro_torch" in top
    assert not top & set(FORBIDDEN), sorted(top & set(FORBIDDEN))


def test_reference_loads_nothing_of_the_program():
    top = _top_level(_modules(_REFERENCE))
    assert not top & (set(FORBIDDEN) | {"repro_torch"})


def test_top_level_names_are_compared_whole():
    assert "repro_torch" not in FORBIDDEN
    assert _top_level(["repro_torch.engine", "repro.engine"]) & set(
        FORBIDDEN) == {"repro"}


def _command(cwd, *extra):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "topk8.spiked_n600_f64.b256", "--seed", "3", "--seconds", "1",
         "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_command_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this process sees a CUDA card")
    out = _command(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_command_without_the_program_fails_and_prints_no_result(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
