"""The port stands alone: it imports neither jax nor repro, and it does not
carry on silently on the CPU when no card is there."""

import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = r"""
import importlib, pkgutil, sys
import torch
import repro_torch

names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "repro"
                or m.startswith("repro."))
assert not leaked, leaked
print("modules", len(names))

torch.cuda.is_available = lambda: False
from repro_torch import SolverEngine
try:
    SolverEngine()
except RuntimeError as exc:
    assert "device='cpu'" in str(exc), exc
else:
    raise AssertionError("SolverEngine() ran without a card")
SolverEngine(device="cpu")
print("ok")
"""


def test_port_imports_no_jax_or_repro_and_needs_a_card_by_default():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.split()
    assert lines[-1] == "ok"
    assert int(lines[1]) >= 20  # every module of the port was imported
