"""The example twins (``examples/torch_*.py``): each runs once at a small
size with ``--device cpu`` (the kernels' plain versions) and exits 0, and
each refuses to run when it finds no card and was not given ``--device``.
On the card they are phase 18 (a) of ``chip_smoke.py``."""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"

#: Each example's small CPU run (its arguments after ``--device cpu``).
RUNS = {
    "torch_quickstart": [],
    "torch_spectral_monitor": ["--steps", "12"],
    "torch_distributed_eei": ["--data", "2"],
    "torch_serve_lm": ["--batch", "2", "--gen", "4", "--mesh", "2x1x1"],
    "torch_train_lm": ["--small", "--steps", "2", "--batch", "2", "--seq",
                       "16", "--mesh", "2x1x1"],
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The examples' tensors are tiny: one thread, so that parallel test
    workers do not each start one a core."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def load(name: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


#: What each example's run prints (the trainer: logs).
SAYS = {
    "torch_quickstart": "eei_tridiag  magnitude table err",
    "torch_spectral_monitor": "warm-path",
    "torch_distributed_eei": "term-sharded |v[32,5]|^2",
    "torch_serve_lm": "[[",
    "torch_train_lm": "done: 2 steps",
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_runs_on_the_cpu(name, tmp_path, monkeypatch, capsys,
                                 caplog):
    monkeypatch.chdir(tmp_path)  # the trainer's checkpoints
    with caplog.at_level("INFO", logger="repro_torch"):
        assert load(name).main(["--device", "cpu", *RUNS[name]]) == 0
    assert SAYS[name] in capsys.readouterr().out + caplog.text


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_without_a_card_needs_device_cpu(name, tmp_path,
                                                 monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    monkeypatch.chdir(tmp_path)
    with pytest.raises((SystemExit, RuntimeError)) as exc:
        load(name).main(RUNS[name])
    assert exc.type is RuntimeError or exc.value.code not in (0, None)
