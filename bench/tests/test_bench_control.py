"""The control of every cell reads not correct.

The control is the program's own path one precision down: the
configuration's float64 stacks through a float32 plan, the step that would
tempt a later change.  On the CPU it runs at the small cells' size; on the
card (``-m cuda``) at each cell's own size, on three seeds, where the
program's float64 path on the same stacks passes.
"""

import pytest
import torch

from conftest import ROOT

from bench import readings, run


def _fails(worst: dict, limits: dict) -> bool:
    return any(not v <= limits[name] for name, v in worst.items())


@pytest.mark.parametrize("name", ["solve.small", "topk4.small"])
def test_control_of_a_small_cell_fails_its_limits(small_root, name):
    cell = run.load_cell(small_root, name)
    limits = cell["traffic"]["limits"]
    control = readings.readings(cell, 31, "float32", 2, "cpu")
    assert _fails(control, limits), control
    sound = readings.readings(cell, 31, "float64", 2, "cpu")
    assert not _fails(sound, limits), sound


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  run.load_manifest(ROOT)["workloads"]])
def test_control_at_the_cells_size_fails_its_limits(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = run.load_cell(ROOT, name)
    limits = cell["traffic"]["limits"]
    device = torch.device("cuda", 0)
    for seed in (41, 42, 43):
        control = readings.readings(cell, seed, "float32", 2, device)
        assert _fails(control, limits), (seed, control)
    sound = readings.readings(cell, 41, "float64", 2, device)
    assert not _fails(sound, limits), sound
