"""A run with the timed path broken underneath reads ``correct`` false.

The faults are planted in the program object the engine calls
(``Program.__call__``), below the harness, and the rest of the run is the
harness's own on the CPU.  Each fault this benchmark's cells can have:

* ``stale_state``: every call returns the previous call's result, as a
  step that leaves its state unchanged would;
* ``half_batch``: half of the stack is left out and the other half's
  results stand in for it;
* ``altered_answer``: one answer is altered where it is produced (one
  component of one eigenvector).

The cells run on one card, so no exchange between cards can be left out.
"""

import pytest
import torch

from bench import run
from repro_torch.engine import engine as engine_mod
from repro_torch.engine.engine import SolveResult, TopkResult


def _stale(call):
    prev = {}

    def broken(self, a):
        out = call(self, a)
        stale = prev.get(id(self), out)
        prev[id(self)] = out
        return stale

    return broken


def _half_batch(call):
    def broken(self, a):
        half = call(self, a[: a.shape[0] // 2])
        return type(half)(*(torch.cat([x, x]) for x in half))

    return broken


def _altered(call):
    def broken(self, a):
        out = call(self, a)
        if isinstance(out, SolveResult):
            mags = out.magnitudes.clone()
            j = int(mags[0, -1].argmax())
            moved = 0.5 * mags[0, -1, j]
            mags[0, -1, j] -= moved
            mags[0, -1, (j + 1) % mags.shape[-1]] += moved
            return SolveResult(out.eigenvalues, mags)
        assert isinstance(out, TopkResult)
        vecs = out.vectors.clone()
        j = int(vecs[0, -1].abs().argmax())
        vecs[0, -1, j] = -vecs[0, -1, j]
        return TopkResult(out.eigenvalues, vecs)

    return broken


FAULTS = {"stale_state": _stale, "half_batch": _half_batch,
          "altered_answer": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ["solve.small", "topk4.small"])
def test_a_broken_timed_path_reads_not_correct(small_root, monkeypatch,
                                               name, fault):
    monkeypatch.setattr(engine_mod.Program, "__call__",
                        FAULTS[fault](engine_mod.Program.__call__))
    cell = run.load_cell(small_root, name)
    result = run.run_cell(cell, 17, 0.01, False, "cpu", 0.0)["result"]
    assert result["correct"] is False
    assert result["failed"] >= 1
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in result["checks"].values())
