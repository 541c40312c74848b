"""The readers of the program's own spans and counters
(``bench/program_trace.py``): their values on synthetic program state,
None where the program recorded nothing or has no tracing module, and the
program's spans against the profiler's trace of the same call."""

import json
import sys

import pytest
import torch

from conftest import ROOT

from bench import run

import repro_torch
from repro_torch import SolverEngine, SolverPlan, tracing

NEW = ("host_syncs_per_call", "lanczos_sync_wait_ms", "lanczos_issue_ms",
       "recover_issue_ms")

#: A traced run's record: 2 warm-up calls (the pool), 4 traced, 2 split.
RECORD = {"device_type": "cuda", "traffic": {"pool": 2}, "calls": 4,
          "split_calls": 2}
COUNTS = {"host_sync": 8 * 276}
SPANS = {
    "stage/reduce/krylov": {"n": 4, "s": 2.4, "self_s": 0.2},
    "lanczos/step": {"n": 1024, "s": 2.0, "self_s": 1.2},
    "lanczos/sync": {"n": 1104, "s": 0.82, "self_s": 0.82},
    "stage/recover/tridiag_signs": {"n": 4, "s": 0.24, "self_s": 0.24},
    "stage/recover/shift_invert_map": {"n": 4, "s": 0.04, "self_s": 0.04},
}


def _read(name, record):
    cell = run.load_cell(ROOT, "topk8.spiked_n600_f64.b256")
    return run.load_reader(cell, name).read(record)


@pytest.fixture
def program_state(monkeypatch):
    monkeypatch.setattr(tracing, "counts", lambda: dict(COUNTS))
    monkeypatch.setattr(tracing, "spans",
                        lambda: {k: dict(v) for k, v in SPANS.items()})


def test_each_reader_on_synthetic_program_state(program_state):
    got = {name: _read(name, dict(RECORD)) for name in NEW}
    assert got["host_syncs_per_call"] == 276  # over all 8 calls
    assert got["lanczos_sync_wait_ms"] == pytest.approx(1e3 * 0.82 / 4)
    assert got["lanczos_issue_ms"] == pytest.approx(1e3 * 1.2 / 4)
    assert got["recover_issue_ms"] == pytest.approx(1e3 * 0.28 / 4)


def test_span_readers_read_nothing_where_no_span_was_closed(monkeypatch):
    """A solve runs no Lanczos, and a program counts no wait where it made
    none: no span is read, and the count reads 0."""
    for spans in ({}, {"stage/reduce/householder":
                       {"n": 1, "s": 1.0, "self_s": 1.0}}):
        monkeypatch.setattr(tracing, "counts", lambda: {"other": 3})
        monkeypatch.setattr(tracing, "spans", lambda: spans)
        got = {name: _read(name, dict(RECORD)) for name in NEW}
        assert got == {"host_syncs_per_call": 0.0,
                       "lanczos_sync_wait_ms": None,
                       "lanczos_issue_ms": None, "recover_issue_ms": None}


def test_readers_read_nothing_on_the_cpu(program_state):
    record = dict(RECORD, device_type="cpu")
    assert all(_read(name, record) is None for name in NEW)


def test_readers_read_nothing_from_a_program_without_tracing(monkeypatch):
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert all(_read(name, dict(RECORD)) is None for name in NEW)


def test_program_spans_agree_with_the_profiler_trace(tmp_path):
    """The program times each span inside the profiler's own event for it:
    the same names, as many of each, and no longer."""
    x = torch.randn(2, 96, 96, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(5))
    engine = SolverEngine(SolverPlan(method="eei_krylov", backend="cuda",
                                     krylov_m=64), device="cpu")
    a = x + x.transpose(-1, -2)
    engine.topk(a, 4)
    tracing.reset()
    with torch.profiler.profile() as prof:
        engine.topk(a, 4)
    spans = tracing.spans()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    trace = {}
    for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation":
            n, s = trace.get(e["name"], (0, 0.0))
            trace[e["name"]] = (n + 1, s + e["dur"] * 1e-6)
    assert {"lanczos/step", "lanczos/sync", "stage/reduce/krylov",
            "stage/recover/tridiag_signs"} <= set(spans)
    assert {name: e["n"] for name, e in spans.items()} == {
        name: trace[name][0] for name in spans}
    for name, e in spans.items():
        # Chrome trace times are whole microseconds.
        assert e["s"] <= trace[name][1] + 2e-6 * e["n"], name
        assert e["self_s"] <= e["s"]
