"""The ``update`` op (``bench/ops/update.py``) on the CPU at a small n: a
session's rank-1 stream through ``bench/run.py``, judged against the plain
reference of each compared call; the two controls of
``bench/update_controls.py``, which must read not correct; the seeded mask
of compared calls; the three session readers and the two readers of the
update program's stage split.

The cell and its configuration are new files in a copy of the small
checkout."""

import dataclasses
import json
import shutil

import pytest
import torch

from conftest import SMALL_TOPK_CONFIG

from bench import readings, run, update_controls
from repro_torch import SessionConfig, tracing

UPDATE_CELL = "update.spiked_n600_f64"
SMALL_CELL = "update.small"
METRICS = ("session_fast_ms", "session_resolve_ms",
           "session_resolves_per_kupdate")
#: The readers of the update program's stage split.
SPLIT_METRICS = ("warm_project_ms", "tridiag_bracketed_ms")
#: n = 260 and m_keep = 8 plan the Krylov chain, as the real cell does.
SESSION_CONFIG = dict(SMALL_TOPK_CONFIG, name="small_session_n260_f64",
                      session=dataclasses.asdict(SessionConfig()))
#: The real cell's traffic at a small size: a window of 8, a re-solve
#: every 25 updates, one compared call in 4.
TRAFFIC = {"config": SESSION_CONFIG["name"], "op": "update", "k": 4,
           "largest": True, "m": 128, "b": 1, "pool": 2, "loop": "closed",
           "window": 8, "rho_per_fro": 0.01, "bank": 64,
           "compare_one_in": 4, "trace_calls": 16, "split_calls": 2}
@pytest.fixture(scope="module")
def update_root(small_root, tmp_path_factory):
    """The small checkout with the session configuration and a small
    update cell added as new files and entries."""
    root = tmp_path_factory.mktemp("update")
    shutil.copytree(small_root / "bench", root / "bench")
    path = f"bench/configs/{SESSION_CONFIG['name']}.json"
    (root / path).write_text(json.dumps(SESSION_CONFIG))
    manifest = json.loads((small_root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": SESSION_CONFIG["name"],
                                "source": "test", "file": path,
                                "reduced": [], "why": "small"})
    limits = json.loads((run.ROOT / "bench" / "workloads"
                         / f"{UPDATE_CELL}.json").read_text())["limits"]
    traffic = dict(TRAFFIC, traffic="update.w8", limits=limits)
    (root / "bench" / "workloads" / f"{SMALL_CELL}.json").write_text(
        json.dumps(traffic))
    manifest["workloads"].append({
        "name": SMALL_CELL, "config": traffic["config"],
        "traffic": traffic["traffic"], "chips": 1, "why": "small"})
    for metric in manifest["per_layer"]:
        if metric["name"] in METRICS + SPLIT_METRICS:
            metric["workloads"].append(SMALL_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


def _run(root, name, trace_on, seed=2**33 + 11, seconds=1.0):
    return run.run_cell(run.load_cell(root, name), seed, seconds, trace_on,
                        "cpu", 0.0)


@pytest.mark.parametrize("trace_on", [False, True])
def test_the_update_op_reads_correct(update_root, trace_on):
    out = _run(update_root, SMALL_CELL, trace_on)
    result = out["result"]
    assert result["correct"] is True and result["failed"] == 0
    assert out["info"]["plan"]["method"] == "eei_krylov"
    assert result["attempted"] == out["info"]["calls"] >= 3
    for c in result["checks"].values():
        assert c["value"] is not None and c["value"] <= c["limit"]
    json.dumps(result, allow_nan=False)
    if trace_on:
        # The split walks the update program's stages, and their readers
        # read them.
        stage_ms = out["info"]["stage_ms"]
        assert {"reduce/warm_project", "spectrum/tridiag_bracketed",
                "recover/update_select"} <= set(stage_ms)
        metrics = result["metrics"]
        assert metrics["warm_project_ms"]["value"] == pytest.approx(
            stage_ms["reduce/warm_project"])
        assert metrics["tridiag_bracketed_ms"]["value"] == pytest.approx(
            stage_ms["spectrum/tridiag_bracketed"])


@pytest.mark.parametrize("kind, failing", [("stale", "eig_err"),
                                           ("float32", "mat_err"),
                                           ("reference32", "mat_err")])
def test_the_controls_read_not_correct(update_root, kind, failing):
    """``bench/update_controls.py``'s controls: the window from before each
    update, the session under the float32 plan, and the plain reference in
    float32."""
    cell = run.load_cell(update_root, SMALL_CELL)
    line = update_controls.reading(cell, 2**33 + 11, 1.0, kind, "cpu")
    assert line["correct"] is False and line["failed"] > 0
    assert line[failing] > 10 * cell["traffic"]["limits"][failing]


def test_a_call_without_drawn_inputs_is_a_stream_of_one_step(update_root):
    """``bench/readings.py`` (the card test of every cell's float32 plan)
    draws no inputs: the op then opens a session and updates it once, and
    the float32 plan fails the cell's limits where float64 passes."""
    cell = run.load_cell(update_root, SMALL_CELL)
    limits = cell["traffic"]["limits"]
    sound = readings.readings(cell, 41, "float64", 2, "cpu")
    assert all(v <= limits[name] for name, v in sound.items())
    control = readings.readings(cell, 41, "float32", 2, "cpu")
    assert control["mat_err"] > 10 * limits["mat_err"]


def test_a_call_left_out_by_the_seeded_mask_is_not_judged(update_root,
                                                          monkeypatch):
    """Only the first kept call on each session and the drawn place of
    each block of ``compare_one_in`` are judged; the others return None,
    which the comparison never reads."""
    asked, drawn = [], []
    load_op = run.load_op

    def load(cell):
        op = load_op(cell)
        reference_for, draw = op.reference_for, op.draw

        def spied_reference_for(idx, ordinal, pool, inputs, traffic):
            asked.append((idx, ordinal))
            return reference_for(idx, ordinal, pool, inputs, traffic)

        def spied_draw(*args):
            inputs = draw(*args)
            drawn.append(inputs)
            return inputs

        op.reference_for, op.draw = spied_reference_for, spied_draw
        return op

    monkeypatch.setattr(run, "load_op", load)
    out = _run(update_root, SMALL_CELL, True)
    assert out["result"]["correct"] is True
    pool = TRAFFIC["pool"]
    calls = (TRAFFIC["trace_calls"] + TRAFFIC["split_calls"]) // pool
    every = TRAFFIC["compare_one_in"]
    offsets = drawn[0]["offsets"]
    expect = [(idx, o) for o in range(1, calls + 1) for idx in (0, 1)
              if o == 1 or o % every == offsets[idx][o // every]]
    assert asked == expect
    assert len(asked) < TRAFFIC["trace_calls"]


def _record():
    return {"device_type": "cuda", "traffic": TRAFFIC, "calls": 4,
            "split_calls": 0, "stage_ms": {}}


def _readers(root, names=METRICS):
    cell = run.load_cell(root, SMALL_CELL)
    return {name: run.load_reader(cell, name) for name in names}


def test_the_readers_read_none_without_the_session_spans_and_counters(
        update_root):
    readers = _readers(update_root)
    tracing.reset()
    assert {name: r.read(_record()) for name, r in readers.items()} == {
        name: None for name in METRICS}
    # A re-solve counted but no fast update: still None, not 0.
    tracing.count("session_resolve")
    assert readers["session_resolves_per_kupdate"].read(_record()) is None
    tracing.reset()


def test_the_readers_read_the_spans_and_counters_of_a_stream(update_root):
    """On the CPU the readers return None by design (no device waits);
    handed a record that names the card, they read what a stream under a
    profiler left."""
    from repro_torch import Rank1Update, SolverEngine, SolverPlan

    torch.manual_seed(0)
    g = torch.randn(24, 24, dtype=torch.float64)
    a = g + g.T
    engine = SolverEngine(SolverPlan(method="eei_tridiag",
                                     precision="float64"), device="cpu")
    tracing.reset()
    session = engine.open_session(a, 2, True, SessionConfig(max_updates=2))
    with torch.profiler.profile():
        for _ in range(4):
            engine.update(session, Rank1Update(0.1 * torch.randn(
                24, dtype=torch.float64), 1))
    counts = tracing.counts()
    assert counts["session_fast_update"] + counts["session_resolve"] == 4
    got = {name: r.read(_record())
           for name, r in _readers(update_root).items()}
    tracing.reset()
    assert got["session_fast_ms"] > 0 and got["session_resolve_ms"] > 0
    resolves = counts["session_resolve"]
    calls = TRAFFIC["pool"] + 4
    assert got["session_resolves_per_kupdate"] == 1e3 * resolves / calls


def test_the_split_readers_read_none_without_the_update_program(
        update_root):
    """A split that walked only a top-k program (a re-solve), or none, has
    no update stage to read."""
    readers = _readers(update_root, SPLIT_METRICS)
    assert {name: r.read(_record()) for name, r in readers.items()} == {
        name: None for name in SPLIT_METRICS}
    record = dict(_record(), split_calls=1,
                  stage_ms={"reduce/krylov": 5.0, "recover/tridiag_signs": 1.0})
    assert {name: r.read(record) for name, r in readers.items()} == {
        name: None for name in SPLIT_METRICS}
    record["stage_ms"].update({"reduce/warm_project": 6.0,
                               "spectrum/tridiag_bracketed": 3.0})
    record["split_calls"] = 2
    assert {name: r.read(record) for name, r in readers.items()} == {
        "warm_project_ms": 3.0, "tridiag_bracketed_ms": 1.5}
