"""The benchmark's layout, yardstick and result line, on the CPU."""

import json
import re

import numpy as np
import pytest
import torch

from conftest import ROOT, SMALL_CONFIG

from bench import ensembles, flops, reference, roofline, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = ["command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"]
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.fixture(scope="module")
def manifest():
    return run.load_manifest(ROOT)


def test_manifest_keys_names_and_units(manifest):
    assert list(manifest) == TOP_KEYS
    assert manifest["command"][:2] == ["python3", "bench/run.py"]
    assert all(_line(w) for w in manifest["command"])
    assert manifest["paths"] == ["bench"]
    assert all(PATH.match(p) and ".." not in p for p in manifest["paths"])
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("bench/") and c["reduced"] == []
        names.append(c["name"])
    cells = []
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
        assert NAME.match(w["traffic"]) and w["config"] in names
        cells.append(w["name"])
    assert len({(w["config"], w["traffic"]) for w in manifest["workloads"]}
               ) == len(cells)
    assert {c["name"] for c in manifest["configs"]} == {
        w["config"] for w in manifest["workloads"]}
    e2e = manifest["end_to_end"]
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in SOURCES_E2E
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in e2e}
    for m in manifest["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert set(m["workloads"]) <= set(cells)
    for m in e2e + manifest["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names += cells
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_cell_config_op_and_metric_found_by_name(manifest):
    for w in manifest["workloads"]:
        cell = run.load_cell(ROOT, w["name"])
        config, traffic = cell["config"], cell["traffic"]
        assert config["reduced"] == [] and config["source"]
        assert config["ensemble"] in ensembles.ENSEMBLES
        assert config["precision"] in roofline.LEVELS
        op = run.load_op(cell)
        assert set(traffic["limits"]) == set(op.CHECKS)
        for key in ("b", "pool", "trace_calls", "split_calls"):
            assert int(traffic[key]) >= 1
        if traffic["op"] == "topk":
            assert 1 <= traffic["k"] <= traffic["m"] <= config["n"]
        for trace_on in (False, True):
            for m in run.metrics_for(cell, trace_on):
                assert callable(run.load_reader(cell, m["name"]).read)
        # Every cell reports set-up, another end-to-end metric and a
        # per-layer one.
        e2e = {m["name"] for m in run.metrics_for(cell, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.metrics_for(cell, True)
    for path in (ROOT / "bench" / "workloads").glob("*.json"):
        assert path.stem in {w["name"] for w in manifest["workloads"]}


def test_per_layer_metrics_move_a_metric_their_cells_report(manifest):
    layers = {}
    for m in manifest["per_layer"]:
        for name in m["workloads"]:
            cell = run.load_cell(ROOT, name)
            e2e = {e["name"] for e in run.metrics_for(cell, False)}
            assert m["moves"] in e2e
        layers.setdefault(m["layer"], []).append(m["name"])
    assert layers["reduce"] == ["householder_ms", "lanczos_ms"]


def test_generator_is_deterministic_per_seed():
    traffic = {"b": 3, "pool": 2}
    seed = 2**31 + 12345
    a = ensembles.draw(SMALL_CONFIG, traffic, seed, "cpu")
    b = ensembles.draw(SMALL_CONFIG, traffic, seed, "cpu")
    c = ensembles.draw(SMALL_CONFIG, traffic, seed + 1, "cpu")
    assert len(a) == 2 and a[0].shape == (3, 136, 136)
    assert a[0].dtype == torch.float64
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], a[1])
    assert all(torch.equal(x, x.transpose(-1, -2)) for x in a)


def test_outliers_land_at_theta_plus_inverse_theta():
    config = dict(SMALL_CONFIG, n=400, spikes=4)
    (stack,) = ensembles.draw(config, {"b": 4, "pool": 1}, 7, "cpu")
    lam = torch.linalg.eigvalsh(stack)
    theta = torch.linspace(2.0, 6.0, 4, dtype=torch.float64)
    want = theta + 1.0 / theta
    assert torch.all((lam[:, -4:] - want).abs() < 0.25)
    # The bulk ends near 2, clear of the lowest outlier at 2.5.
    assert torch.all(lam[:, -5] < 2.15) and torch.all(lam[:, 0] > -2.15)


def test_flop_and_byte_counts_of_small_cases():
    assert flops.sturm_ops(2, 3, 3, 4) == 2 * 3 * 4 * 3 * 8
    assert flops.sturm_bytes(2, 3, 3, 8) == 2 * (3 + 2 + 3) * 8
    assert flops.prod_diff_ops(1, 2, 2, 1) == 20
    assert flops.prod_diff_bytes(1, 2, 2, 1, 8) == (2 + 2 + 4) * 8
    # n = 3, L = 2: 72 reduce + 144 spectrum + 192 minors + 90 prod-diff
    # + 54 back-transform.
    assert flops.solve(3, 2) == pytest.approx(552)
    # n = 4, k = 1, m = 2, L = 2: 192 Lanczos + 32 window + 16 back.
    assert flops.topk(4, 1, 2, 2) == 240
    assert roofline.bound_s(34e12, 0, "float64") == pytest.approx(1.0)
    assert roofline.bound_s(1, 3.35e12, "float64") == pytest.approx(1.0)
    # The main cell's minor stack: 64 x 600 bands of 599 at 64 levels.
    ops = flops.sturm_ops(64 * 600, 599, 599, 64)
    assert ops / 34e12 == pytest.approx(0.2075, rel=1e-3)


def test_reference_agrees_with_numpy_eigh():
    gen = np.random.default_rng(3)
    x = gen.standard_normal((2, 12, 12))
    a = x + x.transpose(0, 2, 1)
    lam, v = np.linalg.eigh(a)
    ref = reference.solve(torch.from_numpy(a))
    np.testing.assert_allclose(ref["lam"].numpy(), lam, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ref["mags"].numpy(),
                               (v * v).transpose(0, 2, 1), atol=1e-12)
    top = reference.topk(torch.from_numpy(a), 3)
    np.testing.assert_allclose(top["lam"].numpy(), lam[:, -3:], atol=1e-12)
    dots = np.abs(np.einsum("bkn,bnk->bk", top["vecs"].numpy(), v[:, :, -3:]))
    np.testing.assert_allclose(dots, 1.0, atol=1e-12)


def test_comparisons_read_zero_on_the_reference_and_ignore_signs():
    gen = np.random.default_rng(4)
    x = torch.from_numpy(gen.standard_normal((2, 12, 12)))
    a = x + x.transpose(-1, -2)
    ref = reference.topk(a, 3)
    flipped = ref["vecs"] * torch.tensor([1.0, -1.0, 1.0])[:, None]
    assert float(reference.vec_err(flipped, ref).max()) == 0.0
    assert float(reference.eig_err(ref["lam"], ref).max()) == 0.0
    one = flipped.clone()
    one[0, 2, 5] = -one[0, 2, 5]
    err = reference.vec_err(one, ref)
    assert float(err[0]) == pytest.approx(2 * abs(float(one[0, 2, 5])))
    assert float(err[1]) == 0.0
    full = reference.solve(a)
    assert float(reference.mag_err(full["mags"], full).max()) == 0.0


def test_result_line_of_a_window(small_root):
    cell = run.load_cell(small_root, "solve.small")
    out = run.run_cell(cell, 2**31 + 99, 0.01, False, "cpu", 0.0)
    result = out["result"]
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 2
    assert set(result["metrics"]) == {"matrices_per_s", "setup_s"}
    assert list(result["device"]) == ["platform", "kind", "count",
                                      "memory_peak_bytes"]
    assert set(result["checks"]) == {"eig_err", "mag_err"}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    assert out["info"]["plan"]["method"] == "eei_tridiag"
    json.dumps(result, allow_nan=False)


def test_traced_line_carries_the_extra_metric_and_the_breakdown(small_root):
    cell = run.load_cell(small_root, "topk4.small")
    out = run.run_cell(cell, 5, 0.01, True, "cpu", 0.0)
    result = out["result"]
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    assert result["correct"] is True
    # Device metrics are never read from a CPU run.
    assert set(result["metrics"]) == {"lanczos_ms", "recover_ms",
                                      "minor_det_ms", "traced_calls"}
    assert result["metrics"]["traced_calls"]["value"] == 1
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["info"]["plan"] == {"method": "eei_krylov",
                                   "spectrum": "windowed", "backend": "cuda",
                                   "precision": "float64", "m": 128}
    json.dumps(result, allow_nan=False)
