"""The port's calibration table: schema and round trip, the resolution
chain (a ``cuda`` table is skipped by a CPU process), the planner reading
an override (as ``tests/test_lanczos.py:270-300`` and
``tests/test_engine.py:160-190`` do for ``repro``), the committed H100
table, and a smoke sweep on the CPU."""

import json
import logging
import time

import pytest

from repro_torch import packed_plan_for, plan_for
from repro_torch.engine import autotune, plan
from repro_torch.engine.autotune import CalibrationTable, load_table


@pytest.fixture(autouse=True)
def _no_active_table():
    autotune.set_table(None)
    yield
    autotune.set_table(None)


def _table(**kw) -> CalibrationTable:
    fields = dict(eigh_crossover_n=24, dense_crossover_n=48,
                  cuda_eigh_crossover_n=16, cuda_dense_crossover_n=32,
                  windowed_k_frac=0.25, krylov_n_min=512, pack_n_max=16,
                  packed_eigh_n_max=64, host="test", backend="cpu")
    fields.update(kw)
    return CalibrationTable(**fields)


def test_round_trip_and_schema(tmp_path):
    path = _table().save(tmp_path / "cal.json")
    d = json.loads(path.read_text())
    assert d["schema_version"] == autotune._SCHEMA_VERSION == 5
    assert "source" not in d
    for tile in ("prod_diff_blocks", "sturm_blocks", "prod_diff_block_b"):
        assert tile not in d  # the kernels size their own launches
    loaded = load_table(path)
    assert loaded == _table(source=f"file:{path}")
    assert loaded.crossovers_for("cuda") == (16, 32)
    assert loaded.crossovers_for("torch") == (24, 48)
    assert loaded.crossovers_for(None) == (24, 48)
    assert _table(cuda_eigh_crossover_n=None).crossovers_for("cuda") == (24,
                                                                        48)


def test_newer_schema_is_refused_and_older_warns_once(tmp_path, caplog):
    d = _table().to_dict()
    d["schema_version"] = 99
    (tmp_path / "new.json").write_text(json.dumps(d))
    with pytest.raises(ValueError, match="newer"):
        load_table(tmp_path / "new.json")
    d["schema_version"] = 4
    del d["pack_n_max"]
    path = tmp_path / "old.json"
    path.write_text(json.dumps(d))
    with caplog.at_level(logging.WARNING, logger="repro_torch.autotune"):
        table = load_table(path)
        load_table(path)
    assert [r.getMessage() for r in caplog.records].count(
        caplog.records[0].getMessage()) == 1
    assert "schema_version 4" in caplog.text
    assert table.pack_n_max is None
    autotune.set_table(table)
    assert plan.resolved_pack_n_max() == plan.PACK_N_MAX


def test_cuda_table_is_skipped_by_a_cpu_process(tmp_path, monkeypatch,
                                                caplog):
    monkeypatch.setattr(autotune, "process_backend", lambda: "cpu")
    cache = _table(backend="cuda").save(tmp_path / "calibration.json")
    monkeypatch.delenv(autotune.CALIBRATION_ENV, raising=False)
    monkeypatch.setattr(autotune, "CACHE_PATH", cache)
    monkeypatch.setattr(autotune, "REPO_DEFAULT_PATH", tmp_path / "none.json")
    with caplog.at_level(logging.WARNING, logger="repro_torch.autotune"):
        assert load_table() is None
        load_table()
    skips = [r for r in caplog.records
             if "measured on backend 'cuda'" in r.getMessage()]
    assert len(skips) == 1
    assert autotune.get_table() is None
    assert plan.resolved_crossovers("cuda") == (plan.EIGH_CROSSOVER_N,
                                                plan.DENSE_CROSSOVER_N)
    # The environment variable and an explicit path are trusted as they are.
    assert load_table(cache).backend == "cuda"
    monkeypatch.setenv(autotune.CALIBRATION_ENV, str(cache))
    assert load_table().backend == "cuda"
    # A process on the card takes the cache.
    monkeypatch.delenv(autotune.CALIBRATION_ENV)
    monkeypatch.setattr(autotune, "process_backend", lambda: "cuda")
    assert load_table().source.startswith("cache:")


def test_committed_default_was_measured_on_the_card(monkeypatch, tmp_path):
    d = json.loads(autotune.REPO_DEFAULT_PATH.read_text())
    assert d["schema_version"] == autotune._SCHEMA_VERSION
    assert d["backend"] == "cuda" and "-cuda-" in d["host"]
    assert "H100" in d["host"]
    table = load_table(autotune.REPO_DEFAULT_PATH)
    assert 1 <= table.eigh_crossover_n and 1 <= table.dense_crossover_n
    assert table.cuda_eigh_crossover_n is not None
    assert table.cuda_dense_crossover_n is not None
    assert 0.0 <= table.windowed_k_frac <= 1.0
    assert table.krylov_n_min >= 1 and table.pack_n_max >= 0
    assert table.packed_eigh_n_max >= 1
    # This process has no card: the committed default does not govern it.
    monkeypatch.setattr(autotune, "process_backend", lambda: "cpu")
    monkeypatch.delenv(autotune.CALIBRATION_ENV, raising=False)
    monkeypatch.setattr(autotune, "CACHE_PATH", tmp_path / "none.json")
    assert load_table() is None
    monkeypatch.setattr(autotune, "process_backend", lambda: "cuda")
    assert load_table().source == "repo-default"


def test_override_steers_plan_for():
    autotune.set_table(_table(cuda_eigh_crossover_n=4,
                              cuda_dense_crossover_n=10,
                              eigh_crossover_n=8, dense_crossover_n=12,
                              windowed_k_frac=1.0, krylov_n_min=64))
    assert plan.resolved_crossovers("cuda") == (4, 10)
    assert plan.resolved_crossovers("torch") == (8, 12)
    assert plan_for((8, 8)).method == "eei_dense"  # 4 < 8 <= 10 (cuda)
    assert plan_for((8, 8), backend="torch").method == "eigh"
    assert plan_for((12, 12)).method == "eei_tridiag"
    assert plan_for((12, 12), backend="torch").method == "eei_dense"
    # Krylov past the measured size with a narrow window.
    assert plan_for((128, 128), k=4).method == "eei_krylov"
    assert plan_for((32, 32), k=2).method == "eei_tridiag"
    assert plan_for((128, 128), k=32).method == "eei_tridiag"
    assert plan_for((128, 128)).method == "eei_tridiag"
    assert plan_for((128, 128), k=4, method="eei_tridiag").method == \
        "eei_tridiag"
    # windowed_k_frac = 1.0 windows every k < n; 0.125 only k <= n / 8.
    assert plan_for((4, 40, 40), k=20).spectrum == "windowed"
    autotune.set_table(_table(windowed_k_frac=0.125))
    assert plan.resolved_windowed_k_frac() == 0.125
    assert plan_for((4, 40, 40), k=20).spectrum == "full"
    assert plan_for((4, 40, 40), k=5).spectrum == "windowed"


def test_override_steers_packed_plan_for():
    autotune.set_table(_table(packed_eigh_n_max=256, pack_n_max=8))
    assert plan.resolved_pack_n_max() == 8
    assert packed_plan_for(256).method == "eigh"
    assert packed_plan_for(512).method == "eei_tridiag"
    autotune.set_table(_table(packed_eigh_n_max=32))
    assert packed_plan_for(64).method == "eei_tridiag"


def test_missing_fields_take_the_static_fallbacks():
    autotune.set_table(_table(krylov_n_min=None, pack_n_max=None,
                              packed_eigh_n_max=None))
    assert plan.resolved_krylov_n_min() == plan.KRYLOV_N_MIN
    assert plan.resolved_pack_n_max() == plan.PACK_N_MAX
    assert plan.resolved_packed_eigh_n_max() == plan.PACKED_EIGH_N_MAX
    assert plan_for((256, 256), k=4).method == "eei_tridiag"


def test_smoke_calibration_on_the_cpu(monkeypatch):
    """Every sweep runs through the port's engine on the CPU; ``_time`` runs
    each call once (no warm-up, no repeats) to keep it short (~10 s on an
    idle CPU)."""
    def once(fn, *args, repeat=3, warmup=1, device=None):
        t0 = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t0

    monkeypatch.setattr(autotune, "_time", once)
    table = autotune.calibrate(smoke=True, device="cpu")
    assert table.backend == "cpu" and table.host.endswith("-cpu-cpu")
    assert table.eigh_crossover_n in (7, 8, 16, 32)
    assert table.cuda_eigh_crossover_n in (7, 8, 16, 32)
    assert table.dense_crossover_n in (7, 8, 16, 32)
    assert 0.0 <= table.windowed_k_frac <= 1.0
    assert table.krylov_n_min in (64, 128, autotune.KRYLOV_NEVER)
    assert table.pack_n_max in (0, 8, 16)
    assert table.packed_eigh_n_max in (16, 32, 64)
    assert CalibrationTable.from_dict(table.to_dict()).windowed_k_frac == \
        table.windowed_k_frac


def test_calibrate_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.calibrate(smoke=True)


def test_main_writes_the_table(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(autotune, "calibrate",
                        lambda **kw: _table(backend="cuda"))
    out = tmp_path / "sub" / "cal.json"
    autotune.main(["--smoke", "--out", str(out)])
    assert load_table(out).krylov_n_min == 512
    assert f"wrote {out}" in capsys.readouterr().out
