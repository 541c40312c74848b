"""The port's dry run (``launch.dryrun_lib``, ``launch.dryrun``), its
meshes (``make_production_mesh``, the ``pod`` axis) and the report tool,
against repro's.

* Reduced gemma2-2b, zamba2-2.7b and deepseek-v3-671b, train and decode
  at 16 x 2 on a 1x1 ``"meta"`` mesh (``tests/test_system.py``'s
  dry-run cells): the counted FLOPs are positive and the argument bytes
  equal repro's ``memory_analysis()`` of the same cell on a 1x1 mesh, with
  the same FSDP choice, exactly.  The FLOP counts are not compared: repro's
  ``cost_analysis`` counts what XLA emits, the port counts matmuls by
  their formulas and one FLOP an element elsewhere.
* The L-extrapolated count of a reduced config (repeats 2) equals its
  full-depth count exactly; the paper's EEI table on a 1x2 meta mesh has
  repro's output shard shape and ``3 batch n^3`` useful FLOPs.
* ``make_production_mesh`` gives repro's shapes and axis names; the spec
  trees of a 1x1x1 pod mesh equal repro's on ``jax.make_mesh((1, 1, 1),
  ("pod", "data", "model"))``; a CPU 2x1x1 mesh serves and trains reduced
  gemma2-2b and deepseek-v3-671b bit for bit as 2x1 does.
* The CLI writes its artifact, and ``tools/roofline_report.py`` reads it.

Repro's six lowerings are compiled once per module, without XLA's
optimization passes (argument sizes do not depend on them).
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs.base import ShapeConfig as RShapeConfig
from repro.configs.registry import get_config as r_get_config
from repro.configs.registry import reduced_config as r_reduced_config
from repro.launch import dryrun_lib as r_dryrun_lib
from repro.launch import mesh as r_mesh_lib
from repro.models.lm import LanguageModel as RLanguageModel
from repro.sharding import rules as r_rules
from repro.train import steps as r_steps
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.data import make_synthetic
from repro_torch.launch import dryrun as dryrun_cli
from repro_torch.launch import dryrun_lib
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import (
    Mesh,
    make_local_mesh,
    make_production_mesh,
    mesh_spec,
    parse_mesh,
)
from repro_torch.models import LanguageModel
from repro_torch.optim import AdamW
from repro_torch.roofline import constants as C
from repro_torch.sharding import placement, rules
from repro_torch.train import TrainState, put_batch, steps

ROOT = Path(__file__).resolve().parents[1]
DRY_ARCHS = ("gemma2-2b", "zamba2-2.7b", "deepseek-v3-671b")
FAST_COMPILE = {"xla_backend_optimization_level": 0}
B, S = 2, 8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side on one torch and one OpenBLAS thread: its tensors
    are tiny, and parallel test workers would otherwise each start a thread
    a core of each."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # the limit on torch's threads still holds
        limits = None
    else:
        limits = threadpool_limits(limits=1, user_api="blas")
    yield
    if limits is not None:
        limits.restore_original_limits()
    torch.set_num_threads(was)


def _meta(spec: str):
    return parse_mesh(spec, "meta")


def _cell(kind: str) -> ShapeConfig:
    return ShapeConfig(f"{kind}_tiny", 16, 2, kind)


@pytest.fixture(scope="module")
def repro_memory():
    """Repro's ``memory_analysis()`` of each dry-run cell on a 1x1 mesh,
    compiled once: ``{(arch, kind): (argument bytes, fsdp)}``."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    out = {}
    for arch in DRY_ARCHS:
        cfg = r_reduced_config(r_get_config(arch))
        fsdp = r_rules.fsdp_recommended(RLanguageModel(cfg).n_params(), mesh)
        for kind in ("train", "decode"):
            shape = RShapeConfig(f"{kind}_tiny", 16, 2, kind)
            compiled = r_dryrun_lib.lower_cell(cfg, shape, mesh).compile(
                FAST_COMPILE)
            out[arch, kind] = (
                compiled.memory_analysis().argument_size_in_bytes, fsdp)
    return out


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", DRY_ARCHS)
def test_dryrun_cell_argument_bytes_equal_repro(arch, kind, repro_memory):
    r_bytes, r_fsdp = repro_memory[arch, kind]
    cell = dryrun_lib.lower_cell(reduced_config(get_config(arch)),
                                 _cell(kind), _meta("1x1"))
    assert cell.fsdp == r_fsdp
    out = dryrun_lib.compile_and_extract(cell)
    assert out["cost"]["flops"] > 0 and out["cost"]["bytes accessed"] > 0
    assert out["memory"]["argument_size_in_bytes"] == r_bytes
    assert out["memory"]["temp_size_in_bytes"] > 0
    assert out["collectives"] == {"total": 0}


@pytest.mark.parametrize("arch, kind, spec", [
    ("gemma2-2b", "train", "1x2"),
    ("gemma2-2b", "decode", "1x2"),
    ("deepseek-v3-671b", "prefill", "1x2"),
    ("deepseek-v3-671b", "train", "2x1"),
])
def test_meta_count_equals_the_count_of_a_run_on_the_cpu(arch, kind, spec):
    """The count reads shapes only: the cell run for real on a CPU mesh
    (weights and tokens drawn from a seed) counts what the meta run does.
    ``tests/test_torch_cuda.py`` holds the same on the card."""
    cfg = reduced_config(get_config(arch))
    meta = dryrun_lib.compile_and_extract(
        dryrun_lib.lower_cell(cfg, _cell(kind), _meta(spec)))
    cpu = dryrun_lib.compile_and_extract(dryrun_lib.lower_cell(
        cfg, _cell(kind), parse_mesh(spec, "cpu"),
        generator=torch.Generator().manual_seed(0)))
    assert cpu["cost"] == meta["cost"]
    assert cpu["collectives"] == meta["collectives"]
    assert cpu["memory"] == meta["memory"]


@pytest.mark.parametrize("arch, kind, spec", [
    ("gemma2-2b", "train", "2x2"),
    ("deepseek-v3-671b", "decode", "1x2"),
    ("zamba2-2.7b", "prefill", "2x1"),
])
def test_extrapolated_count_equals_the_full_depth_count(arch, kind, spec):
    """Every group of the reduced config repeats twice, so the roofline's
    extrapolation from one and two repeats must land on the full count:
    FLOPs, bytes and each collective kind, exactly."""
    cfg = reduced_config(get_config(arch))
    assert all(r == 2 for r, _ in cfg.pattern)
    mesh = _meta(spec)
    full = dryrun_lib.compile_and_extract(
        dryrun_lib.lower_cell(cfg, _cell(kind), mesh))
    rl = dryrun_lib.roofline_for_cell(cfg, _cell(kind), mesh)
    assert rl["roofline"]["flops"] == full["cost"]["flops"]
    assert rl["roofline"]["bytes_accessed"] == full["cost"]["bytes accessed"]
    assert rl["collective_breakdown"] == full["collectives"]
    assert rl["roofline"]["chips"] == mesh.size


def test_paper_eei_on_a_1x2_meta_mesh_has_repro_s_shards():
    n = 64
    r_mesh = jax.sharding.AbstractMesh((1, 2), ("data", "model"))
    out_sh = NamedSharding(r_mesh, JP(r_rules.data_axes(r_mesh), None,
                                      "model"))  # repro's lower_paper_eei
    result = dryrun_lib.dryrun_paper_eei(_meta("1x2"), n=n)
    cell = dryrun_lib.lower_paper_eei(_meta("1x2"), n=n)
    table = cell.run()
    assert [tuple(t.shape) for row in table.shards for t in row] == [
        tuple(out_sh.shard_shape((1, n, n)))] * 2
    assert result["roofline"]["model_flops"] == 3.0 * 1 * n ** 3
    assert result["chips"] == 2 and result["full"]["cost"]["flops"] > 0


# -- meshes ---------------------------------------------------------------------


def test_production_meshes_are_repro_s(monkeypatch):
    monkeypatch.setattr(r_mesh_lib.jax, "make_mesh",
                        lambda shape, axes: (tuple(shape), tuple(axes)))
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        shape, axes = r_mesh_lib.make_production_mesh(multi_pod=multi_pod)
        assert tuple(mesh.shape.values()) == shape
        assert mesh.axis_names == axes
        assert mesh.size == int(np.prod(shape))
        assert mesh.first_device == torch.device("meta")
    assert rules.chip_memory(make_production_mesh()) == C.HBM_PER_CHIP
    assert rules.chip_memory(parse_mesh("1x1", "cpu")) == 16e9


def test_a_pod_mesh_flattens_its_rows_pod_major():
    mesh = make_local_mesh(3, 2, devices=["cpu"] * 12, pod=2)
    assert mesh.shape == {"pod": 2, "data": 3, "model": 2}
    assert mesh.spec == "2x3x2" and mesh.size == 12 and len(mesh.devices) == 6
    assert mesh.position(4, 1) == {"pod": 1, "data": 1, "model": 1}
    assert len(mesh.axis_devices("pod")) == 2
    assert len(mesh.axis_devices("data")) == 3
    assert mesh_spec("2x3x2") == (2, 3, 2)
    assert parse_mesh("2x3x2", "cpu") == mesh
    for bad in ("2x", "1x0x1", "2x2x2x2", "ax1"):
        with pytest.raises(ValueError):
            mesh_spec(bad)
    with pytest.raises(ValueError):
        Mesh(((torch.device("cpu"),),) * 3, ("pod", "data", "model"), 2)
    x = torch.arange(6 * 4.0).reshape(6, 4)
    sh = placement.put(x, placement.Sharding(mesh, rules.P(("pod", "data"),
                                                           "model")))
    assert torch.equal(sh.gather(), x)
    assert torch.equal(sh.shards[4][1], x[4:5, 2:4])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_pod_mesh_specs_equal_repro(arch):
    """Parameter specs under TP and FSDP, cache and batch spec trees of a
    1x1x1 pod mesh against repro's on a real 1x1x1 mesh."""
    r_mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    mesh = make_local_mesh(1, 1, devices=["meta"], pod=1)
    r_model = RLanguageModel(r_get_config(arch))
    model = LanguageModel(get_config(arch), device="meta")

    def plain(tree):
        if isinstance(tree, dict):
            return {k: plain(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [plain(v) for v in tree]
        return tuple(tree)

    for fsdp in (False, True):
        assert plain(steps.param_pspecs(model, rules.make_rules(
            mesh, fsdp=fsdp))) == plain(r_steps.param_pspecs(
                r_model, r_rules.make_rules(r_mesh, fsdp=fsdp)))
    assert plain(steps.cache_pspecs(model, mesh)) == plain(
        r_steps.cache_pspecs(r_model, r_mesh))
    assert plain(steps.batch_pspecs(model.cfg, mesh)) == plain(
        r_steps.batch_pspecs(r_model.cfg, r_mesh))
    assert rules.data_axes(mesh) == r_rules.data_axes(r_mesh)


def _serve_and_train(arch, spec):
    model = LanguageModel(reduced_config(get_config(arch)), device="cpu").init(
        torch.Generator().manual_seed(0))
    mesh = parse_mesh(spec, "cpu")
    progs = steps.build_programs(model, mesh, compute_dtype=torch.float32)
    params = placement.put_tree(model.stacked_dict(),
                                progs.state_shardings.params)
    batch = serve_cli.lm_batch(model.cfg, B, S, 0, "cpu")
    logits, caches = progs.prefill(params, batch, S + 3)
    out = [logits]
    for i in range(3):
        logits, caches = progs.decode_step(
            params, caches, torch.argmax(out[-1], dim=-1), S + i)
        out.append(logits)
    opt = AdamW(lr=3e-3)
    progs = steps.build_programs(model, mesh, optimizer=opt,
                                 compute_dtype=torch.float32)
    stacked = {k: v.clone() for k, v in model.stacked_dict().items()}
    state = placement.put_tree(
        TrainState(stacked, opt.init(stacked),
                   torch.zeros((), dtype=torch.int32)),
        progs.state_shardings)
    source = make_synthetic(model.cfg, ShapeConfig("t", 16, 4, "train"),
                            seed=0)
    state, metrics = progs.train_step(
        state, put_batch(source.global_batch_at(0), "cpu"))
    return out, metrics["loss"], {k: v.gather() for k, v in
                                  state.params.items()}


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-v3-671b"])
def test_a_2x1x1_pod_mesh_serves_and_trains_as_2x1(arch):
    """``pod`` is data parallelism: the 2x1x1 mesh's rows are the 2x1
    mesh's, so prefill, three decode steps and an AdamW step agree bit
    for bit."""
    logits, loss, params = _serve_and_train(arch, "2x1x1")
    r_logits, r_loss, r_params = _serve_and_train(arch, "2x1")
    assert all(torch.equal(a, b) for a, b in zip(logits, r_logits))
    assert torch.equal(loss, r_loss)
    assert params.keys() == r_params.keys()
    assert all(torch.equal(params[k], r_params[k]) for k in params)


# -- the CLI and the report ----------------------------------------------------


def _report_module():
    spec = importlib.util.spec_from_file_location(
        "roofline_report", ROOT / "tools" / "roofline_report.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_cli_writes_an_artifact_the_report_reads(tmp_path, monkeypatch,
                                                 capsys):
    """``dryrun --roofline`` on a reduced cell (the production mesh sent
    to 1x2: a 256-position cell takes minutes), then the report."""
    monkeypatch.setattr(dryrun_cli.mesh_lib, "make_production_mesh",
                        lambda multi_pod=False: _meta("1x2"))
    monkeypatch.setattr(dryrun_lib, "get_config",
                        lambda arch: reduced_config(get_config(arch)))
    out = tmp_path / "dry"
    assert dryrun_cli.main(["--arch", "gemma2-2b", "--shape", "decode_32k",
                            "--roofline", "--out", str(out)]) == 0
    art = json.loads((out / "gemma2-2b__decode_32k__pod.json").read_text())
    assert art["status"] == "ok" and art["mesh"] == "1x2"
    assert art["chips"] == 2 and art["full"]["collectives"]["total"] > 0
    assert art["roofline"]["flops"] == art["full"]["cost"]["flops"]
    assert "[OK     ] gemma2-2b x decode_32k x pod" in capsys.readouterr().out
    rows = _report_module().run(str(out))
    assert [r.name for r in rows] == ["roofline/gemma2-2b/decode_32k"]
    assert rows[0].us > 0 and "dominant=" in rows[0].derived
    assert dryrun_cli.main(["--paper-eei", "--eei-n", "32", "--out",
                            str(out)]) == 0
    assert (out / "paper-eei__eei_n32_sum__pod.json").exists()
