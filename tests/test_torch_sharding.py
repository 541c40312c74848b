"""The port's sharding rules, spec trees, hints and placement against
repro's, on the CPU.

The spec functions are plain arithmetic on a mesh's axis names and sizes.
``repro``'s ``spec_for``, ``cache_spec``, ``fsdp_recommended``,
``mesh_axis_size``, ``batch_pspecs``, ``cache_pspecs`` and ``prune_specs``
read only ``mesh.axis_names`` and ``mesh.devices.shape``, so they run here
on a duck-typed mesh with no JAX device; the port's run on a logical mesh
of CPU devices.  Held equal: every parameter spec of all ten configs at
published width under TP and FSDP, every cache and batch spec, the pruned
specs and the FSDP recommendation, on meshes 1x1, 2x1, 1x2, 1x3, 2x2 and
4x2.  Then the layout requests of the attention's sequence-parallel choice
and of the MoE (``hints.constrain``; repro's recorded through
``jax.lax.with_sharding_constraint``), and the bytes each position of a
2x2 mesh holds against what repro's specs give.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as R_ARCHS
from repro.configs.registry import get_config as r_get_config
from repro.configs.registry import reduced_config as r_reduced_config
from repro.models import attention as r_attn
from repro.models import moe as r_moe
from repro.models.lm import LanguageModel as RLanguageModel
from repro.sharding import hints as r_hints
from repro.sharding import rules as r_rules
from repro.train import steps as r_steps
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.registry import ARCHS
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import attention, moe
from repro_torch.models.lm import LanguageModel, param_table
from repro_torch.models.params import abstract_params, logical_axes
from repro_torch.optim import AdamW, EigenPre
from repro_torch.sharding import hints, placement, rules
from repro_torch.sharding.placement import Sharding, Split
from repro_torch.train import TrainState
from repro_torch.train import steps

MESHES = ((1, 1), (2, 1), (1, 2), (1, 3), (2, 2), (4, 2))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread: its tensors are tiny, and parallel
    test workers would otherwise each start one thread a core."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


class _RMesh:
    """What repro's spec functions read of a ``jax.sharding.Mesh``."""

    def __init__(self, data, model):
        self.axis_names = ("data", "model")
        self.devices = np.empty((data, model))


def _meshes():
    for d, m in MESHES:
        yield (f"{d}x{m}", _RMesh(d, m),
               make_local_mesh(d, m, devices=["cpu"] * (d * m)))


class _Shapes:
    """The port's model as far as the spec functions read it (its table
    and config), without building its parameters."""

    def __init__(self, cfg):
        self.cfg = cfg

    def param_table(self):
        return param_table(self.cfg)


def _plain(tree):
    """A spec tree with every spec as a plain tuple (repro's
    ``PartitionSpec`` and the port's ``P`` are both tuples of entries)."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_plain(v) for v in tree]
    if hasattr(tree, "_fields"):
        return type(tree).__name__, tuple(_plain(v) for v in tree)
    return tuple(tree)


def test_ten_configs_on_both_sides():
    assert sorted(ARCHS) == sorted(R_ARCHS) and len(ARCHS) == 10


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_parameter_cache_and_batch_specs_equal_repro(arch):
    """Every parameter spec under TP and FSDP, the cache and batch spec
    trees and the FSDP recommendation of ``arch`` at published width, on
    each of the six meshes."""
    r_model = RLanguageModel(r_get_config(arch))
    model = _Shapes(get_config(arch))
    assert logical_axes(model.param_table()) == {
        k: d.axes for k, d in r_model.param_table().items()}
    n_params = r_model.n_params()
    for name, r_mesh, mesh in _meshes():
        for fsdp in (False, True):
            r_specs = r_steps.param_pspecs(
                r_model, r_rules.make_rules(r_mesh, fsdp=fsdp))
            specs = steps.param_pspecs(model, rules.make_rules(mesh,
                                                               fsdp=fsdp))
            assert _plain(specs) == _plain(r_specs), (name, fsdp)
        assert _plain(steps.cache_pspecs(model, mesh)) == _plain(
            r_steps.cache_pspecs(r_model, r_mesh)), name
        assert _plain(steps.batch_pspecs(model.cfg, mesh)) == _plain(
            r_steps.batch_pspecs(r_model.cfg, r_mesh)), name
        for hbm in (16e9, 80e9):
            assert rules.fsdp_recommended(n_params, mesh, hbm) \
                == r_rules.fsdp_recommended(n_params, r_mesh, hbm), name
        for axis in ("data", "model", "pod"):
            assert rules.mesh_axis_size(mesh, axis) \
                == r_rules.mesh_axis_size(r_mesh, axis)
        for kind, kv in (("attn", model.cfg.n_kv_heads), ("mla", 1)):
            assert tuple(rules.cache_spec(mesh, kv, kind)) \
                == tuple(r_rules.cache_spec(r_mesh, kv, kind))
        assert tuple(rules.batch_spec(mesh)) == tuple(
            r_rules.batch_spec(r_mesh))


@pytest.mark.parametrize("batch, smax", [(1, 48), (2, 16), (3, 7)])
def test_pruned_cache_specs_equal_repro(batch, smax):
    """``prune_specs`` of every config's cache tree against its shapes
    (batches and lengths that some mesh axes do not divide)."""
    for arch in sorted(ARCHS):
        r_model = RLanguageModel(r_get_config(arch))
        model = LanguageModel(get_config(arch), device="meta")
        for name, r_mesh, mesh in _meshes():
            r_out = r_steps.prune_specs(
                r_steps.cache_pspecs(r_model, r_mesh),
                r_model.cache_spec(batch, smax, jnp.float32), r_mesh)
            out = steps.prune_specs(
                steps.cache_pspecs(model, mesh),
                model.cache_spec(batch, smax, torch.float32), mesh)
            assert _plain(out) == _plain(r_out), (arch, name)


def test_abstract_params_and_state_allocate_nothing():
    model = LanguageModel(get_config("deepseek-v3-671b"), device="meta")
    ab = model.abstract()
    assert list(ab) == sorted(model.param_table())
    assert all(t.device.type == "meta" for t in ab.values())
    assert sum(t.numel() for t in ab.values()) == model.n_params()
    table = model.param_table()
    assert {k: tuple(t.shape) for k, t in abstract_params(table).items()} \
        == {k: d.shape for k, d in table.items()}
    st = steps.abstract_state(model, EigenPre())
    assert st.opt_state.adamw.m["final_norm"].device.type == "meta"
    assert st.step.device.type == "cpu"


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_repro(kind):
    from repro.configs.base import ShapeConfig as RShape
    from repro_torch.configs.base import ShapeConfig

    for arch in ("whisper-large-v3", "llama-3.2-vision-90b", "gemma2-2b"):
        r = r_steps.input_specs(r_get_config(arch), RShape("s", 64, 4, kind))
        p = steps.input_specs(get_config(arch), ShapeConfig("s", 64, 4, kind))
        flat = []
        placement.tree_map(lambda x: flat.append(tuple(x.shape)), p,
                           is_leaf=lambda x: isinstance(x,
                                                        attention.TensorSpec))
        assert sorted(flat) == sorted(tuple(x.shape)
                                      for x in jax.tree.leaves(r)), arch


# -- hints ----------------------------------------------------------------------


@pytest.fixture()
def r_recorded(monkeypatch):
    """repro's layout requests, recorded where its ``constrain`` would
    call ``with_sharding_constraint``."""
    seen = []

    def record(x, spec):
        seen.append(tuple(spec))
        return x

    monkeypatch.setattr(jax.lax, "with_sharding_constraint", record)
    return seen


def _requests(fn, model_size):
    with hints.axis_hints(data=("data",), model="model",
                          model_size=model_size):
        fn()
        return [tuple(s) for s in hints.current()["requests"]]


@pytest.mark.parametrize("heads, kv", [(8, 4), (20, 20), (48, 1), (4, 2),
                                       (128, 128)])
@pytest.mark.parametrize("model_size", [1, 2, 3, 4, 16])
def test_sequence_parallel_choice_requests_repro_s_layouts(
        heads, kv, model_size, r_recorded):
    r_cfg = r_attn.AttnConfig(d_model=64, n_heads=heads, n_kv_heads=kv,
                              head_dim=8)
    cfg = attention.AttnConfig(d_model=64, n_heads=heads, n_kv_heads=kv,
                               head_dim=8)
    x = jnp.zeros((1, 2, heads, 8))
    with r_hints.axis_hints(data=("data",), model="model",
                            model_size=model_size):
        r_attn._sequence_parallel_qkv(r_cfg, x, x, x)
    t = torch.zeros(1, 2, heads, 8)
    ours = _requests(lambda: attention._sequence_parallel_qkv(cfg, t, t, t),
                     model_size)
    assert ours == r_recorded
    assert attention.heads_split(cfg, model_size) == (heads % model_size == 0)


def _moe_case():
    r_cfg = r_moe.MoEConfig(d_model=16, d_ff=8, n_experts=4, top_k=2,
                            n_shared=1, group_size=8)
    cfg = moe.MoEConfig(d_model=16, d_ff=8, n_experts=4, top_k=2, n_shared=1,
                        group_size=8)
    rng = np.random.default_rng(0)
    table = moe.moe_param_table(cfg)
    p = {k: (rng.standard_normal(d.shape) * 0.3).astype(np.float32)
         for k, d in table.items()}
    x = rng.standard_normal((2, 8, 16)).astype(np.float32)
    return r_cfg, cfg, p, x


def test_moe_requests_repro_s_layouts_on_one_device_and_over_rows(r_recorded):
    r_cfg, cfg, p, x = _moe_case()
    with r_hints.axis_hints(data=("data",), model="model", model_size=2):
        r_y, _ = jax.jit(lambda pp, xx: r_moe.moe(r_cfg, pp, xx),
                         compiler_options={
                             "xla_backend_optimization_level": 0})(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    assert len(r_recorded) == 6
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    ours = _requests(lambda: moe.moe(cfg, tp, torch.from_numpy(x)), 2)
    assert ours == r_recorded
    devices = (torch.device("cpu"),) * 2
    split = {k: Split((v, v), None) for k, v in tp.items()}
    rows = _requests(lambda: moe.moe_rows(cfg, [split], [torch.from_numpy(x)],
                                          [devices]), 2)
    assert rows == r_recorded
    y, _ = moe.moe(cfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(r_y), rtol=1e-5,
                               atol=1e-5)


def test_moe_rows_request_the_routing_layouts_when_experts_split():
    """With the experts split over the model axis, each device runs its
    own expert slots: the rows request repro's dispatch, combine and
    output layouts (the experts' own name one device's part, so they
    request none)."""
    r_cfg, cfg, p, x = _moe_case()
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    devices = (torch.device("cpu"),) * 2
    split = {k: Split(tuple(torch.chunk(v, 2, dim=0)), 0) if k.startswith("w_")
             else Split((v, v), None) for k, v in tp.items()}
    rows = _requests(lambda: moe.moe_rows(cfg, [split], [torch.from_numpy(x)],
                                          [devices]), 2)
    assert rows == [rules.P("data", None, "model", None)] * 2 + [
        rules.P("data", None, None)]


def test_moe_counts_the_pairs_it_drops_past_capacity():
    """``stats["moe_dropped"]`` against a loop over the routing: each
    group's (token, choice) pairs in rank-then-token order, an expert
    taking pairs until its capacity is full.  ``moe_rows`` counts the same
    over two rows."""
    _, cfg, p, x = _moe_case()
    cfg = moe.MoEConfig(d_model=16, d_ff=8, n_experts=4, top_k=2,
                        group_size=16, capacity_factor=0.5)
    tp = {k: torch.from_numpy(v) for k, v in p.items()
          if not k.startswith("shared/")}
    xt = torch.from_numpy(x)
    stats = {}
    moe.moe(cfg, tp, xt, stats)
    logits = (xt.reshape(-1, 16) @ tp["router"]).numpy()
    cap = moe._capacity(cfg, 16)
    want = 0
    for group in logits.reshape(-1, 16, 4):
        choice = np.argsort(-group, axis=-1, kind="stable")[:, :2]
        taken = np.zeros(4, int)
        for k in range(2):
            for t in range(16):
                e = choice[t, k]
                if taken[e] < cap:
                    taken[e] += 1
                else:
                    want += 1
    assert want > 0 and [int(d) for d in stats["moe_dropped"]] == [want]
    devices = ((torch.device("cpu"),), (torch.device("cpu"),))
    split = {k: Split((v,), None) for k, v in tp.items()}
    row_stats = {}
    moe.moe_rows(cfg, [split, split], [xt[:1], xt[1:]], devices, row_stats)
    assert [int(d) for d in row_stats["moe_dropped"]] == [want]


def test_mesh_programs_budget_the_first_device_s_memory():
    """``build_programs`` and ``reshard_state`` decide FSDP against
    :func:`rules.chip_memory`: a card's memory, else repro's 16e9.
    gemma2-2b's 12 bytes a parameter (24.7 GB) pass half of 16e9, not half
    of an 80 GB card."""
    mesh = make_local_mesh(2, 1, devices=["cpu"] * 2)
    assert rules.chip_memory(mesh) == 16e9
    model = LanguageModel(get_config("gemma2-2b"), device="meta")
    assert steps.build_programs(model, mesh).fsdp
    assert not rules.fsdp_recommended(model.n_params(), mesh, 80e9)


def test_hints_are_no_ops_without_a_context():
    t = torch.ones(3)
    assert hints.constrain(t, "data") is t and hints.current() is None
    assert hints.model_axis_size() == 1
    with hints.axis_hints(data="data", model="model", model_size=4):
        assert hints.model_axis_size() == 4
        assert hints.constrain(t, None, None) is t
        assert hints.current()["requests"] == []
        with hints.paused():
            assert hints.current() is None
        assert hints.constrain(t, "model") is t
        assert hints.current()["requests"] == [("model",)]


# -- placement ------------------------------------------------------------------


def _expected_bytes(specs: dict, shapes: dict, itemsize: dict, d: int,
                    m: int) -> int:
    """Bytes one position holds by repro's specs: each leaf's elements
    over the product of its mapped axes' sizes."""
    size = {"data": d, "model": m}
    total = 0
    for k, spec in specs.items():
        div = 1
        for e in spec:
            for a in ((e,) if isinstance(e, str) else (e or ())):
                div *= size[a]
        total += math.prod(shapes[k]) // div * itemsize[k]
    return total


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-v3-671b"])
@pytest.mark.parametrize("fsdp", [False, True])
def test_shards_hold_exactly_the_bytes_of_repro_s_specs(arch, fsdp):
    """Each position of a 2x2 CPU mesh holds the parameters, AdamW's
    moments (``m`` in bfloat16) and an attention cache by repro's specs,
    and gathering the shards gives the tensors back."""
    r_model = RLanguageModel(r_reduced_config(r_get_config(arch)))
    r_specs = r_steps.param_pspecs(r_model, r_rules.make_rules(_RMesh(2, 2),
                                                               fsdp=fsdp))
    model = LanguageModel(reduced_config(get_config(arch)), device="cpu").init(
        torch.Generator().manual_seed(0))
    mesh = make_local_mesh(2, 2, devices=["cpu"] * 4)
    progs = steps.build_programs(model, mesh, fsdp=fsdp,
                                 compute_dtype=torch.float32)
    params = model.stacked_dict()
    state = TrainState(params, AdamW().init(params),
                       torch.zeros((), dtype=torch.int32))
    placed = placement.put_tree(state, progs.state_shardings)
    shapes = {k: tuple(v.shape) for k, v in params.items()}
    want = (_expected_bytes(r_specs, shapes, {k: 4 for k in shapes}, 2, 2)
            + _expected_bytes(r_specs, shapes, {k: 2 for k in shapes}, 2, 2)
            + _expected_bytes(r_specs, shapes, {k: 4 for k in shapes}, 2, 2))
    assert placement.device_bytes(placed, mesh) == [[want, want],
                                                    [want, want]]
    for k, v in params.items():
        assert torch.equal(placed.params[k].gather(), v)
        assert tuple(placed.params[k].spec) == tuple(r_specs[k]) + (
            None,) * (v.dim() - len(r_specs[k]))
    caches = model.cache_spec(4, 8, torch.float32)
    cspecs = steps.prune_specs(steps.cache_pspecs(model, mesh), caches, mesh)
    zeros = placement.tree_map(
        lambda s, c: placement.zeros(c.shape, c.dtype, Sharding(mesh, s)),
        cspecs, caches)
    grid = placement.device_bytes(zeros, mesh)
    total = sum(math.prod(c.shape) * 4 for c in jax.tree.leaves(
        caches, is_leaf=lambda x: isinstance(x, attention.TensorSpec)))
    assert sum(map(sum, grid)) == total and len({*grid[0], *grid[1]}) == 1


def test_placement_split_write_and_gradients():
    mesh = make_local_mesh(2, 2, devices=["cpu"] * 4)
    x = torch.arange(48.0).reshape(4, 4, 3)
    for spec in (rules.P("data", "model"), rules.P(None, "model"),
                 rules.P(("data",), None), rules.P()):
        sh = placement.put(x, Sharding(mesh, spec))
        assert torch.equal(sh.gather(), x)
        for r in range(2):
            assert torch.equal(sh.split(r).full(), x)
    sh = placement.put(x, Sharding(mesh, rules.P(None, "model")))
    sp = sh.split(1, gather_data=False)
    assert sp.dim == 1 and sp.bounds(1) == (2, 4)
    sp.write(torch.full((4, 3, 3), -1.0), dim=1, start=1)
    got = sp.full()
    assert (got[:, 1:4] == -1).all() and torch.equal(got[:, 0], x[:, 0])
    assert torch.equal(sh.split(0).full(), x)  # row 0 untouched
    # gradients: replicas over data summed, each slice once
    leaves = placement.put(torch.ones(4, 2), Sharding(mesh, rules.P(None,
                                                                    "model")))
    leaves = leaves.map(lambda t: t.requires_grad_())
    for r in range(2):
        for m in range(2):
            (leaves.shards[r][m] * (1 + r + 10 * m)).sum().backward()
    g = placement.reduce_grads(leaves)
    assert torch.equal(g.gather(), torch.cat([torch.full((4, 1), 3.0),
                                              torch.full((4, 1), 23.0)], 1))
    assert [len(grp) for grp in placement.groups(g)] == [2, 2]
    assert placement.put(torch.tensor(3), Sharding(mesh, rules.P())).dim() == 0
    whole = placement.put(x, Sharding(mesh, None))
    assert isinstance(whole, torch.Tensor) and torch.equal(whole, x)


def test_reference_state_specs_do_not_fit_eigenpre_s_state():
    """The defect in repro this slice meets: ``state_pspecs`` always
    builds AdamW's tree, so ``EigenPre().init(params)`` does not have its
    structure, which is what stops ``repro.launch.train --eigenpre --mesh``
    with a ValueError.  The port builds the optimizer's own tree."""
    from repro.optim import EigenPre as REigenPre

    r_model = RLanguageModel(r_reduced_config(r_get_config("gemma2-2b")))
    r_mesh = _RMesh(1, 1)
    r_specs = r_steps.state_pspecs(r_model, r_rules.make_rules(r_mesh))
    r_opt = jax.eval_shape(REigenPre().init, r_model.abstract())
    assert type(r_specs.opt_state).__name__ == "AdamWState"
    assert type(r_opt).__name__ == "EigenPreState"
    with pytest.raises(ValueError):
        jax.tree.map(lambda s, x: x, r_specs.opt_state, r_opt,
                     is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    model = LanguageModel(reduced_config(get_config("gemma2-2b")),
                          device="meta")
    mesh = make_local_mesh(1, 1, devices=["cpu"])
    specs = steps.state_pspecs(model, rules.make_rules(mesh))
    assert type(specs.opt_state).__name__ == "AdamWState"
    progs = steps.build_programs(model, mesh, optimizer=EigenPre())
    opt_sh = progs.state_shardings.opt_state
    assert type(opt_sh).__name__ == "EigenPreState"
    assert all(s.spec is None for s in opt_sh.gram.values())
