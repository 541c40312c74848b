"""Dry-run core: build every (arch x shape x mesh) cell's program, run it on
``"meta"`` tensors, and count its memory, FLOPs, bytes, collective bytes
and roofline terms.  The twin of ``repro.launch.dryrun_lib``.

``repro`` lowers and compiles each cell for a mesh of placeholder host
devices and reads XLA's analyses.  The port has no compiler to ask: it runs
the cell's eager program (``train.steps.build_programs``) on a mesh whose
every position is ``torch.device("meta")``, where each operator computes
its output's shape and allocates nothing, and counts what the program
dispatches under one ``TorchDispatchMode`` (:class:`OpCounter`).  The
counts read shapes only, so the same program counted on the card gives the
same numbers.  One controller runs every position of the mesh, so a count
is over the whole mesh already.  Tests call :func:`dryrun_cell` on a small
mesh.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, shape_applicable
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.models.attention import TensorSpec
from repro_torch.models.lm import LanguageModel
from repro_torch.optim.adamw import AdamW
from repro_torch.roofline import (
    CostVector,
    Roofline,
    collective_bytes,
    cost_vector,
    extrapolate,
    model_flops,
    slstm_extra_flops,
)
from repro_torch.sharding import placement
from repro_torch.sharding import rules as rules_lib
from repro_torch.sharding.rules import P
from repro_torch.train import steps as steps_lib

#: Operators that only move or make data: counted in bytes, not in FLOPs.
MOVES = frozenset(
    getattr(torch.ops.aten, name) for name in (
        "_to_copy", "clone", "copy_", "cat", "stack", "index", "index_select",
        "gather", "embedding", "index_copy_", "index_put_", "slice_scatter",
        "select_scatter", "scatter", "scatter_", "constant_pad_nd", "repeat",
        "flip", "roll", "tril", "triu", "empty", "empty_like",
        "empty_strided", "new_empty", "new_empty_strided", "zeros",
        "zeros_like", "new_zeros", "ones", "ones_like", "new_ones", "full",
        "full_like", "new_full", "fill_", "zero_", "arange", "scalar_tensor",
        "lift_fresh", "_local_scalar_dense", "masked_fill", "where"))


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts every operator the program dispatches, by its shapes:

    * ``flops``: matmul-class operators by ``torch.utils.flop_counter``'s
      formulas (2 a multiply-add), every other compute operator one a
      output element; views and the data movers of :data:`MOVES` none;
    * ``bytes``: each operator's input and output bytes (views none).  The
      eager port runs every operator as its own kernel, so this is its
      unfused traffic, an upper bound on what a fused program would move;
    * ``peak``: the peak of the live bytes of the storages the operators
      create (freed when their last tensor goes), outputs included.

    Operators run in autograd's own threads too: the mode follows them.
    """

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._seen: dict[int, int] = {}

    def _freed(self, key: int):
        self.live -= self._seen.pop(key, 0)

    def _track(self, t: torch.Tensor):
        storage = t.untyped_storage()
        key = id(storage)
        if key in self._seen:
            return
        self._seen[key] = storage.nbytes()
        self.live += storage.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._freed, key)

    def known(self, tree):
        """Mark ``tree``'s tensors as made before the run (arguments)."""
        for t in _tensors(tree):
            storage = t.untyped_storage()
            self._seen.setdefault(id(storage), 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        outs = _tensors(out)
        self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        self.bytes += sum(_nbytes(t) for t in outs)
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        elif packet not in MOVES:
            self.flops += sum(t.numel() for t in outs)
        for t in outs:
            self._track(t)
        return out


# ---------------------------------------------------------------------------
# Building a cell's program
# ---------------------------------------------------------------------------


def _index_dtype(batch: dict) -> dict:
    """The batch as the port's programs take it: integer inputs int64
    (torch's gather indexes in int64; ``repro`` and the count's arguments
    hold them in int32)."""
    return {k: v if v.is_floating_point() else v.long()
            for k, v in batch.items()}


@dataclasses.dataclass
class Cell:
    """A cell's program on its mesh: ``run()`` runs one step on ``args``
    (placed on the mesh); ``arg_bytes`` is each position's bytes of them
    (``repro``'s ``argument_size_in_bytes``)."""

    run: Any
    args: Any
    arg_bytes: int
    mesh: Any
    fsdp: bool


def _position_bytes(tree, specs, mesh) -> int:
    """The bytes position (0, 0) holds of ``tree``: a ``Sharded`` leaf's
    shard, another tensor's slice by its spec in ``specs`` (a leaf per
    tensor; None: whole, as a 0-d scalar is)."""
    total = 0

    def add(x, spec=None):
        nonlocal total
        if isinstance(x, placement.Sharded):
            total += _nbytes(x.shards[0][0])
        elif isinstance(x, torch.Tensor):
            total += _nbytes(x) // (placement._pieces(spec, mesh)
                                    if spec else 1)
        return x

    if specs is None:
        placement.tree_map(add, tree)
    else:
        placement.tree_map(lambda s, x: add(x, s), specs, tree)
    return total


def lower_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               fsdp: bool | None = None, generator=None) -> Cell:
    """Build the cell's step on ``mesh`` (``build_programs`` with
    ``repro``'s FSDP choice: ``fsdp_recommended`` against ``chip_memory``),
    with its arguments placed on the mesh: the AdamW train state and a
    batch for train, the float32 parameters and a batch (prefill) or
    bfloat16 caches, the tokens and the position (decode).  Compute is
    bfloat16, as in ``repro``.  On a ``"meta"`` mesh nothing is allocated;
    on a real one ``generator`` (on its first device) draws the weights
    and tokens, and the caches start at zero."""
    device = mesh.first_device
    real = generator is not None
    model = LanguageModel(cfg, device=device if real else "meta")
    if fsdp is None:
        fsdp = rules_lib.fsdp_recommended(model.n_params(), mesh,
                                          rules_lib.chip_memory(mesh))
    spec = steps_lib.input_specs(cfg, shape)
    progs = steps_lib.build_programs(
        model, mesh, fsdp=fsdp, compute_dtype=torch.bfloat16,
        cache_shapes=spec["caches"] if shape.kind == "decode" else None)
    batch_specs = steps_lib.batch_pspecs(cfg, mesh)

    def params():
        if not real:
            return model.abstract(torch.float32)
        return model.init(generator).stacked_dict()

    def inputs(tree):
        def make(s):
            if real and not s.dtype.is_floating_point:
                return torch.randint(0, cfg.vocab_size, s.shape,
                                     dtype=s.dtype, device=device,
                                     generator=generator)
            if real:
                return torch.randn(s.shape, dtype=s.dtype, device=device,
                                   generator=generator) * 0.02
            return torch.empty(s.shape, dtype=s.dtype, device=device)

        return placement.tree_map(make, tree,
                                  is_leaf=lambda x: isinstance(x, TensorSpec))

    if shape.kind == "train":
        p = params()
        state = placement.put_tree(
            steps_lib.TrainState(p, AdamW().init(p),
                                 torch.zeros((), dtype=torch.int32)),
            progs.state_shardings)
        del p
        batch = inputs(spec)
        args = (state, batch)
        arg_bytes = (_position_bytes(state, None, mesh)
                     + _position_bytes(batch, batch_specs, mesh))

        def run():
            return progs.train_step(state, _index_dtype(batch))
    elif shape.kind == "prefill":
        weights = placement.put_tree(params(), progs.state_shardings.params)
        batch = inputs(spec)
        args = (weights, batch)
        arg_bytes = (_position_bytes(weights, None, mesh)
                     + _position_bytes(batch, batch_specs, mesh))

        def run():
            return progs.prefill(weights, _index_dtype(batch),
                                 shape.seq_len, cache_dtype=torch.bfloat16)
    else:
        weights = placement.put_tree(params(), progs.state_shardings.params)
        caches = placement.tree_map(
            lambda sh, s: placement.zeros(s.shape, s.dtype, sh),
            progs.cache_shardings, spec["caches"])
        token = inputs(spec["token"])
        pos = torch.zeros((), dtype=torch.int32)
        args = (weights, caches, token, pos)
        arg_bytes = (_position_bytes((weights, caches), None, mesh)
                     + _nbytes(token) + _nbytes(pos))

        def run():
            return progs.serve_step(weights, caches, token, pos)
    model.release()
    return Cell(run, args, arg_bytes, mesh, fsdp)


# ---------------------------------------------------------------------------
# Cost extraction
# ---------------------------------------------------------------------------


def compile_and_extract(cell: Cell) -> dict:
    """Run ``cell`` once under an :class:`OpCounter` and a collective count.
    Returns ``repro``'s dict: ``cost`` (``flops``, ``bytes accessed``),
    ``collectives``, ``memory`` per position (``argument_size_in_bytes`` and
    ``output_size_in_bytes`` exact, ``temp_size_in_bytes`` the counter's
    peak over the mesh's positions: a ``"meta"`` mesh cannot tell its
    positions' allocations apart) and ``run_s``, the run's seconds (nothing
    compiles)."""
    counter = OpCounter()
    counter.known(cell.args)
    t0 = time.monotonic()
    with collective_bytes() as coll, counter:
        out = cell.run()
    run_s = time.monotonic() - t0
    positions = cell.mesh.size
    return {
        "run_s": run_s,
        "cost": {"flops": float(counter.flops),
                 "bytes accessed": float(counter.bytes)},
        "collectives": coll,
        "memory": {
            "argument_size_in_bytes": int(cell.arg_bytes),
            "output_size_in_bytes": _position_bytes(out, None, cell.mesh),
            "temp_size_in_bytes": int(counter.peak // positions),
        },
        "fsdp": cell.fsdp,
    }


def _scaled_pattern(cfg: ModelConfig, repeats: list[int]) -> ModelConfig:
    pattern = tuple(
        (r, kinds) for r, (_, kinds) in zip(repeats, cfg.pattern)
    )
    n_layers = sum(r * len(k) for r, k in pattern)
    return dataclasses.replace(cfg, pattern=pattern, n_layers=n_layers,
                               unroll_groups=True)


def _with_enc(cfg: ModelConfig, n_enc: int) -> ModelConfig:
    return dataclasses.replace(cfg, n_enc_layers=n_enc)


def roofline_for_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      fsdp: bool | None = None) -> dict:
    """L-extrapolated cost vector + roofline terms (see analysis module).

    An eager count is exactly linear in depth; the extrapolation saves
    time, since one controller runs every position of the mesh.  The FSDP
    choice is the full model's, so the shallow runs shard as it does."""
    if fsdp is None:
        fsdp = rules_lib.fsdp_recommended(
            LanguageModel(cfg, device="meta").n_params(), mesh,
            rules_lib.chip_memory(mesh))
    repeats = [r for r, _ in cfg.pattern]
    base_cfg = _scaled_pattern(cfg, [1] * len(repeats))
    if cfg.n_enc_layers:
        base_cfg = _with_enc(base_cfg, 1)
    ex_base = compile_and_extract(lower_cell(base_cfg, shape, mesh, fsdp))
    c_base = cost_vector(ex_base["cost"], ex_base["collectives"])

    slopes: list[CostVector] = []
    lowerings = {"base": ex_base}
    for g in range(len(repeats)):
        reps = [1] * len(repeats)
        reps[g] = 2
        cfg_g = _scaled_pattern(cfg, reps)
        if cfg.n_enc_layers:
            cfg_g = _with_enc(cfg_g, 1)
        ex_g = compile_and_extract(lower_cell(cfg_g, shape, mesh, fsdp))
        lowerings[f"group{g}x2"] = ex_g
        slopes.append(cost_vector(ex_g["cost"], ex_g["collectives"]))
    total = extrapolate(c_base, slopes, repeats)

    if cfg.n_enc_layers:
        cfg_e = _with_enc(_scaled_pattern(cfg, [1] * len(repeats)), 2)
        ex_e = compile_and_extract(lower_cell(cfg_e, shape, mesh, fsdp))
        lowerings["encx2"] = ex_e
        enc_slope = cost_vector(ex_e["cost"], ex_e["collectives"]) - c_base
        total = total + enc_slope.scale(cfg.n_enc_layers - 1)

    # No scaling by the chip count, unlike repro's per-device SPMD
    # analysis: the count ran every position of the mesh, so it is global.
    rl = Roofline(
        flops=total.flops,
        bytes_accessed=total.bytes_accessed,
        collective_bytes=total.collective.get("total", 0.0),
        chips=mesh.size,
        model_flops=model_flops(cfg, shape),
        extra_flops=slstm_extra_flops(cfg, shape),
    )
    return {
        "roofline": rl.as_dict(),
        "collective_breakdown": total.collective,
        "lowerings": {
            k: {kk: v[kk] for kk in ("run_s", "cost", "collectives")}
            for k, v in lowerings.items()
        },
    }


# ---------------------------------------------------------------------------
# Cell driver
# ---------------------------------------------------------------------------


def dryrun_cell(arch: str, shape_name: str, mesh, *, roofline: bool = False,
                full_compile: bool = True, fsdp: bool | None = None) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    result: dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": mesh.spec,
        "axes": list(mesh.axis_names),
        "chips": mesh.size,
    }
    if not ok:
        result["status"] = "skipped"
        result["reason"] = reason
        return result
    try:
        if full_compile:
            result["full"] = compile_and_extract(
                lower_cell(cfg, shape, mesh, fsdp))
        if roofline:
            result.update(roofline_for_cell(cfg, shape, mesh, fsdp))
        result["status"] = "ok"
    except Exception as e:
        result["status"] = "failed"
        result["error"] = f"{type(e).__name__}: {e}"
        raise
    return result


def save_artifact(result: dict, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    mesh_tag = "multipod" if result.get("chips", 0) > 256 else "pod"
    path = os.path.join(
        out_dir, f"{result['arch']}__{result['shape']}__{mesh_tag}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return path


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCHS for s in SHAPES]


# ---------------------------------------------------------------------------
# The paper's own workload as a dry-run citizen: distributed EEI at scale
# ---------------------------------------------------------------------------


def lower_paper_eei(mesh, n: int = 4096, logspace: bool = True,
                    reduce: str = "sum") -> Cell:
    """The EEI component-table computation (Algorithm 2's hot loop) on the
    mesh, in pure torch as ``repro`` keeps it pure ``jnp``: a batch of
    matrices on the data axes, the spectra ``lam`` split over them, the
    minor spectra ``mu`` over (data, ``model``), the table over (data, -,
    ``model``).  Each position computes its minors' columns against the
    whole spectrum of its matrices (the denominator's work replicated over
    ``model``, as in ``repro``'s ``"sum"`` form).  ``reduce="dot_bf16"``
    holds ``mu`` in bfloat16, upcast before the contraction."""
    from repro_torch.core import identity

    device = mesh.first_device
    d_axes = rules_lib.data_axes(mesh)
    batch = rules_lib.mesh_axis_size(mesh, "data") * rules_lib.mesh_axis_size(
        mesh, "pod")
    mu_dtype = torch.bfloat16 if reduce == "dot_bf16" else torch.float32
    reduce_kind = "dot" if reduce.startswith("dot") else reduce
    lam = placement.put(torch.empty((batch, n), device=device),
                        placement.Sharding(mesh, P(d_axes, None)))
    mu = placement.put(torch.empty((batch, n, n - 1), dtype=mu_dtype,
                                   device=device),
                       placement.Sharding(mesh, P(d_axes, "model", None)))

    def table(lam_r, mu_m):
        mu_m = mu_m.float()
        if reduce_kind == "dot":
            log_num = identity.logabs_numerator_dot(lam_r, mu_m)
            log_den = identity.logabs_denominator_dot(lam_r)
            return torch.exp(log_num - log_den[:, :, None])
        return identity.magnitudes_from_spectra(lam_r, mu_m,
                                                logspace=logspace,
                                                reduce=reduce_kind)

    def run():
        rows = []
        for r in range(len(mesh.devices)):
            lam_r = lam.split(r, gather_data=False).full()
            rows.append([table(lam_r.to(mu_m.device), mu_m)
                         for mu_m in mu.split(r, gather_data=False).parts])
        return placement.Sharded(rows, P(d_axes, None, "model"), mesh,
                                 (batch, n, n))

    return Cell(run, (lam, mu), _position_bytes((lam, mu), None, mesh), mesh,
                False)


def dryrun_paper_eei(mesh, n: int = 4096, reduce: str = "sum") -> dict:
    ex = compile_and_extract(lower_paper_eei(mesh, n, reduce=reduce))
    chips = mesh.size
    total = cost_vector(ex["cost"], ex["collectives"])
    batch = rules_lib.mesh_axis_size(mesh, "data") * rules_lib.mesh_axis_size(
        mesh, "pod")
    # useful flops: 3 ops (sub, log-abs, add) per (i, j, k) numerator term
    # + n^2 denominator, per matrix in the batch.
    useful = 3.0 * batch * (float(n) ** 3)
    rl = Roofline(
        flops=total.flops,
        bytes_accessed=total.bytes_accessed,
        collective_bytes=total.collective.get("total", 0.0),
        chips=chips,
        model_flops=useful,
    )
    return {
        "arch": "paper-eei", "shape": f"n{n}",
        "mesh": mesh.spec,
        "chips": chips, "status": "ok",
        "full": ex,
        "roofline": rl.as_dict(),
        "collective_breakdown": total.collective,
    }
