"""Training and serving step factories, the twins of ``repro.train.steps``.

    train_step(state, batch)               -> (state, metrics)
    serve_step(params, caches, token, pos) -> (next_token, caches)

The trainer holds ``repro``'s layout: :class:`TrainState`'s parameters are
``repro``'s flat dict with each layer group stacked on a leading axis
(``LanguageModel.stacked_dict``), so the optimizer sees ``repro``'s tree
key for key: ``EigenPre``'s eligibility, the global norm and the
checkpoint's keys all match.  Each step casts the stacked tensors to the
compute dtype and unbinds them once into the per-layer dict the model's
loss takes (``LanguageModel.unstack``).  Master parameters stay float32;
gradients and the update are float32 (``AdamW``).  ``repro``'s launcher
donates the state to its jitted step; the port's step updates it in place.
``step`` is a 0-d int32 CPU tensor, so the schedule and ``EigenPre``'s
refresh decision cost no device sync.

``repro`` casts the parameters inside its jitted ``serve_step``, where XLA
folds the cast away.  Eager PyTorch would copy every weight on every
token, so callers cast once with :func:`cast_tree` before the decode loop:
``cast_tree`` of a tensor already in ``dtype`` returns it as it is, and the
step's own cast is then free.  The values are the same.

On a mesh, :func:`build_programs` gives the same two steps over sharded
state (``sharding.placement``): parameters, optimizer state and caches
split by ``repro``'s spec trees (:func:`state_pspecs`,
:func:`cache_pspecs`), the model run a data row at a time with the model
axis split inside each row (``models.lm.MeshLM``).  One process drives
every device of the mesh (``repro`` is single-controller); on one card a
logical mesh repeats the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import blocks
from repro_torch.models.attention import TensorSpec
from repro_torch.models.lm import LanguageModel, MeshLM
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.optim.eigenpre import EigenPre, EigenPreState
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.sharding import hints as hints_lib
from repro_torch.sharding import placement
from repro_torch.sharding import rules as rules_lib
from repro_torch.sharding.rules import P
from repro_torch.train.microbatch import accumulated_grads


class TrainState(NamedTuple):
    params: dict  # repro's flat dict, layer groups stacked on axis 0
    opt_state: Any  # AdamWState or EigenPreState
    step: torch.Tensor  # 0-d int32, on the CPU


def cast_tree(tree, dtype):
    """Every floating tensor of a nested dict / list / tuple in ``dtype``
    (a tensor already in it is returned as it is); other leaves unchanged."""
    if isinstance(tree, placement.Sharded):
        return tree.map(lambda t: cast_tree(t, dtype))
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def make_serve_step(model: LanguageModel, compute_dtype=torch.bfloat16):
    """``serve_step(params, caches, token, pos) -> (next_token, caches)``:
    one greedy decode step in ``compute_dtype`` (caches updated in place)."""

    def serve_step(params, caches, token, pos):
        logits, caches = model.decode_step(
            cast_tree(params, compute_dtype), caches, token, pos)
        return torch.argmax(logits, dim=-1), caches

    return serve_step


def put_batch(batch: dict, device) -> dict:
    """A numpy batch (``data.SyntheticLM``'s) as tensors on ``device``;
    integer arrays become int64, the index dtype of the embedding and the
    loss's gather."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


def make_train_step(
    model: LanguageModel,
    optimizer=None,
    compute_dtype=torch.bfloat16,
    schedule: Callable = warmup_cosine,
    microbatch: int | None = None,
):
    """``train_step(state, batch) -> (state, metrics)``: the loss and its
    float32 gradients in ``compute_dtype`` (accumulated over
    ``microbatch`` microbatches when > 1), then ``optimizer.update`` (AdamW
    by default) at ``schedule(state.step)``.  The state is updated in
    place and returned with ``step + 1``; ``metrics`` holds the model's
    (``ce``, ``aux``), ``loss``, ``lr_scale`` and the optimizer's
    (``grad_norm``)."""
    optimizer = optimizer or AdamW()
    n_micro = microbatch if microbatch and microbatch > 1 else 1

    def loss_fn(params, batch):
        return model.loss(model.unstack(cast_tree(params, compute_dtype)),
                          batch)

    def train_step(state: TrainState, batch: dict):
        loss, metrics, grads = accumulated_grads(loss_fn, state.params,
                                                 batch, n_micro)
        lr_scale = schedule(state.step)
        new_params, opt_state, opt_metrics = optimizer.update(
            grads, state.opt_state, state.params, lr_scale)
        metrics = dict(metrics, loss=loss, lr_scale=lr_scale, **opt_metrics)
        return TrainState(new_params, opt_state, state.step + 1), metrics

    return train_step


# ---------------------------------------------------------------------------
# Spec trees (repro's)
# ---------------------------------------------------------------------------


def param_pspecs(model: LanguageModel, rules: rules_lib.ShardingRules) -> dict:
    table = model.param_table()
    return {p: rules.spec_for(d.shape, d.axes) for p, d in table.items()}


def state_pspecs(model: LanguageModel, rules: rules_lib.ShardingRules):
    """``repro``'s state spec tree: always AdamW's (see
    :func:`optimizer_state_pspecs` for ``EigenPre``'s)."""
    ps = param_pspecs(model, rules)
    return TrainState(
        params=ps,
        opt_state=AdamWState(count=P(), m=dict(ps), v=dict(ps)),
        step=P(),
    )


def optimizer_state_pspecs(optimizer, ps: dict):
    """The spec tree of ``optimizer.init(params)`` (``optimizer`` may also
    be such a state): AdamW's moments take the parameters' specs;
    ``EigenPre``'s grams and factors are whole on the mesh's first device
    (spec None).  ``repro``'s :func:`state_pspecs` gives AdamW's tree
    whatever the optimizer, which ``EigenPre``'s state does not match."""
    adamw = AdamWState(count=P(), m=dict(ps), v=dict(ps))
    if isinstance(optimizer, (EigenPre, EigenPreState)):
        whole = {k: None for k in ps}
        return EigenPreState(adamw, dict(whole), dict(whole), dict(whole))
    return adamw


def batch_pspecs(cfg: ModelConfig, mesh) -> dict:
    d = rules_lib.data_axes(mesh)
    specs = {"tokens": P(d, None), "labels": P(d, None)}
    if cfg.family == "audio":
        specs["frames"] = P(d, None, None)
    if cfg.family == "vlm":
        specs["images"] = P(d, None, None)
    return specs


def _kv_heads_spec(mesh, n_kv_heads: int) -> P:
    """(L, B, S, Hkv, Dh): heads on model if divisible, else sequence."""
    d = rules_lib.data_axes(mesh)
    if n_kv_heads % rules_lib.mesh_axis_size(mesh, "model") == 0:
        return P(None, d, None, "model", None)
    return P(None, d, "model", None, None)


def cache_pspecs(model: LanguageModel, mesh):
    """Spec tree matching ``model.cache_spec`` exactly."""
    cfg = model.cfg
    d = rules_lib.data_axes(mesh)
    msz = rules_lib.mesh_axis_size(mesh, "model")

    def attn_spec():
        return {"k": _kv_heads_spec(mesh, cfg.n_kv_heads),
                "v": _kv_heads_spec(mesh, cfg.n_kv_heads)}

    def kind_spec(kind: str):
        if kind in blocks._ATTN_KINDS:
            return attn_spec()
        if kind in ("mla", "mla_moe"):
            return {"latent": P(None, d, "model", None),
                    "k_rope": P(None, d, "model", None)}
        if kind == "cross":
            return attn_spec()
        if kind == "dec_cross":
            return {"self": attn_spec(), "cross": attn_spec()}
        if kind == "mamba":
            mcfg = blocks.mamba_config(cfg)
            h_ax = "model" if mcfg.n_heads % msz == 0 else None
            di_ax = "model" if mcfg.d_inner % msz == 0 else None
            return {
                "ssm": P(None, d, h_ax, None, None),
                "conv_x": P(None, d, None, di_ax),
                "conv_b": P(None, d, None, None),
                "conv_c": P(None, d, None, None),
            }
        if kind == "mlstm":
            mcfg = blocks.mlstm_config(cfg)
            h_ax = "model" if mcfg.n_heads % msz == 0 else None
            di_ax = "model" if mcfg.d_inner % msz == 0 else None
            return {
                "s": P(None, d, h_ax, None, None),
                "n": P(None, d, h_ax, None),
                "conv": P(None, d, None, di_ax),
            }
        if kind == "slstm":
            return {"carry": [P(None, d, None)] * 4}
        raise ValueError(kind)

    return [
        {f"b{bi}:{kind}": kind_spec(kind) for bi, kind in enumerate(kinds)}
        for _, kinds in cfg.pattern
    ]


def prune_specs(spec_tree, shape_tree, mesh):
    """Drop spec axes that do not divide the actual dimension (e.g. batch=1
    long-context caches on a 16-way data axis)."""
    mesh_shape = rules_lib.axis_sizes(mesh)

    def size(ax) -> int:
        if ax is None:
            return 1
        if isinstance(ax, (tuple, list)):
            out = 1
            for a in ax:
                out *= mesh_shape.get(a, 1)
            return out
        return mesh_shape.get(ax, 1)

    def prune(spec: P, shaped) -> P:
        dims = shaped.shape
        out = list(spec) + [None] * (len(dims) - len(spec))
        for i, ax in enumerate(out):
            if dims[i] % size(ax):
                out[i] = None
        return P(*out)

    return placement.tree_map(prune, spec_tree, shape_tree)


# ---------------------------------------------------------------------------
# Programs on a mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CompiledPrograms:
    """``repro``'s programs and shardings, plus the port's ``prefill``
    (``repro``'s launcher jits ``model.prefill`` with the cache shardings)
    and ``decode_step`` (``serve_step``'s logits), and whether the rules are
    FSDP's.  ``state_shardings`` are the optimizer's own
    (:func:`optimizer_state_pspecs`)."""

    train_step: Any = None
    serve_step: Any = None
    state_shardings: Any = None
    batch_shardings: Any = None
    cache_shardings: Any = None
    prefill: Any = None
    decode_step: Any = None
    fsdp: bool = False


def build_programs(
    model: LanguageModel,
    mesh,
    fsdp: bool | None = None,
    optimizer=None,
    compute_dtype=torch.bfloat16,
    microbatch: int | None = None,
    cache_shapes=None,  # pass model.cache_spec(...) to prune indivisible axes
) -> CompiledPrograms:
    """The train and serve steps of ``model`` on ``mesh``.

    ``train_step(state, batch) -> (state, metrics)`` takes a state placed
    by ``state_shardings`` (``placement.put_tree``) and a global batch of
    tensors (numpy arrays via ``put_batch``); it updates the state in place.
    ``serve_step(params, caches, token, pos) -> (next_token, caches)``,
    ``decode_step`` (the same, returning the logits) and ``prefill(params,
    batch, smax, cache_dtype=None) -> (logits, caches)`` take the placed
    parameters; ``prefill`` allocates the caches by
    :func:`cache_pspecs`, pruned against their shapes.  ``decode_step``
    and ``prefill`` take ``stats`` as ``LanguageModel.prefill`` does.  ``fsdp`` None
    decides by :func:`~repro_torch.sharding.rules.fsdp_recommended`
    against the mesh's memory (:func:`~repro_torch.sharding.rules.
    chip_memory`).
    """
    cfg = model.cfg
    optimizer = optimizer or AdamW()
    if fsdp is None:
        fsdp = rules_lib.fsdp_recommended(model.n_params(), mesh,
                                          rules_lib.chip_memory(mesh))
    rules = rules_lib.make_rules(mesh, fsdp=fsdp)
    ps = param_pspecs(model, rules)
    state_specs = TrainState(ps, optimizer_state_pspecs(optimizer, ps), P())
    batch_specs = batch_pspecs(cfg, mesh)
    cache_specs = cache_pspecs(model, mesh)
    if cache_shapes is not None:
        cache_specs = prune_specs(cache_specs, cache_shapes, mesh)
    mlm = MeshLM(model, mesh)
    n_micro = microbatch if microbatch and microbatch > 1 else 1

    def hinted(fn):
        def wrapped(*a, **k):
            with hints_lib.axis_hints(
                data=rules_lib.data_axes(mesh), model="model",
                model_size=rules_lib.mesh_axis_size(mesh, "model"),
            ):
                return fn(*a, **k)
        return wrapped

    def loss_fn(params, batch):
        return mlm.loss(cast_tree(params, compute_dtype), batch)

    @hinted
    def train_step(state: TrainState, batch: dict):
        loss, metrics, grads = accumulated_grads(loss_fn, state.params, batch,
                                                 n_micro)
        lr_scale = warmup_cosine(state.step)
        new_params, opt_state, opt_metrics = optimizer.update_sharded(
            grads, state.opt_state, state.params, lr_scale)
        metrics = dict(metrics, loss=loss, lr_scale=lr_scale, **opt_metrics)
        return TrainState(new_params, opt_state, state.step + 1), metrics

    @hinted
    def decode_step(params, caches, token, pos, stats=None):
        return mlm.decode_step(cast_tree(params, compute_dtype), caches,
                               token, pos, stats)

    def serve_step(params, caches, token, pos):
        logits, caches = decode_step(params, caches, token, pos)
        return torch.argmax(logits, dim=-1), caches

    @hinted
    def prefill(params, batch, smax, cache_dtype=None, stats=None):
        b = batch["tokens"].shape[0]
        dtype = cache_dtype or compute_dtype
        specs = prune_specs(cache_pspecs(model, mesh),
                            model.cache_spec(b, smax, dtype), mesh)
        caches = placement.tree_map(
            lambda spec, shp: placement.zeros(shp.shape, shp.dtype,
                                              placement.Sharding(mesh, spec)),
            specs, model.cache_spec(b, smax, dtype))
        return mlm.prefill(cast_tree(params, compute_dtype), batch, caches,
                           stats)

    return CompiledPrograms(
        train_step=train_step,
        serve_step=serve_step,
        state_shardings=placement.shardings_of(mesh, state_specs),
        batch_shardings=placement.shardings_of(mesh, batch_specs),
        cache_shardings=placement.shardings_of(mesh, cache_specs),
        prefill=prefill,
        decode_step=decode_step,
        fsdp=fsdp,
    )


# ---------------------------------------------------------------------------
# Abstract inputs ("meta" tensors and TensorSpecs), shared with the tests
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                compute_dtype=torch.bfloat16):
    """:class:`TensorSpec` stand-ins for every model input of a workload
    cell."""
    b = shape.global_batch
    if shape.kind in ("train", "prefill"):
        s = shape.seq_len
        specs = {
            "tokens": TensorSpec((b, s), torch.int32),
            "labels": TensorSpec((b, s), torch.int32),
        }
        if cfg.family == "audio":
            specs["frames"] = TensorSpec((b, cfg.enc_seq, cfg.d_model),
                                         compute_dtype)
        if cfg.family == "vlm":
            specs["images"] = TensorSpec((b, cfg.img_seq, cfg.d_model),
                                         compute_dtype)
        return specs
    # decode: one new token against a cache of seq_len
    model = LanguageModel(cfg, device="meta")
    return {
        "caches": model.cache_spec(b, shape.seq_len, compute_dtype),
        "token": TensorSpec((b,), torch.int32),
        "pos": TensorSpec((), torch.int32),
    }


def abstract_state(model: LanguageModel, optimizer=None) -> TrainState:
    """The train state as ``"meta"`` tensors (the step a 0-d int32 on the
    CPU, as the port's is)."""
    optimizer = optimizer or AdamW()
    params = model.abstract(torch.float32)
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32))
