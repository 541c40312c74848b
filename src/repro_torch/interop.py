"""Carrying a ``repro`` problem across to the port.

The EEI engine has no weights: its state is the plan and the input stack.
:func:`plan_from_reference` takes ``dataclasses.asdict`` of a ``repro``
plan and maps its backend names (``pallas -> cuda``, ``jnp -> torch``,
``sharded -> sharded`` on a port mesh the caller gives);
:func:`stack_from_numpy` puts a numpy stack on a device.  Both packages can
then run the same plan on the same data.  The language model has weights:
:func:`params_from_reference` loads ``repro``'s into the port's model,
and :func:`train_state_from_reference` turns ``repro``'s ``TrainState``
into the port's, so both packages can start a training step from one
state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine.plan import SolverPlan

BACKEND_NAMES = {"reference": "reference", "jnp": "torch", "pallas": "cuda",
                 "sharded": "sharded"}


def plan_from_reference(fields: dict, mesh=None) -> SolverPlan:
    """The port's :class:`SolverPlan` for the fields of a ``repro`` plan.

    A ``repro`` mesh is a set of JAX devices, which the port cannot use: a
    plan that holds one takes the port's ``mesh`` (a
    :class:`~repro_torch.launch.mesh.Mesh` of the same shape) in its place.
    """
    fields = dict(fields)
    backend = fields.pop("backend")
    r_mesh = fields.pop("mesh", None)
    if r_mesh is not None or backend == "sharded":
        if mesh is None:
            raise ValueError("a plan on a mesh needs the port's mesh (mesh=)")
        if r_mesh is not None and dict(r_mesh.shape) != mesh.shape:
            raise ValueError(f"mesh shapes differ: {dict(r_mesh.shape)} in "
                             f"repro, {mesh.shape} in the port")
        fields["mesh"] = mesh
    return SolverPlan(backend=BACKEND_NAMES[backend], **fields)


def stack_from_numpy(a: np.ndarray, device, dtype: torch.dtype | None = None):
    """A numpy matrix or stack as a tensor on ``device`` (``dtype`` if given,
    else the array's own)."""
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


def params_from_reference(model, flat: dict) -> None:
    """Load ``repro``'s flat parameter dict (``LanguageModel.init``'s output
    as numpy arrays, layer groups stacked on axis 0) into the port's
    ``models.lm.LanguageModel``, one row of each stacked array per layer,
    cast to the model's dtype on its device.  Every name and shape must
    match both ways: a key of ``flat`` the model does not hold, a parameter
    ``flat`` does not give, or a shape that differs raises ``ValueError``.
    """
    names = model.reference_names()
    table = model.param_table()
    extra = sorted(set(flat) - set(table))
    missing = sorted(set(table) - set(flat))
    if extra or missing:
        raise ValueError(f"repro's parameters and the port's differ: "
                         f"{extra} not in the port, {missing} not given")
    for key, decl in table.items():
        got = tuple(np.shape(flat[key]))
        if got != decl.shape:
            raise ValueError(f"{key}: repro gives {got}, the port's table "
                             f"declares {decl.shape}")
    weights = model.param_dict()
    with torch.no_grad():
        for name, (key, row) in names.items():
            src = np.asarray(flat[key])
            if row is not None:
                src = src[row]
            weights[name].copy_(torch.as_tensor(np.array(src)))


def _tensor(a, device) -> torch.Tensor:
    """A numpy (or JAX) array as a tensor on ``device``, bitwise; bfloat16
    (``ml_dtypes``') through its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a).view(np.uint16))
        return bits.view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(a), device=device)


def train_state_from_reference(state, device):
    """The port's ``train.steps.TrainState`` for ``repro``'s (its
    parameters, ``AdamWState`` or ``EigenPreState`` and step, as numpy or
    JAX arrays): every tensor on ``device`` with the array's dtype, bitwise,
    but the optimizer's ``count`` and the ``step``, which the port keeps as
    0-d int32 CPU tensors."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.optim.eigenpre import EigenPreState
    from repro_torch.train.steps import TrainState

    def tree(d):
        return {k: _tensor(v, device) for k, v in d.items()}

    def count(c):
        return torch.tensor(int(np.asarray(c)), dtype=torch.int32)

    def adamw(s):
        return AdamWState(count(s.count), tree(s.m), tree(s.v))

    opt = state.opt_state
    if getattr(opt, "_fields", None) == AdamWState._fields:
        opt_state = adamw(opt)
    elif getattr(opt, "_fields", None) == EigenPreState._fields:
        opt_state = EigenPreState(adamw(opt.adamw), tree(opt.gram),
                                  tree(opt.eigvals), tree(opt.eigvecs))
    else:
        raise TypeError(f"unknown optimizer state {type(opt).__name__}")
    return TrainState(tree(state.params), opt_state, count(state.step))
