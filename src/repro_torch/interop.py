"""Carrying a ``repro`` problem across to the port.

This system has no weights: its state is the plan and the input stack.
:func:`plan_from_reference` takes ``dataclasses.asdict`` of a ``repro``
plan and maps its backend names (``pallas -> cuda``, ``jnp -> torch``,
``sharded -> sharded`` on a port mesh the caller gives);
:func:`stack_from_numpy` puts a numpy stack on a device.  Both packages can
then run the same plan on the same data.
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
