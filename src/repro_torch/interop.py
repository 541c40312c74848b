"""Carrying a ``repro`` problem across to the port.

This system has no weights: its state is the plan and the input stack.
:func:`plan_from_reference` takes ``dataclasses.asdict`` of a ``repro``
plan and maps its backend names (``pallas -> cuda``, ``jnp -> torch``);
:func:`stack_from_numpy` puts a numpy stack on a device.  Both packages can
then run the same plan on the same data.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine.plan import SolverPlan

BACKEND_NAMES = {"reference": "reference", "jnp": "torch", "pallas": "cuda"}


def plan_from_reference(fields: dict) -> SolverPlan:
    """The port's :class:`SolverPlan` for the fields of a ``repro`` plan."""
    fields = dict(fields)
    backend = fields.pop("backend")
    if backend == "sharded" or fields.pop("mesh", None) is not None:
        raise NotImplementedError(
            "the sharded backend is not ported yet (ROADMAP queue 1, item 13)")
    # Mesh axis names mean nothing without a mesh.
    fields.pop("batch_axis", None)
    fields.pop("minor_axis", None)
    return SolverPlan(backend=BACKEND_NAMES[backend], **fields)


def stack_from_numpy(a: np.ndarray, device, dtype: torch.dtype | None = None):
    """A numpy matrix or stack as a tensor on ``device`` (``dtype`` if given,
    else the array's own)."""
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
