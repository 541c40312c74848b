"""Device meshes for the sharded backend.

The twin of ``repro.launch.mesh`` (and of ``parse_mesh`` in ``repro``'s
``launch/train.py``).  ``repro`` is single-controller: one process owns
every device of a ``jax.sharding.Mesh``, and the server decides each stack
before it runs over the whole mesh.  The port keeps that model: a
:class:`Mesh` is a named ``(data, model)`` grid of ``torch.device``s, and
the sharded stages run each shard on its own device from one process
(``core.distributed``).  A grid may repeat a device: a logical two-device
data axis on one card (``cuda:0`` twice) or on the CPU (``cpu`` twice),
the counterpart of ``--xla_force_host_platform_device_count``.

``repro``'s ``make_production_mesh`` builds TPU pod meshes for the dry-run
and is not ported with it.
"""

from __future__ import annotations

import dataclasses
import logging

import torch

#: ``repro``'s three-axis ``--mesh PxDxM`` (a ``pod`` axis over TPU pods)
#: is not ported: it comes with ``make_production_mesh`` and the dry run.
POD_MESH_REFUSAL = ("--mesh {}: a PxDxM mesh (repro's pod axis) waits for "
                    "the dry-run slice, which ports make_production_mesh; "
                    "pass DxM")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` grid of devices with named axes.

    Frozen and hashable, so that a :class:`~repro_torch.engine.plan.
    SolverPlan` holding one stays a cache key.  ``devices`` is a tuple of
    rows, one per index along the first axis.
    """

    devices: tuple
    axis_names: tuple = ("data", "model")

    def __post_init__(self):
        grid = tuple(tuple(torch.device(d) for d in row)
                     for row in self.devices)
        if not grid or not grid[0] or len({len(r) for r in grid}) != 1:
            raise ValueError(f"mesh devices must be a non-empty rectangular "
                             f"grid, got {self.devices!r}")
        names = tuple(self.axis_names)
        if len(names) != 2 or len(set(names)) != 2:
            raise ValueError(f"a mesh has two distinct axis names, got "
                             f"{names!r}")
        object.__setattr__(self, "devices", grid)
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return {self.axis_names[0]: len(self.devices),
                self.axis_names[1]: len(self.devices[0])}

    @property
    def size(self) -> int:
        """Devices in the grid (a repeated device counts each time)."""
        return len(self.devices) * len(self.devices[0])

    @property
    def first_device(self) -> torch.device:
        """Where the sharded stages take their inputs and leave their
        outputs."""
        return self.devices[0][0]

    def axis_devices(self, axis: str) -> tuple:
        """The devices along ``axis``, at index 0 of the other axis: the
        device that runs each shard of a stage split over ``axis``."""
        if axis == self.axis_names[0]:
            return tuple(row[0] for row in self.devices)
        if axis == self.axis_names[1]:
            return self.devices[0]
        raise ValueError(f"axis {axis!r} not in mesh axes {self.axis_names}")


def make_local_mesh(data: int = 1, model: int = 1, devices=None) -> Mesh:
    """A ``(data, model)`` mesh over the first ``data * model`` of
    ``devices`` (default: the cards, ``cuda:0``, ``cuda:1``, ...), row
    major.  Refuses when there are fewer; an explicit list may repeat a
    device."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got {data}x{model}")
    need = data * model
    if devices is None:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < need:
            raise RuntimeError(
                f"a {data}x{model} mesh needs {need} CUDA devices, found "
                f"{found}; pass devices= (a device may repeat)")
        devices = [torch.device("cuda", i) for i in range(need)]
    devices = list(devices)
    if len(devices) < need:
        raise ValueError(f"a {data}x{model} mesh needs {need} devices, got "
                         f"{len(devices)}")
    return Mesh(tuple(tuple(devices[r * model:(r + 1) * model])
                      for r in range(data)))


def chips(mesh: Mesh) -> int:
    return mesh.size


def mesh_axes(spec: str) -> tuple:
    """``(data, model)`` of a mesh spec ``"DxM"``."""
    try:
        data, model = (int(p) for p in spec.split("x"))
    except ValueError:
        raise ValueError(f"bad mesh spec {spec!r}: expected DxM") from None
    if data < 1 or model < 1:
        raise ValueError(f"bad mesh spec {spec!r}: axes must be >= 1")
    return data, model


def parse_mesh(spec: str, device=None) -> Mesh:
    """The mesh of a launcher's ``--mesh DxM``: the first ``D*M`` cards, or
    with ``device`` that device repeated ``D*M`` times (``--device cpu``
    repeats the CPU)."""
    data, model = mesh_axes(spec)
    devices = None if device is None else [device] * (data * model)
    return make_local_mesh(data, model, devices=devices)


def log_mesh_bytes(log: logging.Logger, mesh: Mesh, tree, what: str):
    """Log to ``log`` the mesh and the bytes each of its positions holds of
    ``tree`` (a launcher's record of a sharded state)."""
    from repro_torch.sharding.placement import device_bytes

    grid = device_bytes(tree, mesh)
    log.info("mesh %s on %s: %s bytes per device %s", dict(mesh.shape),
             sorted({str(d) for row in mesh.devices for d in row}), what,
             grid)
    return grid
