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

A mesh may also carry ``repro``'s ``pod`` axis, ``(pod, data, model)``:
pure data parallelism over pods, whose data rows are the ``pod x data``
positions flattened pod-major.  :func:`make_production_mesh` gives
``repro``'s production meshes on the ``"meta"`` device, for the dry run
(``launch.dryrun``).
"""

from __future__ import annotations

import dataclasses
import logging

import torch

#: The axis names a mesh may have: ``repro``'s two- and three-axis meshes.
AXES_2D = ("data", "model")
AXES_3D = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` or ``(pod, data, model)`` grid of devices with
    named axes.

    Frozen and hashable, so that a :class:`~repro_torch.engine.plan.
    SolverPlan` holding one stays a cache key.  ``devices`` is a tuple of
    rows, one per data row: with a ``pod`` axis of ``P`` and a ``data``
    axis of ``D``, ``P * D`` rows, row ``p * D + d`` at pod ``p``, data
    index ``d``.  ``pods`` is ``P`` (1 without a pod axis).
    """

    devices: tuple
    axis_names: tuple = AXES_2D
    pods: int = 1

    def __post_init__(self):
        grid = tuple(tuple(torch.device(d) for d in row)
                     for row in self.devices)
        if not grid or not grid[0] or len({len(r) for r in grid}) != 1:
            raise ValueError(f"mesh devices must be a non-empty rectangular "
                             f"grid, got {self.devices!r}")
        names = tuple(self.axis_names)
        if names not in (AXES_2D, AXES_3D):
            raise ValueError(f"a mesh's axes are {AXES_2D} or {AXES_3D}, "
                             f"got {names!r}")
        pods = self.pods if names == AXES_3D else 1
        if pods < 1 or len(grid) % pods:
            raise ValueError(f"{len(grid)} data rows do not split into "
                             f"{self.pods} pods")
        object.__setattr__(self, "devices", grid)
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "pods", pods)

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        sizes = {"data": len(self.devices) // self.pods,
                 "model": len(self.devices[0])}
        if self.axis_names == AXES_3D:
            sizes = {"pod": self.pods, **sizes}
        return sizes

    def position(self, r: int, m: int) -> dict:
        """Axis name -> index of data row ``r``, model column ``m``."""
        data = len(self.devices) // self.pods
        return {"pod": r // data, "data": r % data, "model": m}

    @property
    def spec(self) -> str:
        """The mesh's ``--mesh`` spec: ``"DxM"`` or ``"PxDxM"``."""
        return "x".join(str(n) for n in self.shape.values())

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
        """The devices along ``axis``, at index 0 of the other axes: the
        device that runs each shard of a stage split over ``axis``."""
        if axis not in self.axis_names:
            raise ValueError(f"axis {axis!r} not in mesh axes "
                             f"{self.axis_names}")
        if axis == "model":
            return self.devices[0]
        data = len(self.devices) // self.pods
        rows = range(0, len(self.devices), data) if axis == "pod" else range(
            data)
        return tuple(self.devices[r][0] for r in rows)


def make_local_mesh(data: int = 1, model: int = 1, devices=None,
                    pod: int | None = None) -> Mesh:
    """A ``(data, model)`` mesh, or with ``pod`` a ``(pod, data, model)``
    one, over the first ``pod * data * model`` of ``devices`` (default: the
    cards, ``cuda:0``, ``cuda:1``, ...), row major.  Refuses when there are
    fewer; an explicit list may repeat a device."""
    pods = 1 if pod is None else pod
    spec = "x".join(str(a) for a in ((data, model) if pod is None
                                      else (pod, data, model)))
    if data < 1 or model < 1 or pods < 1:
        raise ValueError(f"mesh axes must be >= 1, got {spec}")
    need = pods * data * model
    if devices is None:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < need:
            raise RuntimeError(
                f"a {spec} mesh needs {need} CUDA devices, found "
                f"{found}; pass devices= (a device may repeat)")
        devices = [torch.device("cuda", i) for i in range(need)]
    devices = list(devices)
    if len(devices) < need:
        raise ValueError(f"a {spec} mesh needs {need} devices, got "
                         f"{len(devices)}")
    return Mesh(tuple(tuple(devices[r * model:(r + 1) * model])
                      for r in range(pods * data)),
                AXES_2D if pod is None else AXES_3D, pods)


def make_production_mesh(*, multi_pod: bool = False,
                         device="meta") -> Mesh:
    """``repro``'s production meshes: ``(data=16, model=16)``, 256
    positions, or with ``multi_pod`` ``(pod=2, data=16, model=16)``, 512.
    Every position is ``device`` (default ``"meta"``: the dry run's,
    which allocates nothing)."""
    pod = 2 if multi_pod else None
    return make_local_mesh(16, 16, devices=[device] * ((pod or 1) * 256),
                           pod=pod)


def chips(mesh: Mesh) -> int:
    return mesh.size


def mesh_spec(spec: str) -> tuple:
    """The axis sizes of a mesh spec, ``"DxM"`` or ``"PxDxM"``."""
    try:
        axes = tuple(int(p) for p in spec.split("x"))
    except ValueError:
        axes = ()
    if len(axes) not in (2, 3):
        raise ValueError(f"bad mesh spec {spec!r}: expected DxM or PxDxM")
    if min(axes) < 1:
        raise ValueError(f"bad mesh spec {spec!r}: axes must be >= 1")
    return axes


def mesh_axes(spec: str) -> tuple:
    """``(data, model)`` of a mesh spec ``"DxM"`` (the EEI server's meshes,
    which have no pod axis)."""
    axes = mesh_spec(spec)
    if len(axes) != 2:
        raise ValueError(f"bad mesh spec {spec!r}: expected DxM")
    return axes


def parse_mesh(spec: str, device=None) -> Mesh:
    """The mesh of a launcher's ``--mesh DxM`` or ``--mesh PxDxM`` (as
    ``repro``'s ``launch/train.py``): the first ``P*D*M`` cards, or with
    ``device`` that device repeated (``--device cpu`` repeats the CPU)."""
    *pod, data, model = mesh_spec(spec)
    pod = pod[0] if pod else None
    need = (pod or 1) * data * model
    devices = None if device is None else [device] * need
    return make_local_mesh(data, model, devices=devices, pod=pod)


def log_mesh_bytes(log: logging.Logger, mesh: Mesh, tree, what: str):
    """Log to ``log`` the mesh and the bytes each of its positions holds of
    ``tree`` (a launcher's record of a sharded state)."""
    from repro_torch.sharding.placement import device_bytes

    grid = device_bytes(tree, mesh)
    log.info("mesh %s on %s: %s bytes per device %s", mesh.shape,
             sorted({str(d) for row in mesh.devices for d in row}), what,
             grid)
    return grid
