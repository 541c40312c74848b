"""SolverPlan: one immutable record of every EEI pipeline choice.

The twin of ``repro.engine.plan`` with the port's backend names:

    method        eigh | eei_dense | eei_tridiag | eei_krylov | eei_krylov_si
    spectrum      full | windowed   (the full-spectrum top-k chain, or the
                  k-windowed chain that computes only the selected rows)
    backend       reference | torch | cuda | sharded   (the twins of
                  repro's reference | jnp | pallas | sharded:
                  straightforward PyTorch, fused PyTorch reductions, the
                  hand-written CUDA kernels, and the cuda stages split over
                  the batch axis of a device mesh)
    mesh          the ``launch.mesh.Mesh`` of a sharded plan, with its
                  ``batch_axis`` (the stack's) and ``minor_axis``
    precision     None (keep the input dtype) | "float32" | "float64"
    bisect_iters  Sturm bisection iterations (0 -> dtype default)
    max_batch     microbatch bound for long stacks (0 -> no bound)
    krylov_m      Krylov band size (0 -> ``lanczos.default_m(n, k)``)

:func:`plan_for` picks a plan from the problem shape and
:func:`packed_plan_for` one for a stack of segment-packed rows.  Their
crossovers come from the calibration table (``engine.autotune``: one
measured on the card by the port's own sweep; ``repro``'s table was
measured on a CPU and is never read); the static constants below apply
where no table resolves, as in every CPU process, since the committed
default was measured on the card.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Literal, Optional

if TYPE_CHECKING:
    from repro_torch.launch.mesh import Mesh

Method = Literal[
    "eigh", "eei_dense", "eei_tridiag", "eei_krylov", "eei_krylov_si"]
BackendName = Literal["reference", "torch", "cuda", "sharded"]
Spectrum = Literal["full", "windowed"]

METHODS = ("eigh", "eei_dense", "eei_tridiag", "eei_krylov", "eei_krylov_si")
BACKENDS = ("reference", "torch", "cuda", "sharded")

#: ``n`` at or below which a full ``eigh`` beats any EEI pipeline.
EIGH_CROSSOVER_N = 24

#: ``n`` up to which dense minor spectra beat tridiagonalize + Sturm.
DENSE_CROSSOVER_N = 64

#: ``k / n`` at or below which a top-k query plans the windowed chain.
WINDOWED_K_FRAC = 0.5

#: ``n`` at or above which a narrow top-k query plans the Krylov reduce.
KRYLOV_N_MIN = 1024

#: ``k / n`` at or below which the Krylov band is narrow enough to win.
KRYLOV_K_FRAC = 1.0 / 16.0

#: Largest request ``n`` that is packed as a segment of a shared row.
PACK_N_MAX = 32

#: Packed row width at or below which the packed program takes the eigh
#: chain; wider rows take the segmented-Sturm tridiagonal chain.
PACKED_EIGH_N_MAX = 128


def _measured(field: str, fallback):
    """The calibration table's ``field``, or ``fallback`` where no table
    resolves or the table lacks the field."""
    from repro_torch.engine import autotune

    table = autotune.get_table()
    value = None if table is None else getattr(table, field)
    return fallback if value is None else value


def resolved_crossovers(backend: Optional[str] = None) -> tuple:
    """``(eigh_crossover_n, dense_crossover_n)`` the planner dispatches on:
    the calibration table's pair for ``backend`` (``cuda`` has its own;
    ``sharded``, like every other backend, reads the ``torch`` pair, as
    ``repro``'s reads its ``jnp`` pair), or :data:`EIGH_CROSSOVER_N`,
    :data:`DENSE_CROSSOVER_N` with no table."""
    from repro_torch.engine import autotune

    table = autotune.get_table()
    if table is None:
        return EIGH_CROSSOVER_N, DENSE_CROSSOVER_N
    return table.crossovers_for(backend)


def resolved_windowed_k_frac() -> float:
    """The measured ``k / n`` at or below which the windowed chain wins."""
    return _measured("windowed_k_frac", WINDOWED_K_FRAC)


def resolved_krylov_n_min() -> int:
    """The measured ``n`` at which the Krylov reduce starts winning."""
    return _measured("krylov_n_min", KRYLOV_N_MIN)


def resolved_pack_n_max() -> int:
    """The largest request ``n`` worth packing."""
    return _measured("pack_n_max", PACK_N_MAX)


def resolved_packed_eigh_n_max() -> int:
    """The packed row width at or below which eigh takes the packed
    chain."""
    return _measured("packed_eigh_n_max", PACKED_EIGH_N_MAX)


def fallback_chain() -> tuple:
    """``((name, SolverPlan), ...)``: the per-request escalation chain.

    The serving runtime walks it after a request is isolated (a
    single-request stack that still fails, or a stack row failing verify),
    re-solving the *unpadded* matrix under each plan in turn and verifying
    the result on the host before it may resolve the future.  Ordered
    cheap-to-certain, as ``repro``'s:

    1. the windowed EEI chain (the request's own fast path without its
       co-batch);
    2. the full-spectrum EEI chain (a full bisection is sturdier than
       index-targeted windows on clustered spectra);
    3. shift-and-invert Krylov, the escape for clustered extremal groups;
    4. ``eigh``.

    The server appends a terminal numpy ``eigh`` link of its own.  The
    links name the ``cuda`` backend where ``repro``'s name ``jnp``: on CPU
    tensors it runs the same plain versions as ``torch``, and on the card
    it runs the kernels, where ``torch``'s Sturm bisection is the plain
    Python loop (seconds a call).
    """
    return (
        ("eei_windowed", SolverPlan(
            method="eei_tridiag", backend="cuda", spectrum="windowed")),
        ("eei_full", SolverPlan(method="eei_tridiag", backend="cuda")),
        ("eei_krylov_si", SolverPlan(
            method="eei_krylov_si", backend="cuda", spectrum="windowed")),
        ("eigh", SolverPlan(method="eigh", backend="cuda")),
    )


@dataclasses.dataclass(frozen=True)
class SolverPlan:
    """Immutable, hashable description of one way to run the EEI pipeline."""

    method: Method = "eei_tridiag"
    backend: BackendName = "cuda"
    spectrum: Spectrum = "full"
    mesh: Optional["Mesh"] = None
    batch_axis: str = "data"
    minor_axis: Optional[str] = "model"
    precision: Optional[str] = None  # None -> keep input dtype
    bisect_iters: int = 0  # 0 -> dtype default
    max_batch: int = 0  # 0 -> solve the whole stack at once
    krylov_m: int = 0  # Krylov band size; 0 -> lanczos.default_m(n, k)

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"unknown method {self.method!r}")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.spectrum not in ("full", "windowed"):
            raise ValueError(f"unknown spectrum {self.spectrum!r}")
        if self.precision not in (None, "float32", "float64"):
            raise ValueError(f"unknown precision {self.precision!r}")
        if self.backend == "sharded":
            if self.mesh is None:
                raise ValueError("backend='sharded' requires a mesh")
            if self.batch_axis not in self.mesh.axis_names:
                raise ValueError(
                    f"batch_axis {self.batch_axis!r} not in mesh axes "
                    f"{self.mesh.axis_names}")

    @property
    def batch_axis_size(self) -> int:
        """Devices along the batch (data) axis; 1 for unsharded backends."""
        if self.backend != "sharded" or self.mesh is None:
            return 1
        return self.mesh.shape[self.batch_axis]


def plan_for(
    shape: tuple,
    *,
    k: Optional[int] = None,
    mesh: Optional["Mesh"] = None,
    method: Optional[Method] = None,
    backend: Optional[BackendName] = None,
    spectrum: Optional[Spectrum] = None,
    precision: Optional[str] = None,
    bisect_iters: int = 0,
) -> SolverPlan:
    """Pick a plan from the problem shape ``(n, n)`` or ``(b, n, n)`` and
    the device mesh.

    ``k`` is the number of eigenpairs the caller will ask for (``None``: the
    full table).  Explicit keywords override the heuristics:

    * ``n`` at or below the eigh crossover, or ``k >= n``: ``eigh``;
    * ``n`` at or below the dense crossover: dense minors (``eei_dense``);
    * otherwise the tridiagonal path (``eei_tridiag``), or the Krylov reduce
      for a narrow window (``k <= n / 16``) on a large matrix (``n`` at or
      above :func:`resolved_krylov_n_min`); shift-and-invert is never
      picked, only named;
    * a window with ``k <= resolved_windowed_k_frac() * n`` plans the
      windowed chain.

    The crossovers are the backend's (:func:`resolved_crossovers`).  A
    ``mesh`` whose ``data`` axis has more than one device picks the
    ``sharded`` backend when the stack puts at least one matrix on each of
    them (the engine and the server pad a stack up to a multiple of the
    axis); otherwise the mesh is dropped and the backend defaults to
    ``cuda``, the hand-written kernels.
    """
    if len(shape) not in (2, 3):
        raise ValueError(f"expected (n, n) or (b, n, n), got {shape}")
    n = shape[-1]
    b = shape[0] if len(shape) == 3 else 1
    if backend is None:
        if (mesh is not None and "data" in mesh.axis_names
                and mesh.shape["data"] > 1 and b >= mesh.shape["data"]):
            backend = "sharded"
        else:
            backend = "cuda"
    if backend != "sharded":
        mesh = None
    if method is None:
        eigh_x, dense_x = resolved_crossovers(backend)
        if n <= eigh_x or (k is not None and k >= n):
            method = "eigh"
        elif n <= dense_x:
            method = "eei_dense"
        else:
            method = "eei_tridiag"
        if (method == "eei_tridiag" and k is not None and 0 < k < n
                and k <= KRYLOV_K_FRAC * n
                and n >= resolved_krylov_n_min()):
            method = "eei_krylov"
    if spectrum is None:
        spectrum = "full"
        if (method != "eigh" and k is not None and 0 < k < n
                and k <= resolved_windowed_k_frac() * n):
            spectrum = "windowed"
    minor_axis = None
    if mesh is not None and "model" in mesh.axis_names:
        minor_axis = "model"
    return SolverPlan(method=method, backend=backend, spectrum=spectrum,
                      mesh=mesh, batch_axis="data", minor_axis=minor_axis,
                      precision=precision, bisect_iters=bisect_iters)


def packed_plan_for(row_n: int, *, backend: Optional[BackendName] = None,
                    precision: Optional[str] = None) -> SolverPlan:
    """The plan a stack of segment-packed rows of width ``row_n`` runs.

    A packed row is block-diagonal, so both packed chains apply to it as it
    is; the choice is keyed on the row width: at or below
    :func:`resolved_packed_eigh_n_max` the eigh chain (one ``eigh`` of the
    row and a per-slot selection by mass), above it the windowed
    tridiagonal chain with the segmented Sturm kernel.  The backend
    defaults to ``cuda``.
    """
    if backend is None:
        backend = "cuda"
    if row_n <= resolved_packed_eigh_n_max():
        return SolverPlan(method="eigh", backend=backend, precision=precision)
    return SolverPlan(method="eei_tridiag", backend=backend,
                      spectrum="windowed", precision=precision)
