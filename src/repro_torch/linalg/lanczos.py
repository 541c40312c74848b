"""Lanczos partial tridiagonalization: the Krylov ``reduce`` stage.

The twin of ``repro.linalg.lanczos``.  ``m`` Lanczos steps build an
orthonormal basis ``Q (n, m)`` and a tridiagonal band ``T = Q^T A Q`` whose
extremal Ritz pairs converge to ``A``'s long before ``m`` reaches ``n``; the
band ``(d, e, q)`` feeds the windowed Sturm, minor-determinant and sign
stages unchanged.  As in ``repro``:

* full reorthogonalization (CGS2) against every retained basis vector;
* a windowed Ritz-residual stop every ``check_every`` steps: the ``k``
  windowed Ritz values of the guard-masked band are bisected (through
  ``kernels.sturm.ops.sturm_eigenvalues(..., window=)``: kernel 1 on a CUDA
  tensor, its plain version, bitwise the same, on a CPU one), their
  eigenvector magnitudes come from ``kernels.minor_det.ops`` (one launch
  on a CUDA tensor, the plain loop on a CPU one), and the bound
  ``beta_j |s_j[last]|`` is held to ``rtol`` of the band's scale;
* a breakdown (``beta_j ~ 0``) restarts in a fresh direction orthogonal to
  the basis, through an exactly-zero band junction;
* unused band slots are filled with a guard value outside the active
  band's spectrum, on the side away from the requested extreme.

Two things differ from ``repro``.  The random start and restart directions
come from ``torch.Generator``s seeded from ``seed`` (drawn on the CPU in
float64, so the CPU and the card draw the same vectors); ``repro`` draws
them with ``jax.random``, which the port cannot reproduce, so ``v0=`` takes
an explicit start vector.  And a stack runs as one loop: every active
matrix takes step ``j`` together; at a residual check the matrices that
converged leave the working set with their state frozen (their own
``steps``), as each matrix of ``repro``'s ``vmap``-ped ``while_loop`` stops
at its own step.

Shift-and-invert runs the same iteration on ``B = (A - sigma I)^{-1}``
through one ``lu_factor_ex`` (no error check, so an exactly singular shift
is not refused; no host sync) and ``lu_solve`` a step.

How the steps are issued adapts to the device and the operator, with the
same outputs bit for bit.  On the CPU, and with the shift-and-invert
operator, each step waits for its breakdown test.  On a CUDA tensor with
the dense operator the steps up to a residual check and the check (a
chunk) run with no wait, and replay as one CUDA graph captured once a
stack shape for a caller that keeps a :class:`LanczosGraphs` (each Krylov
reduce stage of a built program does); the breakdown flag is read with the
check's answer in one wait, and a chunk in which a matrix broke down is
run again a step at a time.
"""

from __future__ import annotations

import threading
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.tracing import count, span

#: Krylov band sizing for a k-window: ``m = min(n, max(FACTOR * k, MIN))``
#: (``repro``'s constants; ``SolverPlan.krylov_m`` overrides).
KRYLOV_M_FACTOR = 16
KRYLOV_M_MIN = 128

#: Shift-and-invert band sizing: the inverted operator separates the target
#: cluster, so fewer steps are needed per converged pair.
KRYLOV_SI_M_FACTOR = 8
KRYLOV_SI_M_MIN = 64

#: Shift margin for shift-and-invert, as a fraction of the Gershgorin span.
SI_MARGIN_FRAC = 1e-3


def default_m(n: int, k: int) -> int:
    """Default Krylov band size for a direct top-k window at size ``n``."""
    return min(n, max(KRYLOV_M_FACTOR * k, KRYLOV_M_MIN))


def default_si_m(n: int, k: int) -> int:
    """Default band size for the shift-and-invert mode."""
    return min(n, max(KRYLOV_SI_M_FACTOR * k, KRYLOV_SI_M_MIN))


def _resolve_m(n: int, k: int, m: int, si: bool = False) -> int:
    if m:
        return min(n, max(int(m), k))
    return default_si_m(n, k) if si else default_m(n, k)


def _default_rtol(dtype: torch.dtype) -> float:
    return 1e-12 if dtype == torch.float64 else 1e-5


class LanczosResult(NamedTuple):
    """One partial tridiagonalization per matrix, guard-masked."""

    d: torch.Tensor  # (..., m) band diagonal; guard value beyond `steps`
    e: torch.Tensor  # (..., m-1) off-diagonal; 0 beyond the active block
    q: torch.Tensor  # (..., n, m) basis columns; 0 beyond `steps`
    steps: torch.Tensor  # (...) int32: Lanczos steps taken
    resid: torch.Tensor  # (..., k) last windowed Ritz residual bound


def _from_host(x: torch.Tensor, dtype, device) -> torch.Tensor:
    """``x``, made on the host, as ``dtype`` on ``device``: on the card a
    blocking copy, so the host waits for the device."""
    with span("lanczos/sync"):
        count("host_sync")
        return x.to(dtype=dtype, device=device)


def _any(x: torch.Tensor) -> bool:
    """``bool(x.any())``: the host waits for the device's answer."""
    with span("lanczos/sync"):
        count("host_sync")
        return bool(x.any())


def _floor(dtype: torch.dtype, device) -> torch.Tensor:
    """``sqrt(tiny)`` of ``dtype``, made on ``device`` (no host copy)."""
    tiny = torch.finfo(dtype).tiny
    return torch.full((), tiny, dtype=dtype, device=device) ** 0.5


def _band_bounds(d: torch.Tensor, e_band: torch.Tensor, active: torch.Tensor):
    """Gershgorin ``(lo, hi)`` of the active rows of masked bands
    ``d (..., m)``, ``e_band (..., m-1)``; ``active`` broadcasts to ``d``."""
    m = d.shape[-1]
    rad = torch.zeros_like(d)
    if m > 1:
        rad[..., :-1] += e_band.abs()
        rad[..., 1:] += e_band.abs()
    lo = torch.where(active, d - rad, torch.inf).amin(dim=-1)
    hi = torch.where(active, d + rad, -torch.inf).amax(dim=-1)
    return lo, hi


def _guard_value(d, e_band, active, largest: bool):
    """Guard for inactive band slots: outside the active block's spectrum,
    on the side away from the requested extreme."""
    lo, hi = _band_bounds(d, e_band, active)
    margin = (0.01 * (hi - lo) + 1e-3 * (hi.abs() + lo.abs())
              + _floor(d.dtype, d.device))
    return lo - margin if largest else hi + margin


def _mask_band(d: torch.Tensor, e: torch.Tensor, j, m: int, largest: bool):
    """Guard-fill band entries beyond ``j`` active steps (an int, or one per
    matrix ``(...)``): the ``(..., m)`` diagonal and ``(..., m-1)``
    off-diagonal the spectrum stage sees."""
    idx = torch.arange(m, device=d.device)
    if isinstance(j, torch.Tensor):
        j = j.unsqueeze(-1)
    e_band = (torch.where(idx[:m - 1] < j - 1, e[..., :m - 1], 0.0)
              if m > 1 else e[..., :0])
    active = idx < j
    guard = _guard_value(d, e_band, active, largest)
    return torch.where(active, d, guard.unsqueeze(-1)), e_band


def _gaussian(n: int, seed: int, dtype, device) -> torch.Tensor:
    """A seeded standard normal ``(n,)``, drawn on the CPU in float64."""
    gen = torch.Generator().manual_seed(int(seed))
    return _from_host(torch.randn(n, generator=gen, dtype=torch.float64),
                      dtype, device)


def _restart_seed(seed: int, j: int) -> int:
    """Seed of the restart direction of step ``j`` (the start vector takes
    ``seed`` itself)."""
    return (int(seed) + 1) * 1_000_003 + j + 1


#: A batched operator ``(operands, apply)``: ``apply(operands, v)`` maps
#: ``v (b, n)`` to ``(b, n)``; every operand has the stack on its leading
#: axis, so the operator of a sub-stack is ``apply`` on ``t[rows]``.
Operator = Tuple[Tuple[torch.Tensor, ...], Callable]


def _dense_apply(operands, v):
    return (operands[0] @ v.unsqueeze(-1)).squeeze(-1)


def _row(x: torch.Tensor, j) -> torch.Tensor:
    """``x[:, j]`` for an int ``j`` or a one-element index tensor."""
    if isinstance(j, int):
        return x[:, j]
    return x.index_select(1, j).squeeze(1)


def _set_row(x: torch.Tensor, j, v: torch.Tensor) -> None:
    """``x[:, j] = v`` for an int ``j`` or a one-element index tensor."""
    if isinstance(j, int):
        x[:, j] = v
    else:
        x.index_copy_(1, j, v.unsqueeze(1))


def _ritz_resid(d, e, j1, beta, window, floor):
    """Relative Ritz residual bound ``beta_j |s_i[j-1]| / scale`` of the k
    windowed pairs of the current masked bands, ``(b, k)``, after ``j1``
    steps (an int, or a one-element index tensor)."""
    from repro_torch.kernels.minor_det import ops as md_ops
    from repro_torch.kernels.sturm import ops as sturm_ops

    k, largest = window
    m = d.shape[-1]
    d_m, e_m = _mask_band(d, e, j1, m, largest)
    theta = sturm_ops.sturm_eigenvalues(d_m, e_m, window=(k, largest))
    mags = md_ops.tridiag_windowed_magnitudes(d_m, e_m, theta)
    mags = mags.transpose(-1, -2)  # (b, m, k): row j1 - 1 is the last step
    s_last = torch.sqrt(torch.clamp(_row(mags, j1 - 1), min=0.0))
    lo, hi = _band_bounds(d_m, e_m, torch.arange(m, device=d.device) < j1)
    scale = torch.maximum(torch.maximum(lo.abs(), hi.abs()), floor)
    return beta.unsqueeze(-1) * s_last / scale.unsqueeze(-1)


class _ChunkGraphs:
    """The static buffers of one ``(b, n, m, dtype, device)`` dense Lanczos
    loop on the card, and the chunks captured over them as CUDA graphs, one
    a key: the chunk's length, whether it ends in a residual check, and the
    check's window and ``rtol``.  A step reads its index from the device
    tensor ``t`` and advances it, so one graph serves every chunk of its
    key.  One call at a time uses the buffers (:meth:`take`,
    :meth:`release`)."""

    def __init__(self, b: int, n: int, m: int, dtype, device):
        self.lock = threading.Lock()
        self.free = torch.cuda.Event()  # the last user's work on the card
        self.a = torch.empty((b, n, n), dtype=dtype, device=device)
        self.q = torch.empty((b, m + 1, n), dtype=dtype, device=device)
        self.d = torch.empty((b, m), dtype=dtype, device=device)
        self.e = torch.empty((b, m), dtype=dtype, device=device)
        self.flag = torch.empty((b,), dtype=torch.bool, device=device)
        self.t = torch.zeros((1,), dtype=torch.long, device=device)
        self.floor = _floor(dtype, device)
        self.stream = torch.cuda.Stream(device)
        self.graphs: dict = {}

    def take(self) -> bool:
        """Take the buffers for this call, behind the last user's work on
        them on the card; False if another call holds them."""
        if not self.lock.acquire(blocking=False):
            return False
        torch.cuda.current_stream(self.t.device).wait_event(self.free)
        return True

    def release(self) -> None:
        """Give the buffers up; the next user's work on them waits for the
        copies out of them this call has queued."""
        self.free.record(torch.cuda.current_stream(self.t.device))
        self.lock.release()

    def run(self, chunk: Callable, j0: int, key: tuple):
        """``chunk(t)`` from step ``j0`` as one replay of the graph of
        ``key``, which names all that a capture fixes besides the buffers;
        returns its outputs, which the next replay overwrites.  The first
        chunk of a key runs eagerly on a side stream (the warm-up a capture
        needs) and is then captured."""
        from repro_torch.kernels.minor_det import kernel as md_kernel
        from repro_torch.kernels.sturm import kernel as sturm_kernel

        self.t.fill_(j0)
        if key in self.graphs:
            graph, out, (sturm_launches, md_launches) = self.graphs[key]
            count("lanczos_graph_chunk")
            graph.replay()
            sturm_kernel.replayed(sturm_launches)
            md_kernel.replayed(md_launches)
            return out
        current = torch.cuda.current_stream(self.t.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = chunk(self.t)
        current.wait_stream(self.stream)
        for x in out:
            if x is not None:
                x.record_stream(current)
        graph = torch.cuda.CUDAGraph()
        before = (sturm_kernel.captured(), md_kernel.captured())
        with torch.cuda.graph(graph, stream=self.stream,
                              capture_error_mode="thread_local"):
            captured = chunk(self.t)
        # The check's kernel-1 and minor-determinant calls, which each
        # replay launches.
        launches = (sturm_kernel.captured() - before[0],
                    md_kernel.captured() - before[1])
        self.graphs[key] = (graph, captured, launches)
        return out


class LanczosGraphs:
    """The CUDA graphs of the dense Lanczos loop on the card that one owner
    keeps (each Krylov reduce stage of a built program keeps its own): the
    buffers and graphs of each stack shape it has run, made at the shape's
    first call and freed with the owner."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_shape: dict = {}

    def take(self, b: int, n: int, m: int, dtype,
             device) -> Optional[_ChunkGraphs]:
        """The buffers of this shape, taken for the calling thread, or None
        if another call holds them."""
        key = (b, n, m, dtype, device)
        with self._lock:
            held = self._by_shape.get(key)
            if held is None:
                held = self._by_shape[key] = _ChunkGraphs(b, n, m, dtype,
                                                          device)
        return held if held.take() else None


def lanczos_iterate(
    a: Optional[torch.Tensor],
    m: int,
    *,
    window: Optional[Tuple[int, bool]] = None,
    operator: Optional[Operator] = None,
    rtol: float = 0.0,
    check_every: int = 32,
    seed: int = 0,
    v0: Optional[torch.Tensor] = None,
    graphs: Optional[LanczosGraphs] = None,
):
    """The raw m-step Lanczos loop on a stack ``a (b, n, n)`` (or one
    matrix ``(n, n)``), or on an ``operator`` of a stack.

    Returns ``(d (.., m), e (.., m), Q (.., m+1, n) rows, steps (..),
    resid (.., k))``, the unmasked internals (:func:`lanczos_partial` is the
    masked form).  ``window=(k, largest)`` turns on the windowed Ritz
    residual stop.  ``v0`` (``(n,)`` or ``(b, n)``, normalized here) is the
    start vector; by default a normal vector seeded from ``seed``.

    On a CUDA tensor with the dense operator the steps up to each residual
    check, and the check, run without a wait, as one CUDA graph replay
    when the caller keeps ``graphs``; elsewhere each step waits for its
    breakdown test.  All give the same outputs.
    """
    return _iterate(a, m, None, window=window, operator=operator, rtol=rtol,
                    check_every=check_every, seed=seed, v0=v0, graphs=graphs)


def _iterate(a, m, chunked: Optional[bool], *, window=None, operator=None,
             rtol=0.0, check_every=32, seed=0, v0=None, graphs=None):
    """:func:`lanczos_iterate`, which passes ``chunked=None``: chunked
    steps on a CUDA tensor with the dense operator.  ``chunked=False`` waits
    for the breakdown test of every step.  ``chunked=True`` runs the steps
    of a chunk (up to the next multiple of ``check_every``) and its check
    with no wait, ORing each step's breakdown into a flag that is read with
    the check's answer in one wait; a chunk in which a matrix broke down is
    zeroed and run again a step at a time, restarts included.  A chunk is
    one replay of a graph of ``graphs`` while the whole stack iterates with
    the dense operator on the card."""
    if operator is None:
        squeeze = a.ndim == 2
        stack = a.unsqueeze(0) if squeeze else a
        operator = ((stack,), _dense_apply)
    else:
        squeeze = False
    operands, apply = operator
    b_n, n = operands[0].shape[0], operands[0].shape[-1]
    ref = operands[0]
    dtype, device = ref.dtype, ref.device
    if not 1 <= m <= n:
        raise ValueError(f"Krylov band m={m} out of range for n={n}")
    if window is not None and not 1 <= window[0] <= m:
        raise ValueError(f"window k={window[0]} out of range for m={m}")
    rtol = float(rtol) if rtol else _default_rtol(dtype)
    eps = torch.finfo(dtype).eps
    on_card = device.type == "cuda" and apply is _dense_apply
    if chunked is None:
        chunked = on_card
    floor = _floor(dtype, device)
    k_win = window[0] if window is not None else 1

    if v0 is None:
        v0 = _gaussian(n, seed, dtype, device)
    v0 = torch.as_tensor(v0, dtype=dtype, device=device)
    v0 = v0 / torch.linalg.vector_norm(v0, dim=-1, keepdim=True)

    # The outputs of the whole stack; the working set holds the matrices
    # still iterating, whose original rows are `rows`.
    out_q = torch.zeros((b_n, m + 1, n), dtype=dtype, device=device)
    out_d = torch.zeros((b_n, m), dtype=dtype, device=device)
    out_e = torch.zeros((b_n, m), dtype=dtype, device=device)
    out_steps = torch.zeros((b_n,), dtype=torch.int32, device=device)
    out_resid = torch.full((b_n, k_win), torch.inf, dtype=dtype,
                           device=device)
    held = (graphs.take(b_n, n, m, dtype, device)
            if chunked and on_card and graphs is not None else None)
    if held is None:
        q, d, e = out_q.clone(), out_d.clone(), out_e.clone()
        flag = torch.zeros((b_n,), dtype=torch.bool, device=device)
    else:
        held.a.copy_(ref)
        operands = (held.a,)
        q, d, e = held.q.zero_(), held.d.zero_(), held.e.zero_()
        flag, floor = held.flag, held.floor
    q[:, 0] = v0
    resid = out_resid.clone()
    rows = torch.arange(b_n, device=device)

    def retire(keep, j1):
        """Write the matrices leaving the working set (``~keep``; all of
        them where ``keep`` is None) to the outputs; return the working set
        without them.  One wait for the device, none when all leave."""
        nonlocal q, d, e, flag, resid, rows, operands, held
        if keep is None:
            gone = torch.arange(rows.numel(), device=device)
            stay = gone[:0]
        else:
            with span("lanczos/sync"):
                count("host_sync")
                stay = keep.nonzero().squeeze(-1)
            # Rows not kept sort first, each set in working-set order.
            gone = torch.argsort(keep.to(torch.int8), stable=True)[
                :keep.numel() - stay.numel()]
        out_rows = rows[gone]
        out_q[out_rows], out_d[out_rows], out_e[out_rows] = \
            q[gone], d[gone], e[gone]
        out_resid[out_rows] = resid[gone]
        # A device tensor: a Python number would be copied from the host.
        out_steps[out_rows] = torch.full_like(out_rows, j1,
                                              dtype=out_steps.dtype)
        q, d, e, flag, resid, rows = q[stay], d[stay], e[stay], \
            flag[stay], resid[stay], rows[stay]
        operands = tuple(t[stay] for t in operands)
        if held is not None:
            # The working set has left the graphs' buffers: its later
            # chunks run without a graph.
            held.release()
            held = None

    def project_out(x):
        # Rows of q beyond the basis are exactly zero: no mask needed.
        c = q @ x.unsqueeze(-1)
        return x - (q.transpose(-1, -2) @ c).squeeze(-1)

    def step(j, restart: bool):
        """Step ``j`` (an int, or a device index on the graph path): writes
        ``d[:, j]``, ``e[:, j]`` and ``q[:, j + 1]`` and returns ``beta``.
        With ``restart``, a breakdown is tested (a wait) and restarted
        now; without, it is ORed into ``flag``."""
        qj = _row(q, j)
        w = apply(operands, qj)
        alpha = (qj * w).sum(dim=-1)
        w = w - alpha.unsqueeze(-1) * qj
        w = project_out(project_out(w))  # CGS2
        beta = torch.linalg.vector_norm(w, dim=-1)
        _set_row(d, j, alpha)
        scale = torch.maximum(d.abs().amax(dim=-1), e.abs().amax(dim=-1))
        breakdown = beta <= torch.maximum(100.0 * eps * scale, floor)
        qn = w / torch.maximum(beta, floor).unsqueeze(-1)
        if not restart:
            flag.logical_or_(breakdown)
        elif _any(breakdown):
            # An invariant subspace was captured: go on in a fresh
            # direction orthogonal to the basis, through a zero band
            # junction.
            r = _gaussian(n, _restart_seed(seed, j), dtype, device)
            r = project_out(r.expand(qn.shape))
            rn = torch.linalg.vector_norm(r, dim=-1, keepdim=True)
            r = torch.where(rn > floor, r / torch.maximum(rn, floor), 0.0)
            qn = torch.where(breakdown.unsqueeze(-1), r, qn)
        _set_row(e, j, torch.where(breakdown, 0.0, beta))
        _set_row(q, j + 1, qn)
        return beta

    def check(j1, beta):
        """The residual check after ``j1`` steps: ``(resid, done)``, the
        bounds and the converged rows."""
        r = _ritz_resid(d, e, j1, beta, window, floor)
        return r, (r <= rtol).all(dim=-1)

    def steps_with_waits(j0, j1, due):
        """Steps ``j0 .. j1 - 1``, a wait each, then the check if ``due``
        (in the last step's span): the converged rows, or None."""
        nonlocal resid
        for j in range(j0, j1):
            with span("lanczos/step"):
                beta = step(j, restart=True)
                if j + 1 == j1 and due:
                    resid, done = check(j1, beta)
                    return done if _any(done) else None
        return None

    def chunk(j, length, due):
        """``length`` steps from ``j`` with no wait, then the check if
        ``due``: ``(resid, done, answers)``, with ``None`` for the check's
        outputs where none is due and ``answers``, on the device, whether
        a matrix broke down and whether one converged.  ``j`` is an int,
        or on the graph path the device index, which the steps advance."""
        flag.zero_()
        for i in range(length):
            if isinstance(j, int):
                step(j + i, restart=False)
            else:
                step(j, restart=False)
                j.add_(1)
        j1 = j + length if isinstance(j, int) else j
        if not due:
            return None, None, flag.any().unsqueeze(0)
        # Without a breakdown in the chunk, e[:, j1 - 1] is the last
        # step's beta.
        r, done = check(j1, _row(e, j1 - 1))
        return r, done, torch.stack([flag.any(), done.any()])

    def steps_without_waits(j0, j1, due):
        """Steps ``j0 .. j1 - 1`` and the check if ``due`` as one chunk,
        then one wait: the converged rows, or None.  A chunk with a
        breakdown is zeroed and run again with waits."""
        nonlocal resid
        with span("lanczos/step"):
            if held is not None:
                r, done, answers = held.run(
                    lambda t: chunk(t, j1 - j0, due), j0,
                    (j1 - j0, due, window, rtol))
            else:
                r, done, answers = chunk(j0, j1 - j0, due)
            with span("lanczos/sync"):
                count("host_sync")
                broke, *converged = answers.tolist()
        if not broke:
            if due:
                resid = r
            return done if any(converged) else None
        # What the chunk wrote is exactly zero in the loop with waits, and
        # its projections and scale read it.
        count("lanczos_eager_chunk")
        d[:, j0:] = 0.0
        e[:, j0:] = 0.0
        q[:, j0 + 1:] = 0.0
        return steps_with_waits(j0, j1, due)

    run_chunk = steps_without_waits if chunked else steps_with_waits
    try:
        j1 = 0
        while j1 < m:
            j0, j1 = j1, min(m, j1 - j1 % check_every + check_every)
            due = (window is not None and j1 % check_every == 0
                   and j1 >= k_win + 1)
            done = run_chunk(j0, j1, due)
            if done is not None:
                retire(~done, j1)
                if rows.numel() == 0:
                    break
        if rows.numel():
            retire(None, j1)
    finally:
        if held is not None:
            held.release()
    out = (out_d, out_e, out_q, out_steps, out_resid)
    return tuple(x[0] for x in out) if squeeze else out


def lanczos_partial(
    a: Optional[torch.Tensor],
    m: int,
    k: int,
    largest: bool = True,
    *,
    operator: Optional[Operator] = None,
    rtol: float = 0.0,
    check_every: int = 32,
    seed: int = 0,
    v0: Optional[torch.Tensor] = None,
    graphs: Optional[LanczosGraphs] = None,
) -> LanczosResult:
    """Guard-masked m-step Lanczos band and basis for a ``(k, largest)``
    window, per matrix of ``a (b, n, n)`` or ``(n, n)``.

    ``d (.., m)`` / ``e (.., m-1)`` carry the active block with inactive
    slots guard-filled away from the window; ``q (.., n, m)`` columns are
    the basis (zero beyond ``steps``).  ``graphs`` as in
    :func:`lanczos_iterate`.
    """
    d, e, qr, steps, resid = lanczos_iterate(
        a, m, window=(k, largest), operator=operator, rtol=rtol,
        check_every=check_every, seed=seed, v0=v0, graphs=graphs)
    d_m, e_m = _mask_band(d, e, steps, m, largest)
    # Row `steps` of Q was written by the last step but lies outside the
    # retained basis: zero everything beyond the active block.
    keep = torch.arange(m, device=d.device).unsqueeze(-1) < \
        steps[..., None, None]
    q = torch.where(keep, qr[..., :m, :], 0.0)
    return LanczosResult(d_m, e_m, q.transpose(-1, -2), steps, resid)


# ---------------------------------------------------------------------------
# Engine stage entry points (batched over the leading axis)
# ---------------------------------------------------------------------------


def krylov_reduce(a: torch.Tensor, k: int, largest: bool = True, m: int = 0,
                  rtol: float = 0.0, graphs: Optional[LanczosGraphs] = None):
    """Krylov reduce stage: ``(d, e, q)`` for a top-k window of each matrix
    of ``a (b, n, n)`` (or of one ``(n, n)``); ``graphs`` as in
    :func:`lanczos_iterate`."""
    n = a.shape[-1]
    mm = _resolve_m(n, k, m)
    res = lanczos_partial(a, mm, min(k, mm), largest, rtol=rtol,
                          graphs=graphs)
    return res.d, res.e, res.q


# Batch axes are written out, so the batched name is the same function.
krylov_reduce_batched = krylov_reduce


def shift_invert_sigma(a: torch.Tensor, largest: bool = True) -> torch.Tensor:
    """Gershgorin shift strictly outside each spectrum on the target side,
    ``(...)``."""
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    radius = a.abs().sum(dim=-1) - diag.abs()
    lo = (diag - radius).amin(dim=-1)
    hi = (diag + radius).amax(dim=-1)
    margin = (SI_MARGIN_FRAC * (hi - lo) + 1e-6 * (hi.abs() + lo.abs())
              + _floor(a.dtype, a.device))
    return hi + margin if largest else lo - margin


def _lu_apply(operands, v):
    lu, piv = operands
    return torch.linalg.lu_solve(lu, piv, v.unsqueeze(-1)).squeeze(-1)


def krylov_shift_invert_reduce(a: torch.Tensor, k: int, largest: bool = True,
                               m: int = 0, rtol: float = 0.0):
    """Shift-and-invert Krylov reduce: ``(d, e, q, sigma)`` in theta space.

    Lanczos runs on ``B = (A - sigma I)^{-1}`` through one LU factorization
    per matrix; the band's Ritz values are ``theta = 1/(lambda - sigma)``,
    and the opposite extreme of theta is the requested extreme of lambda
    (the ``shift_invert_map`` stage undoes both).
    """
    squeeze = a.ndim == 2
    stack = a.unsqueeze(0) if squeeze else a
    n = stack.shape[-1]
    mm = _resolve_m(n, k, m, si=True)
    sigma = shift_invert_sigma(stack, largest)
    eye = torch.eye(n, dtype=stack.dtype, device=stack.device)
    lu, piv, _ = torch.linalg.lu_factor_ex(
        stack - sigma[:, None, None] * eye)
    res = lanczos_partial(None, mm, min(k, mm), not largest,
                          operator=((lu, piv), _lu_apply), rtol=rtol)
    out = (res.d, res.e, res.q, sigma)
    return tuple(x[0] for x in out) if squeeze else out


krylov_shift_invert_reduce_batched = krylov_shift_invert_reduce
