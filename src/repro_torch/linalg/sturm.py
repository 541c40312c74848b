"""Sturm-sequence bisection eigenvalues of symmetric tridiagonal matrices.

The plain PyTorch twin of ``repro.linalg.sturm``, batched over leading
axes (``d (..., n)``, ``e (..., n-1)``).  The count uses the LAPACK
``dstebz`` recurrence

    q_0 = d_0 - x ;  q_k = d_k - x - e_{k-1}^2 / q_{k-1}

where ``count(x) = #{k : q_k < 0}`` is the number of eigenvalues below
``x``, with ``|q| < pivmin -> -pivmin`` keeping it finite.  Bisection is
index-targeted and fixed-iteration: lane ``m`` brackets eigenvalue
``target_base + m``, and every lane's arithmetic is elementwise, so a
window of lanes is bitwise-equal to the same lanes of the full spectrum.
:func:`bisect_lanes` is also the plain version of the CUDA Sturm kernel
and :func:`bisect_lanes_segmented` that of the segmented one
(``repro_torch.kernels.sturm.kernel``).
"""

from __future__ import annotations

import torch


def default_iters(dtype: torch.dtype) -> int:
    """Bisection iterations per dtype: 64 for float64, 32 otherwise."""
    return 64 if dtype == torch.float64 else 32


def gershgorin_bounds(d: torch.Tensor, e: torch.Tensor):
    """``(lo, hi)`` bounding each spectrum, widened by ``eps * span``."""
    n = d.shape[-1]
    abs_e = e.abs()
    r = torch.zeros_like(d)
    if n > 1:
        r[..., :-1] += abs_e
        r[..., 1:] += abs_e
    lo = (d - r).amin(dim=-1)
    hi = (d + r).amax(dim=-1)
    span = torch.clamp(hi - lo, min=1.0)
    eps = torch.finfo(d.dtype).eps
    return lo - eps * span, hi + eps * span


def _pivmin(d: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Per-matrix pivot floor ``max(eps^2 * scale^2, tiny)``."""
    finfo = torch.finfo(d.dtype)
    scale = d.abs().amax(dim=-1)
    if e.shape[-1]:
        scale = torch.maximum(scale, e.abs().amax(dim=-1))
    return torch.clamp(finfo.eps * finfo.eps * scale * scale, min=finfo.tiny)


def _count_below(d, e2, x, pivmin, start=None, end=None):
    """Sturm counts per lane: ``d (..., n)``, ``x (..., m)`` -> int32.

    With ``start`` and ``end`` (``(..., m)`` int32) the recurrence still
    runs over the whole band, but only steps ``start <= k < end`` count.
    """
    def counted(q, k):
        neg = q < 0
        return neg if start is None else neg & (start <= k) & (k < end)

    q = d[..., 0:1] - x
    q = torch.where(q.abs() < pivmin, -pivmin, q)
    count = counted(q, 0).to(torch.int32)
    for k in range(1, d.shape[-1]):
        q = d[..., k:k + 1] - x - e2[..., k - 1:k] / q
        q = torch.where(q.abs() < pivmin, -pivmin, q)
        count += counted(q, k)
    return count


def sturm_count(d: torch.Tensor, e: torch.Tensor, x: torch.Tensor):
    """Number of eigenvalues strictly below each shift ``x (..., m)``."""
    return _count_below(d, e * e, x, _pivmin(d, e).unsqueeze(-1))


def _bisect(d, e, lo, hi, pivmin, targets, n_iter, start=None, end=None):
    """The one bisection body: every lane ``(..., m)`` halves its own
    ``[lo, hi]`` ``n_iter`` times towards eigenvalue index ``targets``."""
    e2 = e * e
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        go_right = _count_below(d, e2, mid, pivmin, start, end) <= targets
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid)
    return 0.5 * (lo + hi)


def bisect_lanes(d, e, lo, hi, pivmin, target_base: int, m: int,
                 n_iter: int) -> torch.Tensor:
    """Eigenvalues ``target_base .. target_base + m - 1`` of each band.

    ``lo``, ``hi`` and ``pivmin`` have the band's leading shape; every lane
    starts from its matrix's bracket and runs ``n_iter`` bisections.
    Returns ``(..., m)`` ascending.
    """
    shape = d.shape[:-1] + (m,)
    targets = torch.arange(target_base, target_base + m, device=d.device,
                           dtype=torch.int32)
    return _bisect(d, e, lo.unsqueeze(-1).expand(shape),
                   hi.unsqueeze(-1).expand(shape), pivmin.unsqueeze(-1),
                   targets, n_iter)


def bisect_lanes_segmented(d, e, lo, hi, pivmin, start, end, targets,
                           n_iter: int) -> torch.Tensor:
    """Per-lane bisection on packed bands, ``(..., m)``.

    Every lane carries its own bracket ``lo, hi``, ``pivmin``, segment
    ``[start, end)`` and eigenvalue index ``targets`` (all ``(..., m)``).
    The recurrence runs over the whole band ``d (..., n)``, ``e (..., n-1)``
    and only the lane's segment counts, so a lane brackets eigenvalue
    ``targets`` of its own diagonal block when the off-diagonals at the
    segment junctions are zero (``q`` then restarts by itself).
    """
    return _bisect(d, e, lo, hi, pivmin, targets, n_iter, start, end)


def bisect_eigenvalues_windowed(d: torch.Tensor, e: torch.Tensor, k: int,
                                largest: bool = True,
                                n_iter: int = 0) -> torch.Tensor:
    """The ``k`` extremal eigenvalues of each band, ascending ``(..., k)``.

    Indices ``n-k .. n-1`` (``largest``) or ``0 .. k-1``.  Each lane runs
    exactly what the full bisection runs for its index, so the window is
    bitwise-equal to the matching slice of :func:`bisect_eigenvalues`.
    """
    n = d.shape[-1]
    if not 1 <= k <= n:
        raise ValueError(f"window k={k} out of range for n={n}")
    lo, hi = gershgorin_bounds(d, e)
    return bisect_lanes(d, e, lo, hi, _pivmin(d, e),
                        n - k if largest else 0, k,
                        n_iter or default_iters(d.dtype))


def bisect_eigenvalues(d: torch.Tensor, e: torch.Tensor,
                       n_iter: int = 0) -> torch.Tensor:
    """All eigenvalues of each band (the ``k = n`` window), ``(..., n)``."""
    return bisect_eigenvalues_windowed(d, e, d.shape[-1], n_iter=n_iter)


def bisect_eigenvalues_bracketed(d: torch.Tensor, e: torch.Tensor,
                                 lo: torch.Tensor, hi: torch.Tensor, k: int,
                                 largest: bool = True,
                                 n_iter: int = 0) -> torch.Tensor:
    """The ``k`` extremal eigenvalues from caller-supplied brackets.

    Lane ``t`` starts from ``(lo[..., t], hi[..., t])`` (for example the
    interlacing brackets of ``repro_torch.linalg.interlace``) instead of the
    Gershgorin interval.  The brackets are validated, never trusted: a lane
    keeps its bracket only where ``count(lo) <= target < count(hi)`` and
    ``lo <= hi``, and restarts from its matrix's Gershgorin interval
    otherwise.  Returns ``(..., k)`` ascending.
    """
    n = d.shape[-1]
    if not 1 <= k <= n:
        raise ValueError(f"window k={k} out of range for n={n}")
    lo0, hi0 = gershgorin_bounds(d, e)
    start = n - k if largest else 0
    targets = torch.arange(start, start + k, device=d.device,
                           dtype=torch.int32)
    lo = torch.as_tensor(lo, dtype=d.dtype, device=d.device)
    hi = torch.as_tensor(hi, dtype=d.dtype, device=d.device)
    ok = ((sturm_count(d, e, lo) <= targets)
          & (sturm_count(d, e, hi) > targets) & (lo <= hi))
    lo = torch.where(ok, lo, lo0.unsqueeze(-1))
    hi = torch.where(ok, hi, hi0.unsqueeze(-1))
    return _bisect(d, e, lo, hi, _pivmin(d, e).unsqueeze(-1), targets,
                   n_iter or default_iters(d.dtype))


# Batch axes are written out, so the batched names are the same functions.
bisect_eigenvalues_batched = bisect_eigenvalues
bisect_eigenvalues_windowed_batched = bisect_eigenvalues_windowed
bisect_eigenvalues_bracketed_batched = bisect_eigenvalues_bracketed
