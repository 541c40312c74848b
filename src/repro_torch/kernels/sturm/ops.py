"""Public Sturm entry points over the kernels (bounds, windows, minor
stacks, packed segments, warm brackets).

``sturm_eigenvalues`` runs one launch over a ``(B, n)`` stack of bands;
``sturm_minor_spectra`` flattens all ``b * n`` minor bands of a ``(b, n)``
batch onto the kernel's row axis, so the whole stack is one launch.
``sturm_eigenvalues_segmented`` (packed block-diagonal bands, the
spectrum stage of the packed program) and ``sturm_eigenvalues_bracketed``
(warm per-lane brackets, the session update) run the segmented kernel.  The bounds are computed here exactly as
``repro.kernels.sturm.ops`` computes them: Gershgorin widened by
``eps * span`` and ``pivmin = max(eps^2 * scale^2, tiny)``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.sturm.kernel import sturm_bisect, sturm_segmented
from repro_torch.linalg.sturm import (
    _pivmin,
    default_iters,
    gershgorin_bounds,
    sturm_count,
)


def sturm_eigenvalues(d: torch.Tensor, e: torch.Tensor, *, n_iter: int = 0,
                      window: tuple | None = None) -> torch.Tensor:
    """All eigenvalues of ``B`` symmetric tridiagonal bands, ``(B, n)``.

    ``window=(k, largest)`` bisects only the ``k`` extremal indices and
    returns ``(B, k)`` ascending, bitwise-equal to the matching slice of the
    full spectrum (lanes are independent).
    """
    n = d.shape[-1]
    m, target_base = n, 0
    if window is not None:
        k, largest = int(window[0]), bool(window[1])
        if not 1 <= k <= n:
            raise ValueError(f"window k={k} out of range for n={n}")
        m, target_base = k, (n - k if largest else 0)
    lo, hi = gershgorin_bounds(d, e)
    bounds = torch.stack([lo, hi, _pivmin(d, e)], dim=-1)
    return sturm_bisect(d.contiguous(), e.contiguous(), bounds,
                        target_base=target_base, m=m,
                        n_iter=n_iter or default_iters(d.dtype))


def sturm_minor_spectra(dm: torch.Tensor, em: torch.Tensor, *,
                        n_iter: int = 0) -> torch.Tensor:
    """Spectra of all stacked minor bands ``dm (b, n, m)``, ``em (b, n, m-1)``
    in one launch; returns ``(b, n, m)``."""
    b, n, m = dm.shape
    mu = sturm_eigenvalues(dm.reshape(b * n, m), em.reshape(b * n, m - 1),
                           n_iter=n_iter)
    return mu.reshape(b, n, m)


def sturm_eigenvalues_segmented(d: torch.Tensor, e: torch.Tensor,
                                seg_off: torch.Tensor, seg_len: torch.Tensor,
                                *, k: int, largest: bool,
                                n_iter: int = 0) -> torch.Tensor:
    """The ``k`` extremal eigenvalues of every segment of packed bands.

    Row ``b`` of ``d (B, N)``, ``e (B, N-1)`` carries up to ``S`` blocks:
    block ``s`` spans columns ``[seg_off[b, s], seg_off[b, s] + seg_len[b,
    s])`` (``seg_len = 0``: an empty slot) and the off-diagonals at the
    junctions are zero.  Each segment gets its own Gershgorin bracket and
    ``pivmin`` from masked reductions over the band.  Lane ``(s, t)``
    brackets index ``len - k + t`` (largest, clamped at 0) or ``t``
    (smallest, clamped at ``len - 1``); a clamped lane repeats the boundary
    eigenvalue outside the slice that a request with ``k' <= len`` reads.
    Returns ``(B, S, k)``, ascending per segment.
    """
    lanes = segmented_lanes(d, e, seg_off, seg_len, k=k, largest=largest)
    out = sturm_segmented(d.contiguous(), e.contiguous(), **lanes,
                          n_iter=n_iter or default_iters(d.dtype),
                          segment_lanes=k)
    return out.reshape(d.shape[0], seg_off.shape[1], k)


def segmented_lanes(d: torch.Tensor, e: torch.Tensor, seg_off: torch.Tensor,
                    seg_len: torch.Tensor, *, k: int, largest: bool) -> dict:
    """The lane arrays of :func:`sturm_eigenvalues_segmented`: ``lo, hi,
    pivmin, start, end, targets``, each ``(B, S * k)``, lane ``s * k + t``."""
    b_n, n = d.shape
    s_n = seg_off.shape[1]
    dtype = d.dtype
    if k < 1:
        raise ValueError(f"window k={k} must be >= 1")
    seg_off = seg_off.to(device=d.device, dtype=torch.int32)
    seg_len = seg_len.to(device=d.device, dtype=torch.int32)
    seg_end = seg_off + seg_len

    e_abs = torch.zeros_like(d)  # |e| with a zero past the last column
    e_abs[:, :n - 1] = e.abs()
    r = torch.zeros_like(d)
    if n > 1:
        r[:, :-1] += e_abs[:, :n - 1]
        r[:, 1:] += e_abs[:, :n - 1]
    col = torch.arange(n, dtype=torch.int32, device=d.device)
    in_seg = ((seg_off.unsqueeze(-1) <= col)
              & (col < seg_end.unsqueeze(-1)))  # (B, S, N)
    finfo = torch.finfo(dtype)
    big = torch.full((), finfo.max, dtype=dtype, device=d.device)
    zero = torch.zeros((), dtype=dtype, device=d.device)
    lo_s = torch.where(in_seg, (d - r).unsqueeze(1), big).amin(dim=2)
    hi_s = torch.where(in_seg, (d + r).unsqueeze(1), -big).amax(dim=2)
    empty = seg_len == 0
    lo_s = torch.where(empty, zero, lo_s)
    hi_s = torch.where(empty, zero, hi_s)
    span = torch.clamp(hi_s - lo_s, min=1.0)
    lo_s = lo_s - finfo.eps * span
    hi_s = hi_s + finfo.eps * span
    scale = torch.where(in_seg, d.abs().unsqueeze(1), zero).amax(dim=2)
    scale = torch.maximum(
        scale, torch.where(in_seg, e_abs.unsqueeze(1), zero).amax(dim=2))
    piv_s = torch.clamp(finfo.eps * finfo.eps * scale * scale, min=finfo.tiny)

    # Lane layout m = s * k + t; targets are indices within the segment.
    t = torch.arange(k, dtype=torch.int32, device=d.device)
    if largest:
        targ = torch.clamp(seg_len.unsqueeze(-1) - k + t, min=0)
    else:
        targ = torch.minimum(t, torch.clamp(seg_len.unsqueeze(-1) - 1, min=0))

    def lanes(x):
        if x.ndim == 2:
            x = x.unsqueeze(-1)
        return x.expand(b_n, s_n, k).reshape(b_n, s_n * k).contiguous()

    return {"lo": lanes(lo_s), "hi": lanes(hi_s), "pivmin": lanes(piv_s),
            "start": lanes(seg_off), "end": lanes(seg_end),
            "targets": lanes(targ.to(torch.int32))}


def sturm_eigenvalues_bracketed(d: torch.Tensor, e: torch.Tensor,
                                lo: torch.Tensor, hi: torch.Tensor, *,
                                k: int, largest: bool,
                                n_iter: int = 0) -> torch.Tensor:
    """The ``k`` extremal eigenvalues from caller-supplied per-lane brackets
    ``lo, hi (B, k)``: the warm twin of ``window=`` in
    :func:`sturm_eigenvalues`, on the segmented kernel with one full-band
    segment per row.

    The brackets are validated, never trusted: the plain Sturm count
    checks ``count(lo) <= target < count(hi)`` and ``lo <= hi`` per lane,
    and a lane that fails restarts from its matrix's Gershgorin interval.
    Returns ``(B, k)`` ascending.
    """
    lanes = bracketed_lanes(d, e, lo, hi, k=k, largest=largest)
    return sturm_segmented(d.contiguous(), e.contiguous(), **lanes,
                           n_iter=n_iter or default_iters(d.dtype))


def bracketed_lanes(d: torch.Tensor, e: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor, *, k: int, largest: bool) -> dict:
    """The lane arrays of :func:`sturm_eigenvalues_bracketed`, each
    ``(B, k)``, with the brackets validated."""
    b_n, n = d.shape
    if not 1 <= k <= n:
        raise ValueError(f"window k={k} out of range for n={n}")
    lo_g, hi_g = gershgorin_bounds(d, e)
    first = n - k if largest else 0
    targ = torch.arange(first, first + k, dtype=torch.int32, device=d.device)
    targ = targ.expand(b_n, k)
    lo = torch.as_tensor(lo, dtype=d.dtype, device=d.device)
    hi = torch.as_tensor(hi, dtype=d.dtype, device=d.device)
    counts = sturm_count(d, e, torch.cat([lo, hi], dim=1))
    ok = (counts[:, :k] <= targ) & (counts[:, k:] > targ) & (lo <= hi)
    lo = torch.where(ok, lo, lo_g.unsqueeze(-1))
    hi = torch.where(ok, hi, hi_g.unsqueeze(-1))
    return {"lo": lo.contiguous(), "hi": hi.contiguous(),
            "pivmin": _pivmin(d, e).unsqueeze(-1).expand(b_n, k).contiguous(),
            "start": torch.zeros((b_n, k), dtype=torch.int32, device=d.device),
            "end": torch.full((b_n, k), n, dtype=torch.int32, device=d.device),
            "targets": targ.contiguous()}
