"""The Eigenvector-Eigenvalue Identity (EEI), log-space part.

For a symmetric ``n x n`` ``A`` with eigenvalues ``lam`` (ascending) and
minors ``M_j`` with eigenvalues ``mu[j, :]``:

    |v[i, j]|^2 * prod_{k != i} (lam[i] - lam[k]) = prod_k (lam[i] - mu[j, k])

The plain PyTorch twin of the log-space functions of ``repro.core.identity``
(sums of ``log|diff|``, immune to over- and underflow), batched over
leading axes.  The paper's ``component_*`` variant ladder waits for a later
slice; the spectra of ``A`` and of its dense minors
(:func:`matrix_spectrum`, :func:`minor_spectra`) are LAPACK's, as in
``repro``.  Numerator tables are built in row chunks so the ``(..., i, j, k)``
difference tensor never exists whole: at ``b = 16, n = 600`` it would be
27.6 GB in float64.
"""

from __future__ import annotations

import torch

from repro_torch.core import minors as minors_lib
from repro_torch.linalg.sturm import _pivmin

#: Elements of one ``(..., i_chunk, j, k)`` difference block.
_CHUNK_ELEMS = 1 << 24


def _row_chunks(lam_rows: torch.Tensor, mu: torch.Tensor, block):
    """``block`` over row chunks of ``lam_rows (..., I)``, joined on ``I``.

    Rows are independent of each other, so chunking only bounds memory.
    """
    chunk = max(1, _CHUNK_ELEMS // max(mu.numel(), 1))
    i_n = lam_rows.shape[-1]
    parts = [block(lam_rows[..., i0:i0 + chunk]) for i0 in range(0, i_n, chunk)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)


def matrix_spectrum(a: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of ``a (..., n, n)``, ascending."""
    return torch.linalg.eigvalsh(a)


def minor_spectra(a: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of every minor ``M_j`` of ``a (..., n, n)``:
    ``(..., n, n-1)``, ascending (one batched ``eigvalsh`` of all minors)."""
    return torch.linalg.eigvalsh(minors_lib.all_minors(a))


def spectral_floor(lam: torch.Tensor) -> torch.Tensor:
    """Per-matrix gap clamp ``eps * (max(|lam_0|, |lam_-1|) + 1e-30)``."""
    scale = torch.maximum(lam[..., -1].abs(), lam[..., 0].abs()) + 1e-30
    return torch.finfo(lam.dtype).eps * scale


def logabs_denominator(lam: torch.Tensor) -> torch.Tensor:
    """``sum_{k != i} log|lam[i] - lam[k]|``, ``(..., n)``."""
    n = lam.shape[-1]
    diff = lam.unsqueeze(-1) - lam.unsqueeze(-2)
    eye = torch.eye(n, dtype=torch.bool, device=lam.device)
    return torch.log(torch.where(eye, 1.0, diff).abs()).sum(dim=-1)


def logabs_denominator_dot(lam: torch.Tensor) -> torch.Tensor:
    """:func:`logabs_denominator` as a contraction with a ones-vector.

    The diagonal is excluded without a mask: ``lam[i] - lam[i]`` is exactly
    zero, so ``log(diff + tiny)`` adds ``log(tiny)`` there, subtracted per
    row.
    """
    tiny = 1e-30
    log_d = torch.log((lam.unsqueeze(-1) - lam.unsqueeze(-2)).abs() + tiny)
    ones = torch.ones(lam.shape[-1], dtype=lam.dtype, device=lam.device)
    log_tiny = torch.log(torch.full((), tiny, dtype=lam.dtype,
                                    device=lam.device))
    return log_d @ ones - log_tiny


def logabs_numerator(lam: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """``sum_k log|lam[i] - mu[j, k]|``: ``lam (..., I)``, ``mu (..., J, K)``
    -> ``(..., I, J)``."""
    def block(rows):
        diff = rows[..., :, None, None] - mu.unsqueeze(-3)
        return torch.log(diff.abs()).sum(dim=-1)

    return _row_chunks(lam, mu, block)


def logabs_numerator_clamped(lam: torch.Tensor, mu: torch.Tensor,
                             floor: torch.Tensor,
                             mask: torch.Tensor | None = None) -> torch.Tensor:
    """``sum_k log max(|lam[i] - mu[j, k]|, floor)`` with one ``floor`` per
    matrix: ``lam (..., I)``, ``mu (..., J, K)``, ``floor (...)`` ->
    ``(..., I, J)``.  With ``mask (..., J, K)`` (bool) a masked cell adds
    exactly ``log 1 = 0``."""
    fl = floor[..., None, None, None]
    valid = None if mask is None else mask.unsqueeze(-3)

    def block(rows):
        diff = torch.maximum((rows[..., :, None, None] - mu.unsqueeze(-3)).abs(),
                             fl)
        if valid is not None:
            diff = torch.where(valid, diff, 1.0)
        return torch.log(diff).sum(dim=-1)

    return _row_chunks(lam, mu, block)


def logabs_denominator_clamped(lam: torch.Tensor,
                               floor: torch.Tensor) -> torch.Tensor:
    """``sum_{k != i} log max(|lam[i] - lam[k]|, floor)``, ``(..., n)``."""
    n = lam.shape[-1]
    diff = (lam.unsqueeze(-1) - lam.unsqueeze(-2)).abs()
    eye = torch.eye(n, dtype=torch.bool, device=lam.device)
    diff = torch.where(eye, 1.0, torch.maximum(diff, floor[..., None, None]))
    return torch.log(diff).sum(dim=-1)


def logabs_numerator_dot(lam: torch.Tensor, mu: torch.Tensor,
                         floor=0.0) -> torch.Tensor:
    """:func:`logabs_numerator` with the ``k`` reduction written as a
    contraction with a ones-vector, and gaps clamped at ``floor`` (a
    scalar or one value per matrix)."""
    ones = torch.ones(mu.shape[-1], dtype=mu.dtype, device=mu.device)
    if isinstance(floor, torch.Tensor):
        floor = floor[..., None, None, None]

    def block(rows):
        diff = (rows[..., :, None, None] - mu.unsqueeze(-3)).abs()
        if isinstance(floor, torch.Tensor):
            diff = torch.maximum(diff, floor)
        elif floor:
            diff = torch.clamp(diff, min=floor)
        return torch.log(diff) @ ones

    return _row_chunks(lam, mu, block)


def magnitudes_from_spectra(lam: torch.Tensor, mu: torch.Tensor,
                            reduce: str = "sum", rows=None) -> torch.Tensor:
    """All ``|v[i, j]|^2`` from spectra, ``(..., n, n)``, in log space.

    ``lam (..., n)`` ascending, ``mu (..., n, n-1)``.  ``reduce="dot"``
    takes the ones-contraction forms.  Gaps are clamped at ``eps *
    spectral scale``.  ``rows`` (``(k,)`` eigenvalue indices, shared across
    the stack) evaluates only those rows of the numerator; the floor and
    the denominator still come from the full spectrum and are row-sliced,
    so the ``(..., k, n)`` result equals the matching rows of the table.
    """
    if reduce not in ("sum", "dot"):
        raise ValueError(f"unknown reduce {reduce!r}")
    lam_rows = lam if rows is None else lam[..., rows]
    floor = spectral_floor(lam)
    if reduce == "dot":
        log_num = logabs_numerator_dot(lam_rows, mu, floor=floor)
        log_den = logabs_denominator_dot(lam)
    else:
        log_num = logabs_numerator_clamped(lam_rows, mu, floor)
        log_den = logabs_denominator_clamped(lam, floor)
    if rows is not None:
        log_den = log_den[..., rows]
    return torch.exp(log_num - log_den.unsqueeze(-1))


# ---------------------------------------------------------------------------
# Windowed numerators: minor determinants by ratio recurrence
# ---------------------------------------------------------------------------


def tridiag_minor_logdets(d: torch.Tensor, e: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """``log|det(M_j - x_i I)|`` for every minor ``j``: ``(..., k, n)``.

    ``det(M_j - xI) = f_j(x) g_{j+1}(x)`` with ``f`` / ``g`` the leading /
    trailing principal minors of ``T - xI``; both follow the Sturm ratio
    recurrence, so one forward and one backward sweep plus prefix sums of
    ``log|q|`` give every minor at O(n) per shift.  ``d (..., n)``,
    ``e (..., n-1)``, ``x (..., k)``.  ``pivmin`` keeps the ratios finite.
    """
    n = d.shape[-1]
    k = x.shape[-1]
    if n == 1:
        return torch.zeros(x.shape[:-1] + (k, 1), dtype=d.dtype,
                           device=d.device)
    pm = _pivmin(d, e).unsqueeze(-1)

    def clamp(q):
        return torch.where(q.abs() < pm, -pm, q)

    e2 = e * e
    q = clamp(d[..., 0:1] - x)
    qs = [q]  # q_1 .. q_{n-1}
    for idx in range(1, n - 1):
        q = clamp(d[..., idx:idx + 1] - x - e2[..., idx - 1:idx] / q)
        qs.append(q)
    zero = torch.zeros_like(x).unsqueeze(-2)
    # log_f[j] = sum_{l <= j} log|q_l|, j = 0 .. n-1.
    log_f = torch.cat(
        [zero, torch.cumsum(torch.log(torch.stack(qs, -2).abs()), dim=-2)],
        dim=-2)
    p = clamp(d[..., n - 1:n] - x)
    ps = [p]  # p_{n-1} .. p_1
    for idx in range(n - 2, 0, -1):
        p = clamp(d[..., idx:idx + 1] - x - e2[..., idx:idx + 1] / p)
        ps.append(p)
    # log_g[m-1] = sum_{l >= m} log|p_l|, m = 1 .. n (the last one is 0).
    log_p_rev = torch.log(torch.stack(ps, -2).abs())
    log_g = torch.cat(
        [torch.flip(torch.cumsum(log_p_rev, dim=-2), dims=(-2,)), zero],
        dim=-2)
    # log|det(M_j - xI)| = log_f[j] + log_g[j], j = 0 .. n-1.
    return (log_f + log_g).transpose(-1, -2)


def tridiag_windowed_magnitudes(d: torch.Tensor, e: torch.Tensor,
                                lam_sel: torch.Tensor) -> torch.Tensor:
    """Normalized ``|w[i, j]|^2`` rows for selected eigenvalues, ``(..., k, n)``.

    The Cauchy denominator is constant in ``j`` and equals the row sum of
    the numerators (rows are unit vectors), so normalizing each row by its
    own sum is the identity, with no other eigenvalue needed.
    """
    log_num = tridiag_minor_logdets(d, e, lam_sel)
    log_num = log_num - log_num.amax(dim=-1, keepdim=True)
    w = torch.exp(log_num)
    return w / w.sum(dim=-1, keepdim=True)


# Batch axes are written out, so the batched name is the same function.
tridiag_windowed_magnitudes_batched = tridiag_windowed_magnitudes
