"""Principal minors for the eigenvector-eigenvalue identity.

The twin of ``repro.core.minors``: dense minors by index gathers, and the
tridiagonal representation in which deleting row and column ``j`` of
``T = tridiag(e, d, e)`` leaves two decoupled blocks, written as one band
whose bridging off-diagonal is exactly zero.  Batched over leading axes.
"""

from __future__ import annotations

import torch


def _kept(n: int, j: torch.Tensor) -> torch.Tensor:
    """Indices ``0 .. n-1`` without ``j``: ``p + (p >= j)`` for ``p < n-1``."""
    p = torch.arange(n - 1, device=j.device)
    return p + (p >= j).to(p.dtype)


def delete_index(x: torch.Tensor, j: int) -> torch.Tensor:
    """``x (..., n)`` without element ``j`` of its last axis."""
    return x[..., _kept(x.shape[-1], torch.as_tensor(j, device=x.device))]


def minor(a: torch.Tensor, j: int) -> torch.Tensor:
    """Principal minor of ``a (..., n, n)`` without row and column ``j``."""
    sel = _kept(a.shape[-1], torch.as_tensor(j, device=a.device))
    return a[..., sel, :][..., :, sel]


def minor_stack(a: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """The principal minors of ``a (..., n, n)`` listed in ``j (J,)``:
    ``(..., J, n-1, n-1)``."""
    sel = _kept(a.shape[-1], j.unsqueeze(-1))  # (J, n-1)
    return a[..., sel.unsqueeze(-1), sel.unsqueeze(-2)]


def all_minors(a: torch.Tensor) -> torch.Tensor:
    """All ``n`` principal minors, ``(..., n, n-1, n-1)`` (O(n^3) memory)."""
    return minor_stack(a, torch.arange(a.shape[-1], device=a.device))


def _minor_bands(d: torch.Tensor, e: torch.Tensor, j: torch.Tensor):
    """Bands of the minors listed in ``j`` (any shape ``J``):
    ``(..., *J, n-1)`` and ``(..., *J, n-2)``."""
    n = d.shape[-1]
    j = j.unsqueeze(-1)
    d_minor = d[..., _kept(n, j)]
    q = torch.arange(max(n - 2, 0), device=d.device)
    src = torch.clamp(q + (q >= j).to(q.dtype), max=max(n - 2, 0))
    e_minor = torch.where(q == j - 1, 0.0, e[..., src])
    return d_minor, e_minor


def tridiagonal_minor_bands(d: torch.Tensor, e: torch.Tensor, j: int):
    """Bands ``(..., n-1)``, ``(..., n-2)`` of the minor ``M_j`` of
    ``tridiag(e, d, e)``; the entry bridging the two blocks is zero."""
    return _minor_bands(d, e, torch.as_tensor(j, device=d.device))


def all_tridiagonal_minor_bands(d: torch.Tensor, e: torch.Tensor):
    """Bands of every minor: ``(..., n, n-1)`` and ``(..., n, n-2)``."""
    return _minor_bands(d, e, torch.arange(d.shape[-1], device=d.device))


# Batch axes are written out, so the batched name is the same function.
all_tridiagonal_minor_bands_batched = all_tridiagonal_minor_bands
