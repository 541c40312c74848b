"""Householder tridiagonalization of symmetric matrices, plain PyTorch.

``Q^T A Q = T`` with ``T`` tridiagonal and ``Q`` orthogonal, batched over
leading axes of ``a (..., n, n)``.  The twin of ``repro.linalg.householder``:
the same masked full-size reflector updates, with the ``fori_loop`` written
as a Python loop of ``n - 2`` steps.
"""

from __future__ import annotations

import torch


def _householder_vector(x: torch.Tensor, k: int):
    """Reflector ``(v, beta)`` annihilating ``x[..., k+2:]``.

    ``x (..., n)`` is a full column; only indices ``> k`` take part.
    ``H = I - beta v v^T``; ``beta = 0`` where the tail is already zero.
    """
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    xa = torch.where(idx > k, x, 0.0)
    x0 = xa[..., k + 1]
    sigma = torch.where(idx > k + 1, xa * xa, 0.0).sum(dim=-1)
    norm = torch.sqrt(x0 * x0 + sigma)
    # alpha = -sign(x0) * ||x_active|| avoids cancellation.
    alpha = torch.where(x0 >= 0, -norm, norm)
    v = torch.where(idx == k + 1, (x0 - alpha).unsqueeze(-1), xa)
    vnorm2 = (v * v).sum(dim=-1)
    beta = torch.where(vnorm2 > 0, 2.0 / torch.clamp(vnorm2, min=1e-300), 0.0)
    beta = torch.where(norm > 0, beta, 0.0)
    return v, beta


def tridiagonalize(a: torch.Tensor, with_q: bool = True):
    """Reduce symmetric ``a (..., n, n)`` to tridiagonal form.

    Returns ``(d, e, q)``: ``(..., n)``, ``(..., n-1)`` and the accumulated
    orthogonal ``q (..., n, n)`` (``q^T a q`` is tridiagonal), or ``None``
    for ``q`` when ``with_q=False``.
    """
    n = a.shape[-1]
    q = None
    if with_q:
        q = torch.eye(n, dtype=a.dtype, device=a.device).expand_as(a)
    for k in range(max(n - 2, 0)):
        v, beta = _householder_vector(a[..., :, k], k)
        # Symmetric two-sided update: A <- H A H.
        p = beta.unsqueeze(-1) * (a @ v.unsqueeze(-1)).squeeze(-1)
        kv = 0.5 * beta * (p * v).sum(dim=-1)
        w = p - kv.unsqueeze(-1) * v
        a = (a - v.unsqueeze(-1) * w.unsqueeze(-2)
             - w.unsqueeze(-1) * v.unsqueeze(-2))
        if with_q:  # Q <- Q H
            qv = beta.unsqueeze(-1) * (q @ v.unsqueeze(-1)).squeeze(-1)
            q = q - qv.unsqueeze(-1) * v.unsqueeze(-2)
    d = torch.diagonal(a, dim1=-2, dim2=-1)
    e = torch.diagonal(a, offset=1, dim1=-2, dim2=-1)
    return d.contiguous(), e.contiguous(), q


# Batch axes are written out, so the batched name is the same function.
tridiagonalize_batched = tridiagonalize


def tridiagonal_matrix(d: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Dense ``tridiag(e, d, e)``, batched over leading axes."""
    t = torch.diag_embed(d)
    if d.shape[-1] > 1:
        t = t + torch.diag_embed(e, 1) + torch.diag_embed(e, -1)
    return t
