"""Sign recovery for EEI eigenvector components.

The identity gives only ``|v[i, j]|^2``.  The twin of
``repro.core.directions``:

* ``tridiagonal_signs``: on a tridiagonal matrix the three-term recurrence
  fixes the signs exactly;
* ``inverse_iteration_signs[_batched]``: the dense path, one shifted solve
  orients each eigenvector.  The solves go through ``lu_factor_ex`` (no
  error check) and ``lu_solve``: an exactly singular shifted system is not
  refused, as ``jax.scipy.linalg.lu_factor`` does not refuse it, and the
  card needs no host sync.
"""

from __future__ import annotations

import torch


def tridiagonal_signs(d: torch.Tensor, e: torch.Tensor, lam: torch.Tensor,
                      mags: torch.Tensor) -> torch.Tensor:
    """Signed tridiagonal eigenvectors from magnitudes.

    For ``T w = lam w``: ``e[j] w[j+1] = (lam - d[j]) w[j] - e[j-1] w[j-1]``.
    Starting from ``w[0] = +|w[0]|`` each next sign is the one the
    recurrence predicts; where ``e[j] ~ 0`` the matrix decouples and the
    next block restarts with ``+``.

    ``d (..., n)``, ``e (..., n-1)``, ``lam (..., k)``, ``mags (..., k, n)``
    -> ``(..., k, n)``: the signs applied to ``sqrt(mags)``.
    """
    n = d.shape[-1]
    w_abs = torch.sqrt(torch.clamp(mags, min=0.0))
    if n == 1:
        return w_abs
    scale = torch.maximum(d.abs().amax(dim=-1), e.abs().amax(dim=-1))
    tol = (torch.finfo(d.dtype).eps * torch.clamp(scale, min=1.0)
           * 10.0).unsqueeze(-1)
    w_prev2 = torch.zeros_like(w_abs[..., 0])
    w_prev = w_abs[..., 0]
    out = [w_prev]
    for j in range(n - 1):
        ej = e[..., j:j + 1]
        pred = (lam - d[..., j:j + 1]) * w_prev
        if j > 0:
            pred = pred - e[..., j - 1:j] * w_prev2
        sign = torch.where(ej.abs() <= tol, 1.0,
                           torch.sign(pred) * torch.sign(ej))
        sign = torch.where(sign == 0, 1.0, sign)
        w_prev2, w_prev = w_prev, sign * w_abs[..., j + 1]
        out.append(w_prev)
    return torch.stack(out, dim=-1)


def _orient(x: torch.Tensor, mags: torch.Tensor) -> torch.Tensor:
    """Signs of ``x`` (``0 -> +1``) on ``sqrt(mags)``, each row turned so
    that its largest-|component| entry (the first, on ties) is positive."""
    sign = torch.sign(x)
    v = torch.where(sign == 0, 1.0, sign) * torch.sqrt(
        torch.clamp(mags, min=0.0))
    vmax = torch.take_along_dim(v, v.abs().argmax(dim=-1, keepdim=True),
                                dim=-1)
    return v * torch.where(vmax < 0, -1.0, 1.0)


def _seed_rhs(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.ones(n, dtype=like.dtype, device=like.device) / n ** 0.5


def inverse_iteration_signs(a: torch.Tensor, lam, mags: torch.Tensor,
                            shift_eps: float = 1e-6) -> torch.Tensor:
    """Signed eigenvector of one matrix ``a (n, n)`` for the eigenvalue
    ``lam`` from its magnitudes ``mags (n,)``.

    Solves ``(A - (lam + delta) I) x = b`` for a fixed seed ``b``; ``x`` is
    dominated by the eigenvector nearest the shift, so ``sign(x)`` orients
    the magnitudes.
    """
    n = a.shape[-1]
    delta = shift_eps * (torch.diagonal(a).abs().amax() + 1.0)
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    lu, piv, _ = torch.linalg.lu_factor_ex(a - (lam + delta) * eye)
    x = torch.linalg.lu_solve(lu, piv, _seed_rhs(n, a).unsqueeze(-1))
    return _orient(x.squeeze(-1), mags)


def inverse_iteration_signs_batched(a: torch.Tensor, lam_sel: torch.Tensor,
                                    mags_sel: torch.Tensor,
                                    shift_eps: float = 1e-6) -> torch.Tensor:
    """Signed eigenvectors ``(b, k, n)`` of all selected pairs in one
    batched LU: ``a (b, n, n)``, ``lam_sel (b, k)``, ``mags_sel (b, k, n)``.

    The ``b * k`` shifted systems ``A_b - (lam_bk + delta_b) I`` are
    stacked, factored by one ``lu_factor_ex`` call and solved by one
    ``lu_solve``: the same systems as :func:`inverse_iteration_signs`.
    """
    b_n, k = lam_sel.shape
    n = a.shape[-1]
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    delta = shift_eps * (diag.abs().amax(dim=-1) + 1.0)
    shifts = lam_sel + delta.unsqueeze(-1)
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    shifted = a.unsqueeze(1) - shifts[:, :, None, None] * eye
    lu, piv, _ = torch.linalg.lu_factor_ex(shifted.reshape(b_n * k, n, n))
    rhs = _seed_rhs(n, a).expand(b_n * k, n).unsqueeze(-1)
    x = torch.linalg.lu_solve(lu, piv, rhs).reshape(b_n, k, n)
    return _orient(x, mags_sel)
