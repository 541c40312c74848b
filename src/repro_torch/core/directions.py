"""Sign recovery for EEI eigenvector components (tridiagonal path).

The identity gives only ``|v[i, j]|^2``.  On a tridiagonal matrix the
three-term recurrence fixes the signs exactly; the twin of
``repro.core.directions.tridiagonal_signs``.  The dense inverse-iteration
signs wait for the ``eei_dense`` composition.
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
