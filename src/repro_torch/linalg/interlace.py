"""Cauchy interlacing utilities, plain PyTorch.

The twin of ``repro.linalg.interlace``.  If ``mu`` is the sorted spectrum
of a principal minor of ``A`` with sorted spectrum ``lam``, then
``lam[k] <= mu[k] <= lam[k+1]``.  The rank-1 forms give the warm bisection
brackets of the streaming session: Weyl plus rank-1 interlacing, tightened
by bisecting the secular equation of the retained frame.
"""

from __future__ import annotations

import torch


def _as(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def interlacing_holds(lam, mu, rtol: float = 1e-6) -> torch.Tensor:
    """Boolean scalar: does ``mu`` interlace ``lam`` (up to tolerance)?"""
    lam = torch.sort(torch.as_tensor(lam)).values
    mu = torch.sort(_as(mu, lam)).values
    scale = torch.maximum(lam[-1].abs(), lam[0].abs()) + 1e-30
    tol = rtol * scale
    lower_ok = torch.all(mu >= lam[:-1] - tol)
    upper_ok = torch.all(mu <= lam[1:] + tol)
    return lower_ok & upper_ok


def _bracket_scale(lam: torch.Tensor) -> torch.Tensor:
    """``max |lam|`` over the trailing axis plus a tiny absolute floor, so
    an all-zero spectrum still gets non-degenerate brackets."""
    return lam.abs().amax(dim=-1, keepdim=True) + 1e-30


def _widen_to_floor(lam, lo, hi, rtol):
    """Widen each ``[lo, hi]`` symmetrically to at least ``rtol * scale``."""
    floor = rtol * _bracket_scale(lam)
    pad = torch.clamp(floor - (hi - lo), min=0.0) * 0.5
    return lo - pad, hi + pad


def interlacing_brackets(lam, rtol: float = 1e-7):
    """Per-index bisection brackets ``(lo, hi)`` for a minor's spectrum:
    ``[lam[i], lam[i+1]]``, each widened to a width of at least
    ``rtol * scale`` so that repeated eigenvalues stay bisectable
    (``rtol = 0`` keeps the raw intervals)."""
    lam = torch.as_tensor(lam)
    lo, hi = lam[..., :-1], lam[..., 1:]
    if rtol <= 0:
        return lo, hi
    return _widen_to_floor(lam, lo, hi, rtol)


def rank1_update_brackets(lam, rho, drift_bound=0.0, rtol: float = 1e-7):
    """Per-index brackets for the spectrum of ``A + rho * u u^T`` (``u``
    unit, ``rho`` signed) from the previous spectrum ``lam (..., m)``:

    * ``rho >= 0``: ``lam[i] <= lam'[i] <= min(lam[i+1], lam[i] + rho)``;
    * ``rho <  0``: ``max(lam[i-1], lam[i] + rho) <= lam'[i] <= lam[i]``.

    ``drift_bound`` widens both ends by an absolute slack, and the width
    floor of :func:`interlacing_brackets` keeps repeated eigenvalues
    bisectable.  ``rho`` is a scalar or ``(...,)``.  Returns ``(lo, hi)``,
    each ``(..., m)``.
    """
    lam = torch.as_tensor(lam)
    rho = _as(rho, lam).unsqueeze(-1)
    up_lo = lam
    up_hi = torch.minimum(
        torch.cat([lam[..., 1:], lam[..., -1:] + rho], dim=-1),
        lam + rho)
    dn_lo = torch.maximum(
        torch.cat([lam[..., :1] + rho, lam[..., :-1]], dim=-1),
        lam + rho)
    dn_hi = lam
    pos = rho >= 0
    lo = torch.where(pos, up_lo, dn_lo) - drift_bound
    hi = torch.where(pos, up_hi, dn_hi) + drift_bound
    return _widen_to_floor(lam, lo, hi, rtol)


def secular_bracket_refine(lam, z2, rho, lo, hi, n_iter: int = 12):
    """Tighten rank-1 update brackets by bisecting the secular equation
    ``f(x) = 1 + rho * sum_j z2[j] / (lam[j] - x)`` of the compression
    ``diag(lam) + rho z z^T`` (``z2 = z**2``).  ``f`` is monotone on each
    interlacing interval, so ``n_iter`` bisection steps shrink ``(lo, hi)``
    towards its root without leaving the input interval.  ``lam, z2, lo,
    hi`` are ``(..., m)``; ``rho`` broadcasts.
    """
    lam = torch.as_tensor(lam)
    poles = lam.unsqueeze(-2)  # (..., 1, m)
    z2 = _as(z2, lam).unsqueeze(-2)
    rho = _as(rho, lam)
    # f' has the sign of rho on every interval: normalise the direction so
    # that "sgn * f(mid) < 0" means the root lies to the right.
    sgn = torch.where(rho >= 0, 1.0, -1.0).to(lam.dtype).unsqueeze(-1)
    rho = rho.unsqueeze(-1)

    guard = _as(1e-30, lam)

    def f(x):
        d = x.unsqueeze(-1) - poles  # (..., m, m)
        # At a pole the sign of the blow-up decides; keep it finite.
        d = torch.where(d.abs() < 1e-30, torch.where(d >= 0, guard, -guard), d)
        return 1.0 - rho * torch.sum(z2 / d, dim=-1)

    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        go_right = sgn * f(mid) < 0
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid)
    return lo, hi


def ritz_interlacing_holds(lam, theta, rtol: float = 1e-6) -> torch.Tensor:
    """Boolean scalar: do the Ritz values ``theta`` (size m) satisfy the
    Poincare separation ``lam[i] <= theta[i] <= lam[i + n - m]`` against
    the full spectrum ``lam`` (size n)?"""
    lam = torch.sort(torch.as_tensor(lam)).values
    theta = torch.sort(_as(theta, lam)).values
    n = lam.shape[-1]
    m = theta.shape[-1]
    scale = torch.maximum(lam[-1].abs(), lam[0].abs()) + 1e-30
    tol = rtol * scale
    lower_ok = torch.all(theta >= lam[:m] - tol)
    upper_ok = torch.all(theta <= lam[n - m:] + tol)
    return lower_ok & upper_ok
