"""Post-solve result verification: the ``verify`` stage role.

The twin of ``repro.engine.verify``, for bucketed top-k results
(:func:`verify_topk`) and per slot of segment-packed ones
(:func:`verify_topk_packed`).  The kernels clamp the EEI denominators at ``eps * spectral scale``, which keeps
results finite but not right on (near-)degenerate spectra; this stage
scores every row of a top-k result and returns per-matrix flags:

* **finite**: every selected eigenvalue and vector entry is finite;
* **residual**: ``max_i ||A v_i - lam_i v_i||_2 <= tol * max(||A||_F, tiny)``;
* **unit norm**: ``| ||v_i||_2 - 1 | <= norm_tol`` for every row;
* **bracket order**: ``lam[j+1] >= lam[j] - tol * scale``.

:func:`verify_topk` is torch and runs where the result lies, inside a
program; :func:`verify_topk_host` is the same arithmetic in numpy, for
results that were solved on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

#: Residual tolerance in units of ``||A||_F``: healthy float32 EEI residuals
#: sit at 1e-4 to 4e-4 of ``||A||_F``; a clamped-denominator garbage vector
#: is O(``||A||_F / sqrt(n)``) or NaN.
DEFAULT_TOL = 2e-3

#: Unit-norm tolerance: recover stages renormalise, so a healthy row is
#: 1 within a few ulp.
DEFAULT_NORM_TOL = 1e-3


class VerifyFlags(NamedTuple):
    """Per-matrix verdict, every field ``(b,)``: ``ok`` is the conjunction
    of the checks, ``residual`` the worst relative residual."""

    ok: torch.Tensor
    finite: torch.Tensor
    residual_ok: torch.Tensor
    norm_ok: torch.Tensor
    ordered: torch.Tensor
    residual: torch.Tensor


def _spectral_scale(a: torch.Tensor) -> torch.Tensor:
    """Per-matrix ``max(||A||_F, tiny)``."""
    fro = torch.sqrt(torch.sum(a * a, dim=(-2, -1)))
    return torch.clamp(fro, min=1e-30)


def verify_topk(a: torch.Tensor, lam_sel: torch.Tensor, vecs: torch.Tensor,
                tol: float = DEFAULT_TOL,
                norm_tol: float = DEFAULT_NORM_TOL) -> VerifyFlags:
    """Verify a batched top-k result where it lies.

    ``a (b, n, n)``, ``lam_sel (b, k)`` ascending, ``vecs (b, k, n)``
    (rows are eigenvectors).
    """
    scale = _spectral_scale(a)
    finite = (torch.isfinite(lam_sel).all(dim=-1)
              & torch.isfinite(vecs).all(dim=-1).all(dim=-1))
    av = torch.einsum("...ij,...kj->...ki", a, vecs)
    res = av - lam_sel.unsqueeze(-1) * vecs
    worst = torch.sqrt(torch.sum(res * res, dim=-1)).amax(dim=-1) / scale
    # NaN compares False, so a poisoned row fails residual_ok too.
    residual_ok = worst <= tol
    norms = torch.sqrt(torch.sum(vecs * vecs, dim=-1))
    norm_ok = ((norms - 1.0).abs() <= norm_tol).all(dim=-1)
    if lam_sel.shape[-1] < 2:
        ordered = torch.ones_like(finite)
    else:
        dif = lam_sel[..., 1:] - lam_sel[..., :-1]
        ordered = (dif >= -tol * scale.unsqueeze(-1)).all(dim=-1)
    ok = finite & residual_ok & norm_ok & ordered
    return VerifyFlags(ok=ok, finite=finite, residual_ok=residual_ok,
                       norm_ok=norm_ok, ordered=ordered, residual=worst)


def verify_topk_packed(a: torch.Tensor, seg_off: torch.Tensor,
                       seg_len: torch.Tensor, lam_seg: torch.Tensor,
                       vecs_seg: torch.Tensor, largest: bool = True,
                       tol: float = DEFAULT_TOL,
                       norm_tol: float = DEFAULT_NORM_TOL) -> VerifyFlags:
    """Verify a segment-packed top-k result per slot: flags ``(b, S)``.

    ``a (b, N, N)`` block-diagonal rows, ``seg_off, seg_len (b, S)``,
    ``lam_seg (b, S, k)``, ``vecs_seg (b, S, k, N)``.  The checks of
    :func:`verify_topk`, scoped to each segment so that they hold per
    request:

    * residuals of the vector masked to its segment, scaled by the
      segment's own Frobenius norm;
    * only the ``min(seg_len, k)`` valid lanes are checked (the clamped
      lanes sit at the front of a ``largest`` window, at the back of a
      smallest one);
    * ``norm_ok`` also needs the in-segment mass to reach ``1 - norm_tol``;
    * empty slots (``seg_len == 0``) pass.
    """
    k = lam_seg.shape[-1]
    n = a.shape[-1]
    seg_off = seg_off.to(device=a.device, dtype=torch.int32)
    seg_len = seg_len.to(device=a.device, dtype=torch.int32)
    col = torch.arange(n, dtype=torch.int32, device=a.device)
    in_seg = ((seg_off.unsqueeze(-1) <= col)
              & (col < (seg_off + seg_len).unsqueeze(-1)))  # (b, S, N)
    mask = in_seg.to(a.dtype)
    empty = seg_len == 0

    clen = torch.clamp(seg_len, max=k)
    t = torch.arange(k, dtype=torch.int32, device=a.device)
    if largest:
        valid = t >= (k - clen).unsqueeze(-1)  # (b, S, k)
    else:
        valid = t < clen.unsqueeze(-1)

    finite_lane = (torch.isfinite(lam_seg)
                   & torch.isfinite(vecs_seg).all(dim=-1))
    finite = (finite_lane | ~valid).all(dim=-1)

    seg_fro2 = torch.einsum("bsp,bpq,bsq->bs", mask, a * a, mask)
    scale = torch.clamp(torch.sqrt(seg_fro2), min=1e-30)  # (b, S)

    # The residual of the slice a caller is served: the vector masked to
    # its segment (what the mask drops is bounded by the mass check).
    vm = vecs_seg * mask.unsqueeze(-2)
    av = torch.einsum("bij,bskj->bski", a, vm)
    res = av - lam_seg.unsqueeze(-1) * vm
    res_norm = torch.sqrt(torch.sum(res * res, dim=-1))  # (b, S, k)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    worst = torch.where(valid, res_norm, zero).amax(dim=-1) / scale
    residual_ok = worst <= tol

    norms2 = torch.sum(vecs_seg * vecs_seg, dim=-1)  # (b, S, k)
    mass = torch.einsum("bsp,bskp->bsk", mask, vecs_seg * vecs_seg)
    lane_norm_ok = (((torch.sqrt(norms2) - 1.0).abs() <= norm_tol)
                    & (mass >= 1.0 - norm_tol))
    norm_ok = (lane_norm_ok | ~valid).all(dim=-1)

    if k < 2:
        ordered = torch.ones_like(finite)
    else:
        dif = lam_seg[..., 1:] - lam_seg[..., :-1]
        pair_valid = valid[..., 1:] & valid[..., :-1]
        ordered = ((dif >= -tol * scale.unsqueeze(-1))
                   | ~pair_valid).all(dim=-1)

    ok = (finite & residual_ok & norm_ok & ordered) | empty
    return VerifyFlags(ok=ok, finite=finite | empty,
                       residual_ok=residual_ok | empty,
                       norm_ok=norm_ok | empty, ordered=ordered | empty,
                       residual=torch.where(empty, zero, worst))


def verify_topk_host(a, lam_sel, vecs, tol: float = DEFAULT_TOL,
                     norm_tol: float = DEFAULT_NORM_TOL) -> VerifyFlags:
    """numpy twin of :func:`verify_topk`: the same checks and tolerances on
    host arrays, one matrix ``(n, n)`` or a stack; returns numpy flags."""
    a = np.asarray(a)
    lam_sel = np.asarray(lam_sel)
    vecs = np.asarray(vecs)
    squeeze = a.ndim == 2
    if squeeze:
        a, lam_sel, vecs = a[None], lam_sel[None], vecs[None]

    scale = np.maximum(np.sqrt(np.sum(a * a, axis=(-2, -1))), 1e-30)
    finite = (np.all(np.isfinite(lam_sel), axis=-1)
              & np.all(np.isfinite(vecs), axis=(-2, -1)))
    av = np.einsum("...ij,...kj->...ki", a, vecs)
    res = av - lam_sel[..., :, None] * vecs
    with np.errstate(invalid="ignore", over="ignore"):
        worst = np.max(np.sqrt(np.sum(res * res, axis=-1)), axis=-1) / scale
        residual_ok = worst <= tol
        norms = np.sqrt(np.sum(vecs * vecs, axis=-1))
        norm_ok = np.all(np.abs(norms - 1.0) <= norm_tol, axis=-1)
        dif = lam_sel[..., 1:] - lam_sel[..., :-1]
        ordered = np.all(dif >= -tol * scale[..., None], axis=-1)
    if lam_sel.shape[-1] < 2:
        ordered = np.ones_like(finite)

    ok = finite & residual_ok & norm_ok & ordered
    flags = VerifyFlags(ok=ok, finite=finite, residual_ok=residual_ok,
                        norm_ok=norm_ok, ordered=ordered, residual=worst)
    if squeeze:
        flags = VerifyFlags(*(f[0] for f in flags))
    return flags
