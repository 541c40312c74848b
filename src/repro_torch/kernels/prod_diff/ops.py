"""Public prod-diff entry points over the kernels: the EEI magnitude tables.

Two tiers, as in ``repro.kernels.prod_diff.ops``:

* ``logabs_sum_batched`` / ``eei_magnitudes_batched`` /
  ``eei_magnitudes_windowed``, the engine path: one launch over a
  ``(b, ...)`` stack.  ``eei_magnitudes_windowed`` evaluates only the
  selected rows (the kernel's ``I`` extent shrinks from ``n`` to ``k``).
  ``logabs_sum_batched(..., mask=)`` takes a validity mask per matrix (the
  masked kernel), for stacks whose valid region differs from row to row.
* ``logabs_sum`` / ``eei_magnitudes``, one matrix on the single-matrix
  kernel with a scalar floor: the baseline the batched kernel replaces.

The O(b n^2) Cauchy denominator stays in PyTorch.
"""

from __future__ import annotations

import torch

from repro_torch.core.identity import logabs_denominator_clamped, spectral_floor
from repro_torch.kernels.prod_diff import kernel as _kernel


def logabs_sum_batched(lam: torch.Tensor, mu: torch.Tensor, floor, *,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """``out[b, i, j] = sum_k log(max(|lam[b, i] - mu[b, j, k]|, floor[b]))``.

    ``lam (B, I)``, ``mu (B, J, K)``, ``floor`` a scalar or ``(B,)``; one
    kernel launch for the whole stack.  ``mask (B, J, K)`` (cells where it
    is ``> 0`` are valid) switches to the per-matrix-mask kernel: masked
    cells add exactly 0.
    """
    floor = torch.as_tensor(floor, dtype=lam.dtype, device=lam.device)
    floor = floor.expand(lam.shape[:1]).contiguous()
    if mask is not None:
        valid = torch.as_tensor(mask, device=lam.device).to(lam.dtype) > 0
        return _kernel.logabs_sum_masked(lam.contiguous(), mu.contiguous(),
                                         valid.contiguous(), floor)
    return _kernel.logabs_sum(lam.contiguous(), mu.contiguous(), floor)


#: Per-matrix gap clamp ``eps * spectral scale`` (``lam`` ascending).
_floor_from_spectra = spectral_floor


def _log_denominator(lam: torch.Tensor, floor: torch.Tensor,
                     idx: torch.Tensor | None = None) -> torch.Tensor:
    """Cauchy log-denominator rows ``sum_{k != i} log max(|lam_i - lam_k|,
    floor)``, ``(B, n)``, or only the ``idx`` rows ``(B, k)``.

    The windowed form slices the full table, so it is bitwise-equal to it
    whatever order a reduction over fewer rows would take.
    """
    log_den = logabs_denominator_clamped(lam, floor)
    return log_den if idx is None else log_den[:, idx]


def eei_magnitudes_batched(lam: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """All ``|v[b, i, j]|^2``: ``lam (B, n)`` ascending, ``mu (B, n, n-1)``."""
    floor = _floor_from_spectra(lam)
    log_num = logabs_sum_batched(lam, mu, floor)
    return torch.exp(log_num - _log_denominator(lam, floor).unsqueeze(-1))


def eei_magnitudes_windowed(lam: torch.Tensor, mu: torch.Tensor,
                            idx: torch.Tensor) -> torch.Tensor:
    """Rows ``|v[b, idx, j]|^2`` only, ``(B, k, n)``.

    The floor and the denominator come from the full spectrum as in
    :func:`eei_magnitudes_batched`, and the kernel's ``k`` order does not
    depend on the ``I`` extent, so the rows are bitwise-equal to the
    matching rows of the full table.
    """
    floor = _floor_from_spectra(lam)
    log_num = logabs_sum_batched(lam[:, idx], mu, floor)
    return torch.exp(log_num - _log_denominator(lam, floor, idx).unsqueeze(-1))


# ---------------------------------------------------------------------------
# One matrix, on the single-matrix kernel.
# ---------------------------------------------------------------------------


def logabs_sum(lam: torch.Tensor, mu: torch.Tensor, floor) -> torch.Tensor:
    """``out[i, j] = sum_k log(max(|lam[i] - mu[j, k]|, floor))``:
    ``lam (I,)``, ``mu (J, K)``, ``floor`` a scalar -> ``(I, J)``."""
    floor = torch.as_tensor(floor, dtype=lam.dtype, device=lam.device)
    return _kernel.logabs_sum_single(lam.contiguous(), mu.contiguous(),
                                     floor.reshape(()).contiguous())


def eei_magnitudes(lam: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """All ``|v[i, j]|^2`` from one matrix's spectra: ``lam (n,)``
    ascending, ``mu (n, n-1)`` minor spectra."""
    n = lam.shape[0]
    floor = _floor_from_spectra(lam)
    log_num = logabs_sum(lam, mu, floor)
    diff = (lam[:, None] - lam[None, :]).abs()
    eye = torch.eye(n, dtype=torch.bool, device=lam.device)
    diff = torch.where(eye, 1.0, torch.maximum(diff, floor))
    log_den = torch.log(diff).sum(dim=-1)
    return torch.exp(log_num - log_den[:, None])
