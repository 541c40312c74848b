"""Public prod-diff entry points over the kernel: the EEI magnitude tables.

``eei_magnitudes_batched`` builds the whole ``(b, n, n)`` table with one
kernel launch for the numerator; ``eei_magnitudes_windowed`` evaluates only
the selected rows (the kernel's ``I`` extent shrinks from ``n`` to ``k``).
The O(b n^2) Cauchy denominator stays in PyTorch.  The per-matrix mask
variant (``mask=``) is a separate TPU kernel that waits for the packed
serving path.
"""

from __future__ import annotations

import torch

from repro_torch.core.identity import logabs_denominator_clamped, spectral_floor
from repro_torch.kernels.prod_diff.kernel import logabs_sum


def logabs_sum_batched(lam: torch.Tensor, mu: torch.Tensor,
                       floor) -> torch.Tensor:
    """``out[b, i, j] = sum_k log(max(|lam[b, i] - mu[b, j, k]|, floor[b]))``.

    ``lam (B, I)``, ``mu (B, J, K)``, ``floor`` a scalar or ``(B,)``; one
    kernel launch for the whole stack.
    """
    floor = torch.as_tensor(floor, dtype=lam.dtype, device=lam.device)
    floor = floor.expand(lam.shape[:1]).contiguous()
    return logabs_sum(lam.contiguous(), mu.contiguous(), floor)


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
