"""Pure-PyTorch oracle for the prod-diff kernel (one matrix, unchunked)."""

from __future__ import annotations

import torch


def logabs_sum(lam: torch.Tensor, mu: torch.Tensor, floor) -> torch.Tensor:
    """``out[i, j] = sum_k log(max(|lam[i] - mu[j, k]|, floor))``;
    ``lam (I,)``, ``mu (J, K)`` -> ``(I, J)``."""
    ad = (lam[:, None, None] - mu[None, :, :]).abs()
    return torch.log(torch.clamp(ad, min=floor)).sum(dim=-1)


def eei_magnitudes(lam: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """All ``|v[i, j]|^2`` from spectra (log space); ``lam (n,)``,
    ``mu (n, n-1)``."""
    n = lam.shape[0]
    scale = max(abs(float(lam[-1])), abs(float(lam[0]))) + 1e-30
    floor = torch.finfo(lam.dtype).eps * scale
    log_num = logabs_sum(lam, mu, floor)
    diff = torch.clamp((lam[:, None] - lam[None, :]).abs(), min=floor)
    diff = torch.where(torch.eye(n, dtype=torch.bool, device=lam.device),
                       1.0, diff)
    log_den = torch.log(diff).sum(dim=-1)
    return torch.exp(log_num - log_den[:, None])
