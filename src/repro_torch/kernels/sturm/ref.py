"""Pure-PyTorch oracle for the Sturm kernel: ``repro_torch.linalg.sturm``
with the kernel's batched calling convention."""

from __future__ import annotations

import torch

from repro_torch.linalg import sturm as _sturm


def sturm_eigenvalues(d: torch.Tensor, e: torch.Tensor,
                      n_iter: int = 0) -> torch.Tensor:
    """Eigenvalues of a batch of tridiagonals; d (B, n), e (B, n-1) -> (B, n)."""
    return _sturm.bisect_eigenvalues_batched(d, e, n_iter=n_iter)
