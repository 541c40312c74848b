"""Public entry point of the minor-determinant magnitudes kernel.

:func:`tridiag_windowed_magnitudes` is ``core.identity``'s function of the
same name on the ``cuda`` backend: one launch of ``csrc/minor_det.cu`` for
the whole stack on a CUDA tensor, the plain loop on a CPU one.  The top-k
``minor_det`` stage and the Lanczos residual check call it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.minor_det.kernel import minor_det


def tridiag_windowed_magnitudes(d: torch.Tensor, e: torch.Tensor,
                                lam_sel: torch.Tensor) -> torch.Tensor:
    """Normalized ``|w[i, j]|^2`` rows for selected eigenvalues, ``(..., k,
    n)``: ``d (..., n)``, ``e (..., n-1)`` and ``lam_sel (..., k)`` with the
    same leading axes."""
    return minor_det(d.contiguous(), e.contiguous(), lam_sel.contiguous())
