"""Public Sturm entry points over the kernel (bounds, windows, minor stacks).

``sturm_eigenvalues`` runs one launch over a ``(B, n)`` stack of bands;
``sturm_minor_spectra`` flattens all ``b * n`` minor bands of a ``(b, n)``
batch onto the kernel's row axis, so the whole stack is one launch.
The bounds are computed here exactly as ``repro.kernels.sturm.ops`` computes
them: Gershgorin widened by ``eps * span`` and
``pivmin = max(eps^2 * scale^2, tiny)``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.sturm.kernel import sturm_bisect
from repro_torch.linalg.sturm import _pivmin, default_iters, gershgorin_bounds


def sturm_eigenvalues(d: torch.Tensor, e: torch.Tensor, *, n_iter: int = 0,
                      window: tuple | None = None) -> torch.Tensor:
    """All eigenvalues of ``B`` symmetric tridiagonal bands, ``(B, n)``.

    ``window=(k, largest)`` bisects only the ``k`` extremal indices and
    returns ``(B, k)`` ascending, bitwise-equal to the matching slice of the
    full spectrum (lanes are independent).
    """
    n = d.shape[-1]
    m, target_base = n, 0
    if window is not None:
        k, largest = int(window[0]), bool(window[1])
        if not 1 <= k <= n:
            raise ValueError(f"window k={k} out of range for n={n}")
        m, target_base = k, (n - k if largest else 0)
    lo, hi = gershgorin_bounds(d, e)
    bounds = torch.stack([lo, hi, _pivmin(d, e)], dim=-1)
    return sturm_bisect(d.contiguous(), e.contiguous(), bounds,
                        target_base=target_base, m=m,
                        n_iter=n_iter or default_iters(d.dtype))


def sturm_minor_spectra(dm: torch.Tensor, em: torch.Tensor, *,
                        n_iter: int = 0) -> torch.Tensor:
    """Spectra of all stacked minor bands ``dm (b, n, m)``, ``em (b, n, m-1)``
    in one launch; returns ``(b, n, m)``."""
    b, n, m = dm.shape
    mu = sturm_eigenvalues(dm.reshape(b * n, m), em.reshape(b * n, m - 1),
                           n_iter=n_iter)
    return mu.reshape(b, n, m)
