"""Sturm bisection: the CUDA kernel's wrapper and its plain version.

:func:`sturm_bisect` launches ``csrc/sturm.cu`` (the port of the TPU kernel
``repro.kernels.sturm.kernel.sturm_padded``) for CUDA tensors and runs
:func:`sturm_bisect_plain` for CPU tensors; any other device raises.  Lane
``(row, m)`` brackets eigenvalue ``target_base + m`` of band ``row`` from
that row's ``bounds = [lo, hi, pivmin]``.  ``sturm_bisect.launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.linalg.sturm import bisect_lanes

_ENTRY = {torch.float32: "sturm_bisect_f32", torch.float64: "sturm_bisect_f64"}
_MAX_SHARED_BYTES = 232_448  # opt-in shared memory of one H100 block


def sturm_bisect_plain(d: torch.Tensor, e: torch.Tensor, bounds: torch.Tensor,
                       *, target_base: int, m: int,
                       n_iter: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, ``(rows, m)``."""
    return bisect_lanes(d, e, bounds[:, 0], bounds[:, 1], bounds[:, 2],
                        target_base, m, n_iter)


def _check(d, e, bounds, target_base, m, n_iter):
    if d.dtype not in _ENTRY:
        raise TypeError(f"sturm_bisect takes float32 or float64, got {d.dtype}")
    if d.ndim != 2:
        raise ValueError(f"d must be (rows, n), got {tuple(d.shape)}")
    rows, n = d.shape
    for name, t, shape in (("e", e, (rows, n - 1)), ("bounds", bounds, (rows, 3))):
        if t.dtype != d.dtype or t.device != d.device:
            raise TypeError(f"{name} must be {d.dtype} on {d.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if n < 1 or m < 0 or target_base < 0 or target_base + m > n:
        raise ValueError(
            f"lanes [{target_base}, {target_base + m}) out of range for n={n}")
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")


def sturm_bisect(d: torch.Tensor, e: torch.Tensor, bounds: torch.Tensor, *,
                 target_base: int, m: int, n_iter: int) -> torch.Tensor:
    """Eigenvalues ``target_base .. target_base + m - 1`` of each band.

    ``d (rows, n)``, ``e (rows, n-1)``, ``bounds (rows, 3)``; returns
    ``(rows, m)`` ascending.
    """
    _check(d, e, bounds, target_base, m, n_iter)
    if d.device.type == "cpu":
        return sturm_bisect_plain(d, e, bounds, target_base=target_base, m=m,
                                  n_iter=n_iter)
    if d.device.type != "cuda":
        raise ValueError(f"sturm_bisect runs on cpu or cuda, not {d.device}")
    if not (d.is_contiguous() and e.is_contiguous() and bounds.is_contiguous()):
        raise ValueError("sturm_bisect needs contiguous d, e and bounds")
    rows, n = d.shape
    if 2 * n * d.element_size() > _MAX_SHARED_BYTES:
        raise ValueError(f"band n={n} does not fit one block's shared memory")
    out = torch.empty((rows, m), dtype=d.dtype, device=d.device)
    if rows == 0 or m == 0:
        return out
    lib = build.library()
    name = _ENTRY[d.dtype]
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, name)(
            d.data_ptr(), e.data_ptr(), bounds.data_ptr(), out.data_ptr(),
            rows, n, m, target_base, n_iter, stream)
    build.check(lib, name, code)
    sturm_bisect.launches += 1
    return out


sturm_bisect.launches = 0
