"""Sturm bisection: the CUDA kernels' wrappers and their plain versions.

:func:`sturm_bisect` launches ``csrc/sturm.cu`` (the port of the TPU kernel
``repro.kernels.sturm.kernel.sturm_padded``) for CUDA tensors and runs
:func:`sturm_bisect_plain` for CPU tensors; any other device raises.  Lane
``(row, m)`` brackets eigenvalue ``target_base + m`` of band ``row`` from
that row's ``bounds = [lo, hi, pivmin]``.

:func:`sturm_segmented` launches ``csrc/sturm_segmented.cu`` (the port of
``repro.kernels.sturm.kernel.sturm_segmented_padded``), or runs
:func:`sturm_segmented_plain` on the CPU: every lane carries its own
bracket, ``pivmin``, segment ``[start, end)`` and target index.

Each wrapper's ``.launches`` counts its kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.linalg.sturm import bisect_lanes, bisect_lanes_segmented

_ENTRY = {torch.float32: "sturm_bisect_f32", torch.float64: "sturm_bisect_f64"}
_SEG_ENTRY = {torch.float32: "sturm_segmented_f32",
              torch.float64: "sturm_segmented_f64"}
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
    build.launch(_ENTRY[d.dtype], d.device, d, e, bounds, out, rows, n, m,
                 target_base, n_iter)
    sturm_bisect.launches += 1
    return out


sturm_bisect.launches = 0


def sturm_segmented_plain(d, e, lo, hi, pivmin, start, end, targets, *,
                          n_iter: int) -> torch.Tensor:
    """Plain PyTorch version of the segmented kernel, ``(rows, m)``."""
    return bisect_lanes_segmented(d, e, lo, hi, pivmin, start, end, targets,
                                  n_iter)


def _check_segmented(d, e, lanes, n_iter):
    if d.dtype not in _SEG_ENTRY:
        raise TypeError(
            f"sturm_segmented takes float32 or float64, got {d.dtype}")
    if d.ndim != 2 or d.shape[1] < 1:
        raise ValueError(f"d must be (rows, n), got {tuple(d.shape)}")
    rows, n = d.shape
    if e.dtype != d.dtype or e.device != d.device:
        raise TypeError(f"e must be {d.dtype} on {d.device}")
    if tuple(e.shape) != (rows, n - 1):
        raise ValueError(f"e must be {(rows, n - 1)}, got {tuple(e.shape)}")
    shape = tuple(lanes["lo"].shape)
    if len(shape) != 2 or shape[0] != rows:
        raise ValueError(f"lane arrays must be ({rows}, m), got {shape}")
    for name, t in lanes.items():
        dtype = d.dtype if name in ("lo", "hi", "pivmin") else torch.int32
        if t.dtype != dtype or t.device != d.device:
            raise TypeError(f"{name} must be {dtype} on {d.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")


def sturm_segmented(d: torch.Tensor, e: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor, pivmin: torch.Tensor,
                    start: torch.Tensor, end: torch.Tensor,
                    targets: torch.Tensor, *, n_iter: int) -> torch.Tensor:
    """Lane ``(row, m)``: eigenvalue ``targets[row, m]`` of the block
    ``[start, end)`` of band ``row``, bisected from its own ``[lo, hi]``.

    ``d (rows, n)``, ``e (rows, n-1)``; ``lo, hi, pivmin`` float and
    ``start, end, targets`` int32, each ``(rows, m)``.  Returns
    ``(rows, m)``.
    """
    lanes = {"lo": lo, "hi": hi, "pivmin": pivmin, "start": start,
             "end": end, "targets": targets}
    _check_segmented(d, e, lanes, n_iter)
    if d.device.type == "cpu":
        return sturm_segmented_plain(d, e, lo, hi, pivmin, start, end,
                                     targets, n_iter=n_iter)
    if d.device.type != "cuda":
        raise ValueError(
            f"sturm_segmented runs on cpu or cuda, not {d.device}")
    if not all(t.is_contiguous() for t in (d, e, *lanes.values())):
        raise ValueError("sturm_segmented needs contiguous operands")
    rows, n = d.shape
    m = lo.shape[1]
    if 2 * n * d.element_size() > _MAX_SHARED_BYTES:
        raise ValueError(f"band n={n} does not fit one block's shared memory")
    out = torch.empty((rows, m), dtype=d.dtype, device=d.device)
    if rows == 0 or m == 0:
        return out
    build.launch(_SEG_ENTRY[d.dtype], d.device, d, e, lo, hi, pivmin, start,
                 end, targets, out, rows, n, m, n_iter)
    sturm_segmented.launches += 1
    return out


sturm_segmented.launches = 0
