"""Log-space difference sums: the CUDA kernel's wrapper and its plain version.

:func:`logabs_sum` launches ``csrc/prod_diff.cu`` (the port of the TPU
kernel ``repro.kernels.prod_diff.kernel.logabs_sum_batched_padded``) for
CUDA tensors and runs :func:`logabs_sum_plain` for CPU tensors; any other
device raises.  ``logabs_sum.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.core.identity import logabs_numerator_clamped
from repro_torch.kernels import build

_ENTRY = {torch.float32: "logabs_sum_f32", torch.float64: "logabs_sum_f64"}


def logabs_sum_plain(lam: torch.Tensor, mu: torch.Tensor,
                     floor: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in row chunks of ``lam`` so the
    ``(B, i, J, K)`` difference tensor is never whole."""
    return logabs_numerator_clamped(lam, mu, floor)


def _check(lam, mu, floor):
    if lam.dtype not in _ENTRY:
        raise TypeError(f"logabs_sum takes float32 or float64, got {lam.dtype}")
    if lam.ndim != 2 or mu.ndim != 3 or mu.shape[0] != lam.shape[0]:
        raise ValueError(
            f"expected lam (B, I) and mu (B, J, K), got {tuple(lam.shape)} "
            f"and {tuple(mu.shape)}")
    if tuple(floor.shape) != (lam.shape[0],):
        raise ValueError(f"floor must be ({lam.shape[0]},), got "
                         f"{tuple(floor.shape)}")
    for name, t in (("mu", mu), ("floor", floor)):
        if t.dtype != lam.dtype or t.device != lam.device:
            raise TypeError(f"{name} must be {lam.dtype} on {lam.device}")


def logabs_sum(lam: torch.Tensor, mu: torch.Tensor,
               floor: torch.Tensor) -> torch.Tensor:
    """``out[b, i, j] = sum_k log(max(|lam[b, i] - mu[b, j, k]|, floor[b]))``.

    ``lam (B, I)``, ``mu (B, J, K)``, ``floor (B,)``; returns ``(B, I, J)``.
    The ``k`` terms are added in order, whatever ``I`` is.
    """
    _check(lam, mu, floor)
    if lam.device.type == "cpu":
        return logabs_sum_plain(lam, mu, floor)
    if lam.device.type != "cuda":
        raise ValueError(f"logabs_sum runs on cpu or cuda, not {lam.device}")
    if not (lam.is_contiguous() and mu.is_contiguous()
            and floor.is_contiguous()):
        raise ValueError("logabs_sum needs contiguous lam, mu and floor")
    b_n, i_n = lam.shape
    _, j_n, k_n = mu.shape
    if b_n > 65535:
        raise ValueError(f"logabs_sum takes at most 65535 matrices, got {b_n}")
    out = torch.empty((b_n, i_n, j_n), dtype=lam.dtype, device=lam.device)
    if out.numel() == 0:
        return out
    lib = build.library()
    name = _ENTRY[lam.dtype]
    with torch.cuda.device(lam.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, name)(
            lam.data_ptr(), mu.data_ptr(), floor.data_ptr(), out.data_ptr(),
            b_n, i_n, j_n, k_n, stream)
    build.check(lib, name, code)
    logabs_sum.launches += 1
    return out


logabs_sum.launches = 0
