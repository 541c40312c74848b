"""Log-space difference sums: the CUDA kernels' wrappers and plain versions.

Each wrapper launches its kernel of ``csrc/prod_diff.cu`` for CUDA tensors
and runs its plain version for CPU tensors; any other device raises.  Each
wrapper's ``.launches`` counts its kernel launches.

* :func:`logabs_sum`, the port of the TPU kernel
  ``repro.kernels.prod_diff.kernel.logabs_sum_batched_padded``: a stack,
  one floor per matrix;
* :func:`logabs_sum_masked`, the port of
  ``logabs_sum_batched_masked_padded``: the same with a validity mask per
  matrix, where a masked cell adds exactly 0;
* :func:`logabs_sum_single`, the port of ``logabs_sum_padded``: one matrix
  and one scalar floor, launched as :func:`logabs_sum`'s kernel on a batch
  of one.
"""

from __future__ import annotations

import torch

from repro_torch.core.identity import logabs_numerator_clamped
from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.float64)


def _entry(name: str, dtype: torch.dtype) -> str:
    return f"{name}_{'f32' if dtype == torch.float32 else 'f64'}"


def logabs_sum_plain(lam: torch.Tensor, mu: torch.Tensor,
                     floor: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, in row chunks of ``lam`` so the
    ``(B, i, J, K)`` difference tensor is never whole."""
    return logabs_numerator_clamped(lam, mu, floor)


def logabs_sum_masked_plain(lam: torch.Tensor, mu: torch.Tensor,
                            mask: torch.Tensor,
                            floor: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the masked kernel, in row chunks."""
    return logabs_numerator_clamped(lam, mu, floor, mask=mask)


#: Plain version of the single-matrix kernel: the same arithmetic, with no
#: batch axis.
logabs_sum_single_plain = logabs_sum_plain


def _check(what, lam, mu, floor, mask=None):
    if lam.dtype not in _DTYPES:
        raise TypeError(f"{what} takes float32 or float64, got {lam.dtype}")
    if lam.ndim != 2 or mu.ndim != 3 or mu.shape[0] != lam.shape[0]:
        raise ValueError(f"{what}: expected lam (B, I) and mu (B, J, K), got "
                         f"{tuple(lam.shape)} and {tuple(mu.shape)}")
    if tuple(floor.shape) != lam.shape[:1]:
        raise ValueError(f"floor must be {tuple(lam.shape[:1])}, got "
                         f"{tuple(floor.shape)}")
    for name, t in (("mu", mu), ("floor", floor)):
        if t.dtype != lam.dtype or t.device != lam.device:
            raise TypeError(f"{name} must be {lam.dtype} on {lam.device}")
    if mask is not None:
        if mask.dtype != torch.bool or mask.device != lam.device:
            raise TypeError(f"mask must be torch.bool on {lam.device}")
        if mask.shape != mu.shape:
            raise ValueError(f"mask must be {tuple(mu.shape)}, got "
                             f"{tuple(mask.shape)}")


def _dispatch(wrapper, plain, args, kernel=None):
    """Run ``plain(*args)`` on CPU tensors; on CUDA tensors launch the
    kernel ``kernel`` (by default named after ``wrapper``) and count the
    launch on ``wrapper``.  ``args`` starts with ``lam (B, I)`` and ``mu (B,
    J, K)``; the output is ``(B, I, J)``."""
    what = wrapper.__name__
    lam, mu = args[0], args[1]
    if lam.device.type == "cpu":
        return plain(*args)
    if lam.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {lam.device}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError(f"{what} needs contiguous operands")
    if lam.shape[0] > 65535:
        raise ValueError(f"{what} takes at most 65535 matrices, got "
                         f"{lam.shape[0]}")
    out = torch.empty(lam.shape + mu.shape[-2:-1], dtype=lam.dtype,
                      device=lam.device)
    if out.numel() == 0:
        return out
    build.launch(_entry(kernel or what, lam.dtype), lam.device, *args, out,
                 *lam.shape, *mu.shape[-2:])
    wrapper.launches += 1
    return out


def logabs_sum(lam: torch.Tensor, mu: torch.Tensor,
               floor: torch.Tensor) -> torch.Tensor:
    """``out[b, i, j] = sum_k log(max(|lam[b, i] - mu[b, j, k]|, floor[b]))``.

    ``lam (B, I)``, ``mu (B, J, K)``, ``floor (B,)``; returns ``(B, I, J)``.
    The ``k`` terms are added in order, whatever ``I`` is.
    """
    _check("logabs_sum", lam, mu, floor)
    return _dispatch(logabs_sum, logabs_sum_plain, (lam, mu, floor))


logabs_sum.launches = 0


def logabs_sum_masked(lam: torch.Tensor, mu: torch.Tensor,
                      mask: torch.Tensor,
                      floor: torch.Tensor) -> torch.Tensor:
    """``out[b, i, j] = sum_k [mask[b, j, k]] log(max(|lam[b, i] - mu[b, j,
    k]|, floor[b]))``: a masked cell adds exactly 0.

    ``lam (B, I)``, ``mu (B, J, K)``, ``mask (B, J, K)`` bool, ``floor
    (B,)``; returns ``(B, I, J)``.  The ``k`` terms are added in order.
    """
    _check("logabs_sum_masked", lam, mu, floor, mask=mask)
    return _dispatch(logabs_sum_masked, logabs_sum_masked_plain,
                     (lam, mu, mask, floor))


logabs_sum_masked.launches = 0


def logabs_sum_single(lam: torch.Tensor, mu: torch.Tensor,
                      floor: torch.Tensor) -> torch.Tensor:
    """``out[i, j] = sum_k log(max(|lam[i] - mu[j, k]|, floor))`` for one
    matrix: ``lam (I,)``, ``mu (J, K)``, ``floor`` a 0-d tensor; returns
    ``(I, J)``.  The ``k`` terms are added in order.

    It launches :func:`logabs_sum`'s kernel on a batch of one, and counts
    the launch here, not on :func:`logabs_sum`."""
    if lam.ndim != 1 or mu.ndim != 2 or floor.ndim != 0:
        raise ValueError(f"logabs_sum_single: expected lam (I,), mu (J, K) "
                         f"and a 0-d floor, got {tuple(lam.shape)}, "
                         f"{tuple(mu.shape)} and {tuple(floor.shape)}")
    args = (lam[None], mu[None], floor.reshape(1))
    _check("logabs_sum_single", *args)
    return _dispatch(logabs_sum_single, logabs_sum_plain, args,
                     kernel="logabs_sum")[0]


logabs_sum_single.launches = 0
