"""Minor-determinant magnitudes: the CUDA kernel's wrapper and its plain
version.

:func:`minor_det` launches ``csrc/minor_det.cu`` for CUDA tensors and runs
:func:`minor_det_plain` for CPU tensors; any other device raises.  The
plain version is ``core.identity.tridiag_windowed_magnitudes``, the host
loop that the ``reference`` and ``torch`` backends run as ``repro``'s twin.
The kernel replaces no TPU kernel: ``repro`` leaves this function to
``jnp`` (two ``lax.scan``s), and the plain loop issues about seven launches
a band row, which is why it has a kernel on the card.

``minor_det.launches`` counts kernel launches, those of a CUDA graph that
holds :func:`minor_det` at each of its replays (``captured``,
``replayed``), as ``kernels.sturm.kernel`` counts kernel 1's.  The tracing
counters ``minor_det_kernel`` (a launch, a replayed one included) and
``minor_det_plain`` (a call of the plain version through the wrapper)
count the same way; no metric reads them.
"""

from __future__ import annotations

import math
import threading

import torch

from repro_torch.core.identity import tridiag_windowed_magnitudes
from repro_torch.kernels import build
from repro_torch.tracing import count

_ENTRY = {torch.float32: "minor_det_f32", torch.float64: "minor_det_f64"}
_MAX_SHARED_BYTES = 232_448  # opt-in shared memory of one H100 block
#: Threads a block of ``csrc/minor_det.cu`` (its ``kMaxThreads``) and the
#: lanes it takes: two threads a lane, one a sweep.
_THREADS = 128
_LANES_PER_BLOCK = _THREADS // 2

#: Plain PyTorch version of the kernel, ``(..., k, n)``.
minor_det_plain = tridiag_windowed_magnitudes


def _check(d, e, x):
    if d.dtype not in _ENTRY:
        raise TypeError(f"minor_det takes float32 or float64, got {d.dtype}")
    if d.ndim < 1 or d.shape[-1] < 1:
        raise ValueError(f"d must be (..., n) with n >= 1, got "
                         f"{tuple(d.shape)}")
    lead, n = tuple(d.shape[:-1]), d.shape[-1]
    for name, t in (("e", e), ("x", x)):
        if t.dtype != d.dtype or t.device != d.device:
            raise TypeError(f"{name} must be {d.dtype} on {d.device}")
    if tuple(e.shape) != lead + (n - 1,):
        raise ValueError(f"e must be {lead + (n - 1,)}, got {tuple(e.shape)}")
    if x.ndim != d.ndim or tuple(x.shape[:-1]) != lead:
        raise ValueError(f"x must be {lead + ('k',)}, got {tuple(x.shape)}")
    if not (d.is_contiguous() and e.is_contiguous() and x.is_contiguous()):
        raise ValueError("minor_det needs contiguous d, e and x")
    if 2 * n * d.element_size() > _MAX_SHARED_BYTES:
        raise ValueError(f"band n={n} does not fit one block's shared memory")


def minor_det(d: torch.Tensor, e: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """Normalized ``|w[i, j]|^2`` rows of the bands ``d (..., n)``, ``e (...,
    n-1)`` at the shifts ``x (..., k)``: ``(..., k, n)``, each row from the
    minor determinants ``det(M_j - x_i I)`` scaled to sum to one."""
    _check(d, e, x)
    if d.device.type == "cpu":
        count("minor_det_plain")
        return minor_det_plain(d, e, x)
    if d.device.type != "cuda":
        raise ValueError(f"minor_det runs on cpu or cuda, not {d.device}")
    n, k = d.shape[-1], x.shape[-1]
    rows = math.prod(d.shape[:-1])
    out = torch.empty(x.shape[:-1] + (k, n), dtype=d.dtype, device=d.device)
    if rows == 0 or k == 0:
        return out
    scratch = torch.empty_like(out)  # the backward sweep's prefix sums
    build.launch(_ENTRY[d.dtype], d.device, d, e, x, out, scratch, rows, n,
                 k, min(k, _LANES_PER_BLOCK), _THREADS)
    if torch.cuda.is_current_stream_capturing():
        # Recorded into a CUDA graph: it launches at each replay, where the
        # graph's owner counts it (``captured``, ``replayed``).
        _captures.n = captured() + 1
    else:
        minor_det.launches += 1
        count("minor_det_kernel")
    return out


minor_det.launches = 0
_captures = threading.local()


def captured() -> int:
    """How many :func:`minor_det` calls this thread has made under CUDA
    graph capture.  Such a call launches nothing: the graph launches the
    kernel at each replay, and the graph's owner counts those launches
    with :func:`replayed`."""
    return getattr(_captures, "n", 0)


def replayed(n: int) -> None:
    """Count ``n`` kernel launches made by one CUDA graph replay."""
    if n:
        minor_det.launches += n
        count("minor_det_kernel", n)
