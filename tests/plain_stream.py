"""A plain reference of a session's sliding-window rank-1 stream.

Plain PyTorch in float64: it imports neither JAX nor any module of the
port, and takes nothing the port made.  The stream's schedule, its samples
and the matrix after a step come from ``bench/stream.py``, which the
benchmark's ``update`` op drives a session with: the first ``window``
samples enter (``+x x^T``), then the oldest leaves (``-x x^T``, exactly a
term that entered) and the next one enters, in turn.  After each step the
reference rebuilds the matrix as ``A_0 + sum over the window of x x^T``
and answers its top-k window from ``torch.linalg.eigh``.
"""

import sys
from pathlib import Path

import torch

_ROOT = str(Path(__file__).resolve().parents[1])
if _ROOT not in sys.path:
    sys.path.append(_ROOT)

from bench.stream import matrix_after, samples, step, window_after  # noqa: E402

__all__ = ["matrix_after", "samples", "step", "topk", "window_after"]


def topk(a: torch.Tensor, k: int, largest: bool = True) -> tuple:
    """The ``k`` extremal eigenvalues ``(k,)`` ascending and their unit
    eigenvectors ``(k, n)`` (a row each), by float64 ``eigh``; TF32 is off
    for the call, as a float32 product on a card could otherwise use it."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        lam, v = torch.linalg.eigh(a.to(torch.float64))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was
    sel = slice(-k, None) if largest else slice(0, k)
    return lam[sel], v[:, sel].T

