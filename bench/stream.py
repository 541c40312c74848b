"""A session's sliding-window rank-1 stream, in plain PyTorch.

A stream over a bank of samples ``x_i`` first brings ``window`` samples in
(``+x x^T``), then alternates: the oldest sample leaves (``-x x^T``,
exactly a term that entered), the next one enters.  A sample is ``x = A_0 g
/ ||A_0 g|| * sqrt(rho)`` with ``g`` standard normal and ``rho =
rho_per_fro * ||A_0||_F``, so the samples lean toward ``A_0``'s leading
directions, as a covariance's do.

The ``update`` op (``bench/ops/update.py``) drives a session with it, and
the plain references (the op's and ``tests/plain_stream.py``) rebuild the
matrix from it.  It imports neither JAX nor any module of the port.
"""

import torch


def step(s: int, window: int) -> tuple:
    """``(sample, sign)`` of step ``s`` of the stream."""
    if s < window:
        return s, 1
    j = s - window
    return (j // 2, -1) if j % 2 == 0 else (window + j // 2, 1)


def window_after(s: int, window: int) -> range:
    """The samples in the window after step ``s``."""
    if s < window:
        return range(s + 1)
    j = s - window
    return range(j // 2 + 1, window + (j + 1) // 2)


def samples(a0: torch.Tensor, g: torch.Tensor,
            rho_per_fro: float) -> torch.Tensor:
    """The samples ``(rows, n)`` of the normal draws ``g (rows, n)``:
    ``A_0 g / ||A_0 g|| * sqrt(rho)`` a row, ``rho = rho_per_fro *
    ||A_0||_F``, in float64."""
    a0 = a0.to(torch.float64)
    y = g.to(torch.float64) @ a0  # A_0 is symmetric: each row is A_0 g
    rho = rho_per_fro * torch.linalg.matrix_norm(a0)
    return y * (torch.sqrt(rho)
                / torch.linalg.vector_norm(y, dim=-1, keepdim=True))


def matrix_after(a0: torch.Tensor, bank: torch.Tensor, s: int,
                 window: int) -> torch.Tensor:
    """``A_0 + sum_{i in window} x_i x_i^T`` after step ``s``, in float64;
    the bank is cycled."""
    rows = [i % len(bank) for i in window_after(s, window)]
    x = bank[rows].to(torch.float64)
    return a0.to(torch.float64) + x.T @ x
