"""Paper-faithful NumPy implementations (the reproduction baseline).

The paper benchmarks pure-NumPy/CPython code against ``numpy.linalg.eigh``
(LAPACK).  These functions mirror the paper's Algorithm 1 (baseline) and
Algorithm 2 (batched + thread-dispatched) exactly, including the
thread-pool dispatch whose Amdahl-limited behaviour the paper reports.

A copy of ``repro.core.numpy_ref``, so that the port imports nothing of
``repro``: the paper's comparison on the host, and independent oracles for
the PyTorch ladder (``core.identity``).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np


def eigen_component_baseline(matrix: np.ndarray, i: int, j: int) -> float:
    """Algorithm 1 — recompute everything per call, scalar loops."""
    n = matrix.shape[0]
    minor = np.delete(np.delete(matrix, j, axis=0), j, axis=1)
    matrix_ev = np.linalg.eigvalsh(matrix)
    minor_ev = np.linalg.eigvalsh(minor)
    numerator = 1.0
    for k in range(n - 1):
        numerator *= matrix_ev[i] - minor_ev[k]
    denominator = 1.0
    for k in range(n):
        if k != i:
            denominator *= matrix_ev[i] - matrix_ev[k]
    return numerator / denominator


def eigen_component_cached(
    matrix_ev: np.ndarray, minor_ev: np.ndarray, i: int
) -> float:
    """Spectra cached, scalar loops."""
    n = matrix_ev.shape[0]
    numerator = 1.0
    for k in range(n - 1):
        numerator *= matrix_ev[i] - minor_ev[k]
    denominator = 1.0
    for k in range(n):
        if k != i:
            denominator *= matrix_ev[i] - matrix_ev[k]
    return numerator / denominator


def eigen_component_vectorized(
    matrix_ev: np.ndarray, minor_ev: np.ndarray, i: int
) -> float:
    """Vectorized products."""
    numer = np.prod(matrix_ev[i] - minor_ev)
    denom_terms = np.delete(matrix_ev[i] - matrix_ev, i)
    return numer / np.prod(denom_terms)


def _batch_ratio(args) -> float:
    numer_terms, denom_terms = args
    return np.prod(numer_terms) / np.prod(denom_terms)


def eigen_component_optimized(
    matrix: np.ndarray,
    i: int,
    j: int,
    batch_size: int = 64,
    executor: ThreadPoolExecutor | None = None,
) -> float:
    """Algorithm 2 — batched paired ratios, optionally thread-dispatched.

    ``PrepareBatches``: the matrix spectrum with ``lam[i]`` removed is paired
    term-by-term against the minor spectrum; batches of paired terms produce
    bounded partial ratios (the paper's overflow fix), which are then joined.
    """
    minor = np.delete(np.delete(matrix, j, axis=0), j, axis=1)
    matrix_ev = np.linalg.eigvalsh(matrix)
    eigen_value = matrix_ev[i]
    matrix_ev_wo = np.delete(matrix_ev, i)
    minor_ev = np.linalg.eigvalsh(minor)

    numer_terms = eigen_value - minor_ev
    denom_terms = eigen_value - matrix_ev_wo
    batches = [
        (numer_terms[k : k + batch_size], denom_terms[k : k + batch_size])
        for k in range(0, numer_terms.shape[0], batch_size)
    ]
    if executor is not None:  # the paper's parallel dispatch (Fig 1, "parallelized")
        ratios = list(executor.map(_batch_ratio, batches))
    else:
        ratios = [_batch_ratio(b) for b in batches]
    component = 1.0
    for r in ratios:
        component *= r
    return component


def eigenvector_magnitudes(matrix: np.ndarray, i: int) -> np.ndarray:
    """|v[i, :]|^2 via Algorithm 2 applied per component."""
    n = matrix.shape[0]
    return np.array([eigen_component_optimized(matrix, i, j) for j in range(n)])


def numpy_full_eigh(matrix: np.ndarray):
    """The state-of-the-art the paper compares against (always full set)."""
    return np.linalg.eigh(matrix)
