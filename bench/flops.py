"""Operations and bytes of the EEI work, from shapes and frozen counts only.

The counts read the same work whatever implements it: they never read the
program's counters, its plan or its iteration counts.  ``levels`` is
``roofline.LEVELS[precision]`` and ``m`` the Krylov band a cell's traffic
file freezes.
"""

from bench.roofline import PROD_DIFF_OPS_PER_TERM, STURM_OPS_PER_STEP


def sturm_ops(rows: int, band: int, lanes: int, levels: int) -> int:
    """``lanes`` eigenvalues of each of ``rows`` bands of length ``band``,
    each bisected ``levels`` times over a ``band``-step recurrence."""
    return rows * lanes * levels * band * STURM_OPS_PER_STEP


def sturm_bytes(rows: int, band: int, lanes: int, elsize: int) -> int:
    """The bands' diagonals and off-diagonals read once, the eigenvalues
    written once."""
    return rows * (band + (band - 1) + lanes) * elsize


def prod_diff_ops(b: int, i: int, j: int, k: int) -> int:
    """``out[b, i, j] = sum_k log|lam[b, i] - mu[b, j, k]|``."""
    return b * i * j * k * PROD_DIFF_OPS_PER_TERM


def prod_diff_bytes(b: int, i: int, j: int, k: int, elsize: int) -> int:
    """``lam (b, i)`` and ``mu (b, j, k)`` read once, ``out (b, i, j)``
    written once."""
    return b * (i + j * k + i * j) * elsize


def solve(n: int, levels: int) -> float:
    """One matrix's ``solve``: the reduce and its ``Q`` (8/3 n^3), the
    spectrum, the ``n`` minor spectra, the prod-diff table and the
    back-transform (2 n^3)."""
    return (8 * n ** 3 / 3
            + sturm_ops(1, n, n, levels)
            + sturm_ops(n, n - 1, n - 1, levels)
            + prod_diff_ops(1, n, n, n - 1)
            + 2 * n ** 3)


def topk(n: int, k: int, m: int, levels: int) -> float:
    """One matrix's top-k through an ``m``-step Krylov band: a matvec
    (2 n^2) and two projections against the basis (8 n m) a step, the
    k-window of the band, and the back-transform (2 n m k)."""
    return (m * (2 * n * n + 8 * n * m)
            + sturm_ops(1, m, k, levels)
            + 2 * n * m * k)
