"""The Eigenvector-Eigenvalue Identity (EEI), all its variants.

For a symmetric ``n x n`` ``A`` with eigenvalues ``lam`` (ascending) and
minors ``M_j`` with eigenvalues ``mu[j, :]``:

    |v[i, j]|^2 * prod_{k != i} (lam[i] - lam[k]) = prod_k (lam[i] - mu[j, k])

The plain PyTorch twin of ``repro.core.identity``: the log-space tables
(sums of ``log|diff|``, immune to over- and underflow), batched over
leading axes, the windowed minor determinants, and the paper's ladder of
single-component variants (Fig. 1(c)/(d)):

    baseline     Algorithm 1: recomputes both spectra for every component.
    cached       spectra once, scalar Python-loop products.
    vectorized   spectra once, tensor products.
    batched      Algorithm 2: paired numerator / denominator terms in
                 batches, per-batch ratios multiplied (no overflow at
                 n >~ 150).
    parallel     Algorithm 2 with the batches' ratios as one batched
                 product (the paper's thread-pool dispatch).
    logspace     sums of ``log|diff|``.

The spectra of ``A`` and of its dense minors (:func:`matrix_spectrum`,
:func:`minor_spectra`) are LAPACK's, as in ``repro``.  Numerator tables are
built in row chunks so the ``(..., i, j, k)`` difference tensor never
exists whole: at ``b = 16, n = 600`` it would be 27.6 GB in float64.
"""

from __future__ import annotations

import torch

from repro_torch.core import minors as minors_lib
from repro_torch.linalg.sturm import _pivmin

#: Elements of one ``(..., i_chunk, j, k)`` difference block.
_CHUNK_ELEMS = 1 << 24


def _row_chunks(lam_rows: torch.Tensor, mu: torch.Tensor, block):
    """``block`` over row chunks of ``lam_rows (..., I)``, joined on ``I``.

    Rows are independent of each other, so chunking only bounds memory.
    """
    chunk = max(1, _CHUNK_ELEMS // max(mu.numel(), 1))
    i_n = lam_rows.shape[-1]
    parts = [block(lam_rows[..., i0:i0 + chunk]) for i0 in range(0, i_n, chunk)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)


def matrix_spectrum(a: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of ``a (..., n, n)``, ascending."""
    return torch.linalg.eigvalsh(a)


def minor_spectra(a: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of every minor ``M_j`` of ``a (..., n, n)``:
    ``(..., n, n-1)``, ascending (one batched ``eigvalsh`` of all minors)."""
    return torch.linalg.eigvalsh(minors_lib.all_minors(a))


def spectral_floor(lam: torch.Tensor) -> torch.Tensor:
    """Per-matrix gap clamp ``eps * (max(|lam_0|, |lam_-1|) + 1e-30)``."""
    scale = torch.maximum(lam[..., -1].abs(), lam[..., 0].abs()) + 1e-30
    return torch.finfo(lam.dtype).eps * scale


def denominator_products(lam: torch.Tensor) -> torch.Tensor:
    """``prod_{k != i} (lam[i] - lam[k])`` for every ``i``, ``(..., n)``."""
    n = lam.shape[-1]
    diff = lam.unsqueeze(-1) - lam.unsqueeze(-2)
    eye = torch.eye(n, dtype=torch.bool, device=lam.device)
    return torch.where(eye, 1.0, diff).prod(dim=-1)


def numerator_products(lam: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """``prod_k (lam[i] - mu[j, k])``: ``lam (..., I)``, ``mu (..., J, K)``
    -> ``(..., I, J)``."""
    def block(rows):
        return (rows[..., :, None, None] - mu.unsqueeze(-3)).prod(dim=-1)

    return _row_chunks(lam, mu, block)


def logabs_denominator(lam: torch.Tensor) -> torch.Tensor:
    """``sum_{k != i} log|lam[i] - lam[k]|``, ``(..., n)``."""
    n = lam.shape[-1]
    diff = lam.unsqueeze(-1) - lam.unsqueeze(-2)
    eye = torch.eye(n, dtype=torch.bool, device=lam.device)
    return torch.log(torch.where(eye, 1.0, diff).abs()).sum(dim=-1)


def logabs_denominator_dot(lam: torch.Tensor) -> torch.Tensor:
    """:func:`logabs_denominator` as a contraction with a ones-vector.

    The diagonal is excluded without a mask: ``lam[i] - lam[i]`` is exactly
    zero, so ``log(diff + tiny)`` adds ``log(tiny)`` there, subtracted per
    row.
    """
    tiny = 1e-30
    log_d = torch.log((lam.unsqueeze(-1) - lam.unsqueeze(-2)).abs() + tiny)
    ones = torch.ones(lam.shape[-1], dtype=lam.dtype, device=lam.device)
    log_tiny = torch.log(torch.full((), tiny, dtype=lam.dtype,
                                    device=lam.device))
    return log_d @ ones - log_tiny


def logabs_numerator(lam: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """``sum_k log|lam[i] - mu[j, k]|``: ``lam (..., I)``, ``mu (..., J, K)``
    -> ``(..., I, J)``."""
    def block(rows):
        diff = rows[..., :, None, None] - mu.unsqueeze(-3)
        return torch.log(diff.abs()).sum(dim=-1)

    return _row_chunks(lam, mu, block)


def logabs_numerator_clamped(lam: torch.Tensor, mu: torch.Tensor,
                             floor: torch.Tensor,
                             mask: torch.Tensor | None = None) -> torch.Tensor:
    """``sum_k log max(|lam[i] - mu[j, k]|, floor)`` with one ``floor`` per
    matrix: ``lam (..., I)``, ``mu (..., J, K)``, ``floor (...)`` ->
    ``(..., I, J)``.  With ``mask (..., J, K)`` (bool) a masked cell adds
    exactly ``log 1 = 0``."""
    fl = floor[..., None, None, None]
    valid = None if mask is None else mask.unsqueeze(-3)

    def block(rows):
        diff = torch.maximum((rows[..., :, None, None] - mu.unsqueeze(-3)).abs(),
                             fl)
        if valid is not None:
            diff = torch.where(valid, diff, 1.0)
        return torch.log(diff).sum(dim=-1)

    return _row_chunks(lam, mu, block)


def logabs_denominator_clamped(lam: torch.Tensor,
                               floor: torch.Tensor) -> torch.Tensor:
    """``sum_{k != i} log max(|lam[i] - lam[k]|, floor)``, ``(..., n)``."""
    n = lam.shape[-1]
    diff = (lam.unsqueeze(-1) - lam.unsqueeze(-2)).abs()
    eye = torch.eye(n, dtype=torch.bool, device=lam.device)
    diff = torch.where(eye, 1.0, torch.maximum(diff, floor[..., None, None]))
    return torch.log(diff).sum(dim=-1)


def logabs_numerator_dot(lam: torch.Tensor, mu: torch.Tensor,
                         floor=0.0) -> torch.Tensor:
    """:func:`logabs_numerator` with the ``k`` reduction written as a
    contraction with a ones-vector, and gaps clamped at ``floor`` (a
    scalar or one value per matrix)."""
    ones = torch.ones(mu.shape[-1], dtype=mu.dtype, device=mu.device)
    if isinstance(floor, torch.Tensor):
        floor = floor[..., None, None, None]

    def block(rows):
        diff = (rows[..., :, None, None] - mu.unsqueeze(-3)).abs()
        if isinstance(floor, torch.Tensor):
            diff = torch.maximum(diff, floor)
        elif floor:
            diff = torch.clamp(diff, min=floor)
        return torch.log(diff) @ ones

    return _row_chunks(lam, mu, block)


def magnitudes_from_spectra(lam: torch.Tensor, mu: torch.Tensor,
                            logspace: bool = True, reduce: str = "sum",
                            rows=None) -> torch.Tensor:
    """All ``|v[i, j]|^2`` from spectra, ``(..., n, n)``.

    ``lam (..., n)`` ascending, ``mu (..., n, n-1)``.  In log space
    (the default) ``reduce="dot"`` takes the ones-contraction forms and
    gaps are clamped at ``eps * spectral scale``; ``logspace=False`` divides
    the plain products (over- and underflows at large ``n``).  ``rows``
    (``(k,)`` eigenvalue indices, shared across the stack) evaluates only
    those rows of the numerator; the floor and the denominator still come
    from the full spectrum and are row-sliced, so the ``(..., k, n)``
    result equals the matching rows of the table.
    """
    if reduce not in ("sum", "dot"):
        raise ValueError(f"unknown reduce {reduce!r}")
    lam_rows = lam if rows is None else lam[..., rows]
    if not logspace:
        den = denominator_products(lam)
        if rows is not None:
            den = den[..., rows]
        return numerator_products(lam_rows, mu) / den.unsqueeze(-1)
    floor = spectral_floor(lam)
    if reduce == "dot":
        log_num = logabs_numerator_dot(lam_rows, mu, floor=floor)
        log_den = logabs_denominator_dot(lam)
    else:
        log_num = logabs_numerator_clamped(lam_rows, mu, floor)
        log_den = logabs_denominator_clamped(lam, floor)
    if rows is not None:
        log_den = log_den[..., rows]
    return torch.exp(log_num - log_den.unsqueeze(-1))


# ---------------------------------------------------------------------------
# Windowed numerators: minor determinants by ratio recurrence
# ---------------------------------------------------------------------------


def tridiag_minor_logdets(d: torch.Tensor, e: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """``log|det(M_j - x_i I)|`` for every minor ``j``: ``(..., k, n)``.

    ``det(M_j - xI) = f_j(x) g_{j+1}(x)`` with ``f`` / ``g`` the leading /
    trailing principal minors of ``T - xI``; both follow the Sturm ratio
    recurrence, so one forward and one backward sweep plus prefix sums of
    ``log|q|`` give every minor at O(n) per shift.  ``d (..., n)``,
    ``e (..., n-1)``, ``x (..., k)``.  ``pivmin`` keeps the ratios finite.
    """
    n = d.shape[-1]
    k = x.shape[-1]
    if n == 1:
        return torch.zeros(x.shape[:-1] + (k, 1), dtype=d.dtype,
                           device=d.device)
    pm = _pivmin(d, e).unsqueeze(-1)

    def clamp(q):
        return torch.where(q.abs() < pm, -pm, q)

    e2 = e * e
    q = clamp(d[..., 0:1] - x)
    qs = [q]  # q_1 .. q_{n-1}
    for idx in range(1, n - 1):
        q = clamp(d[..., idx:idx + 1] - x - e2[..., idx - 1:idx] / q)
        qs.append(q)
    zero = torch.zeros_like(x).unsqueeze(-2)
    # log_f[j] = sum_{l <= j} log|q_l|, j = 0 .. n-1.
    log_f = torch.cat(
        [zero, torch.cumsum(torch.log(torch.stack(qs, -2).abs()), dim=-2)],
        dim=-2)
    p = clamp(d[..., n - 1:n] - x)
    ps = [p]  # p_{n-1} .. p_1
    for idx in range(n - 2, 0, -1):
        p = clamp(d[..., idx:idx + 1] - x - e2[..., idx:idx + 1] / p)
        ps.append(p)
    # log_g[m-1] = sum_{l >= m} log|p_l|, m = 1 .. n (the last one is 0).
    log_p_rev = torch.log(torch.stack(ps, -2).abs())
    log_g = torch.cat(
        [torch.flip(torch.cumsum(log_p_rev, dim=-2), dims=(-2,)), zero],
        dim=-2)
    # log|det(M_j - xI)| = log_f[j] + log_g[j], j = 0 .. n-1.
    return (log_f + log_g).transpose(-1, -2)


def tridiag_windowed_magnitudes(d: torch.Tensor, e: torch.Tensor,
                                lam_sel: torch.Tensor) -> torch.Tensor:
    """Normalized ``|w[i, j]|^2`` rows for selected eigenvalues, ``(..., k, n)``.

    The Cauchy denominator is constant in ``j`` and equals the row sum of
    the numerators (rows are unit vectors), so normalizing each row by its
    own sum is the identity, with no other eigenvalue needed.
    """
    log_num = tridiag_minor_logdets(d, e, lam_sel)
    log_num = log_num - log_num.amax(dim=-1, keepdim=True)
    w = torch.exp(log_num)
    return w / w.sum(dim=-1, keepdim=True)


# Batch axes are written out, so the batched name is the same function.
tridiag_windowed_magnitudes_batched = tridiag_windowed_magnitudes


# ---------------------------------------------------------------------------
# The paper's ladder: one component |v[i, j]|^2 per call
# ---------------------------------------------------------------------------


def component_baseline(a: torch.Tensor, i: int, j: int) -> torch.Tensor:
    """Algorithm 1 of the paper: both spectra recomputed per call, scalar
    Python loops.  Deliberately naive: the baseline of the ladder."""
    n = a.shape[-1]
    lam = torch.linalg.eigvalsh(a)
    mu = torch.linalg.eigvalsh(minors_lib.minor(a, j))
    numerator = torch.ones((), dtype=a.dtype, device=a.device)
    for k in range(n - 1):
        numerator = numerator * (lam[i] - mu[k])
    denominator = torch.ones((), dtype=a.dtype, device=a.device)
    for k in range(n):
        if k != i:
            denominator = denominator * (lam[i] - lam[k])
    return numerator / denominator


def component_cached(lam: torch.Tensor, mu_j: torch.Tensor,
                     i: int) -> torch.Tensor:
    """Spectra precomputed, Python-loop products (the paper's first
    improvement)."""
    n = lam.shape[-1]
    numerator = torch.ones((), dtype=lam.dtype, device=lam.device)
    for k in range(n - 1):
        numerator = numerator * (lam[i] - mu_j[k])
    denominator = torch.ones((), dtype=lam.dtype, device=lam.device)
    for k in range(n):
        if k != i:
            denominator = denominator * (lam[i] - lam[k])
    return numerator / denominator


def component_vectorized(lam: torch.Tensor, mu_j: torch.Tensor,
                         i: int) -> torch.Tensor:
    """Tensor products over ``k`` (the paper's vectorized variant).
    ``mu_j (..., n-1)``: leading axes give one component each."""
    n = lam.shape[-1]
    numer = (lam[i] - mu_j).prod(dim=-1)
    keep = torch.arange(n, device=lam.device) == i
    return numer / torch.where(keep, 1.0, lam[i] - lam).prod()


def _paired_terms(lam: torch.Tensor, mu_j: torch.Tensor, i: int):
    """The ``n-1`` paired numerator and denominator terms of Algorithm 2:
    its line 6 deletes ``lam[i]`` from the spectrum so that both products
    have ``n-1`` terms."""
    lam_wo_i = minors_lib.delete_index(lam, i)
    return lam[i] - mu_j, lam[i] - lam_wo_i


def _batch_products(lam, mu_j, i, batch_size: int):
    """Per-batch products ``(nb,)`` of the paired numerator and denominator
    terms, padded with 1.0 to ``nb * batch_size``: one product over the
    ``(nb, batch_size)`` view of each."""
    numer_terms, denom_terms = _paired_terms(lam, mu_j, i)
    pad = (-numer_terms.shape[-1]) % batch_size
    ones = torch.ones(pad, dtype=lam.dtype, device=lam.device)
    numer_terms = torch.cat([numer_terms, ones])
    denom_terms = torch.cat([denom_terms, ones])
    nb = numer_terms.shape[-1] // batch_size
    return (numer_terms.view(nb, batch_size).prod(dim=-1),
            denom_terms.view(nb, batch_size).prod(dim=-1))


def component_batched(lam: torch.Tensor, mu_j: torch.Tensor, i: int,
                      batch_size: int = 64) -> torch.Tensor:
    """Algorithm 2: per-batch partial ratios, multiplied.

    Pairing each numerator term with a denominator term keeps every partial
    ratio O(1) in magnitude (interlacing makes paired terms comparable),
    which fixes the paper's overflow at ``n >~ 150``.
    """
    num_b, den_b = _batch_products(lam, mu_j, i, batch_size)
    return (num_b / den_b).prod()


def component_parallel(lam: torch.Tensor, mu_j: torch.Tensor, i: int,
                       batch_size: int = 64) -> torch.Tensor:
    """Algorithm 2 with the batch dispatch as one batched product over the
    ``(nb, batch_size)`` view: each row is one dispatched batch (the paper's
    thread pool; ``repro``'s ``vmap`` lanes).  The same arithmetic as
    :func:`component_batched`, as in ``repro``."""
    num_b, den_b = _batch_products(lam, mu_j, i, batch_size)
    ratios = num_b / den_b
    return ratios.prod()


def component_logspace(lam: torch.Tensor, mu_j: torch.Tensor, i: int,
                       eps: float | None = None) -> torch.Tensor:
    """Log-domain EEI, immune to over- and underflow at any ``n``.

    Cauchy interlacing makes the sign non-negative, so only ``log|diff|``
    is needed.  Degenerate gaps are clamped at ``eps * scale``.
    ``mu_j (..., n-1)``: leading axes give one component each.
    """
    n = lam.shape[-1]
    scale = torch.maximum(lam[-1].abs(), lam[0].abs()) + 1e-30
    if eps is None:
        eps = torch.finfo(lam.dtype).eps
    floor = eps * scale
    numer = torch.log(torch.maximum((lam[i] - mu_j).abs(), floor)).sum(dim=-1)
    keep = torch.arange(n, device=lam.device) == i
    denom = torch.log(torch.where(
        keep, 1.0, torch.maximum((lam[i] - lam).abs(), floor))).sum()
    return torch.exp(numer - denom)


def eigenvector_magnitudes(a: torch.Tensor, i: int,
                           logspace: bool = True) -> torch.Tensor:
    """``|v[i, :]|^2``: one eigenvector's component magnitudes, ``(n,)``."""
    lam = matrix_spectrum(a)
    mu = minor_spectra(a)
    fn = component_logspace if logspace else component_vectorized
    return fn(lam, mu, i)


def eigenmatrix_magnitudes(a: torch.Tensor,
                           logspace: bool = True) -> torch.Tensor:
    """``|v[i, j]|^2`` for all ``(i, j)``, rows are eigenvectors."""
    return magnitudes_from_spectra(matrix_spectrum(a), minor_spectra(a),
                                   logspace=logspace)


def component(a: torch.Tensor, i: int, j: int, variant: str = "logspace",
              batch_size: int = 64) -> torch.Tensor:
    """One component ``|v[i, j]|^2`` of ``a (n, n)`` by a named variant."""
    if variant == "baseline":
        return component_baseline(a, i, j)
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    lam = matrix_spectrum(a)
    mu_j = torch.linalg.eigvalsh(minors_lib.minor(a, j))
    if variant in ("batched", "parallel"):
        return VARIANTS[variant](lam, mu_j, i, batch_size)
    return VARIANTS[variant](lam, mu_j, i)


VARIANTS = {
    "baseline": component_baseline,
    "cached": component_cached,
    "vectorized": component_vectorized,
    "batched": component_batched,
    "parallel": component_parallel,
    "logspace": component_logspace,
}


def component_jit(a: torch.Tensor, i: int, j: int, variant: str = "logspace",
                  batch_size: int = 64) -> torch.Tensor:
    """``repro``'s jitted single-component entry point, under its name.

    PyTorch runs eagerly and the port builds no per-shape program, so this
    is :func:`component`, every variant included.
    """
    return component(a, i, j, variant=variant, batch_size=batch_size)
