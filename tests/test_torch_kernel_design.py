"""The arithmetic of the two CUDA kernel designs, modelled in numpy.

The kernels of ``src/repro_torch/kernels/csrc`` run only on the card, so
each test here runs a numpy model of a kernel's algorithm, step for step,
and holds it against the port's plain version and against ``repro``:

* ``csrc/sturm.cu``: the bisection tree (every distinct bracket evaluated
  once, up to three levels a round where the block has threads to spare,
  the lanes of a row split over blocks of ``cap`` lanes) with its exit at
  the fixed point, and the integer test on the bit patterns for ``q < 0``.
  It must be bitwise ``bisect_lanes`` and ``repro``'s Sturm reference, on
  bands with repeated eigenvalues, zero off-diagonals, ``n = 1``,
  Wilkinson-type clusters, windows and scales from 1e-30 up.
* ``csrc/prod_diff.cu``: the exponent-split product (one log per cell),
  within the kernels' tolerances of ``logabs_numerator_clamped`` at extreme
  scales, and masked trailing terms leaving it bitwise unchanged.
"""

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from hypothesis_compat import given, settings, st  # noqa: E402
from test_torch_parity import TOL  # noqa: E402

from repro.linalg import sturm as r_sturm  # noqa: E402
from repro_torch.core.identity import (  # noqa: E402
    logabs_numerator_clamped, spectral_floor)
from repro_torch.kernels.sturm.kernel import _geometry  # noqa: E402
from repro_torch.linalg.sturm import (  # noqa: E402
    _pivmin, bisect_lanes, bisect_lanes_segmented, default_iters,
    gershgorin_bounds)

DTYPES = (np.float64, np.float32)
_UINT = {np.float64: np.uint64, np.float32: np.uint32}


# -- a numpy model of csrc/sturm.cu ---------------------------------------------


def _bits(x):
    x = np.asarray(x)
    return x.view(_UINT[x.dtype.type])


def _negative(q):
    """The kernel's ``q < 0``: a signed compare of the bits with -inf's (on
    the high word in float64)."""
    if q.dtype == np.float32:
        return q.view(np.int32) <= np.int32(-(1 << 23))   # 0xff800000
    hi = (q.view(np.int64) >> 32).astype(np.int32)
    return hi <= np.int32(-(1 << 20))                     # 0xfff00000


def _count(d, e2, x, pivmin):
    """Sturm counts at the shifts ``x``, with the kernel's sign test."""
    def clamp(q):
        return np.where(np.abs(q) < pivmin, -pivmin, q)

    q = clamp(d[0] - x)
    count = _negative(q).astype(np.int64)
    for k in range(1, d.shape[0]):
        q = clamp((d[k] - x) - e2[k - 1] / q)
        count += _negative(q)
    return count


def _fixed(lo, hi, mid):
    same = lambda a, b: _bits(a) == _bits(b)  # noqa: E731
    half = mid.dtype.type(0.5)
    return bool((same(mid, lo) or same(mid, hi))
                and same(half * (mid + mid), mid))


def tree_row(d, e, lo0, hi0, pivmin, target_base, m, n_iter, threads, cap):
    """``csrc/sturm.cu`` on one band, with blocks of ``cap`` lanes and
    ``threads`` threads: returns the ``m`` outputs and the number of counts
    the blocks evaluated."""
    dt = d.dtype.type
    half = dt(0.5)
    e2 = e * e
    out = np.full(m, np.nan, dt)
    evaluated = 0
    for lane0 in range(0, m, cap):                       # one block each
        brackets = [(dt(lo0), dt(hi0), lane0, min(m, lane0 + cap) - 1)]
        it = 0
        while brackets and it < n_iter:
            depth = 1   # as many levels as one evaluation a thread allows
            while (depth < 3 and depth < n_iter - it
                   and len(brackets) * ((2 << depth) - 1) <= threads):
                depth += 1
            nodes = (1 << depth) - 1
            mids = []
            for lo, hi, _, _ in brackets:                # node v: heap order
                for v in range(nodes):
                    path, a, b = v + 1, lo, hi
                    mid = half * (a + b)
                    for s in range(path.bit_length() - 2, -1, -1):
                        a, b = (mid, b) if (path >> s) & 1 else (a, mid)
                        mid = half * (a + b)
                    mids.append(mid)
            cnt = _count(d, e2, np.array(mids, dt), pivmin)
            evaluated += len(mids)
            leaves = []
            for i, (lo, hi, first, last) in enumerate(brackets):
                level = [(lo, hi, first, last, 0)]
                for _ in range(depth):
                    kids = []
                    for lo_, hi_, f, l_, v in level:
                        mid = half * (lo_ + hi_)
                        c = int(cnt[i * nodes + v]) - target_base
                        lf, ll, rf, rl = f, min(l_, c - 1), max(f, c), l_
                        if _fixed(lo_, hi_, mid):
                            out[lf:ll + 1] = half * (lo_ + mid)
                            out[rf:rl + 1] = half * (mid + hi_)
                            continue
                        if lf <= ll:
                            kids.append((lo_, mid, lf, ll, 2 * v + 1))
                        if rf <= rl:
                            kids.append((mid, hi_, rf, rl, 2 * v + 2))
                    level = kids
                leaves += [k[:4] for k in level]
            brackets = leaves
            it += depth
        for lo, hi, first, last in brackets:
            out[first:last + 1] = half * (lo + hi)
    return out, evaluated


def tree_bisect(d, e, bounds, target_base, m, n_iter, threads, cap):
    """The model over rows: ``(rows, m)`` and the counts evaluated."""
    rows = [tree_row(d[r], e[r], *bounds[r], target_base, m, n_iter, threads,
                     cap) for r in range(d.shape[0])]
    return np.stack([r[0] for r in rows]), sum(r[1] for r in rows)


def _bounds(d, e):
    dt, et = torch.as_tensor(d), torch.as_tensor(e)
    lo, hi = gershgorin_bounds(dt, et)
    return np.stack([lo.numpy(), hi.numpy(), _pivmin(dt, et).numpy()], -1)


def _plain(d, e, bounds, target_base, m, n_iter):
    b = torch.as_tensor(bounds)
    return bisect_lanes(torch.as_tensor(d), torch.as_tensor(e), b[:, 0],
                        b[:, 1], b[:, 2], target_base, m, n_iter).numpy()


def _same_bits(a, b):
    return a.shape == b.shape and np.array_equal(_bits(a), _bits(b))


def _band(kind, n, rows, dtype, scale, seed):
    """Bands of one structure: ``random``, ``repeated`` (copies of one block,
    so every eigenvalue repeats), ``zero_e`` (e = 0, repeated diagonal
    entries), ``wilkinson`` (W+: close pairs) or ``graded``."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        d = rng.standard_normal((rows, n))
        e = rng.standard_normal((rows, n - 1))
    elif kind == "repeated":
        w = max(1, n // 3)
        blk_d = rng.standard_normal((rows, w))
        blk_e = np.concatenate([rng.standard_normal((rows, w - 1)),
                                np.zeros((rows, 1))], -1)
        d = np.tile(blk_d, (1, -(-n // w)))[:, :n]
        e = np.tile(blk_e, (1, -(-n // w)))[:, :n - 1]
    elif kind == "zero_e":
        d = rng.integers(-2, 3, (rows, n)).astype(float)
        e = np.zeros((rows, n - 1))
    elif kind == "wilkinson":
        d = np.abs(np.arange(n) - (n - 1) / 2)[None].repeat(rows, 0)
        e = np.ones((rows, n - 1))
    else:  # graded: entries over many magnitudes
        d = rng.standard_normal((rows, n)) * 10.0 ** rng.uniform(-8, 8, (rows, n))
        e = rng.standard_normal((rows, n - 1)) * 10.0 ** rng.uniform(-8, 0, (rows, n - 1))
    return (d * scale).astype(dtype), (e * scale).astype(dtype)


# Scales from 1e-30 up.  The top is 1e30 in float64; in float32 it is 1e15,
# because past ~1e19 e^2 (and eps^2 scale^2 in pivmin) overflow float32 and
# every implementation's count turns into NaNs.
_SCALE_EXP = {np.float64: (-30, 30), np.float32: (-30, 15)}
_KINDS = ("random", "repeated", "zero_e", "wilkinson", "graded")


@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
@settings(max_examples=60, deadline=None)
@given(kind=st.sampled_from(_KINDS), n=st.sampled_from([1, 2, 5, 9, 16]),
       scale_exp=st.integers(-30, 30), window=st.integers(0, 3),
       threads=st.sampled_from([32, 64, 256, 640]),
       cap=st.sampled_from([1, 3, 8, 64]), seed=st.integers(0, 2 ** 16))
def test_sturm_tree_is_bitwise_the_plain_bisection(dtype, kind, n, scale_exp,
                                                   window, threads, cap, seed):
    lo_e, hi_e = _SCALE_EXP[dtype]
    scale = 10.0 ** min(max(scale_exp, lo_e), hi_e)
    d, e = _band(kind, n, 2, dtype, scale, seed)
    bounds = _bounds(d, e)
    n_iter = default_iters(torch.float64 if dtype == np.float64
                           else torch.float32)
    # window 0: the full spectrum; else a window of k lanes at either end.
    k = n if window == 0 else min(n, window + 1)
    target_base = 0 if window % 2 else n - k
    got, _ = tree_bisect(d, e, bounds, target_base, k, n_iter, threads, cap)
    plain = _plain(d, e, bounds, target_base, k, n_iter)
    assert _same_bits(got, plain)
    # repro's Sturm reference, through its full spectrum (its window is
    # bitwise the slice of it): bitwise where the band's arithmetic stays in
    # the normal range, since XLA on the CPU flushes subnormal results to
    # zero and the port (on the CPU and on the card) does not; below it,
    # repro's own Sturm tolerance.
    ref = np.asarray(r_sturm.bisect_eigenvalues_batched(
        jnp.asarray(d), jnp.asarray(e)))[:, target_base:target_base + k]
    if _normal_range(d, e, scale):
        assert _same_bits(got, ref)
    else:
        name = "float64" if dtype == np.float64 else "float32"
        np.testing.assert_allclose(got, ref, *TOL["sturm"][name])


def _normal_range(d, e, scale):
    """No subnormal number can arise in the recurrence: ``e^2`` is normal
    (or 0) and the band's scale is far above the subnormal range."""
    finfo = np.finfo(d.dtype)
    e2 = e.astype(np.float64) ** 2
    return (bool(np.all((e2 == 0) | (e2 >= finfo.tiny)))
            and scale >= finfo.tiny ** 0.25)


def test_repro_flushes_subnormals_the_port_does_not():
    """The one place where the port and repro differ: a float32 band whose
    e^2 is subnormal.  XLA on the CPU flushes it to zero, so repro counts
    as if e were 0; the port keeps IEEE subnormals, as the card does, and
    its plain version, the kernel's model and the IEEE count agree."""
    d, e = _band("random", 2, 2, np.float32, 1e-19, 0)
    assert np.any((e.astype(np.float64) ** 2 < np.finfo(np.float32).tiny))
    bounds = _bounds(d, e)
    got, _ = tree_bisect(d, e, bounds, 0, 2, 32, 32, 2)
    plain = _plain(d, e, bounds, 0, 2, 32)
    ref = np.asarray(r_sturm.bisect_eigenvalues_batched(jnp.asarray(d),
                                                        jnp.asarray(e)))
    assert _same_bits(got, plain)
    assert not _same_bits(plain, ref)
    np.testing.assert_allclose(plain, ref, *TOL["sturm"]["float32"])


@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
@pytest.mark.parametrize("threads", [32, 640])
def test_sturm_tree_on_extreme_and_degenerate_bands(dtype, threads):
    """The same, over fixed cases: every structure at both scale ends, and a
    band of equal eigenvalues, whose one bracket never splits."""
    n_iter = 64 if dtype == np.float64 else 32
    lo_e, hi_e = _SCALE_EXP[dtype]
    cases = [_band(kind, 12, 1, dtype, 10.0 ** s, 7)
             for kind in _KINDS for s in (lo_e, hi_e)]
    cases.append((np.full((1, 10), 3.0, dtype), np.zeros((1, 9), dtype)))
    cases.append((np.full((1, 1), -2.5, dtype), np.zeros((1, 0), dtype)))
    for d, e in cases:
        bounds = _bounds(d, e)
        n = d.shape[1]
        got, _ = tree_bisect(d, e, bounds, 0, n, n_iter, threads, 4)
        assert _same_bits(got, _plain(d, e, bounds, 0, n, n_iter))


@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
def test_sturm_tree_evaluates_fewer_counts_than_the_lanes(dtype):
    """The tree shares the first levels and stops at the fixed point: on a
    random band it evaluates clearly fewer counts than ``m * n_iter``, the
    plain version's; the threads a block spares for speculation evaluate
    more, in fewer rounds."""
    n = 40
    d, e = _band("random", n, 1, dtype, 1.0, 3)
    bounds = _bounds(d, e)
    n_iter = 64 if dtype == np.float64 else 32
    _, lean = tree_bisect(d, e, bounds, 0, n, n_iter, 1, n)
    _, wide = tree_bisect(d, e, bounds, 0, n, n_iter, 7 * n, n)
    assert lean < 0.9 * n * n_iter
    assert wide > lean


def test_geometry_fills_the_card_and_fits_shared_memory():
    """The wrapper's launch geometry: one block per row and a thread per
    lane for a large stack, split lanes and threads for three levels a
    round for a small one; the shared memory of a block always fits."""
    sms = 132
    assert _geometry(9600, 599, 599, 8, sms) == (599, 608)
    cap, threads = _geometry(16, 600, 600, 8, sms)
    assert -(-600 // cap) * 16 >= 2 * sms
    assert threads % 32 == 0 and threads >= cap * 7
    assert _geometry(16, 600, 8, 8, sms) == (8, 64)
    cap, threads = _geometry(1, 10_000, 10_000, 8, sms)
    assert cap < 10_000 and 32 <= threads <= 640
    with pytest.raises(ValueError, match="shared memory"):
        _geometry(1, 20_000, 1, 8, sms)


# -- a numpy model of csrc/prod_diff.cu --------------------------------------------

_CHUNK = 32
_FIELD = {np.float64: (52, 0x7FF, 1023), np.float32: (23, 0xFF, 127)}


def _split(x):
    """Significand in [1, 2) and biased exponent field of positive normals."""
    dt = x.dtype.type
    shift, emask, bias = _FIELD[dt]
    u = x.view(_UINT[dt])
    field = ((u >> shift) & emask).astype(np.int64)
    frac = u & _UINT[dt]((1 << shift) - 1)
    return (frac | _UINT[dt](bias << shift)).view(dt), field


def split_logsum(lam, mu, floor, mask=None):
    """``csrc/prod_diff.cu`` on one matrix: ``lam (I,)``, ``mu (J, K)``,
    ``mask (J, K)`` or None -> ``(I, J)``."""
    dt = lam.dtype.type
    _, _, bias = _FIELD[dt]
    k_n = mu.shape[1]
    p = np.ones((lam.shape[0], mu.shape[0]), dt)
    ex = np.zeros(p.shape, np.int64)
    chunks = 0
    for k0 in range(0, k_n, _CHUNK):
        for k in range(k0, min(k_n, k0 + _CHUNK)):
            x = np.maximum(np.abs(lam[:, None] - mu[None, :, k]), floor)
            if mask is not None:
                x = np.where(mask[None, :, k], x, dt(1))
            m, f = _split(x)
            p = p * m
            ex += f
        p, f = _split(p)
        ex += f
        chunks += 1
    e = (ex - bias * (k_n + chunks)).astype(np.float64)
    return (np.log(p.astype(np.float64)) + e * np.log(2.0)).astype(dt), p, ex


def _spectra(rng, i_n, j_n, k_n, dtype, top):
    """Eigenvalue-like values with random signs over magnitudes from 1e-30
    to 10^top, and close pairs, so the terms run from the floor to ~10^top."""
    def draw(shape):
        mag = 10.0 ** rng.uniform(-30, top, shape)
        return (np.sign(rng.standard_normal(shape)) * mag)

    lam = np.sort(draw(i_n))
    mu = draw((j_n, k_n))
    mu[:, :3] = lam[:3]                      # exact coincidences: the floor
    mu[:, 3:6] = lam[:3] * (1 + 1e-12)       # near-coincidences
    return lam.astype(dtype), mu.astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
@pytest.mark.parametrize("top", [0, 30, 300])
def test_split_product_matches_the_sum_of_logs(dtype, top):
    """Within the kernel's tolerances of ``logabs_numerator_clamped`` on
    terms from the floor to 10^top (10^30 at most in float32), with K past
    several re-splits."""
    if dtype == np.float32 and top > 30:
        top = 30
    name = "float64" if dtype == np.float64 else "float32"
    rng = np.random.default_rng(top)
    lam, mu = _spectra(rng, 9, 7, 75, dtype, top)
    floor = spectral_floor(torch.as_tensor(lam)).numpy()
    got, p, _ = split_logsum(lam, mu, floor)
    assert np.all((p >= 1) & (p < 2))
    ref = logabs_numerator_clamped(torch.as_tensor(lam), torch.as_tensor(mu),
                                   torch.as_tensor(floor)).numpy()
    rtol, atol = TOL["prod_diff"][name]
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)
    # A floor far below the terms, and terms all at the floor.
    tiny = np.asarray(np.finfo(dtype).tiny * 4, dtype)
    got, _, _ = split_logsum(lam, mu, tiny)
    ref = logabs_numerator_clamped(torch.as_tensor(lam), torch.as_tensor(mu),
                                   torch.as_tensor(tiny)).numpy()
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)
    flat = np.zeros_like(mu) + lam[0]
    got, _, _ = split_logsum(lam[:1], flat, floor)
    np.testing.assert_allclose(got, 75 * np.log(floor.astype(np.float64)),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
@pytest.mark.parametrize("k_valid", [1, 31, 32, 33, 64, 70])
def test_masked_trailing_terms_leave_the_product_bitwise(dtype, k_valid):
    """A mask that keeps the first ``k_valid`` terms gives bitwise the
    product, exponent and sum of the unmasked model over those terms."""
    rng = np.random.default_rng(k_valid)
    lam, mu = _spectra(rng, 5, 4, 70, dtype, 20)
    floor = spectral_floor(torch.as_tensor(lam)).numpy()
    mask = np.zeros(mu.shape, bool)
    mask[:, :k_valid] = True
    got, p, ex = split_logsum(lam, mu, floor, mask=mask)
    ref, p_ref, ex_ref = split_logsum(lam, mu[:, :k_valid].copy(), floor)
    _, _, bias = _FIELD[dtype]
    extra = (70 - k_valid) + (-(-70 // _CHUNK) - -(-k_valid // _CHUNK))
    assert _same_bits(p, p_ref)
    assert np.array_equal(ex - bias * extra, ex_ref)
    assert _same_bits(got, ref)


@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
def test_split_product_with_a_random_mask_matches_the_masked_sum(dtype):
    name = "float64" if dtype == np.float64 else "float32"
    rng = np.random.default_rng(4)
    lam, mu = _spectra(rng, 6, 5, 50, dtype, 10)
    mask = rng.random(mu.shape) > 0.3
    floor = spectral_floor(torch.as_tensor(lam)).numpy()
    got, _, _ = split_logsum(lam, mu, floor, mask=mask)
    ref = logabs_numerator_clamped(torch.as_tensor(lam), torch.as_tensor(mu),
                                   torch.as_tensor(floor),
                                   mask=torch.as_tensor(mask)).numpy()
    rtol, atol = TOL["prod_diff"][name]
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


# -- a numpy model of csrc/sturm_segmented.cu ---------------------------------


def _walks(d, e2, lo, hi, piv, start, end):
    """Each lane's segment clamped to the band and the column its walk
    starts from: the last ``j <= start`` with ``j == 0`` or ``e2[j-1] ==
    0``, or 0 where a NaN could reach that junction (non-finite ``d`` or
    ``e^2`` before it, ``e^2 / pivmin`` overflowing, ``pivmin <= 0`` or a
    non-finite bracket)."""
    n = d.shape[0]
    s = np.clip(start, 0, n)
    en = np.maximum(np.minimum(end, n), s)
    frm = en.copy()
    for l in range(len(s)):
        if en[l] > s[l]:
            j = s[l]
            while j > 0 and e2[j - 1] != 0:
                j -= 1
            frm[l] = j
    walking = frm < en
    prefix = int(frm[walking].max()) if walking.any() else 0
    e2p = np.concatenate([[0], e2])[:prefix].astype(d.dtype)
    bad = not (np.all(np.isfinite(d[:prefix])) and np.all(np.isfinite(e2p)))
    e2max = e2p[np.isfinite(e2p)].max() if prefix else d.dtype.type(0)
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        for l in range(len(s)):
            if 0 < frm[l] < en[l] and (
                    bad or not piv[l] > 0 or not np.isfinite(e2max / piv[l])
                    or not np.isfinite(lo[l]) or not np.isfinite(hi[l])):
                frm[l] = 0
    return s, en, frm


def _segment_counts(d, e2, x, piv, frm, start, end):
    """Counts of the walks ``[frm, end)`` at the shifts ``x``, only steps
    ``>= start`` counted, all evaluations in lock step; and the steps."""
    dt = d.dtype.type
    count = np.zeros(len(x), np.int64)
    q = np.ones(len(x), dt)
    if len(x) == 0 or not np.any(frm < end):
        return count, 0
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        for k in range(int(frm[frm < end].min()), int(end.max())):
            active = (frm <= k) & (k < end)
            if not active.any():
                continue
            first = k == frm
            dk = d[k] - x
            step = dk - (e2[k - 1] if k > 0 else dt(0)) / q
            qn = np.where(first, dk, step)
            qn = np.where(np.abs(qn) < piv, -piv, qn)
            count += active & (k >= start) & _negative(qn)
            q = np.where(active, qn, q)
    return count, int(np.maximum(end - frm, 0).sum())


def segmented_tree_row(d, e, lo, hi, piv, start, end, targets, n_iter,
                       threads, cap):
    """``csrc/sturm_segmented.cu`` on one band: blocks of ``cap`` lanes and
    ``threads`` threads.  Returns the outputs, the recurrence steps its
    evaluations walked and the rounds of its longest block."""
    dt = d.dtype.type
    half = dt(0.5)
    e2 = e * e
    m = len(lo)
    out = np.full(m, np.nan, dt)
    steps = rounds = 0
    for lane0 in range(0, m, cap):
        sl = slice(lane0, min(m, lane0 + cap))
        blo, bhi, bpiv, tg = lo[sl], hi[sl], piv[sl], targets[sl]
        s, en, frm = _walks(d, e2, blo, bhi, bpiv, start[sl], end[sl])
        same = lambda a, b: _bits(a) == _bits(b)  # noqa: E731
        brackets, first = [], 0
        for l in range(1, len(blo) + 1):
            if l == len(blo) or not (
                    same(blo[l], blo[l - 1]) and same(bhi[l], bhi[l - 1])
                    and same(bpiv[l], bpiv[l - 1]) and s[l] == s[l - 1]
                    and en[l] == en[l - 1] and tg[l] >= tg[l - 1]):
                brackets.append((blo[first], bhi[first], first, l - 1))
                first = l
        it = block_rounds = 0
        while brackets and it < n_iter:
            depth = 1
            while (depth < 3 and depth < n_iter - it
                   and len(brackets) * ((2 << depth) - 1) <= threads):
                depth += 1
            nodes = (1 << depth) - 1
            mids, owner = [], []
            for lo_, hi_, f, _ in brackets:
                for v in range(nodes):
                    path, a, b = v + 1, lo_, hi_
                    mid = half * (a + b)
                    for bit in range(path.bit_length() - 2, -1, -1):
                        a, b = (mid, b) if (path >> bit) & 1 else (a, mid)
                        mid = half * (a + b)
                    mids.append(mid)
                    owner.append(f)
            owner = np.array(owner)
            cnt, walked = _segment_counts(d, e2, np.array(mids, dt),
                                          bpiv[owner], frm[owner], s[owner],
                                          en[owner])
            steps += walked
            # One walker a path (a bracket and `depth` turns), as the kernel
            # walks: a fixed point is written by the first path under each
            # of its children, a live leaf goes on.
            leaves = []
            for w in range(len(brackets) << depth):
                i, path = w >> depth, w & ((1 << depth) - 1)
                a, b, lf, rl = brackets[i]
                v, live = 0, True
                for level in range(depth):
                    below = depth - 1 - level
                    right = (path >> below) & 1
                    mid = half * (a + b)
                    c = int(cnt[i * nodes + v])
                    split = lf + int(np.searchsorted(tg[lf:rl + 1], c))
                    if _fixed(a, b, mid):
                        if path & ((1 << below) - 1) == 0:
                            if not right:
                                out[lane0 + lf:lane0 + split] = half * (a + mid)
                            else:
                                out[lane0 + split:lane0 + rl + 1] = \
                                    half * (mid + b)
                        live = False
                        break
                    if right:
                        a, lf, v = mid, split, 2 * v + 2
                    else:
                        b, rl, v = mid, split - 1, 2 * v + 1
                    if lf > rl:
                        live = False
                        break
                if live:
                    leaves.append((a, b, lf, rl))
            brackets = leaves
            it += depth
            block_rounds += 1
        for a, b, f, last in brackets:
            out[lane0 + f:lane0 + last + 1] = half * (a + b)
        rounds = max(rounds, block_rounds)
    return out, steps, rounds


def segmented_tree(d, e, lanes, n_iter, threads, cap):
    """The model over rows: ``(rows, m)``, steps walked, longest rounds."""
    with np.errstate(all="ignore"):
        rows = [segmented_tree_row(d[r], e[r], *(lanes[name][r] for name in (
            "lo", "hi", "pivmin", "start", "end", "targets")), n_iter,
            threads, cap) for r in range(d.shape[0])]
    return (np.stack([r[0] for r in rows]), sum(r[1] for r in rows),
            max(r[2] for r in rows))


def _plain_segmented(d, e, lanes, n_iter):
    return bisect_lanes_segmented(
        torch.as_tensor(d), torch.as_tensor(e),
        **{k: torch.as_tensor(v) for k, v in lanes.items()},
        n_iter=n_iter).numpy()


def _packed_band(rng, lengths, kinds, dtype, scale, junction):
    """One packed row of segments of ``lengths`` (0: an empty slot, no
    columns), each of its own structure; junction off-diagonals 0, or
    ``junction`` times a normal draw where that is nonzero."""
    d, e = [], []
    for length, kind in zip(lengths, kinds):
        if length == 0:
            continue
        bd, be = _band(kind, length, 1, np.float64, 1.0,
                       int(rng.integers(1 << 16)))
        if d:
            e.append(junction * rng.standard_normal())
        d.extend(bd[0])
        e.extend(be[0])
    off = np.cumsum([0] + list(lengths))[:-1]
    return ((np.array(d) * scale).astype(dtype),
            (np.array(e) * scale).astype(dtype), off.astype(np.int32),
            np.array(lengths, np.int32))


def _np_lanes(d, e, off, length, k, largest):
    from repro_torch.kernels.sturm.ops import segmented_lanes

    lanes = segmented_lanes(torch.as_tensor(d[None]), torch.as_tensor(e[None]),
                            torch.as_tensor(off[None]),
                            torch.as_tensor(length[None]), k=k,
                            largest=largest)
    return {name: v.numpy() for name, v in lanes.items()}


def _iters(dtype):
    return 64 if dtype == np.float64 else 32


#: Scale exponents of the drawn packed bands: float64 to 1e150; float32 to
#: 1e30, past ~1e19 of which e^2 overflows (the lanes then walk from 0).
_SEG_SCALE_EXP = {np.float64: (-19, 150), np.float32: (-19, 30)}


@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
@settings(max_examples=30, deadline=None)
@given(lengths=st.lists(st.integers(0, 9), min_size=1, max_size=4),
       kinds=st.lists(st.sampled_from(_KINDS), min_size=4, max_size=4),
       scale_exp=st.integers(-19, 150), junction=st.sampled_from([0.0, 1e-3, 1.0]),
       k=st.integers(1, 4), largest=st.booleans(),
       threads=st.sampled_from([32, 64, 640]), cap=st.sampled_from([1, 3, 4, 64]),
       seed=st.integers(0, 2 ** 16))
def test_segmented_tree_is_bitwise_the_plain_version(dtype, lengths, kinds,
                                                     scale_exp, junction, k,
                                                     largest, threads, cap,
                                                     seed):
    """The model of kernel 3 (restart at the junction, a tree per block,
    fixed-point exit) against ``bisect_lanes_segmented``, bitwise, on packed
    rows with empty slots, length-1 segments, repeated eigenvalues, zero and
    nonzero junctions, and scales from 1e-19 to 1e150 (1e30 in float32)."""
    if sum(lengths) == 0:
        lengths = lengths + [1]
    lo_e, hi_e = _SEG_SCALE_EXP[dtype]
    scale = 10.0 ** min(max(scale_exp, lo_e), hi_e)
    rng = np.random.default_rng(seed)
    d, e, off, length = _packed_band(rng, lengths, kinds, dtype, scale,
                                     junction)
    lanes = _np_lanes(d, e, off, length, k, largest)
    got, _, _ = segmented_tree(d[None], e[None], lanes, _iters(dtype),
                               threads, cap)
    assert _same_bits(got, _plain_segmented(d[None], e[None], lanes,
                                            _iters(dtype)))


@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
def test_segmented_tree_restarts_only_where_it_is_bitwise(dtype):
    """Lanes whose prefix could form a NaN walk from column 0 and stay
    bitwise: e^2 overflowing before the junction, a non-finite entry there,
    pivmin 0 and an infinite bracket; a nonzero junction walks back to the
    previous zero."""
    rng = np.random.default_rng(5)
    big = 1e200 if dtype == np.float64 else 1e25
    n_iter = _iters(dtype)
    for case in ("overflow", "inf", "pivmin0", "bracket", "leak"):
        d, e, off, length = _packed_band(rng, [6, 1, 7, 5], ["random"] * 4,
                                         dtype, 1.0, 0.0)
        if case == "overflow":
            e[1] = e[2] = dtype(big)
        if case == "inf":
            d[2] = np.inf
        if case == "leak":
            e[6] = dtype(0.5)
        lanes = _np_lanes(d, e, off, length, 3, True)
        if case == "pivmin0":
            lanes["pivmin"][:] = 0
        if case == "bracket":
            lanes["hi"][0, 6:] = np.inf
        with np.errstate(over="ignore"):
            e2 = e * e
        s, en, frm = _walks(d, e2, *(lanes[name][0] for name in (
            "lo", "hi", "pivmin", "start", "end")))
        if case == "leak":
            assert frm[6] == 6 and frm[9] == 14    # back past the leak
        elif case == "bracket":
            assert frm[3] == 6 and np.all(frm[6:] == 0)
        else:
            assert np.all(frm[3:] == 0)            # every later walk from 0
        got, _, _ = segmented_tree(d[None], e[None], lanes, n_iter, 64, 3)
        assert _same_bits(got, _plain_segmented(d[None], e[None], lanes,
                                                n_iter)), case


def test_segmented_tree_matches_repro_on_packed_rows():
    """The model against ``repro``'s segmented op (Pallas, interpret mode)
    on drawn packed rows of one width, within repro's Sturm tolerance (and
    bitwise the plain version): empty slots, length-1 segments, repeated
    eigenvalues, scales from 1e-19 to 1e150 (1e15 in float32, where e^2
    stays finite in every implementation)."""
    from repro.kernels.sturm import ops as r_ops

    rng = np.random.default_rng(11)
    width = 24
    for dtype, top in ((np.float64, 150), (np.float32, 15)):
        name = "float64" if dtype == np.float64 else "float32"
        n_iter = _iters(dtype)
        for case in range(6):
            lengths = list(rng.integers(0, 9, size=4))
            lengths[case % 4] = [0, 1, 9, 3][case % 4]
            lengths[-1] = width - sum(lengths[:-1])
            if lengths[-1] < 0:
                lengths = [8, 8, 8, 0]
            kinds = list(rng.choice(_KINDS, size=4))
            scale = 10.0 ** rng.uniform(-19, top)
            d, e, off, length = _packed_band(rng, lengths, kinds, dtype,
                                             scale, 0.0)
            for k, largest in ((3, True), (2, False)):
                lanes = _np_lanes(d, e, off, length, k, largest)
                got, _, _ = segmented_tree(d[None], e[None], lanes, n_iter,
                                           64, k)
                assert _same_bits(got, _plain_segmented(d[None], e[None],
                                                        lanes, n_iter))
                ref = np.asarray(r_ops.sturm_eigenvalues_segmented(
                    jnp.asarray(d[None]), jnp.asarray(e[None]),
                    jnp.asarray(off[None]), jnp.asarray(length[None]), k=k,
                    largest=largest))
                np.testing.assert_allclose(
                    got.reshape(ref.shape), ref, *TOL["sturm"][name])


@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
def test_segmented_tree_on_warm_brackets(dtype):
    """The session's case: one full-band segment, a bracket a lane from
    interlacing (some stale, so that they fall back to Gershgorin); bitwise
    the plain version and within repro's Sturm tolerance of repro's
    bracketed op."""
    from repro.kernels.sturm import ops as r_ops
    from repro_torch.kernels.sturm.ops import bracketed_lanes

    name = "float64" if dtype == np.float64 else "float32"
    rng = np.random.default_rng(3)
    n, k = 16, 12
    d, e = _band("random", n, 2, dtype, 1.0, 9)
    lam = np.linalg.eigvalsh(np.stack([np.diag(d[r].astype(np.float64))
                                       + np.diag(e[r], 1) + np.diag(e[r], -1)
                                       for r in range(2)]))[:, -k:]
    width = 10.0 ** rng.uniform(-6, -1, lam.shape)
    lo, hi = (lam - width).astype(dtype), (lam + width).astype(dtype)
    lo[1, :3] += 4.0  # stale
    hi[1, :3] += 4.0
    lanes = {key: v.numpy() for key, v in bracketed_lanes(
        torch.as_tensor(d), torch.as_tensor(e), torch.as_tensor(lo),
        torch.as_tensor(hi), k=k, largest=True).items()}
    for threads in (32, 96):
        got, _, rounds = segmented_tree(d, e, lanes, _iters(dtype), threads,
                                        k)
        assert _same_bits(got, _plain_segmented(d, e, lanes, _iters(dtype)))
    ref = np.asarray(r_ops.sturm_eigenvalues_bracketed(
        jnp.asarray(d), jnp.asarray(e), jnp.asarray(lo), jnp.asarray(hi),
        k=k, largest=True))
    np.testing.assert_allclose(got, ref, *TOL["sturm"][name])
    # Three levels a round cut the 64-deep (32) chain to about a third.
    assert rounds <= -(-_iters(dtype) // 3) + 1


def _smoke_packed_rows(dtype, rows, seg_n, slots, seed):
    """Rows of the packed program's kind: ``slots`` tridiagonal bands of
    ``seg_n`` (the Householder bands of seeded symmetric matrices) with zero
    junctions."""
    from repro_torch.linalg.householder import tridiagonalize

    rng = np.random.default_rng(seed)
    a = rng.standard_normal((rows * slots, seg_n, seg_n))
    a = torch.as_tensor((a + np.swapaxes(a, 1, 2)) / 2).to(
        torch.float64 if dtype == np.float64 else torch.float32)
    d, e, _ = tridiagonalize(a, with_q=False)
    d = d.numpy().reshape(rows, slots * seg_n)
    ep = np.zeros((rows * slots, seg_n), dtype)
    ep[:, :seg_n - 1] = e.numpy()
    e = ep.reshape(rows, slots * seg_n)[:, :-1]
    off = np.tile(np.arange(slots, dtype=np.int32) * seg_n, (rows, 1))
    length = np.full((rows, slots), seg_n, np.int32)
    return d, e, off, length


@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
def test_segmented_tree_walks_a_fraction_of_the_whole_band(dtype):
    """The work of the design against the kernel of one lane a thread over
    the whole band, counted in recurrence steps, on two rows of the packed
    program's kind (16 segments of n = 32 a row, k = 8) and two of the
    synthetic packed shape's (4 segments a row; n = 120 here for time).
    With one thread a bracket (8 threads a block of 8 lanes) the walks
    restart at the junctions and the tree shares and stops, so the design
    walks about 0.8 / S of the whole-band steps (0.82 / 0.80 in float64,
    0.73 / 0.69 in float32); one warp a segment evaluates speculative
    levels too, about 1.2 / S, in half the rounds."""
    k = 8
    for seg_n, slots in ((32, 16), (120, 4)):
        d, e, off, length = _smoke_packed_rows(dtype, 2, seg_n, slots, 1)
        assert np.all(e[:, off[0, 1:] - 1] == 0)    # exact zero junctions
        lanes = {key: np.concatenate([_np_lanes(d[r], e[r], off[r],
                                                length[r], k, True)[key]
                                      for r in range(2)])
                 for key in ("lo", "hi", "pivmin", "start", "end", "targets")}
        whole = lanes["lo"].size * _iters(dtype) * d.shape[1]
        plain = _plain_segmented(d, e, lanes, _iters(dtype))
        got, lean, lean_rounds = segmented_tree(d, e, lanes, _iters(dtype),
                                                k, k)
        assert _same_bits(got, plain)
        got, wide, wide_rounds = segmented_tree(d, e, lanes, _iters(dtype),
                                                32, k)
        assert _same_bits(got, plain)
        assert lean < 0.9 / slots * whole, (seg_n, lean / whole)
        assert wide < 1.4 / slots * whole, (seg_n, wide / whole)
        assert wide_rounds < 0.6 * lean_rounds
