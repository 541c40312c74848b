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
    _pivmin, bisect_lanes, default_iters, gershgorin_bounds)

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
