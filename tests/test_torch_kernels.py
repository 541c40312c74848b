"""repro_torch kernels against repro's Pallas kernels (interpret mode).

On the CPU each kernel wrapper runs its plain PyTorch version; the same
seeded numpy inputs go through ``repro`` and the port: the Sturm kernel
(full, windowed, minor stacks), the segmented Sturm kernel (packed segments
and warm brackets), and the three prod-diff kernels (batched, masked,
single matrix).  Also: the
``blocks`` helpers (the property tests of ``tests/test_kernels.py``
mirrored), the two bitwise contracts inside the port, and the wrappers'
refusal of devices they do not serve.
"""

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from hypothesis_compat import given, settings, st  # noqa: E402
from test_torch_parity import DTYPES, assert_close, bands, np_of, t  # noqa: E402

from repro.kernels import blocks as r_blocks  # noqa: E402
from repro.kernels.prod_diff import ops as r_pd  # noqa: E402
from repro.kernels.prod_diff import ref as r_pd_ref  # noqa: E402
from repro.kernels.sturm import ops as r_st  # noqa: E402
from repro_torch.core import identity  # noqa: E402
from repro_torch.kernels import blocks  # noqa: E402
from repro_torch.kernels.prod_diff import kernel as pd_kernel  # noqa: E402
from repro_torch.kernels.prod_diff import ops as pd_ops  # noqa: E402
from repro_torch.kernels.prod_diff import ref as pd_ref  # noqa: E402
from repro_torch.kernels.sturm import kernel as st_kernel  # noqa: E402
from repro_torch.kernels.sturm import ops as st_ops  # noqa: E402
from repro_torch.kernels.sturm import ref as st_ref  # noqa: E402


def _spectra(seed, b, n, dtype):
    """Seeded ascending ``lam (b, n)`` and minor-like ``mu (b, n, n-1)``."""
    rng = np.random.default_rng(seed)
    lam = np.sort(rng.standard_normal((b, n)), axis=-1).astype(dtype)
    mu = np.sort(rng.standard_normal((b, n, n - 1)), axis=-1).astype(dtype)
    return lam, mu


# -- blocks (tests/test_kernels.py:247-289 mirrored) --------------------------


def test_block_clamping_small_problems():
    assert blocks.clamp_block(128, 3) == 8
    assert blocks.clamp_block(128, 17) == 24
    assert blocks.clamp_block(128, 64) == 64
    assert blocks.clamp_block(128, 130) == 128
    assert blocks.clamp_block(8, 130, align=1) == 8
    assert blocks.clamp_block(8, 3, align=1) == 3
    assert blocks.clamp_block(12, 64) == 16
    assert blocks.pow2_bucket(1) == 1 and blocks.pow2_bucket(5) == 8 and \
        blocks.pow2_bucket(64) == 64
    assert blocks.clamp_batch_block(8, 5) == 8
    assert blocks.clamp_batch_block(128, 6) == 8
    assert blocks.clamp_batch_block(1, 100) == 1
    assert blocks.clamp_batch_block(3, 100) == 4


@settings(max_examples=25, deadline=None)
@given(x=st.integers(1, 1 << 20))
def test_property_pow2_bucket(x):
    p = blocks.pow2_bucket(x)
    assert p >= x and p & (p - 1) == 0 and p < 2 * x
    assert blocks.pow2_bucket(p) == p
    assert p == r_blocks.pow2_bucket(x)


def test_pow2_bucket_rejects_nonpositive():
    for bad in (0, -1, -128):
        with pytest.raises(ValueError):
            blocks.pow2_bucket(bad)


@settings(max_examples=25, deadline=None)
@given(requested=st.integers(1, 512), dim=st.integers(1, 512),
       align=st.sampled_from([1, 8]))
def test_property_clamp_block(requested, dim, align):
    block = blocks.clamp_block(requested, dim, align=align)
    rounded_dim = -(-dim // align) * align
    assert block % align == 0
    assert align <= block <= max(rounded_dim, align)
    assert block <= -(-requested // align) * align
    if requested >= rounded_dim:
        assert block == rounded_dim and block - dim < align
    assert blocks.clamp_block(requested + 1, dim, align=align) >= block
    assert block == r_blocks.clamp_block(requested, dim, align=align)


@settings(max_examples=25, deadline=None)
@given(requested=st.integers(1, 512), b=st.integers(1, 512))
def test_property_clamp_batch_block(requested, b):
    bb = blocks.clamp_batch_block(requested, b)
    assert bb >= 1 and bb & (bb - 1) == 0
    assert bb <= blocks.pow2_bucket(b)
    assert blocks.pow2_bucket(b) % bb == 0
    assert bb <= blocks.pow2_bucket(requested)
    assert bb == r_blocks.clamp_batch_block(requested, b)


# -- Sturm ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bn", [(1, 4), (3, 17), (4, 40)])
def test_sturm_eigenvalues_match_repro(bn, dtype):
    d, e = bands(bn[0] * 10 + bn[1], *bn, dtype)
    got = st_ops.sturm_eigenvalues(t(d), t(e))
    assert got.dtype == t(d).dtype
    ref = r_st.sturm_eigenvalues(jnp.asarray(d), jnp.asarray(e))
    assert_close(got, ref, "sturm", dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("largest", [True, False])
def test_sturm_window_matches_repro_and_is_bitwise_the_slice(largest, dtype):
    d, e = bands(7, 3, 23, dtype)
    k = 5
    win = st_ops.sturm_eigenvalues(t(d), t(e), window=(k, largest))
    ref = r_st.sturm_eigenvalues(jnp.asarray(d), jnp.asarray(e),
                                 window=(k, largest))
    assert_close(win, ref, "sturm", dtype)
    full = st_ops.sturm_eigenvalues(t(d), t(e))
    expect = full[:, -k:] if largest else full[:, :k]
    assert torch.equal(win, expect)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sturm_minor_spectra_match_repro(dtype):
    from repro.core import minors as r_minors
    from repro_torch.core import minors

    d, e = bands(5, 3, 12, dtype)
    dm, em = minors.all_tridiagonal_minor_bands(t(d), t(e))
    got = st_ops.sturm_minor_spectra(dm, em)
    assert got.shape == (3, 12, 11)
    rdm, rem = r_minors.all_tridiagonal_minor_bands_batched(
        jnp.asarray(d), jnp.asarray(e))
    assert_close(got, r_st.sturm_minor_spectra(rdm, rem), "sturm", dtype)


def test_sturm_decoupled_and_degenerate():
    d = np.array([[1.0, 1.0, 1.0, 5.0, 5.0, 2.0]])
    e = np.array([[0.0, 0.5, 0.0, 0.0, 1.0]])
    got = st_ops.sturm_eigenvalues(t(d), t(e))
    ref = r_st.sturm_eigenvalues(jnp.asarray(d), jnp.asarray(e))
    assert_close(got, ref, "sturm", "float64")


def _packed_bands(seed, lengths, dtype):
    """Seeded bands of the given lengths packed one after another on each
    row, with zero off-diagonals at the junctions and a free tail; returns
    ``d (B, N)``, ``e (B, N-1)``, ``seg_off``, ``seg_len`` (int32)."""
    rng = np.random.default_rng(seed)
    b_n = len(lengths)
    n = max(sum(row) for row in lengths) + 3
    d = rng.standard_normal((b_n, n)).astype(dtype)
    e = rng.standard_normal((b_n, n - 1)).astype(dtype)
    off = np.zeros((b_n, len(lengths[0])), np.int32)
    for r, row in enumerate(lengths):
        off[r] = np.concatenate([[0], np.cumsum(row)[:-1]])
        for o, ln in zip(off[r], row):
            if 0 < o + ln <= n - 1:
                e[r, o + ln - 1] = 0.0
    return d, e, off, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("largest", [True, False])
def test_sturm_segmented_matches_repro(largest, dtype):
    """Ragged segments, a segment shorter than the window (clamped lanes)
    and an empty slot."""
    d, e, off, length = _packed_bands(3, [[7, 5, 9], [11, 2, 0]], dtype)
    k = 3
    got = st_ops.sturm_eigenvalues_segmented(t(d), t(e), t(off), t(length),
                                             k=k, largest=largest)
    assert got.shape == (2, 3, k) and got.dtype == t(d).dtype
    ref = r_st.sturm_eigenvalues_segmented(
        jnp.asarray(d), jnp.asarray(e), jnp.asarray(off), jnp.asarray(length),
        k=k, largest=largest)
    assert_close(got, ref, "sturm", dtype)
    # A full segment's lanes are the window of its own band.
    seg = st_ops.sturm_eigenvalues(t(d[:1, :7]), t(e[:1, :6]),
                                   window=(k, largest))
    assert_close(got[0, 0], seg[0], "sturm", dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("largest", [True, False])
def test_sturm_bracketed_matches_repro(largest, dtype):
    d, e = bands(21, 3, 17, dtype)
    k = 5
    win = np_of(st_ops.sturm_eigenvalues(t(d), t(e), window=(k, largest)))
    lo = (win - 0.02).astype(dtype)
    hi = (win + 0.02).astype(dtype)
    lo[1, :2] += 4.0  # stale lanes: the Gershgorin fallback runs
    hi[1, :2] += 4.0
    got = st_ops.sturm_eigenvalues_bracketed(t(d), t(e), t(lo), t(hi), k=k,
                                             largest=largest)
    ref = r_st.sturm_eigenvalues_bracketed(
        jnp.asarray(d), jnp.asarray(e), jnp.asarray(lo), jnp.asarray(hi),
        k=k, largest=largest)
    assert_close(got, ref, "sturm", dtype)
    assert_close(got, win, "sturm", dtype)


def test_segmented_plain_on_a_full_band_is_bitwise_the_window():
    d, e = (t(x) for x in bands(13, 2, 30))
    k = 6
    off = torch.zeros((2, 1), dtype=torch.int32)
    length = torch.full((2, 1), 30, dtype=torch.int32)
    got = st_ops.sturm_eigenvalues_segmented(d, e, off, length, k=k,
                                             largest=True)
    assert torch.equal(got[:, 0], st_ops.sturm_eigenvalues(d, e,
                                                           window=(k, True)))


def test_sturm_ref_is_the_plain_path():
    d, e = bands(11, 2, 9)
    assert torch.equal(st_ref.sturm_eigenvalues(t(d), t(e)),
                       st_ops.sturm_eigenvalues(t(d), t(e)))


# -- prod-diff --------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 4, 4, 3), (3, 12, 12, 11),
                                   (2, 40, 33, 17)])
def test_logabs_sum_batched_matches_repro(shape, dtype):
    b, i_n, j_n, k_n = shape
    rng = np.random.default_rng(i_n * 100 + j_n)
    lam = rng.standard_normal((b, i_n)).astype(dtype)
    mu = rng.standard_normal((b, j_n, k_n)).astype(dtype)
    got = pd_ops.logabs_sum_batched(t(lam), t(mu), 1e-9)
    ref = r_pd.logabs_sum_batched(jnp.asarray(lam), jnp.asarray(mu), 1e-9)
    assert_close(got, ref, "prod_diff", dtype)


def test_logabs_sum_per_matrix_floor_matches_repro():
    lam, mu = _spectra(2, 3, 9, "float64")
    floor = np.array([1e-9, 0.3, 2.0])
    got = pd_ops.logabs_sum_batched(t(lam), t(mu), t(floor))
    ref = r_pd.logabs_sum_batched(jnp.asarray(lam), jnp.asarray(mu),
                                  jnp.asarray(floor))
    assert_close(got, ref, "prod_diff", "float64")


@pytest.mark.parametrize("dtype", DTYPES)
def test_eei_magnitudes_batched_matches_repro(dtype):
    lam, mu = _spectra(4, 3, 17, dtype)
    got = pd_ops.eei_magnitudes_batched(t(lam), t(mu))
    ref = r_pd.eei_magnitudes_batched(jnp.asarray(lam), jnp.asarray(mu))
    assert_close(got, ref, "prod_diff", dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_eei_magnitudes_windowed_matches_repro_and_full_rows(dtype):
    lam, mu = _spectra(6, 4, 20, dtype)
    idx = np.array([16, 17, 18, 19])
    got = pd_ops.eei_magnitudes_windowed(t(lam), t(mu), torch.as_tensor(idx))
    ref = r_pd.eei_magnitudes_windowed(jnp.asarray(lam), jnp.asarray(mu),
                                       jnp.asarray(idx))
    assert_close(got, ref, "prod_diff", dtype)
    full = pd_ops.eei_magnitudes_batched(t(lam), t(mu))
    assert torch.equal(got, full[:, idx])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 4, 4, 3), (3, 12, 12, 11),
                                   (2, 40, 33, 17)])
def test_logabs_sum_batched_mask_matches_repro(shape, dtype):
    """No test of repro reaches its masked kernel: its op is called with
    ``mask=`` here.  A per-matrix random mask, valid where it is > 0."""
    b, i_n, j_n, k_n = shape
    rng = np.random.default_rng(i_n * 7 + k_n)
    lam = rng.standard_normal((b, i_n)).astype(dtype)
    mu = rng.standard_normal((b, j_n, k_n)).astype(dtype)
    mask = (rng.random((b, j_n, k_n)) > 0.4).astype(dtype)
    got = pd_ops.logabs_sum_batched(t(lam), t(mu), 1e-9, mask=t(mask))
    ref = r_pd.logabs_sum_batched(jnp.asarray(lam), jnp.asarray(mu), 1e-9,
                                  mask=jnp.asarray(mask))
    assert_close(got, ref, "prod_diff", dtype)


def test_masked_prod_diff_adds_exact_zeros():
    lam, mu = _spectra(14, 2, 9, "float64")
    floor = torch.full((2,), 1e-9, dtype=torch.float64)
    valid = torch.ones(mu.shape, dtype=torch.bool)
    assert torch.equal(
        pd_kernel.logabs_sum_masked(t(lam), t(mu), valid, floor),
        pd_kernel.logabs_sum(t(lam), t(mu), floor))
    valid[:, :, 5:] = False
    assert_close(pd_kernel.logabs_sum_masked(t(lam), t(mu), valid, floor),
                 pd_kernel.logabs_sum(t(lam), t(mu[:, :, :5]).contiguous(),
                                      floor), "prod_diff", "float64")


@pytest.mark.parametrize("dtype", DTYPES)
def test_single_matrix_logabs_sum_and_magnitudes_match_repro(dtype):
    """``logabs_sum`` and ``eei_magnitudes`` reach the single-matrix kernel;
    the spectra are a real matrix's and its minors'."""
    from test_torch_parity import sym_stack

    a = sym_stack(15, 1, 13)[0]
    lam = np.linalg.eigvalsh(a).astype(dtype)
    mu = np.stack([np.linalg.eigvalsh(np.delete(np.delete(a, j, 0), j, 1))
                   for j in range(13)]).astype(dtype)
    got = pd_ops.logabs_sum(t(lam), t(mu), 1e-9)
    assert got.shape == (13, 13)
    assert_close(got, r_pd.logabs_sum(jnp.asarray(lam), jnp.asarray(mu),
                                      1e-9), "prod_diff", dtype)
    mags = pd_ops.eei_magnitudes(t(lam), t(mu))
    assert_close(mags, r_pd.eei_magnitudes(jnp.asarray(lam), jnp.asarray(mu)),
                 "prod_diff", dtype)
    v = np.linalg.eigh(a)[1]
    assert_close(mags, (v * v).T,
                 "prod_diff" if dtype == "float64" else "magnitudes", dtype)
    assert_close(mags, pd_ops.eei_magnitudes_batched(t(lam[None]),
                                                     t(mu[None]))[0],
                 "prod_diff", dtype)


def test_plain_prod_diff_chunking_is_bitwise_invisible(monkeypatch):
    lam, mu = _spectra(8, 2, 15, "float64")
    floor = torch.full((2,), 1e-9, dtype=torch.float64)
    whole = pd_kernel.logabs_sum_plain(t(lam), t(mu), floor)
    monkeypatch.setattr(identity, "_CHUNK_ELEMS", 2 * 15 * 14 * 4)  # 4 rows
    chunked = pd_kernel.logabs_sum_plain(t(lam), t(mu), floor)
    assert torch.equal(whole, chunked)


def test_prod_diff_ref_matches_repro_ref():
    lam, mu = _spectra(9, 1, 12, "float64")
    got = pd_ref.eei_magnitudes(t(lam[0]), t(mu[0]))
    ref = r_pd_ref.eei_magnitudes(jnp.asarray(lam[0]), jnp.asarray(mu[0]))
    assert_close(got, ref, "prod_diff", "float64")
    assert_close(pd_ref.logabs_sum(t(lam[0]), t(mu[0]), 1e-9),
                 r_pd_ref.logabs_sum(jnp.asarray(lam[0]), jnp.asarray(mu[0]),
                                     1e-9), "prod_diff", "float64")


# -- the wrappers serve cpu and cuda only, and check their operands --------------


def test_wrappers_refuse_other_devices():
    d = torch.zeros((2, 5), device="meta")
    e = torch.zeros((2, 4), device="meta")
    bounds = torch.zeros((2, 3), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        st_kernel.sturm_bisect(d, e, bounds, target_base=0, m=5, n_iter=4)
    lam = torch.zeros((2, 5), device="meta")
    mu = torch.zeros((2, 5, 4), device="meta")
    floor = torch.zeros((2,), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        pd_kernel.logabs_sum(lam, mu, floor)
    with pytest.raises(ValueError, match="cpu or cuda"):
        pd_kernel.logabs_sum_masked(
            lam, mu, torch.ones((2, 5, 4), dtype=torch.bool, device="meta"),
            floor)
    with pytest.raises(ValueError, match="cpu or cuda"):
        pd_kernel.logabs_sum_single(lam[0], mu[0], floor[0])
    lanes = torch.zeros((2, 3), device="meta")
    ilanes = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        st_kernel.sturm_segmented(d, e, lanes, lanes, lanes, ilanes, ilanes,
                                  ilanes, n_iter=4)
    assert st_kernel.sturm_bisect.launches == 0
    assert pd_kernel.logabs_sum.launches == 0


def test_wrappers_check_operands():
    d, e = (t(x) for x in bands(1, 2, 6))
    bounds = torch.zeros((2, 3), dtype=torch.float64)
    with pytest.raises(ValueError):
        st_kernel.sturm_bisect(d, e[:, :-1], bounds, target_base=0, m=6,
                               n_iter=4)
    with pytest.raises(ValueError):
        st_kernel.sturm_bisect(d, e, bounds, target_base=3, m=6, n_iter=4)
    with pytest.raises(TypeError):
        st_kernel.sturm_bisect(d.int(), e, bounds, target_base=0, m=6,
                               n_iter=4)
    lam, mu = (t(x) for x in _spectra(1, 2, 6, "float64"))
    with pytest.raises(TypeError):
        pd_kernel.logabs_sum(lam, mu.float(), torch.ones(2, dtype=torch.float64))
    with pytest.raises(ValueError):
        pd_kernel.logabs_sum(lam, mu, torch.ones(3, dtype=torch.float64))
    floor = torch.ones(2, dtype=torch.float64)
    with pytest.raises(TypeError, match="bool"):
        pd_kernel.logabs_sum_masked(lam, mu, torch.ones(mu.shape), floor)
    with pytest.raises(ValueError):
        pd_kernel.logabs_sum_masked(lam, mu, torch.ones((2, 6, 4),
                                                        dtype=torch.bool),
                                    floor)
    with pytest.raises(ValueError):
        pd_kernel.logabs_sum_single(lam, mu, floor)
    lanes = torch.zeros((2, 3), dtype=torch.float64)
    ilanes = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        st_kernel.sturm_segmented(d, e, lanes, lanes, lanes, ilanes.long(),
                                  ilanes, ilanes, n_iter=4)
    with pytest.raises(ValueError):
        st_kernel.sturm_segmented(d, e, lanes, lanes[:, :2], lanes, ilanes,
                                  ilanes, ilanes, n_iter=4)


def test_plain_versions_launch_nothing():
    d, e = bands(3, 2, 8)
    st_ops.sturm_eigenvalues(t(d), t(e))
    st_ops.sturm_eigenvalues_bracketed(t(d), t(e), t(d[:, :2]), t(d[:, :2]),
                                       k=2, largest=True)
    lam, mu = _spectra(3, 2, 8, "float64")
    pd_ops.eei_magnitudes_batched(t(lam), t(mu))
    pd_ops.logabs_sum_batched(t(lam), t(mu), 1e-9, mask=t(mu > 0))
    pd_ops.eei_magnitudes(t(lam[0]), t(mu[0]))
    for wrapper in (st_kernel.sturm_bisect, st_kernel.sturm_segmented,
                    pd_kernel.logabs_sum, pd_kernel.logabs_sum_masked,
                    pd_kernel.logabs_sum_single):
        assert wrapper.launches == 0
    assert np.isfinite(np_of(pd_ops.eei_magnitudes_batched(t(lam), t(mu)))).all()
