"""repro_torch kernels against repro's Pallas kernels (interpret mode).

On the CPU each kernel wrapper runs its plain PyTorch version; the same
seeded numpy inputs go through ``repro`` and the port.  Also: the
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


def test_plain_versions_launch_nothing():
    d, e = bands(3, 2, 8)
    st_ops.sturm_eigenvalues(t(d), t(e))
    lam, mu = _spectra(3, 2, 8, "float64")
    pd_ops.eei_magnitudes_batched(t(lam), t(mu))
    assert st_kernel.sturm_bisect.launches == 0
    assert pd_kernel.logabs_sum.launches == 0
    assert np.isfinite(np_of(pd_ops.eei_magnitudes_batched(t(lam), t(mu)))).all()
