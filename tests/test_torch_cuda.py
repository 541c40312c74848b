"""Tests that need the card: each CUDA kernel against its plain version on
the card, and the engine on cuda against the same engine on the CPU.

Marked ``cuda``; each decides inside the ``cuda_device`` fixture whether a
card is there and skips with a reason where it is not.  This file imports
neither jax nor repro, so it runs on a machine that has only PyTorch:

    python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch import Rank1Update, SolverEngine, SolverPlan
from repro_torch.core import minors
from repro_torch.kernels.prod_diff import kernel as pd_kernel
from repro_torch.kernels.prod_diff import ops as pd_ops
from repro_torch.kernels.sturm import kernel as st_kernel
from repro_torch.kernels.sturm import ops as st_ops
from repro_torch.linalg import interlace
from repro_torch.linalg.sturm import _pivmin, gershgorin_bounds

pytestmark = pytest.mark.cuda

#: Kernel against plain version, from tests/test_kernels.py (rtol = atol).
TOL = {torch.float64: {"sturm": 1e-10, "prod_diff": 1e-10},
       torch.float32: {"sturm": 2e-5, "prod_diff": 1e-4}}
DTYPES = (torch.float64, torch.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card: torch.cuda.is_available() "
                    "is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bands(seed, b, n, dtype, device):
    rng = np.random.default_rng(seed)
    d = torch.as_tensor(rng.standard_normal((b, n)), dtype=dtype, device=device)
    e = torch.as_tensor(rng.standard_normal((b, n - 1)), dtype=dtype,
                        device=device)
    return d, e


def _close(got, ref, tol):
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bn", [(1, 1), (3, 17), (5, 130), (2, 600)])
def test_sturm_kernel_matches_plain(cuda_device, bn, dtype):
    d, e = _bands(bn[1], *bn, dtype, cuda_device)
    lo, hi = gershgorin_bounds(d, e)
    bounds = torch.stack([lo, hi, _pivmin(d, e)], dim=-1)
    before = st_kernel.sturm_bisect.launches
    got = st_kernel.sturm_bisect(d, e, bounds, target_base=0, m=bn[1],
                                 n_iter=64 if dtype == torch.float64 else 32)
    assert st_kernel.sturm_bisect.launches == before + 1
    ref = st_kernel.sturm_bisect_plain(
        d, e, bounds, target_base=0, m=bn[1],
        n_iter=64 if dtype == torch.float64 else 32)
    _close(got, ref, TOL[dtype]["sturm"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_sturm_window_and_minor_stack_on_card(cuda_device, dtype):
    d, e = _bands(4, 3, 40, dtype, cuda_device)
    full = st_ops.sturm_eigenvalues(d, e)
    for k, largest in ((5, True), (7, False), (40, True)):
        win = st_ops.sturm_eigenvalues(d, e, window=(k, largest))
        assert torch.equal(win, full[:, -k:] if largest else full[:, :k])
    dm, em = minors.all_tridiagonal_minor_bands(d, e)
    mu = st_ops.sturm_minor_spectra(dm, em)
    ref = st_ops.sturm_minor_spectra(dm.cpu(), em.cpu())
    _close(mu.cpu(), ref, TOL[dtype]["sturm"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 1, 1, 0), (2, 9, 33, 31),
                                   (3, 40, 70, 69)])
def test_prod_diff_kernel_matches_plain(cuda_device, shape, dtype):
    b, i_n, j_n, k_n = shape
    rng = np.random.default_rng(i_n + j_n)
    lam = torch.as_tensor(rng.standard_normal((b, i_n)), dtype=dtype,
                          device=cuda_device)
    mu = torch.as_tensor(rng.standard_normal((b, j_n, k_n)), dtype=dtype,
                         device=cuda_device)
    floor = torch.full((b,), 1e-6, dtype=dtype, device=cuda_device)
    before = pd_kernel.logabs_sum.launches
    got = pd_kernel.logabs_sum(lam, mu, floor)
    assert pd_kernel.logabs_sum.launches == before + 1
    _close(got, pd_kernel.logabs_sum_plain(lam, mu, floor),
           TOL[dtype]["prod_diff"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_windowed_prod_diff_rows_are_bitwise_full_rows(cuda_device, dtype):
    rng = np.random.default_rng(5)
    lam = torch.as_tensor(np.sort(rng.standard_normal((2, 50)), -1),
                          dtype=dtype, device=cuda_device)
    mu = torch.as_tensor(rng.standard_normal((2, 50, 49)), dtype=dtype,
                         device=cuda_device)
    idx = torch.arange(44, 50, device=cuda_device)
    assert torch.equal(pd_ops.eei_magnitudes_windowed(lam, mu, idx),
                       pd_ops.eei_magnitudes_batched(lam, mu)[:, idx])


def _packed(d, e, seg):
    """Pack ``b`` bands of length ``n`` ``seg`` to a row, with zero
    off-diagonals at the junctions: ``(b / seg, seg * n)`` bands and the
    segment layout."""
    b, n = d.shape
    rows = b // seg
    dp = d.reshape(rows, seg * n).contiguous()
    ep = torch.zeros((rows, seg, n), dtype=e.dtype, device=e.device)
    ep[:, :, :n - 1] = e.reshape(rows, seg, n - 1)
    ep = ep.reshape(rows, seg * n)[:, :-1].contiguous()
    off = (torch.arange(seg, dtype=torch.int32, device=d.device) * n
           ).expand(rows, seg)
    length = torch.full((rows, seg), n, dtype=torch.int32, device=d.device)
    return dp, ep, off, length


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("largest", [True, False])
def test_segmented_kernel_is_bitwise_its_plain_version(cuda_device, largest,
                                                       dtype):
    d, e = _bands(7, 8, 45, dtype, cuda_device)
    dp, ep, off, length = _packed(d, e, 4)
    before = st_kernel.sturm_segmented.launches
    got = st_ops.sturm_eigenvalues_segmented(dp, ep, off, length, k=5,
                                             largest=largest)
    assert st_kernel.sturm_segmented.launches == before + 1
    ref = st_ops.sturm_eigenvalues_segmented(
        dp.cpu(), ep.cpu(), off.cpu(), length.cpu(), k=5, largest=largest)
    assert torch.equal(got.cpu(), ref)
    # Each segment's window is the window of its own band (kernel 1).
    win = st_ops.sturm_eigenvalues(d, e, window=(5, largest))
    _close(got.reshape(8, 5), win, TOL[dtype]["sturm"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_segmented_full_band_lanes_equal_the_sturm_window(cuda_device,
                                                         dtype):
    d, e = _bands(3, 5, 130, dtype, cuda_device)
    k = 9
    lo, hi = gershgorin_bounds(d, e)
    lanes = lambda x: x.unsqueeze(-1).expand(5, k).contiguous()  # noqa: E731
    targets = torch.arange(130 - k, 130, dtype=torch.int32,
                           device=cuda_device).expand(5, k).contiguous()
    got = st_kernel.sturm_segmented(
        d, e, lanes(lo), lanes(hi), lanes(_pivmin(d, e)),
        torch.zeros_like(targets), torch.full_like(targets, 130), targets,
        n_iter=64 if dtype == torch.float64 else 32)
    assert torch.equal(got, st_ops.sturm_eigenvalues(d, e, window=(k, True)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_bracketed_kernel_with_stale_brackets(cuda_device, dtype):
    d, e = _bands(9, 4, 60, dtype, cuda_device)
    lam = st_ops.sturm_eigenvalues(d, e, window=(6, True))
    lo, hi = interlace.rank1_update_brackets(lam, 0.0)
    lo[:2] += 5.0  # stale: these lanes fall back to Gershgorin
    hi[:2] += 5.0
    got = st_ops.sturm_eigenvalues_bracketed(d, e, lo, hi, k=6, largest=True)
    ref = st_ops.sturm_eigenvalues_bracketed(d.cpu(), e.cpu(), lo.cpu(),
                                             hi.cpu(), k=6, largest=True)
    assert torch.equal(got.cpu(), ref)
    _close(got, lam, TOL[dtype]["sturm"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_and_single_prod_diff_kernels_match_plain(cuda_device, dtype):
    rng = np.random.default_rng(11)
    lam = torch.as_tensor(rng.standard_normal((3, 40)), dtype=dtype,
                          device=cuda_device)
    mu = torch.as_tensor(rng.standard_normal((3, 70, 69)), dtype=dtype,
                         device=cuda_device)
    mask = torch.as_tensor(rng.random((3, 70, 69)) > 0.3, device=cuda_device)
    floor = torch.full((3,), 1e-6, dtype=dtype, device=cuda_device)
    before = (pd_kernel.logabs_sum_masked.launches,
              pd_kernel.logabs_sum_single.launches)
    got = pd_kernel.logabs_sum_masked(lam, mu, mask, floor)
    _close(got, pd_kernel.logabs_sum_masked_plain(lam, mu, mask, floor),
           TOL[dtype]["prod_diff"])
    one = pd_kernel.logabs_sum_single(lam[0], mu[0], floor[0])
    _close(one, pd_kernel.logabs_sum_single_plain(lam[0], mu[0], floor[0]),
           TOL[dtype]["prod_diff"])
    assert (pd_kernel.logabs_sum_masked.launches,
            pd_kernel.logabs_sum_single.launches) == (before[0] + 1,
                                                      before[1] + 1)
    # Masked cells add exactly 0: an all-valid mask is the unmasked kernel,
    # and the single-matrix kernel is the batched one's first matrix.
    assert torch.equal(
        pd_kernel.logabs_sum_masked(lam, mu, torch.ones_like(mask), floor),
        pd_kernel.logabs_sum(lam, mu, floor))
    assert torch.equal(one, pd_kernel.logabs_sum(lam, mu, floor)[0])


def test_session_on_card_matches_session_on_cpu(cuda_device):
    rng = np.random.default_rng(2)
    n, k = 40, 4
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    us = [rng.standard_normal(n) * 0.2 for _ in range(4)]
    plan = SolverPlan(method="eei_tridiag", backend="cuda",
                      precision="float64")
    results = {}
    for device in ("cuda", "cpu"):
        engine = SolverEngine(plan, device=device)
        session = engine.open_session(a, k)
        before = st_kernel.sturm_segmented.launches
        results[device] = [engine.update(session, Rank1Update(u, 1))
                           for u in us]
        stats = session.stats()
        results[device + " stats"] = {key: stats[key] for key in (
            "fast_updates", "full_resolves", "resolves_by_cause")}
        launched = st_kernel.sturm_segmented.launches - before
        assert launched == (session.stats()["fast_updates"]
                            if device == "cuda" else 0)
    assert results["cuda stats"] == results["cpu stats"]
    assert results["cuda stats"]["fast_updates"] >= 1
    for got, ref in zip(results["cuda"], results["cpu"]):
        _close(got.eigenvalues.cpu(), ref.eigenvalues, 1e-10)
        dots = (got.vectors.cpu() * ref.vectors).sum(-1).abs()
        assert float(dots.min()) >= 1 - 1e-6


def test_engine_on_card_matches_engine_on_cpu(cuda_device):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 70, 70))
    a = (a + np.swapaxes(a, 1, 2)) / 2
    plan = SolverPlan(backend="cuda")
    counts = (st_kernel.sturm_bisect.launches, pd_kernel.logabs_sum.launches)
    gpu = SolverEngine(plan).solve(a)
    assert st_kernel.sturm_bisect.launches == counts[0] + 2
    assert pd_kernel.logabs_sum.launches == counts[1] + 1
    cpu = SolverEngine(plan, device="cpu").solve(a)
    _close(gpu.eigenvalues.cpu(), cpu.eigenvalues, 1e-10)
    torch.testing.assert_close(gpu.magnitudes.cpu(), cpu.magnitudes,
                               rtol=1e-4, atol=1e-7)


def test_wrappers_raise_on_a_refused_launch(cuda_device):
    """A band too long for one block's shared memory is refused in Python,
    before any launch: there is no fallback to the plain version."""
    n = 20_000
    d = torch.zeros((1, n), dtype=torch.float64, device=cuda_device)
    e = torch.zeros((1, n - 1), dtype=torch.float64, device=cuda_device)
    bounds = torch.zeros((1, 3), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        st_kernel.sturm_bisect(d, e, bounds, target_base=0, m=1, n_iter=1)
