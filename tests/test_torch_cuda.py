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


def _degenerate_bands(dtype, device):
    """Bands that stress the bisection tree of kernel 1: repeated
    eigenvalues (copies of one block), e = 0 with repeated diagonal entries,
    n = 1, Wilkinson W+ (close pairs) and graded entries, each at scales
    from 1e-30 up (to 1e30 in float64; to 1e15 in float32, past which e^2
    overflows float32)."""
    rng = np.random.default_rng(17)
    n = 24
    blk = rng.standard_normal(8)
    blk_e = np.append(rng.standard_normal(7), 0.0)
    cases = [
        (np.tile(blk, 3), np.tile(blk_e, 3)[:n - 1]),
        (rng.integers(-2, 3, n).astype(float), np.zeros(n - 1)),
        (np.abs(np.arange(n) - (n - 1) / 2), np.ones(n - 1)),
        (rng.standard_normal(n) * 10.0 ** rng.uniform(-8, 8, n),
         rng.standard_normal(n - 1) * 10.0 ** rng.uniform(-8, 0, n - 1)),
        (np.full(n, 3.0), np.zeros(n - 1)),
    ]
    top = 30 if dtype == torch.float64 else 15
    d = np.stack([c[0] * s for c in cases for s in (1e-30, 1.0, 10.0 ** top)])
    e = np.stack([c[1] * s for c in cases for s in (1e-30, 1.0, 10.0 ** top)])
    return (torch.as_tensor(d, dtype=dtype, device=device),
            torch.as_tensor(e, dtype=dtype, device=device))


@pytest.mark.parametrize("dtype", DTYPES)
def test_sturm_kernel_is_bitwise_on_degenerate_bands(cuda_device, dtype):
    """Kernel 1 against its plain version, bitwise, on degenerate bands, in
    both of its geometries (a small launch splits lanes over blocks and
    takes three levels a round; a stack of many rows takes one block a
    row), for the full spectrum and windows at both ends, and for n = 1."""
    d, e = _degenerate_bands(dtype, cuda_device)
    iters = 64 if dtype == torch.float64 else 32
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    big = 3 * sms // d.shape[0] + 1
    stacks = {"small": (d, e), "large": (d.repeat(big, 1).contiguous(),
                                         e.repeat(big, 1).contiguous())}
    n = d.shape[1]
    for what, (dd, ee) in stacks.items():
        lo, hi = gershgorin_bounds(dd, ee)
        bounds = torch.stack([lo, hi, _pivmin(dd, ee)], dim=-1)
        for base, m in ((0, n), (0, 5), (n - 5, 5), (7, 9)):
            kw = dict(target_base=base, m=m, n_iter=iters)
            got = st_kernel.sturm_bisect(dd, ee, bounds, **kw)
            ref = st_kernel.sturm_bisect_plain(dd, ee, bounds, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (what, base, m)
    one = torch.full((3, 1), -2.5, dtype=dtype, device=cuda_device)
    none = torch.zeros((3, 0), dtype=dtype, device=cuda_device)
    lo, hi = gershgorin_bounds(one, none)
    bounds = torch.stack([lo, hi, _pivmin(one, none)], dim=-1)
    kw = dict(target_base=0, m=1, n_iter=iters)
    assert torch.equal(st_kernel.sturm_bisect(one, none, bounds, **kw),
                       st_kernel.sturm_bisect_plain(one, none, bounds, **kw))


@pytest.mark.parametrize("dtype", DTYPES)
def test_prod_diff_kernel_at_extreme_scales(cuda_device, dtype):
    """Kernel 2 (one log per cell) within its tolerance of the sum of logs
    on terms from the floor up to ~1e300 (1e30 in float32), with the
    spectral floor, a floor far below every term, and a zero floor (which
    takes the per-term log); masked trailing terms give bitwise the
    unmasked kernel on the prefix."""
    rng = np.random.default_rng(23)
    top = 300 if dtype == torch.float64 else 30

    def draw(shape):
        return np.sign(rng.standard_normal(shape)) * 10.0 ** rng.uniform(
            -30, top, shape)

    lam = np.sort(draw((3, 40)), -1)
    mu = draw((3, 37, 70))
    mu[:, :, :3] = lam[:, None, :3]
    mu[:, :, 3:6] = lam[:, None, :3] * (1 + 1e-12)
    lam = torch.as_tensor(lam, dtype=dtype, device=cuda_device)
    mu = torch.as_tensor(mu, dtype=dtype, device=cuda_device)
    tol = TOL[dtype]["prod_diff"]
    for floor in (pd_ops._floor_from_spectra(lam).contiguous(),
                  torch.full((3,), torch.finfo(dtype).tiny * 4, dtype=dtype,
                             device=cuda_device)):
        _close(pd_kernel.logabs_sum(lam, mu, floor),
               pd_kernel.logabs_sum_plain(lam, mu, floor), tol)
    floor = pd_ops._floor_from_spectra(lam).contiguous()
    for k_valid in (1, 31, 32, 33, 64):
        mask = torch.zeros(mu.shape, dtype=torch.bool, device=cuda_device)
        mask[:, :, :k_valid] = True
        got = pd_kernel.logabs_sum_masked(lam, mu, mask, floor)
        ref = pd_kernel.logabs_sum(lam, mu[:, :, :k_valid].contiguous(),
                                   floor)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), k_valid
    # A zero floor takes the per-term log.
    zero = torch.zeros((3,), dtype=dtype, device=cuda_device)
    got = pd_kernel.logabs_sum(lam, mu[:, :, 6:].contiguous(), zero)
    ref = pd_kernel.logabs_sum_plain(lam, mu[:, :, 6:].contiguous(), zero)
    _close(got, ref, tol)


def _packed_case(rng, lengths, dtype, scale, junction):
    """One packed row: segments of ``lengths`` (0: an empty slot), random
    or made of repeated blocks, junction off-diagonals 0 or ``junction``
    times a normal draw; the layout ``(off, length)``."""
    d, e = [], []
    for i, length in enumerate(lengths):
        if length == 0:
            continue
        if i % 2:  # repeated eigenvalues: one 2-block copied, e = 0 between
            blk = rng.standard_normal(2)
            sd = np.resize(blk, length)
            se = np.resize([rng.standard_normal(), 0.0], length - 1)
        else:
            sd = rng.standard_normal(length)
            se = rng.standard_normal(length - 1)
        if d:
            e.append(junction * rng.standard_normal())
        d.extend(sd)
        e.extend(se)
    off = np.cumsum([0] + list(lengths))[:-1]
    return (np.array(d) * scale, np.array(e) * scale, off,
            np.array(lengths))


def _segmented_cases(dtype):
    """The numpy model's cases (tests/test_torch_kernel_design.py), as
    card inputs: packed rows with empty slots, length-1 segments, repeated
    eigenvalues, zero and nonzero junctions, scales from 1e-19 to 1e150
    (1e30 in float32, past ~1e19 of which e^2 overflows), and the inputs
    whose lanes walk from column 0 (e^2 overflowing, an infinite entry,
    pivmin 0, an infinite bracket); each as ``(d, e, lanes, k)``.  Every
    output is finite, so that ``torch.equal`` compares all of it."""
    rng = np.random.default_rng(31)
    top = 150 if dtype == torch.float64 else 30
    cases = []
    for scale in (1e-19, 1.0, 1e10, 10.0 ** top):
        for junction in (0.0, 1e-3, 1.0):
            for lengths in ((5, 0, 1, 9, 3), (1, 1, 1, 1), (12, 7, 0, 0, 8)):
                d, e, off, length = _packed_case(rng, lengths, dtype, scale,
                                                 junction)
                for k, largest in ((3, True), (2, False)):
                    cases.append((d, e, off, length, k, largest, None))
    big = 1e200 if dtype == torch.float64 else 1e25
    for what in ("overflow", "inf", "pivmin0", "bracket"):
        d, e, off, length = _packed_case(rng, (6, 1, 7, 5), dtype, 1.0, 0.0)
        if what == "overflow":
            e[1] = e[2] = big
        cases.append((d, e, off, length, 3, True, what))
    out = []
    for d, e, off, length, k, largest, what in cases:
        dd = torch.as_tensor(d[None], dtype=dtype)
        ee = torch.as_tensor(e[None], dtype=dtype)
        lanes = st_ops.segmented_lanes(
            dd, ee, torch.as_tensor(off[None]), torch.as_tensor(length[None]),
            k=k, largest=largest)
        if what == "inf":  # after the brackets, which stay finite
            dd[0, 2] = float("inf")
        if what == "pivmin0":
            lanes["pivmin"].zero_()
        if what == "bracket":
            lanes["hi"][0, 6:] = float("inf")
        out.append((dd, ee, lanes, k))
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_segmented_kernel_is_bitwise_on_the_model_cases(cuda_device, dtype):
    """Kernel 3 (restart at the junction, a tree per block) against its
    plain version, bitwise, on the numpy model's cases and on warm per-lane
    brackets (the session's case, some stale), with and without the launch
    geometry's segment hint."""
    iters = 64 if dtype == torch.float64 else 32
    for d, e, lanes, k in _segmented_cases(dtype):
        ref = st_kernel.sturm_segmented_plain(d, e, **lanes, n_iter=iters)
        dev = {key: v.to(cuda_device) for key, v in lanes.items()}
        for hint in (0, k):
            got = st_kernel.sturm_segmented(
                d.to(cuda_device), e.to(cuda_device), **dev, n_iter=iters,
                segment_lanes=hint)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), ref), (tuple(d.shape), k, hint)
    d, e = _bands(13, 2, 16, dtype, "cpu")
    lam = st_ops.sturm_eigenvalues(d, e, window=(12, True))
    lo, hi = interlace.rank1_update_brackets(lam, 0.0, drift_bound=1e-3)
    lo[1, :3] += 4.0
    hi[1, :3] += 4.0
    lanes = st_ops.bracketed_lanes(d, e, lo, hi, k=12, largest=True)
    ref = st_kernel.sturm_segmented_plain(d, e, **lanes, n_iter=iters)
    got = st_kernel.sturm_segmented(
        d.to(cuda_device), e.to(cuda_device),
        **{key: v.to(cuda_device) for key, v in lanes.items()},
        n_iter=iters, segment_lanes=12)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("dtype", DTYPES)
def test_segmented_kernel_on_a_band_longer_than_shared_memory(cuda_device,
                                                             dtype):
    """A band too long for one block's shared memory (its walks read the
    band from device memory): bitwise its plain version, with one lane
    restarting at a zero junction.  Few iterations: the plain version takes
    a Python step a column."""
    n = 15_000 if dtype == torch.float64 else 30_000
    d, e = _bands(19, 1, n, dtype, cuda_device)
    e[0, n // 2 - 1] = 0.0
    m = 3
    lo, hi = gershgorin_bounds(d, e)
    lanes = {"lo": lo[:, None].expand(1, m).contiguous(),
             "hi": hi[:, None].expand(1, m).contiguous(),
             "pivmin": _pivmin(d, e)[:, None].expand(1, m).contiguous(),
             "start": torch.tensor([[0, n // 2, n - 5]], dtype=torch.int32,
                                   device=cuda_device),
             "end": torch.tensor([[n, n, n]], dtype=torch.int32,
                                 device=cuda_device),
             "targets": torch.tensor([[n - 1, 7, 2]], dtype=torch.int32,
                                     device=cuda_device)}
    iters = 6
    got = st_kernel.sturm_segmented(d, e, **lanes, n_iter=iters)
    ref = st_kernel.sturm_segmented_plain(d, e, **lanes, n_iter=iters)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def _uniform_layout(rng, batch, row_n, seg_n):
    """A uniform packed stack (``repro``'s autotune._packed_uniform_layout):
    ``row_n // seg_n`` seeded symmetric segments a row."""
    slots = row_n // seg_n
    a = rng.standard_normal((batch * slots, seg_n, seg_n))
    a = (a + np.swapaxes(a, 1, 2)) / 2
    rows = np.zeros((batch, row_n, row_n))
    for b in range(batch):
        for s in range(slots):
            o = s * seg_n
            rows[b, o:o + seg_n, o:o + seg_n] = a[b * slots + s]
    off = np.tile(np.arange(slots, dtype=np.int32) * seg_n, (batch, 1))
    length = np.full((batch, slots), seg_n, np.int32)
    return a, rows, off, length


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("row_n", [64, 256])
def test_packed_program_on_card(cuda_device, row_n, dtype):
    """``packed_topk_program`` on the card: both chains agree with eigvalsh
    of each request and pass their per-slot verify flags, but for the
    in-segment mass of some float32 slots of the tridiagonal chain, which
    repro misses on the same slots (tests/test_torch_packed.py); the
    windowed chain launches kernel 3 once, bitwise its plain version."""
    from repro_torch import packed_topk_program

    rng = np.random.default_rng(row_n)
    a, rows, off, length = _uniform_layout(rng, 4, row_n, 32)
    # Each chain named, whatever the card's calibration table picks.
    plan = (SolverPlan(method="eigh") if row_n <= 128 else
            SolverPlan(method="eei_tridiag", spectrum="windowed"))
    prog = packed_topk_program(plan, 8, True, verify=True)
    seg_calls = []
    seg = st_ops.sturm_segmented

    def capturing(d, e, **kw):
        out = seg(d, e, **kw)
        seg_calls.append((d, e, kw, out))
        return out

    st_ops.sturm_segmented = capturing
    try:
        before = st_kernel.sturm_segmented.launches
        res, flags = prog(torch.as_tensor(rows, dtype=dtype,
                                          device=cuda_device),
                          torch.as_tensor(off), torch.as_tensor(length))
        torch.cuda.synchronize()
        launched = st_kernel.sturm_segmented.launches - before
    finally:
        st_ops.sturm_segmented = seg
    assert bool((flags.finite & flags.residual_ok & flags.ordered).all())
    if not (dtype == torch.float32 and row_n > 128):
        assert bool(flags.ok.all())
    ref = np.linalg.eigvalsh(a)[:, -8:]
    got = res.eigenvalues.double().cpu().numpy().reshape(-1, 8)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-4 * scale)
    assert launched == (0 if row_n <= 128 else 1)
    for d, e, kw, out in seg_calls:
        assert torch.equal(out, st_kernel.sturm_segmented_plain(d, e, **kw))


# -- the dense and Krylov compositions ----------------------------------------


def _sym(rng, b, n, dtype, device):
    a = rng.standard_normal((b, n, n))
    return torch.as_tensor((a + np.swapaxes(a, 1, 2)) / 2, dtype=dtype,
                           device=device)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prod_diff_kernel_at_the_dense_shapes(cuda_device, dtype):
    """Kernel 2 at the shapes ``eei_dense`` gives it, (64, 64, 64, 63), and
    ``eei_dense_windowed`` with I = k, (64, 8, 64, 63): within tolerance of
    its plain version, the windowed rows bitwise the full table's; and the
    engine's windowed top-k launches it once, with I = k."""
    from repro_torch.core import identity

    a = _sym(np.random.default_rng(64), 64, 64, dtype, cuda_device)
    lam = torch.linalg.eigvalsh(a)
    mu = identity.minor_spectra(a)
    floor = pd_ops._floor_from_spectra(lam).contiguous()
    full = pd_kernel.logabs_sum(lam, mu, floor)
    _close(full, pd_kernel.logabs_sum_plain(lam, mu, floor),
           TOL[dtype]["prod_diff"])
    idx = torch.arange(56, 64, device=cuda_device)
    rows = pd_kernel.logabs_sum(lam[:, idx].contiguous(), mu, floor)
    assert rows.shape == (64, 8, 64)
    assert torch.equal(rows, full[:, idx])
    assert torch.equal(pd_ops.eei_magnitudes_windowed(lam, mu, idx),
                       pd_ops.eei_magnitudes_batched(lam, mu)[:, idx])
    shapes = []
    launch = pd_ops.logabs_sum_batched

    def capturing(lam_, mu_, floor_, **kw):
        shapes.append(tuple(lam_.shape) + tuple(mu_.shape[1:]))
        return launch(lam_, mu_, floor_, **kw)

    pd_ops.logabs_sum_batched = capturing
    try:
        before = pd_kernel.logabs_sum.launches
        eng = SolverEngine(SolverPlan(method="eei_dense", spectrum="windowed"))
        top = eng.topk(a, 8)
        eng.eigenvalues(a, k=8)
        assert pd_kernel.logabs_sum.launches == before + 1
    finally:
        pd_ops.logabs_sum_batched = launch
    assert shapes == [(64, 8, 64, 63)]
    ref = torch.linalg.eigvalsh(a.double())[:, -8:]
    _close(top.eigenvalues.double(), ref,
           1e-8 if dtype == torch.float64 else 1e-3)


def _capture_sturm_bisect():
    """Wrap ``kernels.sturm.ops``'s name for kernel 1's wrapper; returns the
    list the launches' operands and results go to, and the undo."""
    calls = []
    launch = st_ops.sturm_bisect

    def capturing(d, e, bounds, **kw):
        out = launch(d, e, bounds, **kw)
        calls.append((d, e, bounds, kw, out))
        return out

    st_ops.sturm_bisect = capturing

    def undo():
        st_ops.sturm_bisect = launch

    return calls, undo


@pytest.mark.parametrize("dtype", DTYPES)
def test_sturm_window_on_a_guard_filled_krylov_band(cuda_device, dtype):
    """Kernel 1's window on a Lanczos band with exactly-zero junctions (a
    rank-4 matrix breaks down and restarts) and guard-filled slots (it
    converges before m): bitwise its plain version, and the window holds
    the matrix's top eigenvalues, never a guard."""
    from repro_torch.linalg import lanczos

    rng = np.random.default_rng(3)
    low = rng.standard_normal((2, 48, 4))
    a = torch.as_tensor(low @ np.swapaxes(low, 1, 2), dtype=dtype,
                        device=cuda_device)
    res = lanczos.lanczos_partial(a, 40, 2, check_every=8,
                                  rtol=1e-4 if dtype == torch.float32
                                  else 1e-8)
    steps = res.steps.cpu()
    e_active = [res.e[b, :int(s) - 1] for b, s in enumerate(steps)]
    assert any(bool((x == 0).any()) for x in e_active)  # zero junctions
    assert bool((steps < 40).all())  # guard-filled tails
    calls, undo = _capture_sturm_bisect()
    try:
        win = st_ops.sturm_eigenvalues(res.d, res.e, window=(2, True))
    finally:
        undo()
    ((d, e, bounds, kw, out),) = calls
    assert torch.equal(out, st_kernel.sturm_bisect_plain(d, e, bounds, **kw))
    ref = torch.linalg.eigvalsh(a.double())[:, -2:]
    _close(win.double(), ref, 1e-9 if dtype == torch.float64 else 1e-3)


@pytest.mark.parametrize("method", ["eei_krylov", "eei_krylov_si"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sturm_inside_the_lanczos_residual_check(cuda_device, dtype, method):
    """Every kernel-1 launch of a Krylov top-k (the residual checks and the
    window on the band) is bitwise its plain version, and the card's result
    matches the CPU's (the same stopping decisions, so the same steps)."""
    from repro_torch.linalg import lanczos

    a = _sym(np.random.default_rng(11), 2, 200, dtype, cuda_device)
    plan = SolverPlan(method=method)
    calls, undo = _capture_sturm_bisect()
    steps = []
    partial = lanczos.lanczos_partial

    def counting(*args, **kw):
        res = partial(*args, **kw)
        steps.append(res.steps.cpu())
        return res

    lanczos.lanczos_partial = counting
    try:
        before = st_kernel.sturm_bisect.launches
        top = SolverEngine(plan).topk(a, 4)
        launched = st_kernel.sturm_bisect.launches - before
        cpu = SolverEngine(plan, device="cpu").topk(a.cpu(), 4)
    finally:
        undo()
        lanczos.lanczos_partial = partial
    card = [c for c in calls if c[0].is_cuda]
    assert launched == len(card) >= 2  # >= 1 check, and the window
    for d, e, bounds, kw, out in card:
        assert torch.equal(out, st_kernel.sturm_bisect_plain(d, e, bounds,
                                                             **kw))
    assert torch.equal(steps[0], steps[1])
    tol = 1e-9 if dtype == torch.float64 else 1e-3
    _close(top.eigenvalues.cpu(), cpu.eigenvalues, tol)
    dots = (top.vectors.cpu().double() * cpu.vectors.double()).sum(-1).abs()
    assert float(dots.min()) >= 1 - (1e-8 if dtype == torch.float64
                                     else 1e-3)


def test_dense_float32_topk_passes_verify_on_card(cuda_device):
    """cuSOLVER's float32 ``eigvalsh`` on the card is far enough off that
    inverse iteration's shifts miss and small components flip sign (the
    float32 windowed top-k of this stack read a residual of 1.06e-2 of
    ||A||_F); the cuda backend takes a float32 stack's dense spectra in
    float64, and every pair passes the verify stage."""
    from repro_torch.engine.engine import topk_program

    a = torch.as_tensor(_sym(np.random.default_rng(8), 64, 64, torch.float64,
                             "cpu"), dtype=torch.float32, device=cuda_device)
    for spectrum in ("windowed", "full"):
        plan = SolverPlan(method="eei_dense", spectrum=spectrum)
        res, flags = topk_program(plan, 8, True, verify=True)(a)
        assert bool(flags.ok.all()), flags
        assert res.eigenvalues.dtype == torch.float32


def test_fleet_of_two_replicas_on_card(cuda_device):
    """A 2-replica in-process ``EeiFleet`` with no ``device`` serves on the
    card: a small mixed stream under a named ``eei_tridiag`` plan launches
    kernels 1 and 2, every request lands on its rendezvous owner, and each
    result is within 5e-3 of float64 ``eigvalsh`` (``tests/test_fleet.py``'s
    tolerance)."""
    from repro_torch.engine import EeiFleet
    from repro_torch.engine.server import make_eei_stream
    from repro_torch.runtime import route_key

    stream = make_eei_stream(12, 32, 4, seed=3, mixed=True)
    counts = (st_kernel.sturm_bisect.launches, pd_kernel.logabs_sum.launches)
    with EeiFleet(2, server_kwargs=dict(
            plan=SolverPlan(method="eei_tridiag"), max_batch=4,
            record_dispatches=True)) as fleet:
        futs = [fleet.submit(a, k) for a, k in stream]
        results = [f.result(timeout=300) for f in futs]
        servers = {rid: r.driver._server
                   for rid, r in fleet._replicas.items()}
        assert all(s.device.type == "cuda" for s in servers.values())
        for rid, server in servers.items():
            for rec in server.dispatch_log:
                for req in rec.requests:
                    assert route_key((req.n, req.largest), [0, 1]) == rid
        stats = fleet.stats()
    assert stats["requests_completed"] == len(stream)
    assert stats["requests_failed"] == stats["redispatches"] == 0
    assert st_kernel.sturm_bisect.launches > counts[0]
    assert pd_kernel.logabs_sum.launches > counts[1]
    for (a, k), res in zip(stream, results):
        w = np.linalg.eigvalsh(a.astype(np.float64))[-k:]
        np.testing.assert_allclose(res.eigenvalues, w, rtol=5e-3, atol=5e-3)
        assert res.vectors.shape == (k, a.shape[0])


@pytest.mark.parametrize("dtype", DTYPES)
def test_two_device_mesh_solve_is_bitwise_its_plain_versions_per_shard(
        cuda_device, dtype, monkeypatch):
    """A solve on a logical 2x1 mesh of the card (the card twice): each
    stage launches once a shard on half of the padded stack, every kernel-1
    launch is bitwise and every kernel-2 launch within tolerance of its
    plain version on that shard's operands, and the result is within
    tolerance of the same solve on the CPU."""
    from repro_torch import make_local_mesh

    calls = {"sturm": [], "prod_diff": []}
    for module, attr, key in ((st_ops, "sturm_bisect", "sturm"),
                              (pd_ops, "logabs_sum_batched", "prod_diff")):
        def capturing(*args, _fn=getattr(module, attr), _key=key, **kwargs):
            out = _fn(*args, **kwargs)
            calls[_key].append((args, kwargs, out))
            return out

        monkeypatch.setattr(module, attr, capturing)
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 70, 70))
    a = torch.as_tensor((a + np.swapaxes(a, 1, 2)) / 2, dtype=dtype)
    mesh = make_local_mesh(2, 1, devices=[cuda_device, cuda_device])
    plan = SolverPlan(method="eei_tridiag", backend="sharded", mesh=mesh)
    gpu = SolverEngine(plan).solve(a)
    assert [tuple(args[0].shape) for args, _, _ in calls["sturm"]] == \
        [(2, 70)] * 2 + [(2 * 70, 69)] * 2
    assert [tuple(args[0].shape) for args, _, _ in calls["prod_diff"]] == \
        [(2, 70)] * 2
    for args, kwargs, got in calls["sturm"]:
        assert torch.equal(got, st_kernel.sturm_bisect_plain(*args, **kwargs))
    for args, kwargs, got in calls["prod_diff"]:
        _close(got, pd_kernel.logabs_sum_plain(*args, **kwargs),
               TOL[dtype]["prod_diff"])
    cpu = SolverEngine(SolverPlan(method="eei_tridiag"),
                       device="cpu").solve(a)
    tol = 1e-10 if dtype == torch.float64 else 2e-5
    _close(gpu.eigenvalues.cpu(), cpu.eigenvalues, tol)
    torch.testing.assert_close(
        gpu.magnitudes.cpu(), cpu.magnitudes,
        **(dict(rtol=1e-4, atol=1e-7) if dtype == torch.float64
           else dict(rtol=0.0, atol=2e-3)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["gemma2-2b", "whisper-large-v3"])
def test_lm_prefill_decode_on_the_card(cuda_device, arch, dtype):
    """The reduced model on the card against the same model on the CPU, the
    same weights (drawn on the CPU and copied): prefill's last logits, 4
    decode steps teacher-forced with the CPU's tokens, and every cache
    tensor, within tests/test_torch_lm.py's tolerances against repro (3e-4
    of max |x| in float32, 6e-2 in bfloat16)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.serve import lm_batch
    from repro_torch.models import LanguageModel
    from repro_torch.train.steps import cast_tree

    tol = 3e-4 if dtype == torch.float32 else 6e-2
    cfg = reduced_config(get_config(arch))
    host = LanguageModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(2))
    card = LanguageModel(cfg, device=cuda_device)
    card.load_state_dict(host.state_dict())
    runs = {}
    for model in (host, card):
        params = cast_tree(model.param_dict(), dtype)
        batch = lm_batch(cfg, 2, 40, 2, model.device)
        logits, caches = model.prefill(params, batch, 48)
        runs[model.device.type] = (model, params, [logits], caches)
    tok = runs["cpu"][2][0].argmax(-1)
    for i in range(4):
        for model, params, out, caches in runs.values():
            logits, _ = model.decode_step(params, caches,
                                          tok.to(model.device), 40 + i)
            out.append(logits)
        tok = runs["cpu"][2][-1].argmax(-1)

    def close(got, ref, what):
        got, ref = got.cpu().double(), ref.double()
        assert bool(torch.isfinite(got).all()), what
        err = float((got - ref).abs().max() / ref.abs().max())
        assert err <= tol, (arch, dtype, what, err)

    for i, (got, ref) in enumerate(zip(runs["cuda"][2], runs["cpu"][2])):
        close(got, ref, f"logits {i}")

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, list):
            return [x for t in tree for x in leaves(t)]
        return [tree]

    for j, (got, ref) in enumerate(zip(leaves(runs["cuda"][3]),
                                       leaves(runs["cpu"][3]))):
        assert got.dtype == ref.dtype == dtype
        close(got, ref, f"cache {j}")


def test_slstm_scan_replays_a_cuda_graph_a_step_on_the_card(cuda_device):
    """The sLSTM loop past ``GRAPH_MIN_STEPS`` (each step one replay of a
    CUDA graph, forward and its own backward) against the same loop on
    the CPU (eager steps): outputs, final carry and gradients within 1e-4
    of each one's max."""
    from repro_torch.models import xlstm

    cfg = xlstm.SLSTMConfig(64, 4)
    steps = 2 * xlstm.GRAPH_MIN_STEPS
    gen = torch.Generator().manual_seed(3)
    inputs = [torch.randn(2, steps, 256, generator=gen),
              torch.randn(4, 16, 64, generator=gen) * 0.25,
              torch.randn(256, generator=gen) * 0.1]
    weight = torch.randn(2, steps, 64, generator=gen)
    runs = []
    for dev in ("cpu", cuda_device):
        leaves = [x.to(dev).requires_grad_() for x in inputs]
        hs, carry = xlstm._slstm_scan(
            cfg, *leaves, xlstm.slstm_init_carry(cfg, 2, dev))
        grads = torch.autograd.grad((hs * weight.to(dev)).sum(), leaves)
        runs.append([x.detach().cpu() for x in (hs, *carry[:3], *grads)])
    for i, (got, ref) in enumerate(zip(runs[1], runs[0])):
        err = float((got - ref).abs().max() / ref.abs().max())
        assert err <= 1e-4, (i, err)


def test_train_step_on_the_card(cuda_device):
    """One reduced gemma2-2b EigenPre step on the card from the CPU's
    state: the refresh launches kernels 1 and 2 (twice and once for each
    eligible parameter), and the loss, the grad norm and the updated
    parameters agree with the same step on the CPU (loss 1e-5 relative,
    grad norm 1e-3 relative, parameters within 2 x lr: Adam's first step
    moves each weight by about lr * sign(g), so a weight whose gradient is
    rounding noise may step the other way)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_synthetic
    from repro_torch.models import LanguageModel
    from repro_torch.optim import AdamW, EigenPre
    from repro_torch.train import TrainState, make_train_step, put_batch

    cfg = reduced_config(get_config("gemma2-2b"))
    opt = EigenPre(adamw=AdamW(lr=1e-3))
    batch = make_synthetic(cfg, ShapeConfig("t", 32, 4, "train"),
                           seed=1).global_batch_at(0)
    runs = {}
    for dev in ("cpu", cuda_device):
        model = LanguageModel(cfg, device=dev).init(
            torch.Generator().manual_seed(1)) if dev == "cpu" else \
            LanguageModel(cfg, device=dev)
        if dev != "cpu":
            model.load_state_dict(runs["cpu"][0].state_dict())
        params = {k: v.clone() for k, v in model.stacked_dict().items()}
        state = TrainState(params, opt.init(params),
                           torch.zeros((), dtype=torch.int32))
        step = make_train_step(model, opt, torch.float32, microbatch=2)
        before = (st_kernel.sturm_bisect.launches,
                  pd_kernel.logabs_sum.launches)
        state, metrics = step(state, put_batch(batch, model.device))
        launched = (st_kernel.sturm_bisect.launches - before[0],
                    pd_kernel.logabs_sum.launches - before[1])
        runs[str(dev)] = (model, state, metrics, launched)
    _, host, m_host, l_host = runs["cpu"]
    _, card, m_card, l_card = runs[str(cuda_device)]
    eligible = [k for k, p in host.params.items() if opt._eligible(p)]
    assert l_host == (0, 0)
    assert l_card == (2 * len(eligible), len(eligible))
    np.testing.assert_allclose(float(m_card["loss"]), float(m_host["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m_card["grad_norm"]),
                               float(m_host["grad_norm"]), rtol=1e-3)
    for k, p in host.params.items():
        got = card.params[k].cpu()
        assert bool(torch.isfinite(got).all()), k
        assert float((got - p).abs().max()) <= 2 * opt.adamw.lr, k


@pytest.mark.parametrize("spec", ["1x2", "2x1", "1x3"])
def test_mesh_lm_serves_on_a_logical_mesh_of_the_card(cuda_device, spec):
    """Reduced gemma2-2b on a logical mesh of the card (the card repeated,
    ``build_programs``): prefill's last logits and 4 decode steps
    teacher-forced with the 1x1 path's tokens within 1e-5 of max |logit|
    of the 1x1 path on the card (``tests/test_torch_sharded_lm.py``'s
    float32 bound), the caches held as shards on the mesh."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.launch.serve import lm_batch
    from repro_torch.models import LanguageModel
    from repro_torch.sharding.placement import Sharded, put_tree
    from repro_torch.train.steps import build_programs

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = reduced_config(get_config("gemma2-2b"))
        model = LanguageModel(cfg, device=cuda_device).init(
            torch.Generator(device=cuda_device).manual_seed(2))
        batch = lm_batch(cfg, 2, 40, 2, cuda_device)
        params = model.param_dict()
        logits, caches = model.prefill(params, batch, 48)
        ref, toks = [logits], []
        for i in range(4):
            toks.append(ref[-1].argmax(-1))
            logits, caches = model.decode_step(params, caches, toks[-1],
                                               40 + i)
            ref.append(logits)
        mesh = parse_mesh(spec, cuda_device)
        progs = build_programs(model, mesh, compute_dtype=torch.float32)
        placed = put_tree(model.stacked_dict(), progs.state_shardings.params)
        logits, mcaches = progs.prefill(placed, batch, 48)
        got = [logits]
        for i, t in enumerate(toks):
            logits, mcaches = progs.decode_step(placed, mcaches, t, 40 + i)
            got.append(logits)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    leaf = mcaches[0]["b0:attn_local"]["k"]
    assert isinstance(leaf, Sharded) and leaf.shards[0][0].is_cuda
    for i, (g, r) in enumerate(zip(got, ref)):
        err = float((g.double() - r.double()).abs().max()
                    / r.double().abs().max())
        assert err <= 1e-5, (spec, i, err)


def test_mesh_train_step_launches_the_refresh_on_the_first_device(
        cuda_device):
    """One reduced gemma2-2b EigenPre step on a logical 2x1 mesh of the
    card under FSDP: the refresh on the gathered grams launches kernels 1
    and 2 (twice and once an eligible parameter), and the loss equals the
    1x1 step's within 1e-6 relative."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_synthetic
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.models import LanguageModel
    from repro_torch.optim import AdamW, EigenPre
    from repro_torch.sharding.placement import put_tree
    from repro_torch.train import TrainState, make_train_step, put_batch
    from repro_torch.train.steps import build_programs

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = reduced_config(get_config("gemma2-2b"))
        opt = EigenPre(adamw=AdamW(lr=1e-3))
        batch = put_batch(make_synthetic(cfg, ShapeConfig("t", 32, 4,
                                                          "train"), seed=1)
                          .global_batch_at(0), cuda_device)
        model = LanguageModel(cfg, device=cuda_device).init(
            torch.Generator(device=cuda_device).manual_seed(1))

        def fresh():
            params = {k: v.clone() for k, v in model.stacked_dict().items()}
            return TrainState(params, opt.init(params),
                              torch.zeros((), dtype=torch.int32))

        progs = build_programs(model, parse_mesh("2x1", cuda_device),
                               fsdp=True, optimizer=opt,
                               compute_dtype=torch.float32)
        state = put_tree(fresh(), progs.state_shardings)
        _, ref = make_train_step(model, opt, torch.float32)(fresh(), batch)
        before = (st_kernel.sturm_bisect.launches,
                  pd_kernel.logabs_sum.launches)
        state, metrics = progs.train_step(state, batch)
        launched = (st_kernel.sturm_bisect.launches - before[0],
                    pd_kernel.logabs_sum.launches - before[1])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    eligible = sum(g.shape[0] > 1 for g in state.opt_state.gram.values())
    assert eligible and launched == (2 * eligible, eligible)
    assert abs(float(metrics["loss"]) / float(ref["loss"]) - 1) <= 1e-6
