"""The packed top-k program of the port against repro's.

``repro_torch.packed_topk_program`` on the CPU (the kernel wrappers take
their plain versions) against ``repro.engine.engine.packed_topk_program``
(``jnp`` arrays, its segmented Sturm in Pallas interpret mode) on the same
numpy-made packed stacks: both chains (``eigh`` at row width 64, the
windowed tridiagonal chain at 256), float64 and float32, largest and
smallest, a uniform layout and a ragged one from ``pack_segments`` with
empty slots.  Also ``pack_segments`` and ``packed_plan_for`` against
``repro``'s.
"""

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from hypothesis_compat import given, settings, st  # noqa: E402
from test_torch_parity import DTYPES, align_rows, assert_close  # noqa: E402

from repro.engine import engine as r_engine  # noqa: E402
from repro.engine import plan as r_plan  # noqa: E402
from repro.kernels import blocks as r_blocks  # noqa: E402
from repro_torch import packed_plan_for, packed_topk_program  # noqa: E402
from repro_torch.kernels import blocks  # noqa: E402

K = 4
#: Eigenvalues: repro's Sturm tolerance (float64), its kernel tolerance in
#: float32 (tests/test_kernels.py:185), as (rtol, atol).
LAM_TOL = {"float64": (1e-9, 1e-9), "float32": (2e-5, 2e-5)}


def uniform_layout(seed, batch, row_n, seg_n):
    """``row_n // seg_n`` seeded symmetric requests a row
    (``repro``'s autotune._packed_uniform_layout)."""
    slots = row_n // seg_n
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((batch * slots, seg_n, seg_n))
    a = (a + np.swapaxes(a, 1, 2)) / 2
    rows = np.zeros((batch, row_n, row_n))
    for b in range(batch):
        for s in range(slots):
            o = s * seg_n
            rows[b, o:o + seg_n, o:o + seg_n] = a[b * slots + s]
    off = np.tile(np.arange(slots, dtype=np.int32) * seg_n, (batch, 1))
    length = np.full((batch, slots), seg_n, np.int32)
    return rows, off, length


def ragged_layout(seed, row_n, lengths, max_slots):
    """Requests of ``lengths`` packed first-fit by ``pack_segments``; rows
    with fewer than ``max_slots`` requests end in empty slots."""
    rng = np.random.default_rng(seed)
    packed = blocks.pack_segments(lengths, row_n, max_slots)
    rows = np.zeros((len(packed), row_n, row_n))
    off = np.zeros((len(packed), max_slots), np.int32)
    length = np.zeros((len(packed), max_slots), np.int32)
    for b, slots in enumerate(packed):
        for s, (_, o, n) in enumerate(slots):
            m = rng.standard_normal((n, n))
            rows[b, o:o + n, o:o + n] = (m + m.T) / 2
            off[b, s], length[b, s] = o, n
    return rows, off, length


def run_both(rows, off, length, dtype, largest):
    """The packed program of both packages on one stack, verified."""
    row_n = rows.shape[-1]
    r_prog = r_engine.packed_topk_program(
        r_plan.packed_plan_for(row_n, backend="pallas"), K, largest,
        verify=True)
    ref, ref_flags = r_prog(jnp.asarray(rows.astype(dtype)),
                            jnp.asarray(off), jnp.asarray(length))
    prog = packed_topk_program(packed_plan_for(row_n), K, largest,
                               verify=True)
    got, flags = prog(torch.as_tensor(rows.astype(dtype)),
                      torch.as_tensor(off), torch.as_tensor(length))
    return got, flags, ref, ref_flags


def valid_lanes(length, largest):
    """``(b, S, K)``: the lanes a request of ``seg_len`` reads."""
    clen = np.minimum(length, K)[..., None]
    t = np.arange(K)
    return t >= K - clen if largest else t < clen


def check_parity(rows, off, length, dtype, largest):
    got, flags, ref, ref_flags = run_both(rows, off, length, dtype, largest)
    assert got.eigenvalues.dtype == getattr(torch, dtype)
    rtol, atol = LAM_TOL[dtype]
    np.testing.assert_allclose(got.eigenvalues.double().numpy(),
                               np.asarray(ref.eigenvalues, np.float64),
                               rtol=rtol, atol=atol)
    # Vectors: the valid lanes, on the columns of their own segment (the
    # slice a request is served; what lies outside is held by the flags'
    # mass check, and its ~1e-7 (float64) stray amplitude is ill-conditioned
    # in both packages).
    valid = valid_lanes(length, largest)
    col = np.arange(rows.shape[-1])
    own = ((off[..., None] <= col) & (col < (off + length)[..., None]))
    own = np.broadcast_to(own[:, :, None, :], got.vectors.shape)
    vec = np.where(own, got.vectors.numpy(), 0)[valid]
    ref_vec = np.where(own, np.asarray(ref.vectors), 0)[valid]
    assert_close(align_rows(vec, ref_vec), ref_vec, "magnitudes", dtype)
    fields = ("ok", "finite", "residual_ok", "norm_ok", "ordered")
    if dtype == "float32" and rows.shape[-1] > 128:
        # The float32 tridiagonal chain leaves 3e-5 to 3e-3 of a vector's
        # mass outside its segment in both packages (a quotient of nearly
        # cancelled products); which slots cross norm_tol = 1e-3 depends on
        # rounding.  Both must fail only the mass check, and each lane's
        # stray mass must be of repro's order.
        fields = ("finite", "residual_ok", "ordered")
        for f in (flags, ref_flags):
            np.testing.assert_array_equal(np.asarray(f.ok),
                                          np.asarray(f.norm_ok))
        stray = [1 - np.einsum("bsp,bskp->bsk", own[:, :, 0].astype(float),
                               np.asarray(v, np.float64) ** 2)[valid]
                 for v in (got.vectors.numpy(), ref.vectors)]
        assert stray[0].max() < 10 * max(stray[1].max(), 1e-3)
    for field in fields:
        np.testing.assert_array_equal(getattr(flags, field).numpy(),
                                      np.asarray(getattr(ref_flags, field)),
                                      err_msg=field)
    return flags


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("row_n", [64, 256])
def test_packed_program_matches_repro_uniform(row_n, largest, dtype):
    rows, off, length = uniform_layout(row_n, 2, row_n, 16)
    flags = check_parity(rows, off, length, dtype, largest)
    assert bool((flags.finite & flags.residual_ok & flags.ordered).all())
    if dtype == "float64" or row_n <= 128:
        assert bool(flags.ok.all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("row_n", [64, 256])
def test_packed_program_matches_repro_ragged(row_n, largest, dtype):
    """First-fit rows of mixed lengths (1 to 32, some below K), aligned
    offsets with guard columns between them, and empty slots."""
    lengths = [30, 20, 33, 3, 1, 17, 2]
    rows, off, length = ragged_layout(row_n + 1, row_n, lengths, 4)
    assert (length == 0).any()
    check_parity(rows, off, length, dtype, largest)


def test_float32_packed_tridiag_misses_mass_in_both_packages():
    """A 512-wide float32 row of 16 requests of n = 32 (the smoke's packed
    shape): the windowed tridiagonal chain's minor-determinant vectors of
    some slots carry more than ``norm_tol`` of their mass outside the
    segment, and ``repro``'s do on the same slots, so both flag them (a
    server re-solves them); every other check passes."""
    rows, off, length = uniform_layout(512, 1, 512, 32)
    got, flags, ref, ref_flags = run_both(rows, off, length, "float32", True)
    np.testing.assert_array_equal(flags.ok.numpy(), np.asarray(ref_flags.ok))
    assert not bool(flags.ok.all())
    assert bool((flags.finite & flags.residual_ok & flags.ordered).all())
    np.testing.assert_array_equal(flags.ok.numpy(), flags.norm_ok.numpy())


@settings(max_examples=40, deadline=None)
@given(lengths=st.lists(st.integers(1, 48), min_size=1, max_size=24),
       max_slots=st.integers(1, 8))
def test_property_pack_segments_layout(lengths, max_slots):
    """``tests/test_server.py``'s property test of ``pack_segments``: every
    input once, aligned non-overlapping footprints inside the row, at most
    ``max_slots`` a row; and the same rows as ``repro``'s."""
    row_width = 64
    rows = blocks.pack_segments(lengths, row_width, max_slots, align=8)
    seen = []
    for row in rows:
        assert 1 <= len(row) <= max_slots
        end = 0
        for idx, off, length in row:
            seen.append(idx)
            assert length == lengths[idx]
            assert off % 8 == 0 and off >= end
            end = off + (-(-length // 8) * 8)
            assert end <= row_width
    assert sorted(seen) == list(range(len(lengths)))
    assert rows == r_blocks.pack_segments(lengths, row_width, max_slots,
                                          align=8)


def test_pack_segments_rejects_what_repro_rejects():
    for args in (([0], 64, 2), ([65], 64, 2), ([3], 4, 2), ([3], 64, 0)):
        with pytest.raises(ValueError):
            r_blocks.pack_segments(*args)
        with pytest.raises(ValueError):
            blocks.pack_segments(*args)


@pytest.mark.parametrize("row_n", [64, 128, 129, 512])
def test_packed_plan_for_picks_repro_chain(row_n, monkeypatch):
    """The chain ``repro`` picks on its static constants: the port has no
    calibration table yet (ROADMAP queue 1, item 10), and repro's default
    table was measured on a CPU."""
    from repro.engine import autotune as r_autotune

    monkeypatch.setattr(r_autotune, "get_table", lambda: None)
    ref = r_plan.packed_plan_for(row_n, backend="pallas")
    plan = packed_plan_for(row_n)
    assert (plan.method, plan.spectrum) == (ref.method, ref.spectrum)
    assert plan.backend == "cuda"
    assert packed_plan_for(row_n, backend="torch",
                           precision="float32").precision == "float32"


@pytest.mark.parametrize("backend", ["torch", "reference"])
def test_plain_backends_run_the_packed_chains(backend):
    """The ``torch`` and ``reference`` libraries' segmented stage (the
    plain bisection over the same lane layout) gives bitwise the ``cuda``
    library's answer on the CPU, and the same flags, on both chains."""
    for row_n in (64, 256):
        rows, off, length = uniform_layout(7, 1, row_n, 16)
        a = torch.as_tensor(rows)
        out = {}
        for name in ("cuda", backend):
            prog = packed_topk_program(packed_plan_for(row_n, backend=name),
                                       K, True, verify=True)
            out[name] = prog(a, torch.as_tensor(off), torch.as_tensor(length))
        (got, flags), (ref, ref_flags) = out[backend], out["cuda"]
        assert torch.equal(got.eigenvalues, ref.eigenvalues)
        assert torch.equal(flags.ok, ref_flags.ok) and bool(flags.ok.all())
