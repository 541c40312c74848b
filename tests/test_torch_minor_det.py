"""The minor-determinant magnitudes kernel's wrapper and op on the CPU.

``kernels.minor_det``: on a CPU tensor the op runs the plain version,
``core.identity.tridiag_windowed_magnitudes``, bitwise, at the shapes its
callers give it; the wrapper refuses what the kernel does not take; the
``cuda`` library's ``minor_det_components`` and the Lanczos residual check
go through the op, the plain libraries do not.  ``csrc/minor_det.cu``
itself runs only on the card (``tests/test_torch_cuda.py``), so a model of
its threads, step for step (two sweeps a lane, a warp a row), is held
against the plain version here.  No JAX: ``identity``'s function is held
to ``repro``'s in ``tests/test_torch_linalg.py``.  Small n, one thread.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch import SolverEngine, SolverPlan, tracing
from repro_torch.core import identity
from repro_torch.engine.backends import (
    make_cuda_backend,
    make_reference_backend,
    make_torch_backend,
)
from repro_torch.kernels.minor_det import kernel as md_kernel
from repro_torch.kernels.minor_det import ops as md_ops
from repro_torch.linalg import lanczos

DTYPES = (torch.float64, torch.float32)


@pytest.fixture(autouse=True)
def one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _inputs(lead, n, k, dtype, zeros=False, seed=0):
    """Bands ``d (*lead, n)``, ``e (*lead, n-1)`` and shifts ``x (*lead,
    k)``.  With ``zeros`` every third ``e`` is exactly 0 and some shifts
    equal a diagonal entry, so a sweep meets ``q = 0`` at a decoupled block
    and the ``pivmin`` clamp fires."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal(lead + (n,))
    e = rng.standard_normal(lead + (n - 1,))
    x = np.sort(rng.uniform(-2.0, 2.0, lead + (k,)), axis=-1)
    if zeros:
        e[..., ::3] = 0.0
        x[..., ::2] = d[..., :1]
    return tuple(torch.as_tensor(a, dtype=dtype) for a in (d, e, x))


@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
@pytest.mark.parametrize("lead", [(3,), (2, 4)], ids=["b", "b_S"])
@pytest.mark.parametrize("n,zeros", [(1, False), (2, False), (16, False),
                                     (16, True), (128, False), (128, True),
                                     (600, False)])
def test_op_on_the_cpu_is_bitwise_the_plain_version(n, zeros, lead, dtype):
    d, e, x = _inputs(lead, n, 5, dtype, zeros)
    if zeros and n > 1:
        assert bool((d[..., :1] - x == 0).any())  # the clamp fires
    want = identity.tridiag_windowed_magnitudes(d, e, x)
    before = tracing.counts().get("minor_det_plain", 0)
    got = md_ops.tridiag_windowed_magnitudes(d, e, x)
    assert tracing.counts()["minor_det_plain"] == before + 1
    assert got.shape == lead + (5, n) and got.dtype == dtype
    assert torch.equal(got, want)
    assert bool(torch.isfinite(got).all())
    # The op takes views: a transposed-back copy is the same call.
    xt = x.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert torch.equal(md_ops.tridiag_windowed_magnitudes(d, e, xt), want)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    d, e, x = _inputs((2,), 8, 3, torch.float64)
    with pytest.raises(TypeError, match="float32 or float64"):
        md_kernel.minor_det(d.half(), e.half(), x.half())
    with pytest.raises(TypeError):
        md_kernel.minor_det(d, e.float(), x)
    with pytest.raises(ValueError, match="e must be"):
        md_kernel.minor_det(d, e[:, :-1].contiguous(), x)
    with pytest.raises(ValueError, match="x must be"):
        md_kernel.minor_det(d, e, x[:1].contiguous())
    with pytest.raises(ValueError, match="x must be"):
        md_kernel.minor_det(d, e, x[0].contiguous())
    with pytest.raises(ValueError, match="n >= 1"):
        md_kernel.minor_det(d[:, :0], e[:, :0], x)
    xt = torch.empty(3, 2, dtype=torch.float64).t()
    with pytest.raises(ValueError, match="contiguous"):
        md_kernel.minor_det(d, e, xt)
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros(1, 20_000, dtype=torch.float64)
        md_kernel.minor_det(big, big[:, 1:].contiguous(), x[:1])
    meta = [t.to("meta") for t in (d, e, x)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        md_kernel.minor_det(*meta)
    assert md_kernel.minor_det.launches == 0


@pytest.mark.parametrize("backend,plain", [
    ("reference", True), ("torch", True), ("cuda", False)])
def test_only_the_cuda_library_takes_the_op(backend, plain):
    factory = {"reference": make_reference_backend,
               "torch": make_torch_backend, "cuda": make_cuda_backend}
    lib = factory[backend](SolverPlan(method="eei_tridiag",
                                      spectrum="windowed"))
    want = (identity.tridiag_windowed_magnitudes if plain
            else md_ops.tridiag_windowed_magnitudes)
    assert lib.minor_det_components is want


@pytest.mark.parametrize("method", ["eei_tridiag", "eei_krylov"])
def test_cuda_top_k_on_the_cpu_takes_the_op_and_equals_reference(method):
    """The ``cuda`` backend's top-k on CPU tensors: the ``minor_det`` stage
    and each Lanczos residual check go through the op (counted as plain
    calls), with the ``reference`` backend's outputs.  Every backend shares
    the Lanczos loop, so only the stage tells the two apart."""
    g = torch.Generator().manual_seed(30)
    x = torch.randn(2, 40, 40, dtype=torch.float64, generator=g)
    a = x + x.transpose(-1, -2)
    plans = {b: SolverPlan(method=method, backend=b, spectrum="windowed",
                           krylov_m=32)
             for b in ("cuda", "reference")}
    tracing.reset()
    got = SolverEngine(plans["cuda"], device="cpu").topk(a, 3)
    calls = tracing.counts().get("minor_det_plain", 0)
    tracing.reset()
    want = SolverEngine(plans["reference"], device="cpu").topk(a, 3)
    checks = tracing.counts().get("minor_det_plain", 0)
    # The Krylov chain's one residual check, and the cuda stage.
    assert checks == (0 if method == "eei_tridiag" else 1)
    assert calls == checks + 1
    assert torch.equal(got.eigenvalues, want.eigenvalues)
    assert torch.equal(got.vectors, want.vectors)


def test_lanczos_check_counts_one_plain_call_a_check():
    g = torch.Generator().manual_seed(31)
    x = torch.randn(2, 48, 48, dtype=torch.float64, generator=g)
    a = x + x.transpose(-1, -2)
    tracing.reset()
    lanczos.lanczos_iterate(a, 40, window=(2, True), check_every=8)
    assert tracing.counts()["minor_det_plain"] == 40 // 8


# -- a model of csrc/minor_det.cu ------------------------------------------------


def _nan_max(a, b):
    return torch.where(torch.isnan(a) | (a > b), a, b)


def kernel_model(d, e, x, cap=md_kernel._LANES_PER_BLOCK,
                 threads=md_kernel._THREADS):
    """``csrc/minor_det.cu`` on ``d (rows, n)``, ``e (rows, n-1)``, ``x (rows,
    k)``, thread for thread: blocks of ``cap`` lanes; thread ``2l`` sweeps
    lane ``l`` forward into the output and ``2l + 1`` backward into the
    scratch, with the same index arithmetic, storing ``|q|``; the block
    takes the logs; the two threads add their prefix sums in order; then
    warp ``w`` takes rows ``w, w + warps, ...``: ``v = log_f + log_g``, the
    max, ``exp`` and a sum a thread over columns ``j = t mod 32`` in order,
    a butterfly across the warp, and the division.  The threads of a step
    are one vector op."""
    rows, n = d.shape
    k = x.shape[1]
    finfo = torch.finfo(d.dtype)
    out = torch.empty(rows, k, n, dtype=d.dtype)
    scratch = torch.empty_like(out)
    zero = torch.zeros((), dtype=d.dtype)
    for row in range(rows):
        sd = d[row]
        se2 = torch.cat([zero[None], e[row] * e[row]])
        scale = zero
        for v in torch.cat([sd.abs(), e[row].abs()]):
            scale = _nan_max(scale, v)
        pivmin = finfo.eps * finfo.eps * scale * scale
        pivmin = torch.where(pivmin < finfo.tiny, finfo.tiny, pivmin)
        for lane0 in range(0, k, cap):
            lanes = min(cap, k - lane0)
            tid = torch.arange(2 * lanes)
            back = tid & 1
            step = 1 - 2 * back
            start = torch.where(back == 1, n - 1, 0)
            lane = lane0 + (tid >> 1)
            xv = x[row, lane]
            terms = torch.empty(2 * lanes, n, dtype=d.dtype)
            if n > 1:  # the sweeps store |q|
                pos = start
                q = sd[pos] - xv
                q = torch.where(q.abs() < pivmin, -pivmin, q)
                terms[tid, pos + step] = q.abs()
                for _ in range(2, n):
                    pos = pos + step
                    q = (sd[pos] - xv) - se2[pos + back] / q
                    q = torch.where(q.abs() < pivmin, -pivmin, q)
                    terms[tid, pos + step] = q.abs()
            terms[tid, start] = 1.0  # no term there: log 1 = 0, not read
            terms = torch.log(terms)  # the block's log pass
            terms[tid, start] = 0.0
            acc = zero.expand(2 * lanes).clone()
            for s in range(1, n):  # the prefix sums, in order
                at = start + step * s
                acc = acc + terms[tid, at]
                terms[tid, at] = acc
            out[row, lane[back == 0]] = terms[back == 0]
            scratch[row, lane[back == 1]] = terms[back == 1]
            for r in range(lane0, lane0 + lanes):  # a warp a row
                v = out[row, r] + scratch[row, r]
                cols = [torch.arange(n)[t::32] for t in range(32)]
                vmax = torch.stack([
                    _nan_max_all(v[c], -math.inf, d.dtype) for c in cols])
                vmax = _butterfly(vmax, _nan_max)[0]
                w = torch.exp(v - vmax)
                part = torch.stack([_seq_sum(w[c], d.dtype) for c in cols])
                total = _butterfly(part, torch.add)[0]
                out[row, r] = w / total
    assert threads >= 2 * min(cap, k)
    return out


def _nan_max_all(v, init, dtype):
    m = torch.tensor(init, dtype=dtype)
    for y in v:
        m = _nan_max(m, y)
    return m


def _seq_sum(v, dtype):
    s = torch.zeros((), dtype=dtype)
    for y in v:
        s = s + y
    return s


def _butterfly(vals, op):
    """``v = op(v, shfl_xor(v, o))`` for ``o = 16, 8, 4, 2, 1``."""
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        vals = op(vals, vals[idx ^ o])
    assert bool((vals == vals[0]).all() | torch.isnan(vals).all())
    return vals


#: Model against the plain version: the same steps, but the log of a vector
#: may round another way than the log of the plain version's stacked
#: tensor, the row sum is taken in another order, and a float32 sum on the
#: host accumulates in float64.  A few units in the last place of the
#: largest log-sum, over the dtype's smallest normal number.
MODEL_RTOL = {torch.float64: 1e-12, torch.float32: 1e-4}


@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
@pytest.mark.parametrize("n,k,zeros", [(1, 3, False), (2, 3, False),
                                       (16, 12, True), (40, 70, False),
                                       (128, 8, True)])
def test_kernel_model_matches_the_plain_version(n, k, zeros, dtype):
    d, e, x = _inputs((2,), n, k, dtype, zeros, seed=n)
    got = kernel_model(d, e, x)
    want = identity.tridiag_windowed_magnitudes(d, e, x)
    tiny = torch.finfo(dtype).tiny
    torch.testing.assert_close(got, want, rtol=MODEL_RTOL[dtype], atol=tiny)
    if n == 1:
        assert torch.equal(got, want)
