#!/usr/bin/env python3
"""Drive the repro_torch main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and ``nvcc``.
Phases, each of which fails the run (non-zero exit) on error:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` and print
   ``nvcc -Xptxas -v``'s registers and shared memory per kernel;
2. hold each kernel against its plain PyTorch version at the main path's
   shapes (b = 16 matrices of n = 600), in float64 and float32, and check
   the two bitwise contracts (a Sturm window equals the slice of the full
   spectrum; windowed prod-diff rows equal the full table's rows);
3. run ``SolverEngine`` on the ``cuda`` backend (solve, windowed and full
   top-k, eigenvalues full and windowed) with every launch count set to 0
   just before and read just after, and check each result against
   ``torch.linalg.eigh``;
4. time each kernel (CUDA events) beside its bound, its plain version and
   the library yardstick, split one solve into its stages, and time the
   end-to-end solve against ``torch.linalg.eigh``.

The line before the last holds the card's name and power limit; the one
before it the kernels' JSON record; the last line is the JSON verdict.
TF32 is off for matmul and cuDNN throughout, so float32 products run in
full float32.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

B, N, K = 16, 600, 8
SEED = 0
#: Kernel versus plain version: (rtol, atol) as in assert_allclose, from the
#: JAX package's own kernel tests (tests/test_kernels.py).
TOL = {
    ("sturm", "float64"): (1e-10, 1e-10), ("sturm", "float32"): (2e-5, 2e-5),
    ("prod_diff", "float64"): (1e-10, 1e-10),
    ("prod_diff", "float32"): (1e-4, 1e-4),
}
#: float32 solve: the largest relative 2-norm error of one magnitude row
#: against eigh's |v|^2.  At b=16, n=600 on an H100 the port's worst row
#: read 5.3e-2 and the uniform 1/n control's best row 0.77 (PERF.md); the
#: limit is about their geometric mean, a factor of ~4 from each.
F32_ROW_LIMIT = 0.2
#: Largest dense input of one eigvalsh call in the minor-stack yardstick.
LIBRARY_CHUNK_BYTES = 16e9
#: H100 SXM peaks (NVIDIA data sheet): non-tensor FP64 and FP32 rates and
#: the HBM3 rate.  Each operation is counted as one FLOP against them.
PEAK_OPS = {"float64": 34e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
#: Operations per Sturm recurrence step: a divide, two subtracts, an abs,
#: two compares, a select and an integer add.
STURM_OPS_PER_STEP = 8
#: Operations per prod-diff term: a subtract, an abs, a max, a log, an add.
PROD_DIFF_OPS_PER_TERM = 5


class PhaseError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off for matmul and cudnn")
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}, count "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    build.library()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
          f"({build.library_dir()})")
    report = (build.library_dir() / "ptxas.txt")
    if report.is_file():
        for line in report.read_text().splitlines():
            if ("registers" in line or "Compiling entry" in line
                    or "spill" in line or line.startswith("==")):
                print("[build] " + line.strip())
    print(f"[build] sturm_bisect dynamic shared memory per block: 2 n values, "
          f"{2 * N * 8} B in float64 and {2 * N * 4} B in float32 at n={N}")

    stack = _stack(torch, dev)
    kernels = _phase_kernels(torch, dev, stack)
    counts = _phase_engine(torch, dev, stack)
    records = _phase_timing(torch, dev, stack, kernels, counts)

    print(json.dumps({"kernels": records}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print("nvidia-smi: " + smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _stack(torch, dev):
    """Seeded (B, N, N) symmetric float64 stack on the card."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    a = rng.standard_normal((B, N, N))
    return torch.as_tensor((a + np.swapaxes(a, 1, 2)) / 2, device=dev)


def _events_ms(torch, fn, warmup: int, reps: int) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(torch, fn) -> float:
    """Time the card spent in kernels and copies during one call of ``fn``:
    the durations of torch.profiler's device-side events, 0.0 if it
    recorded none.  (Summing the ops' self device times instead would count
    a PyTorch kernel twice, under its op and under its own name.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3


def _max_err(torch, got, ref, rtol: float, atol: float, what: str) -> float:
    """Check ``|got - ref| <= atol + rtol |ref|`` (in float64) and finite
    values of the same shape; returns the largest absolute error."""
    torch.cuda.synchronize()
    check(got.shape == ref.shape, f"{what}: shape {tuple(got.shape)} != "
          f"{tuple(ref.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    err = (got.double() - ref.double()).abs()
    bad = err > atol + rtol * ref.double().abs()
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} entries outside "
          f"rtol={rtol} atol={atol}, max abs err {float(err.max())}")
    return float(err.max())


def _phase_kernels(torch, dev, stack):
    """Each kernel against its plain version, and the bitwise contracts."""
    from repro_torch.core import minors
    from repro_torch.kernels.prod_diff import kernel as pd_kernel
    from repro_torch.kernels.prod_diff import ops as pd_ops
    from repro_torch.kernels.sturm import kernel as st_kernel
    from repro_torch.kernels.sturm import ops as st_ops
    from repro_torch.linalg import householder
    from repro_torch.linalg.sturm import _pivmin, default_iters, gershgorin_bounds

    out = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        a = stack.to(dtype)
        d, e, _ = householder.tridiagonalize(a, with_q=False)
        iters = default_iters(dtype)

        def bounds_of(dd, ee):
            lo, hi = gershgorin_bounds(dd, ee)
            return torch.stack([lo, hi, _pivmin(dd, ee)], dim=-1)

        # Sturm, full spectrum (B, N).
        bnd = bounds_of(d, e)
        args = dict(target_base=0, m=N, n_iter=iters)
        lam = st_kernel.sturm_bisect(d, e, bnd, **args)
        torch.cuda.synchronize()
        t = time.perf_counter()
        lam_plain = st_kernel.sturm_bisect_plain(d, e, bnd, **args)
        torch.cuda.synchronize()
        spec_plain_ms = (time.perf_counter() - t) * 1e3
        spec_err = _max_err(torch, lam, lam_plain, *TOL[("sturm", name)],
                            f"sturm spectrum {name}")
        win = st_ops.sturm_eigenvalues(d, e, window=(K, True))
        check(torch.equal(win, st_ops.sturm_eigenvalues(d, e)[:, -K:]),
              f"sturm window != slice of the full spectrum ({name})")
        print(f"[kernels] sturm spectrum {name} ({B}, {N}): max abs err "
              f"{spec_err:.3e}; window (k={K}) bitwise-equal to the slice")

        # Sturm, all stacked minor bands (B*N, N-1), every row checked.
        dm, em = minors.all_tridiagonal_minor_bands(d, e)
        dm = dm.reshape(B * N, N - 1).contiguous()
        em = em.reshape(B * N, N - 2).contiguous()
        mbnd = bounds_of(dm, em)
        margs = dict(target_base=0, m=N - 1, n_iter=iters)
        mu = st_kernel.sturm_bisect(dm, em, mbnd, **margs)
        torch.cuda.synchronize()
        t = time.perf_counter()
        mu_plain = st_kernel.sturm_bisect_plain(dm, em, mbnd, **margs)
        torch.cuda.synchronize()
        minor_plain_ms = (time.perf_counter() - t) * 1e3
        minor_err = _max_err(torch, mu, mu_plain, *TOL[("sturm", name)],
                             f"sturm minor spectra {name}")
        print(f"[kernels] sturm minor spectra {name} ({B * N}, {N - 1}), all "
              f"rows: max abs err {minor_err:.3e}")

        # Prod-diff numerator table (B, N, N, N-1).
        mu = mu.reshape(B, N, N - 1)
        floor = pd_ops._floor_from_spectra(lam).contiguous()
        num = pd_kernel.logabs_sum(lam, mu, floor)
        torch.cuda.synchronize()
        t = time.perf_counter()
        num_plain = pd_kernel.logabs_sum_plain(lam, mu, floor)
        torch.cuda.synchronize()
        pd_plain_ms = (time.perf_counter() - t) * 1e3
        pd_err = _max_err(torch, num, num_plain, *TOL[("prod_diff", name)],
                          f"prod_diff {name}")
        idx = torch.arange(N - K, N, device=dev)
        check(torch.equal(pd_ops.eei_magnitudes_windowed(lam, mu, idx),
                          pd_ops.eei_magnitudes_batched(lam, mu)[:, idx]),
              f"windowed prod-diff rows != full-table rows ({name})")
        print(f"[kernels] prod_diff {name} ({B}, {N}, {N}, {N - 1}): max abs "
              f"err {pd_err:.3e}; windowed rows bitwise-equal to the table")

        out[name] = dict(
            d=d, e=e, bnd=bnd, dm=dm, em=em, mbnd=mbnd, lam=lam, mu=mu,
            floor=floor, iters=iters,
            err={"spectrum": spec_err, "minor": minor_err, "prod_diff": pd_err},
            plain_ms={"spectrum": spec_plain_ms, "minor": minor_plain_ms,
                      "prod_diff": pd_plain_ms})
    return out


def _check_solve(torch, a, res, name):
    lam_ref, v_ref = torch.linalg.eigh(a.double())
    lam, mags = res
    check(lam.dtype == a.dtype and mags.dtype == a.dtype, f"solve {name}: dtype")
    check(bool(torch.isfinite(mags).all()), f"solve {name}: non-finite")
    mags_ref = (v_ref * v_ref).transpose(-1, -2)
    norm2 = lam_ref.abs().amax(dim=-1, keepdim=True)
    if name == "float64":
        _max_err(torch, lam, lam_ref, 1e-6, 1e-8, f"solve {name} eigenvalues")
        _max_err(torch, mags, mags_ref, 1e-4, 1e-7, f"solve {name} magnitudes")
    else:
        err = (lam.double() - lam_ref).abs() / norm2
        check(float(err.max()) <= 2e-4, f"solve {name}: eigenvalue error "
              f"{float(err.max()):.3e} of ||A||_2 > 2e-4")
        # Each row of the table (one eigenvector's |v|^2) against eigh's, by
        # its relative 2-norm error.  A table of uniform 1/n rows is the
        # control: the limit must sit well below its best row, so that the
        # check fails a table that knows nothing of the eigenvectors.
        worst = float(_row_err(mags, mags_ref).max())
        control = _row_err(torch.full_like(mags_ref, 1.0 / N), mags_ref)
        print(f"[engine] solve {name}: magnitude rows vs eigh, relative "
              f"2-norm error: worst {worst:.3e}; uniform 1/n control: best "
              f"row {float(control.min()):.3e}, worst {float(control.max()):.3e}"
              f"; limit {F32_ROW_LIMIT:g}")
        check(float(control.min()) > F32_ROW_LIMIT,
              f"solve {name}: the uniform control passes the row limit")
        check(worst <= F32_ROW_LIMIT, f"solve {name}: a magnitude row is off "
              f"by {worst:.3e} (relative 2-norm) > {F32_ROW_LIMIT:g}")
    print(f"[engine] solve {name}: within tolerance of torch.linalg.eigh; max "
          f"eigenvalue error {float((lam.double() - lam_ref).abs().max()):.3e},"
          f" max magnitude error {float((mags.double() - mags_ref).abs().max()):.3e}")


def _row_err(mags, ref):
    """Per-row relative 2-norm error of a magnitude table, in float64."""
    ref = ref.double()
    return (mags.double() - ref).norm(dim=-1) / ref.norm(dim=-1)


def _check_topk(torch, a, res, name, what):
    lam_ref, v_ref = torch.linalg.eigh(a.double())
    lam, vecs = res
    check(tuple(vecs.shape) == (B, K, N), f"{what} {name}: shape")
    check(bool(torch.isfinite(vecs).all()), f"{what} {name}: non-finite")
    norm2 = lam_ref.abs().amax(dim=-1, keepdim=True)
    res_norm = (torch.einsum("bij,bkj->bki", a.double(), vecs.double())
                - lam.double()[..., None] * vecs.double()).norm(dim=-1)
    fro = a.double().norm(dim=(-2, -1))[:, None]
    if name == "float64":
        _max_err(torch, lam, lam_ref[:, -K:], 1e-6, 1e-8,
                      f"{what} {name} eigenvalues")
        ref = v_ref[..., -K:].transpose(-1, -2)
        err = torch.minimum((vecs - ref).abs().amax(-1),
                            (vecs + ref).abs().amax(-1))
        check(float(err.max()) < 1e-5, f"{what} {name}: vectors off by "
              f"{float(err.max()):.3e}")
    else:
        err = (lam.double() - lam_ref[:, -K:]).abs() / norm2
        check(float(err.max()) <= 2e-4, f"{what} {name}: eigenvalue error "
              f"{float(err.max()):.3e} of ||A||_2 > 2e-4")
        nrm = (vecs.double().norm(dim=-1) - 1).abs().max()
        check(float(nrm) <= 1e-4, f"{what} {name}: norms off by {float(nrm)}")
    # The residual bound of the JAX package's verify stage (engine/verify.py).
    worst = float((res_norm / fro).max())
    check(worst <= 2e-3, f"{what} {name}: residual {worst:.3e} of ||A||_F "
          f"> 2e-3")
    lam_err = float((lam.double() - lam_ref[:, -K:]).abs().max())
    print(f"[engine] {what} {name}: within tolerance of torch.linalg.eigh; "
          f"max eigenvalue error {lam_err:.3e}, worst residual {worst:.3e} "
          f"of ||A||_F")


def _check_eigenvalues(torch, a, lam, name, what, k=None):
    lam_ref = torch.linalg.eigvalsh(a.double())
    if k:
        lam_ref = lam_ref[:, -k:]
    if name == "float64":
        _max_err(torch, lam, lam_ref, 1e-6, 1e-8, f"{what} {name}")
    else:
        norm2 = lam_ref.abs().amax(dim=-1, keepdim=True)
        err = (lam.double() - lam_ref).abs() / norm2
        check(float(err.max()) <= 2e-4, f"{what} {name}: error "
              f"{float(err.max()):.3e} of ||A||_2 > 2e-4")
    print(f"[engine] {what} {name}: within tolerance of torch.linalg.eigh; "
          f"max error {float((lam.double() - lam_ref).abs().max()):.3e}")


def _reset_counts():
    from repro_torch.kernels.prod_diff.kernel import logabs_sum
    from repro_torch.kernels.sturm.kernel import sturm_bisect

    sturm_bisect.launches = 0
    logabs_sum.launches = 0


def _read_counts():
    from repro_torch.kernels.prod_diff.kernel import logabs_sum
    from repro_torch.kernels.sturm.kernel import sturm_bisect

    return {"sturm_bisect": sturm_bisect.launches,
            "logabs_sum": logabs_sum.launches}


def _phase_engine(torch, dev, stack):
    """The main path through the entry points a user calls."""
    from repro_torch import SolverEngine, plan_for

    shape = tuple(stack.shape)
    windowed = plan_for(shape, k=K)
    check((windowed.method, windowed.spectrum, windowed.backend)
          == ("eei_tridiag", "windowed", "cuda"),
          f"plan_for picked {windowed} for top-{K} of n={N}")
    full = plan_for(shape)
    check((full.method, full.backend) == ("eei_tridiag", "cuda"),
          f"plan_for picked {full} for the full table of n={N}")
    topk_full = plan_for(shape, k=K, spectrum="full")

    inputs = {name: stack.to(dt) for name, dt in
              (("float64", torch.float64), ("float32", torch.float32))}
    results, counts = {}, {}
    for name, a in inputs.items():
        _reset_counts()
        results[name] = {
            "solve": SolverEngine(full).solve(a),
            "topk windowed": SolverEngine(windowed).topk(a, K),
            "topk full": SolverEngine(topk_full).topk(a, K),
            "eigenvalues": SolverEngine(full).eigenvalues(a),
            "eigenvalues k": SolverEngine(full).eigenvalues(a, k=K),
        }
        torch.cuda.synchronize()
        counts[name] = _read_counts()
        print(f"[engine] launches on the main path, {name} (solve, topk "
              f"windowed, topk full, eigenvalues, eigenvalues k): "
              f"{counts[name]}")
        check(all(v > 0 for v in counts[name].values()),
              f"a kernel of the main path was never launched: {counts[name]}")

    for name, a in inputs.items():
        r = results[name]
        _check_solve(torch, a, r["solve"], name)
        _check_topk(torch, a, r["topk windowed"], name, "topk windowed")
        _check_topk(torch, a, r["topk full"], name, "topk full")
        _check_eigenvalues(torch, a, r["eigenvalues"], name, "eigenvalues")
        _check_eigenvalues(torch, a, r["eigenvalues k"], name,
                           "eigenvalues k", k=K)
    return counts


def _sturm_cost(rows, n, m, iters, elsize, dtype_name):
    ops = rows * m * iters * n * STURM_OPS_PER_STEP
    nbytes = (rows * n + rows * (n - 1) + rows * 3 + rows * m) * elsize
    return _bound(ops, nbytes, dtype_name)


def _bound(ops, nbytes, dtype_name):
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def _phase_timing(torch, dev, stack, kernels, counts):
    from repro_torch import SolverEngine, plan_for
    from repro_torch.engine.engine import ProgramSpec, program
    from repro_torch.kernels.prod_diff.kernel import logabs_sum
    from repro_torch.kernels.sturm.kernel import sturm_bisect
    from repro_torch.linalg.householder import tridiagonal_matrix

    plan = plan_for(tuple(stack.shape))
    per_solve = {}
    for name, kd in kernels.items():
        engine = SolverEngine(plan)
        a = stack.to(kd["d"].dtype)
        engine.solve(a)  # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        engine.solve(a)
        torch.cuda.synchronize()
        per_solve[name] = _read_counts()
        print(f"[timing] launches per solve {name}: {per_solve[name]}")

    records = []
    for name, kd in kernels.items():
        elsize = kd["d"].element_size()
        iters = kd["iters"]
        launches = (counts[name], per_solve[name])

        # Sturm, full spectrum; yardstick: eigvalsh of the dense tridiagonal.
        ms = _events_ms(torch, lambda: sturm_bisect(
            kd["d"], kd["e"], kd["bnd"], target_base=0, m=N, n_iter=iters),
            warmup=2, reps=20)
        dense = tridiagonal_matrix(kd["d"], kd["e"])
        lib_ms = _events_ms(torch, lambda: torch.linalg.eigvalsh(dense),
                            warmup=2, reps=10)
        del dense
        bound, by = _sturm_cost(B, N, N, iters, elsize, name)
        records.append(_record(
            f"sturm_bisect[spectrum {B}x{N} {name}]", "sturm", launches,
            kd["err"]["spectrum"], ms, kd["plain_ms"]["spectrum"], bound, by,
            lib_ms))

        # Sturm, all stacked minor bands; yardstick: eigvalsh of the dense
        # minor tridiagonals, in row chunks of at most LIBRARY_CHUNK_BYTES.
        ms = _events_ms(torch, lambda: sturm_bisect(
            kd["dm"], kd["em"], kd["mbnd"], target_base=0, m=N - 1,
            n_iter=iters), warmup=1, reps=3)
        lib_ms, calls, lib_err = _minor_library_ms(torch, kd)
        print(f"[timing] eigvalsh of the {B * N} dense minor tridiagonals "
              f"{name}: {lib_ms:.1f} ms in {calls} call(s); max abs "
              f"difference from the kernel's minor spectra {lib_err:.3e}")
        bound, by = _sturm_cost(B * N, N - 1, N - 1, iters, elsize, name)
        records.append(_record(
            f"sturm_bisect[minor_spectra {B * N}x{N - 1} {name}]", "sturm",
            launches, kd["err"]["minor"], ms, kd["plain_ms"]["minor"], bound,
            by, lib_ms))

        # Prod-diff numerator table; no single library call.
        ms = _events_ms(torch, lambda: logabs_sum(
            kd["lam"], kd["mu"], kd["floor"]), warmup=2, reps=10)
        terms = B * N * N * (N - 1)
        nbytes = (B * N + B * N * (N - 1) + B + B * N * N) * elsize
        bound, by = _bound(terms * PROD_DIFF_OPS_PER_TERM, nbytes, name)
        records.append(_record(
            f"logabs_sum[{B}x{N}x{N}x{N - 1} {name}]", "prod_diff", launches,
            kd["err"]["prod_diff"], ms, kd["plain_ms"]["prod_diff"], bound,
            by, None))

    print(f"[timing] bounds: {STURM_OPS_PER_STEP} operations per Sturm "
          f"recurrence step, {PROD_DIFF_OPS_PER_TERM} per prod-diff term, "
          f"against {PEAK_OPS['float64'] / 1e12:.0f} TFLOP/s (float64) and "
          f"{PEAK_OPS['float32'] / 1e12:.0f} TFLOP/s (float32); bytes against "
          f"{PEAK_BYTES / 1e12:.2f} TB/s")
    for r in records:
        print(f"[timing] {r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}"
              f" ms by {r['bound_by']}; plain {r['plain_ms']:.1f} ms; library "
              f"{'none' if r['library_ms'] is None else '%.4f ms' % r['library_ms']})")

    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        a = stack.to(dtype)
        engine = SolverEngine(plan)

        # Each stage's wall time, then the card's kernel time for a second
        # run of the same stage on the same state (torch.profiler): their
        # ratio is the share of the stage the device is busy.
        prog = program(plan, ProgramSpec("solve"))
        state = prog.initial_state(a)
        split, busy = {}, {}
        for sig, fn in prog.stages:
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(state)
            torch.cuda.synchronize()
            split[sig.role] = (time.perf_counter() - t) * 1e3
            busy[sig.role] = _device_ms(torch, lambda: fn(state))
            state.update(out)
        print(f"[timing] solve stages {name} (ms): " + ", ".join(
            f"{role} {v:.2f}" for role, v in split.items()))
        if sum(busy.values()) > 0:
            print(f"[timing] solve stages {name}, device busy (kernel ms, share"
                  f" of wall): " + ", ".join(
                      f"{role} {busy[role]:.2f} ({busy[role] / v:.0%})"
                      for role, v in split.items())
                  + f"; whole solve {sum(busy.values()) / sum(split.values()):.0%}")
        else:
            print(f"[timing] solve stages {name}, device busy: not measured "
                  f"(the profiler recorded no device time)")

        def wall(fn, reps=3):
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            return sorted(times)[len(times) // 2]

        solve_ms = wall(lambda: engine.solve(a))
        torch.linalg.eigh(a)
        eigh_ms = wall(lambda: torch.linalg.eigh(a))
        print(f"[timing] end to end {name} ({B}, {N}, {N}): SolverEngine.solve "
              f"{solve_ms:.2f} ms, torch.linalg.eigh {eigh_ms:.2f} ms "
              f"(median of 3)")
    return records


def _minor_library_ms(torch, kd):
    """``torch.linalg.eigvalsh`` on the dense minor tridiagonals of the main
    path's stack, the same function as the minor-spectra Sturm launch: the
    summed CUDA-event time of its calls over row chunks (one chunk where
    the dense stack fits in LIBRARY_CHUNK_BYTES), the number of calls, and
    the largest difference from the kernel's minor spectra."""
    dm, em, mu = kd["dm"], kd["em"], kd["mu"].reshape(B * N, N - 1)
    rows = max(1, int(LIBRARY_CHUNK_BYTES
                      // ((N - 1) ** 2 * dm.element_size())))

    def dense(lo, hi):
        t = dm.new_zeros((hi - lo, N - 1, N - 1))
        t.diagonal(dim1=-2, dim2=-1).copy_(dm[lo:hi])
        t.diagonal(1, dim1=-2, dim2=-1).copy_(em[lo:hi])
        t.diagonal(-1, dim1=-2, dim2=-1).copy_(em[lo:hi])
        return t

    torch.cuda.empty_cache()
    torch.linalg.eigvalsh(dense(0, B))  # warm-up
    total, calls, err = 0.0, 0, 0.0
    for lo in range(0, B * N, rows):
        hi = min(lo + rows, B * N)
        t = dense(lo, hi)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        w = torch.linalg.eigvalsh(t)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
        calls += 1
        err = max(err, float((w - mu[lo:hi]).abs().max()))
        del t, w
    torch.cuda.empty_cache()
    return total, calls, err


def _record(name, kind, launches, err, ms, plain_ms, bound_ms, bound_by,
            library_ms):
    """One kernel's entry of the JSON line.  ``launches`` is the wrapper's
    count over this dtype's main-path run (solve, two topk, two
    eigenvalues); ``launches_per_solve`` its count in one ``solve``.  The
    Sturm wrapper's count covers all its roles (spectrum, window, minor
    stack)."""
    main_path, per_solve = launches
    source, replaces, counter = {
        "sturm": ("src/repro_torch/kernels/csrc/sturm.cu",
                  "src/repro/kernels/sturm/kernel.py:197", "sturm_bisect"),
        "prod_diff": ("src/repro_torch/kernels/csrc/prod_diff.cu",
                      "src/repro/kernels/prod_diff/kernel.py:107",
                      "logabs_sum"),
    }[kind]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main_path[counter],
            "launches_per_solve": per_solve[counter],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


if __name__ == "__main__":
    sys.exit(main())
