#!/usr/bin/env python3
"""Drive the repro_torch paths on one NVIDIA card and check them.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and ``nvcc``.
Phases, each of which fails the run (non-zero exit) on error:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc``; print
   ``nvcc -Xptxas -v``'s registers, shared memory and spills per kernel, the
   instructions per recurrence step (Sturm) and per term (prod-diff) in the
   SASS of the kernels' inner loops (``cuobjdump -sass``), and the Sturm
   kernel's launch geometry at each of its shapes;
2. hold each kernel against its plain PyTorch version at the main path's
   shapes (b = 16 matrices of n = 600), in float64 and float32:
   - the Sturm kernel bitwise on the spectrum, the k = 8 window and all
     9600 minor bands, and the prod-diff kernel within its tolerance, also
     on terms from the floor up to ~1e300 (1e30 in float32); the two
     bitwise contracts (a Sturm window equals the slice of the full
     spectrum; windowed prod-diff rows equal the full table's rows);
   - the segmented Sturm kernel, bitwise, on the 16 bands packed 4 to a row
     and on the 9600 minor bands packed 4 to a row, and from warm brackets
     after a rank-1 update (some made stale on purpose); with one full-band
     segment it equals the Sturm kernel's window bitwise;
   - the masked (random per-matrix mask) and single-matrix prod-diff
     kernels;
3. run ``SolverEngine`` on the ``cuda`` backend (solve, windowed and full
   top-k, eigenvalues full and windowed) and check each result against
   ``torch.linalg.eigh``;
4. run the masked and single-matrix prod-diff kernels through their op
   entry points (``logabs_sum_batched(mask=)``, ``logabs_sum``,
   ``eei_magnitudes``) and check what they compute;
5. run a streaming session at n = 600, k = 8 (2 warm-up rank-1 updates, 32
   at 1% of ``||A||_F``, 2 at 60%) and check every step against float64
   ``eigvalsh`` and the verify stage: the stream must take the fast path
   with one segmented-Sturm launch per update, bitwise its plain version on
   each update's operands, and the large updates must force a drift
   re-solve, with no verify re-solve; the host rung may run only for a
   float32 re-solve after a large update, and only where the card's own
   re-solve of that matrix fails verify;
6. time each kernel (CUDA events) beside its bound, its plain version and
   the library yardstick (the Sturm kernel also on the k = 8 window, the
   segmented kernel also alone at the shape the session launches it), split
   one solve into its stages, and time the end-to-end solve against
   ``torch.linalg.eigh`` and the session update against a top-k from
   scratch.

Every launch count is set to 0 just before each of phases 3, 4 and 5 and
read just after, and a kernel that its path did not launch fails the run.
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
#: Segments packed to a row for the segmented Sturm kernel, and the rows of
#: the packed minor bands whose segments the eigvalsh yardstick takes (its
#: time is scaled to all rows).
SEG_S = 4
SEG_LIBRARY_ROWS = 64
#: Operations per segmented Sturm step beside the recurrence's: the two
#: compares of the step against the lane's segment.
SEGMENT_COMPARE_OPS = 2
#: The session stream (benchmarks/throughput.py:682-785): warm-up updates,
#: updates at ~1% of ||A||_F, then updates at ~60%; every step's eigenvalues
#: within SESSION_TOL of the spectral span of float64 eigvalsh.
SESSION_WARMUP, SESSION_STREAM, SESSION_BIG = 2, 32, 2
SESSION_TOL = 5e-3


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
    _kernel_report(build)
    from repro_torch.kernels.sturm.kernel import _geometry
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for what, rows, n, m in (("spectrum", B, N, N), ("window", B, N, K),
                             ("minor stack", B * N, N - 1, N - 1)):
        cap, threads = _geometry(rows, n, m, 8, sms)
        print(f"[build] sturm_bisect {what} {rows}x{m}: {cap} lanes and "
              f"{threads} threads a block, {-(-m // cap)} block(s) a row")

    stack = _stack(torch, dev)
    kernels = _phase_kernels(torch, dev, stack)
    segmented = _phase_segmented(torch, dev, stack, kernels)
    variants = _phase_prod_diff_variants(torch, dev, kernels)
    counts = _phase_engine(torch, dev, stack)
    op_counts = _phase_ops(torch, dev, kernels)
    sessions = _phase_session(torch, dev, stack)
    records = _phase_timing(torch, dev, stack, kernels, counts)
    records += _phase_timing_other_kernels(torch, dev, kernels, segmented, variants,
                                 op_counts, sessions)

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


#: SASS opcode classes for the per-step counts (the opcode up to its first
#: dot); anything else (branches, barriers, conversions) counts as "other".
SASS_CLASSES = {
    "fp64": {"DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET"},
    "fp32": {"FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "FSEL", "FCHK",
             "FSET"},
    "mufu": {"MUFU"},
    "integer": {"IADD3", "IADD", "VIADD", "IMAD", "IMUL", "ISETP", "LOP3",
                "PLOP3", "SEL", "SHF", "LEA", "IMNMX", "VIMNMX", "IABS",
                "PRMT", "MOV", "FLO", "POPC", "BMSK", "SGXT", "P2R", "R2P"},
    "memory": {"LDS", "STS", "LDG", "STG", "LDL", "STL", "LDC", "ULDC",
               "ATOMS", "LD", "ST"},
}
#: Kernel 1's and kernel 2's inner loops in the SASS: (label, mangled-name
#: keys tried in order, the opcode that marks one recurrence step or one
#: term, an opcode the loop must not hold).  A step has one IEEE divide (one
#: reciprocal seed), a term one multiply into the running product; the
#: prod-diff loop without a log (no MUFU) is the one-log-per-cell path.
SASS_LOOPS = (
    ("sturm_bisect float64, per step", ("sturm_bisect_kernelIdE",),
     "MUFU.RCP64H", None),
    ("sturm_bisect float32, per step", ("sturm_bisect_kernelIfE",),
     "MUFU.RCP", None),
    ("logabs_sum float64, per term", ("logabs_sum_kernelIdE",), "DMUL",
     "MUFU"),
    ("logabs_sum float32, per term", ("logabs_sum_kernelIfE",), "FMUL",
     "MUFU"),
)


def _cuda_tool(name):
    """Path of a CUDA toolkit program, or None."""
    import os
    import shutil

    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for path in ([Path(home) / "bin" / name] if home else []) + [
            Path(shutil.which(name) or "/nonexistent"),
            Path("/usr/local/cuda/bin") / name]:
        if path.is_file():
            return str(path)
    return None


def _kernel_short(mangled):
    """``sturm_bisect_kernel<double, 1>`` from a mangled kernel name."""
    import re

    m = re.search(r"([a-z_]+_kernel)I([fd])(?:Li(\d+)E)?", mangled)
    if not m:
        return mangled
    args = ["double" if m.group(2) == "d" else "float"] + (
        [m.group(3)] if m.group(3) else [])
    return f"{m.group(1)}<{', '.join(args)}>"


def _ptxas_summary(report):
    """Per kernel of ``nvcc -Xptxas -v``'s report: registers, static shared
    memory, stack frame and spill bytes."""
    import re

    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _kernel_short(m.group(1))
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers(?:, (\d+) bytes smem)?", line)
        if m:
            out[name].update(registers=int(m.group(1)),
                             smem=int(m.group(2) or 0))
    return out


def _sass_loop(sass, keys, marker, without=None):
    """Instructions per ``marker`` by class in the innermost loop (a
    backward branch) around the most ``marker`` opcodes, and no opcode
    starting with ``without``, of the first kernel whose mangled name holds
    one of ``keys``; None if there is none."""
    import re

    functions, body, pending = {}, None, []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            body = functions.setdefault(m.group(1), [])
            continue
        if body is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if m:
            t = re.search(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b", m.group(3))
            target = None
            if t:
                target = t.group(1) or int(t.group(2), 16)
            body.append((int(m.group(1), 16), m.group(2), target, pending))
            pending = []
    body = next((functions[f] for key in keys for f in functions if key in f),
                None)
    if body is None:
        return None
    index = {addr: i for i, (addr, *_rest) in enumerate(body)}
    index.update({lab: i for i, x in enumerate(body) for lab in x[3]})
    loops = []
    for i, (_, op, target, _) in enumerate(body):
        lo = index.get(target) if op.startswith("BRA") else None
        if lo is not None and lo < i:
            n_mark = sum(1 for x in body[lo:i + 1] if x[1] == marker)
            if n_mark and not (without and any(
                    x[1].startswith(without) for x in body[lo:i + 1])):
                loops.append((lo, i, n_mark))
    inner = [a for a in loops if not any(
        b != a and a[0] <= b[0] and b[1] <= a[1] for b in loops)]
    if not inner:
        return None
    lo, hi, n_mark = max(inner, key=lambda a: (a[2], a[0] - a[1]))
    # The fast path: a predicated forward branch inside the loop skips a
    # slow path (the IEEE divide's call for out-of-range operands), which is
    # not counted.
    skipped = set()
    for i in range(lo, hi + 1):
        _, op, target, _ = body[i]
        j = index.get(target) if op.startswith("BRA") else None
        if j is not None and i < j <= hi:
            skipped.update(range(i + 1, j))
    counts = {c: 0 for c in (*SASS_CLASSES, "other")}
    for i in range(lo, hi + 1):
        if i in skipped:
            continue
        op = body[i][1].split(".")[0]
        cls = next((c for c, ops in SASS_CLASSES.items() if op in ops),
                   "other")
        counts[cls] += 1
    counts["total"] = sum(counts.values())
    return {c: v / n_mark for c, v in counts.items()} | {
        "static": (hi + 1 - lo) / n_mark, "unrolled": n_mark}


def _kernel_report(build, tag="build"):
    """Print the ptxas figures of every kernel and the SASS counts of
    kernels 1 and 2's inner loops; returns both."""
    report = build.library_dir() / "ptxas.txt"
    ptxas = _ptxas_summary(report.read_text()) if report.is_file() else {}
    for name, v in ptxas.items():
        print(f"[{tag}] ptxas {name}: {v.get('registers')} registers, "
              f"{v.get('smem')} B static shared memory, {v.get('stack')} B "
              f"stack, spills {v.get('spill_stores')} B stored / "
              f"{v.get('spill_loads')} B loaded")
    tool = _cuda_tool("cuobjdump")
    sass = {}
    if tool is None:
        print(f"[{tag}] SASS counts: not measured (no cuobjdump)")
        return ptxas, sass
    text = subprocess.run(
        [tool, "-sass", str(build.library_dir() / build.LIB_NAME)],
        capture_output=True, text=True, timeout=300).stdout
    (build.library_dir() / "sass.txt").write_text(text)
    for label, keys, marker, without in SASS_LOOPS:
        sass[label] = _sass_loop(text, keys, marker, without)
        if sass[label] is None:
            print(f"[{tag}] SASS {label}: not measured (loop not found)")
            continue
        print(f"[{tag}] SASS {label} (inner loop, {sass[label]['unrolled']} "
              f"per pass; fast path, and all instructions as 'static'): "
              + ", ".join(f"{c} {v:.2f}" for c, v in sass[label].items()
                          if c != "unrolled"))
    return ptxas, sass


def _device_ms(torch, fn):
    """Time the card spent in kernels and copies during one call of ``fn``,
    and their number: the durations of torch.profiler's device-side events
    (0.0 and 0 if it recorded none).  (Summing the ops' self device times
    instead would count a PyTorch kernel twice, under its op and under its
    own name.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in device) / 1e3, len(device)


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

        # Sturm, full spectrum (B, N), and the k = K window, each bitwise its
        # plain version.
        bnd = bounds_of(d, e)
        args = dict(target_base=0, m=N, n_iter=iters)
        lam = st_kernel.sturm_bisect(d, e, bnd, **args)
        torch.cuda.synchronize()
        t = time.perf_counter()
        lam_plain = st_kernel.sturm_bisect_plain(d, e, bnd, **args)
        torch.cuda.synchronize()
        spec_plain_ms = (time.perf_counter() - t) * 1e3
        check(torch.equal(lam, lam_plain),
              f"sturm spectrum {name}: kernel != plain version")
        wargs = dict(target_base=N - K, m=K, n_iter=iters)
        win = st_kernel.sturm_bisect(d, e, bnd, **wargs)
        win_plain, win_plain_ms = _plain_ms(
            torch, lambda: st_kernel.sturm_bisect_plain(d, e, bnd, **wargs))
        check(torch.equal(win, win_plain),
              f"sturm window {name}: kernel != plain version")
        check(torch.equal(st_ops.sturm_eigenvalues(d, e, window=(K, True)),
                          st_ops.sturm_eigenvalues(d, e)[:, -K:]),
              f"sturm window != slice of the full spectrum ({name})")
        print(f"[kernels] sturm spectrum {name} ({B}, {N}) and window ({B}, "
              f"{K}): bitwise-equal to the plain version; the window "
              f"bitwise-equal to the slice")

        # Sturm, all stacked minor bands (B*N, N-1), every row bitwise.
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
        check(torch.equal(mu, mu_plain),
              f"sturm minor spectra {name}: kernel != plain version on "
              f"{int((mu != mu_plain).any(dim=1).sum())} rows")
        print(f"[kernels] sturm minor spectra {name} ({B * N}, {N - 1}): all "
              f"rows bitwise-equal to the plain version")
        spec_err, win_err, minor_err = (
            float((got - ref).abs().max())
            for got, ref in ((lam, lam_plain), (win, win_plain),
                             (mu, mu_plain)))

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
        ext_err = _prod_diff_extremes(torch, dev, dtype, name)

        out[name] = dict(
            d=d, e=e, bnd=bnd, dm=dm, em=em, mbnd=mbnd, lam=lam, mu=mu,
            floor=floor, iters=iters,
            err={"spectrum": spec_err, "minor": minor_err, "window": win_err,
                 "prod_diff": pd_err, "prod_diff_extremes": ext_err},
            plain_ms={"spectrum": spec_plain_ms, "minor": minor_plain_ms,
                      "window": win_plain_ms, "prod_diff": pd_plain_ms})
    return out


def _prod_diff_extremes(torch, dev, dtype, name):
    """The prod-diff kernel against its plain version on terms that run
    from the floor up to ~1e300 (1e30 in float32): magnitudes from 1e-30
    up, both signs, exact and near coincidences with ``lam``; also with a
    floor far below every term."""
    import numpy as np

    from repro_torch.core.identity import spectral_floor
    from repro_torch.kernels.prod_diff import kernel as pd_kernel

    rng = np.random.default_rng(SEED + 5)
    top = 300 if name == "float64" else 30
    b, i_n, j_n = 4, 40, 70

    def draw(shape):
        return np.sign(rng.standard_normal(shape)) * 10.0 ** rng.uniform(
            -30, top, shape)

    lam = np.sort(draw((b, i_n)), -1)
    mu = draw((b, j_n, N - 1))
    mu[:, :, :3] = lam[:, None, :3]
    mu[:, :, 3:6] = lam[:, None, :3] * (1 + 1e-12)
    lam = torch.as_tensor(lam, dtype=dtype, device=dev)
    mu = torch.as_tensor(mu, dtype=dtype, device=dev)
    worst = 0.0
    for floor in (spectral_floor(lam).contiguous(),
                  torch.full((b,), torch.finfo(dtype).tiny * 4, dtype=dtype,
                             device=dev)):
        got = pd_kernel.logabs_sum(lam, mu, floor)
        worst = max(worst, _max_err(
            torch, got, pd_kernel.logabs_sum_plain(lam, mu, floor),
            *TOL[("prod_diff", name)], f"prod_diff {name} extreme scales"))
    print(f"[kernels] prod_diff {name} ({b}, {i_n}, {j_n}, {N - 1}), terms "
          f"from the floor to ~1e{top}: max abs err {worst:.3e}")
    return worst


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


def _wrappers():
    """Every kernel wrapper, by the name of its launch count."""
    from repro_torch.kernels.prod_diff import kernel as pd
    from repro_torch.kernels.sturm import kernel as st

    return {"sturm_bisect": st.sturm_bisect,
            "sturm_segmented": st.sturm_segmented,
            "logabs_sum": pd.logabs_sum,
            "logabs_sum_masked": pd.logabs_sum_masked,
            "logabs_sum_single": pd.logabs_sum_single}


def _reset_counts():
    for wrapper in _wrappers().values():
        wrapper.launches = 0


def _read_counts():
    return {name: w.launches for name, w in _wrappers().items()}


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
        check(counts[name]["sturm_bisect"] > 0
              and counts[name]["logabs_sum"] > 0,
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
        path, solve = counts[name], per_solve[name]
        st_launches = dict(launches=path["sturm_bisect"],
                           launches_per_solve=solve["sturm_bisect"])

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
            f"sturm_bisect[spectrum {B}x{N} {name}]", "sturm",
            err=kd["err"]["spectrum"], ms=ms,
            plain_ms=kd["plain_ms"]["spectrum"], bound_ms=bound, bound_by=by,
            library_ms=lib_ms, **st_launches))

        # Sturm, the k = K window (windowed topk, eigenvalues(k)); the same
        # yardstick, which computes the whole spectrum.
        ms = _events_ms(torch, lambda: sturm_bisect(
            kd["d"], kd["e"], kd["bnd"], target_base=N - K, m=K,
            n_iter=iters), warmup=2, reps=20)
        bound, by = _sturm_cost(B, N, K, iters, elsize, name)
        records.append(_record(
            f"sturm_bisect[window {B}x{K} {name}]", "sturm",
            err=kd["err"]["window"], ms=ms, plain_ms=kd["plain_ms"]["window"],
            bound_ms=bound, bound_by=by, library_ms=lib_ms, **st_launches))

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
            err=kd["err"]["minor"], ms=ms, plain_ms=kd["plain_ms"]["minor"],
            bound_ms=bound, bound_by=by, library_ms=lib_ms, **st_launches))

        # Prod-diff numerator table; no single library call.
        ms = _events_ms(torch, lambda: logabs_sum(
            kd["lam"], kd["mu"], kd["floor"]), warmup=2, reps=10)
        terms = B * N * N * (N - 1)
        nbytes = (B * N + B * N * (N - 1) + B + B * N * N) * elsize
        bound, by = _bound(terms * PROD_DIFF_OPS_PER_TERM, nbytes, name)
        records.append(_record(
            f"logabs_sum[{B}x{N}x{N}x{N - 1} {name}]", "prod_diff",
            launches=path["logabs_sum"],
            launches_per_solve=solve["logabs_sum"],
            err=kd["err"]["prod_diff"], ms=ms,
            plain_ms=kd["plain_ms"]["prod_diff"], bound_ms=bound,
            bound_by=by, library_ms=None))

    print(f"[timing] bounds: {STURM_OPS_PER_STEP} operations per Sturm "
          f"recurrence step, {PROD_DIFF_OPS_PER_TERM} per prod-diff term, "
          f"against {PEAK_OPS['float64'] / 1e12:.0f} TFLOP/s (float64) and "
          f"{PEAK_OPS['float32'] / 1e12:.0f} TFLOP/s (float32); bytes against "
          f"{PEAK_BYTES / 1e12:.2f} TB/s")
    for r in records:
        _print_record(r)

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
            busy[sig.role] = _device_ms(torch, lambda: fn(state))[0]
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


def _print_record(r):
    library = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    print(f"[timing] {r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4g}"
          f" ms by {r['bound_by']}; plain {r['plain_ms']:.1f} ms; library "
          f"{library})")


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


def _pack(torch, d, e, seg):
    """Pack ``seg`` bands of ``d (b, n)``, ``e (b, n-1)`` to a row, with
    zero off-diagonals at the junctions: ``(b / seg, seg * n)`` bands and
    their segment layout ``seg_off``, ``seg_len``."""
    b, n = d.shape
    rows = b // seg
    dp = d.reshape(rows, seg * n).contiguous()
    ep = torch.zeros((rows, seg, n), dtype=e.dtype, device=e.device)
    ep[:, :, :n - 1] = e.reshape(rows, seg, n - 1)
    ep = ep.reshape(rows, seg * n)[:, :-1].contiguous()
    off = (torch.arange(seg, dtype=torch.int32, device=d.device) * n
           ).expand(rows, seg).contiguous()
    length = torch.full((rows, seg), n, dtype=torch.int32, device=d.device)
    return dp, ep, off, length


def _plain_ms(torch, fn):
    """One call of a plain version on the card: its result and wall ms."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def _phase_segmented(torch, dev, stack, kernels):
    """The segmented Sturm kernel against its plain version, bitwise, on
    packed bands and on warm brackets, and its contract with the Sturm
    kernel's window."""
    import numpy as np

    from repro_torch.kernels.sturm import kernel as st_kernel
    from repro_torch.kernels.sturm import ops as st_ops
    from repro_torch.linalg import householder, interlace
    from repro_torch.linalg.sturm import _pivmin, gershgorin_bounds

    out = {}
    for name, kd in kernels.items():
        d, e, iters = kd["d"], kd["e"], kd["iters"]
        tol = TOL[("sturm", name)]

        def both(dd, ee, lanes):
            got = st_kernel.sturm_segmented(dd, ee, **lanes, n_iter=iters)
            plain, ms = _plain_ms(
                torch, lambda: st_kernel.sturm_segmented_plain(
                    dd, ee, **lanes, n_iter=iters))
            return got, plain, ms

        # The 16 bands packed SEG_S to a row.
        dp, ep, off, length = _pack(torch, d, e, SEG_S)
        for largest in (True, False):
            lanes = st_ops.segmented_lanes(dp, ep, off, length, k=K,
                                           largest=largest)
            got, plain, _ = both(dp, ep, lanes)
            check(torch.equal(got, plain), f"sturm_segmented {name} "
                  f"({B // SEG_S}, {SEG_S * N}) largest={largest}: kernel "
                  f"!= plain version")
            win = st_ops.sturm_eigenvalues(d, e, window=(K, largest))
            err = _max_err(torch, got.reshape(B, K), win, *tol,
                           f"sturm_segmented {name} vs the bands' windows")
            print(f"[kernels] sturm_segmented {name} ({B // SEG_S}, "
                  f"{SEG_S * N}), S={SEG_S}, k={K}, largest={largest}: "
                  f"bitwise-equal to the plain version; max abs err against "
                  f"each band's Sturm window {err:.3e}")

        # The 9600 minor bands packed SEG_S to a row: the timed shape.
        dmp, emp, moff, mlen = _pack(torch, kd["dm"], kd["em"], SEG_S)
        lanes = st_ops.segmented_lanes(dmp, emp, moff, mlen, k=K,
                                       largest=True)
        mgot, plain, plain_ms = both(dmp, emp, lanes)
        check(torch.equal(mgot, plain), f"sturm_segmented {name} minor "
              f"bands {tuple(dmp.shape)}: kernel != plain version")
        plain_err = float((mgot - plain).abs().max())
        top = kd["mu"].reshape(B * N, N - 1)[:, -K:]
        err = _max_err(torch, mgot.reshape(B * N, K), top, *tol,
                       f"sturm_segmented {name} minor bands vs sturm_bisect")
        same = torch.equal(mgot.reshape(B * N, K), top)
        print(f"[kernels] sturm_segmented {name} minor bands "
              f"{tuple(dmp.shape)}, S={SEG_S}, k={K}: bitwise-equal to the "
              f"plain version; against sturm_bisect's minor spectra max abs "
              f"err {err:.3e} (bitwise: {same})")

        # Warm brackets after a rank-1 update A' = A + rho u u^T, the first
        # four matrices' brackets made stale on purpose.
        rng = np.random.default_rng(SEED + 1)
        a = stack.to(d.dtype)
        u = torch.as_tensor(rng.standard_normal((B, N)), dtype=d.dtype,
                            device=dev)
        u = u / u.norm(dim=-1, keepdim=True)
        fro = a.norm(dim=(-2, -1))
        rho = 0.01 * fro
        a2 = a + rho[:, None, None] * u[:, :, None] * u[:, None, :]
        d2, e2, _ = householder.tridiagonalize(a2, with_q=False)
        lo, hi = interlace.rank1_update_brackets(
            kd["lam"][:, -K:], rho, drift_bound=(1e-6 * fro)[:, None])
        lo[:4] += 5.0
        hi[:4] += 5.0
        blanes = st_ops.bracketed_lanes(d2, e2, lo, hi, k=K, largest=True)
        kept = (blanes["lo"] == lo) & (blanes["hi"] == hi)
        check(not bool(kept[:4].any()), "a stale bracket passed validation")
        check(int(kept[4:].sum()) >= (B - 4) * K // 2,
              f"only {int(kept[4:].sum())} warm brackets passed validation")
        got, plain, _ = both(d2, e2, blanes)
        check(torch.equal(got, plain),
              f"sturm_segmented {name} warm brackets: kernel != plain version")
        err = _max_err(torch, got, st_ops.sturm_eigenvalues(
            d2, e2, window=(K, True)), *tol,
            f"sturm_eigenvalues_bracketed {name} vs the Sturm window")
        print(f"[kernels] sturm_eigenvalues_bracketed {name} ({B}, {N}), "
              f"k={K}: {int(kept.sum())} of {B * K} warm brackets kept, the "
              f"{int((~kept).sum())} others (all stale ones among them) on "
              f"Gershgorin; bitwise-equal to the plain version; max abs err "
              f"against the updated bands' Sturm window {err:.3e}")

        # Contract: one full-band segment and the Gershgorin bracket give
        # the Sturm kernel's window, bitwise.
        glo, ghi = gershgorin_bounds(d, e)

        def lane(x):
            return x.unsqueeze(-1).expand(B, K).contiguous()

        targets = torch.arange(N - K, N, dtype=torch.int32,
                               device=dev).expand(B, K).contiguous()
        full = st_kernel.sturm_segmented(
            d, e, lane(glo), lane(ghi), lane(_pivmin(d, e)),
            torch.zeros_like(targets), torch.full_like(targets, N), targets,
            n_iter=iters)
        check(torch.equal(full, st_ops.sturm_eigenvalues(d, e,
                                                         window=(K, True))),
              f"sturm_segmented {name}: one full-band segment != the "
              f"sturm_bisect window")
        print(f"[kernels] sturm_segmented {name}: one full-band segment with "
              f"the Gershgorin bracket is bitwise the sturm_bisect window")
        out[name] = dict(dm=dmp, em=emp, lanes=lanes, got=mgot, iters=iters,
                         err=plain_err, plain_ms=plain_ms)
    return out


def _phase_prod_diff_variants(torch, dev, kernels):
    """The masked and single-matrix prod-diff kernels against their plain
    versions."""
    import numpy as np

    from repro_torch.kernels.prod_diff import kernel as pd_kernel

    out = {}
    for name, kd in kernels.items():
        lam, mu, floor = kd["lam"], kd["mu"], kd["floor"]
        tol = TOL[("prod_diff", name)]
        rng = np.random.default_rng(SEED + 2)
        mask = torch.as_tensor(rng.random((B, N, N - 1)) > 0.25, device=dev)
        got = pd_kernel.logabs_sum_masked(lam, mu, mask, floor)
        plain, masked_plain_ms = _plain_ms(
            torch, lambda: pd_kernel.logabs_sum_masked_plain(lam, mu, mask,
                                                             floor))
        masked_err = _max_err(torch, got, plain, *tol,
                              f"logabs_sum_masked {name}")
        lam0, mu0, floor0 = lam[0], mu[0], floor[0]
        one = pd_kernel.logabs_sum_single(lam0, mu0, floor0)
        plain, single_plain_ms = _plain_ms(
            torch, lambda: pd_kernel.logabs_sum_single_plain(lam0, mu0,
                                                             floor0))
        single_err = _max_err(torch, one, plain, *tol,
                              f"logabs_sum_single {name}")
        check(torch.equal(one, pd_kernel.logabs_sum(lam, mu, floor)[0]),
              f"logabs_sum_single {name} != logabs_sum's first matrix")
        print(f"[kernels] logabs_sum_masked {name} ({B}, {N}, {N}, {N - 1}), "
              f"random per-matrix mask ({int(mask.sum())} of {mask.numel()} "
              f"cells valid): max abs err {masked_err:.3e}; logabs_sum_single"
              f" {name} ({N}, {N}, {N - 1}): max abs err {single_err:.3e}, "
              f"bitwise logabs_sum's first matrix")
        out[name] = dict(mask=mask, masked_err=masked_err,
                         masked_plain_ms=masked_plain_ms,
                         single_err=single_err,
                         single_plain_ms=single_plain_ms)
    return out


def _phase_ops(torch, dev, kernels):
    """The masked and single-matrix kernels through their op entry points,
    with the counts set to 0 just before and read just after."""
    import numpy as np

    from repro_torch.kernels.prod_diff import ops as pd_ops
    from repro_torch.linalg.householder import tridiagonal_matrix

    counts = {}
    for name, kd in kernels.items():
        lam, mu, floor = kd["lam"], kd["mu"], kd["floor"]
        # Each matrix's valid block is its own: rows j < J_b, terms k < K_b.
        rng = np.random.default_rng(SEED + 3)
        j_b = rng.integers(N // 2, N + 1, size=B).tolist()
        k_b = rng.integers(N // 2, N, size=B).tolist()
        jj = torch.arange(N, device=dev)[None, :, None]
        kk = torch.arange(N - 1, device=dev)[None, None, :]
        ragged = ((jj < torch.tensor(j_b, device=dev)[:, None, None])
                  & (kk < torch.tensor(k_b, device=dev)[:, None, None]))
        _reset_counts()
        num = pd_ops.logabs_sum_batched(lam, mu, floor, mask=ragged)
        mags = pd_ops.eei_magnitudes(lam[0], mu[0])
        one = pd_ops.logabs_sum(lam[0], mu[0], floor[0])
        torch.cuda.synchronize()
        counts[name] = _read_counts()
        print(f"[ops] launches through the op entry points, {name} "
              f"(logabs_sum_batched(mask=), eei_magnitudes, logabs_sum): "
              f"{counts[name]}")
        check(counts[name]["logabs_sum_masked"] == 1
              and counts[name]["logabs_sum_single"] == 2,
              f"the op entry points did not launch their kernels: "
              f"{counts[name]}")
        # A masked cell adds exactly 0, so each matrix's rows are the
        # unmasked kernel's on its own valid block, bitwise.
        for b in range(B):
            ref = pd_ops.logabs_sum_batched(
                lam[b:b + 1], mu[b:b + 1, :j_b[b], :k_b[b]].contiguous(),
                floor[b:b + 1])
            check(torch.equal(num[b:b + 1, :, :j_b[b]], ref),
                  f"logabs_sum_batched(mask=) {name}, matrix {b}: != the "
                  f"unmasked kernel on its valid block")
        check(torch.equal(one, pd_ops.logabs_sum_batched(
            lam[:1], mu[:1], floor[:1])[0]),
            f"logabs_sum {name} != logabs_sum_batched's first matrix")
        # eei_magnitudes of the first band against eigh of its tridiagonal.
        t0 = tridiagonal_matrix(kd["d"][0], kd["e"][0]).double()
        w = torch.linalg.eigh(t0)[1]
        ref = (w * w).transpose(0, 1)
        batched = pd_ops.eei_magnitudes_batched(lam[:1], mu[:1])[0]
        _max_err(torch, mags, batched, *TOL[("prod_diff", name)],
                 f"eei_magnitudes {name} vs eei_magnitudes_batched")
        if name == "float64":
            err = _max_err(torch, mags, ref, 1e-4, 1e-7,
                           f"eei_magnitudes {name} vs eigh")
        else:
            worst = float(_row_err(mags, ref).max())
            check(worst <= F32_ROW_LIMIT, f"eei_magnitudes {name}: a row is "
                  f"off by {worst:.3e} (relative 2-norm) > {F32_ROW_LIMIT:g}")
            err = float((mags.double() - ref).abs().max())
        print(f"[ops] {name}: logabs_sum_batched(mask=) rows bitwise the "
              f"unmasked kernel's on each matrix's valid block; logabs_sum "
              f"bitwise logabs_sum_batched; eei_magnitudes of band 0 within "
              f"tolerance of eigh (max abs err {err:.3e})")
    return counts


def _phase_session(torch, dev, stack):
    """A streaming session on one n = 600 matrix of the stack, per dtype,
    every step checked against float64 eigvalsh and the verify stage."""
    import numpy as np

    from repro_torch import (Rank1Update, SessionConfig, SolverEngine,
                             SolverPlan, plan_for)
    from repro_torch.engine import session as session_mod
    from repro_torch.engine.verify import verify_topk_host
    from repro_torch.kernels.sturm import ops as st_ops
    from repro_torch.kernels.sturm.kernel import (sturm_segmented,
                                                  sturm_segmented_plain)

    # Every run of the host rung, with where in the stream it ran and the
    # matrix it was given.
    reseeds, where = [], {}
    host_reseed = session_mod.host_reseed

    def counted_reseed(session, a_new, *args, **kwargs):
        reseeds.append(dict(where, a=a_new.detach().cpu().numpy()))
        return host_reseed(session, a_new, *args, **kwargs)

    session_mod.host_reseed = counted_reseed
    out = {}
    try:
        for name in ("float64", "float32"):
            dtype = getattr(torch, name)
            a_np = stack[0].cpu().numpy()
            plan = SolverPlan(method="eei_tridiag", backend="cuda",
                              precision=name)
            engine = SolverEngine(plan)
            rng = np.random.default_rng(SEED + 4)
            fro = float(np.linalg.norm(a_np))
            small = np.sqrt(0.01 * fro / N)
            big = np.sqrt(0.6 * fro / N)
            span0 = None
            worst = 0.0

            def check_step(res, a_now, what):
                nonlocal span0, worst
                lam = np.linalg.eigvalsh(a_now)
                if span0 is None:
                    span0 = float(lam[-1] - lam[0])
                got = res.eigenvalues.double().cpu().numpy()
                vecs = res.vectors.double().cpu().numpy()
                rel = float(np.max(np.abs(got - lam[-K:]))) / span0
                worst = max(worst, rel)
                check(rel <= SESSION_TOL, f"session {name} {what}: eigenvalue "
                      f"error {rel:.3e} of the span > {SESSION_TOL:g}")
                flags = verify_topk_host(a_now, got, vecs)
                check(bool(flags.ok), f"session {name} {what}: verify failed "
                      f"({flags})")

            def update(scale, what):
                nonlocal a_np
                where["stage"] = what
                u = rng.standard_normal(N) * scale
                a_np = a_np + np.outer(u, u)
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = engine.update(session, Rank1Update(u, 1))
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t) * 1e3
                check_step(res, a_np, what)
                return ms

            where.update(dtype=name, stage="open")
            _reset_counts()
            session = engine.open_session(
                a_np, K, config=SessionConfig(drift_bound=0.5))
            check_step(session.result(), a_np, "open")
            check(session.dtype == dtype, f"session dtype {session.dtype}")
            for i in range(SESSION_WARMUP):
                update(small, f"warm-up {i}")
            fast0 = session.fast_updates
            seg0 = sturm_segmented.launches
            # Every segmented launch of the stream, with the operands the
            # tridiag_bracketed stage gave it and what it returned: held
            # against the plain version below, outside the counted run.
            seg_calls = []

            def capturing(d, e, *, n_iter, **lanes):
                got = sturm_segmented(d, e, **lanes, n_iter=n_iter)
                seg_calls.append((d, e, lanes, n_iter, got))
                return got

            st_ops.sturm_segmented = capturing
            try:
                times = [update(small, f"stream {i}")
                         for i in range(SESSION_STREAM)]
            finally:
                st_ops.sturm_segmented = sturm_segmented
            stream_fast = session.fast_updates - fast0
            stream_seg = sturm_segmented.launches - seg0
            for i in range(SESSION_BIG):
                update(big, f"large {i}")
            torch.cuda.synchronize()
            counts = _read_counts()
            stats = session.stats()
            mine = [r for r in reseeds if r["dtype"] == name]
            print(f"[session] {name} n={N} k={K} m_keep={stats['m_keep']}: "
                  f"{stats}; launches on the session path {counts}; host "
                  f"reseeds {[r['stage'] for r in mine]}; worst eigenvalue "
                  f"error {worst:.3e} of the span")
            check(stream_fast == SESSION_STREAM, f"session {name}: "
                  f"{stream_fast} of {SESSION_STREAM} stream updates took "
                  f"the fast path")
            check(stream_seg == SESSION_STREAM, f"session {name}: "
                  f"{stream_seg} segmented Sturm launches over "
                  f"{SESSION_STREAM} fast updates")
            check(counts["sturm_segmented"] == stats["fast_updates"],
                  f"session {name}: {counts['sturm_segmented']} segmented "
                  f"Sturm launches for {stats['fast_updates']} fast updates")
            check(len(seg_calls) == SESSION_STREAM, f"session {name}: "
                  f"{len(seg_calls)} segmented launches went through the "
                  f"bracketed op over {SESSION_STREAM} fast updates")
            for i, (d, e, lanes, n_iter, got) in enumerate(seg_calls):
                check(torch.equal(got, sturm_segmented_plain(
                    d, e, **lanes, n_iter=n_iter)),
                    f"session {name} stream {i}: the segmented Sturm kernel "
                    f"differs from its plain version on the update's "
                    f"{tuple(d.shape)} band, {tuple(got.shape)} lanes")
            d, e, lanes, n_iter, got = seg_calls[-1]
            print(f"[session] {name}: sturm_segmented bitwise its plain "
                  f"version on the operands of all {len(seg_calls)} stream "
                  f"updates (band {tuple(d.shape)}, lanes "
                  f"{tuple(got.shape)}, n_iter {n_iter}, segment "
                  f"[{int(lanes['start'].min())}, {int(lanes['end'].max())}))")
            causes = stats["resolves_by_cause"]
            check(causes.get("drift", 0) >= 1,
                  f"session {name}: the large updates forced no drift "
                  f"re-solve: {causes}")
            check("verify" not in causes,
                  f"session {name}: a fast update failed verify: {causes}")
            # The host rung may only have run where the session's own
            # re-solve could not pass verify: in float32, on the matrix a
            # large update left (a dominant eigenvalue takes the float32 EEI
            # components past the residual bound; repro's float32 re-solve
            # of this very matrix misses it with the same residual:
            # tests/test_torch_session.py::test_float32_resolve_of_the_chip_
            # smoke_matrix_misses_verify_in_both_packages).  Never in
            # float64, and never for the open, the warm-up or the stream.
            for r in mine:
                check(name == "float32" and r["stage"].startswith("large"),
                      f"session {name}: the host rung ran for {r['stage']}")
                a_r = torch.as_tensor(r["a"], dtype=dtype, device=dev)
                res = engine.topk(a_r, session.m_keep)
                flags = verify_topk_host(r["a"], res.eigenvalues.cpu().numpy(),
                                         res.vectors.cpu().numpy())
                check(not bool(flags.ok), f"session {name}: the host rung ran "
                      f"for {r['stage']} although the card's re-solve passes "
                      f"verify ({flags})")
                print(f"[session] {name}: the re-solve after {r['stage']} fell"
                      f" to the host rung: the card's top-{session.m_keep} of "
                      f"that matrix has residual {float(flags.residual):.3e} of"
                      f" ||A||_F > the verify bound; top eigenvalue "
                      f"{float(np.linalg.eigvalsh(r['a'])[-1]):.2f}, "
                      f"||A||_F {float(np.linalg.norm(r['a'])):.2f}")
            check(counts["sturm_bisect"] > 0 and counts["logabs_sum"] > 0,
                  f"session {name}: the re-solves ran no main-path kernel")

            # Latency: the warm update against a top-k from scratch (the
            # session's plan, and the windowed plan plan_for picks) and
            # torch.linalg.eigh, on the stream's last matrix.
            a_t = torch.as_tensor(a_np, dtype=dtype, device=dev)
            windowed = SolverEngine(plan_for(tuple(a_t.shape), k=K,
                                             precision=name))

            def wall(fn, reps=3):
                fn()
                times_ = []
                for _ in range(reps):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    times_.append((time.perf_counter() - t) * 1e3)
                return float(np.median(times_))

            lat = {"update_ms": float(np.median(times)),
                   "update_ms_min": float(np.min(times)),
                   "update_ms_max": float(np.max(times)),
                   "topk_scratch_ms": wall(lambda: engine.topk(a_t, K)),
                   "topk_windowed_ms": wall(lambda: windowed.topk(a_t, K)),
                   "eigh_ms": wall(lambda: torch.linalg.eigh(a_t))}
            print(f"[session] {name} latency (ms): warm update median "
                  f"{lat['update_ms']:.3f} (min {lat['update_ms_min']:.3f}, "
                  f"max {lat['update_ms_max']:.3f}, {SESSION_STREAM} updates)"
                  f"; engine.topk from scratch {lat['topk_scratch_ms']:.3f} "
                  f"(session plan), {lat['topk_windowed_ms']:.3f} (windowed "
                  f"plan); torch.linalg.eigh {lat['eigh_ms']:.3f} (median "
                  f"of 3)")
            _split_update(torch, dev, engine, session, rng, small, name)
            out[name] = dict(counts=counts, stats=stats, latency=lat,
                             reseeds=[r["stage"] for r in mine],
                             launches_per_update=stream_seg / SESSION_STREAM,
                             seg_call=seg_calls[-1])
    finally:
        session_mod.host_reseed = host_reseed
    return out


def _split_update(torch, dev, engine, session, rng, scale, name):
    """One more update of ``session``'s state (not committed) split into
    the update program's stages: wall ms (median of 5, synchronised around
    each), and the card's kernel ms and kernel count for one more run of
    the stage (torch.profiler)."""
    from repro_torch.engine.engine import update_program

    prog = update_program(engine.plan, session.k, session.largest,
                          session.m_keep, session.n_aug)
    u = torch.as_tensor(rng.standard_normal(N) * scale, dtype=session.dtype,
                        device=dev)
    rho = (u * u).sum().reshape(1)
    state = prog.initial_state(session.a[None], session.basis[None],
                               session.theta[None], (u / rho.sqrt())[None],
                               rho)
    parts = []
    for sig, fn in prog.stages:
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(state)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        busy, launched = _device_ms(torch, lambda: fn(state))
        state.update(out)
        parts.append(f"{sig.name} {sorted(times)[2]:.3f} ms ({launched} "
                     f"device events, {busy:.3f} ms busy)")
    print(f"[session] {name} one update by stage: " + "; ".join(parts))


def _phase_timing_other_kernels(torch, dev, kernels, segmented, variants, op_counts,
                      sessions):
    """Time the segmented Sturm, masked and single-matrix prod-diff kernels
    beside their bounds, plain versions and library yardsticks."""
    from repro_torch.kernels.prod_diff import kernel as pd_kernel
    from repro_torch.kernels.sturm import kernel as st_kernel
    from repro_torch.linalg.householder import tridiagonal_matrix

    records = []
    for name, kd in kernels.items():
        elsize = kd["d"].element_size()
        sg = segmented[name]
        dmp, emp, lanes, iters = sg["dm"], sg["em"], sg["lanes"], sg["iters"]
        rows, n_band = dmp.shape
        m = lanes["lo"].shape[1]
        ms = _events_ms(torch, lambda: st_kernel.sturm_segmented(
            dmp, emp, **lanes, n_iter=iters), warmup=1, reps=3)
        # What any implementation must do: the steps inside each lane's own
        # segment, with the segment compare.
        seg_steps = int((lanes["end"] - lanes["start"]).sum())
        ops = seg_steps * iters * (STURM_OPS_PER_STEP + SEGMENT_COMPARE_OPS)
        nbytes = ((rows * n_band + rows * (n_band - 1) + 4 * rows * m)
                  * elsize + 3 * rows * m * 4)
        bound, by = _bound(ops, nbytes, name)
        lib_ms, lib_err = _segment_library_ms(torch, kd, sg)
        print(f"[timing] eigvalsh of the dense segment tridiagonals of the "
              f"first {SEG_LIBRARY_ROWS} packed rows "
              f"({SEG_LIBRARY_ROWS * SEG_S} segments) {name}, scaled to all "
              f"{rows} rows: {lib_ms:.1f} ms; max abs difference from the "
              f"kernel's lanes {lib_err:.3e}")
        whole_band = rows * m * iters * n_band * (
            STURM_OPS_PER_STEP + SEGMENT_COMPARE_OPS)
        print(f"[timing] sturm_segmented {name}: the whole-band recurrence "
              f"runs {whole_band / ops:.2f}x the steps inside the segments")
        records.append(_record(
            f"sturm_segmented[minor bands packed {rows}x{n_band} S={SEG_S} "
            f"k={K} {name}]", "sturm_segmented",
            launches=sessions[name]["counts"]["sturm_segmented"],
            err=sg["err"], ms=ms, plain_ms=sg["plain_ms"], bound_ms=bound,
            bound_by=by, library_ms=lib_ms,
            launches_per_update=sessions[name]["launches_per_update"]))

        # Kernel 3 alone at the shape the session launches it: the last
        # stream update's band and lanes (bitwise its plain version, checked
        # in the session phase); yardstick: eigvalsh of the dense band.
        d1, e1, lanes1, it1, got1 = sessions[name]["seg_call"]
        rows1, n1 = d1.shape
        m1 = lanes1["lo"].shape[1]
        ms = _events_ms(torch, lambda: st_kernel.sturm_segmented(
            d1, e1, **lanes1, n_iter=it1), warmup=5, reps=200)
        plain1, plain_ms = _plain_ms(
            torch, lambda: st_kernel.sturm_segmented_plain(d1, e1, **lanes1,
                                                           n_iter=it1))
        seg_steps = int((lanes1["end"] - lanes1["start"]).sum())
        ops = seg_steps * it1 * (STURM_OPS_PER_STEP + SEGMENT_COMPARE_OPS)
        nbytes = ((rows1 * n1 + rows1 * (n1 - 1) + 4 * rows1 * m1) * elsize
                  + 3 * rows1 * m1 * 4)
        bound, by = _bound(ops, nbytes, name)
        dense = tridiagonal_matrix(d1, e1)
        lib_ms = _events_ms(torch, lambda: torch.linalg.eigvalsh(dense),
                            warmup=2, reps=20)
        records.append(_record(
            f"sturm_segmented[session band {rows1}x{n1}, {m1} lanes {name}]",
            "sturm_segmented",
            launches=sessions[name]["counts"]["sturm_segmented"],
            err=float((got1 - plain1).abs().max()), ms=ms,
            plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=lib_ms,
            launches_per_update=sessions[name]["launches_per_update"]))

        vd = variants[name]
        lam, mu, floor, mask = kd["lam"], kd["mu"], kd["floor"], vd["mask"]
        ms = _events_ms(torch, lambda: pd_kernel.logabs_sum_masked(
            lam, mu, mask, floor), warmup=2, reps=10)
        terms = N * int(mask.sum())
        nbytes = (B * N + B * N * (N - 1) + B + B * N * N) * elsize \
            + B * N * (N - 1)
        bound, by = _bound(terms * PROD_DIFF_OPS_PER_TERM, nbytes, name)
        records.append(_record(
            f"logabs_sum_masked[{B}x{N}x{N}x{N - 1} random mask {name}]",
            "prod_diff_masked",
            launches=op_counts[name]["logabs_sum_masked"],
            err=vd["masked_err"], ms=ms, plain_ms=vd["masked_plain_ms"],
            bound_ms=bound, bound_by=by, library_ms=None))

        lam0, mu0, floor0 = lam[0], mu[0], floor[0]
        ms = _events_ms(torch, lambda: pd_kernel.logabs_sum_single(
            lam0, mu0, floor0), warmup=2, reps=20)
        nbytes = (N + N * (N - 1) + 1 + N * N) * elsize
        bound, by = _bound(N * N * (N - 1) * PROD_DIFF_OPS_PER_TERM, nbytes,
                           name)
        records.append(_record(
            f"logabs_sum_single[{N}x{N}x{N - 1} {name}]", "prod_diff_single",
            launches=op_counts[name]["logabs_sum_single"],
            err=vd["single_err"], ms=ms, plain_ms=vd["single_plain_ms"],
            bound_ms=bound, bound_by=by, library_ms=None))
    for r in records:
        _print_record(r)
    return records


def _segment_library_ms(torch, kd, sg):
    """``torch.linalg.eigvalsh`` of the dense segment tridiagonals of the
    first SEG_LIBRARY_ROWS packed rows (minor bands 0 .. SEG_S * rows - 1),
    the same function as the segmented launch there: its CUDA-event time
    scaled to all rows, and the largest difference of its top K eigenvalues
    from the kernel's lanes."""
    dm, em = kd["dm"], kd["em"]
    count = SEG_LIBRARY_ROWS * SEG_S
    t = dm.new_zeros((count, N - 1, N - 1))
    t.diagonal(dim1=-2, dim2=-1).copy_(dm[:count])
    t.diagonal(1, dim1=-2, dim2=-1).copy_(em[:count])
    t.diagonal(-1, dim1=-2, dim2=-1).copy_(em[:count])
    torch.linalg.eigvalsh(t[:SEG_S])  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    w = torch.linalg.eigvalsh(t)
    end.record()
    torch.cuda.synchronize()
    rows = sg["dm"].shape[0]
    got = sg["got"][:SEG_LIBRARY_ROWS].reshape(count, K)
    err = float((w[:, -K:] - got).abs().max())
    del t, w
    torch.cuda.empty_cache()
    return start.elapsed_time(end) * rows / SEG_LIBRARY_ROWS, err


#: Kernel kind -> (CUDA source, the TPU kernel's pallas_call it replaces).
_SOURCES = {
    "sturm": ("src/repro_torch/kernels/csrc/sturm.cu",
              "src/repro/kernels/sturm/kernel.py:197"),
    "sturm_segmented": ("src/repro_torch/kernels/csrc/sturm_segmented.cu",
                        "src/repro/kernels/sturm/kernel.py:159"),
    "prod_diff": ("src/repro_torch/kernels/csrc/prod_diff.cu",
                  "src/repro/kernels/prod_diff/kernel.py:107"),
    "prod_diff_masked": ("src/repro_torch/kernels/csrc/prod_diff.cu",
                         "src/repro/kernels/prod_diff/kernel.py:187"),
    "prod_diff_single": ("src/repro_torch/kernels/csrc/prod_diff.cu",
                         "src/repro/kernels/prod_diff/kernel.py:251"),
}


def _record(name, kind, launches, err, ms, plain_ms, bound_ms, bound_by,
            library_ms, **extra):
    """One kernel's entry of the JSON line.  ``launches`` is the wrapper's
    count over this dtype's run of the kernel's path: the main path (solve,
    two topk, two eigenvalues) for the Sturm and prod-diff kernels, the
    session for the segmented Sturm kernel, the op entry points for the
    masked and single-matrix prod-diff kernels.  The Sturm wrapper's count
    covers all its roles (spectrum, window, minor stack)."""
    source, replaces = _SOURCES[kind]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, **extra,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


if __name__ == "__main__":
    sys.exit(main())
