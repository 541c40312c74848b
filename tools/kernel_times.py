"""Time the Sturm, segmented Sturm and prod-diff kernels of one source tree
on the card.

    python3 tools/kernel_times.py [--src DIR] [--check]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
its kernels there and times them with CUDA events at the main path's shapes
(``chip_smoke.py``'s seeded stack, b = 16, n = 600), in float64 and
float32: the Sturm kernel on the spectrum (16 x 600), the k = 8 window
(16 x 8) and the minor stack (9600 x 599); the prod-diff kernel on the
numerator table (16 x 600 x 600 x 599), with a random 75% mask, and for
one matrix; the segmented Sturm kernel on the 9600 minor bands packed 4
to a row (2400 x 2396, k = 8), on a session-sized band (1 x 16, 12 warm
lanes) and on the packed program's launch (64 rows of 16 segments of
n = 32, k = 8), also by its card time in a CUDA graph.  It prints
the tree's ``nvcc -Xptxas -v`` figures and the SASS counts of the
kernels' inner loops (``chip_smoke.py``'s report), the SM clock and power
draw ``nvidia-smi`` reads while the minor stack runs, then one JSON line.
With ``--check`` each Sturm launch must be bitwise its plain version (the
packed 2400 x 2396 launch on its first 64 rows) and each prod-diff launch
within the tolerance of its plain version.

Two trees are compared inside one call on one card, in turns: for example
an unpacked parent commit and this checkout as parent, change, change,
parent.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", default=str(ROOT),
                        help="root of the tree whose kernels are timed")
    parser.add_argument("--check", action="store_true",
                        help="hold each launch against its plain version")
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))
    from repro_torch.core import minors
    from repro_torch.kernels import build
    from repro_torch.kernels.prod_diff import kernel as pd
    from repro_torch.kernels.prod_diff.ops import _floor_from_spectra
    from repro_torch.kernels.sturm import kernel as st
    from repro_torch.kernels.sturm import ops as st_ops
    from repro_torch.linalg import householder, interlace
    from repro_torch.linalg.sturm import (_pivmin, default_iters,
                                          gershgorin_bounds)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    build.library()
    print(f"[{args.src}] kernels from {build.library_dir()}")
    ptxas, sass = smoke._kernel_report(build, tag=args.src)
    b, n, k = smoke.B, smoke.N, smoke.K
    stack = smoke._stack(torch, dev)
    times, device, sm_clocks = {}, {}, {}

    def bounds_of(dd, ee):
        lo, hi = gershgorin_bounds(dd, ee)
        return torch.stack([lo, hi, _pivmin(dd, ee)], dim=-1)

    def timed(label, fn, warmup, reps, plain=None, tol=None, got_rows=None):
        clocks = _Clocks() if "minor stack" in label else None
        times[label] = smoke._events_ms(torch, fn, warmup=warmup, reps=reps)
        if label.startswith("sturm_segmented"):
            # The card's own time a launch (a CUDA graph of launches), apart
            # from the host's time to issue it, which can bound a small one.
            device[label] = smoke._kernel_device_ms(torch, fn)
        if clocks is not None:
            sm_clocks[label] = clocks.stop()
            print(f"[{args.src}] {label}: SM clock while it ran "
                  f"{sm_clocks[label]}")
        note = ""
        if args.check:
            got, ref = fn(), plain()
            if got_rows is not None:
                got = got[:got_rows]
            torch.cuda.synchronize()
            if tol is None:
                smoke.check(torch.equal(got, ref), f"{label}: != plain")
                note = ", bitwise its plain version"
            else:
                err = smoke._max_err(torch, got, ref, *tol, label)
                note = f", max abs err {err:.3e} against its plain version"
        if label in device:
            note += f", card time {device[label]:.4f} ms a launch"
        print(f"[{args.src}] {label}: {times[label]:.4f} ms{note}")

    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        iters = default_iters(dtype)
        d, e, _ = householder.tridiagonalize(stack.to(dtype), with_q=False)
        bnd = bounds_of(d, e)
        dm, em = minors.all_tridiagonal_minor_bands(d, e)
        dm = dm.reshape(b * n, n - 1).contiguous()
        em = em.reshape(b * n, n - 2).contiguous()
        mbnd = bounds_of(dm, em)
        shapes = (("spectrum", d, e, bnd, 0, n, 2, 20),
                  ("window", d, e, bnd, n - k, k, 2, 20),
                  ("minor stack", dm, em, mbnd, 0, n - 1, 1, 3))
        for what, dd, ee, bb, base, m, warmup, reps in shapes:
            kw = dict(target_base=base, m=m, n_iter=iters)
            timed(f"sturm_bisect {what} {dd.shape[0]}x{m} {name}",
                  lambda: st.sturm_bisect(dd, ee, bb, **kw), warmup, reps,
                  plain=lambda: st.sturm_bisect_plain(dd, ee, bb, **kw))
        lam = st.sturm_bisect(d, e, bnd, target_base=0, m=n, n_iter=iters)
        mu = st.sturm_bisect(dm, em, mbnd, target_base=0, m=n - 1,
                             n_iter=iters).reshape(b, n, n - 1)
        floor = _floor_from_spectra(lam).contiguous()
        mask = torch.as_tensor(
            np.random.default_rng(smoke.SEED + 2).random((b, n, n - 1)) > 0.25,
            device=dev)
        tol = smoke.TOL[("prod_diff", name)]
        timed(f"logabs_sum {b}x{n}x{n}x{n - 1} {name}",
              lambda: pd.logabs_sum(lam, mu, floor), 2, 10,
              plain=lambda: pd.logabs_sum_plain(lam, mu, floor), tol=tol)
        timed(f"logabs_sum_masked {b}x{n}x{n}x{n - 1} {name}",
              lambda: pd.logabs_sum_masked(lam, mu, mask, floor), 2, 10,
              plain=lambda: pd.logabs_sum_masked_plain(lam, mu, mask, floor),
              tol=tol)
        timed(f"logabs_sum_single {n}x{n}x{n - 1} {name}",
              lambda: pd.logabs_sum_single(lam[0], mu[0], floor[0]), 2, 20,
              plain=lambda: pd.logabs_sum_single_plain(lam[0], mu[0],
                                                       floor[0]), tol=tol)
        for label, dd, ee, lanes, warmup, reps in _segmented_shapes(
                torch, dev, smoke, st_ops, householder, interlace, dm, em,
                dtype, name):
            kw = dict(n_iter=iters)
            if "segment_lanes" in inspect.signature(
                    st.sturm_segmented).parameters:
                kw["segment_lanes"] = lanes.pop("segment_lanes")
            else:
                lanes.pop("segment_lanes")
            # The plain version of the whole-band minor stack takes minutes:
            # it is checked on its first 64 rows.
            rows = 64 if dd.shape[0] > 64 else dd.shape[0]
            timed(label, lambda: st.sturm_segmented(dd, ee, **lanes, **kw),
                  warmup, reps,
                  plain=lambda: st.sturm_segmented_plain(
                      dd[:rows], ee[:rows],
                      **{key: v[:rows] for key, v in lanes.items()},
                      n_iter=iters),
                  got_rows=rows)
    print(json.dumps({"src": args.src, "times_ms": times,
                      "device_ms": device, "ptxas": ptxas,
                      "sass": sass, "sm_clock_mhz": sm_clocks,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


def _segmented_shapes(torch, dev, smoke, st_ops, householder, interlace, dm,
                      em, dtype, name):
    """Kernel 3's three shapes: ``(label, d, e, lanes, warmup, reps)``, the
    lanes with their ``segment_lanes`` hint.  Built from the tree's own
    ``segmented_lanes`` / ``bracketed_lanes``, so both trees of a comparison
    get the same operands."""
    import numpy as np

    k, seg = smoke.K, smoke.SEG_S
    out = []
    # The minor bands packed SEG_S to a row (chip_smoke.py's synthetic shape).
    dp, ep, off, length = smoke._pack(torch, dm, em, seg)
    lanes = st_ops.segmented_lanes(dp, ep, off, length, k=k, largest=True)
    out.append((f"sturm_segmented packed {dp.shape[0]}x{dp.shape[1]} S={seg} "
                f"k={k} {name}", dp, ep, dict(lanes, segment_lanes=k), 1, 3))
    # A session-sized band: 1 x 16, 12 lanes from interlacing brackets.
    rng = np.random.default_rng(smoke.SEED + 6)
    d1 = torch.as_tensor(rng.standard_normal((1, 16)), dtype=dtype,
                         device=dev)
    e1 = torch.as_tensor(rng.standard_normal((1, 15)), dtype=dtype,
                         device=dev)
    lam = st_ops.sturm_eigenvalues(d1, e1, window=(12, True))
    lo, hi = interlace.rank1_update_brackets(lam, 0.05, drift_bound=1e-3)
    lanes = st_ops.bracketed_lanes(d1, e1, lo, hi, k=12, largest=True)
    out.append((f"sturm_segmented session 1x16 12 lanes {name}", d1, e1,
                dict(lanes, segment_lanes=12), 5, 200))
    # The packed program's launch: 64 rows of 16 segments of n = 32.
    dq, eq, offq, lenq = smoke._packed_program_bands(torch, dev, dtype,
                                                     householder)
    lanes = st_ops.segmented_lanes(dq, eq, offq, lenq, k=k, largest=True)
    out.append((f"sturm_segmented packed program {dq.shape[0]}x{dq.shape[1]} "
                f"S={offq.shape[1]} k={k} {name}", dq, eq,
                dict(lanes, segment_lanes=k), 3, 50))
    return out


class _Clocks:
    """``nvidia-smi``'s SM clock and power draw, sampled every 100 ms from
    construction to ``stop()``, which returns their medians."""

    def __init__(self):
        import subprocess

        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop(self):
        import statistics

        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(v) for v in line.split(",")])
            except ValueError:  # an empty line or "[N/A]"
                continue
        if not rows:
            return "not measured"
        return (f"median {statistics.median(r[0] for r in rows):.0f} MHz, "
                f"power draw {statistics.median(r[1] for r in rows):.0f} W "
                f"({len(rows)} samples)")


if __name__ == "__main__":
    sys.exit(main())
