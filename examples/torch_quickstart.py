"""Quickstart on the PyTorch/CUDA port: the Eigenvector-Eigenvalue
Identity in five minutes.  The twin of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Computes eigenvector component magnitudes through the plan-driven
``SolverEngine`` (``torch.linalg.eigh``, the paper's identity on dense
minors, and the tridiagonal pipeline whose Sturm bisection and
difference products are the port's CUDA kernels) on a single matrix and
on a batched stack, and recovers signed eigenvectors from magnitudes
alone.  It runs on the card (the ``cuda`` backend's kernels); with no card
it fails unless given ``--device cpu``, where the kernels' plain versions
run.  It exits 1 if a table is off by more than ``TABLE_TOL`` or a signed
pair's residual exceeds ``RESIDUAL_TOL`` (float64; ``repro``'s quickstart
prints 6.8e-9 and 2.4e-7 for these inputs).
"""

import argparse
import sys

import numpy as np
import torch

from repro_torch.core import identity
from repro_torch.engine import SolverEngine, SolverPlan, plan_for

TABLE_TOL, RESIDUAL_TOL = 1e-7, 1e-6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_quickstart: no CUDA device; pass --device "
                         "cpu to run the kernels' plain versions")
    rng = np.random.default_rng(0)
    n = 32
    a = rng.standard_normal((n, n))
    a = torch.as_tensor((a + a.T) / 2, device=dev)

    # --- oracle -------------------------------------------------------------
    lam, v = torch.linalg.eigh(a)
    print(f"symmetric {n}x{n} on {dev}; spectrum [{lam[0]:.3f}, "
          f"{lam[-1]:.3f}]")

    # --- one component via the identity (paper Eq. 2, corrected) ------------
    i, j = n // 2, 3
    mag = identity.component(a, i, j, variant="logspace")
    print(f"\n|v[{i},{j}]|^2  identity = {float(mag):.12f}")
    print(f"|v[{i},{j}]|^2  eigh     = {float(v[j, i] ** 2):.12f}")

    # --- full magnitude table, one engine per method --------------------------
    ref = (v * v).T
    worst = 0.0
    for method in ("eigh", "eei_dense", "eei_tridiag"):
        engine = SolverEngine(SolverPlan(method=method, backend="cuda"),
                              device=dev)
        result = engine.solve(a)
        err = float((result.magnitudes - ref).abs().max())
        worst = max(worst, err)
        print(f"{method:12s} magnitude table err  = {err:.2e}")

    # --- a *stack* of matrices in one batched program -------------------------
    b = 8
    stack = rng.standard_normal((b, n, n))
    stack = torch.as_tensor((stack + np.swapaxes(stack, 1, 2)) / 2,
                            device=dev)
    plan = plan_for(tuple(stack.shape), k=3)  # planner picks method/backend
    engine = SolverEngine(plan, device=dev)
    lam_b, mags_b = engine.solve(stack)
    ref_b = torch.linalg.eigh(stack)[1]
    err = float((mags_b - (ref_b ** 2).transpose(-1, -2)).abs().max())
    worst = max(worst, err)
    print(f"\nbatched solve ({b}x{n}x{n}, plan: {plan.method}/{plan.backend})"
          f" table err = {err:.2e}")

    # --- signed eigenvectors from magnitudes (EEI gives only |v|) ------------
    engine = SolverEngine(SolverPlan(method="eei_tridiag", backend="cuda"),
                          device=dev)
    ev, vecs = engine.topk(a, 3)
    print("\ntop-3 eigenvalues (EEI+Sturm kernels):",
          np.round(ev.cpu().numpy(), 6))
    print("vs eigh:                              ",
          np.round(lam[-3:].cpu().numpy(), 6))
    res = torch.linalg.norm(a @ vecs.T - vecs.T * ev[None, :], dim=0)
    print("residual ||Av - lambda v|| per pair:",
          np.round(res.cpu().numpy(), 9))
    if not (worst <= TABLE_TOL and float(res.max()) <= RESIDUAL_TOL):
        print(f"torch_quickstart: table error {worst:.2e} or residual "
              f"{float(res.max()):.2e} above {TABLE_TOL} / {RESIDUAL_TOL}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
