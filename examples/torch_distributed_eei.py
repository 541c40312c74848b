"""Distributed EEI on the PyTorch/CUDA port: the engine's sharded backend on
a device mesh.  The twin of ``examples/distributed_eei.py``.

    PYTHONPATH=src python examples/torch_distributed_eei.py [--data 2] \
        [--device cpu]

Demonstrates the three distributed axes on a mesh of ``--data`` positions
(the cards, or with one card that card repeated: a logical mesh, the
counterpart of ``repro``'s placeholder host devices):
  * batch axis: a stack of matrices split over ``data`` (the serving path:
    one SolverPlan, the whole pipeline per position, no collective);
  * minor axis: one matrix's minors split over ``model``;
  * term axis: one component's product terms split (the paper's batch
    dispatch; the join is one sum).
It runs on the card (the sharded backend issues the ``cuda`` library's
kernels shard by shard); with no card it fails unless given ``--device
cpu``.  It exits 1 if an axis's result is more than ``TOL`` from
``torch.linalg.eigh``'s (float64).
"""

import argparse
import sys

import numpy as np
import torch

from repro_torch.core import distributed, identity
from repro_torch.engine import SolverEngine, SolverPlan
from repro_torch.launch.mesh import make_local_mesh

TOL = 1e-7


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", type=int, default=2,
                    help="positions of the mesh's data (and minor) axis")
    ap.add_argument("--device", default=None,
                    help="torch device, repeated over the mesh (default: "
                    "the cards, the one card repeated if there are fewer)")
    args = ap.parse_args(argv)
    n = 64
    rng = np.random.default_rng(0)
    if args.device is None:
        if not torch.cuda.is_available():
            raise SystemExit("torch_distributed_eei: no CUDA device; pass "
                             "--device cpu to run the kernels' plain "
                             "versions")
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", i % count) for i in range(args.data)]
    else:
        devices = [torch.device(args.device)] * args.data
    n_dev = args.data
    mesh = make_local_mesh(n_dev, 1, devices=devices)
    print(f"mesh: {mesh.shape} on {sorted({str(d) for d in devices})}")

    # --- batch axis: a sharded stack through the engine ----------------------
    b = 2 * n_dev
    stack = rng.standard_normal((b, n, n))
    stack = torch.as_tensor((stack + np.swapaxes(stack, 1, 2)) / 2,
                            device=mesh.first_device)
    plan = SolverPlan(method="eei_tridiag", backend="sharded", mesh=mesh)
    engine = SolverEngine(plan)
    lam_b, mags_b = engine.solve(stack)
    v_ref = torch.linalg.eigh(stack)[1]
    err_b = float((mags_b - (v_ref ** 2).transpose(-1, -2)).abs().max())
    print(f"batch-sharded solve ({b}x{n}x{n} over {n_dev} positions): "
          f"max err vs eigh = {err_b:.2e}")

    # --- minor axis: one matrix, components sharded over 'model' -------------
    a = stack[0]
    mesh_m = make_local_mesh(1, n_dev, devices=devices)
    lam, v = torch.linalg.eigh(a)
    ref = (v * v).T
    mags = distributed.minor_sharded_magnitudes(a, mesh_m, axis="model")
    err_m = float((mags - ref).abs().max())
    print(f"minor-sharded |v|^2 table: max err vs eigh = {err_m:.2e}")

    # --- term axis: single component (Algorithm 2 dispatch -> one sum) -------
    mu = identity.minor_spectra(a)
    i, j = n // 2, 5
    comp = distributed.term_sharded_component(lam, mu[j], i, mesh_m,
                                              axis="model")
    err_t = abs(float(comp) - float(ref[i, j]))
    print(f"term-sharded |v[{i},{j}]|^2 = {float(comp):.12f} "
          f"(eigh: {float(ref[i, j]):.12f})")
    if max(err_b, err_m, err_t) > TOL:
        print(f"torch_distributed_eei: errors {err_b:.2e} {err_m:.2e} "
              f"{err_t:.2e} above {TOL}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
