"""Spectral monitoring during training on the PyTorch/CUDA port: the
paper's partial-eigenvector use case in the loop, on the streaming update
API.  The twin of ``examples/spectral_monitor.py``.

    PYTHONPATH=src python examples/torch_spectral_monitor.py [--steps 30] \
        [--device cpu]

Trains a small LM while maintaining the top eigenpairs of a streaming
gradient-covariance matrix ``A_t = A_{t-1} + u_t u_t^T`` (``u_t`` the step's
mean gradient direction of the unembed matrix) through a
:class:`~repro_torch.engine.session.SpectralSession`: each training step is
one rank-1 ``engine.update()`` (a warm-started refinement of the previous
window, whose Sturm bisection is the segmented CUDA kernel) instead of a
from-scratch solve.  The session's drift monitor forces a verified full
re-solve whenever the accumulated updates could have moved the spectrum
past the warm brackets, so the printed window is always residual-checked,
never stale.  It runs on the card; with no card it fails unless given
``--device cpu``.
"""

import argparse
import math
import sys

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.data import make_synthetic
from repro_torch.engine import Rank1Update, SessionConfig, SolverEngine, SolverPlan
from repro_torch.models import LanguageModel
from repro_torch.optim import AdamW
from repro_torch.train import TrainState, make_train_step, put_batch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_spectral_monitor: no CUDA device; pass "
                         "--device cpu to run the kernels' plain versions")
    cfg = reduced_config(get_config("codeqwen1.5-7b"))
    model = LanguageModel(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    opt = AdamW(lr=3e-3)
    params = model.stacked_dict()
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    step_fn = make_train_step(model, opt, compute_dtype=torch.float32)
    src = make_synthetic(cfg, ShapeConfig("t", 32, 4, "train"))
    engine = SolverEngine(SolverPlan(method="eei_tridiag", backend="cuda"),
                          device=dev)

    def grad_direction(params, batch):
        """The step's mean gradient direction of the unembed matrix."""
        leaves = {k: v.detach().requires_grad_(k == "unembed")
                  for k, v in params.items()}
        loss = model.loss(model.unstack(leaves), batch)[0]
        (g,) = torch.autograd.grad(loss, leaves["unembed"])
        g = g.float()
        return torch.mean(g, dim=1) * math.sqrt(g.shape[0])

    session = None
    warmup: list = []
    unit = None  # first gradient's norm: the stream's working unit
    for i in range(args.steps):
        batch = put_batch(src.global_batch_at(i), dev)
        state, metrics = step_fn(state, batch)
        u = grad_direction(state.params, batch).cpu().numpy()
        # Monitor in units of the first gradient's norm: raw grads here are
        # small, and float32 squares matrix entries in the residual check,
        # which underflows around 1e-19; normalized, everything is O(1).
        if unit is None:
            unit = float(np.linalg.norm(u)) or 1.0
        u = u / unit
        if session is None:
            # Seed from a short warmup so the retained window spans
            # directions actually present, with a spread diagonal ridge
            # (an exactly-degenerate ridge cluster would pin the fast
            # path's verify residual at the tolerance edge).
            warmup.append(u)
            if len(warmup) < 8:
                continue
            n = u.shape[0]
            scale = float(np.mean([w @ w for w in warmup]))
            a0 = sum(np.outer(w, w) for w in warmup)
            a0 = a0 + 1e-3 * scale * np.diag(1.0 + np.linspace(0.0, 1.0, n))
            session = engine.open_session(
                a0, 2, config=SessionConfig(drift_bound=0.5))
        else:
            engine.update(session, Rank1Update(u, 1))
        if i % 5 == 0:
            ev, vecs = session.result()
            top = vecs[-1].cpu().numpy()
            comps = np.argsort(-np.abs(top))[:3]
            print(f"step {i:3d} loss {float(metrics['loss']):7.4f} "
                  f"grad-cov top eigvals {np.round(ev.cpu().numpy(), 6)} "
                  f"dominant dims {comps.tolist()}")
    if session is None:
        raise SystemExit("torch_spectral_monitor: --steps must exceed the 8 "
                         "warm-up steps")
    stats = session.stats()
    print(f"\n{stats['updates_total']} rank-1 updates: "
          f"{stats['fast_updates']} warm-path, "
          f"{stats['full_resolves']} drift-forced full re-solves "
          f"({stats['resolves_by_cause']}).  The steady-state probe cost is "
          "one O(m n^2) warm refinement per step; no full "
          "eigendecomposition anywhere.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
