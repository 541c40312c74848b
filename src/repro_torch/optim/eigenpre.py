"""EigenPre — EEI-powered spectral preconditioning (the paper in the loop).

The twin of ``repro.optim.eigenpre``.  Shampoo-style Kronecker-factor
preconditioning needs, per 2-D parameter, the top eigenpairs of gram
factors ``L = G G^T / n`` accumulated over steps — the partial-spectrum
query regime where the paper's identity beats a full eigendecomposition.
The preconditioner applies a low-rank spectral transform

    P(g) = g + sum_i (f(lam_i) - 1) u_i (u_i^T g)      f(lam) = rsqrt(lam+eps)

using only the top-k eigenpairs from :class:`~repro_torch.engine.SolverEngine`
(tridiagonalize -> Sturm -> EEI -> signed back-transform), grafted onto
AdamW's update; other parameters pass through unchanged.

A parameter is eligible when it is 2-D with at most ``max_dim`` rows.  The
trainer holds ``repro``'s stacked layout (``train.steps``), so the stacked
norm scales, ``(layers, d_model)``, are eligible as they are in ``repro``
(gemma2-2b at full width: four of ``(13, 2304)``).

The engine runs ``repro``'s plan (``eei_tridiag``, the full spectrum,
the input's precision) on the ``cuda`` backend, the twin of ``repro``'s
``jnp``: on the card it launches the Sturm kernel twice and the prod-diff
kernel once a refresh of each parameter, on CPU tensors it runs their plain
versions.  With no ``engine`` given, one is made on the grams' device at
each refresh.  The refresh decision, ``(count + 1) % refresh_every == 1``
as in ``repro`` (so ``refresh_every=1`` never refreshes), is taken on the
CPU count and costs no device sync.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.engine import SolverEngine, SolverPlan
from repro_torch.optim.adamw import AdamW, AdamWState

#: ``repro``'s default engine plan, on the port's ``cuda`` backend.
PLAN = SolverPlan(method="eei_tridiag", backend="cuda")


class EigenPreState(NamedTuple):
    adamw: AdamWState
    gram: dict  # per-param left gram factor (d, d), or (1, 1) if ineligible
    eigvals: dict  # (rank,) top eigenvalues per param
    eigvecs: dict  # (rank, d) top eigenvectors per param


@dataclasses.dataclass(frozen=True)
class EigenPre:
    """AdamW + EEI low-rank spectral graft on 2-D params."""

    adamw: AdamW = AdamW()
    rank: int = 4
    refresh_every: int = 10
    beta_gram: float = 0.95
    eps: float = 1e-6
    max_dim: int = 1024  # precondition only dims <= this (monitoring regime)
    engine: Optional[SolverEngine] = None  # None: PLAN on the grams' device

    def _eligible(self, p) -> bool:
        return len(p.shape) == 2 and p.shape[0] <= self.max_dim

    def _engine(self, device) -> SolverEngine:
        if self.engine is not None:
            return self.engine
        return SolverEngine(PLAN, device=device)

    def init(self, params: dict) -> EigenPreState:
        gram, vals, vecs = {}, {}, {}
        for k, p in params.items():
            d = p.shape[0] if self._eligible(p) else 1
            f32 = dict(dtype=torch.float32, device=p.device)
            gram[k] = torch.zeros((d, d), **f32)
            vals[k] = torch.ones((self.rank,), **f32)
            vecs[k] = torch.zeros((self.rank, d), **f32)
        return EigenPreState(self.adamw.init(params), gram, vals, vecs)

    @torch.no_grad()
    def update(self, grads: dict, state: EigenPreState, params: dict,
               lr_scale=1.0):
        """Returns ``(params, state, metrics)``; the parameters and AdamW's
        moments are updated in place (``AdamW.update``)."""
        grads_p, gram, eigvals, eigvecs = self._precondition(grads, state)
        # 4. AdamW on preconditioned gradients
        new_params, adamw_state, metrics = self.adamw.update(
            grads_p, state.adamw, params, lr_scale)
        return new_params, EigenPreState(adamw_state, gram, eigvals,
                                         eigvecs), metrics

    @torch.no_grad()
    def update_sharded(self, grads: dict, state: EigenPreState, params: dict,
                       lr_scale=1.0):
        """:meth:`update` on a mesh (``train.steps.build_programs``): the
        parameters, gradients and AdamW's moments are ``Sharded``, the
        grams and factors whole on the mesh's first device.  An eligible
        parameter's gradient is gathered there, its gram accumulated and
        (at a refresh) its top eigenpairs found by the engine's kernels; the
        preconditioned gradient is split back to its shards, and AdamW
        updates every shard (``AdamW.update_sharded``)."""
        from repro_torch.sharding.placement import put

        eligible = {k for k, gr in state.gram.items() if gr.shape[0] > 1}
        whole = {k: grads[k].gather(gr.device) if k in eligible else grads[k]
                 for k, gr in state.gram.items()}
        grads_p, gram, eigvals, eigvecs = self._precondition(whole, state)
        grads_p = {k: put(g, grads[k].sharding) if k in eligible else g
                   for k, g in grads_p.items()}
        new_params, adamw_state, metrics = self.adamw.update_sharded(
            grads_p, state.adamw, params, lr_scale)
        return new_params, EigenPreState(adamw_state, gram, eigvals,
                                         eigvecs), metrics

    def _precondition(self, grads: dict, state: EigenPreState):
        """Steps 1-3 of the update: ``(preconditioned grads, gram,
        eigvals, eigvecs)``; a gradient of an ineligible parameter is
        passed through as it is."""
        # 1. accumulate gram factors
        gram = {}
        for k, gr in state.gram.items():
            if gr.shape[0] == 1:
                gram[k] = gr
                continue
            g32 = grads[k].float()
            gram[k] = self.beta_gram * gr + (1 - self.beta_gram) * (
                g32 @ g32.T / g32.shape[1])

        # 2. refresh top-k eigenpairs via the EEI engine (amortized)
        eigvals, eigvecs = dict(state.eigvals), dict(state.eigvecs)
        if (int(state.adamw.count) + 1) % self.refresh_every == 1:
            for k, gr in gram.items():
                if gr.shape[0] == 1:
                    continue
                eigvals[k], eigvecs[k] = self._topk(gr)

        # 3. precondition gradients in the top-k eigenspace
        grads_p = {}
        for k, g in grads.items():
            val, vec = eigvals[k], eigvecs[k]
            if vec.shape[1] == 1:
                grads_p[k] = g
                continue
            g32 = g.float()
            proj = vec @ g32  # (k, cols)
            scale = torch.rsqrt(torch.clamp(val, min=0.0) + self.eps)
            scale = scale / torch.clamp(torch.max(scale), min=1e-12)  # graft
            corrected = (scale - 1.0)[:, None] * proj
            grads_p[k] = (g32 + vec.T @ corrected).to(g.dtype)
        return grads_p, gram, eigvals, eigvecs

    def _topk(self, gr: torch.Tensor):
        """The top ``min(rank, d)`` eigenpairs of ``gr + eps I``, padded to
        ``rank`` in front with eigenvalue 1 and a zero vector."""
        d = gr.shape[0]
        eye = torch.eye(d, dtype=gr.dtype, device=gr.device)
        res = self._engine(gr.device).topk(gr + self.eps * eye,
                                           min(self.rank, d))
        lam, v = res.eigenvalues, res.vectors
        pad = self.rank - lam.shape[0]
        if pad > 0:
            lam = torch.cat([torch.ones((pad,), dtype=torch.float32,
                                        device=lam.device), lam])
            v = torch.cat([torch.zeros((pad, d), dtype=torch.float32,
                                       device=v.device), v])
        return lam.float(), v.float()
