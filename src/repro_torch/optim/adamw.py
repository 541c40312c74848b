"""AdamW with a bfloat16-compressed first moment, the twin of
``repro.optim.adamw``.

The same state (``AdamWState(count, m, v)``: ``m`` in bfloat16 when
``compress_m``, ``v`` in float32), global-norm clipping, decoupled weight
decay and float32 update arithmetic whatever the parameters' dtype.
``count`` is a 0-d int32 tensor on the CPU, so the bias corrections are
CPU scalars and cost no device sync.

``repro``'s launcher donates the train state to its jitted step, so XLA
updates it in place; the port does so explicitly: :meth:`AdamW.update`
writes the new parameters, ``m`` and ``v`` into the tensors it is given
and returns them (a caller that needs the old values clones them first).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    count: torch.Tensor  # 0-d int32, on the CPU
    m: dict  # bfloat16 (compress_m) or float32, like the params
    v: dict  # float32


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    compress_m: bool = True

    def init(self, params: dict) -> AdamWState:
        mdt = torch.bfloat16 if self.compress_m else torch.float32
        m = {k: torch.zeros(p.shape, dtype=mdt, device=p.device)
             for k, p in params.items()}
        v = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
        return AdamWState(torch.zeros((), dtype=torch.int32), m, v)

    @torch.no_grad()
    def update(self, grads: dict, state: AdamWState, params: dict,
               lr_scale=1.0, gnorm=None):
        """Returns ``(params, state, {"grad_norm": ...})``, the parameters
        and moments updated in place.  ``gnorm``: the gradients' global
        norm when the caller has it (:meth:`update_sharded`)."""
        count = state.count + 1
        gnorm = global_norm(grads) if gnorm is None else gnorm
        clip = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-12),
                           max=1.0)
        c32 = count.to(torch.float32)
        bc1 = 1 - torch.tensor(self.b1, dtype=torch.float32) ** c32
        bc2 = 1 - torch.tensor(self.b2, dtype=torch.float32) ** c32
        scale = -self.lr * torch.as_tensor(lr_scale, dtype=torch.float32)
        for k in sorted(params):
            p, m, v = params[k], state.m[k], state.v[k]
            g = grads[k].float() * clip.to(p.device)
            m_new = self.b1 * m.float() + (1 - self.b1) * g
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            del g
            step = m_new / bc1 / (torch.sqrt(v / bc2) + self.eps)
            m.copy_(m_new)  # round to nearest even into bfloat16
            del m_new
            step = step + self.weight_decay * p.float()
            p.add_((scale * step).to(p.dtype))
        return params, AdamWState(count, state.m, state.v), {"grad_norm": gnorm}


    def update_sharded(self, grads: dict, state: AdamWState, params: dict,
                       lr_scale=1.0):
        """:meth:`update` of ``Sharded`` trees (``train.steps.
        build_programs``): every shard of every position once, with the
        global norm of :func:`sharded_global_norm`.  Returns ``(params,
        state, metrics)``, updated in place."""
        _, new, metrics = self.update(
            _flat(grads), AdamWState(state.count, _flat(state.m),
                                     _flat(state.v)),
            _flat(params), lr_scale, gnorm=sharded_global_norm(grads))
        return params, AdamWState(new.count, state.m, state.v), metrics


def _flat(tree: dict) -> dict:
    """``{(key, r, m): shard}`` of a ``{key: Sharded}`` dict."""
    return {(k, r, m): t for k, sh in tree.items()
            for r, row in enumerate(sh.shards) for m, t in enumerate(row)}


def sharded_global_norm(tree: dict) -> torch.Tensor:
    """:func:`global_norm` of a ``{key: Sharded}`` dict: each distinct
    slice counted once, in sorted key order and row-major position order,
    summed on the first position's device."""
    from repro_torch.sharding.placement import distinct

    total = None
    for k in sorted(tree):
        for x in distinct(tree[k]):
            s = torch.sum(x.float() * x.float())
            total = s if total is None else total + s.to(total.device)
    return torch.sqrt(total)


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every leaf, in sorted key
    order (``jax.tree.leaves``' order for a dict)."""
    total = None
    for k in sorted(tree):
        x = tree[k].float()
        s = torch.sum(x * x)
        total = s if total is None else total + s
    return torch.sqrt(total)
