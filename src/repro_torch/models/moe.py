"""Mixture-of-Experts layer: capacity-based top-k routing.

The twin of ``repro.models.moe``: GShard/Switch-style dispatch.  Tokens are
grouped, each token picks its top-k experts, a position-in-expert is
assigned by cumulative sum (expert-choice rank first, then token order),
tokens past an expert's capacity are dropped, and dispatch and combine are
dense one-hot products.

Routing reproduces ``jax.lax.top_k``'s order on ties (the lower expert
index first) with a stable descending sort: ``torch.topk`` promises no
order among equal values, and ties are common once the router's logits
come from a bfloat16 product.  ``repro`` pins the dispatch tensors'
shardings with ``hints.constrain``; on one device those hints have no
numeric effect, and the sharded LM (``ROADMAP.md`` Queue 1) brings them.

Faithfulness notes (``repro``'s): DeepSeek-V3 routes with sigmoid and a
bias correction and is dropless; this is softmax top-k with capacity
dropping plus a shared expert.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import common
from repro_torch.models.params import ParamDecl, ParamTable


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int  # per-expert hidden
    n_experts: int
    top_k: int
    n_shared: int = 0  # shared-expert multiplier (d_ff * n_shared dense path)
    capacity_factor: float = 1.25
    group_size: int = 1024  # tokens per routing group
    router_z_weight: float = 1e-3
    load_balance_weight: float = 1e-2


def moe_param_table(cfg: MoEConfig) -> ParamTable:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    t: ParamTable = {
        "router": ParamDecl((d, e), ("embed", "experts")),
        "w_gate": ParamDecl((e, d, f), ("experts", "embed", "expert_mlp")),
        "w_up": ParamDecl((e, d, f), ("experts", "embed", "expert_mlp")),
        "w_down": ParamDecl((e, f, d), ("experts", "expert_mlp", "embed"),
                            init="output", fan_in=f),
    }
    if cfg.n_shared:
        fs = cfg.d_ff * cfg.n_shared
        t["shared/w_gate"] = ParamDecl((d, fs), ("embed", "mlp"))
        t["shared/w_up"] = ParamDecl((d, fs), ("embed", "mlp"))
        t["shared/w_down"] = ParamDecl((fs, d), ("mlp", "embed"), init="output")
    return t


def _capacity(cfg: MoEConfig, tokens_per_group: int) -> int:
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(4, (c + 3) // 4 * 4)


def group_size(cfg: MoEConfig, tokens: int) -> int:
    """Tokens a routing group: ``cfg.group_size``, halved until it divides
    ``tokens``."""
    g_size = min(cfg.group_size, tokens)
    while tokens % g_size:
        g_size //= 2
    return g_size


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot(idx, n, dtype=float32)`` (an index outside [0, n)
    gives a zero row)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, in descending
    order, the lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe(cfg: MoEConfig, p: dict, x: torch.Tensor):
    """x: (B, S, d) -> (y, aux_loss)."""
    b, s, d = x.shape
    tokens = b * s
    g_size = group_size(cfg, tokens)
    n_groups = tokens // g_size
    cap = _capacity(cfg, g_size)
    e = cfg.n_experts

    xg = x.reshape(n_groups, g_size, d)
    logits = common.matmul(xg, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, cfg.top_k)  # (g,t,k)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)

    # Position-in-expert by arrival order; tokens beyond capacity are dropped.
    sel = _one_hot(gate_idx, e)  # (g,t,k,e)
    # priority: expert choice rank first, then token order (GShard ordering)
    sel_flat = sel.transpose(1, 2).reshape(n_groups, cfg.top_k * g_size, e)
    pos_flat = torch.cumsum(sel_flat, dim=1) - sel_flat  # (g, k*t, e)
    pos = pos_flat.reshape(n_groups, cfg.top_k, g_size, e).transpose(1, 2)
    within_cap = pos < cap
    sel = sel * within_cap
    pos = torch.sum(pos * sel, dim=-1).to(torch.int32)  # (g,t,k) slot index

    dispatch = torch.einsum("gtke,gtkc->gtec", sel, _one_hot(pos, cap))
    combine = dispatch * torch.sum(gate_vals[..., None] * sel, dim=2)[..., None]

    x_e = common.einsum("gtec,gtd->gecd", dispatch.to(x.dtype), xg)  # (g,e,c,d)
    h = common.swiglu(
        common.einsum("gecd,edf->gecf", x_e, p["w_gate"]),
        common.einsum("gecd,edf->gecf", x_e, p["w_up"]),
    )
    y_e = common.einsum("gecf,efd->gecd", h, p["w_down"])
    y = common.einsum("gtec,gecd->gtd", combine.to(x.dtype), y_e)
    y = y.reshape(b, s, d)

    if cfg.n_shared:
        y = y + _shared_mlp(cfg, p, x)

    # Aux losses: load balance (Switch) + router z-loss.
    density = torch.mean(sel.sum(dim=2), dim=1)  # (g, e) fraction routed
    density_prob = torch.mean(probs, dim=1)  # (g, e)
    lb = torch.mean(density * density_prob) * (e**2) * cfg.load_balance_weight
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * cfg.router_z_weight
    return y, lb + z


def _shared_mlp(cfg: MoEConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = common.swiglu(common.matmul(x, p["shared/w_gate"]),
                      common.matmul(x, p["shared/w_up"]))
    return common.matmul(h, p["shared/w_down"])
