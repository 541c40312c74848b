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
shardings with ``hints.constrain``; the port records the same requests
(``sharding.hints``), and :func:`moe_rows` runs the layer over a mesh.
Given a ``stats`` dict, a routing adds the count of (token, choice) pairs
it dropped past capacity to ``stats["moe_dropped"]``, a list with an entry
a routing.

Faithfulness notes (``repro``'s): DeepSeek-V3 routes with sigmoid and a
bias correction and is dropless; this is softmax top-k with capacity
dropping plus a shared expert.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import common
from repro_torch.models.mlp import split_mlp
from repro_torch.models.params import ParamDecl, ParamTable
from repro_torch.sharding import hints


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


def moe(cfg: MoEConfig, p: dict, x: torch.Tensor, stats: dict | None = None):
    """x: (B, S, d) -> (y, aux_loss); the dropped pairs into ``stats``."""
    b, s, d = x.shape
    tokens = b * s
    g_size = group_size(cfg, tokens)
    n_groups = tokens // g_size

    xg = x.reshape(n_groups, g_size, d)
    logits = common.matmul(xg, p["router"]).float()
    probs, sel, dispatch, combine = _route(cfg, logits, g_size)

    # repro pins these layouts: tokens (g) on data, experts (e) on model.
    dispatch = hints.constrain(dispatch, "data", None, "model", None)
    combine = hints.constrain(combine, "data", None, "model", None)
    y = _experts(p, dispatch, combine, xg, constrain=True)
    y = hints.constrain(y, "data", None, None)
    y = y.reshape(b, s, d)

    if cfg.n_shared:
        y = y + _shared_mlp(cfg, p, x)

    lb, z, dropped = _aux_sums(sel, probs, logits)
    _add_dropped(stats, dropped)
    return y, _aux(cfg, lb, z, n_groups, g_size)


def _route(cfg: MoEConfig, logits: torch.Tensor, g_size: int):
    """Top-k routing of float32 router ``logits`` (g, t, e) with capacity
    dropping.  Returns ``(probs, sel, dispatch, combine)``."""
    n_groups, e = logits.shape[0], cfg.n_experts
    cap = _capacity(cfg, g_size)
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
    sel = sel * (pos < cap)
    pos = torch.sum(pos * sel, dim=-1).to(torch.int32)  # (g,t,k) slot index

    dispatch = torch.einsum("gtke,gtkc->gtec", sel, _one_hot(pos, cap))
    combine = dispatch * torch.sum(gate_vals[..., None] * sel, dim=2)[..., None]
    return probs, sel, dispatch, combine


def _experts(p: dict, dispatch, combine, xg, constrain: bool = False,
             partial: bool = False):
    """The experts of ``p`` (``w_gate``, ``w_up``, ``w_down`` on a leading
    expert axis) on their capacity slots: ``dispatch`` and ``combine``
    (g, t, e, c) name the same experts.  Returns (g, t, d); with
    ``partial``, the combine's product in at least float32 (one device's
    part of a sum over the model axis)."""
    dt = xg.dtype
    hint = hints.constrain if constrain else (lambda x, *a: x)
    x_e = common.einsum("gtec,gtd->gecd", dispatch.to(dt), xg)  # (g,e,c,d)
    x_e = hint(x_e, "data", "model", None, None)
    h = common.swiglu(
        common.einsum("gecd,edf->gecf", x_e, p["w_gate"]),
        common.einsum("gecd,edf->gecf", x_e, p["w_up"]),
    )
    h = hint(h, "data", "model", None, None)
    y_e = common.einsum("gecf,efd->gecd", h, p["w_down"])
    y_e = hint(y_e, "data", "model", None, None)
    if partial:
        return common.partial_einsum("gtec,gecd->gtd", combine.to(dt), y_e)
    return common.einsum("gtec,gecd->gtd", combine.to(dt), y_e)


def _aux_sums(sel, probs, logits):
    """The load-balance and z-loss sums over a set of groups (``repro``'s
    means times their counts), and the (token, choice) pairs that ``sel``
    (g, t, k, e), one-hot before the capacity cut, dropped."""
    density = torch.mean(sel.sum(dim=2), dim=1)  # (g, e) fraction routed
    density_prob = torch.mean(probs, dim=1)  # (g, e)
    return (torch.sum(density * density_prob),
            torch.sum(torch.logsumexp(logits, dim=-1) ** 2),
            math.prod(sel.shape[:3]) - torch.sum(sel))


def _add_dropped(stats: dict | None, dropped: torch.Tensor):
    if stats is not None:
        stats.setdefault("moe_dropped", []).append(dropped)


def _aux(cfg: MoEConfig, lb_sum, z_sum, n_groups: int, g_size: int):
    """Aux losses: load balance (Switch) + router z-loss, from
    :func:`_aux_sums` over ``n_groups`` groups."""
    e = cfg.n_experts
    lb = lb_sum / (n_groups * e) * (e**2) * cfg.load_balance_weight
    z = z_sum / (n_groups * g_size) * cfg.router_z_weight
    return lb + z


def moe_rows(cfg: MoEConfig, ps: list, xs: list, rows: list,
             stats: dict | None = None):
    """:func:`moe` over a mesh's data rows: ``xs[r]`` (B_r, S, d) on row
    ``r``'s first device, ``ps[r]`` its ``{path: Split}``, ``rows[r]`` its
    devices.  Returns ``(ys, aux)``; the layer's dropped pairs, summed over
    its groups, go into ``stats`` as one entry.

    The groups and capacity are those of the global token count, as in
    ``repro``'s program for global shapes.  A row runs the groups that lie
    in it; when a group would straddle rows, every row's tokens are
    gathered onto the first row.  The router's weight (a few MB) is
    gathered whole, so that the routing of the same tokens is the
    unsharded layer's, bit for bit.  Within a row of several devices the
    experts split over the model axis when it divides them: each device runs its experts'
    capacity slots and the combined outputs are summed in float32 before
    one rounding.  The dispatch, combine and output tensors take ``repro``'s
    layout requests, and the experts' own when they run whole.
    """
    d = xs[0].shape[-1]
    tokens = [x.shape[0] * x.shape[1] for x in xs]
    total = sum(tokens)
    g_size = group_size(cfg, total)
    units = ([[r] for r in range(len(xs))]
             if all(t % g_size == 0 for t in tokens) else [list(range(len(xs)))])
    ys = [None] * len(xs)
    lb_sum = z_sum = dropped = None
    for unit in units:
        r0 = unit[0]
        first = xs[r0].device
        p, devices = ps[r0], rows[r0]
        xg = torch.cat([xs[r].reshape(-1, d).to(first) for r in unit])
        xg = xg.reshape(-1, g_size, d)
        logits = common.matmul(xg, p["router"].full()).float()
        probs, sel, dispatch, combine = _route(cfg, logits, g_size)
        dispatch = hints.constrain(dispatch, "data", None, "model", None)
        combine = hints.constrain(combine, "data", None, "model", None)
        experts = {n: p[n] for n in ("w_gate", "w_up", "w_down")}
        if experts["w_gate"].dim is None or len(devices) == 1:
            y = _experts({n: w.parts[0] for n, w in experts.items()},
                         dispatch, combine, xg, constrain=True)
        else:
            e_loc = cfg.n_experts // len(devices)
            parts = []
            for m, dev in enumerate(devices):
                sl = slice(m * e_loc, (m + 1) * e_loc)
                parts.append(_experts(
                    {n: w.parts[m] for n, w in experts.items()},
                    dispatch[:, :, sl].to(dev), combine[:, :, sl].to(dev),
                    xg.to(dev), partial=True))
            y = common.sum_partials(parts, first, xg.dtype)
        y = hints.constrain(y, "data", None, None).reshape(-1, d)
        off = 0
        for r in unit:
            ys[r] = y[off:off + tokens[r]].reshape(xs[r].shape).to(
                xs[r].device)
            off += tokens[r]
        lb, z, drop = _aux_sums(sel, probs, logits)
        lb_sum = lb if lb_sum is None else lb_sum + lb.to(lb_sum.device)
        z_sum = z if z_sum is None else z_sum + z.to(z_sum.device)
        dropped = drop if dropped is None else dropped + drop.to(
            dropped.device)
    _add_dropped(stats, dropped)
    if cfg.n_shared:
        for r, x in enumerate(xs):
            shared = {n: w for n, w in ps[r].items()
                      if n.startswith("shared/")}
            ys[r] = ys[r] + split_mlp(_shared_hidden, shared, x, rows[r],
                                      down="shared/w_down")
    return ys, _aux(cfg, lb_sum, z_sum, total // g_size, g_size)


def _shared_mlp(cfg: MoEConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return common.matmul(_shared_hidden(p, x), p["shared/w_down"])


def _shared_hidden(p: dict, x: torch.Tensor) -> torch.Tensor:
    return common.swiglu(common.matmul(x, p["shared/w_gate"]),
                         common.matmul(x, p["shared/w_up"]))
