"""Dense MLP blocks (SwiGLU / GeLU), the twin of ``repro.models.mlp``,
and their column/row split over a mesh row (:func:`mlp_row`)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import common
from repro_torch.models.params import ParamDecl, ParamTable


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    d_model: int
    d_ff: int
    activation: str = "swiglu"  # swiglu | gelu | gelu_tanh


def mlp_param_table(cfg: MLPConfig) -> ParamTable:
    d, f = cfg.d_model, cfg.d_ff
    t: ParamTable = {
        "w_up": ParamDecl((d, f), ("embed", "mlp")),
        "w_down": ParamDecl((f, d), ("mlp", "embed"), init="output"),
    }
    if cfg.activation == "swiglu":
        t["w_gate"] = ParamDecl((d, f), ("embed", "mlp"))
    return t


def mlp(cfg: MLPConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return common.matmul(hidden(cfg, p, x), p["w_down"])


def hidden(cfg: MLPConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The activations the down projection reads."""
    up = common.matmul(x, p["w_up"])
    if cfg.activation == "swiglu":
        return common.swiglu(common.matmul(x, p["w_gate"]), up)
    return common.gelu(up)


def split_mlp(hidden_fn, p: dict, x: torch.Tensor, devices,
              down: str = "w_down") -> torch.Tensor:
    """A two-layer MLP over a mesh row: ``hidden_fn(weights, x)`` then the
    product with ``p[down]``, ``p`` a ``{name: Split}`` whose input weights
    split by columns and ``down`` by rows (the ``mlp`` axis on ``model``).
    Each device runs its columns; their partial products (float32) are
    summed on x's device and rounded once to x's dtype.  Whole when the
    model axis does not split them (or the row has one device)."""
    if p[down].dim is None or len(devices) == 1:
        w = {n: s.parts[0] for n, s in p.items()}
        return common.matmul(hidden_fn(w, x), w[down])
    parts = []
    for m, dev in enumerate(devices):
        w = {n: s.parts[m] for n, s in p.items()}
        parts.append(common.matmul(hidden_fn(w, x.to(dev)), w[down],
                                   f32=True))
    return common.sum_partials(parts, x.device, x.dtype)


def mlp_row(cfg: MLPConfig, p: dict, x: torch.Tensor, devices) -> torch.Tensor:
    """:func:`mlp` over a mesh row (:func:`split_mlp`)."""
    return split_mlp(lambda w, xx: hidden(cfg, w, xx), p, x, devices)
