"""Dense MLP blocks (SwiGLU / GeLU), the twin of ``repro.models.mlp``."""

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
    up = common.matmul(x, p["w_up"])
    if cfg.activation == "swiglu":
        h = common.swiglu(common.matmul(x, p["w_gate"]), up)
    else:
        h = common.gelu(up)
    return common.matmul(h, p["w_down"])
