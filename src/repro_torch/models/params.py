"""Declarative parameter tables (the twin of ``repro.models.params``).

Every model declares its parameters once as a flat ``{path: ParamDecl}``
table, in ``repro``'s einsum layouts (``wq`` is ``(d, heads, head_dim)``).
The table drives :func:`init_one` and :func:`num_params`; its logical axis
names are kept for the sharded LM, which is not ported yet.  ``repro``
draws from JAX's PRNG, whose bits cannot be matched: parity tests carry
``repro``'s weights across (``interop.params_from_reference``).

Stacked (scanned) layer groups prepend a ``layers`` axis to the declared
shape, as in ``repro``; the port's model holds one tensor per layer and
maps each back to its row of ``repro``'s stacked key
(``models.lm.LanguageModel.reference_names``).
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis names, len == len(shape)
    init: str = "normal"  # normal | zeros | ones | embed | output
    fan_in: int | None = None  # overrides shape-derived fan-in for "normal"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")


ParamTable = dict[str, ParamDecl]


def stack_table(table: ParamTable, count: int) -> ParamTable:
    """Prepend a scanned ``layers`` axis of size ``count`` to every decl."""
    return {
        path: ParamDecl(
            shape=(count, *decl.shape),
            axes=("layers", *decl.axes),
            init=decl.init,
            fan_in=decl.fan_in,
        )
        for path, decl in table.items()
    }


def prefix_table(prefix: str, table: ParamTable) -> ParamTable:
    return {f"{prefix}/{path}": decl for path, decl in table.items()}


def merge_tables(*tables: ParamTable) -> ParamTable:
    out: ParamTable = {}
    for t in tables:
        for k, v in t.items():
            if k in out:
                raise ValueError(f"duplicate param path {k!r}")
            out[k] = v
    return out


def init_std(decl: ParamDecl) -> float | None:
    """The normal draw's standard deviation under ``repro``'s rules
    (``_init_one``), or None for the constant inits (zeros, ones)."""
    if decl.init in ("zeros", "ones"):
        return None
    if decl.init == "embed":
        return 1.0
    if decl.fan_in is not None:
        fan_in = decl.fan_in
    else:
        # contracting dim: last-but-one for matrices, last for vectors
        fan_in = decl.shape[-2] if len(decl.shape) >= 2 else decl.shape[-1]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    if decl.init == "output":
        std = std * 0.5
    return std


@torch.no_grad()
def init_one(decl: ParamDecl, out: torch.Tensor,
             generator: torch.Generator) -> torch.Tensor:
    """Fill ``out`` (of ``decl.shape``) by ``decl``'s rule: zeros, ones, or a
    float32 normal draw from ``generator`` scaled by :func:`init_std` and
    cast to ``out``'s dtype.  The draw is made on the generator's device."""
    if tuple(out.shape) != tuple(decl.shape):
        raise ValueError(f"init of {decl.shape} into a tensor of "
                         f"{tuple(out.shape)}")
    std = init_std(decl)
    if std is None:
        return out.fill_(0.0 if decl.init == "zeros" else 1.0)
    draw = torch.randn(decl.shape, generator=generator,
                       device=generator.device, dtype=torch.float32)
    if std != 1.0:
        draw.mul_(std)
    return out.copy_(draw)


def num_params(table: ParamTable) -> int:
    return sum(math.prod(d.shape) for d in table.values())
