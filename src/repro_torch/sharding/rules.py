"""Logical-axis -> mesh-axis rules (T5X-style), with divisibility fallback.

The twin of ``repro.sharding.rules``, on the port's ``launch.mesh.Mesh``.
Two rule sets:

* ``tp``       — tensor/expert parallelism only: weights sharded on ``model``,
                 replicated across ``data``.
* ``tp_fsdp``  — additionally shards the ``embed`` (d_model) dimension of every
                 weight over ``data`` (ZeRO-3/FSDP).

A logical axis maps to its mesh axis only when the dimension is divisible by
the mesh axis size (granite's kv_heads=1 falls back to replicated; the KV
*cache* then shards on sequence instead, see :func:`cache_spec`).

A spec is a :class:`P`: one entry per dimension, a mesh axis name, a tuple
of names, or None (replicated), as ``jax.sharding.PartitionSpec``.
``sharding.placement`` holds tensors as shards by these specs.
"""

from __future__ import annotations

import dataclasses

TP_RULES: dict[str, str | None] = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_mlp": None,
    "inner": "model",
    "inner2": None,
    "q_lora": None,
    "kv_lora": None,
    "state": None,
    "embed": None,
    "layers": None,
}

FSDP_RULES = dict(TP_RULES, embed="data", q_lora="data")


class P(tuple):
    """A partition spec: ``P("data", None)`` splits dimension 0 over the
    ``data`` axis and replicates dimension 1; ``P()`` replicates every
    dimension.  A tuple of its entries, normalized as
    ``jax.sharding.PartitionSpec`` normalizes them: a one-name tuple entry
    is that name, an empty one None."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


def axis_sizes(mesh) -> dict:
    """Mesh axis name -> size."""
    return dict(mesh.shape)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: dict
    mesh: object

    def spec_for(self, shape, axes) -> P:
        if len(shape) != len(axes):
            raise ValueError(f"shape {shape} and axes {axes} differ in rank")
        mesh_shape = axis_sizes(self.mesh)
        used: set[str] = set()
        out = []
        for dim, ax in zip(shape, axes):
            mapped = self.rules.get(ax) if ax is not None else None
            if (
                mapped is not None
                and mapped not in used
                and mapped in mesh_shape
                and dim % mesh_shape[mapped] == 0
            ):
                out.append(mapped)
                used.add(mapped)
            else:
                out.append(None)
        return P(*out)

    def sharding_for(self, shape, axes):
        from repro_torch.sharding.placement import Sharding

        return Sharding(self.mesh, self.spec_for(shape, axes))

    def param_specs(self, table_axes: dict, table_shapes: dict) -> dict:
        return {
            path: self.spec_for(table_shapes[path], axes)
            for path, axes in table_axes.items()
        }


def make_rules(mesh, fsdp: bool = False) -> ShardingRules:
    return ShardingRules(FSDP_RULES if fsdp else TP_RULES, mesh)


def data_axes(mesh) -> tuple[str, ...]:
    """Axes carrying the global batch ('pod' + 'data' when present)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_spec(mesh) -> P:
    return P(data_axes(mesh))


def cache_spec(mesh, n_kv_heads: int, kind: str = "attn") -> P:
    """KV-cache sharding: (layers, batch, seq, heads, dim).

    Heads shard on ``model`` when divisible; otherwise the sequence dimension
    takes ``model`` (flash-decoding style: the softmax combines the shards'
    partial sums).  MLA latent caches always shard on sequence (the latent
    dim is contracted every step).
    """
    model = mesh_axis_size(mesh, "model")
    d = data_axes(mesh)
    if kind == "mla":
        return P(None, d, "model", None)
    if n_kv_heads % model == 0:
        return P(None, d, None, "model", None)
    return P(None, d, "model", None, None)


def fsdp_recommended(n_params: int, mesh, hbm_per_chip: float = 16e9) -> bool:
    """FSDP when fp32 params + Adam(m, v) replicated over data would overflow.

    12 bytes/param (fp32 master + m + v) divided by the model axis only.
    The default ``hbm_per_chip`` is ``repro``'s (a TPU's); the mesh
    programs pass :func:`chip_memory`.
    """
    model = mesh_axis_size(mesh, "model")
    bytes_per_chip = 12.0 * n_params / model
    return bytes_per_chip > 0.5 * hbm_per_chip


def chip_memory(mesh) -> float:
    """The per-chip budget :func:`fsdp_recommended` compares against on
    ``mesh``: its first device's memory on a card, else ``repro``'s
    default."""
    import torch

    device = mesh.first_device
    if device.type == "cuda":
        return float(torch.cuda.get_device_properties(device).total_memory)
    return 16e9


def mesh_axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)
