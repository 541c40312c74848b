"""Logical-axis sharding rules, activation hints and the placement of
tensors as shards on a mesh (the twin of ``repro.sharding``, plus the
port's ``placement``)."""

from repro_torch.sharding.rules import (  # noqa: F401
    FSDP_RULES,
    TP_RULES,
    P,
    ShardingRules,
    batch_spec,
    cache_spec,
    chip_memory,
    data_axes,
    fsdp_recommended,
    make_rules,
    mesh_axis_size,
)
