"""Sharding rules (logical axes -> mesh axes), placement on a ``DeviceMesh`` and
the named-axis collectives of the port's ``shard_map``-style bodies."""

from .rules import (
    DEFAULT_RULES,
    MeshCtx,
    all_gather,
    as_dtensor,
    axis_index,
    collective_counts,
    constrain,
    distribute,
    full_value,
    local_block,
    logical_to_spec,
    mesh_axes,
    placements,
    psum,
    relayout,
    reset_collective_counts,
    shard_bytes,
    shard_shape,
    spec_entry,
    spec_of,
    spec_tree,
)

__all__ = ["DEFAULT_RULES", "MeshCtx", "all_gather", "as_dtensor", "axis_index",
           "collective_counts", "constrain", "distribute", "full_value", "local_block",
           "logical_to_spec", "mesh_axes", "placements", "psum", "relayout",
           "reset_collective_counts", "shard_bytes", "shard_shape", "spec_entry", "spec_of",
           "spec_tree"]
