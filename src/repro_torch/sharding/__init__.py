"""Sharding-rule arithmetic (logical axes -> mesh axes) for the dry run; no placement yet."""

from .rules import DEFAULT_RULES, MeshCtx, logical_to_spec, shard_bytes, shard_shape, spec_tree

__all__ = ["DEFAULT_RULES", "MeshCtx", "logical_to_spec", "shard_bytes", "shard_shape",
           "spec_tree"]
