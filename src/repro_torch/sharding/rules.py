"""Logical-axis -> mesh-axis sharding rules: the arithmetic, without devices.

Port of the device-free half of the JAX package's ``repro/sharding/rules.py``.
Every parameter, cache entry and input carries a tuple of logical axis names
per dim (``transformer.param_axes``, ``transformer.cache_axes``,
``launch/specs.py``); a rule table maps each logical name to mesh axes, and
:func:`logical_to_spec` applies it with the reference's **divisibility
fallback**: a dim whose size does not divide by its mapped mesh axes is
replicated instead (qwen2-0.5b's 14 heads on a 16-way model axis), and a
mesh axis shards at most one dim of a tensor.

A spec is a tuple with one entry per dim: ``None`` (replicated), a mesh axis
name, or a tuple of names (``("pod", "data")``) — the entries of the JAX
package's ``PartitionSpec``.  :func:`shard_shape` and :func:`shard_bytes`
give one device's share, from which the dry run
(:mod:`repro_torch.launch.dryrun`) reads per-device state bytes on the
production meshes.

A :class:`MeshCtx` holds the mesh as an axis-name -> size map
(:func:`repro_torch.launch.mesh.production_mesh_axes`): no device is created.
Placement — the reference's ``constrain`` (``with_sharding_constraint``) and
parameters laid out on a device mesh — waits for the multi-card slice.

Default rule table (mesh axes: pod, data, model):
  embed   -> data          (FSDP: params sharded over the data axis)
  heads/kv_heads/mlp/vocab/expert/rnn -> model  (TP / EP)
  layers  -> None          (the JAX package's stacked scan axis; the port
                            keeps one tree per layer and has no such dim)
Batch is data-parallel over (pod, data); ``long_500k`` overrides the KV
cache to sequence-parallel over data (see ``launch/specs.py``).
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["DEFAULT_RULES", "MeshCtx", "logical_to_spec", "shard_bytes", "shard_shape",
           "spec_tree"]

DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "embed": ("data",),  # FSDP
    "embed_e": ("data",),  # expert-weight d_model dim: FSDP even at inference
    # (MoE param volume never fits TP-only; dense params do)
    "moe_ff": (),  # expert d_ff dim; decode overrides to ("data",) so expert
    # weights stay fully resident (tokens are dispatched instead)
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "rnn": ("model",),
    "head_dim": ("model",),  # KV-cache fallback when kv_heads can't shard
    "state": (),
    "layers": (),
    "batch": ("pod", "data"),
    "seq": (),
    "seq_sp": ("data",),  # sequence parallelism (long-context override)
}


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    """A mesh's axis sizes and the rule table in force on it."""

    axes: tuple[tuple[str, int], ...]
    rules: tuple[tuple[str, tuple[str, ...]], ...] = tuple(DEFAULT_RULES.items())

    @classmethod
    def of(cls, axis_sizes: dict[str, int]) -> "MeshCtx":
        """The default rules on a mesh given as ``{axis name: size}`` (in mesh order)."""
        return cls(axes=tuple((k, int(v)) for k, v in axis_sizes.items()))

    @property
    def rule_map(self) -> dict[str, tuple[str, ...]]:
        return dict(self.rules)

    @property
    def axis_sizes(self) -> dict[str, int]:
        return dict(self.axes)

    def with_rules(self, **overrides) -> "MeshCtx":
        r = self.rule_map
        r.update(overrides)
        return dataclasses.replace(self, rules=tuple(r.items()))


def logical_to_spec(ctx, shape: tuple[int, ...], axes: tuple[str | None, ...]) -> tuple:
    """Map logical axes to a spec tuple, replicating non-divisible dims.

    ``ctx`` is a :class:`MeshCtx` or anything with ``rule_map`` and
    ``axis_sizes``.
    """
    assert len(shape) == len(axes), (shape, axes)
    rule_map = ctx.rule_map
    sizes = ctx.axis_sizes
    used: set[str] = set()
    entries = []
    for dim, name in zip(shape, axes):
        if name is None:
            entries.append(None)
            continue
        mesh_axes = tuple(a for a in rule_map.get(name, ()) if a in sizes and a not in used)
        total = math.prod(sizes[a] for a in mesh_axes) if mesh_axes else 1
        if mesh_axes and dim % total == 0:
            entries.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
            used.update(mesh_axes)
        else:
            entries.append(None)
    return tuple(entries)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def spec_tree(ctx, tree, axes_tree):
    """The spec of every leaf of ``tree`` (tensors, or anything with ``shape``),
    from the parallel logical-axes tree (dicts and lists of axis tuples)."""
    if _is_axes(axes_tree):
        return logical_to_spec(ctx, tuple(tree.shape), axes_tree)
    if isinstance(axes_tree, dict):
        if tree.keys() != axes_tree.keys():
            raise ValueError(f"tree keys {sorted(tree)} != axes keys {sorted(axes_tree)}")
        return {k: spec_tree(ctx, tree[k], axes_tree[k]) for k in tree}
    if isinstance(axes_tree, (list, tuple)):
        if len(tree) != len(axes_tree):
            raise ValueError(f"{len(tree)} subtrees against {len(axes_tree)} axes subtrees")
        return [spec_tree(ctx, t, a) for t, a in zip(tree, axes_tree)]
    raise TypeError(f"not an axes tree: {axes_tree!r}")


def shard_shape(ctx, shape: tuple[int, ...], spec: tuple) -> tuple[int, ...]:
    """One device's block of a tensor of ``shape`` laid out by ``spec``."""
    sizes = ctx.axis_sizes
    out = []
    for dim, entry in zip(shape, spec):
        names = () if entry is None else (entry,) if isinstance(entry, str) else entry
        out.append(dim // math.prod(sizes[a] for a in names))
    return tuple(out)


def shard_bytes(ctx, shape: tuple[int, ...], spec: tuple, itemsize: int) -> int:
    """Bytes of one device's block (every device holds the same: the specs divide)."""
    return math.prod(shard_shape(ctx, shape, spec)) * int(itemsize)
