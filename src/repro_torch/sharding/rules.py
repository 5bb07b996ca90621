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

A :class:`MeshCtx` holds the mesh's axis sizes and, on ranks started by
:func:`repro_torch.launch.mesh.run_on_mesh`, the ``torch.distributed``
``DeviceMesh`` itself: the dry run's arithmetic and placement share the
class.  Placement is the second half of this module:

* :func:`placements`, :func:`distribute` and :func:`constrain` (the
  reference's ``with_sharding_constraint``) turn a spec into a ``DTensor``
  — the port's sharded array, playing the part of a ``jax.Array`` with its
  ``NamedSharding``;
* :func:`relayout` moves a rank's local block from one spec to another, the
  port's ``shard_map`` ``in_specs``: it gathers the mesh axes the new spec
  drops and slices for those it adds;
* :func:`psum`, :func:`all_gather` and :func:`axis_index` are
  ``jax.lax``'s collectives over named mesh axes, for the port's
  ``shard_map``-style bodies, built on ``all_reduce`` and the list form of
  ``all_gather`` (the two collectives gloo runs on CUDA tensors).  Each
  counts its calls and bytes by kind (:func:`collective_counts`).

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

from ..obs.timing import Stopwatch

__all__ = ["DEFAULT_RULES", "MeshCtx", "all_gather", "as_dtensor", "axis_index",
           "collective_counts", "constrain", "distribute", "full_value", "local_block",
           "logical_to_spec", "mesh_axes", "placements", "psum", "relayout",
           "reset_collective_counts", "shard_bytes", "shard_shape", "spec_entry", "spec_of",
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
    """A mesh's axis sizes, the rule table in force on it and, on a rank, the
    ``DeviceMesh`` (``None`` for the dry run's arithmetic)."""

    axes: tuple[tuple[str, int], ...]
    rules: tuple[tuple[str, tuple[str, ...]], ...] = tuple(DEFAULT_RULES.items())
    mesh: object = dataclasses.field(default=None, compare=False)

    @classmethod
    def of(cls, axis_sizes: dict[str, int]) -> "MeshCtx":
        """The default rules on a mesh given as ``{axis name: size}`` (in mesh order)."""
        return cls(axes=tuple((k, int(v)) for k, v in axis_sizes.items()))

    @classmethod
    def on(cls, mesh) -> "MeshCtx":
        """The default rules on a ``DeviceMesh``; the axis sizes are the mesh's."""
        return cls(axes=tuple(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape))), mesh=mesh)

    @property
    def rule_map(self) -> dict[str, tuple[str, ...]]:
        return dict(self.rules)

    @property
    def axis_sizes(self) -> dict[str, int]:
        return dict(self.axes)

    def present(self, axes: tuple[str, ...]) -> tuple[str, ...]:
        return tuple(a for a in axes if a in self.axis_sizes)

    @property
    def dp_axes(self) -> tuple[str, ...]:
        return self.present(("pod", "data"))

    @property
    def tp_axis(self) -> str | None:
        return "model" if "model" in self.axis_sizes else None

    def tp_size(self) -> int:
        return self.axis_sizes.get("model", 1)

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


# --------------------------------------------------------------------------
# placement on a DeviceMesh
# --------------------------------------------------------------------------


def mesh_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (``None``, a name, or a tuple of names)."""
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def spec_entry(names) -> str | tuple | None:
    """The spec entry of a dim split over mesh axes ``names`` (``mesh_axes``' inverse)."""
    names = tuple(names)
    return None if not names else names[0] if len(names) == 1 else names


def _mesh(ctx):
    if ctx is None or ctx.mesh is None:
        raise ValueError("placement needs a MeshCtx on a DeviceMesh (MeshCtx.on)")
    return ctx.mesh


def placements(ctx, spec: tuple) -> tuple:
    """One ``Shard(dim)`` or ``Replicate()`` per mesh dim for ``spec``.

    A dim split over several mesh axes lists them in mesh order (the order
    ``DTensor`` nests its shards in), as the rule table does.
    """
    from torch.distributed.tensor import Replicate, Shard

    names = list(_mesh(ctx).mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = mesh_axes(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry!r} is not in mesh order {names}")
        for p in pos:
            out[p] = Shard(dim)
    return tuple(out)


def spec_of(ctx, x) -> tuple:
    """The spec of a ``DTensor`` on ``ctx``'s mesh (replicated for a plain tensor)."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return (None,) * x.dim()
    dims: list[list[str]] = [[] for _ in range(x.dim())]
    for name, p in zip(_mesh(ctx).mesh_dim_names, x.placements):
        if isinstance(p, Shard):
            dims[p.dim].append(name)
        elif not p.is_replicate():
            raise ValueError(f"placement {p} is neither Shard nor Replicate")
    return tuple(spec_entry(d) for d in dims)


def axis_index(ctx, axis: str) -> int:
    """This rank's coordinate on mesh axis ``axis`` (``jax.lax.axis_index``)."""
    return int(_mesh(ctx).get_local_rank(axis))


#: calls, bytes (this rank's payload) and host seconds of each collective kind
#: since the last reset
_COUNTS: dict[str, dict[str, float]] = {}


def collective_counts() -> dict[str, dict[str, float]]:
    """``{kind: {"calls", "bytes", "seconds"}}`` of this process's collectives since
    the last reset; ``seconds`` is the host's wall time inside the calls
    (they return when their result is in place)."""
    return {k: dict(v) for k, v in _COUNTS.items()}


def reset_collective_counts() -> None:
    _COUNTS.clear()


def _count(kind: str, x, seconds: float) -> None:
    c = _COUNTS.setdefault(kind, {"calls": 0, "bytes": 0, "seconds": 0.0})
    c["calls"] += 1
    c["bytes"] += x.numel() * x.element_size()
    c["seconds"] += seconds


def psum(ctx, x, axes):
    """The sum of ``x`` over the ranks of mesh axes ``axes`` (a name or a tuple),
    one ``all_reduce`` per axis, innermost first; a new tensor."""
    import torch.distributed as dist

    mesh = _mesh(ctx)
    out = x.contiguous().clone()
    for a in reversed(mesh_axes(axes)):
        if mesh.size(mesh.mesh_dim_names.index(a)) == 1:
            continue
        sw = Stopwatch()
        dist.all_reduce(out, group=mesh.get_group(a))
        _count("all_reduce", out, sw.elapsed())
    return out


def all_gather(ctx, x, axes, dim: int = 0):
    """The blocks of ``x`` over mesh axes ``axes`` concatenated along ``dim`` in
    axis-index order, the first axis major (``jax.lax.all_gather(..., tiled=True)``)."""
    import torch
    import torch.distributed as dist

    mesh = _mesh(ctx)
    out = x.contiguous()
    for a in reversed(mesh_axes(axes)):
        n = mesh.size(mesh.mesh_dim_names.index(a))
        if n == 1:
            continue
        parts = [torch.empty_like(out) for _ in range(n)]
        sw = Stopwatch()
        dist.all_gather(parts, out, group=mesh.get_group(a))
        _count("all_gather", out, sw.elapsed())
        out = torch.cat(parts, dim=dim)
    return out


def relayout(ctx, local, in_spec: tuple, out_spec: tuple):
    """This rank's block of a tensor laid out by ``out_spec``, from its block
    under ``in_spec``: every dim whose mesh axes change is gathered whole
    over its old axes, then cut for its new ones.  A dim that keeps its
    axes is left alone, so an unchanged spec returns ``local`` itself."""
    if len(in_spec) != local.dim() or len(out_spec) != local.dim():
        raise ValueError(f"specs {in_spec} -> {out_spec} for a {local.dim()}-d block")
    sizes = ctx.axis_sizes
    moved = [d for d in range(local.dim()) if mesh_axes(in_spec[d]) != mesh_axes(out_spec[d])]
    for d in moved:
        if mesh_axes(in_spec[d]):
            local = all_gather(ctx, local, in_spec[d], dim=d)
    for d in moved:
        axes = mesh_axes(out_spec[d])
        if axes:
            n = math.prod(sizes[a] for a in axes)
            idx = 0
            for a in axes:
                idx = idx * sizes[a] + axis_index(ctx, a)
            step = local.shape[d] // n
            if step * n != local.shape[d]:
                raise ValueError(f"dim {d} of {tuple(local.shape)} does not split {n} ways")
            local = local.narrow(d, idx * step, step)
    return local


def local_block(ctx, x, spec: tuple):
    """This rank's block of ``x`` laid out by ``spec`` (``x`` a ``DTensor`` on
    ``ctx``'s mesh, or a whole tensor every rank holds): a ``shard_map``
    body's view of its argument under ``in_specs`` ``spec``."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return relayout(ctx, x.to_local(), spec_of(ctx, x), spec)
    return relayout(ctx, x, (None,) * x.dim(), spec)


def as_dtensor(ctx, local, spec: tuple, shape):
    """The ``DTensor`` of ``shape`` laid out by ``spec`` whose block on this rank
    is ``local`` (no communication: every rank passes its own block)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, _mesh(ctx), placements(ctx, spec), run_check=False,
                              shape=tuple(shape), stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= int(n)
    return tuple(reversed(stride))


def distribute(ctx, x, *axes):
    """``x`` (a whole tensor every rank holds, or a ``DTensor``) as a ``DTensor``
    laid out by the logical ``axes``; the local block is a copy of its own,
    so the whole tensor can be freed."""
    spec = logical_to_spec(ctx, tuple(x.shape), tuple(axes))
    return as_dtensor(ctx, local_block(ctx, x, spec).contiguous().clone(), spec, x.shape)


def constrain(ctx, x, *axes):
    """``x`` laid out by the logical ``axes`` with the divisibility fallback
    (the reference's ``with_sharding_constraint``); a no-op without a mesh.
    The local block shares storage with ``x``'s where the layout keeps it."""
    if ctx is None or ctx.mesh is None:
        return x
    spec = logical_to_spec(ctx, tuple(x.shape), tuple(axes))
    return as_dtensor(ctx, local_block(ctx, x, spec), spec, x.shape)


def full_value(ctx, x):
    """The whole tensor of a ``DTensor``, gathered on every rank (a plain tensor as it is)."""
    return local_block(ctx, x, (None,) * x.dim())
