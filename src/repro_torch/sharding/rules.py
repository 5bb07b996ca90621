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
* :func:`psum`, :func:`pbroadcast`, :func:`all_gather`,
  :func:`psum_scatter`, :func:`pmax` and :func:`axis_index` are
  ``jax.lax``'s collectives over named mesh axes, for the port's
  ``shard_map``-style bodies, built on ``all_reduce``, the list form of
  ``all_gather`` and ``reduce_scatter_tensor`` (gloo runs all three on CUDA
  tensors).  Each counts its calls and bytes by kind
  (:func:`collective_counts`), in the backward too.

The collectives are ``torch.autograd.Function``\\s with the transposes that
``shard_map`` gives them, so a train step differentiates through the mesh
forward (Megatron's ``f``/``g`` pair is :func:`pbroadcast`/:func:`psum`):

=================  ===========================  ==============================
collective         forward                      backward
=================  ===========================  ==============================
``psum``           ``all_reduce``               the cotangent as it is
``pbroadcast``     identity                     ``all_reduce``
``all_gather``     list ``all_gather``, tiled   ``reduce_scatter``, or
                                                ``all_reduce`` and this rank's
                                                block (``MeshCtx.fsdp_grad``)
``pmax``           ``all_reduce`` (max)         none: its result is detached
``sp_gather``      list ``all_gather``, tiled   ``reduce_scatter``
``sp_scatter``     ``reduce_scatter``           list ``all_gather``, tiled
=================  ===========================  ==============================

:func:`sp_gather` and :func:`sp_scatter` are sequence parallelism's pair
(the rule ``seq -> model``: the residual stream cut along its sequence over
the model axis between blocks, Megatron's ``g`` and ``g-bar``): a block's
input is gathered whole where it enters the column-parallel products, and
each row-parallel sum becomes a reduce-scatter back to the rank's block.

A gather's backward sums the ranks' cotangents, so it assumes what every
gather of the port's train step meets: each rank uses the gathered value on
rows of its own (a weight's FSDP blocks on a data rank's batch rows), and
its cotangent is a partial sum.  A replicated value that enters a region
the model axis splits goes through :func:`pbroadcast`.

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

import torch

from ..obs.timing import Stopwatch

__all__ = ["DEFAULT_RULES", "MeshCtx", "all_gather", "as_dtensor", "axis_index", "block",
           "block_index", "collective_counts", "constrain", "distribute", "full_value", "like",
           "local_block", "logical_to_spec", "mesh_axes", "pbroadcast", "placements", "pmax",
           "psum", "psum_scatter", "relayout", "reset_collective_counts", "row_sum",
           "seq_block", "shard_bytes", "shard_shape", "sp_gather", "sp_scatter", "spec_at",
           "spec_entry", "spec_of", "spec_tree", "tp_in"]

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
    ``DeviceMesh`` (``None`` for the dry run's arithmetic).

    ``fsdp_grad`` is how a gather's backward reduces the ranks' partial
    gradients: ``"reduce_scatter"`` (each rank receives the sum of its own
    block: the reference's ``grad_reshard=True``) or ``"all_reduce"`` (every
    rank receives the whole sum and keeps its block).  The values are the
    same; the collective and its wire bytes differ.

    ``same_rows`` names the data axes whose ranks compute the same rows: a
    batch the divisibility fallback replicates (a microbatch of 16 rows on
    32 data ranks).  Their cotangents are then whole, not partial sums: a
    gather's backward over such an axis keeps its own block of the
    cotangent, and no gradient is summed over it."""

    axes: tuple[tuple[str, int], ...]
    rules: tuple[tuple[str, tuple[str, ...]], ...] = tuple(DEFAULT_RULES.items())
    mesh: object = dataclasses.field(default=None, compare=False)
    fsdp_grad: str = dataclasses.field(default="reduce_scatter", compare=False)
    same_rows: tuple[str, ...] = dataclasses.field(default=(), compare=False)

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
#: calls and bytes of each collective kind by the mesh axis it ran over, with
#: the axis's size (the group's ranks)
_BY_AXIS: dict[str, dict[str, dict[str, int]]] = {}


def collective_counts(by_axis: bool = False) -> dict:
    """``{kind: {"calls", "bytes", "seconds"}}`` of this process's collectives since
    the last reset; ``seconds`` is the host's wall time inside the calls
    (they return when their result is in place).  ``bytes`` is the operand
    this rank passes: its block for an ``all_gather``, the whole input of a
    ``reduce_scatter``.  ``by_axis``: ``{kind: {axis: {"calls", "bytes",
    "group"}}}`` instead, ``group`` the axis's size."""
    if by_axis:
        return {k: {a: dict(c) for a, c in v.items()} for k, v in _BY_AXIS.items()}
    return {k: dict(v) for k, v in _COUNTS.items()}


def reset_collective_counts() -> None:
    _COUNTS.clear()
    _BY_AXIS.clear()


def _count(kind: str, x, seconds: float, axis: str, group: int) -> None:
    nbytes = x.numel() * x.element_size()
    c = _COUNTS.setdefault(kind, {"calls": 0, "bytes": 0, "seconds": 0.0})
    c["calls"] += 1
    c["bytes"] += nbytes
    c["seconds"] += seconds
    a = _BY_AXIS.setdefault(kind, {}).setdefault(axis, {"calls": 0, "bytes": 0, "group": group})
    a["calls"] += 1
    a["bytes"] += nbytes


def _axis_size(mesh, a: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(a))


def _all_reduce(ctx, x, axes, op=None):
    """The sum (or ``op``) of ``x`` over mesh axes ``axes``, one ``all_reduce`` per
    axis, innermost first; a new tensor."""
    import torch.distributed as dist

    mesh = _mesh(ctx)
    out = x.contiguous().clone()
    for a in reversed(mesh_axes(axes)):
        n = _axis_size(mesh, a)
        if n == 1:
            continue
        sw = Stopwatch()
        dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=mesh.get_group(a))
        _count("all_reduce", out, sw.elapsed(), a, n)
    return out


def _gather(ctx, x, a: str, dim: int):
    """The blocks of ``x`` over mesh axis ``a`` concatenated along ``dim``."""
    import torch.distributed as dist

    mesh = _mesh(ctx)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(_axis_size(mesh, a))]
    sw = Stopwatch()
    dist.all_gather(parts, x, group=mesh.get_group(a))
    _count("all_gather", x, sw.elapsed(), a, len(parts))
    return torch.cat(parts, dim=dim)


def _scatter(ctx, x, a: str, dim: int):
    """The sum of ``x`` over mesh axis ``a``, cut along ``dim`` into one block
    per rank of the axis: this rank's block (``reduce_scatter``)."""
    import torch.distributed as dist

    mesh = _mesh(ctx)
    n = _axis_size(mesh, a)
    whole = x.movedim(dim, 0).contiguous()
    if whole.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {n} ways")
    out = whole.new_empty((whole.shape[0] // n, *whole.shape[1:]))
    sw = Stopwatch()
    dist.reduce_scatter_tensor(out, whole, group=mesh.get_group(a))
    _count("reduce_scatter", whole, sw.elapsed(), a, n)
    return out.movedim(0, dim).contiguous()


def _own_block(ctx, x, a: str, dim: int):
    """This rank's block along ``dim`` of ``x`` cut over mesh axis ``a``."""
    n = _axis_size(_mesh(ctx), a)
    step = x.shape[dim] // n
    return x.narrow(dim, axis_index(ctx, a) * step, step)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(fctx, ctx, x, axes):
        return _all_reduce(ctx, x, axes)

    @staticmethod
    def backward(fctx, g):
        return None, g, None


class _Pbroadcast(torch.autograd.Function):
    @staticmethod
    def forward(fctx, ctx, x, axes):
        fctx.mesh_ctx, fctx.axes = ctx, axes
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return None, _all_reduce(fctx.mesh_ctx, g, fctx.axes), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, ctx, x, a, dim):
        fctx.mesh_ctx, fctx.a, fctx.dim = ctx, a, dim
        return _gather(ctx, x, a, dim)

    @staticmethod
    def backward(fctx, g):
        ctx, a, dim = fctx.mesh_ctx, fctx.a, fctx.dim
        # either way a contiguous block: a later sum over it (the clip's norm)
        # adds its elements in one order
        if a in ctx.same_rows:  # every rank of the axis holds the whole cotangent
            return None, _own_block(ctx, g, a, dim).contiguous(), None, None
        if ctx.fsdp_grad == "reduce_scatter":
            return None, psum_scatter(ctx, g, a, dim), None, None
        if ctx.fsdp_grad != "all_reduce":
            raise ValueError(f"fsdp_grad={ctx.fsdp_grad!r}: 'reduce_scatter' or 'all_reduce'")
        return None, _own_block(ctx, _all_reduce(ctx, g, a), a, dim).contiguous(), None, None


def psum(ctx, x, axes):
    """The sum of ``x`` over the ranks of mesh axes ``axes`` (a name or a tuple),
    one ``all_reduce`` per axis, innermost first; a new tensor.  Its backward
    passes the cotangent through (every rank holds the sum)."""
    return _Psum.apply(ctx, x, axes)


def pbroadcast(ctx, x, axes):
    """``x`` itself, where a value every rank of ``axes`` holds enters a region
    those axes split; the backward sums the ranks' partial cotangents."""
    return _Pbroadcast.apply(ctx, x, axes)


def spec_at(specs, *path):
    """The entry at ``path`` (keys, then a dim) of a tree of block specs: the mesh
    axes that dim is split over, ``None`` where it is whole or without specs
    (no mesh)."""
    for key in path:
        if specs is None:
            return None
        specs = specs[key]
    return specs


def tp_in(ctx, x, split, seq=None):
    """``x``, a value every model rank holds, as it enters a product whose weight
    the model axis splits (``split`` not ``None``): the same values, and in the
    backward the sum of the ranks' partial cotangents (:func:`pbroadcast`).

    Under sequence parallelism (``seq``, the mesh axis that cuts the residual
    stream's sequence) it is ``x`` itself: an activation read from the
    stream's gather has its partial cotangents summed by the gather's
    backward (:func:`sp_gather`), and a parameter by the train step's sum of
    sequence-parallel gradients (``model._sum_replicated``)."""
    return x if split is None or seq is not None else pbroadcast(ctx, x, ctx.tp_axis)


def row_sum(ctx, y, contracted, seq=None):
    """A row-parallel product's partial sums over the model axis (none when its
    ``contracted`` dim is whole on every rank).  Under sequence parallelism
    (``seq``) this rank's block of the sum along the sequence (dim 1): a
    reduce-scatter (:func:`sp_scatter`), or the block itself of a product
    computed whole on every rank."""
    if seq is None:
        return y if contracted is None else psum(ctx, y, ctx.tp_axis)
    return seq_block(ctx, y, seq) if contracted is None else sp_scatter(ctx, y, seq)


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, ctx, x, a):
        fctx.mesh_ctx, fctx.a = ctx, a
        return _gather(ctx, x, a, 1)

    @staticmethod
    def backward(fctx, g):
        return None, _scatter(fctx.mesh_ctx, g, fctx.a, 1), None


class _SeqScatter(torch.autograd.Function):
    @staticmethod
    def forward(fctx, ctx, x, a):
        fctx.mesh_ctx, fctx.a = ctx, a
        return _scatter(ctx, x, a, 1)

    @staticmethod
    def backward(fctx, g):
        return None, _gather(fctx.mesh_ctx, g, fctx.a, 1), None


def sp_gather(ctx, x, seq):
    """The whole sequence (dim 1) of ``x`` from the ranks' blocks over mesh axis
    ``seq`` (``all_gather``), where a block enters the products of a layer;
    ``x`` itself for ``seq`` ``None``.  The backward is a ``reduce_scatter``:
    the ranks' partial cotangents, summed, this rank's block.  It is an
    activation's gather, so ``MeshCtx.fsdp_grad`` and ``same_rows`` (the FSDP
    parameter reduction's knobs) do not touch it."""
    return x if seq is None else _SeqGather.apply(ctx, x, seq)


def sp_scatter(ctx, x, seq):
    """The sum of the ranks' partial ``x`` over mesh axis ``seq``, of which this
    rank keeps its block of the sequence (dim 1; ``reduce_scatter``); ``x``
    itself for ``seq`` ``None``.  The backward gathers the blocks' cotangents
    (``all_gather``): every rank's partial term reaches every block."""
    return x if seq is None else _SeqScatter.apply(ctx, x, seq)


def seq_block(ctx, x, seq):
    """This rank's block of the sequence (dim 1) of ``x``, which every rank of
    mesh axis ``seq`` holds whole (no communication; the backward pads the
    cotangent with zeros, a partial term of the whole one)."""
    return x if seq is None else _own_block(ctx, x, seq, 1)


def pmax(ctx, x, axes):
    """The largest ``x`` over the ranks of mesh axes ``axes``, detached (for a
    logsumexp's shift, which no gradient depends on)."""
    import torch.distributed as dist

    return _all_reduce(ctx, x.detach(), axes, op=dist.ReduceOp.MAX)


def all_gather(ctx, x, axes, dim: int = 0):
    """The blocks of ``x`` over mesh axes ``axes`` concatenated along ``dim`` in
    axis-index order, the first axis major (``jax.lax.all_gather(..., tiled=True)``).
    The backward reduces the ranks' partial cotangents to this rank's block
    (``ctx.fsdp_grad``)."""
    for a in reversed(mesh_axes(axes)):
        if _axis_size(_mesh(ctx), a) > 1:
            x = _Gather.apply(ctx, x, a, dim)
    return x.contiguous()


def psum_scatter(ctx, x, axes, dim: int = 0):
    """The sum of ``x`` over mesh axes ``axes``, of which this rank keeps its block
    along ``dim`` (``jax.lax.psum_scatter(..., tiled=True)``: the blocks in
    :func:`all_gather`'s order), one ``reduce_scatter`` per axis, the first
    axis first; a contiguous tensor.  It is the gathers' backward and has
    none of its own."""
    for a in mesh_axes(axes):
        if _axis_size(_mesh(ctx), a) > 1:
            x = _scatter(ctx, x, a, dim)
    return x


def block_index(ctx, axes) -> int:
    """This rank's block of a dim cut over mesh axes ``axes``, the first axis major."""
    sizes, idx = ctx.axis_sizes, 0
    for a in mesh_axes(axes):
        idx = idx * sizes[a] + axis_index(ctx, a)
    return idx


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
            step = local.shape[d] // n
            if step * n != local.shape[d]:
                raise ValueError(f"dim {d} of {tuple(local.shape)} does not split {n} ways")
            local = local.narrow(d, block_index(ctx, axes) * step, step)
    return local


def local_block(ctx, x, spec: tuple):
    """This rank's block of ``x`` laid out by ``spec`` (``x`` a ``DTensor`` on
    ``ctx``'s mesh, or a whole tensor every rank holds): a ``shard_map``
    body's view of its argument under ``in_specs`` ``spec``."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return relayout(ctx, block(x), spec_of(ctx, x), spec)
    return relayout(ctx, x, (None,) * x.dim(), spec)


def block(x):
    """This rank's block of a ``DTensor`` (a plain tensor as it is).  Under
    autograd the block's gradient is this rank's block of ``x``'s: the
    placements stay, so no backward calls ``redistribute``."""
    from torch.distributed.tensor import DTensor

    return x.to_local(grad_placements=x.placements) if isinstance(x, DTensor) else x


def like(ref, local):
    """``local`` as a ``DTensor`` laid out as ``ref`` is (``local`` itself where
    ``ref`` is a plain tensor)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(ref, DTensor):
        return local
    return DTensor.from_local(local, ref.device_mesh, ref.placements, run_check=False,
                              shape=ref.shape, stride=ref.stride())


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
