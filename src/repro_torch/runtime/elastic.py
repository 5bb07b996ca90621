"""Elastic scaling: re-shard a (restored) state onto a different mesh.

Port of the JAX package's ``repro/runtime/elastic.py``.  Checkpoints store
whole arrays and the model's logical axes; placement is purely a function of
(mesh, rules).  Growing or shrinking the cluster is therefore: restore
(:mod:`repro_torch.checkpoint`), then put every leaf onto the new mesh — the
reference's ``device_put`` with the new ``NamedSharding``\\s.  Here every
leaf's whole value is gathered on each rank (a leaf that is already whole
is taken as it is) and this rank's block of it under the new mesh's spec is
cut and copied into a ``DTensor`` (:func:`repro_torch.sharding.rules.distribute`),
one leaf at a time, so a rank holds at most one whole leaf beside its
shards.  Between two rule tables on one mesh (prefill's layout to
decode's) a leaf is gathered only over the axes that leave a dim
(:func:`repro_torch.sharding.rules.relayout`).  The values are moved,
never computed: the result is bit-identical.

Parameters reach a mesh the same way: :func:`repro_torch.convert.lm_params_from_arrays`
(or ``transformer.init_params``), then :func:`reshard_state` with
``old_ctx=None``.
"""

from __future__ import annotations

from ..sharding.rules import as_dtensor, full_value, local_block, placements, spec_tree

__all__ = ["reshard_state", "state_shardings", "state_specs"]


def state_specs(ctx, state, params_axes):
    """The spec tree of a state: a train state ``{params, opt{...}, step}``, or
    a parameter tree alone.  Optimizer slots that mirror the parameters
    (``mu``, ``nu``, an optional ``master``) share the parameters' specs;
    scalars replicate."""
    if "params" not in state:
        return spec_tree(ctx, state, params_axes)
    p_specs = spec_tree(ctx, state["params"], params_axes)
    opt = {k: (p_specs if isinstance(v, dict) else ()) for k, v in state["opt"].items()}
    return {"params": p_specs, "opt": opt, "step": ()}


def state_shardings(ctx, state, params_axes):
    """The placements (``Shard`` / ``Replicate`` per mesh dim) of every leaf
    of a state on ``ctx``'s mesh, as :func:`state_specs` lays it out."""
    return _map_specs(lambda spec: placements(ctx, spec), state_specs(ctx, state, params_axes))


def _map_specs(fn, specs):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_specs(fn, v) for v in specs]
    return fn(specs)


def reshard_state(state, old_ctx, new_ctx, params_axes):
    """Move a state onto ``new_ctx``'s mesh (elastic grow or shrink).

    ``state`` holds whole tensors (``old_ctx`` ``None``: a restored
    checkpoint, fresh parameters) or ``DTensor``\\s on ``old_ctx``'s mesh;
    every rank of both meshes calls this.  Returns the same tree of
    ``DTensor``\\s on the new mesh, each local block a copy of its own.
    """
    specs = state_specs(new_ctx, state, params_axes)

    same_mesh = old_ctx is not None and old_ctx.mesh is new_ctx.mesh

    def move(x, spec):
        if len(spec) != x.dim():
            raise ValueError(f"spec {spec} for a {x.dim()}-d leaf")
        if same_mesh:
            local = local_block(old_ctx, x, spec)
        else:
            whole = x if old_ctx is None else full_value(old_ctx, x)
            local = local_block(new_ctx, whole, spec)
        return as_dtensor(new_ctx, local.contiguous().clone(), spec, x.shape)

    return _tree_map_specs(move, state, specs)


def _tree_map_specs(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _tree_map_specs(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_tree_map_specs(fn, t, s) for t, s in zip(tree, specs, strict=True)]
    return fn(tree, specs)
