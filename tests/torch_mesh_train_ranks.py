"""Rank bodies of the port's mesh train-step tests, run by ``run_on_mesh`` in spawned processes.

They import only torch, numpy and ``repro_torch``, so a rank loads no JAX.
Each case puts the whole train state on the mesh under the train rules
(``reshard_state``), runs ``make_grad_fn`` and one ``make_train_step`` with
each asked ``grad_reshard``, and returns whole values (gathered on the
rank) for the test process to hold against the JAX package's, beside each
gradient's own block for the checks across ranks.
"""

import dataclasses

import numpy as np
import torch

from repro_torch.configs import SHAPES
from repro_torch.launch.specs import make_ctx
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as tt
from repro_torch.runtime.elastic import reshard_state
from repro_torch.sharding import rules
from repro_torch.tree import tree_paths


def _whole(ctx, tree) -> dict:
    return {path: rules.full_value(ctx, t).float().numpy() for path, t in tree_paths(tree)}


def _counts() -> dict:
    return {k: {"calls": c["calls"], "bytes": c["bytes"]}
            for k, c in rules.collective_counts().items()}


def run_case(ctx, case: dict) -> dict:
    """One case on this rank: per ``grad_reshard`` mode the loss, the gradients
    (whole, and this rank's blocks with their specs), the step's metrics and
    new state (whole), and the collectives of the gradient's call."""
    cfg = case["cfg"]
    tctx = make_ctx(ctx, cfg, SHAPES["train_4k"])
    state = reshard_state(case["state"], None, tctx, tt.param_axes(cfg))
    kw = dict(compute_dtype=torch.float32, grad_accum=case["grad_accum"])
    out = {"coord": {a: rules.axis_index(tctx, a) for a in tctx.axis_sizes}}
    for rs in case["modes"]:
        rules.reset_collective_counts()
        loss, grads = tmodel.make_grad_fn(cfg, tctx, grad_reshard=rs, **kw)(
            state["params"], case["batch"])
        counts = _counts()
        new, metrics = tmodel.make_train_step(cfg, tctx, warmup=0, grad_reshard=rs, **kw)(
            state, case["batch"])
        out[rs] = dict(
            loss=float(loss), counts=counts, grads=_whole(tctx, grads),
            blocks={path: (rules.spec_of(tctx, g), rules.block(g).float().numpy().copy())
                    for path, g in tree_paths(grads)},
            grad_norm=float(metrics["grad_norm"]), new=_whole(tctx, new),
            step=int(rules.block(new["step"])), dtypes={
                path: str(rules.block(t).dtype) for path, t in tree_paths(new["params"])})
    if case.get("remat_none"):  # the same gradients without checkpointing, and fewer gathers
        rules.reset_collective_counts()
        _, grads = tmodel.make_grad_fn(dataclasses.replace(cfg, remat="none"), tctx,
                                       grad_reshard=True, **kw)(state["params"], case["batch"])
        out["remat_none"] = dict(counts=_counts(), grads=_whole(tctx, grads))
    return out


def cases_body(ctx, cases: dict) -> dict:
    """Every case of this mesh, in one spawn."""
    return {name: run_case(ctx, case) for name, case in cases.items()}


def missing_backward_body(ctx, cfg, state, batch) -> dict:
    """The FSDP gather with its backward taken away (its output detached, as a
    collective autograd does not see): the step must raise, not train on zeros."""
    tctx = make_ctx(ctx, cfg, SHAPES["train_4k"])
    placed = reshard_state(state, None, tctx, tt.param_axes(cfg))
    gather = rules._Gather.apply
    rules._Gather.apply = lambda *a: gather(*a).detach()
    try:
        tmodel.make_train_step(cfg, tctx, compute_dtype=torch.float32)(placed, batch)
    except ValueError as e:
        return {"raised": str(e)}
    finally:
        rules._Gather.apply = gather
    return {"raised": None}


def collectives_body(ctx) -> dict:
    """The collectives' values and transposes on small integer-valued tensors
    (every sum exact, so any order gives the same bits): ``psum_scatter`` over
    both axes is the block of ``psum``'s sum; a gather over both axes gives
    each block the sum of the ranks' cotangents' blocks, by reduce-scatter or
    by all-reduce and a cut; ``pbroadcast``'s cotangent is summed and
    ``psum``'s passed through."""
    both = tuple(ctx.axis_sizes)
    gen = torch.Generator().manual_seed(rules.block_index(ctx, both))
    ints = lambda *shape: torch.randint(-8, 8, shape, generator=gen).float()  # noqa: E731
    x, w = ints(3, 8), ints(3, 8)
    cut = lambda t: rules.relayout(ctx, t, (None, None), (None, both))  # noqa: E731
    out = {"scatter": torch.equal(rules.psum_scatter(ctx, x, both, dim=1),
                                  cut(rules.psum(ctx, x, both)))}
    for mode in ("reduce_scatter", "all_reduce"):
        mctx = dataclasses.replace(ctx, fsdp_grad=mode)
        blk = ints(3, 2).requires_grad_()
        rules.reset_collective_counts()
        (rules.all_gather(mctx, blk, both, dim=1) * w).sum().backward()
        out[f"gather/{mode}/kinds"] = sorted(rules.collective_counts())
        out[f"gather/{mode}"] = torch.equal(blk.grad, cut(rules.psum(ctx, w, both)))
    v = ints(4).requires_grad_()
    (rules.pbroadcast(ctx, v, both) * w[0, :4]).sum().backward()
    out["pbroadcast"] = torch.equal(v.grad, rules.psum(ctx, w[0, :4], both))
    v = ints(4).requires_grad_()
    (rules.psum(ctx, v, both) * w[0, :4]).sum().backward()
    out["psum"] = torch.equal(v.grad, w[0, :4])
    return out


def body(ctx, cases: dict, negative=None) -> dict:
    out = cases_body(ctx, cases)
    if negative is not None:
        out["missing_backward"] = missing_backward_body(ctx, *negative)
        out["collectives"] = collectives_body(ctx)
    return out


def replicated_blocks_agree(results: list, path: str, mode) -> bool:
    """Every pair of ranks that hold the same block of ``path`` (the same
    coordinate on each mesh axis its spec names) holds the same bits."""
    by_block = {}
    for r in results:
        spec, blk = r[mode]["blocks"][path]
        key = tuple(r["coord"][a] for e in spec for a in rules.mesh_axes(e))
        by_block.setdefault(key, []).append(blk)
    return all(np.array_equal(b[0], x) for b in by_block.values() for x in b[1:])
