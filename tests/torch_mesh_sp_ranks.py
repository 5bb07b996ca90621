"""Rank bodies of the port's sequence-parallelism tests, run by ``run_on_mesh`` in spawned processes.

They import only torch, numpy and ``repro_torch``, so a rank loads no JAX.
Each case places its train state under the train rules (``reshard_state``)
and runs, under those rules with the override ``seq -> model`` and without
it, the forward (logits gathered whole), the loss and gradients in each
asked ``grad_reshard`` mode, a forward's collectives by kind and axis, and
one decode step's collectives under the decode rules.
"""

import numpy as np
import torch

from repro_torch.configs import SHAPES
from repro_torch.launch.specs import make_ctx
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as tt
from repro_torch.runtime.elastic import reshard_state
from repro_torch.sharding import rules
from repro_torch.tree import tree_paths

SP = {"seq": ("model",)}


def _whole(ctx, tree) -> dict:
    return {path: rules.full_value(ctx, t).float().numpy() for path, t in tree_paths(tree)}


def _by_axis() -> dict:
    return {k: {a: {"calls": v["calls"], "bytes": v["bytes"]} for a, v in per.items()}
            for k, per in rules.collective_counts(by_axis=True).items()}


def _inputs(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items() if k != "labels"}


def _forward(ctx, cfg, params, batch) -> tuple:
    """The logits gathered whole, their spec, and the forward's collectives."""
    rules.reset_collective_counts()
    with torch.no_grad():
        logits = tt.apply(params, cfg, _inputs(batch), ctx=ctx)
    counts = _by_axis()
    return rules.full_value(ctx, logits).numpy(), rules.spec_of(ctx, logits), counts


def _grads(ctx, cfg, state, batch, rs: bool) -> dict:
    rules.reset_collective_counts()
    loss, grads = tmodel.make_grad_fn(cfg, ctx, grad_reshard=rs, compute_dtype=torch.float32)(
        state["params"], batch)
    return dict(loss=float(loss), counts=_by_axis(), grads=_whole(ctx, grads),
                blocks={path: (rules.spec_of(ctx, g), rules.block(g).float().numpy().copy())
                        for path, g in tree_paths(grads)})


def _decode_counts(ctx, cfg, params, batch: int) -> dict:
    """One fp32 decode step's collectives at position 3 of a zero cache of 8."""
    dctx = make_ctx(ctx, cfg, SHAPES["decode_32k"])
    out = {}
    for name, c in (("plain", dctx), ("sp", dctx.with_rules(**SP))):
        placed = reshard_state(params, None, c, tt.param_axes(cfg))
        cache = tt.init_cache(cfg, batch, 8, torch.float32, device="cpu", ctx=c)
        step = tmodel.make_serve_step(cfg, c, compute_dtype=torch.float32)
        rules.reset_collective_counts()
        logits, _ = step(placed, cache, torch.zeros((batch, 1), dtype=torch.long), 3)
        out[name] = dict(counts=_by_axis(), logits=rules.full_value(c, logits).numpy())
    return out


def run_case(ctx, case: dict) -> dict:
    cfg, batch = case["cfg"], case["batch"]
    tctx = make_ctx(ctx, cfg, SHAPES["train_4k"])
    sctx = tctx.with_rules(**SP)
    state = reshard_state(case["state"], None, tctx, tt.param_axes(cfg))
    out = {"coord": {a: rules.axis_index(tctx, a) for a in tctx.axis_sizes},
           "seq_axis": tt.seq_axis(sctx, cfg, _inputs(batch))}
    for name, c in (("sp", sctx), ("plain", tctx)):
        logits, spec, counts = _forward(c, cfg, state["params"], batch)
        out[name] = {"logits": logits, "logits_spec": spec, "forward_counts": counts,
                     **{rs: _grads(c, cfg, state, batch, rs)
                        for rs in (case["modes"] if name == "sp" else (True,))}}
    if cfg.kind != "encoder":
        out["decode"] = _decode_counts(ctx, cfg, case["state"]["params"], batch["tokens"].shape[0])
    return out


def body(ctx, cases: dict) -> dict:
    """Every case on this rank, in one spawn."""
    return {name: run_case(ctx, case) for name, case in cases.items()}


def replicated_blocks_agree(results: list, case: str, path: str, mode) -> bool:
    """Every pair of ranks that hold the same block of ``path``'s gradient (the
    same coordinate on each mesh axis its spec names) holds the same bits."""
    by_block = {}
    for r in results:
        spec, blk = r[case]["sp"][mode]["blocks"][path]
        key = tuple(r[case]["coord"][a] for e in spec for a in rules.mesh_axes(e))
        by_block.setdefault(key, []).append(blk)
    return all(np.array_equal(b[0], x) for b in by_block.values() for x in b[1:])
