"""Rank bodies of the port's mesh tests, run by ``run_on_mesh`` in spawned processes.

They import only torch, numpy and ``repro_torch``, so a rank loads no JAX.
Each returns numpy arrays (whole values gathered on the rank) for the test
process to hold against the JAX package's results.
"""

import numpy as np
import torch

from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs import SHAPES
from repro_torch.launch.serve import generate_on_mesh, greedy_tokens
from repro_torch.launch.specs import make_ctx
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.runtime.elastic import reshard_state, state_shardings, state_specs
from repro_torch.sharding import rules
from repro_torch.tree import tree_leaves

MOE_AXES = {"router": ("embed", None), "w1": ("expert", "embed_e", "moe_ff"),
            "wg": ("expert", "embed_e", "moe_ff"), "w2": ("expert", "moe_ff", "embed_e")}


def _whole(ctx, x) -> np.ndarray:
    return rules.full_value(ctx, x).numpy()


def moe_body(ctx, p, x_prefill, x_decode, dims):
    """The EP layer at capacity factors 1.25 and 8.0 (params whole, then
    distributed by the default rules: the FSDP ``embed_e`` gathered), the
    no-EP path at 8.0, and token dispatch on decode-shaped tokens."""
    E, K = dims["E"], dims["K"]
    p = {k: torch.from_numpy(v) for k, v in p.items()}
    x = rules.distribute(ctx, torch.from_numpy(x_prefill), "batch", None, None)
    pd = {k: rules.distribute(ctx, v, *MOE_AXES[k]) for k, v in p.items()}
    out, counts = {}, {}
    for cf in (1.25, 8.0):
        for impl in ("einsum", "block_spmm"):
            kw = dict(num_experts=E, top_k=K, act="silu", capacity_factor=cf, gemm_impl=impl)
            rules.reset_collective_counts()
            y = tmoe.moe_apply(p, x, ctx=ctx, **kw)
            counts[f"ep/{cf}/{impl}"] = rules.collective_counts()
            out[f"ep/{cf}/{impl}"] = _whole(ctx, y)
            out[f"ep_sharded/{cf}/{impl}"] = _whole(ctx, tmoe.moe_apply(pd, x, ctx=ctx, **kw))
    kw = dict(num_experts=E, top_k=K, act="silu", capacity_factor=8.0)
    out["local/8.0"] = tmoe.moe_apply(p, torch.from_numpy(x_prefill), **kw).numpy()
    # 6 experts do not split over 4 model ranks: every expert on every rank
    p6 = {k: v[:, :6] if k == "router" else v[:6] for k, v in p.items()}
    kw6 = dict(kw, num_experts=6)
    out["no_ep"] = _whole(ctx, tmoe.moe_apply(p6, x, ctx=ctx, **kw6))
    out["no_ep_local"] = tmoe.moe_apply(p6, torch.from_numpy(x_prefill), **kw6).numpy()

    xd = rules.distribute(ctx, torch.from_numpy(x_decode), "batch", None, None)
    kw = dict(num_experts=E, top_k=K, act="silu", dropless=True)
    out["dispatch"] = _whole(ctx, tmoe.moe_apply(p, xd, ctx=ctx, token_dispatch=True, **kw))
    dctx = ctx.with_rules(embed=(), embed_e=(), moe_ff=("data",))  # make_ctx's decode rules
    pdd = {k: rules.distribute(dctx, v, *MOE_AXES[k]) for k, v in p.items()}
    rules.reset_collective_counts()
    y = tmoe.moe_apply(pdd, xd, ctx=dctx, token_dispatch=True, **kw)
    counts["dispatch_resident"] = rules.collective_counts()
    out["dispatch_resident"] = _whole(dctx, y)
    out["dispatch_local"] = tmoe.moe_apply(p, torch.from_numpy(x_decode), **kw).numpy()
    whole = torch.from_numpy(x_prefill)
    c = rules.constrain(ctx, whole, "batch", None, None)
    out_c = dict(spec=rules.spec_of(ctx, c), local=tuple(c.to_local().shape),
                 same_storage=c.to_local().data_ptr() == rules.local_block(
                     ctx, whole, ("data", None, None)).data_ptr(),
                 no_mesh_is_noop=rules.constrain(None, whole, "batch", None, None) is whole,
                 whole_equal=torch.equal(rules.full_value(ctx, c), whole),
                 router_spec=rules.spec_of(ctx, pd["router"]))
    mesh = ctx.mesh
    return dict(out=out, counts=counts, constrain=out_c, backend=mesh.backend, ranks_per_card=mesh.ranks_per_card,
                coord=[rules.axis_index(ctx, a) for a in mesh.mesh_dim_names])


def lm_body(ctx, cfg, params, tokens, prompts, gen):
    """The reduced LM on the mesh: a prefill-ctx forward, its layout, decode
    steps under the decode ctx after ``reshard_state``, and greedy serving."""
    axes = tt.param_axes(cfg)
    pctx = make_ctx(ctx, cfg, SHAPES["prefill_32k"])
    dctx = make_ctx(ctx, cfg, SHAPES["decode_32k"])
    pp = reshard_state(params, None, pctx, axes)
    logits = tt.apply(pp, cfg, {"tokens": torch.from_numpy(tokens)}, ctx=pctx)
    out = dict(prefill=_whole(pctx, logits), prefill_spec=rules.spec_of(pctx, logits),
               prefill_local=tuple(logits.to_local().shape))
    dp = reshard_state(pp, pctx, dctx, axes)
    out["decode_w1_spec"] = rules.spec_of(dctx, dp["layers"][0]["moe"]["w1"])
    B, S = tokens.shape
    cache = tt.init_cache(cfg, B, S, torch.float32, device="cpu", ctx=dctx)
    out["cache_spec"] = rules.spec_of(dctx, cache["layers"][0]["k"])
    serve = tmodel.make_serve_step(cfg, dctx, compute_dtype=torch.float32)
    steps = []
    for pos in range(gen["decode_steps"]):
        lg, cache = serve(dp, cache, torch.from_numpy(tokens[:, pos:pos + 1]).long(), pos)
        steps.append(_whole(dctx, lg)[:, 0])
    out["decode"] = np.stack(steps, 1)
    out["greedy_last"] = greedy_tokens(dctx, lg).numpy()
    out["seqs"] = generate_on_mesh(dctx, cfg, dp, prompts, gen["new_tokens"], device="cpu")
    return out


def gqa_body(ctx, cfg, params, tokens, prompts, new_tokens):
    """A dense LM whose kv heads do not split over the model axis (reduced
    qwen2-0.5b, 4 query heads and 2 kv heads on model 4): the query heads
    and the MLP split, the kv projections compute whole, the cache falls
    back to head_dim over the model axis."""
    axes = tt.param_axes(cfg)
    pctx = make_ctx(ctx, cfg, SHAPES["prefill_32k"])
    dctx = make_ctx(ctx, cfg, SHAPES["decode_32k"])
    pp = reshard_state(params, None, pctx, axes)
    out = dict(prefill=_whole(pctx, tt.apply(pp, cfg, {"tokens": torch.from_numpy(tokens)},
                                             ctx=pctx)),
               q_spec=rules.spec_of(pctx, pp["layers"][0]["q"]["w"]),
               k_spec=rules.spec_of(pctx, pp["layers"][0]["k"]["w"]),
               wo_spec=rules.spec_of(pctx, pp["layers"][0]["mlp"]["wo"]))
    dp = reshard_state(pp, pctx, dctx, axes)
    B, S = tokens.shape
    cache = tt.init_cache(cfg, B, S, torch.float32, device="cpu", ctx=dctx)
    out["cache_spec"] = rules.spec_of(dctx, cache["layers"][0]["k"])
    serve = tmodel.make_serve_step(cfg, dctx, compute_dtype=torch.float32)
    steps = []
    for pos in range(S):
        lg, cache = serve(dp, cache, torch.from_numpy(tokens[:, pos:pos + 1]).long(), pos)
        steps.append(_whole(dctx, lg)[:, 0])
    out["decode"] = np.stack(steps, 1)
    out["seqs"] = generate_on_mesh(dctx, cfg, dp, prompts, new_tokens, device="cpu")
    return out


def mesh24_body(ctx, moe_args, gqa_args):
    """Both bodies that run on the (data 2, model 4) mesh, in one spawn."""
    return dict(moe=moe_body(ctx, *moe_args), gqa=gqa_body(ctx, *gqa_args))


def _leaves_with_specs(tree, specs, path=""):
    """``(path, leaf, spec)`` of a state tree and its spec tree, walked together."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves_with_specs(tree[k], specs[k], f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, t in enumerate(tree)
                for x in _leaves_with_specs(t, specs[i], f"{path}/{i}")]
    return [(path, tree, specs)]


def elastic_body(ctx, cfg, state, meshes, ckpt_dir):
    """``reshard_state`` along ``meshes`` (``(shape, axes)`` pairs over this
    pool of ranks): each state's whole value, its local shapes and layouts
    against its specs, and a restored checkpoint put on the last mesh."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.rules import MeshCtx

    axes = tt.param_axes(cfg)
    prev, prev_ctx, out = state, None, []
    for shape, names in meshes:
        mctx = MeshCtx.on(make_mesh(shape, names, device="cpu"))
        prev = reshard_state(prev, prev_ctx, mctx, axes)
        leaves = _leaves_with_specs(prev, state_specs(mctx, state, axes))
        wrong = [path for path, t, spec in leaves
                 if tuple(t.to_local().shape) != rules.shard_shape(mctx, tuple(t.shape), spec)
                 or rules.spec_of(mctx, t) != tuple(spec)]
        placed = state_shardings(mctx, state, axes)
        wrong += [path for (path, t, _), (_, _, want) in
                  zip(leaves, _leaves_with_specs(state, placed), strict=True)
                  if tuple(t.placements) != tuple(want)]
        whole = [rules.full_value(mctx, t) for t in tree_leaves(prev)]
        same = all(torch.equal(a, b) for a, b in zip(whole, tree_leaves(state), strict=True))
        out.append(dict(mesh=list(shape), bit_identical=same, wrong=wrong,
                        local_shapes={path: tuple(t.to_local().shape) for path, t, _ in leaves},
                        sharded=sum(rules.spec_of(mctx, t) != (None,) * t.dim()
                                    for _, t, _ in leaves)))
        prev_ctx = mctx
    restored, _ = restore_checkpoint(ckpt_dir, state)
    placed = reshard_state(restored, None, prev_ctx, axes)
    out.append(dict(restored_bit_identical=all(
        torch.equal(rules.full_value(prev_ctx, a), b)
        for a, b in zip(tree_leaves(placed), tree_leaves(state), strict=True))))
    return out


def failing_body(ctx):
    if rules.axis_index(ctx, "data") == 1:
        raise ValueError("rank failed on purpose")
    return True


def pool_body(ctx, cards):
    """Meshes over the first ranks of a larger pool: every rank builds them,
    the ranks outside have no coordinate.  First on the CPU, then on
    ``cards`` cards that the pool's ranks share over gloo (the CUDA calls
    stubbed): the mesh keeps the group's backend and counts the group's
    ranks a card."""
    from repro_torch.launch.mesh import make_mesh

    small = make_mesh((2,), ("data",), device="cpu")
    coord = small.get_coordinate()
    out = dict(pool=dict(ctx.axes), coord=None if coord is None else list(coord),
               backend=small.backend)
    torch.cuda.is_available = lambda: True
    torch.cuda.is_initialized = lambda: True
    torch.cuda.device_count = lambda: cards
    torch.cuda.set_device = lambda device: None
    on_cards = make_mesh((2,), ("data",), device="cuda")
    out["on_cards"] = dict(backend=on_cards.backend, ranks_per_card=on_cards.ranks_per_card,
                           device_type=on_cards.device_type)
    return out


def dying_body(ctx, exit_code):
    """Rank 1 ends at once without a word (as the OOM killer ends a process)
    unless ``exit_code`` is ``None``; the others are busy long past the
    launcher's notice."""
    import os
    import time

    if exit_code is not None and rules.axis_index(ctx, "data") == 1:
        os._exit(exit_code)
    time.sleep(300)
    return True
