"""Rank bodies of the port's mesh tests, run by ``run_on_mesh`` in spawned processes.

They import only torch, numpy and ``repro_torch``, so a rank loads no JAX.
Each returns numpy arrays (whole values gathered on the rank) for the test
process to hold against the JAX package's results.
"""

import math

import numpy as np
import torch

from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs import SHAPES
from repro_torch.launch.serve import generate_on_mesh, greedy_tokens
from repro_torch.launch.specs import make_ctx
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.runtime.elastic import keep_blocks, reshard_state, state_shardings, state_specs
from repro_torch.sharding import rules
from repro_torch.tree import tree_leaves, tree_map, tree_paths

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
    # the gradients under the train rules: the kv projections whole, each rank's
    # queries reading a slice of their heads
    tctx = make_ctx(ctx, cfg, SHAPES["train_4k"])
    loss, grads = tmodel.make_grad_fn(cfg, tctx, compute_dtype=torch.float32)(
        reshard_state(params, None, tctx, axes), {"tokens": tokens})
    out["train"] = dict(loss=float(loss), grads={path: _whole(tctx, g)
                                                 for path, g in tree_paths(grads)},
                        k_spec=rules.spec_of(tctx, grads["layers"][0]["k"]["w"]))
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


def _calls_bytes() -> dict:
    return {k: {"calls": c["calls"], "bytes": c["bytes"]}
            for k, c in rules.collective_counts().items()}


def recurrent_family(ctx, cfg, params, tokens, decode_steps, prompts=None, new_tokens=0,
                     long_tokens=None):
    """A reduced ``rec`` / ``ssm`` family on this mesh: the prefill-ctx forward
    (and one at ``long_tokens``' length) with its collectives, the layouts of
    the parameters and the cache, ``decode_steps`` serve steps under the
    decode ctx (the last one's collectives counted), the cache after them,
    gathered, and greedy serving when ``prompts`` are given."""
    axes = tt.param_axes(cfg)
    pctx = make_ctx(ctx, cfg, SHAPES["prefill_32k"])
    dctx = make_ctx(ctx, cfg, SHAPES["decode_32k"])
    pp = reshard_state(params, None, pctx, axes)
    out = dict(param_specs={path: rules.spec_of(pctx, t) for path, t in tree_paths(pp)})
    for key, toks in (("prefill", tokens), ("prefill_long", long_tokens)):
        if toks is not None:
            rules.reset_collective_counts()
            logits = tt.apply(pp, cfg, {"tokens": torch.from_numpy(toks)}, ctx=pctx)
            out[f"{key}_counts"] = _calls_bytes()
            out[key] = _whole(pctx, logits)
    dp = reshard_state(pp, pctx, dctx, axes)
    B, S = tokens.shape
    cache = tt.init_cache(cfg, B, S, torch.float32, device="cpu", ctx=dctx)
    layout = {path: (rules.spec_of(dctx, t), tuple(t.to_local().shape))
              for path, t in tree_paths(cache)}
    serve = tmodel.make_serve_step(cfg, dctx, compute_dtype=torch.float32)
    steps = []
    for pos in range(decode_steps):
        rules.reset_collective_counts()
        lg, cache = serve(dp, cache, torch.from_numpy(tokens[:, pos:pos + 1]).long(), pos)
        out["step_counts"] = _calls_bytes()
        steps.append(_whole(dctx, lg)[:, 0])
    out["decode"] = np.stack(steps, 1)
    out["cache_specs"] = {path: spec for path, (spec, _) in layout.items()}
    out["cache_layout_kept"] = all(
        (rules.spec_of(dctx, t), tuple(t.to_local().shape)) == layout[path]
        for path, t in tree_paths(cache))
    out["cache"] = {path: _whole(dctx, t) for path, t in tree_paths(cache)}
    if prompts is not None:
        out["seqs"] = generate_on_mesh(dctx, cfg, dp, prompts, new_tokens, device="cpu")
    return out


def families_body(ctx, cases: dict) -> dict:
    """Every family case of this mesh, in one spawn."""
    return {name: recurrent_family(ctx, **case) for name, case in cases.items()}


def _cache_from_numpy(ctx, cfg, whole: dict, int8: bool):
    """A whole cache tree of numpy arrays (:func:`tt.init_cache`'s leaves and
    dtypes) as ``DTensor`` leaves laid out by ``ctx``'s rules."""
    like = tt.init_cache(cfg, 1, SHAPES["long_500k"].seq_len,
                         torch.int8 if int8 else torch.float32, device="cpu")
    specs = rules.spec_tree(ctx, like, tt.cache_axes(cfg, int8=int8))

    def place(t, arr, spec):
        x = torch.from_numpy(np.asarray(arr)).to(t.dtype)
        return rules.as_dtensor(ctx, rules.local_block(ctx, x, spec).contiguous().clone(), spec,
                                t.shape)

    return tree_map(place, like, whole, specs)


def _attn_blocks(cache) -> dict:
    """Copies of this rank's blocks of every attention layer's cache leaves."""
    return {f"{i}/{name}": t.to_local().clone() for i, c in enumerate(cache["layers"])
            for name, t in c.items() if name in ("k", "v", "k_scale", "v_scale")}


def long_families_body(ctx, cases: dict) -> dict:
    """Every family's :func:`long_body`, in one spawn."""
    return {name: long_body(ctx, **case) for name, case in cases.items()}


def long_body(ctx, cfg, params, runs: dict) -> dict:
    """A reduced family under the ``long_500k`` rules (B 1, the KV cache's
    sequence over ``data``): each run decodes ``tokens`` from ``pos0`` on the
    cache ``cache`` (a whole numpy tree, or zeros), in fp32 or int8.  Per run:
    every step's logits, the cache after, gathered, its layout kept, and on
    the first step the local rows each attention leaf's block changed."""
    lctx = make_ctx(ctx, cfg, SHAPES["long_500k"])
    dp = reshard_state(params, None, lctx, tt.param_axes(cfg))
    serve = tmodel.make_serve_step(cfg, lctx, compute_dtype=torch.float32)
    out = dict(coord={a: rules.axis_index(ctx, a) for a in ctx.mesh.mesh_dim_names}, runs={})
    for key, run in runs.items():
        int8 = run["int8"]
        if run["cache"] is None:
            cache = tt.init_cache(cfg, 1, SHAPES["long_500k"].seq_len,
                                  torch.int8 if int8 else torch.float32, device="cpu", ctx=lctx)
        else:
            cache = _cache_from_numpy(lctx, cfg, run["cache"], int8)
        layout = {path: (rules.spec_of(lctx, t), tuple(t.to_local().shape))
                  for path, t in tree_paths(cache)}
        tokens = run["tokens"]
        steps, touched = [], None
        for i in range(tokens.shape[1]):
            before = _attn_blocks(cache) if i == 0 else None
            lg, cache = serve(dp, cache, torch.from_numpy(tokens[:, i:i + 1]).long(),
                              run["pos0"] + i)
            if before is not None:
                after = _attn_blocks(cache)
                touched = {k: sorted({int(r) for r in torch.nonzero(
                    (after[k] != before[k]).reshape(after[k].shape[0], after[k].shape[1], -1)
                    .any(-1).any(0)).flatten()}) for k in before}
            steps.append(_whole(lctx, lg)[:, 0])
        out["runs"][key] = dict(
            decode=np.stack(steps, 1), touched=touched,
            cache_specs={path: spec for path, (spec, _) in layout.items()},
            layout_kept=all((rules.spec_of(lctx, t), tuple(t.to_local().shape)) == layout[path]
                            for path, t in tree_paths(cache)),
            cache={path: rules.full_value(lctx, t).float().numpy()
                   for path, t in tree_paths(cache)})
    return out


def step_counts_body(ctx, cases: dict) -> dict:
    """Each case's step once on this rank, its collectives counted by kind and
    axis: ``{"cfg", "shape", "dtype", "grad_reshard"}`` a train step
    (``make_train_step``) of ``state`` on ``batch``, else a decode step
    (``make_serve_step``) at ``pos`` on a zero cache of the shape's batch
    and length; ``rules``, if any, laid over the shape's.  The parameters,
    the cache and the compute are in ``dtype``, as
    :func:`repro_torch.launch.dryrun.measure_on_mesh` is asked."""
    out = {}
    for name, c in cases.items():
        cfg, shape, dt = c["cfg"], c["shape"], c["dtype"]
        cctx = make_ctx(ctx, cfg, shape)
        if c.get("rules"):
            cctx = cctx.with_rules(**c["rules"])
        if shape.kind == "train":
            state = reshard_state(c["state"], None, cctx, tt.param_axes(cfg))
            step = tmodel.make_train_step(cfg, cctx, compute_dtype=dt,
                                          grad_reshard=c["grad_reshard"])
            rules.reset_collective_counts()
            step(state, c["batch"])
        else:
            params = reshard_state(tmodel.cast_params(c["params"], dt), None, cctx,
                                   tt.param_axes(cfg))
            cache = tt.init_cache(cfg, shape.global_batch, shape.seq_len, dt, device="cpu",
                                  ctx=cctx)
            serve = tmodel.make_serve_step(cfg, cctx, compute_dtype=dt)
            tokens = torch.zeros((shape.global_batch, 1), dtype=torch.long)
            rules.reset_collective_counts()
            serve(params, cache, tokens, c["pos"])
        out[name] = {k: {a: {"calls": v["calls"], "bytes": v["bytes"], "group": v["group"]}
                         for a, v in per.items()}
                     for k, per in rules.collective_counts(by_axis=True).items()}
    return out


def archs_body(ctx, cases: dict) -> dict:
    """Each reduced architecture on this mesh: the forward under the prefill
    rules on its inputs, gathered, and for a decoder ``steps`` decode steps
    under the decode rules (after ``reshard_state``) on a zero fp32 cache."""
    out = {}
    for name, c in cases.items():
        cfg = c["cfg"]
        axes = tt.param_axes(cfg)
        pctx = make_ctx(ctx, cfg, SHAPES["prefill_32k"])
        pp = reshard_state(c["params"], None, pctx, axes)
        inputs = {k: torch.from_numpy(v) for k, v in c["inputs"].items()}
        res = dict(prefill=_whole(pctx, tt.apply(pp, cfg, inputs, ctx=pctx)))
        if c["tokens"] is not None:
            dctx = make_ctx(ctx, cfg, SHAPES["decode_32k"])
            dp = reshard_state(pp, pctx, dctx, axes)
            tokens = c["tokens"]
            cache = tt.init_cache(cfg, tokens.shape[0], tokens.shape[1], torch.float32,
                                  device="cpu", ctx=dctx)
            serve = tmodel.make_serve_step(cfg, dctx, compute_dtype=torch.float32)
            steps = []
            for pos in range(tokens.shape[1]):
                lg, cache = serve(dp, cache, torch.from_numpy(tokens[:, pos:pos + 1]).long(), pos)
                steps.append(_whole(dctx, lg)[:, 0])
            res["decode"] = np.stack(steps, 1)
        out[name] = res
    return out


def bf16_serve_body(ctx, cases: dict) -> dict:
    """Each reduced MoE model served in bf16 on this mesh, its parameters
    drawn in bf16 straight into this rank's blocks (``init_params(...,
    dtype=, keep=keep_blocks(...))``, once under the prefill rules and once
    under the decode rules): the forward under the prefill rules, gathered,
    and ``len(tokens[0])`` steps of ``make_serve_step(cfg, dctx,
    compute_dtype=bf16)`` on a bf16 cache; with the experts this rank routed
    each token to in every MoE layer (``routes``: the forward's, then each
    step's, a layer at a time)."""
    bf16 = torch.bfloat16
    out = {"coord": [rules.axis_index(ctx, a) for a in ("data", "model")]}
    route, calls = tmoe.route, []

    def recording(x, router, top_k):
        gates, eidx = route(x, router, top_k)
        calls.append(eidx.numpy())
        return gates, eidx

    tmoe.route = recording
    try:
        for name, c in cases.items():
            cfg = c["cfg"]
            axes = tt.param_axes(cfg)
            pctx = make_ctx(ctx, cfg, SHAPES["prefill_32k"])
            dctx = make_ctx(ctx, cfg, SHAPES["decode_32k"])
            pp = tt.init_params(cfg, seed=c["seed"], device="cpu", dtype=bf16,
                                keep=keep_blocks(pctx, axes))
            calls.clear()
            logits = tt.apply(pp, cfg, {"tokens": torch.from_numpy(c["inputs"])}, ctx=pctx)
            res = dict(prefill=rules.full_value(pctx, logits).float().numpy(),
                       prefill_dtype=str(logits.dtype),
                       param_dtypes=sorted({str(rules.block(t).dtype) for t in tree_leaves(pp)}),
                       routes={"prefill": list(calls)})
            del pp
            dp = tt.init_params(cfg, seed=c["seed"], device="cpu", dtype=bf16,
                                keep=keep_blocks(dctx, axes))
            tokens = c["tokens"]
            cache = tt.init_cache(cfg, tokens.shape[0], tokens.shape[1], bf16, device="cpu",
                                  ctx=dctx)
            serve = tmodel.make_serve_step(cfg, dctx, compute_dtype=bf16)
            steps = []
            calls.clear()
            for pos in range(tokens.shape[1]):
                lg, cache = serve(dp, cache, torch.from_numpy(tokens[:, pos:pos + 1]).long(), pos)
                steps.append(rules.full_value(dctx, lg).float().numpy()[:, 0])
            res["decode"] = np.stack(steps, 1)
            res["routes"]["decode"] = list(calls)
            res["cache_dtype"] = str(rules.block(cache["layers"][0]["k"]).dtype)
            out[name] = res
    finally:
        tmoe.route = route
    return out


def init_stream_body(ctx, cases: dict) -> dict:
    """Each case's parameters drawn straight into this rank's blocks
    (``init_params(..., keep=keep_blocks(cctx, axes))``, fp32 and bf16) under
    the prefill, decode and train rules, against the blocks ``reshard_state``
    cuts from the whole tree (cast for bf16): ``{(shape, dtype): equal}``,
    equal meaning every leaf's spec, global shape and local bits."""
    out = {}
    for name, c in cases.items():
        cfg = c["cfg"]
        axes = tt.param_axes(cfg)
        whole = tt.init_params(cfg, seed=c["seed"], device="cpu")
        res = {}
        for shape in ("prefill_32k", "decode_32k", "train_4k"):
            cctx = make_ctx(ctx, cfg, SHAPES[shape])
            for dt in (None, torch.bfloat16):
                want = reshard_state(whole if dt is None else tmodel.cast_params(whole, dt), None,
                                     cctx, axes)
                got = tt.init_params(cfg, seed=c["seed"], device="cpu", dtype=dt,
                                     keep=keep_blocks(cctx, axes))
                pairs = list(zip(tree_paths(got), tree_paths(want), strict=True))
                res[(shape, str(dt))] = all(
                    pg == pw and rules.spec_of(cctx, g) == rules.spec_of(cctx, w)
                    and g.shape == w.shape and torch.equal(g.to_local(), w.to_local())
                    for (pg, g), (pw, w) in pairs)
        out[name] = res
    return out


def ep_chunks_body(ctx, p, x_prefill, dims, chunks) -> dict:
    """The expert-parallel layer under the prefill rules (expert weights
    FSDP-sharded on d_model over ``data``), fp32 and bf16, both GEMM routes,
    with the rank's experts gathered and run ``chunk`` at a time for each of
    ``chunks`` (``moe.EP_GATHER_BYTES`` set so), against the body as it was
    before the gathers were cut: every expert weight gathered whole first,
    then ``_moe_local`` and the sum over ``model``.  ``{(dtype, impl, chunk):
    (bits equal, collectives)}``."""
    E, K = dims["E"], dims["K"]
    tp = ctx.tp_axis
    E_l = E // ctx.tp_size()
    out = {}
    budget = tmoe.EP_GATHER_BYTES
    try:
        for dt in (torch.float32, torch.bfloat16):
            pd = {k: rules.distribute(ctx, torch.from_numpy(v).to(dt), *MOE_AXES[k])
                  for k, v in p.items()}
            x = rules.distribute(ctx, torch.from_numpy(x_prefill).to(dt), "batch", None, None)
            for impl in ("einsum", "block_spmm"):
                kw = dict(num_experts=E, top_k=K, act="silu", capacity_factor=1.25,
                          gemm_impl=impl)
                # before: the three weights gathered whole up front
                x_l = rules.local_block(ctx, x, ("data", None, None))
                w = {k: rules.local_block(ctx, pd[k], (tp, None, None)) for k in ("w1", "wg", "w2")}
                router = rules.local_block(ctx, pd["router"], (None, None))
                cap = math.ceil(x_l.shape[0] * x_l.shape[1] * K * 1.25 / E)
                before = rules.psum(ctx, tmoe._moe_local(
                    x_l, router, *tmoe._sliced(w["w1"], w["wg"], w["w2"]), num_local=E_l,
                    e_base=rules.axis_index(ctx, tp) * E_l, num_experts=E, top_k=K,
                    capacity=cap, act="silu", gemm_impl=impl), tp)
                for chunk in chunks:
                    per_weight = chunk * p["w1"].shape[1] * p["w1"].shape[2] * before.element_size()
                    tmoe.EP_GATHER_BYTES = per_weight
                    rules.reset_collective_counts()
                    got = rules.block(tmoe.moe_apply(pd, x, ctx=ctx, **kw))
                    counts = rules.collective_counts(by_axis=True)
                    out[(str(dt), impl, chunk)] = (
                        tmoe.ep_chunk(pd["w1"], E_l) == chunk and got.dtype == dt
                        and torch.equal(got, before), counts)
    finally:
        tmoe.EP_GATHER_BYTES = budget
    return out
