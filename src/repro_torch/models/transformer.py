"""Model assembly: decoder / encoder / VLM / MoE / hybrid / SSM LMs from ArchConfig.

Port of the JAX package's ``repro/models/transformer.py``: the ``attn`` and
``local`` attention blocks with the dense MLP or the MoE FFN
(:mod:`.moe`), the ``rec`` RG-LRU block (:mod:`.rglru`, with its MLP) and
the ``ssm`` Mamba-2 SSD block (:mod:`.ssd`, norm and mixer only), and all
three frontends (tokens, audio frames, vision patches as a prefix).

Parameters are a plain dict: ``embed``, optional ``frontend``, ``layers`` — a
list with one dict per layer in execution order (layer ``i`` has kind
``block_pattern[i % len(block_pattern)]``) — ``final_norm`` and, untied,
``head``.  The JAX package stacks layers by pattern position for its scan;
:mod:`repro_torch.convert` maps between the two.  The JAX package's
``unroll`` (scan or Python loop) has no counterpart: the port's layer loop
is a Python loop.  The decode cache is ``{"layers": [...]}``, one dict per
layer; :func:`decode_step` writes the new token's keys and values into an
attention layer's cache in place and replaces a recurrent layer's state
entries (``h``, ``conv``) in its dict.

On a mesh (``ctx=`` a :class:`~repro_torch.sharding.rules.MeshCtx` on a
``DeviceMesh``, every rank running the same call) the parameters and the
cache are ``DTensor`` objects laid out by :func:`param_axes` and
:func:`cache_axes` under the ctx's rules, and the reference's rule table is
realised on each rank's local blocks: q/k/v and the MLP's ``wi``/``wg`` are
column-parallel over the model axis (``heads``, ``kv_heads``, ``mlp``),
``o`` and ``wo`` row-parallel with a sum over it; the embedding and the
head are vocab-parallel and the logits stay vocab-sharded (a ``DTensor``,
as the reference's ``constrain`` leaves them); batch rows go over the data
axes; the MoE runs its expert-parallel body, and in decode its token
dispatch.  Any other sharding of a parameter (the FSDP ``embed -> data``
of a training ctx) is gathered before use, and a dim the divisibility
fallback replicates is computed whole on every rank.  The values are one
process's up to the order of the sums over the model axis.  One layer loop
serves one device and the mesh: without a mesh the helpers that realise
the rules do nothing.  The ``rec`` and ``ssm`` blocks have no mesh path
yet.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..core.matrix import resolve_device
from ..sharding import rules
from ..sharding.rules import logical_to_spec
from ..tree import tree_map
from . import attention as attn_mod
from . import moe as moe_mod
from . import rglru as rec_mod
from . import ssd as ssm_mod
from .layers import (
    apply_norm,
    dense,
    dense_init,
    embed_init,
    mlp_apply,
    mlp_init,
    norm_init,
    proj_in,
    proj_in_init,
    proj_out,
    proj_out_init,
    rope,
)

__all__ = ["apply", "cache_axes", "decode_step", "init_cache", "init_params", "layer_kinds",
           "param_axes"]


def layer_kinds(cfg: ArchConfig) -> list[str]:
    """The block kind of every layer, in execution order."""
    pattern = cfg.block_pattern
    return [pattern[i % len(pattern)] for i in range(cfg.num_layers)]


def _final_norm_kind(cfg: ArchConfig) -> str:
    return cfg.norm if cfg.norm != "nonparam_ln" else "rmsnorm"


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def _block_init(gen, cfg: ArchConfig, kind: str):
    dev = gen.device
    p = {"ln1": norm_init(cfg.norm, cfg.d_model, dev)}
    if kind in ("attn", "local"):
        hd = cfg.hd
        p["q"] = proj_in_init(gen, cfg.d_model, cfg.num_heads, hd, bias=cfg.qkv_bias)
        p["k"] = proj_in_init(gen, cfg.d_model, cfg.num_kv_heads, hd, bias=cfg.qkv_bias)
        p["v"] = proj_in_init(gen, cfg.d_model, cfg.num_kv_heads, hd, bias=cfg.qkv_bias)
        p["o"] = proj_out_init(gen, cfg.num_heads, hd, cfg.d_model)
    elif kind == "rec":
        p["mix"] = rec_mod.rglru_block_init(gen, cfg.d_model, cfg.num_heads)
    elif kind == "ssm":
        p["mix"] = ssm_mod.ssd_block_init(gen, cfg.d_model, d_inner=cfg.d_inner,
                                          heads=cfg.ssm_heads, d_state=cfg.ssm_state)
        return p  # a Mamba block: norm and mixer, no MLP
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    p["ln2"] = norm_init(cfg.norm, cfg.d_model, dev)
    if cfg.is_moe and kind in ("attn", "local"):
        p["moe"] = moe_mod.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.mlp_act)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act)
    return p


def init_params(cfg: ArchConfig, *, seed: int | None = None,
                generator: torch.Generator | None = None, device="cuda"):
    """Random parameters with the JAX package's shapes, scales and zero/one inits.

    Draws from ``generator`` (which fixes the device) or from a new
    ``torch.Generator`` on ``device`` seeded with ``seed``.  The numbers
    differ from ``jax.random``'s; carry JAX parameters across with
    :func:`repro_torch.convert.lm_params_from_arrays`.
    """
    if generator is None:
        if seed is None:
            raise ValueError("init_params needs a seed or a generator")
        generator = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    gen = generator
    p = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model)}
    if cfg.frontend == "audio_stub":
        p["frontend"] = dense_init(gen, cfg.frontend_dim, cfg.d_model)
    p["layers"] = [_block_init(gen, cfg, kind) for kind in layer_kinds(cfg)]
    p["final_norm"] = norm_init(_final_norm_kind(cfg), cfg.d_model, gen.device)
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, cfg.d_model, cfg.vocab_size)
    return p


# --------------------------------------------------------------------------
# logical sharding axes (the dry run's spec arithmetic: repro_torch.sharding)
# --------------------------------------------------------------------------


def _norm_axes(kind: str) -> dict:
    if kind == "nonparam_ln":
        return {}
    return {"scale": ("embed",), "bias": ("embed",)} if kind == "layernorm" else {"scale": ("embed",)}


def _mlp_axes(act: str) -> dict:
    a = {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}
    if act in ("silu", "geglu"):
        a["wg"] = ("embed", "mlp")
    return a


def _block_axes(cfg: ArchConfig, kind: str) -> dict:
    """The logical axes of one layer's parameters, as :func:`_block_init` lays
    them out (the JAX package's ``_block_init`` names, less its stacked
    ``"layers"`` dim)."""
    a = {"ln1": _norm_axes(cfg.norm)}
    if kind in ("attn", "local"):
        for name, head_axis in (("q", "heads"), ("k", "kv_heads"), ("v", "kv_heads")):
            a[name] = {"w": ("embed", head_axis, None)}
            if cfg.qkv_bias:
                a[name]["b"] = (head_axis, None)
        a["o"] = {"w": ("heads", None, "embed")}
    elif kind == "rec":
        a["mix"] = {"w_in_x": ("embed", "rnn"), "w_in_g": ("embed", "rnn"), "conv": (None, "rnn"),
                    "w_r": ("heads", None, None), "w_i": ("heads", None, None),
                    "lam": ("rnn",), "w_out": ("rnn", "embed")}
    elif kind == "ssm":
        a["mix"] = {"in_proj": ("embed", "rnn"), "conv": (None, None), "a_log": ("heads",),
                    "d_skip": ("heads",), "dt_bias": ("heads",), "norm_scale": ("rnn",),
                    "out_proj": ("rnn", "embed")}
        return a
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    a["ln2"] = _norm_axes(cfg.norm)
    if cfg.is_moe and kind in ("attn", "local"):
        a["moe"] = {"router": ("embed", None), "w1": ("expert", "embed_e", "moe_ff"),
                    "w2": ("expert", "moe_ff", "embed_e")}
        if cfg.mlp_act in ("silu", "geglu"):
            a["moe"]["wg"] = ("expert", "embed_e", "moe_ff")
    else:
        a["mlp"] = _mlp_axes(cfg.mlp_act)
    return a


def param_axes(cfg: ArchConfig) -> dict:
    """The logical axis names of every parameter, mirroring :func:`init_params`'s tree.

    The names are the JAX package's (``transformer.param_axes``); its stacked
    scan dim ``"layers"`` has no counterpart here (one tree per layer), and
    the rules map it to no mesh axis, so every spec is the same.
    """
    a = {"embed": {"table": ("vocab", "embed")}}
    if cfg.frontend == "audio_stub":
        a["frontend"] = {"w": ("embed", None)}
    a["layers"] = [_block_axes(cfg, kind) for kind in layer_kinds(cfg)]
    a["final_norm"] = _norm_axes(_final_norm_kind(cfg))
    if not cfg.tie_embeddings:
        a["head"] = {"w": ("embed", "vocab")}
    return a


def cache_axes(cfg: ArchConfig, int8: bool = False) -> dict:
    """The logical axes of :func:`init_cache`'s tree (the JAX package's
    ``cache_axes`` per layer, less its ``"layers"`` dim)."""

    def kind_axes(kind: str) -> dict:
        if kind in ("attn", "local"):
            # kv_heads shards when divisible; otherwise head_dim picks up the model axis
            kv = ("batch", "seq_kv", "kv_heads", "head_dim")
            d = {"k": kv, "v": kv}
            if int8:
                d["k_scale"] = d["v_scale"] = ("batch", "seq_kv", "kv_heads")
            return d
        if kind == "rec":
            return {"h": ("batch", "rnn"), "conv": ("batch", None, "rnn")}
        return {"h": ("batch", "heads", None, None), "conv": ("batch", None, "rnn")}

    return {"layers": [kind_axes(kind) for kind in layer_kinds(cfg)]}


# --------------------------------------------------------------------------
# on a mesh: the rule table realised on each rank's local blocks.  Every helper
# here does nothing without a mesh (``ctx`` None, or a dry-run MeshCtx)
# --------------------------------------------------------------------------


def _on_mesh(ctx) -> bool:
    return ctx is not None and ctx.mesh is not None


def _blocks(ctx, tree):
    """``(blocks, specs)`` a layer computes with: the parameters themselves and
    no specs without a mesh; on a mesh each leaf's local block with only its
    model-axis sharding kept (any other axis gathered, as a ``shard_map``
    whose ``in_specs`` name the model axis alone).  The MoE's leaves stay
    as they are: :func:`moe_mod.moe_apply` lays them out itself."""
    if not _on_mesh(ctx):
        return tree, None
    tree = {k: v for k, v in tree.items() if k != "moe"}
    tp = ctx.tp_axis
    specs = tree_map(lambda t: tuple(e if e == tp else None for e in rules.spec_of(ctx, t)), tree)
    return tree_map(lambda t, spec: rules.local_block(ctx, t, spec), tree, specs), specs


def _split(specs, name: str, key: str, dim: int):
    """The mesh axes of dim ``dim`` of block ``specs[name][key]`` (``None``: whole)."""
    return None if specs is None else specs[name][key][dim]


def _row_sum(ctx, y, contracted):
    """A row-parallel product's partial sums over the model axis (none when its
    ``contracted`` dim is whole on every rank)."""
    return y if contracted is None else rules.psum(ctx, y, ctx.tp_axis)


def _kv_heads(ctx, cfg: ArchConfig, specs):
    """The kv heads this rank's query heads read when the model axis splits the
    query heads and not the kv heads (``None``: all of the local ones)."""
    if _split(specs, "q", "w", 1) is None or _split(specs, "k", "w", 1) is not None:
        return None
    group = cfg.num_heads // cfg.num_kv_heads
    H_l = cfg.num_heads // ctx.tp_size()
    if H_l % group and group % H_l:
        raise ValueError(f"{H_l} local query heads do not tile groups of {group}")
    r = rules.axis_index(ctx, ctx.tp_axis)
    return slice(r * H_l // group, ((r + 1) * H_l - 1) // group + 1)


def _lookup(ctx, specs):
    """The embedding lookup for a table block: vocab-parallel (each rank looks up
    the tokens in its vocab range, zeros elsewhere, a sum over the model axis:
    one term is non-zero, so the sum is exact) when the vocab dim is sharded."""
    if _split(specs, "embed", "table", 0) is None:
        return F.embedding

    def lookup(tokens, table):
        V_l = table.shape[0]
        t = tokens - rules.axis_index(ctx, ctx.tp_axis) * V_l
        inside = (t >= 0) & (t < V_l)
        x = F.embedding(torch.where(inside, t, 0), table)
        return rules.psum(ctx, torch.where(inside[..., None], x, 0), ctx.tp_axis)

    return lookup


def _batch_entry(ctx, B: int):
    """The mesh axes of the batch dim of a ``[B, S, d]`` activation."""
    return logical_to_spec(ctx, (B, 1, 1), ("batch", "seq", None))[0]


def _rows(ctx, x, B: int):
    """This rank's batch rows of a whole input every rank holds."""
    if not _on_mesh(ctx):
        return x
    return rules.local_block(ctx, x, (_batch_entry(ctx, B),) + (None,) * (x.dim() - 1))


def _check_kinds(ctx, cfg: ArchConfig) -> None:
    if _on_mesh(ctx):
        for kind in set(layer_kinds(cfg)) - {"attn", "local"}:
            raise NotImplementedError(f"a {kind!r} block has no mesh path yet (attn and local do)")


def _logits(ctx, params, cfg: ArchConfig, x, B: int):
    """The final norm and the head: logits ``[B, S, vocab]``, on a mesh a
    ``DTensor`` sharded over the batch and vocab rules."""
    top, _ = _blocks(ctx, {k: params[k] for k in ("final_norm", "embed", "head") if k in params})
    x = apply_norm(_final_norm_kind(cfg), top["final_norm"], x)
    local = _head(top, cfg, x)
    if not _on_mesh(ctx):
        return local
    shape = (B, x.shape[1], cfg.vocab_size)
    return rules.as_dtensor(ctx, local, logical_to_spec(ctx, shape, ("batch", "seq", "vocab")),
                            shape)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def _sinusoidal(S: int, D: int, dtype, device) -> torch.Tensor:
    """float64 on the host, cast to the activation type (as the JAX package does)."""
    pos = np.arange(S)[:, None]
    i = np.arange(D // 2)[None, :]
    ang = pos / (10000 ** (2 * i / D))
    pe = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(pe).to(device=device, dtype=dtype)


def _ffn(p, blocks, specs, h2, cfg: ArchConfig, *, ctx=None, batch: int = 0,
         decode: bool = False):
    """The MLP or the MoE; ``decode`` never drops a generation token and, on a
    mesh, dispatches tokens (the reference's ``token_dispatch=True``).
    ``batch``: the whole batch that ``h2``'s rows belong to (on a mesh)."""
    if "moe" in p:
        kw = dict(num_experts=cfg.num_experts, top_k=cfg.top_k, act=cfg.mlp_act,
                  capacity_factor=cfg.moe_capacity_factor, dropless=decode)
        if not _on_mesh(ctx):
            return moe_mod.moe_apply(p["moe"], h2, **kw)
        x = rules.as_dtensor(ctx, h2, (_batch_entry(ctx, batch), None, None),
                             (batch, *h2.shape[1:]))
        return moe_mod.moe_apply(p["moe"], x, ctx=ctx, token_dispatch=decode, **kw).to_local()
    return _row_sum(ctx, mlp_apply(blocks["mlp"], h2, cfg.mlp_act), _split(specs, "mlp", "wo", 0))


def _apply_block(p, x, cfg: ArchConfig, kind: str, *, positions, prefix_len=None,
                 attn_impl="chunked", ctx=None, batch: int = 0):
    lp, sp = _blocks(ctx, p)
    h = apply_norm(cfg.norm, lp["ln1"], x)
    if kind in ("attn", "local"):
        q = proj_in(lp["q"], h)  # [B, S, H, hd]
        k = proj_in(lp["k"], h)
        v = proj_in(lp["v"], h)
        if cfg.positions == "rope":
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        kv = _kv_heads(ctx, cfg, sp)
        if kv is not None:
            k, v = k[:, :, kv], v[:, :, kv]
        out = attn_mod.attention(
            q, k, v,
            causal=cfg.kind != "encoder",
            window=cfg.window if kind == "local" else None,
            prefix_len=prefix_len,
            impl=attn_impl,
        )
        mixed = _row_sum(ctx, proj_out(lp["o"], out), _split(sp, "o", "w", 0))
    elif kind == "rec":
        mixed = rec_mod.rglru_block_apply(p["mix"], h, heads=cfg.num_heads)
    else:  # ssm: a Mamba block has no MLP
        return x + ssm_mod.ssd_block_apply(p["mix"], h, d_inner=cfg.d_inner, heads=cfg.ssm_heads,
                                           d_state=cfg.ssm_state)
    x = x + mixed
    return x + _ffn(p, lp, sp, apply_norm(cfg.norm, lp["ln2"], x), cfg, ctx=ctx, batch=batch)


def _embed_inputs(p, cfg: ArchConfig, inputs, lookup=F.embedding):
    """``lookup(tokens, table)``: the table lookup (vocab-parallel on a mesh)."""
    table = p["embed"]["table"]
    if cfg.frontend == "audio_stub":
        x = dense(p["frontend"], inputs["frames"])
    elif cfg.frontend == "vision_stub":
        tok = lookup(inputs["tokens"], table)
        x = torch.cat([inputs["patches"].to(tok.dtype), tok], dim=1)
    else:
        # F.embedding: its CUDA backward sorts the indices, so a repeated token's
        # gradient rows are summed in one order from run to run (no atomics)
        x = lookup(inputs["tokens"], table)
    if cfg.positions == "sinusoidal":
        x = x + _sinusoidal(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
    return x


def _head(p, cfg: ArchConfig, x):
    if cfg.tie_embeddings and "head" not in p:
        return x @ p["embed"]["table"].T.to(x.dtype)
    return dense(p["head"], x)


#: the products ``"dots"`` keeps for the backward: matrix products with no
#: batch dimension (``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``).
#: A projection ``[B, S, d] @ [d, f]`` folds to ``mm``; attention's and the
#: experts' batched products (``bmm``) are recomputed.
_DOTS_SAVED = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED else CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(remat: str, fn, x):
    """``fn(x)`` under ``cfg.remat``: ``"full"`` keeps only ``x`` for the
    backward and recomputes the rest, ``"dots"`` also keeps the outputs of
    the unbatched matrix products (:data:`_DOTS_SAVED`)."""
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    if remat == "full":
        return checkpoint(fn, x, use_reentrant=False)
    return checkpoint(fn, x, use_reentrant=False,
                      context_fn=lambda: create_selective_checkpoint_contexts(_save_dots))


def apply(params, cfg: ArchConfig, inputs, *, attn_impl: str = "chunked", ctx=None):
    """Full forward -> logits ``[B, S, vocab]``.

    ``inputs``: ``{"tokens": [B, S]}``, ``{"frames": [B, S, frontend_dim]}``
    (audio) or ``{"patches": [B, P, d], "tokens": [B, S - P]}`` (vision,
    the patches a bidirectional prefix).  ``attn_impl``: ``"chunked"``,
    ``"direct"`` or ``"flash"`` (the CUDA kernel on the card).

    While autograd records, ``cfg.remat`` (``"none"``, ``"full"`` or
    ``"dots"``) checkpoints each period of ``len(block_pattern)`` layers as
    one unit, as the JAX package wraps its scan body in ``jax.checkpoint``;
    the ``num_layers % len(block_pattern)`` tail layers are not wrapped.
    The values, and the gradients, are those of ``"none"``.

    With ``ctx`` on a mesh, every rank passes the whole inputs, computes its
    batch rows on its blocks, and gets the logits as a ``DTensor`` sharded
    over the batch and vocab rules (see the module's docstring).
    """
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat={cfg.remat!r}: 'none', 'full' or 'dots'")
    _check_kinds(ctx, cfg)
    B = next(iter(inputs.values())).shape[0]
    emb, emb_spec = _blocks(ctx, {k: params[k] for k in ("embed", "frontend") if k in params})
    x = _embed_inputs(emb, cfg, {k: _rows(ctx, v, B) for k, v in inputs.items()},
                      lookup=_lookup(ctx, emb_spec))
    B_l, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B_l, S)
    prefix_len = cfg.num_patches if cfg.frontend == "vision_stub" else None
    layers, kinds = params["layers"], layer_kinds(cfg)

    def run(lo: int, hi: int):
        def layers_lo_hi(x):
            for p, kind in zip(layers[lo:hi], kinds[lo:hi], strict=True):
                x = _apply_block(p, x, cfg, kind, positions=positions, prefix_len=prefix_len,
                                 attn_impl=attn_impl, ctx=ctx, batch=B)
            return x
        return layers_lo_hi

    period = len(cfg.block_pattern)
    wrapped = 0  # layers in checkpointed periods: none unless autograd records
    if cfg.remat != "none" and torch.is_grad_enabled():
        wrapped = cfg.num_layers // period * period
    for lo in range(0, wrapped, period):
        x = _checkpointed(cfg.remat, run(lo, lo + period), x)
    x = run(wrapped, cfg.num_layers)(x)
    return _logits(ctx, params, cfg, x, B)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------


def _cache_for_kind(cfg: ArchConfig, kind: str, batch: int, max_len: int, dtype, dev):
    if kind in ("attn", "local"):
        w = max_len if kind == "attn" else min(cfg.window, max_len)
        shape = (batch, w, cfg.num_kv_heads, cfg.hd)
        c = {"k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev)}
        if dtype == torch.int8:  # quantized serving: per-(b, s, h) absmax scales
            c["k_scale"] = torch.zeros(shape[:3], dtype=torch.bfloat16, device=dev)
            c["v_scale"] = torch.zeros(shape[:3], dtype=torch.bfloat16, device=dev)
        return c
    sdt = torch.bfloat16 if dtype == torch.int8 else dtype  # a recurrent state is not quantized
    if kind == "rec":
        return rec_mod.rglru_init_state(batch, cfg.d_model, sdt, device=dev)
    return ssm_mod.ssd_init_state(batch, d_inner=cfg.d_inner, heads=cfg.ssm_heads,
                                  d_state=cfg.ssm_state, dtype=sdt, device=dev)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda",
               *, ctx=None):
    """Zeroed decode cache ``{"layers": [...]}``, one dict per layer.

    An attention layer keeps ``{"k", "v"[, "k_scale", "v_scale"]}``: a
    ``local`` layer a ring buffer of ``min(window, max_len)`` slots, an int8
    cache per-(b, s, h) absmax scales in bf16.  A ``rec`` or ``ssm`` layer
    keeps ``{"h", "conv"}``: the recurrent state in fp32 and the conv tail in
    ``dtype`` (bf16 when ``dtype`` is int8).

    With ``ctx`` on a mesh, each leaf is a ``DTensor`` laid out by
    :func:`cache_axes` under the ctx's rules, and a rank allocates only its
    own block.
    """
    dev = resolve_device(device)
    if _on_mesh(ctx):
        whole = {"layers": [_cache_for_kind(cfg, kind, batch, max_len, dtype, "meta")
                            for kind in layer_kinds(cfg)]}
        specs = rules.spec_tree(ctx, whole, cache_axes(cfg, int8=dtype == torch.int8))
        return tree_map(lambda t, spec: rules.as_dtensor(
            ctx, torch.zeros(rules.shard_shape(ctx, t.shape, spec), dtype=t.dtype, device=dev),
            spec, t.shape), whole, specs)
    return {"layers": [_cache_for_kind(cfg, kind, batch, max_len, dtype, dev)
                       for kind in layer_kinds(cfg)]}


def _quantize(x: torch.Tensor):
    """int8 absmax over the head dim: ``(round(x / max(s, 1e-6) * 127), s)``, s in fp32."""
    s = x.float().abs().amax(-1)  # [B, KH]
    q = torch.round(x.float() / torch.clamp(s, min=1e-6)[..., None] * 127.0).to(torch.int8)
    return q, s


def _cache_view(ctx, c, specs, batch: int):
    """An attention layer's cache in the layout the rank computes in (its batch
    rows, the kv heads its k/v projections give), and ``write_back(slot)``,
    which puts row ``slot`` of that view back into the cache's own layout.

    The view is the cache itself without a mesh, and a view of the cache's
    own block unless the divisibility fallback laid the cache out otherwise
    (head_dim over the model axis, where the kv heads do not split): then
    the view is a gathered copy, and only the new row goes back."""
    if not _on_mesh(ctx):
        return c, lambda slot: None
    bspec, kv_entry = _batch_entry(ctx, batch), _split(specs, "k", "w", 1)
    held = {name: rules.spec_of(ctx, t) for name, t in c.items()}
    want = {name: (bspec, None, kv_entry, None)[:t.dim()] for name, t in c.items()}
    view = {name: rules.relayout(ctx, t.to_local(), held[name], want[name])
            for name, t in c.items()}

    def write_back(slot: int) -> None:
        for name, t in c.items():
            if held[name] != want[name]:
                row = rules.relayout(ctx, view[name][:, slot:slot + 1], want[name], held[name])
                t.to_local()[:, slot] = row[:, 0]

    return view, write_back


def _decode_attention(ctx, p, specs, cache, h, cfg: ArchConfig, kind: str, pos: int,
                      batch: int):
    c, write_back = _cache_view(ctx, cache, specs, batch)
    B = h.shape[0]
    q = proj_in(p["q"], h)  # [B, 1, H, hd]
    k = proj_in(p["k"], h)
    v = proj_in(p["v"], h)
    if cfg.positions == "rope":
        pp = torch.full((B, 1), pos, device=h.device)
        q = rope(q, pp, cfg.rope_theta)
        k = rope(k, pp, cfg.rope_theta)
    w = c["k"].shape[1]
    slot = pos if kind == "attn" else pos % w
    if c["k"].dtype == torch.int8:
        k8, ks = _quantize(k[:, 0])
        v8, vs = _quantize(v[:, 0])
        c["k"][:, slot] = k8
        c["v"][:, slot] = v8
        c["k_scale"][:, slot] = ks.to(torch.bfloat16)
        c["v_scale"][:, slot] = vs.to(torch.bfloat16)
    else:
        c["k"][:, slot] = k[:, 0].to(c["k"].dtype)
        c["v"][:, slot] = v[:, 0].to(c["v"].dtype)
    write_back(slot)
    s = torch.arange(w, device=h.device)
    kpos = s if kind == "attn" else pos - ((pos - s) % w)  # ring buffer of size window
    kv = _kv_heads(ctx, cfg, specs)
    sel = (lambda t: t) if kv is None else (lambda t: None if t is None else t[:, :, kv])
    out = attn_mod.decode_attention(
        q, sel(c["k"]), sel(c["v"]), pos,
        window=cfg.window if kind == "local" else None,
        kpos=kpos,
        k_scale=sel(c.get("k_scale")),
        v_scale=sel(c.get("v_scale")),
    )
    return _row_sum(ctx, proj_out(p["o"], out), _split(specs, "o", "w", 0))


def _decode_block(p, c, x, cfg: ArchConfig, kind: str, pos: int, *, ctx=None, batch: int = 0):
    lp, sp = _blocks(ctx, p)
    h = apply_norm(cfg.norm, lp["ln1"], x)
    if kind in ("attn", "local"):
        mixed = _decode_attention(ctx, lp, sp, c, h, cfg, kind, pos, batch)
    elif kind == "rec":
        mixed, state = rec_mod.rglru_decode_step(p["mix"], h, c, heads=cfg.num_heads)
        c.update(state)
    else:  # ssm: a Mamba block has no MLP
        mixed, state = ssm_mod.ssd_decode_step(p["mix"], h, c, d_inner=cfg.d_inner,
                                               heads=cfg.ssm_heads, d_state=cfg.ssm_state)
        c.update(state)
        return x + mixed
    x = x + mixed
    return x + _ffn(p, lp, sp, apply_norm(cfg.norm, lp["ln2"], x), cfg, ctx=ctx, batch=batch,
                    decode=True)


def decode_step(params, cfg: ArchConfig, cache, tokens: torch.Tensor, pos: int, *, ctx=None):
    """One decode step -> ``(logits [B, 1, vocab], cache)``.

    tokens: ``[B, 1]`` int; pos: the position of these tokens.  The cache is
    updated in place (slot ``pos``, or ``pos % window`` for a local layer;
    a recurrent layer's ``h`` and ``conv`` entries replaced) and returned.
    With ``ctx`` on a mesh, every rank passes the whole tokens, the cache is
    :func:`init_cache`'s with the same ``ctx``, the MoE dispatches tokens
    (the reference's ``token_dispatch=True``) and the logits are a
    vocab-sharded ``DTensor``.
    """
    _check_kinds(ctx, cfg)
    B = tokens.shape[0]
    emb, emb_spec = _blocks(ctx, {"embed": params["embed"]})
    x = _lookup(ctx, emb_spec)(_rows(ctx, tokens, B), emb["embed"]["table"])
    for p, c, kind in zip(params["layers"], cache["layers"], layer_kinds(cfg), strict=True):
        x = _decode_block(p, c, x, cfg, kind, pos, ctx=ctx, batch=B)
    return _logits(ctx, params, cfg, x, B), cache
