"""Train and serve step factories: the loss, gradient accumulation, the optimizer's wiring.

Port of the JAX package's ``repro/models/model.py``.  The gradients come
from ``torch.autograd.grad`` over the plain PyTorch forward (the chunked
attention, the MoE's batched expert GEMMs, the RG-LRU and SSD scans).  The
port's hand-written kernels have no gradient rule, as the JAX package's
Pallas calls have none, and raise under autograd
(:mod:`repro_torch.kernels.ops`): ``attn_impl="flash"`` fails on the first
step instead of leaving attention out of the gradient.

A train state is ``{"params", "opt": {"mu", "nu", "count"[, "master"]},
"step"}``; ``step`` and ``count`` are int32 0-d tensors on the parameters'
device.  A train step returns a new state and modifies none of the one it is
given, so a failed step can be retried on the same state.
:func:`abstract_train_state` builds the same tree as fake tensors (shapes and
dtypes, no storage) for the dry run (:mod:`repro_torch.launch.dryrun`).
``cfg.remat`` is applied as the JAX package applies it
(:func:`transformer.apply`): each period of layers is one
``torch.utils.checkpoint`` unit (``"full"``: recompute everything,
``"dots"``: keep the unbatched matrix products), with gradients
bit-identical to ``"none"``'s.

Serving and training both run on a mesh (``ctx`` a
:class:`~repro_torch.sharding.rules.MeshCtx` on a ``DeviceMesh``, every rank
making the same call with its ``DTensor`` state, laid out by
:func:`repro_torch.runtime.elastic.reshard_state`).  The train step on a
mesh differentiates each rank's blocks through the mesh forward, whose
collectives have ``shard_map``'s transposes (:mod:`repro_torch.sharding.rules`):

* the loss is the mean cross entropy over the global batch, computed on
  each rank's ``[B_l, S, V_l]`` logits (vocab-parallel: a max and two sums
  over the model axis, then a sum over the data axes);
* a parameter that a mesh axis shards gets its gradient already reduced,
  as this rank's block: the backward of the FSDP gather over the data axes
  is a ``reduce_scatter`` with ``grad_reshard=True`` (the reference's pinned
  gradients) and an ``all_reduce`` and a cut with ``False``; a parameter no
  data axis shards gets a sum over those axes after the backward;
* a parameter the loss should reach and does not raises, where one device
  gives it zeros (hubert's token table, which the loss never reads, gets
  zeros on both).

The values are one process's up to the order of the sums.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..optim import adamw_init, adamw_update, clip_by_global_norm, cosine_lr
from ..sharding import rules
from ..tree import tree_leaves, tree_map, tree_paths, tree_unflatten
from . import transformer

__all__ = [
    "abstract_train_state",
    "cast_params",
    "fake_mode",
    "init_train_state",
    "make_grad_fn",
    "make_loss_fn",
    "make_serve_step",
    "make_train_step",
    "make_update_fn",
    "unreached",
]


def cast_params(params, dtype: torch.dtype):
    """Every floating-point tensor of a parameter tree cast to ``dtype`` (others as
    they are); a ``DTensor``'s local block is cast in place of the ``DTensor``
    (no collective), and the layout kept."""
    return tree_map(lambda t: transformer.cast_leaf(t, dtype), params)


def _cast_inputs(batch, dtype):
    return {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in batch.items()}


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy in fp32: logsumexp less the label's logit.

    The label's logit is gathered; the JAX package contracts with a one-hot
    ``[B, S, V]`` array, the same value without its 2.5 GB at qwen2-0.5b's
    vocabulary and 4,096 tokens.
    """
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    correct = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - correct).mean()


def _ce_on_mesh(ctx, logits: torch.Tensor, labels: torch.Tensor, spec: tuple,
                count: int, keep=None) -> torch.Tensor:
    """:func:`_ce` over a global batch of ``count`` labels, from this rank's block
    ``[B_l, S, V_l]`` of the logits (laid out by ``spec``) and its rows of the
    labels.  The logsumexp takes the max and the sum of exponentials over the
    model axis, the label's logit comes from the rank whose vocab range holds
    it, and the rows' sum is summed over the data axes: the same value on
    every rank, with no ``[B, S, V]`` gather.  Logits cut along the sequence
    (sequence parallelism with a head the vocab's fallback keeps whole) come
    with every position's label and ``keep``, the positions that count, and
    their sum is summed over the sequence's axes too."""
    logits = logits.float()
    vocab = rules.mesh_axes(spec[-1])
    m = logits.detach().amax(-1)
    if vocab:
        m = rules.pmax(ctx, m, vocab)
    V_l = logits.shape[-1]
    t = labels.long() - rules.block_index(ctx, vocab) * V_l
    inside = (t >= 0) & (t < V_l)
    picked = logits.gather(-1, torch.where(inside, t, 0)[..., None])[..., 0]
    parts = torch.stack([torch.exp(logits - m[..., None]).sum(-1),
                         torch.where(inside, picked, 0.0)])
    if vocab:
        parts = rules.psum(ctx, parts, vocab)  # the two sums in one all_reduce
    per = m + torch.log(parts[0]) - parts[1]
    if keep is not None:
        per = torch.where(keep, per, 0.0)
    loss = per.sum() / count
    rows = rules.mesh_axes(spec[0]) + rules.mesh_axes(spec[1])
    return rules.psum(ctx, loss, rows) if rows else loss


def _targets(cfg: ArchConfig, logits, batch):
    """The logits that predict and the labels they predict: a decoder's next
    token, an encoder's (hubert) ``labels``, a vision prefix-LM's (paligemma)
    text after its ``num_patches`` patches."""
    if cfg.kind == "encoder":
        return logits, batch["labels"]
    if cfg.frontend == "vision_stub":
        return logits[:, cfg.num_patches:-1], batch["tokens"][:, 1:]
    return logits[:, :-1], batch["tokens"][:, 1:]


def _position_targets(cfg: ArchConfig, batch, S: int):
    """``(labels, keep)``, both ``[B, S]``: the label each position of the stream
    predicts (as :func:`_targets` pairs them) and whether it counts, for
    logits cut along the sequence."""
    if cfg.kind == "encoder":
        labels = batch["labels"].long()
        return labels, torch.ones_like(labels, dtype=torch.bool)
    tokens = batch["tokens"].long()
    lo = cfg.num_patches if cfg.frontend == "vision_stub" else 0  # the first text position
    labels = torch.zeros((tokens.shape[0], S), dtype=torch.long, device=tokens.device)
    labels[:, lo:S - 1] = tokens[:, 1:]
    keep = torch.zeros_like(labels, dtype=torch.bool)
    keep[:, lo:S - 1] = True
    return labels, keep


def _on_mesh(ctx) -> bool:
    return ctx is not None and ctx.mesh is not None


def make_loss_fn(cfg: ArchConfig, ctx=None, *, attn_impl: str = "chunked",
                 compute_dtype=torch.bfloat16):
    """Returns ``loss_fn(params, batch) -> (loss, {"loss": loss})``.

    The parameters and the batch's floating inputs are cast to
    ``compute_dtype`` inside the function, so a gradient reaches the
    parameters in their own type.  With ``ctx`` on a mesh every rank passes
    its ``DTensor`` parameters and the whole batch, and gets the loss of the
    global batch (:func:`_ce_on_mesh`).
    """

    def loss_fn(params, batch):
        logits = transformer.apply(cast_params(params, compute_dtype), cfg,
                                   _cast_inputs(batch, compute_dtype), attn_impl=attn_impl,
                                   ctx=ctx)
        if not _on_mesh(ctx):
            loss = _ce(*_targets(cfg, logits, batch))
            return loss, {"loss": loss}
        spec = rules.spec_of(ctx, logits)
        if spec[1] is None:
            local, labels = _targets(cfg, rules.block(logits), batch)
            loss = _ce_on_mesh(ctx, local, rules.local_block(ctx, labels, (spec[0], None)),
                               spec, labels.numel())
        else:
            labels, keep = _position_targets(cfg, batch, logits.shape[1])
            loss = _ce_on_mesh(ctx, rules.block(logits),
                               rules.local_block(ctx, labels, spec[:2]), spec,
                               int(keep.sum()), keep=rules.local_block(ctx, keep, spec[:2]))
        return loss, {"loss": loss}

    return loss_fn


def init_train_state(cfg: ArchConfig, *, seed: int, device="cuda", param_dtype=torch.float32):
    """``{"params", "opt", "step"}`` from :func:`transformer.init_params`.

    ``param_dtype=torch.bfloat16`` stores bf16 weights and keeps an fp32
    ``master`` copy in the optimizer state (classic mixed precision): the
    gradients are then bf16, and the update runs on the master copy.
    """
    params = transformer.init_params(cfg, seed=seed, device=device)
    dev = tree_leaves(params)[0].device
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if param_dtype == torch.bfloat16:
        state["opt"]["master"] = params  # fp32 master copy
        state["params"] = cast_params(params, torch.bfloat16)
    return state


def fake_mode():
    """A ``FakeTensorMode``: tensors that carry shapes, dtypes and a device and
    allocate nothing, and ops on them that compute only those.  Tensors made
    under one mode are used under that mode (the dry run keeps one per cell).
    The ``meta`` device cannot stand in: ``torch.Generator`` has none, and
    :func:`transformer.init_params` draws from one."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def abstract_train_state(cfg: ArchConfig, *, param_dtype=torch.float32, mode=None) -> dict:
    """:func:`init_train_state`'s tree as fake CPU tensors (``mode``, or a new
    :func:`fake_mode`): the same leaves, shapes and dtypes — the fp32
    ``master`` copy included when ``param_dtype`` is bf16 — without a byte
    allocated or a number drawn."""
    with mode if mode is not None else fake_mode():
        return init_train_state(cfg, seed=0, device="cpu", param_dtype=param_dtype)


def _batch_on(batch, dev: torch.device):
    """The batch's arrays (numpy or tensors) as tensors on ``dev``."""
    return {k: (torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray) else v).to(dev)
            for k, v in batch.items()}


def unreached(cfg: ArchConfig) -> frozenset:
    """The paths of the parameters the loss does not read: an audio encoder's
    token table (hubert looks up no token, and its head is its own)."""
    if cfg.frontend == "audio_stub" and not cfg.tie_embeddings:
        return frozenset({"embed/table"})
    return frozenset()


def _sum_replicated(ctx, params: list, grads: list, seq=None) -> list:
    """Each gradient block summed over the data axes that do not shard its
    parameter (its ranks saw other rows of the batch), one ``all_reduce`` per
    set of axes and type; a parameter a data axis shards was reduced by its
    gather's backward.  Under sequence parallelism (``seq``, the model axis)
    a parameter the model axis does not shard is summed over it as well:
    its ranks computed other blocks of the sequence, or each the whole of a
    product of which it kept its block (Megatron's sequence-parallel
    parameters: the norms, and every weight the fallback keeps whole)."""
    over = ctx.dp_axes + ((seq,) if seq is not None else ())
    groups: dict = {}
    for i, (p, g) in enumerate(zip(params, grads)):
        held = {a for e in rules.spec_of(ctx, p) for a in rules.mesh_axes(e)}
        axes = tuple(a for a in over if a not in held and a not in ctx.same_rows)
        if axes:
            groups.setdefault((axes, g.dtype), []).append(i)
    out = list(grads)
    for (axes, _), idx in groups.items():
        flat = rules.psum(ctx, torch.cat([grads[i].reshape(-1) for i in idx]), axes)
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            out[i] = part.view_as(grads[i])
    return out


def make_grad_fn(cfg: ArchConfig, ctx=None, *, attn_impl: str = "chunked",
                 compute_dtype=torch.bfloat16, grad_accum: int | None = None,
                 grad_reshard: bool = False):
    """Returns ``grad_fn(params, batch) -> (loss, grads)``, the loss an fp32 0-d tensor.

    ``batch`` holds numpy arrays or tensors; they move to the parameters'
    device.  ``grad_accum > 1`` splits the batch on its leading dimension into
    that many microbatches, sums their gradients in fp32 in microbatch order
    and divides (the activation-memory lever); the gradients are then fp32,
    and otherwise in the parameters' type.

    With ``ctx`` on a mesh each gradient is a ``DTensor`` laid out as its
    parameter, every block already reduced (see the module's docstring);
    ``grad_reshard`` picks the FSDP reduction (``reduce_scatter`` or
    ``all_reduce``), the values are the same.  A microbatch whose rows do not
    split over the data axes is replicated over them, as the divisibility
    fallback lays it out: every data rank computes all its rows, and no
    gradient is summed over the data axes (``MeshCtx.same_rows``).
    """
    mesh = _on_mesh(ctx)
    if mesh:
        ctx = dataclasses.replace(ctx, fsdp_grad="reduce_scatter" if grad_reshard
                                  else "all_reduce")
    loss_fn = make_loss_fn(cfg, ctx, attn_impl=attn_impl, compute_dtype=compute_dtype)
    if mesh:  # a microbatch the data axes do not split: the same rows on every data rank
        whole_ctx = dataclasses.replace(ctx, same_rows=ctx.dp_axes)
        whole_loss_fn = make_loss_fn(cfg, whole_ctx, attn_impl=attn_impl,
                                     compute_dtype=compute_dtype)
    accum = grad_accum if grad_accum is not None else cfg.grad_accum
    skip = unreached(cfg)

    def grads_of(params, mb, whole: bool = False):
        """The loss and each parameter's gradient (its block, on a mesh)."""
        held = tree_leaves(params)
        # the parameters are differentiated in the compute type, as the loss casts
        # them: the sums over ranks run in that type, and each gradient is cast to
        # its parameter's type once, after them (the cast's backward)
        leaves = [rules.block(p).detach().to(compute_dtype).requires_grad_() for p in held]
        with torch.enable_grad():
            loss, _ = (whole_loss_fn if whole else loss_fn)(
                tree_unflatten(params, [rules.like(p, x) for p, x in zip(held, leaves)]), mb)
            grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
        for i, (path, _) in enumerate(tree_paths(params)):
            if grads[i] is None:
                # a parameter the loss does not reach gets zeros, as in JAX; on a
                # mesh, a collective without a backward would look the same
                if mesh and path not in skip:
                    raise ValueError(f"no gradient reaches {path} on the mesh: a collective "
                                     f"on its path has no backward")
                grads[i] = torch.zeros_like(leaves[i])
        if mesh:
            grads = _sum_replicated(whole_ctx if whole else ctx, held, grads,
                                    transformer.seq_axis(ctx, cfg, mb))
        del leaves
        for i, p in enumerate(held):  # one leaf's two copies at a time
            grads[i] = grads[i].to(p.dtype)
        return loss.detach(), grads

    def grad_fn(params, batch):
        held = tree_leaves(params)
        batch = _batch_on(batch, rules.block(held[0]).device)
        rows = next(iter(batch.values())).shape[0] // max(accum, 1)
        whole = mesh and rows % math.prod(ctx.axis_sizes[a] for a in ctx.dp_axes) != 0
        if accum <= 1:
            loss, grads = grads_of(params, batch, whole)
        else:
            micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                     for k, v in batch.items()}
            grads = [torch.zeros(rules.block(p).shape, dtype=torch.float32,
                                 device=rules.block(p).device) for p in held]
            loss_sum = 0.0
            for i in range(accum):
                loss, g = grads_of(params, {k: v[i] for k, v in micro.items()}, whole)
                grads = [a + b.float() for a, b in zip(grads, g)]
                loss_sum = loss_sum + loss
            loss, grads = loss_sum / accum, [g / accum for g in grads]
        return loss, tree_unflatten(params, [rules.like(p, g) for p, g in zip(held, grads)])

    return grad_fn


def make_update_fn(*, lr_peak: float = 3e-4, warmup: int = 100, total_steps: int = 10_000,
                   grad_clip: float = 1.0, weight_decay: float = 0.1):
    """Returns ``update(state, grads) -> (state, {"grad_norm", "lr"})``: clip, the
    cosine rate at ``state["step"]``, AdamW, ``step + 1``.  A state whose
    ``opt`` holds a ``master`` copy (see :func:`init_train_state`) is updated
    on that copy, and its parameters become the new master cast to their own
    types.  A mesh state's ``DTensor``\\s are updated block by block, in
    their own layouts."""

    def update(state, grads):
        params = state["params"]
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        step = rules.block(state["step"])
        lr = cosine_lr(step, peak=lr_peak, warmup=warmup, total=total_steps)
        master = state["opt"].get("master", params)
        opt_in = {k: v for k, v in state["opt"].items() if k != "master"}
        new_master, new_opt = adamw_update(grads, opt_in, master, lr=lr,
                                           weight_decay=weight_decay)
        if "master" in state["opt"]:
            new_params = tree_map(lambda m, p: rules.like(p, rules.block(m).to(p.dtype)),
                                  new_master, params)
            new_opt["master"] = new_master
        else:
            new_params = new_master
        new_state = {"params": new_params, "opt": new_opt,
                     "step": rules.like(state["step"], step + 1)}
        return new_state, {"grad_norm": gnorm, "lr": lr}

    return update


def make_train_step(cfg: ArchConfig, ctx=None, *, attn_impl: str = "chunked",
                    compute_dtype=torch.bfloat16, lr_peak: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, grad_clip: float = 1.0,
                    grad_accum: int | None = None, weight_decay: float = 0.1,
                    grad_reshard: bool = False, on_update=None):
    """Returns ``train_step(state, batch) -> (state, {"loss", "grad_norm", "lr"})``:
    :func:`make_grad_fn`, then :func:`make_update_fn`.  ``state`` is left as it was.
    ``on_update()``, if given, is called between the two (the dry run's
    meters start the update's phase there).

    With ``ctx`` on a mesh every rank calls the step with its ``DTensor``
    state and the whole batch, and gets its blocks of the new state;
    ``grad_reshard=True`` reduces the FSDP gradients with a
    ``reduce_scatter`` (the reference's gradients pinned to the parameters'
    sharding), ``False`` with an ``all_reduce``: the states are the same."""
    grad_fn = make_grad_fn(cfg, ctx, attn_impl=attn_impl, compute_dtype=compute_dtype,
                           grad_accum=grad_accum, grad_reshard=grad_reshard)
    update = make_update_fn(lr_peak=lr_peak, warmup=warmup, total_steps=total_steps,
                            grad_clip=grad_clip, weight_decay=weight_decay)

    def train_step(state, batch):
        loss, grads = grad_fn(state["params"], batch)
        if on_update is not None:
            on_update()
        new_state, metrics = update(state, grads)
        return new_state, {"loss": loss, **metrics}

    return train_step


def make_serve_step(cfg: ArchConfig, ctx=None, *, compute_dtype=torch.bfloat16):
    """Returns ``serve_step(params, cache, tokens, pos) -> (logits, cache)``.

    The parameters run in ``compute_dtype``, as in the JAX package's serve
    step.  The cast is made once per parameter tree, on the first step that
    is given it, and kept for the steps that follow: a tree changed in place
    between steps is not seen, so pass a new tree instead.  With ``ctx`` on a
    mesh, every rank calls the step with its ``DTensor`` parameters and
    cache (:func:`transformer.decode_step`).
    """
    cast = {"source": None, "params": None}

    def serve_step(params, cache, tokens, pos):
        if cast["source"] is not params:
            cast.update(source=params, params=cast_params(params, compute_dtype))
        return transformer.decode_step(cast["params"], cfg, cache, tokens, pos, ctx=ctx)

    return serve_step
