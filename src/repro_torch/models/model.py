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
dtypes, no storage) for the dry run (:mod:`repro_torch.launch.dryrun`); the
JAX package's ``grad_reshard`` pins gradients to a multi-device sharding and
waits for the multi-card slice.  ``cfg.remat`` is
applied as the JAX package applies it (:func:`transformer.apply`): each
period of layers is one ``torch.utils.checkpoint`` unit (``"full"``: recompute
everything, ``"dots"``: keep the unbatched matrix products), with gradients
bit-identical to ``"none"``'s.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..optim import adamw_init, adamw_update, clip_by_global_norm, cosine_lr
from ..tree import tree_leaves, tree_map, tree_unflatten
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
]


def cast_params(params, dtype: torch.dtype):
    """Every floating-point tensor of a parameter tree cast to ``dtype`` (others as they are)."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, params)


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


def make_loss_fn(cfg: ArchConfig, *, attn_impl: str = "chunked", compute_dtype=torch.bfloat16):
    """Returns ``loss_fn(params, batch) -> (loss, {"loss": loss})``.

    The parameters and the batch's floating inputs are cast to
    ``compute_dtype`` inside the function, so a gradient reaches the
    parameters in their own type.  Decoders predict the next token; an
    encoder (hubert) its ``labels``; a vision prefix-LM (paligemma) the text
    after its ``num_patches`` patches.
    """

    def loss_fn(params, batch):
        logits = transformer.apply(cast_params(params, compute_dtype), cfg,
                                   _cast_inputs(batch, compute_dtype), attn_impl=attn_impl)
        if cfg.kind == "encoder":
            loss = _ce(logits, batch["labels"])
        elif cfg.frontend == "vision_stub":
            # prefix-LM: text logits start after the patch prefix
            loss = _ce(logits[:, cfg.num_patches:-1], batch["tokens"][:, 1:])
        else:
            loss = _ce(logits[:, :-1], batch["tokens"][:, 1:])
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


def make_grad_fn(cfg: ArchConfig, *, attn_impl: str = "chunked", compute_dtype=torch.bfloat16,
                 grad_accum: int | None = None):
    """Returns ``grad_fn(params, batch) -> (loss, grads)``, the loss an fp32 0-d tensor.

    ``batch`` holds numpy arrays or tensors; they move to the parameters'
    device.  ``grad_accum > 1`` splits the batch on its leading dimension into
    that many microbatches, sums their gradients in fp32 in microbatch order
    and divides (the activation-memory lever); the gradients are then fp32,
    and otherwise in the parameters' type.
    """
    loss_fn = make_loss_fn(cfg, attn_impl=attn_impl, compute_dtype=compute_dtype)
    accum = grad_accum if grad_accum is not None else cfg.grad_accum

    def grads_of(params, mb):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, _ = loss_fn(tree_unflatten(params, leaves), mb)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a parameter the loss does not reach (hubert's token table) gets zeros, as in JAX
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
        return loss.detach(), tree_unflatten(params, grads)

    def grad_fn(params, batch):
        batch = _batch_on(batch, tree_leaves(params)[0].device)
        if accum <= 1:
            return grads_of(params, batch)
        micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:]) for k, v in batch.items()}
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                         params)
        loss_sum = 0.0
        for i in range(accum):
            loss, g = grads_of(params, {k: v[i] for k, v in micro.items()})
            grads = tree_map(lambda a, b: a + b.float(), grads, g)
            loss_sum = loss_sum + loss
        return loss_sum / accum, tree_map(lambda g: g / accum, grads)

    return grad_fn


def make_update_fn(*, lr_peak: float = 3e-4, warmup: int = 100, total_steps: int = 10_000,
                   grad_clip: float = 1.0, weight_decay: float = 0.1):
    """Returns ``update(state, grads) -> (state, {"grad_norm", "lr"})``: clip, the
    cosine rate at ``state["step"]``, AdamW, ``step + 1``.  A state whose
    ``opt`` holds a ``master`` copy (see :func:`init_train_state`) is updated
    on that copy, and its parameters become the new master cast to their own
    types."""

    def update(state, grads):
        params = state["params"]
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        lr = cosine_lr(state["step"], peak=lr_peak, warmup=warmup, total=total_steps)
        master = state["opt"].get("master", params)
        opt_in = {k: v for k, v in state["opt"].items() if k != "master"}
        new_master, new_opt = adamw_update(grads, opt_in, master, lr=lr,
                                           weight_decay=weight_decay)
        if "master" in state["opt"]:
            new_params = tree_map(lambda m, p: m.to(p.dtype), new_master, params)
            new_opt["master"] = new_master
        else:
            new_params = new_master
        new_state = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
        return new_state, {"grad_norm": gnorm, "lr": lr}

    return update


def make_train_step(cfg: ArchConfig, *, attn_impl: str = "chunked", compute_dtype=torch.bfloat16,
                    lr_peak: float = 3e-4, warmup: int = 100, total_steps: int = 10_000,
                    grad_clip: float = 1.0, grad_accum: int | None = None,
                    weight_decay: float = 0.1, on_update=None):
    """Returns ``train_step(state, batch) -> (state, {"loss", "grad_norm", "lr"})``:
    :func:`make_grad_fn`, then :func:`make_update_fn`.  ``state`` is left as it was.
    ``on_update()``, if given, is called between the two (the dry run's
    meters start the update's phase there)."""
    grad_fn = make_grad_fn(cfg, attn_impl=attn_impl, compute_dtype=compute_dtype,
                           grad_accum=grad_accum)
    update = make_update_fn(lr_peak=lr_peak, warmup=warmup, total_steps=total_steps,
                            grad_clip=grad_clip, weight_decay=weight_decay)

    def train_step(state, batch):
        loss, grads = grad_fn(state["params"], batch)
        if on_update is not None:
            on_update()
        new_state, metrics = update(state, grads)
        return new_state, {"loss": loss, **metrics}

    return train_step


def make_serve_step(cfg: ArchConfig, *, compute_dtype=torch.bfloat16):
    """Returns ``serve_step(params, cache, tokens, pos) -> (logits, cache)``.

    The parameters run in ``compute_dtype``, as in the JAX package's serve
    step.  The cast is made once per parameter tree, on the first step that
    is given it, and kept for the steps that follow: a tree changed in place
    between steps is not seen, so pass a new tree instead.
    """
    cast = {"source": None, "params": None}

    def serve_step(params, cache, tokens, pos):
        if cast["source"] is not params:
            cast.update(source=params, params=cast_params(params, compute_dtype))
        return transformer.decode_step(cast["params"], cfg, cache, tokens, pos)

    return serve_step
