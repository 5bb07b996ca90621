"""AdamW with global-norm clipping and a cosine schedule.

Port of the JAX package's ``repro/optim/adamw.py``.  The optimizer state
mirrors the parameter tree: ``{"mu", "nu", "count"}``, the moments in fp32
and ``count`` an int32 0-d tensor on the parameters' device.  The bias
corrections, the schedule's warmup and cosine are computed in fp32 tensors,
as XLA computes them (Python floats would be float64).  Every function
builds new tensors and modifies none of its inputs: a step that fails
halfway leaves the state it was given as it was, so a retry starts from it
(:func:`repro_torch.runtime.run_with_retries`).
"""

from __future__ import annotations

import math

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm", "cosine_lr"]


def adamw_init(params):
    """Zero moments of the parameters' shapes in fp32, and ``count`` 0."""
    dev = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def clip_by_global_norm(grads, max_norm: float):
    """``(grads scaled to a global norm of at most max_norm in fp32, the norm before)``.

    The norm is the root of the sum of every leaf's sum of squares, as in
    the JAX package (the leaves' sums added in one reduction, not one by
    one).  ``torch.sum`` sums in a tree on both devices; PyTorch's CPU
    ``linalg.vector_norm`` and ``_foreach_norm`` accumulate in fp32 one
    element after another and were 1.5 % off at 136 M elements.
    """
    leaves = [g.float() for g in tree_leaves(grads)]
    sums = [torch.sum(sq) for sq in torch._foreach_mul(leaves, leaves)]
    norm = torch.sqrt(torch.sum(torch.stack(sums)))
    # a tensor numerator: a Python number over a tensor would multiply by a reciprocal
    scale = torch.clamp(torch.full_like(norm, max_norm) / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_unflatten(grads, torch._foreach_mul(leaves, scale)), norm


def adamw_update(grads, state, params, *, lr, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1):
    """``(new params, new state)``: one AdamW step with decoupled weight decay.

    The update runs in fp32 and the new parameters come back in each
    parameter's type.  ``lr`` may be a 0-d tensor on the parameters' device.
    Every leaf takes the JAX package's sequence of single roundings
    (``b1 * m + (1 - b1) * g``, ...), each op applied to all leaves at once
    by PyTorch's multi-tensor ops (``torch._foreach_*``, out of place): a
    few dozen launches a step, not a dozen per parameter.
    """
    count = state["count"] + 1
    cf = count.float()
    bc1 = 1.0 - b1**cf
    bc2 = 1.0 - b2**cf
    with torch.no_grad():
        g = [x.float() for x in tree_leaves(grads)]
        p = tree_leaves(params)
        p32 = [x.float() for x in p]
        add, mul, div = torch._foreach_add, torch._foreach_mul, torch._foreach_div
        m = add(mul(tree_leaves(state["mu"]), b1), mul(g, 1 - b1))
        v = add(mul(tree_leaves(state["nu"]), b2), mul(mul(g, g), 1 - b2))
        step = div(div(m, bc1), add(torch._foreach_sqrt(div(v, bc2)), eps))
        newp = torch._foreach_sub(p32, mul(add(step, mul(p32, weight_decay)), lr))
        newp = [x.to(q.dtype) for x, q in zip(newp, p, strict=True)]
    return tree_unflatten(params, newp), {"mu": tree_unflatten(params, m),
                                          "nu": tree_unflatten(params, v), "count": count}


def cosine_lr(step, *, peak: float, warmup: int, total: int, floor_frac: float = 0.1):
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine to ``floor_frac * peak``
    at ``total``; ``step`` an int tensor (or int), the rate an fp32 0-d tensor on its device."""
    step = torch.as_tensor(step).float()
    warm = peak * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak * (floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)
