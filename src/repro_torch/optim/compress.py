"""Int8 gradient compression with error feedback (cross-pod all-reduce aid).

Port of the JAX package's ``repro/optim/compress.py``.  Each leaf is
quantised to int8 with one fp32 scale, ``max|g| / 127``; ``torch.round``
rounds half to even as ``jnp.round`` does, so the codes equal the JAX
package's.  Error feedback keeps the quantisation residual and adds it to
the next step's gradient (Karimireddy et al., 2019)::

    q, scales = compress_grads(intended)          # intended = grads + err
    transmitted = decompress_grads(q, scales)     # what the wire carries
    err = error_feedback_update(intended, transmitted)
"""

from __future__ import annotations

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["compress_grads", "decompress_grads", "error_feedback_update"]


def _q_one(g: torch.Tensor):
    g32 = g.float()
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_grads(grads):
    """``(int8 codes, fp32 0-d scales)``, two trees of ``grads``' structure."""
    pairs = [_q_one(g) for g in tree_leaves(grads)]
    return (tree_unflatten(grads, [q for q, _ in pairs]),
            tree_unflatten(grads, [s for _, s in pairs]))


def decompress_grads(q, scales):
    return tree_map(lambda qq, s: qq.float() * s, q, scales)


def error_feedback_update(intended, transmitted):
    """New residual: what was meant to be sent less what the wire carried."""
    return tree_map(lambda a, b: a.float() - b.float(), intended, transmitted)
