"""Serve step factory.

Port of ``make_serve_step`` of the JAX package's ``repro/models/model.py``.
The loss and train steps (and ``optim/``) are not ported yet.
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from . import transformer

__all__ = ["cast_params", "make_serve_step"]


def cast_params(params, dtype: torch.dtype):
    """Every floating-point tensor of a parameter tree cast to ``dtype`` (others as they are)."""
    return transformer.tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, params)


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
