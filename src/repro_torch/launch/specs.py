"""Input specs and their sharding specs for every (arch x shape) cell.

Port of the JAX package's ``repro/launch/specs.py``.  The inputs of a cell's
train step, prefill forward or decode step are fake tensors (shapes, dtypes,
no storage; :func:`repro_torch.models.model.fake_mode`) with the reference's
shapes and dtypes, and their sharding specs come from the same logical-axis
rules as the parameters (:mod:`repro_torch.sharding.rules`).  The JAX
package returns ``NamedSharding``\\s on a device mesh; the port returns the
spec tuples, since placement waits for the multi-card slice.  Shape-specific
rule overrides, as the reference's:

* inference (prefill, decode) keeps dense parameters off the FSDP axis
  (``embed=()``); decode of an MoE moves expert weights' FSDP axis to the
  expert d_ff dim (``embed_e=()``, ``moe_ff=("data",)``);
* ``long_500k`` (batch 1): the KV cache shards its sequence dim over the
  data axis, and the batch falls back to replicated by the divisibility rule.
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..models import transformer
from ..models.model import fake_mode
from ..sharding.rules import MeshCtx, logical_to_spec, spec_tree

__all__ = [
    "make_ctx",
    "serve_input_spec_tree",
    "serve_input_specs",
    "train_input_spec_tree",
    "train_input_specs",
]


def make_ctx(axes, cfg: ArchConfig, shape: ShapeSpec) -> MeshCtx:
    """The rules in force for a cell on a mesh (``{axis: size}`` or a :class:`MeshCtx`)."""
    ctx = axes if isinstance(axes, MeshCtx) else MeshCtx.of(axes)
    if shape.kind in ("prefill", "decode"):
        # Inference: no optimizer state, so dense params fit TP-only.  Expert
        # weights keep an FSDP axis (MoE volume never fits TP-only): prefill
        # on d_model ("embed_e"), decode on the expert d_ff dim ("moe_ff").
        ctx = ctx.with_rules(embed=())
    if shape.kind == "decode" and cfg.is_moe:
        ctx = ctx.with_rules(embed_e=(), moe_ff=("data",))
    if shape.name == "long_500k":
        ctx = ctx.with_rules(seq_kv=("data",))
    # decode_32k keeps KV caches batch-sharded only (the reference's note:
    # a sharded cache seq dim makes the per-token update cross shards)
    return ctx


def _token_shapes(cfg: ArchConfig, batch: int, seq: int) -> dict:
    """``{name: (shape, dtype, logical axes)}`` of a cell's token inputs."""
    if cfg.frontend == "audio_stub":
        return {"frames": ((batch, seq, cfg.frontend_dim), torch.float32, ("batch", "seq", None)),
                "labels": ((batch, seq), torch.int32, ("batch", "seq"))}
    if cfg.frontend == "vision_stub":
        return {"patches": ((batch, cfg.num_patches, cfg.d_model), torch.float32,
                            ("batch", None, None)),
                "tokens": ((batch, seq - cfg.num_patches), torch.int32, ("batch", None))}
    return {"tokens": ((batch, seq), torch.int32, ("batch", "seq"))}


def train_input_specs(cfg: ArchConfig, shape: ShapeSpec, *, mode=None) -> dict:
    """The batch of a train or prefill cell as fake tensors (``mode``, or a new one)."""
    with mode if mode is not None else fake_mode():
        return {k: torch.empty(s, dtype=dt)
                for k, (s, dt, _) in _token_shapes(cfg, shape.global_batch, shape.seq_len).items()}


def train_input_spec_tree(ctx, cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """The batch's sharding specs (the reference's ``train_input_shardings``)."""
    return {k: logical_to_spec(ctx, s, ax)
            for k, (s, _, ax) in _token_shapes(cfg, shape.global_batch, shape.seq_len).items()}


def serve_input_specs(cfg: ArchConfig, shape: ShapeSpec, kv_dtype=None, *, mode=None):
    """``(cache, tokens, pos)`` of a decode cell as fake tensors: the cache of
    ``seq_len`` positions in ``kv_dtype`` (bf16 by default; int8 adds the
    per-(b, s, h) scales), tokens ``[B, 1]`` int32 and a 0-d int32 position."""
    dt = kv_dtype if kv_dtype is not None else torch.bfloat16
    with mode if mode is not None else fake_mode():
        cache = transformer.init_cache(cfg, shape.global_batch, shape.seq_len, dt, device="cpu")
        tokens = torch.empty((shape.global_batch, 1), dtype=torch.int32)
        pos = torch.empty((), dtype=torch.int32)
    return cache, tokens, pos


def serve_input_spec_tree(ctx, cfg: ArchConfig, shape: ShapeSpec, kv_dtype=None):
    """``(cache specs, tokens spec, pos spec)`` (the reference's ``serve_input_shardings``)."""
    cache, tokens, _ = serve_input_specs(cfg, shape, kv_dtype)
    c_axes = transformer.cache_axes(cfg, int8=kv_dtype == torch.int8)
    tok_spec = logical_to_spec(ctx, tuple(tokens.shape), ("batch", None))
    return spec_tree(ctx, cache, c_axes), tok_spec, ()
