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
:mod:`repro_torch.convert` maps between the two.  The JAX package's ``ctx``
(sharding constraints and expert parallelism) and ``unroll`` (scan or
Python loop) have no counterpart: the port runs on one card and its layer
loop is a Python loop.  The decode cache is ``{"layers": [...]}``, one dict
per layer; :func:`decode_step` writes the new token's keys and values into
an attention layer's cache in place and replaces a recurrent layer's state
entries (``h``, ``conv``) in its dict.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..core.matrix import resolve_device
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

__all__ = ["apply", "decode_step", "init_cache", "init_params", "layer_kinds"]


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
# forward
# --------------------------------------------------------------------------


def _sinusoidal(S: int, D: int, dtype, device) -> torch.Tensor:
    """float64 on the host, cast to the activation type (as the JAX package does)."""
    pos = np.arange(S)[:, None]
    i = np.arange(D // 2)[None, :]
    ang = pos / (10000 ** (2 * i / D))
    pe = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(pe).to(device=device, dtype=dtype)


def _ffn(p, h2, cfg: ArchConfig, *, dropless: bool = False):
    if "moe" in p:
        return moe_mod.moe_apply(p["moe"], h2, num_experts=cfg.num_experts, top_k=cfg.top_k,
                                 act=cfg.mlp_act, capacity_factor=cfg.moe_capacity_factor,
                                 dropless=dropless)
    return mlp_apply(p["mlp"], h2, cfg.mlp_act)


def _apply_block(p, x, cfg: ArchConfig, kind: str, *, positions, prefix_len=None,
                 attn_impl="chunked"):
    h = apply_norm(cfg.norm, p["ln1"], x)
    if kind in ("attn", "local"):
        q = proj_in(p["q"], h)  # [B, S, H, hd]
        k = proj_in(p["k"], h)
        v = proj_in(p["v"], h)
        if cfg.positions == "rope":
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        out = attn_mod.attention(
            q, k, v,
            causal=cfg.kind != "encoder",
            window=cfg.window if kind == "local" else None,
            prefix_len=prefix_len,
            impl=attn_impl,
        )
        mixed = proj_out(p["o"], out)
    elif kind == "rec":
        mixed = rec_mod.rglru_block_apply(p["mix"], h, heads=cfg.num_heads)
    else:  # ssm: a Mamba block has no MLP
        return x + ssm_mod.ssd_block_apply(p["mix"], h, d_inner=cfg.d_inner, heads=cfg.ssm_heads,
                                           d_state=cfg.ssm_state)
    x = x + mixed
    return x + _ffn(p, apply_norm(cfg.norm, p["ln2"], x), cfg)


def _embed_inputs(p, cfg: ArchConfig, inputs):
    table = p["embed"]["table"]
    if cfg.frontend == "audio_stub":
        x = dense(p["frontend"], inputs["frames"])
    elif cfg.frontend == "vision_stub":
        tok = F.embedding(inputs["tokens"], table)
        x = torch.cat([inputs["patches"].to(tok.dtype), tok], dim=1)
    else:
        # F.embedding: its CUDA backward sorts the indices, so a repeated token's
        # gradient rows are summed in one order from run to run (no atomics)
        x = F.embedding(inputs["tokens"], table)
    if cfg.positions == "sinusoidal":
        x = x + _sinusoidal(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
    return x


def _head(p, cfg: ArchConfig, x):
    if cfg.tie_embeddings and "head" not in p:
        return x @ p["embed"]["table"].T.to(x.dtype)
    return dense(p["head"], x)


def apply(params, cfg: ArchConfig, inputs, *, attn_impl: str = "chunked") -> torch.Tensor:
    """Full forward -> logits ``[B, S, vocab]``.

    ``inputs``: ``{"tokens": [B, S]}``, ``{"frames": [B, S, frontend_dim]}``
    (audio) or ``{"patches": [B, P, d], "tokens": [B, S - P]}`` (vision,
    the patches a bidirectional prefix).  ``attn_impl``: ``"chunked"``,
    ``"direct"`` or ``"flash"`` (the CUDA kernel on the card).
    """
    x = _embed_inputs(params, cfg, inputs)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    prefix_len = cfg.num_patches if cfg.frontend == "vision_stub" else None
    for p, kind in zip(params["layers"], layer_kinds(cfg), strict=True):
        x = _apply_block(p, x, cfg, kind, positions=positions, prefix_len=prefix_len,
                         attn_impl=attn_impl)
    x = apply_norm(_final_norm_kind(cfg), params["final_norm"], x)
    return _head(params, cfg, x)


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


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda"):
    """Zeroed decode cache ``{"layers": [...]}``, one dict per layer.

    An attention layer keeps ``{"k", "v"[, "k_scale", "v_scale"]}``: a
    ``local`` layer a ring buffer of ``min(window, max_len)`` slots, an int8
    cache per-(b, s, h) absmax scales in bf16.  A ``rec`` or ``ssm`` layer
    keeps ``{"h", "conv"}``: the recurrent state in fp32 and the conv tail in
    ``dtype`` (bf16 when ``dtype`` is int8).
    """
    dev = resolve_device(device)
    return {"layers": [_cache_for_kind(cfg, kind, batch, max_len, dtype, dev)
                       for kind in layer_kinds(cfg)]}


def _quantize(x: torch.Tensor):
    """int8 absmax over the head dim: ``(round(x / max(s, 1e-6) * 127), s)``, s in fp32."""
    s = x.float().abs().amax(-1)  # [B, KH]
    q = torch.round(x.float() / torch.clamp(s, min=1e-6)[..., None] * 127.0).to(torch.int8)
    return q, s


def _decode_attention(p, c, h, cfg: ArchConfig, kind: str, pos: int):
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
    s = torch.arange(w, device=h.device)
    kpos = s if kind == "attn" else pos - ((pos - s) % w)  # ring buffer of size window
    out = attn_mod.decode_attention(
        q, c["k"], c["v"], pos,
        window=cfg.window if kind == "local" else None,
        kpos=kpos,
        k_scale=c.get("k_scale"),
        v_scale=c.get("v_scale"),
    )
    return proj_out(p["o"], out)


def _decode_block(p, c, x, cfg: ArchConfig, kind: str, pos: int):
    h = apply_norm(cfg.norm, p["ln1"], x)
    if kind in ("attn", "local"):
        mixed = _decode_attention(p, c, h, cfg, kind, pos)
    elif kind == "rec":
        mixed, state = rec_mod.rglru_decode_step(p["mix"], h, c, heads=cfg.num_heads)
        c.update(state)
    else:  # ssm: a Mamba block has no MLP
        mixed, state = ssm_mod.ssd_decode_step(p["mix"], h, c, d_inner=cfg.d_inner,
                                               heads=cfg.ssm_heads, d_state=cfg.ssm_state)
        c.update(state)
        return x + mixed
    x = x + mixed
    # decode never drops a generation token
    return x + _ffn(p, apply_norm(cfg.norm, p["ln2"], x), cfg, dropless=True)


def decode_step(params, cfg: ArchConfig, cache, tokens: torch.Tensor, pos: int):
    """One decode step -> ``(logits [B, 1, vocab], cache)``.

    tokens: ``[B, 1]`` int; pos: the position of these tokens.  The cache is
    updated in place (slot ``pos``, or ``pos % window`` for a local layer;
    a recurrent layer's ``h`` and ``conv`` entries replaced) and returned.
    """
    x = params["embed"]["table"][tokens]
    for p, c, kind in zip(params["layers"], cache["layers"], layer_kinds(cfg), strict=True):
        x = _decode_block(p, c, x, cfg, kind, pos)
    x = apply_norm(_final_norm_kind(cfg), params["final_norm"], x)
    return _head(params, cfg, x), cache
