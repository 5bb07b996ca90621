"""Model assembly for the dense-attention LMs: decoder / encoder / VLM from ArchConfig.

Port of the JAX package's ``repro/models/transformer.py`` for the ``attn``
and ``local`` block kinds with the dense MLP, and all three frontends
(tokens, audio frames, vision patches as a prefix).  MoE, ``rec`` (RG-LRU)
and ``ssm`` (SSD) blocks raise ``NotImplementedError``.

Parameters are a plain dict: ``embed``, optional ``frontend``, ``layers`` — a
list with one dict per layer in execution order (layer ``i`` has kind
``block_pattern[i % len(block_pattern)]``) — ``final_norm`` and, untied,
``head``.  The JAX package stacks layers by pattern position for its scan;
:mod:`repro_torch.convert` maps between the two.  The JAX package's ``ctx``
(sharding constraints) and ``unroll`` (scan or Python loop) have no
counterpart: the port runs on one card and its layer loop is a Python loop.
The decode cache is ``{"layers": [...]}``, one dict per layer, and
:func:`decode_step` writes the new token's keys and values into it in place.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.matrix import resolve_device
from . import attention as attn_mod
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

__all__ = ["apply", "decode_step", "init_cache", "init_params", "layer_kinds", "tree_map"]

_NOT_PORTED = ("{what} is not ported to the PyTorch package yet "
               "(ROADMAP queue 1 item 6: MoE, RG-LRU and SSD blocks)")


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a parameter or cache tree (dicts and lists), structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def layer_kinds(cfg: ArchConfig) -> list[str]:
    """The block kind of every layer, in execution order."""
    pattern = cfg.block_pattern
    return [pattern[i % len(pattern)] for i in range(cfg.num_layers)]


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.is_moe:
        raise NotImplementedError(_NOT_PORTED.format(what=f"{cfg.name}: the MoE block"))
    other = sorted(set(cfg.block_pattern) - {"attn", "local"})
    if other:
        raise NotImplementedError(_NOT_PORTED.format(what=f"{cfg.name}: block kind(s) {other}"))


def _final_norm_kind(cfg: ArchConfig) -> str:
    return cfg.norm if cfg.norm != "nonparam_ln" else "rmsnorm"


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def _block_init(gen, cfg: ArchConfig):
    dev = gen.device
    hd = cfg.hd
    return {
        "ln1": norm_init(cfg.norm, cfg.d_model, dev),
        "q": proj_in_init(gen, cfg.d_model, cfg.num_heads, hd, bias=cfg.qkv_bias),
        "k": proj_in_init(gen, cfg.d_model, cfg.num_kv_heads, hd, bias=cfg.qkv_bias),
        "v": proj_in_init(gen, cfg.d_model, cfg.num_kv_heads, hd, bias=cfg.qkv_bias),
        "o": proj_out_init(gen, cfg.num_heads, hd, cfg.d_model),
        "ln2": norm_init(cfg.norm, cfg.d_model, dev),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act),
    }


def init_params(cfg: ArchConfig, *, seed: int | None = None,
                generator: torch.Generator | None = None, device="cuda"):
    """Random parameters with the JAX package's shapes, scales and zero/one inits.

    Draws from ``generator`` (which fixes the device) or from a new
    ``torch.Generator`` on ``device`` seeded with ``seed``.  The numbers
    differ from ``jax.random``'s; carry JAX parameters across with
    :func:`repro_torch.convert.lm_params_from_arrays`.
    """
    _check_supported(cfg)
    if generator is None:
        if seed is None:
            raise ValueError("init_params needs a seed or a generator")
        generator = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    gen = generator
    p = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model)}
    if cfg.frontend == "audio_stub":
        p["frontend"] = dense_init(gen, cfg.frontend_dim, cfg.d_model)
    p["layers"] = [_block_init(gen, cfg) for _ in range(cfg.num_layers)]
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


def _apply_block(p, x, cfg: ArchConfig, kind: str, *, positions, prefix_len=None,
                 attn_impl="chunked"):
    h = apply_norm(cfg.norm, p["ln1"], x)
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
    x = x + proj_out(p["o"], out)
    h2 = apply_norm(cfg.norm, p["ln2"], x)
    return x + mlp_apply(p["mlp"], h2, cfg.mlp_act)


def _embed_inputs(p, cfg: ArchConfig, inputs):
    table = p["embed"]["table"]
    if cfg.frontend == "audio_stub":
        x = dense(p["frontend"], inputs["frames"])
    elif cfg.frontend == "vision_stub":
        tok = table[inputs["tokens"]]
        x = torch.cat([inputs["patches"].to(tok.dtype), tok], dim=1)
    else:
        x = table[inputs["tokens"]]
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
    _check_supported(cfg)
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


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda"):
    """Zeroed KV cache ``{"layers": [{"k", "v"[, "k_scale", "v_scale"]}, ...]}``.

    A ``local`` layer keeps a ring buffer of ``min(window, max_len)`` slots.
    An int8 cache keeps per-(b, s, h) absmax scales in bf16.
    """
    _check_supported(cfg)
    dev = resolve_device(device)
    layers = []
    for kind in layer_kinds(cfg):
        w = max_len if kind == "attn" else min(cfg.window, max_len)
        shape = (batch, w, cfg.num_kv_heads, cfg.hd)
        c = {"k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev)}
        if dtype == torch.int8:  # quantized serving: per-(b, s, h) absmax scales
            c["k_scale"] = torch.zeros(shape[:3], dtype=torch.bfloat16, device=dev)
            c["v_scale"] = torch.zeros(shape[:3], dtype=torch.bfloat16, device=dev)
        layers.append(c)
    return {"layers": layers}


def _quantize(x: torch.Tensor):
    """int8 absmax over the head dim: ``(round(x / max(s, 1e-6) * 127), s)``, s in fp32."""
    s = x.float().abs().amax(-1)  # [B, KH]
    q = torch.round(x.float() / torch.clamp(s, min=1e-6)[..., None] * 127.0).to(torch.int8)
    return q, s


def _decode_block(p, c, x, cfg: ArchConfig, kind: str, pos: int):
    B = x.shape[0]
    h = apply_norm(cfg.norm, p["ln1"], x)
    q = proj_in(p["q"], h)  # [B, 1, H, hd]
    k = proj_in(p["k"], h)
    v = proj_in(p["v"], h)
    if cfg.positions == "rope":
        pp = torch.full((B, 1), pos, device=x.device)
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
    s = torch.arange(w, device=x.device)
    kpos = s if kind == "attn" else pos - ((pos - s) % w)  # ring buffer of size window
    out = attn_mod.decode_attention(
        q, c["k"], c["v"], pos,
        window=cfg.window if kind == "local" else None,
        kpos=kpos,
        k_scale=c.get("k_scale"),
        v_scale=c.get("v_scale"),
    )
    x = x + proj_out(p["o"], out)
    h2 = apply_norm(cfg.norm, p["ln2"], x)
    return x + mlp_apply(p["mlp"], h2, cfg.mlp_act)


def decode_step(params, cfg: ArchConfig, cache, tokens: torch.Tensor, pos: int):
    """One decode step -> ``(logits [B, 1, vocab], cache)``.

    tokens: ``[B, 1]`` int; pos: the position of these tokens.  The cache is
    updated in place (slot ``pos``, or ``pos % window`` for a local layer)
    and returned.
    """
    _check_supported(cfg)
    x = params["embed"]["table"][tokens]
    for p, c, kind in zip(params["layers"], cache["layers"], layer_kinds(cfg), strict=True):
        x = _decode_block(p, c, x, cfg, kind, pos)
    x = apply_norm(_final_norm_kind(cfg), params["final_norm"], x)
    return _head(params, cfg, x), cache
