"""Shared transformer layers: norms, rotary, MLPs, embeddings.

Port of the JAX package's ``repro/models/layers.py``.  Parameters are plain
nested dicts of tensors, with the JAX package's names and shapes (attention
projections keep the head as a tensor dim: ``[d, H, hd]`` in,
``[H, hd, d]`` out), so parameters cross between the packages array for
array (:mod:`repro_torch.convert`).  Every ``*_init`` draws from an explicit
``torch.Generator`` with the JAX package's scales and zero/one
initialisations.  The JAX package returns each parameter's logical sharding
axes beside it; the port keeps them apart, in ``transformer.param_axes``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "apply_norm",
    "causal_conv",
    "dense",
    "dense_init",
    "embed_init",
    "linspace_f32",
    "mlp_apply",
    "mlp_init",
    "norm_init",
    "proj_in",
    "proj_in_init",
    "proj_out",
    "proj_out_init",
    "rope",
]


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32) * scale


def linspace_f32(start: float, stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace``'s fp32 arithmetic: ``start * (1 - s) + stop * s`` with
    ``s = i / (num - 1)``, and ``stop`` itself last, so that constants built
    on it round as the JAX package's do."""
    if num < 2:
        return torch.full((num,), start, dtype=torch.float32, device=device)
    step = torch.arange(num - 1, dtype=torch.float32, device=device) / (num - 1)
    out = start * (1 - step) + stop * step
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32, device=device)])


def dense_init(gen, d_in: int, d_out: int, *, bias: bool = False, scale=None):
    scale = scale if scale is not None else d_in**-0.5
    p = {"w": _normal(gen, (d_in, d_out), scale)}
    if bias:
        p["b"] = torch.zeros((d_out,), device=gen.device)
    return p


def dense(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def proj_in_init(gen, d: int, heads: int, hd: int, *, bias: bool = False):
    """Attention in-projection with the head as a tensor dim: w ``[d, heads, hd]``."""
    p = {"w": _normal(gen, (d, heads, hd), d**-0.5)}
    if bias:
        p["b"] = torch.zeros((heads, hd), device=gen.device)
    return p


def proj_in(p, x: torch.Tensor) -> torch.Tensor:
    """``[..., d] @ [d, H, hd] -> [..., H, hd]``."""
    w = p["w"].to(x.dtype)
    y = (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def proj_out_init(gen, heads: int, hd: int, d: int):
    return {"w": _normal(gen, (heads, hd, d), (heads * hd) ** -0.5)}


def proj_out(p, x: torch.Tensor) -> torch.Tensor:
    """``[..., H, hd] @ [H, hd, d] -> [..., d]``."""
    w = p["w"].to(x.dtype)
    return x.flatten(-2) @ w.reshape(-1, w.shape[-1])


def norm_init(kind: str, d: int, device):
    """kind: rmsnorm | layernorm | nonparam_ln (OLMo: no learned params)."""
    if kind == "nonparam_ln":
        return {}
    p = {"scale": torch.ones((d,), device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), device=device)
    return p


def apply_norm(kind: str, p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Computed in fp32 and cast back to ``x.dtype``, as in the JAX package."""
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        return (y * p["scale"]).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * p["scale"] + p["bias"]
    return y.to(x.dtype)


def embed_init(gen, vocab: int, d: int):
    return {"table": _normal(gen, (vocab, d), 1.0)}


def mlp_init(gen, d: int, d_ff: int, act: str):
    """act: silu (SwiGLU), geglu (gated GELU), gelu (plain 2-matrix MLP)."""
    p = {"wi": _normal(gen, (d, d_ff), d**-0.5)}
    if act in ("silu", "geglu"):
        p["wg"] = _normal(gen, (d, d_ff), d**-0.5)
    p["wo"] = _normal(gen, (d_ff, d), d_ff**-0.5)
    return p


def mlp_apply(p, x: torch.Tensor, act: str) -> torch.Tensor:
    """``jax.nn.gelu`` defaults to the tanh approximation, so GELU here is ``approximate="tanh"``."""
    h = x @ p["wi"].to(x.dtype)
    if act == "silu":
        h = F.silu(h) * (x @ p["wg"].to(x.dtype))
    elif act == "geglu":
        h = F.gelu(h, approximate="tanh") * (x @ p["wg"].to(x.dtype))
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["wo"].to(x.dtype)


def causal_conv(w: torch.Tensor, x: torch.Tensor, tail: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv: ``w [W, D]`` over x ``[B, S, D]``; ``tail [B, W - 1, D]``
    holds the inputs before x (zeros when ``None``).

    Tap j reads the input j steps back; the taps are summed j = 0 .. W - 1 in
    order, in the type ``jnp`` would promote the tail and x to (the JAX
    package's RG-LRU and SSD blocks).
    """
    W, S = w.shape[0], x.shape[1]
    if tail is None:
        tail = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    ctx = torch.cat([tail, x], dim=1)
    out = w[0].to(x.dtype) * x
    for j in range(1, W):
        out = out + w[j].to(x.dtype) * ctx[:, W - 1 - j:W - 1 - j + S]
    return out


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding in fp32. x: ``[..., seq, heads, head_dim]``; positions: ``[..., seq]``."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs  # [..., seq, half]
    cos = torch.cos(ang)[..., None, :]  # [..., seq, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)
