"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Port of the JAX package's ``repro/models/rglru.py``.  Recurrence::

  r_t = sigmoid(W_r u_t);  i_t = sigmoid(W_i u_t)
  a_t = exp(-c * softplus(Lambda) * r_t)        (c = 8)
  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t u_t)

The forward runs the recurrence as a log-depth parallel scan over time in
fp32 (``ceil(log2 S)`` doubling steps of plain tensor ops, the counterpart
of ``jax.lax.associative_scan``); decode keeps ``h`` as O(1) state.  Gate
weights are block-diagonal per head.  The block: linear-in (two branches) ->
causal depthwise conv (width 4) -> RG-LRU -> gated merge -> linear-out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.matrix import resolve_device
from .layers import _normal, causal_conv, linspace_f32

__all__ = ["rglru_block_apply", "rglru_block_init", "rglru_decode_step", "rglru_init_state"]

_C = 8.0
_CONV_W = 4


def rglru_block_init(gen, d: int, heads: int):
    dh = d // heads
    dev = gen.device
    p = {
        "w_in_x": _normal(gen, (d, d), d**-0.5),
        "w_in_g": _normal(gen, (d, d), d**-0.5),
        "conv": _normal(gen, (_CONV_W, d), 0.1),
        "w_r": _normal(gen, (heads, dh, dh), dh**-0.5),
        "w_i": _normal(gen, (heads, dh, dh), dh**-0.5),
        # Lambda parametrised so that a ~ U(0.9, 0.999) at r = 1 (fp32, as the JAX package)
        "lam": torch.log(torch.expm1(-torch.log(linspace_f32(0.9, 0.999, d, dev)) / _C)),
        "w_out": _normal(gen, (d, d), d**-0.5),
    }
    return p


def _gates(p, u: torch.Tensor, heads: int):
    B, S, D = u.shape
    uh = u.reshape(B, S, heads, D // heads)
    r = torch.sigmoid(torch.einsum("bshd,hde->bshe", uh, p["w_r"].to(u.dtype)))
    i = torch.sigmoid(torch.einsum("bshd,hde->bshe", uh, p["w_i"].to(u.dtype)))
    return r.reshape(B, S, D), i.reshape(B, S, D)


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` (h_{-1} = 0) along dim 1, by recursive doubling.

    Step ``d`` combines each element with the prefix ending ``d`` earlier,
    ``(a', b') = (a_{t-d} a_t, a_t b_{t-d} + b_t)``: ``ceil(log2 S)`` steps.
    """
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def _rglru_scan(p, u: torch.Tensor, heads: int):
    """u ``[B, S, D]`` -> ``(y in u's type, h_last fp32)``, from h = 0."""
    r, i = _gates(p, u, heads)
    a = torch.exp(-_C * F.softplus(p["lam"].float()) * r.float())
    gated = torch.sqrt(torch.clamp(1.0 - a.square(), min=1e-12)) * (i.float() * u.float())
    h = _scan(a, gated)
    return h.to(u.dtype), h[:, -1]


def rglru_block_apply(p, x: torch.Tensor, *, heads: int) -> torch.Tensor:
    """The full block: ``[B, S, D] -> [B, S, D]``."""
    u = x @ p["w_in_x"].to(x.dtype)
    g = F.gelu(x @ p["w_in_g"].to(x.dtype), approximate="tanh")
    y, _ = _rglru_scan(p, causal_conv(p["conv"], u), heads)
    return (y * g) @ p["w_out"].to(x.dtype)


def rglru_init_state(batch: int, d: int, dtype=torch.float32, device="cuda"):
    """``h [B, d]`` fp32 and the conv tail ``[B, 3, d]`` in ``dtype``."""
    device = resolve_device(device)
    return {"h": torch.zeros((batch, d), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, _CONV_W - 1, d), dtype=dtype, device=device)}


def rglru_decode_step(p, x: torch.Tensor, state, *, heads: int):
    """One token: x ``[B, 1, D]`` -> ``(y [B, 1, D], new state)``.

    The new conv tail is the old one's last two rows and this step's input,
    concatenated with PyTorch's type promotion (as ``jnp.concatenate``).
    """
    u = x @ p["w_in_x"].to(x.dtype)
    g = F.gelu(x @ p["w_in_g"].to(x.dtype), approximate="tanh")
    tail = state["conv"]
    u_c = causal_conv(p["conv"], u, tail=tail)
    r, i = _gates(p, u_c, heads)
    a = torch.exp(-_C * F.softplus(p["lam"].float()) * r[:, 0].float())
    h = a * state["h"] + torch.sqrt(torch.clamp(1 - a.square(), min=1e-12)) * (
        i[:, 0].float() * u_c[:, 0].float())
    y = (h.to(x.dtype)[:, None] * g) @ p["w_out"].to(x.dtype)
    return y, {"h": h, "conv": torch.cat([tail[:, 1:], u], dim=1)}
