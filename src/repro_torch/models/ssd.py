"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060).

Port of the JAX package's ``repro/models/ssd.py``.  The chunked SSD
algorithm is a block-banded (semiseparable) matrix product: intra-chunk
terms are dense ``Q x Q`` blocks on the diagonal band, inter-chunk terms
flow through a rank-N state.  Block layout: in_proj -> [z (gate), x, B, C,
dt]; causal depthwise conv (width 4) on (x, B, C), then SiLU; SSD; gated
RMSNorm; out_proj.  Decode carries the ``[B, H, P, N]`` state and the conv
tail: O(1) per token.

The JAX package writes the intra-chunk term as one four-operand einsum;
here it is three explicit products (``C B^T`` per chunk, times the decay
``L``, times x), so no ``[B, nc, Q, Q, H, P]`` intermediate is formed
whatever order ``torch.einsum`` would pick.  The scan over chunks is a
Python loop (``S / chunk`` steps).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.matrix import resolve_device
from .layers import _normal, apply_norm, causal_conv, linspace_f32

__all__ = ["ssd_block_apply", "ssd_block_init", "ssd_chunked", "ssd_decode_step", "ssd_init_state"]

_CONV_W = 4


def ssd_block_init(gen, d: int, *, d_inner: int, heads: int, d_state: int):
    dev = gen.device
    return {
        "in_proj": _normal(gen, (d, 2 * d_inner + 2 * d_state + heads), d**-0.5),
        "conv": _normal(gen, (_CONV_W, d_inner + 2 * d_state), 0.1),
        "a_log": torch.log(linspace_f32(1.0, 16.0, heads, dev)),
        "d_skip": torch.ones((heads,), device=dev),
        "dt_bias": torch.zeros((heads,), device=dev),
        "norm_scale": torch.ones((d_inner,), device=dev),
        "out_proj": _normal(gen, (d_inner, d), d_inner**-0.5),
    }


def _split_proj(p, x: torch.Tensor, d_inner: int, d_state: int, heads: int):
    """``(z, x, B, C, dt)`` of the input projection."""
    proj = x @ p["in_proj"].to(x.dtype)
    return torch.split(proj, [d_inner, d_inner, d_state, d_state, heads], dim=-1)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """``out[..., i, j] = sum_{j < k <= i} x[k]`` for ``j <= i``, ``-inf`` above the diagonal."""
    T = x.shape[-1]
    cs = torch.cumsum(x, -1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(xh, dt, a_log, Bm, Cm, *, chunk: int):
    """SSD over chunks.  xh ``[B, S, H, P]``; dt ``[B, S, H]``; Bm, Cm ``[B, S, N]``.

    Returns y ``[B, S, H, P]`` and the final state ``[B, H, P, N]`` (fp32).
    S must be a multiple of ``min(chunk, S)``.
    """
    Bsz, S, H, Pd = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk {Q}")
    nc = S // Q
    A = -torch.exp(a_log)  # [H], negative
    xt = (xh * dt[..., None]).reshape(Bsz, nc, Q, H, Pd)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)
    dA = (dt * A).reshape(Bsz, nc, Q, H).permute(0, 3, 1, 2)  # [B, H, nc, Q]
    dA_cs = torch.cumsum(dA, -1)

    # intra-chunk (the diagonal band): y[l] = sum_s (C_l . B_s) L[l, s] x_s
    L = torch.exp(_segsum(dA))  # [B, H, nc, Q, Q]
    cb = Cc @ Bc.transpose(-1, -2)  # [B, nc, l, s]
    xt_h = xt.permute(0, 3, 1, 2, 4)  # [B, H, nc, s, P]
    y_diag = ((cb[:, None] * L) @ xt_h).permute(0, 2, 3, 1, 4)  # [B, nc, l, H, P]

    # chunk states: each chunk's inputs decayed to the chunk's end
    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)  # [B, H, nc, Q]
    xd = xt_h * decay_states[..., None]  # [B, H, nc, l, P]
    states = xd.transpose(-1, -2) @ Bc[:, None]  # [B, H, nc, P, N]

    # inter-chunk recurrence: prev[c] is the state entering chunk c
    chunk_decay = torch.exp(dA_cs[..., -1])  # [B, H, nc]
    h = torch.zeros((Bsz, H, Pd, N), dtype=torch.float32, device=xh.device)
    prev = []
    for c in range(nc):
        prev.append(h)
        h = h * chunk_decay[:, :, c, None, None] + states[:, :, c].float()
    prev = torch.stack(prev, dim=2).to(Cc.dtype)  # [B, H, nc, P, N]

    # the state's contribution: y[l] = exp(dA_cs[l]) C_l . prev
    y_off = (Cc[:, None] @ prev.transpose(-1, -2)) * torch.exp(dA_cs)[..., None]  # [B, H, nc, l, P]
    y = y_diag + y_off.permute(0, 2, 3, 1, 4)
    return y.reshape(Bsz, S, H, Pd), h


def ssd_block_apply(p, x: torch.Tensor, *, d_inner: int, heads: int, d_state: int,
                    chunk: int = 128) -> torch.Tensor:
    B, S, _ = x.shape
    z, xs, Bm, Cm, dt = _split_proj(p, x, d_inner, d_state, heads)
    conv_out = F.silu(causal_conv(p["conv"], torch.cat([xs, Bm, Cm], dim=-1)))
    xs, Bm, Cm = torch.split(conv_out, [d_inner, d_state, d_state], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])  # [B, S, H]
    xh = xs.reshape(B, S, heads, d_inner // heads)
    y, _ = ssd_chunked(xh.float(), dt, p["a_log"], Bm.float(), Cm.float(), chunk=chunk)
    y = y + xh.float() * p["d_skip"][None, None, :, None]
    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = apply_norm("rmsnorm", {"scale": p["norm_scale"]}, y * F.silu(z))
    return y @ p["out_proj"].to(x.dtype)


def ssd_init_state(batch: int, *, d_inner: int, heads: int, d_state: int, dtype=torch.float32,
                   device="cuda"):
    """``h [B, H, P, N]`` fp32 and the conv tail ``[B, 3, d_inner + 2 N]`` in ``dtype``."""
    device = resolve_device(device)
    return {"h": torch.zeros((batch, heads, d_inner // heads, d_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, _CONV_W - 1, d_inner + 2 * d_state), dtype=dtype,
                                device=device)}


def ssd_decode_step(p, x: torch.Tensor, state, *, d_inner: int, heads: int, d_state: int):
    """One token: x ``[B, 1, D]`` -> ``(y [B, 1, D], new state)``."""
    B = x.shape[0]
    z, xs, Bm, Cm, dt = _split_proj(p, x, d_inner, d_state, heads)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_out = F.silu(causal_conv(p["conv"], conv_in, tail=state["conv"]))
    xs, Bm, Cm = torch.split(conv_out[:, 0], [d_inner, d_state, d_state], dim=-1)
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])  # [B, H]
    dec = torch.exp(dt * -torch.exp(p["a_log"]))  # [B, H]
    xh = xs.reshape(B, heads, d_inner // heads).float()
    upd = (dt[:, :, None] * xh)[..., None] * Bm.float()[:, None, None, :]  # [B, H, P, N]
    h = state["h"] * dec[..., None, None] + upd
    y = (h @ Cm.float()[:, None, :, None])[..., 0]  # [B, H, P]
    y = y + xh * p["d_skip"][None, :, None]
    y = y.reshape(B, 1, d_inner).to(x.dtype)
    y = apply_norm("rmsnorm", {"scale": p["norm_scale"]}, y * F.silu(z))
    return y @ p["out_proj"].to(x.dtype), {"h": h, "conv": torch.cat([state["conv"][:, 1:], conv_in], dim=1)}
