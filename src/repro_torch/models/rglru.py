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

On a mesh (``ctx`` and ``specs``, the model-axis entries of the rank's
parameter blocks, from ``transformer._blocks``) the block runs on the
rank's ``rnn`` channels: ``w_in_x`` / ``w_in_g`` column-parallel, the conv,
``lam`` and the scan per channel, ``w_out`` row-parallel with one sum over
the model axis.  The gates need whole heads: where the heads do not split
but the channels do (the divisibility fallback), the conv's output is
gathered over the model axis, the gates computed whole and the rank's
channels kept.  The decode state's blocks (``h`` and ``conv`` on ``rnn``)
are the rank's channels.  Under sequence parallelism (``seq``: the block's
input is the stream's gather, whole along the sequence, which the scan
needs) no value is ``pbroadcast`` (``rules.tp_in``) and ``w_out``'s sum is
a reduce-scatter to the rank's block of the sequence.  Without a mesh
every helper does nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.matrix import resolve_device
from ..sharding import rules
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


def _gates(p, u: torch.Tensor, heads: int, ctx=None, specs=None, seq=None):
    """``(r, i)`` on ``u``'s channels: the rank's, on a mesh.  ``heads``: the
    model's; the rank's share where the heads split."""
    rnn, split_heads = rules.spec_at(specs, "w_in_x", 1), rules.spec_at(specs, "w_r", 0)
    w_r, w_i = p["w_r"], p["w_i"]
    gather = rnn is not None and split_heads is None  # the rank holds part of a head
    D_l = u.shape[-1]
    if split_heads is not None:
        heads //= ctx.tp_size()
    if gather:
        u = rules.all_gather(ctx, u, rnn, dim=-1)
        w_r, w_i = (rules.tp_in(ctx, w, rnn, seq) for w in (w_r, w_i))
    B, S, D = u.shape
    uh = u.reshape(B, S, heads, D // heads)
    r = torch.sigmoid(torch.einsum("bshd,hde->bshe", uh, w_r.to(u.dtype))).reshape(B, S, D)
    i = torch.sigmoid(torch.einsum("bshd,hde->bshe", uh, w_i.to(u.dtype))).reshape(B, S, D)
    if gather:
        lo = rules.axis_index(ctx, ctx.tp_axis) * D_l
        r, i = r[..., lo:lo + D_l], i[..., lo:lo + D_l]
    return r, i


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


def _rglru_scan(p, u: torch.Tensor, heads: int, ctx=None, specs=None, seq=None):
    """u ``[B, S, D]`` -> ``(y in u's type, h_last fp32)``, from h = 0."""
    r, i = _gates(p, u, heads, ctx, specs, seq)
    a = torch.exp(-_C * F.softplus(p["lam"].float()) * r.float())
    gated = torch.sqrt(torch.clamp(1.0 - a.square(), min=1e-12)) * (i.float() * u.float())
    h = _scan(a, gated)
    return h.to(u.dtype), h[:, -1]


def _branches(p, x: torch.Tensor, ctx, specs, seq=None):
    """The two linear-in branches ``(u, gelu(g))`` on the rank's channels."""
    x = rules.tp_in(ctx, x, rules.spec_at(specs, "w_in_x", 1), seq)  # w_in_x, w_in_g split alike
    return x @ p["w_in_x"].to(x.dtype), F.gelu(x @ p["w_in_g"].to(x.dtype), approximate="tanh")


def rglru_block_apply(p, x: torch.Tensor, *, heads: int, ctx=None, specs=None,
                      seq=None) -> torch.Tensor:
    """The full block: ``[B, S, D] -> [B, S, D]``; under sequence parallelism
    (``seq``) the result is the rank's block of the sequence."""
    u, g = _branches(p, x, ctx, specs, seq)
    y, _ = _rglru_scan(p, causal_conv(p["conv"], u), heads, ctx, specs, seq)
    return rules.row_sum(ctx, (y * g) @ p["w_out"].to(x.dtype), rules.spec_at(specs, "w_out", 0),
                         seq)


def rglru_init_state(batch: int, d: int, dtype=torch.float32, device="cuda"):
    """``h [B, d]`` fp32 and the conv tail ``[B, 3, d]`` in ``dtype``."""
    device = resolve_device(device)
    return {"h": torch.zeros((batch, d), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, _CONV_W - 1, d), dtype=dtype, device=device)}


def rglru_decode_step(p, x: torch.Tensor, state, *, heads: int, ctx=None, specs=None):
    """One token: x ``[B, 1, D]`` -> ``(y [B, 1, D], new state)``.

    The new conv tail is the old one's last two rows and this step's input,
    concatenated with PyTorch's type promotion (as ``jnp.concatenate``).  On
    a mesh ``state`` holds the rank's blocks, which are its channels.
    """
    u, g = _branches(p, x, ctx, specs)
    tail = state["conv"]
    u_c = causal_conv(p["conv"], u, tail=tail)
    r, i = _gates(p, u_c, heads, ctx, specs)
    a = torch.exp(-_C * F.softplus(p["lam"].float()) * r[:, 0].float())
    h = a * state["h"] + torch.sqrt(torch.clamp(1 - a.square(), min=1e-12)) * (
        i[:, 0].float() * u_c[:, 0].float())
    y = rules.row_sum(ctx, (h.to(x.dtype)[:, None] * g) @ p["w_out"].to(x.dtype),
                      rules.spec_at(specs, "w_out", 0))
    return y, {"h": h, "conv": torch.cat([tail[:, 1:], u], dim=1)}
