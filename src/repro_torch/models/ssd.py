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

On a mesh (``ctx`` and ``specs``, the model-axis entries of the rank's
parameter blocks, from ``transformer._blocks``) the block runs on the
rank's heads.  ``in_proj``'s columns are ``[z | x | B | C | dt]``, which a
contiguous split over the model axis cuts across, so every rank makes the
whole projection: one ``all_gather`` of whichever is smaller, the rank's
output columns or the weight's column block, decided from shapes on the
host.  The conv runs on all ``x | B | C`` channels with the replicated
conv weight; the SSD on the rank's heads (``B`` and ``C`` whole); the gated
RMSNorm over the whole ``d_inner`` sums the squares of the rank's block
over the model axis; ``out_proj`` is row-parallel with one sum.  Where the
heads do not split but ``d_inner`` does (the divisibility fallback), all
heads are computed and the rank's ``d_inner`` block kept.  In decode the
conv tail's cache block is a contiguous cut of the ``x | B | C`` channels,
not the rank's heads: the tail is gathered whole in the projection's own
``all_gather``, and the rank's cut of the new tail, taken from the whole
projection it holds, is written back.  Under sequence parallelism
(``seq``: the block's input is the stream's gather, whole along the
sequence, which the scan needs) no value is ``pbroadcast``
(``rules.tp_in``) but the norm's sum of squares, which sums channels, not
positions; ``out_proj``'s sum is a reduce-scatter to the rank's block of
the sequence.  Without a mesh every helper does nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.matrix import resolve_device
from ..sharding import rules
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


def _gather_last(ctx, blocks):
    """``blocks`` (each ``[B, ..., c]``, cut over the model axis along its last
    dim) whole, in one ``all_gather``; each keeps its type."""
    B, n = blocks[0].shape[0], ctx.tp_size()
    flat = torch.cat([b.reshape(B, -1) for b in blocks], dim=1)
    whole = rules.all_gather(ctx, flat, ctx.tp_axis, dim=1).reshape(B, n, -1)
    out, lo = [], 0
    for b in blocks:
        k = b[0].numel()
        w = whole[:, :, lo:lo + k].reshape(B, n, *b.shape[1:]).movedim(1, -2)
        out.append(w.reshape(*b.shape[:-1], n * b.shape[-1]).to(b.dtype))
        lo += k
    return out


def _proj_and_tail(p, x: torch.Tensor, ctx, specs, tail=None, tail_split=None, seq=None):
    """The whole input projection ``[B, S, 2 d_inner + 2 N + H]`` on every rank,
    and the whole conv tail (``tail`` as it is unless ``tail_split``, the mesh
    axes of its channels, cuts it).

    A column block of ``in_proj`` is made whole by gathering the rank's output
    columns where they have fewer rows than the weight (decode), else the
    weight's block (a long prefill); a cut tail joins the outputs' gather.
    """
    w = p["in_proj"]
    cols, inner = rules.spec_at(specs, "in_proj", 1), rules.spec_at(specs, "norm_scale", 0)
    if cols is not None and inner is None:
        raise NotImplementedError("in_proj splits over the model axis but d_inner does not")
    proj, cut = None, {}
    if cols is None:
        proj = rules.tp_in(ctx, x @ w.to(x.dtype), inner, seq)
    elif x.shape[0] * x.shape[1] <= w.shape[0]:
        cut["proj"] = rules.tp_in(ctx, x, cols, seq) @ w.to(x.dtype)
    else:
        proj = rules.tp_in(ctx, x, cols, seq) @ rules.all_gather(ctx, w, cols, dim=1).to(x.dtype)
    if tail_split is not None:
        cut["tail"] = tail
    whole = dict(zip(cut, _gather_last(ctx, list(cut.values())))) if cut else {}
    return whole.get("proj", proj), whole.get("tail", tail)


def _rank_heads(ctx, specs, heads: int) -> tuple[int, int]:
    """``(first, count)`` of the heads this rank computes: all where they do not split."""
    if rules.spec_at(specs, "a_log", 0) is None:
        return 0, heads
    n = heads // ctx.tp_size()
    return rules.axis_index(ctx, ctx.tp_axis) * n, n


def _head_params(p, ctx, specs, seq=None):
    """``a_log``, ``d_skip``, ``dt_bias`` as the rank's heads read them: a whole
    one enters the rank's ``d_inner`` block through ``tp_in`` (the fallback)."""
    inner = rules.spec_at(specs, "norm_scale", 0)
    return tuple(rules.tp_in(ctx, p[k], inner if rules.spec_at(specs, k, 0) is None else None,
                             seq)
                 for k in ("a_log", "d_skip", "dt_bias"))


def _out(p, y: torch.Tensor, z: torch.Tensor, ctx, specs, d_inner: int,
         seq=None) -> torch.Tensor:
    """The gated RMSNorm over the whole ``d_inner`` and ``out_proj``; ``y`` holds the
    rank's heads (or all of them), ``z`` is whole."""
    inner = rules.spec_at(specs, "norm_scale", 0)
    D_l = p["norm_scale"].shape[0]
    lo = 0 if inner is None else rules.axis_index(ctx, ctx.tp_axis) * D_l
    v = y[..., lo:lo + D_l] if y.shape[-1] != D_l else y  # all heads: the rank's block
    v = v * F.silu(z[..., lo:lo + D_l])
    if inner is None:
        v = apply_norm("rmsnorm", {"scale": p["norm_scale"]}, v)
    else:  # the mean square over d_inner: the ranks' sums of squares, summed
        vf = v.float()
        ss = rules.tp_in(ctx, rules.psum(ctx, vf.square().sum(-1, keepdim=True), inner), inner)
        v = (vf * torch.rsqrt(ss / d_inner + 1e-6) * p["norm_scale"]).to(v.dtype)
    return rules.row_sum(ctx, v @ p["out_proj"].to(v.dtype), rules.spec_at(specs, "out_proj", 0),
                         seq)


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
                    chunk: int = 128, ctx=None, specs=None, seq=None) -> torch.Tensor:
    """The full block: ``[B, S, D] -> [B, S, D]``; under sequence parallelism
    (``seq``) the result is the rank's block of the sequence."""
    B, S, _ = x.shape
    P = d_inner // heads
    proj, _ = _proj_and_tail(p, x, ctx, specs, seq=seq)
    z, xs, Bm, Cm, dt = torch.split(proj, [d_inner, d_inner, d_state, d_state, heads], dim=-1)
    conv = rules.tp_in(ctx, p["conv"], rules.spec_at(specs, "norm_scale", 0), seq)
    conv_out = F.silu(causal_conv(conv, torch.cat([xs, Bm, Cm], dim=-1)))
    xs, Bm, Cm = torch.split(conv_out, [d_inner, d_state, d_state], dim=-1)
    lo, n = _rank_heads(ctx, specs, heads)
    a_log, d_skip, dt_bias = _head_params(p, ctx, specs, seq)
    dt = F.softplus(dt[..., lo:lo + n].float() + dt_bias)  # [B, S, n]
    xh = xs[..., lo * P:(lo + n) * P].reshape(B, S, n, P)
    y, _ = ssd_chunked(xh.float(), dt, a_log, Bm.float(), Cm.float(), chunk=chunk)
    y = y + xh.float() * d_skip[None, None, :, None]
    return _out(p, y.reshape(B, S, n * P).to(x.dtype), z, ctx, specs, d_inner, seq)


def ssd_init_state(batch: int, *, d_inner: int, heads: int, d_state: int, dtype=torch.float32,
                   device="cuda"):
    """``h [B, H, P, N]`` fp32 and the conv tail ``[B, 3, d_inner + 2 N]`` in ``dtype``."""
    device = resolve_device(device)
    return {"h": torch.zeros((batch, heads, d_inner // heads, d_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, _CONV_W - 1, d_inner + 2 * d_state), dtype=dtype,
                                device=device)}


def ssd_decode_step(p, x: torch.Tensor, state, *, d_inner: int, heads: int, d_state: int,
                    ctx=None, specs=None, tail_split=None):
    """One token: x ``[B, 1, D]`` -> ``(y [B, 1, D], new state)``.

    On a mesh ``state`` holds the rank's blocks: ``h`` its heads', ``conv`` the
    channels ``tail_split`` (the mesh axes of the tail's last dim) cuts.
    """
    B = x.shape[0]
    P = d_inner // heads
    proj, tail = _proj_and_tail(p, x, ctx, specs, state["conv"], tail_split)
    z, xs, Bm, Cm, dt = torch.split(proj, [d_inner, d_inner, d_state, d_state, heads], dim=-1)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv = rules.tp_in(ctx, p["conv"], rules.spec_at(specs, "norm_scale", 0))
    conv_out = F.silu(causal_conv(conv, conv_in, tail=tail))
    xs, Bm, Cm = torch.split(conv_out[:, 0], [d_inner, d_state, d_state], dim=-1)
    lo, n = _rank_heads(ctx, specs, heads)
    a_log, d_skip, dt_bias = _head_params(p, ctx, specs)
    dt = F.softplus(dt[:, 0, lo:lo + n].float() + dt_bias)  # [B, n]
    dec = torch.exp(dt * -torch.exp(a_log))  # [B, n]
    xh = xs[:, lo * P:(lo + n) * P].reshape(B, n, P).float()
    upd = (dt[:, :, None] * xh)[..., None] * Bm.float()[:, None, None, :]  # [B, n, P, N]
    h = state["h"] * dec[..., None, None] + upd
    y = (h @ Cm.float()[:, None, :, None])[..., 0]  # [B, n, P]
    y = y + xh * d_skip[None, :, None]
    new_tail = torch.cat([tail[:, 1:], conv_in], dim=1)
    if tail_split is not None:  # the rank's cut of the channels, in the cache's layout
        C_l = state["conv"].shape[-1]
        c0 = rules.axis_index(ctx, ctx.tp_axis) * C_l
        new_tail = new_tail[..., c0:c0 + C_l].contiguous()
    return (_out(p, y.reshape(B, 1, n * P).to(x.dtype), z, ctx, specs, d_inner),
            {"h": h, "conv": new_tail})
