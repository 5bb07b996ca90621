"""Mixture-of-Experts FFN: top-k routing, capacity-bounded dispatch, expert GEMMs.

Port of the single-device branch of the JAX package's ``repro/models/moe.py``
(every expert local; the expert-parallel ``shard_map`` branches exist only
across cards and are not ported).  A dropless-ish MoE FFN is a block-sparse
matrix multiply whose structure is known only at run time: the expert GEMMs
are batched products (``gemm_impl="einsum"``) or one ``block_spmm`` task per
expert (``gemm_impl="block_spmm"``: the CUDA kernel on the card, its plain
version on the CPU).

Capacity: ``Ce = ceil(T * top_k * capacity_factor / E)`` slots per expert;
pairs past an expert's capacity (in token order) are dropped.  The combine
sums each token's surviving slots in ascending slot order with a gather, so
the output is the same bits from run to run on every device (no scatter-add).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from .layers import _normal

__all__ = ["moe_apply", "moe_init"]


def moe_init(gen, d: int, d_ff: int, num_experts: int, act: str):
    """``router [d, E]``, ``w1``/``wg [E, d, d_ff]`` (``wg`` only for a gated act), ``w2 [E, d_ff, d]``."""
    p = {
        "router": _normal(gen, (d, num_experts), d**-0.5),
        "w1": _normal(gen, (num_experts, d, d_ff), d**-0.5),
        "w2": _normal(gen, (num_experts, d_ff, d), d_ff**-0.5),
    }
    if act in ("silu", "geglu"):
        p["wg"] = _normal(gen, (num_experts, d, d_ff), d**-0.5)
    return p


def _grouped_mm(x: torch.Tensor, w: torch.Tensor, *, gemm_impl: str) -> torch.Tensor:
    """``[E, M, K] x [E, K, N] -> [E, M, N]``, batched or through the block GEMM."""
    if gemm_impl == "block_spmm":
        idx = np.arange(x.shape[0])
        return kops.block_spmm(x, w.to(x.dtype), idx, idx, idx, x.shape[0]).to(x.dtype)
    if gemm_impl != "einsum":
        raise ValueError(f"gemm_impl={gemm_impl!r}: 'einsum' or 'block_spmm'")
    return torch.bmm(x, w.to(x.dtype))


def _expert_ffn(xe, w1, wg, w2, act: str, gemm_impl: str) -> torch.Tensor:
    """xe ``[E, Ce, D]`` through every expert's FFN; GELU is the tanh form (``jax.nn.gelu``)."""
    h = _grouped_mm(xe, w1, gemm_impl=gemm_impl)
    if act == "silu":
        h = F.silu(h) * _grouped_mm(xe, wg, gemm_impl=gemm_impl)
    elif act == "geglu":
        h = F.gelu(h, approximate="tanh") * _grouped_mm(xe, wg, gemm_impl=gemm_impl)
    else:
        h = F.gelu(h, approximate="tanh")
    return _grouped_mm(h.to(xe.dtype), w2, gemm_impl=gemm_impl)


def route(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """``(gates [T, k], experts [T, k])`` of the tokens of x ``[..., D]``.

    The logits are the product in the activation type, then fp32; the
    softmax probabilities' top k are taken by a stable descending sort, so
    a tie goes to the lower expert index as ``jax.lax.top_k`` does; the gates
    are renormalised over the k.
    """
    xf = x.reshape(-1, x.shape[-1])
    probs = torch.softmax((xf @ router.to(xf.dtype)).float(), dim=-1)
    gates, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = gates[:, :top_k], eidx[:, :top_k]
    return gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9), eidx


def _moe_local(x, router, w1, wg, w2, *, top_k: int, capacity: int, act: str, gemm_impl: str):
    B, S, D = x.shape
    E = w1.shape[0]
    T = B * S
    dev = x.device
    xf = x.reshape(T, D)
    gates, eidx = route(xf, router, top_k)

    pe = eidx.reshape(-1)  # [T*k] expert of each pair
    pt = torch.arange(T, device=dev).repeat_interleave(top_k)
    pg = gates.reshape(-1)

    # rank of each pair within its expert, in arrival (token) order
    order = torch.argsort(pe, stable=True)
    sorted_e = pe[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.empty_like(pe)
    rank[order] = torch.arange(T * top_k, device=dev) - first

    valid = rank < capacity
    trash = E * capacity
    slot = torch.where(valid, pe * capacity + rank, trash)

    # dispatch: slot -> token (T: a zero row); dropped pairs all write the trash slot
    disp = torch.full((trash + 1,), T, dtype=torch.long, device=dev)
    disp[slot] = torch.where(valid, pt, T)
    comb_gate = torch.zeros((trash + 1,), dtype=torch.float32, device=dev)
    comb_gate[slot] = torch.where(valid, pg, 0.0)
    x_pad = torch.cat([xf, xf.new_zeros((1, D))])
    xe = x_pad[disp[:-1]].reshape(E, capacity, D)

    ye = _expert_ffn(xe, w1, wg, w2, act, gemm_impl)  # [E, Ce, D]
    ye = ye.reshape(trash, D) * comb_gate[:-1, None].to(ye.dtype)
    ye = torch.cat([ye, ye.new_zeros((1, D))])  # row `trash`: the zero row of a dropped pair

    # combine: each token's k slots (dropped ones -> the zero row), summed in ascending slot order
    slots = torch.sort(slot.reshape(T, top_k), dim=1).values
    out = ye[slots[:, 0]]
    for j in range(1, top_k):
        out = out + ye[slots[:, j]]
    return out.reshape(B, S, D).to(x.dtype)


def moe_apply(p, x: torch.Tensor, *, num_experts: int, top_k: int, act: str,
              capacity_factor: float = 1.25, gemm_impl: str = "einsum",
              dropless: bool = False) -> torch.Tensor:
    """x ``[B, S, D]`` -> ``[B, S, D]``, every expert on this device.

    ``dropless=True`` sets the capacity to the token count (every token's top
    k on one expert still fits): no pair is dropped.  Decode uses it, where
    a drop would skew generation; the forward keeps ``capacity_factor``.
    A non-gated ``act`` passes ``w1`` in ``wg``'s place (unused).
    """
    T = x.shape[0] * x.shape[1]
    cap = T if dropless else max(1, math.ceil(T * top_k * capacity_factor / num_experts))
    return _moe_local(x, p["router"], p["w1"], p.get("wg", p["w1"]), p["w2"],
                      top_k=top_k, capacity=cap, act=act, gemm_impl=gemm_impl)
