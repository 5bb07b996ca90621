"""Mixture-of-Experts FFN: top-k routing, capacity-bounded dispatch, expert GEMMs.

Port of the JAX package's ``repro/models/moe.py``.  A dropless-ish MoE FFN
is a block-sparse matrix multiply whose structure is known only at run time:
the expert GEMMs are batched products (``gemm_impl="einsum"``) or one
``block_spmm`` task per expert (``gemm_impl="block_spmm"``: the CUDA kernel
on the card, its plain version on the CPU).

On a mesh (``ctx`` a :class:`~repro_torch.sharding.rules.MeshCtx` on a
``DeviceMesh``) the layer runs the reference's two ``shard_map`` bodies on
each rank's local blocks, with the port's named-axis collectives:

* expert parallelism: activations are data-parallel over ``(pod, data)``
  and replicated along ``model``; each model rank serves experts
  ``[e_base, e_base + E_l)`` of its local tokens (capacity from the local
  token count) and the partial outputs are summed over ``model``.  The
  expert weights are first gathered whole on their d_model dim, as the
  reference's ``in_specs`` ``P(tp, None, None)`` asks (prefill keeps them
  FSDP-sharded there, ``embed_e -> data``);
* token dispatch (decode, ``token_dispatch=True``): the decode batch is
  gathered over the data axes, every rank serves its experts' d_ff slice
  (``moe_ff -> data``), one sum over the whole mesh recombines, and each
  rank keeps its own rows.

The router is replicated and every rank routes over all E logits, so the
top-k ties fall as in one process.

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
from ..sharding import rules
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


def _moe_local(x, router, w1, wg, w2, *, e_base: int, num_experts: int, top_k: int,
               capacity: int, act: str, gemm_impl: str):
    """The MoE over local tokens and local experts ``[e_base, e_base + E_l)``.

    x ``[B_l, S, D]``, router ``[D, E]`` (all experts), w1 ``[E_l, D, F_l]``.
    Returns the partial output of the local experts (to be summed over the
    ranks that hold the others)."""
    B, S, D = x.shape
    E_l = w1.shape[0]
    T = B * S
    dev = x.device
    if router.shape[-1] != num_experts:
        raise ValueError(f"router of {router.shape[-1]} experts, num_experts={num_experts}")
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

    mine = (pe >= e_base) & (pe < e_base + E_l)
    valid = mine & (rank < capacity)
    trash = E_l * capacity
    slot = torch.where(valid, (pe - e_base) * capacity + rank, trash)

    # dispatch: slot -> token (T: a zero row); dropped pairs all write the trash slot
    disp = torch.full((trash + 1,), T, dtype=torch.long, device=dev)
    disp[slot] = torch.where(valid, pt, T)
    comb_gate = torch.zeros((trash + 1,), dtype=torch.float32, device=dev)
    comb_gate[slot] = torch.where(valid, pg, 0.0)
    x_pad = torch.cat([xf, xf.new_zeros((1, D))])
    xe = x_pad[disp[:-1]].reshape(E_l, capacity, D)

    ye = _expert_ffn(xe, w1, wg, w2, act, gemm_impl)  # [E_l, Ce, D]
    ye = ye.reshape(trash, D) * comb_gate[:-1, None].to(ye.dtype)
    ye = torch.cat([ye, ye.new_zeros((1, D))])  # row `trash`: the zero row of a dropped pair

    # combine: each token's k slots (dropped ones -> the zero row), summed in ascending slot order
    slots = torch.sort(slot.reshape(T, top_k), dim=1).values
    out = ye[slots[:, 0]]
    for j in range(1, top_k):
        out = out + ye[slots[:, j]]
    return out.reshape(B, S, D).to(x.dtype)


def moe_apply(p, x, *, num_experts: int, top_k: int, act: str, capacity_factor: float = 1.25,
              gemm_impl: str = "einsum", dropless: bool = False, ctx=None,
              token_dispatch: bool = False):
    """x ``[B, S, D]`` -> ``[B, S, D]``.

    ``dropless=True`` sets the capacity to the token count (every token's top
    k on one expert still fits): no pair is dropped.  Decode uses it, where
    a drop would skew generation; the forward keeps ``capacity_factor``.
    A non-gated ``act`` passes ``w1`` in ``wg``'s place (unused).

    Without a mesh (``ctx`` ``None`` or a dry-run ``MeshCtx``) every expert
    is local.  On a mesh, ``x`` and the leaves of ``p`` are ``DTensor`` objects
    (or whole tensors every rank holds) and the result is a ``DTensor``
    batch-sharded over the data axes: the expert-parallel body when the
    model axis divides ``num_experts``, the token-dispatch body when
    ``token_dispatch`` is asked and the data axes divide the batch and d_ff
    (the reference's conditions), else every expert on every rank over the
    whole batch.
    """

    def cap(tokens: int) -> int:
        if dropless:
            return tokens
        return max(1, math.ceil(tokens * top_k * capacity_factor / num_experts))

    if ctx is None or ctx.mesh is None:
        return _moe_local(x, p["router"], p["w1"], p.get("wg", p["w1"]), p["w2"], e_base=0,
                          num_experts=num_experts, top_k=top_k,
                          capacity=cap(x.shape[0] * x.shape[1]), act=act, gemm_impl=gemm_impl)

    local = rules.local_block
    dp = ctx.dp_axes
    dpe = rules.spec_entry(dp)
    dp_size = math.prod(ctx.axis_sizes[a] for a in dp)
    B, S, _ = x.shape
    out_spec = (dpe if B % dp_size == 0 else None, None, None)
    wg = p.get("wg")

    if ctx.tp_axis is None or num_experts % ctx.tp_size() != 0:
        # no EP: every expert on every rank, over the whole batch (the reference's
        # single-device branch under SPMD), then this rank's rows
        xs = rules.full_value(ctx, x)
        w = {k: rules.full_value(ctx, p[k]) for k in p}
        out = _moe_local(xs, w["router"], w["w1"], w.get("wg", w["w1"]), w["w2"], e_base=0,
                         num_experts=num_experts, top_k=top_k, capacity=cap(B * S), act=act,
                         gemm_impl=gemm_impl)
        return rules.as_dtensor(ctx, rules.relayout(ctx, out, (None,) * 3, out_spec), out_spec,
                                 x.shape)
    if B % dp_size:  # the reference's shard_map needs the batch to split
        raise ValueError(f"batch {B} does not split over {dp} ({dp_size} ranks)")

    tp = ctx.tp_axis
    E_l = num_experts // ctx.tp_size()
    e_base = rules.axis_index(ctx, tp) * E_l
    x_l = local(ctx, x, out_spec)
    router = local(ctx, p["router"], (None, None))

    if token_dispatch and dp and p["w1"].shape[-1] % dp_size == 0:
        # decode dispatch: move tokens (KB), not weights (GB).  Expert weights
        # stay resident, d_ff-sharded over the data axes; the decode batch is
        # gathered so every rank serves its experts' d_ff slice, then one sum
        # over the whole mesh recombines and each rank keeps its rows
        w1 = local(ctx, p["w1"], (tp, None, dpe))
        wg_l = w1 if wg is None else local(ctx, wg, (tp, None, dpe))
        w2 = local(ctx, p["w2"], (tp, dpe, None))
        xg = rules.all_gather(ctx, x_l, dp, dim=0)  # [B, S, D]
        out = _moe_local(xg, router, w1, wg_l, w2, e_base=e_base, num_experts=num_experts,
                         top_k=top_k, capacity=B * S,  # dropless at decode scale
                         act=act, gemm_impl=gemm_impl)
        out = rules.psum(ctx, out, (tp, *dp))
        out = rules.relayout(ctx, out, (None, None, None), out_spec)  # this rank's rows
        return rules.as_dtensor(ctx, out.contiguous(), out_spec, x.shape)

    # expert parallelism: local tokens, local experts, a sum over the model axis
    w1 = local(ctx, p["w1"], (tp, None, None))
    wg_l = w1 if wg is None else local(ctx, wg, (tp, None, None))
    w2 = local(ctx, p["w2"], (tp, None, None))
    out = _moe_local(x_l, router, w1, wg_l, w2, e_base=e_base, num_experts=num_experts,
                     top_k=top_k, capacity=cap((B // dp_size) * S), act=act, gemm_impl=gemm_impl)
    return rules.as_dtensor(ctx, rules.psum(ctx, out, tp), out_spec, x.shape)
