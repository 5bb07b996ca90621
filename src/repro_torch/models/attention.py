"""Attention: GQA full/causal/prefix/local variants + KV-cache decode.

Port of the JAX package's ``repro/models/attention.py``.  Activations are
``[B, S, H, hd]``.  Three implementations:

* ``direct``  — materialised logits (small shapes, oracle).
* ``chunked`` — a loop over KV chunks with online softmax: memory stays
  O(S * chunk) whatever the sequence length.
* ``flash``   — the hand-written CUDA kernel on the card
  (:mod:`repro_torch.kernels.flash_attention`), its plain version on the CPU.

Local (sliding-window) attention uses banded chunking — q chunk i attends kv
chunks {i-1, i} with an exact in-window mask — so its cost is O(S * 2W).
The dispatch order of :func:`attention` is the JAX package's: a window with
``Sq == Sk`` takes the banded path before ``flash``; a prefix never takes
``flash``; small shapes take ``direct`` unless ``flash`` was asked for.
"""

from __future__ import annotations

import torch

from ..kernels import ops as kops
from ..kernels.flash_attention import attention_mask

__all__ = ["attention", "decode_attention"]

_NEG = -1e30
#: cache positions decode_attention converts to fp32 at a time: a chunk of a
#: long cache, never the whole of it
DECODE_CHUNK = 512


def _repeat_kv(k: torch.Tensor, heads: int) -> torch.Tensor:
    """Each kv head repeated for its ``heads // HK`` query heads (``jnp.repeat``'s order).

    An expanded view reshaped, not ``repeat_interleave``: that one gathers
    with ``index_select``, whose CUDA backward adds with atomics, so a
    gradient's bits would change from run to run.  This one's backward sums
    the group in one order.
    """
    B, S, hk, D = k.shape
    if hk == heads:
        return k
    return k[:, :, :, None].expand(B, S, hk, heads // hk, D).reshape(B, S, heads, D)


def _direct(q, k, v, qpos, kpos, *, causal, window, prefix_len, scale):
    k = _repeat_kv(k, q.shape[2])
    v = _repeat_kv(v, q.shape[2])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits * scale
    m = attention_mask(qpos, kpos, causal=causal, window=window, prefix_len=prefix_len)
    logits = torch.where(m[:, None] if m.ndim == 3 else m[None, None], logits, _NEG)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _chunked(q, k, v, qpos, kpos, *, causal, window, prefix_len, scale, chunk):
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    chunk = min(chunk, Sk)
    k = _repeat_kv(k, H)
    v = _repeat_kv(v, H)
    qf = q.float()
    m_run = torch.full((B, H, Sq), _NEG, device=q.device)
    l_run = torch.zeros((B, H, Sq), device=q.device)
    acc = torch.zeros((B, H, Sq, D), device=q.device)
    for lo in range(0, Sk, chunk):
        kb, vb, kp = k[:, lo:lo + chunk], v[:, lo:lo + chunk], kpos[lo:lo + chunk]
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float())
        logits = logits * scale
        msk = attention_mask(qpos, kp, causal=causal, window=window, prefix_len=prefix_len)
        logits = torch.where(msk[None, None], logits, _NEG)
        m_new = torch.maximum(m_run, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m_run - m_new)
        l_run = l_run * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb.float())
        m_run = m_new
    l_run = torch.where(l_run == 0.0, 1.0, l_run)
    out = (acc / l_run[..., None]).transpose(1, 2)
    return out.to(q.dtype)


def _local_banded(q, k, v, *, window, scale):
    """Causal sliding-window attention via banded chunking: O(S * 2W) work.

    A query at position p sees the keys in (p - W, p], which lie in its own
    chunk of W and the one before.  Only the causal mask bounds the band:
    the window alone (``kpos > qpos - window``) lets a non-causal query see
    every later key, so non-causal windows take the general paths.  The
    zeros padded after a ragged last chunk sit at positions >= S, past every
    real query, and the causal mask drops them.
    """
    B, S, H, D = q.shape
    W = window
    pad = (-S) % W
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    Sp = S + pad
    n = Sp // W
    k = _repeat_kv(k, H)
    v = _repeat_kv(v, H)
    qb = q.reshape(B, n, W, H, D)
    # kv context for chunk i = chunks [i-1, i] -> width 2W
    kb = k.reshape(B, n, W, H, D)
    vb = v.reshape(B, n, W, H, D)
    k_prev = torch.nn.functional.pad(kb, (0, 0, 0, 0, 0, 0, 1, 0))[:, :-1]
    v_prev = torch.nn.functional.pad(vb, (0, 0, 0, 0, 0, 0, 1, 0))[:, :-1]
    kctx = torch.cat([k_prev, kb], dim=2)  # [B, n, 2W, H, D]
    vctx = torch.cat([v_prev, vb], dim=2)
    logits = torch.einsum("bnqhd,bnkhd->bnhqk", qb.float(), kctx.float())
    logits = logits * scale
    dev = q.device
    qpos = torch.arange(n * W, device=dev).reshape(n, W)
    # positions of the 2W context for chunk i: (i-1)*W ... (i+1)*W - 1
    ctx = (torch.arange(n, device=dev)[:, None] - 1) * W + torch.arange(2 * W, device=dev)[None, :]
    m = attention_mask(qpos, ctx, causal=True, window=W) & (ctx[:, None, :] >= 0)
    logits = torch.where(m[None, :, None], logits, _NEG)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnhqk,bnkhd->bnqhd", p, vctx.float())
    out = out.reshape(B, Sp, H, D)[:, :S]
    return out.to(q.dtype)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    prefix_len: int | None = None,
    impl: str = "chunked",
    chunk: int = 512,
) -> torch.Tensor:
    """q: ``[B, Sq, H, hd]``; k, v: ``[B, Sk, HK, hd]`` (HK divides H)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = D**-0.5
    qpos = torch.arange(Sq, device=q.device) + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)
    if window is not None and causal and prefix_len is None and Sq == Sk and impl != "direct":
        return _local_banded(q, k, v, window=window, scale=scale)
    if impl == "flash" and prefix_len is None:
        # [B, S, H, D] seen as [B, H, S, D]: strided views, no copy on the card
        out = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                   causal=causal, window=window)
        return out.transpose(1, 2)
    if impl == "direct" or Sq * Sk <= 256 * 256:
        return _direct(q, k, v, qpos, kpos, causal=causal, window=window,
                       prefix_len=prefix_len, scale=scale)
    return _chunked(q, k, v, qpos, kpos, causal=causal, window=window,
                    prefix_len=prefix_len, scale=scale, chunk=chunk)


def decode_attention(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    pos: int,
    *,
    window: int | None = None,
    kpos: torch.Tensor | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """One-token attention against a KV cache.

    q: ``[B, 1, H, hd]``; cache_k/v: ``[B, S, HK, hd]``; pos: current index.
    kpos optionally gives the true position held by each cache slot (ring
    buffers); negative kpos = never written.  Positions > pos are masked;
    with window, positions <= pos - window too.

    int8 caches: pass per-(b, s, h) absmax scales; they are applied to the
    logits and the probabilities, never to the cache.  As in the JAX
    package, q is cast to the cache's compute type (bf16 for int8) and the
    probabilities are rounded to it before the PV product; both products
    accumulate in fp32.  The cache is read in chunks of
    :data:`DECODE_CHUNK` positions, and only the chunk being multiplied is
    converted to fp32, so no fp32 copy of a bf16 or int8 cache is built.
    """
    B, _, H, D = q.shape
    S, HK = cache_k.shape[1], cache_k.shape[2]
    G = H // HK
    # GQA without repeating K/V: group the q heads by kv head
    qg = q.reshape(B, HK, G, D)
    compute = torch.bfloat16 if cache_k.dtype == torch.int8 else cache_k.dtype
    qf = qg.to(compute).float()
    logits = torch.empty((B, HK, G, S), dtype=torch.float32, device=q.device)
    for s0 in range(0, S, DECODE_CHUNK):
        kc = cache_k[:, s0:s0 + DECODE_CHUNK].to(compute).float()
        logits[..., s0:s0 + DECODE_CHUNK] = torch.einsum("bhgd,bshd->bhgs", qf, kc)
    if k_scale is not None:  # [B, S, HK] -> scale logits rows
        logits = logits * k_scale.transpose(1, 2)[:, :, None, :] / 127.0
    logits = logits * D**-0.5
    kpos = torch.arange(S, device=q.device) if kpos is None else kpos
    m = (kpos >= 0) & (kpos <= pos)
    if window is not None:
        m &= kpos > pos - window
    logits = torch.where(m[None, None, None, :], logits, _NEG)
    p = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        p = p * v_scale.transpose(1, 2)[:, :, None, :] / 127.0
    vcompute = torch.bfloat16 if cache_v.dtype == torch.int8 else cache_v.dtype
    pf = p.to(vcompute).float()
    out = torch.zeros((B, HK, G, D), dtype=torch.float32, device=q.device)
    for s0 in range(0, S, DECODE_CHUNK):
        vc = cache_v[:, s0:s0 + DECODE_CHUNK].to(vcompute).float()
        out += torch.einsum("bhgs,bshd->bhgd", pf[..., s0:s0 + DECODE_CHUNK], vc)
    return out.reshape(B, 1, H, D).to(q.dtype)
