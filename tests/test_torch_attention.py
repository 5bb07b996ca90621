"""The port's attention against the JAX package's, on the same numpy inputs.

``flash_attention`` (plain version on the CPU) is held against the Pallas
kernel run in interpret mode, as ``tests/test_kernels.py`` runs it; the
model-level ``attention`` and ``decode_attention`` against their JAX
counterparts.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention_call  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402


def _arrays(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _to_torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _bf16_jax(a):
    return jnp.asarray(a, jnp.bfloat16)


# (B, H, HK, Sq, Sk, D, causal, window)
FLASH_CASES = {
    "causal_rep1": (2, 4, 4, 128, 128, 32, True, None),
    "noncausal_rep1": (2, 4, 4, 128, 128, 32, False, None),
    "causal_rep2": (1, 4, 2, 128, 128, 16, True, None),
    "noncausal_rep2": (1, 4, 2, 128, 128, 16, False, None),
    "causal_rep4": (2, 8, 2, 128, 128, 32, True, None),
    "noncausal_rep4": (1, 8, 2, 64, 64, 16, False, None),
    "window": (1, 2, 1, 256, 256, 16, True, 48),
    "window_noncausal": (1, 2, 2, 128, 128, 16, False, 40),
    "suffix": (1, 4, 2, 64, 256, 16, True, None),
    "window_suffix": (1, 4, 1, 64, 256, 16, True, 100),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_matches_pallas_kernel(case):
    """fp32: rtol = atol = 2e-4, the limit tests/test_kernels.py holds the Pallas kernel to."""
    B, H, HK, Sq, Sk, D, causal, window = FLASH_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q, k, v = _arrays(rng, (B, H, Sq, D), (B, HK, Sk, D), (B, HK, Sk, D))
    want = np.asarray(flash_attention_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           causal=causal, window=window, bq=64, bkv=64,
                                           interpret=True))
    tq, tk, tv = _to_torch(q, k, v)
    ref = fa.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    fa.launches = 0
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert fa.launches == 0  # a CPU tensor takes the plain version
    assert torch.equal(got, ref)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def _bf16_limit(want32, v):
    """A bf16 output against the fp32 result on the same bf16 inputs,
    elementwise: the fp32 sums' order (1e-4 * max|v|) plus one rounding to
    bf16, half an ulp <= 2^-8 * |want|."""
    return 2.0**-8 * np.abs(want32) + 1e-4 * float(np.abs(v).max())


@pytest.mark.parametrize("case", ["causal_rep2", "window_suffix"])
def test_flash_bf16_matches_pallas_kernel(case):
    """bf16 in and out, fp32 inside: the port and the Pallas kernel each lie
    within one bf16 rounding of the fp32 result on the same inputs."""
    B, H, HK, Sq, Sk, D, causal, window = FLASH_CASES[case]
    rng = np.random.default_rng(7)
    q, k, v = _arrays(rng, (B, H, Sq, D), (B, HK, Sk, D), (B, HK, Sk, D))
    want = flash_attention_call(_bf16_jax(q), _bf16_jax(k), _bf16_jax(v), causal=causal,
                                window=window, bq=64, bkv=64, interpret=True)
    assert want.dtype == jnp.bfloat16
    tq, tk, tv = _to_torch(q, k, v, dtype=torch.bfloat16)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    want32 = fa.flash_attention_ref(tq.float(), tk.float(), tv.float(), causal=causal,
                                    window=window).numpy()
    limit = _bf16_limit(want32, tv.float().numpy())
    assert (np.abs(got.float().numpy() - want32) <= limit).all()
    assert (np.abs(np.asarray(want, np.float32) - want32) <= limit).all()


def _split_p_attention(q, k, v, *, causal, window, split):
    """The bf16 CUDA kernel's arithmetic in plain torch, on bf16 q, k, v:
    fp32 scores (products of bf16 values are exact), fp32 softmax with the
    kernel's sentinel and zero rows, then P V with P split into
    ``p_hi = bf16(p)`` and ``p_lo = bf16(p - p_hi)`` (``split``) or rounded
    once to bf16, each product of bf16 values summed in fp32."""
    B, H, Sq, D = q.shape
    HK, Sk = k.shape[1], k.shape[2]
    rep = H // HK
    s = torch.matmul(q.float().reshape(B, HK, rep * Sq, D), k.float().transpose(-1, -2))
    s = s.view(B, HK, rep, Sq, Sk) * D**-0.5
    mask = fa.attention_mask(torch.arange(Sq) + (Sk - Sq), torch.arange(Sk), causal=causal,
                             window=window)
    s = torch.where(mask, s, fa.NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    p_hi = p.to(torch.bfloat16).float()
    parts = (p_hi, (p - p_hi).to(torch.bfloat16).float()) if split else (p_hi,)
    o = sum(torch.matmul(part.view(B, HK, rep * Sq, Sk), v.float()) for part in parts)
    o = o.view(B, HK, rep, Sq, D) / torch.where(l == 0.0, 1.0, l)
    return o.reshape(B, H, Sq, D).to(torch.bfloat16)


# (B, H, HK, Sq, Sk, D, causal, window): qwen2-0.5b's heads at S 256, a
# decode-style suffix with a window, a non-causal D 80
SPLIT_P_CASES = {
    "qwen2_layer_s256": (1, 14, 2, 256, 256, 64, True, None),
    "window_suffix": (1, 14, 2, 64, 256, 64, True, 32),
    "noncausal_d80": (1, 4, 4, 128, 128, 80, False, None),
    "kimi_k2_d112_rep8": (1, 16, 2, 256, 256, 112, True, None),
}


@pytest.mark.parametrize("case", sorted(SPLIT_P_CASES))
def test_split_p_arithmetic_meets_the_bf16_limit(case):
    """Pins the bf16 kernel's PV arithmetic before it reaches the card: with P
    split in two the bf16 output lies within the smoke's elementwise limit
    (2^-8 |want| + 1e-4 max|v|) of the plain version's fp32 result on the
    same inputs, while a P rounded once to bf16 exceeds that limit."""
    B, H, HK, Sq, Sk, D, causal, window = SPLIT_P_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q, k, v = _to_torch(*_arrays(rng, (B, H, Sq, D), (B, HK, Sk, D), (B, HK, Sk, D)),
                        dtype=torch.bfloat16)
    want32 = fa.flash_attention_ref(q.float(), k.float(), v.float(), causal=causal,
                                    window=window).numpy()
    limit = _bf16_limit(want32, v.float().numpy())

    def excess(split):
        got = _split_p_attention(q, k, v, causal=causal, window=window, split=split)
        return float((np.abs(got.float().numpy() - want32) / limit).max())

    assert excess(split=True) <= 1.0
    assert excess(split=False) > 1.0


def _ffma_kernel_attention(q, k, v, *, causal, window):
    """The fp32 CUDA kernel's arithmetic in plain torch, tile by tile, on fp32
    q, k, v: q tiles of 128 rows (64 for head dims above 128) against 64-key
    tiles over exactly the live range; per tile the fp32 scores, the row max
    of the raw scores (masked pairs count as -1e30), m_new = max(m, mx * sl2)
    with sl2 = scale * log2(e), alpha = exp2(m - m_new), p = exp2(fma(s, sl2,
    -m_new)) (the fma taken in float64 and rounded once, as the hardware
    does), p = 0 on masked pairs; a tile that crosses no edge (the ragged
    ends, the diagonal, the window's edge) is not masked at all, and the
    accumulator is rescaled only where a row max moved.  Returns the output
    and the counts of full tiles, masked tiles and rows whose rescale was
    skipped."""
    B, H, Sq, D = q.shape
    HK, Sk = k.shape[1], k.shape[2]
    k = k.repeat_interleave(H // HK, dim=1)
    v = v.repeat_interleave(H // HK, dim=1)
    BQ, BKV = (128 if D <= 128 else 64), 64
    sl2 = torch.tensor(D**-0.5, dtype=torch.float32) * torch.tensor(1.4426950408889634, dtype=torch.float32)
    neg = torch.tensor(fa.NEG_INF, dtype=torch.float32)
    out = torch.empty_like(q)
    counts = dict(full=0, masked=0, rescale_skipped=0)
    nkv = -(-Sk // BKV)
    for q0 in range(0, Sq, BQ):
        rows = min(BQ, Sq - q0)
        q_first = q0 + Sk - Sq
        q_last = q_first + rows - 1
        kt_begin, kt_end = 0, nkv
        if causal:
            kt_end = 0 if q_last < 0 else min(nkv, q_last // BKV + 1)
        if window is not None and q_first - window + 1 > 0:
            kt_begin = min(nkv, (q_first - window + 1) // BKV)
        m = torch.full((B, H, rows), fa.NEG_INF)
        l = torch.zeros(B, H, rows)
        acc = torch.zeros(B, H, rows, D)
        for kt in range(kt_begin, kt_end):
            k0 = kt * BKV
            kv_rows = min(BKV, Sk - k0)
            s = torch.matmul(q[:, :, q0:q0 + rows], k[:, :, k0:k0 + kv_rows].transpose(-1, -2))
            full = (rows == BQ and kv_rows == BKV and (not causal or k0 + BKV - 1 <= q_first)
                    and (window is None or k0 > q_last - window))
            if full:
                live = torch.ones(rows, kv_rows, dtype=torch.bool)
                counts["full"] += 1
            else:
                live = fa.attention_mask(torch.arange(rows) + q_first, torch.arange(kv_rows) + k0,
                                         causal=causal, window=window)
                counts["masked"] += 1
            mx = torch.where(live, s, neg).amax(-1)
            m_new = torch.maximum(m, torch.where(mx == neg, neg, mx * sl2))
            alpha = torch.exp2(m - m_new)
            m = m_new
            x = torch.exp2((s.double() * sl2.double() - m_new.double()[..., None]).float())
            p = torch.where(live, x, 0.0)
            l = l * alpha + p.sum(-1)
            moved = alpha != 1.0
            acc = torch.where(moved[..., None], acc * alpha[..., None], acc)
            counts["rescale_skipped"] += int((~moved).sum())
            acc = acc + torch.matmul(p, v[:, :, k0:k0 + kv_rows])
        out[:, :, q0:q0 + rows] = acc / torch.where(l == 0.0, 1.0, l)[..., None]
    return out, counts


# (B, H, HK, Sq, Sk, D, causal, window), multiples of the Pallas kernel's 64:
# a ragged last q tile on the causal diagonal, a window suffix ending
# mid-tile, rows at negative positions, and D 80 (the 128 bucket)
FFMA_CASES = {
    "causal_ragged_q_tile": (1, 4, 2, 320, 320, 64, True, None),
    "window_suffix": (1, 4, 2, 128, 512, 64, True, 300),
    "masked_rows": (1, 2, 1, 192, 128, 64, True, None),
    "noncausal_d80": (1, 2, 2, 192, 192, 80, False, None),
}


@pytest.mark.parametrize("case", sorted(FFMA_CASES))
def test_ffma_kernel_arithmetic_meets_the_fp32_limit(case):
    """Pins the fp32 kernel's softmax before it reaches the card: the scale
    folded into the fma before exp2, the rescale skipped where no row max
    moved, and the mask built only on tiles that cross an edge keep the
    result within the smoke's fp32 limit, 1e-4 * max|v|, of the plain version
    and of the Pallas kernel in interpret mode on the same inputs."""
    B, H, HK, Sq, Sk, D, causal, window = FFMA_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q, k, v = _arrays(rng, (B, H, Sq, D), (B, HK, Sk, D), (B, HK, Sk, D))
    tq, tk, tv = _to_torch(q, k, v)
    got, counts = _ffma_kernel_attention(tq, tk, tv, causal=causal, window=window)
    limit = 1e-4 * float(np.abs(v).max())
    ref = fa.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    pallas = np.asarray(flash_attention_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             causal=causal, window=window, bq=64, bkv=64,
                                             interpret=True))
    assert counts["masked"] > 0
    if case != "masked_rows":  # every q tile of that case is ragged
        assert counts["full"] > 0
    assert counts["rescale_skipped"] > 0
    assert float((got - ref).abs().max()) <= limit
    dead = max(Sq - Sk, 0) if causal else 0
    assert not got[:, :, :dead].any()  # rows at negative positions: exact zeros
    assert np.abs(got.numpy()[:, :, dead:] - pallas[:, :, dead:]).max() <= limit


def _tc_bucket(D):
    """The bf16 kernel's head-dim bucket: (output columns P V computes, keys a kv tile)."""
    dn = 64 if D <= 64 else 112 if D <= 112 else 128 if D <= 128 else 256
    return dn, 128 if D <= 128 else 64


def _tc_kernel_attention(q, k, v, *, causal, window):
    """The bf16 CUDA kernel's arithmetic in plain torch, tile by tile, on bf16
    q, k, v: blocks of 128 query rows run as two 64-row halves (the two
    consumer warpgroups) over the kv tiles of the block's live range (128
    keys at D <= 128, 64 at D 256); per half and tile the fp32 scores
    (products of bf16 values are exact), -inf on the pairs that are not live
    where the half's tile crosses an edge (the ragged ends, the diagonal, the
    window's edge) and no mask elsewhere, m_new = max(m, max(s) * sl2),
    alpha = exp2(m - m_new), p = exp2(fma(s, sl2, -m_new)) (the fma taken in
    float64 and rounded once), the accumulator rescaled only where a row max
    moved, then acc += p_hi V + p_lo V with p_hi = bf16(p) and p_lo = bf16(p -
    p_hi).  Returns the bf16 output, the fp32 one before that rounding, and
    the counts of full and masked half-tiles, of rows whose rescale was
    skipped and of kv tiles the live range skipped."""
    B, H, Sq, D = q.shape
    HK, Sk = k.shape[1], k.shape[2]
    k = k.float().repeat_interleave(H // HK, dim=1)
    v = v.float().repeat_interleave(H // HK, dim=1)
    q = q.float()
    BQ, HALF = 128, 64
    _, BKV = _tc_bucket(D)
    sl2 = torch.tensor(D**-0.5, dtype=torch.float32) * torch.tensor(1.4426950408889634, dtype=torch.float32)
    out = torch.zeros(B, H, Sq, D)
    counts = dict(full=0, masked=0, rescale_skipped=0, tiles_skipped=0)
    nkv = -(-Sk // BKV)
    for q0 in range(0, Sq, BQ):
        q_first = q0 + Sk - Sq
        q_last = q_first + min(BQ, Sq - q0) - 1
        kt_begin, kt_end = 0, nkv
        if causal:
            kt_end = 0 if q_last < 0 else min(nkv, q_last // BKV + 1)
        if window is not None and q_first - window + 1 > 0:
            kt_begin = min(nkv, (q_first - window + 1) // BKV)
        counts["tiles_skipped"] += nkv - max(kt_end - kt_begin, 0)
        for row0 in (q0, q0 + HALF):
            rows = min(HALF, Sq - row0)
            if rows <= 0:  # a ragged block's empty half: its rows are never stored
                continue
            w_first = row0 + Sk - Sq
            m = torch.full((B, H, rows), fa.NEG_INF)
            l = torch.zeros(B, H, rows)
            acc = torch.zeros(B, H, rows, D)
            for kt in range(kt_begin, kt_end):
                k0 = kt * BKV
                kv_rows = min(BKV, Sk - k0)
                s = torch.matmul(q[:, :, row0:row0 + rows], k[:, :, k0:k0 + kv_rows].transpose(-1, -2))
                full = (rows == HALF and kv_rows == BKV and (not causal or k0 + BKV - 1 <= w_first)
                        and (window is None or k0 > w_first + HALF - 1 - window))
                if full:
                    counts["full"] += 1
                else:
                    live = fa.attention_mask(torch.arange(rows) + w_first, torch.arange(kv_rows) + k0,
                                             causal=causal, window=window)
                    s = torch.where(live, s, -torch.inf)
                    counts["masked"] += 1
                m_new = torch.maximum(m, s.amax(-1) * sl2)
                alpha = torch.exp2(m - m_new)
                m = m_new
                p = torch.exp2((s.double() * sl2.double() - m_new.double()[..., None]).float())
                l = l * alpha + p.sum(-1)
                moved = alpha != 1.0
                acc = torch.where(moved[..., None], acc * alpha[..., None], acc)
                counts["rescale_skipped"] += int((~moved).sum())
                p_hi = p.to(torch.bfloat16).float()
                p_lo = (p - p_hi).to(torch.bfloat16).float()
                vt = v[:, :, k0:k0 + kv_rows]
                acc = acc + torch.matmul(p_hi, vt) + torch.matmul(p_lo, vt)
            out[:, :, row0:row0 + rows] = acc / torch.where(l == 0.0, 1.0, l)[..., None]
    return out.to(torch.bfloat16), out, counts


# (B, H, HK, Sq, Sk, D, causal, window, Pallas bq / bkv): a ragged last q
# tile on the causal diagonal (320 rows: the last block's second half is
# empty), kimi-k2's GQA at D 112 (rep 8), D 96 in the 112 bucket on a
# suffix, a window suffix ending mid-tile, and a non-causal D 256 ragged on
# both axes (the last block 72 rows, the last kv tile 56 keys)
TC_CASES = {
    "d64_causal_ragged_q_tile": (1, 4, 2, 320, 320, 64, True, None, 64),
    "d112_kimi_k2_rep8": (1, 16, 2, 192, 192, 112, True, None, 64),
    "d96_bucket112_suffix": (1, 4, 2, 256, 384, 96, True, None, 64),
    "window_suffix_mid_tile": (1, 4, 2, 128, 512, 64, True, 200, 64),
    "d256_noncausal_ragged": (1, 2, 1, 200, 120, 256, False, None, 40),
}


@pytest.mark.parametrize("case", sorted(TC_CASES))
def test_tc_kernel_arithmetic_meets_the_bf16_limit(case):
    """Pins the bf16 kernel's tiling before it reaches the card: 128-row
    blocks as two 64-row halves, 128-key tiles (64 at D 256) over the live
    range, the mask only on tiles that cross an edge, the rescale only where
    a row max moved and the split P keep the bf16 result within the bf16
    limit (2^-8 |want| + 1e-4 max|v|) of the plain version's fp32 result on
    the same inputs, and the fp32 sums before the rounding within the same
    limit of the Pallas kernel run in interpret mode on the same bf16 values."""
    B, H, HK, Sq, Sk, D, causal, window, blk = TC_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q, k, v = _to_torch(*_arrays(rng, (B, H, Sq, D), (B, HK, Sk, D), (B, HK, Sk, D)),
                        dtype=torch.bfloat16)
    got, got32, counts = _tc_kernel_attention(q, k, v, causal=causal, window=window)
    want32 = fa.flash_attention_ref(q.float(), k.float(), v.float(), causal=causal,
                                    window=window).numpy()
    vmax = v.float().numpy()
    assert (np.abs(got.float().numpy() - want32) <= _bf16_limit(want32, vmax)).all()
    pallas = np.asarray(flash_attention_call(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
                                             causal=causal, window=window, bq=blk, bkv=blk,
                                             interpret=True))
    assert (np.abs(got32.numpy() - pallas) <= _bf16_limit(pallas, vmax)).all()
    assert counts["masked"] > 0 and counts["full"] > 0
    assert counts["rescale_skipped"] > 0
    if causal or window is not None:
        assert counts["tiles_skipped"] > 0
    dn, _ = _tc_bucket(D)
    if D == 112:
        assert dn == D  # kimi-k2's head dim: P V computes no zero column


def test_flash_fully_masked_rows_are_zero():
    """Causal with Sq > Sk: the first Sq - Sk rows see no key.  The kernel (and
    the Pallas kernel) give zeros; the JAX package's -inf reference gives NaN."""
    rng = np.random.default_rng(3)
    B, H, HK, Sq, Sk, D = 1, 4, 2, 128, 64, 16
    q, k, v = _arrays(rng, (B, H, Sq, D), (B, HK, Sk, D), (B, HK, Sk, D))
    want = np.asarray(flash_attention_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           causal=True, bq=64, bkv=64, interpret=True))
    got = ops.flash_attention(*_to_torch(q, k, v), causal=True).numpy()
    assert not got[:, :, : Sq - Sk].any()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_flash_dispatch_rules_on_the_cpu():
    rng = np.random.default_rng(4)
    q, k, v = _to_torch(*_arrays(rng, (1, 2, 16, 8), (1, 1, 16, 8), (1, 1, 16, 8)))
    with pytest.raises(ValueError):  # the kernel needs a card
        ops.flash_attention(q, k, v, impl="kernel")
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, window=0)
    assert torch.equal(ops.flash_attention(q, k, v, impl="ref"), ops.flash_attention(q, k, v))


@pytest.mark.parametrize("layout", ["contiguous", "bshd_view", "one_head_free_stride", "one_row"])
def test_flash_outer_strides_name_a_valid_stride_for_size_one_axes(layout):
    """The (batch, head, sequence) strides the wrapper hands the kernels: as
    the tensor has them on every axis of several entries, and on an axis of
    size 1 (whose stride PyTorch leaves free) the tensor's extent, a multiple
    of 16 bytes in bf16 that the tensor maps take."""
    base = torch.zeros((2, 24, 4, 112), dtype=torch.bfloat16)
    t = {"contiguous": base.transpose(1, 2).contiguous(),
         "bshd_view": base.transpose(1, 2),
         "one_head_free_stride": torch.as_strided(base[:, :, :1].contiguous(), (2, 1, 24, 112),
                                                  (24 * 112, 1, 112, 1)),
         "one_row": base[:, :1].transpose(1, 2)}[layout]
    got = fa._outer_strides(t)
    for s, n, own in zip(got, t.shape[:3], t.stride()[:3]):
        assert s == own if n > 1 else (s * 2 % 16 == 0 and s >= t.shape[3])
    if layout == "one_head_free_stride":
        assert t.stride(1) == 1 and got[1] == 2 * 24 * 112


# --- models/attention.attention ---------------------------------------------

# name: (B, Sq, Sk, H, HK, D, kwargs)
ATTN_CASES = {
    "direct_causal": (2, 32, 32, 4, 2, 16, dict(impl="direct")),
    "direct_noncausal": (2, 32, 32, 4, 4, 16, dict(impl="direct", causal=False)),
    "direct_suffix_window": (1, 16, 64, 4, 1, 16, dict(impl="direct", window=24)),
    "small_chunked_takes_direct": (2, 64, 64, 4, 2, 16, dict(impl="chunked")),
    "chunked_causal": (1, 384, 384, 4, 2, 16, dict(impl="chunked", chunk=128)),
    "chunked_noncausal": (1, 256, 512, 2, 1, 16, dict(impl="chunked", causal=False, chunk=128)),
    "chunked_suffix_window": (1, 128, 640, 4, 2, 16, dict(impl="chunked", window=200, chunk=128)),
    "chunked_prefix": (1, 320, 320, 2, 2, 16, dict(impl="chunked", prefix_len=40, chunk=64)),
    "local_banded": (2, 64, 64, 4, 2, 16, dict(impl="chunked", window=16)),
    "local_banded_ragged": (1, 50, 50, 2, 1, 16, dict(impl="flash", window=16)),
    "local_banded_noncausal": (1, 64, 64, 2, 2, 16, dict(impl="chunked", window=16, causal=False)),
    "prefix_direct": (2, 32, 32, 4, 2, 16, dict(impl="chunked", prefix_len=8)),
    "prefix_never_flash": (2, 32, 32, 4, 2, 16, dict(impl="flash", prefix_len=8)),
    "flash_causal": (2, 64, 64, 4, 2, 16, dict(impl="flash")),
    "flash_noncausal": (1, 128, 128, 4, 4, 32, dict(impl="flash", causal=False)),
    "flash_suffix_window": (1, 64, 128, 4, 1, 16, dict(impl="flash", window=40)),
}


# cases held against another path of the JAX package: its banded path gives
# a non-causal window only the keys of two chunks, while the window
# (kpos > qpos - window) lets a non-causal query see every later key
JAX_IMPL = {"local_banded_noncausal": "direct"}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_matches_jax(case):
    """fp32, rtol = atol = 2e-4 (as the flash kernel's own limit)."""
    B, Sq, Sk, H, HK, D, kw = ATTN_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q, k, v = _arrays(rng, (B, Sq, H, D), (B, Sk, HK, D), (B, Sk, HK, D))
    jkw = dict(kw, impl=JAX_IMPL.get(case, kw["impl"]))
    want = np.asarray(jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw))
    fa.launches = 0
    got = tattn.attention(*_to_torch(q, k, v), **kw)
    assert fa.launches == 0
    assert got.shape == (B, Sq, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_chunked_on_a_ragged_kv_axis_matches_direct():
    """Sk not a multiple of the chunk.  The JAX package pads the last chunk
    with keys at position -1e9, which pass the causal and the all-true masks,
    so its chunked path gives the zero-padded keys weight there (an error of
    order 1 against its own direct path); the port slices the last chunk, so
    it agrees with the direct path of either package."""
    rng = np.random.default_rng(5)
    B, S, H, D = 1, 300, 2, 16
    q, k, v = _arrays(rng, (B, S, H, D), (B, S, H, D), (B, S, H, D))
    for causal in (True, False):
        want = np.asarray(jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          causal=causal, impl="direct"))
        got = tattn.attention(*_to_torch(q, k, v), causal=causal, impl="chunked", chunk=128)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
        jax_chunked = np.asarray(jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                 causal=causal, impl="chunked", chunk=128))
        assert np.abs(jax_chunked - want).max() > 1e-2  # the JAX package's padding fault


@pytest.mark.parametrize("S", [50, 64, 300])
def test_windowed_attention_on_a_ragged_sequence_matches_direct(S):
    """A window of 16 over S = 50 and 300 (ragged) and 64: every path against
    the port's direct path, causal and not.  The banded path padded the
    ragged last chunk with zero keys and, without the causal mask, let real
    queries attend to them; it also held a non-causal query to two chunks,
    where the window lets it see every later key.  Causal windows still take
    the banded path; non-causal ones the chunked (or direct) path.  The JAX
    package's banded path has both faults, so it is not the reference here."""
    torch.manual_seed(0)
    q, k, v = torch.randn(1, S, 2, 16), torch.randn(1, S, 1, 16), torch.randn(1, S, 1, 16)
    for causal in (False, True):
        want = tattn.attention(q, k, v, causal=causal, window=16, impl="direct")
        for impl in ("chunked", "flash"):
            got = tattn.attention(q, k, v, causal=causal, window=16, impl=impl, chunk=128)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


def test_attention_bf16_matches_jax():
    """bf16 activations through the flash path: both packages within one bf16
    rounding of the fp32 result on the same bf16 inputs."""
    rng = np.random.default_rng(6)
    q, k, v = _arrays(rng, (2, 64, 4, 16), (2, 64, 2, 16), (2, 64, 2, 16))
    want = jattn.attention(_bf16_jax(q), _bf16_jax(k), _bf16_jax(v), impl="flash")
    tq, tk, tv = _to_torch(q, k, v, dtype=torch.bfloat16)
    got = tattn.attention(tq, tk, tv, impl="flash")
    want32 = tattn.attention(tq.float(), tk.float(), tv.float(), impl="flash").numpy()
    limit = _bf16_limit(want32, tv.float().numpy())
    assert (np.abs(got.float().numpy() - want32) <= limit).all()
    assert (np.abs(np.asarray(want, np.float32) - want32) <= limit).all()


# --- decode_attention ---------------------------------------------------------


def _decode_inputs(rng, cache_dtype, B=2, S=24, H=4, HK=2, D=16):
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k, v = _arrays(rng, (B, S, HK, D), (B, S, HK, D))
    if cache_dtype != "int8":
        return q, k, v, None, None
    ks, vs = np.abs(k).max(-1), np.abs(v).max(-1)
    k8 = np.round(k / ks[..., None] * 127).astype(np.int8)
    v8 = np.round(v / vs[..., None] * 127).astype(np.int8)
    # scales are stored in bf16: hand both packages the bf16-exact values
    ks, vs = (np.asarray(jnp.asarray(s, jnp.bfloat16), np.float32) for s in (ks, vs))
    return q, k8, v8, ks, vs


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("window,ring", [(None, False), (8, True)])
def test_decode_attention_matches_jax(cache_dtype, window, ring):
    """fp32 q against an fp32, bf16 or int8 cache.  fp32: rtol = atol = 1e-5.
    bf16 and int8 round q and the probabilities to bf16 in both packages, so
    one bf16 ulp of the output can differ: atol = 2^-7 * max|v|."""
    rng = np.random.default_rng(8)
    q, k, v, ks, vs = _decode_inputs(rng, cache_dtype)
    S, pos = k.shape[1], 17
    kpos = None
    if ring:  # a ring buffer of S slots holding positions pos - S + 1 .. pos
        pos = 30
        kpos = pos - ((pos - np.arange(S)) % S)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}[cache_dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}[cache_dtype]
    jk, jv = (jnp.asarray(a).astype(jdt) for a in (k, v))
    want = np.asarray(jattn.decode_attention(
        jnp.asarray(q), jk, jv, pos, window=window,
        kpos=None if kpos is None else jnp.asarray(kpos),
        k_scale=None if ks is None else jnp.asarray(ks, jnp.bfloat16),
        v_scale=None if vs is None else jnp.asarray(vs, jnp.bfloat16)))
    tk, tv = (torch.from_numpy(a).to(tdt) for a in (k, v))
    got = tattn.decode_attention(
        torch.from_numpy(q), tk, tv, pos, window=window,
        kpos=None if kpos is None else torch.from_numpy(kpos),
        k_scale=None if ks is None else torch.from_numpy(ks).to(torch.bfloat16),
        v_scale=None if vs is None else torch.from_numpy(vs).to(torch.bfloat16)).numpy()
    assert got.shape == q.shape
    if cache_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        v_values = v if vs is None else v * vs[..., None] / 127.0  # dequantised int8
        assert np.abs(got - want).max() <= 2.0**-7 * float(np.abs(v_values).max())


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_decode_attention_over_several_chunks_matches_jax(cache_dtype):
    """A bf16 and an int8 cache longer than two chunks (and not a multiple of
    one): the port converts one chunk of the cache to fp32 at a time and sums
    the PV product chunk by chunk; held to the bf16 tolerance above."""
    rng = np.random.default_rng(9)
    S = 2 * tattn.DECODE_CHUNK + 37
    q, k, v, ks, vs = _decode_inputs(rng, cache_dtype, B=1, S=S, H=4, HK=2, D=16)
    pos = S - 5
    jdt = {"bfloat16": jnp.bfloat16, "int8": jnp.int8}[cache_dtype]
    tdt = {"bfloat16": torch.bfloat16, "int8": torch.int8}[cache_dtype]
    want = np.asarray(jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(k).astype(jdt), jnp.asarray(v).astype(jdt), pos,
        k_scale=None if ks is None else jnp.asarray(ks, jnp.bfloat16),
        v_scale=None if vs is None else jnp.asarray(vs, jnp.bfloat16)))
    got = tattn.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt), pos,
        k_scale=None if ks is None else torch.from_numpy(ks).to(torch.bfloat16),
        v_scale=None if vs is None else torch.from_numpy(vs).to(torch.bfloat16)).numpy()
    v_values = v if vs is None else v * vs[..., None] / 127.0  # dequantised int8
    assert np.abs(got - want).max() <= 2.0**-7 * float(np.abs(v_values).max())
