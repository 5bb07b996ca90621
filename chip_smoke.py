#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card, and check it.

    python3 chip_smoke.py              # on a machine with a CUDA card (H100)
    python3 chip_smoke.py --rehearse   # tiny sizes on the CPU, plain versions

Phases, one JSON line each:

1. ``build``        — ``nvcc`` builds every kernel of the path from
                      ``src/repro_torch``, one process per source, all at once.
   ``analysis``     — ``python -m repro_torch.analysis --selftest`` in-process
                      (host numpy, no JAX): 24 benchmark-structure plans
                      verified clean, every seeded corruption caught, the
                      repo lint clean against its baseline.
2. ``kernel``       — the ``block_spmm`` kernel on the card against its plain
                      PyTorch version on the same inputs (bit-identical on
                      repeat, within tolerance; its 128 x 128 engine
                      bit-identical to the 64 x 64 one on the timing case,
                      and every engine that takes bs 32 and bs 24, forced
                      with ``engine=``, bit-identical to the rule's),
                      timed with CUDA events beside the plain version and
                      its bound; then the band at bs 64 (N = 8192) and bs
                      32 (N = 4096) through TileRows and through Tile64:
                      the same bits, each timed beside Tile64, the plain
                      version and ``torch.bmm`` on pre-gathered operands.
3. ``fused_kernel`` — the fused leaf kernel the same way, on the N = 8192 band
                      planned for 8 workers (fp32, bf16 stores, adaptive,
                      masked tasks), bs 24, no exchange rounds and empty runs;
                      fp32 fused is bit-identical to the staged path
                      (concatenated buffers + ``block_spmm``); the band at
                      bs 64 on 8 workers through TileRows == Tile64 ==
                      the staged path, timed as the bs-64 band above.
4. ``multiply``     — the paper's Table 1 first row (banded A, N = 100,000,
                      half-bandwidth 3000, bs 128): ``multiply(A, A)``, with 64
                      sampled output blocks held against float64 host products.
5. ``sp2``          — the ``examples/purification.py`` pipeline at N = 8192,
                      bs 128: S -> inv_chol -> Z^T F Z -> sp2_purify -> D, held
                      against a float64 eigendecomposition.
6. ``dist_multiply`` — the paper's Table 1 second row (N = 200,000, 4 workers):
                      ``scatter`` -> ``dist_multiply`` (cold and warm plan
                      cache) -> ``gather``, bit-identical to ``multiply(A, A)``.
   ``weak_scaling`` — the largest Table 1 band row that fits the card (row
                      3: N = 400,000, 8 workers, bs 128) through
                      ``benchmarks/torch_weak_scaling.py``'s resident row:
                      one fused launch a call, 64 sampled output blocks
                      against float64 products, peak memory under 80 GB.
7. ``dist_spamm``   — delta-plan SpAMM at N = 8192 on 8 workers, two ``tau``
                      and three precisions, each within its returned bound.
8. ``dist_pipeline`` — the ``sp2`` phase's S and H resident on 8 workers:
                      ``dist_sqrt_inv_pipeline`` (S -> Z -> Z^T H Z -> SP2 ->
                      Z D Z^T), one fused launch per non-empty resident
                      multiply, M = L^T D L (L = cholesky(S)) held to the
                      ``sp2`` phase's limits against the float64
                      eigendecomposition of L^-1 H L^-T; then the same run
                      from a skewed layout with ``rebalance=``, bit-identical.
9. ``dist_outer``   — the outer-product schedule on Table 1 row 1's
                      random-blocks structure (N = 100,000, band half-width
                      3000, one dense block of 15,716; 2 workers, bs 128):
                      ``choose_schedule`` picks it over the p2p plan;
                      ``dist_spgemm_outer`` (one ``block_spmm`` launch for
                      both workers) held per block against the resident p2p
                      ``dist_multiply`` and bit-identical on repeat; kernel,
                      exchange and accumulate timed; then the N = 8192 band
                      on 8 workers against the plain version.
10. ``dist_observatory`` — the ``dist_pipeline`` phase's skewed run with the
                      plan verifier (``verify="always"``), tracer, event log,
                      memory meter, locality ledger, flight recorder and
                      health monitor on: D bit-identical to the static run,
                      no violation, a valid trace with 8 worker tracks, the
                      ledger conserving bytes; the host time split between
                      plan builds, verification, dispatch and the rest; the
                      observatory's overhead on the warm pipeline, in turns,
                      and each observer's alone (wall, process and
                      main-thread CPU).
    ``sequences``   — the paper's three structure families (banded,
                      exp-decay, random-offdiag at N = 8192, bs 128) through
                      resident SP2 on 8 workers from the all-on-worker-0
                      layout, static and with ``rebalance=``, a locality
                      ledger on: D bit-identical, the rebalanced locality
                      above the static one, one fused launch per non-empty
                      resident multiply, |trace(D) - n_occ| <= 1e-3 on a
                      family with a spectral gap.
11. ``flash_kernel`` — the flash-attention kernels (fp32 FFMA, bf16 tensor
                      cores) against their plain version over eight shapes
                      (qwen2-0.5b's layer, non-causal D 80, D 128 and 256
                      with one kv head, a decode-style suffix, a window,
                      ragged S, fully masked rows), timed on qwen2-0.5b's
                      layer and the D 128 and D 256 cases in both types
                      beside the plain version, the bounds and SDPA (a
                      yardstick only); the ``build`` phase fails on a spill
                      in any fp32 instantiation it compiled.
12. ``lm_forward``   — qwen2-0.5b at full width (24 layers, d 896, vocab
                      151,936), seeded random weights, B 2 x S 4096:
                      ``apply(attn_impl="flash")`` against ``"direct"`` in fp32
                      and bf16, 24 kernel launches per forward.
13. ``lm_serve``    — ``generate`` at full width, fp32, 4 requests, prompt 8,
                      32 new tokens; a flash forward over the generated
                      sequences confirms every decode step's logits and token.
    ``lm_train``    — the training path: qwen2-0.5b at full width cut to 2
                      layers, fp32, B 2 x S 640 (two kv chunks, the last
                      ragged): one step's loss and gradients on the card
                      against the CPU's, and the AdamW update of the CPU's
                      gradients on the card against the CPU's; then all 24
                      layers, B 4 x S 1024, bf16 compute with fp32 params and
                      AdamW, 8 steps through ``TrainLoop`` from
                      ``TokenPipeline`` (seed 0) with a checkpoint every 4
                      into a temporary directory: the loss at step 7, and
                      batch 0's loss at the final parameters, below 0.95 of
                      step 0's; a new loop
                      resumed from the step-4 checkpoint ends bit-identical,
                      one step run twice is bit-identical, and the train step
                      launches none of the three kernels (no kernel has a
                      gradient rule); tokens/s and MFU over the whole 8-step
                      window, the median ms a step, peak memory, checkpoint
                      seconds and the card's busy share.  Before the loop,
                      the same shape under ``remat="none"`` and ``"full"``
                      (every full config's): ms a step and peak memory of
                      each, ``"full"``'s peak below ``"none"``'s, and the
                      first step's loss and gradients bit-identical.
    ``dryrun``      — the one-card dry run (``repro_torch.launch.dryrun``: each
                      cell's step on fake tensors, host only): all 40 (arch x
                      shape) cells at full width over worker processes, 31
                      ``ok`` and 9 ``skipped`` with the reference's reasons,
                      none in ``error``; then qwen2-0.5b's train step at
                      ``lm_train``'s shape under ``remat="none"`` and
                      ``"full"`` and one decode step of its full
                      ``decode_32k`` cell (B 128, 32,768 cached positions,
                      position 32,000) on the card: each predicted peak
                      within 15 % of ``max_memory_allocated`` above the
                      phase's starting allocation, beside the predicted
                      FLOPs over the step's time and the decode step's ms
                      beside its memory term.
    ``moe_layer``   — one MoE layer of qwen3-moe-235b-a22b at full width (d
                      4096, 128 experts, d_ff 1536, top 8, SwiGLU) on B 2 x S
                      4096 tokens at capacity factor 1.25 (640 rows an
                      expert): ``moe_apply(gemm_impl="block_spmm")``, three
                      kernel launches, bit-identical on repeat, within
                      1e-4 * max|out| of the einsum route; each expert GEMM
                      held to the kernel's plain version and timed beside
                      ``torch.bmm`` and its bound; then the layer's 65,536
                      dropless pairs through ``grouped_gemm_varsize`` (bm 8,
                      TileRows packing 8 tiles), held to a per-group
                      product, bit-identical to the same launch forced
                      through Tile64, and timed beside Tile64, the
                      per-group ``torch.matmul`` loop and its bound.
    ``lm_families`` — qwen3-moe-235b-a22b (2 of 94 layers), recurrentgemma-9b
                      (5 of 38: rec, rec, local, rec, rec) and mamba2-370m
                      (all 48) at full width, seeded weights, one after the
                      other: a forward at B 2 x S 4096 (qwen3-moe's flash
                      against direct), then ``generate`` (4 requests, prompt
                      8, 32 new tokens, fp32) confirmed by a forward over the
                      generated sequences (dropless for the MoE); positions
                      where a router's 8th and 9th probabilities tie to fp32
                      rounding are counted and left out.
    ``examples``    — every ``examples/torch_*.py`` with ``--device cuda``,
                      all seven at once, each in its own process: each checks
                      its own result (against the dense oracle, the
                      single-host driver, the prompt, a falling loss) and
                      must exit 0.
14. ``dist_pipeline_profile`` — the ``dist_pipeline`` phase's static run
                      replayed on a full plan cache under ``torch.profiler``:
                      the card's busy share and the fused kernel's time
                      (last, since a profiler session slows later launches).
15. the ``{"kernels": [...]}`` line (the flash kernel once per type, with
    its launches per type; ``block_spmm`` with its MoE expert GEMMs beside
    ``torch.bmm`` and its grouped GEMM beside its bound), then
    ``{"ok": true, "device": {...}}``.

Any failed check raises, so the run exits non-zero and prints no ``ok`` line.
Without ``--rehearse`` it needs a CUDA card and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: fp32 FFMA rate (no tensor cores), dense bf16
# tensor-core rate, HBM3 rate
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
# per output block: |dC|_max <= REL * sum over its tasks of ||A_t||_F ||B_t||_F,
# because the kernel and the plain version sum each element in another order
REL = 1e-5
# the sequences phase: a family whose HOMO-LUMO gap is below this share of its
# spectral width has no spectral gap, and fp32 SP2 a trace floor on it
GAP_MIN_REL = 1e-3

# bf16 rounding of both operands of a task: |fl(A)fl(B) - AB|_F <= (2u + u^2) |A|_F |B|_F
ROUND2_BOUND = 2.0 * 2.0**-8 + 2.0**-16

LM_BATCH = 2  # lm_forward: B 2 x S lm_seq
# lm_train: the parity step's limits (loss relative; per leaf, of its max|x|)
# and the full-width run's peak rate (the training CLI's default)
TRAIN_LOSS_REL = 1e-5
TRAIN_GRAD_REL = 1e-4
TRAIN_UPDATE_REL = 1e-6
TRAIN_LR = 1e-3
# lm_train learns when its loss ends below this share of the loss at the initial
# parameters (step 0's): 5 %, far above the 0.3 % by which two batches differ there
TRAIN_LEARN_SHARE = 0.95
SERVE = (4, 8, 32)  # lm_serve: requests, prompt length, new tokens (the JAX CLI's defaults)

# flash-attention cases: (B, H, HK, Sq, Sk, D, causal, window); FLASH_TIMED are timed
FLASH_TIMED = ("qwen2_0_5b_layer", "d128_hk1", "d256_hk1")
FLASH_FULL = {
    "qwen2_0_5b_layer": (2, 14, 2, 4096, 4096, 64, True, None),
    "noncausal_d80": (2, 16, 16, 1024, 1024, 80, False, None),
    "d128_hk1": (1, 16, 1, 2048, 2048, 128, True, None),
    "d256_hk1": (1, 8, 1, 2048, 2048, 256, True, None),
    "suffix_256_of_4096": (2, 14, 2, 256, 4096, 64, True, None),
    "window512_suffix": (1, 14, 2, 1024, 4096, 64, True, 512),
    "ragged_1000": (2, 14, 2, 1000, 1000, 64, True, None),
    "masked_rows": (1, 14, 2, 1000, 600, 64, True, None),
}
FLASH_REHEARSAL = {
    "qwen2_0_5b_layer": (2, 14, 2, 256, 256, 64, True, None),
    "noncausal_d80": (1, 4, 4, 128, 128, 80, False, None),
    "d128_hk1": (1, 4, 1, 128, 128, 128, True, None),
    "d256_hk1": (1, 2, 1, 128, 128, 256, True, None),
    "suffix_256_of_4096": (1, 14, 2, 16, 256, 64, True, None),
    "window512_suffix": (1, 14, 2, 64, 256, 64, True, 32),
    "ragged_1000": (1, 14, 2, 100, 100, 64, True, None),
    "masked_rows": (1, 14, 2, 100, 60, 64, True, None),
}

FULL = dict(mul_n=100_000, mul_hw=3000, mul_bs=128, time_n=8192,
            sp2_n=8192, sp2_bs=128, sp2_nocc=2560,
            fused_p=8, r24_n=4800, r24_hw=600, small_n=2048,
            small_bands=((64, 8192), (32, 4096)),
            dist_n=200_000, dist_p=4, spamm_n=8192, spamm_p=8, pipe_p=8,
            outer=dict(n=100_000, bs=128, hw=3000, block=15716, p=2,
                       small_n=8192, small_hw=1000, small_p=8),
            seq_n=8192, seq_bs=128, seq_p=8, seq_max_iter=10,
            weak_scaling=dict(n=400_000, hw=3000, bs=128, workers=8, table1_row=3),
            flash=FLASH_FULL, lm_reduced=False, lm_seq=4096,
            train=dict(parity_layers=2, parity_batch=2, parity_seq=640, batch=4, seq=1024,
                       steps=8, ckpt_every=4),
            dryrun=dict(arch="qwen2-0.5b", reduced=False, workers=8, train_batch=4,
                        train_seq=1024, decode_shape="decode_32k", decode_pos=32_000))
REHEARSAL = dict(mul_n=4096, mul_hw=300, mul_bs=32, time_n=1024,
                 sp2_n=512, sp2_bs=32, sp2_nocc=160,
                 fused_p=8, r24_n=480, r24_hw=60, small_n=256,
                 small_bands=((64, 512), (32, 256)),
                 dist_n=4096, dist_p=4, spamm_n=1024, spamm_p=8, pipe_p=8,
                 outer=dict(n=4096, bs=32, hw=120, block=640, p=2,
                            small_n=1024, small_hw=120, small_p=8),
                 seq_n=256, seq_bs=16, seq_p=8, seq_max_iter=40,
                 weak_scaling=dict(n=4096, hw=300, bs=32, workers=8),
                 flash=FLASH_REHEARSAL, lm_reduced=True, lm_seq=64,
                 train=dict(parity_layers=2, parity_batch=2, parity_seq=640, batch=4, seq=64,
                            steps=8, ckpt_every=4),
                 dryrun=dict(arch="qwen2-0.5b", reduced=True, workers=4, train_batch=4,
                             train_seq=64, decode_shape="decode_32k", decode_batch=2,
                             decode_seq=64, decode_pos=60))


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


class Context:
    """The device under test, its synchronisation and its timer."""

    def __init__(self, torch, rehearse: bool):
        self.torch = torch
        self.rehearse = rehearse
        self.dev = torch.device("cpu" if rehearse else "cuda")
        self.card = None  # nvidia-smi's name and power limit, set by main on the card

    def sync(self) -> None:
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()

    def time_ms(self, fn, reps: int) -> float:
        """Mean milliseconds of ``fn`` over ``reps`` warm calls (CUDA events on the card)."""
        fn()
        self.sync()
        if self.dev.type == "cuda":
            start = self.torch.cuda.Event(enable_timing=True)
            end = self.torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps


def gemm_bound(T, bm, bk, bn, a_blocks, b_blocks, num_out, itemsize):
    """Least time for the grouped GEMM on an H100: operations or bytes, whichever is larger.

    Operations: 2*T*bm*bn*bk at the fp32 FFMA rate.  Bytes: every distinct
    operand block read once, the task arrays (two int64 per task plus the
    int64 run offsets), and every output block written once in fp32.
    """
    ops = 2.0 * T * bm * bn * bk
    nbytes = ((a_blocks * bm * bk + b_blocks * bk * bn) * itemsize
              + 8 * (2 * T + num_out + 1) + 4 * num_out * bm * bn)
    t_ops, t_bytes = ops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return dict(
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        bound_arithmetic=(f"max(2*{T}*{bm}*{bn}*{bk} op / 67e12 op/s = {t_ops * 1e3:.4f} ms, "
                          f"{nbytes} B / 3.35e12 B/s = {t_bytes * 1e3:.4f} ms)"),
    )


def band_coords(nb: int, hw_blocks: int):
    """Morton-sorted block coordinates of a block band |I - J| <= hw_blocks."""
    import numpy as np
    from repro_torch.core.quadtree import morton_sort

    i = np.arange(nb)
    parts = [np.stack([i[(i + d >= 0) & (i + d < nb)], (i + d)[(i + d >= 0) & (i + d < nb)]], 1)
             for d in range(-hw_blocks, hw_blocks + 1)]
    coords = np.concatenate(parts).astype(np.int64)
    return coords[morton_sort(coords)]


def banded_matrix(ctx, n: int, hw: int, bs: int, seed: int):
    """Banded A (|i - j| <= hw, N x N) built from block coordinates, values
    from a seeded torch.Generator on the device (a dense N x N never exists)."""
    torch = ctx.torch
    from repro_torch.core import BSMatrix

    coords = band_coords(-(-n // bs), (hw + bs - 1) // bs)
    gen = torch.Generator(device=ctx.dev).manual_seed(seed)
    data = torch.randn((coords.shape[0], bs, bs), generator=gen, device=ctx.dev)
    r = torch.arange(bs, device=ctx.dev)
    c_t = torch.from_numpy(coords).to(ctx.dev)
    for k in range(0, coords.shape[0], 4096):  # mask the element band in slabs
        rows = (c_t[k:k + 4096, 0, None, None] * bs + r[None, :, None])
        cols = (c_t[k:k + 4096, 1, None, None] * bs + r[None, None, :])
        keep = ((rows - cols).abs() <= hw) & (rows < n) & (cols < n)
        data[k:k + 4096].mul_(keep)
    return BSMatrix(shape=(n, n), bs=bs, coords=coords, data=data)


def block_tolerance(a_data, b_data, a_idx, b_idx, run_ptr):
    """REL * sum_t ||A_t||_F ||B_t||_F per output block, on the device."""
    import torch as th

    na = th.linalg.matrix_norm(a_data.double())
    nb = th.linalg.matrix_norm(b_data.double())
    per_task = na[a_idx] * nb[b_idx]
    csum = th.cat([per_task.new_zeros(1), per_task.cumsum(0)])
    return REL * (csum[run_ptr[1:]] - csum[run_ptr[:-1]])


def gemm_engine(ctx, module, engine):
    """A GEMM kernel forced through one tile engine (``engine=``); in the
    rehearsal, where no kernel runs, its plain version."""
    if ctx.rehearse:
        return module.block_spmm_ref if hasattr(module, "block_spmm_ref") else module.fused_block_spmm_ref
    cuda = module.block_spmm_cuda if hasattr(module, "block_spmm_cuda") else module.fused_block_spmm_cuda
    return lambda *a, **k: cuda(*a, **k, engine=engine)


def valid_engines(bm, bk, bn, tensors):
    from repro_torch.kernels import block_spmm as bsp

    return [e for e in bsp.ENGINES if bsp.engine_takes(e, bm, bk, bn, tensors)]


def phase_build(ctx) -> dict:
    if ctx.rehearse:
        out = dict(phase="build", skipped="rehearsal: no nvcc, plain versions only")
        emit(out)
        return out
    from repro_torch.kernels import build

    names = ["block_spmm", "fused_block_spmm", "flash_attention"]
    t0 = time.perf_counter()
    build.build_all(names)
    for name in names:
        build.load_library(name)
    secs = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in build.build_logs.get(name, "").splitlines()
                    if "registers" in ln or "spill" in ln] for name in names}
    log = build.build_logs.get("flash_attention", "")  # empty for a library loaded as built
    flash = ptxas_by_function(log)
    out = dict(phase="build", seconds=secs, kernels=names, ptxas=ptxas, flash_ptxas=flash)
    emit(out)
    if log:
        f32 = {f: r for f, r in flash.items() if f.startswith("flash_attention_f32_kernel")}
        check(len(f32) == 3, f"build: ptxas reported {sorted(f32)} for the fp32 flash kernel, "
                             "expected D 64, 128 and 256")
        for f, r in f32.items():
            check(r["spill_stores"] == 0 and r["spill_loads"] == 0, f"build: {f} spills registers: {r}")
    return out


def ptxas_by_function(log: str) -> dict:
    """``{kernel<DMAX>: {registers, spill_stores, spill_loads}}`` from the flash
    library's ``nvcc -Xptxas -v`` output (mangled names shortened)."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            short = re.search(r"(flash_attention_(?:f32|bf16)_kernel)ILi(\d+)E", entry.group(1))
            name = f"{short.group(1)}<{short.group(2)}>" if short else entry.group(1)
            out[name] = dict(registers=None, spill_stores=None, spill_loads=None)
            continue
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spills and name:
            out[name].update(spill_stores=int(spills.group(1)), spill_loads=int(spills.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            out[name]["registers"] = int(regs.group(1))
    return out


def phase_kernel(ctx, sizes) -> dict:
    import numpy as np

    torch = ctx.torch
    from repro_torch.kernels import block_spmm as bsp
    from repro_torch.kernels import ops
    from repro_torch.core.spgemm import spgemm_symbolic

    kernel = bsp.block_spmm_ref if ctx.rehearse else bsp.block_spmm_cuda
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=ctx.dev).manual_seed(1)
    cases = []

    def random_case(name, bs, dtype, n_blocks, num_out, max_run, empty):
        lens = rng.integers(1, max_run + 1, num_out)
        lens[list(empty)] = 0
        c = np.repeat(np.arange(num_out), lens)
        a = rng.integers(0, n_blocks, c.size)
        b = rng.integers(0, n_blocks, c.size)
        A = torch.randn((n_blocks, bs, bs), generator=gen, device=ctx.dev).to(dtype)
        B = torch.randn((n_blocks, bs, bs), generator=gen, device=ctx.dev).to(dtype)
        return name, A, B, a, b, c, num_out

    # the timing case: the paper's band (half-bandwidth 3000 elements) at
    # bs 128, cut to N = 8192 so that the plain version's [T, bs, bs] gather fits
    mbs = sizes["mul_bs"]
    coords = band_coords(-(-sizes["time_n"] // mbs), (sizes["mul_hw"] + mbs - 1) // mbs)
    tasks = spgemm_symbolic(coords, coords)
    A = torch.randn((coords.shape[0], mbs, mbs), generator=gen, device=ctx.dev)
    timing = (f"band_bs{mbs}_f32", A, A, tasks.a_idx, tasks.b_idx, tasks.c_idx, tasks.num_out)
    cases.append(timing)
    empty = (3, 17, 63)  # empty rows, the last one a trailing trash row
    cases.append(random_case(f"runs_bs{mbs}_bf16", mbs, torch.bfloat16, 200, 64, 12, empty))
    cases.append(random_case("runs_bs32_f32", 32, torch.float32, 300, 64, 12, empty))
    cases.append(random_case("runs_bs24_f32", 24, torch.float32, 300, 64, 12, empty))

    results = []
    for name, A, B, a, b, c, num_out in cases:
        args = (A, B, *ops.task_arrays(a, b, c, num_out, ctx.dev), num_out)
        got = kernel(*args)
        again = kernel(*args)
        want = bsp.block_spmm_ref(*args)
        ctx.sync()
        identical = bool(torch.equal(got, again))
        err = (got - want).abs().flatten(1).amax(dim=1).double()
        tol = block_tolerance(A, B, args[2], args[3], args[4])
        ok = bool((err <= tol).all())
        empty_rows_zero = bool(not got[torch.from_numpy(np.setdiff1d(np.arange(num_out), c)).to(ctx.dev)].any())
        row = dict(case=name, dtype=str(A.dtype).replace("torch.", ""), bs=A.shape[1],
                   tasks=int(len(a)), num_out=num_out, max_abs_err=float(err.max()),
                   max_err_over_tol=float((err / tol.clamp_min(1e-300)).max()),
                   bit_identical_on_repeat=identical, empty_rows_zero=empty_rows_zero)
        check(identical, f"{name}: kernel output differs between two launches")
        check(ok, f"{name}: kernel disagrees with the plain version beyond tolerance")
        check(empty_rows_zero, f"{name}: rows without tasks are not zero")
        if name in ("runs_bs32_f32", "runs_bs24_f32"):  # every engine that takes it, forced
            engines = valid_engines(A.shape[1], A.shape[2], B.shape[2], (A, B))
            same = {e: bool(torch.equal(gemm_engine(ctx, bsp, e)(*args), got)) for e in engines}
            row.update(engines=engines, engines_bit_identical=all(same.values()),
                       rule_engine=bsp.tile_engine(A.shape[1], A.shape[2], B.shape[2], (A, B)))
            check(row["engines_bit_identical"], f"{name}: the engines differ: {same}")
        results.append(row)

    small = [small_band_case(ctx, bs, n, sizes["mul_hw"], gen) for bs, n in sizes["small_bands"]]

    name, A, B, a, b, c, num_out = timing
    args = (A, B, *ops.task_arrays(a, b, c, num_out, ctx.dev), num_out)
    # the 128 x 128 engine against the 64 x 64 one on the timing case: one
    # fmaf chain per element in both, so the same bits (engine= forces one)
    engines_identical = bool(torch.equal(kernel(*args), gemm_engine(ctx, bsp, "tile64")(*args)))
    check(engines_identical, f"{name}: the 128 x 128 and 64 x 64 engines differ")
    ms = ctx.time_ms(lambda: kernel(*args), reps=10)
    plain_ms = ctx.time_ms(lambda: bsp.block_spmm_ref(*args), reps=3)
    lhs, rhs = A[args[2]], B[args[3]]
    bmm_ms = ctx.time_ms(lambda: torch.bmm(lhs, rhs), reps=10)
    del lhs, rhs
    T = len(a)
    bound = gemm_bound(T, mbs, mbs, mbs, np.unique(a).size, np.unique(b).size, num_out, 4)
    timing_row = dict(case=name, tasks=T, ms=ms, plain_ms=plain_ms,
                      engines_bit_identical=engines_identical,
                      tflops=2.0 * T * mbs**3 / (ms * 1e-3) / 1e12,
                      bmm_yardstick_ms=bmm_ms,
                      bmm_yardstick="torch.bmm on the pre-gathered operands: the products only, no gather, no sum",
                      **bound)
    out = dict(phase="kernel", cases=results, timing=timing_row, small_blocks=small)
    emit(out)
    return out


def small_band_case(ctx, bs: int, n: int, hw: int, gen) -> dict:
    """The paper's band (half-bandwidth ``hw`` elements) at a small leaf,
    through the rule's engine (TileRows) and forced through Tile64: the same
    bits, repeat-identical, within the plain version's limit; timed beside
    Tile64, the plain version and ``torch.bmm`` on pre-gathered operands.
    Cut to ``n`` so that the plain version's ``[T, bs, bs]`` gathers fit."""
    import numpy as np

    torch = ctx.torch
    from repro_torch.core.spgemm import spgemm_symbolic
    from repro_torch.kernels import block_spmm as bsp
    from repro_torch.kernels import ops

    kernel = bsp.block_spmm_ref if ctx.rehearse else bsp.block_spmm_cuda
    tile64 = gemm_engine(ctx, bsp, "tile64")
    coords = band_coords(-(-n // bs), (hw + bs - 1) // bs)
    tasks = spgemm_symbolic(coords, coords)
    A = torch.randn((coords.shape[0], bs, bs), generator=gen, device=ctx.dev)
    num_out = tasks.num_out
    args = (A, A, *ops.task_arrays(tasks.a_idx, tasks.b_idx, tasks.c_idx, num_out, ctx.dev), num_out)
    name = f"band_bs{bs}_n{n}_f32"
    got, again, old = kernel(*args), kernel(*args), tile64(*args)
    ctx.sync()
    identical, same = bool(torch.equal(got, again)), bool(torch.equal(got, old))
    del again, old
    want = bsp.block_spmm_ref(*args)
    err = (got - want).abs().flatten(1).amax(dim=1).double()
    tol = block_tolerance(A, A, args[2], args[3], args[4])
    row = dict(case=name, bs=bs, n=n, tasks=int(tasks.a_idx.size), num_out=num_out,
               engine=bsp.tile_engine(bs, bs, bs, (A,)), pack=bsp.rows_pack(bs, bs),
               max_abs_err=float(err.max()),
               max_err_over_tol=float((err / tol.clamp_min(1e-300)).max()),
               bit_identical_on_repeat=identical, bit_identical_to_tile64=same)
    del want, got, err
    check(identical, f"{name}: kernel output differs between two launches")
    check(same, f"{name}: TileRows and Tile64 differ")
    check(row["max_err_over_tol"] <= 1.0, f"{name}: kernel disagrees with the plain version")
    row["ms"] = ctx.time_ms(lambda: kernel(*args), reps=5)
    row["tile64_ms"] = ctx.time_ms(lambda: tile64(*args), reps=3)
    row["plain_ms"] = ctx.time_ms(lambda: bsp.block_spmm_ref(*args), reps=2)
    lhs, rhs = A[args[2]], A[args[3]]
    row["bmm_yardstick_ms"] = ctx.time_ms(lambda: torch.bmm(lhs, rhs), reps=5)
    del lhs, rhs
    T = row["tasks"]
    row.update(gemm_bound(T, bs, bs, bs, np.unique(tasks.a_idx).size, np.unique(tasks.b_idx).size,
                          num_out, 4),
               tflops=2.0 * T * bs**3 / (row["ms"] * 1e-3) / 1e12,
               speedup_over_tile64=row["tile64_ms"] / row["ms"])
    row["bound_share"] = row["bound_ms"] / row["ms"]
    del A, args
    if ctx.dev.type == "cuda":
        torch.cuda.empty_cache()
    return row


def phase_multiply(ctx, sizes) -> dict:
    import numpy as np

    torch = ctx.torch
    from repro_torch.core import SymbolicCache, multiply
    from repro_torch.kernels import block_spmm as bsp
    from repro_torch.kernels import ops

    n, hw, bs = sizes["mul_n"], sizes["mul_hw"], sizes["mul_bs"]
    t0 = time.perf_counter()
    a = banded_matrix(ctx, n, hw, bs, seed=100)
    ctx.sync()
    build_s = time.perf_counter() - t0
    cache = SymbolicCache()
    if ctx.dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    bsp.launches = 0
    t0 = time.perf_counter()
    c = multiply(a, a, cache=cache)
    ctx.sync()
    first_s = time.perf_counter() - t0
    launches = bsp.launches
    expected = 0 if ctx.rehearse else 1
    check(launches == expected, f"multiply launched the kernel {launches} times, expected {expected}")
    peak = torch.cuda.max_memory_allocated() if ctx.dev.type == "cuda" else None
    tasks = cache.peek(("spgemm", a.structure_key, a.structure_key))
    T = tasks.num_tasks
    flops = 2.0 * T * bs**3

    # kernel time alone, on the uploaded task arrays (CUDA events)
    args = (a.data, a.data, *ops.task_arrays(tasks.a_idx, tasks.b_idx, tasks.c_idx,
                                            tasks.num_out, ctx.dev), tasks.num_out)
    kernel = bsp.block_spmm_ref if ctx.rehearse else bsp.block_spmm_cuda
    del c
    kernel_ms = ctx.time_ms(lambda: kernel(*args), reps=2)
    t0 = time.perf_counter()
    c = multiply(a, a, cache=cache)  # the symbolic phase is a cache hit now
    ctx.sync()
    warm_s = time.perf_counter() - t0

    # 64 sampled output blocks against float64 host products of the same blocks
    rng = np.random.default_rng(5)
    run_ptr = args[4].cpu().numpy()
    worst = 0.0
    for blk in rng.choice(tasks.num_out, size=min(64, tasks.num_out), replace=False):
        lo, hi = run_ptr[blk], run_ptr[blk + 1]
        ia = torch.from_numpy(tasks.a_idx[lo:hi]).to(ctx.dev)
        ib = torch.from_numpy(tasks.b_idx[lo:hi]).to(ctx.dev)
        A_t = a.data[ia].double().cpu().numpy()
        B_t = a.data[ib].double().cpu().numpy()
        want = np.einsum("tij,tjk->ik", A_t, B_t)
        tol = REL * float((np.linalg.norm(A_t, axis=(1, 2)) * np.linalg.norm(B_t, axis=(1, 2))).sum())
        err = float(np.abs(c.data[int(blk)].double().cpu().numpy() - want).max())
        check(err <= tol, f"multiply block {blk}: error {err} > tolerance {tol}")
        worst = max(worst, err / tol)
    bound = gemm_bound(T, bs, bs, bs, a.nnzb, a.nnzb, tasks.num_out, 4)
    out = dict(phase="multiply", n=n, half_bandwidth=hw, bs=bs, a_blocks=a.nnzb,
               a_gb=a.nnzb * bs * bs * 4 / 1e9, c_blocks=tasks.num_out,
               c_gb=tasks.num_out * bs * bs * 4 / 1e9, tasks=T, tflop=flops / 1e12,
               build_a_s=build_s, symbolic_s=cache.build_s, first_multiply_s=first_s,
               warm_multiply_s=warm_s, kernel_ms=kernel_ms,
               kernel_tflops=flops / (kernel_ms * 1e-3) / 1e12, **bound,
               max_memory_allocated=peak, launches=launches,
               sampled_blocks=int(min(64, tasks.num_out)), max_err_over_tol=worst)
    emit(out)
    return out


def _hamiltonian(n: int, nocc: int, seed: int):
    """Banded exponential-decay couplings plus a diagonal spread with a gap.

    Site energies: nocc of them (chosen at random) spread over [-2, -0.5],
    the rest over [0.5, 2]; couplings 0.3 exp(-0.5 |i - j|) x N(0, 1) for
    |i - j| <= 8, symmetrised.  S = I + 0.01 |H|.
    """
    import numpy as np

    rng = np.random.default_rng(seed)
    diag = np.empty(n)
    occ = rng.permutation(n)[:nocc]
    virt = np.setdiff1d(np.arange(n), occ)
    diag[occ] = rng.permutation(np.linspace(-2.0, -0.5, nocc))
    diag[virt] = rng.permutation(np.linspace(0.5, 2.0, n - nocc))
    h = np.zeros((n, n))
    i = np.arange(n)
    for d in range(1, 9):
        v = 0.3 * np.exp(-0.5 * d) * rng.standard_normal(n - d)
        h[i[:-d], i[d:]] = v
    h = (h + h.T) / 2 + np.diag(diag)
    s = np.eye(n) + 0.01 * np.abs(h)
    return h.astype(np.float32), s.astype(np.float32)


def phase_sp2(ctx, sizes) -> dict:
    import numpy as np

    torch = ctx.torch
    import repro_torch.core.spgemm as spgemm_mod
    from repro_torch.core import (BSMatrix, SymbolicCache, factorization_residual, inv_chol,
                                  multiply, sp2_purify)
    from repro_torch.kernels import block_spmm as bsp

    n, bs, nocc = sizes["sp2_n"], sizes["sp2_bs"], sizes["sp2_nocc"]
    h, s_dense = _hamiltonian(n, nocc, seed=7)
    f = BSMatrix.from_dense(h, bs, device=ctx.dev)
    s = BSMatrix.from_dense(s_dense, bs, device=ctx.dev)

    # count the multiplies with a non-empty task list, independently of the kernel
    numeric = spgemm_mod.spgemm_numeric
    nonempty = [0]

    def counting_numeric(a_data, b_data, tasks, **kw):
        nonempty[0] += tasks.num_tasks > 0
        return numeric(a_data, b_data, tasks, **kw)

    spgemm_mod.spgemm_numeric = counting_numeric
    bsp.launches = 0
    cache = SymbolicCache()
    t0 = time.perf_counter()
    z = inv_chol(s, cache=cache)
    resid = factorization_residual(s, z, cache=cache)
    ctx.sync()
    t1 = time.perf_counter()
    f_o = multiply(multiply(z.transpose(), f, cache=cache), z, cache=cache)
    # Gershgorin bounds from the blocks of F_o: diagonal +- off-diagonal |row| sums
    absrow = f_o.data.abs().sum(dim=2).double().cpu().numpy()  # [nnzb, bs]
    rows = (f_o.coords[:, 0, None] * bs + np.arange(bs)).ravel()
    rowsum = np.zeros(f_o.nblocks[0] * bs)
    np.add.at(rowsum, rows, absrow.ravel())
    diag = np.zeros_like(rowsum)
    on = np.nonzero(f_o.coords[:, 0] == f_o.coords[:, 1])[0]
    dblk = f_o.data[torch.from_numpy(on).to(ctx.dev)].diagonal(dim1=1, dim2=2).double().cpu().numpy()
    diag[(f_o.coords[on, 0, None] * bs + np.arange(bs)).ravel()] = dblk.ravel()
    radius = rowsum - np.abs(diag)
    lmin, lmax = float((diag - radius)[:n].min()), float((diag + radius)[:n].max())
    ctx.sync()
    t2 = time.perf_counter()
    d, stats = sp2_purify(f_o, nocc, lmin, lmax, idem_tol=1e-6, trunc_tau=1e-5, cache=cache)
    ctx.sync()
    t3 = time.perf_counter()
    spgemm_mod.spgemm_numeric = numeric
    launches, multiplies = bsp.launches, nonempty[0]
    expected = 0 if ctx.rehearse else multiplies
    check(launches == expected,
          f"kernel launches {launches} != non-empty multiplies {multiplies}")

    # checks: trace, idempotency, and D against a float64 eigendecomposition
    d64 = torch.from_numpy(d.to_dense()).to(ctx.dev, torch.float64)
    trace = float(d.data[torch.from_numpy(np.nonzero(d.coords[:, 0] == d.coords[:, 1])[0])
                         .to(ctx.dev)].double().diagonal(dim1=1, dim2=2).sum())
    idem = d64 @ d64 - d64
    fo64 = torch.from_numpy(f_o.to_dense()).to(ctx.dev, torch.float64)
    evals, evecs = torch.linalg.eigh(fo64)
    occ_vecs = evecs[:, :nocc]
    d_ref = occ_vecs @ occ_vecs.T
    out = dict(phase="sp2", n=n, bs=bs, nocc=nocc, lmin=lmin, lmax=lmax,
               homo_lumo_gap=float(evals[nocc] - evals[nocc - 1]),
               inv_chol_s=t1 - t0, factorization_residual=resid,
               congruence_and_bounds_s=t2 - t1, sp2_s=t3 - t2,
               iterations=stats.iterations, sp2_s_per_iteration=(t3 - t2) / stats.iterations,
               nnzb_history=stats.nnzb_history, d_blocks=d.nnzb,
               kernel_launches=launches, nonempty_multiplies=multiplies,
               trace_error=abs(trace - nocc),
               idempotency_fro=float(torch.linalg.matrix_norm(idem)),
               idempotency_max=float(idem.abs().max()),
               sp2_best_idempotency_fro=min(stats.idempotency_history),
               max_abs_d_minus_ref=float((d64 - d_ref).abs().max()))
    emit(out)
    check(out["trace_error"] <= 1e-3, "|trace(D) - nocc| > 1e-3")
    check(out["idempotency_max"] <= 1e-6, "max |D^2 - D| > 1e-6")
    check(out["max_abs_d_minus_ref"] <= 1e-4, "max |D - D_ref| > 1e-4")
    return out


def fused_task_norms(args):
    """||A_t||_F ||B_t||_F of every task slot [P, T] (float64, on the device)."""
    import torch as th

    a_store, a_recv, b_store, b_recv, a_src, a_off, b_src, b_off = args[:8]
    P = a_src.shape[0]

    def norms(store, recv, src, off):
        ns = th.linalg.matrix_norm(store.double())
        nr = th.linalg.matrix_norm(recv.double())
        p = th.arange(P, device=src.device)[:, None].expand_as(src)
        return th.where(src == 0, ns[p, off.clamp(max=ns.shape[1] - 1)],
                        nr[p, (src - 1).clamp(min=0), off.clamp(max=nr.shape[2] - 1)])

    return norms(a_store, a_recv, a_src, a_off) * norms(b_store, b_recv, b_src, b_off)


def run_sums(run_ptr, per):
    """Sum of a per-task value ``[P, T]`` over each output block's run ``[P, num_out]``."""
    import torch as th

    csum = th.cat([per.new_zeros(per.shape[0], 1), per.cumsum(1)], 1)
    return csum.gather(1, run_ptr[:, 1:]) - csum.gather(1, run_ptr[:, :-1])


def fused_bound(args, on=None):
    """Least time for the fused kernel on an H100: operations or bytes.

    Operations: 2*T*bm*bn*bk over the tasks that run, at the fp32 FFMA rate.
    Bytes: every distinct operand block the tasks reference (own store or
    receive buffer) read once, the four int64 task arrays and the runs, the
    on flags when given, and every output block written once in fp32.
    """
    import numpy as np

    a_store, a_recv, b_store, b_recv, a_src, a_off, b_src, b_off, run_ptr, num_out = args
    P, T = a_src.shape
    bm, bk, bn = a_store.shape[2], a_store.shape[3], b_store.shape[3]
    rp = run_ptr.cpu().numpy()
    live = np.arange(T)[None] < rp[:, -1:]
    if on is not None:
        live &= on.cpu().numpy()
    n_tasks = int(live.sum())
    p = np.nonzero(live)[0]

    def distinct(src, off):
        s, o = src.cpu().numpy()[live], off.cpu().numpy()[live]
        return np.unique(np.stack([p, s, o], 1), axis=0).shape[0]

    isz = a_store.element_size()
    nbytes = ((distinct(a_src, a_off) * bm * bk + distinct(b_src, b_off) * bk * bn) * isz
              + 8 * (4 * P * T + P * (num_out + 1)) + (P * T if on is not None else 0)
              + 4 * P * num_out * bm * bn)
    ops = 2.0 * n_tasks * bm * bn * bk
    t_ops, t_bytes = ops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return dict(tasks=n_tasks, bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_arithmetic=(f"max({ops:.6g} op / 67e12 op/s = {t_ops * 1e3:.4f} ms, "
                                  f"{nbytes} B / 3.35e12 B/s = {t_bytes * 1e3:.4f} ms)"))


def phase_fused_kernel(ctx, sizes) -> dict:
    import numpy as np

    torch = ctx.torch
    from repro_torch.core.distributed import (FusedSpgemmExecutable, MaskedSpgemmExecutable,
                                              SpgemmExecutable, WorkerMesh, shard_stores)
    from repro_torch.core.schedule import make_spgemm_plan
    from repro_torch.kernels import fused_leaf as fl
    from repro_torch.kernels.precision import BF16, FP32

    kernel = fl.fused_block_spmm_ref if ctx.rehearse else fl.fused_block_spmm_cuda
    staged_impl = "ref" if ctx.rehearse else "kernel"
    rng = np.random.default_rng(2)
    gen = torch.Generator(device=ctx.dev).manual_seed(3)
    mbs, P = sizes["mul_bs"], sizes["fused_p"]

    def band_plan(n, hw, bs, nparts):
        coords = band_coords(-(-n // bs), (hw + bs - 1) // bs)
        plan = make_spgemm_plan(coords, coords, nparts, bs)
        data = torch.randn((coords.shape[0], bs, bs), generator=gen, device=ctx.dev)
        return plan, data

    def plan_args(plan, data, precision=FP32):
        """The kernel's arguments as the fused executable launches them on the plan."""
        exe = FusedSpgemmExecutable(plan, WorkerMesh(plan.nparts, ctx.dev), precision=precision)
        return exe.kernel_args(*shard_stores(plan, data, data))

    t0 = time.perf_counter()
    plan, data = band_plan(sizes["time_n"], sizes["mul_hw"], mbs, P)
    plan_s = time.perf_counter() - t0
    valid = np.arange(plan.t_cap)[None] < plan.task_count[:, None]
    f32 = plan_args(plan, data)
    low = torch.from_numpy(rng.random(valid.shape) < 0.5).to(ctx.dev)
    on_np = (rng.random(valid.shape) >= 0.3) & valid
    on = torch.from_numpy(on_np).to(ctx.dev)
    plan24, data24 = band_plan(sizes["r24_n"], sizes["r24_hw"], 24, 4)
    plan1, data1 = band_plan(sizes["small_n"], sizes["mul_hw"], mbs, 1)
    t0 = time.perf_counter()
    plan64, data64 = band_plan(sizes["time_n"], sizes["mul_hw"], 64, P)
    plan64_s = time.perf_counter() - t0
    f64 = plan_args(plan64, data64)

    # runs with empty rows (3, 17 and the last) on 3 workers, random operands
    def empty_runs_case():
        num_out, T, cap, R, cu = 64, 400, 40, 2, 30
        rows = np.setdiff1d(np.arange(num_out), (3, 17, num_out - 1))
        c = np.sort(rng.choice(rows, (3, T)), axis=1)
        src = [rng.integers(0, R + 1, (3, T)) for _ in range(2)]
        off = [np.where(s == 0, rng.integers(0, cap, (3, T)), rng.integers(0, cu, (3, T))) for s in src]
        up = lambda x: torch.from_numpy(np.asarray(x, np.int64)).to(ctx.dev)  # noqa: E731
        r = lambda *sh: torch.randn(sh, generator=gen, device=ctx.dev)  # noqa: E731
        from repro_torch.kernels.fused_leaf import fused_task_runs
        return (r(3, cap, mbs, mbs), r(3, R, cu, mbs, mbs), r(3, cap, mbs, mbs), r(3, R, cu, mbs, mbs),
                up(src[0]), up(off[0]), up(src[1]), up(off[1]), up(fused_task_runs(c, num_out)), num_out)

    cases = [
        (f"band_p{P}_bs{mbs}_f32", f32, {}),
        (f"band_p{P}_bs{mbs}_bf16", plan_args(plan, data, BF16), {}),
        (f"band_p{P}_bs{mbs}_adaptive", f32, dict(low=low, adaptive=True)),
        (f"band_p{P}_bs{mbs}_masked30", f32, dict(on=on)),
        ("band_p4_bs24_f32", plan_args(plan24, data24), {}),
        (f"band_p1_bs{mbs}_no_rounds", plan_args(plan1, data1), {}),
        (f"random_p3_bs{mbs}_empty_runs", empty_runs_case(), {}),
        (f"band_p{P}_bs64_f32", f64, {}),
    ]
    results, outs = [], {}
    for name, args, kw in cases:
        got = kernel(*args, **kw)
        again = kernel(*args, **kw)
        want = fl.fused_block_spmm_ref(*args, **kw)
        ctx.sync()
        identical = bool(torch.equal(got, again))
        err = (got - want).abs().flatten(2).amax(dim=2).double()
        norms = fused_task_norms(args)
        if "on" in kw:
            norms = norms * kw["on"]
        # the plain version rounds the same elements with the same cast, so
        # every mode differs from it only in the order of the fp32 sums
        tol = run_sums(args[8], REL * norms)
        rp = args[8].cpu().numpy()
        empty = torch.from_numpy(np.diff(rp, axis=1) == 0).to(ctx.dev)
        empty_rows_zero = bool(not got[empty].any())
        row = dict(case=name, dtype=str(args[0].dtype).replace("torch.", ""), bs=args[0].shape[2],
                   workers=args[0].shape[0], rounds=(args[1].shape[1] if args[1].shape[2] > 1 else 0),
                   task_slots=int(args[4].numel()), num_out=args[9],
                   max_abs_err=float(err.max()),
                   max_err_over_tol=float((err / tol.clamp_min(1e-300)).max()),
                   bit_identical_on_repeat=identical, empty_rows_zero=empty_rows_zero,
                   empty_rows=int(empty.sum()))
        check(identical, f"{name}: fused kernel output differs between two launches")
        check(bool((err <= tol).all()), f"{name}: fused kernel disagrees with the plain version")
        check(empty_rows_zero, f"{name}: rows without tasks are not zero")
        if kw.get("adaptive"):
            # the low flags act: the kernel lies far nearer the rounded plain
            # version than the rounding moves it, and within the analytic
            # bf16 bound (2u + u^2) of the unrounded fp32 product
            unrounded = fl.fused_block_spmm_ref(*args)
            shift = float((want - unrounded).abs().max())
            vs_fp32 = (got - unrounded).abs().flatten(2).amax(dim=2).double()
            bound = tol + run_sums(args[8], ROUND2_BOUND * norms * kw["low"])
            row.update(rounding_shift=shift, max_err_over_rounding_shift=float(err.max()) / shift,
                       round2_bound_max=float(bound.max()), output_abs_max=float(got.abs().max()),
                       vs_fp32_over_round2_bound=float((vs_fp32 / bound.clamp_min(1e-300)).max()))
            check(shift > 0 and float(err.max()) <= shift / 8,
                  f"{name}: kernel error {float(err.max())} against a rounding shift of {shift}")
            check(bool((vs_fp32 <= bound).all()), f"{name}: beyond the bf16 rounding bound of the fp32 product")
            del unrounded
        results.append(row)
        outs[name] = got

    # fp32 fused == staged path (concatenated buffers + block_spmm), bit for bit;
    # masked with every task on == unmasked; masked == staged with off tasks dropped
    mesh = WorkerMesh(P, ctx.dev)
    a_store, b_store = f32[0], f32[2]
    staged = SpgemmExecutable(plan, mesh, impl=staged_impl)(a_store, b_store)
    staged_masked = MaskedSpgemmExecutable(plan, mesh, impl=staged_impl)(a_store, b_store, on_np)
    all_on = kernel(*f32, on=torch.from_numpy(valid).to(ctx.dev))
    ctx.sync()
    fused_eq_staged = bool(torch.equal(outs[cases[0][0]], staged))
    masked_eq_staged = bool(torch.equal(outs[cases[3][0]], staged_masked))
    all_on_eq = bool(torch.equal(all_on, outs[cases[0][0]]))
    check(fused_eq_staged, "fp32 fused kernel is not bit-identical to the staged path")
    check(masked_eq_staged, "masked fused kernel is not bit-identical to the staged path without the off tasks")
    check(all_on_eq, "masked fused kernel with every task on differs from the unmasked kernel")
    small = fused_small_block_case(ctx, plan64, f64, outs[f"band_p{P}_bs64_f32"], mesh, staged_impl)
    small["plan_s"] = plan64_s
    del staged, staged_masked, all_on, outs, f64

    # timing: the fp32 case, the plain version, and torch.bmm on pre-gathered operands
    ms = ctx.time_ms(lambda: kernel(*f32), reps=10)
    plain_ms = ctx.time_ms(lambda: fl.fused_block_spmm_ref(*f32), reps=3)
    p_idx, t_idx = torch.nonzero(torch.from_numpy(valid).to(ctx.dev), as_tuple=True)
    lhs = fl._gather(f32[0], f32[1], p_idx, f32[4][p_idx, t_idx], f32[5][p_idx, t_idx])
    rhs = fl._gather(f32[2], f32[3], p_idx, f32[6][p_idx, t_idx], f32[7][p_idx, t_idx])
    bmm_ms = ctx.time_ms(lambda: torch.bmm(lhs, rhs), reps=10)
    del lhs, rhs
    bound = fused_bound(f32)
    tpw = plan.task_count
    timing = dict(case=cases[0][0], ms=ms, plain_ms=plain_ms, bmm_yardstick_ms=bmm_ms,
                  bmm_yardstick="torch.bmm on the pre-gathered operands: the products only, no gather, no sum",
                  tflops=2.0 * bound["tasks"] * mbs**3 / (ms * 1e-3) / 1e12, **bound)
    out = dict(phase="fused_kernel", plan_s=plan_s, a_offsets=list(plan.a_offsets),
               b_offsets=list(plan.b_offsets), tasks_per_worker_min=int(tpw.min()),
               tasks_per_worker_max=int(tpw.max()), masked_share=float(1 - on_np.sum() / valid.sum()),
               low_share=float(low.cpu().numpy()[valid].mean()), cases=results,
               fused_eq_staged=fused_eq_staged, masked_eq_staged=masked_eq_staged,
               masked_all_on_eq_unmasked=all_on_eq, timing=timing, small_block=small)
    emit(out)
    return out


def fused_small_block_case(ctx, plan, args, got, mesh, staged_impl) -> dict:
    """The fused kernel at bs 64 (the N = 8192 band planned for the fused
    phase's workers): the rule's engine (TileRows) == Tile64 forced == the
    staged path (concatenated buffers + ``block_spmm``), bit for bit; timed
    beside Tile64, the plain version and ``torch.bmm`` on pre-gathered operands."""
    import numpy as np

    torch = ctx.torch
    from repro_torch.core.distributed import SpgemmExecutable
    from repro_torch.kernels import block_spmm as bsp
    from repro_torch.kernels import fused_leaf as fl

    kernel = fl.fused_block_spmm_ref if ctx.rehearse else fl.fused_block_spmm_cuda
    tile64 = gemm_engine(ctx, fl, "tile64")
    bs = args[0].shape[2]
    name = f"band_p{args[0].shape[0]}_bs{bs}_f32"
    old = tile64(*args)
    staged = SpgemmExecutable(plan, mesh, impl=staged_impl)(args[0], args[2])
    ctx.sync()
    same, eq_staged = bool(torch.equal(got, old)), bool(torch.equal(got, staged))
    del old, staged
    check(same, f"{name}: fused TileRows and Tile64 differ")
    check(eq_staged, f"{name}: fused kernel is not bit-identical to the staged path")
    row = dict(case=name, bs=bs, engine=bsp.tile_engine(bs, bs, bs, args[:4]), pack=bsp.rows_pack(bs, bs),
               bit_identical_to_tile64=same, fused_eq_staged=eq_staged)
    row["ms"] = ctx.time_ms(lambda: kernel(*args), reps=5)
    row["tile64_ms"] = ctx.time_ms(lambda: tile64(*args), reps=3)
    row["plain_ms"] = ctx.time_ms(lambda: fl.fused_block_spmm_ref(*args), reps=2)
    valid = np.arange(plan.t_cap)[None] < plan.task_count[:, None]
    p_idx, t_idx = torch.nonzero(torch.from_numpy(valid).to(ctx.dev), as_tuple=True)
    lhs = fl._gather(args[0], args[1], p_idx, args[4][p_idx, t_idx], args[5][p_idx, t_idx])
    rhs = fl._gather(args[2], args[3], p_idx, args[6][p_idx, t_idx], args[7][p_idx, t_idx])
    row["bmm_yardstick_ms"] = ctx.time_ms(lambda: torch.bmm(lhs, rhs), reps=5)
    del lhs, rhs
    row.update(fused_bound(args))
    row.update(tflops=2.0 * row["tasks"] * bs**3 / (row["ms"] * 1e-3) / 1e12,
               speedup_over_tile64=row["tile64_ms"] / row["ms"], bound_share=row["bound_ms"] / row["ms"])
    return row


def dense_on_device(m, dtype):
    """The dense matrix of a BSMatrix, built on its device."""
    import torch as th

    nbr, nbc = m.nblocks
    grid = th.zeros((nbr, nbc, m.bs, m.bs), dtype=dtype, device=m.device)
    if m.nnzb:
        c = th.from_numpy(m.coords).to(m.device)
        grid[c[:, 0], c[:, 1]] = m.data.to(dtype)
    return grid.permute(0, 2, 1, 3).reshape(nbr * m.bs, nbc * m.bs)[: m.shape[0], : m.shape[1]]


def phase_dist_multiply(ctx, sizes) -> dict:
    import numpy as np

    torch = ctx.torch
    from repro_torch.core import multiply
    from repro_torch.core.distributed import make_worker_mesh
    from repro_torch.core.schedule import plan_worker_bytes
    from repro_torch.dist import PlanCache, dist_multiply, scatter
    from repro_torch.kernels import fused_leaf as fl
    from repro_torch.kernels import ops

    n, hw, bs, P = sizes["dist_n"], sizes["mul_hw"], sizes["mul_bs"], sizes["dist_p"]
    a = banded_matrix(ctx, n, hw, bs, seed=200)
    mesh = make_worker_mesh(P, ctx.dev)
    t0 = time.perf_counter()
    d = scatter(a, mesh)
    ctx.sync()
    scatter_s = time.perf_counter() - t0
    if ctx.dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cache = PlanCache()
    expected = 0 if ctx.rehearse else 1
    fl.launches = 0  # the main path's count starts here
    t0 = time.perf_counter()
    c = dist_multiply(d, d, cache)
    ctx.sync()
    cold_s = time.perf_counter() - t0
    cold = (fl.launches, cache.hits, cache.misses)
    del c
    t0 = time.perf_counter()
    c = dist_multiply(d, d, cache)
    ctx.sync()
    warm_s = time.perf_counter() - t0
    launches = fl.launches  # ... and is read here
    warm = (launches - cold[0], cache.hits - cold[1], cache.misses - cold[2])
    check(cold == (expected, 0, 1), f"cold dist_multiply: (launches, hits, misses) = {cold}")
    check(warm == (expected, 1, 0), f"warm dist_multiply: (launches, hits, misses) = {warm}")
    peak = torch.cuda.max_memory_allocated() if ctx.dev.type == "cuda" else None
    plan, exe = cache.peek(cache.last_plan_key)
    T = plan.tasks.num_tasks
    flops = 2.0 * T * bs**3

    # exchange and kernel alone (CUDA events), on the resident stores
    exchange_ms = ctx.time_ms(lambda: exe.kernel_args(d.store, d.store), reps=3)
    args = exe.kernel_args(d.store, d.store)
    kernel_ms = ctx.time_ms(lambda: ops.fused_block_spmm(*args), reps=2)
    bound = fused_bound(args)
    bound.pop("tasks")
    del args

    # gather, then the single-device multiply of the same matrix: bit for bit
    g = c.gather()
    del c
    if ctx.dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    single = multiply(a, a)
    ctx.sync()
    single_s = time.perf_counter() - t0
    same_coords = bool(np.array_equal(single.coords, g.coords))
    identical = same_coords and bool(torch.equal(single.data, g.data))
    check(identical, "dist_multiply is not bit-identical to the single-device multiply")
    del single

    # 64 sampled output blocks against float64 host products
    tasks = plan.tasks
    run_ptr = np.searchsorted(tasks.c_idx, np.arange(tasks.num_out + 1))
    rng = np.random.default_rng(6)
    worst = 0.0
    for blk in rng.choice(tasks.num_out, size=min(64, tasks.num_out), replace=False):
        lo, hi = run_ptr[blk], run_ptr[blk + 1]
        A_t = a.data[torch.from_numpy(tasks.a_idx[lo:hi]).to(ctx.dev)].double().cpu().numpy()
        B_t = a.data[torch.from_numpy(tasks.b_idx[lo:hi]).to(ctx.dev)].double().cpu().numpy()
        want = np.einsum("tij,tjk->ik", A_t, B_t)
        tol = REL * float((np.linalg.norm(A_t, axis=(1, 2)) * np.linalg.norm(B_t, axis=(1, 2))).sum())
        err = float(np.abs(g.data[int(blk)].double().cpu().numpy() - want).max())
        check(err <= tol, f"dist_multiply block {blk}: error {err} > tolerance {tol}")
        worst = max(worst, err / tol)
    recv, send, padded = plan_worker_bytes(plan)
    out = dict(phase="dist_multiply", n=n, half_bandwidth=hw, bs=bs, workers=P,
               a_blocks=a.nnzb, a_gb=a.nnzb * bs * bs * 4 / 1e9, tasks=T, tflop=flops / 1e12,
               a_offsets=list(plan.a_offsets), b_offsets=list(plan.b_offsets),
               a_send_caps=[int(plan.a_send[x].shape[1]) for x in plan.a_offsets],
               b_send_caps=[int(plan.b_send[x].shape[1]) for x in plan.b_offsets],
               c_cap=plan.c_cap, c_store_gb=P * plan.c_cap * bs * bs * 4 / 1e9,
               tasks_per_worker=plan.task_count.tolist(),
               scatter_s=scatter_s, plan_build_s=cache.build_s, verify_s=cache.verify_s,
               plans_verified=cache.plans_verified, first_call_s=cold_s,
               warm_call_s=warm_s, exchange_ms=exchange_ms, kernel_ms=kernel_ms,
               kernel_tflops=flops / (kernel_ms * 1e-3) / 1e12, **bound,
               exchanged_bytes=float(recv.sum()), exchanged_bytes_padded=float(padded.sum()),
               max_memory_allocated=peak, launches=launches,
               cache=dict(hits=cache.hits, misses=cache.misses),
               single_device_multiply_s=single_s, bit_identical_to_multiply=identical,
               sampled_blocks=int(min(64, tasks.num_out)), max_err_over_tol=worst)
    emit(out)
    return out


def phase_weak_scaling(ctx, sizes) -> dict:
    """The largest Table 1 band row that fits one card (``benchmarks/
    torch_weak_scaling.py``'s ``--card`` row: N = 400,000, half-bandwidth
    3000, 8 workers sharing the card, bs 128) through ``scatter`` ->
    ``dist_multiply`` cold and warm: sampled output blocks against float64
    products, one fused launch a call, peak memory under the card's 80 GB."""
    torch = ctx.torch
    sys.path.insert(0, str(ROOT / "benchmarks"))
    import torch_weak_scaling as tws
    from repro_torch.kernels import fused_leaf as fl

    w = sizes["weak_scaling"]
    if ctx.dev.type == "cuda":
        torch.cuda.empty_cache()
    fl.launches = 0  # the main path's count starts here, and is read inside
    row = tws.table1_row(ctx.dev, w["n"], w["hw"], w["bs"], w["workers"])
    launches = row["fused_launches"]  # the two calls' launches, not the timing runs'
    expected = 0 if ctx.rehearse else 2
    check(launches == expected, f"weak_scaling: {launches} fused launches, expected {expected}")
    check(row["max_err_over_tol"] <= 1.0, f"weak_scaling: error {row['max_err_over_tol']}x its limit")
    peak = row["max_memory_allocated"]
    check(peak is None or peak < 80e9, f"weak_scaling: peak {peak} bytes")
    out = dict(phase="weak_scaling", card=ctx.card, table1_row=w.get("table1_row"), **row,
               launches=launches)
    emit(out)
    return out


def phase_dist_spamm(ctx, sizes) -> dict:
    import numpy as np

    torch = ctx.torch
    from repro_torch.core import BSMatrix, spgemm_symbolic
    from repro_torch.core.distributed import make_worker_mesh
    from repro_torch.dist import PlanCache, dist_multiply, dist_spamm, scatter
    from repro_torch.kernels import fused_leaf as fl
    from repro_torch.kernels.precision import BF16, Precision

    n, bs, P = sizes["spamm_n"], sizes["mul_bs"], sizes["spamm_p"]
    # exponential off-diagonal decay, a_ij = z_ij exp(-0.01 |i - j|), blocks
    # of Frobenius norm <= 1e-6 dropped (the electronic-structure regime)
    gen = torch.Generator(device=ctx.dev).manual_seed(11)
    i = torch.arange(n, device=ctx.dev, dtype=torch.float32)
    dense = torch.randn((n, n), generator=gen, device=ctx.dev) * torch.exp(-0.01 * (i[:, None] - i[None, :]).abs())
    a = BSMatrix.from_dense(dense.cpu().numpy(), bs, prune_tol=1e-6, device=ctx.dev)
    a64 = dense_on_device(a, torch.float64)
    exact = a64 @ a64
    a16 = a64.float().to(torch.bfloat16).double()
    exact_bf16 = a16 @ a16
    del dense, a64, a16
    d = scatter(a, make_worker_mesh(P, ctx.dev))
    cache = PlanCache()
    fro = a.frobenius_norm()
    # the unpruned product, each block within REL * sum_t ||A_t|| ||B_t|| of
    # the float64 product: a limit computed from A alone
    full = dist_multiply(d, d, cache).gather()
    full_tasks = int(cache.last_task_count.sum())
    tasks = spgemm_symbolic(a.coords, a.coords)
    na = torch.linalg.matrix_norm(a.data.double()).cpu().numpy()
    tol = REL * np.bincount(tasks.c_idx, weights=na[tasks.a_idx] * na[tasks.b_idx],
                            minlength=tasks.num_out)
    check(np.array_equal(full.coords, tasks.c_coords), "dist_multiply: output structure differs")
    nb = -(-n // bs)
    grid = torch.nn.functional.pad(exact, (0, nb * bs - n, 0, nb * bs - n))
    grid = grid.reshape(nb, bs, nb, bs).permute(0, 2, 1, 3)
    cc = torch.from_numpy(full.coords).to(ctx.dev)
    full_err = (full.data.double() - grid[cc[:, 0], cc[:, 1]]).abs().amax(dim=(1, 2)).cpu().numpy()
    check(bool((full_err <= tol).all()), "unpruned dist_multiply beyond its fp32 tolerance")
    rounding = float(torch.linalg.matrix_norm(dense_on_device(full, torch.float64) - exact))
    del full, grid
    expected = 0 if ctx.rehearse else 1
    fl.launches = 0  # the main path's count starts here
    rows, calls = [], 0
    for tau_rel in (1e-4, 1e-3):
        for name, prec in (("fp32", None), ("bf16", BF16), ("adaptive", Precision("adaptive"))):
            h0, m0 = cache.hits, cache.misses
            t0 = time.perf_counter()
            c, err = dist_spamm(d, d, tau_rel * fro, cache, precision=prec)
            ctx.sync()
            secs = time.perf_counter() - t0
            calls += 1
            exe = cache.peek(cache.last_plan_key)[1]
            kept = int(cache.last_task_count.sum())
            ref = exact_bf16 if name == "bf16" else exact
            true_err = float(torch.linalg.matrix_norm(dense_on_device(c.gather(), torch.float64) - ref))
            del c
            row = dict(tau_rel=tau_rel, tau=tau_rel * fro, precision=name, seconds=secs,
                       err_bound=err, true_err=true_err, true_err_over_bound=true_err / err,
                       kept_tasks=kept, full_tasks=full_tasks, pruned_share=1 - kept / full_tasks,
                       cache_hits=cache.hits - h0, cache_misses=cache.misses - m0,
                       last_exchange=exe.last_exchange)
            rows.append(row)
            check(true_err <= err, f"SpAMM {name} tau {tau_rel}: ||A A - C||_F {true_err} > bound {err}")
            check(0 < row["pruned_share"] < 1, f"SpAMM {name} tau {tau_rel}: pruned share {row['pruned_share']}")
            if tau_rel == 1e-3:
                check(row["cache_misses"] == 0, f"SpAMM {name}: the second tau missed the plan cache")
    launches = fl.launches  # ... and is read here
    check(launches == expected * calls, f"dist_spamm: {launches} fused launches for {calls} calls")
    out = dict(phase="dist_spamm", n=n, bs=bs, workers=P, a_blocks=a.nnzb, fro_norm=fro,
               fp32_rounding_of_full_product=rounding,
               full_product_max_err_over_tol=float((full_err / tol).max()),
               frobenius_fp32_allowance=bs * float(tol.sum()), calls=calls, launches=launches, rows=rows,
               cache=dict(hits=cache.hits, misses=cache.misses))
    emit(out)
    return out


def _skewed_owner(nnzb: int, nparts: int):
    """The first half of the Morton order on worker 0, the rest Morton-cut over the others."""
    import numpy as np
    from repro_torch.core.schedule import partition_morton

    half = nnzb // 2
    return np.concatenate([np.zeros(half, np.int32),
                           partition_morton(nnzb - half, nparts - 1).astype(np.int32) + 1])


def phase_dist_pipeline(ctx, sizes) -> dict:
    """S -> Z -> Z^T H Z -> SP2 -> Z D Z^T resident on 8 workers (the paper's workload).

    Static Morton layout first, then the same matrices scattered skewed and
    run with ``rebalance=``: D must come out bit for bit the same.  Stage
    seconds come from wrappers that synchronise the card at each stage's
    edges (the drivers themselves only wait where a scalar crosses).
    """
    import numpy as np

    torch = ctx.torch
    import repro_torch.core.distributed as cdist
    import repro_torch.dist.inverse as inv_mod
    import repro_torch.dist.purify as pur
    from repro_torch.core import BSMatrix
    from repro_torch.core.distributed import make_worker_mesh
    from repro_torch.dist import PlanCache, RebalancePolicy, scatter
    from repro_torch.kernels import fused_leaf as fl
    from repro_torch.obs.timing import IterationScope

    n, bs, nocc, P = sizes["sp2_n"], sizes["sp2_bs"], sizes["sp2_nocc"], sizes["pipe_p"]
    h, s_dense = _hamiltonian(n, nocc, seed=7)
    mesh = make_worker_mesh(P, ctx.dev)
    H = BSMatrix.from_dense(h, bs, device=ctx.dev)
    S = BSMatrix.from_dense(s_dense, bs, device=ctx.dev)
    kw = dict(trunc_tau=1e-5, idem_tol=1e-6)

    # resident multiplies counted independently of the kernel, and by whether
    # their plan holds a task
    marks, calls = {}, [0, 0]
    real_run = cdist.FusedSpgemmExecutable._run

    def counting_run(self, *a, **k):
        calls[0] += 1
        calls[1] += self.plan.tasks.num_tasks > 0
        return real_run(self, *a, **k)

    def synced(name, fn):
        def wrapped(*a, **k):
            ctx.sync()
            marks[name] = [time.perf_counter()]
            out = fn(*a, **k)
            ctx.sync()
            marks[name].append(time.perf_counter())
            return out
        return wrapped

    class SyncedScope(IterationScope):
        def delta(self):
            ctx.sync()
            return super().delta()

    patches = [(cdist.FusedSpgemmExecutable, "_run", counting_run),
               (pur, "dist_localized_inverse_factorization",
                synced("inverse", pur.dist_localized_inverse_factorization)),
               (pur, "dist_sp2_purify", synced("sp2", pur.dist_sp2_purify)),
               (pur, "IterationScope", SyncedScope), (inv_mod, "IterationScope", SyncedScope)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]

    def run(owner, rebalance):
        calls[0] = calls[1] = 0
        cache = PlanCache()
        ds, dh = scatter(S, mesh, owner=owner), scatter(H, mesh, owner=owner)
        fl.launches = 0  # the main path's count starts here
        ctx.sync()
        t0 = time.perf_counter()
        d, st = pur.dist_sqrt_inv_pipeline(ds, dh, nocc, cache=cache, rebalance=rebalance, **kw)
        ctx.sync()
        total = time.perf_counter() - t0
        launches = fl.launches  # ... and is read here
        inv_s = marks["inverse"][1] - marks["inverse"][0]
        sp2_s = marks["sp2"][1] - marks["sp2"][0]
        rows = st.inverse.per_iter + st.purify.per_iter
        stages = dict(inverse_s=inv_s, congruence_s=st.congruence["wall_s"],
                      spectral_bounds_s=marks["sp2"][0] - marks["inverse"][1] - st.congruence["wall_s"],
                      sp2_s=sp2_s, back_transform_s=st.back_transform["wall_s"],
                      gather_s=t0 + total - marks["sp2"][1] - st.back_transform["wall_s"])
        imb = [r["imbalance"] for r in rows if r["imbalance"] is not None]
        refine_s = sum(r["wall_s"] for r in st.inverse.per_iter)
        info = dict(seconds=total, **stages, inv_chol_s=inv_s - refine_s, refinement_s=refine_s,
                    refinement_iterations=st.inverse.iterations,
                    refinement_stop=st.inverse.stop_reason,
                    factorization_residual=st.inverse.factorization_residual,
                    residual_history=st.inverse.residual_history,
                    sp2_iterations=st.purify.iterations,
                    sp2_s_per_iteration=sp2_s / st.purify.iterations,
                    sp2_nnzb_history=st.purify.nnzb_history, bounds=list(st.bounds),
                    plan_build_s=cache.build_s, verify_s=cache.verify_s,
                    symbolic_s=cache.symbolic_s,
                    cache=dict(hits=cache.hits, misses=cache.misses),
                    zero_miss_iterations=dict(
                        refinement=sum(r["cache_misses"] == 0 for r in st.inverse.per_iter),
                        sp2=sum(r["cache_misses"] == 0 for r in st.purify.per_iter)),
                    resident_multiplies=calls[0], nonempty_multiplies=calls[1],
                    fused_launches=launches,
                    imbalance_mean=float(np.mean(imb)), imbalance_max=float(np.max(imb)),
                    imbalance_first=imb[0],
                    rebalances=st.inverse.rebalances + st.purify.rebalances,
                    migrated_bytes=int(sum(r["migrated_bytes"] for r in rows)),
                    d_blocks=d.nnzb)
        expected = 0 if ctx.rehearse else calls[1]
        check(launches == expected and calls[0] == calls[1],
              f"fused launches {launches}, resident multiplies {calls[0]}, non-empty {calls[1]}")
        return d, info

    for obj, name, value in patches:
        setattr(obj, name, value)
    try:
        d, static = run(None, None)
        ctx.pipeline_d = d  # the observatory phase holds its D to this one, bit for bit
        skew = _skewed_owner(S.nnzb, P)
        d_reb, rebalanced = run(skew, RebalancePolicy())
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)
    identical = (np.array_equal(d.coords, d_reb.coords) and bool(torch.equal(d.data, d_reb.data)))
    check(identical, "the rebalanced pipeline's D is not bit-identical to the static run's")
    check(rebalanced["rebalances"] >= 1 or rebalanced["migrated_bytes"] > 0,
          "the rebalanced run re-laid nothing out")
    resid, stop = static["factorization_residual"], static["refinement_stop"]
    check(stop in ("converged", "stalled"), f"refinement stopped: {stop}")

    # accuracy: M = L^T D L is the density matrix in the orthonormal basis L^-T
    s64 = torch.from_numpy(s_dense).to(ctx.dev, torch.float64)
    h64 = torch.from_numpy(h).to(ctx.dev, torch.float64)
    L = torch.linalg.cholesky(s64)
    m = L.T @ dense_on_device(d, torch.float64) @ L
    li = torch.linalg.solve_triangular(L, torch.eye(n, dtype=torch.float64, device=ctx.dev),
                                       upper=False)
    evals, evecs = torch.linalg.eigh(li @ h64 @ li.T)
    occ = evecs[:, :nocc]
    out = dict(phase="dist_pipeline", n=n, bs=bs, nocc=nocc, workers=P, **kw,
               tol=1e-8, s_blocks=S.nnzb, h_blocks=H.nnzb,
               homo_lumo_gap=float(evals[nocc] - evals[nocc - 1]),
               trace_error=abs(float(torch.trace(m)) - nocc),
               idempotency_max=float((m @ m - m).abs().max()),
               max_abs_m_minus_ref=float((m - occ @ occ.T).abs().max()),
               static=static, rebalanced=rebalanced, skew="first half of the Morton order on worker 0",
               rebalanced_bit_identical=identical,
               launches=static["fused_launches"] + rebalanced["fused_launches"])
    emit(out)
    check(out["trace_error"] <= 1e-3, "|trace(L^T D L) - nocc| > 1e-3")
    check(out["idempotency_max"] <= 1e-6, "max |M^2 - M| > 1e-6")
    check(out["max_abs_m_minus_ref"] <= 1e-4, "max |M - V_occ V_occ^T| > 1e-4")
    return out


def random_blocks_coords(n: int, bs: int, hw: int, block: int, seed: int = 0):
    """Block structure of ``benchmarks/weak_scaling.py``'s ``random`` family with one block.

    The band ``|I - J| <= ceil(hw / bs)`` of ``_band_block_coords`` plus the
    blocks of one dense ``block x block`` square on the diagonal, placed as
    ``_random_block_starts(n, block, 1, seed)`` places it, Morton-sorted.  The
    formulas are copied here because that benchmark imports the JAX package.
    """
    import numpy as np
    from repro_torch.core.quadtree import morton_sort

    nb = -(-n // bs)
    band = band_coords(nb, -(-hw // bs))
    gaps = np.random.default_rng(seed).multinomial(n - block, np.ones(2) / 2)
    b0, sb = int(gaps[0]) // bs, -(-block // bs)
    r = np.arange(b0, min(b0 + sb + 1, nb))
    square = np.stack(np.meshgrid(r, r, indexing="ij"), -1).reshape(-1, 2)
    codes = np.unique(np.concatenate([band[:, 0] * nb + band[:, 1], square[:, 0] * nb + square[:, 1]]))
    coords = np.stack([codes // nb, codes % nb], 1).astype(np.int64)
    return coords[morton_sort(coords)]


def max_block_excess(got, want, tol, chunk: int = 4096) -> float:
    """max over blocks of ``max|got - want| / tol`` (both ``[n, bs, bs]`` on one device), in chunks."""
    worst = 0.0
    for k in range(0, got.shape[0], chunk):
        err = (got[k:k + chunk].double() - want[k:k + chunk].double()).abs().amax(dim=(1, 2))
        worst = max(worst, float((err / tol[k:k + chunk]).max()))
    return worst


def phase_dist_outer(ctx, sizes) -> dict:
    """The outer-product schedule on the paper's poor-locality case.

    Table 1 row 1's random-blocks structure (N = 100,000, band half-width
    3000, one dense block of 15,716) on Table 1 row 1's 2 workers at leaf
    128, random block values from a seed: ``choose_schedule`` must pick the
    outer schedule; ``dist_spgemm_outer`` (one ``block_spmm`` launch for both
    workers) is held per block against the resident p2p ``dist_multiply`` of
    the same operands; two outer calls must agree bit for bit.  Then the
    N = 8192 band on 8 workers, where the partials travel several offsets,
    against the outer multiply's plain version element for element.
    """
    import numpy as np

    torch = ctx.torch
    import repro_torch.core.outer as outer
    from repro_torch.core import BSMatrix
    from repro_torch.core.distributed import (OuterSpgemmExecutable, dist_spgemm_outer,
                                              make_worker_mesh, shard_stores, unshard_result)
    from repro_torch.core.schedule import plan_stats
    from repro_torch.core.spgemm import spgemm_symbolic
    from repro_torch.dist import PlanCache, dist_multiply, scatter
    from repro_torch.kernels import block_spmm as bsp
    from repro_torch.kernels import ops

    cfg = sizes["outer"]
    n, bs, P = cfg["n"], cfg["bs"], cfg["p"]
    coords = random_blocks_coords(n, bs, cfg["hw"], cfg["block"])
    gen = torch.Generator(device=ctx.dev).manual_seed(300)
    a = BSMatrix(shape=(n, n), bs=bs, coords=coords,
                 data=torch.randn((coords.shape[0], bs, bs), generator=gen, device=ctx.dev))
    mesh = make_worker_mesh(P, ctx.dev)
    t0 = time.perf_counter()
    tasks = spgemm_symbolic(coords, coords)
    symbolic_s = time.perf_counter() - t0

    # choose_schedule builds both plans; the wrappers keep them and time each
    built, real = {}, {}

    def keep(name, fn):
        real[name] = fn

        def wrapped(*a, **k):
            t = time.perf_counter()
            plan = fn(*a, **k)
            built[name] = (plan, time.perf_counter() - t)
            return plan
        return wrapped

    outer.make_spgemm_plan = keep("p2p", outer.make_spgemm_plan)
    outer.make_outer_plan = keep("outer", outer.make_outer_plan)
    try:
        t0 = time.perf_counter()
        kind, plan, stats = outer.choose_schedule(coords, coords, P, bs, tasks=tasks)
        choose_s = time.perf_counter() - t0
    finally:
        outer.make_spgemm_plan, outer.make_outer_plan = real["p2p"], real["outer"]
    p2p_plan, p2p_build_s = built["p2p"]
    outer_build_s = built["outer"][1]
    p2p_recv = plan_stats(p2p_plan)["recv_bytes_mean"]
    del p2p_plan
    check(kind == "outer", f"choose_schedule picked {kind!r} on the random-blocks structure")
    check(stats["recv_bytes_mean"] < p2p_recv, "the outer plan receives no fewer bytes")

    # the outer multiply: one-shot first call, then warm calls on laid-out stores
    if ctx.dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    expected = 0 if ctx.rehearse else 1
    bsp.launches = 0  # the main path's count starts here
    ctx.sync()
    t0 = time.perf_counter()
    c_first = dist_spgemm_outer(plan, a.data, a.data, mesh)
    ctx.sync()
    first_s = time.perf_counter() - t0
    first_launches = bsp.launches
    del c_first
    exe = OuterSpgemmExecutable(plan, mesh)
    a_store, b_store = shard_stores(plan, a.data, a.data)
    t0 = time.perf_counter()
    c1 = exe(a_store, b_store)
    ctx.sync()
    warm_s = time.perf_counter() - t0
    c2 = exe(a_store, b_store)
    ctx.sync()
    launches = bsp.launches  # ... and is read here
    check(first_launches == expected and launches == 3 * expected,
          f"outer multiply: {first_launches} then {launches} block_spmm launches for 1 then 3 calls")
    repeat_identical = bool(torch.equal(c1, c2))
    check(repeat_identical, "two outer calls differ")
    del c2
    outer_peak = torch.cuda.max_memory_allocated() if ctx.dev.type == "cuda" else None

    # the kernel, the partials' exchange and the accumulate alone (CUDA events)
    T = tasks.num_tasks
    kernel_ms = ctx.time_ms(lambda: exe.partials(a_store, b_store), reps=2)
    partials = exe.partials(a_store, b_store)
    exchange_ms = ctx.time_ms(lambda: exe.exchange(partials), reps=3)
    received = exe.exchange(partials)
    accumulate_ms = ctx.time_ms(lambda: exe.accumulate(partials, received), reps=2)
    bound = gemm_bound(T, bs, bs, bs, a.nnzb, a.nnzb, P * plan.p_cap, 4)
    del partials, received, a_store, b_store, exe
    c_outer = unshard_result(plan, c1, (n, n), bs)
    del c1
    if ctx.dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # the owner-computes multiply of the same operands, resident
    d = scatter(a, mesh)
    cache = PlanCache()
    ctx.sync()
    t0 = time.perf_counter()
    c = dist_multiply(d, d, cache)
    ctx.sync()
    p2p_first_s = time.perf_counter() - t0
    del c
    t0 = time.perf_counter()
    c = dist_multiply(d, d, cache)
    ctx.sync()
    p2p_warm_s = time.perf_counter() - t0
    p2p_peak = torch.cuda.max_memory_allocated() if ctx.dev.type == "cuda" else None
    g = c.gather()
    del c, d
    check(bool(np.array_equal(g.coords, c_outer.coords)), "outer and p2p output structures differ")
    run_ptr = torch.from_numpy(np.searchsorted(tasks.c_idx, np.arange(tasks.num_out + 1))).to(ctx.dev)
    tol = block_tolerance(a.data, a.data, torch.from_numpy(tasks.a_idx).to(ctx.dev),
                          torch.from_numpy(tasks.b_idx).to(ctx.dev), run_ptr)
    worst = max_block_excess(c_outer.data, g.data, tol)
    check(worst <= 1.0, f"outer vs p2p: a block differs by {worst} x its tolerance")
    del g, c_outer, a

    # the small case: several offsets, the launch against its plain version
    sn, sp = cfg["small_n"], cfg["small_p"]
    small = banded_matrix(ctx, sn, cfg["small_hw"], bs, seed=301)
    splan = outer.make_outer_plan(small.coords, small.coords, sp, bs)
    check(len(splan.offsets) >= 2, f"the small outer plan has offsets {splan.offsets}")
    smesh = make_worker_mesh(sp, ctx.dev)
    got = dist_spgemm_outer(splan, small.data, small.data, smesh)
    want = dist_spgemm_outer(splan, small.data, small.data, smesh, impl="ref")
    st = splan.tasks
    srun = torch.from_numpy(np.searchsorted(st.c_idx, np.arange(st.num_out + 1))).to(ctx.dev)
    stol = block_tolerance(small.data, small.data, torch.from_numpy(st.a_idx).to(ctx.dev),
                           torch.from_numpy(st.b_idx).to(ctx.dev), srun)
    got_b = unshard_result(splan, got, (sn, sn), bs).data
    want_b = unshard_result(splan, want, (sn, sn), bs).data
    small_excess = max_block_excess(got_b, want_b, stol)
    small_err = float((got_b - want_b).abs().max())
    check(small_excess <= 1.0, f"small outer case: kernel vs plain {small_excess} x tolerance")
    check(not got[torch.from_numpy(~splan.c_store_valid).to(ctx.dev)].any(),
          "small outer case: padding C slots are not zero")
    out = dict(phase="dist_outer", card=ctx.card, n=n, bs=bs, workers=P, half_bandwidth=cfg["hw"],
               dense_block=cfg["block"], a_blocks=int(coords.shape[0]),
               a_gb=coords.shape[0] * bs * bs * 4 / 1e9, tasks=T, tflop=2.0 * T * bs**3 / 1e12,
               c_blocks=tasks.num_out, schedule=kind,
               outer_recv_bytes_mean=stats["recv_bytes_mean"], p2p_recv_bytes_mean=p2p_recv,
               a_cap=plan.a_cap, p_cap=plan.p_cap, c_cap=plan.c_cap, offsets=list(plan.offsets),
               symbolic_s=symbolic_s, choose_schedule_s=choose_s,
               outer_plan_build_s=outer_build_s, p2p_plan_build_s=p2p_build_s,
               outer_verify_s=None,  # neither package has a verifier for the outer plan
               outer_first_call_s=first_s, outer_warm_call_s=warm_s,
               kernel_ms=kernel_ms, kernel_tflops=2.0 * T * bs**3 / (kernel_ms * 1e-3) / 1e12,
               **bound, exchange_ms=exchange_ms, accumulate_ms=accumulate_ms,
               outer_max_memory_allocated=outer_peak,
               p2p_first_call_s=p2p_first_s, p2p_warm_call_s=p2p_warm_s,
               p2p_plan_build_s_in_cache=cache.build_s, p2p_verify_s=cache.verify_s,
               p2p_plans_verified=cache.plans_verified, p2p_max_memory_allocated=p2p_peak,
               max_err_over_tol_vs_p2p=worst, repeat_bit_identical=repeat_identical,
               launches=launches, small=dict(n=sn, workers=sp, offsets=list(splan.offsets),
                                             tasks=st.num_tasks, max_abs_err=small_err,
                                             max_err_over_tol=small_excess))
    emit(out)
    return out


def phase_dist_observatory(ctx, sizes) -> dict:
    """The ``dist_pipeline`` phase's skewed run with the whole observatory on.

    Plan cache with ``verify="always"``, a memory meter, a locality ledger
    and a flight recorder; the tracer, a debug-level event log and a health
    policy passed to the driver; ``rebalance=``.  D must equal the static
    run's bit for bit although the health monitor refits the load balancer
    live; no plan or payload may fail verification; the written trace must
    validate with one track per worker; the ledger must conserve bytes on
    every worker; the log must hold the run's events.  Then the split of the
    host time between the spans, and the observatory's overhead: the warm
    pipeline on the static layout with everything on against everything
    off, in turns.
    """
    import statistics
    import tempfile

    import numpy as np

    torch = ctx.torch
    import repro_torch.dist.purify as pur
    from repro_torch.core import BSMatrix
    from repro_torch.core.distributed import make_worker_mesh
    from repro_torch.dist import PlanCache, RebalancePolicy, scatter
    from repro_torch.kernels import fused_leaf as fl
    from repro_torch.obs import (EventLog, FlightRecorder, HealthPolicy, LocalityLedger,
                                 MemoryMeter, Tracer, load_events, validate_chrome_trace,
                                 write_chrome_trace)

    n, bs, nocc, P = sizes["sp2_n"], sizes["sp2_bs"], sizes["sp2_nocc"], sizes["pipe_p"]
    h, s_dense = _hamiltonian(n, nocc, seed=7)
    mesh = make_worker_mesh(P, ctx.dev)
    H = BSMatrix.from_dense(h, bs, device=ctx.dev)
    S = BSMatrix.from_dense(s_dense, bs, device=ctx.dev)
    kw = dict(trunc_tau=1e-5, idem_tol=1e-6)
    skew = _skewed_owner(S.nnzb, P)

    def observed(tmp, **cache_kw):
        cache = PlanCache(**cache_kw)
        meter = MemoryMeter().install(cache)
        ledger = LocalityLedger().install(cache)
        rec = FlightRecorder(str(Path(tmp) / "postmortem.json")).install(cache)
        log = EventLog(str(Path(tmp) / "events.jsonl"), level="debug")
        return cache, meter, ledger, rec, log

    with tempfile.TemporaryDirectory() as tmp:
        cache, meter, ledger, rec, log = observed(tmp, verify="always")
        tracer = Tracer()
        ds, dh = scatter(S, mesh, owner=skew), scatter(H, mesh, owner=skew)
        if ctx.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        fl.launches = 0  # the main path's count starts here
        ctx.sync()
        t0 = time.perf_counter()
        d, st = pur.dist_sqrt_inv_pipeline(ds, dh, nocc, cache=cache, rebalance=RebalancePolicy(),
                                           tracer=tracer, log=log, health=HealthPolicy(), **kw)
        ctx.sync()
        wall = time.perf_counter() - t0
        launches = fl.launches  # ... and is read here
        log.close()
        peak = torch.cuda.max_memory_allocated() if ctx.dev.type == "cuda" else None
        identical = (np.array_equal(d.coords, ctx.pipeline_d.coords)
                     and bool(torch.equal(d.data, ctx.pipeline_d.data)))
        check(identical, "D with the observatory on is not bit-identical to the static run's")
        check(cache.verify_violations == 0 and cache.plans_verified > 0,
              f"verifier: {cache.plans_verified} values verified, "
              f"{cache.verify_violations} violations")
        trace_path = str(Path(tmp) / "trace.json")
        summary = write_chrome_trace(tracer, trace_path)
        check(validate_chrome_trace(trace_path) == summary and summary["workers"] == P,
              f"trace: {summary['workers']} worker tracks")
        lsum = ledger.summary()
        for w in lsum["per_worker"]:
            check(w["local_bytes"] + w["shipped_bytes"] == w["referenced_bytes"],
                  f"ledger: worker {w['worker']} local + shipped != referenced")
        events = {e["event"] for e in load_events(str(Path(tmp) / "events.jsonl"))}
        check({"run_start", "run_end", "iteration", "plan_build"} <= events,
              f"event log holds {sorted(events)}")
        diverged = bool({"sp2_divergence", "refine_divergence"} & events)
        pm_written = (Path(tmp) / "postmortem.json").exists()
        check(pm_written == diverged, f"postmortem written {pm_written}, divergence logged {diverged}")

    # the host time between the spans: outermost spans of each kind
    def total(names):
        spans = tracer.spans
        out = 0.0
        for sp in spans:
            if sp.name not in names:
                continue
            p = sp.parent
            while p >= 0 and spans[p].name not in names:
                p = spans[p].parent
            if p < 0:
                out += sp.dur
        return out

    split = dict(plan_build_s=total({"plan_build"}), plan_verify_s=total({"plan_verify"}),
                 dispatch_s=total({"dispatch"}),
                 symbolic_s=total({sp.name for sp in tracer.spans if sp.cat == "symbolic"}))
    split["rest_s"] = wall - sum(split.values())
    health = [x for x in (st.inverse.health, st.purify.health) if x is not None]
    alerts: dict = {}
    for hsum in health:
        for k, v in hsum["alerts_by_kind"].items():
            alerts[k] = alerts.get(k, 0) + v

    # overhead: warm pipeline, static layout, everything on (verify="always",
    # as above) and the observers on with the default verify="cached-once"
    # (which verifies nothing on a warm run) against everything off, in turns
    logs = []

    def warm_runner(config, tmp):
        extra = {}
        cache = PlanCache(max_entries=4096)
        if config in ("on", "on_cached_once"):
            verify = "always" if config == "on" else "cached-once"
            cache, _, _, _, wlog = observed(tmp, max_entries=4096, verify=verify)
            logs.append(wlog)
            extra = dict(tracer=Tracer(), log=wlog, health=HealthPolicy())
        elif config == "tracer":
            extra = dict(tracer=Tracer())
        elif config == "log":
            logs.append(EventLog(str(Path(tmp) / "events.jsonl"), level="debug"))
            extra = dict(log=logs[-1])
        elif config == "health":
            extra = dict(health=HealthPolicy())
        elif config == "memory":
            MemoryMeter().install(cache)
        elif config == "locality":
            LocalityLedger().install(cache)

        def run():
            return pur.dist_sqrt_inv_pipeline(scatter(S, mesh), scatter(H, mesh), nocc,
                                              cache=cache, **extra, **kw)
        run()  # fills the plan cache: every later run is all hits
        return run

    # each observer alone too, as in benchmarks/torch_trace_overhead.py's split
    # (the tracer here waits for the card in dispatch spans, as in "on")
    observers = ("tracer", "log", "health", "memory", "locality")
    configs = ("off", "on", "on_cached_once") + observers
    walls = {c: [] for c in configs}
    cpus = {c: [] for c in configs}  # (process CPU s, main-thread CPU s)
    with tempfile.TemporaryDirectory() as tmp:
        for c in configs:
            (Path(tmp) / c).mkdir()
        runners = {c: warm_runner(c, str(Path(tmp) / c)) for c in configs}
        for k in range(3):
            for c in configs[k:] + configs[:k]:
                ctx.sync()
                c0, m0, t0 = time.process_time(), time.thread_time(), time.perf_counter()
                runners[c]()
                ctx.sync()
                walls[c].append(time.perf_counter() - t0)
                cpus[c].append((time.process_time() - c0, time.thread_time() - m0))
        for wlog in logs:
            wlog.close()
    med = {c: statistics.median(w) for c, w in walls.items()}

    def paired(c, k):  # median over rounds of (config - off) / off, in %
        base = [(w, *cp) for w, cp in zip(walls["off"], cpus["off"])]
        arm = [(w, *cp) for w, cp in zip(walls[c], cpus[c])]
        return statistics.median((a[k] - b[k]) / b[k] * 100.0 for b, a in zip(base, arm))

    per_observer = {c: dict(wall_pct=paired(c, 0), cpu_pct=paired(c, 1), main_cpu_pct=paired(c, 2))
                    for c in observers + ("on_cached_once",)}
    print("dist_observatory per-observer overhead, paired medians of 3 (wall / process CPU / "
          "main-thread CPU): " + "; ".join(
              f"{c} {v['wall_pct']:+.2f} / {v['cpu_pct']:+.2f} / {v['main_cpu_pct']:+.2f} %"
              for c, v in per_observer.items()), file=sys.stderr, flush=True)
    out = dict(phase="dist_observatory", card=ctx.card, n=n, bs=bs, nocc=nocc, workers=P, **kw,
               skew="first half of the Morton order on worker 0", seconds=wall,
               bit_identical_to_static=identical, launches=launches,
               plans_verified=cache.plans_verified, verify_violations=cache.verify_violations,
               verify_s=cache.verify_s, plan_build_s=cache.build_s,
               cache=dict(hits=cache.hits, misses=cache.misses),
               trace=dict(workers=summary["workers"], host_spans=summary["host_spans"],
                          events=summary["events"]),
               events=sorted(events), postmortem_written=pm_written,
               health_alerts_by_kind=alerts, health_refits=sum(x["refits"] for x in health),
               rebalances=st.inverse.rebalances + st.purify.rebalances,
               meter_worker_peak_bytes=meter.worker_peak().tolist(),
               max_memory_allocated=peak,
               ledger=dict(locality_flops=lsum["locality_flops"],
                           locality_bytes=lsum["locality_bytes"],
                           local_bytes=lsum["local_bytes"], shipped_bytes=lsum["shipped_bytes"],
                           dispatches=lsum["dispatches"]),
               host_split=split, host_split_share={k: v / wall for k, v in split.items()},
               overhead=dict(walls_s=walls, median_s=med,
                             on_overhead_pct=100.0 * (med["on"] / med["off"] - 1.0),
                             on_cached_once_overhead_pct=100.0 * (
                                 med["on_cached_once"] / med["off"] - 1.0),
                             cpu_s=cpus, per_observer=per_observer))
    emit(out)
    return out


def phase_analysis(ctx) -> dict:
    """``python -m repro_torch.analysis --selftest`` in this process: the plan
    verifier on the benchmark structures, the repo lint and the seeded
    corruptions, all host numpy, on a machine without JAX."""
    import contextlib
    import io

    from repro_torch.analysis import __main__ as cli
    from repro_torch.analysis.lint import lint_paths
    from repro_torch.analysis.mutate import CORRUPTIONS

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--selftest"])
    lines = buf.getvalue().splitlines()
    plans = [ln for ln in lines if "/P=" in ln and ln.startswith(("ok ", "FAIL "))]
    caught = [ln for ln in lines if ln.startswith("ok ") and ": caught as " in ln]
    missed = [ln for ln in lines if ln.startswith("MISS ")]
    findings, waived = lint_paths()
    out = dict(phase="analysis", seconds=time.perf_counter() - t0, rc=rc,
               plans_verified=len(plans), plan_violations=sum(ln.startswith("FAIL") for ln in plans),
               corruptions=len(CORRUPTIONS), corruptions_caught=len(caught),
               corruptions_missed=len(missed), lint_findings=len(findings),
               lint_waived=sorted({f.key for f in waived}), summary=lines[-1])
    emit(out)
    check(rc == 0, f"python -m repro_torch.analysis --selftest returned {rc}")
    check(out["plans_verified"] == 24 and out["plan_violations"] == 0,
          f"{out['plans_verified']} plans verified, {out['plan_violations']} with violations")
    check(out["corruptions_caught"] == len(CORRUPTIONS) and not missed,
          f"{len(caught)} of {len(CORRUPTIONS)} corruptions caught")
    check(not findings, f"lint: {[str(f) for f in findings]}")
    return out


def phase_sequences(ctx, sizes) -> dict:
    """The paper's three structure families (``benchmarks/torch_spamm_sequences.py``:
    banded, exp-decay, random-offdiag) through resident SP2 on 8 workers,
    each from the all-on-worker-0 layout, static and with
    ``RebalancePolicy()``, a locality ledger on the plan cache: the
    ``--card`` problem of ``benchmarks/torch_dist_balance.py`` /
    ``torch_locality.py``.  D must be bit-identical between the modes, the
    rebalanced locality fraction (flops) above the static one, and the fused
    launches equal to the non-empty resident multiplies.  |trace(D) - n_occ|
    must be <= 1e-3, except on a family without a spectral gap (the HOMO-LUMO
    gap below GAP_MIN_REL of the spectral width), where fp32 SP2 has a floor:
    that family's trace error is recorded and it is held to bit identity.
    """
    import numpy as np

    torch = ctx.torch
    sys.path.insert(0, str(ROOT / "benchmarks"))
    import repro_torch.core.distributed as cdist
    import torch_dist_balance as tdb
    import torch_locality as tloc
    from torch_spamm_sequences import sequences
    from repro_torch.core.distributed import make_worker_mesh
    from repro_torch.dist import RebalancePolicy
    from repro_torch.kernels import fused_leaf as fl
    from repro_torch.obs.locality import LocalityLedger

    n, bs, P, max_iter = sizes["seq_n"], sizes["seq_bs"], sizes["seq_p"], sizes["seq_max_iter"]
    nocc = int(0.3 * n)
    mesh = make_worker_mesh(P, ctx.dev)
    calls = [0, 0]
    real_run = cdist.FusedSpgemmExecutable._run

    def counting_run(self, *a, **k):
        calls[0] += 1
        calls[1] += self.plan.tasks.num_tasks > 0
        return real_run(self, *a, **k)

    t_all = time.perf_counter()
    t0 = time.perf_counter()
    fams = sequences(n, bs, device=ctx.dev)
    gen_s = time.perf_counter() - t0
    families, launches_total = {}, 0
    for name, f in fams.items():
        t0 = time.perf_counter()
        lmin, lmax = tdb.spectral_bounds(f, mesh, exact=False)
        bounds_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        w = torch.linalg.eigvalsh(dense_on_device(f, torch.float32))
        gap = float(w[nocc] - w[nocc - 1])
        width = float(w[-1] - w[0])
        row = dict(nnzb=f.nnzb, bounds=[lmin, lmax], bounds_s=bounds_s,
                   spectrum=[float(w[0]), float(w[-1])], eigvalsh_s=time.perf_counter() - t0,
                   homo_lumo_gap=gap, gapless=gap < GAP_MIN_REL * width)
        del w
        ds = {}
        cdist.FusedSpgemmExecutable._run = counting_run
        try:
            for mode, policy in (("static", None), ("rebalanced", RebalancePolicy())):
                calls[0] = calls[1] = 0
                ledger = LocalityLedger()
                fl.launches = 0  # the main path's count starts here
                d, r, st, cache = tdb.run_mode(f, nocc, lmin, lmax, mesh, policy, max_iter,
                                               ledger=ledger)
                launches = fl.launches  # ... and is read here
                loc = ledger.summary()
                expected = 0 if ctx.rehearse else calls[1]
                check(launches == expected,
                      f"{name}/{mode}: fused launches {launches}, non-empty resident "
                      f"multiplies {calls[1]} of {calls[0]}")
                diag = np.nonzero(d.coords[:, 0] == d.coords[:, 1])[0]
                trace = float(d.data[torch.from_numpy(diag).to(d.device)].double()
                              .diagonal(dim1=1, dim2=2).sum())
                ds[mode] = d
                launches_total += launches
                row[mode] = dict(
                    iterations=r["iterations"], s_per_iteration=r["wall_s_per_iter"],
                    seconds=r["wall_s_total"], imbalance_peak=r["imbalance_max"],
                    imbalance_mean=r["imbalance_mean"], imbalance_tail=r["imbalance_tail"],
                    migrated_bytes=r["migrated_bytes_total"], rebalances=r["rebalances"],
                    plan_hits=r["cache"]["hits"], plan_misses=r["cache"]["misses"],
                    plan_build_s=r["plan_build_s"], verify_s=r["verify_s"],
                    locality_flops=loc["locality_flops"], locality_bytes=loc["locality_bytes"],
                    resident_multiplies=calls[0], nonempty_multiplies=calls[1],
                    fused_launches=launches, trace_error=abs(trace - nocc),
                    idempotency=st.idempotency_history[-1], d_blocks=d.nnzb)
        finally:
            cdist.FusedSpgemmExecutable._run = real_run
        row["bit_identical"] = tdb.bit_identical(ds["static"], ds["rebalanced"])
        row["taskgraph_predicted_gain"] = tloc.taskgraph_row(f, bs)["predicted_gain"]
        row["locality_gain"] = (row["rebalanced"]["locality_flops"]
                                / max(row["static"]["locality_flops"], 1e-12))
        families[name] = row
        del ds
        check(row["bit_identical"], f"{name}: the rebalanced D is not bit-identical to the static D")
        check(row["rebalanced"]["locality_flops"] > row["static"]["locality_flops"],
              f"{name}: rebalancing did not raise the locality fraction")
        err = row["static"]["trace_error"]
        check(err <= 1e-3 or row["gapless"],
              f"{name}: |trace(D) - n_occ| = {err:.3e} > 1e-3 with a spectral gap of {gap:.3e}")
    out = dict(phase="sequences", card=ctx.card, n=n, bs=bs, workers=P, nocc=nocc,
               max_iter=max_iter, idem_tol=tdb.IDEM_TOL, trunc_tau=tdb.TRUNC_TAU,
               spamm_tau=tdb.SPAMM_TAU, gap_min_rel=GAP_MIN_REL,
               initial_layout="all blocks on worker 0", generate_s=gen_s,
               seconds=time.perf_counter() - t_all, launches=launches_total, families=families)
    emit(out)
    return out


EXAMPLES = ("quickstart", "purification", "distributed_spgemm", "distributed_purification",
            "distributed_inverse", "serve_lm", "train_lm")


def phase_examples(ctx) -> dict:
    """Every ``examples/torch_*.py`` with ``--device cuda`` (``cpu`` in the
    rehearsal), all at once, each in its own process: each checks its own
    result and must exit 0 (the training example runs 20 steps into a
    temporary checkpoint directory)."""
    import os
    import tempfile

    dev = "cpu" if ctx.rehearse else "cuda"
    # seven processes share the host's cores: one intra-op thread each
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    results = {}
    with tempfile.TemporaryDirectory(prefix="examples_") as tmp:
        procs = {}
        try:
            for name in EXAMPLES:
                argv = [sys.executable, str(ROOT / "examples" / f"torch_{name}.py"), "--device", dev]
                if name == "train_lm":
                    argv += ["--steps", "20", "--ckpt-dir", str(Path(tmp) / "ckpt")]
                procs[name] = subprocess.Popen(argv, env=dict(env, TMPDIR=tmp), text=True,
                                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for name, proc in procs.items():
                out, _ = proc.communicate(timeout=300)
                results[name] = dict(rc=proc.returncode, seconds=time.perf_counter() - t0,
                                     tail=out.strip().splitlines()[-3:])
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    out = dict(phase="examples", device=dev, seconds=time.perf_counter() - t0, examples=results)
    emit(out)
    bad = {k: v for k, v in results.items() if v["rc"] != 0}
    check(not bad and len(results) == len(EXAMPLES), f"examples failed: {bad}")
    return out


def phase_dist_pipeline_profile(ctx, sizes) -> dict:
    """Where a warm resident pipeline's time goes: the ``dist_pipeline`` phase's
    static run, once to fill the plan cache, then replayed on it under
    ``torch.profiler``.  It runs after every timed phase: a profiler session
    leaves the card's activity tracing attached, which slows each later
    kernel launch of the process."""
    import repro_torch.dist.purify as pur
    from repro_torch.core import BSMatrix
    from repro_torch.core.distributed import make_worker_mesh
    from repro_torch.dist import PlanCache, scatter

    n, bs, nocc = sizes["sp2_n"], sizes["sp2_bs"], sizes["sp2_nocc"]
    h, s_dense = _hamiltonian(n, nocc, seed=7)
    mesh = make_worker_mesh(sizes["pipe_p"], ctx.dev)
    H = BSMatrix.from_dense(h, bs, device=ctx.dev)
    S = BSMatrix.from_dense(s_dense, bs, device=ctx.dev)
    # room for every plan of the run: at the default 128 entries the LRU
    # evicts plans the replay needs again
    cache = PlanCache(max_entries=4096)

    def pipeline():
        return pur.dist_sqrt_inv_pipeline(scatter(S, mesh), scatter(H, mesh), nocc, cache=cache,
                                          trunc_tau=1e-5, idem_tol=1e-6)

    pipeline()
    ctx.sync()
    misses = cache.misses
    out = dict(phase="dist_pipeline_profile", **profile_device(ctx, pipeline,
                                                                 kernel="fused_block_spmm"),
               replay_cache_misses=cache.misses - misses)
    emit(out)
    return out


def flash_bound(q, k, live_pairs: int) -> dict:
    """Least time for one flash-attention call on an H100: operations or bytes.

    Operations: 2 * D per live (query, key) pair for each product.
    ``bound_ms`` is the fp32 kernel's design, both products in fp32 FFMA at
    67 TFLOP/s.  For bf16 inputs ``bf16_bound_ms`` is the bf16 kernel's
    design at the Pallas kernel's precision: QK^T (products of bf16 values
    are exact in fp32) and the two PV products of the split P (p_hi V and
    p_lo V), all three on the bf16 tensor cores at 989 TFLOP/s with fp32
    accumulation.  ``bf16_ffma_pv_bound_ms`` is the earlier design's bound,
    PV in fp32 FFMA beside QK^T on the tensor cores (the two units run at
    once, so the larger time bounds): no kernel that runs PV on FFMA beats it.
    Bytes: q, k, v read once and o written once in the input type.
    """
    B, H, Sq, D = q.shape
    half = 2.0 * D * live_pairs  # the operations of one product
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    t_ops, t_bytes = 2 * half / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    out = dict(live_pairs=live_pairs, bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               bound_arithmetic=(f"max(4*{D}*{live_pairs} op / 67e12 op/s = {t_ops * 1e3:.4f} ms, "
                                 f"{nbytes} B / 3.35e12 B/s = {t_bytes * 1e3:.4f} ms)"))
    if str(q.dtype) == "torch.bfloat16":
        t_tc, t_qk, t_pv = 3 * half / BF16_FLOPS, half / BF16_FLOPS, half / FP32_FLOPS
        out.update(bf16_bound_ms=max(t_tc, t_bytes) * 1e3,
                   bf16_bound_by="operations" if t_tc >= t_bytes else "bytes",
                   bf16_bound_arithmetic=(
                       f"max(QK^T + p_hi V + p_lo V 3*2*{D}*{live_pairs} op / 989e12 op/s = "
                       f"{t_tc * 1e3:.4f} ms, {nbytes} B / 3.35e12 B/s = {t_bytes * 1e3:.4f} ms)"),
                   bf16_ffma_pv_bound_ms=max(t_qk, t_pv, t_bytes) * 1e3,
                   bf16_ffma_pv_bound_arithmetic=(
                       f"max(QK^T 2*{D}*{live_pairs} op / 989e12 op/s = {t_qk * 1e3:.4f} ms, "
                       f"PV 2*{D}*{live_pairs} op / 67e12 op/s = {t_pv * 1e3:.4f} ms, "
                       f"{nbytes} B / 3.35e12 B/s = {t_bytes * 1e3:.4f} ms)"))
    return out


def flash_ref_rounding_p(q, k, v, *, causal, window):
    """A deliberately wrong copy of the plain version: it rounds the
    probabilities to bf16 before the PV product, as a tensor-core redesign
    might.  The bf16 check must reject it."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    B, H, Sq, D = q.shape
    HK, Sk = k.shape[1], k.shape[2]
    rep = H // HK
    s = torch.matmul(q.float().reshape(B, HK, rep * Sq, D), k.float().transpose(-1, -2))
    s = s.view(B, HK, rep, Sq, Sk) * D**-0.5
    mask = fa.attention_mask(torch.arange(Sq, device=q.device) + (Sk - Sq),
                             torch.arange(Sk, device=q.device), causal=causal, window=window)
    s = torch.where(mask, s, fa.NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    p = p.to(torch.bfloat16).float()  # the fault
    o = torch.matmul(p.view(B, HK, rep * Sq, Sk), v.float()).view(B, HK, rep, Sq, D)
    return (o / torch.where(l == 0.0, 1.0, l)).reshape(B, H, Sq, D).to(q.dtype)


def flash_excess(got, q, k, v, **kw) -> tuple[float, float]:
    """``(max |got - want|, max |got - want| / limit)`` against the plain
    version's fp32 result ``want`` on the same inputs (bf16 inputs upcast
    exactly).  The limit is elementwise: 1e-4 * max|v| for the order of the
    fp32 sums and exps (the output is a convex combination of v's rows), and
    for a bf16 output also its one rounding, half a bf16 ulp <= 2^-8 * |want|.
    A ratio above 1 fails."""
    from repro_torch.kernels import flash_attention as fa

    want = fa.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    limit = 1e-4 * float(v.float().abs().max())
    if got.dtype != want.dtype:
        limit = 2.0**-8 * want.abs() + limit
    diff = (got.float() - want).abs()
    return float(diff.max()), float((diff / limit).max())


def phase_flash_kernel(ctx, sizes) -> dict:
    torch = ctx.torch
    from repro_torch.kernels import flash_attention as fa

    kernel = fa.flash_attention_ref if ctx.rehearse else fa.flash_attention_cuda
    gen = torch.Generator(device=ctx.dev).manual_seed(13)
    results, timing = [], {}
    cases = sizes["flash"]
    for name, (B, H, HK, Sq, Sk, D, causal, window) in cases.items():
        kw = dict(causal=causal, window=window)
        q32, k32, v32 = (torch.randn(sh, generator=gen, device=ctx.dev)
                         for sh in ((B, H, Sq, D), (B, HK, Sk, D), (B, HK, Sk, D)))
        qpos = torch.arange(Sq, device=ctx.dev) + (Sk - Sq)
        live = int(fa.attention_mask(qpos, torch.arange(Sk, device=ctx.dev), **kw).sum()) * B * H
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            got = kernel(q, k, v, **kw)
            again = kernel(q, k, v, **kw)
            ctx.sync()
            identical = bool(torch.equal(got, again))
            err, excess = flash_excess(got, q, k, v, **kw)
            dead = max(Sq - Sk, 0) if causal else 0  # rows at negative positions
            row = dict(case=name, dtype=str(dtype).replace("torch.", ""), B=B, H=H, HK=HK, Sq=Sq,
                       Sk=Sk, D=D, causal=causal, window=window, live_pairs=live,
                       max_abs_err=err, err_over_limit=excess, bit_identical_on_repeat=identical,
                       dead_rows=dead, dead_rows_zero=bool(not got[:, :, :dead].any()),
                       finite=bool(torch.isfinite(got.float()).all()))
            check(identical, f"{name} {dtype}: flash kernel output differs between two launches")
            check(excess <= 1.0, f"{name} {dtype}: flash kernel off its plain version by {excess} of the limit")
            check(row["finite"] and row["dead_rows_zero"], f"{name} {dtype}: non-finite output or non-zero dead rows")
            del got, again
            if name == next(iter(cases)) and dtype == torch.bfloat16:
                # the check must catch bf16 probabilities
                _, row["rounding_p_err_over_limit"] = flash_excess(
                    flash_ref_rounding_p(q, k, v, **kw), q, k, v, **kw)
                check(row["rounding_p_err_over_limit"] > 1.0,
                      f"{name}: the bf16 check passes a version that rounds p to bf16")
            if name in FLASH_TIMED:
                sdpa = torch.nn.functional.scaled_dot_product_attention
                ms = ctx.time_ms(lambda: kernel(q, k, v, **kw), reps=20)
                plain_ms = ctx.time_ms(lambda: fa.flash_attention_ref(q, k, v, **kw), reps=3)
                sdpa_ms = ctx.time_ms(lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True), reps=20)
                bound = flash_bound(q, k, live)
                t = timing.setdefault(name, {})[row["dtype"]] = dict(
                    case=name, ms=ms, plain_ms=plain_ms, sdpa_ms=sdpa_ms,
                    sdpa=f"torch.nn.functional.scaled_dot_product_attention(is_causal={causal}, "
                         "enable_gqa=True), yardstick only",
                    tflops=4.0 * D * live / (ms * 1e-3) / 1e12, bound_share=bound["bound_ms"] / ms, **bound)
                if "bf16_bound_ms" in bound:
                    t.update(bf16_bound_share=bound["bf16_bound_ms"] / ms,
                             bf16_tflops=3 * 2.0 * D * live / (ms * 1e-3) / 1e12)
            results.append(row)
    out = dict(phase="flash_kernel", cases=results, timing=timing)
    emit(out)
    return out


def lm_model(ctx, sizes):
    """qwen2-0.5b (full width on the card, reduced in the rehearsal), weights from seed 0."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import transformer

    cfg = reduced_config("qwen2-0.5b") if sizes["lm_reduced"] else get_config("qwen2-0.5b")
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=0, device=ctx.dev)
    ctx.sync()
    return cfg, params, time.perf_counter() - t0


def phase_lm_forward(ctx, sizes, model) -> dict:
    import numpy as np

    torch = ctx.torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as model_mod
    from repro_torch.models import transformer
    from repro_torch.tree import tree_leaves

    cfg, params, init_s = model
    B, S = LM_BATCH, sizes["lm_seq"]
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    inputs = {"tokens": torch.from_numpy(tokens).to(ctx.dev)}
    per_forward = 0 if ctx.rehearse else cfg.num_layers
    if ctx.dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rows = {}
    fa.launches = 0  # the main path's count starts here
    fa.launches_by_dtype.update(float32=0, bfloat16=0)
    with torch.inference_mode():
        for dtype, rel in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
            p = model_mod.cast_params(params, dtype)
            before = fa.launches
            flash = transformer.apply(p, cfg, inputs, attn_impl="flash")
            ctx.sync()
            check(fa.launches - before == per_forward,
                  f"{dtype} forward launched the flash kernel {fa.launches - before} times, expected {per_forward}")
            t0 = time.perf_counter()
            again = transformer.apply(p, cfg, inputs, attn_impl="flash")  # warm, timed
            ctx.sync()
            secs = time.perf_counter() - t0
            identical = bool(torch.equal(flash, again))
            del again
            t0 = time.perf_counter()
            direct = transformer.apply(p, cfg, inputs, attn_impl="direct")
            ctx.sync()
            direct_s = time.perf_counter() - t0
            lmax = float(flash.float().abs().max())
            err = float((flash.float() - direct.float()).abs().max())
            finite = bool(torch.isfinite(flash.float()).all())
            del direct, flash, p
            name = str(dtype).replace("torch.", "")
            rows[name] = dict(seconds_per_forward=secs, tokens_per_s=B * S / secs,
                              direct_seconds=direct_s, max_abs_logit=lmax,
                              max_abs_flash_minus_direct=err, tol=rel * lmax,
                              bit_identical_on_repeat=identical, finite=finite)
            check(finite, f"{name} forward: non-finite logits")
            check(identical, f"{name} forward: two flash forwards differ")
            check(err <= rel * lmax, f"{name} forward: flash off direct by {err} > {rel} * {lmax}")
    launches = fa.launches  # ... and is read here
    by_dtype = dict(fa.launches_by_dtype)
    numels = [t.numel() for t in tree_leaves(params)]
    check(launches == 4 * per_forward, f"lm_forward: {launches} flash launches in 4 flash forwards")
    check(by_dtype == dict(float32=2 * per_forward, bfloat16=2 * per_forward),
          f"lm_forward: flash launches by type {by_dtype}, expected {2 * per_forward} of each")
    peak = torch.cuda.max_memory_allocated() if ctx.dev.type == "cuda" else None
    out = dict(phase="lm_forward", arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
               vocab=cfg.vocab_size, params=sum(numels),
               init_s=init_s, batch=B, seq=S, launches=launches, launches_by_dtype=by_dtype,
               flash_forwards=4,
               max_memory_allocated=peak, **rows)
    emit(out)
    return out


def profile_device(ctx, fn, kernel: str | None = None, top: int = 0) -> dict:
    """``fn()`` under ``torch.profiler``: the PyTorch calls the host makes, the
    kernels the card runs and their summed device time, against the wall time
    with the profiler on; ``kernel`` also sums the device time of the kernels
    whose name holds it, and ``top`` lists that many kernel names with the
    most device time (ms, launches; names cut to 90 characters)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if ctx.dev.type == "cuda" else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        ctx.sync()
        wall = time.perf_counter() - t0
    events = prof.events()
    host_calls = sum(1 for e in events if e.device_type == DeviceType.CPU and e.cpu_parent is None
                     and e.name.startswith("aten::"))
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_s = sum(e.time_range.elapsed_us() for e in kernels) * 1e-6
    out = dict(profiled_wall_ms=wall * 1e3, host_aten_calls=host_calls,
               device_kernels=len(kernels) if ctx.dev.type == "cuda" else None,
               device_ms=device_s * 1e3 if kernels else None,
               device_busy_share=device_s / wall if kernels else None)
    if top:
        by_name = {}
        for e in kernels:
            ms_n = by_name.setdefault(e.name[:90], [0.0, 0])
            ms_n[0] += e.time_range.elapsed_us() * 1e-3
            ms_n[1] += 1
        out["top_kernels"] = sorted(([n, ms_, k] for n, (ms_, k) in by_name.items()),
                                    key=lambda r: -r[1])[:top]
    if kernel is not None:
        mine = [e for e in kernels if kernel in e.name]
        out.update({f"{kernel}_launches": len(mine),
                    f"{kernel}_ms": sum(e.time_range.elapsed_us() for e in mine) * 1e-3
                    if mine else None})
    return out


def profile_decode_step(ctx, cfg, params, prompts) -> dict:
    """One warm fp32 decode step under ``torch.profiler`` (:func:`profile_device`)."""
    torch = ctx.torch
    from repro_torch.models import model as model_mod
    from repro_torch.models import transformer

    B = prompts.shape[0]
    cache = transformer.init_cache(cfg, B, 2, torch.float32, device=ctx.dev)
    step = model_mod.make_serve_step(cfg, compute_dtype=torch.float32)
    tok = torch.from_numpy(prompts[:, :1]).to(ctx.dev)
    with torch.inference_mode():
        step(params, cache, tok, 0)
        ctx.sync()
        return profile_device(ctx, lambda: step(params, cache, tok, 1))


def phase_lm_serve(ctx, model) -> dict:
    import numpy as np

    torch = ctx.torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer

    cfg, params, _ = model
    B, P, G = SERVE
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, P))
    generate(cfg, params, prompts[:, :2], 2, device=ctx.dev)  # warm-up: allocator, cuBLAS
    ctx.sync()
    t0 = time.perf_counter()
    seqs, steps = generate(cfg, params, prompts, G, dtype=torch.float32, device=ctx.dev,
                           return_logits=True)
    ctx.sync()
    secs = time.perf_counter() - t0
    n_steps = P + G - 1
    check(seqs.shape == (B, P + G) and np.array_equal(seqs[:, :P], prompts),
          f"generate returned {seqs.shape}, or not the prompts")
    fa.launches = 0  # the main path's count starts here
    fa.launches_by_dtype.update(float32=0, bfloat16=0)
    with torch.inference_mode():
        full = transformer.apply(params, cfg, {"tokens": torch.from_numpy(seqs).to(ctx.dev)},
                                 attn_impl="flash")[:, :-1].float()
    ctx.sync()
    launches = fa.launches  # ... and is read here
    by_dtype = dict(fa.launches_by_dtype)
    expected = 0 if ctx.rehearse else cfg.num_layers
    check(launches == expected and by_dtype["float32"] == expected,
          f"lm_serve: the confirming forward launched {by_dtype}, expected {expected} fp32")
    lmax = float(full.abs().max())
    tol = 1e-4 * lmax
    err = float((full - steps).abs().max())
    check(err <= tol, f"lm_serve: decode-step logits off the flash forward by {err} > {tol}")
    # greedy tokens: the forward's argmax where its top-2 margin exceeds the tolerance
    gen_logits = full[:, P - 1:]
    top2 = gen_logits.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > tol
    agree = gen_logits.argmax(-1).cpu().numpy() == seqs[:, P:]
    decided = decided.cpu().numpy()
    check(bool(agree[decided].all()), "lm_serve: a generated token is not the flash forward's argmax")
    out = dict(phase="lm_serve", arch=cfg.name, batch=B, prompt_len=P, gen=G, dtype="float32",
               seconds=secs, decode_steps=n_steps, ms_per_decode_step=secs * 1e3 / n_steps,
               profiled_step=profile_decode_step(ctx, cfg, params, prompts),
               tokens_per_s=B * n_steps / secs, generated_tokens_per_s=B * G / secs,
               launches=launches, launches_by_dtype=by_dtype, max_abs_logit=lmax, max_abs_step_minus_forward=err, tol=tol,
               tokens_checked=int(decided.sum()), tokens_total=int(decided.size),
               first_sequence=seqs[0].tolist())
    emit(out)
    return out


def _tree_excess(got, want, rel: float) -> float:
    """The largest ``max|got - want| / (rel * max|want|)`` over the leaves of two
    trees of one structure (``want`` on the host): at most 1 where every leaf
    is within its limit."""
    from repro_torch.tree import tree_leaves

    worst = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want), strict=True):
        w = w.double()
        err = float((g.cpu().double() - w).abs().max())
        scale = float(w.abs().max())
        worst = max(worst, err / (rel * scale) if scale > 0 else (0.0 if err == 0 else float("inf")))
    return worst


def train_parity(ctx, cfg, t) -> dict:
    """One fp32 train step of ``cfg`` on the device against the same step on the
    CPU, from one seeded state and batch: the loss within TRAIN_LOSS_REL, each
    gradient leaf within TRAIN_GRAD_REL * max|g| of the CPU's, and the AdamW
    update of the CPU's gradients on the device within TRAIN_UPDATE_REL of the
    CPU's update (at the peak rate: ``warmup=0``)."""
    torch = ctx.torch
    from repro_torch.data import TokenPipeline
    from repro_torch.models import model as model_mod
    from repro_torch.tree import tree_map

    cpu = torch.device("cpu")
    state = model_mod.init_train_state(cfg, seed=0, device=ctx.dev)
    cpu_state = tree_map(lambda x: x.to(cpu), state)
    batch = TokenPipeline(cfg, batch=t["parity_batch"], seq=t["parity_seq"], seed=0).global_batch(0)
    grad_fn = model_mod.make_grad_fn(cfg, compute_dtype=torch.float32)
    t0 = time.perf_counter()
    loss, grads = grad_fn(state["params"], batch)
    ctx.sync()
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = grad_fn(cpu_state["params"], batch)
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
    grad_excess = _tree_excess(grads, cpu_grads, TRAIN_GRAD_REL)
    del grads
    update = model_mod.make_update_fn(warmup=0)
    want, _ = update(cpu_state, cpu_grads)
    got, _ = update(state, tree_map(lambda g: g.to(ctx.dev), cpu_grads))
    update_excess = _tree_excess(got, want, TRAIN_UPDATE_REL)
    out = dict(arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model, vocab=cfg.vocab_size,
               batch=t["parity_batch"], seq=t["parity_seq"], compute="float32",
               loss=float(loss), cpu_loss=float(cpu_loss), loss_rel_err=loss_rel,
               loss_rel_limit=TRAIN_LOSS_REL, grad_err_over_limit=grad_excess,
               grad_limit=f"{TRAIN_GRAD_REL} * max|g| per leaf",
               update_err_over_limit=update_excess,
               update_limit=f"{TRAIN_UPDATE_REL} * max|x| per leaf of params, mu, nu",
               device_grad_s=dev_s, cpu_grad_s=cpu_s)
    check(loss_rel <= TRAIN_LOSS_REL, f"lm_train parity: loss off the CPU's by {loss_rel} relative")
    check(grad_excess <= 1.0, f"lm_train parity: a gradient leaf is {grad_excess}x its limit")
    check(update_excess <= 1.0, f"lm_train parity: an updated leaf is {update_excess}x its limit")
    return out


def train_remat(ctx, cfg, state, batch, steps: int = 3) -> dict:
    """The train step at ``cfg``'s shape under ``remat="none"`` and ``"full"``
    (every full config's): per mode the median ms of ``steps`` warm steps and
    the peak memory over them; then the first step's loss and gradients of
    both modes, which must be bit-identical."""
    import dataclasses
    import statistics

    torch = ctx.torch
    from repro_torch.models import model as model_mod
    from repro_torch.tree import tree_leaves

    out = {}
    for remat in ("none", "full"):
        c = dataclasses.replace(cfg, remat=remat)
        step = model_mod.make_train_step(c, compute_dtype=torch.bfloat16, lr_peak=TRAIN_LR,
                                         warmup=1, total_steps=steps)
        float(step(state, batch)[1]["loss"])  # warm
        if ctx.dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            new, m = step(state, batch)
            float(m["loss"])
            times.append(time.perf_counter() - t0)
            del new, m
        peak = torch.cuda.max_memory_allocated() if ctx.dev.type == "cuda" else None
        out[remat] = dict(ms_per_step=statistics.median(times) * 1e3,
                          step_ms=[x * 1e3 for x in times], max_memory_allocated=peak)
    first = {}
    for remat in ("none", "full"):
        grad_fn = model_mod.make_grad_fn(dataclasses.replace(cfg, remat=remat),
                                         compute_dtype=torch.bfloat16)
        first[remat] = grad_fn(state["params"], batch)
    (l0, g0), (l1, g1) = first["none"], first["full"]
    identical = bool(torch.equal(l0, l1)) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(g0), tree_leaves(g1), strict=True))
    del first, g0, g1
    check(identical, "lm_train: remat 'full' is not bit-identical to 'none' on the first step")
    if ctx.dev.type == "cuda":
        check(out["full"]["max_memory_allocated"] < out["none"]["max_memory_allocated"],
              f"lm_train: remat 'full' peaks at {out['full']['max_memory_allocated']} bytes, "
              f"'none' at {out['none']['max_memory_allocated']}")
    out.update(first_step_bit_identical=identical, steps=steps, loss=float(l0))
    return out


def phase_lm_train(ctx, sizes) -> dict:
    """The training path (:mod:`repro_torch.models.model`, ``optim``, ``data``,
    ``checkpoint``, ``runtime``): the parity step (qwen2-0.5b cut to 2 layers,
    fp32, B 2 x S 640: two kv chunks, the last ragged) against the CPU; then
    all 24 layers at B 4 x S 1024 in bf16 compute through ``TrainLoop`` for 8
    steps with a checkpoint every 4, a restart from the step-4 checkpoint
    bit-identical to the uninterrupted run, one step run twice bit-identical,
    and no kernel launched by the train step."""
    import dataclasses
    import os
    import shutil
    import statistics
    import tempfile

    torch = ctx.torch
    from repro_torch.checkpoint import latest_step
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import block_spmm as bsp
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_leaf as fl
    from repro_torch.models import model as model_mod
    from repro_torch.runtime import TrainLoop
    from repro_torch.tree import tree_leaves

    t = sizes["train"]
    cfg = reduced_config("qwen2-0.5b") if sizes["lm_reduced"] else get_config("qwen2-0.5b")
    parity = train_parity(ctx, dataclasses.replace(cfg, num_layers=t["parity_layers"]), t)
    if ctx.dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    B, S, steps, every = t["batch"], t["seq"], t["steps"], t["ckpt_every"]
    pipe = TokenPipeline(cfg, batch=B, seq=S, seed=0)
    step = model_mod.make_train_step(cfg, compute_dtype=torch.bfloat16, lr_peak=TRAIN_LR,
                                     warmup=1, total_steps=steps)
    quiet = dict(log_every=steps, log=lambda *_: None)
    ckpt = tempfile.mkdtemp(prefix="lm_train_ckpt_")  # outside the repo: each save is the state
    run_dir = os.path.join(ckpt, "run")
    try:
        t0 = time.perf_counter()
        state = model_mod.init_train_state(cfg, seed=0, device=ctx.dev)
        ctx.sync()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in tree_leaves(state["params"]))
        state_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(state))
        remat = train_remat(ctx, cfg, state, pipe.global_batch(0))
        if ctx.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        bsp.launches = fl.launches = fa.launches = 0  # the main path's count starts here
        loop = TrainLoop(step, pipe, run_dir, ckpt_every=every)
        t0 = time.perf_counter()
        final, hist = loop.run(state, 0, steps, **quiet)
        run_s = time.perf_counter() - t0
        launches = dict(block_spmm=bsp.launches, fused_block_spmm=fl.launches,
                        flash_attention=fa.launches)  # ... and is read here
        peak = torch.cuda.max_memory_allocated() if ctx.dev.type == "cuda" else None
        del state
        losses = [h["loss"] for h in hist]
        gnorms = [h["grad_norm"] for h in hist]
        check(launches == dict(block_spmm=0, fused_block_spmm=0, flash_attention=0),
              f"lm_train: the train step launched kernels {launches}")
        check(all(map(math.isfinite, losses + gnorms)), "lm_train: a non-finite loss or norm")
        check(losses[-1] < TRAIN_LEARN_SHARE * losses[0],
              f"lm_train: loss {losses[0]} at step 0, {losses[-1]} at step {steps - 1}")
        # per-step statistics beside the whole window's rate
        median_ms = statistics.median(loop.step_seconds[1:]) * 1e3
        # steps 1 .. every - 1 run with no checkpoint being written beside them
        quiet_ms = statistics.median(loop.step_seconds[1:every]) * 1e3
        ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                         for d, _, fs in os.walk(run_dir) for f in fs)
        free_bytes = shutil.disk_usage(ckpt).free

        # a crash after step `every`'s checkpoint: a new loop resumes there
        for name in os.listdir(run_dir):
            if int(name.split("_")[1]) > every:
                shutil.rmtree(os.path.join(run_dir, name))
        check(latest_step(run_dir) == every, f"lm_train: latest checkpoint {latest_step(run_dir)}")
        loop2 = TrainLoop(step, pipe, run_dir, ckpt_every=every)
        t0 = time.perf_counter()
        resumed, start = loop2.resume_or_init(final)  # the final state: only its shapes count
        ctx.sync()
        restore_s = time.perf_counter() - t0
        check(start == every, f"lm_train: resumed at step {start}, expected {every}")
        resumed, hist2 = loop2.run(resumed, start, steps - start, **quiet)
        restart_identical = all(torch.equal(a, b) for a, b in zip(tree_leaves(final),
                                                                   tree_leaves(resumed)))
        check(restart_identical, "lm_train: the resumed run does not end bit-identical")
        check([h["loss"] for h in hist2] == losses[start:], "lm_train: resumed losses differ")
        del resumed

        # step 0's batch scored again at the final parameters: one batch, before and after
        loss_fn = model_mod.make_loss_fn(cfg, compute_dtype=torch.bfloat16)
        with torch.no_grad():
            batch0 = {k: torch.from_numpy(v).to(ctx.dev) for k, v in pipe.global_batch(0).items()}
            batch0_after = float(loss_fn(final["params"], batch0)[0])
        del batch0
        check(batch0_after < TRAIN_LEARN_SHARE * losses[0],
              f"lm_train: batch 0's loss {losses[0]} at the initial parameters, "
              f"{batch0_after} at the final ones")

        batch = pipe.global_batch(steps)
        a, ma = step(final, batch)
        b, mb = step(final, batch)
        repeat_identical = all(torch.equal(x, y) for x, y in zip(tree_leaves([a, ma]),
                                                                  tree_leaves([b, mb])))
        check(repeat_identical, "lm_train: two runs of one step differ")
        del a, b
        prof = profile_device(ctx, lambda: step(final, batch), top=12)
        del final
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    tokens = B * S
    tokens_per_s = steps * tokens / run_s  # the whole window: step 0 and the checkpoints in it
    out = dict(phase="lm_train", parity=parity, arch=cfg.name, layers=cfg.num_layers,
               d_model=cfg.d_model, vocab=cfg.vocab_size, params=n_params, state_bytes=state_bytes,
               remat_config=cfg.remat, remat=remat,
               batch=B, seq=S, tokens_per_step=tokens, compute="bfloat16", params_dtype="float32",
               lr_peak=TRAIN_LR, steps=steps, ckpt_every=every, init_s=init_s, run_s=run_s,
               losses=losses, batch0_loss_after=batch0_after, learn_share=TRAIN_LEARN_SHARE,
               grad_norms=gnorms, step_ms=[x * 1e3 for x in loop.step_seconds],
               tokens_per_s=tokens_per_s, ms_per_step=run_s / steps * 1e3,
               ms_per_step_median=median_ms, ms_per_step_no_ckpt_write=quiet_ms,
               mfu=6 * n_params * tokens_per_s / BF16_FLOPS if not ctx.rehearse else None,
               mfu_formula=f"6 * {n_params} params * {steps} * {tokens} tokens / run_s / "
                           f"{BF16_FLOPS:.3g}",
               max_memory_allocated=peak, launches=launches,
               ckpt=dict(bytes=ckpt_bytes, free_bytes=free_bytes,
                         snapshot_s=loop.manager.snapshot_seconds,
                         write_s=loop.manager.write_seconds, restore_s=restore_s,
                         dir_under=os.path.dirname(ckpt)),
               restart_bit_identical=restart_identical, resumed_at=start,
               repeat_bit_identical=repeat_identical, profiled_step=prof,
               retries=loop.retries + loop2.retries, stragglers=loop.straggler.events)
    emit(out)
    return out


# the serving families (the MoE, RG-LRU and SSD blocks): (arch, layers at full
# width, layers in the rehearsal); qwen3-moe and recurrentgemma are cut in depth
FAMILIES = (("qwen3-moe-235b-a22b", 2, 2), ("recurrentgemma-9b", 5, 5), ("mamba2-370m", 48, 4))
# a router margin between a token's k-th and (k+1)-th probability below this
# share of the k-th is within fp32 rounding: decode and the forward may pick
# either expert there
NEAR_TIE_REL = 1e-6
# decode-step logits against the forward, as a share of max|logits|, for
# every family: the scan families' recurrences against their parallel forms
# held it too (2.2e-6 and 4.2e-6 of max|logits| on an H100 80GB HBM3)
STEP_REL = 1e-4


#: the dry run's predicted peaks must lie within this share of the card's
DRYRUN_PEAK_REL = 0.15


def _measured_peak(ctx, fn) -> tuple:
    """``fn()`` twice (a warm call, then a measured one): ``(the measured call's
    output, its ms, the card's peak bytes above what was allocated before the
    phase built its inputs)``; no peak on the CPU."""
    torch = ctx.torch
    out = fn()
    del out
    if ctx.dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    ctx.sync()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() if ctx.dev.type == "cuda" else None
    return out, ms, peak


def phase_dryrun(ctx, sizes) -> dict:
    """The one-card dry run (``repro_torch.launch.dryrun``: every cell's step on
    fake tensors, no allocation; deep cells extrapolated per period, as the
    sweep and the command line give them) held against the card.  The sweep of all 40
    (arch x shape) cells at full width over worker processes: 31 ``ok``, 9
    ``skipped`` with the reference's reasons, none in ``error``.  Then two
    predictions against real runs: qwen2-0.5b's train step at ``lm_train``'s
    shape (B 4 x S 1024, bf16 compute, fp32 params and AdamW) under
    ``remat="none"`` and ``"full"``, and one decode step of its full
    ``decode_32k`` cell (B 128, a 32,768-position bf16 cache) at position
    32,000: each predicted peak within 15 % of the card's
    ``max_memory_allocated`` above what was allocated before the inputs were
    built, beside the predicted FLOPs over the measured step time and the
    decode step's ms beside its memory term."""
    import dataclasses
    import os

    torch = ctx.torch
    from repro_torch.configs import ARCH_IDS, SHAPES, get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import dryrun
    from repro_torch.models import model as model_mod
    from repro_torch.models import transformer

    d = sizes["dryrun"]
    t0 = time.perf_counter()
    cells = [(a, s, False) for a in ARCH_IDS for s in SHAPES]
    recs = dryrun.run_cells(cells, workers=min(d["workers"], os.cpu_count() or 1))
    sweep_s = time.perf_counter() - t0
    status = {k: sum(r["status"] == k for r in recs) for k in ("ok", "skipped", "error")}
    for r in recs:
        if r["status"] == "skipped":
            check(r["why"] == get_config(r["arch"]).supports(SHAPES[r["shape"]])[1],
                  f"dryrun: {r['arch']} x {r['shape']} skipped for another reason: {r['why']}")
    errors = [f"{r['arch']} x {r['shape']}: {r['error']}" for r in recs if r["status"] == "error"]
    check(not errors, f"dryrun: cells in error: {errors}")
    check(status == dict(ok=31, skipped=9, error=0), f"dryrun: sweep {status}")
    fits = sorted(f"{r['arch']} x {r['shape']}" for r in recs
                  if r["status"] == "ok" and r["fits_one_card"])
    emit(dict(phase="dryrun_sweep", card=ctx.card, cells=len(recs), **status, sweep_s=sweep_s,
              workers=d["workers"], fit_one_card=fits))

    arch = d["arch"]
    over = dryrun.reduced_overrides(arch) if d["reduced"] else {}
    cfg = dataclasses.replace(get_config(arch), **over)
    dev = ctx.dev
    results = {}
    base = torch.cuda.memory_allocated() if dev.type == "cuda" else 0

    # the train step at lm_train's shape, under both remat modes
    tshape = ShapeSpec("lm_train", d["train_seq"], d["train_batch"], "train")
    state = model_mod.init_train_state(cfg, seed=0, device=dev)
    pipe = TokenPipeline(cfg, batch=tshape.global_batch, seq=tshape.seq_len, seed=0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.global_batch(0).items()}
    for remat in ("none", "full"):
        pred = dryrun.lower_cell(arch, tshape, cfg_overrides={**over, "remat": remat})
        step = model_mod.make_train_step(dataclasses.replace(cfg, remat=remat),
                                         compute_dtype=torch.bfloat16)

        def run():
            new, m = step(state, batch)
            float(m["loss"])
            return new

        out, ms, peak = _measured_peak(ctx, run)
        del out
        results[f"train_remat_{remat}"] = dict(
            extrapolation=pred["extrapolation"], predicted_peak_bytes=pred["peak_bytes_card"],
            measured_peak_bytes=
            None if peak is None else peak - base, predicted_flops=pred["flops"], step_ms=ms,
            predicted_flops_per_s=pred["flops"] / (ms / 1e3), compute_term_s=pred["compute_term_s"],
            memory_term_s=pred["memory_term_s"], peak_by_phase=pred["peak_bytes_by_phase"])
    del state, batch
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # one decode step of the decode cell at full size
    dshape = (SHAPES[d["decode_shape"]] if not d["reduced"]
              else ShapeSpec("decode_rehearsal", d["decode_seq"], d["decode_batch"], "decode"))
    pred = dryrun.lower_cell(arch, dshape, cfg_overrides=over or None, pos=d["decode_pos"])
    check(pred["fits_one_card"], f"dryrun: {arch} x {dshape.name} is predicted not to fit")
    params = model_mod.cast_params(transformer.init_params(cfg, seed=0, device=dev), torch.bfloat16)
    cache = transformer.init_cache(cfg, dshape.global_batch, dshape.seq_len, torch.bfloat16,
                                   device=dev)
    gen = torch.Generator(device="cpu").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (dshape.global_batch, 1), generator=gen).to(dev)
    serve = model_mod.make_serve_step(cfg)
    pos = iter((d["decode_pos"] - 1, d["decode_pos"]))  # a warm step, then the measured one

    def decode():
        logits, _ = serve(params, cache, tokens, next(pos))
        return logits

    logits, ms, peak = _measured_peak(ctx, decode)
    check(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (
        dshape.global_batch, 1, cfg.vocab_size), "dryrun: the decode step's logits")
    del logits, params, cache
    results["decode"] = dict(
        shape=dshape.name, batch=dshape.global_batch, cache=dshape.seq_len, pos=d["decode_pos"],
        extrapolation=pred["extrapolation"], predicted_peak_bytes=pred["peak_bytes_card"],
        measured_peak_bytes=None if peak is None else peak - base, step_ms=ms,
        memory_term_ms=pred["memory_term_s"] * 1e3, compute_term_ms=pred["compute_term_s"] * 1e3,
        predicted_bytes=pred["bytes"], predicted_flops=pred["flops"])
    for name, r in results.items():
        if r["measured_peak_bytes"] is None:
            continue
        r["peak_rel_err"] = r["predicted_peak_bytes"] / r["measured_peak_bytes"] - 1.0
        check(abs(r["peak_rel_err"]) <= DRYRUN_PEAK_REL,
              f"dryrun: {name} predicted {r['predicted_peak_bytes']} bytes at peak, the card "
              f"{r['measured_peak_bytes']} ({r['peak_rel_err']:+.1%})")
    out = dict(phase="dryrun", card=ctx.card, arch=arch, sweep_s=sweep_s, **status, **results)
    emit(out)
    return out


def grouped_gemm_plain(x, sizes, w):
    """The dropless grouped GEMM's plain version: ``x[rows of g] @ w[g]`` per group."""
    import torch

    out = torch.empty((x.shape[0], w.shape[2]), dtype=torch.float32, device=x.device)
    lo = 0
    for g, n in enumerate(sizes):
        out[lo:lo + n] = torch.matmul(x[lo:lo + n].float(), w[g].float())
        lo += n
    return out


def phase_moe_layer(ctx, sizes) -> dict:
    """One MoE layer of qwen3-moe-235b-a22b at full width (d 4096, 128 experts,
    d_ff 1536, top 8, SwiGLU) on B 2 x S 4096 tokens at capacity factor 1.25:
    the expert GEMMs through ``block_spmm`` (one task per expert), then the
    same layer's dropless pairs through ``grouped_gemm_varsize``."""
    import math

    import numpy as np

    torch = ctx.torch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels import block_spmm as bsp
    from repro_torch.kernels import ops
    from repro_torch.models import moe

    arch = "qwen3-moe-235b-a22b"
    cfg = reduced_config(arch) if sizes["lm_reduced"] else get_config(arch)
    D, F, E, K = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.top_k
    B, S = LM_BATCH, sizes["lm_seq"]
    T = B * S
    cap = math.ceil(T * K * 1.25 / E)
    gen = torch.Generator(device=ctx.dev).manual_seed(19)
    p = moe.moe_init(gen, D, F, E, cfg.mlp_act)
    x = torch.randn((B, S, D), generator=gen, device=ctx.dev)
    kw = dict(num_experts=E, top_k=K, act=cfg.mlp_act, capacity_factor=1.25)
    calls = []
    block_spmm = ops.block_spmm

    def recording(a_data, b_data, *args, **kwargs):
        out = block_spmm(a_data, b_data, *args, **kwargs)
        calls.append((a_data, b_data, args, out))
        return out

    ops.block_spmm = recording
    try:
        with torch.inference_mode():
            bsp.launches = 0  # the main path's count starts here
            out = moe.moe_apply(p, x, gemm_impl="block_spmm", **kw)
            ctx.sync()
            launches = bsp.launches  # ... and is read here
            gemms = list(calls)
            again = moe.moe_apply(p, x, gemm_impl="block_spmm", **kw)
            ref = moe.moe_apply(p, x, gemm_impl="einsum", **kw)
            ctx.sync()
            identical = bool(torch.equal(out, again))
            omax = float(out.abs().max())
            layer_err = float((out - ref).abs().max())
            del again, ref
            check(launches == (0 if ctx.rehearse else 3),
                  f"moe_layer: the block_spmm route launched {launches} kernels, expected 3")
            check(identical, "moe_layer: two block_spmm MoE layers differ")
            check(bool(torch.isfinite(out).all()) and layer_err <= 1e-4 * omax,
                  f"moe_layer: block_spmm route off the einsum route by {layer_err} > 1e-4 * {omax}")

            # each expert GEMM against the kernel's plain version, and timed beside torch.bmm
            kernel = bsp.block_spmm_ref if ctx.rehearse else bsp.block_spmm_cuda
            idx = np.arange(E)
            tasks = ops.task_arrays(idx, idx, idx, E, ctx.dev)
            rows = []
            for name, (a, b, _, got) in zip(("w1", "wg", "w2"), gemms, strict=True):
                want = bsp.block_spmm_ref(a, b, *tasks, E)
                tol = block_tolerance(a, b, *tasks)
                excess = float(((got - want).abs().flatten(1).amax(1).double() / tol).max())
                err = float((got - want).abs().max())
                del want
                check(excess <= 1.0, f"moe_layer {name}: kernel off its plain version by {excess} of the limit")
                ms = ctx.time_ms(lambda a=a, b=b: kernel(a, b, *tasks, E), reps=5)
                bmm_ms = ctx.time_ms(lambda a=a, b=b: torch.bmm(a, b), reps=5)
                M, Kd, N = a.shape[1], a.shape[2], b.shape[2]
                bound = gemm_bound(E, M, Kd, N, E, E, E, a.element_size())
                rows.append(dict(gemm=name, shape=f"[{E}, {M}, {Kd}] x [{E}, {Kd}, {N}]",
                                 engine=bsp.tile_engine(M, Kd, N, (a, b)),
                                 max_abs_err=err, err_over_limit=excess, ms=ms, bmm_ms=bmm_ms,
                                 bmm="torch.bmm on the same operands (one task per expert)",
                                 bound_share=bound["bound_ms"] / ms, **bound))
            calls.clear()
            del gemms, out

            # the same layer's dropless pairs, sorted by expert, through the grouped GEMM
            gates, experts = moe.route(x, p["router"], K)
            pe = experts.reshape(-1)
            order = torch.argsort(pe, stable=True)
            tokens = x.reshape(T, D)[torch.arange(T, device=ctx.dev).repeat_interleave(K)[order]]
            group_sizes = torch.bincount(pe, minlength=E).cpu().numpy()
            bsp.launches = 0  # the main path's count starts here
            grouped = ops.grouped_gemm_varsize(tokens, group_sizes, p["w1"])
            ctx.sync()
            grouped_launches = bsp.launches  # ... and is read here
            check(grouped_launches == (0 if ctx.rehearse else 1),
                  f"moe_layer: grouped_gemm_varsize launched {grouped_launches} kernels, expected 1")
            (a_data, b_data, (a_idx, b_idx, c_idx, nt), _), = calls
            g_again = ops.grouped_gemm_varsize(tokens, group_sizes, p["w1"])
            plain = grouped_gemm_plain(tokens, group_sizes, p["w1"])
            ctx.sync()
            g_identical = bool(torch.equal(grouped, g_again))
            # per row: REL * ||x_r|| ||w_g||_F, the block limit of a one-row task
            wnorm = torch.linalg.matrix_norm(p["w1"].double())
            row_group = torch.repeat_interleave(torch.arange(E, device=ctx.dev),
                                                torch.from_numpy(group_sizes).to(ctx.dev))
            row_tol = REL * torch.linalg.vector_norm(tokens.double(), dim=1) * wnorm[row_group]
            g_excess = float(((grouped - plain).abs().amax(1).double() / row_tol).max())
            g_err = float((grouped - plain).abs().max())
            del g_again, plain
            check(g_identical, "moe_layer: two grouped GEMMs differ")
            check(g_excess <= 1.0, f"moe_layer: grouped GEMM off its plain version by {g_excess} of the limit")
            g_tasks = ops.task_arrays(np.arange(len(b_idx)), b_idx, c_idx, nt, ctx.dev)
            g_ms = ctx.time_ms(lambda: kernel(a_data, b_data, *g_tasks, nt), reps=3)
            # the same launch forced through Tile64, the engine before TileRows: the same bits
            tile64 = gemm_engine(ctx, bsp, "tile64")
            g_same = bool(torch.equal(kernel(a_data, b_data, *g_tasks, nt),
                                      tile64(a_data, b_data, *g_tasks, nt)))
            check(g_same, "moe_layer: the grouped GEMM's TileRows and Tile64 launches differ")
            g_tile64_ms = ctx.time_ms(lambda: tile64(a_data, b_data, *g_tasks, nt), reps=2)
            g_call_ms = ctx.time_ms(lambda: ops.grouped_gemm_varsize(tokens, group_sizes, p["w1"]), reps=3)
            loop_ms = ctx.time_ms(lambda: grouped_gemm_plain(tokens, group_sizes, p["w1"]), reps=3)
            # the work this run's rows need: T * K real rows, x read and out written once
            ops_ = 2.0 * T * K * D * F
            nbytes = 4 * (T * K * D + E * D * F + T * K * F)
            t_ops, t_bytes = ops_ / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
            tiles = int(nt)
            boundary = int(len(b_idx) - np.unique(np.asarray(c_idx)).size)
            # TileRows' steps on this task list (the kernel's rule, on the host)
            pack = bsp.rows_pack(8, F)
            steps = bsp.packed_steps(bsp.task_runs(np.asarray(c_idx), tiles), np.asarray(b_idx), pack)
            n_groups = -(-tiles // pack)
            multi = int((np.bincount([g for g, _ in steps], minlength=n_groups) > 1).sum())
    finally:
        ops.block_spmm = block_spmm
    out = dict(phase="moe_layer", arch=cfg.name, d_model=D, experts=E, d_ff=F, top_k=K,
               act=cfg.mlp_act, tokens=T, capacity=cap, launches=launches + grouped_launches,
               block_spmm_route_launches=launches, max_abs_out=omax,
               max_abs_block_spmm_minus_einsum=layer_err, tol=1e-4 * omax,
               bit_identical_on_repeat=identical, gemms=rows,
               grouped=dict(rows=T * K, groups=E, empty_groups=int((group_sizes == 0).sum()),
                            tile_m=8, tiles=tiles, tasks=len(b_idx), extra_boundary_tasks=boundary,
                            engine=bsp.tile_engine(8, D, F, (a_data, b_data)), pack=pack,
                            packed_tiles=n_groups, packed_steps=len(steps), multi_step_tiles=multi,
                            live_step_row_share=len(b_idx) / (len(steps) * pack),
                            launches=grouped_launches, bit_identical_on_repeat=g_identical,
                            bit_identical_to_tile64=g_same, tile64_kernel_ms=g_tile64_ms,
                            speedup_over_tile64=g_tile64_ms / g_ms,
                            max_abs_err=g_err, err_over_limit=g_excess, kernel_ms=g_ms,
                            call_ms=g_call_ms, per_group_matmul_ms=loop_ms,
                            per_group_matmul=f"{E} torch.matmul calls, yardstick only",
                            bound_ms=max(t_ops, t_bytes) * 1e3,
                            bound_by="operations" if t_ops >= t_bytes else "bytes",
                            bound_arithmetic=(f"max(2*{T * K}*{D}*{F} op / 67e12 op/s = "
                                              f"{t_ops * 1e3:.4f} ms, {nbytes} B / 3.35e12 B/s = "
                                              f"{t_bytes * 1e3:.4f} ms)"),
                            bound_share=max(t_ops, t_bytes) * 1e3 / g_ms))
    emit(out)
    return out


def family_config(arch: str, layers: int, reduced: bool):
    """The serving family's config, cut to ``layers`` in depth."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config

    cfg = reduced_config(arch) if reduced else get_config(arch)
    return dataclasses.replace(cfg, num_layers=layers)


def router_margins(calls, top_k: int):
    """``[B, S]`` bool: a position where some MoE layer's k-th and (k+1)-th
    router probabilities lie within :data:`NEAR_TIE_REL` of each other."""
    import torch

    near = None
    for x, router in calls:
        xf = x.reshape(-1, x.shape[-1])
        probs = torch.softmax((xf @ router.to(xf.dtype)).float(), dim=-1)
        top = probs.topk(top_k + 1, dim=-1).values
        tie = (top[:, top_k - 1] - top[:, top_k]) <= NEAR_TIE_REL * top[:, top_k - 1]
        tie = tie.reshape(x.shape[:2])
        near = tie if near is None else near | tie
    return near


def phase_lm_families(ctx, sizes) -> dict:
    """The MoE, RG-LRU and SSD families at full width: a forward at B 2 x S 4096,
    then ``generate`` (4 requests, prompt 8, 32 new tokens, fp32) confirmed by
    a forward over the generated sequences."""
    import dataclasses

    import numpy as np

    torch = ctx.torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import generate
    from repro_torch.models import moe
    from repro_torch.models import transformer
    from repro_torch.tree import tree_leaves

    B, S = LM_BATCH, sizes["lm_seq"]
    R, P, G = SERVE
    rows, launches = [], 0
    for arch, full_layers, rehearsal_layers in FAMILIES:
        cfg = family_config(arch, rehearsal_layers if sizes["lm_reduced"] else full_layers,
                            sizes["lm_reduced"])
        kinds = transformer.layer_kinds(cfg)
        per_flash = 0 if ctx.rehearse else kinds.count("attn")
        if ctx.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = transformer.init_params(cfg, seed=0, device=ctx.dev)
        ctx.sync()
        init_s = time.perf_counter() - t0
        numels = [t.numel() for t in tree_leaves(params)]
        row = dict(arch=cfg.name, layers=cfg.num_layers, kinds=sorted(set(kinds)),
                   d_model=cfg.d_model, vocab=cfg.vocab_size, params=sum(numels),
                   param_bytes=4 * sum(numels), init_s=init_s, batch=B, seq=S)
        tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
        inputs = {"tokens": torch.from_numpy(tokens).to(ctx.dev)}
        with torch.inference_mode():
            fa.launches = 0  # the main path's count starts here
            fa.launches_by_dtype.update(float32=0, bfloat16=0)
            transformer.apply(params, cfg, inputs, attn_impl="flash")  # warm: allocator, cuBLAS
            ctx.sync()
            t0 = time.perf_counter()
            logits = transformer.apply(params, cfg, inputs, attn_impl="flash")
            ctx.sync()
            row["forward_s"] = time.perf_counter() - t0
            fwd_launches = fa.launches
            check(fwd_launches == 2 * per_flash,
                  f"{arch}: two flash forwards launched the flash kernel {fwd_launches} times, "
                  f"expected {2 * per_flash}")
            lmax = float(logits.abs().max())
            row.update(forward_tokens_per_s=B * S / row["forward_s"], max_abs_logit=lmax,
                       finite=bool(torch.isfinite(logits).all()),
                       shape=list(logits.shape))
            check(row["finite"] and row["shape"] == [B, S, cfg.vocab_size],
                  f"{arch} forward: non-finite logits or shape {row['shape']}")
            if "attn" in kinds:
                direct = transformer.apply(params, cfg, inputs, attn_impl="direct")
                err = float((logits - direct).abs().max())
                del direct
                row.update(max_abs_flash_minus_direct=err, flash_tol=1e-4 * lmax)
                check(err <= 1e-4 * lmax, f"{arch} forward: flash off direct by {err} > 1e-4 * {lmax}")
            del logits
            row["forward_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                         if ctx.dev.type == "cuda" else None)

        prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (R, P))
        generate(cfg, params, prompts[:, :2], 2, device=ctx.dev)  # warm-up
        ctx.sync()
        t0 = time.perf_counter()
        seqs, steps = generate(cfg, params, prompts, G, dtype=torch.float32, device=ctx.dev,
                               return_logits=True)
        ctx.sync()
        secs = time.perf_counter() - t0
        n_steps = P + G - 1
        check(seqs.shape == (R, P + G) and np.array_equal(seqs[:, :P], prompts),
              f"{arch}: generate returned {seqs.shape}, or not the prompts")
        # the confirming forward is dropless, as decode is
        confirm_cfg = (dataclasses.replace(cfg, moe_capacity_factor=cfg.num_experts / cfg.top_k)
                       if cfg.is_moe else cfg)
        calls = []
        moe_apply = moe.moe_apply

        def recording(p, x, **kw):
            calls.append((x, p["router"]))
            return moe_apply(p, x, **kw)

        moe.moe_apply = recording
        try:
            with torch.inference_mode():
                before = fa.launches
                full = transformer.apply(params, confirm_cfg,
                                         {"tokens": torch.from_numpy(seqs).to(ctx.dev)},
                                         attn_impl="flash")[:, :-1].float()
                ctx.sync()
                near = (router_margins(calls, cfg.top_k)[:, :-1] if calls
                        else torch.zeros(full.shape[:2], dtype=torch.bool, device=ctx.dev))
        finally:
            moe.moe_apply = moe_apply
        check(fa.launches - before == per_flash,
              f"{arch}: the confirming forward launched {fa.launches - before} flash kernels")
        fam_launches = fa.launches  # ... and is read here
        check(fa.launches_by_dtype["float32"] == fam_launches,
              f"{arch}: flash launches by type {dict(fa.launches_by_dtype)}, all fp32 expected")
        launches += fam_launches
        lmax = float(full.abs().max())
        keep = ~near
        err = float((full - steps).abs().amax(-1)[keep].max())
        check(err <= STEP_REL * lmax,
              f"{arch}: decode-step logits off the forward by {err} > {STEP_REL} * {lmax}")
        gen_logits = full[:, P - 1:]
        top2 = gen_logits.topk(2, dim=-1).values
        decided = ((top2[..., 0] - top2[..., 1]) > STEP_REL * lmax) & keep[:, P - 1:]
        agree = gen_logits.argmax(-1).cpu().numpy() == seqs[:, P:]
        decided = decided.cpu().numpy()
        check(bool(agree[decided].all()), f"{arch}: a generated token is not the forward's argmax")
        row.update(gen=dict(batch=R, prompt_len=P, new_tokens=G, dtype="float32", seconds=secs,
                            decode_steps=n_steps, ms_per_decode_step=secs * 1e3 / n_steps,
                            generated_tokens_per_s=R * G / secs,
                            confirming_forward=("dropless: moe_capacity_factor = num_experts / "
                                                f"top_k = {confirm_cfg.moe_capacity_factor}")
                            if cfg.is_moe else "as the forward",
                            near_tie_positions=int(near.sum()), positions=int(near.numel()),
                            near_tie_rel=NEAR_TIE_REL, excluded_positions=int(near.sum()),
                            max_abs_logit=lmax, max_abs_step_minus_forward=err,
                            step_err_over_max_logit=err / lmax, limit_rel=STEP_REL,
                            tokens_checked=int(decided.sum()), tokens_total=int(decided.size),
                            first_sequence=seqs[0].tolist()),
                   flash_launches=fam_launches,
                   peak_bytes=torch.cuda.max_memory_allocated() if ctx.dev.type == "cuda" else None)
        rows.append(row)
        del params, full, steps
        if ctx.dev.type == "cuda":
            torch.cuda.empty_cache()
    out = dict(phase="lm_families", launches=launches, launches_by_dtype=dict(float32=launches),
               families=rows)
    emit(out)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rehearse", action="store_true",
                   help="tiny sizes on the CPU with the plain versions (no card, no nvcc)")
    args = p.parse_args(argv)

    import torch

    if not args.rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; use --rehearse for the CPU rehearsal", file=sys.stderr)
        return 2
    if not args.rehearse:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True)
        print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = Context(torch, args.rehearse)
    if not args.rehearse:
        ctx.card = smi.stdout.strip().splitlines()[0]
    sizes = REHEARSAL if args.rehearse else FULL
    t0 = time.perf_counter()

    def phase(fn, *args):
        out = fn(*args)
        if ctx.dev.type == "cuda":
            torch.cuda.empty_cache()
        return out

    phase(phase_build, ctx)
    phase(phase_analysis, ctx)
    kern = phase(phase_kernel, ctx, sizes)
    fused = phase(phase_fused_kernel, ctx, sizes)
    mul = phase(phase_multiply, ctx, sizes)
    sp2 = phase(phase_sp2, ctx, sizes)
    dmul = phase(phase_dist_multiply, ctx, sizes)
    wscale = phase(phase_weak_scaling, ctx, sizes)
    dspamm = phase(phase_dist_spamm, ctx, sizes)
    dpipe = phase(phase_dist_pipeline, ctx, sizes)
    douter = phase(phase_dist_outer, ctx, sizes)
    dobs = phase(phase_dist_observatory, ctx, sizes)
    del ctx.pipeline_d
    seqs = phase(phase_sequences, ctx, sizes)
    flash = phase(phase_flash_kernel, ctx, sizes)
    model = lm_model(ctx, sizes)
    fwd = phase(phase_lm_forward, ctx, sizes, model)
    serve = phase(phase_lm_serve, ctx, model)
    del model
    phase(phase_lm_train, ctx, sizes)
    phase(phase_dryrun, ctx, sizes)
    moe_layer = phase(phase_moe_layer, ctx, sizes)
    families = phase(phase_lm_families, ctx, sizes)
    phase(phase_examples, ctx)
    phase(phase_dist_pipeline_profile, ctx, sizes)

    timing, ftiming = kern["timing"], fused["timing"]
    flash_t = flash["timing"][FLASH_TIMED[0]]  # qwen2-0.5b's layer

    def flash_row(dtype):
        t = flash_t[dtype]
        bf16 = dtype == "bfloat16"
        return dict(name=f"flash_attention_{'bf16' if bf16 else 'f32'}", route="cuda",
                    source="src/repro_torch/kernels/csrc/flash_attention.cu",
                    replaces="src/repro/kernels/flash_attention.py:31",
                    launches=(fwd["launches_by_dtype"][dtype] + serve["launches_by_dtype"][dtype]
                              + families["launches_by_dtype"].get(dtype, 0)),
                    max_abs_err=max(c["max_abs_err"] for c in flash["cases"] if c["dtype"] == dtype),
                    ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=t["bf16_bound_ms"] if bf16 else t["bound_ms"],
                    bound_by=t["bf16_bound_by"] if bf16 else t["bound_by"], library_ms=t["sdpa_ms"])

    emit({"kernels": [
        dict(name="block_spmm", route="cuda", source="src/repro_torch/kernels/csrc/block_spmm.cu",
             replaces="src/repro/kernels/block_spmm.py:38",
             launches=(mul["launches"] + sp2["kernel_launches"] + douter["launches"]
                       + moe_layer["launches"]),
             max_abs_err=max(c["max_abs_err"] for c in kern["cases"]),
             ms=timing["ms"], plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
             bound_by=timing["bound_by"], library_ms=None,
             moe_expert_gemms=[dict(gemm=g["gemm"], shape=g["shape"], ms=g["ms"],
                                    library_ms=g["bmm_ms"], bound_ms=g["bound_ms"],
                                    bound_by=g["bound_by"], max_abs_err=g["max_abs_err"])
                               for g in moe_layer["gemms"]],
             grouped_gemm_varsize={k: moe_layer["grouped"][k] for k in (
                 "tasks", "launches", "engine", "kernel_ms", "tile64_kernel_ms", "call_ms",
                 "per_group_matmul_ms", "bound_ms", "bound_by", "max_abs_err")},
             small_blocks=[dict(case=r["case"], engine=r["engine"], ms=r["ms"],
                                tile64_ms=r["tile64_ms"], plain_ms=r["plain_ms"],
                                bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                                library_ms=r["bmm_yardstick_ms"], max_abs_err=r["max_abs_err"])
                           for r in kern["small_blocks"]]
             + [dict(case="grouped_gemm_varsize", engine=moe_layer["grouped"]["engine"],
                     ms=moe_layer["grouped"]["kernel_ms"],
                     tile64_ms=moe_layer["grouped"]["tile64_kernel_ms"], plain_ms=None,
                     plain="not timed: block_spmm_ref would gather 209 GB of expert weights",
                     bound_ms=moe_layer["grouped"]["bound_ms"],
                     bound_by=moe_layer["grouped"]["bound_by"],
                     library_ms=moe_layer["grouped"]["per_group_matmul_ms"],
                     max_abs_err=moe_layer["grouped"]["max_abs_err"])]),
        dict(name="fused_block_spmm", route="cuda",
             source="src/repro_torch/kernels/csrc/fused_block_spmm.cu",
             replaces="src/repro/kernels/fused_leaf.py:71",
             launches=(dmul["launches"] + wscale["launches"] + dspamm["launches"]
                       + dpipe["launches"] + dobs["launches"] + seqs["launches"]),
             max_abs_err=max(c["max_abs_err"] for c in fused["cases"]),
             ms=ftiming["ms"], plain_ms=ftiming["plain_ms"], bound_ms=ftiming["bound_ms"],
             bound_by=ftiming["bound_by"], library_ms=None,
             small_blocks=[{k: fused["small_block"][k] for k in (
                 "case", "engine", "ms", "tile64_ms", "plain_ms", "bound_ms", "bound_by")}
                 | dict(library_ms=fused["small_block"]["bmm_yardstick_ms"])]),
        flash_row("float32"),
        flash_row("bfloat16"),
    ]})
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    if args.rehearse:
        emit({"ok": True, "rehearsal": True, "device": {"platform": "cpu", "kind": "cpu", "count": 0}})
    else:
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
