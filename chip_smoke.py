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
                      version and ``torch.bmm`` on pre-gathered operands;
                      the bf16 case (bs 128) on the tensor cores (TileTC,
                      the rule for bf16 stores) timed beside Tile128
                      forced, the plain version, ``torch.bmm`` and the
                      card's bound.
   ``autotune``     — the tile autotuner (``kernels/autotune.py``), each
                      shape in a cache of its own: the reference's round trip
                      (pick, tune, drop the memo, pick the winner back up) at
                      bs 8-128 fp32 and bs 128 bf16 on the tuner's default
                      bench (a random list of 2,048 tasks, device time; its
                      winner is not saved unless asked), and on the main
                      path's own lists: the band at bs 128 / 64 / 32 and the
                      grouped GEMM's [8, 4096] @ [4096, 1536]; each
                      candidate's us, the winner and the rule's pair; both
                      GEMM kernels with no engine named launch the winner
                      (``launches_by_tiles``) with the rule's bits, a corrupt
                      cache gives the rule's launch, every candidate the same
                      bits; the rule's launch timed against the tuned one on
                      the random lists at bs 8-64 and the bands (device
                      time; on a band the tuned launch may not be slower by
                      more than 10 %).  Every other phase runs with an
                      empty cache (``REPRO_TORCH_AUTOTUNE_CACHE``, set by
                      ``main``), so their launches are the rule's.
3. ``fused_kernel`` — the fused leaf kernel the same way, on the N = 8192 band
                      planned for 8 workers (fp32, bf16 stores, adaptive,
                      masked tasks), bs 24, no exchange rounds and empty runs;
                      fp32 fused is bit-identical to the staged path
                      (concatenated buffers + ``block_spmm``); the band at
                      bs 64 on 8 workers through TileRows == Tile64 ==
                      the staged path, timed as the bs-64 band above; the
                      bf16 band on TileTC bit-identical to the staged path,
                      timed beside Tile128 forced, the plain version,
                      ``torch.bmm`` and the card's bound.
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
                      cores) against their plain version over nine shapes
                      (qwen2-0.5b's layer, non-causal D 80, D 128 and 256
                      with one kv head, a decode-style suffix, a window,
                      ragged S, fully masked rows, a kimi-k2 mesh rank's
                      layer at D 112), timed on qwen2-0.5b's layer, the
                      D 128, D 256 and D 112 cases in both types
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
    ``dryrun``      — the dry run (``repro_torch.launch.dryrun``: each
                      cell's step on fake tensors, host only): all 40 (arch x
                      shape) cells at full width over worker processes on
                      half the cores, started after ``build`` and running
                      beside the card phases before this one, each
                      also as rank 0 of the 16 x 16 mesh on a fake process
                      group (the 2 x 16 x 16 mesh is the tests' and the
                      command line's), 31 ``ok`` with a finite collective
                      term and 9 ``skipped`` with the reference's reasons,
                      none in ``error``, and the five cells whose collective
                      term is largest against their compute term (a
                      prediction for NVLink and InfiniBand, not measured
                      here); in the same worker pool, qwen2-72b's
                      ``train_4k`` under the hillclimb's ``accum4``, ``sp``
                      and ``sp_accum4`` on 16 x 16, printed beside the
                      sweep's baseline (peak, collective term, calls by
                      kind and axis: sequence parallelism's reduce-scatters
                      over ``model``); then qwen2-0.5b's train step at
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
    ``mesh_serve``  — the mesh path: qwen3-moe-235b-a22b (2 of 94 layers,
                      full width) on a (data 2, model 2) mesh of four ranks
                      sharing the card over gloo (``run_on_mesh``), against
                      one process on the same seeded weights.  One process
                      first (its results saved per rank block, its model
                      freed), then each rank in turn draws the whole model
                      and keeps its blocks under the prefill rules: the
                      expert-parallel MoE layer at B 2 x S 4096 through
                      ``block_spmm`` (3 launches a rank, each held against
                      the kernel's plain version), within 1e-4 of one
                      process's at a capacity where no pair drops (checked
                      from the routing); the prefill ``apply(attn_impl=
                      "flash", ctx=)`` (2 fp32 flash launches a rank, each
                      held against its plain version), each rank's logits
                      block within 1e-4 * max|logits|; the prefill again
                      under sequence parallelism (the prefill rules and
                      ``seq -> model``: the stream cut along its sequence
                      between blocks; 2 more flash launches a rank, the
                      same checks, its row sums over ``model`` turned into
                      reduce-scatters), the two prefills' collectives by
                      kind and axis and seconds side by side;
                      ``reshard_state`` to the decode rules; ``generate_on_mesh`` (4 requests,
                      prompt 8, 32 greedy tokens, fp32) through
                      ``make_serve_step(cfg, ctx)``: tokens equal to one
                      process's unless a request parts at a router or logit
                      near-tie, step logits within 1e-4 * max|logits| up to
                      there.  Backend, ranks per card, collectives per
                      decode step by kind and bytes, ms a step beside one
                      process's, each rank's shard and peak memory.  Then
                      the recurrent families on the same mesh, in one more
                      spawn: recurrentgemma-9b (5 of 38 layers: rec, rec,
                      local, rec, rec) and mamba2-370m (all 48) at full
                      width, one process first and each rank in turn
                      drawing the model, as above; the prefill ``apply(
                      attn_impl="flash", ctx=)`` at B 2 x S 4096 (each
                      rank's logits block within 1e-4 * max|logits|) and
                      ``generate_on_mesh`` as above, with no kernel
                      launched on any rank (the local layer takes the
                      banded path, as one process does); collectives per
                      decode step, ms a step beside one process's and
                      ``lm_families``', each rank's shard and peak.  Each
                      spawn also runs one decode step alone at the served
                      shape (collectives by kind and axis, ms, peak).  Then,
                      in the families' spawn, the ``long_500k`` cell under
                      its rules (B 1 replicated, the KV cache's sequence
                      over ``data``): the cache of 524,288 positions filled
                      from a seed, whole and alike in every process, two
                      greedy runs of 16 steps from positions 522,232 (the
                      2,048-slot ring wraps from data rank 1's slots to
                      rank 0's) and 523,256 (rank 0's slots to rank 1's):
                      each step's logits within 1e-4 * max|logits| of one
                      process on the same cache, the tokens equal, no
                      kernel; collectives and ms a step beside one
                      process's.
    ``mesh_kimi``   — kimi-k2-1t-a32b (1 of 61 layers) at full width in bf16
                      on the same mesh: one process first (drawn leaf by
                      leaf in bf16), then each rank draws its blocks from
                      the same stream (``keep_blocks``); the EP layer
                      (its 192 experts a rank gathered in chunks) through
                      ``block_spmm``, every launch held against its plain
                      version; the prefill with bf16 flash at head_dim 112;
                      the decode rules' blocks drawn; ``generate_on_mesh``
                      in bf16.  The EP layer within 5e-2 * max|x| of one
                      process at every position; the prefill and decode
                      logits the same where the rank routed each token to
                      the experts one process did (the others counted);
                      tokens equal unless a request parts at such a step or
                      where one process's top two logits lie within twice
                      the step's error; all of the ranks' ``block_spmm``
                      launches on TileTC (``launches_by_tiles``); the
                      rank's expert GEMMs timed beside Tile64 forced (the
                      earlier engine) and ``torch.bmm``.
    ``mesh_train``  — the train step on the mesh: qwen2-0.5b at full width on
                      the same (data 2, model 2) mesh of four gloo ranks,
                      under the train rules (FSDP ``embed -> data``, the
                      heads, MLP and vocab over ``model``), B 4 x S 1024
                      from ``TokenPipeline(seed=0)``.  (a) 2 layers, fp32:
                      one process first (its gradients and new state saved
                      whole, its card memory freed), then each rank's
                      ``make_grad_fn`` and one ``make_train_step`` with
                      ``grad_reshard=True`` and ``False``: the two bit for
                      bit; the loss and grad_norm within 1e-5 relative of
                      one process's, every gradient block within 1e-4 *
                      max|g| of its leaf, the mesh's update of one
                      process's gradients within 1e-6 * max|x|, and its
                      own new state within the limits its gradients allow
                      (moments 1e-4 and 2e-4 of their max, parameters
                      2 * lr); then the same under sequence parallelism
                      (``seq -> model``), both modes bit for bit, the same
                      limits.  (b) all 24 layers, bf16 compute, fp32
                      parameters and AdamW, ``remat="full"``: 3 steps in
                      each mode and 3 under sequence parallelism (with
                      ``reduce_scatter``), the median ms of the last 2 beside
                      ``lm_train``'s one process, collectives a step by
                      kind, each rank's peak; step 0's loss within 1e-2 of
                      ``lm_train``'s, one step run twice bit-identical, the
                      two modes' first steps bit-identical, no kernel.
    ``dryrun_mesh`` — the dry run held to the mesh phases: its (data 2,
                      model 2) prediction (``dryrun.measure_on_mesh``, a
                      fake mesh in worker processes) of each step the mesh
                      phases counted — qwen3-moe's decode step,
                      recurrentgemma's and mamba2's at the served shape and
                      under ``long_500k``, qwen2-0.5b's 24-layer train step
                      in both FSDP reductions and under sequence
                      parallelism, kimi-k2's bf16 prefill and decode
                      step — equals every rank's
                      collectives exactly (calls and operand bytes by kind
                      and axis), and each predicted peak lies within 15 %
                      of the rank's measured one.
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
    its launches per type; the launches include ``mesh_serve``'s and
    ``mesh_kimi``'s, listed per rank in ``mesh_launches_per_rank`` and
    ``mesh_kimi_launches_per_rank``; ``block_spmm`` and
    ``fused_block_spmm`` beside ``torch.bmm`` on pre-gathered operands,
    ``block_spmm`` with the tuned winners, its MoE expert GEMMs beside
    ``torch.bmm`` and its grouped GEMM beside its bound), then
    ``{"ok": true, "device": {...}}``.

Any failed check raises, so the run exits non-zero and prints no ``ok`` line.
Without ``--rehearse`` it needs a CUDA card and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
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

# Context.device_ms: the spin that the timed launches queue behind, in SM clock
# cycles (about 10 ms at the H100's 1,980 MHz; 20 launches take the host ~2 ms)
SLEEP_CYCLES = 20_000_000

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
FLASH_TIMED = ("qwen2_0_5b_layer", "d128_hk1", "d256_hk1", "kimi_k2_rank")
FLASH_FULL = {
    "qwen2_0_5b_layer": (2, 14, 2, 4096, 4096, 64, True, None),
    "noncausal_d80": (2, 16, 16, 1024, 1024, 80, False, None),
    "d128_hk1": (1, 16, 1, 2048, 2048, 128, True, None),
    "d256_hk1": (1, 8, 1, 2048, 2048, 256, True, None),
    "suffix_256_of_4096": (2, 14, 2, 256, 4096, 64, True, None),
    "window512_suffix": (1, 14, 2, 1024, 4096, 64, True, 512),
    "ragged_1000": (2, 14, 2, 1000, 1000, 64, True, None),
    "masked_rows": (1, 14, 2, 1000, 600, 64, True, None),
    "kimi_k2_rank": (1, 32, 4, 4096, 4096, 112, True, None),  # a mesh_kimi rank's layer
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
    "kimi_k2_rank": (1, 4, 2, 128, 128, 112, True, None),
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
                        train_seq=1024, decode_shape="decode_32k", decode_pos=32_000),
            autotune=dict(bs=(8, 16, 32, 64, 96, 128), bf16_bs=(128,), tasks=2048, outputs=256,
                          blocks=128, grouped=dict(rows=65_536, d=4096, f=1536, experts=128)))
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
                             decode_seq=64, decode_pos=60),
                 autotune=dict(bs=(8, 16), bf16_bs=(16,), tasks=64, outputs=16, blocks=8,
                               grouped=dict(rows=256, d=64, f=96, experts=8)))


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

    def device_ms(self, fn, reps: int) -> float:
        """Mean device milliseconds of ``fn`` over ``reps`` warm calls: the
        calls are queued behind a spinning kernel (``torch.cuda._sleep``), so
        the card runs them back to back whatever the host takes to launch
        them, and the CUDA events time the card alone.  For launches shorter
        than the host's own cost; the wall clock on the CPU."""
        if self.dev.type != "cuda":
            return self.time_ms(fn, reps)
        fn()
        self.sync()
        start = self.torch.cuda.Event(enable_timing=True)
        end = self.torch.cuda.Event(enable_timing=True)
        self.torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps


def gemm_bound(T, bm, bk, bn, a_blocks, b_blocks, num_out, itemsize, flops=FP32_FLOPS):
    """Least time for the grouped GEMM on an H100: operations or bytes, whichever is larger.

    Operations: 2*T*bm*bn*bk at ``flops`` (the fp32 FFMA rate; bf16 stores
    run on the tensor cores, ``BF16_FLOPS``).  Bytes: every distinct operand
    block read once, the task arrays (two int64 per task plus the int64 run
    offsets), and every output block written once in fp32.
    """
    ops = 2.0 * T * bm * bn * bk
    nbytes = ((a_blocks * bm * bk + b_blocks * bk * bn) * itemsize
              + 8 * (2 * T + num_out + 1) + 4 * num_out * bm * bn)
    t_ops, t_bytes = ops / flops, nbytes / HBM_BYTES_PER_S
    return dict(
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        bound_arithmetic=(f"max(2*{T}*{bm}*{bn}*{bk} op / {flops / 1e12:g}e12 op/s = "
                          f"{t_ops * 1e3:.4f} ms, {nbytes} B / 3.35e12 B/s = {t_bytes * 1e3:.4f} ms)"),
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

    # bf16 stores on the tensor cores (TileTC, the rule's engine for them),
    # timed beside the earlier FFMA engine (Tile128, forced), the plain
    # version and torch.bmm on pre-gathered operands, against the card's bound
    name, A, B, a, b, c, num_out = next(cs for cs in cases if cs[0] == f"runs_bs{mbs}_bf16")
    args = (A, B, *ops.task_arrays(a, b, c, num_out, ctx.dev), num_out)
    engine = bsp.tile_engine(mbs, mbs, mbs, (A, B))
    if not ctx.rehearse:
        check(engine == "tiletc", f"{name}: the rule takes {engine} for bf16 stores, not TileTC")
    lhs, rhs = A[args[2]], B[args[3]]
    bf16_row = dict(case=name, engine=engine, tasks=len(a),
                    ms=ctx.device_ms(lambda: kernel(*args), reps=20),
                    tile128_ms=ctx.device_ms(lambda: gemm_engine(ctx, bsp, "tile128")(*args), reps=20),
                    plain_ms=ctx.time_ms(lambda: bsp.block_spmm_ref(*args), reps=3),
                    bmm_yardstick_ms=ctx.device_ms(lambda: torch.bmm(lhs, rhs), reps=20),
                    timing="device ms: CUDA events on launches queued behind a spin",
                    **gemm_bound(len(a), mbs, mbs, mbs, np.unique(a).size, np.unique(b).size,
                                 num_out, 2, flops=BF16_FLOPS))
    bf16_row["bound_share"] = bf16_row["bound_ms"] / bf16_row["ms"]
    del lhs, rhs

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
    out = dict(phase="kernel", cases=results, timing=timing_row, small_blocks=small,
               bf16_timing=bf16_row)
    emit(out)
    return out


def autotune_random_list(ctx, bs: int, dtype, at: dict, seed: int):
    """A random task list (the tuner's default bench's sizes): the operand
    stacks, the device task arrays and the output count."""
    import numpy as np

    torch = ctx.torch
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=ctx.dev).manual_seed(seed)
    nb, T, nout = at["blocks"], at["tasks"], at["outputs"]
    A = torch.randn((nb, bs, bs), generator=gen, device=ctx.dev).to(dtype)
    B = torch.randn((nb, bs, bs), generator=gen, device=ctx.dev).to(dtype)
    a, b = rng.integers(0, nb, T), rng.integers(0, nb, T)
    c = np.sort(rng.integers(0, nout, T))
    return A, B, ops.task_arrays(a, b, c, nout, ctx.dev), nout


def autotune_grouped_list(ctx, g: dict, seed: int):
    """The dropless grouped GEMM's task list at ``moe_layer``'s shape: rows
    routed at random to the experts, cut into 8-row tiles masked to their
    expert (``ops.grouped_gemm_tasks``); one A block per task, the experts'
    weights as the B stack."""
    import numpy as np

    torch = ctx.torch
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=ctx.dev).manual_seed(seed)
    sizes = np.bincount(rng.integers(0, g["experts"], g["rows"]), minlength=g["experts"])
    a_idx, b_idx, c_idx, lo, hi = ops.grouped_gemm_tasks(sizes, 8)
    nt = -(-g["rows"] // 8)
    x = torch.randn((nt * 8, g["d"]), generator=gen, device=ctx.dev)
    w = torch.randn((g["experts"], g["d"], g["f"]), generator=gen, device=ctx.dev)
    rows = torch.arange(8, device=ctx.dev)
    lo_t, hi_t = (torch.from_numpy(m).to(ctx.dev) for m in (lo, hi))
    sel = (rows[None, :] >= lo_t[:, None]) & (rows[None, :] < hi_t[:, None])
    a_data = (x.view(nt, 8, g["d"])[torch.from_numpy(a_idx).to(ctx.dev)] * sel[:, :, None]).contiguous()
    del x, sel
    tasks = ops.task_arrays(np.arange(a_idx.size), b_idx, c_idx, nt, ctx.dev)
    return a_data, w, tasks, nt


def as_fused(A, B, tasks, nout):
    """One worker's fused-kernel arguments for a ``block_spmm`` task list: every
    operand in the worker's own store, an unused one-block receive stack."""
    import torch

    a_idx, b_idx, run_ptr = tasks
    zero = torch.zeros_like(a_idx)[None]
    return (A[None], A.new_zeros((1, 1, 1) + tuple(A.shape[1:])), B[None],
            B.new_zeros((1, 1, 1) + tuple(B.shape[1:])), zero, a_idx[None], zero.clone(),
            b_idx[None], run_ptr[None], nout)


def autotune_band_list(ctx, bs: int, n: int, hw: int, seed: int):
    """The paper's band (half-bandwidth ``hw`` elements) at leaf ``bs``, cut
    to ``n``: the task list the main path's multiplies run (the ``kernel``
    phase's timing case and small-leaf bands)."""
    torch = ctx.torch
    from repro_torch.core.spgemm import spgemm_symbolic
    from repro_torch.kernels import ops

    gen = torch.Generator(device=ctx.dev).manual_seed(seed)
    coords = band_coords(-(-n // bs), (hw + bs - 1) // bs)
    tasks = spgemm_symbolic(coords, coords)
    A = torch.randn((coords.shape[0], bs, bs), generator=gen, device=ctx.dev)
    return A, A, ops.task_arrays(tasks.a_idx, tasks.b_idx, tasks.c_idx, tasks.num_out, ctx.dev), \
        tasks.num_out


def device_seconds(ctx, fn) -> float:
    """One call of ``fn`` queued behind a spin and timed between CUDA events:
    its device seconds, which the tuner's ``time_call`` takes in place of the
    wall clock."""
    torch = ctx.torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3


def phase_autotune(ctx, sizes) -> dict:
    """The tile autotuner (``repro_torch.kernels.autotune``) on the card, each
    shape in a cache of its own: the reference's round trip (pick, tune over
    ``candidate_tiles``, drop the memo, pick again) for bs 8-128 in fp32 and
    bs 128 in bf16 on the tuner's default bench (a random list, device
    time), whose winner is saved only when asked (``persist=True``); for the
    main path's own lists with a bench over each (device time): the band at
    bs 128 / 64 / 32 and the grouped GEMM's ``[8, 4096] @ [4096, 1536]``.
    Then, per shape, ``block_spmm`` and ``fused_block_spmm`` launched with
    ``engine=None`` run the winner (``launches_by_tiles``) and give the
    rule's bits, a corrupt cache gives the rule's launch, and every candidate
    gives the same bits; the rule's launch is timed against the tuned one on
    the random lists at bs 8-64 and, in both kernels, on the bands, where the
    tuned launch must not be slower than the rule's by more than 10 %.  In
    the rehearsal a plain-version bench exercises the round trip only (no
    kernel, no launch to count)."""
    torch = ctx.torch
    from repro_torch.kernels import autotune
    from repro_torch.kernels import block_spmm as bsp
    from repro_torch.kernels import fused_leaf as fl

    at = sizes["autotune"]
    t0 = time.perf_counter()
    platform = autotune.device_platform(ctx.dev)
    shapes = [(bs, torch.float32) for bs in at["bs"]] + [(bs, torch.bfloat16) for bs in at["bf16_bs"]]
    cases = []
    for i, (bs, dtype) in enumerate(shapes):
        cases.append((f"random_bs{bs}_{str(dtype)[6:]}", (bs, bs, bs), dtype,
                      lambda bs=bs, dtype=dtype, i=i: autotune_random_list(ctx, bs, dtype, at, 30 + i)))
    for i, (bs, n) in enumerate(((sizes["mul_bs"], sizes["time_n"]),) + tuple(sizes["small_bands"])):
        cases.append((f"band_bs{bs}_n{n}", (bs, bs, bs), torch.float32,
                      lambda bs=bs, n=n, i=i: autotune_band_list(ctx, bs, n, sizes["mul_hw"], 50 + i)))
    g = at["grouped"]
    cases.append(("grouped_gemm", (8, g["d"], g["f"]), torch.float32,
                  lambda: autotune_grouped_list(ctx, g, 40)))
    results, cache = [], {}
    saved_env = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    with tempfile.TemporaryDirectory(prefix="autotune_") as tmp:
        try:
            for name, (bm, bk, bn), dtype, make in cases:
                path = os.path.join(tmp, f"{name}.json")
                os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = path  # this case's launches read this cache
                A, B, tasks, nout = make()
                args = (A, B, *tasks, nout)
                fargs = as_fused(A, B, tasks, nout)
                rule = autotune.heuristic_tiles(bm, bk, bn, (A, B))
                cands = autotune.candidate_tiles(bm, bk, bn, (A, B))
                key = autotune.tile_key(platform, bm, bk, bn, dtype)
                random = name.startswith("random")
                if ctx.rehearse:  # no kernel: every candidate runs the plain version
                    bench = lambda e, p: lambda: bsp.block_spmm_ref(*args)  # noqa: E731
                elif random:
                    bench = None  # the tuner's default bench: its own random list
                else:
                    def bench(e, p):
                        return lambda: device_seconds(ctx, lambda: bsp.block_spmm_cuda(*args, engine=e, pack=p))
                autotune.clear_memo()
                before = autotune.pick_tiles(bm, bk, bn, dtype, platform=platform, path=path,
                                             tensors=(A, B))
                row = dict(case=name, shape=[bm, bk, bn], dtype=str(dtype)[6:], tasks=int(tasks[0].numel()),
                           rule=list(rule), pick_before=list(before))
                if bench is None:  # the default bench's winner is reported, not saved
                    unsaved, _ = autotune.autotune_tiles(bm, bk, bn, dtype, candidates=cands,
                                                         platform=platform, path=path)
                    autotune.clear_memo()
                    kept = autotune.pick_tiles(bm, bk, bn, dtype, platform=platform, path=path,
                                               tensors=(A, B))
                    row.update(unsaved_winner=list(unsaved), pick_after_unsaved=list(kept))
                    check(key not in autotune.load_tile_cache(path) and tuple(kept) == tuple(rule),
                          f"autotune {name}: the default bench saved {unsaved} without persist=True")
                best, rows = autotune.autotune_tiles(bm, bk, bn, dtype, bench=bench, candidates=cands,
                                                     platform=platform, path=path, persist=True)
                autotune.clear_memo()
                after = autotune.pick_tiles(bm, bk, bn, dtype, platform=platform, path=path,
                                            tensors=(A, B))
                row.update(candidates=[dict(tiles=list(r["tiles"]), us=r["us"], error=r.get("error"))
                                       for r in rows],
                           winner=list(best), pick_after=list(after), roundtrip_ok=tuple(after) == tuple(best))
                check(tuple(before) == tuple(rule), f"autotune {name}: the empty cache picked {before}, not the rule's {rule}")
                check(row["roundtrip_ok"], f"autotune {name}: picked {after} after tuning, the winner is {best}")
                if dtype == torch.bfloat16 and not ctx.rehearse:  # TileTC's own pair alone has its bits
                    check(cands == [("tiletc", 1)] and tuple(best) == tuple(rule) == ("tiletc", 1),
                          f"autotune {name}: bf16 candidates {cands}, tuned {best}, rule {rule}")
                check(all(r["us"] is not None for r in rows), f"autotune {name}: a candidate failed: {rows}")
                entries = autotune.load_tile_cache(path)
                check(list(entries) == [key], f"autotune {name}: its cache holds {list(entries)}, not {key}")
                cache.update(entries)
                if not ctx.rehearse:
                    # engine=None under the tuned cache launches the winner, in both kernels
                    def launched(fn, *a):
                        counts = (dict(bsp.launches_by_tiles), dict(fl.launches_by_tiles))
                        out = fn(*a)
                        ctx.sync()
                        new = [{k: v - c.get(k, 0) for k, v in m.items() if v != c.get(k, 0)}
                               for m, c in zip((bsp.launches_by_tiles, fl.launches_by_tiles), counts)]
                        return out, new
                    tuned, new = launched(bsp.block_spmm_cuda, *args)
                    check(new == [{tuple(best): 1}, {}], f"autotune {name}: block_spmm launched {new}, the winner is {best}")
                    ftuned, fnew = launched(fl.fused_block_spmm_cuda, *fargs)
                    check(fnew == [{}, {tuple(best): 1}], f"autotune {name}: fused_block_spmm launched {fnew}, the winner is {best}")
                    want = bsp.block_spmm_cuda(*args, engine=rule[0], pack=rule[1])
                    fwant = fl.fused_block_spmm_cuda(*fargs, engine=rule[0], pack=rule[1])
                    ctx.sync()
                    check(torch.equal(tuned, want) and torch.equal(ftuned, fwant),
                          f"autotune {name}: the tuned launch differs from the rule's")
                    check(torch.equal(ftuned[0], want), f"autotune {name}: fused differs from block_spmm")
                    del ftuned, fwant
                    # a corrupt cache file reads as empty: the rule's launch
                    good = open(path).read()
                    with open(path, "w") as fh:
                        fh.write("{not json")
                    autotune.clear_memo()
                    corrupt, new = launched(bsp.block_spmm_cuda, *args)
                    _, fnew = launched(fl.fused_block_spmm_cuda, *fargs)
                    check(new == [{tuple(rule): 1}, {}] and fnew == [{}, {tuple(rule): 1}],
                          f"autotune {name}: a corrupt cache launched {new} / {fnew}, not the rule's {rule}")
                    check(torch.equal(corrupt, want), f"autotune {name}: the corrupt-cache launch differs")
                    with open(path, "w") as fh:
                        fh.write(good)
                    autotune.clear_memo()
                    # every candidate, forced, gives the same bits
                    same = {f"{e}/{p}": bool(torch.equal(bsp.block_spmm_cuda(*args, engine=e, pack=p), want))
                            for e, p in cands}
                    row["candidates_bit_identical"] = all(same.values())
                    check(row["candidates_bit_identical"], f"autotune {name}: the candidates differ: {same}")
                    del tuned, want, corrupt
                    # the rule's launch against the tuned one (engine=None), in turns, device time
                    timed = []
                    if random and bm <= 64 and dtype == torch.float32:
                        timed = [("", bsp.block_spmm_cuda, args, 20)]
                    elif name.startswith("band"):
                        timed = [("", bsp.block_spmm_cuda, args, 5), ("fused_", fl.fused_block_spmm_cuda, fargs, 5)]
                    for prefix, fn, a, reps in timed:
                        ms = {f"{prefix}rule_ms": [], f"{prefix}tuned_ms": []}
                        for which in ("rule", "tuned", "tuned", "rule"):
                            kw = dict(engine=rule[0], pack=rule[1]) if which == "rule" else {}
                            ms[f"{prefix}{which}_ms"].append(ctx.device_ms(lambda: fn(*a, **kw), reps=reps))
                        row.update(ms, **{f"{prefix}speedup_over_rule":
                                          sum(ms[f"{prefix}rule_ms"]) / sum(ms[f"{prefix}tuned_ms"])})
                        if name.startswith("band"):
                            check(row[f"{prefix}speedup_over_rule"] >= 1 / 1.1,
                                  f"autotune {name}: the {prefix or 'block_spmm '}launch tuned on its own "
                                  f"list is slower than the rule's: {ms}")
                results.append(row)
                del A, B, tasks, args, fargs
                if ctx.dev.type == "cuda":
                    torch.cuda.empty_cache()
            # the host's cost of the lookup before a launch that names no engine (a
            # memo hit), and of one stat of the cache file
            A = torch.zeros((1, 8, 8), device=ctx.dev)
            autotune.pick_tiles(8, 8, 8, torch.float32, platform=platform, tensors=(A, A))
            n = 10_000
            t1 = time.perf_counter()
            for _ in range(n):
                autotune.pick_tiles(8, 8, 8, torch.float32, platform=platform, tensors=(A, A))
            pick_us = (time.perf_counter() - t1) * 1e6 / n
            t1 = time.perf_counter()
            for _ in range(n // 10):
                os.stat(path)
            stat_us = (time.perf_counter() - t1) * 1e6 / (n // 10)
        finally:
            if saved_env is None:
                os.environ.pop("REPRO_TORCH_AUTOTUNE_CACHE", None)
            else:
                os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = saved_env
            autotune.clear_memo()
    out = dict(phase="autotune", platform=platform, seconds=time.perf_counter() - t0,
               card=ctx.card, shapes=results, cache_entries=cache, pick_us_per_launch=pick_us,
               stat_us=stat_us, stat_interval_s=autotune.STAT_INTERVAL_S,
               timing="candidate us: device time (CUDA events on launches queued behind a spin), "
                      "10 launches a call with the default bench, one on the bands and the "
                      "grouped GEMM, mean of 3 calls; rule_ms / tuned_ms: CUDA-event means of 20 "
                      "(random) or 5 (band) launches queued behind a spin, in turns rule / tuned / "
                      "tuned / rule")
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


def fused_bound(args, on=None, flops=FP32_FLOPS):
    """Least time for the fused kernel on an H100: operations or bytes.

    Operations: 2*T*bm*bn*bk over the tasks that run, at ``flops`` (the fp32
    FFMA rate; ``BF16_FLOPS`` for bf16 stores on the tensor cores).  Bytes:
    every distinct operand block the tasks reference (own store or receive
    buffer) read once, the four int64 task arrays and the runs, the on flags
    when given, and every output block written once in fp32.
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
    t_ops, t_bytes = ops / flops, nbytes / HBM_BYTES_PER_S
    return dict(tasks=n_tasks, bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_arithmetic=(f"max({ops:.6g} op / {flops / 1e12:g}e12 op/s = {t_ops * 1e3:.4f} ms, "
                                  f"{nbytes} B / 3.35e12 B/s = {t_bytes * 1e3:.4f} ms)"))


def phase_fused_kernel(ctx, sizes) -> dict:
    import numpy as np

    torch = ctx.torch
    from repro_torch.core.distributed import (FusedSpgemmExecutable, MaskedSpgemmExecutable,
                                              SpgemmExecutable, WorkerMesh, shard_stores)
    from repro_torch.core.schedule import make_spgemm_plan
    from repro_torch.kernels import block_spmm as bsp
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

    bf16 = plan_args(plan, data, BF16)
    cases = [
        (f"band_p{P}_bs{mbs}_f32", f32, {}),
        (f"band_p{P}_bs{mbs}_bf16", bf16, {}),
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
    # bf16 stores: the fused kernel and the staged path both on TileTC, bit for bit
    staged_bf16 = SpgemmExecutable(plan, mesh, impl=staged_impl)(bf16[0], bf16[2])
    ctx.sync()
    bf16_eq_staged = bool(torch.equal(outs[cases[1][0]], staged_bf16))
    check(bf16_eq_staged, "bf16 fused kernel is not bit-identical to the staged path")
    small = fused_small_block_case(ctx, plan64, f64, outs[f"band_p{P}_bs64_f32"], mesh, staged_impl)
    small["plan_s"] = plan64_s
    del staged, staged_masked, all_on, outs, f64, staged_bf16

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
    # the bf16 band on TileTC, beside the earlier FFMA engine (Tile128, forced)
    bf16_engine = bsp.tile_engine(mbs, mbs, mbs, bf16[:4])
    if not ctx.rehearse:
        check(bf16_engine == "tiletc", f"fused bf16 band: the rule takes {bf16_engine}, not TileTC")
    bf16_ms = ctx.time_ms(lambda: kernel(*bf16), reps=10)
    tile128_ms = ctx.time_ms(lambda: gemm_engine(ctx, fl, "tile128")(*bf16), reps=5)
    bf16_plain_ms = ctx.time_ms(lambda: fl.fused_block_spmm_ref(*bf16), reps=2)
    lhs = fl._gather(bf16[0], bf16[1], p_idx, bf16[4][p_idx, t_idx], bf16[5][p_idx, t_idx])
    rhs = fl._gather(bf16[2], bf16[3], p_idx, bf16[6][p_idx, t_idx], bf16[7][p_idx, t_idx])
    bf16_bmm_ms = ctx.time_ms(lambda: torch.bmm(lhs, rhs), reps=10)
    del lhs, rhs
    bbound = fused_bound(bf16, flops=BF16_FLOPS)
    bf16_timing = dict(case=cases[1][0], engine=bf16_engine, ms=bf16_ms, tile128_ms=tile128_ms,
                       plain_ms=bf16_plain_ms, bmm_yardstick_ms=bf16_bmm_ms,
                       fused_eq_staged=bf16_eq_staged,
                       tflops=2.0 * bbound["tasks"] * mbs**3 / (bf16_ms * 1e-3) / 1e12,
                       bound_share=bbound["bound_ms"] / bf16_ms, **bbound)
    out = dict(phase="fused_kernel", plan_s=plan_s, a_offsets=list(plan.a_offsets),
               b_offsets=list(plan.b_offsets), tasks_per_worker_min=int(tpw.min()),
               tasks_per_worker_max=int(tpw.max()), masked_share=float(1 - on_np.sum() / valid.sum()),
               low_share=float(low.cpu().numpy()[valid].mean()), cases=results,
               fused_eq_staged=fused_eq_staged, masked_eq_staged=masked_eq_staged,
               masked_all_on_eq_unmasked=all_on_eq, timing=timing, bf16_timing=bf16_timing,
               small_block=small)
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
    A ratio above 1 fails.  One kv head's query heads at a time: the plain
    version's scores stay at ``[B, H / HK, Sq, Sk]`` (on a card four mesh
    ranks share, a kimi-k2 rank's whole layer would hold 2.1 GB of them)."""
    from repro_torch.kernels import flash_attention as fa

    HK = k.shape[1]
    rep = q.shape[1] // HK
    floor = 1e-4 * float(v.float().abs().max())
    err = excess = 0.0
    for h in range(HK):
        heads = slice(h * rep, (h + 1) * rep)
        want = fa.flash_attention_ref(q[:, heads].float(), k[:, h:h + 1].float(),
                                      v[:, h:h + 1].float(), **kw)
        limit = floor if got.dtype == want.dtype else 2.0**-8 * want.abs() + floor
        diff = (got[:, heads].float() - want).abs()
        err = max(err, float(diff.max()))
        excess = max(excess, float((diff / limit).max()))
    return err, excess


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
# the most positions (decode steps) a bf16 run on the mesh may route to other
# experts than one process and leave out of the comparison of its logits
REROUTED_MAX_SHARE = 0.5
# bf16 forward and decode logits against one process, as a share of max|x|
# (the lm_forward phase's bf16 limit)
BF16_REL = 5e-2
# decode-step logits against the forward, as a share of max|logits|, for
# every family: the scan families' recurrences against their parallel forms
# held it too (2.2e-6 and 4.2e-6 of max|logits| on an H100 80GB HBM3)
STEP_REL = 1e-4


#: the dry run's predicted peaks must lie within this share of the card's
DRYRUN_PEAK_REL = 0.15


#: the hillclimb cell and variants the ``dryrun`` phase prints on 16 x 16: sequence
#: parallelism beside the same microbatches without it
HILL_CELL = ("qwen2-72b", "train_4k")
HILL_VARIANTS = ("baseline", "accum4", "sp", "sp_accum4")


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


def _dryrun_sweep_process(cells, workers: int, path: str) -> None:
    """The dry run's sweep in a process of its own (spawned by
    :func:`start_dryrun_sweep`), at a lower scheduling priority, so that it
    takes neither the interpreter lock nor the cores of the card phases it
    runs beside; its records and seconds are pickled to ``path``."""
    import pickle

    from repro_torch.launch import dryrun

    os.nice(10)  # this process and its workers yield the cores to the smoke's
    t0 = time.perf_counter()
    recs = dryrun.run_cells(cells, workers=workers,
                            meshes=("16x16",))  # 2 x 16 x 16: the tests and the command line
    with open(path, "wb") as fh:
        pickle.dump((recs, time.perf_counter() - t0), fh)


def start_dryrun_sweep(sizes) -> dict:
    """Start the dry run's sweep (host only, fake tensors: every (arch x
    shape) cell at full width, each also as rank 0 of the 16 x 16 mesh, and
    the hillclimb's variants of ``HILL_CELL``) in a process of its own over
    half the machine's cores, so that it runs beside the card phases before
    ``dryrun``, which waits for its records (:func:`finish_dryrun_sweep`)."""
    import multiprocessing

    from repro_torch.configs import ARCH_IDS, SHAPES
    from repro_torch.launch import dryrun, hillclimb

    d = sizes["dryrun"]
    cells = [(a, s, False) for a in ARCH_IDS for s in SHAPES]
    # the hillclimb's sequence-parallel records of qwen2-72b's train_4k beside the
    # variants without it (baseline is the sweep's own cell), in the sweep's pool
    hill_over = dryrun.reduced_overrides(HILL_CELL[0]) if d["reduced"] else None
    hill = [(*HILL_CELL, False, hillclimb.variant_kwargs(v, hill_over))
            for v in HILL_VARIANTS[1:]]
    workers = max(1, min(d["workers"], os.cpu_count() or 1) // 2)
    fd, path = tempfile.mkstemp(prefix="chip_smoke_sweep_", suffix=".pkl")
    os.close(fd)
    proc = multiprocessing.get_context("spawn").Process(
        target=_dryrun_sweep_process, args=(cells + hill, workers, path), name="dryrun_sweep")
    proc.start()
    return dict(proc=proc, path=path, cells=len(cells), workers=workers, t0=time.perf_counter())


def finish_dryrun_sweep(sweep: dict):
    """Wait for the sweep's process; ``(records, seconds)``, or raise if it
    failed (``run_phases`` removes its file)."""
    import pickle

    sweep["proc"].join()
    check(sweep["proc"].exitcode == 0, f"dryrun: the sweep's process exited {sweep['proc'].exitcode}")
    with open(sweep["path"], "rb") as fh:
        return pickle.load(fh)


def phase_dryrun(ctx, sizes, sweep) -> dict:
    """The one-card dry run (``repro_torch.launch.dryrun``: every cell's step on
    fake tensors, no allocation; deep cells extrapolated per period, as the
    sweep and the command line give them) held against the card.  The sweep of all 40
    (arch x shape) cells at full width over worker processes
    (:func:`start_dryrun_sweep`, a process running since the start of the card phases):
    31 ``ok``, 9 ``skipped`` with the reference's reasons, none in ``error``.  Then two
    predictions against real runs: qwen2-0.5b's train step at ``lm_train``'s
    shape (B 4 x S 1024, bf16 compute, fp32 params and AdamW) under
    ``remat="none"`` and ``"full"``, and one decode step of its full
    ``decode_32k`` cell (B 128, a 32,768-position bf16 cache) at position
    32,000: each predicted peak within 15 % of the card's
    ``max_memory_allocated`` above what was allocated before the inputs were
    built, beside the predicted FLOPs over the measured step time and the
    decode step's ms beside its memory term."""
    import dataclasses

    torch = ctx.torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import dryrun
    from repro_torch.models import model as model_mod
    from repro_torch.models import transformer

    d = sizes["dryrun"]
    hill_over = dryrun.reduced_overrides(HILL_CELL[0]) if d["reduced"] else None
    t1 = time.perf_counter()
    recs, sweep_s = finish_dryrun_sweep(sweep)
    waited_s = time.perf_counter() - t1
    recs, hill_recs = recs[:sweep["cells"]], recs[sweep["cells"]:]
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
    ok = [r for r in recs if r["status"] == "ok"]
    bad = [f"{r['arch']} x {r['shape']}" for r in ok
           if not (isinstance(r["collective_term_s"], float)
                   and math.isfinite(r["collective_term_s"]))]
    check(not bad, f"dryrun: no finite collective term on 16 x 16 for {bad}")
    on16 = lambda r: r["on_mesh"]["16x16"]  # noqa: E731
    most = sorted(ok, key=lambda r: -on16(r)["collective_term_s"]
                  / max(on16(r)["compute_term_s"], 1e-12))[:5]
    emit(dict(phase="dryrun_sweep", card=ctx.card, cells=len(recs), **status, sweep_s=sweep_s,
              waited_s=waited_s, started_s_before=t1 - sweep["t0"], workers=sweep["workers"],
              fit_one_card=fits, meshes=["16x16"],
              collective_terms="a prediction for NVLink 4 within an 8-card H100 node and one "
                               "400 Gb/s InfiniBand link a card between nodes; this one-card "
                               "machine does not measure it",
              most_collective_bound=[dict(
                  arch=r["arch"], shape=r["shape"],
                  collective_over_compute=on16(r)["collective_term_s"]
                  / max(on16(r)["compute_term_s"], 1e-12),
                  collective_term_s=on16(r)["collective_term_s"],
                  compute_term_s=on16(r)["compute_term_s"],
                  peak_gb_per_device=on16(r)["peak_bytes_card"] / 1e9,
                  wire_bytes_by_kind={k: v["wire_bytes"]
                                      for k, v in on16(r)["collectives_by_kind"].items()})
                  for r in most]))

    hill_base = next(r for r in recs if (r["arch"], r["shape"]) == HILL_CELL)
    if d["reduced"]:  # the rehearsal's sweep is at full width, its variants are not
        hill_base = dryrun.lower_cell(*HILL_CELL, cfg_overrides=hill_over, meshes=("16x16",))
    hill_rows = {}
    for name, r in zip(HILL_VARIANTS, [hill_base, *hill_recs]):
        check(r["status"] == "ok" and math.isfinite(on16(r)["collective_term_s"]),
              f"dryrun: {HILL_CELL} {name}: {r.get('error', r['status'])}")
        by_kind = on16(r)["collectives_by_kind"]
        check(("model" in by_kind.get("reduce_scatter", {}).get("by_axis", {}))
              == name.startswith("sp"), f"dryrun: {HILL_CELL} {name}'s collectives {by_kind}")
        hill_rows[name] = dict(
            grad_accum=r["grad_accum"], rules_override=r.get("rules_override"),
            peak_gb_per_device=on16(r)["peak_bytes_card"] / 1e9,
            collective_term_s=on16(r)["collective_term_s"],
            compute_term_s=on16(r)["compute_term_s"], memory_term_s=on16(r)["memory_term_s"],
            activation_gb_per_device=on16(r)["activation_bytes"] / 1e9,
            calls_by_kind_and_axis={k: {a: v["calls"] for a, v in c["by_axis"].items()}
                                    for k, c in by_kind.items()},
            wire_gb_by_kind={k: c["wire_bytes"] / 1e9 for k, c in by_kind.items()})
    emit(dict(phase="dryrun_hillclimb", card=ctx.card, arch=HILL_CELL[0], shape=HILL_CELL[1],
              mesh="16x16", reduced=d["reduced"], variants=hill_rows,
              note="predictions for 256 H100s on fake tensors; no card measures them"))

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
        pred = dryrun.lower_cell(arch, tshape, cfg_overrides={**over, "remat": remat},
                                 meshes=())  # one card's account
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
    pred = dryrun.lower_cell(arch, dshape, cfg_overrides=over or None, pos=d["decode_pos"],
                             meshes=())
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


#: processes for the dry run's (2, 2) predictions in ``dryrun_mesh``
MESH_PREDICT_WORKERS = 6


def _mesh_prediction(task):
    """One dry-run prediction on the (data 2, model 2) fake mesh, in a worker
    (``chip_smoke`` is re-imported there)."""
    import dataclasses

    name, arch, layers, reduced, shape, kw, cfg_over = task
    from repro_torch.launch import dryrun

    cfg = dataclasses.replace(family_config(arch, layers, reduced), **cfg_over)
    return name, dryrun.measure_on_mesh(cfg, shape, dict(zip(MESH_AXES, MESH_SHAPE)), **kw)


def phase_dryrun_mesh(ctx, sizes, mesh: dict, mesh_train: dict, kimi: dict) -> dict:
    """The dry run's prediction held to the card: its collectives a step on the
    (data 2, model 2) mesh (``dryrun.measure_on_mesh``: the step as rank 0 of
    a fake mesh, on fake tensors) at the shapes ``mesh_serve`` and
    ``mesh_train`` ran must equal what every rank counted running the step
    (calls and operand bytes by kind and axis): qwen3-moe's decode step,
    recurrentgemma's and mamba2's under ``decode_32k`` and ``long_500k``,
    qwen2-0.5b's train step in both FSDP reductions and under sequence
    parallelism, kimi-k2's bf16 prefill (at the ranks' capacity factor) and
    decode step (``mesh_kimi``).  Each predicted peak
    lies within 15 % of the rank's measured one (the step's peak above what
    was allocated before it, plus its inputs)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    torch = ctx.torch
    from repro_torch.configs import SHAPES
    from repro_torch.configs.base import ShapeSpec

    red = sizes["lm_reduced"]
    f32 = dict(param_dtype=torch.float32, kv_dtype=torch.float32, compute_dtype=torch.float32)
    measured, tasks = {}, []
    ds = mesh["decode_step"]
    moe_arch = FAMILIES[0][0]
    tasks.append(("qwen3_moe_decode", moe_arch, mesh["layers"], red,
                  ShapeSpec("decode_32k", ds["cache_len"], ds["batch"], "decode"),
                  dict(f32, pos=ds["pos"]), {}))
    measured["qwen3_moe_decode"] = (ds["collectives_per_rank"], ds["peak_bytes_per_rank"])
    for row in mesh["families"]["rows"]:
        tag = row["arch"].split("-")[0]
        ds = row["decode_step"]
        tasks.append((f"{tag}_decode_32k", row["arch"], row["layers"], red,
                      ShapeSpec("decode_32k", ds["cache_len"], ds["batch"], "decode"),
                      dict(f32, pos=ds["pos"]), {}))
        measured[f"{tag}_decode_32k"] = (ds["collectives_per_rank"], ds["peak_bytes_per_rank"])
        for run in row["long_500k"]["runs"]:
            name = f"{tag}_long_500k_from_{run['start']}"
            tasks.append((name, row["arch"], row["layers"], red, SHAPES["long_500k"],
                          dict(f32, pos=run["step_pos"]), {}))
            measured[name] = (run["collectives_by_axis_per_rank"], run["step_peak_bytes_per_rank"])
    tm = mesh_train["timed"]
    for mode in ("reduce_scatter", "all_reduce", "sp"):  # sp: seq -> model, reduce_scatter
        name = f"qwen2_train_{mode}"
        tasks.append((name, mesh_train["arch"], tm["layers"], red,
                      ShapeSpec("train_4k", tm["seq"], tm["batch"], "train"),
                      dict(param_dtype=torch.float32, compute_dtype=torch.bfloat16,
                           grad_reshard=mode != "all_reduce",
                           rules_override={"seq": ("model",)} if mode == "sp" else None), {}))
        measured[name] = (tm["collectives_by_axis_per_rank"][mode],
                          tm["step_peak_bytes_per_rank"][mode])
    bf16 = dict(param_dtype=torch.bfloat16, kv_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    pf, ds = kimi["prefill"], kimi["decode_step"]
    tasks.append(("kimi_prefill", KIMI[0], kimi["layers"], red,
                  ShapeSpec("prefill_32k", pf["seq"], pf["batch"], "prefill"), bf16,
                  dict(moe_capacity_factor=kimi["no_drop_capacity_factor"]["rank"])))
    measured["kimi_prefill"] = (pf["collectives_per_rank"], pf["peak_bytes_per_rank"])
    tasks.append(("kimi_decode", KIMI[0], kimi["layers"], red,
                  ShapeSpec("decode_32k", ds["cache_len"], ds["batch"], "decode"),
                  dict(bf16, pos=ds["pos"]), {}))
    measured["kimi_decode"] = (ds["collectives_per_rank"], ds["peak_bytes_per_rank"])
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=min(MESH_PREDICT_WORKERS, len(tasks)),
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        predicted = dict(pool.map(_mesh_prediction, tasks))
    predict_s = time.perf_counter() - t0

    rows = []
    for name, (per_rank, peaks) in measured.items():
        p = predicted[name]
        want = {k: {a: dict(calls=v["calls"], bytes=v["operand_bytes"])
                    for a, v in c["by_axis"].items()} for k, c in p["collectives_by_kind"].items()}
        for rank, got in enumerate(per_rank):
            got = {k: {a: dict(calls=v["calls"], bytes=v["bytes"]) for a, v in per.items()}
                   for k, per in got.items()}
            check(got == want, f"dryrun_mesh {name} rank {rank}: measured collectives {got}, "
                               f"the dry run predicted {want}")
        p_peak = max(p["peak_bytes_card"].values())  # the step's phases' largest
        rel = [None if b is None else p_peak / b - 1.0 for b in peaks]
        for rank, e in enumerate(rel):
            if e is not None:  # the card's peak (none on the CPU)
                check(abs(e) <= DRYRUN_PEAK_REL,
                      f"dryrun_mesh {name} rank {rank}: predicted peak {p_peak} bytes, "
                      f"measured {peaks[rank]} ({e:+.1%})")
        rows.append(dict(
            step=name, collectives_equal=True,
            collectives={k: dict(calls=c["calls"], bytes=c["operand_bytes"],
                                 wire_bytes=c["wire_bytes"])
                         for k, c in p["collectives_by_kind"].items()},
            predicted_peak_bytes=p_peak, measured_peak_bytes_per_rank=peaks,
            peak_rel_err_per_rank=rel, predicted_flops=p["flops"],
            predicted_argument_bytes=p["argument_bytes"]))
    out = dict(phase="dryrun_mesh", card=ctx.card, mesh=dict(zip(MESH_AXES, MESH_SHAPE)),
               predict_s=predict_s, steps=rows,
               note="collective counts and peaks predicted on a fake mesh in one process; "
                    "the wire time over NVLink or InfiniBand is not measured on one card")
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


MESH_SHAPE, MESH_AXES = (2, 2), ("data", "model")
# capacity factor of mesh_serve's one process: 4.0 gives it 2,048 slots an
# expert, far above the ~512 pairs an expert gets; the ranks take the least
# multiple of 0.25 above their largest expert load (four ranks share the
# card's memory).  Without drops on either side the two compute the same
# function; the phase checks that no pair drops
MESH_NODROP_CF = 4.0
MESH_EP_SEED = 23  # the EP layer's input, drawn on each rank and in the one process
# mesh against one process, as a share of max|x|: the psums over the model axis
# and the expert products sum in another order
MESH_REL = 1e-4


def _expert_loads(x, router, top_k: int, rows: int):
    """Pairs each expert gets, over the whole batch and over each block of
    ``rows`` batch rows (a data rank's): ``(whole max, per-block max)``."""
    import torch

    from repro_torch.models import moe

    _, eidx = moe.route(x, router, top_k)
    E = router.shape[-1]
    per_row = eidx.reshape(x.shape[0], -1)
    whole = torch.bincount(per_row.reshape(-1), minlength=E).max()
    block = max(int(torch.bincount(per_row[i:i + rows].reshape(-1), minlength=E).max())
                for i in range(0, x.shape[0], rows))
    return int(whole), block


def _step_ties(calls, n_moe: int, top_k: int):
    """``[B, steps]`` bool: a decode step where some MoE layer's k-th and
    (k+1)-th router probabilities lie within :data:`NEAR_TIE_REL` (the
    calls are recorded step by step, ``n_moe`` a step)."""
    import torch

    ties = [router_margins(calls[i:i + n_moe], top_k)[:, 0] for i in range(0, len(calls), n_moe)]
    return torch.stack(ties, dim=1)


def recording_routes():
    """``(calls, restore)``: from here on ``moe.route`` appends the experts it
    picks for the tokens of each call (``[T, k]``, left on the device) to
    ``calls``, until ``restore()``."""
    from repro_torch.models import moe

    route, calls = moe.route, []

    def recording(x, router, top_k):
        gates, eidx = route(x, router, top_k)
        calls.append(eidx)
        return gates, eidx

    moe.route = recording

    def restore():
        moe.route = route

    return calls, restore


def rerouted(mine, theirs, rows: int, n_moe: int, last_moe: bool):
    """``[rows, n]`` bool: where two runs' sets of experts differ in some MoE
    layer, and, for a layer before the model's last, every later position
    (step) of the row, which reads it through attention and the cache.
    ``mine`` and ``theirs`` are routes (numpy ``[rows * m, k]``), ``n_moe`` a
    forward of ``n = m`` positions or ``n_moe`` a decode step (``m = 1``)."""
    import numpy as np

    early, last = [], []
    for i in range(0, len(mine), n_moe):
        diff = [(np.sort(a, -1) != np.sort(b, -1)).any(-1).reshape(rows, -1)
                for a, b in zip(mine[i:i + n_moe], theirs[i:i + n_moe], strict=True)]
        final = diff.pop() if last_moe else np.zeros_like(diff[0])
        early.append(np.any(diff, axis=0) if diff else np.zeros_like(final))
        last.append(final)
    return np.maximum.accumulate(np.concatenate(early, 1), axis=1) | np.concatenate(last, 1)


# the long_500k cell on the mesh: the cache (524,288 positions) filled from this
# seed, two runs of LONG_STEPS greedy steps from each start: the first wraps
# recurrentgemma's 2,048-slot ring from data rank 1's slots to rank 0's (slot
# 2040), the second crosses from rank 0's slots to rank 1's (slot 1016)
LONG_CACHE_SEED = 41
LONG_STARTS = (522_232, 523_256)
LONG_STEPS = 16


def _card_bytes(tree) -> int:
    """The bytes the caching allocator holds for the storages of ``tree``'s
    leaves (a ``DTensor``'s block's), each rounded up to 512 bytes, each
    storage once: what the dry run counts as a step's inputs."""
    from repro_torch.sharding import rules
    from repro_torch.tree import tree_leaves

    seen = {}
    for t in tree_leaves(tree):
        st = rules.block(t).untyped_storage()
        seen[st.data_ptr()] = -(-st.nbytes() // 512) * 512
    return sum(seen.values())


def counted_step(card: bool, fn, inputs):
    """``fn()`` once, its collectives counted by kind and mesh axis: ``(its
    output, {"collectives", "ms", "peak_bytes"})``, ``peak_bytes`` the card's
    peak during the call above what was allocated before it, plus the
    allocator's bytes of ``inputs`` (None on the CPU) — the dry run's
    ``peak_bytes_card`` of the same step."""
    import torch

    from repro_torch.sharding import rules

    if card:
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    rules.reset_collective_counts()
    t0 = time.perf_counter()
    out = fn()
    if card:
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    coll = rules.collective_counts(by_axis=True)
    peak = (torch.cuda.max_memory_allocated() - held + _card_bytes(inputs)) if card else None
    return out, dict(collectives=coll, ms=ms, peak_bytes=peak)


def long_cache(cfg, dev, ctx=None):
    """The ``long_500k`` cell's cache (B 1, 524,288 positions, fp32), every leaf
    filled whole from :data:`LONG_CACHE_SEED` (the same numbers in every
    process on one device), as ``DTensor`` blocks laid out by ``ctx``'s rules
    when it is given."""
    import torch

    from repro_torch.configs import SHAPES
    from repro_torch.models import transformer
    from repro_torch.sharding import rules
    from repro_torch.tree import tree_map, tree_paths

    whole = transformer.init_cache(cfg, 1, SHAPES["long_500k"].seq_len, torch.float32,
                                   device=dev)
    gen = torch.Generator(device=dev).manual_seed(LONG_CACHE_SEED)
    for _, t in tree_paths(whole):
        t.copy_(0.5 * torch.randn(t.shape, generator=gen, device=dev))
    if ctx is None:
        return whole
    specs = rules.spec_tree(ctx, whole, transformer.cache_axes(cfg))
    return tree_map(lambda t, spec: rules.as_dtensor(
        ctx, rules.local_block(ctx, t, spec).contiguous().clone(), spec, t.shape), whole, specs)


def long_decode(cfg, params, cache, first: int, start: int, steps: int, dev, ctx=None,
                card: bool = False):
    """Greedy decode of ``steps`` tokens from position ``start`` on ``cache``, the
    first token ``first``, fp32: ``(tokens [steps + 1], logits [steps, V_l],
    ms a step (the median after the first), the last step's counts)``.  On a
    mesh (``ctx``) each step is ``make_serve_step(cfg, ctx)``'s, the logits
    this rank's vocab block, the next token :func:`greedy_tokens`' (its
    gather left out of the step's counts)."""
    import statistics

    import torch

    from repro_torch.launch.serve import greedy_tokens
    from repro_torch.models import model as model_mod

    serve = model_mod.make_serve_step(cfg, ctx, compute_dtype=torch.float32)
    tok = torch.full((1, 1), first, dtype=torch.long, device=dev)
    tokens, logits, ms, last = [first], [], [], None
    with torch.inference_mode():
        for i in range(steps):
            (lg, cache), last = counted_step(card, lambda: serve(params, cache, tok, start + i),
                                             (params, cache, tok))
            ms.append(last["ms"])
            if ctx is None:
                logits.append(lg[0, 0].float())
                tok = lg[:, 0].argmax(-1)[:, None]
            else:
                logits.append(lg.to_local()[0, 0].float())
                tok = greedy_tokens(ctx, lg)
            tokens.append(int(tok[0, 0]))
    return tokens, torch.stack(logits), statistics.median(ms[1:]), last


def decode_step_alone(card: bool, dctx, cfg, params, prompts, gen: int, dev, dtype=None) -> dict:
    """One ``make_serve_step(cfg, dctx)`` step alone, at the shape ``generate_on_mesh``
    served (``len(prompts)`` rows, a fresh cache of ``P + gen`` positions,
    cache and compute in ``dtype``, fp32 by default), after a warm step: its
    collectives by kind and axis, ms and peak (:func:`counted_step`), the dry
    run's prediction of the same step."""
    import torch

    from repro_torch.models import model as model_mod
    from repro_torch.models import transformer

    dtype = dtype or torch.float32
    R, L = prompts.shape[0], prompts.shape[1] + gen
    cache = transformer.init_cache(cfg, R, L, dtype, device=dev, ctx=dctx)
    serve = model_mod.make_serve_step(cfg, dctx, compute_dtype=dtype)
    tok = torch.from_numpy(prompts[:, :1]).to(dev)
    with torch.inference_mode():
        serve(params, cache, tok, 0)
        _, got = counted_step(card, lambda: serve(params, cache, tok, L - 2), (params, cache, tok))
    return dict(got, batch=R, cache_len=L, pos=L - 2)


def warm_placement(mctx, dev) -> None:
    """One ``DTensor`` made on every rank at once: its first construction in a
    process imports ``torch.distributed.tensor``'s machinery (seconds), which
    the ranks' one-at-a-time draws would otherwise pay in turn."""
    import torch

    from repro_torch.sharding import rules

    rules.as_dtensor(mctx, torch.zeros(1, device=dev), (None,), (1,))


def mesh_serve_rank(mctx, cfg, tmp: str, prompts, gen: int, masks: dict, rank_cf: float):
    """One rank of the ``mesh_serve`` phase (spawned by ``run_on_mesh``)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import SHAPES
    from repro_torch.kernels import block_spmm as bsp
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate_on_mesh
    from repro_torch.launch.specs import make_ctx
    from repro_torch.models import moe, transformer
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.sharding import rules
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = mctx.mesh.device_type == "cuda"
    dev = torch.device("cuda", torch.cuda.current_device()) if card else torch.device("cpu")
    sync = torch.cuda.synchronize if card else (lambda: None)
    rank, world = dist.get_rank(), dist.get_world_size()
    d, m = (rules.axis_index(mctx, a) for a in MESH_AXES)
    load = lambda name: torch.from_numpy(np.load(os.path.join(tmp, name))).to(dev)  # noqa: E731
    peak = lambda: torch.cuda.max_memory_allocated() if card else None  # noqa: E731
    pctx = make_ctx(mctx, cfg, SHAPES["prefill_32k"])
    dctx = make_ctx(mctx, cfg, SHAPES["decode_32k"])
    axes = transformer.param_axes(cfg)
    out = dict(rank=rank, coord=[d, m], backend=mctx.mesh.backend,
               ranks_per_card=mctx.mesh.ranks_per_card)

    # the parameters: one rank at a time draws the whole tree (seed 0, as the
    # one process did) and keeps its blocks under the prefill rules
    warm_placement(mctx, dev)
    t0 = time.perf_counter()
    for r in range(world):
        if r == rank:
            whole = transformer.init_params(cfg, seed=0, device=dev)
            params = reshard_state(whole, None, pctx, axes)
            del whole
            if card:
                torch.cuda.empty_cache()
        dist.barrier()
    out["build_s"] = time.perf_counter() - t0
    out["shard_bytes"] = sum(t.to_local().numel() * t.to_local().element_size()
                             for t in tree_leaves(params))
    out["build_peak_bytes"] = peak()

    # the expert-parallel MoE layer through block_spmm, every launch held
    # against the kernel's plain version on the same operands
    B, S = masks["layer_near"].shape
    gen_x = torch.Generator(device=dev).manual_seed(MESH_EP_SEED)
    x = torch.randn((B, S, cfg.d_model), generator=gen_x, device=dev)
    xd = rules.distribute(pctx, x, "batch", None, None)
    del x
    lp = params["layers"][0]["moe"]
    E_l = cfg.num_experts // mctx.axis_sizes["model"]
    checks = []
    block_spmm = ops.block_spmm

    def holding(a, b, *args, **kw):
        got = block_spmm(a, b, *args, **kw)
        # the plain version on the same operands, 8 experts (tasks) at a time:
        # four ranks share the card's memory
        err = excess = 0.0
        for lo in range(0, E_l, 8):
            n = min(8, E_l - lo)
            tasks = ops.task_arrays(np.arange(n), np.arange(n), np.arange(n), n, dev)
            a_c, b_c = a[lo:lo + n], b[lo:lo + n]
            diff = (got[lo:lo + n] - bsp.block_spmm_ref(a_c, b_c, *tasks, n)).abs()
            err = max(err, float(diff.max()))
            excess = max(excess, float((diff.flatten(1).amax(1).double()
                                        / block_tolerance(a_c, b_c, *tasks)).max()))
            del diff
        checks.append(dict(shape=[list(a.shape), list(b.shape)], max_abs_err=err,
                           err_over_limit=excess))
        return got

    kw = dict(num_experts=cfg.num_experts, top_k=cfg.top_k, act=cfg.mlp_act,
              gemm_impl="block_spmm")
    ops.block_spmm = holding
    try:
        with torch.inference_mode():
            bsp.launches = 0  # the main path's count starts here
            layer = moe.moe_apply(lp, xd, ctx=pctx, capacity_factor=rank_cf, **kw)
            sync()
            out["ep_launches"] = bsp.launches  # ... and is read here
    finally:
        ops.block_spmm = block_spmm
    ref = load(f"layer_{d}.npy")
    keep = ~torch.from_numpy(masks["layer_near"][d:d + 1]).to(dev)
    diff = (layer.to_local() - ref).abs().amax(-1)
    # one call at capacity factor 1.25, warm from the checked call: its wall
    # time and its collectives (each call gathers the experts over gloo)
    rules.reset_collective_counts()
    sync()
    t0 = time.perf_counter()
    with torch.inference_mode():
        moe.moe_apply(lp, xd, ctx=pctx, capacity_factor=1.25, **kw)
    sync()
    out["ep"] = dict(launch_checks=checks, max_abs_err=float(diff[keep].max()),
                     excluded_positions=int((~keep).sum()),
                     ep_ms_cf125=(time.perf_counter() - t0) * 1e3,
                     collectives=rules.collective_counts())
    del layer, ref, xd, diff
    if card:
        torch.cuda.empty_cache()

    # the prefill forward through the flash kernel, each launch held against
    # its plain version, the logits against one process's on this rank's block;
    # then again under sequence parallelism (the prefill rules and seq -> model:
    # the stream cut along its sequence between blocks, each layer gathering it
    # whole, so attention still runs over the whole sequence)
    tokens = torch.from_numpy(masks["tokens"]).to(dev)
    cfg_nd = dataclasses.replace(cfg, moe_capacity_factor=rank_cf)
    flash = ops.flash_attention
    ref = load(f"logits_{d}_{m}.npy")
    keep = ~torch.from_numpy(masks["forward_near"][d:d + 1]).to(dev)

    def prefill(c) -> dict:
        checks = []

        def holding_flash(q, k, v, **kw):
            got = flash(q, k, v, **kw)
            err, excess = flash_excess(got, q, k, v, **kw)
            checks.append(dict(shape=list(q.shape), max_abs_err=err, err_over_limit=excess))
            return got

        ops.flash_attention = holding_flash
        try:
            with torch.inference_mode():
                fa.launches = 0  # the main path's count starts here
                fa.launches_by_dtype.update(float32=0, bfloat16=0)
                rules.reset_collective_counts()
                sync()
                t0 = time.perf_counter()
                logits = transformer.apply(params, cfg_nd, {"tokens": tokens},
                                           attn_impl="flash", ctx=c)
                sync()
                secs = time.perf_counter() - t0
                launches = fa.launches  # ... and is read here
        finally:
            ops.flash_attention = flash
        local = logits.to_local()
        res = dict(local_shape=list(local.shape), spec=list(rules.spec_of(c, logits)),
                   finite=bool(torch.isfinite(local).all()),
                   max_abs_err=float((local - ref).abs().amax(-1)[keep].max()),
                   excluded_positions=int((~keep).sum()), flash_checks=checks,
                   vocab_block=[m * local.shape[-1], (m + 1) * local.shape[-1]],
                   seconds=secs, flash_launches=launches,
                   collectives=rules.collective_counts(),
                   collectives_by_axis=rules.collective_counts(by_axis=True))
        del logits, local
        if card:
            torch.cuda.empty_cache()
        return res

    out["prefill"] = prefill(pctx)
    out["prefill_sp"] = prefill(pctx.with_rules(seq=("model",)))
    del ref
    out["prefill_peak_bytes"] = peak()

    # the decode layout, one part at a time (each rank holds one whole leaf at most)
    rules.reset_collective_counts()
    sync()
    t0 = time.perf_counter()
    dparams = {}
    for key in list(params):
        if key == "layers":
            dparams["layers"] = []
            for i in range(len(params["layers"])):
                dparams["layers"].append(reshard_state(params["layers"][i], pctx, dctx,
                                                       axes["layers"][i]))
                params["layers"][i] = None
        else:
            dparams[key] = reshard_state(params[key], pctx, dctx, axes[key])
        params[key] = None
        if card:
            torch.cuda.empty_cache()
    sync()
    out["reshard"] = dict(seconds=time.perf_counter() - t0,
                          collectives=rules.collective_counts(),
                          w1_spec=list(rules.spec_of(dctx, dparams["layers"][0]["moe"]["w1"])))
    del params

    # greedy serving through make_serve_step(cfg, ctx)
    generate_on_mesh(dctx, cfg, dparams, prompts[:, :2], 2, device=dev)  # warm-up
    rules.reset_collective_counts()
    sync()
    t0 = time.perf_counter()
    seqs, steps = generate_on_mesh(dctx, cfg, dparams, prompts, gen, dtype=torch.float32,
                                   device=dev, return_logits=True)
    sync()
    secs = time.perf_counter() - t0
    n_steps = prompts.shape[1] + gen - 1
    counts = rules.collective_counts()
    ref = load(f"steps_{d}_{m}.npy")
    out["serve"] = dict(seqs=seqs.tolist(), seconds=secs, ms_per_decode_step=secs * 1e3 / n_steps,
                        collectives_per_step={k: {kk: vv / n_steps for kk, vv in v.items()}
                                              for k, v in counts.items()},
                        step_err=(steps - ref).abs().amax(-1).cpu().numpy().tolist())
    del steps, ref
    out["decode_step"] = decode_step_alone(card, dctx, cfg, dparams, prompts, gen, dev)
    out["peak_bytes"] = peak()
    return out


def mesh_prefill_summary(ranks: list, key: str, B: int, S: int, lmax: float) -> dict:
    """One of ``mesh_serve``'s prefills over the ranks: launches, errors, seconds and
    rank 0's collectives (by kind with host seconds, and by kind and axis)."""
    return dict(batch=B, seq=S, attn_impl="flash",
                flash_launches_per_rank=[r[key]["flash_launches"] for r in ranks],
                logits_spec=ranks[0][key]["spec"], local_logits_shape=ranks[0][key]["local_shape"],
                max_abs_logit=lmax, max_abs_err=max(r[key]["max_abs_err"] for r in ranks),
                tol=MESH_REL * lmax,
                excluded_positions=sum(r[key]["excluded_positions"] for r in ranks),
                flash_checks=[c for r in ranks for c in r[key]["flash_checks"]],
                seconds_per_rank=[r[key]["seconds"] for r in ranks],
                collectives=ranks[0][key]["collectives"],
                collectives_by_axis=ranks[0][key]["collectives_by_axis"])


def phase_mesh_serve(ctx, sizes, lm_families: dict) -> dict:
    """qwen3-moe-235b-a22b (2 of 94 layers) at full width on a (data 2, model 2)
    mesh of four ranks sharing the card over gloo, against one process; then
    the recurrent families (:func:`mesh_families`)."""
    import dataclasses

    import numpy as np

    torch = ctx.torch
    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.launch.serve import generate
    from repro_torch.models import moe, transformer

    arch, full_layers, rehearsal_layers = FAMILIES[0]
    cfg = family_config(arch, rehearsal_layers if sizes["lm_reduced"] else full_layers,
                        sizes["lm_reduced"])
    B, S = LM_BATCH, sizes["lm_seq"]
    R, P, G = SERVE
    dp = MESH_SHAPE[0]
    V_l = cfg.vocab_size // MESH_SHAPE[1]
    cfg_nd = dataclasses.replace(cfg, moe_capacity_factor=MESH_NODROP_CF)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    prompts = rng.integers(0, cfg.vocab_size, (R, P))
    one = {}
    calls = []
    moe_apply = moe.moe_apply

    def recording(p, x, **kw):
        calls.append((x, p["router"]))
        return moe_apply(p, x, **kw)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        def save(name, t):
            np.save(os.path.join(tmp, name), t.contiguous().cpu().numpy())

        # one process: the layer, the forward and greedy serving, each rank's block saved
        params = transformer.init_params(cfg, seed=0, device=ctx.dev)
        gen_x = torch.Generator(device=ctx.dev).manual_seed(MESH_EP_SEED)
        x = torch.randn((B, S, cfg.d_model), generator=gen_x, device=ctx.dev)
        lp = params["layers"][0]["moe"]
        kw = dict(num_experts=cfg.num_experts, top_k=cfg.top_k, act=cfg.mlp_act)
        with torch.inference_mode():
            layer = moe.moe_apply(lp, x, capacity_factor=MESH_NODROP_CF, **kw)
            layer_near = router_margins([(x, lp["router"])], cfg.top_k)
            loads = [_expert_loads(x, lp["router"], cfg.top_k, B // dp)]
        one["max_abs_layer"] = float(layer.abs().max())
        for i in range(dp):
            save(f"layer_{i}.npy", layer[i * B // dp:(i + 1) * B // dp])
        del layer, x
        moe.moe_apply = recording
        try:
            with torch.inference_mode():
                logits = transformer.apply(params, cfg_nd,
                                           {"tokens": torch.from_numpy(tokens).to(ctx.dev)},
                                           attn_impl="flash")
                forward_near = router_margins(calls, cfg.top_k)
                loads += [_expert_loads(xc, r, cfg.top_k, B // dp) for xc, r in calls]
            calls.clear()
            one["max_abs_logit"] = float(logits.abs().max())
            for i in range(dp):
                for j in range(MESH_SHAPE[1]):
                    save(f"logits_{i}_{j}.npy", logits[i * B // dp:(i + 1) * B // dp, :,
                                                       j * V_l:(j + 1) * V_l])
            del logits
            generate(cfg, params, prompts[:, :2], 2, device=ctx.dev)  # warm-up
            calls.clear()
            ctx.sync()
            t0 = time.perf_counter()
            seqs, steps = generate(cfg, params, prompts, G, dtype=torch.float32, device=ctx.dev,
                                   return_logits=True)
            ctx.sync()
            one["ms_per_decode_step"] = (time.perf_counter() - t0) * 1e3 / (P + G - 1)
            router_ties = _step_ties(calls, cfg.num_layers, cfg.top_k).cpu().numpy()
        finally:
            moe.moe_apply = moe_apply
        smax = one["max_abs_step_logit"] = float(steps.abs().max())
        top2 = steps.topk(2, dim=-1).values
        logit_ties = ((top2[..., 0] - top2[..., 1]) <= STEP_REL * smax).cpu().numpy()
        for i in range(dp):
            for j in range(MESH_SHAPE[1]):
                save(f"steps_{i}_{j}.npy", steps[i * R // dp:(i + 1) * R // dp, :,
                                                 j * V_l:(j + 1) * V_l])
        seqs = np.asarray(seqs)
        del params, steps, top2, lp
        calls.clear()
        if ctx.dev.type == "cuda":
            torch.cuda.empty_cache()
        max_load = dict(one_process=max(w for w, _ in loads), rank=max(b for _, b in loads))
        rank_tokens = B // dp * S * cfg.top_k
        rank_cf = math.ceil(4 * max_load["rank"] * cfg.num_experts / rank_tokens + 1) / 4
        caps = dict(one_process=math.ceil(B * S * cfg.top_k * MESH_NODROP_CF / cfg.num_experts),
                    rank=math.ceil(rank_tokens * rank_cf / cfg.num_experts))
        check(max_load["one_process"] <= caps["one_process"] and max_load["rank"] <= caps["rank"],
              f"mesh_serve: an expert's load {max_load} exceeds the no-drop capacity {caps}")

        masks = dict(tokens=tokens, layer_near=layer_near.cpu().numpy(),
                     forward_near=forward_near.cpu().numpy())
        parent_bytes = torch.cuda.memory_allocated() if ctx.dev.type == "cuda" else None
        # the ranks' allocators grow their segments in place: four processes
        # share the card, and blocks cached in one are lost to the others
        alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        t0 = time.perf_counter()
        try:
            ranks = run_on_mesh(mesh_serve_rank, MESH_SHAPE, MESH_AXES, device=ctx.dev.type,
                                args=(cfg, tmp, prompts, G, masks, rank_cf), timeout_s=900)
        finally:
            if alloc_conf is None:
                del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
        mesh_s = time.perf_counter() - t0

    # the checks: every rank's launches, its kernels against their plain
    # versions, its blocks against one process's
    per_flash = 0 if ctx.rehearse else transformer.layer_kinds(cfg).count("attn")
    lmax, layer_max = one["max_abs_logit"], one["max_abs_layer"]
    for r in ranks:
        tag = f"mesh_serve rank {r['rank']} {tuple(r['coord'])}"
        check(r["ep_launches"] == (0 if ctx.rehearse else 3),
              f"{tag}: the EP layer launched block_spmm {r['ep_launches']} times, expected 3")
        check(len(r["ep"]["launch_checks"]) == 3
              and all(c["err_over_limit"] <= 1.0 for c in r["ep"]["launch_checks"]),
              f"{tag}: a block_spmm launch is off its plain version: {r['ep']['launch_checks']}")
        check(r["ep"]["max_abs_err"] <= MESH_REL * layer_max,
              f"{tag}: the EP layer is off one process's by {r['ep']['max_abs_err']} "
              f"> {MESH_REL} * {layer_max}")
        for key in ("prefill", "prefill_sp"):
            pf = r[key]
            check(pf["flash_launches"] == per_flash,
                  f"{tag}: the {key} launched the flash kernel {pf['flash_launches']} times, "
                  f"expected {per_flash}")
            check(len(pf["flash_checks"]) == cfg.num_layers
                  and all(c["err_over_limit"] <= 1.0 for c in pf["flash_checks"]),
                  f"{tag}: a {key} flash launch is off its plain version: {pf['flash_checks']}")
            check(pf["finite"] and pf["max_abs_err"] <= MESH_REL * lmax,
                  f"{tag}: {key} logits off one process's by {pf['max_abs_err']} "
                  f"> {MESH_REL} * {lmax}")
            check(pf["spec"] == ["data", None, "model"], f"{tag}: {key} logits laid out "
                                                         f"{pf['spec']}")
        # sequence parallelism: the row sums over model became reduce-scatters
        sp_axes = r["prefill_sp"]["collectives_by_axis"]
        check("model" in sp_axes.get("reduce_scatter", {})
              and "model" not in sp_axes.get("all_reduce", {})
              and "model" not in r["prefill"]["collectives_by_axis"].get("reduce_scatter", {}),
              f"{tag}: the prefills' collectives {r['prefill']['collectives_by_axis']} / "
              f"{sp_axes}")
        check(r["serve"]["seqs"] == ranks[0]["serve"]["seqs"], f"{tag}: its tokens differ from rank 0's")
    mesh_seqs = np.asarray(ranks[0]["serve"]["seqs"])
    check(mesh_seqs.shape == (R, P + G) and np.array_equal(mesh_seqs[:, :P], prompts),
          f"mesh_serve: generate_on_mesh returned {mesh_seqs.shape}, or not the prompts")
    # a request may part from one process's tokens only after a router near-tie
    # (from its step on) or at a step whose top two logits tie to STEP_REL
    n_steps = P + G - 1
    first_diff, excused = [], 0
    for q in range(R):
        diff = np.nonzero(mesh_seqs[q] != seqs[q])[0]
        t = int(diff[0]) if diff.size else P + G
        first_diff.append(t)
        if diff.size:
            tie = bool(router_ties[q, :t].any() or logit_ties[q, t - 1])
            check(tie, f"mesh_serve: request {q} parts from one process's tokens at {t} "
                       "without a router or logit tie")
            excused += 1
    step_err, compared = 0.0, 0
    for r in ranks:
        d = r["coord"][0]
        for row, errs in enumerate(r["serve"]["step_err"]):
            q = d * (R // dp) + row
            tie_at = np.nonzero(router_ties[q])[0]
            upto = min(first_diff[q], int(tie_at[0]) if tie_at.size else n_steps)
            if upto:
                step_err = max(step_err, max(errs[:upto]))
                compared += upto
    smax = one["max_abs_step_logit"]
    check(step_err <= MESH_REL * smax,
          f"mesh_serve: decode-step logits off one process's by {step_err} > {MESH_REL} * {smax}")
    gb = lambda b: None if b is None else round(b / 1e9, 3)  # noqa: E731
    out = dict(phase="mesh_serve", arch=cfg.name, layers=cfg.num_layers, mesh=dict(zip(MESH_AXES, MESH_SHAPE)),
               decode_step=dict(ranks[0]["decode_step"], ms_per_rank=[
                   r["decode_step"]["ms"] for r in ranks], peak_bytes_per_rank=[
                   r["decode_step"]["peak_bytes"] for r in ranks],
                   collectives_per_rank=[r["decode_step"]["collectives"] for r in ranks]),
               backend=ranks[0]["backend"], ranks_per_card=ranks[0]["ranks_per_card"],
               card=ctx.card, spawn_and_run_s=mesh_s,
               no_drop_capacity_factor=dict(one_process=MESH_NODROP_CF, rank=rank_cf),
               capacity=caps, max_expert_load=max_load,
               parent_allocated_gb_at_spawn=None if parent_bytes is None else parent_bytes / 1e9,
               ep_layer=dict(batch=B, seq=S, gemm_impl="block_spmm",
                             launches_per_rank=[r["ep_launches"] for r in ranks],
                             max_abs_one_process=layer_max,
                             max_abs_err=max(r["ep"]["max_abs_err"] for r in ranks),
                             tol=MESH_REL * layer_max,
                             excluded_positions=sum(r["ep"]["excluded_positions"] for r in ranks),
                             kernel_checks=[c for r in ranks for c in r["ep"]["launch_checks"]],
                             ms_at_cf_1_25_per_rank=[r["ep"]["ep_ms_cf125"] for r in ranks],
                             collectives_at_cf_1_25=ranks[0]["ep"]["collectives"]),
               prefill=mesh_prefill_summary(ranks, "prefill", B, S, lmax),
               prefill_sp=dict(mesh_prefill_summary(ranks, "prefill_sp", B, S, lmax),
                               rules="prefill_32k's and seq -> model"),
               reshard=dict(to="decode rules (embed_e=(), moe_ff=data)",
                            w1_spec=ranks[0]["reshard"]["w1_spec"],
                            seconds_per_rank=[r["reshard"]["seconds"] for r in ranks],
                            collectives=ranks[0]["reshard"]["collectives"]),
               serve=dict(requests=R, prompt_len=P, new_tokens=G, dtype="float32",
                          decode_steps=n_steps,
                          ms_per_decode_step_per_rank=[r["serve"]["ms_per_decode_step"] for r in ranks],
                          one_process_ms_per_decode_step=one["ms_per_decode_step"],
                          collectives_per_step=ranks[0]["serve"]["collectives_per_step"],
                          tokens_equal_one_process=bool(np.array_equal(mesh_seqs, seqs)),
                          requests_parted_at_a_tie=excused,
                          router_tie_steps=int(router_ties.sum()),
                          logit_tie_steps=int(logit_ties.sum()),
                          max_abs_step_logit=smax, max_abs_step_err=step_err,
                          tol=MESH_REL * smax, steps_compared=compared,
                          first_sequence=mesh_seqs[0].tolist()),
               shard_gb_per_rank=[gb(r["shard_bytes"]) for r in ranks],
               peak_gb_per_rank=dict(build=[gb(r["build_peak_bytes"]) for r in ranks],
                                     prefill=[gb(r["prefill_peak_bytes"]) for r in ranks],
                                     end=[gb(r["peak_bytes"]) for r in ranks]),
               families=mesh_families(ctx, sizes, lm_families))
    emit(out)
    return out


def mesh_family_rank(mctx, cfg, tmp: str, tokens, prompts, gen: int, long_first) -> dict:
    """One rank's part of a recurrent family in ``mesh_serve``: the model drawn
    one rank at a time, the prefill and greedy serving, one decode step
    alone (counted by kind and axis, its peak), then the ``long_500k`` cell
    (B 1, the cache's sequence over ``data``): greedy runs of
    :data:`LONG_STEPS` from each of :data:`LONG_STARTS` on the seeded cache,
    every kernel launch counted (none is expected)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import SHAPES
    from repro_torch.kernels import block_spmm as bsp
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_leaf as fl
    from repro_torch.launch.serve import generate_on_mesh
    from repro_torch.launch.specs import make_ctx
    from repro_torch.models import transformer
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.sharding import rules
    from repro_torch.tree import tree_leaves, tree_paths

    card = mctx.mesh.device_type == "cuda"
    dev = torch.device("cuda", torch.cuda.current_device()) if card else torch.device("cpu")
    sync = torch.cuda.synchronize if card else (lambda: None)
    rank, world = dist.get_rank(), dist.get_world_size()
    d, m = (rules.axis_index(mctx, a) for a in MESH_AXES)
    # memory-mapped: four ranks hold no host copy of their 2.1 GB logits blocks
    load = lambda name: torch.from_numpy(  # noqa: E731
        np.load(os.path.join(tmp, name), mmap_mode="c")).to(dev)
    peak = lambda: torch.cuda.max_memory_allocated() if card else None  # noqa: E731
    if card:
        torch.cuda.reset_peak_memory_stats()
    pctx = make_ctx(mctx, cfg, SHAPES["prefill_32k"])
    dctx = make_ctx(mctx, cfg, SHAPES["decode_32k"])
    check(pctx.rules == dctx.rules, f"{cfg.name}: the decode rules move the parameters")

    def kernel_launches():
        return dict(block_spmm=bsp.launches, fused_block_spmm=fl.launches, flash=fa.launches)

    def zero_launches():
        bsp.launches = fl.launches = fa.launches = 0

    warm_placement(mctx, dev)
    t0 = time.perf_counter()
    own = {}  # this rank's turn: drawing, keeping its blocks, freeing the rest
    for r in range(world):
        if r == rank:
            t1 = time.perf_counter()
            whole = transformer.init_params(cfg, seed=0, device=dev)
            sync()
            t2 = time.perf_counter()
            params = reshard_state(whole, None, pctx, transformer.param_axes(cfg))
            sync()
            t3 = time.perf_counter()
            del whole
            if card:
                torch.cuda.empty_cache()
            own = dict(draw_s=t2 - t1, blocks_s=t3 - t2, free_s=time.perf_counter() - t3)
        dist.barrier()
    out = dict(rank=rank, coord=[d, m], build_s=time.perf_counter() - t0, build_own=own,
               shard_bytes=sum(t.to_local().numel() * t.to_local().element_size()
                               for t in tree_leaves(params)),
               build_peak_bytes=peak())

    tokens = torch.from_numpy(tokens).to(dev)
    rules.reset_collective_counts()
    with torch.inference_mode():
        zero_launches()  # the main path's count starts here
        sync()
        t0 = time.perf_counter()
        logits = transformer.apply(params, cfg, {"tokens": tokens}, attn_impl="flash", ctx=pctx)
        sync()
        out["prefill_s"] = time.perf_counter() - t0
        out["prefill_launches"] = kernel_launches()  # ... and is read here
    out["prefill_collectives"] = rules.collective_counts()
    local = logits.to_local()
    ref = load(f"logits_{d}_{m}.npy")
    out["prefill"] = dict(local_shape=list(local.shape), spec=list(rules.spec_of(pctx, logits)),
                          finite=bool(torch.isfinite(local).all()),
                          max_abs_err=float((local - ref).abs().max()))
    del logits, local, ref
    out["prefill_peak_bytes"] = peak()
    if card:
        torch.cuda.empty_cache()

    generate_on_mesh(dctx, cfg, params, prompts[:, :2], 2, device=dev)  # warm-up
    rules.reset_collective_counts()
    zero_launches()
    sync()
    t0 = time.perf_counter()
    seqs, steps = generate_on_mesh(dctx, cfg, params, prompts, gen, dtype=torch.float32,
                                   device=dev, return_logits=True)
    sync()
    secs = time.perf_counter() - t0
    n_steps = prompts.shape[1] + gen - 1
    out["serve_launches"] = kernel_launches()
    ref = load(f"steps_{d}_{m}.npy")
    out["serve"] = dict(seqs=seqs.tolist(), seconds=secs, ms_per_decode_step=secs * 1e3 / n_steps,
                        collectives_per_step={k: {kk: vv / n_steps for kk, vv in v.items()}
                                              for k, v in rules.collective_counts().items()},
                        step_err=(steps - ref).abs().amax(-1).cpu().numpy().tolist())
    del steps, ref
    out["decode_step"] = decode_step_alone(card, dctx, cfg, params, prompts, gen, dev)

    # long_500k: the cell's rules (the cache's sequence over data, B 1 replicated);
    # the parameters keep their layout
    lctx = make_ctx(mctx, cfg, SHAPES["long_500k"])
    runs = []
    for start, first in zip(LONG_STARTS, long_first):
        cache = long_cache(cfg, dev, lctx)
        if not runs:
            out["long_cache_specs"] = {path: list(rules.spec_of(lctx, t))
                                       for path, t in tree_paths(cache)}
        zero_launches()
        toks, logits, ms, last = long_decode(cfg, params, cache, first, start, LONG_STEPS, dev,
                                             ctx=lctx, card=card)
        ref = load(f"long_{start}_{m}.npy")
        runs.append(dict(start=start, tokens=toks, ms_per_step=ms, step=last,
                         launches=kernel_launches(), finite=bool(torch.isfinite(logits).all()),
                         max_abs_err=float((logits - ref).abs().max())))
        del cache, logits, ref
    out["long"] = runs
    out["peak_bytes"] = peak()
    del params
    if card:
        torch.cuda.empty_cache()
    return out


def mesh_families_rank(mctx, cases: list, tmp: str) -> dict:
    """Both recurrent families on this rank, one after the other (one spawn)."""
    return {case["cfg"].name: mesh_family_rank(mctx, tmp=os.path.join(tmp, case["cfg"].name),
                                               **case) for case in cases}


def mesh_families(ctx, sizes, lm_families: dict) -> list:
    """recurrentgemma-9b (5 of 38 layers) and mamba2-370m (48) at full width on
    the (data 2, model 2) mesh: per family one process first (each rank's
    blocks of its prefill logits and step logits saved), then the ranks, each
    block held against one process's."""
    import numpy as np

    torch = ctx.torch
    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer

    B, S = LM_BATCH, sizes["lm_seq"]
    R, P, G = SERVE
    dp, tp = MESH_SHAPE
    n_steps = P + G - 1
    cases, one = [], {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_families_") as tmp:
        for i, (arch, full_layers, rehearsal_layers) in enumerate(FAMILIES[1:]):
            cfg = family_config(arch, rehearsal_layers if sizes["lm_reduced"] else full_layers,
                                sizes["lm_reduced"])
            V_l = cfg.vocab_size // tp
            rng = np.random.default_rng(30 + i)
            tokens = rng.integers(0, cfg.vocab_size, (B, S))
            prompts = rng.integers(0, cfg.vocab_size, (R, P))
            os.mkdir(os.path.join(tmp, cfg.name))

            def save(name, t, blocks):
                for a in range(dp):
                    for b in range(tp):
                        np.save(os.path.join(tmp, cfg.name, f"{name}_{a}_{b}.npy"),
                                t[a * blocks // dp:(a + 1) * blocks // dp, :,
                                  b * V_l:(b + 1) * V_l].contiguous().cpu().numpy())

            params = transformer.init_params(cfg, seed=0, device=ctx.dev)
            with torch.inference_mode():
                logits = transformer.apply(params, cfg,
                                           {"tokens": torch.from_numpy(tokens).to(ctx.dev)},
                                           attn_impl="flash")
            o = dict(max_abs_logit=float(logits.abs().max()))
            save("logits", logits, B)
            del logits
            generate(cfg, params, prompts[:, :2], 2, device=ctx.dev)  # warm-up
            ctx.sync()
            t0 = time.perf_counter()
            seqs, steps = generate(cfg, params, prompts, G, dtype=torch.float32, device=ctx.dev,
                                   return_logits=True)
            ctx.sync()
            o["ms_per_decode_step"] = (time.perf_counter() - t0) * 1e3 / n_steps
            o["max_abs_step_logit"] = float(steps.abs().max())
            top2 = steps.topk(2, dim=-1).values
            o["logit_ties"] = ((top2[..., 0] - top2[..., 1])
                               <= STEP_REL * o["max_abs_step_logit"]).cpu().numpy()
            save("steps", steps, R)
            o["seqs"] = np.asarray(seqs)
            # long_500k in one process: each run's logits saved per model rank's vocab block
            long_first = [int(x) for x in rng.integers(0, cfg.vocab_size, len(LONG_STARTS))]
            o["long"] = []
            for start, first in zip(LONG_STARTS, long_first):
                cache = long_cache(cfg, ctx.dev)
                toks, lg, ms, _ = long_decode(cfg, params, cache, first, start, LONG_STEPS,
                                              ctx.dev, card=ctx.dev.type == "cuda")
                for b in range(tp):
                    np.save(os.path.join(tmp, cfg.name, f"long_{start}_{b}.npy"),
                            lg[:, b * V_l:(b + 1) * V_l].contiguous().cpu().numpy())
                top2 = lg.topk(2, dim=-1).values
                lmax_long = float(lg.abs().max())
                o["long"].append(dict(start=start, tokens=toks, ms_per_step=ms,
                                      max_abs_logit=lmax_long, logit_ties=int(
                                          ((top2[:, 0] - top2[:, 1]) <= STEP_REL * lmax_long)
                                          .sum())))
                del cache, lg
            one[cfg.name] = o
            cases.append(dict(cfg=cfg, tokens=tokens, prompts=prompts, gen=G,
                              long_first=long_first))
            del params, steps, top2
            if ctx.dev.type == "cuda":
                torch.cuda.empty_cache()
        alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        t0 = time.perf_counter()
        try:
            ranks = run_on_mesh(mesh_families_rank, MESH_SHAPE, MESH_AXES, device=ctx.dev.type,
                                args=(cases, tmp), timeout_s=900)
        finally:
            if alloc_conf is None:
                del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
        spawn_s = time.perf_counter() - t0

    gb = lambda b: None if b is None else round(b / 1e9, 3)  # noqa: E731
    no_launch = dict(block_spmm=0, fused_block_spmm=0, flash=0)
    rows = []
    for case in cases:
        cfg = case["cfg"]
        o, per_rank = one[cfg.name], [r[cfg.name] for r in ranks]
        lmax, smax = o["max_abs_logit"], o["max_abs_step_logit"]
        for r in per_rank:
            tag = f"mesh_serve {cfg.name} rank {r['rank']} {tuple(r['coord'])}"
            check(r["prefill_launches"] == no_launch and r["serve_launches"] == no_launch,
                  f"{tag}: launched {r['prefill_launches']} in the prefill and "
                  f"{r['serve_launches']} serving, expected none")
            check(r["prefill"]["finite"] and r["prefill"]["max_abs_err"] <= MESH_REL * lmax,
                  f"{tag}: prefill logits off one process's by {r['prefill']['max_abs_err']} "
                  f"> {MESH_REL} * {lmax}")
            check(r["serve"]["seqs"] == per_rank[0]["serve"]["seqs"],
                  f"{tag}: its tokens differ from rank 0's")
        mesh_seqs = np.asarray(per_rank[0]["serve"]["seqs"])
        check(mesh_seqs.shape == (R, P + G) and np.array_equal(mesh_seqs[:, :P], case["prompts"]),
              f"mesh_serve {cfg.name}: generate_on_mesh returned {mesh_seqs.shape}, "
              "or not the prompts")
        # a request may part from one process's tokens only at a step whose top
        # two logits tie to STEP_REL; its step logits are held up to there
        first_diff = []
        for q in range(R):
            diff = np.nonzero(mesh_seqs[q] != o["seqs"][q])[0]
            t = int(diff[0]) if diff.size else P + G
            first_diff.append(t)
            check(not diff.size or bool(o["logit_ties"][q, t - 1]),
                  f"mesh_serve {cfg.name}: request {q} parts from one process's tokens at {t} "
                  "without a logit tie")
        step_err, compared = 0.0, 0
        for r in per_rank:
            for row, errs in enumerate(r["serve"]["step_err"]):
                upto = min(first_diff[r["coord"][0] * (R // dp) + row], n_steps)
                if upto:
                    step_err = max(step_err, max(errs[:upto]))
                    compared += upto
        check(step_err <= MESH_REL * smax,
              f"mesh_serve {cfg.name}: decode-step logits off one process's by {step_err} "
              f"> {MESH_REL} * {smax}")
        long_rows = []
        for j, lo in enumerate(o["long"]):
            for r in per_rank:
                run = r["long"][j]
                tag = f"mesh_serve long_500k {cfg.name} from {lo['start']} rank {r['rank']}"
                check(run["launches"] == no_launch, f"{tag}: launched {run['launches']}")
                check(run["finite"] and run["max_abs_err"] <= MESH_REL * lo["max_abs_logit"],
                      f"{tag}: logits off one process's by {run['max_abs_err']} "
                      f"> {MESH_REL} * {lo['max_abs_logit']}")
                check(run["tokens"] == lo["tokens"],
                      f"{tag}: greedy tokens {run['tokens']} differ from one process's "
                      f"{lo['tokens']}")
            last = per_rank[0]["long"][j]["step"]
            long_rows.append(dict(
                start=lo["start"], steps=LONG_STEPS, slot_window=cfg.window,
                first_slot=lo["start"] % cfg.window if cfg.window else None,
                ms_per_step_per_rank=[r["long"][j]["ms_per_step"] for r in per_rank],
                one_process_ms_per_step=lo["ms_per_step"],
                collectives_per_step={k: {"calls": sum(a["calls"] for a in v.values()),
                                          "bytes": sum(a["bytes"] for a in v.values())}
                                      for k, v in last["collectives"].items()},
                step_peak_gb_per_rank=[gb(r["long"][j]["step"]["peak_bytes"]) for r in per_rank],
                step_peak_bytes_per_rank=[r["long"][j]["step"]["peak_bytes"] for r in per_rank],
                step_pos=lo["start"] + LONG_STEPS - 1,
                collectives_by_axis_per_rank=[r["long"][j]["step"]["collectives"]
                                              for r in per_rank],
                max_abs_logit=lo["max_abs_logit"],
                max_abs_err=max(r["long"][j]["max_abs_err"] for r in per_rank),
                tol=MESH_REL * lo["max_abs_logit"], logit_ties=lo["logit_ties"],
                tokens_equal_one_process=True, tokens=lo["tokens"]))
        fam = next(f for f in lm_families["families"] if f["arch"] == cfg.name)
        rows.append(dict(
            arch=cfg.name, layers=cfg.num_layers, kinds=sorted(set(transformer.layer_kinds(cfg))),
            launches_per_rank=[dict(prefill=r["prefill_launches"], serve=r["serve_launches"])
                               for r in per_rank],
            prefill=dict(batch=B, seq=S, attn_impl="flash",
                         logits_spec=per_rank[0]["prefill"]["spec"],
                         local_logits_shape=per_rank[0]["prefill"]["local_shape"],
                         max_abs_logit=lmax,
                         max_abs_err=max(r["prefill"]["max_abs_err"] for r in per_rank),
                         tol=MESH_REL * lmax, seconds_per_rank=[r["prefill_s"] for r in per_rank],
                         collectives=per_rank[0]["prefill_collectives"]),
            serve=dict(requests=R, prompt_len=P, new_tokens=G, dtype="float32",
                       decode_steps=n_steps,
                       ms_per_decode_step_per_rank=[r["serve"]["ms_per_decode_step"]
                                                    for r in per_rank],
                       one_process_ms_per_decode_step=o["ms_per_decode_step"],
                       lm_families_ms_per_decode_step=fam["gen"]["ms_per_decode_step"],
                       collectives_per_step=per_rank[0]["serve"]["collectives_per_step"],
                       tokens_equal_one_process=bool(np.array_equal(mesh_seqs, o["seqs"])),
                       requests_parted_at_a_tie=sum(t < P + G for t in first_diff),
                       logit_tie_steps=int(o["logit_ties"].sum()),
                       max_abs_step_logit=smax, max_abs_step_err=step_err,
                       tol=MESH_REL * smax, steps_compared=compared,
                       first_sequence=mesh_seqs[0].tolist()),
            decode_step=dict(per_rank[0]["decode_step"], ms_per_rank=[
                r["decode_step"]["ms"] for r in per_rank], peak_bytes_per_rank=[
                r["decode_step"]["peak_bytes"] for r in per_rank],
                collectives_per_rank=[r["decode_step"]["collectives"] for r in per_rank]),
            long_500k=dict(batch=1, cache_positions=524_288, dtype="float32",
                           cache_specs=per_rank[0]["long_cache_specs"], runs=long_rows),
            build_s_per_rank=[r["build_s"] for r in per_rank],
            build_own_turn_per_rank=[r["build_own"] for r in per_rank],
            shard_gb_per_rank=[gb(r["shard_bytes"]) for r in per_rank],
            peak_gb_per_rank=dict(build=[gb(r["build_peak_bytes"]) for r in per_rank],
                                  prefill=[gb(r["prefill_peak_bytes"]) for r in per_rank],
                                  end=[gb(r["peak_bytes"]) for r in per_rank])))
    return dict(spawn_and_run_s=spawn_s, rows=rows)


# mesh_train: the timed steps a grad_reshard mode (the median of the last two is
# reported), and step 0's loss against lm_train's one process (bf16 compute)
# kimi-k2-1t-a32b on the mesh: (arch, layers) at full width and in the rehearsal
KIMI = ("kimi-k2-1t-a32b", 1)


def kimi_gemm_timing(ctx, cfg, rank_tokens: int, num_local: int, chunk: int) -> dict:
    """The expert GEMMs of a ``mesh_kimi`` rank at capacity factor 1.25, timed
    on the card alone (the ranks have ended): each launch's shape (``chunk``
    experts, the w1 / wg product and the w2 product) through ``block_spmm``
    (the rule: TileTC, the tensor cores) beside the earlier engine forced
    (Tile64, fp32 FFMA) and ``torch.bmm`` on the same random bf16 operands,
    and the rank's layer (3 products x its chunks) against two bounds: fp32
    FFMA at 67 TFLOP/s (the bytes below), the earlier engines' design, and
    the card's, the bf16 tensor cores at 989 TFLOP/s or the bytes at 3.35
    TB/s (operands read once, fp32 outputs written once)."""
    import math

    import numpy as np

    torch = ctx.torch
    from repro_torch.kernels import block_spmm as bsp
    from repro_torch.kernels import ops

    D, F, E, K = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.top_k
    ce = math.ceil(rank_tokens * K * 1.25 / E)
    kernel = bsp.block_spmm_ref if ctx.rehearse else bsp.block_spmm_cuda
    gen = torch.Generator(device=ctx.dev).manual_seed(29)
    idx = np.arange(chunk)
    tasks = ops.task_arrays(idx, idx, idx, chunk, ctx.dev)
    n_chunks = math.ceil(num_local / chunk)
    rows, layer = [], dict(ms=0.0, tile64_ms=0.0, bmm_ms=0.0, flops=0.0, bytes=0.0)
    tile64 = gemm_engine(ctx, bsp, "tile64")
    for name, (kd, n), per_chunk in (("w1", (D, F), 2), ("w2", (F, D), 1)):  # wg: w1's shape
        a = torch.randn((chunk, ce, kd), generator=gen, device=ctx.dev).to(torch.bfloat16)
        b = (torch.randn((chunk, kd, n), generator=gen, device=ctx.dev) * kd**-0.5).to(
            torch.bfloat16)
        # the rule (TileTC), then the earlier engine forced (Tile64), then torch.bmm
        ms = ctx.time_ms(lambda a=a, b=b: kernel(a, b, *tasks, chunk), reps=5)
        tile64_ms = ctx.time_ms(lambda a=a, b=b: tile64(a, b, *tasks, chunk), reps=2)
        bmm_ms = ctx.time_ms(lambda a=a, b=b: torch.bmm(a, b), reps=5)
        flops = 2.0 * chunk * ce * kd * n
        nbytes = 2.0 * (a.numel() + b.numel()) + 4.0 * chunk * ce * n
        rows.append(dict(gemm=name, shape=f"[{chunk}, {ce}, {kd}] x [{chunk}, {kd}, {n}]",
                         dtype="bfloat16", engine=bsp.tile_engine(ce, kd, n, (a, b)), ms=ms,
                         tile64_ms=tile64_ms, bmm_ms=bmm_ms, bmm="torch.bmm on the same operands",
                         ffma_bound_ms=flops / FP32_FLOPS * 1e3,
                         card_bound_ms=max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3,
                         launches_per_rank_layer=per_chunk * n_chunks))
        times = per_chunk * n_chunks
        layer["ms"] += times * ms
        layer["tile64_ms"] += times * tile64_ms
        layer["bmm_ms"] += times * bmm_ms
        layer["flops"] += times * flops
        layer["bytes"] += times * nbytes
        del a, b
    t_ops, t_tc, t_bytes = (layer["flops"] / FP32_FLOPS, layer["flops"] / BF16_FLOPS,
                            layer["bytes"] / HBM_BYTES_PER_S)
    return dict(capacity=ce, chunk=chunk, chunks=n_chunks, launches=rows,
                rank_layer=dict(layer, ffma_bound_ms=max(t_ops, t_bytes) * 1e3,
                                ffma_bound_by="operations" if t_ops >= t_bytes else "bytes",
                                card_bound_ms=max(t_tc, t_bytes) * 1e3,
                                card_bound_by="operations" if t_tc >= t_bytes else "bytes",
                                ffma_bound_share=max(t_ops, t_bytes) * 1e3 / layer["ms"],
                                card_bound_share=max(t_tc, t_bytes) * 1e3 / layer["ms"]))


def mesh_kimi_rank(mctx, cfg, tmp: str, prompts, gen: int, masks: dict, rank_cf: float):
    """One rank of the ``mesh_kimi`` phase (spawned by ``run_on_mesh``): the
    parameters drawn in bf16 straight into this rank's blocks, one rank at a
    time, under the prefill rules; the EP layer through ``block_spmm``; the
    prefill forward through the flash kernel; the parameters dropped and
    drawn again under the decode rules; greedy serving in bf16."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import SHAPES
    from repro_torch.kernels import block_spmm as bsp
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate_on_mesh
    from repro_torch.launch.specs import make_ctx
    from repro_torch.models import moe, transformer
    from repro_torch.runtime.elastic import keep_blocks
    from repro_torch.sharding import rules
    from repro_torch.tree import tree_leaves

    bf16 = torch.bfloat16
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = mctx.mesh.device_type == "cuda"
    dev = torch.device("cuda", torch.cuda.current_device()) if card else torch.device("cpu")
    sync = torch.cuda.synchronize if card else (lambda: None)
    rank, world = dist.get_rank(), dist.get_world_size()
    d, m = (rules.axis_index(mctx, a) for a in MESH_AXES)
    load = lambda name: torch.from_numpy(np.load(os.path.join(tmp, name))).to(dev).view(bf16)  # noqa: E731
    peak = lambda: torch.cuda.max_memory_allocated() if card else None  # noqa: E731
    pctx = make_ctx(mctx, cfg, SHAPES["prefill_32k"])
    dctx = make_ctx(mctx, cfg, SHAPES["decode_32k"])
    axes = transformer.param_axes(cfg)
    out = dict(rank=rank, coord=[d, m], backend=mctx.mesh.backend,
               ranks_per_card=mctx.mesh.ranks_per_card)

    def draw(c):
        # one rank at a time: each leaf drawn whole in fp32 (seed 0, as the one
        # process did), cut to this rank's block under c's rules, cast to bf16
        params = None
        for r in range(world):
            if r == rank:
                params = transformer.init_params(cfg, seed=0, device=dev, dtype=bf16,
                                                 keep=keep_blocks(c, axes))
                if card:
                    torch.cuda.empty_cache()
            dist.barrier()
        return params

    warm_placement(mctx, dev)
    t0 = time.perf_counter()
    params = draw(pctx)
    out["build_s"] = time.perf_counter() - t0
    out["shard_bytes"] = sum(t.to_local().numel() * t.to_local().element_size()
                             for t in tree_leaves(params))
    out["build_peak_bytes"] = peak()

    # the expert-parallel layer through block_spmm, every launch held against the
    # kernel's plain version on the same operands, 8 experts (tasks) at a time
    B, S = masks["tokens"].shape
    gen_x = torch.Generator(device=dev).manual_seed(MESH_EP_SEED)
    x = torch.randn((B, S, cfg.d_model), generator=gen_x, device=dev).to(bf16)
    xd = rules.distribute(pctx, x, "batch", None, None)
    del x
    lp = params["layers"][0]["moe"]
    checks = []
    block_spmm = ops.block_spmm

    def holding(a, b, *args, **kw):
        got = block_spmm(a, b, *args, **kw)
        err = excess = 0.0
        for lo in range(0, a.shape[0], 8):
            n = min(8, a.shape[0] - lo)
            tasks = ops.task_arrays(np.arange(n), np.arange(n), np.arange(n), n, dev)
            a_c, b_c = a[lo:lo + n], b[lo:lo + n]
            diff = (got[lo:lo + n] - bsp.block_spmm_ref(a_c, b_c, *tasks, n)).abs()
            err = max(err, float(diff.max()))
            excess = max(excess, float((diff.flatten(1).amax(1).double()
                                        / block_tolerance(a_c, b_c, *tasks)).max()))
            del diff
        checks.append(dict(shape=[list(a.shape), list(b.shape)], dtype=str(a.dtype),
                           max_abs_err=err, err_over_limit=excess))
        return got

    kw = dict(num_experts=cfg.num_experts, top_k=cfg.top_k, act=cfg.mlp_act,
              gemm_impl="block_spmm")
    ops.block_spmm = holding
    try:
        with torch.inference_mode():
            bsp.launches = 0  # the main path's count starts here
            bsp.launches_by_tiles.clear()
            layer, counted = counted_step(card, lambda: moe.moe_apply(
                lp, xd, ctx=pctx, capacity_factor=rank_cf, **kw), ())
            out["ep_launches"] = bsp.launches  # ... and is read here
            out["ep_launches_by_tiles"] = {f"{e}/{k}": n for (e, k), n in bsp.launches_by_tiles.items()}
    finally:
        ops.block_spmm = block_spmm
    # every position: both sides route the same bf16 x through the same router
    diff = (layer.to_local().float() - load(f"layer_{d}.npy").float()).abs()
    # one call (each gathers the rank's experts over gloo): its seconds hold the
    # plain versions' checks too
    out["ep"] = dict(launch_checks=checks, max_abs_err=float(diff.max()), dtype=str(layer.dtype),
                     seconds=counted["ms"] / 1e3, collectives=counted["collectives"])
    del layer, diff, xd, lp
    if card:
        torch.cuda.empty_cache()

    # the prefill forward in bf16 through the flash kernel (head_dim 112), each
    # launch held against its plain version, counted as the dry run counts it
    tokens = torch.from_numpy(masks["tokens"]).to(dev)
    cfg_nd = dataclasses.replace(cfg, moe_capacity_factor=rank_cf)
    flash = ops.flash_attention
    fchecks = []

    def holding_flash(q, k, v, **kw):
        got = flash(q, k, v, **kw)
        err, excess = flash_excess(got, q, k, v, **kw)
        fchecks.append(dict(shape=list(q.shape), dtype=str(q.dtype), max_abs_err=err,
                            err_over_limit=excess))
        return got

    ops.flash_attention = holding_flash
    routes, restore = recording_routes()
    try:
        with torch.inference_mode():
            fa.launches = 0  # the main path's count starts here
            fa.launches_by_dtype.update(float32=0, bfloat16=0)
            logits, counted = counted_step(card, lambda: transformer.apply(
                params, cfg_nd, {"tokens": tokens}, attn_impl="flash", ctx=pctx),
                (params, tokens))
            launches = dict(fa.launches_by_dtype)  # ... and is read here
    finally:
        ops.flash_attention = flash
        restore()
    local = logits.to_local()
    # left out: the positions this rank routed to another set of experts than
    # the one process did (and, after a layer before the last, the row's later ones)
    B_l = local.shape[0]
    moved = torch.from_numpy(rerouted(
        [r.cpu().numpy() for r in routes],
        [r[d * B_l * S:(d + 1) * B_l * S] for r in masks["routes"]],
        B_l, len(routes), masks["last_moe"])).to(dev)
    del routes
    err = (local.float() - load(f"logits_{d}_{m}.npy").float()).abs().amax(-1)
    out["prefill"] = dict(local_shape=list(local.shape), spec=list(rules.spec_of(pctx, logits)),
                          dtype=str(local.dtype), finite=bool(torch.isfinite(local).all()),
                          max_abs_err=float(err[~moved].max()) if not moved.all() else None,
                          positions=moved.numel(), rerouted_positions=int(moved.sum()),
                          flash_checks=fchecks,
                          rerouted_max_abs_err=float(err[moved].max()) if moved.any() else None,
                          flash_launches=launches, seconds=counted["ms"] / 1e3,
                          peak_bytes=counted["peak_bytes"],
                          collectives_by_axis=counted["collectives"])
    del logits, local, err, moved, params
    if card:
        torch.cuda.empty_cache()
    out["prefill_peak_bytes"] = peak()

    # the decode layout: the prefill blocks dropped, the decode rules' blocks drawn
    t0 = time.perf_counter()
    dparams = draw(dctx)
    out["decode_build_s"] = time.perf_counter() - t0
    out["decode_shard_bytes"] = sum(t.to_local().numel() * t.to_local().element_size()
                                    for t in tree_leaves(dparams))
    out["w1_decode_spec"] = list(rules.spec_of(dctx, dparams["layers"][0]["moe"]["w1"]))

    # greedy serving in bf16 through make_serve_step(cfg, dctx)
    generate_on_mesh(dctx, cfg, dparams, prompts[:, :2], 2, dtype=bf16, device=dev)  # warm-up
    rules.reset_collective_counts()
    routes, restore = recording_routes()
    try:
        sync()
        t0 = time.perf_counter()
        seqs, steps = generate_on_mesh(dctx, cfg, dparams, prompts, gen, dtype=bf16, device=dev,
                                       return_logits=True)
        sync()
        secs = time.perf_counter() - t0
    finally:
        restore()
    n_steps = prompts.shape[1] + gen - 1
    counts = rules.collective_counts()
    ref = load(f"steps_{d}_{m}.npy").float()
    out["serve"] = dict(seqs=seqs.tolist(), seconds=secs, ms_per_decode_step=secs * 1e3 / n_steps,
                        collectives_per_step={k: {kk: vv / n_steps for kk, vv in v.items()}
                                              for k, v in counts.items()},
                        step_err=(steps - ref).abs().amax(-1).cpu().numpy().tolist(),
                        routes=[r.cpu().numpy() for r in routes])
    del steps, ref, routes
    out["decode_step"] = decode_step_alone(card, dctx, cfg, dparams, prompts, gen, dev,
                                           dtype=bf16)
    out["peak_bytes"] = peak()
    return out


def phase_mesh_kimi(ctx, sizes) -> dict:
    """kimi-k2-1t-a32b (1 of 61 layers) at full width, served in bf16 (the
    reference's serve dtype) on a (data 2, model 2) mesh of four ranks sharing
    the card over gloo, against one process: the one process first (its
    parameters drawn in bf16 leaf by leaf, 38.8 GB), its results saved per
    rank block under a ``tempfile`` directory and its model freed; then each
    rank draws its own blocks (:func:`mesh_kimi_rank`).  The EP layer at B 2
    x S 4096 (the rank's 192 experts gathered over ``data`` in chunks,
    ``moe.ep_chunk``), the prefill, 4 requests of 8 + 32 greedy tokens under
    the decode rules; then the rank's expert GEMMs timed on the card alone
    (:func:`kimi_gemm_timing`)."""
    import dataclasses
    import math

    import numpy as np

    torch = ctx.torch
    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.launch.serve import generate
    from repro_torch.models import moe, transformer
    from repro_torch.tree import tree_leaves

    bf16 = torch.bfloat16
    card = ctx.dev.type == "cuda"
    arch, layers = KIMI
    cfg = family_config(arch, layers, sizes["lm_reduced"])
    B, S = LM_BATCH, sizes["lm_seq"]
    R, P, G = SERVE
    dp, mp = MESH_SHAPE
    V_l = cfg.vocab_size // mp
    E_l = cfg.num_experts // mp
    cfg_nd = dataclasses.replace(cfg, moe_capacity_factor=MESH_NODROP_CF)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    prompts = rng.integers(0, cfg.vocab_size, (R, P))
    one, calls = {}, []
    moe_apply = moe.moe_apply
    peak = lambda: torch.cuda.max_memory_allocated() if card else None  # noqa: E731

    def recording(p, x, **kw):
        calls.append((x, p["router"]))
        return moe_apply(p, x, **kw)

    def timed(fn):
        ctx.sync()
        t0 = time.perf_counter()
        res = fn()
        ctx.sync()
        return res, time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="chip_smoke_kimi_") as tmp:
        def save(name, t):  # a bf16 block as its bits (numpy has no bf16)
            np.save(os.path.join(tmp, name), t.to(bf16).contiguous().view(torch.int16).cpu().numpy())

        # one process: the layer, the forward and greedy serving, each rank's block saved
        if card:
            torch.cuda.reset_peak_memory_stats()
        params, one["draw_s"] = timed(lambda: transformer.init_params(cfg, seed=0, device=ctx.dev,
                                                                      dtype=bf16))
        one["draw_peak_bytes"] = peak()
        one["param_bytes"] = sum(t.numel() * t.element_size() for t in tree_leaves(params))
        gen_x = torch.Generator(device=ctx.dev).manual_seed(MESH_EP_SEED)
        x = torch.randn((B, S, cfg.d_model), generator=gen_x, device=ctx.dev).to(bf16)
        lp = params["layers"][0]["moe"]
        kw = dict(num_experts=cfg.num_experts, top_k=cfg.top_k, act=cfg.mlp_act)
        with torch.inference_mode():
            layer = moe.moe_apply(lp, x, capacity_factor=MESH_NODROP_CF, **kw)
            loads = [_expert_loads(x, lp["router"], cfg.top_k, B // dp)]
            _, one["ep_s"] = timed(lambda: moe.moe_apply(lp, x, capacity_factor=MESH_NODROP_CF,
                                                         **kw))
        one["max_abs_layer"] = float(layer.float().abs().max())
        for i in range(dp):
            save(f"layer_{i}.npy", layer[i * B // dp:(i + 1) * B // dp])
        del layer, x
        moe.moe_apply = recording
        routes, restore = recording_routes()
        try:
            with torch.inference_mode():
                logits, one["prefill_s"] = timed(lambda: transformer.apply(
                    params, cfg_nd, {"tokens": torch.from_numpy(tokens).to(ctx.dev)},
                    attn_impl="flash"))
                prefill_routes = [r.cpu().numpy() for r in routes]
                loads += [_expert_loads(xc, r, cfg.top_k, B // dp) for xc, r in calls]
            calls.clear()
            one["max_abs_logit"] = float(logits.float().abs().max())
            one["logits_dtype"] = str(logits.dtype)
            for i in range(dp):
                for j in range(mp):
                    save(f"logits_{i}_{j}.npy", logits[i * B // dp:(i + 1) * B // dp, :,
                                                       j * V_l:(j + 1) * V_l])
            del logits
            generate(cfg, params, prompts[:, :2], 2, dtype=bf16, device=ctx.dev)  # warm-up
            routes.clear()
            (seqs, steps), secs = timed(lambda: generate(cfg, params, prompts, G, dtype=bf16,
                                                         device=ctx.dev, return_logits=True))
            one["ms_per_decode_step"] = secs * 1e3 / (P + G - 1)
            decode_routes = [r.cpu().numpy() for r in routes]
        finally:
            moe.moe_apply = moe_apply
            restore()
        one["peak_bytes"] = peak()
        smax = one["max_abs_step_logit"] = float(steps.abs().max())
        top2 = steps.float().topk(2, dim=-1).values
        margin = (top2[..., 0] - top2[..., 1]).cpu().numpy()  # [R, steps]
        for i in range(dp):
            for j in range(mp):
                save(f"steps_{i}_{j}.npy", steps[i * R // dp:(i + 1) * R // dp, :,
                                                 j * V_l:(j + 1) * V_l])
        seqs = np.asarray(seqs)
        del params, steps, top2, lp, routes
        calls.clear()
        if card:
            torch.cuda.empty_cache()
        max_load = dict(one_process=max(w for w, _ in loads), rank=max(b for _, b in loads))
        rank_tokens = B // dp * S * cfg.top_k
        rank_cf = math.ceil(4 * max_load["rank"] * cfg.num_experts / rank_tokens + 1) / 4
        caps = dict(one_process=math.ceil(B * S * cfg.top_k * MESH_NODROP_CF / cfg.num_experts),
                    rank=math.ceil(rank_tokens * rank_cf / cfg.num_experts))
        check(max_load["one_process"] <= caps["one_process"] and max_load["rank"] <= caps["rank"],
              f"mesh_kimi: an expert's load {max_load} exceeds the no-drop capacity {caps}")
        n_moe = sum(k in ("attn", "local") for k in transformer.layer_kinds(cfg))
        last_moe = transformer.layer_kinds(cfg)[-1] in ("attn", "local")
        masks = dict(tokens=tokens, routes=prefill_routes, last_moe=last_moe)
        parent_bytes = torch.cuda.memory_allocated() if card else None
        alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        t0 = time.perf_counter()
        try:
            ranks = run_on_mesh(mesh_kimi_rank, MESH_SHAPE, MESH_AXES, device=ctx.dev.type,
                                args=(cfg, tmp, prompts, G, masks, rank_cf), timeout_s=900)
        finally:
            if alloc_conf is None:
                del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
        mesh_s = time.perf_counter() - t0

    # the checks: every rank's launches, its kernels against their plain versions,
    # its blocks against one process's
    chunk = moe.ep_chunk(torch.empty((cfg.num_experts, cfg.d_model, cfg.d_ff), dtype=bf16,
                                     device="meta"), E_l)
    ep_gemms = 3 * math.ceil(E_l / chunk)  # w1, wg, w2 for each chunk
    attn_layers = transformer.layer_kinds(cfg).count("attn")
    lmax, layer_max = one["max_abs_logit"], one["max_abs_layer"]
    by_tiles = {}  # the main path's bf16 launches by (engine, pack), over the ranks
    for r in ranks:
        for k, n in r["ep_launches_by_tiles"].items():
            by_tiles[k] = by_tiles.get(k, 0) + n
    want_tiles = {} if ctx.rehearse else {"tiletc/1": ep_gemms * len(ranks)}
    check(by_tiles == want_tiles, f"mesh_kimi: the EP layers launched {by_tiles}, expected {want_tiles}")
    for r in ranks:
        tag = f"mesh_kimi rank {r['rank']} {tuple(r['coord'])}"
        check(r["ep_launches"] == (0 if ctx.rehearse else ep_gemms),
              f"{tag}: the EP layer launched block_spmm {r['ep_launches']} times, "
              f"expected {ep_gemms}")
        ep_checks = r["ep"]["launch_checks"]
        check(len(ep_checks) == ep_gemms and all(c["err_over_limit"] <= 1.0
                                                 and c["dtype"] == "torch.bfloat16"
                                                 for c in ep_checks),
              f"{tag}: a bf16 block_spmm launch is off its plain version: {ep_checks}")
        check(r["ep"]["dtype"] == "torch.bfloat16"
              and r["ep"]["max_abs_err"] <= BF16_REL * layer_max,
              f"{tag}: the EP layer is off one process's by {r['ep']['max_abs_err']} "
              f"> {BF16_REL} * {layer_max}")
        pf = r["prefill"]
        want_flash = dict(float32=0, bfloat16=0 if ctx.rehearse else attn_layers)
        check(pf["flash_launches"] == want_flash,
              f"{tag}: the prefill launched the flash kernel {pf['flash_launches']}, "
              f"expected {want_flash}")
        check(len(pf["flash_checks"]) == attn_layers
              and all(c["err_over_limit"] <= 1.0 for c in pf["flash_checks"]),
              f"{tag}: a prefill flash launch is off its plain version: {pf['flash_checks']}")
        check(pf["finite"] and pf["dtype"] == "torch.bfloat16"
              and pf["rerouted_positions"] <= REROUTED_MAX_SHARE * pf["positions"]
              and pf["max_abs_err"] <= BF16_REL * lmax,
              f"{tag}: prefill logits off one process's by {pf['max_abs_err']} "
              f"> {BF16_REL} * {lmax}, or {pf['rerouted_positions']} of {pf['positions']} "
              "positions routed elsewhere")
        check(pf["spec"] == ["data", None, "model"], f"{tag}: prefill logits laid out {pf['spec']}")
        check(r["w1_decode_spec"] == ["model", None, "data"],
              f"{tag}: w1 under the decode rules laid out {r['w1_decode_spec']}")
        check(r["serve"]["seqs"] == ranks[0]["serve"]["seqs"], f"{tag}: its tokens differ from rank 0's")
    mesh_seqs = np.asarray(ranks[0]["serve"]["seqs"])
    check(mesh_seqs.shape == (R, P + G) and np.array_equal(mesh_seqs[:, :P], prompts),
          f"mesh_kimi: generate_on_mesh returned {mesh_seqs.shape}, or not the prompts")
    # the steps some rank routed to other experts than one process did (after a
    # layer before the last, the row's later steps too), and each step's error
    # over the whole vocab (the model ranks' blocks)
    n_steps = P + G - 1
    moved = np.zeros((R, n_steps), bool)
    errs = np.zeros((R, n_steps))
    for r in ranks:
        moved |= rerouted(r["serve"]["routes"], decode_routes, R, n_moe, last_moe)
        rows = slice(r["coord"][0] * (R // dp), (r["coord"][0] + 1) * (R // dp))
        errs[rows] = np.maximum(errs[rows], np.asarray(r["serve"]["step_err"]))
    # a request may part from one process's tokens only after a step routed
    # elsewhere, or where one process's top two logits lie within twice that
    # step's error: only there can the mesh's greedy pick differ
    smax = one["max_abs_step_logit"]
    first_diff, parted = [], []
    for q in range(R):
        diff = np.nonzero(mesh_seqs[q] != seqs[q])[0]
        t = int(diff[0]) if diff.size else P + G
        first_diff.append(t)
        if diff.size:
            why = ("rerouted" if moved[q, t - 1] else "logit_margin"
                   if margin[q, t - 1] <= 2 * errs[q, t - 1] + 1e-6 * smax else None)
            parted.append(dict(request=q, at=t, why=why, margin=float(margin[q, t - 1]),
                               step_err=float(errs[q, t - 1])))
    check(all(p["why"] for p in parted),
          f"mesh_kimi: a request parts from one process's tokens unexplained: {parted}")
    # the step logits up to each request's parting (its step t - 1 read the same
    # tokens), less the steps routed elsewhere
    upto = np.arange(n_steps)[None, :] < np.asarray(first_diff)[:, None]
    compared = int((upto & ~moved).sum())
    step_err = float(errs[upto & ~moved].max()) if compared else None
    check(compared >= (1 - REROUTED_MAX_SHARE) * upto.sum() and step_err <= BF16_REL * smax,
          f"mesh_kimi: decode-step logits off one process's by {step_err} > {BF16_REL} * "
          f"{smax}, or {compared} of {int(upto.sum())} steps compared")
    timing = kimi_gemm_timing(ctx, cfg, B // dp * S, E_l, chunk)
    gb = lambda b: None if b is None else round(b / 1e9, 3)  # noqa: E731
    out = dict(phase="mesh_kimi", arch=cfg.name, layers=cfg.num_layers, dtype="bfloat16",
               mesh=dict(zip(MESH_AXES, MESH_SHAPE)), card=ctx.card,
               backend=ranks[0]["backend"], ranks_per_card=ranks[0]["ranks_per_card"],
               spawn_and_run_s=mesh_s, one_process=one,
               parent_allocated_gb_at_spawn=None if parent_bytes is None else parent_bytes / 1e9,
               no_drop_capacity_factor=dict(one_process=MESH_NODROP_CF, rank=rank_cf),
               capacity=caps, max_expert_load=max_load, rel=BF16_REL,
               ep_layer=dict(batch=B, seq=S, gemm_impl="block_spmm", chunk=chunk,
                             launches_per_rank=[r["ep_launches"] for r in ranks],
                             launches_by_tiles=by_tiles,
                             max_abs_one_process=layer_max,
                             max_abs_err=max(r["ep"]["max_abs_err"] for r in ranks),
                             tol=BF16_REL * layer_max,
                             kernel_checks=[c for r in ranks for c in r["ep"]["launch_checks"]],
                             seconds_per_rank=[r["ep"]["seconds"] for r in ranks],
                             one_process_seconds=one["ep_s"],
                             collectives=ranks[0]["ep"]["collectives"]),
               prefill=dict(batch=B, seq=S, attn_impl="flash",
                            flash_launches_per_rank=[r["prefill"]["flash_launches"] for r in ranks],
                            flash_checks=[c for r in ranks for c in r["prefill"]["flash_checks"]],
                            logits_spec=ranks[0]["prefill"]["spec"],
                            local_logits_shape=ranks[0]["prefill"]["local_shape"],
                            max_abs_logit=lmax,
                            max_abs_err=max(r["prefill"]["max_abs_err"] for r in ranks),
                            tol=BF16_REL * lmax,
                            positions_per_rank=ranks[0]["prefill"]["positions"],
                            rerouted_positions_per_rank=[r["prefill"]["rerouted_positions"]
                                                         for r in ranks],
                            rerouted_max_abs_err=max((r["prefill"]["rerouted_max_abs_err"] or 0.0)
                                                     for r in ranks),
                            seconds_per_rank=[r["prefill"]["seconds"] for r in ranks],
                            one_process_seconds=one["prefill_s"],
                            peak_bytes_per_rank=[r["prefill"]["peak_bytes"] for r in ranks],
                            collectives_per_rank=[r["prefill"]["collectives_by_axis"]
                                                  for r in ranks]),
               decode_step=dict(ranks[0]["decode_step"], ms_per_rank=[
                   r["decode_step"]["ms"] for r in ranks], peak_bytes_per_rank=[
                   r["decode_step"]["peak_bytes"] for r in ranks],
                   collectives_per_rank=[r["decode_step"]["collectives"] for r in ranks]),
               serve=dict(requests=R, prompt_len=P, new_tokens=G, dtype="bfloat16",
                          decode_steps=n_steps,
                          ms_per_decode_step_per_rank=[r["serve"]["ms_per_decode_step"]
                                                       for r in ranks],
                          one_process_ms_per_decode_step=one["ms_per_decode_step"],
                          collectives_per_step=ranks[0]["serve"]["collectives_per_step"],
                          tokens_equal_one_process=bool(np.array_equal(mesh_seqs, seqs)),
                          parted=parted, rerouted_steps=int((upto & moved).sum()),
                          max_abs_step_logit=smax, max_abs_step_err=step_err,
                          tol=BF16_REL * smax, steps_compared=compared,
                          rerouted_max_abs_step_err=(float(errs[upto & moved].max())
                                                     if (upto & moved).any() else None),
                          first_sequence=mesh_seqs[0].tolist()),
               build_s_per_rank=dict(prefill=[r["build_s"] for r in ranks],
                                     decode=[r["decode_build_s"] for r in ranks]),
               shard_gb_per_rank=dict(prefill=[gb(r["shard_bytes"]) for r in ranks],
                                      decode=[gb(r["decode_shard_bytes"]) for r in ranks]),
               peak_gb_per_rank=dict(build=[gb(r["build_peak_bytes"]) for r in ranks],
                                     prefill=[gb(r["prefill_peak_bytes"]) for r in ranks],
                                     end=[gb(r["peak_bytes"]) for r in ranks]),
               expert_gemms=timing)
    emit(out)
    return out


MESH_TRAIN_STEPS = 3
MESH_TRAIN_LOSS_REL = 1e-2
# the parity step's rate (warmup 0: the peak at once) and, for the new state
# against one process's, the moments' limits: the first step's moments are
# 0.1 g and 0.05 g^2, so they inherit the gradients' TRAIN_GRAD_REL (twice for
# g^2); a parameter moves about lr * sign(g), so one whose gradient is rounding
# noise (a key bias's: softmax ignores a shift of a query's scores) may move
# 2 * lr either way
MESH_TRAIN_LR = 3e-4


def _leaf_file(tmp: str, tree: str, path: str) -> str:
    return os.path.join(tmp, f"{tree}.{path.replace('/', '.')}.npy")


def _save_tree(tmp: str, name: str, tree, scales: dict) -> None:
    """Each leaf of ``tree`` as an fp32 ``.npy`` under ``tmp``, and its max|x| in ``scales``."""
    import numpy as np

    from repro_torch.tree import tree_paths

    for path, t in tree_paths(tree):
        np.save(_leaf_file(tmp, name, path), t.detach().float().cpu().numpy())
        scales[f"{name}/{path}"] = float(t.detach().abs().max())


def _saved_blocks(tctx, like, tmp: str, name: str, dev):
    """This rank's blocks of the tree saved under ``name`` (read from the files
    by memory map), as ``DTensor``\\s laid out as the leaves of ``like``."""
    import numpy as np
    import torch

    from repro_torch.sharding import rules
    from repro_torch.tree import tree_paths, tree_unflatten

    def block(path, t):
        whole = torch.from_numpy(np.load(_leaf_file(tmp, name, path), mmap_mode="c"))
        local = rules.local_block(tctx, whole, rules.spec_of(tctx, t))
        return rules.like(t, local.to(device=dev, dtype=rules.block(t).dtype))

    return tree_unflatten(like, [block(path, t) for path, t in tree_paths(like)])


def _block_excess(tctx, got, tmp: str, name: str, limit, scales: dict) -> tuple:
    """``(the worst max|got - want| / limit(max|want|) over the leaves, its path)``:
    ``got`` a tree of ``DTensor``\\s, ``want`` the one process's tree saved
    under ``name``, of which each rank reads only its blocks."""
    from repro_torch.sharding import rules
    from repro_torch.tree import tree_leaves, tree_paths

    want = _saved_blocks(tctx, got, tmp, name, rules.block(tree_leaves(got)[0]).device)
    worst, where = 0.0, None
    for (path, g), w in zip(tree_paths(got), tree_leaves(want), strict=True):
        err = float((rules.block(g).float() - rules.block(w).float()).abs().max())
        bound = limit(scales[f"{name}/{path}"])
        ratio = err / bound if bound > 0 else (0.0 if err == 0 else math.inf)
        if ratio > worst or where is None:
            worst, where = ratio, path
    return worst, where


def _blocks_equal(a, b) -> bool:
    """Two trees of ``DTensor``\\s hold the same bits on this rank."""
    import torch

    from repro_torch.sharding import rules
    from repro_torch.tree import tree_leaves

    return all(torch.equal(rules.block(x), rules.block(y))
               for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True))


def mesh_train_rank(mctx, cfg, parity_layers: int, tmp: str, scales: dict, batch, steps: int,
                    lr: float):
    """One rank of the ``mesh_train`` phase (spawned by ``run_on_mesh``)."""
    import dataclasses
    import statistics

    import torch
    import torch.distributed as dist

    from repro_torch.configs import SHAPES
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import block_spmm as bsp
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_leaf as fl
    from repro_torch.launch.specs import make_ctx
    from repro_torch.models import model as model_mod
    from repro_torch.models import transformer
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.sharding import rules
    from repro_torch.tree import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = mctx.mesh.device_type == "cuda"
    dev = torch.device("cuda", torch.cuda.current_device()) if card else torch.device("cpu")
    sync = torch.cuda.synchronize if card else (lambda: None)
    peak = lambda: torch.cuda.max_memory_allocated() if card else None  # noqa: E731
    rank, world = dist.get_rank(), dist.get_world_size()
    tctx = make_ctx(mctx, cfg, SHAPES["train_4k"])
    out = dict(rank=rank, coord=[rules.axis_index(mctx, a) for a in MESH_AXES])
    warm_placement(mctx, dev)

    def placed(c):
        """``c``'s state from seed 0, drawn whole by one rank at a time (as the one
        process drew it) and kept as this rank's blocks under the train rules."""
        for r in range(world):
            if r == rank:
                whole = model_mod.init_train_state(c, seed=0, device=dev)
                state = reshard_state(whole, None, tctx, transformer.param_axes(c))
                del whole
                if card:
                    torch.cuda.empty_cache()
            dist.barrier()
        return state

    def counts():
        return {k: dict(v) for k, v in rules.collective_counts().items()}

    # (a) fp32 parity: the gradients and one step in each mode against one process's,
    # under the train rules and under sequence parallelism (seq -> model)
    pcfg = dataclasses.replace(cfg, num_layers=parity_layers)
    state = placed(pcfg)
    kw = dict(compute_dtype=torch.float32)
    sctx = tctx.with_rules(seq=("model",))

    def parity(c) -> dict:
        grads, steps_a, par = {}, {}, {}
        for rs in (True, False):
            rules.reset_collective_counts()
            loss, grads[rs] = model_mod.make_grad_fn(pcfg, c, grad_reshard=rs, **kw)(
                state["params"], batch)
            par[f"grad_collectives_{rs}"] = counts()
            par[f"grad_collectives_by_axis_{rs}"] = rules.collective_counts(by_axis=True)
            par[f"loss_{rs}"] = float(loss)
            steps_a[rs] = model_mod.make_train_step(pcfg, c, warmup=0, lr_peak=lr,
                                                    grad_reshard=rs, **kw)(state, batch)
        par["modes_bit_identical"] = (
            _blocks_equal(grads[True], grads[False])
            and _blocks_equal(*(s[0] for s in steps_a.values()))
            and all(float(steps_a[True][1][k]) == float(steps_a[False][1][k])
                    for k in ("loss", "grad_norm")))
        new, metrics = steps_a[True]
        par["step_loss"], par["grad_norm"] = float(metrics["loss"]), float(metrics["grad_norm"])
        par["grad_excess"] = _block_excess(c, grads[True], tmp, "grads",
                                           lambda mx: TRAIN_GRAD_REL * mx, scales)
        moments = {"mu": TRAIN_GRAD_REL, "nu": 2 * TRAIN_GRAD_REL}
        par["new_excess"] = {
            "params": _block_excess(c, new["params"], tmp, "new_params",
                                    lambda mx: 2 * lr * (1 + 1e-3), scales),
            **{k: _block_excess(c, new["opt"][k], tmp, f"new_{k}",
                                lambda mx, rel=rel: rel * mx, scales)
               for k, rel in moments.items()}}
        return par

    par = parity(tctx)
    par_sp = parity(sctx)
    # the mesh's update of the one process's own gradients: clip over sharded
    # blocks and AdamW on blocks, against the one process's update
    theirs = _saved_blocks(tctx, state["params"], tmp, "grads", dev)
    upd, um = model_mod.make_update_fn(warmup=0, lr_peak=lr)(state, theirs)
    par["update_grad_norm"] = float(um["grad_norm"])
    par["update_excess"] = {k: _block_excess(tctx, tree, tmp, f"new_{k}",
                                             lambda mx: TRAIN_UPDATE_REL * mx, scales)
                            for k, tree in (("params", upd["params"]), ("mu", upd["opt"]["mu"]),
                                            ("nu", upd["opt"]["nu"]))}
    par["peak_bytes"] = peak()
    out["parity"], out["parity_sp"] = par, par_sp
    del state, theirs, upd
    if card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # (b) every layer, bf16 compute, fp32 parameters and AdamW, the config's remat
    t0 = time.perf_counter()
    state0 = placed(cfg)
    out["build_s"] = time.perf_counter() - t0
    out["shard_bytes"] = sum(rules.block(t).numel() * rules.block(t).element_size()
                             for t in tree_leaves(state0))
    out["build_peak_bytes"] = peak()
    if card:
        torch.cuda.reset_peak_memory_stats()
    pipe = TokenPipeline(cfg, batch=batch["tokens"].shape[0], seq=batch["tokens"].shape[1],
                         seed=0)
    bsp.launches = fl.launches = fa.launches = 0  # the main path's count starts here
    timed, firsts = {}, {}
    # the FSDP reductions, then sequence parallelism with the reduce-scatter one
    modes = {"reduce_scatter": (tctx, True), "all_reduce": (tctx, False), "sp": (sctx, True)}
    for mode, (c, rs) in modes.items():
        step = model_mod.make_train_step(cfg, c, compute_dtype=torch.bfloat16,
                                         lr_peak=TRAIN_LR, warmup=1, total_steps=steps,
                                         grad_reshard=rs)
        s, ms, losses = state0, [], []
        for i in range(steps):
            rules.reset_collective_counts()
            sync()
            if card and i == steps - 1:  # the step's own memory, above what is held
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            s, m = step(s, pipe.global_batch(i))
            losses.append(float(m["loss"]))
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0 and mode != "sp":
                firsts[rs] = (s, m)
        timed[mode] = dict(step_ms=ms, ms_per_step=statistics.median(ms[1:]), losses=losses,
                           collectives_per_step=counts(),
                           collectives_by_axis=rules.collective_counts(by_axis=True),
                           # the last step's peak with its inputs (the state it was given),
                           # the dry run's peak_bytes_card of the same step
                           step_peak_bytes=(torch.cuda.max_memory_allocated() - held
                                            + _card_bytes(state0)) if card else None)
        if card and mode == "reduce_scatter":
            out["step_peak_above_held_bytes"] = torch.cuda.max_memory_allocated() - held
        del s
        if mode == "reduce_scatter":  # the first step again, from the same state: the same bits
            again = step(state0, pipe.global_batch(0))
            timed[mode]["repeat_bit_identical"] = (
                _blocks_equal(again[0], firsts[rs][0])
                and float(again[1]["loss"]) == float(firsts[rs][1]["loss"]))
            del again
    out["launches"] = dict(block_spmm=bsp.launches, fused_block_spmm=fl.launches,
                           flash_attention=fa.launches)  # ... and is read here
    out["modes_bit_identical"] = (_blocks_equal(firsts[True][0], firsts[False][0])
                                  and all(float(firsts[True][1][k]) == float(firsts[False][1][k])
                                          for k in ("loss", "grad_norm")))
    out["timed"] = timed
    out["peak_bytes"] = peak()  # the steps and the states kept for the checks beside them
    del firsts, state0
    return out


def phase_mesh_train(ctx, sizes, lm_train: dict) -> dict:
    """qwen2-0.5b's train step at full width on a (data 2, model 2) mesh of four
    ranks sharing the card over gloo, against one process: the parity step
    (2 layers, fp32) and timed steps (every layer, bf16 compute) in both
    FSDP reductions."""
    import dataclasses

    torch = ctx.torch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.mesh import run_on_mesh
    from repro_torch.models import model as model_mod
    from repro_torch.tree import tree_leaves

    t = sizes["train"]
    cfg = reduced_config("qwen2-0.5b") if sizes["lm_reduced"] else get_config("qwen2-0.5b")
    pcfg = dataclasses.replace(cfg, num_layers=t["parity_layers"])
    B, S = t["batch"], t["seq"]
    batch = TokenPipeline(cfg, batch=B, seq=S, seed=0).global_batch(0)
    one = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_train_") as tmp:
        # one process: the parity step's loss, gradients, norm and new state, kept whole on the host
        state = model_mod.init_train_state(pcfg, seed=0, device=ctx.dev)
        loss, grads = model_mod.make_grad_fn(pcfg, compute_dtype=torch.float32)(
            state["params"], batch)
        scales = {}
        _save_tree(tmp, "grads", grads, scales)
        del grads
        new, m = model_mod.make_train_step(pcfg, compute_dtype=torch.float32, warmup=0,
                                           lr_peak=MESH_TRAIN_LR)(state, batch)
        one.update(loss=float(loss), step_loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
        _save_tree(tmp, "new_params", new["params"], scales)
        for k in ("mu", "nu"):
            _save_tree(tmp, f"new_{k}", new["opt"][k], scales)
        one["params"] = sum(p.numel() for p in tree_leaves(state["params"]))
        del state, new, m, loss
        if ctx.dev.type == "cuda":
            torch.cuda.empty_cache()  # four ranks share the card next
        parent_bytes = torch.cuda.memory_allocated() if ctx.dev.type == "cuda" else None
        alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        t0 = time.perf_counter()
        try:
            ranks = run_on_mesh(mesh_train_rank, MESH_SHAPE, MESH_AXES, device=ctx.dev.type,
                                args=(cfg, t["parity_layers"], tmp, scales, batch,
                                      MESH_TRAIN_STEPS, MESH_TRAIN_LR), timeout_s=900)
        finally:
            if alloc_conf is None:
                del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
        mesh_s = time.perf_counter() - t0

    ref_loss = lm_train["losses"][0]
    for r in ranks:
        for name in ("parity", "parity_sp"):  # under the train rules, and with seq -> model
            tag = f"mesh_train rank {r['rank']} {tuple(r['coord'])} {name}"
            p = r[name]
            for key in ("loss_True", "loss_False", "step_loss"):
                rel = abs(p[key] - one["loss"]) / abs(one["loss"])
                check(rel <= TRAIN_LOSS_REL, f"{tag}: {key} {p[key]} off one process's "
                                             f"{one['loss']} by {rel} relative")
            for key in ("grad_norm", "update_grad_norm"):
                if key in p:
                    rel = abs(p[key] - one["grad_norm"]) / abs(one["grad_norm"])
                    check(rel <= TRAIN_LOSS_REL, f"{tag}: {key} {p[key]} off one process's "
                                                 f"{one['grad_norm']} by {rel} relative")
            check(p["grad_excess"][0] <= 1.0, f"{tag}: gradient {p['grad_excess']} x its limit")
            for k, (x, where) in {**p["new_excess"], **{f"update_{k}": v for k, v in
                                                      p.get("update_excess", {}).items()}}.items():
                check(x <= 1.0, f"{tag}: new {k} at {where} is {x} x its limit")
            check(p["modes_bit_identical"], f"{tag}: grad_reshard True and False differ")
        tag = f"mesh_train rank {r['rank']} {tuple(r['coord'])}"
        sp_axes = r["parity_sp"]["grad_collectives_by_axis_True"]
        check("model" in sp_axes.get("reduce_scatter", {}),
              f"{tag}: the sequence-parallel step ran {sp_axes}")
        check(r["modes_bit_identical"], f"{tag}: grad_reshard True and False differ (bf16)")
        check(r["launches"] == dict(block_spmm=0, fused_block_spmm=0, flash_attention=0),
              f"{tag}: the mesh train step launched kernels {r['launches']}")
        for mode, tm in r["timed"].items():
            rel = abs(tm["losses"][0] - ref_loss) / abs(ref_loss)
            check(rel <= MESH_TRAIN_LOSS_REL, f"{tag}: {mode} step 0's loss {tm['losses'][0]} "
                                              f"off lm_train's {ref_loss} by {rel} relative")
            check(all(map(math.isfinite, tm["losses"])), f"{tag}: {mode} a non-finite loss")
        check(r["timed"]["reduce_scatter"]["repeat_bit_identical"],
              f"{tag}: two runs of one step differ")
        rs_counts = r["timed"]["reduce_scatter"]["collectives_per_step"]
        check("reduce_scatter" in rs_counts
              and "reduce_scatter" not in r["timed"]["all_reduce"]["collectives_per_step"],
              f"{tag}: the FSDP reductions ran {sorted(rs_counts)}")
    gb = lambda b: None if b is None else round(b / 1e9, 3)  # noqa: E731
    r0 = ranks[0]
    out = dict(phase="mesh_train", arch=cfg.name, mesh=dict(zip(MESH_AXES, MESH_SHAPE)),
               card=ctx.card, rules="train_4k (embed -> data, heads/kv_heads/mlp/vocab -> model)",
               spawn_and_run_s=mesh_s,
               parent_allocated_gb_at_spawn=None if parent_bytes is None else parent_bytes / 1e9,
               parity=dict(layers=t["parity_layers"], batch=B, seq=S, compute="float32",
                           lr=MESH_TRAIN_LR, one_process=one,
                           loss_rel_err=max(abs(r["parity"]["loss_True"] - one["loss"])
                                            / abs(one["loss"]) for r in ranks),
                           grad_norm_rel_err=max(abs(r["parity"]["grad_norm"] - one["grad_norm"])
                                                 / abs(one["grad_norm"]) for r in ranks),
                           grad_err_over_limit=max(r["parity"]["grad_excess"][0] for r in ranks),
                           grad_limit=f"{TRAIN_GRAD_REL} * max|g| per leaf",
                           new_state_err_over_limit={
                               k: max(r["parity"]["new_excess"][k][0] for r in ranks)
                               for k in ("params", "mu", "nu")},
                           new_state_limits=dict(params=f"2 * lr = {2 * MESH_TRAIN_LR}",
                                                 mu=f"{TRAIN_GRAD_REL} * max|mu|",
                                                 nu=f"{2 * TRAIN_GRAD_REL} * max|nu|"),
                           update_of_one_process_grads_err_over_limit={
                               k: max(r["parity"]["update_excess"][k][0] for r in ranks)
                               for k in ("params", "mu", "nu")},
                           update_limit=f"{TRAIN_UPDATE_REL} * max|x| per leaf",
                           modes_bit_identical=all(r["parity"]["modes_bit_identical"]
                                                   for r in ranks),
                           grad_collectives=dict(reduce_scatter=r0["parity"]["grad_collectives_True"],
                                                 all_reduce=r0["parity"]["grad_collectives_False"]),
                           peak_gb_per_rank=[gb(r["parity"]["peak_bytes"]) for r in ranks]),
               parity_sp=dict(
                   rules="train_4k's and seq -> model (sequence parallelism)",
                   loss_rel_err=max(abs(r["parity_sp"][k] - one["loss"]) / abs(one["loss"])
                                    for r in ranks for k in ("loss_True", "loss_False")),
                   grad_norm_rel_err=max(abs(r["parity_sp"]["grad_norm"] - one["grad_norm"])
                                         / abs(one["grad_norm"]) for r in ranks),
                   grad_err_over_limit=max(r["parity_sp"]["grad_excess"][0] for r in ranks),
                   new_state_err_over_limit={
                       k: max(r["parity_sp"]["new_excess"][k][0] for r in ranks)
                       for k in ("params", "mu", "nu")},
                   modes_bit_identical=all(r["parity_sp"]["modes_bit_identical"] for r in ranks),
                   grad_collectives_by_axis=dict(
                       reduce_scatter=r0["parity_sp"]["grad_collectives_by_axis_True"],
                       all_reduce=r0["parity_sp"]["grad_collectives_by_axis_False"])),
               timed=dict(layers=cfg.num_layers, batch=B, seq=S, compute="bfloat16",
                          params_dtype="float32", remat=cfg.remat, steps_per_mode=MESH_TRAIN_STEPS,
                          ms_per_step={mode: [r["timed"][mode]["ms_per_step"] for r in ranks]
                                       for mode in r0["timed"]},
                          step_ms={mode: [r["timed"][mode]["step_ms"] for r in ranks]
                                   for mode in r0["timed"]},
                          one_process_ms_per_step=dict(
                              train_loop_median=lm_train["ms_per_step_median"],
                              remat_full=lm_train["remat"]["full"]["ms_per_step"]),
                          losses={mode: r0["timed"][mode]["losses"] for mode in r0["timed"]},
                          lm_train_step0_loss=ref_loss,
                          collectives_per_step={mode: r0["timed"][mode]["collectives_per_step"]
                                                for mode in r0["timed"]},
                          collectives_by_axis_per_rank={
                              mode: [r["timed"][mode]["collectives_by_axis"] for r in ranks]
                              for mode in r0["timed"]},
                          step_peak_bytes_per_rank={
                              mode: [r["timed"][mode]["step_peak_bytes"] for r in ranks]
                              for mode in r0["timed"]},
                          repeat_bit_identical=all(r["timed"]["reduce_scatter"]["repeat_bit_identical"]
                                                   for r in ranks),
                          modes_bit_identical=all(r["modes_bit_identical"] for r in ranks),
                          launches_per_rank=[r["launches"] for r in ranks]),
               shard_gb_per_rank=[gb(r["shard_bytes"]) for r in ranks],
               peak_gb_per_rank=dict(build=[gb(r["build_peak_bytes"]) for r in ranks],
                                     steps=[gb(r["peak_bytes"]) for r in ranks],
                                     one_step_above_held=[gb(r.get("step_peak_above_held_bytes"))
                                                          for r in ranks]),
               build_s_per_rank=[r["build_s"] for r in ranks])
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
    card = None
    if not args.rehearse:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True)
        card = smi.stdout.strip().splitlines()[0]
        print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # an empty tile-autotuner cache: no cache in the machine's home moves a
    # phase's launches (the autotune phase tunes into a cache of its own)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_autotune_") as tmp:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(tmp, "autotune.json")
        return run_phases(torch, args, card)


def run_phases(torch, args, card) -> int:
    ctx = Context(torch, args.rehearse)
    ctx.card = card
    sizes = REHEARSAL if args.rehearse else FULL
    t0 = time.perf_counter()

    walls = {}

    def phase(fn, *args):
        t1 = time.perf_counter()
        out = fn(*args)
        if ctx.dev.type == "cuda":
            torch.cuda.empty_cache()
        walls[fn.__name__] = time.perf_counter() - t1
        print(f"chip_smoke: {fn.__name__} {walls[fn.__name__]:.1f} s", file=sys.stderr, flush=True)
        return out

    phase(phase_build, ctx)
    sweep = start_dryrun_sweep(sizes)  # host only: beside the card phases up to dryrun
    try:
        phase(phase_analysis, ctx)
        kern = phase(phase_kernel, ctx, sizes)
        tuned = phase(phase_autotune, ctx, sizes)
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
        train = phase(phase_lm_train, ctx, sizes)
        phase(phase_dryrun, ctx, sizes, sweep)
        moe_layer = phase(phase_moe_layer, ctx, sizes)
        families = phase(phase_lm_families, ctx, sizes)
        mesh = phase(phase_mesh_serve, ctx, sizes, families)
        kimi = phase(phase_mesh_kimi, ctx, sizes)
        mtrain = phase(phase_mesh_train, ctx, sizes, train)
        phase(phase_dryrun_mesh, ctx, sizes, mesh, mtrain, kimi)
        phase(phase_examples, ctx)
        phase(phase_dist_pipeline_profile, ctx, sizes)

        timing, ftiming = kern["timing"], fused["timing"]
        # the mesh's qwen3-moe prefills (without and with sequence parallelism) run fp32
        # flash on every rank, kimi-k2's prefill bf16 flash
        mesh_per_rank = dict(float32=[a + b for a, b in zip(
            mesh["prefill"]["flash_launches_per_rank"], mesh["prefill_sp"]["flash_launches_per_rank"])],
            bfloat16=[r["bfloat16"] for r in kimi["prefill"]["flash_launches_per_rank"]])
        mesh_flash = {k: sum(v) for k, v in mesh_per_rank.items()}
        flash_t = flash["timing"][FLASH_TIMED[0]]  # qwen2-0.5b's layer

        def flash_row(dtype):
            t = flash_t[dtype]
            bf16 = dtype == "bfloat16"
            return dict(name=f"flash_attention_{'bf16' if bf16 else 'f32'}", route="cuda",
                        source="src/repro_torch/kernels/csrc/flash_attention.cu",
                        replaces="src/repro/kernels/flash_attention.py:31",
                        launches=(fwd["launches_by_dtype"][dtype] + serve["launches_by_dtype"][dtype]
                                  + families["launches_by_dtype"].get(dtype, 0) + mesh_flash[dtype]),
                        mesh_launches_per_rank=mesh_per_rank[dtype],
                        max_abs_err=max(c["max_abs_err"] for c in flash["cases"] if c["dtype"] == dtype),
                        ms=t["ms"], plain_ms=t["plain_ms"],
                        bound_ms=t["bf16_bound_ms"] if bf16 else t["bound_ms"],
                        bound_by=t["bf16_bound_by"] if bf16 else t["bound_by"], library_ms=t["sdpa_ms"])

        emit({"kernels": [
            dict(name="block_spmm", route="cuda", source="src/repro_torch/kernels/csrc/block_spmm.cu",
                 replaces="src/repro/kernels/block_spmm.py:38",
                 launches=(mul["launches"] + sp2["kernel_launches"] + douter["launches"]
                           + moe_layer["launches"] + sum(mesh["ep_layer"]["launches_per_rank"])
                           + sum(kimi["ep_layer"]["launches_per_rank"])),
                 mesh_launches_per_rank=mesh["ep_layer"]["launches_per_rank"],
                 mesh_kimi_launches_per_rank=kimi["ep_layer"]["launches_per_rank"],
                 kimi_expert_gemms=kimi["expert_gemms"],
                 mesh_kimi_launches_by_tiles=kimi["ep_layer"]["launches_by_tiles"],
                 bf16=[{k: kern["bf16_timing"][k] for k in (
                     "case", "engine", "ms", "tile128_ms", "plain_ms", "bound_ms", "bound_by")}
                     | dict(library_ms=kern["bf16_timing"]["bmm_yardstick_ms"]),
                     dict(case="kimi_k2_rank_layer", engine=kimi["expert_gemms"]["launches"][0]["engine"],
                          ms=kimi["expert_gemms"]["rank_layer"]["ms"],
                          tile64_ms=kimi["expert_gemms"]["rank_layer"]["tile64_ms"], plain_ms=None,
                          plain="not timed: each rank holds every launch against it 8 experts at a time",
                          bound_ms=kimi["expert_gemms"]["rank_layer"]["card_bound_ms"],
                          bound_by=kimi["expert_gemms"]["rank_layer"]["card_bound_by"],
                          library_ms=kimi["expert_gemms"]["rank_layer"]["bmm_ms"])],
                 max_abs_err=max(c["max_abs_err"] for c in kern["cases"]),
                 ms=timing["ms"], plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
                 bound_by=timing["bound_by"], library_ms=timing["bmm_yardstick_ms"],
                 library="torch.bmm on the pre-gathered operands: the products only, no gather, no sum",
                 autotune=[{k: r.get(k) for k in ("case", "shape", "dtype", "winner", "rule", "rule_ms",
                                                  "tuned_ms", "fused_rule_ms", "fused_tuned_ms")}
                           | dict(winner_us=min(c["us"] for c in r["candidates"]),
                                  rule_us=next(c["us"] for c in r["candidates"] if c["tiles"] == r["rule"]))
                           for r in tuned["shapes"]],
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
                 bound_by=ftiming["bound_by"], library_ms=ftiming["bmm_yardstick_ms"],
                 library="torch.bmm on the pre-gathered operands: the products only, no gather, no sum",
                 small_blocks=[{k: fused["small_block"][k] for k in (
                     "case", "engine", "ms", "tile64_ms", "plain_ms", "bound_ms", "bound_by")}
                     | dict(library_ms=fused["small_block"]["bmm_yardstick_ms"])],
                 bf16=[{k: fused["bf16_timing"][k] for k in (
                     "case", "engine", "ms", "tile128_ms", "plain_ms", "bound_ms", "bound_by",
                     "fused_eq_staged")} | dict(library_ms=fused["bf16_timing"]["bmm_yardstick_ms"])]),
            flash_row("float32"),
            flash_row("bfloat16"),
        ]})
        print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s; by phase "
              + json.dumps({k.removeprefix("phase_"): round(v, 1) for k, v in walls.items()}),
              file=sys.stderr)
        if args.rehearse:
            emit({"ok": True, "rehearsal": True, "device": {"platform": "cpu", "kind": "cpu", "count": 0}})
        else:
            emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                         "count": torch.cuda.device_count()}})
        return 0
    finally:  # the sweep's process ends with the smoke, whatever failed
        sweep["proc"].join()
        if os.path.exists(sweep["path"]):
            os.unlink(sweep["path"])


if __name__ == "__main__":
    sys.exit(main())
