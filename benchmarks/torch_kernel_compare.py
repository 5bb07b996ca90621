#!/usr/bin/env python3
"""Hold the port's CUDA kernels against an older copy of their sources, on one card.

    python3 benchmarks/torch_kernel_compare.py --old DIR [--out FILE]

``DIR`` holds an older ``src/repro_torch/kernels/csrc`` (``block_spmm.cu``,
``fused_block_spmm.cu``, ``tile_gemm.cuh``, ``flash_attention.cu``), for
example one unpacked from ``git archive <commit> src/repro_torch/kernels/csrc``
into a directory that ``.gitignore`` lists.  Both versions are built with
``nvcc`` (the older one into ``build/kernel_compare/``), loaded side by side
and run through the same Python wrappers on the same inputs:

- ``block_spmm`` on ``chip_smoke.py``'s timing case (the N = 8192 band at
  bs 128, fp32), on the same band at bs 64 and on the dropless grouped
  GEMM at ``moe_layer``'s shape (65,536 rows routed at random to 128
  experts, 8-row tiles of [8, 4096] @ [4096, 1536]), and ``fused_block_spmm``
  on its fused timing case (the bs-128 band planned for 8 workers): the two
  versions' outputs must be bit-identical;
- ``flash_attention`` on qwen2-0.5b's layer in fp32 and bf16, on
  ``chip_smoke.py``'s D 128 and D 256 cases in both types and on its kimi-k2
  rank layer (D 112) in bf16: each version's output is held against the
  plain version with ``chip_smoke.py``'s limit.

``--only flash`` (or ``gemm``) runs one half.

Each kernel is timed with CUDA events in turns old, new, new, old (the flash
kernels in device time, queued behind a spinning kernel), and the
current version is run back to back for about a second while ``nvidia-smi``
samples the SM clock and the power draw.  The result is one JSON object on
the last line of standard output (and in ``--out``); it names the card and
its power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

NAMES = ("block_spmm", "fused_block_spmm", "flash_attention")


def build_old(old_dir: Path, names=NAMES) -> dict[str, ctypes.CDLL]:
    """Compile the older sources, one ``nvcc`` each, all at once."""
    from repro_torch.kernels import build

    out_dir = ROOT / "build" / "kernel_compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out_dir / f"{name}-old.so"),
               str(old_dir / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the older {name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(str(out_dir / f"{name}-old.so"))
    return libs


class Versions:
    """Switches the wrappers between the current libraries and the older ones."""

    def __init__(self, old: dict[str, ctypes.CDLL]):
        from repro_torch.kernels import build

        self.build = build
        self.new = {name: build.load_library(name) for name in old}
        self.old = old

    def use(self, which: str) -> None:
        self.build._libraries.update(self.old if which == "old" else self.new)


def turns(ctx, versions, fn, reps: int, device: bool = False) -> dict:
    """ms of ``fn`` for each version, timed in turns old, new, new, old
    (``device``: the card's time alone, ``chip_smoke.Context.device_ms``)."""
    times = {"old": [], "new": []}
    timer = ctx.device_ms if device else ctx.time_ms
    for which in ("old", "new", "new", "old"):
        versions.use(which)
        times[which].append(timer(fn, reps=reps))
    versions.use("new")
    return dict(old_ms=times["old"], new_ms=times["new"],
                speedup=sum(times["old"]) / sum(times["new"]))


def clocks_during(fn, seconds: float = 1.0) -> dict:
    """Median SM clock (MHz) and power draw (W) that ``nvidia-smi`` samples
    every 50 ms while ``fn`` runs back to back for about ``seconds``."""
    import torch

    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "50"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate()
    rows = [[float(x) for x in line.split(",")] for line in out.splitlines() if line.strip()]
    rows = rows[2:] or rows  # the first samples may predate the load
    return dict(sm_clock_mhz=statistics.median(r[0] for r in rows),
                power_w=statistics.median(r[1] for r in rows), samples=len(rows))


def flash_turns(ctx, versions, result, case, q32, k32, v32, dtype, kw) -> None:
    """One flash case in one type: both versions against the plain version,
    then timed in turns; the row goes to ``result``."""
    import chip_smoke as cs
    import torch
    from repro_torch.kernels import flash_attention as fa

    q, k, v = (t.to(dtype) for t in (q32, k32, v32))
    row = {}
    for which in ("old", "new"):
        versions.use(which)
        got = fa.flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        row[f"{which}_err_over_limit"] = cs.flash_excess(got, q, k, v, **kw)[1]
    versions.use("new")
    call = lambda: fa.flash_attention_cuda(q, k, v, **kw)  # noqa: E731
    row.update(turns(ctx, versions, call, 20, device=True), new_under_load=clocks_during(call))
    name = f"flash_attention_{str(dtype).replace('torch.', '')}"
    result[name if case == "qwen2_0_5b_layer" else f"{name}_{case}"] = dict(case=case, **row)


def gemm_cases(ctx):
    """chip_smoke.py's block_spmm and fused timing cases (fp32)."""
    import chip_smoke as cs
    import torch
    from repro_torch.core.distributed import FusedSpgemmExecutable, WorkerMesh, shard_stores
    from repro_torch.core.schedule import make_spgemm_plan
    from repro_torch.core.spgemm import spgemm_symbolic
    from repro_torch.kernels import ops

    sizes = cs.FULL
    bs = sizes["mul_bs"]
    coords = cs.band_coords(-(-sizes["time_n"] // bs), (sizes["mul_hw"] + bs - 1) // bs)
    gen = torch.Generator(device=ctx.dev).manual_seed(1)
    tasks = spgemm_symbolic(coords, coords)
    A = torch.randn((coords.shape[0], bs, bs), generator=gen, device=ctx.dev)
    bsp_args = (A, A, *ops.task_arrays(tasks.a_idx, tasks.b_idx, tasks.c_idx, tasks.num_out, ctx.dev),
                tasks.num_out)
    plan = make_spgemm_plan(coords, coords, sizes["fused_p"], bs)
    exe = FusedSpgemmExecutable(plan, WorkerMesh(plan.nparts, ctx.dev))
    fused_args = exe.kernel_args(*shard_stores(plan, A, A))
    return bsp_args, fused_args, int(tasks.num_tasks)


def small_gemm_cases(ctx) -> dict:
    """``block_spmm``'s small-block cases: the band at bs 64 and the grouped GEMM."""
    import chip_smoke as cs
    import numpy as np
    import torch
    from repro_torch.core.spgemm import spgemm_symbolic
    from repro_torch.kernels import ops

    gen = torch.Generator(device=ctx.dev).manual_seed(2)
    coords = cs.band_coords(-(-cs.FULL["time_n"] // 64), (cs.FULL["mul_hw"] + 63) // 64)
    t = spgemm_symbolic(coords, coords)
    X = torch.randn((coords.shape[0], 64, 64), generator=gen, device=ctx.dev)
    band = (X, X, *ops.task_arrays(t.a_idx, t.b_idx, t.c_idx, t.num_out, ctx.dev), t.num_out)
    sizes = np.bincount(np.random.default_rng(0).integers(0, 128, 65536), minlength=128)
    a, b, c, _, _ = ops.grouped_gemm_tasks(sizes, 8)
    nt = int(c.max()) + 1
    A = torch.randn((len(a), 8, 4096), generator=gen, device=ctx.dev)
    W = torch.randn((128, 4096, 1536), generator=gen, device=ctx.dev)
    grouped = (A, W, *ops.task_arrays(np.arange(len(a)), b, c, nt, ctx.dev), nt)
    return {"band_bs64_f32": (band, int(t.num_tasks)), "grouped_bm8_f32": (grouped, len(a))}


def shape_of(case, bsp_args, small):
    """(bm, bk, bn) of a GEMM case's operand blocks."""
    A, B = small[case][0][:2] if case in small else bsp_args[:2]
    return A.shape[1], A.shape[2], B.shape[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--old", type=Path, required=True, help="directory of the older csrc sources")
    p.add_argument("--out", type=Path, default=None, help="also write the JSON result here")
    p.add_argument("--only", choices=("gemm", "flash"), default=None, help="run one half")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_compare: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.kernels import block_spmm as bsp
    from repro_torch.kernels import fused_leaf as fl

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    ctx = cs.Context(torch, rehearse=False)
    names = {"gemm": NAMES[:2], "flash": NAMES[2:]}.get(args.only, NAMES)
    versions = Versions(build_old(args.old, names))
    result = dict(card=card, old_sources=str(args.old))

    gemms = []
    if args.only != "flash":
        bsp_args, fused_args, T = gemm_cases(ctx)
        small = small_gemm_cases(ctx)
        gemms = [("block_spmm", lambda: bsp.block_spmm_cuda(*bsp_args), "band_bs128_f32", T),
                 ("fused_block_spmm", lambda: fl.fused_block_spmm_cuda(*fused_args), "band_p8_bs128_f32", T)]
        gemms += [(f"block_spmm_{case}", lambda a=a: bsp.block_spmm_cuda(*a), case, n)
                  for case, (a, n) in small.items()]
    for name, fn, case, T in gemms:
        versions.use("old")
        old = fn()
        versions.use("new")
        new = fn()
        torch.cuda.synchronize()
        identical = bool(torch.equal(old, new))
        result[name] = dict(case=case, tasks=T, engine=bsp.tile_engine(*shape_of(case, bsp_args, small)),
                            bit_identical_to_old=identical,
                            max_abs_diff=float((old - new).abs().max()),
                            **turns(ctx, versions, fn, 3 if "grouped" in case else 10),
                            new_under_load=clocks_during(fn))
        del old, new
    gemms = small = None

    both = (torch.float32, torch.bfloat16)
    flash_cases = (("qwen2_0_5b_layer", both), ("d128_hk1", both), ("d256_hk1", both),
                   ("kimi_k2_rank", (torch.bfloat16,)))
    for case, dtypes in flash_cases if args.only != "gemm" else ():
        B, H, HK, Sq, Sk, D, causal, window = cs.FLASH_FULL[case]
        gen = torch.Generator(device=ctx.dev).manual_seed(13)
        q32, k32, v32 = (torch.randn(sh, generator=gen, device=ctx.dev)
                         for sh in ((B, H, Sq, D), (B, HK, Sk, D), (B, HK, Sk, D)))
        kw = dict(causal=causal, window=window)
        for dtype in dtypes:
            flash_turns(ctx, versions, result, case, q32, k32, v32, dtype, kw)

    line = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    ok = all(r["bit_identical_to_old"] for r in result.values() if isinstance(r, dict) and "tasks" in r)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
