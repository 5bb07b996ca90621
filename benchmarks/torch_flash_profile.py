#!/usr/bin/env python3
"""Where the bf16 flash kernel's kv loop spends its clocks, on one card.

    python3 benchmarks/torch_flash_profile.py [--case NAME ...] [--block N] [--out FILE]

Builds ``csrc/flash_attention.cu`` with ``-DFLASH_PROFILE=<block>`` into
``build/flash_profile/`` (a library of its own: the port's build is left as
it is), runs each case of ``chip_smoke.py``'s ``FLASH_FULL`` (default: the
four timed ones) in bf16, and reads the SM clock that the first warp of each
consumer warpgroup of block ``<block>`` (default 0: the last q tile of the
first head, the longest causal row range) records at eight points of each kv
iteration.  Printed per consumer: the median clocks of each phase over the
steady iterations (4 to 27) -- ``full_wait`` (the stage's full barrier),
``turn`` (the other consumer's ping-pong barrier), ``issue`` (S(j) and
P(j - 1) V issued), ``qk_wait`` (wgmma.wait_group 1), ``softmax``,
``pv_wait`` (wait_group 0), ``split`` (release, rescale, split of P),
``loop`` (to the next iteration) -- and their sum, beside the clocks the
iteration's products take on the tensor cores at the card's peak.  The last
line of standard output is one JSON object naming the card and its power
limit.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

PHASES = ("full_wait", "turn", "issue", "qk_wait", "softmax", "pv_wait", "split", "loop")
MARKS, ITERS, CONSUMERS = 8, 64, 2


def build_profiled(block: int) -> ctypes.CDLL:
    from repro_torch.kernels import build

    out = ROOT / "build" / "flash_profile" / f"flash_attention-profile{block}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f"-DFLASH_PROFILE={block}", "-o", str(out),
           str(build.CSRC_DIR / "flash_attention.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    return ctypes.CDLL(str(out))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--case", nargs="*", default=None, help="FLASH_FULL cases (default: the timed ones)")
    p.add_argument("--block", type=int, default=0, help="the block whose consumers record")
    p.add_argument("--out", type=Path, default=None, help="also write the JSON result here")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_flash_profile: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    card = subprocess.run(smi, capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    lib = build_profiled(args.block)
    build._libraries["flash_attention"] = lib  # the wrapper now launches the profiled build
    dev = torch.device("cuda")
    result = dict(card=card, block=args.block, unit="SM clocks per kv iteration (median)", cases={})
    for name in args.case or cs.FLASH_TIMED:
        B, H, HK, Sq, Sk, D, causal, window = cs.FLASH_FULL[name]
        g = torch.Generator(device=dev).manual_seed(13)
        q, k, v = (torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
                   for s in ((B, H, Sq, D), (B, HK, Sk, D), (B, HK, Sk, D)))
        for _ in range(3):
            fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (CONSUMERS * ITERS * MARKS))()
        rc = lib.flash_attention_profile_read(buf)
        if rc != 0:
            raise RuntimeError(f"reading the profile failed ({rc})")
        marks = [[list(buf[(c * ITERS + j) * MARKS:(c * ITERS + j + 1) * MARKS]) for j in range(ITERS)]
                 for c in range(CONSUMERS)]
        # the bf16 kernel's tile: 128 keys up to D 128, 64 at D 256; D padded to its bucket
        bkv = 128 if D <= 128 else 64
        dn = 64 if D <= 64 else 112 if D <= 112 else 128 if D <= 128 else 256
        flops = 2 * 64 * bkv * (16 * -(-D // 16)) + 2 * (2 * 64 * bkv * dn)  # one consumer's products
        tc_clocks = flops / (989e12 / 132 / 1.83e9)  # 989 TFLOP/s at 1.83 GHz over 132 SMs
        row = dict(D=D, products_clocks_at_peak=round(tc_clocks))
        for c in range(CONSUMERS):
            steady = [m for m in marks[c][4:28] if all(m)]
            nxt = [marks[c][j + 1][0] for j in range(4, 28) if all(marks[c][j]) and marks[c][j + 1][0]]
            phases = {}
            for i, ph in enumerate(PHASES[:-1]):
                phases[ph] = statistics.median(m[i + 1] - m[i] for m in steady)
            phases["loop"] = statistics.median(b - m[7] for m, b in zip(steady, nxt))
            phases["sum"] = sum(phases.values())
            row[f"consumer{c}"] = phases
        result["cases"][name] = row
        print(name, json.dumps(row), flush=True)
    line = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
