#!/usr/bin/env python3
"""Count the register-bank pressure of the FFMAs in a compiled kernel library.

    python3 benchmarks/sass_ffma_banks.py [--lib PATH] [--match TEXT] [--out FILE]

Builds ``csrc/flash_attention.cu`` as the port does (or takes ``--lib``),
disassembles it with ``cuobjdump -sass`` and, for every kernel whose name
holds ``--match`` (default: the fp32 flash kernel), counts its instructions,
FFMAs, shared loads and stores, and the FFMAs that read two source
registers of one parity (register index mod 2, the two banks of a Hopper
SM's register file) where neither carries a ``.reuse`` flag: those reads
collide in one bank.  Prints one JSON object.  Needs the CUDA toolkit, so it
runs on the machine with the card.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

_REG = re.compile(r"(-?|\|)R(\d+)(\.reuse)?")


def _short_name(mangled: str) -> str:
    """``kernel<N>`` for a mangled template kernel ``...<len><kernel>ILi<N>E...``."""
    m = re.search(r"ILi(\d+)E", mangled)
    if not m:
        return mangled
    prefix = mangled[:m.start()]
    for n in range(1, len(prefix)):  # the identifier is preceded by its length
        if prefix[:-n].endswith(str(n)):
            return f"{prefix[-n:]}<{m.group(1)}>"
    return mangled


def ffma_bank_counts(sass: str, match: str) -> dict:
    """Per kernel (``kernel<DMAX>``): instruction counts and same-bank FFMA reads."""
    out = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.split("\n", 1)[0].strip()
        if match not in name:
            continue
        key = _short_name(name)
        ops = []
        for line in func.splitlines():
            if re.search(r"/\*[0-9a-f]{4,}\*/", line):
                op = re.sub(r"\s+", " ", re.sub(r"/\*.*?\*/", "", line)).strip()
                if op:
                    ops.append(op)
        names = Counter(o.split(" ")[1] if o.startswith("@") else o.split(" ")[0] for o in ops)
        same_bank = 0
        for op in ops:
            m = re.search(r"\bFFMA\b\s+\S+,\s*(.*?);", op)
            if not m:
                continue
            srcs = [(int(r.group(2)), bool(r.group(3))) for r in _REG.finditer(m.group(1))]
            parities = [reg % 2 for reg, reuse in srcs if not reuse]
            if len(parities) >= 2 and max(parities.count(0), parities.count(1)) >= 2:
                same_bank += 1
        out[key] = dict(instructions=len(ops), ffma=names["FFMA"],
                        lds=sum(v for k, v in names.items() if k.startswith("LDS")),
                        sts=sum(v for k, v in names.items() if k.startswith("STS")),
                        ffma_same_bank_reads=same_bank)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--lib", type=Path, default=None, help="a built library (default: build flash_attention)")
    p.add_argument("--match", default="flash_attention_f32_kernel", help="kernels whose name holds this")
    p.add_argument("--out", type=Path, default=None, help="also write the JSON result here")
    args = p.parse_args(argv)

    from repro_torch.kernels import build

    lib = args.lib or build.build_library("flash_attention")
    cuobjdump = shutil.which("cuobjdump") or str(Path(build.nvcc_path()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    result = dict(library=str(lib), kernels=ffma_bank_counts(sass, args.match))
    line = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
