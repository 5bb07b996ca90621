"""Roofline table of the port's dry run: reads ``repro_torch.launch.dryrun`` JSONs.

The port's copy of ``benchmarks/roofline.py``.  Each record is one cell: its
compute and memory terms run whole on one NVIDIA H100 (:data:`HW`, the data
sheet's dense rates), and its collective term one device's on the record's
production mesh (``on_mesh``: the port's own collectives, counted on a fake
mesh, over NVLink 4 within an 8-card node and one 400 Gb/s InfiniBand link a
card between nodes; a prediction no one-card machine measures).  ``table``
gives one markdown row per cell, ``summary`` the counts, the cells furthest
from the roofline and, as the reference computes it, the cells whose
collective term is largest against their compute term, both terms from the
16 x 16 mesh's device.

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun_torch
      python benchmarks/torch_roofline.py [results/dryrun_torch]
"""

from __future__ import annotations

import glob
import json
import os
import sys

#: NVIDIA H100 SXM: bf16 dense tensor-core and fp32 FFMA FLOP/s, HBM3 bytes/s and bytes
HW = dict(peak_flops_bf16=989e12, peak_flops_fp32=67e12, hbm_bw=3.35e12, hbm_bytes=80e9)


def load(dirname: str = "results/dryrun_torch") -> list[dict]:
    recs = []
    for fn in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(fn) as f:
            recs.append(json.load(f))
    return recs


def table(recs: list[dict], mesh: str = "16x16") -> str:
    head = (
        "| arch | shape | compute s | memory s | collective s | bottleneck | "
        "MODEL/counted flops | roofline frac | peak GB | fits one card |\n"
        "|---|---|---|---|---|---|---|---|---|---|"
    )
    lines = [head]
    for r in recs:
        if r.get("mesh") != mesh:
            continue
        if r["status"] == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | skipped: {r['why']} "
                         "| — | — | — | — |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | ERROR | | | | | | | |")
            continue
        lines.append(
            "| {arch} | {shape} | {c:.3e} | {m:.3e} | {k:.3e} | {b} | {u:.2f} | {f:.3f} | {p:.2f} | "
            "{fit} |".format(arch=r["arch"], shape=r["shape"], c=r["compute_term_s"],
                             m=r["memory_term_s"], k=r["collective_term_s"], b=r["bottleneck"],
                             u=r["useful_flops_ratio"],
                             f=r["roofline_fraction"], p=r["peak_bytes_card"] / 1e9,
                             fit="yes" if r["fits_one_card"] else "no"))
    return "\n".join(lines)


def summary(recs: list[dict]) -> dict:
    ok = [r for r in recs if r["status"] == "ok"]
    single = [r for r in ok if r["mesh"] == "16x16"]
    worst = sorted(single, key=lambda r: r["roofline_fraction"])[:5]
    mem = sorted(single, key=lambda r: -r["memory_term_s"] / max(r["compute_term_s"], 1e-12))[:5]
    on16 = [(r, r["on_mesh"]["16x16"]) for r in ok if "16x16" in r.get("on_mesh", {})]
    on16 = list({(r["arch"], r["shape"]): (r, m) for r, m in on16}.values())  # one per cell
    coll = sorted(on16, key=lambda rm: -rm[1]["collective_term_s"]
                  / max(rm[1]["compute_term_s"], 1e-12))[:5]
    return {
        "cells_ok": len(ok),
        "cells_skipped": len([r for r in recs if r["status"] == "skipped"]),
        "cells_error": len([r for r in recs if r["status"] == "error"]),
        "fit_one_card": sorted((r["arch"], r["shape"]) for r in single if r["fits_one_card"]),
        "worst_fraction": [(r["arch"], r["shape"], r["roofline_fraction"]) for r in worst],
        "most_memory_bound": [(r["arch"], r["shape"],
                               r["memory_term_s"] / max(r["compute_term_s"], 1e-12)) for r in mem],
        "most_collective_bound": [(r["arch"], r["shape"], m["collective_term_s"]
                                   / max(m["compute_term_s"], 1e-12)) for r, m in coll],
    }


if __name__ == "__main__":
    recs = load(sys.argv[1] if len(sys.argv) > 1 else "results/dryrun_torch")
    print(table(recs))
    print(json.dumps(summary(recs), indent=1))
