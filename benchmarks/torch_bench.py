"""Shared command line and metadata of the port's benchmark mirrors.

Every ``benchmarks/torch_*.py`` mirror of a JAX-package benchmark takes
``--device {cuda,cpu}`` (default ``cuda``, which raises without a card, as
the port's entry points do), the reference's ``--smoke`` and full sizes, and
``--card`` (N = 8192, bs 128, 8 workers: the size ``chip_smoke.py``'s
resident pipeline runs).  Each writes ``BENCH_<name>_torch.json`` at the
repo root with the reference file's keys plus ``meta.card`` (the
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` line, or
``"cpu"``) and ``meta.commit``.  This module imports only ``repro_torch``,
numpy and torch, like the mirrors.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.append(ROOT)  # chip_smoke.py's problem generators

#: the card size of the family benchmarks: N, bs, workers
CARD_N, CARD_BS, CARD_P = 8192, 128, 8


def parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the port runs (default: the card; raises without one)")
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--smoke", action="store_true", help="the reference's smoke size")
    size.add_argument("--card", action="store_true",
                      help=f"N = {CARD_N}, bs {CARD_BS}, {CARD_P} workers")
    ap.add_argument("--out", default=None, help="where to write the JSON (default: repo root)")
    return ap


def size_name(args) -> str:
    """``"smoke"``, ``"full"`` or ``"card"``: the size a run was made at."""
    return "card" if args.card else ("smoke" if args.smoke else "full")


def device(name: str):
    """The torch device for ``--device``, raising when the card is not there."""
    from repro_torch.core.matrix import resolve_device

    return resolve_device(name)


def card_line(dev) -> str:
    """nvidia-smi's name and power limit of the card, or ``"cpu"``."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def git_commit() -> str:
    """``BENCH_COMMIT`` when set (a checkout copied without ``.git``), else the
    short hash of HEAD (``-dirty`` with uncommitted changes), else "unknown"."""
    if os.environ.get("BENCH_COMMIT"):
        return os.environ["BENCH_COMMIT"]
    try:
        head = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=ROOT,
                              capture_output=True, text=True, timeout=10)
        if head.returncode != 0:
            return "unknown"
        dirty = subprocess.run(["git", "status", "--porcelain", "--untracked-files=no"],
                               cwd=ROOT, capture_output=True, text=True, timeout=10)
        return head.stdout.strip() + ("-dirty" if dirty.stdout.strip() else "")
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def sync(dev) -> None:
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def bit_identical(a, b) -> bool:
    """Two BSMatrix results with the same structure and the same bits."""
    import numpy as np
    import torch

    return bool(np.array_equal(a.coords, b.coords) and torch.equal(a.data, b.data))


def write(payload: dict, name: str, out: str | None = None) -> str:
    """Write ``payload`` to ``out`` or ``BENCH_<name>_torch.json`` at the repo root."""
    path = out or os.path.join(ROOT, f"BENCH_{name}_torch.json")
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")
    print(f"\nwrote {os.path.abspath(path)}")
    return path
