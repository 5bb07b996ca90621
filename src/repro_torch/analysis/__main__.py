"""``python -m repro_torch.analysis`` — verify benchmark-structure plans, lint
the port's runtime tree, and (optionally) prove the verifier detects via the
seeded mutation suite.

Host-only numpy: it runs where no JAX is installed (the card's machine).
The plans equal the JAX package's array for array, so the ``ok`` / ``FAIL``
/ ``MISS`` lines equal those of ``python -m repro.analysis`` line for line.
Exit status is nonzero on any violation, unwaived lint finding, or missed
mutation, so CI can gate on it directly.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from ..core.schedule import make_spgemm_plan
from . import lint as lint_mod
from .mutate import CORRUPTIONS, NotApplicable
from .verify import verify_spgemm_plan, verify_task_mask

# the benchmark structure families (benchmarks/spamm_sequences.py), scaled
# down: plan building and verification are pure host work, no devices needed
N, BS = 512, 16


def _coords(mask: np.ndarray) -> np.ndarray:
    from ..core.quadtree import morton_encode

    i, j = np.nonzero(mask)
    order = np.argsort(morton_encode(i, j), kind="stable")
    return np.stack([i[order], j[order]], axis=1).astype(np.int64)


def _structures() -> dict[str, np.ndarray]:
    nb = N // BS
    ii, jj = np.meshgrid(np.arange(nb), np.arange(nb), indexing="ij")
    rng = np.random.default_rng(0)
    return {
        "banded": np.abs(ii - jj) <= 2,
        "exp_decay": rng.random((nb, nb)) < np.exp(-0.45 * np.abs(ii - jj)),
        "random_offdiag": (ii == jj) | (rng.random((nb, nb)) < 0.08),
    }


def run_verify() -> int:
    failures = 0
    for sname, mask in _structures().items():
        coords = _coords(mask)
        for nparts in (1, 3, 4, 8):
            for exchange in ("p2p", "allgather"):
                plan = make_spgemm_plan(coords, coords, nparts, BS,
                                        exchange=exchange)
                report = verify_spgemm_plan(plan)
                if exchange == "p2p":
                    rng = np.random.default_rng(nparts)
                    mask_on = rng.random(plan.tasks.num_tasks) < 0.5
                    report += verify_task_mask(plan, mask_on)
                    report += verify_task_mask(
                        plan, np.zeros(plan.tasks.num_tasks, bool))
                tag = f"{sname}/P={nparts}/{exchange}"
                if report:
                    failures += len(report)
                    print(f"FAIL {tag}: {len(report)} violation(s)")
                    for v in report[:8]:
                        print(f"  {v}")
                else:
                    print(f"ok   {tag}: {plan.tasks.num_tasks} tasks, "
                          f"{len(plan.a_offsets) + len(plan.b_offsets)} rounds")
    return failures


def run_selftest() -> int:
    coords = _coords(_structures()["random_offdiag"])
    plan = make_spgemm_plan(coords, coords, 4, BS)
    missed = 0
    for name, (fn, expected) in CORRUPTIONS.items():
        try:
            bad, kwargs = fn(plan)
        except NotApplicable as exc:
            print(f"MISS {name}: not applicable ({exc})")
            missed += 1
            continue
        checks = {v.check for v in verify_spgemm_plan(bad, **kwargs)}
        if expected in checks:
            print(f"ok   {name}: caught as {expected!r}")
        else:
            print(f"MISS {name}: wanted {expected!r}, got {sorted(checks)}")
            missed += 1
    return missed


def run_lint(roots, fix: bool = False) -> int:
    if fix:
        for relpath, n in lint_mod.fix_paths(roots):
            print(f"FIX  {relpath}: {n} edit(s)")
    findings, waived = lint_mod.lint_paths(roots)
    for f in findings:
        print(f"LINT {f}")
    print(f"lint: {len(findings)} finding(s), {len(waived)} waived")
    return len(findings)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--verify-only", action="store_true")
    ap.add_argument("--lint-only", action="store_true")
    ap.add_argument("--selftest", action="store_true",
                    help="also run the seeded mutation suite")
    ap.add_argument("--fix", action="store_true",
                    help="rewrite fixable perf-counter findings in place "
                         "(Stopwatch/wall_clock), then lint the result")
    ap.add_argument("paths", nargs="*", type=Path,
                    help="lint roots (default: src/repro_torch)")
    args = ap.parse_args(argv)
    problems = 0
    if not args.lint_only:
        problems += run_verify()
    if not args.verify_only:
        problems += run_lint(args.paths or None, fix=args.fix)
    if args.selftest and not args.lint_only and not args.verify_only:
        problems += run_selftest()
    print("analysis:", "clean" if not problems else f"{problems} problem(s)")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
