"""Benchmark trajectory store + regression gate.

The port's card benchmarks (``benchmarks/torch_*.py``) write
``BENCH_*_torch.json`` files at the repo root.  This module defines the
one-schema-for-all-benches trajectory store (``BENCH_HISTORY_torch.jsonl``,
kept apart from the JAX package's ``BENCH_HISTORY.jsonl``) and the CI gate
over it, the JAX package's ``repro.obs.regress`` with the port's metric
names added:

* Every history entry is one JSON line with the stable envelope
  :data:`ENTRY_KEYS`: ``ts`` (epoch seconds), ``commit`` (short git hash or
  "unknown"), ``bench`` ("trace" / "balance" / "kernel" / "purify" / ...),
  ``config`` ("smoke" / "full" / structure name), ``metrics`` (flat
  str->float dict) and free-form ``meta``.  ``benchmarks/history.py``
  extracts entries from the written BENCH files and appends them
  (``benchmarks/torch_history.py`` for the port's).
* :func:`check_history` groups entries by ``(bench, config, metric)``,
  takes the **median of all prior entries** in each group as the baseline
  (robust to one noisy CI run) and fails the latest entry when it is worse
  than baseline beyond the metric's tolerance.  Metric direction and
  tolerances live in :data:`TOLERANCES`; unknown metrics get
  :data:`DEFAULT_SPEC` (lower-is-better, 100% relative slack — wall-clock
  noise on shared CI runners is real).  Single-entry groups pass: the first
  recorded run *is* the baseline.
* CLI: ``python -m repro_torch.obs.regress --check`` exits nonzero on any
  regression; ``--list`` prints the trajectory table.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

__all__ = [
    "ENTRY_KEYS",
    "HISTORY_FILENAME",
    "MetricSpec",
    "TOLERANCES",
    "DEFAULT_SPEC",
    "load_history",
    "append_history",
    "check_history",
    "trajectory_table",
    "main",
]

#: the stable envelope of one history entry, in order
ENTRY_KEYS = ("ts", "commit", "bench", "config", "metrics", "meta")

HISTORY_FILENAME = "BENCH_HISTORY_torch.jsonl"


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """Tolerance of one metric: ``direction`` is "lower" or "higher"
    (which way is better); the latest value regresses when it is worse than
    baseline by more than ``abs_tol + rel_tol * |baseline|``."""

    direction: str = "lower"
    rel_tol: float = 1.0
    abs_tol: float = 0.0


DEFAULT_SPEC = MetricSpec()

#: per-bench metric tolerances.  Wall-clock metrics get loose relative
#: slack (CI runners are noisy); structural metrics (bit identity, overhead
#: cap, error bounds) are tight — those are the ones a code change moves.
TOLERANCES: dict[str, dict[str, MetricSpec]] = {
    "trace": {
        # the bench's own gate is 2%; the history gate allows the same
        # absolute drift from the recorded baseline
        "overhead_pct": MetricSpec("lower", rel_tol=0.0, abs_tol=2.0),
        "overhead_sync_pct": MetricSpec("lower", rel_tol=1.0, abs_tol=10.0),
        "bit_identical": MetricSpec("higher", rel_tol=0.0, abs_tol=0.0),
        "min_untraced_s": MetricSpec("lower", rel_tol=1.0),
        "min_traced_s": MetricSpec("lower", rel_tol=1.0),
    },
    "balance": {
        "peak_imbalance_reduction": MetricSpec("higher", rel_tol=0.5),
        "bit_identical": MetricSpec("higher", rel_tol=0.0, abs_tol=0.0),
        "imbalance_tail": MetricSpec("lower", rel_tol=0.5),
        "wall_s_per_iter": MetricSpec("lower", rel_tol=1.0),
    },
    "kernel": {
        "fused_speedup": MetricSpec("higher", rel_tol=0.5),
        "bit_identical": MetricSpec("higher", rel_tol=0.0, abs_tol=0.0),
        "bf16_fro_err": MetricSpec("lower", rel_tol=0.5),
        "within_bounds": MetricSpec("higher", rel_tol=0.0, abs_tol=0.0),
        # the port's 64 x 64 and 128 x 128 tile engines agree bit for bit
        "engines_bit_identical": MetricSpec("higher", rel_tol=0.0, abs_tol=0.0),
    },
    "locality": {
        # locality fractions are structural (placement + plan), not
        # wall-clock: regressions here mean a planning/placement change
        # started moving bytes it didn't need to
        "locality_flops_static": MetricSpec("higher", rel_tol=0.25),
        "locality_flops_rebalanced": MetricSpec("higher", rel_tol=0.25),
        "locality_bytes_rebalanced": MetricSpec("higher", rel_tol=0.25),
        # rebalanced must beat static on the skewed layout (the bench
        # asserts > 1.0; history-gate drift beyond 25% is a regression)
        "rebalanced_locality_gain": MetricSpec("higher", rel_tol=0.25),
        "wire_mb_rebalanced": MetricSpec("lower", rel_tol=0.5),
        # what-if critical-path ratio (rebalanced cut / executed plan):
        # lower is better, and it is a pure re-plan property
        "critical_path_ratio": MetricSpec("lower", rel_tol=0.25),
    },
    # -- the port's own benches (benchmarks/torch_*.py) -----------------------
    "purify": {
        "resident_speedup": MetricSpec("higher", rel_tol=0.5),
        "bytes_reduction": MetricSpec("higher", rel_tol=0.25),
        "wall_s_per_iter_resident": MetricSpec("lower", rel_tol=1.0),
        "wall_s_per_iter_baseline": MetricSpec("lower", rel_tol=1.0),
        # plan reuse is structural: a drop means plans stopped being shared
        "plan_hit_rate": MetricSpec("higher", rel_tol=0.1),
        "delta_all_hit_iterations": MetricSpec("higher", rel_tol=0.25),
    },
    "inverse": {
        # an SCF replay must hit every plan: any miss is a regression
        "replay_misses": MetricSpec("lower", rel_tol=0.0, abs_tol=0.0),
        "warm_speedup": MetricSpec("higher", rel_tol=0.5),
        "wall_s_per_iter_replay": MetricSpec("lower", rel_tol=1.0),
        "z_max_abs_diff": MetricSpec("lower", rel_tol=1.0, abs_tol=1e-6),
    },
    "spamm": {
        "bound_ok": MetricSpec("higher", rel_tol=0.0, abs_tol=0.0),
        # the bench asserts true error <= bound + 1e-2
        "max_err_excess": MetricSpec("lower", rel_tol=0.0, abs_tol=1e-2),
        # node pairs the hierarchical descent visits per leaf task at the
        # largest tau: a pure symbolic property
        "hier_visit_ratio": MetricSpec("lower", rel_tol=0.25),
    },
}


def _spec_for(bench: str, metric: str) -> MetricSpec:
    return TOLERANCES.get(bench, {}).get(metric, DEFAULT_SPEC)


def load_history(path: str) -> list[dict]:
    """Parse the JSONL history; missing file is an empty history."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as fh:
        for i, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            entry = json.loads(line)
            missing = set(ENTRY_KEYS) - entry.keys()
            if missing:
                raise ValueError(
                    f"{path}:{i + 1}: entry missing keys {sorted(missing)}")
            out.append(entry)
    return out


def append_history(path: str, entry: dict) -> dict:
    """Validate the envelope and append one JSONL line."""
    missing = set(ENTRY_KEYS) - entry.keys()
    if missing:
        raise ValueError(f"history entry missing keys {sorted(missing)}")
    for k, v in entry["metrics"].items():
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            raise ValueError(f"metric {k!r} must be numeric, got {v!r}")
    with open(path, "a") as fh:
        fh.write(json.dumps(entry, sort_keys=True) + "\n")
    return entry


def _median(values: list[float]) -> float:
    s = sorted(values)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def check_history(entries: list[dict],
                  tolerances: dict | None = None) -> list[dict]:
    """Regressions of each group's latest entry vs the median of its prior
    entries.  Returns one violation dict per regressing metric."""
    groups: dict[tuple, list[tuple[int, dict]]] = {}
    for i, e in enumerate(entries):
        groups.setdefault((e["bench"], e["config"]), []).append((i, e))

    violations = []
    for (bench, config), members in sorted(groups.items()):
        if len(members) < 2:
            continue  # first recorded run is the baseline
        *prior, (_, latest) = members
        for metric, value in sorted(latest["metrics"].items()):
            history = [e["metrics"][metric] for _, e in prior
                       if metric in e["metrics"]]
            if not history:
                continue
            spec = (tolerances or {}).get(bench, {}).get(metric) \
                if tolerances else None
            spec = spec or _spec_for(bench, metric)
            baseline = _median(history)
            slack = spec.abs_tol + spec.rel_tol * abs(baseline)
            if spec.direction == "lower":
                bad = value > baseline + slack
            else:
                bad = value < baseline - slack
            if bad:
                violations.append(dict(
                    bench=bench, config=config, metric=metric,
                    value=float(value), baseline=float(baseline),
                    slack=float(slack), direction=spec.direction,
                    samples=len(history), commit=latest.get("commit"),
                ))
    return violations


def trajectory_table(entries: list[dict]) -> str:
    """Human-readable trajectory: one line per entry."""
    lines = [f"{'bench':10s} {'config':16s} {'commit':10s} metrics"]
    for e in entries:
        metrics = "  ".join(f"{k}={v:.4g}"
                            for k, v in sorted(e["metrics"].items()))
        lines.append(f"{e['bench']:10s} {e['config']:16s} "
                     f"{str(e['commit']):10s} {metrics}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.regress",
        description="benchmark history regression gate")
    ap.add_argument("--history", default=HISTORY_FILENAME,
                    help=f"history file (default ./{HISTORY_FILENAME})")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero on tolerance-violating regressions")
    ap.add_argument("--list", action="store_true",
                    help="print the trajectory table")
    args = ap.parse_args(argv)

    entries = load_history(args.history)
    if args.list or not args.check:
        print(trajectory_table(entries) if entries
              else f"{args.history}: no entries")
    if not args.check:
        return 0
    violations = check_history(entries)
    if violations:
        print(f"regress: {len(violations)} regression(s) vs baseline "
              f"in {args.history}:")
        for v in violations:
            arrow = ">" if v["direction"] == "lower" else "<"
            print(f"  {v['bench']}/{v['config']} {v['metric']}: "
                  f"{v['value']:.4g} {arrow} baseline {v['baseline']:.4g} "
                  f"± {v['slack']:.4g} ({v['samples']} prior sample(s), "
                  f"commit {v['commit']})")
        return 1
    n = len(entries)
    print(f"regress: clean ({n} entr{'y' if n == 1 else 'ies'} "
          f"in {args.history})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
