"""Append the port's benchmark results to its commit-stamped trajectory store.

The port's mirror of ``benchmarks/history.py``: extracts one-schema history
entries (see :mod:`repro_torch.obs.regress`) from the ``BENCH_*_torch.json``
files the ``benchmarks/torch_*.py`` mirrors write and appends them to
``BENCH_HISTORY_torch.jsonl``::

    python benchmarks/torch_history.py BENCH_*_torch.json
    PYTHONPATH=src python -m repro_torch.obs.regress --check --history BENCH_HISTORY_torch.jsonl

Each BENCH file maps to its bench kind by content, as in the reference:
trace (overhead gate), balance (one entry per structure), locality (one
entry per structure), kernel (fused leaf engine; the port's file adds the
tile engines' bit identity), and the port's own purify (resident vs
re-shard), inverse (zero-miss replay) and spamm (one entry per structure).
The reference's files give the reference's entries.  Boolean gates (bit
identity, precision bounds) become 0/1 metrics so the regression gate
treats a flipped gate as an exact-tolerance failure.  Entries carry the
file's ``meta.card`` (the card's name and power limit) when it has one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_bench import git_commit  # noqa: E402
from repro_torch.obs.regress import HISTORY_FILENAME, append_history  # noqa: E402

__all__ = ["git_commit", "make_entry", "entries_from_bench_json", "main"]


def make_entry(bench: str, metrics: dict, *, config: str = "default",
               meta: dict | None = None, ts: float | None = None,
               commit: str | None = None) -> dict:
    return dict(
        ts=float(ts if ts is not None else time.time()),
        commit=commit if commit is not None else git_commit(),
        bench=str(bench),
        config=str(config),
        metrics={k: float(v) for k, v in metrics.items()},
        meta=dict(meta or {}),
    )


def _config(meta: dict, base: str = "") -> str:
    # the port's mirrors name their size ("smoke" / "full" / "card")
    mode = meta.get("size") or ("smoke" if meta.get("smoke") else "full")
    return f"{base}-{mode}" if base else mode


def entries_from_bench_json(path: str, *, ts: float | None = None,
                            commit: str | None = None) -> list[dict]:
    """History entries for one written BENCH file (kind sniffed by schema)."""
    with open(path) as fh:
        data = json.load(fh)
    meta = data.get("meta", {})
    kw = dict(ts=ts, commit=commit)
    card = {"card": meta["card"]} if "card" in meta else {}

    if "overhead" in data:  # BENCH_trace.json
        ov = data["overhead"]
        metrics = dict(
            overhead_pct=ov["overhead_pct"],
            overhead_sync_pct=ov["overhead_sync_pct"],
            min_untraced_s=ov["min_untraced_s"],
            min_traced_s=ov["min_traced_s"],
            bit_identical=1.0 if ov["bit_identical"] else 0.0,
        )
        entry_meta = dict(n=meta.get("n"), workers=meta.get("workers"),
                          source=os.path.basename(path), **card)
        if "observatory" in meta:
            entry_meta["observatory"] = bool(meta["observatory"])
        return [make_entry("trace", metrics, config=_config(meta),
                           meta=entry_meta, **kw)]

    if "structures" in data:  # BENCH_balance.json
        entries = []
        for name, row in sorted(data["structures"].items()):
            reb = row["rebalanced"]
            metrics = dict(
                peak_imbalance_reduction=row["peak_imbalance_reduction"],
                bit_identical=1.0 if reb["bit_identical_to_static"] else 0.0,
                imbalance_tail=reb["imbalance_tail"],
                wall_s_per_iter=reb["wall_s_per_iter"],
            )
            entries.append(make_entry(
                "balance", metrics, config=_config(meta, name),
                meta=dict(n=meta.get("n"), workers=meta.get("workers"),
                          source=os.path.basename(path), **card), **kw))
        return entries

    if "locality" in data:  # BENCH_locality.json
        entries = []
        for name, row in sorted(data["locality"].items()):
            stat, reb = row["static"], row["rebalanced"]
            tg = row.get("taskgraph") or {}
            metrics = dict(
                locality_flops_static=stat["locality_flops"],
                locality_flops_rebalanced=reb["locality_flops"],
                locality_bytes_rebalanced=reb["locality_bytes"],
                rebalanced_locality_gain=(
                    reb["locality_flops"] / max(stat["locality_flops"], 1e-12)),
                wire_mb_rebalanced=reb["wire_recv_bytes"] / 1e6,
            )
            if tg.get("after"):
                metrics["critical_path_ratio"] = (
                    tg["after"]["critical_path"]
                    / max(tg["before"]["critical_path"], 1e-12))
            entries.append(make_entry(
                "locality", metrics, config=_config(meta, name),
                meta=dict(n=meta.get("n"), workers=meta.get("workers"),
                          source=os.path.basename(path), **card), **kw))
        return entries

    if "fused_vs_staged" in data:  # BENCH_kernel.json
        fvs = data["fused_vs_staged"]
        prec = data["precision"]
        metrics = dict(
            fused_speedup=fvs["speedup"],
            bit_identical=1.0 if fvs["bit_identical"] else 0.0,
            bf16_fro_err=prec["bf16"]["fro_err"],
            within_bounds=1.0 if prec["within_bounds"] else 0.0,
            autotune_roundtrip=1.0 if data["autotune"]["roundtrip_ok"] else 0.0,
        )
        if "engines_bit_identical" in data["autotune"]:  # the port's tile engines
            metrics["engines_bit_identical"] = (
                1.0 if data["autotune"]["engines_bit_identical"] else 0.0)
        return [make_entry("kernel", metrics, config=_config(meta),
                           meta=dict(backend=meta.get("backend"),
                                     bs=meta.get("bs"),
                                     source=os.path.basename(path), **card), **kw)]

    if "resident_speedup" in data:  # BENCH_purify_torch.json
        res, base = data["resident"], data["baseline"]
        delta = data["error_control"]["hier + delta-SpAMM"]
        metrics = dict(
            resident_speedup=data["resident_speedup"],
            bytes_reduction=data["bytes_reduction"],
            wall_s_per_iter_resident=res["wall_s_per_iter"],
            wall_s_per_iter_baseline=base["wall_s_per_iter"],
            plan_hit_rate=res["cache"]["hit_rate"],
            delta_all_hit_iterations=delta["all_hit_iterations"],
        )
        return [make_entry("purify", metrics, config=_config(meta),
                           meta=dict(n=meta.get("n"), workers=meta.get("workers"),
                                     source=os.path.basename(path), **card), **kw)]

    if "resident_replay" in data:  # BENCH_inverse_torch.json
        metrics = dict(
            replay_misses=data["replay_misses"],
            warm_speedup=data["warm_speedup"],
            wall_s_per_iter_replay=data["resident_replay"]["wall_s_per_iter"],
            z_max_abs_diff=data["z_max_abs_diff"],
        )
        return [make_entry("inverse", metrics, config=_config(meta),
                           meta=dict(n=meta.get("n"), workers=meta.get("workers"),
                                     source=os.path.basename(path), **card), **kw)]

    if "sequences" in data:  # BENCH_spamm_torch.json
        entries = []
        for name, row in sorted(data["sequences"].items()):
            taus = row["taus"]
            last = taus[-1]
            metrics = dict(
                bound_ok=1.0 if all(
                    t["true_err"] <= t["hierarchical"]["err_bound"] + 1e-2 for t in taus) else 0.0,
                max_err_excess=max(t["true_err"] - t["hierarchical"]["err_bound"] for t in taus),
                hier_visit_ratio=last["hierarchical"]["visited"] / max(last["leaf"]["visited"], 1),
            )
            entries.append(make_entry(
                "spamm", metrics, config=_config(meta, name),
                meta=dict(n=meta.get("n"), source=os.path.basename(path), **card), **kw))
        return entries

    raise ValueError(f"{path}: unrecognized BENCH schema "
                     f"(top-level keys {sorted(data)})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="append BENCH_*.json results to the benchmark history")
    ap.add_argument("bench_files", nargs="+", help="written BENCH_*.json files")
    ap.add_argument("--history", default=HISTORY_FILENAME)
    args = ap.parse_args(argv)

    commit = git_commit()
    ts = time.time()
    total = 0
    for path in args.bench_files:
        for entry in entries_from_bench_json(path, ts=ts, commit=commit):
            append_history(args.history, entry)
            total += 1
            print(f"history: + {entry['bench']}/{entry['config']} "
                  f"@ {entry['commit']} "
                  f"({len(entry['metrics'])} metrics) from {path}")
    print(f"history: {total} entr{'y' if total == 1 else 'ies'} "
          f"appended to {args.history}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
