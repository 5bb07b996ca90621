"""Data-locality trajectory on the paper's matrix sequences, on the port.

The port's mirror of ``benchmarks/locality.py``: distributed SP2 on the
three structure families on 8 resident workers, from the skewed initial
layout (every block on worker 0), with a
:class:`repro_torch.obs.locality.LocalityLedger` riding on the plan cache:

* ``static``      — the skewed layout is never revisited, so almost every
                    operand byte a task reads has to cross between workers;
* ``rebalanced``  — ``RebalancePolicy()`` migrates the iterate to the
                    measured cut, after which tasks mostly read bytes their
                    own worker holds.

Reported per (structure, mode): locality fraction (locally-owned flops and
bytes over totals), shipped vs wire bytes, the per-worker split, and the
most re-fetched blocks; per structure, the task-graph what-ifs of the skewed
first-iteration plan (critical path, slack, the projection onto the
measured rebalanced cut).  The rebalanced locality fraction must come out
strictly higher than the static one on every structure — the bench's own
gate.  Writes ``BENCH_locality_torch.json``.

Run:  python benchmarks/torch_locality.py [--device cpu] [--smoke | --card]
"""

from __future__ import annotations

import numpy as np

import torch_bench
import torch_dist_balance

from repro_torch.core.distributed import make_worker_mesh  # noqa: E402
from repro_torch.core.schedule import make_spgemm_plan  # noqa: E402
from repro_torch.dist import RebalancePolicy  # noqa: E402
from repro_torch.obs.locality import LocalityLedger  # noqa: E402
from repro_torch.obs.report import locality_table  # noqa: E402
from repro_torch.obs.taskgraph import whatif_rebalanced  # noqa: E402

P = torch_dist_balance.P


def sizes(args) -> tuple[int, int, int]:
    """``(n, bs, max_iter)``: the reference's smoke / full, or the card's."""
    if args.card:
        return torch_bench.CARD_N, torch_bench.CARD_BS, 25
    return (256, torch_dist_balance.BS, 12) if args.smoke else (512, torch_dist_balance.BS, 25)


def run_mode(f, nocc, lmin, lmax, mesh, policy, max_iter):
    """One ledgered SP2 run from the skewed layout: ``(d, ledger row, balance row)``."""
    ledger = LocalityLedger()
    d, brow, st, _ = torch_dist_balance.run_mode(f, nocc, lmin, lmax, mesh, policy, max_iter,
                                                 ledger=ledger)
    r = ledger.summary()
    r["iterations"] = st.iterations
    r["rebalances"] = st.rebalances
    r["wall_s_total"] = brow["wall_s_total"]
    # per-iteration locality trajectory from the driver rows the ledger fed
    r["locality_flops_per_iter"] = [
        float(pi["locality_flops"]) for pi in st.per_iter if "locality_flops" in pi]
    return d, r, brow


def taskgraph_row(f, bs: int) -> dict:
    """What-if analysis of the skewed first-iteration plan — pure host."""
    skew = np.zeros(f.nnzb, dtype=np.int32)
    plan = make_spgemm_plan(f.coords, f.coords, P, bs, a_owner=skew, b_owner=skew)
    w = whatif_rebalanced(plan, f.coords)
    return dict(before=w["before"].as_dict(), after=w["after"].as_dict(),
                predicted_gain=w["predicted_gain"])


def run(n: int, bs: int, max_iter: int, dev, *, exact_bounds: bool) -> dict:
    """Every family, static then rebalanced, ledgered; the payload's ``locality``."""
    mesh = make_worker_mesh(P, dev)
    results: dict = {}
    for name, f in torch_dist_balance.torch_spamm_sequences.sequences(n, bs, device=dev).items():
        nocc = int(0.3 * n)
        lmin, lmax = torch_dist_balance.spectral_bounds(f, mesh, exact=exact_bounds)
        print(f"\n== {name}: n={n} bs={bs} nnzb={f.nnzb} workers={P} "
              f"(skewed initial layout: all blocks on worker 0) ==")
        row: dict = {}
        d_ref = None
        for mode, policy in (("static", None), ("rebalanced", RebalancePolicy())):
            d, r, _ = run_mode(f, nocc, lmin, lmax, mesh, policy, max_iter)
            if d_ref is None:
                d_ref = d
            else:
                r["bit_identical_to_static"] = torch_dist_balance.bit_identical(d_ref, d)
                assert r["bit_identical_to_static"], "the ledger is an observer: math must not move"
            row[mode] = r
            print(f"  [{mode:10s}] iters={r['iterations']:3d}  "
                  f"locality {r['locality_flops'] * 100:5.1f}% flops / "
                  f"{r['locality_bytes'] * 100:5.1f}% bytes  "
                  f"shipped {r['shipped_bytes'] / 1e6:7.2f} MB  "
                  f"wire {r['wire_recv_bytes'] / 1e6:7.2f} MB")
        row["taskgraph"] = tg = taskgraph_row(f, bs)
        print(f"  what-if (skewed plan): critical path "
              f"{tg['before']['critical_path']:.1f} -> rebalanced cut "
              f"{tg['after']['critical_path']:.1f} "
              f"(predicted gain {tg['predicted_gain']:.2f}x)")
        gain = (row["rebalanced"]["locality_flops"]
                / max(row["static"]["locality_flops"], 1e-12))
        print(f"  rebalanced locality gain: {gain:.2f}x")
        assert row["rebalanced"]["locality_flops"] > row["static"]["locality_flops"], (
            f"{name}: rebalancing must raise the locality fraction on the skewed layout")
        results[name] = row
    return results


def main(argv=None) -> int:
    args = torch_bench.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = torch_bench.device(args.device)
    n, bs, max_iter = sizes(args)
    results = run(n, bs, max_iter, dev, exact_bounds=not args.card)
    payload = dict(meta=torch_dist_balance.meta(n, bs, max_iter, args, dev),
                   locality=results)
    torch_bench.write(payload, "locality", args.out)
    print(locality_table(payload))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
