"""Dynamic load balancing on the paper's matrix sequences, on the port.

The port's mirror of ``benchmarks/dist_balance.py``: distributed SP2
purification on the three structure families (banded, exp-decay,
random-offdiag; :mod:`torch_spamm_sequences`) on 8 resident workers, from a
deliberately skewed initial layout (every block on worker 0), comparing:

* ``static``      — the layout is never revisited (rebalance=None);
* ``rebalanced``  — ``RebalancePolicy()``: the measured per-worker cost model
                    re-lays the iterate out whenever the combined max/mean
                    imbalance crosses the threshold.

Reported per (structure, mode): measured imbalance trajectory (max / mean /
tail), wall seconds per iteration (the card synchronised at the edges),
bytes migrated by re-layouts, plan-cache misses, and the plan verifier's
seconds.  The rebalanced D must equal the static D bit for bit.  At the
reference's sizes the spectral interval comes from a dense host
``eigvalsh``; at ``--card`` (N = 8192, bs 128) from
``dist_lanczos_bounds`` on the resident F, with the same 0.05 margin.
Writes ``BENCH_balance_torch.json``.

Run:  python benchmarks/torch_dist_balance.py [--device cpu] [--smoke | --card]
"""

from __future__ import annotations

import time

import numpy as np

import torch_bench
import torch_spamm_sequences
from torch_bench import bit_identical

from repro_torch.core.distributed import make_worker_mesh  # noqa: E402
from repro_torch.dist import (  # noqa: E402
    PlanCache,
    RebalancePolicy,
    dist_lanczos_bounds,
    dist_sp2_purify,
    scatter,
)

P = 8
BS = torch_spamm_sequences.BS  # 16
IDEM_TOL, TRUNC_TAU, SPAMM_TAU = 1e-5, 1e-5, 1e-6
#: the reference's margin around the spectral interval
MARGIN = 0.05


def sizes(args) -> tuple[int, int, int]:
    """``(n, bs, max_iter)`` of a run: the reference's smoke / full, or the card's."""
    if args.card:
        return torch_bench.CARD_N, torch_bench.CARD_BS, 40
    return (256, BS, 25) if args.smoke else (512, BS, 40)


def spectral_bounds(f, mesh, *, exact: bool) -> tuple[float, float]:
    """``(lmin, lmax)`` with the reference's margin: dense host eigenvalues when
    ``exact``, else resident Lanczos on a Morton-scattered F (own plan cache)."""
    if exact:
        return torch_spamm_sequences.eig_bounds(f)
    lo, hi = dist_lanczos_bounds(scatter(f, mesh), PlanCache())
    return lo - MARGIN, hi + MARGIN


def run_mode(f, nocc, lmin, lmax, mesh, policy, max_iter, *, ledger=None):
    """One SP2 run from the all-on-worker-0 layout.  Returns ``(d, row, stats,
    cache)``: the gathered D, the reference's per-mode row (plus ``verify_s``
    and the card-synchronised wall time), ``dist_sp2_purify``'s stats and the cache
    (``ledger``, a LocalityLedger, is installed on it when given)."""
    skew = np.zeros(f.nnzb, dtype=np.int32)  # skewed initial layout
    df = scatter(f, mesh, owner=skew)
    cache = PlanCache()
    if ledger is not None:
        ledger.install(cache)
    torch_bench.sync(mesh.device)
    t0 = time.perf_counter()
    d, st = dist_sp2_purify(
        df, nocc, lmin, lmax, max_iter=max_iter, idem_tol=IDEM_TOL,
        trunc_tau=TRUNC_TAU, spamm_tau=SPAMM_TAU, cache=cache,
        rebalance=policy,
    )
    torch_bench.sync(mesh.device)
    total = time.perf_counter() - t0
    imbs = [pi["imbalance"] for pi in st.per_iter if pi["imbalance"] is not None]
    misses = [pi["cache_misses"] for pi in st.per_iter]
    row = dict(
        iterations=st.iterations,
        rebalances=st.rebalances,
        wall_s_total=total,
        wall_s_per_iter=total / max(st.iterations, 1),
        imbalance_max=float(max(imbs)) if imbs else None,
        imbalance_mean=float(np.mean(imbs)) if imbs else None,
        imbalance_tail=float(np.mean(imbs[-3:])) if imbs else None,
        imbalance_per_iter=[float(i) for i in imbs],
        migrated_bytes_total=int(sum(pi["migrated_bytes"] for pi in st.per_iter)),
        plan_misses_total=int(sum(misses)),
        plan_misses_tail=[int(m) for m in misses[-3:]],
        cache=dict(hits=st.cache["hits"], misses=st.cache["misses"]),
        calibration=st.calibration,
        verify_s=float(cache.verify_s),
        plan_build_s=float(cache.build_s),
    )
    return d, row, st, cache


def run(n: int, bs: int, max_iter: int, dev, *, exact_bounds: bool) -> dict:
    """Every family, static then rebalanced; returns the payload's ``structures``."""
    mesh = make_worker_mesh(P, dev)
    results: dict = {}
    for name, f in torch_spamm_sequences.sequences(n, bs, device=dev).items():
        nocc = int(0.3 * n)
        lmin, lmax = spectral_bounds(f, mesh, exact=exact_bounds)
        print(f"\n== {name}: n={n} bs={bs} nnzb={f.nnzb} workers={P} "
              f"(skewed initial layout: all blocks on worker 0) ==")
        row: dict = dict(bounds=[lmin, lmax])
        d_ref = None
        for mode, policy in (("static", None), ("rebalanced", RebalancePolicy())):
            d, r, _, _ = run_mode(f, nocc, lmin, lmax, mesh, policy, max_iter)
            if d_ref is None:
                d_ref = d
            else:
                r["bit_identical_to_static"] = bit_identical(d_ref, d)
                assert r["bit_identical_to_static"], "re-layouts changed the math"
            row[mode] = r
            print(f"  [{mode:10s}] iters={r['iterations']:3d}  "
                  f"wall/iter {r['wall_s_per_iter']*1e3:7.1f} ms  "
                  f"imb max {r['imbalance_max']:.2f} mean {r['imbalance_mean']:.3f} "
                  f"tail {r['imbalance_tail']:.3f}  "
                  f"migrated {r['migrated_bytes_total']/1e3:.1f} kB  "
                  f"misses {r['plan_misses_total']} (tail {r['plan_misses_tail']})")
        ratio = row["static"]["imbalance_max"] / row["rebalanced"]["imbalance_max"]
        row["peak_imbalance_reduction"] = float(ratio)
        print(f"  peak imbalance reduction: {ratio:.2f}x")
        cal = row["rebalanced"].get("calibration")
        if cal and cal.get("fitted"):
            print(f"  wall-clock calibration: task {cal['task_s']*1e6:.1f} us  "
                  f"recv {cal['recv_cost']:.3f} send {cal['send_cost']:.3f} "
                  f"block {cal['block_cost']:.3f} "
                  f"(rms resid {cal['rms_resid_s']*1e3:.2f} ms, "
                  f"{cal['samples']} samples)")
        results[name] = row
    return results


def meta(n, bs, max_iter, args, dev) -> dict:
    return dict(
        n=n, bs=bs, workers=P, smoke=args.smoke, size=torch_bench.size_name(args),
        max_iter=max_iter,
        idem_tol=IDEM_TOL, trunc_tau=TRUNC_TAU, spamm_tau=SPAMM_TAU,
        initial_layout="all blocks on worker 0",
        policy=dict(RebalancePolicy().__dict__),
        params=torch_spamm_sequences.family_params(bs),
        card=torch_bench.card_line(dev), commit=torch_bench.git_commit(),
    )


def main(argv=None) -> int:
    args = torch_bench.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = torch_bench.device(args.device)
    n, bs, max_iter = sizes(args)
    results = run(n, bs, max_iter, dev, exact_bounds=not args.card)
    payload = dict(meta=meta(n, bs, max_iter, args, dev), structures=results)
    torch_bench.write(payload, "balance", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
