"""Tracing overhead + utilization report for the full resident pipeline, on the port.

The port's mirror of ``benchmarks/trace_overhead.py``: runs
``dist_sqrt_inv_pipeline`` (S -> Z -> Z^T H Z -> SP2 -> Z D Z^T) on 8
resident workers from a deliberately skewed initial layout (so re-layout
migrations appear in the trace), three ways:

* warm-cache repeats with observability **off**;
* warm-cache repeats with the **full observatory on** (a fresh
  ``Tracer(sync=False)`` + in-memory ``EventLog`` + ``HealthPolicy`` +
  ``MemoryMeter`` + ``LocalityLedger`` per repeat on the same plan cache) —
  the overhead gate: the arms run back-to-back within each round and the
  **median of the per-round paired process-CPU overheads** must stay under
  ``OVERHEAD_CAP_PCT``, with D **bit-identical** either way.  Rounds keep
  being added (up to 4x the base count) while the distribution-free 95%
  confidence interval of that median (sign-test order statistics)
  straddles the cap.  The unpaired best-of-arm floors (CPU and wall) are
  reported beside it, unguarded.  ``Tracer(sync=True)`` additionally waits
  for the card inside dispatch spans; its cost is reported as
  ``overhead_sync_pct``, not gated;
* one **cold** traced run (``sync=True``) on a fresh cache, whose Chrome
  trace (``trace_pipeline_torch.json``) carries the plan-build spans and
  feeds the per-worker utilization + peak-memory report.

On the card, process CPU time includes the host's wait for the device
(PyTorch synchronises by spinning), in both arms alike.  The gate runs last,
so a failing run still leaves ``BENCH_trace_torch.json`` and the trace on
disk; outside ``--smoke`` a miss of the cap fails the script, as the
reference's does.

Run:  python benchmarks/torch_trace_overhead.py [--device cpu] [--smoke | --card]
"""

from __future__ import annotations

import gc
import math
import os
import statistics
import time

import numpy as np

import torch_bench

from repro_torch.core import BSMatrix  # noqa: E402
from repro_torch.core.distributed import make_worker_mesh  # noqa: E402
from repro_torch.dist import (  # noqa: E402
    PlanCache,
    RebalancePolicy,
    dist_sqrt_inv_pipeline,
    scatter,
)
from repro_torch.obs import (  # noqa: E402
    EventLog,
    HealthPolicy,
    LocalityLedger,
    MemoryMeter,
    Tracer,
    utilization_table,
    worker_utilization,
    write_chrome_trace,
)

P = 8
BS = 16
TOL, IDEM_TOL, TRUNC_TAU, SPAMM_TAU = 1e-6, 1e-5, 1e-6, 1e-7
OVERHEAD_CAP_PCT = 2.0
TRACE_PATH = os.path.join(torch_bench.ROOT, "trace_pipeline_torch.json")


def problem(n: int, bs: int = BS, device="cuda", *, card: bool = False
            ) -> tuple[BSMatrix, BSMatrix, int]:
    """Banded SPD overlap S + symmetric Hamiltonian H, SP2-ready.

    The reference's problem (its H is dense), or with ``card`` the
    ``chip_smoke.py`` resident pipeline's (``_hamiltonian``: banded couplings
    with a spectral gap, S = I + 0.01 |H|, n_occ = 0.3125 N).  At N = 8192 the
    reference's dense H makes every SP2 product a dense 64 x 64-block
    multiply, and one card run of the three arms did not finish in 900 s.
    """
    if card:
        import chip_smoke

        nocc = n * 5 // 16
        h, s = chip_smoke._hamiltonian(n, nocc, seed=7)
        return (BSMatrix.from_dense(s, bs, device=device),
                BSMatrix.from_dense(h, bs, device=device), nocc)
    rng = np.random.default_rng(11)
    b = np.zeros((n, n), dtype=np.float32)
    h = int(round(12 * bs / BS))
    for i in range(n):
        lo, hi = max(0, i - h), min(n, i + h + 1)
        b[i, lo:hi] = rng.standard_normal(hi - lo)
    s = (b @ b.T / n + np.eye(n)).astype(np.float32)
    hm = 0.2 * rng.standard_normal((n, n)).astype(np.float32)
    ham = ((hm + hm.T) / 2 + np.diag(np.linspace(-1.0, 1.0, n))).astype(np.float32)
    return (BSMatrix.from_dense(s, bs, device=device),
            BSMatrix.from_dense(ham, bs, device=device), int(0.3 * n))


def run_once(dS, dH, nocc, mesh, cache, tracer=None, log=None, health=None):
    d, st = dist_sqrt_inv_pipeline(
        dS, dH, nocc, mesh, tol=TOL, idem_tol=IDEM_TOL,
        trunc_tau=TRUNC_TAU, spamm_tau=SPAMM_TAU, cache=cache,
        rebalance=RebalancePolicy(), tracer=tracer, log=log, health=health,
    )
    torch_bench.sync(mesh.device)
    return d, st


def _median_ci(xs: list, conf: float = 0.95) -> tuple:
    """Distribution-free confidence interval for the median (sign-test
    inversion): ``(x_(l), x_(n-1-l))`` covers the true median with >= ``conf``."""
    s = sorted(xs)
    n = len(s)
    alpha = (1.0 - conf) / 2.0
    cum, lo = 0.0, 0
    for k in range(n + 1):
        cum += math.comb(n, k) * 0.5 ** n
        if cum > alpha:
            lo = k
            break
    hi = n - 1 - lo
    if lo > hi:  # too few samples for the requested confidence
        return s[0], s[-1]
    return s[lo], s[hi]


def full_observatory(sync: bool) -> dict:
    """One repeat's worth of the whole observability stack."""
    return dict(
        tracer=Tracer(sync=sync),
        log=EventLog(path=None, level="info"),
        health=HealthPolicy(),
        memory=MemoryMeter(),
        locality=LocalityLedger(),
    )


def run(n: int, bs: int, repeats: int, sync_repeats: int, dev, *, smoke: bool,
        size: str, trace_path: str = TRACE_PATH) -> dict:
    """The three arms and the cold traced run; returns the BENCH payload."""
    mesh = make_worker_mesh(P, dev)
    card = size == "card"
    s, ham, nocc = problem(n, bs, device=dev, card=card)
    dS = scatter(s, mesh, owner=np.zeros(s.nnzb, dtype=np.int32))  # everything on worker 0
    dH = scatter(ham, mesh, owner=np.zeros(ham.nnzb, dtype=np.int32))
    print(f"pipeline: n={n} bs={bs} nnzb(S)={s.nnzb} workers={P} "
          f"(skewed initial layout, rebalancing on)")

    # room for the whole run's plan vocabulary: at the default 128 entries
    # the LRU evicts, and every "warm" repeat would replan
    cache = PlanCache(max_entries=4096)
    d_ref, _ = run_once(dS, dH, nocc, mesh, cache)
    warm_misses = cache.misses
    run_once(dS, dH, nocc, mesh, cache)
    replay_misses = cache.misses - warm_misses
    print(f"plan cache: {warm_misses} builds, replay misses {replay_misses}")
    assert replay_misses == 0, f"warm replay still missed {replay_misses} plans"

    def one_run(obs_factory):
        cache.tracer = None
        cache.event_log = None
        cache.memory_meter = None
        cache.locality_ledger = None
        kw = obs_factory() if obs_factory else {}
        mm = kw.pop("memory", None)
        if mm is not None:
            mm.install(cache)
        lld = kw.pop("locality", None)
        if lld is not None:
            lld.install(cache)
        gc.collect()
        gc.disable()
        try:
            c0 = time.process_time()
            t0 = time.perf_counter()
            d, _ = run_once(dS, dH, nocc, mesh, cache, **kw)
            wall = time.perf_counter() - t0
            cpu = time.process_time() - c0
        finally:
            gc.enable()
        assert torch_bench.bit_identical(d, d_ref), "repeat diverged from reference"
        return wall, cpu

    # bare and observatory arms every round (the paired median tightens with
    # N); the sync arm rides the first few rounds only
    arms = (None, lambda: full_observatory(sync=False), lambda: full_observatory(sync=True))
    walls = ([], [], [])
    max_rounds = repeats if smoke else 4 * repeats
    rounds = 0
    while True:
        idxs = (0, 1, 2) if rounds < sync_repeats else (0, 1)
        for i in (idxs if rounds % 2 == 0 else idxs[::-1]):
            walls[i].append(one_run(arms[i]))
        rounds += 1
        if rounds < repeats:
            continue
        pcts = [(on - off) / off * 100.0 for (_, off), (_, on) in zip(walls[0], walls[1])]
        ci_lo, ci_hi = _median_ci(pcts)
        if ci_hi < OVERHEAD_CAP_PCT or ci_lo >= OVERHEAD_CAP_PCT or rounds >= max_rounds:
            break
    if rounds > repeats:
        print(f"noisy host: paired-overhead 95% CI straddled the {OVERHEAD_CAP_PCT}% cap "
              f"at n={repeats}, extended sampling to n={rounds}")
    off_s, on_s, sync_s = ([w for w, _ in arm] for arm in walls)
    off_c, on_c, sync_c = ([c for _, c in arm] for arm in walls)
    min_off, min_on, min_sync = min(off_s), min(on_s), min(sync_s)
    cmin_off, cmin_on, cmin_sync = min(off_c), min(on_c), min(sync_c)
    overhead_pct = statistics.median(pcts)
    overhead_sync_pct = statistics.median(
        (s - off) / off * 100.0 for off, s in zip(off_c, sync_c))
    overhead_cpu_min_pct = (cmin_on - cmin_off) / cmin_off * 100.0
    overhead_wall_pct = (min_on - min_off) / min_off * 100.0
    print(f"warm cpu paired median of {rounds}: overhead {overhead_pct:+.2f}%  "
          f"(95% CI [{ci_lo:+.2f}%, {ci_hi:+.2f}%];  sync spans {overhead_sync_pct:+.2f}%;  "
          f"unpaired cpu floors bare {cmin_off*1e3:.1f} ms / observatory {cmin_on*1e3:.1f} ms, "
          f"{overhead_cpu_min_pct:+.2f}%, unguarded)")
    print(f"warm wall (best of {rounds}): bare {min_off*1e3:.1f} ms  observatory "
          f"{min_on*1e3:.1f} ms  ({overhead_wall_pct:+.2f}%, unguarded)  bit-identical: True")

    # -- cold observed run -> exported trace + utilization/memory report ----
    tracer = Tracer()
    log = EventLog(path=None, level="info")
    mm = MemoryMeter()
    cold_cache = PlanCache(tracer=tracer, event_log=log)
    mm.install(cold_cache)
    lld = LocalityLedger().install(cold_cache)
    d_cold, st = run_once(dS, dH, nocc, mesh, cold_cache, tracer=tracer, log=log,
                          health=HealthPolicy())
    assert torch_bench.bit_identical(d_cold, d_ref), "cold traced run diverged"
    mm.flush(tracer)  # per-worker peak gauges -> trace counter track
    summary = write_chrome_trace(tracer, trace_path)
    util = worker_utilization(tracer)
    print(f"\nwrote {os.path.abspath(trace_path)} ({summary['events']} events, "
          f"{summary['host_spans']} host spans, {summary['workers']} worker tracks)")
    print(utilization_table(util, memory=mm.worker_peak()))
    loc = lld.summary()
    print(f"locality: {loc['locality_flops'] * 100:.1f}% of flops / "
          f"{loc['locality_bytes'] * 100:.1f}% of bytes read locally; "
          f"wire {loc['wire_recv_bytes'] / 1e6:.2f} MB over {loc['dispatches']} dispatches")

    cats: dict[str, int] = {}
    for sp in tracer.spans:
        cats[sp.cat or "?"] = cats.get(sp.cat or "?", 0) + 1
    imbs = [pi["imbalance"] for pi in st.purify.per_iter + st.inverse.per_iter
            if pi.get("imbalance") is not None]
    events_by_kind: dict[str, int] = {}
    for rec in log.recent:
        events_by_kind[rec["event"]] = events_by_kind.get(rec["event"], 0) + 1
    health_summaries = {
        name: stats.health
        for name, stats in (("inverse", st.inverse), ("purify", st.purify))
        if getattr(stats, "health", None) is not None
    }
    return dict(
        meta=dict(n=n, bs=bs, workers=P, smoke=smoke, size=size, repeats=repeats, repeats_run=rounds,
                  problem="chip_smoke._hamiltonian" if card else "reference",
                  tol=TOL, idem_tol=IDEM_TOL, trunc_tau=TRUNC_TAU, spamm_tau=SPAMM_TAU,
                  overhead_cap_pct=OVERHEAD_CAP_PCT, observatory=True,
                  initial_layout="all blocks on worker 0",
                  card=torch_bench.card_line(dev), commit=torch_bench.git_commit()),
        overhead=dict(
            untraced_s=[float(t) for t in off_s],
            traced_s=[float(t) for t in on_s],
            traced_sync_s=[float(t) for t in sync_s],
            untraced_cpu_s=[float(t) for t in off_c],
            traced_cpu_s=[float(t) for t in on_c],
            traced_sync_cpu_s=[float(t) for t in sync_c],
            min_untraced_s=float(min_off),
            min_traced_s=float(min_on),
            min_traced_sync_s=float(min_sync),
            min_untraced_cpu_s=float(cmin_off),
            min_traced_cpu_s=float(cmin_on),
            min_traced_sync_cpu_s=float(cmin_sync),
            overhead_pct=float(overhead_pct),
            overhead_ci_pct=[float(ci_lo), float(ci_hi)],
            overhead_sync_pct=float(overhead_sync_pct),
            overhead_cpu_min_pct=float(overhead_cpu_min_pct),
            overhead_wall_pct=float(overhead_wall_pct),
            bit_identical=True,
        ),
        trace=dict(path=os.path.basename(trace_path), summary=summary,
                   spans_by_cat=cats, counter_totals=tracer.metrics_flat()),
        utilization=util,
        observatory=dict(
            events_by_kind=events_by_kind,
            health=health_summaries,
            memory=mm.summary(),
            locality=lld.summary(),
        ),
        per_iter_imbalance_mean=float(np.mean(imbs)) if imbs else None,
        per_iter_imbalance_max=float(np.max(imbs)) if imbs else None,
    )


def sizes(args) -> tuple[int, int, int, int]:
    """``(n, bs, repeats, sync_repeats)``: the reference's smoke / full, or the card's."""
    if args.card:
        return torch_bench.CARD_N, torch_bench.CARD_BS, 12, 4
    return (128, BS, 2, 2) if args.smoke else (256, BS, 12, 4)


def main(argv=None) -> int:
    args = torch_bench.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = torch_bench.device(args.device)
    n, bs, repeats, sync_repeats = sizes(args)
    trace_path = (os.path.join(os.path.dirname(os.path.abspath(args.out)),
                               os.path.basename(TRACE_PATH)) if args.out else TRACE_PATH)
    payload = run(n, bs, repeats, sync_repeats, dev, smoke=args.smoke,
                  size=torch_bench.size_name(args), trace_path=trace_path)
    torch_bench.write(payload, "trace", args.out)
    ov = payload["overhead"]
    # gate last so a failing run still leaves the samples and the trace on disk
    if not args.smoke:
        assert ov["overhead_pct"] < OVERHEAD_CAP_PCT, (
            f"observatory overhead {ov['overhead_pct']:.2f}% (95% CI "
            f"[{ov['overhead_ci_pct'][0]:+.2f}%, {ov['overhead_ci_pct'][1]:+.2f}%] over "
            f"{payload['meta']['repeats_run']} paired rounds) exceeds {OVERHEAD_CAP_PCT}% cap")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
