"""Resident vs re-shard-per-call distributed purification, on the port.

The port's mirror of ``benchmarks/dist_purify.py``: what the resident
runtime (``repro_torch.dist``) buys over calling the one-shot
``make_spgemm_plan`` + ``dist_spgemm`` path every SP2 iteration:

* per-iteration wall time (the card synchronised at the edges): the resident
  path amortizes planning, verification and plan uploads through the
  structure-keyed PlanCache;
* bytes moved per iteration: the baseline re-lays both operand stores out
  every multiply (a host->device shipment in the JAX package, a device-side
  gather of the single-device blocks here) and uploads the plan's index
  arrays; the resident path scatters F once and uploads a plan's arrays
  only when its structure is new;
* plan-cache hit/miss counts per iteration.

A second section compares the error-control modes on the SpAMM-enabled loop:
leaf truncation + replan SpAMM against hierarchical truncation + delta-plan
SpAMM (the prune pattern is a task mask over the cached full plan).  Writes
``BENCH_purify_torch.json``.

Run:  python benchmarks/torch_dist_purify.py [--device cpu] [--smoke | --card]
"""

from __future__ import annotations

import time

import numpy as np

import torch_bench

from repro_torch.core import BSMatrix, add, add_scaled_identity, truncate  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    dist_spgemm,
    make_worker_mesh,
    shard_stores,
    unshard_result,
)
from repro_torch.core.purify import Sp2Monitor, sp2_init_coeffs, sp2_should_square  # noqa: E402
from repro_torch.core.schedule import make_spgemm_plan  # noqa: E402
from repro_torch.dist import PlanCache, dist_lanczos_bounds, dist_sp2_purify, scatter  # noqa: E402

P = 8
N, BS, NOCC = 512, 32, 160
IDEM_TOL, TRUNC_TAU = 1e-5, 1e-5
SPAMM_TAU = 1e-6


def sizes(args) -> tuple[int, int, int]:
    """``(n, bs, n_occ)``: the reference's, a quarter of it for ``--smoke``, or the card's."""
    if args.card:
        n = torch_bench.CARD_N
        return n, torch_bench.CARD_BS, n * NOCC // N
    return (256, BS, 80) if args.smoke else (N, BS, NOCC)


def hamiltonian(n: int, bs: int, device="cuda") -> BSMatrix:
    """The reference's banded Hamiltonian; the half-width (6 elements at bs 32)
    scales with bs so the block-level shape stays."""
    rng = np.random.default_rng(7)
    hw = int(round(6 * bs / BS))
    h = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        lo, hi = max(0, i - hw), min(n, i + hw + 1)
        h[i, lo:hi] = 0.2 * rng.standard_normal(hi - lo)
    h = (h + h.T) / 2 + np.diag(np.linspace(-2.0, 2.0, n))
    # float32, as the JAX package's from_dense stores it
    return BSMatrix.from_dense(h.astype(np.float32), bs, device=device)


def eig_bounds(f: BSMatrix) -> tuple[float, float]:
    w = np.linalg.eigvalsh(np.asarray(f.to_dense(), np.float64))
    return float(w.min()) - 0.05, float(w.max()) + 0.05


def _nbytes(t) -> int:
    return int(t.numel() * t.element_size())


def baseline_reshard_purify(f, n_occ, lmin, lmax, mesh, max_iter=60):
    """SP2 where every multiply re-plans, re-lays the stores out and rebuilds
    its executable.  Returns ``(iters, times, relayout_bytes, plan_bytes)``."""
    scale, shift = sp2_init_coeffs(lmin, lmax)
    x = add_scaled_identity(f.scale(scale), shift)
    monitor = Sp2Monitor(IDEM_TOL)
    times, relayout, plan_up = [], [], []
    for it in range(max_iter):
        torch_bench.sync(mesh.device)
        t0 = time.perf_counter()
        plan = make_spgemm_plan(x.coords, x.coords, P, x.bs)
        a_store, b_store = shard_stores(plan, x.data, x.data)
        moved = _nbytes(a_store) + _nbytes(b_store)
        up = plan.task_a.nbytes + plan.task_b.nbytes + plan.task_c.nbytes
        up += sum(plan.a_send[d].nbytes for d in plan.a_offsets)
        up += sum(plan.b_send[d].nbytes for d in plan.b_offsets)
        c_stores = dist_spgemm(plan, x.data, x.data, mesh)
        x2 = unshard_result(plan, c_stores, x.shape, x.bs)
        idem = add(x2, x, 1.0, -1.0).frobenius_norm()
        tr = x.trace()
        torch_bench.sync(mesh.device)
        times.append(time.perf_counter() - t0)
        relayout.append(moved)
        plan_up.append(up)
        if monitor.update(it, idem):
            break
        x = x2 if sp2_should_square(tr, n_occ) else add(x, x2, 2.0, -1.0)
        if TRUNC_TAU > 0:
            x = truncate(x, TRUNC_TAU)
    return it + 1, times, relayout, plan_up


def resident_purify(f, n_occ, lmin, lmax, mesh):
    cache = PlanCache()
    torch_bench.sync(mesh.device)
    t0 = time.perf_counter()
    df = scatter(f, mesh)  # the one-time shipment of F onto the workers
    torch_bench.sync(mesh.device)
    scatter_s = time.perf_counter() - t0
    t_all0 = time.perf_counter()
    d, stats = dist_sp2_purify(df, n_occ, lmin, lmax, idem_tol=IDEM_TOL, trunc_tau=TRUNC_TAU,
                               cache=cache)
    torch_bench.sync(mesh.device)
    total = time.perf_counter() - t_all0
    return d, stats, cache, total, scatter_s, _nbytes(df.store)


def error_control_comparison(f, n_occ, lmin, lmax, mesh, spamm_tau=SPAMM_TAU) -> dict:
    """Leaf/replan vs hierarchical/delta error control on the same SP2 run."""
    modes = [
        ("leaf + replan-SpAMM", dict(trunc_method="leaf", spamm_method="replan")),
        ("hier + delta-SpAMM", dict(trunc_method="hierarchical", spamm_method="delta")),
    ]
    print(f"\n-- error-control modes (spamm_tau={spamm_tau:g}, trunc_tau={TRUNC_TAU:g}) --")
    out = {}
    for name, kw in modes:
        cache = PlanCache()
        df = scatter(f, mesh)
        torch_bench.sync(mesh.device)
        t0 = time.perf_counter()
        _, stats = dist_sp2_purify(df, n_occ, lmin, lmax, idem_tol=IDEM_TOL, trunc_tau=TRUNC_TAU,
                                   spamm_tau=spamm_tau, cache=cache, **kw)
        torch_bench.sync(mesh.device)
        total = time.perf_counter() - t0
        per = stats.per_iter
        misses = [pi["cache_misses"] for pi in per]
        sym_ms = [pi["symbolic_s"] * 1e3 for pi in per]
        build_ms = [pi["plan_build_s"] * 1e3 for pi in per]
        row = dict(
            iterations=stats.iterations, wall_s_per_iter=total / max(stats.iterations, 1),
            plan_misses_per_iter=misses, all_hit_iterations=sum(1 for m in misses if m == 0),
            symbolic_ms_mean=float(np.mean(sym_ms)), symbolic_ms_tail=float(np.mean(sym_ms[-5:])),
            plan_build_ms_mean=float(np.mean(build_ms)),
            plan_build_ms_tail=float(np.mean(build_ms[-5:])),
            verify_s=float(cache.verify_s),
            recv_mb_per_worker_tail=per[-1]["recv_bytes_mean"] / 1e6,
        )
        out[name] = row
        print(f"\n  [{name}]  iters={row['iterations']}  wall/iter "
              f"{row['wall_s_per_iter']*1e3:.1f} ms")
        print(f"    plan misses/iter    {misses}")
        print(f"    all-hit iterations  {row['all_hit_iterations']}/{len(per)}")
        print(f"    symbolic ms/iter    mean {row['symbolic_ms_mean']:7.2f}  "
              f"tail {row['symbolic_ms_tail']:7.2f}")
        print(f"    plan ms/iter        mean {row['plan_build_ms_mean']:7.2f}  "
              f"tail {row['plan_build_ms_tail']:7.2f}")
        print(f"    recv MB/worker tail {row['recv_mb_per_worker_tail']:.3f}")
    return out


def run(n: int, bs: int, nocc: int, dev, *, exact_bounds: bool) -> dict:
    """Baseline, resident and the error-control modes; the BENCH payload's sections."""
    mesh = make_worker_mesh(P, dev)
    f = hamiltonian(n, bs, device=dev)
    if exact_bounds:
        lmin, lmax = eig_bounds(f)
    else:
        lo, hi = dist_lanczos_bounds(scatter(f, mesh), PlanCache())
        lmin, lmax = lo - 0.05, hi + 0.05
    print(f"F: n={n} bs={bs} nnzb={f.nnzb}  workers={P}")

    iters_b, times_b, relayout_b, plan_b = baseline_reshard_purify(f, nocc, lmin, lmax, mesh)
    d, stats, cache, total_r, scatter_s, scatter_bytes = resident_purify(f, nocc, lmin, lmax, mesh)
    per_iter_r = total_r / max(stats.iterations, 1)

    print("\n-- baseline: make_spgemm_plan + dist_spgemm per iteration --")
    print(f"iterations            {iters_b}")
    print(f"wall/iter             {np.mean(times_b)*1e3:9.1f} ms")
    print(f"stores re-laid/iter   {np.mean(relayout_b)/1e6:9.3f} MB")
    print(f"plan arrays/iter      {np.mean(plan_b)/1e6:9.3f} MB uploaded")
    print("\n-- resident: repro_torch.dist (DistBSMatrix + PlanCache) --")
    print(f"iterations            {stats.iterations}")
    print(f"wall/iter             {per_iter_r*1e3:9.1f} ms")
    print(f"scatter once          {scatter_bytes/1e6:9.3f} MB in {scatter_s*1e3:.1f} ms")
    c = stats.cache
    print(f"plan cache            {c['hits']} hits / {c['misses']} misses "
          f"(hit rate {c['hit_rate']:.2f}), verification {cache.verify_s:.3f} s")
    hit_iters = [pi["wall_s"] for pi in stats.per_iter if pi["cache_misses"] == 0]
    assert c["hits"] > 0, "expected plan-cache hits across iterations"
    speedup = np.mean(times_b) / per_iter_r
    print(f"\nresident speedup      {speedup:9.2f}x per iteration")
    return dict(
        bounds=[lmin, lmax],
        baseline=dict(iterations=iters_b, wall_s_per_iter=float(np.mean(times_b)),
                      wall_s_per_iter_all=[float(t) for t in times_b],
                      relayout_bytes_per_iter=float(np.mean(relayout_b)),
                      plan_upload_bytes_per_iter=float(np.mean(plan_b)),
                      bytes_total=float(np.sum(relayout_b) + np.sum(plan_b))),
        resident=dict(iterations=stats.iterations, wall_s_total=total_r,
                      wall_s_per_iter=per_iter_r, scatter_s=scatter_s,
                      scatter_bytes=scatter_bytes, operand_bytes_per_iter=0.0,
                      cache=dict(hits=c["hits"], misses=c["misses"], hit_rate=c["hit_rate"]),
                      plan_build_s=float(cache.build_s), verify_s=float(cache.verify_s),
                      steady_state=[[pi["cache_hits"], pi["cache_misses"]]
                                    for pi in stats.per_iter[-5:]],
                      wall_s_per_iter_all_hit=(float(np.mean(hit_iters)) if hit_iters else None),
                      all_hit_iterations=len(hit_iters),
                      recv_bytes_per_worker_tail=stats.per_iter[-1]["recv_bytes_mean"]),
        resident_speedup=float(speedup),
        bytes_reduction=float((np.sum(relayout_b) + np.sum(plan_b)) / max(scatter_bytes, 1)),
        error_control=error_control_comparison(f, nocc, lmin, lmax, mesh),
    )


def main(argv=None) -> int:
    args = torch_bench.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = torch_bench.device(args.device)
    n, bs, nocc = sizes(args)
    payload = dict(meta=dict(n=n, bs=bs, nocc=nocc, workers=P, smoke=args.smoke, size=torch_bench.size_name(args),
                             idem_tol=IDEM_TOL, trunc_tau=TRUNC_TAU, spamm_tau=SPAMM_TAU,
                             card=torch_bench.card_line(dev), commit=torch_bench.git_commit()),
                   **run(n, bs, nocc, dev, exact_bounds=not args.card))
    torch_bench.write(payload, "purify", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
