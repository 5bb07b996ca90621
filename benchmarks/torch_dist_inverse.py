"""Single-device vs resident inverse factorization, on the port.

The port's mirror of ``benchmarks/dist_inverse.py``: what the resident
refinement loop (``repro_torch.dist.inverse``) buys on the localized inverse
factorization workload, against the single-device
``localized_inverse_factorization`` with a ``SymbolicCache`` (its numeric
phase the ``block_spmm`` kernel on the card):

* refinement iterations + residual trajectory;
* per-iteration plan-cache misses and planning/symbolic seconds — with
  delta-plan SpAMM + hierarchical truncation a stabilized pattern incurs
  zero misses, and an SCF-style repeated solve replays every iteration
  (including the first) from the cache (asserted);
* bytes moved per iteration: the executed multiply plan's exchange and the
  shared [nnzb] norm-table fetch;
* single-device vs resident wall-clock (the card synchronised at the edges).

Writes ``BENCH_inverse_torch.json``.

Run:  python benchmarks/torch_dist_inverse.py [--device cpu] [--smoke | --card]
"""

from __future__ import annotations

import time

import numpy as np

import torch_bench
from torch_spamm_sequences import dense

import torch  # noqa: E402
from repro_torch.core import BSMatrix, SymbolicCache, localized_inverse_factorization  # noqa: E402
from repro_torch.core.distributed import make_worker_mesh  # noqa: E402
from repro_torch.dist import PlanCache, dist_localized_inverse_factorization, scatter  # noqa: E402
from repro_torch.kernels import block_spmm  # noqa: E402

P = 8
N, BS = 256, 16
TOL, TRUNC_TAU, SPAMM_TAU = 1e-6, 1e-6, 1e-7


def sizes(args) -> tuple[int, int]:
    if args.card:
        return torch_bench.CARD_N, torch_bench.CARD_BS
    return (128, BS) if args.smoke else (N, BS)


def overlap(n: int, bs: int, device="cuda") -> BSMatrix:
    """The reference's banded SPD overlap; the half-width (4 elements at bs 16)
    scales with bs so the block-level shape stays."""
    rng = np.random.default_rng(11)
    hw = int(round(4 * bs / BS))
    b = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        lo, hi = max(0, i - hw), min(n, i + hw + 1)
        b[i, lo:hi] = rng.standard_normal(hi - lo)
    return BSMatrix.from_dense(b @ b.T + n * np.eye(n, dtype=np.float32), bs, device=device)


def host_run(s: BSMatrix):
    cache = SymbolicCache()
    launches = block_spmm.launches
    torch_bench.sync(s.device)
    t0 = time.perf_counter()
    z, stats = localized_inverse_factorization(s, tol=TOL, trunc_tau=TRUNC_TAU, cache=cache)
    torch_bench.sync(s.device)
    return z, stats, time.perf_counter() - t0, block_spmm.launches - launches


def resident_run(s: BSMatrix, mesh, cache: PlanCache):
    ds = scatter(s, mesh)
    torch_bench.sync(mesh.device)
    t0 = time.perf_counter()
    z, stats = dist_localized_inverse_factorization(ds, cache, tol=TOL, trunc_tau=TRUNC_TAU,
                                                    spamm_tau=SPAMM_TAU)
    torch_bench.sync(mesh.device)
    return z, stats, time.perf_counter() - t0


def report(stats, total, cache) -> dict:
    per = stats.per_iter
    misses = [pi["cache_misses"] for pi in per]
    sym = [pi["symbolic_s"] * 1e3 for pi in per]
    build = [pi["plan_build_s"] * 1e3 for pi in per]
    hit_iters = [pi["wall_s"] for pi in per if pi["cache_misses"] == 0]
    row = dict(
        iterations=stats.iterations, factorization_residual=float(stats.factorization_residual),
        stop_reason=stats.stop_reason, wall_s_total=total,
        wall_s_per_iter=total / max(stats.iterations, 1), plan_misses_per_iter=misses,
        all_hit_iterations=len(hit_iters),
        symbolic_ms_mean=float(np.mean(sym)), symbolic_ms_tail=float(np.mean(sym[-3:])),
        plan_build_ms_mean=float(np.mean(build)), plan_build_ms_tail=float(np.mean(build[-3:])),
        recv_bytes_per_worker_tail=per[-1]["recv_bytes_mean"],
        norm_fetch_bytes_per_iter=per[-1]["norm_fetch_bytes"],
        wall_s_per_iter_all_hit=float(np.mean(hit_iters)) if hit_iters else None,
        cache=dict(hits=cache.hits, misses=cache.misses), verify_s=float(cache.verify_s),
    )
    print(f"  iterations          {row['iterations']}  residual {row['factorization_residual']:.2e}")
    print(f"  wall/iter           {row['wall_s_per_iter']*1e3:9.1f} ms")
    print(f"  plan misses/iter    {misses}")
    print(f"  all-hit iterations  {len(hit_iters)}/{len(per)}")
    print(f"  symbolic ms/iter    mean {row['symbolic_ms_mean']:7.2f}  "
          f"tail {row['symbolic_ms_tail']:7.2f}")
    print(f"  plan ms/iter        mean {row['plan_build_ms_mean']:7.2f}  "
          f"tail {row['plan_build_ms_tail']:7.2f}")
    print(f"  recv MB/worker tail {row['recv_bytes_per_worker_tail']/1e6:.3f}")
    print(f"  norm fetch/iter     {row['norm_fetch_bytes_per_iter']/1e3:.2f} kB")
    return row


def run(n: int, bs: int, dev) -> dict:
    mesh = make_worker_mesh(P, dev)
    s = overlap(n, bs, device=dev)
    print(f"S: n={n} bs={bs} nnzb={s.nnzb}  workers={P}")

    z_h, st_h, total_h, launches_h = host_run(s)
    print("\n-- single device: core localized_inverse_factorization + SymbolicCache --")
    print(f"  iterations          {st_h.iterations}  residual {st_h.factorization_residual:.2e}")
    print(f"  wall/iter           {total_h/max(st_h.iterations,1)*1e3:9.1f} ms")
    print(f"  block_spmm launches {launches_h}")
    print(f"  symbolic misses/it  {st_h.cache_misses_history}")

    # room for every plan of a solve: at the card's size a solve builds more
    # than the default 128 entries, and the replay would re-plan what the LRU evicted
    cache = PlanCache(max_entries=4096)
    z_r, st_r, total_r = resident_run(s, mesh, cache)
    print("\n-- resident: dist_localized_inverse_factorization "
          "(delta-SpAMM + hierarchical truncation) --")
    first = report(st_r, total_r, cache)

    # SCF-style repeated solve: every structure is cached, every iteration
    # (including the first) replays with zero plan-cache misses
    misses0 = cache.misses
    z_r2, st_r2, total_r2 = resident_run(s, mesh, cache)
    print("\n-- resident, second solve (SCF replay) --")
    replay = report(st_r2, total_r2, cache)
    misses2 = [pi["cache_misses"] for pi in st_r2.per_iter]
    assert all(m == 0 for m in misses2) and cache.misses == misses0, misses2
    print("\nzero plan-cache misses across the repeated solve: OK")

    zr = z_r.gather()
    z_diff = float(torch.max(torch.abs(dense(zr) - dense(z_h))))
    print(f"max |Z_resident - Z_single_device| = {z_diff:.2e}")
    speedup = (total_h / max(st_h.iterations, 1)) / (total_r2 / max(st_r2.iterations, 1))
    print(f"warm resident vs single-device wall/iter: {speedup:.2f}x")
    return dict(
        single_device=dict(iterations=st_h.iterations,
                           factorization_residual=float(st_h.factorization_residual),
                           wall_s_total=total_h, wall_s_per_iter=total_h / max(st_h.iterations, 1),
                           block_spmm_launches=launches_h,
                           symbolic_misses_per_iter=list(st_h.cache_misses_history or [])),
        resident=first, resident_replay=replay, replay_misses=int(sum(misses2)),
        z_max_abs_diff=z_diff, warm_speedup=float(speedup),
    )


def main(argv=None) -> int:
    args = torch_bench.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = torch_bench.device(args.device)
    n, bs = sizes(args)
    payload = dict(meta=dict(n=n, bs=bs, workers=P, smoke=args.smoke, size=torch_bench.size_name(args), tol=TOL,
                             trunc_tau=TRUNC_TAU, spamm_tau=SPAMM_TAU,
                             card=torch_bench.card_line(dev), commit=torch_bench.git_commit()),
                   **run(n, bs, dev))
    torch_bench.write(payload, "inverse", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
