"""Paper Table 1 + Figure 1 (weak scaling of sparse A*A), on the port.

The port's mirror of ``benchmarks/weak_scaling.py`` and of ``run.py``'s
``bench_table1`` / ``bench_fig1c`` / ``bench_fig1a``:

* **Table 1**: the element-level TFLOP column of the three families at the
  paper's sizes (1e5 .. 6.4e6), analytic from the structure (no matrix is
  built), beside the paper's values.
* **Fig 1c**: data received per worker, from the port's planner at the
  paper's leaf 2048: the locality-aware schedule, the allgather baseline and
  the outer-product schedule, with each worker's receive bytes.
* **Fig 1a/b**: P workers share one card here, so the measured curve is
  *time per TFLOP against worker count*, not a scaling efficiency:
  the resident ``dist_multiply`` on a reduced band at 1, 2 and 4 workers with
  the work per worker held (``fig1a``), and with
  ``--card`` the largest Table 1 band row that fits one 80 GB card (row 3:
  N = 400,000, half-bandwidth 3000, 8 workers, leaf 128) through the
  resident runtime — ``scatter`` -> ``dist_multiply`` cold and warm -> 64
  sampled output blocks against float64 products on the card.

Run:  python benchmarks/torch_weak_scaling.py [--device cpu] [--smoke | --card]
"""

from __future__ import annotations

import time

import numpy as np

import torch_bench

from repro_torch.core import BSMatrix  # noqa: E402
from repro_torch.core.outer import make_outer_plan, plan_outer_stats  # noqa: E402
from repro_torch.core.quadtree import morton_sort  # noqa: E402
from repro_torch.core.schedule import make_spgemm_plan, plan_stats  # noqa: E402
from repro_torch.core.spgemm import spgemm_symbolic  # noqa: E402

BANDW = 3000  # paper: bandwidth 2*3000 + 1
LEAF = 2048  # paper leaf matrix dimension

# paper Table 1
SIZES = [100_000, 200_000, 400_000, 800_000, 1_600_000, 3_200_000, 6_400_000]
WORKERS = [2, 4, 8, 16, 32, 64, 128]
PAPER_TFLOP_BANDED = [7.022, 14.22, 28.63, 57.44, 115.1, 230.3, 460.8]
PAPER_TFLOP_BLOCKED = [14.04, 28.45, 57.26, 114.9, 230.1, 460.6, 921.6]
GROWING_BLOCK_SIZE = [15716, 19652, 24621, 30899, 38825, 48828, 61446]
RANDOM_BLOCK_SIZE = [15716, 15705, 15700, 15697, 15696, 15695, 15695]
RANDOM_BLOCK_NUM = [1, 2, 4, 8, 16, 32, 64]

#: the Table 1 band row the card runs (N = 400,000 on 8 workers): row 2 peaked
#: at 20.8 GB, so row 3 needs about 42 GB and row 4 about 84 GB
CARD_ROW = 2
#: per sampled output block: |dC|_max <= REL * sum_t ||A_t||_F ||B_t||_F
REL = 1e-5


# ---------------------------------------------------------------------------
# Table 1: analytic flop counts from element-level structure
# ---------------------------------------------------------------------------


def _band_counts(n: int, h: int) -> np.ndarray:
    k = np.arange(n, dtype=np.int64)
    return np.minimum(n - 1, k + h) - np.maximum(0, k - h) + 1


def banded_flops(n: int, h: int = BANDW) -> float:
    c = _band_counts(n, h).astype(np.float64)
    return float(2.0 * np.sum(c * c))  # A is symmetric in structure: rows == cols


def growing_block_flops(n: int, s: int, h: int = BANDW) -> float:
    c = _band_counts(n, h).astype(np.float64)
    k = np.arange(n, dtype=np.int64)
    # dense corner block [0,s) x [0,s): column k < s gains (s - overlap with band)
    overlap = np.where(
        k < s, np.minimum(s - 1, k + h) - np.maximum(0, k - h) + 1, 0
    ).astype(np.float64)
    extra = np.where(k < s, s - overlap, 0.0)
    tot = c + extra
    return float(2.0 * np.sum(tot * tot))


def random_blocks_flops(n: int, s: int, nblocks: int, h: int = BANDW, seed=0) -> float:
    c = _band_counts(n, h).astype(np.float64)
    starts = _random_block_starts(n, s, nblocks, seed)
    k = np.arange(n, dtype=np.int64)
    extra = np.zeros(n, dtype=np.float64)
    for st in starts:
        kk = k[st : st + s]
        overlap = np.minimum(st + s - 1, kk + h) - np.maximum(st, kk - h) + 1
        extra[st : st + s] = s - np.maximum(overlap, 0)
    tot = c + extra
    return float(2.0 * np.sum(tot * tot))


def _random_block_starts(n, s, nblocks, seed=0):
    """Non-overlapping blocks at random diagonal positions (paper setup)."""
    rng = np.random.default_rng(seed)
    slots = n - s * nblocks
    gaps = rng.multinomial(slots, np.ones(nblocks + 1) / (nblocks + 1))
    starts, pos = [], 0
    for i in range(nblocks):
        pos += gaps[i]
        starts.append(pos)
        pos += s
    return starts


def table1() -> list[dict]:
    rows = []
    for i, n in enumerate(SIZES):
        rows.append(
            dict(
                n=n,
                workers=WORKERS[i],
                banded_tflop=banded_flops(n) / 1e12,
                paper_banded=PAPER_TFLOP_BANDED[i],
                growing_tflop=growing_block_flops(n, GROWING_BLOCK_SIZE[i]) / 1e12,
                random_tflop=random_blocks_flops(n, RANDOM_BLOCK_SIZE[i], RANDOM_BLOCK_NUM[i]) / 1e12,
                paper_blocked=PAPER_TFLOP_BLOCKED[i],
            )
        )
    return rows


# ---------------------------------------------------------------------------
# structural matrices at paper block granularity (for comm / task analysis)
# ---------------------------------------------------------------------------


def _band_block_coords(nb: int, hw_blocks: int) -> np.ndarray:
    i = np.arange(nb)
    rows, cols = [], []
    for d in range(-hw_blocks, hw_blocks + 1):
        j = i + d
        m = (j >= 0) & (j < nb)
        rows.append(i[m])
        cols.append(j[m])
    coords = np.stack([np.concatenate(rows), np.concatenate(cols)], 1)
    return coords[morton_sort(coords)]


def structure_coords(family: str, n: int, idx: int, bs: int = LEAF) -> np.ndarray:
    """Block coordinates of each family at the paper's scale."""
    nb = -(-n // bs)
    hw = -(-BANDW // bs)
    band = _band_block_coords(nb, hw)
    keys = {tuple(x) for x in band.tolist()}
    extra = []
    if family == "banded":
        pass
    elif family == "growing":
        sb = -(-GROWING_BLOCK_SIZE[idx] // bs)
        for i in range(sb):
            for j in range(sb):
                if (i, j) not in keys:
                    extra.append((i, j))
    elif family == "random":
        s = RANDOM_BLOCK_SIZE[idx]
        sb = -(-s // bs)
        for st in _random_block_starts(n, s, RANDOM_BLOCK_NUM[idx]):
            b0 = st // bs
            for i in range(b0, min(b0 + sb + 1, nb)):
                for j in range(b0, min(b0 + sb + 1, nb)):
                    if (i, j) not in keys:
                        extra.append((i, j))
    else:
        raise ValueError(family)
    if extra:
        coords = np.concatenate([band, np.array(extra, dtype=np.int64)])
        return coords[morton_sort(coords)]
    return band


def fig1c(max_idx: int = 7, include_outer: bool = True) -> list[dict]:
    """Data received per worker: locality schedule vs baselines, paper scale.

    Beside the reference's means (MiB in fp64, as the paper), each row keeps
    every worker's receive bytes of the p2p and allgather plans (fp32
    blocks, as planned).
    """
    rows = []
    for i in range(max_idx):
        n, P = SIZES[i], WORKERS[i]
        for family in ("banded", "growing", "random"):
            coords = structure_coords(family, n, i)
            tasks = spgemm_symbolic(coords, coords)
            loc = plan_stats(
                make_spgemm_plan(coords, coords, P, LEAF, placement="morton", tasks=tasks)
            )
            ag = plan_stats(
                make_spgemm_plan(
                    coords, coords, P, LEAF, placement="random", exchange="allgather", tasks=tasks
                )
            )
            row = dict(
                family=family,
                n=n,
                workers=P,
                nnzb=len(coords),
                tasks=tasks.num_tasks,
                locality_recv_mb=loc["recv_bytes_mean"] / 2**20 * 2,  # fp64 (paper)
                allgather_recv_mb=ag["recv_bytes_mean"] / 2**20 * 2,
                balance=loc["task_balance"],
                locality_recv_bytes_per_worker=loc["recv_bytes_per_worker"],
                allgather_recv_bytes_per_worker=ag["recv_bytes_per_worker"],
            )
            if include_outer:
                op = plan_outer_stats(make_outer_plan(coords, coords, P, LEAF, tasks=tasks))
                row["outer_recv_mb"] = op["recv_bytes_mean"] / 2**20 * 2
                row["outer_balance"] = op["task_balance"]
            rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Fig 1a/b on one card: time per TFLOP
# ---------------------------------------------------------------------------


def band_matrix(n: int, hw: int, bs: int, seed: int, dev) -> BSMatrix:
    """Banded A (|i - j| <= hw, N x N) from block coordinates, values from a
    seeded ``torch.Generator`` on ``dev`` (a dense N x N never exists)."""
    import torch

    coords = _band_block_coords(-(-n // bs), (hw + bs - 1) // bs).astype(np.int64)
    gen = torch.Generator(device=dev).manual_seed(seed)
    data = torch.randn((coords.shape[0], bs, bs), generator=gen, device=dev)
    r = torch.arange(bs, device=dev)
    c_t = torch.from_numpy(coords).to(dev)
    for k in range(0, coords.shape[0], 4096):  # mask the element band in slabs
        rows = c_t[k:k + 4096, 0, None, None] * bs + r[None, :, None]
        cols = c_t[k:k + 4096, 1, None, None] * bs + r[None, None, :]
        keep = ((rows - cols).abs() <= hw) & (rows < n) & (cols < n)
        data[k:k + 4096].mul_(keep)
    return BSMatrix(shape=(n, n), bs=bs, coords=coords, data=data)


def measured_weak_scaling(dev, base_n: int = 2048, bs: int = 128, reps: int = 3) -> list[dict]:
    """The weak-scaling protocol on one card: a band of half-width ``bs`` at
    ``base_n`` times P on P = 1, 2, 4 workers (the work per worker held),
    through the resident ``dist_multiply``: warm seconds per call and per
    TFLOP.  The workers share the card, so the curve is time per TFLOP
    against worker count, not a parallel efficiency."""
    from repro_torch.core.distributed import make_worker_mesh
    from repro_torch.dist import PlanCache, dist_multiply, scatter

    rows = []
    for workers in (1, 2, 4):
        n = base_n * workers
        a = band_matrix(n, bs, bs, seed=workers, dev=dev)
        d = scatter(a, make_worker_mesh(workers, dev))
        cache = PlanCache()
        dist_multiply(d, d, cache)  # cold: the plan, the kernel build
        torch_bench.sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            dist_multiply(d, d, cache)
        torch_bench.sync(dev)
        dt = (time.perf_counter() - t0) / reps
        tasks = cache.peek(cache.last_plan_key)[0].tasks
        flops = 2.0 * tasks.num_tasks * bs**3
        rows.append(dict(n=n, workers=workers, nnzb=a.nnzb, tasks=tasks.num_tasks, wall_s=dt,
                         gflops=flops / dt / 1e9, s_per_tflop=dt / (flops / 1e12)))
    return rows


def table1_row(dev, n: int, hw: int, bs: int, workers: int, *, samples: int = 64,
               seed: int = 400) -> dict:
    """One Table 1 band row through the resident runtime on ``dev``.

    ``scatter`` -> ``dist_multiply`` on a fresh ``PlanCache`` (cold: plan
    build, verification, the first call) and again (warm); the exchange and
    the fused kernel timed alone with CUDA events; ``samples`` output blocks
    held per block against float64 products of their tasks on ``dev``.
    Returns the row with the fused kernel's launches and the peak memory of
    the two calls (read before the timing runs, which hold a second C).
    """
    import torch

    from repro_torch.core.distributed import make_worker_mesh
    from repro_torch.dist import PlanCache, dist_multiply, scatter
    from repro_torch.kernels import fused_leaf as fl
    from repro_torch.kernels import ops

    cuda = dev.type == "cuda"
    a = band_matrix(n, hw, bs, seed, dev)
    mesh = make_worker_mesh(workers, dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    d = scatter(a, mesh)
    cache = PlanCache()
    launches0 = fl.launches
    torch_bench.sync(dev)
    t0 = time.perf_counter()
    c = dist_multiply(d, d, cache)
    torch_bench.sync(dev)
    first_s = time.perf_counter() - t0
    del c
    t0 = time.perf_counter()
    c = dist_multiply(d, d, cache)
    torch_bench.sync(dev)
    warm_s = time.perf_counter() - t0
    launches = fl.launches - launches0
    peak = torch.cuda.max_memory_allocated() if cuda else None  # the two calls' peak
    plan, exe = cache.peek(cache.last_plan_key)
    tasks = plan.tasks

    def event_ms(fn, reps):
        fn()
        torch_bench.sync(dev)
        if not cuda:
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t) * 1e3 / reps
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    exchange_ms = event_ms(lambda: exe.kernel_args(d.store, d.store), reps=3)
    args = exe.kernel_args(d.store, d.store)
    kernel_ms = event_ms(lambda: ops.fused_block_spmm(*args), reps=2)
    del args

    # sampled output blocks against float64 products of their tasks
    run_ptr = np.searchsorted(tasks.c_idx, np.arange(tasks.num_out + 1))
    rng = np.random.default_rng(6)
    worst = 0.0
    for blk in rng.choice(tasks.num_out, size=min(samples, tasks.num_out), replace=False):
        lo, hi = run_ptr[blk], run_ptr[blk + 1]
        at = a.data[torch.from_numpy(tasks.a_idx[lo:hi]).to(dev)].double()
        bt = a.data[torch.from_numpy(tasks.b_idx[lo:hi]).to(dev)].double()
        want = torch.einsum("tij,tjk->ik", at, bt)
        tol = REL * float((torch.linalg.matrix_norm(at) * torch.linalg.matrix_norm(bt)).sum())
        got = c.store[int(c.owner[blk]), int(c.slot[blk])].double()
        err = float((got - want).abs().max())
        if not err <= tol:
            raise RuntimeError(f"table 1 row N={n}: block {blk} error {err} > tolerance {tol}")
        worst = max(worst, err / tol)
    if c.nnzb != tasks.num_out:
        raise RuntimeError(f"table 1 row N={n}: {c.nnzb} output blocks, plan has {tasks.num_out}")
    block_tflop = 2.0 * tasks.num_tasks * bs**3 / 1e12
    element_tflop = banded_flops(n, hw) / 1e12
    blk_bytes = bs * bs * 4
    return dict(
        n=n, half_bandwidth=hw, bs=bs, workers=workers, a_blocks=a.nnzb, c_blocks=c.nnzb,
        tasks=tasks.num_tasks, block_tflop=block_tflop, element_tflop=element_tflop,
        a_store_gb=workers * d.cap * blk_bytes / 1e9, c_store_gb=workers * c.cap * blk_bytes / 1e9,
        plan_build_s=cache.build_s, verify_s=cache.verify_s, first_call_s=first_s,
        warm_call_s=warm_s, exchange_ms=exchange_ms, kernel_ms=kernel_ms,
        kernel_tflops=block_tflop / (kernel_ms * 1e-3),
        s_per_block_tflop=warm_s / block_tflop, s_per_element_tflop=warm_s / element_tflop,
        max_memory_allocated=peak, fused_launches=launches,
        sampled_blocks=int(min(samples, tasks.num_out)), max_err_over_tol=worst,
    )


# ---------------------------------------------------------------------------
# run.py's three benches and the BENCH file
# ---------------------------------------------------------------------------


def bench_table1() -> list[tuple]:
    out = []
    for r in table1():
        rel = abs(r["banded_tflop"] - r["paper_banded"]) / r["paper_banded"]
        out.append((f"table1_banded_n{r['n']}", 0.0,
                    f"tflop={r['banded_tflop']:.3f} paper={r['paper_banded']} rel_err={rel:.3f}"))
        out.append((f"table1_growing_n{r['n']}", 0.0,
                    f"tflop={r['growing_tflop']:.3f} paper={r['paper_blocked']}"))
        out.append((f"table1_random_n{r['n']}", 0.0,
                    f"tflop={r['random_tflop']:.3f} paper={r['paper_blocked']}"))
    return out


def bench_fig1c(rows: list[dict]) -> list[tuple]:
    return [(f"fig1c_{r['family']}_p{r['workers']}", 0.0,
             f"locality_mb={r['locality_recv_mb']:.1f} outer_mb={r.get('outer_recv_mb', -1):.1f} "
             f"allgather_mb={r['allgather_recv_mb']:.1f} balance={r['balance']:.2f}")
            for r in rows]


def bench_fig1a(rows: list[dict]) -> list[tuple]:
    return [(f"fig1a_banded_n{r['n']}_p{r['workers']}", r["wall_s"] * 1e6,
             f"gflops={r['gflops']:.2f} s_per_tflop={r['s_per_tflop']:.4f}") for r in rows]


def sizes(args) -> dict:
    """Fig 1c's rows, Fig 1a's base size and block, and the resident row."""
    if args.card:
        i = CARD_ROW
        return dict(fig1c_rows=7, fig1a=(2048, 128),
                    row=dict(n=SIZES[i], hw=BANDW, bs=torch_bench.CARD_BS, workers=WORKERS[i]))
    if args.smoke:
        return dict(fig1c_rows=1, fig1a=(256, 32), row=dict(n=4096, hw=300, bs=32, workers=8))
    return dict(fig1c_rows=7, fig1a=(2048, 128), row=dict(n=16384, hw=1000, bs=128, workers=8))


def main(argv=None) -> int:
    args = torch_bench.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = torch_bench.device(args.device)
    sz = sizes(args)
    t1 = table1()
    f1c = fig1c(max_idx=sz["fig1c_rows"])
    f1a = measured_weak_scaling(dev, *sz["fig1a"])
    row = table1_row(dev, **sz["row"])
    print("name,us_per_call,derived")
    for name, us, derived in bench_table1() + bench_fig1c(f1c) + bench_fig1a(f1a):
        print(f"{name},{us:.1f},{derived}")
    print(f"table1 row N={row['n']} on {row['workers']} workers: first call "
          f"{row['first_call_s']:.3f} s (plan {row['plan_build_s']:.3f} s, verify "
          f"{row['verify_s']:.3f} s), warm {row['warm_call_s']:.3f} s, kernel "
          f"{row['kernel_ms']:.2f} ms, {row['s_per_element_tflop']:.4f} s per element TFLOP")
    payload = dict(
        meta=dict(size=torch_bench.size_name(args), card=torch_bench.card_line(dev),
                  commit=torch_bench.git_commit(), leaf=LEAF, bandwidth=BANDW,
                  fig1a_metric="seconds per TFLOP against worker count: the workers share one "
                               "card, so this is not a scaling efficiency"),
        table1=t1, fig1c=f1c, fig1a=f1a, table1_row=row,
    )
    torch_bench.write(payload, "weak_scaling", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
