"""Kernel microbenchmarks on the port: the GEMM kernels, fused vs staged, precision, engines.

The port's mirror of ``benchmarks/kernel_micro.py``, its sections mapped onto
the port's hand-written CUDA kernels (on the card; a CPU run times the plain
versions and marks every row ``smoke_only``):

* ``rows`` — the ``block_spmm`` kernel against its plain version and against
  ``torch.bmm`` on pre-gathered operands (the products only: no gather, no
  ordered sum), then the library multiply's symbolic phase and whole call;
* ``fused_vs_staged`` — one worker's leaf workload (own store + stacked
  receive buffers) through the fused kernel against the staged path
  (concatenated operand buffers + ``block_spmm``): bit-identical in fp32;
* ``precision`` — the fused kernel in fp32, on bf16 stores, and adaptive
  (a per-task bf16 mask within a quarter of the full bf16 bound), each
  error against its analytic ``(2u + u^2) sum ||A_t|| ||B_t||`` bound;
* ``autotune`` — the JAX package's tile autotuner is not ported; on the card
  this section holds the two tile engines of ``tile_gemm.cuh`` (64 x 64 and
  128 x 128) timed on the same ``block_spmm`` task list at bs 32 / 64 / 128 /
  256 (a copy whose data starts 4 bytes past a 16-byte boundary makes the
  kernel take the 64 x 64 engine; the 128 x 128 one needs bs a multiple of
  128).  ``heuristic`` / ``pre_tune_pick`` / ``post_tune_pick`` are the
  engine the kernels' block-size rule picks at bs 128, ``winner`` the faster
  one, and ``roundtrip_ok`` whether the rule picked the faster engine at
  every bs timed.  The engines must agree bit for bit.

Times are CUDA-event means on the card (the process's wall clock on the
CPU).  Writes ``BENCH_kernel_torch.json``.

Run:  python benchmarks/torch_kernel_micro.py [--device cpu] [--smoke | --card]
"""

from __future__ import annotations

import time

import numpy as np

import torch_bench

import torch  # noqa: E402
from repro_torch.core import BSMatrix, multiply  # noqa: E402
from repro_torch.core.quadtree import morton_sort  # noqa: E402
from repro_torch.core.spgemm import spgemm_symbolic  # noqa: E402
from repro_torch.kernels import block_spmm as bsp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.fused_leaf import fused_task_runs  # noqa: E402
from repro_torch.kernels.precision import ROUND2_BOUND, low_precision_task_mask  # noqa: E402

ENGINE_BS = (32, 64, 128, 256)
#: (tm, tn, tk) of the engines in csrc/tile_gemm.cuh
ENGINE_TILES = {"tile64": [64, 64, 16], "tile128": [128, 128, 16]}


def time_us(fn, dev, reps: int = 10) -> float:
    """Mean microseconds of ``fn`` over ``reps`` warm calls (CUDA events on the card)."""
    fn()
    torch_bench.sync(dev)
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e6 / reps


def _random_tasks(rng, n_blocks: int, T: int, nout: int):
    a = rng.integers(0, n_blocks, T)
    b = rng.integers(0, n_blocks, T)
    c = np.sort(rng.integers(0, nout, T))
    return a, b, c


def bench_block_spmm(dev, bs: int, T: int, nout: int, n_blocks: int = 32) -> list[dict]:
    """The kernel (on the card), its plain version and ``torch.bmm`` on the
    pre-gathered operands, on one random task list."""
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn((n_blocks, bs, bs), generator=gen, device=dev)
    B = torch.randn((n_blocks, bs, bs), generator=gen, device=dev)
    a, b, c = _random_tasks(rng, n_blocks, T, nout)
    args = (A, B, *ops.task_arrays(a, b, c, nout, dev), nout)
    flops = 2.0 * T * bs**3
    on_card = dev.type == "cuda"
    rows = []
    if on_card:
        t_k = time_us(lambda: bsp.block_spmm_cuda(*args), dev)
        rows.append(dict(name=f"block_spmm_cuda_bs{bs}", us=t_k, gflops=flops / t_k / 1e3,
                         smoke_only=False))
    t_ref = time_us(lambda: bsp.block_spmm_ref(*args), dev, reps=3)
    rows.append(dict(name=f"block_spmm_plain_bs{bs}", us=t_ref, gflops=flops / t_ref / 1e3,
                     smoke_only=not on_card))
    lhs, rhs = A[args[2]], B[args[3]]
    t_bmm = time_us(lambda: torch.bmm(lhs, rhs), dev)
    rows.append(dict(name=f"bmm_pregathered_bs{bs}", us=t_bmm, gflops=flops / t_bmm / 1e3,
                     smoke_only=not on_card))
    return rows


def bench_spgemm_end_to_end(dev, n: int, bs: int) -> list[dict]:
    """Library-level multiply incl. symbolic phase (banded matrix)."""
    rng = np.random.default_rng(1)
    nb = n // bs
    i = np.arange(nb)
    coords = []
    for d in (-1, 0, 1):
        j = i + d
        m = (j >= 0) & (j < nb)
        coords.append(np.stack([i[m], j[m]], 1))
    coords = np.concatenate(coords)
    coords = coords[morton_sort(coords)]
    data = torch.from_numpy(rng.standard_normal((len(coords), bs, bs)).astype(np.float32)).to(dev)
    a = BSMatrix(shape=(n, n), bs=bs, coords=coords, data=data)
    cpu = torch.device("cpu")
    t_sym = time_us(lambda: spgemm_symbolic(a.coords, a.coords), cpu, reps=10)
    t_full = time_us(lambda: multiply(a, a), dev, reps=3)
    tasks = spgemm_symbolic(a.coords, a.coords)
    flops = 2.0 * tasks.num_tasks * bs**3
    return [
        dict(name=f"spgemm_symbolic_n{n}", us=t_sym, gflops=0.0, smoke_only=False),
        dict(name=f"spgemm_full_n{n}", us=t_full, gflops=flops / t_full / 1e3,
             smoke_only=dev.type != "cuda"),
    ]


def fused_problem(dev, bs: int, T: int, n_store: int = 64, rounds: int = 3, cap_u: int = 32,
                  seed: int = 3) -> dict:
    """One worker's leaf workload: own store + stacked receive buffers, tasks
    addressing both (the reference's ``_fused_problem``, as a 1-worker mesh)."""
    rng = np.random.default_rng(seed)

    def t(x, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

    a_store = t(rng.standard_normal((1, n_store, bs, bs)))
    b_store = t(rng.standard_normal((1, n_store, bs, bs)))
    a_recv = t(rng.standard_normal((1, rounds, cap_u, bs, bs)))
    b_recv = t(rng.standard_normal((1, rounds, cap_u, bs, bs)))
    a_src = rng.integers(0, rounds + 1, T)
    b_src = rng.integers(0, rounds + 1, T)
    a_off = np.where(a_src == 0, rng.integers(0, n_store, T), rng.integers(0, cap_u, T))
    b_off = np.where(b_src == 0, rng.integers(0, n_store, T), rng.integers(0, cap_u, T))
    nout = max(T // 4, 1)
    c_idx = np.sort(rng.integers(0, nout, T))
    a_lin = np.where(a_src == 0, a_off, n_store + (a_src - 1) * cap_u + a_off)
    b_lin = np.where(b_src == 0, b_off, n_store + (b_src - 1) * cap_u + b_off)
    i64 = lambda x: t(np.asarray(x)[None], torch.int64)  # noqa: E731
    return dict(
        a_store=a_store, b_store=b_store, a_recv=a_recv, b_recv=b_recv,
        idx=(i64(a_src), i64(a_off), i64(b_src), i64(b_off)),
        run_ptr=t(fused_task_runs(c_idx[None], nout), torch.int64),
        staged_tasks=ops.task_arrays(a_lin, b_lin, c_idx, nout, dev),
        a_lin=a_lin, b_lin=b_lin, nout=nout, bs=bs, T=T,
    )


def _fused(p, a_store=None, b_store=None, a_recv=None, b_recv=None, **kw):
    return ops.fused_block_spmm(
        p["a_store"] if a_store is None else a_store, p["a_recv"] if a_recv is None else a_recv,
        p["b_store"] if b_store is None else b_store, p["b_recv"] if b_recv is None else b_recv,
        *p["idx"], p["run_ptr"], p["nout"], **kw)[0]


def bench_fused_vs_staged(dev, bs: int, T: int) -> dict:
    """Staged (materialize the concatenated ``[own | recv...]`` operand
    buffer, then ``block_spmm``) against the fused kernel (reads straight
    from store + receive stacks); bit-identical in fp32."""
    p = fused_problem(dev, bs, T)

    def staged():
        a_cat = torch.cat([p["a_store"][0], p["a_recv"][0].reshape(-1, bs, bs)])
        b_cat = torch.cat([p["b_store"][0], p["b_recv"][0].reshape(-1, bs, bs)])
        return ops.block_spmm_tensors(a_cat, b_cat, *p["staged_tasks"], p["nout"])

    def fused():
        return _fused(p)

    bit_identical = bool(torch.equal(staged(), fused()))
    t_staged = time_us(staged, dev)
    t_fused = time_us(fused, dev)
    flops = 2.0 * T * bs**3
    out = dict(
        bs=bs, T=T, bit_identical=bit_identical,
        staged_us=t_staged, fused_us=t_fused, speedup=t_staged / t_fused,
        staged_gflops=flops / t_staged / 1e3, fused_gflops=flops / t_fused / 1e3,
        operand_buffer_bytes_eliminated=int(
            2 * (p["a_store"].shape[1] + p["a_recv"].shape[2] * p["a_recv"].shape[3])
            * bs * bs * 4),
    )
    assert bit_identical, "fused kernel diverged from the staged path"
    return out


def bench_precision_modes(dev, bs: int, T: int) -> dict:
    """fp32 vs bf16 stores vs norm-adaptive per-task rounding, each error
    against the analytic bound it promises."""
    p = fused_problem(dev, bs, T, seed=4)
    exact = _fused(p)
    t_fp32 = time_us(lambda: _fused(p), dev)

    bf = {k: p[k].to(torch.bfloat16) for k in ("a_store", "b_store", "a_recv", "b_recv")}
    a_cat = torch.cat([p["a_store"][0], p["a_recv"][0].reshape(-1, bs, bs)]).double()
    b_cat = torch.cat([p["b_store"][0], p["b_recv"][0].reshape(-1, bs, bs)]).double()
    a_n = torch.linalg.matrix_norm(a_cat).cpu().numpy()
    b_n = torch.linalg.matrix_norm(b_cat).cpu().numpy()
    full_bound = float(ROUND2_BOUND * (a_n[p["a_lin"]] * b_n[p["b_lin"]]).sum())

    c_bf16 = _fused(p, **bf)
    t_bf16 = time_us(lambda: _fused(p, **bf), dev)
    err_bf16 = float(torch.linalg.vector_norm((c_bf16 - exact).double()))

    budget = 0.25 * full_bound
    low, spent = low_precision_task_mask(a_n, b_n, p["a_lin"], p["b_lin"], budget)
    low_t = torch.from_numpy(low[None]).to(dev)
    c_ad = _fused(p, low=low_t, adaptive=True)
    t_ad = time_us(lambda: _fused(p, low=low_t, adaptive=True), dev)
    err_ad = float(torch.linalg.vector_norm((c_ad - exact).double()))
    out = dict(
        bs=bs, T=T,
        fp32=dict(us=t_fp32, fro_err=0.0, bound=0.0),
        bf16=dict(us=t_bf16, fro_err=err_bf16, bound=full_bound, wire_bytes_ratio=0.5),
        adaptive=dict(us=t_ad, fro_err=err_ad, bound=spent, budget=budget,
                      low_tasks=int(low.sum()), tasks=T),
        within_bounds=bool(err_bf16 <= full_bound and err_ad <= spent + 1e-12),
    )
    assert out["within_bounds"], (err_bf16, full_bound, err_ad, spent)
    return out


def _misaligned(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` whose data starts 4 bytes past a 16-byte boundary."""
    moved = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
    moved.copy_(x)
    return moved


def bench_engines(dev, T: int = 2048, nout: int = 256, n_blocks: int = 128,
                  bs_list=ENGINE_BS) -> list[dict]:
    """The 64 x 64 and 128 x 128 engines on one random task list per bs
    (on the card; the CPU has neither and times the plain version)."""
    rng = np.random.default_rng(5)
    gen = torch.Generator(device=dev).manual_seed(5)
    on_card = dev.type == "cuda"
    kernel = bsp.block_spmm_cuda if on_card else bsp.block_spmm_ref
    rows = []
    for bs in bs_list:
        A = torch.randn((n_blocks, bs, bs), generator=gen, device=dev)
        B = torch.randn((n_blocks, bs, bs), generator=gen, device=dev)
        a, b, c = _random_tasks(rng, n_blocks, T, nout)
        tasks = ops.task_arrays(a, b, c, nout, dev)
        A64, B64 = _misaligned(A), _misaligned(B)
        picked = bsp.tile_engine(bs, bs, bs, (A, B))
        out_picked = kernel(A, B, *tasks, nout)
        out_64 = kernel(A64, B64, *tasks, nout)
        us_picked = time_us(lambda: kernel(A, B, *tasks, nout), dev)
        us_64 = time_us(lambda: kernel(A64, B64, *tasks, nout), dev)
        us = dict(tile64=us_64, tile128=us_picked if picked == "tile128" else None)
        faster = "tile128" if us["tile128"] is not None and us["tile128"] < us_64 else "tile64"
        flops = 2.0 * T * bs**3
        rows.append(dict(bs=bs, T=T, picked=picked, faster=faster,
                         tile64_us=us_64, tile128_us=us["tile128"],
                         tile64_tflops=flops / us_64 / 1e6,
                         tile128_tflops=(flops / us["tile128"] / 1e6 if us["tile128"] else None),
                         bit_identical=bool(torch.equal(out_picked, out_64)),
                         smoke_only=not on_card))
        del A, B, A64, B64
    return rows


def bench_autotune(dev, engines: list[dict]) -> dict:
    """The reference's ``autotune`` section, answered with the engine times."""
    at = next((r for r in engines if r["bs"] == 128), engines[-1])
    card = torch_bench.card_line(dev).split(",")[0]
    return dict(
        bs=at["bs"],
        heuristic=ENGINE_TILES[at["picked"]],
        pre_tune_pick=ENGINE_TILES[at["picked"]],
        post_tune_pick=ENGINE_TILES[at["picked"]],
        winner=ENGINE_TILES[at["faster"]],
        roundtrip_ok=bool(all(r["picked"] == r["faster"] for r in engines)),
        key=f"{card}|{at['bs']}x{at['bs']}x{at['bs']}|float32",
        candidates=[dict(tiles=ENGINE_TILES[e], us=at[f"{e}_us"], error=None)
                    for e in ("tile128", "tile64") if at[f"{e}_us"] is not None],
        engines=engines,
        engines_bit_identical=bool(all(r["bit_identical"] for r in engines)),
        smoke_only=dev.type != "cuda",
    )


def run(dev, *, bs: int, T: int, spg_n: int, spg_bs: int, row_T: int, row_nout: int,
        engine_bs=ENGINE_BS, engine_T: int = 2048) -> dict:
    rows = bench_block_spmm(dev, spg_bs, row_T, row_nout)
    rows += bench_spgemm_end_to_end(dev, spg_n, spg_bs)
    for r in rows:
        tag = "  [smoke-only, plain version on the CPU]" if r["smoke_only"] else ""
        print(f"{r['name']:44s} {r['us']:10.1f} us  gflops={r['gflops']:.2f}{tag}")
    fvs = bench_fused_vs_staged(dev, bs, T)
    print(f"\nfused vs staged (bs={bs}, T={T}): staged {fvs['staged_us']:.1f} us, "
          f"fused {fvs['fused_us']:.1f} us ({fvs['speedup']:.2f}x), "
          f"bit_identical={fvs['bit_identical']}")
    prec = bench_precision_modes(dev, bs, T)
    for mode in ("fp32", "bf16", "adaptive"):
        r = prec[mode]
        print(f"precision {mode:8s}: {r['us']:10.1f} us  fro_err={r['fro_err']:.3e} "
              f"bound={r['bound']:.3e}")
    engines = bench_engines(dev, T=engine_T, bs_list=engine_bs)
    for r in engines:
        t128 = f"{r['tile128_us']:10.1f} us" if r["tile128_us"] else "         --"
        print(f"engines bs {r['bs']:3d}: tile64 {r['tile64_us']:10.1f} us  tile128 {t128}  "
              f"picked {r['picked']}  bit_identical={r['bit_identical']}")
    at = bench_autotune(dev, engines)
    assert at["engines_bit_identical"], "the 64 x 64 and 128 x 128 engines differ"
    return dict(rows=rows, fused_vs_staged=fvs, precision=prec, autotune=at)


def sizes(args) -> dict:
    """:func:`run`'s sizes: the reference's smoke / full, or the card's."""
    if args.card:
        return dict(bs=128, T=4096, spg_n=8192, spg_bs=128, row_T=8192, row_nout=1024,
                    engine_T=2048)
    if args.smoke:
        return dict(bs=32, T=64, spg_n=1024, spg_bs=64, row_T=32, row_nout=8, engine_T=64)
    return dict(bs=64, T=512, spg_n=4096, spg_bs=128, row_T=32, row_nout=8, engine_T=256)


def main(argv=None) -> int:
    args = torch_bench.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = torch_bench.device(args.device)
    kw = sizes(args)
    payload = dict(
        meta=dict(backend=dev.type, smoke=args.smoke, size=torch_bench.size_name(args),
                  bs=kw["bs"], T=kw["T"],
                  card=torch_bench.card_line(dev), commit=torch_bench.git_commit(),
                  note="CPU rows time the plain versions and are smoke_only: "
                       "they claim nothing about the card"),
        **run(dev, **kw),
    )
    torch_bench.write(payload, "kernel", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
