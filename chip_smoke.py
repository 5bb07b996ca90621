#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card, and check it.

    python3 chip_smoke.py              # on a machine with a CUDA card (H100)
    python3 chip_smoke.py --rehearse   # tiny sizes on the CPU, plain versions

Phases, one JSON line each:

1. ``build``    — ``nvcc`` builds every kernel of the path from ``src/repro_torch``.
2. ``kernel``   — each kernel on the card against its plain PyTorch version on
                  the same inputs (bit-identical on repeat, within tolerance),
                  timed with CUDA events beside the plain version and its bound.
3. ``multiply`` — the paper's Table 1 first row (banded A, N = 100,000,
                  half-bandwidth 3000, bs 128): ``multiply(A, A)``, with 64
                  sampled output blocks held against float64 host products.
4. ``sp2``      — the ``examples/purification.py`` pipeline at N = 8192,
                  bs 128: S -> inv_chol -> Z^T F Z -> sp2_purify -> D, held
                  against a float64 eigendecomposition.
5. the ``{"kernels": [...]}`` line, then ``{"ok": true, "device": {...}}``.

Any failed check raises, so the run exits non-zero and prints no ``ok`` line.
Without ``--rehearse`` it needs a CUDA card and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: fp32 FFMA rate (no tensor cores), HBM3 rate
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# per output block: |dC|_max <= REL * sum over its tasks of ||A_t||_F ||B_t||_F,
# because the kernel and the plain version sum each element in another order
REL = 1e-5

FULL = dict(mul_n=100_000, mul_hw=3000, mul_bs=128, time_n=8192,
            sp2_n=8192, sp2_bs=128, sp2_nocc=2560)
REHEARSAL = dict(mul_n=4096, mul_hw=300, mul_bs=32, time_n=1024,
                 sp2_n=512, sp2_bs=32, sp2_nocc=160)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


class Context:
    """The device under test, its synchronisation and its timer."""

    def __init__(self, torch, rehearse: bool):
        self.torch = torch
        self.rehearse = rehearse
        self.dev = torch.device("cpu" if rehearse else "cuda")

    def sync(self) -> None:
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()

    def time_ms(self, fn, reps: int) -> float:
        """Mean milliseconds of ``fn`` over ``reps`` warm calls (CUDA events on the card)."""
        fn()
        self.sync()
        if self.dev.type == "cuda":
            start = self.torch.cuda.Event(enable_timing=True)
            end = self.torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps


def gemm_bound(T, bm, bk, bn, a_blocks, b_blocks, num_out, itemsize):
    """Least time for the grouped GEMM on an H100: operations or bytes, whichever is larger.

    Operations: 2*T*bm*bn*bk at the fp32 FFMA rate.  Bytes: every distinct
    operand block read once, the task arrays (two int64 per task plus the
    int64 run offsets), and every output block written once in fp32.
    """
    ops = 2.0 * T * bm * bn * bk
    nbytes = ((a_blocks * bm * bk + b_blocks * bk * bn) * itemsize
              + 8 * (2 * T + num_out + 1) + 4 * num_out * bm * bn)
    t_ops, t_bytes = ops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return dict(
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        bound_arithmetic=(f"max(2*{T}*{bm}*{bn}*{bk} op / 67e12 op/s = {t_ops * 1e3:.4f} ms, "
                          f"{nbytes} B / 3.35e12 B/s = {t_bytes * 1e3:.4f} ms)"),
    )


def band_coords(nb: int, hw_blocks: int):
    """Morton-sorted block coordinates of a block band |I - J| <= hw_blocks."""
    import numpy as np
    from repro_torch.core.quadtree import morton_sort

    i = np.arange(nb)
    parts = [np.stack([i[(i + d >= 0) & (i + d < nb)], (i + d)[(i + d >= 0) & (i + d < nb)]], 1)
             for d in range(-hw_blocks, hw_blocks + 1)]
    coords = np.concatenate(parts).astype(np.int64)
    return coords[morton_sort(coords)]


def banded_matrix(ctx, n: int, hw: int, bs: int, seed: int):
    """Banded A (|i - j| <= hw, N x N) built from block coordinates, values
    from a seeded torch.Generator on the device (a dense N x N never exists)."""
    torch = ctx.torch
    from repro_torch.core import BSMatrix

    coords = band_coords(-(-n // bs), (hw + bs - 1) // bs)
    gen = torch.Generator(device=ctx.dev).manual_seed(seed)
    data = torch.randn((coords.shape[0], bs, bs), generator=gen, device=ctx.dev)
    r = torch.arange(bs, device=ctx.dev)
    c_t = torch.from_numpy(coords).to(ctx.dev)
    for k in range(0, coords.shape[0], 4096):  # mask the element band in slabs
        rows = (c_t[k:k + 4096, 0, None, None] * bs + r[None, :, None])
        cols = (c_t[k:k + 4096, 1, None, None] * bs + r[None, None, :])
        keep = ((rows - cols).abs() <= hw) & (rows < n) & (cols < n)
        data[k:k + 4096].mul_(keep)
    return BSMatrix(shape=(n, n), bs=bs, coords=coords, data=data)


def block_tolerance(a_data, b_data, a_idx, b_idx, run_ptr):
    """REL * sum_t ||A_t||_F ||B_t||_F per output block, on the device."""
    import torch as th

    na = th.linalg.matrix_norm(a_data.double())
    nb = th.linalg.matrix_norm(b_data.double())
    per_task = na[a_idx] * nb[b_idx]
    csum = th.cat([per_task.new_zeros(1), per_task.cumsum(0)])
    return REL * (csum[run_ptr[1:]] - csum[run_ptr[:-1]])


def phase_build(ctx) -> dict:
    if ctx.rehearse:
        out = dict(phase="build", skipped="rehearsal: no nvcc, plain versions only")
        emit(out)
        return out
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.load_library("block_spmm")
    secs = time.perf_counter() - t0
    log = build.build_logs.get("block_spmm", "")
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    out = dict(phase="build", seconds=secs, kernels=["block_spmm"], ptxas=ptxas[:6])
    emit(out)
    return out


def phase_kernel(ctx, sizes) -> dict:
    import numpy as np

    torch = ctx.torch
    from repro_torch.kernels import block_spmm as bsp
    from repro_torch.kernels import ops
    from repro_torch.core.spgemm import spgemm_symbolic

    kernel = bsp.block_spmm_ref if ctx.rehearse else bsp.block_spmm_cuda
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=ctx.dev).manual_seed(1)
    cases = []

    def random_case(name, bs, dtype, n_blocks, num_out, max_run, empty):
        lens = rng.integers(1, max_run + 1, num_out)
        lens[list(empty)] = 0
        c = np.repeat(np.arange(num_out), lens)
        a = rng.integers(0, n_blocks, c.size)
        b = rng.integers(0, n_blocks, c.size)
        A = torch.randn((n_blocks, bs, bs), generator=gen, device=ctx.dev).to(dtype)
        B = torch.randn((n_blocks, bs, bs), generator=gen, device=ctx.dev).to(dtype)
        return name, A, B, a, b, c, num_out

    # the timing case: the paper's band (half-bandwidth 3000 elements) at
    # bs 128, cut to N = 8192 so that the plain version's [T, bs, bs] gather fits
    mbs = sizes["mul_bs"]
    coords = band_coords(-(-sizes["time_n"] // mbs), (sizes["mul_hw"] + mbs - 1) // mbs)
    tasks = spgemm_symbolic(coords, coords)
    A = torch.randn((coords.shape[0], mbs, mbs), generator=gen, device=ctx.dev)
    timing = (f"band_bs{mbs}_f32", A, A, tasks.a_idx, tasks.b_idx, tasks.c_idx, tasks.num_out)
    cases.append(timing)
    empty = (3, 17, 63)  # empty rows, the last one a trailing trash row
    cases.append(random_case(f"runs_bs{mbs}_bf16", mbs, torch.bfloat16, 200, 64, 12, empty))
    cases.append(random_case("runs_bs32_f32", 32, torch.float32, 300, 64, 12, empty))
    cases.append(random_case("runs_bs24_f32", 24, torch.float32, 300, 64, 12, empty))

    results = []
    for name, A, B, a, b, c, num_out in cases:
        args = (A, B, *ops.task_arrays(a, b, c, num_out, ctx.dev), num_out)
        got = kernel(*args)
        again = kernel(*args)
        want = bsp.block_spmm_ref(*args)
        ctx.sync()
        identical = bool(torch.equal(got, again))
        err = (got - want).abs().flatten(1).amax(dim=1).double()
        tol = block_tolerance(A, B, args[2], args[3], args[4])
        ok = bool((err <= tol).all())
        empty_rows_zero = bool(not got[torch.from_numpy(np.setdiff1d(np.arange(num_out), c)).to(ctx.dev)].any())
        row = dict(case=name, dtype=str(A.dtype).replace("torch.", ""), bs=A.shape[1],
                   tasks=int(len(a)), num_out=num_out, max_abs_err=float(err.max()),
                   max_err_over_tol=float((err / tol.clamp_min(1e-300)).max()),
                   bit_identical_on_repeat=identical, empty_rows_zero=empty_rows_zero)
        check(identical, f"{name}: kernel output differs between two launches")
        check(ok, f"{name}: kernel disagrees with the plain version beyond tolerance")
        check(empty_rows_zero, f"{name}: rows without tasks are not zero")
        results.append(row)

    name, A, B, a, b, c, num_out = timing
    args = (A, B, *ops.task_arrays(a, b, c, num_out, ctx.dev), num_out)
    ms = ctx.time_ms(lambda: kernel(*args), reps=10)
    plain_ms = ctx.time_ms(lambda: bsp.block_spmm_ref(*args), reps=3)
    lhs, rhs = A[args[2]], B[args[3]]
    bmm_ms = ctx.time_ms(lambda: torch.bmm(lhs, rhs), reps=10)
    del lhs, rhs
    T = len(a)
    bound = gemm_bound(T, mbs, mbs, mbs, np.unique(a).size, np.unique(b).size, num_out, 4)
    timing_row = dict(case=name, tasks=T, ms=ms, plain_ms=plain_ms,
                      tflops=2.0 * T * mbs**3 / (ms * 1e-3) / 1e12,
                      bmm_yardstick_ms=bmm_ms,
                      bmm_yardstick="torch.bmm on the pre-gathered operands: the products only, no gather, no sum",
                      **bound)
    out = dict(phase="kernel", cases=results, timing=timing_row)
    emit(out)
    return out


def phase_multiply(ctx, sizes) -> dict:
    import numpy as np

    torch = ctx.torch
    from repro_torch.core import SymbolicCache, multiply
    from repro_torch.kernels import block_spmm as bsp
    from repro_torch.kernels import ops

    n, hw, bs = sizes["mul_n"], sizes["mul_hw"], sizes["mul_bs"]
    t0 = time.perf_counter()
    a = banded_matrix(ctx, n, hw, bs, seed=100)
    ctx.sync()
    build_s = time.perf_counter() - t0
    cache = SymbolicCache()
    if ctx.dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    bsp.launches = 0
    t0 = time.perf_counter()
    c = multiply(a, a, cache=cache)
    ctx.sync()
    first_s = time.perf_counter() - t0
    launches = bsp.launches
    expected = 0 if ctx.rehearse else 1
    check(launches == expected, f"multiply launched the kernel {launches} times, expected {expected}")
    peak = torch.cuda.max_memory_allocated() if ctx.dev.type == "cuda" else None
    tasks = cache.peek(("spgemm", a.structure_key, a.structure_key))
    T = tasks.num_tasks
    flops = 2.0 * T * bs**3

    # kernel time alone, on the uploaded task arrays (CUDA events)
    args = (a.data, a.data, *ops.task_arrays(tasks.a_idx, tasks.b_idx, tasks.c_idx,
                                            tasks.num_out, ctx.dev), tasks.num_out)
    kernel = bsp.block_spmm_ref if ctx.rehearse else bsp.block_spmm_cuda
    del c
    kernel_ms = ctx.time_ms(lambda: kernel(*args), reps=2)
    t0 = time.perf_counter()
    c = multiply(a, a, cache=cache)  # the symbolic phase is a cache hit now
    ctx.sync()
    warm_s = time.perf_counter() - t0

    # 64 sampled output blocks against float64 host products of the same blocks
    rng = np.random.default_rng(5)
    run_ptr = args[4].cpu().numpy()
    worst = 0.0
    for blk in rng.choice(tasks.num_out, size=min(64, tasks.num_out), replace=False):
        lo, hi = run_ptr[blk], run_ptr[blk + 1]
        ia = torch.from_numpy(tasks.a_idx[lo:hi]).to(ctx.dev)
        ib = torch.from_numpy(tasks.b_idx[lo:hi]).to(ctx.dev)
        A_t = a.data[ia].double().cpu().numpy()
        B_t = a.data[ib].double().cpu().numpy()
        want = np.einsum("tij,tjk->ik", A_t, B_t)
        tol = REL * float((np.linalg.norm(A_t, axis=(1, 2)) * np.linalg.norm(B_t, axis=(1, 2))).sum())
        err = float(np.abs(c.data[int(blk)].double().cpu().numpy() - want).max())
        check(err <= tol, f"multiply block {blk}: error {err} > tolerance {tol}")
        worst = max(worst, err / tol)
    bound = gemm_bound(T, bs, bs, bs, a.nnzb, a.nnzb, tasks.num_out, 4)
    out = dict(phase="multiply", n=n, half_bandwidth=hw, bs=bs, a_blocks=a.nnzb,
               a_gb=a.nnzb * bs * bs * 4 / 1e9, c_blocks=tasks.num_out,
               c_gb=tasks.num_out * bs * bs * 4 / 1e9, tasks=T, tflop=flops / 1e12,
               build_a_s=build_s, symbolic_s=cache.build_s, first_multiply_s=first_s,
               warm_multiply_s=warm_s, kernel_ms=kernel_ms,
               kernel_tflops=flops / (kernel_ms * 1e-3) / 1e12, **bound,
               max_memory_allocated=peak, launches=launches,
               sampled_blocks=int(min(64, tasks.num_out)), max_err_over_tol=worst)
    emit(out)
    return out


def _hamiltonian(n: int, nocc: int, seed: int):
    """Banded exponential-decay couplings plus a diagonal spread with a gap.

    Site energies: nocc of them (chosen at random) spread over [-2, -0.5],
    the rest over [0.5, 2]; couplings 0.3 exp(-0.5 |i - j|) x N(0, 1) for
    |i - j| <= 8, symmetrised.  S = I + 0.01 |H|.
    """
    import numpy as np

    rng = np.random.default_rng(seed)
    diag = np.empty(n)
    occ = rng.permutation(n)[:nocc]
    virt = np.setdiff1d(np.arange(n), occ)
    diag[occ] = rng.permutation(np.linspace(-2.0, -0.5, nocc))
    diag[virt] = rng.permutation(np.linspace(0.5, 2.0, n - nocc))
    h = np.zeros((n, n))
    i = np.arange(n)
    for d in range(1, 9):
        v = 0.3 * np.exp(-0.5 * d) * rng.standard_normal(n - d)
        h[i[:-d], i[d:]] = v
    h = (h + h.T) / 2 + np.diag(diag)
    s = np.eye(n) + 0.01 * np.abs(h)
    return h.astype(np.float32), s.astype(np.float32)


def phase_sp2(ctx, sizes) -> dict:
    import numpy as np

    torch = ctx.torch
    import repro_torch.core.spgemm as spgemm_mod
    from repro_torch.core import (BSMatrix, SymbolicCache, factorization_residual, inv_chol,
                                  multiply, sp2_purify)
    from repro_torch.kernels import block_spmm as bsp

    n, bs, nocc = sizes["sp2_n"], sizes["sp2_bs"], sizes["sp2_nocc"]
    h, s_dense = _hamiltonian(n, nocc, seed=7)
    f = BSMatrix.from_dense(h, bs, device=ctx.dev)
    s = BSMatrix.from_dense(s_dense, bs, device=ctx.dev)

    # count the multiplies with a non-empty task list, independently of the kernel
    numeric = spgemm_mod.spgemm_numeric
    nonempty = [0]

    def counting_numeric(a_data, b_data, tasks, **kw):
        nonempty[0] += tasks.num_tasks > 0
        return numeric(a_data, b_data, tasks, **kw)

    spgemm_mod.spgemm_numeric = counting_numeric
    bsp.launches = 0
    cache = SymbolicCache()
    t0 = time.perf_counter()
    z = inv_chol(s, cache=cache)
    resid = factorization_residual(s, z, cache=cache)
    ctx.sync()
    t1 = time.perf_counter()
    f_o = multiply(multiply(z.transpose(), f, cache=cache), z, cache=cache)
    # Gershgorin bounds from the blocks of F_o: diagonal +- off-diagonal |row| sums
    absrow = f_o.data.abs().sum(dim=2).double().cpu().numpy()  # [nnzb, bs]
    rows = (f_o.coords[:, 0, None] * bs + np.arange(bs)).ravel()
    rowsum = np.zeros(f_o.nblocks[0] * bs)
    np.add.at(rowsum, rows, absrow.ravel())
    diag = np.zeros_like(rowsum)
    on = np.nonzero(f_o.coords[:, 0] == f_o.coords[:, 1])[0]
    dblk = f_o.data[torch.from_numpy(on).to(ctx.dev)].diagonal(dim1=1, dim2=2).double().cpu().numpy()
    diag[(f_o.coords[on, 0, None] * bs + np.arange(bs)).ravel()] = dblk.ravel()
    radius = rowsum - np.abs(diag)
    lmin, lmax = float((diag - radius)[:n].min()), float((diag + radius)[:n].max())
    ctx.sync()
    t2 = time.perf_counter()
    d, stats = sp2_purify(f_o, nocc, lmin, lmax, idem_tol=1e-6, trunc_tau=1e-5, cache=cache)
    ctx.sync()
    t3 = time.perf_counter()
    spgemm_mod.spgemm_numeric = numeric
    launches, multiplies = bsp.launches, nonempty[0]
    expected = 0 if ctx.rehearse else multiplies
    check(launches == expected,
          f"kernel launches {launches} != non-empty multiplies {multiplies}")

    # checks: trace, idempotency, and D against a float64 eigendecomposition
    d64 = torch.from_numpy(d.to_dense()).to(ctx.dev, torch.float64)
    trace = float(d.data[torch.from_numpy(np.nonzero(d.coords[:, 0] == d.coords[:, 1])[0])
                         .to(ctx.dev)].double().diagonal(dim1=1, dim2=2).sum())
    idem = d64 @ d64 - d64
    fo64 = torch.from_numpy(f_o.to_dense()).to(ctx.dev, torch.float64)
    evals, evecs = torch.linalg.eigh(fo64)
    occ_vecs = evecs[:, :nocc]
    d_ref = occ_vecs @ occ_vecs.T
    out = dict(phase="sp2", n=n, bs=bs, nocc=nocc, lmin=lmin, lmax=lmax,
               homo_lumo_gap=float(evals[nocc] - evals[nocc - 1]),
               inv_chol_s=t1 - t0, factorization_residual=resid,
               congruence_and_bounds_s=t2 - t1, sp2_s=t3 - t2,
               iterations=stats.iterations, sp2_s_per_iteration=(t3 - t2) / stats.iterations,
               nnzb_history=stats.nnzb_history, d_blocks=d.nnzb,
               kernel_launches=launches, nonempty_multiplies=multiplies,
               trace_error=abs(trace - nocc),
               idempotency_fro=float(torch.linalg.matrix_norm(idem)),
               idempotency_max=float(idem.abs().max()),
               sp2_best_idempotency_fro=min(stats.idempotency_history),
               max_abs_d_minus_ref=float((d64 - d_ref).abs().max()))
    emit(out)
    check(out["trace_error"] <= 1e-3, "|trace(D) - nocc| > 1e-3")
    check(out["idempotency_max"] <= 1e-6, "max |D^2 - D| > 1e-6")
    check(out["max_abs_d_minus_ref"] <= 1e-4, "max |D - D_ref| > 1e-4")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rehearse", action="store_true",
                   help="tiny sizes on the CPU with the plain versions (no card, no nvcc)")
    args = p.parse_args(argv)

    import torch

    if not args.rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; use --rehearse for the CPU rehearsal", file=sys.stderr)
        return 2
    if not args.rehearse:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True)
        print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = Context(torch, args.rehearse)
    sizes = REHEARSAL if args.rehearse else FULL
    t0 = time.perf_counter()

    phase_build(ctx)
    kern = phase_kernel(ctx, sizes)
    mul = phase_multiply(ctx, sizes)
    sp2 = phase_sp2(ctx, sizes)

    timing = kern["timing"]
    max_err = max(c["max_abs_err"] for c in kern["cases"])
    emit({"kernels": [dict(
        name="block_spmm", route="cuda", source="src/repro_torch/kernels/csrc/block_spmm.cu",
        replaces="src/repro/kernels/block_spmm.py:38",
        launches=mul["launches"] + sp2["kernel_launches"], max_abs_err=max_err,
        ms=timing["ms"], plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
        bound_by=timing["bound_by"], library_ms=None)]})
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    if args.rehearse:
        emit({"ok": True, "rehearsal": True, "device": {"platform": "cpu", "kind": "cpu", "count": 0}})
    else:
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
