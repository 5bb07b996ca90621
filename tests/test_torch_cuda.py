"""The CUDA kernels on the card: built from the sources, held against their plain versions.

Marked ``gpu``: each test skips where no CUDA card is present (decided inside
the fixture, never at import).  On the card run
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import BSMatrix, multiply
from repro_torch.kernels import autotune
from repro_torch.kernels import block_spmm as bsp
from repro_torch.kernels import fused_leaf as fl
from repro_torch.kernels import ops

pytestmark = pytest.mark.gpu

# |dC|_max <= 1e-5 * sum_t ||A_t||_F ||B_t||_F per output block: the kernel
# and torch.bmm sum each element's products in different orders
REL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def tile_cache(tmp_path, monkeypatch):
    """An empty tile-autotuner cache of the test's own: no cache in the home
    directory moves the launches that name no engine."""
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    autotune.clear_memo()
    yield str(path)
    autotune.clear_memo()


def _tasks(rng, na, nb, nc, T, empty=()):
    """Sorted tasks over nc outputs; rows in ``empty`` get no task."""
    rows = np.setdiff1d(np.arange(nc), empty)
    c = np.sort(np.concatenate([rows, rng.choice(rows, T - rows.size)]))
    return rng.integers(0, na, c.size), rng.integers(0, nb, c.size), c


def _check(A, B, a, b, c, nc):
    dev = A.device
    args = (A, B, *ops.task_arrays(a, b, c, nc, dev), nc)
    before = bsp.launches
    got = bsp.block_spmm_cuda(*args)
    again = bsp.block_spmm_cuda(*args)
    want = bsp.block_spmm_ref(*args)
    torch.cuda.synchronize()
    assert bsp.launches == before + 2
    assert torch.equal(got, again), "kernel is not deterministic"
    na = torch.linalg.matrix_norm(A.double()).cpu().numpy()
    nb = torch.linalg.matrix_norm(B.double()).cpu().numpy()
    tol = np.zeros(nc)
    np.add.at(tol, c, REL * na[a] * nb[b])
    err = (got - want).abs().flatten(1).amax(dim=1).double().cpu().numpy()
    assert (err <= tol).all(), (err.max(), tol[err > tol][:4])
    return got


# blocks of at most 64 rows take TileRows (10: masked scalar loads), 96, 130
# and 192 (nine tiles) the 64 x 64 engine, 128, 256 and (128, 256, 128) the
# 128 x 128 one (256: four tiles a block)
@pytest.mark.parametrize("bm,bk,bn", [(8, 8, 8), (10, 10, 10), (16, 16, 16), (24, 24, 24),
                                      (16, 32, 8), (64, 16, 32), (128, 128, 128),
                                      (130, 70, 66), (128, 256, 128), (96, 96, 96),
                                      (192, 192, 192), (256, 256, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, bm, bk, bn, dtype):
    rng = np.random.default_rng(bm + bk + bn)
    A = torch.randn(7, bm, bk, device=cuda).to(dtype)
    B = torch.randn(5, bk, bn, device=cuda).to(dtype)
    a, b, c = _tasks(rng, 7, 5, 9, 40, empty=(2, 8))  # empty rows incl. a trailing one
    got = _check(A, B, a, b, c, 9)
    assert not got[2].any() and not got[8].any()


def test_multiply_goes_through_the_kernel(cuda):
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((300, 300)).astype(np.float32)
    dense[np.abs(np.subtract.outer(np.arange(300), np.arange(300))) > 60] = 0
    a = BSMatrix.from_dense(dense, 32)
    before = bsp.launches
    c = multiply(a, a)
    assert bsp.launches == before + 1
    np.testing.assert_allclose(c.to_dense(), dense.astype(np.float64) @ dense, rtol=1e-4, atol=1e-3)
    with pytest.raises(ValueError):  # off the card the kernel is refused
        multiply(BSMatrix.from_dense(dense, 32, device="cpu"), a, impl="kernel")


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    A = torch.randn(2, 16, 16, device=cuda)
    args = ops.task_arrays(np.array([0]), np.array([1]), np.array([0]), 1, cuda)
    with pytest.raises(TypeError):
        bsp.block_spmm_cuda(A.double(), A.double(), *args, 1)
    with pytest.raises(ValueError):
        bsp.block_spmm_cuda(A.transpose(1, 2), A, *args, 1)


# --- the fused leaf engine (kernels/csrc/fused_block_spmm.cu) ---------------

def _fused_problem(dev, rng, P, T, bm, bk, bn, dtype, rounds=2, cap=6, cap_u=5, num_out=9,
                   empty=(2, 8)):
    """Random stores/receive stacks for P workers and sorted tasks; rows in
    ``empty`` get no task; two padded tasks per worker aim past the last row."""
    R, cu = (rounds, cap_u) if rounds else (1, 1)
    t = lambda *s: torch.randn(*s, device=dev).to(dtype)  # noqa: E731
    stores = (t(P, cap, bm, bk), t(P, R, cu, bm, bk), t(P, cap, bk, bn), t(P, R, cu, bk, bn))
    idx = []
    for _ in range(2):
        src = rng.integers(0, rounds + 1, (P, T + 2))
        off = np.where(src == 0, rng.integers(0, cap, (P, T + 2)), rng.integers(0, cu, (P, T + 2)))
        idx += [src, off]
    rows = np.setdiff1d(np.arange(num_out), empty)
    c = np.concatenate([np.sort(rng.choice(rows, (P, T)), axis=1), np.full((P, 2), num_out)], 1)
    up = lambda x: torch.from_numpy(np.asarray(x, np.int64)).to(dev)  # noqa: E731
    run_ptr = up(fl.fused_task_runs(c, num_out))
    return stores + tuple(up(x) for x in idx) + (run_ptr, num_out)


def _fused_tolerance(args, on=None):
    """REL * sum over each output block's (on) tasks of ||A_t||_F ||B_t||_F."""
    a_store, a_recv, b_store, b_recv, a_src, a_off, b_src, b_off, run_ptr, num_out = args
    P, T = a_src.shape

    def norms(store, recv, src, off):
        ns = torch.linalg.matrix_norm(store.double())
        nr = torch.linalg.matrix_norm(recv.double())
        p = torch.arange(P, device=src.device)[:, None].expand_as(src)
        return torch.where(src == 0, ns[p, off.clamp(max=ns.shape[1] - 1)],
                           nr[p, (src - 1).clamp(min=0), off.clamp(max=nr.shape[2] - 1)])

    per = REL * norms(a_store, a_recv, a_src, a_off) * norms(b_store, b_recv, b_src, b_off)
    if on is not None:
        per = per * on
    csum = torch.cat([per.new_zeros(P, 1), per.cumsum(1)], 1)
    return csum.gather(1, run_ptr[:, 1:]) - csum.gather(1, run_ptr[:, :-1])


@pytest.mark.parametrize("bm,bk,bn", [(8, 8, 8), (10, 10, 10), (24, 24, 24), (16, 32, 8),
                                      (128, 128, 128), (130, 70, 66), (96, 96, 96),
                                      (192, 192, 192), (256, 256, 256)])
@pytest.mark.parametrize("mode", ["fp32", "bf16", "adaptive", "masked"])
def test_fused_kernel_matches_plain_version(cuda, bm, bk, bn, mode):
    rng = np.random.default_rng(bm * 7 + bk + bn)
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    args = _fused_problem(cuda, rng, 3, 40, bm, bk, bn, dtype)
    kw = {}
    if mode == "adaptive":
        kw = dict(low=torch.from_numpy(rng.random((3, 42)) < 0.5).to(cuda), adaptive=True)
    if mode == "masked":
        on = rng.random((3, 42)) < 0.7
        on[:, 1:4] = [False, True, False]
        kw = dict(on=torch.from_numpy(on).to(cuda))
    before = fl.launches
    got = fl.fused_block_spmm_cuda(*args, **kw)
    again = fl.fused_block_spmm_cuda(*args, **kw)
    want = fl.fused_block_spmm_ref(*args, **kw)
    torch.cuda.synchronize()
    assert fl.launches == before + 2
    assert torch.equal(got, again), "kernel is not deterministic"
    tol = _fused_tolerance(args, kw.get("on"))
    err = (got - want).abs().flatten(2).amax(dim=2).double()
    assert (err <= tol).all(), (float(err.max()), float(tol[err > tol][:4].min()))
    assert not got[:, [2, 8]].any()  # rows without tasks are zero
    if mode == "adaptive":  # the low flags act: far nearer the rounded plain version than rounding moves it
        shift = float((want - fl.fused_block_spmm_ref(*args)).abs().max())
        assert 0 < shift and float(err.max()) * 8 <= shift, (float(err.max()), shift)


def _staged_operands(args):
    """The staged path's operands of a fused problem: per worker [own | recv
    rounds] concatenated into one stack, and one flat task list."""
    a_store, a_recv, b_store, b_recv, a_src, a_off, b_src, b_off, run_ptr, num_out = args
    dev = a_store.device
    P, cap = a_store.shape[:2]
    R, cu = a_recv.shape[1:3]
    L = cap + R * cu
    a_all = torch.cat([a_store, a_recv.flatten(1, 2)], 1).flatten(0, 1).contiguous()
    b_all = torch.cat([b_store, b_recv.flatten(1, 2)], 1).flatten(0, 1).contiguous()
    lin = lambda src, off: torch.where(src == 0, off, cap + (src - 1) * cu + off)  # noqa: E731
    rp = run_ptr.cpu().numpy()
    p, t = np.nonzero(np.arange(a_src.shape[1])[None] < rp[:, -1:])
    c = np.concatenate([np.repeat(np.arange(num_out), np.diff(rp[q])) for q in range(P)])
    pt = (torch.from_numpy(p).to(dev), torch.from_numpy(t).to(dev))
    a = (pt[0] * L + lin(a_src, a_off)[pt]).cpu().numpy()
    b = (pt[0] * L + lin(b_src, b_off)[pt]).cpu().numpy()
    return a_all, b_all, a, b, p * num_out + c, P * num_out


def test_fused_kernel_bit_identical_to_staged_kernel_and_masked_all_on(cuda):
    rng = np.random.default_rng(3)
    args = _fused_problem(cuda, rng, 4, 60, 128, 128, 128, torch.float32)
    fused = fl.fused_block_spmm_cuda(*args)
    all_on = fl.fused_block_spmm_cuda(*args, on=torch.ones(args[4].shape, dtype=torch.bool, device=cuda))
    assert torch.equal(fused, all_on)
    staged = ops.block_spmm(*_staged_operands(args), impl="kernel")
    assert torch.equal(fused.reshape(staged.shape), staged)


def _misaligned(x):
    """A contiguous copy of ``x`` whose data starts 4 bytes past a 16-byte
    boundary: the kernels then take the 64 x 64 engine at bm above 64, and
    TileRows' masked scalar loads at bm 64 or less."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    out = flat.view(x.shape)
    out.copy_(x)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


@pytest.mark.parametrize("bs", [128, 130])
def test_engines_and_paths_agree_bit_for_bit(cuda, bs):
    """fp32 fused == staged (concatenated stacks through block_spmm), and at
    bs 128 the 128 x 128 engine == the 64 x 64 engine on the same inputs:
    one fmaf chain per element whatever the kernel and the tile shape."""
    rng = np.random.default_rng(bs)
    args = _fused_problem(cuda, rng, 4, 60, bs, bs, bs, torch.float32)
    fused = fl.fused_block_spmm_cuda(*args)
    a_all, b_all, a, b, c, nc = _staged_operands(args)
    staged = ops.block_spmm(a_all, b_all, a, b, c, nc, impl="kernel")
    assert torch.equal(fused.reshape(staged.shape), staged)
    small = ops.block_spmm(_misaligned(a_all), _misaligned(b_all), a, b, c, nc, impl="kernel")
    assert torch.equal(small, staged)
    moved = tuple(_misaligned(t) for t in args[:4]) + args[4:]
    assert torch.equal(fl.fused_block_spmm_cuda(*moved), fused)


def test_fused_kernel_without_rounds_and_without_tasks(cuda):
    rng = np.random.default_rng(4)
    args = _fused_problem(cuda, rng, 1, 20, 24, 24, 24, torch.float32, rounds=0)
    got = fl.fused_block_spmm_cuda(*args)
    err = (got - fl.fused_block_spmm_ref(*args)).abs().flatten(2).amax(dim=2).double()
    assert (err <= _fused_tolerance(args)).all()
    empty = _fused_problem(cuda, rng, 2, 0, 16, 16, 16, torch.float32, empty=())
    assert not fl.fused_block_spmm_cuda(*empty).any()


def test_dist_multiply_goes_through_the_fused_kernel(cuda):
    from repro_torch.core.distributed import make_worker_mesh
    from repro_torch.dist import PlanCache, dist_multiply, dist_spamm, scatter

    rng = np.random.default_rng(5)
    dist = np.abs(np.subtract.outer(np.arange(600), np.arange(600)))
    dense = (rng.standard_normal((600, 600)) * np.exp(-0.05 * dist)).astype(np.float32)
    a = BSMatrix.from_dense(dense, 32, prune_tol=1e-6)
    d = scatter(a, make_worker_mesh(4))
    cache = PlanCache()
    before = fl.launches
    c = dist_multiply(d, d, cache)
    assert fl.launches == before + 1
    assert torch.equal(c.gather().data, multiply(a, a).data)  # same fmaf chains
    s, err = dist_spamm(d, d, 1e-3 * a.frobenius_norm() ** 2, cache)
    assert fl.launches == before + 2 and err > 0
    exact = dense.astype(np.float64) @ dense
    assert np.linalg.norm(s.gather().to_dense() - exact) <= err



def test_outer_launch_matches_plain_version_on_the_card(cuda):
    """The outer multiply's one flattened ``block_spmm`` launch for all 8
    workers against ``impl="ref"``, element for element within the GEMM
    tolerance, with several exchange offsets; bit-identical on repeat."""
    from repro_torch.core.distributed import dist_spgemm_outer, make_worker_mesh, unshard_result
    from repro_torch.core.outer import make_outer_plan

    rng = np.random.default_rng(8)
    dist = np.abs(np.subtract.outer(np.arange(768), np.arange(768)))
    dense = (rng.standard_normal((768, 768)) * (dist <= 100)).astype(np.float32)
    a = BSMatrix.from_dense(dense, 32)
    plan = make_outer_plan(a.coords, a.coords, 8, 32)
    assert len(plan.offsets) >= 2
    mesh = make_worker_mesh(8)
    before = bsp.launches
    got = dist_spgemm_outer(plan, a.data, a.data, mesh)
    again = dist_spgemm_outer(plan, a.data, a.data, mesh)
    torch.cuda.synchronize()
    assert bsp.launches == before + 2
    assert torch.equal(got, again)
    want = dist_spgemm_outer(plan, a.data, a.data, mesh, impl="ref")
    assert bsp.launches == before + 2
    t = plan.tasks
    na = torch.linalg.matrix_norm(a.data.double()).cpu().numpy()
    tol = np.zeros(t.num_out)
    np.add.at(tol, t.c_idx, REL * na[t.a_idx] * na[t.b_idx])
    g = unshard_result(plan, got, a.shape, 32).data
    w = unshard_result(plan, want, a.shape, 32).data
    err = (g - w).abs().flatten(1).amax(dim=1).double().cpu().numpy()
    assert (err <= tol).all(), err.max()


def test_tracer_sync_spans_measure_the_kernel(cuda):
    """A span around a kernel launch measures the kernel with ``sync=True``
    and only the launch with ``sync=False``."""
    from repro_torch.obs import Tracer

    rng = np.random.default_rng(9)
    A = torch.randn((64, 128, 128), device=cuda)
    a, b, c = _tasks(rng, 64, 64, 512, 24576)
    args = (A, A, *ops.task_arrays(a, b, c, 512, cuda), 512)
    bsp.block_spmm_cuda(*args)
    torch.cuda.synchronize()

    def span_s(sync):
        tr = Tracer(sync=sync)
        durs = []
        for _ in range(5):
            torch.cuda.synchronize()
            with tr.span("dispatch") as sp:
                tr.sync(bsp.block_spmm_cuda(*args))
            durs.append(sp.dur)
        torch.cuda.synchronize()
        return float(np.median(durs))

    synced, unsynced = span_s(True), span_s(False)
    assert synced > 2 * unsynced, (synced, unsynced)


def test_cuda_memory_stats_reads_the_allocator(cuda):
    from repro_torch.obs import cuda_memory_stats

    x = torch.empty(1 << 24, device=cuda)  # 64 MiB
    stats = cuda_memory_stats()
    assert [s["device"] for s in stats] == list(range(torch.cuda.device_count()))
    mine = stats[cuda.index or 0]
    assert mine["allocated_bytes.all.current"] == torch.cuda.memory_allocated(cuda)
    assert mine["allocated_bytes.all.peak"] >= x.numel() * 4
    del x


@pytest.mark.parametrize("bm,bk,bn,offset", [(64, 64, 64, 0), (96, 96, 96, 0), (128, 128, 128, 0),
                                             (130, 130, 130, 0), (128, 256, 128, 0),
                                             (256, 256, 256, 0), (128, 128, 128, 1),
                                             (8, 256, 384, 0), (24, 24, 24, 1), (32, 10, 32, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_tile_engine_mirror_matches_the_kernel(cuda, bm, bk, bn, offset, dtype):
    """The host mirror of ``tile_gemm::pick_engine`` names the engine the
    kernel launched, read from the kernel's name in a ``torch.profiler``
    trace (``Tile128`` / ``TileRows`` / ``Tile64`` template arguments, or
    TileTC's own kernel); ``offset`` shifts A by one element so its stack is
    no longer 16-byte aligned."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(10)
    base = torch.randn(8 * bm * bk + offset, device=cuda).to(dtype)
    A = base[offset:].view(8, bm, bk)
    B = torch.randn((8, bk, bn), device=cuda).to(dtype)
    a, b, c = _tasks(rng, 8, 8, 16, 40)
    args = (A, B, *ops.task_arrays(a, b, c, 16, cuda), 16)
    # a profiler session on the card sometimes records no kernel at all: the
    # launch is profiled again, a few times at most, until one is recorded
    names = []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            bsp.block_spmm_cuda(*args)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if "block_spmm" in e.name]
        if names:
            break
    tags = {"Tile128": "tile128", "TileRows": "tilerows", "Tile64": "tile64", "_tc_kernel": "tiletc"}
    launched = {e for tag, e in tags.items() for nm in names if tag in nm}
    assert launched == {bsp.tile_engine(bm, bk, bn, (A, B))}, names


def _valid_engines(bm, bk, bn, tensors):
    return [e for e in bsp.ENGINES if bsp.engine_takes(e, bm, bk, bn, tensors)]


def _engines_agree(A, B, a, b, c, nc):
    """Every engine that takes the shape, forced on the same inputs: the FFMA
    engines the same bits (one fmaf chain per element), TileTC (bf16 stores
    on the tensor cores, summed in their order) its own; each equal on
    repeat and within the plain version's limit, the rule's launch equal to
    its engine's."""
    args = (A, B, *ops.task_arrays(a, b, c, nc, A.device), nc)
    bm, bk, bn = A.shape[1], A.shape[2], B.shape[2]
    engines = _valid_engines(bm, bk, bn, (A, B))
    outs = {}
    for e in engines:
        outs[e] = bsp.block_spmm_cuda(*args, engine=e)
        assert torch.equal(outs[e], bsp.block_spmm_cuda(*args, engine=e)), e
    got = _check(A, B, a, b, c, nc)  # the rule's engine, against the plain version
    assert torch.equal(outs[bsp.tile_engine(bm, bk, bn, (A, B))], got)
    ffma = [e for e in engines if e != "tiletc"]
    for e in ffma:
        assert torch.equal(outs[e], outs[ffma[0]]), (e, float((outs[e] - outs[ffma[0]]).abs().max()))
    want = bsp.block_spmm_ref(*args)
    tol = torch.from_numpy(_tolerance(A, B, a, b, c, nc)).to(A.device)
    for e, out in outs.items():
        assert ((out - want).abs().flatten(1).amax(1).double() <= tol).all(), e
    return engines, got


def _tolerance(A, B, a, b, c, nc):
    """REL * sum over each output block's tasks of ||A_t||_F ||B_t||_F (host)."""
    na = torch.linalg.matrix_norm(A.double()).cpu().numpy()
    nb = torch.linalg.matrix_norm(B.double()).cpu().numpy()
    tol = np.zeros(nc)
    np.add.at(tol, c, REL * na[a] * nb[b])
    return tol


@pytest.mark.parametrize("bs", [16, 24, 32, 48, 64, 96])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_engines_agree_bit_for_bit_on_small_blocks(cuda, bs, dtype):
    """TileRows (bm <= 64) and Tile64 forced on the same tasks give the same
    bits at every small block size, aligned, off a 16-byte boundary, with a
    ragged bk and bn, and at bn 200; TileTC (bf16, bm >= 64) its own bits,
    within the same limit; empty runs are zeros in every engine."""
    rng = np.random.default_rng(bs)
    A = torch.randn(30, bs, bs, device=cuda).to(dtype)
    B = torch.randn(30, bs, bs, device=cuda).to(dtype)
    a, b, c = _tasks(rng, 30, 30, 37, 300, empty=(0, 5, 17, 36))
    engines, got = _engines_agree(A, B, a, b, c, 37)
    assert ("tilerows" in engines) == (bs <= 64) and "tile64" in engines
    assert ("tiletc" in engines) == (dtype == torch.bfloat16 and bs >= 64)
    assert not got[[0, 5, 17, 36]].any()
    _engines_agree(_misaligned(A), _misaligned(B), a, b, c, 37)
    ragged = torch.randn(30, bs, 10, device=cuda).to(dtype), torch.randn(30, 10, bs + 3, device=cuda).to(dtype)
    _engines_agree(*ragged, a, b, c, 37)
    # bn above 64: TileRows' 128-row tile with 8 x 8 registers a thread, two column tiles
    wide = torch.randn(30, bs, 48, device=cuda).to(dtype), torch.randn(30, 48, 200, device=cuda).to(dtype)
    _engines_agree(*wide, a, b, c, 37)
    _engines_agree(_misaligned(wide[0]), wide[1], a, b, c, 37)


def test_engines_agree_on_the_grouped_gemm_tasks(cuda):
    """The dropless grouped GEMM's 8-row tiles: tiles that span groups (one
    task per group), empty groups, a tile past 8 packed blocks; TileRows ==
    Tile64 bit for bit and within the plain version's limit."""
    sizes = [3, 2, 11, 0, 30, 0, 0, 45, 1, 70]
    a, b, c, lo, hi = ops.grouped_gemm_tasks(sizes, 8)
    assert len(b) > c.max() + 1  # boundary tiles
    gen = torch.Generator(device=cuda).manual_seed(3)
    K, N = 96, 160
    x = torch.randn((sum(sizes) + (-sum(sizes)) % 8, K), generator=gen, device=cuda)
    rows = torch.arange(8, device=cuda)
    sel = (rows[None] >= torch.from_numpy(lo).to(cuda)[:, None]) & (rows[None] < torch.from_numpy(hi).to(cuda)[:, None])
    A = (x.view(-1, 8, K)[torch.from_numpy(a).to(cuda)] * sel[:, :, None]).contiguous()
    W = torch.randn((len(sizes), K, N), generator=gen, device=cuda)
    for dtype in (torch.float32, torch.bfloat16):
        engines, _ = _engines_agree(A.to(dtype), W.to(dtype), np.arange(len(a)), b, c, int(c.max()) + 1)
        assert engines == ["tile64", "tilerows"]


@pytest.mark.parametrize("bs", [8, 24, 32, 64])
@pytest.mark.parametrize("mode", ["fp32", "bf16", "adaptive", "masked"])
def test_fused_engines_agree_bit_for_bit(cuda, bs, mode):
    """The fused kernel through every engine that takes the shape, on the
    same inputs: the same bits, repeat-identical, within the plain version's
    limit; the masked path with every task on equals the unmasked one."""
    rng = np.random.default_rng(bs * 11)
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    args = _fused_problem(cuda, rng, 3, 60, bs, bs, bs, dtype, num_out=19, empty=(2, 8, 9, 18))
    kw = {}
    if mode == "adaptive":
        kw = dict(low=torch.from_numpy(rng.random((3, 62)) < 0.5).to(cuda), adaptive=True)
    if mode == "masked":
        on = rng.random((3, 62)) < 0.7
        on[:, 1:4] = [False, True, False]
        kw = dict(on=torch.from_numpy(on).to(cuda))
    engines = _valid_engines(bs, bs, bs, args[:4])
    outs = [fl.fused_block_spmm_cuda(*args, **kw, engine=e) for e in engines]
    again = fl.fused_block_spmm_cuda(*args, **kw)
    want = fl.fused_block_spmm_ref(*args, **kw)
    torch.cuda.synchronize()
    # TileTC takes bf16 stores of 64 rows and more, and sums in its own order
    assert engines == ["tile64", "tilerows"] + (["tiletc"] if mode == "bf16" and bs >= 64 else [])
    assert torch.equal(outs[engines.index(bsp.tile_engine(bs, bs, bs, args[:4]))], again)
    tol = _fused_tolerance(args, kw.get("on"))
    for e, out in zip(engines, outs, strict=True):
        if e != "tiletc":
            assert torch.equal(out, outs[0]), e
        assert ((out - want).abs().flatten(2).amax(dim=2).double() <= tol).all(), e
    err = (again - want).abs().flatten(2).amax(dim=2).double()
    assert (err <= tol).all()
    assert not again[:, [2, 8, 9, 18]].any()
    if mode == "fp32":
        all_on = torch.ones(args[4].shape, dtype=torch.bool, device=cuda)
        assert torch.equal(fl.fused_block_spmm_cuda(*args, on=all_on), again)


def test_fused_equals_staged_at_bs_64_through_every_engine(cuda):
    rng = np.random.default_rng(64)
    args = _fused_problem(cuda, rng, 4, 80, 64, 64, 64, torch.float32)
    a_all, b_all, a, b, c, nc = _staged_operands(args)
    staged = ops.block_spmm(a_all, b_all, a, b, c, nc, impl="kernel")
    for e in ("tile64", "tilerows"):
        fused = fl.fused_block_spmm_cuda(*args, engine=e)
        assert torch.equal(fused.reshape(staged.shape), staged), e
        tasks = ops.task_arrays(a, b, c, nc, cuda)
        assert torch.equal(bsp.block_spmm_cuda(a_all, b_all, *tasks, nc, engine=e), staged), e


def test_empty_runs_write_zeros_in_every_engine(cuda):
    """A tile whose packed blocks have no task at all, and a kernel with no
    task: zeros (the output is allocated with torch.empty)."""
    for bs in (8, 32, 64, 128):
        A = torch.randn(4, bs, bs, device=cuda)
        c = np.array([0, 0, 19])  # blocks 1 .. 18 empty: whole TileRows tiles
        args = (A, A, *ops.task_arrays(np.array([0, 1, 2]), np.array([3, 2, 1]), c, 20, cuda), 20)
        for e in _valid_engines(bs, bs, bs, (A,)):
            out = bsp.block_spmm_cuda(*args, engine=e)
            assert not out[1:19].any() and out[0].any() and out[19].any(), (bs, e)
        none = ops.task_arrays(np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int64), 9, cuda)
        for e in _valid_engines(bs, bs, bs, (A,)):
            assert not bsp.block_spmm_cuda(A, A, *none, 9, engine=e).any()


@pytest.mark.parametrize("bm", [64, 107, 128, 150, 200])
@pytest.mark.parametrize("bk,bn", [(1024, 2048), (40, 200)])
def test_tiletc_matches_the_plain_versions(cuda, bm, bk, bn):
    """TileTC (bf16 stores on the tensor cores) at one to four warpgroups of
    rows, a ragged last warpgroup, a ragged bk and bn: ``block_spmm`` and the
    fused kernel (three workers, receive rounds) within the plain versions'
    limit, both bit-identical on repeat, the fused kernel bit-identical to
    the staged path (concatenated stacks through ``block_spmm``), empty runs
    zeros; every launch on TileTC."""
    rng = np.random.default_rng(bm + bk)
    A = torch.randn(5, bm, bk, device=cuda).to(torch.bfloat16)
    B = (torch.randn(4, bk, bn, device=cuda) * bk**-0.5).to(torch.bfloat16)
    a, b, c = _tasks(rng, 5, 4, 7, 16, empty=(2, 6))
    before = dict(bsp.launches_by_tiles), dict(fl.launches_by_tiles)
    got = _check(A, B, a, b, c, 7)
    assert not got[[2, 6]].any()
    args = _fused_problem(cuda, rng, 3, 12, bm, bk, bn, torch.bfloat16, cap=3, cap_u=2, num_out=5,
                          empty=(1, 4))
    fused = fl.fused_block_spmm_cuda(*args)
    again = fl.fused_block_spmm_cuda(*args)
    want = fl.fused_block_spmm_ref(*args)
    a_all, b_all, sa, sb, sc, snc = _staged_operands(args)
    staged = ops.block_spmm(a_all, b_all, sa, sb, sc, snc, impl="kernel")
    torch.cuda.synchronize()
    assert torch.equal(fused, again)
    assert torch.equal(fused.reshape(staged.shape), staged)
    err = (fused - want).abs().flatten(2).amax(dim=2).double()
    assert (err <= _fused_tolerance(args)).all(), float(err.max())
    assert not fused[:, [1, 4]].any()
    tc = ("tiletc", 1)
    assert bsp.launches_by_tiles[tc] - before[0].get(tc, 0) == 3
    assert fl.launches_by_tiles[tc] - before[1].get(tc, 0) == 2


def test_tiletc_empty_runs_and_no_tasks_write_zeros(cuda):
    """Whole tiles with no task, a kernel with no task, and a fused launch
    whose receive stacks hold no block: zeros where no task writes (the
    output is allocated with torch.empty)."""
    A = torch.randn(4, 128, 64, device=cuda).to(torch.bfloat16)
    B = torch.randn(4, 64, 256, device=cuda).to(torch.bfloat16)
    c = np.array([0, 0, 19])
    args = (A, B, *ops.task_arrays(np.array([0, 1, 2]), np.array([3, 2, 1]), c, 20, cuda), 20)
    out = bsp.block_spmm_cuda(*args)
    assert bsp.tile_engine(128, 64, 256, (A, B)) == "tiletc"
    assert not out[1:19].any() and out[0].any() and out[19].any()
    none = ops.task_arrays(np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int64), 9, cuda)
    assert not bsp.block_spmm_cuda(A, B, *none, 9).any()
    rng = np.random.default_rng(6)
    args = _fused_problem(cuda, rng, 2, 10, 128, 64, 256, torch.bfloat16, rounds=0)  # own stores only
    empty_recv = (args[0], args[1][:, :0], args[2], args[3][:, :0]) + args[4:]
    assert not empty_recv[1].numel() and not empty_recv[3].numel()
    got = fl.fused_block_spmm_cuda(*empty_recv)
    err = (got - fl.fused_block_spmm_ref(*args)).abs().flatten(2).amax(dim=2).double()
    assert (err <= _fused_tolerance(args)).all()
    assert not got[:, [2, 8]].any()


def test_forced_engine_that_does_not_take_the_shape_raises(cuda):
    A = torch.randn(2, 96, 96, device=cuda)
    args = ops.task_arrays(np.array([0]), np.array([1]), np.array([0]), 1, cuda)
    before = bsp.launches
    with pytest.raises(ValueError, match="tilerows"):
        bsp.block_spmm_cuda(A, A, *args, 1, engine="tilerows")
    with pytest.raises(ValueError, match="tile128"):
        bsp.block_spmm_cuda(A[:, :64, :64].contiguous(), A[:, :64, :64].contiguous(), *args, 1,
                            engine="tile128")
    with pytest.raises(ValueError):
        bsp.block_spmm_cuda(A, A, *args, 1, engine="tile32")
    assert bsp.launches == before


# --- the tile autotuner's (engine, pack) pairs ------------------------------


def _one_worker(A, B, a, b, c, nc):
    """A ``block_spmm`` task list as one worker's fused-kernel arguments: the
    operands in the worker's own store, an unused one-block receive stack."""
    dev = A.device
    a_idx, b_idx, run_ptr = ops.task_arrays(a, b, c, nc, dev)
    zero = torch.zeros_like(a_idx)[None]
    return (A[None], A.new_zeros((1, 1, 1) + tuple(A.shape[1:])), B[None],
            B.new_zeros((1, 1, 1) + tuple(B.shape[1:])), zero, a_idx[None], zero.clone(),
            b_idx[None], run_ptr[None], nc)


def _tiles_case(dev, case, dtype):
    """(A, B, a, b, c, nc) of the Morton band, a random list or the grouped GEMM."""
    rng = np.random.default_rng(len(case))
    if case.startswith("band"):
        from repro_torch.core.quadtree import morton_sort
        from repro_torch.core.spgemm import spgemm_symbolic

        bs, nb, hw = int(case[7:]), 24, 3
        coords = np.array([(i, j) for i in range(nb) for j in range(nb) if abs(i - j) <= hw])
        coords = coords[morton_sort(coords)]
        tasks = spgemm_symbolic(coords, coords)
        A = torch.randn((len(coords), bs, bs), device=dev).to(dtype)
        return A, A, tasks.a_idx, tasks.b_idx, tasks.c_idx, tasks.num_out
    if case.startswith("random"):
        bs = int(case[9:])
        A = torch.randn(40, bs, bs, device=dev).to(dtype)
        B = torch.randn(40, bs, bs, device=dev).to(dtype)
        return (A, B, *_tasks(rng, 40, 40, 53, 400, empty=(0, 7, 52)), 53)
    sizes = [3, 2, 11, 0, 30, 0, 0, 45, 1, 70, 9, 17]  # the grouped GEMM, bm 8, bn 160
    a, b, c, lo, hi = ops.grouped_gemm_tasks(sizes, 8)
    K, N = 96, 160
    x = torch.randn((sum(sizes) + (-sum(sizes)) % 8, K), device=dev)
    rows = torch.arange(8, device=dev)
    sel = (rows[None] >= torch.from_numpy(lo).to(dev)[:, None]) & (rows[None] < torch.from_numpy(hi).to(dev)[:, None])
    A = (x.view(-1, 8, K)[torch.from_numpy(a).to(dev)] * sel[:, :, None]).contiguous().to(dtype)
    W = torch.randn((len(sizes), K, N), device=dev).to(dtype)
    return A, W, np.arange(len(a)), b, c, int(c.max()) + 1


@pytest.mark.parametrize("case", ["band_bs8", "band_bs24", "band_bs64", "random_bs8",
                                  "random_bs16", "random_bs32", "random_bs64", "grouped"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_tiles_candidate_is_bit_for_bit_the_rule(cuda, case, dtype):
    """Every ``(engine, pack)`` the tuner may pick, forced in both kernels on
    the same tasks: the rule's bits (the rule's launch within the plain
    version's limit), the fused kernel's equal to ``block_spmm``'s; at a
    TileTC shape (bf16, bs 64) the only candidate is TileTC's own."""
    A, B, a, b, c, nc = _tiles_case(cuda, case, dtype)
    bm, bk, bn = A.shape[1], A.shape[2], B.shape[2]
    want = _check(A, B, a, b, c, nc)  # engine=None with an empty cache: the rule
    args = (A, B, *ops.task_arrays(a, b, c, nc, cuda), nc)
    fargs = _one_worker(A, B, a, b, c, nc)
    cands = autotune.candidate_tiles(bm, bk, bn, (A, B))
    assert autotune.heuristic_tiles(bm, bk, bn, (A, B)) in cands
    if bsp.engine_takes("tiletc", bm, bk, bn, (A, B)):  # bf16 at bm 64: TileTC's bits alone
        assert cands == [("tiletc", 1)]
    else:
        assert ("tilerows", bsp.rows_pack(bm, bn)) in cands and ("tilerows", 1) in cands
    for e, p in cands:
        assert torch.equal(bsp.block_spmm_cuda(*args, engine=e, pack=p), want), (e, p)
        assert torch.equal(fl.fused_block_spmm_cuda(*fargs, engine=e, pack=p)[0], want), (e, p)


@pytest.mark.parametrize("bs", [8, 24, 64])
@pytest.mark.parametrize("mode", ["fp32", "bf16", "adaptive", "masked"])
def test_fused_tiles_candidates_agree_across_workers_and_rounds(cuda, bs, mode):
    """The fused kernel on three workers with receive rounds, every pack of
    TileRows against the rule's launch, in every precision mode."""
    rng = np.random.default_rng(bs * 13)
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    args = _fused_problem(cuda, rng, 3, 60, bs, bs, bs, dtype, num_out=37, empty=(0, 9, 36))
    kw = {}
    if mode == "adaptive":
        kw = dict(low=torch.from_numpy(rng.random((3, 62)) < 0.5).to(cuda), adaptive=True)
    if mode == "masked":
        kw = dict(on=torch.from_numpy(rng.random((3, 62)) < 0.7).to(cuda))
    want = fl.fused_block_spmm_cuda(*args, **kw)
    for e, p in autotune.candidate_tiles(bs, bs, bs, args[:4]):
        assert torch.equal(fl.fused_block_spmm_cuda(*args, **kw, engine=e, pack=p), want), (e, p)


def test_pack_out_of_range_is_refused_before_the_launch(cuda):
    A = torch.randn(3, 8, 8, device=cuda)
    W = torch.randn(3, 128, 128, device=cuda)
    tasks = ops.task_arrays(np.array([0, 1]), np.array([1, 2]), np.array([0, 1]), 2, cuda)
    fargs = _one_worker(A, A, np.array([0, 1]), np.array([1, 2]), np.array([0, 1]), 2)
    before = (bsp.launches, fl.launches, dict(bsp.launches_by_tiles), dict(fl.launches_by_tiles))
    for kw in (dict(engine="tilerows", pack=0), dict(engine="tilerows", pack=9),
               dict(engine="tilerows", pack=-1), dict(engine="tile64", pack=2),
               dict(engine="tilerows", pack=2.0), dict(pack=1)):
        with pytest.raises(ValueError):
            bsp.block_spmm_cuda(A, A, *tasks, 2, **kw)
        with pytest.raises(ValueError):
            fl.fused_block_spmm_cuda(*fargs, **kw)
    with pytest.raises(ValueError):
        bsp.block_spmm_cuda(W, W, *tasks, 2, engine="tile128", pack=2)
    assert before == (bsp.launches, fl.launches, bsp.launches_by_tiles, fl.launches_by_tiles)
    bsp.block_spmm_cuda(A, A, *tasks, 2, engine="tilerows", pack=8)  # the full pack is taken
    bsp.block_spmm_cuda(W, W, *tasks, 2, engine="tile128", pack=1)


def test_tuned_cache_steers_the_launches(cuda, tile_cache):
    """With no engine named, both kernels launch the cached pair; a stale
    entry (a pack above the full pack, Tile128 on an unaligned stack) and a
    corrupt file give the rule's launch; the tuner's default bench round-trips."""
    A = torch.randn(20, 8, 8, device=cuda)
    rng = np.random.default_rng(0)
    a, b, c = _tasks(rng, 20, 20, 30, 200)
    args = (A, A, *ops.task_arrays(a, b, c, 30, cuda), 30)
    fargs = _one_worker(A, A, a, b, c, 30)
    key = autotune.tile_key(torch.cuda.get_device_name(), 8, 8, 8, "float32")

    def launched(entry):
        if entry is not None:
            autotune.save_tile_entry(key, entry)
        counts = (dict(bsp.launches_by_tiles), dict(fl.launches_by_tiles))
        out = bsp.block_spmm_cuda(*args), fl.fused_block_spmm_cuda(*fargs)
        new = [{k: v - m0.get(k, 0) for k, v in m.items() if v != m0.get(k, 0)}
               for m, m0 in zip((bsp.launches_by_tiles, fl.launches_by_tiles), counts)]
        return out, new

    (rule, frule), new = launched(None)
    assert new == [{("tilerows", 8): 1}, {("tilerows", 8): 1}]
    for entry in (("tile64", 1), ("tilerows", 2)):
        (got, fgot), new = launched(entry)
        assert new == [{entry: 1}, {entry: 1}]
        assert torch.equal(got, rule) and torch.equal(fgot, frule)
    _, new = launched(("tilerows", 9))  # stale: above rows_pack(8, 8)
    assert new == [{("tilerows", 8): 1}, {("tilerows", 8): 1}]
    with open(tile_cache, "w") as fh:
        fh.write("{not json")
    autotune.clear_memo()
    _, new = launched(None)
    assert new == [{("tilerows", 8): 1}, {("tilerows", 8): 1}]
    # Tile128 cached for bs 128 and a stack off a 16-byte boundary: the rule (Tile64)
    W = torch.randn(4, 128, 128, device=cuda)
    autotune.save_tile_entry(autotune.tile_key(torch.cuda.get_device_name(), 128, 128, 128,
                                               "float32"), ("tile128", 1))
    tasks = ops.task_arrays(np.array([0, 1]), np.array([2, 3]), np.array([0, 1]), 2, cuda)
    before = dict(bsp.launches_by_tiles)
    bsp.block_spmm_cuda(_misaligned(W), W, *tasks, 2)
    bsp.block_spmm_cuda(W, W, *tasks, 2)
    assert bsp.launches_by_tiles[("tile64", 1)] == before.get(("tile64", 1), 0) + 1
    assert bsp.launches_by_tiles[("tile128", 1)] == before.get(("tile128", 1), 0) + 1
    # the default bench on the card (device time): its random-list winner is
    # not saved unless asked; asked, it is saved and picked back up
    key16 = autotune.tile_key(torch.cuda.get_device_name(), 16, 16, 16, "float32")
    autotune.clear_memo()
    best, rows = autotune.autotune_tiles(16, 16, 16, "float32", reps=2, path=tile_cache)
    assert all(r["us"] > 0 for r in rows) and len(rows) == len(autotune.candidate_tiles(16, 16, 16))
    assert key16 not in autotune.load_tile_cache(tile_cache)
    best, rows = autotune.autotune_tiles(16, 16, 16, "float32", reps=2, path=tile_cache,
                                         persist=True)
    autotune.clear_memo()
    assert autotune.pick_tiles(16, 16, 16, "float32", path=tile_cache) == best


@pytest.mark.parametrize("offset", [0, 1])
def test_resident_dispatch_span_records_the_tiles_that_launched(cuda, tile_cache, offset):
    """The dispatch span's ``tiles`` are the pair the fused kernel launched,
    with the stores on or off a 16-byte boundary at bs 128 (Tile128 or the
    rule's other engine); a cache tuned mid-process moves a new executable,
    not the one that already picked."""
    import repro_torch.obs as tobs
    from repro_torch.core.distributed import make_worker_mesh
    from repro_torch.dist import PlanCache, dist_multiply, scatter

    rng = np.random.default_rng(offset)
    dense = rng.standard_normal((512, 512)).astype(np.float32)
    dense[np.abs(np.subtract.outer(np.arange(512), np.arange(512))) > 160] = 0
    x = scatter(BSMatrix.from_dense(dense, 128), make_worker_mesh(4))
    if offset:
        x = dataclasses.replace(x, store=_misaligned(x.store))
    key = autotune.tile_key(torch.cuda.get_device_name(), 128, 128, 128, "float32")

    def run(cache):
        before = dict(fl.launches_by_tiles)
        dist_multiply(x, x, cache)
        torch.cuda.synchronize()
        new = {k: v - before.get(k, 0) for k, v in fl.launches_by_tiles.items()
               if v != before.get(k, 0)}
        spans = [sp.args for sp in cache.tracer.spans if sp.name == "dispatch" and "tasks" in sp.args]
        return new, spans[-1]["tiles"]

    cache = PlanCache(tracer=tobs.Tracer(sync=False))
    rule = ("tile64", 1) if offset else ("tile128", 1)
    assert run(cache) == ({rule: 1}, list(rule))
    autotune.save_tile_entry(key, ("tile64", 1))
    assert run(cache) == ({rule: 1}, list(rule))  # this executable keeps its pick
    assert run(PlanCache(tracer=tobs.Tracer(sync=False))) == ({("tile64", 1): 1}, ["tile64", 1])


def _sp2_problem(n, nocc, seed):
    """A gapped banded Hamiltonian and its overlap S = I + 0.01 |H| (the smoke's)."""
    rng = np.random.default_rng(seed)
    diag = np.where(np.arange(n) < nocc, np.linspace(-2.0, -0.5, n), np.linspace(0.5, 2.0, n))
    h = np.zeros((n, n))
    i = np.arange(n)
    for d in range(1, 9):
        h[i[:-d], i[d:]] = 0.3 * np.exp(-0.5 * d) * rng.standard_normal(n - d)
    h = (h + h.T) / 2 + np.diag(rng.permutation(diag))
    return h.astype(np.float32), (np.eye(n) + 0.01 * np.abs(h)).astype(np.float32)


def _skewed(nnzb, nparts):
    from repro_torch.core.schedule import partition_morton

    half = nnzb // 2
    return np.concatenate([np.zeros(half, np.int32),
                           partition_morton(nnzb - half, nparts - 1).astype(np.int32) + 1])


def test_resident_sp2_on_the_card_repeats_and_rebalances_bit_for_bit(cuda):
    from repro_torch.core.distributed import make_worker_mesh
    from repro_torch.dist import PlanCache, RebalancePolicy, dist_sp2_purify, scatter

    h, _ = _sp2_problem(512, 160, 1)
    f = BSMatrix.from_dense(h, 32)
    mesh = make_worker_mesh(8)
    kw = dict(idem_tol=1e-6, trunc_tau=1e-5, spamm_tau=1e-7)
    before = fl.launches
    d1, st1 = dist_sp2_purify(f, 160, -2.5, 2.5, mesh, **kw)
    assert fl.launches - before == st1.iterations  # one fused launch per square
    d2, st2 = dist_sp2_purify(f, 160, -2.5, 2.5, mesh, **kw)
    d3, st3 = dist_sp2_purify(scatter(f, mesh, owner=_skewed(f.nnzb, 8)), 160, -2.5, 2.5,
                              cache=PlanCache(), rebalance=RebalancePolicy(), **kw)
    assert st3.rebalances >= 1
    for d, st in ((d2, st2), (d3, st3)):
        assert st.idempotency_history == st1.idempotency_history
        assert np.array_equal(d.coords, d1.coords) and torch.equal(d.data, d1.data)
    dd = d1.to_dense().astype(np.float64)
    assert abs(np.trace(dd) - 160) < 1e-3 and np.abs(dd @ dd - dd).max() < 1e-5


def test_resident_pipeline_on_the_card_repeats_and_rebalances_bit_for_bit(cuda):
    from repro_torch.core.distributed import make_worker_mesh
    from repro_torch.dist import PlanCache, RebalancePolicy, dist_sqrt_inv_pipeline, scatter

    h, s = _sp2_problem(512, 160, 2)
    H, S = BSMatrix.from_dense(h, 32), BSMatrix.from_dense(s, 32)
    mesh = make_worker_mesh(8)
    kw = dict(trunc_tau=1e-5, idem_tol=1e-6)
    d1, p1 = dist_sqrt_inv_pipeline(S, H, 160, mesh, **kw)
    d2, _ = dist_sqrt_inv_pipeline(S, H, 160, mesh, **kw)
    skew = _skewed(S.nnzb, 8)
    d3, p3 = dist_sqrt_inv_pipeline(scatter(S, mesh, owner=skew), scatter(H, mesh, owner=skew),
                                    160, cache=PlanCache(), rebalance=RebalancePolicy(), **kw)
    assert p3.inverse.rebalances + p3.purify.rebalances >= 1
    for d in (d2, d3):
        assert np.array_equal(d.coords, d1.coords) and torch.equal(d.data, d1.data)
    # against the float64 generalized eigenproblem H C = S C E
    L = np.linalg.cholesky(s.astype(np.float64))
    li = np.linalg.inv(L)
    _, v = np.linalg.eigh(li @ h.astype(np.float64) @ li.T)
    m = L.T @ d1.to_dense().astype(np.float64) @ L
    assert abs(np.trace(m) - 160) < 1e-3
    assert np.abs(m - v[:, :160] @ v[:, :160].T).max() < 1e-4


# --- flash attention (kernels/csrc/flash_attention.cu) ----------------------

# (B, H, HK, Sq, Sk, D, causal, window): the smoke's flash_kernel cases at a smaller S
FLASH_CASES = {
    "qwen2_layer": (2, 14, 2, 512, 512, 64, True, None),
    "noncausal_d80": (1, 4, 4, 300, 300, 80, False, None),
    "d128_mqa": (1, 4, 1, 256, 256, 128, True, None),
    "d256_mqa": (1, 4, 1, 200, 200, 256, True, None),
    "suffix": (2, 6, 2, 64, 512, 64, True, None),
    "window_suffix": (1, 4, 2, 100, 600, 64, True, 128),
    "window_noncausal": (1, 2, 1, 256, 256, 32, False, 50),
    "ragged": (1, 3, 1, 333, 333, 64, True, None),
    "masked_rows": (1, 2, 1, 150, 100, 64, True, None),
    # head dims that pad the contraction to 16 (and to the 64 or 128 bucket)
    "d8": (1, 4, 2, 130, 130, 8, True, None),
    "d40_noncausal": (1, 3, 1, 200, 200, 40, False, None),
    "d72": (2, 4, 2, 150, 150, 72, True, None),
    # qwen2's GQA (14 q heads on 2 kv heads, rep 7) on a ragged kv axis with a suffix
    "gqa_rep7_suffix_ragged": (1, 14, 2, 100, 1000, 64, True, None),
    # the fp32 kernel's tile edges (128 query rows for D <= 128, 64 for D 256;
    # 64-key tiles): Sq and Sk one off a multiple, so a q tile meets a partly
    # live kv tile at both ends of the diagonal
    "edges_sq129_sk191": (1, 4, 2, 129, 191, 64, True, None),
    "edges_sq127_sk65": (2, 3, 1, 127, 65, 64, True, None),
    "edges_d128_sq255_sk257": (1, 4, 1, 255, 257, 128, True, None),
    "edges_d256_sq65_sk63": (1, 2, 1, 65, 63, 256, True, None),
    # one query row against a long kv axis (decode)
    "decode_sq1_sk1000": (2, 14, 2, 1, 1000, 64, True, None),
    # a window ending mid-tile, Sq != Sk, causal and not
    "window100_sq300_sk700": (1, 4, 2, 300, 700, 64, True, 100),
    "window77_noncausal_sq200_sk333": (1, 2, 1, 200, 333, 48, False, 77),
    # D 256, non-causal, ragged on both axes
    "d256_noncausal_ragged": (1, 4, 1, 129, 250, 256, False, None),
    # the bf16 kernel's 112 bucket (128-row blocks, 128-key tiles): kimi-k2's
    # GQA (rep 8) on Sq and Sk one off a multiple of 128, a non-causal
    # window, a decode-style suffix, and D 96 (7 k16 steps over TMA's zeros)
    "d112_kimi_gqa_sq257_sk383": (1, 16, 2, 257, 383, 112, True, None),
    "d112_window70_noncausal": (1, 8, 1, 200, 300, 112, False, 70),
    "d112_suffix_sq5_sk700": (2, 8, 1, 5, 700, 112, True, None),
    "d96": (1, 4, 2, 300, 300, 96, True, None),
    # a kv axis shorter than one kv tile
    "sk40_below_one_tile": (1, 4, 2, 50, 40, 64, False, None),
}


def _flash_inputs(dev, case, dtype, seed=0):
    B, H, HK, Sq, Sk, D, causal, window = FLASH_CASES[case]
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(s, generator=g, device=dev).to(dtype)
               for s in ((B, H, Sq, D), (B, HK, Sk, D), (B, HK, Sk, D)))
    return q, k, v, dict(causal=causal, window=window)


def _flash_excess(got, q, k, v, **kw):
    """max |got - want| / limit against the plain version's fp32 result on the
    same inputs, elementwise: 1e-4 * max|v| for the order of the fp32 sums and
    exps (the output is a convex combination of v's rows), plus for a bf16
    output its one rounding, half a bf16 ulp <= 2^-8 * |want|."""
    from repro_torch.kernels import flash_attention as fa

    want = fa.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    limit = 1e-4 * float(v.float().abs().max())
    if got.dtype != torch.float32:
        limit = 2.0**-8 * want.abs() + limit
    return float(((got.float() - want).abs() / limit).max())


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_version(cuda, case, dtype):
    from repro_torch.kernels import flash_attention as fa

    q, k, v, kw = _flash_inputs(cuda, case, dtype)
    before = fa.launches
    got = fa.flash_attention_cuda(q, k, v, **kw)
    again = fa.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 2
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, again), "flash kernel is not deterministic"
    excess = _flash_excess(got, q, k, v, **kw)
    assert excess <= 1.0, (case, excess)


def test_flash_kernel_zeros_on_fully_masked_rows(cuda):
    from repro_torch.kernels import flash_attention as fa

    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, kw = _flash_inputs(cuda, "masked_rows", dtype)
        got = fa.flash_attention_cuda(q, k, v, **kw)
        dead = q.shape[2] - k.shape[2]  # rows at negative positions see no key
        assert not got[:, :, :dead].any()
        assert torch.isfinite(got.float()).all() and got[:, :, dead:].abs().sum() > 0


def test_flash_kernel_takes_strided_views_without_copy(cuda):
    from repro_torch.kernels import flash_attention as fa

    q, k, v, kw = _flash_inputs(cuda, "qwen2_layer", torch.float32)
    # [B, S, H, D] activations seen as [B, H, S, D]: the layout models/attention.py passes
    qs, ks, vs = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    got = fa.flash_attention_cuda(qs, ks, vs, **kw)
    assert got.stride() == qs.stride()
    assert torch.equal(got, fa.flash_attention_cuda(q, k, v, **kw))


def test_flash_bf16_takes_strided_views_at_d112(cuda):
    """kimi-k2's layout at D 112: ``[B, S, H, D]`` activations seen as ``[B,
    H, S, D]`` go into the tensor maps as they are, and give the contiguous
    launch's bits; a size-1 head axis may carry any stride."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
               for s in ((1, 191, 16, 112), (1, 191, 2, 112), (1, 191, 2, 112)))
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
    before = fa.launches
    got = fa.flash_attention_cuda(qs, ks, vs)
    want = fa.flash_attention_cuda(qs.contiguous(), ks.contiguous(), vs.contiguous())
    torch.cuda.synchronize()
    assert fa.launches == before + 2
    assert got.stride() == qs.stride()
    assert torch.equal(got, want)
    assert _flash_excess(got, qs, ks, vs, causal=True) <= 1.0
    # one head: PyTorch leaves its stride free (here 1); the wrapper names a valid one
    one = torch.as_strided(q[:, :, :1].transpose(1, 2).contiguous(), (1, 1, 191, 112), (191 * 112, 1, 112, 1))
    kv1 = (ks[:, :1].contiguous(), vs[:, :1].contiguous())
    assert torch.equal(fa.flash_attention_cuda(one, *kv1), fa.flash_attention_cuda(one.contiguous(), *kv1))


def test_flash_bf16_refuses_views_tma_cannot_take(cuda):
    """A bf16 view whose base or row stride is no multiple of 16 bytes (TMA's
    rule) raises before any launch; nothing falls back to the plain version."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(6)
    wide = torch.randn((1, 4, 96, 112 + 8), generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn((1, 2, 96, 112), generator=g, device=cuda).to(torch.bfloat16)
    off_base = wide[..., 4:116]      # base 8 bytes off a 16-byte boundary
    narrow = torch.randn((1, 4, 96, 112 + 4), generator=g, device=cuda).to(torch.bfloat16)
    off_rows = narrow[..., :112]     # rows 232 bytes apart
    before = fa.launches
    for q in (off_base, off_rows):
        with pytest.raises(ValueError, match="16-byte"):
            fa.flash_attention_cuda(q, k, k)
        with pytest.raises(ValueError, match="16-byte"):
            ops.flash_attention(k.repeat(1, 2, 1, 1), q[:, :2], q[:, :2], impl="kernel")
    assert fa.launches == before


def test_flash_dispatch_and_rejections(cuda):
    from repro_torch.kernels import flash_attention as fa

    q, k, v, kw = _flash_inputs(cuda, "suffix", torch.float32)
    before = fa.launches
    ops.flash_attention(q, k, v, **kw)
    assert fa.launches == before + 1  # "auto" on a CUDA tensor launches the kernel
    ops.flash_attention(q, k, v, impl="ref", **kw)
    assert fa.launches == before + 1
    with pytest.raises(ValueError):  # off the card the kernel is refused
        ops.flash_attention(q.cpu(), k.cpu(), v.cpu(), impl="kernel", **kw)
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):  # head dim not a multiple of 8
        fa.flash_attention_cuda(q[..., :12], k[..., :12], v[..., :12])
    with pytest.raises(ValueError):  # head dim above 256
        big = torch.zeros(1, 1, 8, 264, device=cuda)
        fa.flash_attention_cuda(big, big, big)
    with pytest.raises(ValueError):  # q heads not a multiple of kv heads
        fa.flash_attention_cuda(q[:, :5], k, v)
    with pytest.raises(ValueError):  # non-unit stride along the head dim
        fa.flash_attention_cuda(q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3))
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q, k, v, window=0)
    assert fa.launches == before + 1


def test_lm_forward_and_generate_go_through_the_flash_kernel(cuda):
    from repro_torch.configs import reduced_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer

    cfg = reduced_config("qwen2-0.5b")
    params = transformer.init_params(cfg, seed=0)  # on the card by default
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 300))).to(cuda)
    before = fa.launches
    flash = transformer.apply(params, cfg, {"tokens": tokens}, attn_impl="flash")
    assert fa.launches == before + cfg.num_layers
    direct = transformer.apply(params, cfg, {"tokens": tokens}, attn_impl="direct")
    assert float((flash - direct).abs().max()) <= 1e-4 * float(direct.abs().max())
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 5))
    seqs, steps = generate(cfg, params, prompts, 6, return_logits=True)
    full = transformer.apply(params, cfg, {"tokens": torch.from_numpy(seqs).to(cuda)},
                             attn_impl="flash")[:, :-1]
    assert float((full - steps).abs().max()) <= 1e-4 * float(full.abs().max())


# -- the MoE FFN, the dropless grouped GEMM and the scan families ----------------


@pytest.mark.parametrize("capacity_factor", [1.25, 4.0])
def test_moe_block_spmm_route_matches_the_cpu_and_repeats(cuda, capacity_factor):
    """Ce = 40 (TileRows) and 128 (the 128 x 128 engine): three kernel
    launches a call, bit-identical on repeat, within 1e-4 * max|out| of the
    CPU's plain route on the same inputs."""
    from repro_torch.models import moe

    D, F, E, K = 128, 256, 8, 2
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(gen, D, F, E, "silu")
    x = torch.randn((2, 64, D), generator=gen)
    kw = dict(num_experts=E, top_k=K, act="silu", capacity_factor=capacity_factor,
              gemm_impl="block_spmm")
    want = moe.moe_apply(p, x, **kw)
    pc = {k: v.to(cuda) for k, v in p.items()}
    before = bsp.launches
    got = moe.moe_apply(pc, x.to(cuda), **kw)
    again = moe.moe_apply(pc, x.to(cuda), **kw)
    torch.cuda.synchronize()
    assert bsp.launches == before + 6
    assert torch.equal(got, again)
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_moe_block_spmm_route_in_bf16_runs_on_tiletc(cuda):
    """The MoE route in bf16 at Ce 160 (TileTC, two warpgroups and a ragged
    third): three TileTC launches a call, bit-identical on repeat, within
    1e-2 * max|out| of the CPU's plain route on the same bf16 inputs (the
    expert GEMMs' fp32 sums differ in order, then round to bf16)."""
    from repro_torch.models import moe

    D, F, E, K = 128, 256, 8, 2
    gen = torch.Generator().manual_seed(0)
    p = {k: v.to(torch.bfloat16) for k, v in moe.moe_init(gen, D, F, E, "silu").items()}
    x = torch.randn((2, 256, D), generator=gen).to(torch.bfloat16)
    kw = dict(num_experts=E, top_k=K, act="silu", capacity_factor=1.25, gemm_impl="block_spmm")
    want = moe.moe_apply(p, x, **kw)
    pc = {k: v.to(cuda) for k, v in p.items()}
    before = bsp.launches_by_tiles.get(("tiletc", 1), 0)
    got = moe.moe_apply(pc, x.to(cuda), **kw)
    again = moe.moe_apply(pc, x.to(cuda), **kw)
    torch.cuda.synchronize()
    assert bsp.launches_by_tiles.get(("tiletc", 1), 0) == before + 6
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    assert float((got.cpu().float() - want.float()).abs().max()) <= 1e-2 * float(want.float().abs().max())


def test_grouped_gemm_varsize_on_the_card_matches_its_plain_version(cuda):
    """Tile 0 spans groups 0, 1 and 2 (three tasks); group 3 is empty."""
    sizes = [3, 2, 11, 0, 30]
    a, b, c, lo, hi = ops.grouped_gemm_tasks(sizes, 8)
    assert list(b[a == 0]) == [0, 1, 2]
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((sum(sizes), 64), generator=gen)
    w = torch.randn((len(sizes), 64, 96), generator=gen)
    want = ops.grouped_gemm_varsize(x, sizes, w)
    before = bsp.launches
    got = ops.grouped_gemm_varsize(x.to(cuda), sizes, w.to(cuda))
    again = ops.grouped_gemm_varsize(x.to(cuda), sizes, w.to(cuda))
    torch.cuda.synchronize()
    assert bsp.launches == before + 2
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "recurrentgemma-9b", "mamba2-370m"])
def test_every_family_decodes_like_its_forward_on_the_card(cuda, arch):
    from repro_torch.configs import reduced_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer

    cfg = reduced_config(arch)
    params = transformer.init_params(cfg, seed=0)  # on the card by default
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 5))
    seqs, steps = generate(cfg, params, prompts, 20, return_logits=True)
    full = transformer.apply(params, cfg, {"tokens": torch.from_numpy(seqs).to(cuda)},
                             attn_impl="flash")[:, :-1]
    assert float((full - steps).abs().max()) <= 1e-4 * float(full.abs().max())


# -- benchmarks/torch_kernel_micro.py on the card ------------------------------


def _kernel_micro():
    import importlib
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
    return importlib.import_module("torch_kernel_micro")


def test_kernel_micro_rows_match_the_plain_versions(cuda):
    km = _kernel_micro()
    rng = np.random.default_rng(0)
    for bs, T, nout in ((64, 32, 8), (128, 256, 64)):
        gen = torch.Generator(device=cuda).manual_seed(bs)
        A = torch.randn((32, bs, bs), generator=gen, device=cuda)
        B = torch.randn((32, bs, bs), generator=gen, device=cuda)
        a, b, c = km._random_tasks(rng, 32, T, nout)
        _check(A, B, a, b, c, nout)  # the kernel the rows time, against block_spmm_ref
    rows = km.bench_block_spmm(cuda, 128, 256, 64)
    assert [r["name"] for r in rows] == ["block_spmm_cuda_bs128", "block_spmm_plain_bs128",
                                         "bmm_pregathered_bs128"]
    assert all(r["us"] > 0 and not r["smoke_only"] for r in rows)
    fvs = km.bench_fused_vs_staged(cuda, 128, 512)
    assert fvs["bit_identical"]
    p = km.fused_problem(cuda, 64, 256)
    got = km._fused(p)
    want = fl.fused_block_spmm_ref(p["a_store"], p["a_recv"], p["b_store"], p["b_recv"],
                                   *p["idx"], p["run_ptr"], p["nout"])[0]
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= REL * 64 * scale
    prec = km.bench_precision_modes(cuda, 128, 512)
    assert prec["within_bounds"]


@pytest.mark.parametrize("bs", [8, 32, 64, 96, 128, 256])
def test_kernel_micro_engines_agree_bit_for_bit(cuda, bs):
    km = _kernel_micro()
    (row,) = km.bench_engines(cuda, T=256, nout=64, n_blocks=32, bs_list=(bs,))
    assert row["bit_identical"], row
    assert row["picked"] == ("tile128" if bs % 128 == 0 else "tilerows" if bs <= 64 else "tile64")
    timed = {e for e, us in row["us"].items() if us is not None}
    assert timed == {"tile64"} | ({"tile128"} if bs % 128 == 0 else set()) | (
        {"tilerows"} if bs <= 64 else set())
    assert row["fastest"] in timed


# --- the training path on the card -------------------------------------------


@pytest.mark.parametrize("name", ["block_spmm", "block_spmm_tensors", "grouped_gemm_varsize",
                                  "fused_block_spmm", "flash_attention"])
def test_kernel_entry_points_raise_under_autograd_on_the_card(cuda, name):
    from test_torch_kernel_autograd import _calls

    launches = (bsp.launches, fl.launches)
    with pytest.raises(TypeError, match="no gradient rule"):
        _calls(True, cuda)[name]()
    assert (bsp.launches, fl.launches) == launches
    with torch.no_grad():
        out = _calls(True, cuda)[name]()
    assert out.device.type == "cuda" and torch.isfinite(out).all()


def _train_setup(device, arch="qwen2-0.5b"):
    from repro_torch.configs import reduced_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import model as model_mod

    cfg = reduced_config(arch)
    state = model_mod.init_train_state(cfg, seed=0, device=device)
    return cfg, state, TokenPipeline(cfg, batch=2, seq=640, seed=0), model_mod


def _on(tree, device):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.to(device), tree)


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """Reduced qwen2-0.5b at S 640 (two kv chunks, the last ragged), fp32: the
    loss within 1e-5 relative, each gradient leaf within 1e-4 * max|g| of the
    CPU's; the update of the CPU's gradients on the card within 1e-6 of the
    leaf's largest magnitude."""
    from repro_torch.tree import tree_leaves

    cfg, state, pipe, model_mod = _train_setup("cpu")
    batch = pipe.global_batch(0)
    grad_fn = model_mod.make_grad_fn(cfg, compute_dtype=torch.float32)
    loss, grads = grad_fn(state["params"], batch)
    card_state = _on(state, cuda)
    card_loss, card_grads = grad_fn(card_state["params"], batch)
    assert abs(float(card_loss) - float(loss)) <= 1e-5 * abs(float(loss))
    for g, w in zip(tree_leaves(card_grads), tree_leaves(grads)):
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(w.abs().max())
    update = model_mod.make_update_fn(warmup=0)
    want, _ = update(state, grads)
    got, _ = update(card_state, _on(grads, cuda))
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert float((g.cpu().double() - w.double()).abs().max()) <= 1e-6 * max(
            float(w.double().abs().max()), 1e-30)


def test_train_step_is_bit_identical_on_repeat_on_the_card(cuda):
    """bf16 compute: two runs of one step from one state give the same bits
    (no backward on the path accumulates with atomics)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.tree import tree_leaves

    for arch in ("qwen2-0.5b", "qwen3-moe-235b-a22b"):
        cfg, state, pipe, model_mod = _train_setup(cuda, arch)
        step = model_mod.make_train_step(cfg, warmup=0)
        launches = (bsp.launches, fl.launches, fa.launches)
        a, ma = step(state, pipe.global_batch(0))
        b, mb = step(state, pipe.global_batch(0))
        torch.cuda.synchronize()
        assert (bsp.launches, fl.launches, fa.launches) == launches  # no kernel on the path
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves([a, ma]), tree_leaves([b, mb])))


def test_restart_is_bitwise_identical_on_the_card(cuda, tmp_path):
    from repro_torch.runtime import TrainLoop
    from repro_torch.tree import tree_leaves

    cfg, state, pipe, model_mod = _train_setup(cuda)
    step = model_mod.make_train_step(cfg, lr_peak=1e-3, warmup=1, total_steps=6)
    quiet = dict(log_every=100, log=lambda *_: None)
    straight, _ = TrainLoop(step, pipe, str(tmp_path / "a"), ckpt_every=3).run(state, 0, 6, **quiet)
    TrainLoop(step, pipe, str(tmp_path / "b"), ckpt_every=3).run(state, 0, 3, **quiet)
    loop = TrainLoop(step, pipe, str(tmp_path / "b"), ckpt_every=3)
    resumed, start = loop.resume_or_init(state)
    assert start == 3 and all(t.device.type == "cuda" for t in tree_leaves(resumed))
    resumed, _ = loop.run(resumed, start, 3, **quiet)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(straight), tree_leaves(resumed)))
