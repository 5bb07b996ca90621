"""The CUDA kernels on the card: built from the sources, held against their plain versions.

Marked ``gpu``: each test skips where no CUDA card is present (decided inside
the fixture, never at import).  On the card run
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import BSMatrix, multiply
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


@pytest.mark.parametrize("bm,bk,bn", [(8, 8, 8), (10, 10, 10), (16, 16, 16), (24, 24, 24),
                                      (16, 32, 8), (64, 16, 32), (128, 128, 128),
                                      (130, 70, 66), (128, 256, 128)])
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
                                      (128, 128, 128), (130, 70, 66)])
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


def test_fused_kernel_bit_identical_to_staged_kernel_and_masked_all_on(cuda):
    rng = np.random.default_rng(3)
    args = _fused_problem(cuda, rng, 4, 60, 128, 128, 128, torch.float32)
    a_store, a_recv, b_store, b_recv, a_src, a_off, b_src, b_off, run_ptr, num_out = args
    fused = fl.fused_block_spmm_cuda(*args)
    all_on = fl.fused_block_spmm_cuda(*args, on=torch.ones(a_src.shape, dtype=torch.bool, device=cuda))
    assert torch.equal(fused, all_on)
    # staged: per worker [own | recv rounds] concatenated, one flat task list
    P, cap = a_store.shape[:2]
    R, cu = a_recv.shape[1:3]
    L = cap + R * cu
    a_all = torch.cat([a_store, a_recv.flatten(1, 2)], 1).flatten(0, 1).contiguous()
    b_all = torch.cat([b_store, b_recv.flatten(1, 2)], 1).flatten(0, 1).contiguous()
    lin = lambda src, off: torch.where(src == 0, off, cap + (src - 1) * cu + off)  # noqa: E731
    rp = run_ptr.cpu().numpy()
    p, t = np.nonzero(np.arange(a_src.shape[1])[None] < rp[:, -1:])
    c = np.concatenate([np.repeat(np.arange(num_out), np.diff(rp[q])) for q in range(P)])
    pt = (torch.from_numpy(p).to(cuda), torch.from_numpy(t).to(cuda))
    a = (pt[0] * L + lin(a_src, a_off)[pt]).cpu().numpy()
    b = (pt[0] * L + lin(b_src, b_off)[pt]).cpu().numpy()
    staged = ops.block_spmm(a_all, b_all, a, b, p * num_out + c, P * num_out, impl="kernel")
    assert torch.equal(fused.reshape(staged.shape), staged)


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
