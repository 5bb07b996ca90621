"""The CUDA kernel on the card: built from the sources, held against its plain version.

Marked ``gpu``: each test skips where no CUDA card is present (decided inside
the fixture, never at import).  On the card run
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import BSMatrix, multiply
from repro_torch.kernels import block_spmm as bsp
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
