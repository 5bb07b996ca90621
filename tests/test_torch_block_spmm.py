"""The port's grouped block GEMM (plain version, CPU) against the JAX package's.

The JAX side runs its Pallas kernel in interpret mode, as ``test_kernels.py``
does, on the same shapes; block sizes the Pallas kernel never sees (bs 24 and
bs 10, which ``repro/kernels/ops.py`` sends to its oracle) are held against
the JAX oracle ``block_spmm_ref``.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.block_spmm import block_spmm_kernel_call  # noqa: E402
from repro.kernels.ref import block_spmm_ref as jax_block_spmm_ref  # noqa: E402
from repro_torch.kernels import block_spmm as tbs  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from torch_parity import assert_blocks_within, gemm_tolerance  # noqa: E402

# fp32: |dC|_max <= 1e-5 * sum_t ||A_t||_F ||B_t||_F per output block, because
# the summation order differs (torch_parity.gemm_tolerance)
FP32_REL = 1e-5


def _random_tasks(rng, na, nb, nc, T):
    """Random tasks satisfying the kernel contract: c sorted and covering
    every output row (the symbolic phase guarantees both)."""
    T = max(T, nc)
    a = rng.integers(0, na, T)
    b = rng.integers(0, nb, T)
    c = np.sort(np.concatenate([np.arange(nc), rng.integers(0, nc, T - nc)]))
    return a, b, c


_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _port(A, B, a, b, c, num_out):
    return tops.block_spmm(
        torch.from_numpy(np.array(A, np.float32)).to(_TORCH_DTYPES[A.dtype.name]),
        torch.from_numpy(np.array(B, np.float32)).to(_TORCH_DTYPES[B.dtype.name]),
        a, b, c, num_out,
    ).numpy()


def _jax_kernel(A, B, a, b, c, num_out):
    i32 = lambda x: jnp.asarray(x, jnp.int32)
    return np.asarray(block_spmm_kernel_call(A, B, i32(a), i32(b), i32(c), num_out=num_out, interpret=True))


def _check_fp32(A, B, a, b, c, num_out, got, want, rows=None):
    tol = gemm_tolerance(np.asarray(A), np.asarray(B), a, b, c, num_out, rel=FP32_REL)
    rows = slice(None) if rows is None else rows
    assert_blocks_within(got[rows], want[rows], tol[rows])


@pytest.mark.parametrize("bs", [8, 16, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_spmm_square(bs, dtype):
    rng = np.random.default_rng(bs)
    na, nb, nc, T = 7, 5, 6, 23
    A = jnp.asarray(rng.standard_normal((na, bs, bs)), dtype)
    B = jnp.asarray(rng.standard_normal((nb, bs, bs)), dtype)
    a, b, c = _random_tasks(rng, na, nb, nc, T)
    got, want = _port(A, B, a, b, c, nc), _jax_kernel(A, B, a, b, c, nc)
    if dtype == "float32":
        _check_fp32(A, B, a, b, c, nc, got, want)
    else:  # the reference test's own bf16 tolerance (tests/test_kernels.py)
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-1)


@pytest.mark.parametrize("bm,bk,bn", [(16, 32, 8), (64, 16, 32), (128, 256, 128)])
def test_block_spmm_rectangular(bm, bk, bn):
    rng = np.random.default_rng(0)
    na, nb, nc, T = 4, 4, 3, 11
    A = jnp.asarray(rng.standard_normal((na, bm, bk)), jnp.float32)
    B = jnp.asarray(rng.standard_normal((nb, bk, bn)), jnp.float32)
    a, b, c = _random_tasks(rng, na, nb, nc, T)
    _check_fp32(A, B, a, b, c, nc, _port(A, B, a, b, c, nc), _jax_kernel(A, B, a, b, c, nc))


def test_block_spmm_tiled_large_block():
    # bs 1024 drives the JAX kernel's multi-tile accumulation paths
    rng = np.random.default_rng(1)
    A = jnp.asarray(rng.standard_normal((2, 1024, 1024)), jnp.float32)
    B = jnp.asarray(rng.standard_normal((2, 1024, 1024)), jnp.float32)
    a, b, c = np.array([0, 1, 1]), np.array([1, 0, 1]), np.array([0, 0, 1])
    _check_fp32(A, B, a, b, c, 2, _port(A, B, a, b, c, 2), _jax_kernel(A, B, a, b, c, 2))


def test_block_spmm_trailing_trash_row():
    """Rows covered by tasks match; the port writes zeros into the trailing
    trash row (the JAX kernel leaves it unspecified, its oracle zeros it)."""
    rng = np.random.default_rng(2)
    A = jnp.asarray(rng.standard_normal((3, 16, 16)), jnp.float32)
    B = jnp.asarray(rng.standard_normal((3, 16, 16)), jnp.float32)
    a, b, c = np.array([0, 1, 2, 2]), np.array([0, 1, 0, 1]), np.array([0, 1, 1, 2])
    got = _port(A, B, a, b, c, 4)
    _check_fp32(A, B, a, b, c, 4, got, _jax_kernel(A, B, a, b, c, 4), rows=slice(0, 3))
    assert not got[3].any()


def test_block_spmm_empty_task_list():
    A = torch.ones((2, 16, 16))
    z = np.zeros(0, np.int64)
    out = tops.block_spmm(A, A, z, z, z, 3)
    assert out.shape == (3, 16, 16) and out.dtype == torch.float32 and not out.any()


@pytest.mark.parametrize("bs", [24, 10])
def test_block_spmm_odd_block_sizes(bs):
    rng = np.random.default_rng(bs)
    na, nb, nc, T = 6, 5, 7, 30
    A = jnp.asarray(rng.standard_normal((na, bs, bs)), jnp.float32)
    B = jnp.asarray(rng.standard_normal((nb, bs, bs)), jnp.float32)
    a, b, c = _random_tasks(rng, na, nb, nc, T)
    want = np.asarray(jax_block_spmm_ref(A, B, jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), nc))
    _check_fp32(A, B, a, b, c, nc, _port(A, B, a, b, c, nc), want)


def test_plain_version_sums_in_task_order():
    """The plain version adds each run's products in ascending t: equal to a
    left-to-right loop, bit for bit."""
    rng = np.random.default_rng(5)
    A = torch.from_numpy(rng.standard_normal((5, 8, 8)).astype(np.float32))
    a, b, c = _random_tasks(rng, 5, 5, 4, 19)
    out = tops.block_spmm(A, A, a, b, c, 4)
    for blk in range(4):
        acc = torch.zeros(8, 8)
        for t in np.nonzero(c == blk)[0]:
            acc = acc + A[a[t]] @ A[b[t]]
        assert torch.equal(out[blk], acc)


def test_unsorted_output_indices_rejected():
    A = torch.ones((2, 8, 8))
    with pytest.raises(ValueError):
        tops.block_spmm(A, A, np.array([0, 1]), np.array([0, 1]), np.array([1, 0]), 2)
    with pytest.raises(ValueError):
        tops.block_spmm(A, A, np.array([0]), np.array([0]), np.array([2]), 2)


def test_kernel_impl_raises_off_the_card():
    A = torch.ones((2, 8, 8))
    before = tbs.launches
    with pytest.raises(ValueError):
        tops.block_spmm(A, A, np.array([0]), np.array([1]), np.array([0]), 1, impl="kernel")
    assert tbs.launches == before
