"""Helpers shared by the parity tests of the PyTorch port against the JAX package.

Matrices cross between the packages as numpy arrays (``repro_torch.convert``).
Import this module after ``pytest.importorskip("jax")``.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np

from repro.core import BSMatrix as JaxBSMatrix
from repro_torch.convert import bsmatrix_from_arrays, bsmatrix_to_arrays

# the structure families of the SpAMM benchmark (benchmarks/spamm_sequences.py)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "benchmarks"))
import spamm_sequences  # noqa: E402


def randomize_lm(tree, rng):
    """Random values for every bias, norm scale and SSD skip / dt bias of an LM's
    parameter tree of numpy arrays (0 and 1 at init, so a dropped bias or
    scale would pass on fresh parameters)."""
    def visit(node, name=""):
        if isinstance(node, dict):
            return {k: visit(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [visit(v) for v in node]
        if name in ("b", "bias", "dt_bias"):
            return (0.5 * rng.standard_normal(node.shape)).astype(np.float32)
        if name in ("scale", "norm_scale", "d_skip"):
            return (1.0 + 0.5 * rng.standard_normal(node.shape)).astype(np.float32)
        return node
    return visit(tree)


def to_port(m: JaxBSMatrix, device: str = "cpu"):
    return bsmatrix_from_arrays(m.shape, m.bs, m.coords, np.asarray(m.data), device=device)


def to_jax(m) -> JaxBSMatrix:
    shape, bs, coords, data = bsmatrix_to_arrays(m)
    return JaxBSMatrix(shape=shape, bs=bs, coords=coords, data=jnp.asarray(data))


def gemm_tolerance(a_data, b_data, a_idx, b_idx, c_idx, num_out, rel=1e-5):
    """Per output block ``c``: ``rel * sum over its tasks of ||A_t||_F ||B_t||_F``.

    The two packages sum each output element's products in different orders
    (XLA's dot and segment_sum against torch.bmm and an ordered run sum, or
    the CUDA kernel's k-tiles), so fp32 results differ by rounding.  Every
    product's rounding error is bounded by a multiple of
    ``||A_t||_F ||B_t||_F``, and so is their sum.
    """
    def norms(d):
        return np.sqrt((np.asarray(d).astype(np.float64) ** 2).sum(axis=(1, 2)))

    bound = np.zeros(num_out)
    np.add.at(bound, np.asarray(c_idx), norms(a_data)[a_idx] * norms(b_data)[b_idx])
    return rel * bound


def assert_blocks_within(got, want, tol):
    """``max |got_c - want_c| <= tol[c]`` for every output block ``c``."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).reshape(got.shape[0], -1).max(axis=1, initial=0.0)
    bad = np.nonzero(err > tol)[0]
    assert bad.size == 0, f"blocks {bad[:8]}: err {err[bad[:8]]} > tol {tol[bad[:8]]}"


def structures(n: int = 256):
    """The test structures: tests/helpers.py's and the three SpAMM sequences."""
    from helpers import banded_matrix, random_block_matrix, spd_banded

    return {
        "banded": banded_matrix(n, 20, 16, seed=0),
        "random": random_block_matrix(n, 16, 0.3, seed=1),
        "spd_banded": spd_banded(n - 40, 9, 16, seed=2),
        "seq_banded": spamm_sequences.banded(n, 24),
        "seq_exp_decay": spamm_sequences.exp_decay(n, rate=0.08),
        "seq_random_offdiag": spamm_sequences.random_offdiag(n, density=0.08),
    }
