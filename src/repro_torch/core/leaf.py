"""Leaf matrix libraries (paper §2.1 ships three stand-alone leaf types).

On the card every leaf is materially a dense ``bs x bs`` tile; the three
paper leaf types survive as *structure policies* that control (a) pruning
when building leaves and (b) exact flop/nnz accounting at sub-leaf
granularity — which is how the paper's Table 1 Tflop numbers are computed
(block-sparse leaves with 64x64 internal blocks).

* ``dense``        — basic_matrix_lib: full leaf, no internal structure.
* ``block_sparse`` — block_sparse_matrix_lib: uniform internal blocks, zero
                     internal blocks neither stored nor counted.
* ``hierarchical`` — hierarchical_block_sparse_lib: quadtree inside the leaf;
                     for accounting identical to block_sparse with
                     power-of-two internal blocks.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .matrix import BSMatrix, _to_numpy, block_frobenius_norms

__all__ = [
    "LeafSpec",
    "inner_masks",
    "inner_norms",
    "exact_spgemm_flops",
    "nnz_elements",
]


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    kind: str = "block_sparse"  # dense | block_sparse | hierarchical
    inner_bs: int = 64

    def __post_init__(self):
        assert self.kind in ("dense", "block_sparse", "hierarchical")


def _inner_bs(a: BSMatrix, spec: LeafSpec) -> int:
    ibs = a.bs if spec.kind == "dense" else spec.inner_bs
    assert a.bs % ibs == 0
    return ibs


def inner_masks(a: BSMatrix, spec: LeafSpec) -> np.ndarray:
    """Bool [nnzb, bs/ibs, bs/ibs]: which internal blocks are nonzero."""
    ibs = _inner_bs(a, spec)
    ni = a.bs // ibs
    blocks = a.data.reshape(a.nnzb, ni, ibs, ni, ibs)
    return _to_numpy((blocks != 0).any(dim=4).any(dim=2))


def inner_norms(a: BSMatrix, spec: LeafSpec) -> np.ndarray:
    """Float64 [nnzb, ni, ni]: Frobenius norm of each internal block.

    The leaf-policy view of the norm table: zero internal blocks are exact
    zeros, so these matrices are simultaneously the inner sparsity mask and
    the ingredient of the tightened SpAMM leaf bound
    ``||Na @ Nb||_F <= ||A_leaf||_F * ||B_leaf||_F``
    (:func:`repro_torch.core.spgemm.spamm` with ``leaf_spec=``).  Under
    ``kind="dense"`` the internal block IS the leaf (``ni == 1``).
    """
    ibs = _inner_bs(a, spec)
    return _to_numpy(block_frobenius_norms(a.data, inner=ibs)).astype(np.float64)


def nnz_elements(a: BSMatrix, spec: LeafSpec) -> int:
    """Stored elements under the leaf policy (zero internal blocks free)."""
    ibs = _inner_bs(a, spec)
    return int(inner_masks(a, spec).sum()) * ibs * ibs


def exact_spgemm_flops(a: BSMatrix, b: BSMatrix, tasks, spec: LeafSpec) -> float:
    """Exact flops of the task list under the leaf policy.

    Counts 2*ibs^3 per internal (i,k)x(k,j) product with both internal blocks
    nonzero — the convention behind the paper's Table 1 Tflop column.
    """
    ibs = _inner_bs(a, spec)
    ma = inner_masks(a, spec).astype(np.int64)
    mb = inner_masks(b, spec).astype(np.int64)
    # triples per task = sum_ik ma[i,k] * (number of j with mb[k,j])
    mb_rowsum = mb.sum(axis=2)  # [nnzb_b, ni]
    triples = np.einsum("tik,tk->t", ma[tasks.a_idx], mb_rowsum[tasks.b_idx])
    return float(triples.sum()) * 2.0 * ibs**3
