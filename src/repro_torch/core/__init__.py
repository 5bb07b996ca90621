"""Core: the paper's contribution — quadtree block-sparse matrix algebra.

Chunks = BSMatrix (host Morton structure + device block stacks);
Tasks   = host symbolic phases + device grouped-GEMM numeric phases.
The single-device part of the JAX package's ``repro.core``, with the same
public names.
"""

from .add import add, add_scaled_identity, identity
from .cache import SymbolicCache
from .inverse import (
    InverseStats,
    RefineMonitor,
    factorization_residual,
    inv_chol,
    localized_inverse_factorization,
    submatrix,
)
from .leaf import LeafSpec, exact_spgemm_flops, inner_masks, nnz_elements
from .matrix import BSMatrix
from .purify import sp2_purify
from .quadtree import QuadtreeIndex, build_quadtree_index, structure_fingerprint
from .spgemm import (
    Tasks,
    multiply,
    spamm,
    spamm_symbolic,
    spgemm_numeric,
    spgemm_symbolic,
    spgemm_symbolic_recursive,
    spgemm_symbolic_tree,
    symm_square,
    syrk,
    task_flops,
)
from .truncate import truncate, truncate_elementwise, truncate_hierarchical

__all__ = [
    "BSMatrix",
    "Tasks",
    "LeafSpec",
    "QuadtreeIndex",
    "build_quadtree_index",
    "structure_fingerprint",
    "SymbolicCache",
    "add",
    "add_scaled_identity",
    "identity",
    "multiply",
    "syrk",
    "symm_square",
    "spamm",
    "spamm_symbolic",
    "spgemm_symbolic",
    "spgemm_symbolic_tree",
    "spgemm_symbolic_recursive",
    "spgemm_numeric",
    "task_flops",
    "exact_spgemm_flops",
    "inner_masks",
    "nnz_elements",
    "truncate",
    "truncate_hierarchical",
    "truncate_elementwise",
    "inv_chol",
    "localized_inverse_factorization",
    "factorization_residual",
    "InverseStats",
    "RefineMonitor",
    "submatrix",
    "sp2_purify",
]
