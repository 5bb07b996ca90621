"""Sparse quadtree structure utilities (host side, numpy).

A copy of ``repro/core/quadtree.py``, the JAX package's module of the same
name, kept line for line so that Morton codes, quadtree indices, structure
fingerprints and hierarchical drop masks are equal array for array between
the two packages (the port imports nothing of the JAX package).

The paper represents a matrix as a sparse quaternary tree: a node is either
identically zero, a leaf matrix, or four recursively represented quadrants.
The *data* lives in a flat device tensor of fixed-size leaf blocks and the
*structure* as host-side block coordinates.  The quadtree lives in the
Morton (Z-order) codes of the block coordinates: every quadtree node at
level L corresponds to a 2L-bit Morton prefix, and zero branches are exactly
the absent prefixes.

:class:`QuadtreeIndex` makes the hierarchy first-class: per-level sorted
prefix arrays with CSR parent->child and node->leaf spans plus per-node
subtree Frobenius norms, built once per structure and cached on
:class:`~repro_torch.core.matrix.BSMatrix`.  The symbolic phases in
:mod:`repro_torch.core.spgemm` descend it level-by-level (vectorized), and
SpAMM and :func:`repro_torch.core.truncate.truncate_hierarchical` prune whole
subtrees against the norms.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

__all__ = [
    "morton_encode",
    "morton_decode",
    "morton_sort",
    "quadtree_node_counts",
    "quadtree_depth",
    "expand_prefix",
    "structure_fingerprint",
    "QuadtreeIndex",
    "build_quadtree_index",
    "hierarchical_drop_mask",
]

_B = [
    0x5555555555555555,
    0x3333333333333333,
    0x0F0F0F0F0F0F0F0F,
    0x00FF00FF00FF00FF,
    0x0000FFFF0000FFFF,
]


def _part1by1(x: np.ndarray) -> np.ndarray:
    """Spread the low 32 bits of x so there is a zero bit between each."""
    x = x.astype(np.uint64)
    x = (x | (x << np.uint64(16))) & np.uint64(_B[4])
    x = (x | (x << np.uint64(8))) & np.uint64(_B[3])
    x = (x | (x << np.uint64(4))) & np.uint64(_B[2])
    x = (x | (x << np.uint64(2))) & np.uint64(_B[1])
    x = (x | (x << np.uint64(1))) & np.uint64(_B[0])
    return x


def _compact1by1(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & np.uint64(_B[0])
    x = (x | (x >> np.uint64(1))) & np.uint64(_B[1])
    x = (x | (x >> np.uint64(2))) & np.uint64(_B[2])
    x = (x | (x >> np.uint64(4))) & np.uint64(_B[3])
    x = (x | (x >> np.uint64(8))) & np.uint64(_B[4])
    x = (x | (x >> np.uint64(16))) & np.uint64(0x00000000FFFFFFFF)
    return x


def morton_encode(row: np.ndarray, col: np.ndarray) -> np.ndarray:
    """Interleave bits of (row, col) -> Z-order code.  row in even bits."""
    row = np.asarray(row)
    col = np.asarray(col)
    return (_part1by1(row) << np.uint64(1)) | _part1by1(col)


def morton_decode(code: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    code = np.asarray(code, dtype=np.uint64)
    row = _compact1by1(code >> np.uint64(1))
    col = _compact1by1(code)
    return row.astype(np.int64), col.astype(np.int64)


def morton_sort(coords: np.ndarray) -> np.ndarray:
    """Return the permutation that sorts (row, col) block coords in Z-order."""
    coords = np.asarray(coords)
    if coords.size == 0:
        return np.zeros((0,), dtype=np.int64)
    codes = morton_encode(coords[:, 0], coords[:, 1])
    return np.argsort(codes, kind="stable")


def quadtree_depth(nblocks_row: int, nblocks_col: int) -> int:
    """Number of quadtree levels above the leaves for a grid of blocks."""
    n = max(int(nblocks_row), int(nblocks_col), 1)
    return int(np.ceil(np.log2(n))) if n > 1 else 0


def quadtree_node_counts(coords: np.ndarray, depth: int | None = None) -> list[int]:
    """Number of *nonzero* quadtree nodes per level, root (level 0) to leaves.

    Level k nodes are the distinct 2k-bit Morton prefixes present in the
    structure.  This is the paper's "nonzero branches": everything absent is a
    nil chunk id and costs nothing.
    """
    coords = np.asarray(coords)
    if coords.size == 0:
        return [0]
    codes = morton_encode(coords[:, 0], coords[:, 1])
    if depth is None:
        depth = quadtree_depth(int(coords[:, 0].max()) + 1, int(coords[:, 1].max()) + 1)
    counts = []
    for level in range(depth + 1):
        shift = np.uint64(2 * (depth - level))
        counts.append(int(np.unique(codes >> shift).size))
    return counts


def expand_prefix(prefix: int, level: int, depth: int) -> tuple[int, int, int, int]:
    """Block-coordinate bounding box (r0, r1, c0, c1) of a Morton prefix node."""
    side = 1 << (depth - level)
    r, c = morton_decode(np.asarray([prefix << (2 * (depth - level))], dtype=np.uint64))
    return int(r[0]), int(r[0]) + side, int(c[0]), int(c[0]) + side


def structure_fingerprint(*parts) -> str:
    """Stable hex digest of a structure: arrays hashed by bytes, scalars by repr.

    The chunk-cache key analogue: two matrices with identical Morton codes
    (and two plans over identical structures) produce identical fingerprints
    across processes — ``hash()`` randomization and object identity play no
    role.  Used by :class:`repro_torch.core.cache.SymbolicCache`.
    """
    h = hashlib.blake2b(digest_size=16)
    for part in parts:
        if isinstance(part, np.ndarray):
            arr = np.ascontiguousarray(part)
            h.update(str(arr.dtype).encode())
            h.update(str(arr.shape).encode())
            h.update(arr.tobytes())
        else:
            h.update(repr(part).encode())
        h.update(b"|")
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class QuadtreeIndex:
    """First-class hierarchical quadtree over a Morton-sorted block structure.

    The paper's sparse quaternary tree, materialized: level ``k`` holds the
    sorted ``2k``-bit Morton prefixes of the nonzero nodes, with CSR-style
    parent->child spans into level ``k+1`` (children of a node are contiguous
    because prefixes are sorted), leaf spans into the block stack, and —
    when built with leaf norms — per-node *subtree* Frobenius norms.  These
    are exactly the internal-node norms the paper's multiplication, SpAMM and
    truncation tasks use to prune whole subtrees without visiting them.

    Attributes:
      depth:        levels above the leaves (level 0 = root, level depth = leaves).
      prefixes:     per level, sorted uint64 Morton prefixes of nonzero nodes.
      child_start:  per level k < depth, int64 [n_k + 1] CSR spans: children of
                    node j at level k are prefixes[k+1][child_start[k][j] :
                    child_start[k][j+1]].
      leaf_start:   per level, int64 [n_k + 1] spans into the Morton-sorted
                    block stack covered by each node's subtree.
      norms:        per level, float64 [n_k] subtree Frobenius norms, or None
                    for a structure-only index.
      fingerprint:  structure fingerprint of (leaf codes, depth) — the cache
                    key shared with :class:`repro_torch.core.cache.SymbolicCache`.
    """

    depth: int
    prefixes: tuple[np.ndarray, ...]
    child_start: tuple[np.ndarray, ...]
    leaf_start: tuple[np.ndarray, ...]
    norms: tuple[np.ndarray, ...] | None
    fingerprint: str

    @property
    def nnzb(self) -> int:
        return int(self.prefixes[-1].size)

    def num_nodes(self) -> int:
        """Total nonzero nodes across all levels."""
        return int(sum(p.size for p in self.prefixes))

    def node_counts(self) -> list[int]:
        return [int(p.size) for p in self.prefixes]

    def boundaries(self, level: int | None = None) -> np.ndarray:
        """Sorted unique leaf positions that start a quadtree node.

        ``level`` restricts to one level; default merges every level —
        the candidate cut positions for subtree-aligned Morton partitioning
        (the Morton partitioner's ``align=`` of the JAX package's scheduler).
        """
        if level is not None:
            return np.unique(self.leaf_start[level])
        return np.unique(np.concatenate([ls for ls in self.leaf_start]))


def hierarchical_drop_mask(qt: QuadtreeIndex, tau: float) -> tuple[np.ndarray, int]:
    """Top-down greedy subtree-drop selection under a global Frobenius budget.

    The shared symbolic phase of hierarchical truncation (host
    :func:`repro_torch.core.truncate.truncate_hierarchical` and the distributed
    ``dist_truncate_hierarchical``): at each level, the frontier nodes with
    smallest subtree norms are dropped while the *squared* budget allows (a
    subtree's squared Frobenius norm is exactly the sum of its leaf squares,
    so the accounting is exact); survivors descend.

    Returns ``(keep, nodes_visited)``: ``keep`` is a bool mask over the
    Morton-sorted leaf stack (False = the leaf lies under a dropped subtree)
    with ``sqrt(sum of dropped leaf norms^2) <= tau`` by construction, and
    ``nodes_visited`` counts the frontier nodes whose norms were examined —
    nodes (and leaves) below a dropped subtree are never visited.
    """
    assert qt.norms is not None, "hierarchical drop needs subtree norms"
    nnzb = qt.nnzb
    if nnzb == 0:
        return np.zeros((0,), dtype=bool), 0
    budget_sq = float(tau) ** 2
    drop_mark = np.zeros(nnzb + 1, dtype=np.int64)
    frontier = np.zeros(1, dtype=np.int64)  # root
    visited = 0
    for level in range(qt.depth + 1):
        visited += int(frontier.size)
        sq = qt.norms[level][frontier] ** 2
        order = np.argsort(sq)
        csum = np.cumsum(sq[order])
        ndrop = int(np.searchsorted(csum, budget_sq, side="right"))
        if ndrop:
            budget_sq -= float(csum[ndrop - 1])
            dropped = frontier[order[:ndrop]]
            ls = qt.leaf_start[level]
            np.add.at(drop_mark, ls[dropped], 1)
            np.add.at(drop_mark, ls[dropped + 1], -1)
            keep_nodes = np.ones(frontier.size, dtype=bool)
            keep_nodes[order[:ndrop]] = False
            frontier = frontier[keep_nodes]
        if frontier.size == 0 or level == qt.depth:
            break
        cs = qt.child_start[level]
        s0 = cs[frontier]
        counts = cs[frontier + 1] - s0
        local = np.arange(int(counts.sum())) - np.repeat(np.cumsum(counts) - counts, counts)
        frontier = np.repeat(s0, counts) + local
    keep = np.cumsum(drop_mark[:-1]) == 0
    return keep, visited


def build_quadtree_index(
    coords: np.ndarray,
    leaf_norms: np.ndarray | None = None,
    depth: int | None = None,
) -> QuadtreeIndex:
    """Build a :class:`QuadtreeIndex` from Morton-sorted block coords.

    ``leaf_norms`` (per-block Frobenius norms, stack order) enables the
    subtree-norm levels; omit for a structure-only index.  ``depth`` may be
    raised above the natural grid depth so two operands of a multiply share a
    common root (extra top levels are chains of single nodes).
    """
    coords = np.asarray(coords)
    n = coords.shape[0]
    if depth is None:
        top = int(max(coords.max(initial=0), 1))
        depth = 0
        while (1 << depth) <= top:
            depth += 1
    if n == 0:
        z = np.zeros((0,), dtype=np.uint64)
        s = np.zeros((1,), dtype=np.int64)
        return QuadtreeIndex(
            depth=depth,
            prefixes=tuple(z for _ in range(depth + 1)),
            child_start=tuple(s for _ in range(depth)),
            leaf_start=tuple(s for _ in range(depth + 1)),
            norms=None if leaf_norms is None else tuple(
                np.zeros((0,), dtype=np.float64) for _ in range(depth + 1)
            ),
            fingerprint=structure_fingerprint(z, depth),
        )
    codes = morton_encode(coords[:, 0], coords[:, 1])
    assert np.all(np.diff(codes.astype(np.int64)) > 0), "coords must be Morton-sorted, unique"
    prefixes = [codes >> np.uint64(2 * (depth - k)) for k in range(depth + 1)]
    prefixes = [np.unique(p) for p in prefixes[:-1]] + [prefixes[-1]]
    child_start = []
    for k in range(depth):
        parent = prefixes[k + 1] >> np.uint64(2)
        starts = np.searchsorted(parent, prefixes[k], side="left")
        child_start.append(
            np.concatenate([starts, [prefixes[k + 1].size]]).astype(np.int64)
        )
    leaf_start = [None] * (depth + 1)
    leaf_start[depth] = np.arange(n + 1, dtype=np.int64)
    for k in range(depth - 1, -1, -1):
        leaf_start[k] = leaf_start[k + 1][child_start[k]]
    norms = None
    if leaf_norms is not None:
        leaf_norms = np.asarray(leaf_norms, dtype=np.float64)
        assert leaf_norms.shape == (n,)
        sq = [None] * (depth + 1)
        sq[depth] = leaf_norms**2
        for k in range(depth - 1, -1, -1):
            sq[k] = np.add.reduceat(sq[k + 1], child_start[k][:-1])
        norms = tuple(np.sqrt(s) for s in sq)
    return QuadtreeIndex(
        depth=depth,
        prefixes=tuple(prefixes),
        child_start=tuple(child_start),
        leaf_start=tuple(leaf_start),
        norms=norms,
        fingerprint=structure_fingerprint(codes, depth),
    )
