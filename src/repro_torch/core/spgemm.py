"""Sparse matrix-matrix multiplication over quadtree block structures.

Mirrors the paper's multiplication task templates in two phases:

* **Symbolic** (host, structure only, numpy): enumerate the leaf-level block
  products ``C[c] += A[a] @ B[b]``.  Three implementations, all producing
  identical task sets: the *production path* :func:`spgemm_symbolic_tree`, a
  vectorized level-by-level descent over cached
  :class:`~repro_torch.core.quadtree.QuadtreeIndex` structures; a flat
  hash/merge join (:func:`spgemm_symbolic`); and a literal Python-recursive
  quadtree descent (:func:`spgemm_symbolic_recursive`).  This half is the JAX
  package's code as it is, so the task lists are equal array for array.
* **Numeric** (device): grouped block matmul over the stacked leaf data —
  the hand-written CUDA kernel on the card, its plain PyTorch version on the
  CPU (:mod:`repro_torch.kernels.ops`).

Also provides symmetric multiply (syrk), and SpAMM — the paper's sparse
approximate multiply with norm-based pruning applied *during* the descent
(:func:`spamm_symbolic`): subtree pairs whose ``||A||_F * ||B||_F`` bound
fits the greedy budget are dropped before their leaves are ever enumerated,
with a returned error bound <= tau.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import ops as kops
from .cache import SymbolicCache
from .matrix import BSMatrix, _to_numpy, block_frobenius_norms
from .quadtree import QuadtreeIndex, morton_encode, morton_decode, quadtree_depth

__all__ = [
    "Tasks",
    "spgemm_symbolic",
    "spgemm_symbolic_tree",
    "spgemm_symbolic_recursive",
    "spgemm_numeric",
    "multiply",
    "syrk",
    "symm_square",
    "spamm",
    "spamm_symbolic",
    "task_flops",
]


@dataclasses.dataclass(frozen=True)
class Tasks:
    """Leaf-level multiply task list: C[c_idx[t]] += A[a_idx[t]] @ B[b_idx[t]].

    Tasks are sorted by (c_idx, a_idx); c_coords is Morton-sorted so that
    ``c_idx`` ascending == Morton order of output blocks.
    """

    a_idx: np.ndarray  # [T] int64 into A block stack
    b_idx: np.ndarray  # [T] int64 into B block stack
    c_idx: np.ndarray  # [T] int64 into c_coords
    c_coords: np.ndarray  # [nnzb_c, 2] block coords of the output

    @property
    def num_tasks(self) -> int:
        return int(self.a_idx.shape[0])

    @property
    def num_out(self) -> int:
        return int(self.c_coords.shape[0])


def _empty_tasks() -> Tasks:
    z = np.zeros((0,), dtype=np.int64)
    return Tasks(z, z, z, np.zeros((0, 2), dtype=np.int64))


def _finalize_tasks(a_idx: np.ndarray, b_idx: np.ndarray, ci: np.ndarray, cj: np.ndarray) -> Tasks:
    """Canonical Tasks from raw (a, b, out-row, out-col) pair lists.

    Shared tail of every symbolic phase, so all of them are bit-identical:
    dedupe output codes into Morton-sorted c_coords, lexsort by (c_idx, a_idx)
    — which uniquely orders tasks since b is determined by (a, c).
    """
    codes = morton_encode(ci, cj)
    uniq, c_idx = np.unique(codes, return_inverse=True)
    r, c = morton_decode(uniq)
    c_coords = np.stack([r, c], axis=1)
    order = np.lexsort((a_idx, c_idx))
    return Tasks(
        a_idx=a_idx[order].astype(np.int64),
        b_idx=b_idx[order].astype(np.int64),
        c_idx=c_idx[order].astype(np.int64),
        c_coords=c_coords,
    )


def spgemm_symbolic(a_coords: np.ndarray, b_coords: np.ndarray) -> Tasks:
    """Vectorized symbolic phase: join A's block-cols against B's block-rows."""
    a_coords = np.asarray(a_coords)
    b_coords = np.asarray(b_coords)
    if a_coords.shape[0] == 0 or b_coords.shape[0] == 0:
        return _empty_tasks()

    # group A by k = col, B by k = row
    a_ord = np.argsort(a_coords[:, 1], kind="stable")
    b_ord = np.argsort(b_coords[:, 0], kind="stable")
    ak = a_coords[a_ord, 1]
    bk = b_coords[b_ord, 0]
    a_uk, a_start, a_cnt = np.unique(ak, return_index=True, return_counts=True)
    b_uk, b_start, b_cnt = np.unique(bk, return_index=True, return_counts=True)
    common, ia, ib = np.intersect1d(a_uk, b_uk, assume_unique=True, return_indices=True)
    if common.size == 0:
        return _empty_tasks()
    ca, cb = a_cnt[ia], b_cnt[ib]  # per-k group sizes
    sa, sb = a_start[ia], b_start[ib]  # per-k group starts
    pairs = ca * cb
    total = int(pairs.sum())
    # expand: for group g, a index repeats cb[g] times each; b index tiles ca[g] times
    goff = np.concatenate([[0], np.cumsum(pairs)])[:-1]
    gid = np.repeat(np.arange(common.size), pairs)
    local = np.arange(total) - goff[gid]  # 0..pairs[g)-1 within each group
    a_local = local // cb[gid]
    b_local = local % cb[gid]
    a_idx = a_ord[sa[gid] + a_local]
    b_idx = b_ord[sb[gid] + b_local]

    ci = a_coords[a_idx, 0]
    cj = b_coords[b_idx, 1]
    return _finalize_tasks(a_idx, b_idx, ci, cj)


def _tree_descend(
    ia: QuadtreeIndex,
    ib: QuadtreeIndex,
    tau: float | None,
    *,
    upper_only: bool = False,
) -> tuple[np.ndarray, np.ndarray, float, int]:
    """Vectorized level-synchronous quadtree descent for C = A @ B.

    Expands the frontier of matching (A node, B node) pairs one level at a
    time (the paper's multiplication task recursion, whole levels at once):
    children pairs must agree on the inner quadrant bit, nil children are
    pruned for free by the CSR child spans.  With ``tau`` set, additionally
    applies the SpAMM bound during descent — at each level the smallest
    ``||A_node|| * ||B_node||`` products are greedily dropped while their sum
    fits the remaining budget, so pruned subtrees are *never enumerated*.

    ``upper_only`` restricts the descent to the upper triangle of C (the
    paper's symmetric task types): a node pair whose output node lies
    strictly below the diagonal — A-node row prefix > B-node col prefix —
    can only produce c_row > c_col leaves, so the whole pair is dropped
    mid-descent and its subtree is never expanded; diagonal-straddling pairs
    keep descending and the leaf level applies the exact c_row <= c_col cut.

    Returns ``(leaf_a, leaf_b, err_bound, pairs_visited)``: leaf pairs as
    block-stack indices, the accumulated pruned-bound sum (<= tau), and the
    number of candidate node pairs visited across all levels.
    """
    assert ia.depth == ib.depth, (ia.depth, ib.depth)
    if ia.nnzb == 0 or ib.nnzb == 0:
        z = np.zeros((0,), dtype=np.int64)
        return z, z, 0.0, 0
    if tau is not None and tau > 0:
        assert ia.norms is not None and ib.norms is not None, "SpAMM needs subtree norms"
    ai = np.zeros(1, dtype=np.int64)  # root pair
    bi = np.zeros(1, dtype=np.int64)
    visited = 1
    err = 0.0
    budget = float(tau) if tau is not None else 0.0
    one = np.uint64(1)
    for level in range(ia.depth):
        sa = ia.child_start[level]
        sb = ib.child_start[level]
        sa0, ca = sa[ai], sa[ai + 1] - sa[ai]
        sb0, cb = sb[bi], sb[bi + 1] - sb[bi]
        pairs = ca * cb
        total = int(pairs.sum())
        goff = np.concatenate([[0], np.cumsum(pairs)])[:-1]
        gid = np.repeat(np.arange(pairs.size), pairs)
        local = np.arange(total) - goff[gid]
        ach = sa0[gid] + local // cb[gid]
        bch = sb0[gid] + local % cb[gid]
        # inner-index match: A child quadrant (qi, qk), B child (qk, qj)
        pa = ia.prefixes[level + 1][ach]
        pb = ib.prefixes[level + 1][bch]
        match = (pa & one) == ((pb >> one) & one)
        if upper_only:
            # output node (i, j): i from the A child prefix, j from the B
            # child prefix; strictly-lower nodes cannot reach c_row <= c_col
            i_node, _ = morton_decode(pa)
            _, j_node = morton_decode(pb)
            match &= i_node <= j_node
        ai, bi = ach[match], bch[match]
        visited += int(ai.size)
        if budget > 0.0 and ai.size:
            bound = ia.norms[level + 1][ai] * ib.norms[level + 1][bi]
            order = np.argsort(bound)
            csum = np.cumsum(bound[order])
            ndrop = int(np.searchsorted(csum, budget, side="right"))
            if ndrop:
                pruned = float(csum[ndrop - 1])
                err += pruned
                budget -= pruned
                keep = np.ones(ai.size, dtype=bool)
                keep[order[:ndrop]] = False
                ai, bi = ai[keep], bi[keep]
        if ai.size == 0:
            break
    return ai, bi, err, visited


def _tasks_from_leaf_pairs(ia: QuadtreeIndex, ib: QuadtreeIndex, ai, bi) -> Tasks:
    if ai.size == 0:
        return _empty_tasks()
    ar, _ = morton_decode(ia.prefixes[-1][ai])
    _, bc = morton_decode(ib.prefixes[-1][bi])
    return _finalize_tasks(ai, bi, ar, bc)


def spgemm_symbolic_tree(
    ia: QuadtreeIndex, ib: QuadtreeIndex, *, upper_only: bool = False
) -> Tasks:
    """Symbolic phase via vectorized quadtree descent — the production path.

    Identical output to :func:`spgemm_symbolic` (tested bit-for-bit), but
    structured as the paper's hierarchy walk over cached
    :class:`~repro_torch.core.quadtree.QuadtreeIndex` structures, which is what
    lets SpAMM (:func:`spamm_symbolic`) prune whole subtrees mid-descent.

    ``upper_only`` keeps only tasks with ``c_row <= c_col``, pruned *during*
    the descent (strictly-lower node pairs are never expanded) — the
    symmetric task types (:func:`syrk` / :func:`symm_square`) use it to
    roughly halve their symbolic cost versus enumerate-then-filter, with a
    bit-identical task list (tested).
    """
    ai, bi, _, _ = _tree_descend(ia, ib, tau=None, upper_only=upper_only)
    return _tasks_from_leaf_pairs(ia, ib, ai, bi)


def spamm_symbolic(
    ia: QuadtreeIndex, ib: QuadtreeIndex, tau: float
) -> tuple[Tasks, float, int]:
    """Hierarchical SpAMM symbolic phase.

    Applies the ``||A_node||_F * ||B_node||_F <= remaining-budget`` bound at
    every level of the descent, so a subtree pair pruned at level L never
    expands its up-to-4^(depth-L) leaf tasks.  Returns ``(tasks, err_bound,
    pairs_visited)`` with the guarantee ``||A@B - C||_F <= err_bound <= tau``
    (triangle inequality over the pruned node-pair products).
    """
    ai, bi, err, visited = _tree_descend(ia, ib, tau=tau)
    return _tasks_from_leaf_pairs(ia, ib, ai, bi), err, visited


def spgemm_symbolic_recursive(a_coords: np.ndarray, b_coords: np.ndarray) -> Tasks:
    """Literal quadtree-descent symbolic phase (the paper's task recursion).

    A multiply task at level L on nodes (A_ik, B_kj) registers child tasks for
    every pair of nonzero child quadrants with matching inner index; nil
    children (absent Morton prefixes) are pruned — the fallback execute
    function of the paper.  Equivalent to :func:`spgemm_symbolic` (tested);
    kept as the faithful reference and used by the scheduler's cost model.
    """
    a_coords = np.asarray(a_coords)
    b_coords = np.asarray(b_coords)
    if a_coords.shape[0] == 0 or b_coords.shape[0] == 0:
        return _empty_tasks()
    depth = 0
    top = int(
        max(
            a_coords.max(initial=0),
            b_coords.max(initial=0),
            1,
        )
    )
    while (1 << depth) <= top:
        depth += 1
    # per-level sets of (node codes) plus leaf code -> stack index maps
    a_codes = morton_encode(a_coords[:, 0], a_coords[:, 1])
    b_codes = morton_encode(b_coords[:, 0], b_coords[:, 1])
    a_pos = {int(c): i for i, c in enumerate(a_codes)}
    b_pos = {int(c): i for i, c in enumerate(b_codes)}
    a_levels = [set((a_codes >> np.uint64(2 * (depth - l))).tolist()) for l in range(depth + 1)]
    b_levels = [set((b_codes >> np.uint64(2 * (depth - l))).tolist()) for l in range(depth + 1)]

    out_a, out_b, out_ci, out_cj = [], [], [], []

    def child(prefix: int, qr: int, qc: int) -> int:
        return (prefix << 2) | (qr << 1) | qc

    def descend(an: int, bn: int, level: int) -> None:
        # an encodes (i,k) interleaved; bn encodes (k,j).  Children quadrants
        # are indexed by (qi,qk) for A and (qk,qj) for B.
        if level == depth:
            ar, ac = morton_decode(np.asarray([an], dtype=np.uint64))
            br, bc = morton_decode(np.asarray([bn], dtype=np.uint64))
            out_a.append(a_pos[an])
            out_b.append(b_pos[bn])
            out_ci.append(int(ar[0]))
            out_cj.append(int(bc[0]))
            return
        nl = level + 1
        for qi in range(2):
            for qk in range(2):
                ac = child(an, qi, qk)
                if ac not in a_levels[nl]:
                    continue  # nil chunk id: zero branch pruned
                for qj in range(2):
                    bc = child(bn, qk, qj)
                    if bc in b_levels[nl]:
                        descend(ac, bc, nl)

    descend(0, 0, 0)
    if not out_a:
        return _empty_tasks()
    a_idx = np.asarray(out_a, dtype=np.int64)
    b_idx = np.asarray(out_b, dtype=np.int64)
    codes = morton_encode(np.asarray(out_ci), np.asarray(out_cj))
    uniq, c_idx = np.unique(codes, return_inverse=True)
    r, c = morton_decode(uniq)
    order = np.lexsort((a_idx, c_idx))
    return Tasks(a_idx[order], b_idx[order], c_idx[order].astype(np.int64), np.stack([r, c], axis=1))


def task_flops(tasks: Tasks, bs: int) -> float:
    """Dense-leaf flop count: 2 * bs^3 per task (mul+add)."""
    return 2.0 * float(tasks.num_tasks) * bs**3


def _prune_tasks(tasks: Tasks, keep: np.ndarray) -> Tasks:
    """Restrict a task list to a bool keep mask, dropping orphaned C blocks."""
    kept_out = np.unique(tasks.c_idx[keep])
    remap = -np.ones(tasks.num_out, dtype=np.int64)
    remap[kept_out] = np.arange(kept_out.size)
    return Tasks(
        a_idx=tasks.a_idx[keep],
        b_idx=tasks.b_idx[keep],
        c_idx=remap[tasks.c_idx[keep]],
        c_coords=tasks.c_coords[kept_out],
    )


def _refine_leaf_spamm(
    a: BSMatrix, b: BSMatrix, tasks: Tasks, tau: float, err: float, leaf_spec
) -> tuple[Tasks, float]:
    """Leaf-policy SpAMM refinement: inner-norm product bounds per kept task.

    The hierarchical descent prunes with the leaf bound
    ``||A_leaf||_F * ||B_leaf||_F``; for leaves carrying internal sparsity
    (:class:`repro_torch.core.leaf.LeafSpec` ``block_sparse`` / ``hierarchical``)
    the tighter ``||Na @ Nb||_F`` holds, where ``Na[i, k] = ||A_ik||_F`` over
    the internal blocks: per internal output block,
    ``||(AB)_ij||_F <= sum_k ||A_ik||_F ||B_kj||_F = (Na Nb)_ij``, and by
    Cauchy-Schwarz ``||Na Nb||_F <= ||Na||_F ||Nb||_F`` — so tasks whose
    internal structures barely overlap (disjoint inner masks bound to ~0) are
    dropped within the remaining ``tau`` budget even though their full-leaf
    norm product survived the descent.  Under ``kind="dense"`` the internal
    block is the whole leaf and the bound degenerates to the descent's own,
    so nothing extra can be pruned: the task list is returned untouched,
    bit-identical to the plain path (regression-tested).
    """
    from .leaf import inner_norms

    ibs = a.bs if leaf_spec.kind == "dense" else leaf_spec.inner_bs
    if a.bs // ibs <= 1 or tasks.num_tasks == 0:
        return tasks, err
    na = inner_norms(a, leaf_spec)  # [nnzb_a, ni, ni]
    nb = inner_norms(b, leaf_spec)
    prod = np.einsum("tik,tkj->tij", na[tasks.a_idx], nb[tasks.b_idx])
    bound = np.sqrt(np.sum(prod**2, axis=(1, 2)))
    order = np.argsort(bound)
    csum = np.cumsum(bound[order])
    ndrop = int(np.searchsorted(csum, tau - err, side="right"))
    if ndrop == 0:
        return tasks, err
    keep = np.ones(tasks.num_tasks, dtype=bool)
    keep[order[:ndrop]] = False
    return _prune_tasks(tasks, keep), err + float(csum[ndrop - 1])


def spgemm_numeric(
    a_data: torch.Tensor,
    b_data: torch.Tensor,
    tasks: Tasks,
    *,
    impl: str = "auto",
    out_dtype=None,
) -> torch.Tensor:
    """Numeric phase: grouped block matmul C[c] += A[a] @ B[b].

    impl: ``"auto"`` (the CUDA kernel for tensors on the card, the plain
    version for tensors on the CPU), ``"kernel"`` (the CUDA kernel; raises
    off the card) or ``"ref"`` (the plain version on any device).
    """
    out_dtype = out_dtype or a_data.dtype
    bs = a_data.shape[-2]
    if tasks.num_tasks == 0:
        return torch.zeros((0, bs, b_data.shape[-1]), dtype=out_dtype, device=a_data.device)
    return kops.block_spmm(
        a_data, b_data, tasks.a_idx, tasks.b_idx, tasks.c_idx, tasks.num_out, impl=impl
    ).to(out_dtype)


def _common_depth(a: BSMatrix, b: BSMatrix) -> int:
    """Shared quadtree depth so both operands hang off one root."""
    return max(quadtree_depth(*a.nblocks), quadtree_depth(*b.nblocks))


def multiply(
    a: BSMatrix, b: BSMatrix, *, impl: str = "auto", cache: SymbolicCache | None = None
) -> BSMatrix:
    """C = A @ B (regular multiplication task type).

    The symbolic phase is the vectorized quadtree descent over the operands'
    cached :class:`~repro_torch.core.quadtree.QuadtreeIndex` structures; pass
    a :class:`~repro_torch.core.cache.SymbolicCache` to skip it entirely
    whenever the pair of sparsity patterns has been seen before (iterative
    algorithms — see :func:`repro_torch.core.purify.sp2_purify`).
    """
    assert a.shape[1] == b.shape[0], (a.shape, b.shape)
    assert a.bs == b.bs

    def build() -> Tasks:
        depth = _common_depth(a, b)
        return spgemm_symbolic_tree(
            a.quadtree_index(depth, with_norms=False),
            b.quadtree_index(depth, with_norms=False),
        )

    if cache is None:
        tasks = build()
    else:
        tasks = cache.get_or_build(
            ("spgemm", a.structure_key, b.structure_key), build
        )
    data = spgemm_numeric(a.data, b.data, tasks, impl=impl)
    return BSMatrix(
        shape=(a.shape[0], b.shape[1]), bs=a.bs, coords=tasks.c_coords, data=data
    )


def syrk(a: BSMatrix, *, impl: str = "auto") -> BSMatrix:
    """Symmetric rank-k construction: C = A @ A^T, exploiting symmetry.

    Only tasks with c_row <= c_col are computed — via the ``upper_only``
    hierarchy descent, so strictly-lower subtree pairs are pruned before
    their leaves are ever enumerated — and the mirror is materialized by
    transposing the strictly-upper blocks (paper: symmetric square / rank-k
    task types).
    """
    at = a.transpose()
    depth = _common_depth(a, at)
    upper = spgemm_symbolic_tree(
        a.quadtree_index(depth, with_norms=False),
        at.quadtree_index(depth, with_norms=False),
        upper_only=True,
    )
    data = spgemm_numeric(a.data, at.data, upper, impl=impl)
    upper_m = BSMatrix(shape=(a.shape[0], a.shape[0]), bs=a.bs, coords=upper.c_coords, data=data)
    strict = upper.c_coords[:, 0] < upper.c_coords[:, 1]
    if not strict.any():
        return upper_m
    mirror_coords = upper.c_coords[strict][:, ::-1]
    mirror_data = data[torch.from_numpy(np.nonzero(strict)[0]).to(data.device)].transpose(1, 2)
    return BSMatrix.from_blocks(
        (a.shape[0], a.shape[0]),
        a.bs,
        np.concatenate([upper.c_coords, mirror_coords]),
        torch.cat([data, mirror_data]),
        device=data.device,
    )


def symm_square(a: BSMatrix, *, impl: str = "auto") -> BSMatrix:
    """Symmetric matrix square (paper task type): for symmetric A,
    A^2 = A A^T, so only the upper triangle is computed and mirrored."""
    return syrk(a, impl=impl)


def spamm(
    a: BSMatrix,
    b: BSMatrix,
    tau: float,
    *,
    impl: str = "auto",
    method: str = "hierarchical",
    leaf_spec=None,
):
    """Sparse approximate multiply (paper: SpAMM task type).

    Skips work whose contribution bound ||A_node||_F * ||B_node||_F fits a
    greedy budget so the *total* skipped bound <= tau.  Returns
    (C, error_bound) with ||AB - C||_F <= error_bound <= tau.

    ``method="hierarchical"`` (default) prunes during the quadtree descent
    (:func:`spamm_symbolic`): a dropped subtree pair is never enumerated, so
    the symbolic cost shrinks with the dropped work.  ``method="leaf"`` is
    the flat reference: enumerate every leaf task, then prune.

    ``leaf_spec`` (a :class:`repro_torch.core.leaf.LeafSpec`) extends either
    method's pruning below leaf granularity: surviving tasks are re-bounded
    with the inner-norm product ``||Na @ Nb||_F`` (tighter than the leaf
    norm product for block-sparse leaves; identical to it for
    ``kind="dense"``) and further pruned within the remaining budget — see
    :func:`_refine_leaf_spamm`.
    """
    zeros = lambda: BSMatrix.zeros((a.shape[0], b.shape[1]), a.bs, a.dtype, device=a.device)
    if method == "hierarchical":
        depth = _common_depth(a, b)
        tasks, err, _ = spamm_symbolic(
            a.quadtree_index(depth), b.quadtree_index(depth), tau
        )
        if leaf_spec is not None:
            tasks, err = _refine_leaf_spamm(a, b, tasks, tau, err, leaf_spec)
        if tasks.num_tasks == 0:
            return zeros(), err
        data = spgemm_numeric(a.data, b.data, tasks, impl=impl)
        return (
            BSMatrix(
                shape=(a.shape[0], b.shape[1]),
                bs=a.bs,
                coords=tasks.c_coords,
                data=data,
            ),
            err,
        )
    assert method == "leaf", method
    tasks = spgemm_symbolic(a.coords, b.coords)
    if tasks.num_tasks == 0:
        return zeros(), 0.0
    na = _to_numpy(block_frobenius_norms(a.data)).astype(np.float64)
    nb = _to_numpy(block_frobenius_norms(b.data)).astype(np.float64)
    bound = na[tasks.a_idx] * nb[tasks.b_idx]
    order = np.argsort(bound)
    csum = np.cumsum(bound[order])
    ndrop = int(np.searchsorted(csum, tau, side="right"))
    drop = np.zeros(tasks.num_tasks, dtype=bool)
    drop[order[:ndrop]] = True
    err = float(csum[ndrop - 1]) if ndrop else 0.0
    kept = _prune_tasks(tasks, ~drop)
    if leaf_spec is not None:
        kept, err = _refine_leaf_spamm(a, b, kept, tau, err, leaf_spec)
    if kept.num_tasks == 0:
        return zeros(), err
    data = spgemm_numeric(a.data, b.data, kept, impl=impl)
    return (
        BSMatrix(shape=(a.shape[0], b.shape[1]), bs=a.bs, coords=kept.c_coords, data=data),
        err,
    )
