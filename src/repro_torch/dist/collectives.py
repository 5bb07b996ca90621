"""Distributed linear-algebra collectives over resident stores.

Everything here follows the shape of the multiply schedule: a host-side
symbolic phase per *structure* (cached in :class:`~repro_torch.dist.cache.PlanCache`)
producing small index arrays, uploaded once to the mesh's device, and a
device phase that only ever touches the resident ``[P, cap, bs, bs]``
stores.  The P workers live on one device as the leading store axis
(:mod:`repro_torch.core.distributed`), so a planned exchange round is a
gather along that axis and a ``psum`` is a sum over it; every gather here
reads each source row once, with no scatter-add and no atomics.

* :func:`dist_add` — C = alpha*A + beta*B, structure union with owner-aligned
  re-slotting: union blocks inherit A's owner where present, else B's, so
  only B-copies of overlapping blocks ever cross between workers (planned
  as exchange rounds via :func:`repro_torch.core.schedule.plan_fetch`).  Each
  output slot takes at most one block of each operand, so the add is a
  gather plus ``alpha*a + beta*b``.
* :func:`dist_trace` / :func:`dist_frobenius_norm` — reductions whose order
  depends on the structure alone (see :class:`_ReduceExecutable`), so a
  re-layout cannot flip a decision taken on them.
* :func:`dist_truncate` — device-computed block norms, host symbolic
  selection (identical error control to :func:`repro_torch.core.truncate.truncate`),
  device-side compaction gather; blocks keep their owners so no data moves.
* :func:`dist_truncate_hierarchical` — the same compaction, but the symbolic
  selection is the quadtree subtree-drop descent
  (:func:`repro_torch.core.quadtree.hierarchical_drop_mask`) over a
  :class:`~repro_torch.core.quadtree.QuadtreeIndex` built from the resident
  norm table: dropped subtrees' leaves are never enumerated, and only the
  ``[nnzb]`` norm vector crosses device -> host.
* :func:`dist_transpose`, :func:`dist_repartition`, :func:`dist_submatrix`
  and :func:`dist_assemble2x2` — owner-inheriting transpose, the load
  balancer's owner re-layout, and the quadrant slice / glue of the inverse
  factorization.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.distributed import _exchange_bufs, _upload
from ..core.quadtree import (
    build_quadtree_index,
    hierarchical_drop_mask,
    morton_decode,
    morton_sort,
    quadtree_depth,
    structure_fingerprint,
)
from ..core.matrix import _to_numpy
from ..core.schedule import _owner_slots, local_fetch_index, plan_fetch
from ..obs.timing import timed_into
from ..obs.tracer import tracer_of
from .cache import PlanCache
from .matrix import DistBSMatrix, mesh_key, resident_block_norms

__all__ = [
    "dist_add",
    "dist_scale",
    "dist_trace",
    "dist_frobenius_norm",
    "dist_transpose",
    "dist_repartition",
    "RepartitionExecutable",
    "dist_submatrix",
    "dist_assemble2x2",
    "dist_truncate",
    "dist_truncate_hierarchical",
    "transpose_permutation",
]


def _structure_key(a: DistBSMatrix) -> tuple:
    return (
        structure_fingerprint(a.codes(), a.owner, a.nparts, a.bs),
        mesh_key(a.mesh),
    )


def _acc_dtype(*dtypes) -> torch.dtype:
    """Accumulate in at least float32, wider if the stores are wider."""
    out = torch.float32
    for dt in dtypes:
        out = torch.promote_types(out, dt)
    return out


def _cap(stores) -> int:
    return max(max((len(s) for s in stores), default=0), 1)


class _Gather:
    """``[P, cap_out]`` row gather out of a per-worker buffer, zero where ``gval`` is 0.

    The device half shared by every re-slotting collective: output slot
    ``(p, j)`` reads row ``gidx[p, j]`` of worker ``p``'s buffer (its own
    store, or ``[own store | recv rounds...]`` after an exchange) and is
    multiplied by ``gval[p, j]`` (1 for a valid slot, 0 for padding).
    """

    def __init__(self, device, gidx: np.ndarray, gval: np.ndarray):
        self._p = _upload(np.arange(gidx.shape[0])[:, None], device)
        self._gidx = _upload(gidx, device)
        self._gval = _upload(gval, device, np.float32)

    def __call__(self, buf: torch.Tensor) -> torch.Tensor:
        return buf[self._p, self._gidx] * self._gval.to(buf.dtype)[..., None, None]


# --------------------------------------------------------------------------
# add
# --------------------------------------------------------------------------


class AddExecutable:
    """Planned structure-union add bound to a mesh; alpha/beta are call-time
    scalars so one executable serves every coefficient pair."""

    def __init__(self, a: DistBSMatrix, b: DistBSMatrix):
        nparts, dev = a.nparts, a.device
        a_codes, b_codes = a.codes(), b.codes()
        c_codes = np.union1d(a_codes, b_codes)  # sorted == Morton order
        nc = int(c_codes.size)
        pos_a = np.searchsorted(c_codes, a_codes)
        pos_b = np.searchsorted(c_codes, b_codes)
        # owner-aligned re-slotting: A's owner wins on overlap -> A blocks
        # never move; B-only blocks inherit B's owner and never move either.
        c_owner = np.zeros(nc, dtype=np.int32)
        c_owner[pos_b] = b.owner
        c_owner[pos_a] = a.owner
        c_slot, c_stores = _owner_slots(c_owner, nparts)
        c_cap = _cap(c_stores)

        # which A/B blocks each worker needs: the source blocks of the union
        # entries it owns (ascending by construction; plan_fetch skips the
        # ones whose source copy is already local)
        def needs(x_pos):
            dst_of = c_owner[x_pos]
            return [np.nonzero(dst_of == p)[0].astype(np.int64) for p in range(nparts)]

        a_offsets, a_send, a_send_cnt, a_recv = plan_fetch(a.owner, a.slot, needs(pos_a), nparts)
        b_offsets, b_send, b_send_cnt, b_recv = plan_fetch(b.owner, b.slot, needs(pos_b), nparts)

        # union position -> source block index (or -1)
        from_a = -np.ones(nc, dtype=np.int64)
        from_b = -np.ones(nc, dtype=np.int64)
        from_a[pos_a] = np.arange(a.nnzb)
        from_b[pos_b] = np.arange(b.nnzb)

        idx_a = np.zeros((nparts, c_cap), dtype=np.int64)
        idx_b = np.zeros((nparts, c_cap), dtype=np.int64)
        val_a = np.zeros((nparts, c_cap), dtype=np.float32)
        val_b = np.zeros((nparts, c_cap), dtype=np.float32)
        for p, s in enumerate(c_stores):
            for local, u in enumerate(s):
                ga, gb = from_a[u], from_b[u]
                if ga >= 0:
                    idx_a[p, local] = local_fetch_index(
                        a.owner, a.slot, a_offsets, a_send, a_recv, a.cap, ga, p)
                    val_a[p, local] = 1.0
                if gb >= 0:
                    idx_b[p, local] = local_fetch_index(
                        b.owner, b.slot, b_offsets, b_send, b_recv, b.cap, gb, p)
                    val_b[p, local] = 1.0

        # host-side plan copy for static verification at plan-cache
        # admission (repro_torch.analysis.verify, kind="add") — the device
        # arrays are not what the verifier reads
        self._verify_plan = dict(
            kind="add", nparts=nparts,
            a_owner=np.asarray(a.owner), a_slot=np.asarray(a.slot), a_cap=a.cap,
            b_owner=np.asarray(b.owner), b_slot=np.asarray(b.slot), b_cap=b.cap,
            pos_a=pos_a, pos_b=pos_b, from_a=from_a, from_b=from_b,
            c_owner=c_owner, c_slot=c_slot, c_cap=c_cap,
            a_offsets=a_offsets, a_send=a_send, a_send_cnt=a_send_cnt,
            b_offsets=b_offsets, b_send=b_send, b_send_cnt=b_send_cnt,
            idx_a=idx_a, idx_b=idx_b, val_a=val_a, val_b=val_b,
        )

        r, c = morton_decode(c_codes)
        self.c_coords = np.stack([r, c], axis=1)
        self.c_owner = c_owner
        self.c_slot = c_slot
        self.c_cap = c_cap
        self.mesh = a.mesh
        self._a_offsets, self._b_offsets = a_offsets, b_offsets
        self._a_sends = [_upload(a_send[d], dev) for d in a_offsets]
        self._b_sends = [_upload(b_send[d], dev) for d in b_offsets]
        self._gather_a = _Gather(dev, idx_a, val_a)
        self._gather_b = _Gather(dev, idx_b, val_b)

    def __call__(self, a_store, b_store, alpha, beta) -> torch.Tensor:
        acc = _acc_dtype(a_store.dtype, b_store.dtype)
        a_all = _exchange_bufs(a_store, self._a_offsets, self._a_sends).to(acc)
        b_all = _exchange_bufs(b_store, self._b_offsets, self._b_sends).to(acc)
        # the JAX package's expression order: alpha * a * val_a + beta * b * val_b,
        # with alpha and beta rounded to fp32 first
        c = self._gather_a(a_all) * float(np.float32(alpha))
        c += self._gather_b(b_all) * float(np.float32(beta))
        return c


def dist_add(
    a: DistBSMatrix,
    b: DistBSMatrix,
    alpha=1.0,
    beta=1.0,
    cache: PlanCache | None = None,
) -> DistBSMatrix:
    """C = alpha*A + beta*B on resident stores; structure-union plan cached."""
    if a.shape != b.shape or a.bs != b.bs or a.mesh != b.mesh:
        raise ValueError(f"dist_add of {a.shape} (bs {a.bs}) and {b.shape} (bs {b.bs}) "
                         "on one mesh")
    tr = tracer_of(cache)
    key = ("add", _structure_key(a), _structure_key(b))
    build = lambda: AddExecutable(a, b)  # noqa: E731
    with tr.span("dist_add", cat="collective", nnzb_a=a.nnzb, nnzb_b=b.nnzb):
        exe = cache.get_or_build(key, build) if cache is not None else build()
        with tr.span("dispatch", cat="kernel", op="add") as sp:
            store = tr.sync(exe(a.store, b.store, alpha, beta).to(
                torch.promote_types(a.dtype, b.dtype)))
            if tr.enabled:
                sp.worker_costs = np.bincount(exe.c_owner, minlength=a.nparts).astype(np.float64)
    return DistBSMatrix(
        shape=tuple(a.shape), bs=a.bs, coords=exe.c_coords, owner=exe.c_owner,
        slot=exe.c_slot, cap=exe.c_cap, store=store, mesh=a.mesh,
    )


def dist_scale(a: DistBSMatrix, alpha) -> DistBSMatrix:
    """alpha * A; purely local, no plan needed."""
    return a.scale(alpha)


# --------------------------------------------------------------------------
# reductions
# --------------------------------------------------------------------------


class _ReduceExecutable:
    """A resident reduction whose summation order is fixed by the structure.

    The JAX package sums each device's masked slots and then ``psum``s over
    the mesh, an order that follows the owner layout.  Here the blocks the
    reduction reads are gathered into stack (Morton) order first — a
    ``[k, bs, bs]`` tensor whose shape and contents do not depend on which
    worker holds which block — then each block is reduced to its partial
    and the partials are summed, both over that tensor.  So a re-layout
    (:func:`dist_repartition`) cannot change a single bit of the result, and
    SP2's branch and stop decisions, which compare these scalars, are the
    same in a rebalanced and a static run.  Against the JAX package the
    values agree to rounding, not bit for bit.
    """

    def __init__(self, a: DistBSMatrix, blocks: np.ndarray, kind: str):
        self._owner = _upload(a.owner[blocks], a.device)
        self._slot = _upload(a.slot[blocks], a.device)
        self._kind = kind

    def __call__(self, store: torch.Tensor) -> torch.Tensor:
        acc = _acc_dtype(store.dtype)
        if self._kind == "trace":
            diag = store.diagonal(dim1=2, dim2=3)[self._owner, self._slot].to(acc)
            return diag.sum(dim=1).sum()
        blocks = store[self._owner, self._slot].to(acc)
        return torch.sum(torch.square(blocks), dim=(1, 2)).sum()


def dist_trace(a: DistBSMatrix, cache: PlanCache | None = None) -> float:
    """trace(A): per-diagonal-block traces summed in stack order (one host read)."""
    def build():
        diag = np.nonzero(a.coords[:, 0] == a.coords[:, 1])[0]
        return _ReduceExecutable(a, diag, "trace")

    tr = tracer_of(cache)
    with tr.span("dist_trace", cat="collective", nnzb=a.nnzb):
        key = ("trace", _structure_key(a))
        exe = cache.get_or_build(key, build) if cache is not None else build()
        return float(exe(a.store))


def dist_frobenius_norm(a: DistBSMatrix, cache: PlanCache | None = None) -> float:
    """||A||_F: per-block sums of squares summed in stack order (one host read)."""
    def build():
        return _ReduceExecutable(a, np.arange(a.nnzb), "sumsq")

    tr = tracer_of(cache)
    with tr.span("dist_fro", cat="collective", nnzb=a.nnzb):
        key = ("fro", _structure_key(a))
        exe = cache.get_or_build(key, build) if cache is not None else build()
        return float(torch.sqrt(exe(a.store)))


# --------------------------------------------------------------------------
# truncation
# --------------------------------------------------------------------------


def _compact_to_kept(
    a: DistBSMatrix,
    kept: np.ndarray,
    cache: PlanCache | None,
    *,
    coords: np.ndarray | None = None,
    shape: tuple[int, int] | None = None,
    kind: str = "truncate",
) -> DistBSMatrix:
    """Device-side compaction onto a kept subset of the block stack.

    Shared tail of both truncation variants and of the resident quadrant
    slice (:func:`dist_submatrix`): blocks keep their owners (slots just
    close ranks within each worker), so compaction never moves block data
    between workers; the gather executable is cached per
    (structure, kept-set).  ``kept`` may carry any order — slots follow its
    order per owner, so slicers that re-sort shifted coordinates into Morton
    order preserve the store layout invariant.  ``coords`` / ``shape``
    override the result structure (slices shift coordinates and shrink the
    logical shape; the executable itself depends only on the kept set).
    """
    new_owner = a.owner[kept]
    new_slot, new_stores = _owner_slots(new_owner, a.nparts)
    new_cap = _cap(new_stores)
    gidx = np.zeros((a.nparts, new_cap), dtype=np.int64)
    gval = np.zeros((a.nparts, new_cap), dtype=np.float32)
    for p, s in enumerate(new_stores):
        gidx[p, : len(s)] = a.slot[kept[s]]
        gval[p, : len(s)] = 1.0

    key = (kind, _structure_key(a), structure_fingerprint(kept))

    def build():
        exe = _Gather(a.device, gidx, gval)
        # host-side plan copy for static verification at cache admission
        # (repro_torch.analysis.verify, kind="compact")
        exe._verify_plan = dict(
            kind="compact", label=kind, nparts=a.nparts,
            a_owner=np.asarray(a.owner), a_slot=np.asarray(a.slot), a_cap=a.cap,
            kept=np.asarray(kept, dtype=np.int64), new_owner=new_owner,
            new_slot=new_slot, new_cap=new_cap, gidx=gidx, gval=gval,
        )
        return exe

    exe = cache.get_or_build(key, build) if cache is not None else build()
    return DistBSMatrix(
        shape=tuple(a.shape) if shape is None else tuple(shape),
        bs=a.bs,
        coords=a.coords[kept] if coords is None else coords,
        owner=new_owner,
        slot=new_slot,
        cap=new_cap,
        store=exe(a.store),
        mesh=a.mesh,
    )


def dist_truncate(
    a: DistBSMatrix, tau: float, cache: PlanCache | None = None
) -> DistBSMatrix:
    """Drop smallest-norm blocks with sqrt(sum of dropped norms^2) <= tau.

    Block sums of squares are computed on the device over the stack-order
    blocks (only the ``[nnzb]`` vector crosses to the host); the greedy
    global selection is the same error control as
    :func:`repro_torch.core.truncate.truncate`; surviving blocks are
    compacted device-side and keep their owners, so truncation moves no
    block data between workers.
    """
    if a.nnzb == 0 or tau <= 0:
        return a
    # device fetch stays OUTSIDE the symbolic account (same rule as the
    # hierarchical path, which times only the descent)
    n_sq = _to_numpy(torch.sum(torch.square(a.stack_blocks().float()), dim=(1, 2)))
    with timed_into(cache, "symbolic_s", tracer_of(cache), "truncate_select",
                    cat="symbolic", nnzb=a.nnzb):
        n_sq = n_sq.astype(np.float64)
        order = np.argsort(n_sq)
        csum = np.sqrt(np.cumsum(n_sq[order]))
        ndrop = int(np.searchsorted(csum, tau, side="right"))
    if ndrop == 0:
        return a
    keep = np.ones(a.nnzb, dtype=bool)
    keep[order[:ndrop]] = False
    return _compact_to_kept(a, np.nonzero(keep)[0], cache)


def dist_truncate_hierarchical(
    a: DistBSMatrix,
    tau: float,
    cache: PlanCache | None = None,
    *,
    norms: np.ndarray | None = None,
    stats: dict | None = None,
) -> DistBSMatrix:
    """Truncate by dropping whole quadtree subtrees first — resident variant.

    Builds a :class:`~repro_torch.core.quadtree.QuadtreeIndex` from the
    resident per-block norm table (one ``[nnzb]`` device->host transfer, or
    none when ``norms`` is supplied by a caller that already fetched it) and
    runs the same top-down subtree-drop descent as
    :func:`repro_torch.core.truncate.truncate_hierarchical` — identical kept
    set on identical inputs, same global guarantee ``||A - T(A)||_F <= tau``,
    and a subtree dropped at level L is removed without its leaves ever being
    enumerated.  Survivors are compacted device-side keeping their owners, so
    no block data moves between workers.

    ``stats``, when a dict, receives ``nodes_visited`` (frontier nodes whose
    norms the descent examined) and ``kept`` (surviving stack indices) — the
    SP2 driver uses ``kept`` to carry the norm table forward to the next
    iteration's SpAMM without a fresh fetch.
    """
    if stats is not None:
        stats["nodes_visited"] = 0
        stats["kept"] = np.arange(a.nnzb, dtype=np.int64)
    if a.nnzb == 0 or tau <= 0:
        return a
    if norms is None:
        # outside the symbolic timer: a miss on the norm executable is timed
        # into cache.build_s by get_or_build
        norms = resident_block_norms(a, cache)
    with timed_into(cache, "symbolic_s", tracer_of(cache), "hierarchical_drop",
                    cat="symbolic", nnzb=a.nnzb):
        depth = quadtree_depth(-(-a.shape[0] // a.bs), -(-a.shape[1] // a.bs))
        qt = build_quadtree_index(a.coords, norms, depth=depth)
        keep, visited = hierarchical_drop_mask(qt, tau)
    if stats is not None:
        stats["nodes_visited"] = visited
    if keep.all():
        return a
    kept = np.nonzero(keep)[0]
    if stats is not None:
        stats["kept"] = kept
    return _compact_to_kept(a, kept, cache)


# --------------------------------------------------------------------------
# transpose and repartition (owner re-layout)
# --------------------------------------------------------------------------


def transpose_permutation(coords: np.ndarray) -> np.ndarray:
    """``perm`` with ``perm[i]`` = source stack index of transposed block i.

    Pure structure: the transposed stack in Morton order pulls block ``i``
    from position ``perm[i]`` of the original stack.  Block Frobenius norms
    are transpose-invariant, so ``norms[perm]`` is the transposed matrix's
    norm table — callers holding a current table (the refinement loop in
    :mod:`repro_torch.dist.inverse`) reuse it without a fresh device fetch.
    """
    return morton_sort(np.asarray(coords)[:, ::-1])


class _RelayoutExecutable:
    """Output stack position ``o`` lives on worker ``out_owner[o]`` and pulls
    source block ``src[o]`` out of X's resident layout.

    Blocks already local gather from the store, the rest travel in planned
    exchange rounds (:func:`repro_torch.core.schedule.plan_fetch`).
    Transpose (``src`` = the transpose permutation) and repartition (``src``
    = identity) are both this plan; ``label`` names which in the host copy
    of the plan that the verifier reads at cache admission.
    """

    def __init__(self, x: DistBSMatrix, out_owner: np.ndarray, src: np.ndarray, label: str):
        nparts = x.nparts
        out_slot, out_stores = _owner_slots(out_owner, nparts)
        out_cap = _cap(out_stores)
        needs = [
            np.unique(src[out_owner == p]) if np.any(out_owner == p)
            else np.zeros(0, np.int64)
            for p in range(nparts)
        ]
        offsets, send, send_cnt, recv = plan_fetch(x.owner, x.slot, needs, nparts)
        gidx = np.zeros((nparts, out_cap), dtype=np.int64)
        gval = np.zeros((nparts, out_cap), dtype=np.float32)
        for p, s in enumerate(out_stores):
            for local, o in enumerate(s):
                gidx[p, local] = local_fetch_index(
                    x.owner, x.slot, offsets, send, recv, x.cap, src[o], p)
                gval[p, local] = 1.0
        self._verify_plan = dict(
            kind="relayout", label=label, nparts=nparts,
            x_owner=np.asarray(x.owner), x_slot=np.asarray(x.slot), x_cap=x.cap,
            src=np.asarray(src), out_owner=np.asarray(out_owner),
            out_slot=np.asarray(out_slot), out_cap=out_cap, offsets=offsets,
            send=send, send_cnt=send_cnt, gidx=gidx, gval=gval,
        )
        # per-source true send counts (stats attribution)
        self.sent_blocks = np.zeros(nparts, dtype=np.int64)
        for d in offsets:
            self.sent_blocks += send_cnt[d]
        self.out_owner = np.asarray(out_owner, dtype=np.int32)
        self.out_slot = out_slot
        self.out_cap = out_cap
        self.mesh = x.mesh
        self._offsets = offsets
        self._sends = [_upload(send[d], x.device) for d in offsets]
        self._gather = _Gather(x.device, gidx, gval)

    def _relayout(self, store: torch.Tensor) -> torch.Tensor:
        return self._gather(_exchange_bufs(store, self._offsets, self._sends))


class TransposeExecutable(_RelayoutExecutable):
    """Planned resident transpose bound to a mesh.

    Every transposed block *inherits its source block's owner* — the cut the
    operand currently has, uniform Morton or dynamically rebalanced, carries
    through unchanged.  That makes the transpose communication-free by
    construction (every gather is local; the planned exchange degenerates to
    zero rounds) and, after a rebalance, keeps the balancer's weighted cut
    instead of re-slotting back to the uniform Morton partition.  Block data
    is transposed on gather.
    """

    def __init__(self, a: DistBSMatrix):
        src = transpose_permutation(a.coords)  # out stack pos -> a stack idx
        super().__init__(a, a.owner[src], src, "transpose")  # inherit the operand's cut
        self.src = src
        self.out_coords = a.coords[src][:, ::-1]

    def __call__(self, store: torch.Tensor) -> torch.Tensor:
        return self._relayout(store).transpose(2, 3).contiguous()


def dist_transpose(
    a: DistBSMatrix, cache: PlanCache | None = None
) -> DistBSMatrix:
    """A^T on the resident store; structure-keyed plan, no host gather.

    The result's owner layout inherits A's (each transposed block stays on
    the worker that owns its source block), so the transpose is
    communication-free and a rebalanced cut survives it; downstream plan
    keys fingerprint the owner map, so plans re-key automatically.
    """
    tr = tracer_of(cache)
    key = ("transpose", _structure_key(a))
    build = lambda: TransposeExecutable(a)  # noqa: E731
    with tr.span("dist_transpose", cat="collective", nnzb=a.nnzb):
        exe = cache.get_or_build(key, build) if cache is not None else build()
        with tr.span("dispatch", cat="kernel", op="transpose") as sp:
            store = tr.sync(exe(a.store))
            if tr.enabled:
                blk = a.bs * a.bs * a.store.element_size()
                shipped = int(exe.sent_blocks.sum())
                sp.args.update(sent_blocks=shipped)
                tr.counter("send_bytes").add(shipped * blk)
                tr.counter("recv_bytes").add(shipped * blk)
                # cost share: blocks each source ships, plus the local gather
                sp.worker_costs = exe.sent_blocks.astype(np.float64) + 1.0
    return DistBSMatrix(
        shape=(a.shape[1], a.shape[0]), bs=a.bs, coords=exe.out_coords,
        owner=exe.out_owner, slot=exe.out_slot, cap=exe.out_cap, store=store,
        mesh=a.mesh,
    )


class RepartitionExecutable(_RelayoutExecutable):
    """Planned owner re-layout bound to a mesh — the dynamic load balancer's
    data-motion primitive (:mod:`repro_torch.dist.balance`).

    Re-slots every block to a caller-supplied new owner map: blocks whose
    owner is unchanged are gathered from the local store, blocks that
    migrate travel between workers in the planned rounds — block payloads
    only, no host round-trip.  Coordinates and stack (Morton) order are
    untouched; slots are reassigned in ascending Morton order within each
    new owner, preserving the layout invariant every planner relies on.
    Downstream plans re-key automatically: every plan-cache key fingerprints
    the owner map, so the first operation after a re-layout plans fresh and
    the cache returns to all-hit once the layout stabilizes.
    """

    def __init__(self, x: DistBSMatrix, new_owner: np.ndarray):
        new_owner = np.asarray(new_owner, dtype=np.int32)
        if new_owner.shape != (x.nnzb,):
            raise ValueError(f"owner map of shape {new_owner.shape} for {x.nnzb} blocks")
        if new_owner.size and (new_owner.min() < 0 or new_owner.max() >= x.nparts):
            raise ValueError(f"owner map assigns blocks outside the mesh of {x.nparts}")
        # a re-layout, not a permutation
        super().__init__(x, new_owner, np.arange(x.nnzb, dtype=np.int64), "repartition")
        self.new_owner = self.out_owner
        self.new_slot = self.out_slot
        self.new_cap = self.out_cap
        self.migrated_blocks = int(np.count_nonzero(new_owner != x.owner))

    def __call__(self, store: torch.Tensor) -> torch.Tensor:
        return self._relayout(store)


def dist_repartition(
    x: DistBSMatrix,
    new_owner: np.ndarray,
    cache: PlanCache | None = None,
    *,
    stats: dict | None = None,
) -> DistBSMatrix:
    """Re-slot X's blocks to ``new_owner`` entirely on the device.

    The resident re-layout collective of the dynamic load balancer
    (:mod:`repro_torch.dist.balance`): structure, values and Morton stack
    order are preserved bit for bit (``gather()`` before and after are
    identical, and so is the stack-order norm table — block values never
    change, only which worker holds them), so a re-layout between iterations
    is invisible to the algorithm and only visible to the schedule.  The
    executable is cached per (structure + old owner, new owner); a no-op map
    (``new_owner == x.owner``) returns ``x`` unchanged without touching the
    cache.

    ``stats``, when a dict, receives ``migrated_blocks`` / ``migrated_bytes``
    (blocks that actually changed owner — the planned rounds ship nothing
    else) and ``sent_blocks_per_worker``.
    """
    new_owner = np.asarray(new_owner, dtype=np.int32)
    if x.nnzb == 0 or np.array_equal(new_owner, x.owner):
        if stats is not None:
            stats["migrated_blocks"] = 0
            stats["migrated_bytes"] = 0
            stats["sent_blocks_per_worker"] = np.zeros(x.nparts, dtype=np.int64)
        return x
    tr = tracer_of(cache)
    key = ("repartition", _structure_key(x), structure_fingerprint(new_owner))
    build = lambda: RepartitionExecutable(x, new_owner)  # noqa: E731
    blk = x.bs * x.bs * x.store.element_size()
    with tr.span("dist_repartition", cat="migration", nnzb=x.nnzb) as msp:
        exe = cache.get_or_build(key, build) if cache is not None else build()
        if stats is not None:
            stats["migrated_blocks"] = exe.migrated_blocks
            stats["migrated_bytes"] = exe.migrated_blocks * blk
            stats["sent_blocks_per_worker"] = exe.sent_blocks.copy()
        with tr.span("dispatch", cat="kernel", op="repartition") as sp:
            store = tr.sync(exe(x.store))
            if tr.enabled:
                msp.args.update(migrated_blocks=exe.migrated_blocks)
                tr.counter("migrated_bytes").add(exe.migrated_blocks * blk)
                # cost share: blocks each source ships, plus the local gather
                sp.worker_costs = exe.sent_blocks.astype(np.float64) + 1.0
    return DistBSMatrix(
        shape=tuple(x.shape), bs=x.bs, coords=x.coords, owner=exe.new_owner,
        slot=exe.new_slot, cap=exe.new_cap, store=store, mesh=x.mesh,
    )


# --------------------------------------------------------------------------
# quadrant slice / assemble
# --------------------------------------------------------------------------


def dist_submatrix(
    a: DistBSMatrix,
    r0: int,
    r1: int,
    c0: int,
    c1: int,
    cache: PlanCache | None = None,
) -> DistBSMatrix:
    """Block-range slice a[r0:r1, c0:c1] on the resident store.

    The resident counterpart of :func:`repro_torch.core.inverse.submatrix`:
    the kept set is an owner-local coordinate mask decided on the host, the
    data motion is the shared device-side compaction
    (:func:`_compact_to_kept`) — blocks keep their owners, so slicing moves
    nothing between workers.
    """
    m = (
        (a.coords[:, 0] >= r0)
        & (a.coords[:, 0] < r1)
        & (a.coords[:, 1] >= c0)
        & (a.coords[:, 1] < c1)
    )
    kept = np.nonzero(m)[0]
    new_coords = a.coords[kept] - np.array([[r0, c0]])
    # quadrant offsets strip a shared Morton prefix, which preserves relative
    # order; re-sort anyway so arbitrary ranges keep the layout invariant
    order = morton_sort(new_coords)
    kept, new_coords = kept[order], new_coords[order]
    rows = min((r1 - r0) * a.bs, max(a.shape[0] - r0 * a.bs, 0))
    cols = min((c1 - c0) * a.bs, max(a.shape[1] - c0 * a.bs, 0))
    return _compact_to_kept(
        a, kept, cache, coords=new_coords, shape=(rows, cols), kind="slice"
    )


class AssembleExecutable:
    """Planned 2x2 quadrant glue bound to a mesh.

    Every output block is one quadrant's block on the worker that already
    owns it — the local buffer is just the four quadrant stores
    concatenated along the slot axis — so assembly moves nothing between
    workers; only the merged slot maps are rebuilt on the host.
    """

    def __init__(self, quads, offsets_rc, mesh):
        nparts = int(mesh.nparts)
        coords, owner, src_q, src_i = [], [], [], []
        for qi, (q, (dr, dc)) in enumerate(zip(quads, offsets_rc)):
            if q.nnzb:
                coords.append(q.coords + np.array([[dr, dc]]))
                owner.append(q.owner)
                src_q.append(np.full(q.nnzb, qi, dtype=np.int64))
                src_i.append(np.arange(q.nnzb, dtype=np.int64))
        if coords:
            coords = np.concatenate(coords)
            owner = np.concatenate(owner)
            src_q = np.concatenate(src_q)
            src_i = np.concatenate(src_i)
        else:
            coords = np.zeros((0, 2), dtype=np.int64)
            owner = np.zeros((0,), dtype=np.int32)
            src_q = src_i = np.zeros((0,), dtype=np.int64)
        order = morton_sort(coords)
        coords, owner = coords[order], owner[order]
        src_q, src_i = src_q[order], src_i[order]
        out_slot, out_stores = _owner_slots(owner, nparts)
        out_cap = _cap(out_stores)

        base = np.concatenate([[0], np.cumsum([q.cap for q in quads])])[:-1]
        gidx = np.zeros((nparts, out_cap), dtype=np.int64)
        gval = np.zeros((nparts, out_cap), dtype=np.float32)
        for p, s in enumerate(out_stores):
            for local, o in enumerate(s):
                gidx[p, local] = base[src_q[o]] + quads[src_q[o]].slot[src_i[o]]
                gval[p, local] = 1.0

        self.out_coords = coords
        self.out_owner = np.asarray(owner, dtype=np.int32)
        self.out_slot = out_slot
        self.out_cap = out_cap
        self._gather = _Gather(mesh.device, gidx, gval)

    def __call__(self, *stores) -> torch.Tensor:
        return self._gather(torch.cat(stores, dim=1))


def dist_assemble2x2(
    a00: DistBSMatrix,
    a01: DistBSMatrix,
    a10: DistBSMatrix,
    a11: DistBSMatrix,
    split: int,
    cache: PlanCache | None = None,
) -> DistBSMatrix:
    """Glue four resident quadrants at block offset ``split``.

    Inverse of :func:`dist_submatrix` over a quadtree split; blocks keep
    their owners, so nothing moves between workers (empty quadrants — the
    zero branches of the factorization — contribute padding only).
    """
    quads = (a00, a01, a10, a11)
    bs = a00.bs
    if any(q.bs != bs or q.mesh != a00.mesh for q in quads):
        raise ValueError("dist_assemble2x2 takes four quadrants of one block size on one mesh")
    shape = (a00.shape[0] + a11.shape[0], a00.shape[1] + a11.shape[1])
    offsets_rc = ((0, 0), (0, split), (split, 0), (split, split))
    key = (
        "assemble",
        tuple(_structure_key(q) for q in quads),
        tuple(tuple(q.shape) for q in quads),
        int(split),
    )
    build = lambda: AssembleExecutable(quads, offsets_rc, a00.mesh)  # noqa: E731
    exe = cache.get_or_build(key, build) if cache is not None else build()
    dtype = a00.dtype
    for q in quads[1:]:
        dtype = torch.promote_types(dtype, q.dtype)
    store = exe(*(q.store.to(dtype) for q in quads))
    return DistBSMatrix(
        shape=shape, bs=bs, coords=exe.out_coords, owner=exe.out_owner,
        slot=exe.out_slot, cap=exe.out_cap, store=store, mesh=a00.mesh,
    )
