"""Locality-aware static scheduling — the CHT runtime analogue for the worker mesh.

CHT-MPI maps chunks and tasks to workers dynamically (decentralized data,
breadth-first work stealing).  The resident runtime runs every worker's step
as one planned program, so the equivalent decisions are made *here*, on the
host, per matrix structure:

* **Data placement** (= chunk placement): Morton-order contiguous range
  partition of the block stacks.  Children of a quadtree node are contiguous
  in Morton order, so this is precisely "blocks of the same subtree live on
  the same worker" — the locality CHT gets from hierarchical chunk identifiers.
* **Task placement** (= task scheduling): owner-of-C computes; the C
  partition is weighted by per-block task counts (flop cost model), which is
  the static equivalent of work stealing achieving flop balance.
* **Communication plan** (= chunk fetching/caching): for every task, its A/B
  operand blocks are either local or fetched from a peer; the full exchange
  is planned here as per-offset exchange rounds (worker ``p`` sends to
  ``(p + d) % P``), and only referenced blocks ever move (CHT's chunk cache
  pulls exactly the chunks tasks touch).

A ``random`` placement mode destroys locality on purpose — it reproduces the
random-permutation baseline family the paper argues against [5, 6, 8], and
the comparison (bytes moved per worker) is the Fig 1c experiment.

This module is numpy only and is the JAX package's ``repro/core/schedule.py``
as it is, so plans are equal array for array.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..analysis.errors import PlanError
from .quadtree import build_quadtree_index, morton_encode, structure_fingerprint
from .spgemm import Tasks, spgemm_symbolic

__all__ = [
    "partition_morton",
    "partition_random",
    "SpgemmPlan",
    "make_spgemm_plan",
    "plan_stats",
    "plan_worker_bytes",
    "plan_byte_provenance",
    "structure_fingerprint",
    "plan_fetch",
    "local_fetch_index",
    "split_local_indices",
    "subtree_boundaries",
]


def subtree_boundaries(coords: np.ndarray) -> np.ndarray | None:
    """Candidate partition cuts: leaf positions starting a quadtree node.

    Returns None when ``coords`` is not Morton-sorted-unique (callers of the
    public planner may pass arbitrary coords; alignment is best-effort).
    """
    coords = np.asarray(coords)
    if coords.shape[0] == 0:
        return None
    codes = morton_encode(coords[:, 0], coords[:, 1]).astype(np.int64)
    if np.any(np.diff(codes) <= 0):
        return None
    return build_quadtree_index(coords).boundaries()


def partition_morton(
    nblocks: int,
    nparts: int,
    weights: np.ndarray | None = None,
    *,
    align: np.ndarray | None = None,
    slack: float = 0.15,
) -> np.ndarray:
    """Owner id per block: contiguous Morton ranges with ~equal total weight.

    Blocks are assumed Morton-sorted (BSMatrix canonical order).  Boundary
    placement is greedy on the weight prefix sum; this bounds the per-part
    overshoot by one block's weight, the static analogue of CHT's balance.

    ``align`` (sorted candidate cut positions, e.g. quadtree node boundaries
    from :func:`subtree_boundaries`) snaps each cut to the nearest candidate
    whose weight displacement stays within ``slack`` of a part's target
    weight — so partitions own whole subtrees where the balance budget
    allows, the locality CHT gets from hierarchical chunk identifiers.
    """
    if nblocks == 0:
        return np.zeros((0,), dtype=np.int32)
    w = np.ones(nblocks) if weights is None else np.asarray(weights, dtype=np.float64)
    w = np.maximum(w, 1e-12)
    csum = np.cumsum(w)
    total = csum[-1]
    # targets at equal weight quantiles
    targets = total * (np.arange(1, nparts) / nparts)
    bounds = np.searchsorted(csum, targets, side="left")
    if align is not None and len(align):
        align = np.unique(np.clip(np.asarray(align, dtype=np.int64), 0, nblocks))
        tol = slack * total / nparts
        w_before = np.concatenate([[0.0], csum])  # weight left of a cut position
        snapped = np.empty_like(bounds)
        for i, (t, b) in enumerate(zip(targets, bounds)):
            pos = np.searchsorted(align, b)
            cand = align[max(pos - 1, 0) : pos + 1]
            if cand.size:
                dist = np.abs(w_before[cand] - t)
                j = int(np.argmin(dist))
                if dist[j] <= tol:
                    b = int(cand[j])
            snapped[i] = b
        bounds = np.maximum.accumulate(snapped)
    owner = np.zeros(nblocks, dtype=np.int32)
    prev = 0
    for p, b in enumerate(np.concatenate([bounds, [nblocks]])):
        owner[prev:b] = p
        prev = b
    return owner


def partition_random(nblocks: int, nparts: int, seed: int = 0) -> np.ndarray:
    """Random-permutation placement (the locality-destroying baseline)."""
    rng = np.random.default_rng(seed)
    owner = np.arange(nblocks, dtype=np.int32) % nparts
    rng.shuffle(owner)
    return owner


def _pad_ragged(lists: list[np.ndarray], pad_val: int) -> np.ndarray:
    cap = max((len(x) for x in lists), default=0)
    cap = max(cap, 1)
    out = np.full((len(lists), cap), pad_val, dtype=np.int32)
    for i, x in enumerate(lists):
        out[i, : len(x)] = x
    return out


@dataclasses.dataclass(frozen=True)
class SpgemmPlan:
    """Host-side static schedule for one distributed multiply C = A @ B.

    All arrays with leading dim P hold one row per worker of the mesh.
    Device-local A buffer layout during execution:
      [ own A store (a_cap) | recv buffers per offset, in offset order ]
    and similarly for B.  Task operand indices point into that layout.
    """

    nparts: int
    bs: int
    exchange: str  # "p2p" (planned exchange rounds) | "allgather" (baseline)
    # block placement: owner[i] and local slot of every global block
    a_owner: np.ndarray
    b_owner: np.ndarray
    a_slot: np.ndarray
    b_slot: np.ndarray
    a_cap: int
    b_cap: int
    a_store_idx: np.ndarray  # [P, a_cap] global A block idx per local slot (pad -> 0)
    b_store_idx: np.ndarray
    a_store_valid: np.ndarray  # [P, a_cap] bool
    b_store_valid: np.ndarray
    # exchange: per offset d, send slot lists  [P, cap_d]
    a_offsets: tuple[int, ...]
    b_offsets: tuple[int, ...]
    a_send: dict[int, np.ndarray]
    b_send: dict[int, np.ndarray]
    a_send_count: dict[int, np.ndarray]  # true counts per device (stats)
    b_send_count: dict[int, np.ndarray]
    # tasks per device (padded): operand idx into device-local buffer layout
    t_cap: int
    task_a: np.ndarray  # [P, t_cap]
    task_b: np.ndarray
    task_c: np.ndarray  # [P, t_cap] local C slot, sorted; pad -> c_cap (trash row)
    task_count: np.ndarray  # [P]
    # output
    c_coords: np.ndarray
    c_owner: np.ndarray
    c_slot: np.ndarray
    c_cap: int
    c_store_idx: np.ndarray  # [P, c_cap] global C block idx (pad -> 0)
    c_store_valid: np.ndarray
    tasks: Tasks
    # [P, t_cap] global task index (into the tasks arrays) per padded device
    # slot (pad -> 0; mask with task_count) — lets a per-call prune pattern
    # over the global task list be relaid into the device task layout without
    # re-planning (delta-plan SpAMM, repro_torch.dist.multiply)
    task_gidx: np.ndarray | None = None
    # fused-engine operand addressing (p2p plans only; None for allgather):
    # task_a == (src == 0 ? off : a_cap + sum(round caps before src-1) + off),
    # decomposed so the fused kernel can gather tiles from the own store
    # (src == 0) or receive buffer src-1 without the concatenated buffer —
    # see repro_torch.kernels.fused_leaf
    task_a_src: np.ndarray | None = None  # [P, t_cap] int32
    task_a_off: np.ndarray | None = None
    task_b_src: np.ndarray | None = None
    task_b_off: np.ndarray | None = None

    @property
    def shapes(self):
        return dict(
            a_cap=self.a_cap, b_cap=self.b_cap, c_cap=self.c_cap, t_cap=self.t_cap
        )


def plan_fetch(x_owner: np.ndarray, x_slot: np.ndarray, needs: list, nparts: int):
    """Plan exchange rounds delivering, to each device, the blocks it needs.

    ``needs[dst]`` is a sorted-unique array of global block indices device
    ``dst`` must end up holding (its own blocks are skipped — they are already
    resident).  Remote blocks arrive via one exchange round per ring offset
    ``d = (dst - src) mod nparts``; the receive layout on ``dst`` is blocks
    sorted by global index, per offset.  Returns ``(offsets, send_pad,
    send_cnt, recv_pos)`` where ``recv_pos[(dst, g)] = (offset, position)``.

    This is the chunk-fetch planner shared by the multiply schedule and the
    device-resident collectives in :mod:`repro_torch.dist`.
    """
    send: dict[int, list] = {}
    recv_pos = {}  # (dst, global block) -> (offset, position)
    for dst in range(nparts):
        need = np.asarray(needs[dst], dtype=np.int64)
        remote = need[x_owner[need] != dst] if need.size else need
        for src in np.unique(x_owner[remote]) if remote.size else []:
            d = int((dst - src) % nparts)
            blocks = remote[x_owner[remote] == src]  # sorted (np.unique)
            send.setdefault(d, [np.zeros(0, np.int32)] * nparts)
            send[d][src] = x_slot[blocks].astype(np.int32)
            for pos, g in enumerate(blocks):
                recv_pos[(dst, int(g))] = (d, pos)
    offsets = tuple(sorted(send.keys()))
    send_pad = {d: _pad_ragged(send[d], 0) for d in offsets}
    send_cnt = {
        d: np.array([len(x) for x in send[d]], dtype=np.int64) for d in offsets
    }
    return offsets, send_pad, send_cnt, recv_pos


def local_fetch_index(
    x_owner, x_slot, offsets, send_pad, recv_pos, cap: int, g: int, dev: int
) -> int:
    """Index of global block ``g`` in device ``dev``'s local p2p buffer.

    Buffer layout during execution: ``[ own store (cap) | recv buffers per
    offset, in offset order ]`` — matches :func:`plan_fetch`'s receive layout.
    """
    if x_owner[g] == dev:
        return int(x_slot[g])
    d, pos = recv_pos[(dev, int(g))]
    base = cap
    for dd in offsets:
        if dd == d:
            break
        base += send_pad[dd].shape[1]
    return base + pos


def split_local_indices(
    idx: np.ndarray, cap: int, round_caps: list[int]
) -> tuple[np.ndarray, np.ndarray]:
    """Decompose p2p buffer indices into fused-engine ``(src, off)`` pairs.

    The staged layout is ``[own store (cap) | recv per offset, in offset
    order]``; ``src == 0`` addresses the own store at row ``off`` and
    ``src == r+1`` addresses receive buffer ``r`` (padded round capacity
    ``round_caps[r]``) at row ``off``.  Vectorized over any index array.
    """
    idx = np.asarray(idx, dtype=np.int64)
    bounds = np.concatenate([[cap], cap + np.cumsum(round_caps)]).astype(np.int64)
    src = np.searchsorted(bounds, idx, side="right").astype(np.int32)
    starts = np.concatenate([[0], bounds[:-1]]).astype(np.int64)
    off = (idx - starts[src]).astype(np.int32)
    return src, off


def _owner_slots(owner: np.ndarray, nparts: int):
    """Local slot per block + per-part store index lists."""
    slot = np.zeros(owner.shape[0], dtype=np.int32)
    stores = []
    for p in range(nparts):
        idx = np.nonzero(owner == p)[0]
        slot[idx] = np.arange(idx.size, dtype=np.int32)
        stores.append(idx.astype(np.int32))
    return slot, stores


def make_spgemm_plan(
    a_coords: np.ndarray,
    b_coords: np.ndarray,
    nparts: int,
    bs: int,
    *,
    placement: str = "morton",  # morton | random
    exchange: str = "p2p",  # p2p | allgather
    tasks: Tasks | None = None,
    seed: int = 0,
    a_owner: np.ndarray | None = None,
    b_owner: np.ndarray | None = None,
    align_subtrees: bool = True,
) -> SpgemmPlan:
    """Plan a distributed multiply: placement, task schedule, exchange.

    ``a_owner`` / ``b_owner`` pin the operand placements to externally-fixed
    maps (device-resident operands — :class:`repro_torch.dist.DistBSMatrix` — whose
    stores must not be reshuffled); when omitted they are chosen here.
    ``tasks`` pins a precomputed (possibly SpAMM-pruned) task list so the
    symbolic phase is not redone.  ``align_subtrees`` snaps Morton partition
    cuts to quadtree node boundaries within the balance slack.
    """
    tasks = tasks if tasks is not None else spgemm_symbolic(a_coords, b_coords)
    na, nb, nc = a_coords.shape[0], b_coords.shape[0], tasks.num_out

    # -- placement (chunk -> worker) ---------------------------------------
    if placement == "morton":
        # weight C blocks by task count (flops); A/B by uniform block weight
        cw = np.bincount(tasks.c_idx, minlength=nc).astype(np.float64)
        c_owner = partition_morton(
            nc,
            nparts,
            cw,
            align=subtree_boundaries(tasks.c_coords) if align_subtrees else None,
        )
        if a_owner is None:
            a_owner = partition_morton(
                na,
                nparts,
                align=subtree_boundaries(a_coords) if align_subtrees else None,
            )
        if b_owner is None:
            b_owner = partition_morton(
                nb,
                nparts,
                align=subtree_boundaries(b_coords) if align_subtrees else None,
            )
    elif placement == "random":
        c_owner = partition_random(nc, nparts, seed)
        if a_owner is None:
            a_owner = partition_random(na, nparts, seed + 1)
        if b_owner is None:
            b_owner = partition_random(nb, nparts, seed + 2)
    else:
        raise ValueError(placement)
    a_owner = np.asarray(a_owner, dtype=np.int32)
    b_owner = np.asarray(b_owner, dtype=np.int32)
    # typed (not assert) so `python -O` keeps the guard: a pinned owner map
    # of the wrong shape or range would silently scramble every store slot
    if a_owner.shape != (na,) or b_owner.shape != (nb,):
        raise PlanError(
            f"pinned owner maps do not match the operand structures: "
            f"a_owner {a_owner.shape} for {na} A blocks, "
            f"b_owner {b_owner.shape} for {nb} B blocks")
    for name, owner, n in (("a", a_owner, na), ("b", b_owner, nb)):
        if n and (int(owner.min()) < 0 or int(owner.max()) >= nparts):
            raise PlanError(
                f"{name}_owner assigns blocks outside the mesh of {nparts} "
                f"(owner range [{int(owner.min())}, {int(owner.max())}])")

    a_slot, a_stores = _owner_slots(a_owner, nparts)
    b_slot, b_stores = _owner_slots(b_owner, nparts)
    c_slot, c_stores = _owner_slots(c_owner, nparts)
    a_cap = max(max((len(s) for s in a_stores), default=0), 1)
    b_cap = max(max((len(s) for s in b_stores), default=0), 1)
    c_cap = max(max((len(s) for s in c_stores), default=0), 1)

    def store_arrays(stores, cap):
        idx = np.zeros((nparts, cap), dtype=np.int32)
        valid = np.zeros((nparts, cap), dtype=bool)
        for p, s in enumerate(stores):
            idx[p, : len(s)] = s
            valid[p, : len(s)] = True
        return idx, valid

    a_store_idx, a_store_valid = store_arrays(a_stores, a_cap)
    b_store_idx, b_store_valid = store_arrays(b_stores, b_cap)
    c_store_idx, c_store_valid = store_arrays(c_stores, c_cap)

    # -- task -> owner of C -------------------------------------------------
    t_owner = c_owner[tasks.c_idx]

    # -- exchange plan (chunk fetches) ---------------------------------------
    # For matrix X in {A, B}: device p needs the distinct X blocks referenced
    # by its tasks; those owned elsewhere arrive via the rounds planned by
    # plan_fetch.
    def _exchange(x_owner, x_slot, ref_idx):
        needs = [
            np.unique(ref_idx[t_owner == p]) if np.any(t_owner == p) else np.zeros(0, np.int64)
            for p in range(nparts)
        ]
        return plan_fetch(x_owner, x_slot, needs, nparts)

    if exchange == "p2p":
        a_offsets, a_send, a_send_cnt, a_recv_pos = _exchange(a_owner, a_slot, tasks.a_idx)
        b_offsets, b_send, b_send_cnt, b_recv_pos = _exchange(b_owner, b_slot, tasks.b_idx)
    else:  # allgather baseline: no planned exchange, full replication
        a_offsets = b_offsets = ()
        a_send = b_send = {}
        a_send_cnt = b_send_cnt = {}
        a_recv_pos = b_recv_pos = {}

    # -- device-local operand indices ----------------------------------------
    # local buffer layout: [store (cap) | offset buffers in tuple order]
    def local_index(x_owner, x_slot, offsets, send_pad, recv_pos, cap, g, dev):
        if exchange == "allgather":
            # gathered layout: [owner0 store | owner1 store | ...]
            return int(x_owner[g]) * cap + int(x_slot[g])
        return local_fetch_index(
            x_owner, x_slot, offsets, send_pad, recv_pos, cap, g, dev
        )

    task_a_l, task_b_l, task_c_l, task_g_l = [], [], [], []
    for p in range(nparts):
        sel = np.nonzero(t_owner == p)[0]
        # keep tasks sorted by local C slot for kernel-friendly accumulation;
        # the stable sort keeps global (symbolic) task order within a C
        # block, so fp32 accumulation order — and hence the result bits —
        # is invariant under owner re-layout (rebalancing stays bit-exact)
        order = np.argsort(c_slot[tasks.c_idx[sel]], kind="stable")
        sel = sel[order]
        task_g_l.append(sel.astype(np.int32))
        ta = np.array(
            [
                local_index(a_owner, a_slot, a_offsets, a_send, a_recv_pos, a_cap, g, p)
                for g in tasks.a_idx[sel]
            ],
            dtype=np.int32,
        )
        tb = np.array(
            [
                local_index(b_owner, b_slot, b_offsets, b_send, b_recv_pos, b_cap, g, p)
                for g in tasks.b_idx[sel]
            ],
            dtype=np.int32,
        )
        tc = c_slot[tasks.c_idx[sel]].astype(np.int32)
        task_a_l.append(ta)
        task_b_l.append(tb)
        task_c_l.append(tc)
    t_cap = max(max((len(x) for x in task_a_l), default=0), 1)
    task_count = np.array([len(x) for x in task_a_l], dtype=np.int64)
    task_a = _pad_ragged(task_a_l, 0)
    task_b = _pad_ragged(task_b_l, 0)
    task_c = _pad_ragged(task_c_l, c_cap)  # trash row
    task_gidx = _pad_ragged(task_g_l, 0)
    # fused-engine addressing (padded slots decompose to (0, 0): store row 0,
    # discarded via the trash row)
    task_a_src = task_a_off = task_b_src = task_b_off = None
    if exchange == "p2p":
        task_a_src, task_a_off = split_local_indices(
            task_a, a_cap, [a_send[d].shape[1] for d in a_offsets]
        )
        task_b_src, task_b_off = split_local_indices(
            task_b, b_cap, [b_send[d].shape[1] for d in b_offsets]
        )

    return SpgemmPlan(
        nparts=nparts,
        bs=bs,
        exchange=exchange,
        a_owner=a_owner,
        b_owner=b_owner,
        a_slot=a_slot,
        b_slot=b_slot,
        a_cap=a_cap,
        b_cap=b_cap,
        a_store_idx=a_store_idx,
        b_store_idx=b_store_idx,
        a_store_valid=a_store_valid,
        b_store_valid=b_store_valid,
        a_offsets=a_offsets,
        b_offsets=b_offsets,
        a_send=a_send,
        b_send=b_send,
        a_send_count=a_send_cnt,
        b_send_count=b_send_cnt,
        t_cap=t_cap,
        task_a=task_a,
        task_b=task_b,
        task_c=task_c,
        task_count=task_count,
        c_coords=tasks.c_coords,
        c_owner=c_owner,
        c_slot=c_slot,
        c_cap=c_cap,
        c_store_idx=c_store_idx,
        c_store_valid=c_store_valid,
        tasks=tasks,
        task_gidx=task_gidx,
        task_a_src=task_a_src,
        task_a_off=task_a_off,
        task_b_src=task_b_src,
        task_b_off=task_b_off,
    )


def plan_worker_bytes(plan: SpgemmPlan) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-worker exchange bytes of a plan: (recv_actual, send_actual, recv_padded).

    ``recv_actual`` / ``send_actual`` count the true (unpadded) operand blocks
    each worker receives / ships during the planned exchange rounds;
    ``recv_padded`` is what the SPMD program physically moves (uniform padded
    payloads per exchange round).  This is the per-worker breakdown the
    dynamic load-balancing cost model (:mod:`repro_torch.dist.balance`) consumes —
    a skewed operand layout shows up as one worker shipping everything.
    """
    P = plan.nparts
    itemsize = 4
    blk = plan.bs * plan.bs * itemsize
    recv_actual = np.zeros(P, dtype=np.float64)
    send_actual = np.zeros(P, dtype=np.float64)
    recv_padded = np.zeros(P, dtype=np.float64)
    if plan.exchange == "allgather":
        # every device receives everyone else's full (padded) store and ships
        # its own store to the other P-1 devices
        per_dev = (P - 1) * (plan.a_cap + plan.b_cap) * blk
        recv_padded[:] = per_dev
        a_counts = np.bincount(plan.a_owner, minlength=P)
        b_counts = np.bincount(plan.b_owner, minlength=P)
        recv_actual[:] = (a_counts.sum() + b_counts.sum()) * blk  # upper: full matrices
        for p in range(P):
            recv_actual[p] -= (a_counts[p] + b_counts[p]) * blk
            send_actual[p] = (P - 1) * (a_counts[p] + b_counts[p]) * blk
    else:
        for offs, send_cnt, send_pad in (
            (plan.a_offsets, plan.a_send_count, plan.a_send),
            (plan.b_offsets, plan.b_send_count, plan.b_send),
        ):
            for d in offs:
                cnt = send_cnt[d]  # indexed by src; dst = (src + d) % P
                for src in range(P):
                    dst = (src + d) % P
                    recv_actual[dst] += cnt[src] * blk
                    send_actual[src] += cnt[src] * blk
                    recv_padded[dst] += send_pad[d].shape[1] * blk
    return recv_actual, send_actual, recv_padded


def plan_byte_provenance(plan: SpgemmPlan) -> dict:
    """Per-task, per-round provenance of every operand byte a plan touches.

    Extends :func:`plan_worker_bytes` (per-worker exchange totals) down to
    the level the locality ledger (:mod:`repro_torch.obs.locality`) meters:

    * ``referenced`` / ``local`` / ``shipped`` — per-worker bytes of the
      *distinct* operand blocks each worker's task list reads, split by
      whether the block is resident (owned) or fetched.  Counted at fp32
      itemsize so ``local + shipped == referenced`` holds exactly and, for
      p2p plans, ``shipped`` equals ``plan_worker_bytes``'s ``recv_actual``
      bit-for-bit (the planned exchange delivers precisely the distinct
      remote references).
    * ``task_local`` — ``[P, t_cap]`` bool, True where *both* operands of a
      padded task slot are locally owned (padding is False); ``local_tasks``
      is its per-worker row sum — the locally-satisfied flop count.
    * ``rounds`` — one record per planned exchange round (execution
      order: A rounds then B rounds) with per-worker actual/padded
      block counts, for the executed-task-graph analyzer.
    * ``fetch_a`` / ``fetch_b`` — flat ``(gids, src, dst)`` arrays: global
      block index, owning worker, fetching worker for every planned remote
      reference — the per-block movement-lineage feed.

    All quantities are static plan properties; delta-mask pruning and bf16
    wire halving are applied by the ledger at dispatch time.
    """
    P = plan.nparts
    blk = plan.bs * plan.bs * 4
    tasks = plan.tasks
    t_owner = plan.c_owner[tasks.c_idx] if tasks.c_idx.size else np.zeros(0, np.int32)
    referenced = np.zeros(P, dtype=np.float64)
    local = np.zeros(P, dtype=np.float64)
    shipped = np.zeros(P, dtype=np.float64)
    fetch = {}
    for name, owner, ref_idx in (
        ("a", plan.a_owner, tasks.a_idx),
        ("b", plan.b_owner, tasks.b_idx),
    ):
        gids_l, src_l, dst_l = [], [], []
        for p in range(P):
            refs = np.unique(ref_idx[t_owner == p]) if ref_idx.size else np.zeros(0, np.int64)
            own = int((owner[refs] == p).sum()) if refs.size else 0
            referenced[p] += refs.size * blk
            local[p] += own * blk
            shipped[p] += (refs.size - own) * blk
            remote = refs[owner[refs] != p] if refs.size else refs
            if remote.size:
                gids_l.append(remote.astype(np.int64))
                src_l.append(owner[remote].astype(np.int32))
                dst_l.append(np.full(remote.size, p, dtype=np.int32))
        fetch[name] = (
            np.concatenate(gids_l) if gids_l else np.zeros(0, np.int64),
            np.concatenate(src_l) if src_l else np.zeros(0, np.int32),
            np.concatenate(dst_l) if dst_l else np.zeros(0, np.int32),
        )

    # per-task locality from the global task map (exchange-independent):
    # a padded slot repeats global task 0, so mask with task_count
    valid = np.arange(plan.task_c.shape[1])[None, :] < plan.task_count[:, None]
    if plan.task_gidx is not None and tasks.a_idx.size:
        ga = tasks.a_idx[plan.task_gidx]
        gb = tasks.b_idx[plan.task_gidx]
        me = np.arange(P, dtype=np.int32)[:, None]
        task_local = (
            (plan.a_owner[ga] == me) & (plan.b_owner[gb] == me) & valid
        )
    else:
        task_local = np.zeros_like(valid)
    local_tasks = task_local.sum(axis=1).astype(np.int64)

    # per-round wire records, in execution order (A rounds then B rounds)
    rounds = []
    if plan.exchange == "p2p":
        for name, offs, send_pad, send_cnt in (
            ("a", plan.a_offsets, plan.a_send, plan.a_send_count),
            ("b", plan.b_offsets, plan.b_send, plan.b_send_count),
        ):
            for r, d in enumerate(offs):
                cnt = send_cnt[d].astype(np.int64)  # by src; dst = (src+d)%P
                recv = np.zeros(P, dtype=np.int64)
                recv[(np.arange(P) + d) % P] = cnt
                rounds.append(dict(
                    operand=name, offset=int(d), round=r,
                    cap=int(send_pad[d].shape[1]),
                    send_blocks=cnt, recv_blocks=recv,
                ))
    else:  # allgather: one logical round replicating both padded stores
        a_counts = np.bincount(plan.a_owner, minlength=P).astype(np.int64)
        b_counts = np.bincount(plan.b_owner, minlength=P).astype(np.int64)
        total = a_counts + b_counts
        rounds.append(dict(
            operand="ab", offset=-1, round=0,
            cap=int(plan.a_cap + plan.b_cap),
            send_blocks=(P - 1) * total,
            recv_blocks=int(total.sum()) - total,
        ))
    wire_recv, wire_send, wire_padded = plan_worker_bytes(plan)
    return dict(
        itemsize=4,
        block_bytes=blk,
        referenced=referenced,
        local=local,
        shipped=shipped,
        task_local=task_local,
        local_tasks=local_tasks,
        rounds=rounds,
        fetch_a=fetch["a"],
        fetch_b=fetch["b"],
        wire_recv=wire_recv,
        wire_send=wire_send,
        wire_padded=wire_padded,
    )


def plan_stats(plan: SpgemmPlan) -> dict:
    """Schedule quality metrics — the paper's Fig 1 quantities.

    * flop balance: max/mean tasks per device (CHT's load balancing claim)
    * recv bytes per device: actual (true counts) and padded (what the SPMD
      program moves) — Fig 1c 'data received per worker process'.
    * per-worker breakdown (``tasks_per_worker`` / ``recv_bytes_per_worker``
      / ``send_bytes_per_worker``) — the raw vectors the dynamic
      load-balancing cost model (:mod:`repro_torch.dist.balance`) weighs.
    """
    P = plan.nparts
    recv_actual, send_actual, recv_padded = plan_worker_bytes(plan)
    tasks = plan.task_count.astype(np.float64)
    mean_t = max(tasks.mean(), 1e-12)
    return dict(
        nparts=P,
        tasks_total=int(tasks.sum()),
        task_balance=float(tasks.max() / mean_t),
        flops_per_dev_mean=2.0 * mean_t * plan.bs**3,
        recv_bytes_mean=float(recv_actual.mean()),
        recv_bytes_max=float(recv_actual.max()),
        recv_bytes_padded_mean=float(recv_padded.mean()),
        n_offsets=len(plan.a_offsets) + len(plan.b_offsets),
        tasks_per_worker=plan.task_count.astype(np.int64).tolist(),
        recv_bytes_per_worker=recv_actual.tolist(),
        send_bytes_per_worker=send_actual.tolist(),
    )
