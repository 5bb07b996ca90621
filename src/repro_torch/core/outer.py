"""Outer-product distributed SpGEMM — the paper's stated future work (§5).

The owner-of-C schedule fetches A/B operand blocks to the task site; with
poor data locality (the paper's random-blocks case at high worker counts)
those fetches grow.  The outer-product formulation partitions the
CONTRACTION index k instead:

  * A blocks live with the owner of their block-column k; B blocks with the
    owner of their block-row k — so every task (i,k,j) has BOTH operands
    local by construction: zero operand communication.
  * each device computes partial C blocks for its k-range, then ships each
    partial to the C owner, which reduces arriving contributions.

Communication = volume of partial-C spill (blocks whose contributions arise
on a device other than their owner) instead of operand fetches.  Which side
wins is structure-dependent: banded favours owner-computes (tiny operand
halo), heavy fill-in favours outer-product.  ``plan_outer_stats`` exposes the
comparison; ``choose_schedule`` picks the cheaper plan per structure — the
scheduler-level answer to the paper's "improve the scaling behavior in cases
with poor data locality".

This module is numpy only and is the JAX package's ``repro/core/outer.py``,
so plans are equal array for array; the numeric phase is
:func:`repro_torch.core.distributed.dist_spgemm_outer`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .spgemm import Tasks, spgemm_symbolic
from .schedule import SpgemmPlan, make_spgemm_plan, partition_morton, plan_stats, _pad_ragged

__all__ = ["OuterPlan", "make_outer_plan", "plan_outer_stats", "choose_schedule"]


@dataclasses.dataclass(frozen=True)
class OuterPlan:
    """Static schedule for one outer-product multiply."""

    nparts: int
    bs: int
    # operand placement by contraction index
    a_owner: np.ndarray  # owner of A block = k_owner[col]
    b_owner: np.ndarray
    a_slot: np.ndarray
    b_slot: np.ndarray
    a_cap: int
    b_cap: int
    a_store_idx: np.ndarray
    b_store_idx: np.ndarray
    a_store_valid: np.ndarray
    b_store_valid: np.ndarray
    # local tasks (all-local operands): [P, t_cap]
    t_cap: int
    task_a: np.ndarray
    task_b: np.ndarray
    task_c: np.ndarray  # local partial-C slot, sorted
    task_count: np.ndarray
    # partial C: per device list of (global C block) it produces
    p_cap: int
    partial_c_global: np.ndarray  # [P, p_cap] global C idx per local partial slot
    partial_valid: np.ndarray
    # exchange of partials: offsets + send slot lists, and receive accumulate
    offsets: tuple[int, ...]
    send: dict[int, np.ndarray]  # [P, cap_d] local partial slots to send
    send_count: dict[int, np.ndarray]
    # destination accumulate indices: for [own partials | recv buffers] ->
    # local C slot (or c_cap trash for partials owned elsewhere)
    acc_idx: np.ndarray  # [P, acc_cap]
    acc_cap: int
    # output placement
    c_coords: np.ndarray
    c_owner: np.ndarray
    c_slot: np.ndarray
    c_cap: int
    c_store_idx: np.ndarray
    c_store_valid: np.ndarray
    tasks: Tasks


def make_outer_plan(
    a_coords: np.ndarray,
    b_coords: np.ndarray,
    nparts: int,
    bs: int,
    *,
    tasks: Tasks | None = None,
) -> OuterPlan:
    a_coords = np.asarray(a_coords)
    b_coords = np.asarray(b_coords)
    tasks = tasks if tasks is not None else spgemm_symbolic(a_coords, b_coords)
    nk = int(max(a_coords[:, 1].max(initial=0), b_coords[:, 0].max(initial=0))) + 1

    # partition the contraction index by task weight
    t_k = a_coords[tasks.a_idx, 1]
    kw = np.bincount(t_k, minlength=nk).astype(np.float64)
    k_owner = partition_morton(nk, nparts, kw)  # contiguous k ranges
    a_owner = k_owner[a_coords[:, 1]].astype(np.int32)
    b_owner = k_owner[b_coords[:, 0]].astype(np.int32)
    t_owner = k_owner[t_k]

    def owner_slots(owner):
        slot = np.zeros(owner.shape[0], dtype=np.int32)
        stores = []
        for p in range(nparts):
            idx = np.nonzero(owner == p)[0]
            slot[idx] = np.arange(idx.size, dtype=np.int32)
            stores.append(idx.astype(np.int32))
        return slot, stores

    a_slot, a_stores = owner_slots(a_owner)
    b_slot, b_stores = owner_slots(b_owner)
    a_cap = max(max((len(s) for s in a_stores), default=0), 1)
    b_cap = max(max((len(s) for s in b_stores), default=0), 1)

    def store_arrays(stores, cap, n):
        idx = np.zeros((nparts, cap), dtype=np.int32)
        valid = np.zeros((nparts, cap), dtype=bool)
        for p, s in enumerate(stores):
            idx[p, : len(s)] = s
            valid[p, : len(s)] = True
        return idx, valid

    a_store_idx, a_store_valid = store_arrays(a_stores, a_cap, len(a_coords))
    b_store_idx, b_store_valid = store_arrays(b_stores, b_cap, len(b_coords))

    # C ownership: Morton contiguous weighted by task count (same as p2p plan)
    nc = tasks.num_out
    cw = np.bincount(tasks.c_idx, minlength=nc).astype(np.float64)
    c_owner = partition_morton(nc, nparts, cw).astype(np.int32)
    c_slot, c_stores = owner_slots(c_owner)
    c_cap = max(max((len(s) for s in c_stores), default=0), 1)
    c_store_idx, c_store_valid = store_arrays(c_stores, c_cap, nc)

    # per-device: local partial-C index space + task lists
    task_a_l, task_b_l, task_c_l, partials = [], [], [], []
    for p in range(nparts):
        sel = np.nonzero(t_owner == p)[0]
        local_c_glob = np.unique(tasks.c_idx[sel])
        # local partial slot of each task: its C block's rank among the
        # worker's distinct C blocks
        tc = np.searchsorted(local_c_glob, tasks.c_idx[sel]).astype(np.int32)
        order = np.argsort(tc, kind="stable")
        sel = sel[order]
        tc = tc[order]
        task_a_l.append(a_slot[tasks.a_idx[sel]])
        task_b_l.append(b_slot[tasks.b_idx[sel]])
        task_c_l.append(tc)
        partials.append(local_c_glob.astype(np.int32))

    t_cap = max(max((len(x) for x in task_a_l), default=0), 1)
    p_cap = max(max((len(x) for x in partials), default=0), 1)
    task_count = np.array([len(x) for x in task_a_l], dtype=np.int64)
    partial_c_global = _pad_ragged(partials, 0)
    partial_valid = np.zeros((nparts, p_cap), dtype=bool)
    for p, g in enumerate(partials):
        partial_valid[p, : len(g)] = True

    # exchange plan: device p sends partial slot s to owner of its C block
    send: dict[int, list] = {}
    recv_lists: dict[int, list] = {}  # dst -> list of (offset, src_order, global)
    for src in range(nparts):
        g = partials[src]
        dst_owner = c_owner[g]
        for dst in np.unique(dst_owner):
            if dst == src:
                continue
            d = int((dst - src) % nparts)
            slots = np.nonzero(dst_owner == dst)[0].astype(np.int32)
            send.setdefault(d, [np.zeros(0, np.int32)] * nparts)
            send[d][src] = slots
            recv_lists.setdefault(int(dst), []).append((d, g[slots]))
    offsets = tuple(sorted(send.keys()))
    send_pad = {d: _pad_ragged(send[d], 0) for d in offsets}
    send_cnt = {d: np.array([len(x) for x in send[d]], dtype=np.int64) for d in offsets}

    # accumulate layout on dst: [own partials (p_cap) | recv buffers per offset]
    acc_cap = p_cap + sum(send_pad[d].shape[1] for d in offsets)
    acc_idx = np.full((nparts, acc_cap), c_cap, dtype=np.int32)  # trash default
    for p in range(nparts):
        g = partials[p]
        own = c_owner[g] == p
        acc_idx[p, : len(g)][own] = c_slot[g[own]]
        base = p_cap
        for d in offsets:
            cap_d = send_pad[d].shape[1]
            src = (p - d) % nparts
            pairs = [x for x in recv_lists.get(p, []) if x[0] == d]
            if pairs:
                arriving = pairs[0][1]
                acc_idx[p, base : base + len(arriving)] = c_slot[arriving]
            base += cap_d

    return OuterPlan(
        nparts=nparts,
        bs=bs,
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
        t_cap=t_cap,
        task_a=_pad_ragged(task_a_l, 0),
        task_b=_pad_ragged(task_b_l, 0),
        task_c=_pad_ragged(task_c_l, p_cap),  # trash partial row
        task_count=task_count,
        p_cap=p_cap,
        partial_c_global=partial_c_global,
        partial_valid=partial_valid,
        offsets=offsets,
        send=send_pad,
        send_count=send_cnt,
        acc_idx=acc_idx,
        acc_cap=acc_cap,
        c_coords=tasks.c_coords,
        c_owner=c_owner,
        c_slot=c_slot,
        c_cap=c_cap,
        c_store_idx=c_store_idx,
        c_store_valid=c_store_valid,
        tasks=tasks,
    )


def plan_outer_stats(plan: OuterPlan) -> dict:
    P = plan.nparts
    blk = plan.bs * plan.bs * 4
    recv = np.zeros(P, dtype=np.float64)
    for d in plan.offsets:
        cnt = plan.send_count[d]
        for src in range(P):
            recv[(src + d) % P] += cnt[src] * blk
    tasks = plan.task_count.astype(np.float64)
    mean_t = max(tasks.mean(), 1e-12)
    return dict(
        nparts=P,
        tasks_total=int(tasks.sum()),
        task_balance=float(tasks.max() / mean_t),
        recv_bytes_mean=float(recv.mean()),
        recv_bytes_max=float(recv.max()),
        n_offsets=len(plan.offsets),
    )


def choose_schedule(a_coords, b_coords, nparts, bs, *, tasks=None):
    """Pick owner-computes vs outer-product by planned communication volume.

    Returns ("p2p"|"outer", plan, stats).  This is the structure-adaptive
    scheduler the paper's future-work section asks for.
    """
    tasks = tasks if tasks is not None else spgemm_symbolic(a_coords, b_coords)
    p2p = make_spgemm_plan(a_coords, b_coords, nparts, bs, tasks=tasks)
    outer = make_outer_plan(a_coords, b_coords, nparts, bs, tasks=tasks)
    s1 = plan_stats(p2p)
    s2 = plan_outer_stats(outer)
    if s1["recv_bytes_mean"] <= s2["recv_bytes_mean"]:
        return "p2p", p2p, s1
    return "outer", outer, s2
