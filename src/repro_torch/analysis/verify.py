"""Static plan verifier and accumulation-race detector of the resident runtime.

CHT gets race-freedom by construction (immutable chunks, explicit task
dependencies).  The resident runtime re-derives those guarantees by hand in
every :class:`~repro_torch.core.schedule.SpgemmPlan` — ring exchange rounds,
the fused engine's ``(src, off)`` operand addressing, the ``c_slot``
accumulation layout — and this module re-proves them, on the host, before
a plan is admitted to the cache:

* **Exchange rounds** — each round is a ring permutation at a distinct
  offset in ``[1, nparts)``, sent slots address the sender's real store,
  and the blocks delivered to a worker within a round land in strictly
  increasing distinct receive slots (no two sends into one slot), never
  duplicating a block across rounds or re-delivering a block the receiver
  owns.
* **Task addressing** — every task operand index resolves, in the staged
  ``[own store | recv per round]`` buffer layout, to exactly the global
  block the symbolic phase assigned it (anything undelivered is a
  use-before-receive), and the fused-engine ``(src, off)`` decomposition
  recomposes to the same index within each round's true capacity.
* **Accumulation chains** — per worker, tasks are sorted by output slot
  (the fused kernel sums one contiguous run per output block, so a
  revisited slot would split a block's sum), each slot accumulates exactly
  one output block, and within a slot the global task order is preserved
  (the stable sort that keeps fp32 accumulation order — and hence result
  bits — invariant under owner re-layout).
* **Delta-plan safety** — the memoized send-slot->task spans that masked
  executables prune the exchange with must cover every (task, remote
  operand) pair, so *every* reachable runtime mask keeps the blocks its
  kept tasks read; padded task slots must redirect to the trash row.

Everything here is numpy over the host-side plan arrays.  The checks, their
messages and their order are the JAX package's ``repro/analysis/verify.py``;
the per-reference loops over remote operand reads (:func:`_remote_refs`,
the span coverage of :func:`verify_spgemm_plan` and
:func:`verify_task_mask`) run as array operations here, and report the
same violations in the same order.
"""

from __future__ import annotations

import numpy as np

from ..core.schedule import SpgemmPlan, _owner_slots
from .errors import PlanError, Violation

__all__ = [
    "verify_spgemm_plan",
    "verify_task_mask",
    "verify_relayout_plan",
    "verify_norm_table",
    "verify_add_plan",
    "verify_compact_plan",
    "verify_value",
    "PlanError",
    "Violation",
]


# ---------------------------------------------------------------------------
# shared reconstruction helpers
# ---------------------------------------------------------------------------


def _inverse_store(owner: np.ndarray, slot: np.ndarray, nparts: int, cap: int):
    """[P, cap] global block id resident at each store slot (-1 = empty)."""
    inv = np.full((nparts, cap), -1, dtype=np.int64)
    n = owner.shape[0]
    if n:
        ok = (
            (owner >= 0)
            & (owner < nparts)
            & (slot >= 0)
            & (slot < cap)
        )
        inv[owner[ok], slot[ok]] = np.nonzero(ok)[0]
    return inv


def _delivered_blocks(inv, send, send_cnt, d, nparts):
    """Per destination device: global blocks round ``d`` delivers, by slot.

    Returns ``[P, width]`` int64 (-1 at padded positions); row ``dst`` holds
    the blocks sent by ``src = (dst - d) % nparts``.
    """
    pad = np.asarray(send[d])
    width = pad.shape[1]
    out = np.full((nparts, width), -1, dtype=np.int64)
    for dst in range(nparts):
        src = (dst - d) % nparts
        cnt = min(int(send_cnt[d][src]), width)
        slots = pad[src, :cnt].astype(np.int64)
        ok = (slots >= 0) & (slots < inv.shape[1])
        vals = np.where(ok, inv[src, np.clip(slots, 0, inv.shape[1] - 1)], -1)
        out[dst, :cnt] = vals
    return out


def _staged_buffer(inv, cap, offsets, send, send_cnt, nparts):
    """[P, cap + sum(widths)] global block at each staged buffer position.

    Mirrors the execution-time layout ``[own store (cap) | recv per offset,
    in offset order]`` that :func:`repro_torch.core.schedule.local_fetch_index`
    addresses; -1 marks padding / never-written positions.
    """
    parts = [inv[:, :cap] if inv.shape[1] >= cap else np.pad(
        inv, ((0, 0), (0, cap - inv.shape[1])), constant_values=-1)]
    widths = []
    for d in offsets:
        dv = _delivered_blocks(inv, send, send_cnt, d, nparts)
        widths.append(dv.shape[1])
        parts.append(dv)
    return np.concatenate(parts, axis=1), widths


def _check_layout(name, owner, slot, cap, expected, nparts, out, store_idx=None,
                  store_valid=None):
    """Owner/slot layout checks; returns the inverse store (or None if the
    owner map is unusable)."""
    owner = np.asarray(owner)
    slot = np.asarray(slot)
    n = owner.shape[0]
    if expected is not None and not np.array_equal(owner, np.asarray(expected)):
        i = int(np.nonzero(owner != np.asarray(expected))[0][0])
        out.append(Violation(
            "owner-fingerprint",
            f"operand {name!r}: plan owner map disagrees with the owner map "
            f"the cache key fingerprints (block {i}: plan {int(owner[i])}, "
            f"key {int(np.asarray(expected)[i])})",
            dict(operand=name, block=i),
        ))
    if n and ((owner < 0) | (owner >= nparts)).any():
        i = int(np.nonzero((owner < 0) | (owner >= nparts))[0][0])
        out.append(Violation(
            "owner-map",
            f"operand {name!r}: block {i} assigned to device {int(owner[i])} "
            f"outside the mesh of {nparts}",
            dict(operand=name, block=i, owner=int(owner[i])),
        ))
        return None
    sizes = np.bincount(owner, minlength=nparts) if n else np.zeros(nparts, np.int64)
    if cap < max(int(sizes.max()) if n else 0, 1):
        out.append(Violation(
            "capacity-mismatch",
            f"operand {name!r}: store capacity {cap} is below the largest "
            f"per-device store ({int(sizes.max())})",
            dict(operand=name, cap=int(cap), max_store=int(sizes.max())),
        ))
    # duplicate (owner, slot) pairs: two blocks resident in one store slot
    if n:
        key = owner.astype(np.int64) * (int(max(slot.max(), 0)) + 1) + slot
        uniq, counts = np.unique(key, return_counts=True)
        if (counts > 1).any():
            dup = uniq[counts > 1][0]
            blocks = np.nonzero(key == dup)[0][:2]
            check = "c-slot-race" if name == "c" else "slot-collision"
            out.append(Violation(
                check,
                f"operand {name!r}: blocks {int(blocks[0])} and "
                f"{int(blocks[1])} share store slot "
                f"{int(slot[blocks[0]])} on device {int(owner[blocks[0]])} — "
                f"two blocks (and their accumulation chains) would alias one "
                f"output row",
                dict(operand=name, device=int(owner[blocks[0]]),
                     slot=int(slot[blocks[0]]),
                     blocks=[int(b) for b in blocks]),
            ))
    # the ascending-global-order-within-owner invariant every planner and
    # the scatter/gather layout rely on
    ref_slot, _ = _owner_slots(owner, nparts)
    if not np.array_equal(slot, ref_slot):
        i = int(np.nonzero(slot != ref_slot)[0][0])
        out.append(Violation(
            "owner-map",
            f"operand {name!r}: store slots violate the ascending-Morton-"
            f"within-owner layout invariant (block {i} at slot "
            f"{int(slot[i])}, layout says {int(ref_slot[i])})",
            dict(operand=name, block=i, slot=int(slot[i]),
                 expected=int(ref_slot[i])),
        ))
    inv = _inverse_store(owner, slot, nparts, int(cap))
    if store_idx is not None:
        sidx = np.asarray(store_idx)
        svalid = np.asarray(store_valid)
        want_valid = inv >= 0
        if sidx.shape != (nparts, cap) or svalid.shape != (nparts, cap):
            out.append(Violation(
                "capacity-mismatch",
                f"operand {name!r}: store index arrays have shape "
                f"{sidx.shape}, plan capacity says ({nparts}, {cap})",
                dict(operand=name),
            ))
        elif (not np.array_equal(svalid, want_valid)
              or not np.array_equal(np.where(want_valid, sidx, 0),
                                    np.where(want_valid, inv, 0))):
            p, s = [int(x[0]) for x in np.nonzero(
                (svalid != want_valid)
                | (np.where(want_valid, sidx, 0) != np.where(want_valid, inv, 0)))]
            out.append(Violation(
                "owner-map",
                f"operand {name!r}: store index table disagrees with the "
                f"owner/slot maps at device {p} slot {s}",
                dict(operand=name, device=p, slot=s),
            ))
    return inv


def _check_rounds(name, offsets, send, send_cnt, inv, owner, nparts, out):
    """Per-round ppermute checks for one operand's exchange plan."""
    offs = tuple(int(d) for d in offsets)
    for r, d in enumerate(offs):
        if not (1 <= d < nparts):
            out.append(Violation(
                "round-permutation",
                f"operand {name!r} round {r}: ring offset {d} outside "
                f"[1, {nparts}) — the round is not a permutation of the mesh "
                f"(offset 0 aliases every device's own store)",
                dict(operand=name, round=r, offset=d),
            ))
        elif r and d <= offs[r - 1]:
            out.append(Violation(
                "round-permutation",
                f"operand {name!r} round {r}: ring offset {d} does not "
                f"increase over round {r - 1} (offset {offs[r - 1]}) — "
                f"duplicate offsets deliver into the same receive buffer",
                dict(operand=name, round=r, offset=d),
            ))
    sizes = np.bincount(owner, minlength=nparts) if owner.size else np.zeros(
        nparts, np.int64)
    seen = [dict() for _ in range(nparts)]  # dst -> {block: round}
    for r, d in enumerate(offs):
        pad = np.asarray(send[d])
        width = pad.shape[1]
        if pad.shape[0] != nparts:
            out.append(Violation(
                "capacity-mismatch",
                f"operand {name!r} round {r}: send table has "
                f"{pad.shape[0]} rows for a mesh of {nparts}",
                dict(operand=name, round=r),
            ))
            continue
        for src in range(nparts):
            cnt = int(send_cnt[d][src])
            if cnt > width:
                out.append(Violation(
                    "capacity-mismatch",
                    f"operand {name!r} round {r} (offset {d}): device {src} "
                    f"claims {cnt} sends but the padded round capacity is "
                    f"{width}",
                    dict(operand=name, round=r, offset=d, src=src,
                         count=cnt, width=width),
                ))
                cnt = width
            slots = pad[src, :cnt].astype(np.int64)
            bad = (slots < 0) | (slots >= int(sizes[src]))
            if bad.any():
                pos = int(np.nonzero(bad)[0][0])
                out.append(Violation(
                    "send-oob",
                    f"operand {name!r} round {r} (offset {d}): device {src} "
                    f"sends store slot {int(slots[pos])} at position {pos} "
                    f"but only holds {int(sizes[src])} blocks",
                    dict(operand=name, round=r, offset=d, src=src, pos=pos,
                         slot=int(slots[pos])),
                ))
                continue
            if d % nparts == 0:
                continue  # self-send already reported as round-permutation
            dst = (src + d) % nparts
            blocks = inv[src, slots] if cnt else np.zeros(0, np.int64)
            diffs = np.diff(blocks)
            if (diffs <= 0).any():
                pos = int(np.nonzero(diffs <= 0)[0][0]) + 1
                out.append(Violation(
                    "send-conflict",
                    f"operand {name!r} round {r} (offset {d}): device {src} "
                    f"delivers block {int(blocks[pos])} to device {dst} at "
                    f"position {pos}, not strictly after block "
                    f"{int(blocks[pos - 1])} — two sends land in one logical "
                    f"receive slot",
                    dict(operand=name, round=r, offset=d, src=src, dst=dst,
                         pos=pos, block=int(blocks[pos])),
                ))
            for pos, g in enumerate(blocks):
                g = int(g)
                if g < 0:
                    continue
                if owner[g] == dst:
                    out.append(Violation(
                        "send-conflict",
                        f"operand {name!r} round {r} (offset {d}): block {g} "
                        f"is delivered to device {dst}, which already owns "
                        f"it — the delivery aliases the resident store",
                        dict(operand=name, round=r, offset=d, src=src,
                             dst=dst, pos=pos, block=g),
                    ))
                elif g in seen[dst]:
                    out.append(Violation(
                        "send-conflict",
                        f"operand {name!r} round {r} (offset {d}): block {g} "
                        f"was already delivered to device {dst} in round "
                        f"{seen[dst][g]}",
                        dict(operand=name, round=r, offset=d, src=src,
                             dst=dst, pos=pos, block=g,
                             first_round=seen[dst][g]),
                    ))
                else:
                    seen[dst][g] = r


def _remote_refs(plan: SpgemmPlan, name: str):
    """Per-worker remote operand references of one operand.

    Returns ``(rows, widths)``: ``rows`` is a dict of equal-length int64
    arrays ``p`` (worker), ``t`` (task slot), ``g`` (global task), ``r``
    (round), ``src`` (sender, -1 when the round index is out of range) and
    ``pos`` (position in the round), one entry for every valid task whose
    operand index addresses a receive buffer, worker-major and ascending by
    task slot within a worker; ``widths`` are the rounds' padded widths.
    """
    offsets = plan.a_offsets if name == "a" else plan.b_offsets
    send = plan.a_send if name == "a" else plan.b_send
    cap = plan.a_cap if name == "a" else plan.b_cap
    task_x = plan.task_a if name == "a" else plan.task_b
    widths = [np.asarray(send[d]).shape[1] for d in offsets]
    bounds = np.concatenate([[cap], cap + np.cumsum(widths)]).astype(np.int64)
    valid = np.arange(task_x.shape[1])[None, :] < np.asarray(plan.task_count)[:, None]
    tx_all = np.asarray(task_x, dtype=np.int64)
    p, t = np.nonzero(valid & (tx_all >= cap))
    tx = tx_all[p, t]
    r = np.searchsorted(bounds, tx, side="right") - 1
    r = np.clip(r, 0, max(len(offsets) - 1, 0))
    pos = tx - bounds[r]
    offs = np.asarray(offsets, dtype=np.int64)
    in_range = r < len(offsets)
    d = np.where(in_range, offs[np.minimum(r, max(len(offsets) - 1, 0))]
                 if len(offsets) else -1, -1)
    src = np.where(d >= 0, (p - d) % plan.nparts, -1)
    rows = dict(p=p.astype(np.int64), t=t.astype(np.int64),
                g=np.asarray(plan.task_gidx, dtype=np.int64)[p, t],
                r=r.astype(np.int64), src=src.astype(np.int64), pos=pos.astype(np.int64))
    return rows, widths


def _span_members(starts: np.ndarray, cat: np.ndarray, seg: np.ndarray,
                  task: np.ndarray) -> np.ndarray:
    """``task[i] in cat[starts[seg[i]]:starts[seg[i] + 1]]`` for every ``i``.

    Exact for any ``starts``: entries of ``cat`` are keyed by (value,
    position), and a query hits when the first entry of its value at or
    after the span's start lies before the span's end.
    """
    cat = np.asarray(cat, dtype=np.int64)
    n = cat.shape[0]
    if not seg.size or not n:
        return np.zeros(seg.shape, dtype=bool)
    starts = np.asarray(starts, dtype=np.int64)
    s0 = np.clip(starts[seg], 0, n)
    s1 = np.clip(starts[seg + 1], 0, n)
    key = np.sort(cat * (n + 1) + np.arange(n, dtype=np.int64))
    base = task.astype(np.int64) * (n + 1)
    at = np.searchsorted(key, base + s0)
    return (at < n) & (key[np.minimum(at, n - 1)] < base + s1)


# ---------------------------------------------------------------------------
# the SpgemmPlan verifier
# ---------------------------------------------------------------------------


def verify_spgemm_plan(
    plan: SpgemmPlan,
    *,
    expected_a_owner: np.ndarray | None = None,
    expected_b_owner: np.ndarray | None = None,
    check_spans: bool = True,
    max_violations: int = 64,
) -> list[Violation]:
    """Re-prove every scheduling invariant of one multiply plan.

    Returns the (possibly empty) list of violations; callers that want an
    exception raise :class:`PlanError` on a non-empty report (the plan-cache
    admission hook in :mod:`repro_torch.core.cache` does).
    """
    out: list[Violation] = []
    P = int(plan.nparts)
    tasks = plan.tasks
    nt = int(tasks.num_tasks)

    inv_a = _check_layout("a", plan.a_owner, plan.a_slot, plan.a_cap,
                          expected_a_owner, P, out,
                          store_idx=plan.a_store_idx,
                          store_valid=plan.a_store_valid)
    inv_b = _check_layout("b", plan.b_owner, plan.b_slot, plan.b_cap,
                          expected_b_owner, P, out,
                          store_idx=plan.b_store_idx,
                          store_valid=plan.b_store_valid)
    inv_c = _check_layout("c", plan.c_owner, plan.c_slot, plan.c_cap,
                          None, P, out,
                          store_idx=plan.c_store_idx,
                          store_valid=plan.c_store_valid)
    if inv_a is None or inv_b is None or inv_c is None:
        return out[:max_violations]

    if plan.exchange == "p2p":
        _check_rounds("a", plan.a_offsets, plan.a_send, plan.a_send_count,
                      inv_a, np.asarray(plan.a_owner), P, out)
        _check_rounds("b", plan.b_offsets, plan.b_send, plan.b_send_count,
                      inv_b, np.asarray(plan.b_owner), P, out)
        buf_a, widths_a = _staged_buffer(inv_a, plan.a_cap, plan.a_offsets,
                                         plan.a_send, plan.a_send_count, P)
        buf_b, widths_b = _staged_buffer(inv_b, plan.b_cap, plan.b_offsets,
                                         plan.b_send, plan.b_send_count, P)
    else:  # allgather baseline: [owner0 store | owner1 store | ...]
        buf_a = inv_a.reshape(1, -1).repeat(P, axis=0)
        buf_b = inv_b.reshape(1, -1).repeat(P, axis=0)
        widths_a, widths_b = [], []

    # -- task addressing, placement and accumulation chains -----------------
    c_owner = np.asarray(plan.c_owner)
    c_slot = np.asarray(plan.c_slot)
    cover = np.zeros(nt, dtype=np.int64)
    for p in range(P):
        cnt = int(plan.task_count[p])
        if cnt > plan.t_cap:
            out.append(Violation(
                "capacity-mismatch",
                f"device {p} schedules {cnt} tasks over task capacity "
                f"{plan.t_cap}",
                dict(device=p, count=cnt, t_cap=int(plan.t_cap)),
            ))
            cnt = int(plan.t_cap)
        gid = plan.task_gidx[p, :cnt].astype(np.int64)
        bad_gid = (gid < 0) | (gid >= nt)
        if bad_gid.any():
            t = int(np.nonzero(bad_gid)[0][0])
            out.append(Violation(
                "task-gidx",
                f"device {p} task slot {t} references global task "
                f"{int(gid[t])} outside the {nt}-task list",
                dict(device=p, slot=t, task=int(gid[t])),
            ))
            gid = np.clip(gid, 0, max(nt - 1, 0))
        if nt:
            cover += np.bincount(gid, minlength=nt)
        ga = tasks.a_idx[gid] if nt else gid
        gb = tasks.b_idx[gid] if nt else gid
        gc = tasks.c_idx[gid] if nt else gid

        if cnt and (c_owner[gc] != p).any():
            t = int(np.nonzero(c_owner[gc] != p)[0][0])
            out.append(Violation(
                "task-placement",
                f"device {p} task slot {t} computes C block {int(gc[t])} "
                f"owned by device {int(c_owner[gc[t]])} — owner-of-C is "
                f"violated",
                dict(device=p, slot=t, task=int(gid[t]), c_block=int(gc[t])),
            ))

        for name, task_x, buf, gx in (("a", plan.task_a, buf_a, ga),
                                      ("b", plan.task_b, buf_b, gb)):
            tx = task_x[p].astype(np.int64)
            oob = (tx < 0) | (tx >= buf.shape[1])
            if oob.any():
                t = int(np.nonzero(oob)[0][0])
                out.append(Violation(
                    "src-off-oob",
                    f"device {p} task slot {t}: operand {name!r} index "
                    f"{int(tx[t])} outside the staged buffer of "
                    f"{buf.shape[1]} rows",
                    dict(operand=name, device=p, slot=t, index=int(tx[t])),
                ))
            got = buf[p, np.clip(tx[:cnt], 0, buf.shape[1] - 1)]
            bad = (got != gx[:cnt]) | oob[:cnt]
            for t in np.nonzero(bad)[0][:4]:
                t = int(t)
                want = int(gx[t])
                delivered = bool((buf[p] == want).any())
                out.append(Violation(
                    "operand-mismatch" if delivered else "use-before-receive",
                    f"device {p} task slot {t} (global task {int(gid[t])}) "
                    f"reads operand {name!r} buffer row {int(tx[t])} which "
                    + (f"holds block {int(got[t])}, not block {want}"
                       if delivered and int(got[t]) >= 0 else
                       f"no exchange round ever delivers block {want} to")
                    + f" device {p}",
                    dict(operand=name, device=p, slot=t, task=int(gid[t]),
                         block=want, index=int(tx[t])),
                ))

        # accumulation race detector: one ordered chain per output slot
        tc = plan.task_c[p].astype(np.int64)
        if cnt:
            expect_tc = c_slot[gc]
            if (tc[:cnt] != expect_tc).any():
                t = int(np.nonzero(tc[:cnt] != expect_tc)[0][0])
                out.append(Violation(
                    "c-slot-race",
                    f"device {p} task slot {t} accumulates into output row "
                    f"{int(tc[t])} but its C block {int(gc[t])} lives in "
                    f"slot {int(expect_tc[t])} — the contribution lands in "
                    f"another block's accumulation chain",
                    dict(device=p, slot=t, task=int(gid[t]),
                         c_block=int(gc[t]), got=int(tc[t]),
                         expected=int(expect_tc[t])),
                ))
            # one definition of the kernel's zero-on-slot-change contract,
            # shared with the fused engine that relies on it
            from ..kernels.fused_leaf import first_accumulation_hazard

            hazard = first_accumulation_hazard(tc[:cnt])
            if hazard is not None:
                t = hazard
                out.append(Violation(
                    "c-slot-order",
                    f"device {p} task slot {t} revisits output row "
                    f"{int(tc[t])} after row {int(tc[t - 1])} — the fused "
                    f"grid zeroes its accumulator on every slot change, so "
                    f"the earlier chain's contributions are overwritten",
                    dict(device=p, slot=t, task=int(gid[t]),
                         c_slot=int(tc[t])),
                ))
            else:
                same = tc[1:cnt] == tc[:cnt - 1]
                mixed = same & (gc[1:] != gc[:-1])
                if mixed.any():
                    t = int(np.nonzero(mixed)[0][0]) + 1
                    out.append(Violation(
                        "c-slot-race",
                        f"device {p} output row {int(tc[t])} accumulates "
                        f"two different C blocks ({int(gc[t - 1])} and "
                        f"{int(gc[t])}) — two chains race into one slot",
                        dict(device=p, slot=t, c_slot=int(tc[t]),
                             blocks=[int(gc[t - 1]), int(gc[t])]),
                    ))
                unstable = same & (gid[1:] <= gid[:-1]) & (gc[1:] == gc[:-1])
                if unstable.any():
                    t = int(np.nonzero(unstable)[0][0]) + 1
                    out.append(Violation(
                        "accumulation-order",
                        f"device {p} task slots {t - 1},{t} accumulate C "
                        f"block {int(gc[t])} with global tasks "
                        f"{int(gid[t - 1])},{int(gid[t])} out of symbolic "
                        f"order — fp32 accumulation order (and result bits "
                        f"under re-layout) is no longer deterministic",
                        dict(device=p, slot=t, c_slot=int(tc[t]),
                             tasks=[int(gid[t - 1]), int(gid[t])]),
                    ))
        # padded task slots must redirect to the trash row
        if (tc[cnt:] != plan.c_cap).any():
            t = cnt + int(np.nonzero(tc[cnt:] != plan.c_cap)[0][0])
            out.append(Violation(
                "mask-redirect",
                f"device {p} padded task slot {t} writes output row "
                f"{int(tc[t])} instead of the trash row {plan.c_cap} — a "
                f"masked/padded task would corrupt a live output block",
                dict(device=p, slot=t, got=int(tc[t]),
                     trash=int(plan.c_cap)),
            ))

    if nt and not (cover == 1).all():
        g = int(np.nonzero(cover != 1)[0][0])
        out.append(Violation(
            "task-gidx",
            f"global task {g} is scheduled {int(cover[g])} times across the "
            f"mesh (every task must run exactly once)",
            dict(task=g, times=int(cover[g])),
        ))

    # fused (src, off) decomposition must recompose within true capacities
    if plan.exchange == "p2p" and plan.task_a_src is not None:
        for name, task_x, src_x, off_x, cap, widths in (
            ("a", plan.task_a, plan.task_a_src, plan.task_a_off,
             plan.a_cap, widths_a),
            ("b", plan.task_b, plan.task_b_src, plan.task_b_off,
             plan.b_cap, widths_b),
        ):
            caps = np.array([cap] + list(widths), dtype=np.int64)
            starts = np.concatenate([[0], np.cumsum(caps)[:-1]]).astype(np.int64)
            src = np.asarray(src_x, dtype=np.int64)
            off = np.asarray(off_x, dtype=np.int64)
            bad_src = (src < 0) | (src >= caps.shape[0])
            src_c = np.clip(src, 0, caps.shape[0] - 1)
            bad = bad_src | (off < 0) | (off >= caps[src_c]) | (
                starts[src_c] + off != np.asarray(task_x, dtype=np.int64))
            if bad.any():
                p, t = [int(x[0]) for x in np.nonzero(bad)]
                out.append(Violation(
                    "src-off-oob",
                    f"device {p} task slot {t}: fused operand {name!r} "
                    f"address (src={int(src[p, t])}, off={int(off[p, t])}) "
                    f"does not resolve inside "
                    + ("the own store" if int(src_c[p, t]) == 0 else
                       f"receive buffer {int(src_c[p, t]) - 1}")
                    + f" of capacity {int(caps[src_c[p, t]])} at buffer row "
                    f"{int(task_x[p, t])}",
                    dict(operand=name, device=p, slot=t,
                         src=int(src[p, t]), off=int(off[p, t]),
                         index=int(np.asarray(task_x)[p, t])),
                ))

    # masked/delta safety for every reachable mask: the memoized send spans
    # must cover each (task, remote operand) pair
    if check_spans and plan.exchange == "p2p" and nt:
        from ..core.distributed import _send_task_spans

        maps = _send_task_spans(plan)
        for name in ("a", "b"):
            offsets = plan.a_offsets if name == "a" else plan.b_offsets
            rows, widths = _remote_refs(plan, name)
            w = np.asarray(widths + [0], dtype=np.int64)
            # rows outside their round were already reported as src-off-oob
            ok = (rows["r"] < len(offsets)) & (rows["pos"] < w[rows["r"]])
            missing = np.zeros(ok.shape, dtype=bool)
            for r in np.unique(rows["r"][ok]):
                sel = ok & (rows["r"] == r)
                starts, cat = maps[(name, int(offsets[r]))]
                seg = rows["src"][sel] * widths[r] + rows["pos"][sel]
                missing[sel] = ~_span_members(starts, cat, seg, rows["g"][sel])
            for i in np.nonzero(missing)[0]:
                p, g, r, src, pos = (int(rows[k][i]) for k in ("p", "g", "r", "src", "pos"))
                out.append(Violation(
                    "exchange-starvation",
                    f"device {p} global task {g} reads operand {name!r} "
                    f"from round {r} send slot (src={src}, pos={pos}) "
                    f"but the memoized send-task span omits it — a "
                    f"delta mask keeping only this task would prune the "
                    f"delivery it depends on",
                    dict(operand=name, device=p, task=g, round=r,
                         src=src, pos=pos),
                ))
                if len(out) >= max_violations:
                    return out[:max_violations]

    return out[:max_violations]


def verify_task_mask(plan: SpgemmPlan, task_on: np.ndarray) -> list[Violation]:
    """Prove one concrete delta mask safe: every kept task's remote operands
    survive the pruned exchange (send keep masks + live rounds)."""
    from ..core.distributed import _exchange_keep_masks

    out: list[Violation] = []
    task_on = np.asarray(task_on).astype(bool)
    a_keeps, b_keeps, live_a, live_b, _ = _exchange_keep_masks(plan, task_on)
    for name, keeps, live in (("a", a_keeps, live_a), ("b", b_keeps, live_b)):
        rows, widths = _remote_refs(plan, name)
        w = np.asarray(widths + [0], dtype=np.int64)
        r, src, pos = rows["r"], rows["src"], rows["pos"]
        considered = (task_on[rows["g"]] & (r < len(keeps))
                      & (pos < w[np.minimum(r, len(widths))]))
        dropped = considered & ~np.isin(r, np.asarray(live, dtype=np.int64))
        pruned = np.zeros(r.shape, dtype=bool)
        for rr in np.unique(r[considered & ~dropped]):
            sel = considered & ~dropped & (r == rr)
            pruned[sel] = ~keeps[rr][src[sel], pos[sel]]
        for i in np.nonzero(dropped | pruned)[0]:
            p, g, ri, si, pi = (int(rows[k][i]) for k in ("p", "g", "r", "src", "pos"))
            if dropped[i]:
                out.append(Violation(
                    "exchange-starvation",
                    f"kept task {g} on device {p} reads operand {name!r} "
                    f"from round {ri}, which the mask drops entirely",
                    dict(operand=name, device=p, task=g, round=ri),
                ))
            else:
                out.append(Violation(
                    "exchange-starvation",
                    f"kept task {g} on device {p} reads operand {name!r} "
                    f"from round {ri} send slot (src={si}, pos={pi}), "
                    f"which the mask prunes to zero payload",
                    dict(operand=name, device=p, task=g, round=ri,
                         src=si, pos=pi),
                ))
    return out


# ---------------------------------------------------------------------------
# relayout (transpose / repartition) and norm-table verification
# ---------------------------------------------------------------------------


def verify_relayout_plan(payload: dict) -> list[Violation]:
    """Verify a relayout plan: the transpose / repartition executables of
    :mod:`repro_torch.dist.collectives` retain their host-side arrays."""
    out: list[Violation] = []
    P = int(payload["nparts"])
    x_owner = np.asarray(payload["x_owner"])
    x_slot = np.asarray(payload["x_slot"])
    x_cap = int(payload["x_cap"])
    src = np.asarray(payload["src"], dtype=np.int64)
    out_owner = np.asarray(payload["out_owner"])
    out_slot = np.asarray(payload["out_slot"])
    out_cap = int(payload["out_cap"])
    offsets = payload["offsets"]
    send, send_cnt = payload["send"], payload["send_cnt"]
    gidx = np.asarray(payload["gidx"])
    gval = np.asarray(payload["gval"])
    kind = payload.get("label", "relayout")

    inv_x = _check_layout(f"{kind}:src", x_owner, x_slot, x_cap, None, P, out)
    inv_o = _check_layout(f"{kind}:out", out_owner, out_slot, out_cap, None,
                          P, out)
    if inv_x is None or inv_o is None:
        return out
    _check_rounds(f"{kind}:src", offsets, send, send_cnt, inv_x, x_owner, P,
                  out)
    buf, _ = _staged_buffer(inv_x, x_cap, offsets, send, send_cnt, P)
    n_out = out_owner.shape[0]
    if src.shape[0] != n_out:
        out.append(Violation(
            "capacity-mismatch",
            f"{kind}: gather permutation covers {src.shape[0]} blocks for "
            f"{n_out} outputs",
            dict(kind=kind),
        ))
        return out
    for p in range(P):
        mine = np.nonzero(out_owner == p)[0]
        for local, o in enumerate(mine):
            if local >= out_cap or gval[p, local] != 1.0:
                out.append(Violation(
                    "gather-gap",
                    f"{kind}: output block {int(o)} (device {p} slot "
                    f"{local}) has no gather source — it would materialize "
                    f"as zeros",
                    dict(kind=kind, device=p, slot=int(local), block=int(o)),
                ))
                continue
            want = int(src[o])
            idx = int(gidx[p, local])
            got = int(buf[p, idx]) if 0 <= idx < buf.shape[1] else -1
            if got != want:
                delivered = bool((buf[p] == want).any())
                out.append(Violation(
                    "operand-mismatch" if delivered else "use-before-receive",
                    f"{kind}: output block {int(o)} on device {p} gathers "
                    f"buffer row {idx} which "
                    + (f"holds block {got}, not block {want}" if delivered
                       and got >= 0 else
                       f"no exchange round ever delivers block {want} to")
                    + f" device {p}",
                    dict(kind=kind, device=p, slot=int(local),
                         block=int(o), source=want, index=idx),
                ))
        # padding slots must be masked out by gval
        pad = np.nonzero(gval[p, len(mine):] != 0.0)[0]
        if pad.size:
            s = int(len(mine) + pad[0])
            out.append(Violation(
                "mask-redirect",
                f"{kind}: device {p} padding slot {s} has gather weight "
                f"{float(gval[p, s])} — padding must contribute zeros",
                dict(kind=kind, device=p, slot=s),
            ))
    return out


def verify_norm_table(payload: dict) -> list[Violation]:
    """Verify a norm-table scatter map: each resident block's norm lands at
    its global index exactly once; padding lands in the trash position."""
    out: list[Violation] = []
    P = int(payload["nparts"])
    gpos = np.asarray(payload["gpos"])
    owner = np.asarray(payload["owner"])
    slot = np.asarray(payload["slot"])
    nnzb = int(payload["nnzb"])
    cap = int(payload["cap"])
    if gpos.shape != (P, cap):
        out.append(Violation(
            "norm-scatter",
            f"norm table scatter map has shape {gpos.shape}, layout says "
            f"({P}, {cap})",
            dict(),
        ))
        return out
    want = np.full((P, cap), nnzb, dtype=np.int64)
    if nnzb:
        want[owner, slot] = np.arange(nnzb)
    if not np.array_equal(gpos, want):
        p, s = [int(x[0]) for x in np.nonzero(gpos != want)]
        out.append(Violation(
            "norm-scatter",
            f"norm table scatter: device {p} slot {s} writes position "
            f"{int(gpos[p, s])}, layout says {int(want[p, s])} — a block "
            f"norm would land on the wrong row (or clobber the trash row)",
            dict(device=p, slot=s, got=int(gpos[p, s]),
                 expected=int(want[p, s])),
        ))
    return out


# ---------------------------------------------------------------------------
# structure-union add and compaction verification
# ---------------------------------------------------------------------------


def verify_add_plan(payload: dict) -> list[Violation]:
    """Verify a :class:`repro_torch.dist.collectives.AddExecutable` plan.

    Re-proves the union structure (A wins ownership on overlap, so A blocks
    never move; B-only blocks stay put), both operands' exchange rounds, and
    that every ``(idx, val)`` gather pair resolves — in the staged
    ``[own store | recv per round]`` buffer — to exactly the source block
    the union position demands, with padding masked to zero weight.
    """
    out: list[Violation] = []
    P = int(payload["nparts"])
    pos_a = np.asarray(payload["pos_a"], dtype=np.int64)
    pos_b = np.asarray(payload["pos_b"], dtype=np.int64)
    from_a = np.asarray(payload["from_a"], dtype=np.int64)
    from_b = np.asarray(payload["from_b"], dtype=np.int64)
    c_owner = np.asarray(payload["c_owner"])
    c_cap = int(payload["c_cap"])
    nc = c_owner.shape[0]

    inv_a = _check_layout("add:a", payload["a_owner"], payload["a_slot"],
                          int(payload["a_cap"]), None, P, out)
    inv_b = _check_layout("add:b", payload["b_owner"], payload["b_slot"],
                          int(payload["b_cap"]), None, P, out)
    inv_c = _check_layout("add:c", c_owner, payload["c_slot"], c_cap,
                          None, P, out)
    if inv_a is None or inv_b is None or inv_c is None:
        return out

    a_owner = np.asarray(payload["a_owner"])
    b_owner = np.asarray(payload["b_owner"])
    # union positions partition into {A (wins overlap), B-only}; each source
    # block appears exactly once and ownership is inherited (add is
    # communication-minimal: only overlap copies of B move)
    for name, pos, frm, n_src in (("a", pos_a, from_a, a_owner.shape[0]),
                                  ("b", pos_b, from_b, b_owner.shape[0])):
        if pos.shape[0] != n_src or (n_src and (
                (pos < 0) | (pos >= nc)).any()):
            out.append(Violation(
                "add-union",
                f"add: operand {name!r} union positions do not map its "
                f"{n_src} blocks into the {nc}-block union",
                dict(operand=name),
            ))
            return out
        back = np.nonzero(frm >= 0)[0]
        if not np.array_equal(np.sort(frm[back]), np.arange(n_src)):
            out.append(Violation(
                "add-union",
                f"add: operand {name!r} source map does not cover each of "
                f"its {n_src} blocks exactly once — a block would be "
                f"dropped or double-counted",
                dict(operand=name),
            ))
    if (c_owner[pos_a] != a_owner).any():
        i = int(np.nonzero(c_owner[pos_a] != a_owner)[0][0])
        out.append(Violation(
            "add-union",
            f"add: union block {int(pos_a[i])} does not inherit A block "
            f"{i}'s owner (A wins overlap so A blocks never move); got "
            f"device {int(c_owner[pos_a[i]])}, A owner {int(a_owner[i])}",
            dict(block=int(pos_a[i]), a_block=i),
        ))
    b_only = from_a[pos_b] < 0
    if b_only.any() and (c_owner[pos_b[b_only]] != b_owner[b_only]).any():
        j = int(np.nonzero(b_only & (c_owner[pos_b] != b_owner))[0][0])
        out.append(Violation(
            "add-union",
            f"add: B-only union block {int(pos_b[j])} does not inherit B "
            f"block {j}'s owner — a block with no overlap partner moved",
            dict(block=int(pos_b[j]), b_block=j),
        ))

    _check_rounds("add:a", payload["a_offsets"], payload["a_send"],
                  payload["a_send_cnt"], inv_a, a_owner, P, out)
    _check_rounds("add:b", payload["b_offsets"], payload["b_send"],
                  payload["b_send_cnt"], inv_b, b_owner, P, out)
    buf_a, _ = _staged_buffer(inv_a, int(payload["a_cap"]),
                              payload["a_offsets"], payload["a_send"],
                              payload["a_send_cnt"], P)
    buf_b, _ = _staged_buffer(inv_b, int(payload["b_cap"]),
                              payload["b_offsets"], payload["b_send"],
                              payload["b_send_cnt"], P)

    idx = dict(a=np.asarray(payload["idx_a"]), b=np.asarray(payload["idx_b"]))
    val = dict(a=np.asarray(payload["val_a"]), b=np.asarray(payload["val_b"]))
    frm = dict(a=from_a, b=from_b)
    buf = dict(a=buf_a, b=buf_b)
    for p in range(P):
        mine = np.nonzero(c_owner == p)[0]  # ascending == slot order
        for name in ("a", "b"):
            for local in range(c_cap):
                want = int(frm[name][mine[local]]) if local < mine.size else -1
                v = float(val[name][p, local])
                if want < 0:
                    if v != 0.0:
                        out.append(Violation(
                            "mask-redirect",
                            f"add: device {p} output slot {local} has "
                            f"operand {name!r} weight {v} but no source "
                            f"block — padding / absent operands must "
                            f"contribute zeros",
                            dict(operand=name, device=p, slot=local),
                        ))
                    continue
                i = int(idx[name][p, local])
                got = int(buf[name][p, i]) if 0 <= i < buf[name].shape[1] \
                    else -1
                if v != 1.0 or got != want:
                    delivered = bool((buf[name][p] == want).any())
                    out.append(Violation(
                        "operand-mismatch" if delivered
                        else "use-before-receive",
                        f"add: device {p} output slot {local} gathers "
                        f"operand {name!r} buffer row {i} which "
                        + (f"holds block {got}, not block {want}"
                           if delivered and got >= 0 else
                           f"no exchange round ever delivers block {want} "
                           f"to")
                        + f" device {p} (weight {v})",
                        dict(operand=name, device=p, slot=local,
                             source=want, index=i),
                    ))
    return out


def verify_compact_plan(payload: dict) -> list[Violation]:
    """Verify a :func:`repro_torch.dist.collectives._compact_to_kept` gather map.

    Compaction must be communication-free (kept blocks keep their owners,
    slots close ranks in kept order) and each new slot must gather exactly
    its kept block's old store slot, with padding masked to zero weight.
    """
    out: list[Violation] = []
    P = int(payload["nparts"])
    kind = payload.get("label", "compact")
    a_owner = np.asarray(payload["a_owner"])
    a_slot = np.asarray(payload["a_slot"])
    kept = np.asarray(payload["kept"], dtype=np.int64)
    new_owner = np.asarray(payload["new_owner"])
    new_cap = int(payload["new_cap"])
    gidx = np.asarray(payload["gidx"])
    gval = np.asarray(payload["gval"])

    na = a_owner.shape[0]
    if kept.size and ((kept < 0) | (kept >= na)).any():
        i = int(np.nonzero((kept < 0) | (kept >= na))[0][0])
        out.append(Violation(
            "owner-map",
            f"{kind}: kept entry {i} references block {int(kept[i])} "
            f"outside the {na}-block source structure",
            dict(kind=kind, pos=i, block=int(kept[i])),
        ))
        return out
    if _check_layout(f"{kind}:src", a_owner, a_slot, int(payload["a_cap"]),
                     None, P, out) is None:
        return out
    if _check_layout(f"{kind}:out", new_owner, payload["new_slot"], new_cap,
                     a_owner[kept], P, out) is None:
        return out

    for p in range(P):
        mine = np.nonzero(new_owner == p)[0]  # ascending == slot order
        for local in range(new_cap):
            if local >= mine.size:
                if float(gval[p, local]) != 0.0:
                    out.append(Violation(
                        "mask-redirect",
                        f"{kind}: device {p} padding slot {local} has "
                        f"gather weight {float(gval[p, local])} — padding "
                        f"must contribute zeros",
                        dict(kind=kind, device=p, slot=local),
                    ))
                continue
            src = int(kept[mine[local]])
            want = int(a_slot[src])
            got = int(gidx[p, local])
            if float(gval[p, local]) != 1.0 or got != want:
                out.append(Violation(
                    "operand-mismatch",
                    f"{kind}: device {p} new slot {local} gathers old "
                    f"store row {got} (weight {float(gval[p, local])}), "
                    f"kept block {src} lives in slot {want} — compaction "
                    f"would materialize the wrong block",
                    dict(kind=kind, device=p, slot=local, block=src,
                         got=got, expected=want),
                ))
    return out


# ---------------------------------------------------------------------------
# cache-admission dispatcher
# ---------------------------------------------------------------------------


def verify_payload(payload: dict) -> list[Violation]:
    kind = payload.get("kind")
    if kind == "relayout":
        return verify_relayout_plan(payload)
    if kind == "norm-table":
        return verify_norm_table(payload)
    if kind == "add":
        return verify_add_plan(payload)
    if kind == "compact":
        return verify_compact_plan(payload)
    return []


def verify_value(key, value) -> list[Violation] | None:
    """Verify whatever a plan-cache builder returned.

    Returns ``None`` when the value carries nothing verifiable (symbolic
    task lists, scalar reductions, ...), else the violation report.  Plans
    appear directly or inside (plan, executable) tuples; relayout and
    norm-table executables retain their host-side plan arrays in a
    ``_verify_plan`` payload dict.
    """
    items = list(value) if isinstance(value, (tuple, list)) else [value]
    report: list[Violation] | None = None
    for item in items:
        if isinstance(item, SpgemmPlan):
            found = verify_spgemm_plan(item)
        else:
            payload = getattr(item, "_verify_plan", None)
            if payload is None:
                continue
            found = verify_payload(payload)
        report = (report if report is not None else []) + found
    return report
