"""Seeded plan corruptions — proof the verifier detects, not just passes.

Each corruption clones a clean :class:`~repro_torch.core.schedule.SpgemmPlan`,
breaks exactly one scheduling invariant, and names the check that must
catch it.  The mutation tests run every corruption against
:func:`repro_torch.analysis.verify.verify_spgemm_plan` and require the
named violation with non-empty provenance.  The JAX package's
``repro/analysis/mutate.py``, corruption for corruption.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.schedule import SpgemmPlan

__all__ = ["clone_plan", "CORRUPTIONS", "NotApplicable"]


class NotApplicable(RuntimeError):
    """The clean plan lacks the structure this corruption needs (e.g. no
    exchange rounds on a single-worker plan)."""


def clone_plan(plan: SpgemmPlan) -> SpgemmPlan:
    """Deep-copy the plan's arrays so corruptions never touch the original
    (the memoized send-task spans are deliberately not carried over)."""
    kw = {}
    for f in dataclasses.fields(SpgemmPlan):
        val = getattr(plan, f.name)
        if isinstance(val, np.ndarray):
            val = val.copy()
        elif isinstance(val, dict):
            val = {k: np.array(v, copy=True) for k, v in val.items()}
        kw[f.name] = val
    return SpgemmPlan(**kw)


def _first_round(plan, min_count=1):
    for name in ("a", "b"):
        offsets = plan.a_offsets if name == "a" else plan.b_offsets
        cnts = plan.a_send_count if name == "a" else plan.b_send_count
        for d in offsets:
            for src in range(plan.nparts):
                if int(cnts[d][src]) >= min_count:
                    return name, d, src
    raise NotApplicable(f"no exchange round ships >= {min_count} blocks")


def corrupt_send_conflict(plan):
    """Duplicate a send slot within one round: two sends, one recv slot."""
    p = clone_plan(plan)
    name, d, src = _first_round(p, min_count=2)
    send = p.a_send if name == "a" else p.b_send
    send[d][src, 1] = send[d][src, 0]
    return p, {}


def corrupt_src_off_oob(plan):
    """Point a fused (src, off) address past its round's true capacity."""
    p = clone_plan(plan)
    if p.task_a_src is None:
        raise NotApplicable("plan has no fused addressing")
    hits = np.nonzero(np.asarray(p.task_a_src) > 0)
    if not hits[0].size:
        raise NotApplicable("no task reads a receive buffer")
    dev, t = int(hits[0][0]), int(hits[1][0])
    r = int(p.task_a_src[dev, t]) - 1
    width = p.a_send[p.a_offsets[r]].shape[1]
    p.task_a_off[dev, t] = width  # one past the round capacity
    return p, {}


def corrupt_round_permutation(plan):
    """Shift a round to ring offset 0 — a self-send, not a permutation."""
    p = clone_plan(plan)
    for name in ("a", "b"):
        offsets = getattr(p, f"{name}_offsets")
        if offsets:
            d0 = offsets[0]
            for attr in (f"{name}_send", f"{name}_send_count"):
                table = getattr(p, attr)
                table[0] = table.pop(d0)
            object.__setattr__(p, f"{name}_offsets", (0,) + offsets[1:])
            return p, {}
    raise NotApplicable("plan has no exchange rounds")


def corrupt_use_before_receive(plan):
    """Erase the delivery a remote task depends on (send count to zero)."""
    p = clone_plan(plan)
    for name in ("a", "b"):
        offsets = getattr(p, f"{name}_offsets")
        cnts = getattr(p, f"{name}_send_count")
        for d in offsets:
            src = int(np.argmax(cnts[d]))
            if int(cnts[d][src]):
                cnts[d][src] = 0
                return p, {}
    raise NotApplicable("plan has no exchange rounds")


def corrupt_c_slot_race(plan):
    """Merge two output blocks' accumulation chains into one slot."""
    p = clone_plan(plan)
    for dev in range(p.nparts):
        cnt = int(p.task_count[dev])
        tc = p.task_c[dev, :cnt]
        change = np.nonzero(np.diff(tc) > 0)[0]
        if change.size:
            t = int(change[0]) + 1  # first slot of the second run
            run2 = tc[t]
            p.task_c[dev, :cnt][tc == run2] = tc[t - 1]
            return p, {}
    raise NotApplicable("no device accumulates two distinct output blocks")


def corrupt_owner_fingerprint(plan):
    """Flip one owner entry so the plan disagrees with the fingerprinted
    owner map (and with its own slot/store layout)."""
    p = clone_plan(plan)
    if p.nparts < 2 or not p.a_owner.size:
        raise NotApplicable("needs >= 2 devices and a nonempty A")
    i = int(p.a_owner.shape[0] // 2)
    p.a_owner[i] = (int(p.a_owner[i]) + 1) % p.nparts
    return p, {"expected_a_owner": np.asarray(plan.a_owner).copy()}


def corrupt_mask_redirect(plan):
    """Aim a padded task slot at a live output row instead of the trash."""
    p = clone_plan(plan)
    pads = np.nonzero(np.asarray(p.task_count) < p.t_cap)[0]
    if not pads.size:
        raise NotApplicable("no device has padded task slots")
    dev = int(pads[0])
    p.task_c[dev, int(p.task_count[dev])] = p.c_cap - 1
    return p, {}


def corrupt_capacity_mismatch(plan):
    """Claim more sends than the padded round capacity holds."""
    p = clone_plan(plan)
    name, d, src = _first_round(p)
    cnts = p.a_send_count if name == "a" else p.b_send_count
    send = p.a_send if name == "a" else p.b_send
    cnts[d][src] = send[d].shape[1] + 1
    return p, {}


def corrupt_accumulation_order(plan):
    """Swap two tasks inside one accumulation chain, breaking the stable
    symbolic order fp32 bit-exactness under re-layout depends on."""
    p = clone_plan(plan)
    for dev in range(p.nparts):
        cnt = int(p.task_count[dev])
        tc = p.task_c[dev, :cnt]
        runs = np.nonzero(np.diff(tc) == 0)[0]
        if not runs.size:
            continue
        t = int(runs[0])  # tasks t, t+1 share an output slot
        for arr in (p.task_a, p.task_b, p.task_gidx,
                    p.task_a_src, p.task_a_off, p.task_b_src, p.task_b_off):
            if arr is not None:
                arr[dev, t], arr[dev, t + 1] = arr[dev, t + 1], arr[dev, t]
        return p, {}
    raise NotApplicable("no output slot accumulates two tasks")


# name -> (corruption, the check that must catch it)
CORRUPTIONS = {
    "send_conflict": (corrupt_send_conflict, "send-conflict"),
    "src_off_oob": (corrupt_src_off_oob, "src-off-oob"),
    "round_permutation": (corrupt_round_permutation, "round-permutation"),
    "use_before_receive": (corrupt_use_before_receive, "use-before-receive"),
    "c_slot_race": (corrupt_c_slot_race, "c-slot-race"),
    "owner_fingerprint": (corrupt_owner_fingerprint, "owner-fingerprint"),
    "mask_redirect": (corrupt_mask_redirect, "mask-redirect"),
    "capacity_mismatch": (corrupt_capacity_mismatch, "capacity-mismatch"),
    "accumulation_order": (corrupt_accumulation_order, "accumulation-order"),
}
