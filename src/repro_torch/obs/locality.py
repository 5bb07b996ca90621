"""Data-locality ledger — who owned each operand byte, who fetched it, how often.

The paper's central empirical claim is that the runtime "dynamically
exploit[s] data locality to avoid movement of data".  The tracer measures
*time* and the memory meter measures *bytes resident*, but neither
attributes movement to *placement decisions*.  This module closes that gap:

* :class:`LocalityLedger` — rides on the plan cache like the tracer and
  event log (``cache.locality_ledger``, installed via :meth:`install`,
  read back with ``getattr`` so un-instrumented dispatches pay nothing).
  Every multiply-family dispatch feeds it one :meth:`note_dispatch` call;
  the ledger decomposes the executed plan's operand reads into
  locally-owned vs shipped bytes (static residency split, from
  :func:`repro_torch.core.schedule.plan_byte_provenance`), meters what actually
  crossed the wire (delta-mask pruning and bf16 wire halving applied), and
  accumulates per-block movement lineage — who owned a block, who fetched
  it, and how many times across the run.  A block re-fetched every
  iteration is the cache-opportunity signal a future exchange cache would
  exploit.
* :func:`locality_snapshot` / :func:`locality_iteration` — the driver-side
  per-iteration emission pair: fraction fields into the stats row, span
  attrs on the iteration span, tracer gauges, and one ``locality``
  :class:`~repro_torch.obs.log.EventLog` record.

Accounting invariants (tested in ``tests/test_locality.py``):

* ``local_bytes + shipped_bytes == referenced_bytes`` exactly — the static
  residency split conserves, per worker and in total.
* ``local_bytes`` is a placement property, not a mask property: delta-mask
  pruning shrinks ``wire_recv_bytes`` but never ``local_bytes`` (a locally
  owned block is resident whether or not this dispatch's mask reads it).
* For p2p plans the static ``shipped`` decomposition equals
  ``plan_worker_bytes``'s ``recv_actual`` bit-for-bit (hypothesis-tested
  in the analysis CI job).

The ledger only ever meters *verified* plans: :meth:`install` refuses a
cache whose static-verification policy is ``"off"``.
"""

from __future__ import annotations

import json
import typing

import numpy as np

from .log import log_of
from .tracer import tracer_of

if typing.TYPE_CHECKING:  # core.cache imports obs.log: keep obs<->core lazy
    from ..core.schedule import SpgemmPlan

__all__ = [
    "LocalityLedger",
    "ledger_of",
    "plan_provenance",
    "locality_snapshot",
    "locality_iteration",
    "LOCALITY_ITER_KEYS",
]

#: rider attribute memoizing a plan's static byte provenance (computed once
#: per plan, like the dispatch annotations' ``_obs_static`` rider)
_PROV_ATTR = "_obs_locality"
_STATIC_ATTR = "_obs_locality_dispatch"

#: the per-iteration fields locality_iteration() appends to driver rows —
#: schema-stable like SHARED_ITER_KEYS
LOCALITY_ITER_KEYS = (
    "locality_flops",
    "locality_bytes",
    "local_bytes",
    "shipped_bytes",
    "wire_recv_bytes",
    "wire_send_bytes",
)


def plan_provenance(plan: SpgemmPlan) -> dict:
    """Memoized :func:`~repro_torch.core.schedule.plan_byte_provenance` of a plan.

    The provenance is a pure structural property, so it rides on the frozen
    plan (``object.__setattr__``) and every later dispatch of the same plan
    reuses it — steady-state dispatch cost is a few vector adds.
    """
    prov = getattr(plan, _PROV_ATTR, None)
    if prov is None:
        from ..core.schedule import plan_byte_provenance  # lazy: import cycle

        prov = plan_byte_provenance(plan)
        object.__setattr__(plan, _PROV_ATTR, prov)
    return prov


def _frac(num: float, den: float) -> float:
    return float(num / den) if den > 0 else 1.0


class LocalityLedger:
    """Cumulative locality account of every verified multiply dispatch.

    Scalar totals are mirrored by per-worker vectors (lazily sized to the
    first dispatched plan's ``nparts``).  Movement lineage is appended as
    raw per-dispatch arrays and aggregated only in :meth:`moved_blocks` /
    :meth:`summary`, keeping the dispatch-path cost flat.
    """

    def __init__(self, *, top_k: int = 10):
        self.top_k = int(top_k)
        self.nparts: int | None = None
        self.dispatches = 0
        # static residency split, fp32 itemsize (conserving: local + shipped
        # == referenced, per worker)
        self.referenced_bytes = 0.0
        self.local_bytes = 0.0
        self.shipped_bytes = 0.0
        # what actually crossed the wire: delta-mask pruning drops whole
        # blocks, reduced precision halves the per-block payload
        self.wire_recv_bytes = 0.0
        self.wire_send_bytes = 0.0
        # locally-satisfied flops (both operands resident on the task's
        # worker) vs total executed flops — runtime task masks honored
        self.local_flops = 0.0
        self.total_flops = 0.0
        self._pw: dict[str, np.ndarray] | None = None
        # movement lineage: per-dispatch (operand, code, src, dst) arrays
        self._lineage: list[tuple[str, np.ndarray, np.ndarray, np.ndarray]] = []

    # -- wiring ---------------------------------------------------------------
    def install(self, cache) -> "LocalityLedger":
        """Attach as ``cache.locality_ledger``.

        Refuses a cache with static verification off: the ledger's numbers
        are placement claims about executed plans, and an unverified plan
        could mis-attribute every byte.
        """
        if getattr(cache, "verify", "off") == "off":
            raise ValueError(
                "locality ledger only meters verified plans: set "
                "cache.verify to 'cached-once' or 'always', not 'off'")
        cache.locality_ledger = self
        return self

    # -- dispatch-side metering ----------------------------------------------
    def note_dispatch(self, plan: SpgemmPlan, *, wire_itemsize: int = 4,
                      task_on: np.ndarray | None = None,
                      keeps: tuple | None = None,
                      a_codes: np.ndarray | None = None,
                      b_codes: np.ndarray | None = None) -> dict:
        """Meter one executed plan; returns this dispatch's scalar deltas.

        ``task_on`` is the delta-plan runtime task mask (``[P, t_cap]``
        bool) when the dispatch masked tasks; ``keeps`` is the per-round
        exchange keep-mask pair ``(a_keeps, b_keeps)`` when the fused
        masked engine also pruned the wire.  ``a_codes`` / ``b_codes`` are
        the operands' Morton codes — the structure-stable block identity
        lineage is keyed by (falls back to global indices, which are only
        stable within one structure).
        """
        prov = plan_provenance(plan)
        P = plan.nparts
        if self._pw is None:
            self.nparts = P
            self._pw = {k: np.zeros(P, dtype=np.float64) for k in (
                "referenced", "local", "shipped", "wire_recv", "wire_send",
                "local_flops", "total_flops")}
        pw = self._pw
        if task_on is None and keeps is None:
            # the whole plan ran over its full exchange: every number is a
            # property of the plan and the wire type, computed once
            static = _plan_dispatch_static(plan, prov, wire_itemsize)
            vec, out = static["per_worker"], static["out"]
        else:
            vec, out = _dispatch_account(plan, prov, wire_itemsize, task_on, keeps)
        for k, v in vec.items():
            pw[k] += v

        self._note_lineage(plan, prov, keeps, a_codes, b_codes)

        self.dispatches += 1
        out = dict(out)
        self.referenced_bytes += out["referenced_bytes"]
        self.local_bytes += out["local_bytes"]
        self.shipped_bytes += out["shipped_bytes"]
        self.wire_recv_bytes += out["wire_recv_bytes"]
        self.wire_send_bytes += out["wire_send_bytes"]
        self.local_flops += out["local_flops"]
        self.total_flops += out["total_flops"]
        return out

    def _note_lineage(self, plan, prov, keeps, a_codes, b_codes) -> None:
        """Append each operand's fetches; their Morton keys are looked up
        only when :meth:`moved_blocks` aggregates (the arrays are kept by
        reference: a plan's fetches and a matrix's codes never change)."""
        for name, codes, keep_i in (("a", a_codes, 0), ("b", b_codes, 1)):
            if keeps is None:
                gids, src, dst = prov[f"fetch_{name}"]
            else:
                gids, src, dst = _kept_fetches(plan, name, keeps[keep_i])
            if gids.size:
                self._lineage.append((name, codes, gids, src, dst))

    # -- per-iteration deltas -------------------------------------------------
    def snapshot(self) -> tuple:
        """Scalar snapshot for per-iteration deltas (see :meth:`delta`)."""
        return (self.local_flops, self.total_flops, self.local_bytes,
                self.shipped_bytes, self.referenced_bytes,
                self.wire_recv_bytes, self.wire_send_bytes)

    def delta(self, snap: tuple) -> dict:
        """Locality accumulated since ``snap``: the per-iteration fields
        (:data:`LOCALITY_ITER_KEYS`) the drivers append to stats rows."""
        lf, tf, lb, sb, rb, wr, ws = snap
        d_lf = self.local_flops - lf
        d_tf = self.total_flops - tf
        d_lb = self.local_bytes - lb
        d_rb = self.referenced_bytes - rb
        return dict(
            locality_flops=_frac(d_lf, d_tf),
            locality_bytes=_frac(d_lb, d_rb),
            local_bytes=d_lb,
            shipped_bytes=self.shipped_bytes - sb,
            wire_recv_bytes=self.wire_recv_bytes - wr,
            wire_send_bytes=self.wire_send_bytes - ws,
        )

    # -- aggregation ----------------------------------------------------------
    def moved_blocks(self, top_k: int | None = None) -> list[dict]:
        """The most-fetched blocks across the run, most-moved first.

        One record per (operand, block): fetch count (re-fetch across
        iterations counts every time — the cache-opportunity signal),
        distinct fetching workers, and the owning worker(s) observed.
        """
        top_k = self.top_k if top_k is None else int(top_k)
        out = []
        for op in ("a", "b"):
            chunks = [(np.asarray(gids if codes is None else codes[gids], dtype=np.int64), s, d)
                      for (o, codes, gids, s, d) in self._lineage if o == op]
            if not chunks:
                continue
            codes = np.concatenate([c for c, _, _ in chunks])
            src = np.concatenate([s for _, s, _ in chunks])
            dst = np.concatenate([d for _, _, d in chunks])
            uniq, inv, cnts = np.unique(codes, return_inverse=True,
                                        return_counts=True)
            for i in np.argsort(-cnts, kind="stable")[:top_k]:
                sel = inv == i
                out.append(dict(
                    operand=op,
                    code=int(uniq[i]),
                    fetches=int(cnts[i]),
                    fetchers=np.unique(dst[sel]).astype(int).tolist(),
                    owners=np.unique(src[sel]).astype(int).tolist(),
                ))
        out.sort(key=lambda r: -r["fetches"])
        return out[:top_k]

    def summary(self) -> dict:
        """JSON-safe run totals: fractions, per-worker table, moved blocks."""
        pw = self._pw
        per_worker = []
        if pw is not None:
            for p in range(self.nparts):
                per_worker.append(dict(
                    worker=p,
                    referenced_bytes=float(pw["referenced"][p]),
                    local_bytes=float(pw["local"][p]),
                    shipped_bytes=float(pw["shipped"][p]),
                    wire_recv_bytes=float(pw["wire_recv"][p]),
                    wire_send_bytes=float(pw["wire_send"][p]),
                    locality_bytes=_frac(pw["local"][p], pw["referenced"][p]),
                    locality_flops=_frac(pw["local_flops"][p],
                                         pw["total_flops"][p]),
                ))
        return dict(
            dispatches=self.dispatches,
            nparts=self.nparts,
            locality_flops=_frac(self.local_flops, self.total_flops),
            locality_bytes=_frac(self.local_bytes, self.referenced_bytes),
            referenced_bytes=self.referenced_bytes,
            local_bytes=self.local_bytes,
            shipped_bytes=self.shipped_bytes,
            wire_recv_bytes=self.wire_recv_bytes,
            wire_send_bytes=self.wire_send_bytes,
            local_flops=self.local_flops,
            total_flops=self.total_flops,
            per_worker=per_worker,
            moved_blocks=self.moved_blocks(),
        )

    def write(self, path: str) -> str:
        with open(path, "w") as fh:
            json.dump(self.summary(), fh, indent=2)
            fh.write("\n")
        return path


def _dispatch_account(plan: SpgemmPlan, prov: dict, wire_itemsize: int, task_on, keeps):
    """One dispatch's per-worker increments and scalar deltas: the executed
    tasks (``task_on``, else all of the plan's) and the kept wire (``keeps``,
    else the whole planned exchange at ``wire_itemsize``)."""
    flop = 2.0 * float(plan.bs) ** 3
    if task_on is None:
        counts = plan.task_count.astype(np.float64)
        lcounts = prov["local_tasks"].astype(np.float64)
    else:
        counts = task_on.sum(axis=1).astype(np.float64)
        lcounts = (prov["task_local"] & task_on).sum(axis=1).astype(np.float64)
    if keeps is None:
        scale = wire_itemsize / 4.0
        wrecv = prov["wire_recv"] * scale
        wsend = prov["wire_send"] * scale
    else:
        wrecv, wsend = _kept_wire(plan, keeps, wire_itemsize)
    vec = dict(referenced=prov["referenced"], local=prov["local"], shipped=prov["shipped"],
               total_flops=counts * flop, local_flops=lcounts * flop,
               wire_recv=wrecv, wire_send=wsend)
    out = dict(
        referenced_bytes=float(prov["referenced"].sum()),
        local_bytes=float(prov["local"].sum()),
        shipped_bytes=float(prov["shipped"].sum()),
        wire_recv_bytes=float(wrecv.sum()),
        wire_send_bytes=float(wsend.sum()),
        local_flops=float(lcounts.sum() * flop),
        total_flops=float(counts.sum() * flop),
    )
    return vec, out


def _plan_dispatch_static(plan: SpgemmPlan, prov: dict, wire_itemsize: int) -> dict:
    """:func:`_dispatch_account` of a dispatch that ran the whole plan, memoized
    on the frozen plan per wire itemsize, as :func:`plan_provenance` is."""
    memo = getattr(plan, _STATIC_ATTR, None)
    if memo is None:
        memo = {}
        object.__setattr__(plan, _STATIC_ATTR, memo)
    st = memo.get(wire_itemsize)
    if st is None:
        vec, out = _dispatch_account(plan, prov, wire_itemsize, None, None)
        st = memo[wire_itemsize] = dict(per_worker=vec, out=out)
    return st


def _kept_wire(plan: SpgemmPlan, keeps: tuple, wire_itemsize: int):
    """Per-worker wire bytes of a keep-mask-pruned exchange."""
    P = plan.nparts
    wblk = plan.bs * plan.bs * wire_itemsize
    wrecv = np.zeros(P, dtype=np.float64)
    wsend = np.zeros(P, dtype=np.float64)
    for (offs, send_cnt), keep in zip(
        ((plan.a_offsets, plan.a_send_count), (plan.b_offsets, plan.b_send_count)),
        keeps,
    ):
        for r, d in enumerate(offs):
            cnt = send_cnt[d]
            k = np.asarray(keep[r], dtype=bool)
            in_cnt = np.arange(k.shape[1])[None, :] < cnt[:, None]
            kept = (k & in_cnt).sum(axis=1).astype(np.float64)
            wsend += kept * wblk
            wrecv[(np.arange(P) + d) % P] += kept * wblk
    return wrecv, wsend


def _kept_fetches(plan: SpgemmPlan, name: str, keep: list):
    """(gids, src, dst) of the blocks a pruned exchange actually delivered."""
    offs = plan.a_offsets if name == "a" else plan.b_offsets
    send = plan.a_send if name == "a" else plan.b_send
    send_cnt = plan.a_send_count if name == "a" else plan.b_send_count
    store_idx = plan.a_store_idx if name == "a" else plan.b_store_idx
    P = plan.nparts
    gids_l, src_l, dst_l = [], [], []
    for r, d in enumerate(offs):
        k = np.asarray(keep[r], dtype=bool)
        live = k & (np.arange(k.shape[1])[None, :] < send_cnt[d][:, None])
        src, col = np.nonzero(live)  # row-major: by sender, then slot, as delivered
        if not src.size:
            continue
        gids_l.append(store_idx[src, send[d][src, col]].astype(np.int64))
        src_l.append(src.astype(np.int32))
        dst_l.append(((src + d) % P).astype(np.int32))
    if not gids_l:
        z = np.zeros(0, np.int64)
        return z, np.zeros(0, np.int32), np.zeros(0, np.int32)
    return (np.concatenate(gids_l), np.concatenate(src_l),
            np.concatenate(dst_l))


def ledger_of(cache) -> LocalityLedger | None:
    """The ledger riding on the plan cache, or None when not installed."""
    if cache is None:
        return None
    return getattr(cache, "locality_ledger", None)


def locality_snapshot(cache) -> tuple | None:
    """Iteration-top ledger snapshot; None when no ledger is installed."""
    lld = ledger_of(cache)
    return lld.snapshot() if lld is not None else None


def locality_iteration(cache, scope, snap: tuple | None, *,
                       iteration, driver: str) -> dict:
    """Per-iteration locality emission: returns the row-extra fields and
    lands the same numbers as span attrs, tracer gauges and an EventLog
    ``locality`` record.  A cheap no-op dict when no ledger is installed,
    so un-instrumented drivers pay a getattr and nothing else."""
    lld = ledger_of(cache)
    if lld is None or snap is None:
        return {}
    fields = lld.delta(snap)
    scope.annotate(**fields)
    tr = tracer_of(cache)
    if tr.enabled:
        tr.gauge("locality_flops").set(fields["locality_flops"])
        tr.gauge("locality_bytes").set(fields["locality_bytes"])
    lg = log_of(cache)
    if lg.enabled:
        lg.info("locality", driver=driver, iteration=iteration, **fields)
    return fields
