"""The observatory's cheaper dispatch path against the forms it replaced.

The locality ledger's masked-dispatch totals (a few array passes), its
vectorised per-worker wire split and its deferred lineage; the health
monitor's median; the tracer's span as its own context manager; and the
profile script that splits the observers' main-thread time.  Each new form
is held to the loop or the numpy call it replaced, on the same plans.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from helpers import random_block_matrix
from repro_torch.core.distributed import _exchange_keep_masks
from repro_torch.core.schedule import make_spgemm_plan
from repro_torch.obs import LocalityLedger, Tracer
from repro_torch.obs import health as thealth
from repro_torch.obs import locality as tloc

ROOT = os.path.join(os.path.dirname(__file__), "..")
BS = 16


def _plan(nparts, skew, seed=3):
    m = random_block_matrix(256, BS, 0.25, seed=seed)
    owner = np.zeros(m.coords.shape[0], np.int32) if skew else None
    return make_spgemm_plan(m.coords, m.coords, nparts, BS, a_owner=owner, b_owner=owner), m


def _kept_wire_loop(plan, keeps, wire_itemsize):
    """The per-round loop the ledger ran before (the JAX package's form)."""
    P = plan.nparts
    wblk = plan.bs * plan.bs * wire_itemsize
    wrecv = np.zeros(P, dtype=np.float64)
    wsend = np.zeros(P, dtype=np.float64)
    for (offs, send_cnt), keep in zip(((plan.a_offsets, plan.a_send_count),
                                       (plan.b_offsets, plan.b_send_count)), keeps):
        for r, d in enumerate(offs):
            k = np.asarray(keep[r], dtype=bool)
            in_cnt = np.arange(k.shape[1])[None, :] < send_cnt[d][:, None]
            kept = (k & in_cnt).sum(axis=1).astype(np.float64)
            wsend += kept * wblk
            wrecv[(np.arange(P) + d) % P] += kept * wblk
    return wrecv, wsend


@pytest.mark.parametrize("wire", [4, 2])
@pytest.mark.parametrize("nparts,skew", [(3, False), (4, True), (8, False)])
def test_masked_dispatch_accounts_equal_the_loop(nparts, skew, wire):
    plan, _ = _plan(nparts, skew)
    prov = tloc.plan_provenance(plan)
    rng = np.random.default_rng(nparts)
    for frac in (0.0, 0.3, 1.0):
        keeps = _exchange_keep_masks(plan, rng.random(plan.tasks.num_tasks) < frac)[:2]
        got = tloc._kept_wire(plan, keeps, wire)
        want = _kept_wire_loop(plan, keeps, wire)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
        task_on = rng.random(plan.task_gidx.shape) < 0.5
        for t, k in ((task_on, keeps), (task_on, None), (None, keeps)):
            totals = tloc._dispatch_totals(plan, prov, wire, t, k)
            assert totals == tloc._dispatch_account(plan, prov, wire, t, k)[1]


def test_ledger_resolves_deferred_work_in_dispatch_order():
    """Per-worker vectors and lineage are worked out when read: the summary
    equals that of a ledger whose pending work is resolved after every dispatch."""
    plan, m = _plan(4, True)
    codes = np.arange(m.coords.shape[0]) * 7
    rng = np.random.default_rng(0)
    masks = [_exchange_keep_masks(plan, rng.random(plan.tasks.num_tasks) < 0.4)[:2]
             for _ in range(3)]
    lazy, eager = LocalityLedger(top_k=4), LocalityLedger(top_k=4)
    for ledger in (lazy, eager):
        for keeps in masks:
            ledger.note_dispatch(plan, a_codes=codes, b_codes=codes)
            ledger.note_dispatch(plan, keeps=keeps, wire_itemsize=2, a_codes=codes,
                                 b_codes=codes,
                                 task_on=np.ones(plan.task_gidx.shape, bool))
            if ledger is eager:
                ledger._per_worker()
                assert not ledger._pending
    assert lazy._pending and lazy.summary() == eager.summary()
    assert lazy.summary()["moved_blocks"] and not lazy._pending


def test_health_median_equals_numpy():
    rng = np.random.default_rng(1)
    for n in range(1, 70):
        for scale in (1e-3, 1.0, 1e9):
            x = (rng.random(n) * scale).tolist()
            assert thealth._median(x) == float(np.median(x))


def test_span_is_its_own_context_and_drops_its_tracer():
    tr = Tracer(sync=False)
    with tr.span("outer", cat="a", n=1) as outer:
        with tr.span("inner", cat="b") as inner:
            inner.args["k"] = 2
        assert tr._stack == [0]
    assert outer is tr.spans[0] and inner is tr.spans[1]
    assert (inner.parent, outer.parent) == (0, -1) and inner.args == {"k": 2}
    assert outer._tracer is None and inner._tracer is None and tr._stack == []
    c = tr.counter("x")
    c.add(2.0)
    tr.gauge("g").set(3)
    assert [e[1:] for e in tr._counter_events] == [("x", 2.0), ("g", 3.0)]


def test_profile_script_splits_the_observers(tmp_path):
    out = tmp_path / "split.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "benchmarks", "torch_obs_profile.py"),
                           "--device", "cpu", "--n", "128", "--bs", "16", "--runs", "1",
                           "--out", str(out)],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    split = json.loads(out.read_text())
    assert {"tracer", "locality", "memory", "health", "log"} <= set(split["entry_points_ms"])
    assert split["spans"] > 0 and split["counter_events"] > 0
    assert "LocalityLedger.summary" in split["entry_points"]["locality"]
    assert 0 < split["locality_read_ms"] <= split["entry_points_ms"]["locality"]
    assert all(v >= 0 for v in split["cprofile_ms"].values())
