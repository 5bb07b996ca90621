"""The port's observatory against the JAX package's: tracer, Chrome export,
reports, locality ledger, task-graph analytics and memory accounting.

Everything here is host-side: the same scripted span program runs on both
packages' tracers under a deterministic clock, and the ledger, the
task-graph analysis and the memory account read plans built from the same
structures, so results are held equal — events, fractions, byte totals and
critical paths exactly.  The last tests drive the port's resident drivers
on 8 CPU workers with the observatory on: D is bit-identical to a run with
it off, every row shares one schema, and the written trace validates with
one track per worker.  (The JAX package's drivers are held against the
port's in ``test_torch_health.py``.)
"""

import json
import os
import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from helpers import random_block_matrix  # noqa: E402
import repro.obs as jobs  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro.core.distributed import _exchange_keep_masks as j_keep_masks  # noqa: E402
from repro.core.schedule import make_spgemm_plan as j_make_plan  # noqa: E402
from repro_torch.core import BSMatrix  # noqa: E402
from repro_torch.core.cache import SymbolicCache  # noqa: E402
from repro_torch.core.distributed import _exchange_keep_masks, make_worker_mesh  # noqa: E402
from repro_torch.core.schedule import make_spgemm_plan  # noqa: E402
from repro_torch.dist import PlanCache, RebalancePolicy, dist_sp2_purify, scatter  # noqa: E402
from repro_torch.dist import dist_localized_inverse_factorization  # noqa: E402
from repro_torch.kernels.precision import BF16  # noqa: E402

BS = 16


class Tick:
    """Deterministic clock: advances 1.0 s per call."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _program(obs):
    """One scripted span program: nesting, attributed steps, counters,
    gauges and instants, as the drivers emit them."""
    tr = obs.Tracer(clock=Tick(), sync=False)
    with tr.span("phase", cat="phase", n=3):
        with tr.span("dispatch", cat="dispatch") as sp:
            sp.worker_costs = np.array([2.0, 1.0, 0.0, 1.0])
            tr.counter("tasks_executed").add(4)
        with tr.span("outer", cat="collective") as sp:
            sp.worker_costs = np.array([1.0, 1.0, 1.0, 1.0])
            with tr.span("inner", cat="dispatch") as inner:
                inner.worker_costs = np.array([3.0, 1.0, 1.0, 1.0])
            tr.instant("exchange_round", cat="exchange", bytes=256)
        tr.gauge("imbalance").set(1.5)
        tr.counter("tasks_executed").add(2)
    return tr


def _spans(tr):
    return [(s.name, s.cat, s.t0, s.t1, s.parent, s.args,
             None if s.worker_costs is None else list(s.worker_costs)) for s in tr.spans]


def test_tracer_records_the_same_program_as_jax():
    got, want = _program(tobs), _program(jobs)
    assert _spans(got) == _spans(want)
    assert got.instants == want.instants
    assert got._counter_events == want._counter_events
    assert got.metrics_flat() == want.metrics_flat()
    assert got.instants_of("exchange_round", "exchange") == [{"bytes": 256}]
    assert got._stack == []


def test_chrome_export_reports_and_validation_match_jax(tmp_path):
    got, want = _program(tobs), _program(jobs)
    assert tobs.chrome_trace_events(got) == jobs.chrome_trace_events(want)
    summary = tobs.write_chrome_trace(got, str(tmp_path / "t.json"))
    assert summary == jobs.write_chrome_trace(want, str(tmp_path / "j.json"))
    assert summary["workers"] == 4 and summary["host_spans"] == 4
    assert tobs.validate_chrome_trace(str(tmp_path / "t.json")) == summary
    util = tobs.worker_utilization(got)
    assert util == jobs.worker_utilization(want)
    assert tobs.utilization_from_file(str(tmp_path / "t.json")) == \
        jobs.utilization_from_file(str(tmp_path / "j.json"))
    assert tobs.utilization_table(util, [1e6] * 4) == jobs.utilization_table(util, [1e6] * 4)
    # only the outermost attributed span of a nest feeds the worker tracks
    busy = [e for e in tobs.chrome_trace_events(got) if e.get("pid") == 1 and e["ph"] == "B"]
    assert {e["name"] for e in busy} == {"dispatch", "outer"}


def test_validate_rejects_misnested_pairs():
    bad = [
        {"ph": "M", "pid": 0, "tid": 0, "name": "thread_name", "args": {"name": "host"}},
        {"ph": "B", "pid": 0, "tid": 0, "ts": 0.0, "name": "a", "cat": "c"},
        {"ph": "B", "pid": 0, "tid": 0, "ts": 1.0, "name": "b", "cat": "c"},
        {"ph": "E", "pid": 0, "tid": 0, "ts": 2.0, "name": "a"},
    ]
    with pytest.raises(AssertionError):
        tobs.validate_chrome_trace(bad)


def test_null_tracer_and_the_cache_riders():
    null = tobs.NULL_TRACER
    assert not null and not null.enabled
    with null.span("x", cat="c", a=1) as sp:
        sp.worker_costs = [1, 2]  # annotations vanish
        sp.args.update(k=1)
    assert sp.worker_costs is None and sp.args == {}
    null.counter("c").add(5)
    null.instant("i")
    assert null.metrics_flat() == {} and null.instants_of("i") == [] and null.sync("v") == "v"
    cache = SymbolicCache()
    assert tobs.tracer_of(cache) is null and tobs.log_of(cache) is tobs.NULL_LOG
    assert (cache.flight_recorder, cache.memory_meter, cache.locality_ledger) == (None, None, None)
    tr = tobs.Tracer(sync=False)
    cache.tracer = tr
    assert tobs.tracer_of(cache) is tr
    cache.tracer = None
    assert cache.tracer is null
    cache = SymbolicCache(tracer=tr)
    cache.get_or_build(("spgemm", 1), lambda: "v")
    cache.get_or_build(("spgemm", 1), lambda: "v")
    m = tobs.run_metrics(cache)
    assert (m["plan_misses"], m["plan_hits"], m["hits"], m["misses"]) == (1, 1, 1, 1)
    assert any(s.name == "plan_build" for s in tr.spans)
    plain = SymbolicCache()
    plain.get_or_build(("add", 1), lambda: "v")
    assert tobs.run_metrics(plain) == plain.stats()


def test_timing_idioms_and_scope_annotation():
    cache = SymbolicCache()
    tr = tobs.Tracer(clock=Tick(), sync=False)
    with tobs.timed_into(cache, "symbolic_s", tr, "descent", cat="symbolic", n=3):
        pass
    assert cache.symbolic_s > 0 and tr.spans[0].args == {"n": 3}
    with tobs.IterationScope(cache, 2, tr, name="sp2_iteration") as scope:
        cache.get_or_build(("k",), lambda: 1)
        scope.annotate(locality_flops=0.5)
        row = scope.row(nnzb=7, idem=0.5)
    assert set(tobs.SHARED_ITER_KEYS) <= row.keys() and row["cache_misses"] == 1
    assert tr.spans[-1].args == {"i": 2, "locality_flops": 0.5}
    with tobs.IterationScope(None, None, tobs.NULL_TRACER) as st:
        st.annotate(x=1)  # no span: a no-op
        assert st.delta()["cache_hits"] == 0


def test_sync_waits_for_cuda_tensors_only(monkeypatch):
    """``Tracer.sync`` synchronises each CUDA device among its arguments and
    nothing for CPU tensors (the card-side half is a gpu-marked test)."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: calls.append(dev))
    x = torch.zeros(2)
    tr = tobs.Tracer()
    assert tr.sync(x) is x
    tr.sync((x, [x], {"k": x}, 3))
    assert calls == []
    assert tobs.Tracer(sync=False).sync(x) is x


def test_profiler_scopes_label_a_torch_profile():
    from torch.profiler import ProfilerActivity, profile

    tr = tobs.Tracer(sync=False, profiler_scopes=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("labelled_span"):
            torch.ones(4).sum()
    assert "labelled_span" in {e.key for e in prof.key_averages()}


# --- memory accounting ---------------------------------------------------------


def _plans(nparts=4, exchange="p2p", seed=3, skew=False):
    m = random_block_matrix(256, BS, 0.25, seed=seed)
    owner = np.zeros(m.coords.shape[0], np.int32) if skew else None
    kw = dict(exchange=exchange, a_owner=owner, b_owner=owner)
    return (make_spgemm_plan(m.coords, m.coords, nparts, BS, **kw),
            j_make_plan(m.coords, m.coords, nparts, BS, **kw), m)


@pytest.mark.parametrize("exchange", ["p2p", "allgather"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_plan_memory_bytes_and_meter_match_jax(exchange, precision):
    port, ref, _ = _plans(exchange=exchange)
    tp = BF16 if precision == "bf16" else None
    from repro.kernels.precision import BF16 as JBF16

    jp = JBF16 if precision == "bf16" else None
    got, want = tobs.plan_memory_bytes(port, tp), jobs.plan_memory_bytes(ref, jp)
    assert got.keys() == want.keys()
    for k in got:
        assert np.array_equal(got[k], want[k]), k
    mm, jm = tobs.MemoryMeter(), jobs.MemoryMeter()
    for meter, plan, p in ((mm, port, tp), (jm, ref, jp)):
        meter.note_plan(plan, p)
        meter.note_bytes("norm_table", np.full(plan.nparts, 64.0))
        meter.note_plan(plan, p, kind="spamm")
    s, js = mm.summary(), jm.summary()
    assert s.pop("cuda") is None  # no card here
    js.pop("jax")
    assert s == js
    tr = tobs.Tracer(sync=False)
    mm.flush(tr)
    assert tr.metrics_flat()[f"mem_peak_w0_bytes"] == s["worker_peak_bytes"][0]
    assert tobs.meter_of(types.SimpleNamespace(memory_meter=mm)) is mm
    assert tobs.cuda_memory_stats() is None


# --- locality ledger and task-graph analytics ----------------------------------


@pytest.mark.parametrize("nparts,exchange,skew", [(1, "p2p", False), (3, "p2p", False),
                                                  (4, "p2p", True), (4, "allgather", False)])
def test_ledger_and_provenance_match_jax(nparts, exchange, skew):
    port, ref, m = _plans(nparts, exchange, skew=skew)
    prov, jprov = tobs.plan_provenance(port), jobs.plan_provenance(ref)
    assert tobs.plan_provenance(port) is prov  # memoized on the plan
    assert np.array_equal(prov["local"] + prov["shipped"], prov["referenced"])
    rng = np.random.default_rng(0)
    keep_task = rng.random(port.tasks.num_tasks) < 0.2
    codes = np.arange(m.coords.shape[0]) * 7
    lld, jl = tobs.LocalityLedger(top_k=5), jobs.LocalityLedger(top_k=5)
    for ledger, plan, masks in ((lld, port, _exchange_keep_masks), (jl, ref, j_keep_masks)):
        snap = ledger.snapshot()
        outs = [ledger.note_dispatch(plan, a_codes=codes, b_codes=codes),
                ledger.note_dispatch(plan, wire_itemsize=2)]
        t_cap = plan.task_gidx.shape[1]
        task_on = np.arange(t_cap)[None, :] < (plan.task_count[:, None] // 2)
        outs.append(ledger.note_dispatch(plan, task_on=task_on))
        if exchange == "p2p" and (plan.a_offsets or plan.b_offsets):
            a_keeps, b_keeps, *_ = masks(plan, keep_task)
            outs.append(ledger.note_dispatch(plan, keeps=(a_keeps, b_keeps), a_codes=codes,
                                             b_codes=codes))
        ledger.outs, ledger.fields = outs, ledger.delta(snap)
    assert lld.outs == jl.outs and lld.fields == jl.fields
    assert sorted(lld.fields) == sorted(tobs.LOCALITY_ITER_KEYS)
    assert lld.summary() == jl.summary()
    for k in prov:
        if isinstance(prov[k], np.ndarray):
            assert np.array_equal(prov[k], jprov[k]), k
    assert tobs.locality_table(dict(meta=dict(n=256), locality=dict(
        run=dict(static=lld.summary())))) == jobs.locality_table(dict(
            meta=dict(n=256), locality=dict(run=dict(static=jl.summary()))))


def test_ledger_install_refuses_an_unverified_cache():
    with pytest.raises(ValueError, match="verified plans"):
        tobs.LocalityLedger().install(PlanCache(verify="off"))
    cache = PlanCache()
    lld = tobs.LocalityLedger().install(cache)
    assert tobs.ledger_of(cache) is lld and tobs.ledger_of(None) is None
    plain = types.SimpleNamespace()
    assert tobs.locality_snapshot(plain) is None
    assert tobs.locality_iteration(plain, None, None, iteration=0, driver="x") == {}


@pytest.mark.parametrize("skew", [False, True])
def test_task_graph_analysis_matches_jax(skew):
    port, ref, m = _plans(4, skew=skew)
    an, jan = tobs.analyze_plan(port), jobs.analyze_plan(ref)
    assert an.as_dict() == jan.as_dict()
    assert (an.slack >= -1e-9).all() and an.critical_path >= an.busy.max() - 1e-9
    half = port.task_count // 2
    assert (tobs.analyze_plan(port, task_count=half).as_dict()
            == jobs.analyze_plan(ref, task_count=half).as_dict())
    with pytest.raises(ValueError, match="task_count shape"):
        tobs.analyze_plan(port, task_count=np.zeros(port.nparts + 1))
    w, jw = tobs.whatif_rebalanced(port, m.coords), jobs.whatif_rebalanced(ref, m.coords)
    assert w["predicted_gain"] == jw["predicted_gain"]
    assert np.array_equal(w["a_owner"], jw["a_owner"])
    assert w["after"].as_dict() == jw["after"].as_dict()
    if skew:
        assert w["predicted_gain"] > 1.0
    assert tobs.project_seconds(an, 2.0) == jobs.project_seconds(jan, 2.0)


# --- the drivers with the observatory on (port only, 8 CPU workers) -----------


def _driver_inputs():
    rng = np.random.default_rng(0)
    n, bs = 64, 8
    b = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        lo, hi = max(0, i - 5), min(n, i + 6)
        b[i, lo:hi] = rng.standard_normal(hi - lo)
    s = BSMatrix.from_dense(b @ b.T / n + np.eye(n, dtype=np.float32), bs, device="cpu")
    hm = 0.2 * rng.standard_normal((n, n)).astype(np.float32)
    f = BSMatrix.from_dense((hm + hm.T) / 2 + np.diag(np.linspace(-1, 1, n)).astype(np.float32),
                            bs, device="cpu")
    w = np.linalg.eigvalsh(np.asarray(f.to_dense(), np.float64))
    return s, f, float(w.min()) - 0.05, float(w.max()) + 0.05


@pytest.fixture(scope="module")
def traced_runs(tmp_path_factory):
    s, f, lmin, lmax = _driver_inputs()
    mesh = make_worker_mesh(8, "cpu")
    kw = dict(idem_tol=1e-5, trunc_tau=1e-6, spamm_tau=1e-7, max_iter=40)
    df = scatter(f, mesh)
    d0, st0 = dist_sp2_purify(df, 20, lmin, lmax, cache=PlanCache(), **kw)
    tr = tobs.Tracer()
    cache1 = PlanCache()
    lld = tobs.LocalityLedger().install(cache1)
    d1, st1 = dist_sp2_purify(df, 20, lmin, lmax, cache=cache1, tracer=tr, **kw)
    skew = scatter(f, mesh, owner=np.zeros(f.nnzb, np.int32))
    d2, st2 = dist_sp2_purify(skew, 20, lmin, lmax, cache=PlanCache(),
                              rebalance=RebalancePolicy(), **kw)
    tr2 = tobs.Tracer()
    cache = PlanCache(tracer=tr2)
    ds = scatter(s, mesh)
    ikw = dict(tol=1e-7, max_iter=40, trunc_tau=1e-6, spamm_tau=1e-7)
    z1, i1 = dist_localized_inverse_factorization(ds, cache, **ikw)
    h1, m1 = cache.hits, cache.misses
    z2, i2 = dist_localized_inverse_factorization(ds, cache, **ikw)
    path = str(tmp_path_factory.mktemp("trace") / "trace.json")
    summary = tobs.write_chrome_trace(tr2, path)
    return dict(d=(d0, d1, d2), st=(st0, st1, st2, i1, i2), tr=(tr, tr2), cache=cache,
                replay=(cache.hits - h1, cache.misses - m1), lld=lld, path=path,
                summary=summary)


def test_observatory_on_is_bit_identical_and_rows_share_one_schema(traced_runs):
    d0, d1, d2 = traced_runs["d"]
    st0, st1, st2, i1, i2 = traced_runs["st"]
    assert torch.equal(d0.data, d1.data) and torch.equal(d0.data, d2.data)
    extra = set(tobs.LOCALITY_ITER_KEYS)
    assert not (extra & set(st0.per_iter[0])) and extra <= set(st1.per_iter[0])
    assert sorted(set(st1.per_iter[0]) - extra) == sorted(st0.per_iter[0])
    for st in (st0, st1, st2, i1, i2):
        assert all(set(tobs.SHARED_ITER_KEYS) <= set(r) for r in st.per_iter)
    assert st2.calibration is not None and st0.calibration is None
    tr, _ = traced_runs["tr"]
    names = {sp.name for sp in tr.spans}
    assert {"sp2_purify", "sp2_iteration", "dist_spamm", "plan_build", "plan_verify",
            "dispatch"} <= names
    dispatch = [sp for sp in tr.spans if sp.name == "dispatch" and "tasks" in sp.args]
    assert dispatch and all(sp.args["engine"] == "tilerows" for sp in dispatch)  # bs 8
    s = traced_runs["lld"].summary()
    assert s["dispatches"] > 0
    assert s["local_bytes"] + s["shipped_bytes"] == s["referenced_bytes"]
    assert all(0.0 <= r["locality_flops"] <= 1.0 for r in st1.per_iter)


def test_zero_miss_replay_conserves_counters_and_exports_worker_tracks(traced_runs):
    cache, (_, tr2) = traced_runs["cache"], traced_runs["tr"]
    assert traced_runs["replay"][1] == 0
    assert tr2.counter("plan_hits").value == cache.hits
    assert tr2.counter("plan_misses").value == cache.misses
    assert tr2.counter("plans_verified").value == cache.plans_verified > 0
    assert tobs.run_metrics(cache)["plan_hits"] == cache.hits
    s = traced_runs["summary"]
    assert s["workers"] == 8 and s["events"] > s["host_spans"] > 0
    assert tobs.validate_chrome_trace(traced_runs["path"]) == s
    util = tobs.worker_utilization(tr2)
    assert util["nparts"] == 8 and all(0.0 <= f <= 1.0 + 1e-9 for f in util["busy_frac"])
    futil = tobs.utilization_from_file(traced_runs["path"])
    assert abs(futil["timeline_imbalance"] - util["timeline_imbalance"]) < 1e-6
    with open(traced_runs["path"]) as fh:
        assert json.load(fh)["displayTimeUnit"] == "ms"


def test_report_cli_prints_the_worker_table(traced_runs, capsys):
    from repro_torch.obs import report

    assert report.main([traced_runs["path"]]) == 0
    out = capsys.readouterr().out
    assert "8 workers" in out and "busy %" in out
    assert os.path.exists(traced_runs["path"])


# --- the observers' per-plan caches against a cold computation ----------------


def _kept_fetches_loop(plan, name, keep):
    """The ledger's kept-fetch lineage as a loop over rounds and senders (the
    JAX package's form): the reference for the vectorized port."""
    offs = plan.a_offsets if name == "a" else plan.b_offsets
    send = plan.a_send if name == "a" else plan.b_send
    send_cnt = plan.a_send_count if name == "a" else plan.b_send_count
    store_idx = plan.a_store_idx if name == "a" else plan.b_store_idx
    gids, src_l, dst_l = [], [], []
    for r, d in enumerate(offs):
        k = np.asarray(keep[r], dtype=bool)
        for src in range(plan.nparts):
            c = int(send_cnt[d][src])
            slots = send[d][src, :c][k[src, :c]]
            gids.append(store_idx[src, slots].astype(np.int64))
            src_l.append(np.full(slots.size, src, dtype=np.int32))
            dst_l.append(np.full(slots.size, (src + d) % plan.nparts, dtype=np.int32))
    cat = lambda xs, dt: np.concatenate(xs) if xs else np.zeros(0, dt)  # noqa: E731
    return cat(gids, np.int64), cat(src_l, np.int32), cat(dst_l, np.int32)


@pytest.mark.parametrize("skew", [False, True])
def test_kept_fetches_equal_the_loop(skew):
    from repro_torch.obs.locality import _kept_fetches

    port, _, _ = _plans(4, "p2p", skew=skew)
    keep_task = np.random.default_rng(1).random(port.tasks.num_tasks) < 0.3
    a_keeps, b_keeps, *_ = _exchange_keep_masks(port, keep_task)
    for name, keep in (("a", a_keeps), ("b", b_keeps)):
        got, want = _kept_fetches(port, name, keep), _kept_fetches_loop(port, name, keep)
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_observer_caches_equal_a_cold_computation(monkeypatch):
    """Two dispatches of one plan and one of a second, a SpAMM delta dispatch
    among them, with the tracer, the memory meter and the locality ledger on:
    their counters, ledger totals (moved blocks included) and memory account
    equal those of the same run with every per-plan and per-matrix cache
    (the dispatch annotations', the ledger's, the Morton codes) recomputed
    on each use."""
    from repro_torch.core.quadtree import morton_encode
    from repro_torch.dist import dist_multiply, dist_spamm
    from repro_torch.dist import multiply as tmul
    from repro_torch.dist.matrix import DistBSMatrix
    from repro_torch.obs import locality as tloc

    mesh = make_worker_mesh(4, "cpu")
    m1 = random_block_matrix(256, BS, 0.25, seed=3)
    m2 = random_block_matrix(256, BS, 0.4, seed=4)
    mats = [scatter(BSMatrix.from_dense(np.asarray(m.to_dense()), BS, device="cpu"), mesh)
            for m in (m1, m2)]

    def run():
        tr = tobs.Tracer(sync=False)
        cache = PlanCache(tracer=tr)
        mm, lld = tobs.MemoryMeter().install(cache), tobs.LocalityLedger().install(cache)
        for x in (mats[0], mats[0], mats[1]):
            dist_multiply(x, x, cache)
        dist_spamm(mats[0], mats[0], 1e-1, cache)
        counters = {k: v for k, v in tr.metrics_flat().items()}
        return counters, lld.summary(), mm.summary()

    warm = run()
    plain_static, plain_prov = tmul._plan_obs_static, tloc.plan_provenance

    def cold_static(plan):
        plan.__dict__.pop("_obs_static", None)
        return plain_static(plan)

    def cold_prov(plan):
        plan.__dict__.pop(tloc._PROV_ATTR, None)
        return plain_prov(plan)

    monkeypatch.setattr(tmul, "_plan_obs_static", cold_static)
    monkeypatch.setattr(tloc, "plan_provenance", cold_prov)
    monkeypatch.setattr(tloc, "_plan_dispatch_static", lambda plan, prov, w: dict(
        zip(("per_worker", "out"), tloc._dispatch_account(plan, prov, w, None, None))))
    monkeypatch.setattr(DistBSMatrix, "codes",
                        lambda self: morton_encode(self.coords[:, 0], self.coords[:, 1]))
    cold = run()
    assert warm[0] == cold[0]
    assert warm[1] == cold[1] and warm[1]["dispatches"] == 4 and warm[1]["moved_blocks"]
    assert warm[2] == cold[2]
