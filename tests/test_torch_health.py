"""The port's health observatory against the JAX package's: event log,
flight recorder, health monitor, and the resident drivers with every
observer on.

The event log, the flight recorder and the detectors are host-side: the
same events, counters and synthetic iteration rows go through both
packages under a deterministic clock and are held equal.  The drivers run
the JAX side once per module in a subprocess with 8 host devices; the port
runs the same numpy inputs here on ``make_worker_mesh(8, "cpu")``, from a
skewed layout with ``rebalance=``, the tracer, the event log, the memory
meter, the locality ledger and a health policy tight enough to fire.  With
exact multiplies every one of those observes structure only, so the
alerts (kind, iteration), the event counts, the memory peaks, the ledger's
totals and the tracer's byte and task counters are held equal to the JAX
package's; D to 1e-5 (elements of order 1); and D with everything on is
bit-identical to D with everything off.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro.obs as jobs  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro.dist.balance import RebalancePolicy as JPolicy  # noqa: E402
from repro.dist.balance import WorkerLoad as JLoad  # noqa: E402
from repro_torch.analysis import CORRUPTIONS, PlanError  # noqa: E402
from repro_torch.core import BSMatrix  # noqa: E402
from repro_torch.core.cache import SymbolicCache  # noqa: E402
from repro_torch.core.distributed import make_worker_mesh  # noqa: E402
from repro_torch.core.schedule import make_spgemm_plan  # noqa: E402
from repro_torch.dist import (  # noqa: E402
    PlanCache,
    RebalancePolicy,
    dist_localized_inverse_factorization,
    dist_sp2_purify,
    scatter,
)
from repro_torch.dist import inverse as inv_mod  # noqa: E402
from repro_torch.dist import purify as pur  # noqa: E402
from repro_torch.dist.balance import WorkerLoad  # noqa: E402
from helpers import random_block_matrix  # noqa: E402

P = 8
NOCC = 40
KW = dict(idem_tol=1e-4, trunc_tau=1e-5, max_iter=40)
# tight enough that each detector fires on this small run
HEALTH = dict(straggler_factor=1.2, straggler_patience=2, miss_warmup=1, miss_storm_window=2,
              exchange_blowup=1.5, stall_window=3, live_policy=False)
COUNTERS = ("tasks_executed", "recv_bytes", "send_bytes", "plan_hits", "plan_misses",
            "plans_verified", "migrated_bytes", "norm_fetch_bytes", "local_bytes",
            "shipped_bytes", "wire_recv_bytes", "local_flops")


class Tick:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


# --- event log and flight recorder --------------------------------------------


def _log_program(obs, path):
    lg = obs.EventLog(path, level="debug", capacity=4, clock=Tick())
    lg.debug("plan_build", kind="spgemm", build_s=0.25)
    lg.info("run_start", driver="sp2", n=64, arr=np.arange(3))
    lg.warn("health_alert", kind="straggler", worker=2)
    lg.error("plan_error", kind="spgemm")
    lg.info("tick", i=1)
    lg.close()
    quiet = obs.EventLog(level="warn", clock=Tick())
    return lg, [quiet.info("x"), quiet.warn("first"), quiet.error("second")]


def test_event_log_matches_jax(tmp_path):
    lg, quiet = _log_program(tobs, str(tmp_path / "t.jsonl"))
    jlg, jquiet = _log_program(jobs, str(tmp_path / "j.jsonl"))
    assert list(lg.recent) == list(jlg.recent) and quiet == jquiet
    assert tobs.load_events(str(tmp_path / "t.jsonl")) == jobs.load_events(str(tmp_path / "j.jsonl"))
    assert tobs.EVENT_KEYS == jobs.EVENT_KEYS == ("ts", "seq", "level", "event")
    assert all(tuple(r)[:4] == tobs.EVENT_KEYS for r in lg.recent)
    assert [r["event"] for r in lg.recent] == ["run_start", "health_alert", "plan_error", "tick"]
    assert lg.events_of("health_alert", level="warn") and lg.events_of("tick", "warn") == []
    null = tobs.NULL_LOG
    assert not null and null.info("x", a=1) is None and null.events_of("x") == []
    cache = SymbolicCache()
    assert tobs.log_of(cache) is null
    cache.event_log = lg
    assert tobs.log_of(cache) is lg
    with pytest.raises(ValueError):
        tobs.EventLog(level="loud")


def _recorder_program(obs, cache_cls, path):
    tr = obs.Tracer(clock=Tick(), sync=False)
    cache = cache_cls(tracer=tr, event_log=obs.EventLog(clock=Tick()))
    rec = obs.FlightRecorder(path, clock=Tick()).install(cache)
    tr.counter("tasks_executed").add(10.0)
    rec.mark(cache)
    with tr.span("step", cat="phase"):
        tr.counter("tasks_executed").add(3.0)
    cache.event_log.info("iteration", i=0)
    return rec.snapshot("unit_test", cache, extra="detail")


def test_postmortem_matches_jax_golden_keys_and_deltas(tmp_path):
    from repro.core.cache import SymbolicCache as JCache

    pm = _recorder_program(tobs, SymbolicCache, str(tmp_path / "t.json"))
    jpm = _recorder_program(jobs, JCache, str(tmp_path / "j.json"))
    for k in ("cache",):  # the port's cache stats name the same keys
        assert sorted(pm[k]) == sorted(jpm[k])
        pm.pop(k), jpm.pop(k)
    assert pm == jpm
    assert tuple(pm) == tuple(k for k in tobs.POSTMORTEM_KEYS if k != "cache")
    assert tobs.POSTMORTEM_KEYS == jobs.POSTMORTEM_KEYS
    assert pm["counter_deltas"]["tasks_executed"] == 3.0


def test_plan_error_dumps_a_postmortem(tmp_path):
    m = random_block_matrix(256, 16, 0.25, seed=3)
    bad, _ = CORRUPTIONS["send_conflict"][0](make_spgemm_plan(m.coords, m.coords, 4, 16))
    tr = tobs.Tracer(sync=False)
    lg = tobs.EventLog(level="debug")
    cache = PlanCache(tracer=tr, event_log=lg)
    path = str(tmp_path / "postmortem.json")
    rec = tobs.FlightRecorder(path).install(cache)
    with pytest.raises(PlanError):
        cache.get_or_build(("spgemm", "k1"), lambda: (bad, None))
    assert rec.dumps == 1
    with open(path) as fh:
        pm = json.load(fh)
    assert tuple(pm) == tobs.POSTMORTEM_KEYS and pm["reason"] == "plan_error"
    assert pm["detail"]["violations"][0]["check"] == "send-conflict"
    assert pm["cache"]["entries"] == 0
    assert lg.events_of("plan_error", level="error") and tr.instants_of("postmortem", "health")


# --- the detectors on synthetic rows ------------------------------------------


def _rows():
    """Rows and per-worker task loads that trip every detector once or more."""
    out = []
    for it in range(14):
        row = dict(iteration=it, cache_misses=2 if 3 <= it < 7 else 0,
                   recv_bytes_mean=8000.0 if it == 9 else 1000.0 + it,
                   residual=1.0 / (it + 1) if it < 6 else 0.1)
        tasks = [100.0, 100.0, 100.0, 400.0 if 2 <= it < 8 else 100.0]
        out.append((row, tasks))
    return out


def _alerts(obs, load_cls, policy):
    hm = obs.HealthMonitor(obs.HealthPolicy(**policy))
    for row, tasks in _rows():
        t = np.asarray(tasks)
        z = np.zeros_like(t)
        hm.observe(dict(row), load_cls(nparts=4, bs=16, tasks=t, recv_bytes=z, send_bytes=z,
                                       blocks=z))
    return hm.summary()


@pytest.mark.parametrize("policy", [{}, dict(straggler_patience=1, miss_warmup=0,
                                             miss_storm_window=2, exchange_blowup=2.0,
                                             stall_window=2)])
def test_detectors_fire_at_the_same_iterations_as_jax(policy):
    got, want = _alerts(tobs, WorkerLoad, policy), _alerts(jobs, JLoad, policy)
    assert got == want
    assert {"straggler", "miss_storm", "exchange_blowup", "convergence_stall"} <= \
        set(got["alerts_by_kind"])


def test_alerts_land_in_log_and_trace_and_refits_apply():
    tr = tobs.Tracer(sync=False)
    cache = SymbolicCache(tracer=tr, event_log=tobs.EventLog())
    hm = tobs.HealthMonitor(tobs.HealthPolicy(stall_window=2), cache=cache)
    for it in range(5):
        hm.observe(dict(iteration=it, residual=1.0))
    assert cache.event_log.events_of("health_alert", level="warn")
    assert tr.instants_of("health_alert", "health")
    assert hm.summary()["alerts_by_kind"] == {"convergence_stall": 1}
    fitted = RebalancePolicy(recv_cost=0.9, send_cost=0.1, block_cost=0.4)

    class FakeLB:
        policy = RebalancePolicy()

        def calibration(self):
            return fitted, dict(fitted=True, rms_resid_s=0.01)

    lb = FakeLB()
    hm = tobs.HealthMonitor(tobs.HealthPolicy(refit_every=4), cache=cache)
    for it in range(4):
        hm.observe(dict(iteration=it))
        out = hm.maybe_refit(lb)
    assert out == fitted and lb.policy == fitted and hm.refits == 1
    assert cache.event_log.events_of("policy_refit")
    off = tobs.HealthMonitor(tobs.HealthPolicy(refit_every=1, live_policy=False))
    off.observe(dict(iteration=0))
    assert off.maybe_refit(FakeLB()) is None
    assert JPolicy() == JPolicy()  # the reference's policy type is a plain dataclass too


# --- the drivers with every observer on, against the JAX package --------------


def _inputs():
    r = np.random.default_rng(3)
    h = np.zeros((128, 128), dtype=np.float32)
    for i in range(128):
        lo, hi = max(0, i - 3), min(128, i + 4)
        h[i, lo:hi] = 0.2 * r.standard_normal(hi - lo)
    h = ((h + h.T) / 2 + np.diag(np.linspace(-1, 1, 128))).astype(np.float32)
    d = np.zeros((64, 64), dtype=np.float32)
    rng = np.random.default_rng(3)
    for i in range(64):
        lo, hi = max(0, i - 4), min(64, i + 5)
        d[i, lo:hi] = rng.standard_normal(hi - lo)
    s = (d @ d.T + 64 * np.eye(64, dtype=np.float32)).astype(np.float32)
    return dict(h=h, s=s)


def _skew(nnzb):
    return np.concatenate([np.zeros(nnzb // 2, np.int32),
                           (np.arange(nnzb - nnzb // 2) % (P - 1) + 1).astype(np.int32)])


_JAX_SCRIPT = r"""
import json, os, sys, tempfile
import numpy as np, jax
from repro.core import BSMatrix
from repro.core.distributed import make_worker_mesh
from repro.dist import (PlanCache, RebalancePolicy, dist_sp2_purify,
                        dist_localized_inverse_factorization, scatter)
import repro.dist.inverse as inv
from repro.obs import (EventLog, FlightRecorder, HealthPolicy, LocalityLedger, MemoryMeter,
                       POSTMORTEM_KEYS, Tracer)

assert jax.device_count() == 8, jax.device_count()
inp = dict(np.load(sys.argv[1]))
meta = json.loads(sys.argv[3])
mesh = make_worker_mesh(8)
tmp = tempfile.mkdtemp()
out, arrays = {}, {}

F = BSMatrix.from_dense(inp["h"], 16)
w = np.linalg.eigvalsh(inp["h"].astype(np.float64))
lmin, lmax = float(w.min()) - 0.05, float(w.max()) + 0.05
tr = Tracer(sync=False)
cache = PlanCache(verify="always", tracer=tr, event_log=EventLog(level="debug"))
mm = MemoryMeter().install(cache)
lld = LocalityLedger().install(cache)
d, st = dist_sp2_purify(scatter(F, mesh, owner=inp["skew"]), meta["nocc"], lmin, lmax,
                        cache=cache, rebalance=RebalancePolicy(),
                        health=HealthPolicy(**meta["health"]), **meta["kw"])
arrays["d"] = np.asarray(d.to_dense())
out["health"] = st.health
out["rows"] = [[r["cache_hits"], r["cache_misses"], r["nnzb"], r["locality_flops"],
                r["locality_bytes"], r["migrated_bytes"]] for r in st.per_iter]
events = [r["event"] for r in cache.event_log.recent]
out["events"] = {e: events.count(e) for e in sorted(set(events))}
out["memory"] = {k: v["peak_bytes"] for k, v in mm.summary()["per_kind"].items()}
out["ledger"] = {k: v for k, v in lld.summary().items() if k != "nparts"}
out["counters"] = {k: tr.counter(k).value for k in meta["counters"]}
out["verified"] = [cache.plans_verified, cache.verify_violations]

class DivergeNow(inv.RefineMonitor):
    def update(self, it, r):
        super().update(it, r)
        if it >= 1:
            self.stop_reason = "diverged"
            return True
        return False
inv.RefineMonitor = DivergeNow
cache3 = PlanCache(tracer=Tracer(sync=False), event_log=EventLog(level="debug"))
pm_path = os.path.join(tmp, "pm.json")
rec = FlightRecorder(pm_path, last_spans=32).install(cache3)
dist_localized_inverse_factorization(scatter(BSMatrix.from_dense(inp["s"], 8), mesh), cache3,
                                     tol=1e-9, max_iter=10, trunc_tau=1e-6)
with open(pm_path) as fh:
    pm = json.load(fh)
out["postmortem"] = dict(dumps=rec.dumps, keys=list(pm), reason=pm["reason"],
                         iteration=pm["detail"].get("iteration"))
np.savez(sys.argv[2], **arrays)
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("health")
    inp = _inputs()
    inp["skew"] = _skew(BSMatrix.from_dense(inp["h"], 16, device="cpu").nnzb)
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    meta = json.dumps(dict(nocc=NOCC, kw=KW, health=HEALTH, counters=COUNTERS))
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(tmp / "in.npz"),
                           str(tmp / "out.npz"), meta], env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):]), dict(np.load(tmp / "out.npz"))


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    inp = _inputs()
    mesh = make_worker_mesh(P, "cpu")
    f = BSMatrix.from_dense(inp["h"], 16, device="cpu")
    w = np.linalg.eigvalsh(inp["h"].astype(np.float64))
    lmin, lmax = float(w.min()) - 0.05, float(w.max()) + 0.05
    df = scatter(f, mesh, owner=_skew(f.nnzb))
    d_off, _ = dist_sp2_purify(df, NOCC, lmin, lmax, cache=PlanCache(), **KW)
    tmp = tmp_path_factory.mktemp("port_health")
    tr = tobs.Tracer()
    cache = PlanCache(verify="always")
    mm = tobs.MemoryMeter().install(cache)
    lld = tobs.LocalityLedger().install(cache)
    rec = tobs.FlightRecorder(str(tmp / "pm.json")).install(cache)
    lg = tobs.EventLog(str(tmp / "events.jsonl"), level="debug")
    d, st = dist_sp2_purify(df, NOCC, lmin, lmax, cache=cache, rebalance=RebalancePolicy(),
                            tracer=tr, log=lg, health=tobs.HealthPolicy(**HEALTH), **KW)
    lg.close()
    return dict(d=d, d_off=d_off, st=st, cache=cache, mm=mm, lld=lld, rec=rec, tr=tr, lg=lg,
                tmp=tmp, rebalanced=dist_sp2_purify(df, NOCC, lmin, lmax, cache=PlanCache(),
                                                    rebalance=RebalancePolicy(), **KW)[0])


def test_observatory_on_is_bit_identical_and_close_to_jax(jax_run, port_run):
    _, arrays = jax_run
    d, d_off = port_run["d"], port_run["d_off"]
    assert np.array_equal(d.coords, d_off.coords) and torch.equal(d.data, d_off.data)
    assert torch.equal(port_run["rebalanced"].data, d.data)
    np.testing.assert_allclose(d.to_dense(), arrays["d"], rtol=0, atol=1e-5)
    assert port_run["rec"].dumps == 0  # no divergence, no postmortem
    assert not os.path.exists(port_run["tmp"] / "pm.json")


def test_health_alerts_match_jax(jax_run, port_run):
    out, _ = jax_run
    got, want = port_run["st"].health, out["health"]
    assert [(a["kind"], a["iteration"]) for a in got["alerts"]] == \
        [(a["kind"], a["iteration"]) for a in want["alerts"]]
    assert got["alerts_by_kind"] == want["alerts_by_kind"] and got["refits"] == 0
    assert {"exchange_blowup", "straggler"} & set(got["alerts_by_kind"])
    for a, b in zip(got["alerts"], want["alerts"]):
        if a["kind"] != "convergence_stall":  # its residuals round differently
            assert a == b


def test_rows_events_memory_ledger_and_counters_match_jax(jax_run, port_run):
    out, _ = jax_run
    st, cache, tr = port_run["st"], port_run["cache"], port_run["tr"]
    rows = [[r["cache_hits"], r["cache_misses"], r["nnzb"], r["locality_flops"],
             r["locality_bytes"], r["migrated_bytes"]] for r in st.per_iter]
    assert rows == out["rows"]
    events = [r["event"] for r in tobs.load_events(str(port_run["tmp"] / "events.jsonl"))]
    assert {e: events.count(e) for e in sorted(set(events))} == out["events"]
    assert {"run_start", "run_end", "iteration", "plan_build", "rebalance"} <= set(events)
    memory = {k: v["peak_bytes"] for k, v in port_run["mm"].summary()["per_kind"].items()}
    assert memory == out["memory"]
    ledger = {k: v for k, v in port_run["lld"].summary().items() if k != "nparts"}
    assert ledger == out["ledger"]
    for per_worker in ledger["per_worker"]:
        assert per_worker["local_bytes"] + per_worker["shipped_bytes"] == \
            per_worker["referenced_bytes"]
    assert {k: tr.counter(k).value for k in COUNTERS} == out["counters"]
    assert [cache.plans_verified, cache.verify_violations] == out["verified"]
    assert out["verified"][1] == 0


def test_refine_divergence_dumps_the_postmortem_jax_does(jax_run, tmp_path, monkeypatch):
    out, _ = jax_run

    class DivergeNow(inv_mod.RefineMonitor):
        def update(self, it, r):
            super().update(it, r)
            if it >= 1:
                self.stop_reason = "diverged"
                return True
            return False

    monkeypatch.setattr(inv_mod, "RefineMonitor", DivergeNow)
    lg = tobs.EventLog(level="debug")
    cache = PlanCache(tracer=tobs.Tracer(sync=False), event_log=lg)
    path = str(tmp_path / "pm.json")
    rec = tobs.FlightRecorder(path, last_spans=32).install(cache)
    mesh = make_worker_mesh(P, "cpu")
    dist_localized_inverse_factorization(
        scatter(BSMatrix.from_dense(_inputs()["s"], 8, device="cpu"), mesh), cache,
        tol=1e-9, max_iter=10, trunc_tau=1e-6)
    with open(path) as fh:
        pm = json.load(fh)
    got = dict(dumps=rec.dumps, keys=list(pm), reason=pm["reason"],
               iteration=pm["detail"].get("iteration"))
    assert got == out["postmortem"]
    assert got["keys"] == list(tobs.POSTMORTEM_KEYS) and got["reason"] == "refine_divergence"
    assert pm["spans"] and (pm["cache"]["hits"] or pm["cache"]["misses"])
    assert lg.events_of("refine_divergence", level="warn")


def test_lanczos_divergence_falls_back_and_logs():
    mesh = make_worker_mesh(P, "cpu")
    ds = scatter(BSMatrix.from_dense(_inputs()["s"], 8, device="cpu"), mesh)
    lg = tobs.EventLog(level="debug")
    cache = PlanCache(event_log=lg)
    lo_ref, hi_ref = pur._spectral_bounds_from_norms(ds.coords,
                                                     pur.resident_block_norms(ds, cache))
    real = pur._lanczos_ritz

    def broken(f, cache, steps, seed):
        raise pur.LanczosDivergence("injected non-finite beta")

    pur._lanczos_ritz = broken
    try:
        lo, hi = pur.dist_lanczos_bounds(ds, cache, steps=8)
    finally:
        pur._lanczos_ritz = real
    assert (lo, hi) == (lo_ref, hi_ref)
    fb = lg.events_of("lanczos_fallback", level="warn")
    assert fb and "injected" in fb[0]["reason"]
