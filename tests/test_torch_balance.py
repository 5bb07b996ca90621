"""The port's load balancer against the JAX package's.

The cost model, the policy and the partitioner are host numpy, so their
results must equal the reference's array for array: those run in this
process against ``repro.dist.balance`` and ``repro.core.schedule``.  The
resident behaviour — ``dist_repartition``, ``rebalance=`` on the multiplies
and in the SP2 and inverse drivers — runs on ``make_worker_mesh(8,
device="cpu")``, and the JAX side of it once per module in a subprocess
with 8 host devices.

Held to: owner maps, plans, worker loads, imbalances, migrated bytes and
per-iteration plan-cache hits and misses equal to the reference's; inside
the port, a rebalanced run bit-identical to its static run and a
repartition round trip bit-identical to the store it started from.  The
JAX package's own rebalanced inverse misses the plan cache in its last
iterations (tests/test_balance.py::test_inverse_rebalanced_pinned_operand);
the port's misses are compared with the reference's, iteration by
iteration, and no imbalance or residual of the reference is copied as an
expected value.
"""

import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.core import schedule as jsched  # noqa: E402
from repro.dist import balance as jbal  # noqa: E402
from repro_torch.core import BSMatrix  # noqa: E402
from repro_torch.core.distributed import make_worker_mesh  # noqa: E402
from repro_torch.core.schedule import (  # noqa: E402
    make_spgemm_plan,
    partition_morton,
    subtree_boundaries,
)
from repro_torch.dist import (  # noqa: E402
    LoadMonitor,
    PlanCache,
    RebalancePolicy,
    WorkerLoad,
    dist_localized_inverse_factorization,
    dist_multiply,
    dist_repartition,
    dist_sp2_purify,
    dist_spamm,
    owner_imbalance,
    rebalanced_owner,
    resident_block_norms,
    scatter,
    worker_load,
)
from repro_torch.dist import balance as tbal  # noqa: E402
from repro_torch.dist.collectives import RepartitionExecutable  # noqa: E402

P, N, BS, N_OCC = 8, 128, 16, 40
SEEDS = range(6)


def _random_offdiag(n, density, bs, seed):
    """Strong diagonal blocks + sparse off-diagonal blocks of widely varying
    size (the random-offdiag sequence of benchmarks/spamm_sequences.py)."""
    rng = np.random.default_rng(seed)
    nb = n // bs
    a = np.zeros((n, n), dtype=np.float32)
    for b in range(nb):
        a[b * bs:(b + 1) * bs, b * bs:(b + 1) * bs] = rng.standard_normal((bs, bs))
    mask = rng.random((nb, nb)) < density
    np.fill_diagonal(mask, False)
    for i, j in zip(*np.nonzero(mask)):
        a[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = 10.0 ** rng.uniform(-4, 0) * rng.standard_normal((bs, bs))
    return a


def _inputs() -> dict:
    h = _random_offdiag(N, 0.15, BS, 2)
    h = 0.2 * (h + h.T) / 2 + np.diag(np.linspace(-1, 1, N))
    spd = _random_offdiag(N, 0.15, BS, 5)
    spd = (spd + spd.T) / 2 * 0.05 + np.diag(1.0 + 0.5 * np.random.default_rng(7).random(N))
    return dict(h=h.astype(np.float32), spd=spd.astype(np.float32))


def _bounds(h):
    w = np.linalg.eigvalsh(h.astype(np.float64))
    return float(w.min()) - 0.05, float(w.max()) + 0.05


SP2_KW = dict(idem_tol=1e-4, trunc_tau=1e-5, spamm_tau=1e-6)
INV_KW = dict(tol=1e-5, trunc_tau=1e-7, spamm_tau=1e-8)

_JAX_SCRIPT = r"""
import json, sys
import numpy as np, jax
from repro.core import BSMatrix
from repro.core.distributed import make_worker_mesh
from repro.dist import (scatter, PlanCache, dist_repartition, dist_multiply, dist_sp2_purify,
                        dist_localized_inverse_factorization, rebalanced_owner, RebalancePolicy)

assert jax.device_count() == 8, jax.device_count()
inp = dict(np.load(sys.argv[1]))
meta = json.loads(sys.argv[2])
stats = {}
mesh = make_worker_mesh(8)
f = BSMatrix.from_dense(inp["h"], meta["bs"])
skew = np.zeros(f.nnzb, dtype=np.int32)

dA = scatter(f, mesh, owner=skew)
new_owner = rebalanced_owner(dA.coords, np.ones(dA.nnzb), 8)
info = {}
dist_repartition(dA, new_owner, PlanCache(), stats=info)
stats["repartition"] = dict(owner=new_owner.tolist(), migrated_blocks=int(info["migrated_blocks"]),
                            migrated_bytes=int(info["migrated_bytes"]),
                            sent=np.asarray(info["sent_blocks_per_worker"]).tolist())

def rows(st):
    return [[r["cache_hits"], r["cache_misses"], r["nnzb"], r["imbalance"], r["imbalance_after"],
             int(r["migrated_bytes"])] for r in st.per_iter]

lmin, lmax = meta["bounds"]
for name, pol in (("static", None), ("rebalanced", RebalancePolicy())):
    d, st = dist_sp2_purify(scatter(f, mesh, owner=skew), meta["nocc"], lmin, lmax,
                            cache=PlanCache(), rebalance=pol, **meta["sp2_kw"])
    stats["sp2/" + name] = dict(iterations=st.iterations, rebalances=st.rebalances, rows=rows(st))
A = BSMatrix.from_dense(inp["spd"], meta["bs"])
for name, pol in (("static", None), ("rebalanced", RebalancePolicy())):
    da = scatter(A, mesh, owner=np.zeros(A.nnzb, dtype=np.int32))
    z, st = dist_localized_inverse_factorization(da, PlanCache(), rebalance=pol, **meta["inv_kw"])
    stats["inv/" + name] = dict(iterations=st.iterations, rebalances=st.rebalances, rows=rows(st))
cache = PlanCache()
dskew = scatter(f, mesh, owner=skew)
dist_multiply(dskew, dskew, cache)
dist_multiply(dskew, dskew, cache, rebalance=RebalancePolicy())
h0, m0 = cache.hits, cache.misses
dist_multiply(dskew, dskew, cache, rebalance=RebalancePolicy())
stats["knob"] = [cache.hits - h0, cache.misses - m0, cache.stats()["by_kind"]]
print("STATS " + json.dumps(stats))
"""


# -- host numpy: the partitioner and the cost model against the reference --


@pytest.mark.parametrize("seed", SEEDS)
def test_partition_morton_matches_reference_and_keeps_its_bounds(seed):
    rng = np.random.default_rng(seed)
    nblocks, nparts = int(rng.integers(1, 200)), int(rng.integers(1, 12))
    w = rng.random(nblocks) * rng.choice([1.0, 10.0, 100.0], size=nblocks)
    owner = partition_morton(nblocks, nparts, w)
    assert np.array_equal(owner, jsched.partition_morton(nblocks, nparts, w))
    assert np.all(np.diff(owner) >= 0) and owner.min() >= 0 and owner.max() < nparts
    w_eff = np.maximum(w, 1e-12)  # the partitioner's zero-weight clamp
    loads = np.bincount(owner, weights=w_eff, minlength=nparts)
    assert loads.max() <= w_eff.sum() / nparts + w_eff.max() + 1e-9
    # zero and all-zero weights, more parts than blocks, the empty structure
    w[rng.random(nblocks) < 0.5] = 0.0
    for weights in (w, np.zeros(nblocks)):
        got = partition_morton(nblocks, nparts, weights)
        assert np.array_equal(got, jsched.partition_morton(nblocks, nparts, weights))
        assert np.all(np.diff(got) >= 0) and got.max() < nparts
    few = partition_morton(nblocks % 6 + 1, 7 + seed)
    assert np.array_equal(few, jsched.partition_morton(nblocks % 6 + 1, 7 + seed))
    assert np.bincount(few).max() <= 1
    assert partition_morton(0, nparts).shape == (0,)


@pytest.mark.parametrize("seed", SEEDS)
def test_partition_morton_aligned_cuts_match_reference(seed):
    rng = np.random.default_rng(seed)
    w = rng.random(64) * 10
    nparts = 2 + seed % 5
    for align in (np.array([0, 0, 64, 64, 200, -3]), np.array([32]), np.arange(0, 65)):
        owner = partition_morton(64, nparts, w, align=align, slack=0.25)
        assert np.array_equal(owner, jsched.partition_morton(64, nparts, w, align=align, slack=0.25))
        loads = np.bincount(owner, weights=np.maximum(w, 1e-12), minlength=nparts)
        assert loads.max() <= 1.25 * w.sum() / nparts + w.max() + 1e-9
    a = BSMatrix.from_dense(_random_offdiag(N, 0.3, BS, seed), BS, device="cpu")
    align = subtree_boundaries(a.coords)
    assert np.array_equal(align, jsched.subtree_boundaries(a.coords))
    weights = rng.random(a.nnzb) + 0.5
    owner = rebalanced_owner(a.coords, weights, 4)
    assert np.array_equal(owner, jbal.rebalanced_owner(a.coords, weights, 4))
    cuts = np.nonzero(np.diff(owner))[0] + 1
    assert np.all(np.isin(cuts, align))


def test_worker_load_matches_reference():
    a = BSMatrix.from_dense(_random_offdiag(N, 0.3, BS, 1), BS, device="cpu")
    skew = np.minimum(np.arange(a.nnzb) // 3, P - 1).astype(np.int32)
    plans = [plan(a.coords, a.coords, P, BS, a_owner=skew, b_owner=skew)
             for plan in (jsched.make_spgemm_plan, make_spgemm_plan)]
    rng = np.random.default_rng(0)
    tc = rng.integers(0, 50, P)
    wts = (rng.random(a.nnzb) > 0.3).astype(np.float64)
    for kw in (dict(), dict(task_count=tc, a_weights=wts, b_weights=wts)):
        want, got = jbal.worker_load(plans[0], **kw), worker_load(plans[1], **kw)
        for f in ("tasks", "recv_bytes", "send_bytes", "blocks"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
        assert got.imbalance() == want.imbalance()
        both = got + got
        assert np.array_equal(both.tasks, 2 * got.tasks)
    assert tbal.block_reference_weights(plans[1].tasks, a.nnzb, a.nnzb)[0].tolist() == \
        jbal.block_reference_weights(plans[0].tasks, a.nnzb, a.nnzb)[0].tolist()


def test_worker_load_imbalance_uniform_is_one():
    ld = WorkerLoad(nparts=4, bs=16, tasks=np.full(4, 10.0), recv_bytes=np.full(4, 1024.0),
                    send_bytes=np.full(4, 1024.0), blocks=np.full(4, 5.0))
    assert ld.imbalance() == pytest.approx(1.0)
    skewed = WorkerLoad(nparts=4, bs=16, tasks=np.array([40.0, 0.0, 0.0, 0.0]),
                        recv_bytes=np.zeros(4), send_bytes=np.zeros(4), blocks=np.zeros(4))
    assert skewed.imbalance() == pytest.approx(4.0)
    both = ld + skewed
    assert both.tasks[0] == 50.0 and both.tasks[1] == 10.0


def test_owner_imbalance_and_policy_gating():
    owner = np.zeros(8, dtype=np.int32)
    assert owner_imbalance(owner, np.ones(8), 4) == pytest.approx(4.0)
    balanced = np.repeat(np.arange(4), 2).astype(np.int32)
    assert owner_imbalance(balanced, np.ones(8), 4) == pytest.approx(1.0)
    w = np.random.default_rng(1).random(8)
    assert owner_imbalance(balanced, w, 4) == jbal.owner_imbalance(balanced, w, 4)
    with pytest.raises(ValueError):
        RebalancePolicy(threshold=0.5)
    assert dataclasses.asdict(RebalancePolicy()) == dataclasses.asdict(jbal.RebalancePolicy())


def test_map_block_weights_join_semantics():
    src = np.array([[0, 0], [1, 1], [2, 2]])
    dst = np.array([[0, 0], [2, 2], [3, 3]])
    w = tbal.map_block_weights(src, np.array([5.0, 7.0, 9.0]), dst, default=1.5)
    assert w.tolist() == [5.0, 9.0, 1.5]
    assert tbal.map_block_weights(src, np.ones(3), np.zeros((0, 2), np.int64)).shape == (0,)
    assert tbal.map_block_weights(np.zeros((0, 2), np.int64), np.zeros(0), dst,
                                  default=2.0).tolist() == [2.0, 2.0, 2.0]
    a = BSMatrix.from_dense(_random_offdiag(N, 0.3, BS, 3), BS, device="cpu")
    b = BSMatrix.from_dense(_random_offdiag(N, 0.3, BS, 4), BS, device="cpu")
    wa = np.random.default_rng(2).random(a.nnzb)
    assert np.array_equal(tbal.map_block_weights(a.coords, wa, b.coords),
                          jbal.map_block_weights(a.coords, wa, b.coords))


def test_load_monitor_and_calibration_match_reference():
    a = BSMatrix.from_dense(_random_offdiag(N, 0.3, BS, 1), BS, device="cpu")
    x = types.SimpleNamespace(nnzb=a.nnzb, coords=a.coords,
                              owner=np.zeros(a.nnzb, dtype=np.int32))
    w = np.random.default_rng(5).random(a.nnzb) + 0.1
    got, want = LoadMonitor(P).propose(x, w), jbal.LoadMonitor(P).propose(x, w)
    assert got is not None and np.array_equal(got, want)
    x.owner = got  # a converged layout is left alone
    assert LoadMonitor(P).propose(x, w) is None and jbal.LoadMonitor(P).propose(x, w) is None
    rng = np.random.default_rng(6)
    loads = [WorkerLoad(P, BS, rng.random(P) * 100, rng.random(P) * 1e5, rng.random(P) * 1e5,
                        rng.random(P) * 10, wall_s=float(rng.random() + 0.1)) for _ in range(6)]
    jloads = [jbal.WorkerLoad(**dataclasses.asdict(ld)) for ld in loads]
    (pol, rep), (jpol, jrep) = tbal.calibrate_policy(loads), jbal.calibrate_policy(jloads)
    assert dataclasses.asdict(pol) == dataclasses.asdict(jpol) and rep == jrep
    assert tbal.calibrate_policy(loads[:3])[1]["fitted"] is False


# -- resident: the port on 8 CPU workers, the JAX package in a subprocess ----


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("balance")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    meta = json.dumps(dict(bs=BS, nocc=N_OCC, bounds=_bounds(inputs["h"]), sp2_kw=SP2_KW,
                           inv_kw=INV_KW))
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(tmp / "inputs.npz"), meta],
                          env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("STATS ")][0]
    return inputs, json.loads(line[len("STATS "):])


@pytest.fixture(scope="module")
def port(jax_run):
    inputs = jax_run[0]
    mesh = make_worker_mesh(P, "cpu")
    f = BSMatrix.from_dense(inputs["h"], BS, device="cpu")
    return mesh, f, np.zeros(f.nnzb, dtype=np.int32)


def _rows(st):
    return [[r["cache_hits"], r["cache_misses"], r["nnzb"], r["imbalance"], r["imbalance_after"],
             int(r["migrated_bytes"])] for r in st.per_iter]


def test_dist_repartition_moves_only_migrating_blocks_like_jax(jax_run, port):
    _, stats = jax_run
    mesh, f, skew = port
    want = stats["repartition"]
    cache = PlanCache()
    da = scatter(f, mesh, owner=skew)
    new_owner = rebalanced_owner(da.coords, np.ones(da.nnzb), P)
    assert new_owner.tolist() == want["owner"]
    info = {}
    db = dist_repartition(da, new_owner, cache, stats=info)
    assert np.array_equal(db.owner, new_owner) and np.array_equal(db.coords, da.coords)
    assert (info["migrated_blocks"], info["migrated_bytes"]) == \
        (want["migrated_blocks"], want["migrated_bytes"])
    assert info["sent_blocks_per_worker"].tolist() == want["sent"]
    exe = RepartitionExecutable(da, new_owner)
    assert exe.sent_blocks.sum() == exe.migrated_blocks == int(np.count_nonzero(new_owner != skew))
    # values, stack order and the norm table do not move
    assert torch.equal(db.gather().data, da.gather().data)
    assert np.array_equal(resident_block_norms(db, cache), resident_block_norms(da, cache))
    # the round trip restores the store bit for bit; a no-op map touches nothing
    dc = dist_repartition(db, da.owner, cache)
    assert torch.equal(dc.store, da.store) and dc.cap == da.cap
    h, m = cache.hits, cache.misses
    assert dist_repartition(db, db.owner, cache) is db and (cache.hits, cache.misses) == (h, m)


def test_multiply_rebalance_knob_is_bit_identical_and_cached(jax_run, port):
    _, stats = jax_run
    mesh, f, skew = port
    cache = PlanCache()
    dskew = scatter(f, mesh, owner=skew)
    c_static = dist_multiply(dskew, dskew, cache)
    c_reb = dist_multiply(dskew, dskew, cache, rebalance=RebalancePolicy())
    assert cache.stats()["by_kind"]["repartition/miss"] == 1  # the skewed operand moved
    assert torch.equal(c_reb.gather().data, c_static.gather().data)
    h0, m0 = cache.hits, cache.misses
    dist_multiply(dskew, dskew, cache, rebalance=RebalancePolicy())
    hits, misses, by_kind = stats["knob"]
    assert [cache.hits - h0, cache.misses - m0] == [hits, misses] and misses == 0
    assert cache.stats()["by_kind"] == by_kind
    s_static, e_static = dist_spamm(dskew, dskew, 1e-3, PlanCache())
    s_reb, e_reb = dist_spamm(dskew, dskew, 1e-3, PlanCache(), rebalance=RebalancePolicy())
    assert e_reb == e_static and torch.equal(s_reb.gather().data, s_static.gather().data)


def test_sp2_rebalanced_is_bit_identical_and_schedules_like_jax(jax_run, port):
    inputs, stats = jax_run
    mesh, f, skew = port
    lmin, lmax = _bounds(inputs["h"])
    runs = {}
    for name, pol in (("static", None), ("rebalanced", RebalancePolicy())):
        runs[name] = dist_sp2_purify(scatter(f, mesh, owner=skew), N_OCC, lmin, lmax,
                                     cache=PlanCache(), rebalance=pol, **SP2_KW)
        d, st = runs[name]
        want = stats["sp2/" + name]
        assert (st.iterations, st.rebalances) == (want["iterations"], want["rebalances"])
        assert _rows(st) == want["rows"]
    (d_s, st_s), (d_r, st_r) = runs["static"], runs["rebalanced"]
    assert st_r.rebalances >= 1 and sum(r["migrated_bytes"] for r in st_r.per_iter) > 0
    assert torch.equal(d_r.data, d_s.data)
    assert st_r.trace_history == st_s.trace_history
    assert st_r.idempotency_history == st_s.idempotency_history
    imb_s = [r["imbalance"] for r in st_s.per_iter]
    imb_r = [r["imbalance"] for r in st_r.per_iter]
    assert max(imb_s) >= 2.0 * max(imb_r)


def test_inverse_rebalanced_is_bit_identical_and_misses_like_jax(jax_run, port):
    inputs, stats = jax_run
    mesh, _, _ = port
    a = BSMatrix.from_dense(inputs["spd"], BS, device="cpu")
    runs = {}
    for name, pol in (("static", None), ("rebalanced", RebalancePolicy())):
        da = scatter(a, mesh, owner=np.zeros(a.nnzb, dtype=np.int32))
        runs[name] = dist_localized_inverse_factorization(da, PlanCache(), rebalance=pol, **INV_KW)
        z, st = runs[name]
        want = stats["inv/" + name]
        assert (st.iterations, st.rebalances) == (want["iterations"], want["rebalances"])
        # hits, misses, nnzb, imbalance and migrated bytes of every iteration
        assert _rows(st) == want["rows"]
    (z_s, st_s), (z_r, st_r) = runs["static"], runs["rebalanced"]
    assert st_r.rebalances >= 1
    assert torch.equal(z_r.gather().data, z_s.gather().data)
    assert st_r.residual_history == st_s.residual_history
    assert st_r.factorization_residual == st_s.factorization_residual
