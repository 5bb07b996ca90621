"""The port's plan verifier against the JAX package's.

Plans are numpy in both packages, so both verifiers run here in one
process on plans built from the same structures; their reports — check,
message and provenance of every violation, in order — must be equal, on
the clean plan and under every seeded corruption.  The port's verifier
runs its per-reference loops (remote operand references, send-span
coverage, task-mask coverage) as array operations; these tests hold them
to the reference's loops.  The payload verifiers (add, compact, relayout,
norm table) read the host copies the port's executables keep, and are
held equal too.  Then the cache admission hook: a corrupt plan raises
``PlanError`` and is never admitted, and ``verify="always"`` over the
port's real executables reports nothing.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from helpers import banded_matrix, random_block_matrix  # noqa: E402
from repro.analysis import mutate as jmutate  # noqa: E402
from repro.analysis import verify as jverify  # noqa: E402
from repro.core.distributed import _send_task_spans as j_send_task_spans  # noqa: E402
from repro.core.schedule import make_spgemm_plan as j_make_plan  # noqa: E402
from repro_torch.analysis import PlanError  # noqa: E402
from repro_torch.analysis import mutate as tmutate  # noqa: E402
from repro_torch.analysis import verify as tverify  # noqa: E402
from repro_torch.core import BSMatrix  # noqa: E402
from repro_torch.core.cache import SymbolicCache  # noqa: E402
from repro_torch.core.distributed import _send_task_spans, make_worker_mesh  # noqa: E402
from repro_torch.core.schedule import make_spgemm_plan  # noqa: E402
from repro_torch.dist import (  # noqa: E402
    PlanCache,
    dist_add,
    dist_multiply,
    dist_repartition,
    dist_spamm,
    dist_submatrix,
    dist_trace,
    dist_transpose,
    dist_truncate,
    dist_truncate_hierarchical,
    resident_block_norms,
    scatter,
)
from repro_torch.dist.collectives import AddExecutable, RepartitionExecutable, TransposeExecutable  # noqa: E402
from repro_torch.dist.matrix import NormTableExecutable  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402

BS = 16


def _report(violations):
    return [(v.check, v.message, v.provenance) for v in violations]


def _structures():
    return {
        "banded": banded_matrix(256, 20, BS, seed=0),
        "random": random_block_matrix(256, BS, 0.25, seed=3),
        "odd_blocks": random_block_matrix(120, 24, 0.4, seed=5),
    }


def _plans(name, nparts, pin=None, exchange="p2p"):
    m = _structures()[name]
    bs = m.bs
    owner = None
    if pin == "skew":
        owner = np.zeros(m.coords.shape[0], np.int32)
        owner[m.coords.shape[0] // 2:] = np.arange(m.coords.shape[0] - m.coords.shape[0] // 2) % nparts
    kw = dict(exchange=exchange, a_owner=owner, b_owner=owner)
    return (make_spgemm_plan(m.coords, m.coords, nparts, bs, **kw),
            j_make_plan(m.coords, m.coords, nparts, bs, **kw))


CASES = [("banded", 3, None, "p2p"), ("banded", 8, None, "p2p"), ("random", 4, "skew", "p2p"),
         ("random", 8, None, "p2p"), ("odd_blocks", 3, None, "p2p"), ("random", 4, None, "allgather"),
         ("random", 1, None, "p2p")]
CASE_IDS = [f"{n}-p{p}-{pin or 'morton'}-{x}" for n, p, pin, x in CASES]


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("corruption", ["clean"] + sorted(tmutate.CORRUPTIONS))
def test_verifier_reports_equal_jax_clean_and_corrupted(case, corruption):
    port, ref = _plans(*case)
    if corruption == "clean":
        assert _report(tverify.verify_spgemm_plan(port)) == _report(jverify.verify_spgemm_plan(ref)) == []
        return
    fn, check = tmutate.CORRUPTIONS[corruption]
    jfn, jcheck = jmutate.CORRUPTIONS[corruption]
    assert check == jcheck
    try:
        bad, kw = fn(port)
    except tmutate.NotApplicable:
        with pytest.raises(jmutate.NotApplicable):
            jfn(ref)
        return
    jbad, jkw = jfn(ref)
    got = _report(tverify.verify_spgemm_plan(bad, **kw))
    assert got == _report(jverify.verify_spgemm_plan(jbad, **jkw))
    assert check in {c for c, _, _ in got}
    assert all(prov for _, _, prov in got)


def _starve_spans(port_plan, ref_plan, which):
    """Empty or thin out one send-span table in both packages' memos."""
    for plan, spans in ((port_plan, _send_task_spans), (ref_plan, j_send_task_spans)):
        maps = {k: (s.copy(), c.copy()) for k, (s, c) in spans(plan).items()}
        key = sorted(maps)[which]
        starts, cat = maps[key]
        if which % 2:
            maps[key] = (np.zeros_like(starts), cat)  # every span empty
        else:
            keep = np.ones(cat.shape[0], bool)
            keep[::3] = False  # drop a third of the entries of every span
            cs = np.concatenate([[0], np.cumsum(keep)])
            maps[key] = (cs[starts], cat[keep])
        object.__setattr__(plan, "_send_task_spans", maps)


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("case", CASES[:4], ids=CASE_IDS[:4])
def test_span_and_mask_coverage_reports_equal_jax(case, which):
    """The vectorised coverage checks against the reference's loops: on a
    starved span memo both the plan check and every task mask report the
    same ``exchange-starvation`` violations in the same order."""
    port, ref = _plans(*case)
    port, ref = tmutate.clone_plan(port), jmutate.clone_plan(ref)
    rng = np.random.default_rng(1)
    masks = [np.ones(port.tasks.num_tasks, bool), rng.random(port.tasks.num_tasks) < 0.5,
             np.zeros(port.tasks.num_tasks, bool)]
    for on in masks:  # clean memo: every mask is safe
        assert _report(tverify.verify_task_mask(port, on)) == []
        assert _report(jverify.verify_task_mask(ref, on)) == []
    _starve_spans(port, ref, which)
    got = _report(tverify.verify_spgemm_plan(port))
    assert got == _report(jverify.verify_spgemm_plan(ref))
    assert "exchange-starvation" in {c for c, _, _ in got}
    for max_violations in (1, 5):
        assert (_report(tverify.verify_spgemm_plan(port, max_violations=max_violations))
                == _report(jverify.verify_spgemm_plan(ref, max_violations=max_violations)))
    for on in masks:
        assert _report(tverify.verify_task_mask(port, on)) == _report(jverify.verify_task_mask(ref, on))


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_remote_refs_equal_the_reference_rows(case):
    port, ref = _plans(*case)
    for name in ("a", "b"):
        rows, widths = tverify._remote_refs(port, name)
        jrows, jwidths = jverify._remote_refs(ref, name)
        assert widths == jwidths
        got = list(zip(*(rows[k].tolist() for k in ("p", "t", "g", "r", "src", "pos"))))
        assert got == jrows


# --- the payload verifiers ----------------------------------------------------


@pytest.fixture(scope="module")
def resident():
    """Two overlapping resident matrices on 4 CPU workers, one skewed."""
    rng = np.random.default_rng(0)
    n, bs = 96, 8
    da = np.zeros((n, n), np.float32)
    da[:64, :64] = rng.standard_normal((64, 64))
    db = np.zeros((n, n), np.float32)
    db[24:96, 24:96] = rng.standard_normal((72, 72))
    mesh = make_worker_mesh(4, "cpu")
    a = BSMatrix.from_dense(da, bs, device="cpu")
    b = BSMatrix.from_dense(db, bs, device="cpu")
    skew = np.zeros(b.nnzb, np.int32)
    skew[b.nnzb // 2:] = 3
    return scatter(a, mesh), scatter(b, mesh, owner=skew)


def _payloads(resident):
    a, b = resident
    new_owner = (np.arange(b.nnzb) % 4).astype(np.int32)
    from repro_torch.dist.collectives import _compact_to_kept

    kept = np.arange(0, a.nnzb, 3)
    cache = PlanCache()
    _compact_to_kept(a, kept, cache, kind="truncate")
    (exe,) = [v for k, v in cache._entries.items() if k[0] == "truncate"]
    return dict(
        add=AddExecutable(a, b)._verify_plan,
        add_reversed=AddExecutable(b, a)._verify_plan,
        compact=exe._verify_plan,
        transpose=TransposeExecutable(b)._verify_plan,
        repartition=RepartitionExecutable(b, new_owner)._verify_plan,
        norms=NormTableExecutable(b)._verify_plan,
    )


def _corrupt(kind, payload):
    """A few corruptions per payload kind (each returns a new dict)."""
    out = []
    p = dict(payload)
    if kind.startswith("add"):
        live = np.nonzero(p["from_a"] >= 0)[0]
        q = dict(p, from_a=p["from_a"].copy())
        q["from_a"][live[1]] = q["from_a"][live[0]]
        out.append(q)
        q = dict(p, val_a=p["val_a"].copy())
        q["val_a"][tuple(np.argwhere(q["val_a"] == 1.0)[0])] = 0.0
        out.append(q)
        q = dict(p, idx_b=p["idx_b"].copy())
        q["idx_b"][tuple(np.argwhere(p["val_b"] == 1.0)[-1])] += 1
        out.append(q)
        if p["b_offsets"]:
            d = p["b_offsets"][0]
            cnt = {k: v.copy() for k, v in p["b_send_cnt"].items()}
            cnt[d][:] = 0
            out.append(dict(p, b_send_cnt=cnt))
    elif kind == "compact":
        q = dict(p, gidx=p["gidx"].copy())
        q["gidx"][0, 0] += 1
        out.append(q)
        q = dict(p, gval=p["gval"].copy())
        q["gval"][tuple(np.argwhere(p["gval"] == 0.0)[0])] = 1.0
        out.append(q)
        out.append(dict(p, kept=np.concatenate([p["kept"][:-1], [10**6]])))
    elif kind in ("transpose", "repartition"):
        q = dict(p, gidx=p["gidx"].copy())
        q["gidx"][0, 0] = q["gidx"][0, 1]
        out.append(q)
        q = dict(p, gval=p["gval"].copy())
        q["gval"][tuple(np.argwhere(p["gval"] == 1.0)[0])] = 0.0
        out.append(q)
        if p["offsets"]:
            d = p["offsets"][0]
            send = {k: v.copy() for k, v in p["send"].items()}
            send[d][:, 0] = send[d][:, -1]
            out.append(dict(p, send=send))
    else:
        q = dict(p, gpos=p["gpos"].copy())
        q["gpos"][0, 0], q["gpos"][1, 0] = q["gpos"][1, 0], q["gpos"][0, 0]
        out.append(q)
        out.append(dict(p, gpos=p["gpos"][:, :-1]))
    return out


@pytest.mark.parametrize("kind", ["add", "add_reversed", "compact", "transpose", "repartition",
                                  "norms"])
def test_payload_verifiers_equal_jax_clean_and_corrupted(resident, kind):
    payload = _payloads(resident)[kind]
    assert _report(tverify.verify_payload(payload)) == _report(jverify.verify_payload(payload)) == []
    if kind == "repartition" or kind == "add":
        has_rounds = payload.get("offsets") or payload.get("b_offsets")
        assert has_rounds, "the case exercises the exchange rounds"
    for bad in _corrupt(kind, payload):
        got = _report(tverify.verify_payload(bad))
        assert got, f"{kind}: corruption not caught"
        assert got == _report(jverify.verify_payload(bad))


# --- the cache admission hook -------------------------------------------------


def test_cache_rejects_a_corrupt_plan_and_reports_it():
    port, _ = _plans("random", 4)
    bad, _ = tmutate.CORRUPTIONS["send_conflict"][0](port)
    tr = Tracer(sync=False)
    cache = PlanCache(tracer=tr)
    with pytest.raises(PlanError) as exc:
        cache.get_or_build(("spgemm", "k1"), lambda: (bad, None))
    assert exc.value.violations and exc.value.violations[0].provenance
    assert ("spgemm", "k1") not in cache  # a bad plan is never admitted
    events = tr.instants_of("plan_verify_violation", "analysis")
    assert events and events[0]["check"] == "send-conflict"
    assert cache.verify_violations >= 1 and tr.counter("verify_violations").value >= 1
    # the default admission proves the clean plan once, on the miss
    cache.get_or_build(("spgemm", "k2"), lambda: (port, None))
    assert cache.plans_verified == 2 and "k2" in {k[1] for k in cache._entries}


def test_cached_once_pays_nothing_on_hits():
    port, _ = _plans("random", 4)
    cache = SymbolicCache()
    cache.get_or_build(("spgemm", "k"), lambda: (port, None))
    assert cache.plans_verified == 1 and cache.verify_s > 0.0
    verified, spent = cache.plans_verified, cache.verify_s
    for _ in range(5):
        cache.get_or_build(("spgemm", "k"), lambda: (port, None))
    assert (cache.hits, cache.plans_verified, cache.verify_s) == (5, verified, spent)
    always = SymbolicCache(verify="always")
    always.get_or_build(("spgemm", "k"), lambda: (port, None))
    always.get_or_build(("spgemm", "k"), lambda: (port, None))
    assert always.plans_verified == 2
    off = SymbolicCache(verify="off")
    off.get_or_build(("spgemm", "k"), lambda: (port, None))
    assert off.plans_verified == 0 and off.verify_s == 0.0
    assert SymbolicCache().get_or_build(("trace", "k"), lambda: 42.0) == 42.0
    assert tverify.verify_value(("trace", "k"), 42.0) is None


def test_verify_always_on_the_ports_real_executables(resident):
    """Every kind of plan the resident runtime caches, built on a skewed
    4-worker CPU mesh under ``verify="always"``: all verify clean."""
    a, b = resident
    cache = PlanCache(verify="always")
    c = dist_multiply(a, b, cache)
    dist_multiply(a, b, cache)  # a hit, re-verified
    dist_spamm(a, b, 1e-2, cache)
    d = dist_add(c, a, 1.0, -0.5, cache)
    dist_trace(d, cache)
    t = dist_transpose(b, cache)
    dist_repartition(t, (np.arange(t.nnzb) % 4).astype(np.int32), cache)
    tau = 0.3 * float(np.linalg.norm(resident_block_norms(d, cache)))
    assert dist_truncate(d, tau, cache).nnzb < d.nnzb
    assert dist_truncate_hierarchical(d, tau, cache).nnzb < d.nnzb
    dist_submatrix(d, 0, 4, 0, 4, cache)
    resident_block_norms(b, cache)
    assert cache.verify_violations == 0 and cache.plans_verified >= 10
    kinds = {k[0] for k, v in cache._entries.items() if tverify.verify_value(k, v) is not None}
    assert kinds >= {"spgemm", "spamm-delta", "add", "transpose", "repartition", "truncate",
                     "slice", "norms"}
    for key, value in cache._entries.items():
        assert _report(tverify.verify_value(key, value) or []) == []
    assert torch.isfinite(c.store).all()
