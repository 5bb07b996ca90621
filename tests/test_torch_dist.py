"""The port's resident runtime against the JAX package's on 8 workers.

The JAX side needs 8 devices, so it runs once per module in a subprocess
with ``--xla_force_host_platform_device_count=8`` (as tests/test_distributed.py
does) and writes its results as numpy arrays; the port runs the same inputs
in this process on a CPU mesh of 8 workers.  Structure is compared exactly
(coords, owner/slot/cap, kept task counts, exchange statistics, plan-cache
hit/miss counts); values within ``torch_parity.gemm_tolerance`` (rel 1e-5);
SpAMM error bounds within 1e-6 relative (the packages' fp32 block norms
differ by an ulp), and exactly when the port is handed the JAX norms.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro_torch.convert import distmatrix_from_arrays, distmatrix_to_arrays  # noqa: E402
from repro_torch.core import BSMatrix, multiply, spgemm_symbolic  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    dist_spgemm,
    make_worker_mesh,
    unshard_result,
)
from repro_torch.core.quadtree import morton_encode  # noqa: E402
from repro_torch.core.schedule import make_spgemm_plan  # noqa: E402
from repro_torch.dist import (  # noqa: E402
    PlanCache,
    dist_multiply,
    dist_sp2_purify,
    dist_spamm,
    resident_block_norms,
    scatter,
)
from repro_torch.kernels import fused_leaf  # noqa: E402
from repro_torch.kernels.precision import BF16, Precision  # noqa: E402
from torch_parity import assert_blocks_within, gemm_tolerance  # noqa: E402

P, N, BS = 8, 256, 16
TAUS = (1e-3, 1e-2)  # relative to ||E||_F^2
PRECISIONS = ("fp32", "bf16", "adaptive")


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    i = np.arange(N)
    dist = np.abs(i[:, None] - i[None, :])
    band = np.where(dist <= 20, rng.standard_normal((N, N)), 0.0).astype(np.float32)
    decay = (rng.standard_normal((N, N)) * np.exp(-0.08 * dist)).astype(np.float32)
    nb = N // BS
    mask = np.kron(rng.random((nb, nb)) < 0.3, np.ones((BS, BS)))
    rand = (mask * rng.standard_normal((N, N))).astype(np.float32)
    return dict(band=band, decay=decay, rand=rand)


_JAX_SCRIPT = r"""
import json, sys
import numpy as np, jax
from repro.core import BSMatrix
from repro.core.distributed import make_worker_mesh, dist_spgemm, unshard_result
from repro.core.schedule import make_spgemm_plan
from repro.dist import PlanCache, scatter, dist_multiply, dist_spamm, resident_block_norms
from repro.kernels.precision import BF16, Precision

assert jax.device_count() == 8, jax.device_count()
inp = dict(np.load(sys.argv[1]))
meta = json.loads(sys.argv[3])
out, stats = {}, {}
mesh = make_worker_mesh(8)
band = BSMatrix.from_dense(inp["band"], meta["bs"])
rand = BSMatrix.from_dense(inp["rand"], meta["bs"])
decay = BSMatrix.from_dense(inp["decay"], meta["bs"], prune_tol=1e-6)

def keep(name, x):
    out[name + "/coords"] = np.asarray(x.coords)
    out[name + "/owner"] = np.asarray(x.owner)
    out[name + "/slot"] = np.asarray(x.slot)
    out[name + "/cap"] = np.asarray(x.cap)
    out[name + "/data"] = np.asarray(x.gather().data).astype(np.float32)

d_band, d_rand, d_decay = scatter(band, mesh), scatter(rand, mesh), scatter(decay, mesh)
for f in ("coords", "owner", "slot", "cap", "store"):
    out["band_resident/" + f] = np.asarray(getattr(d_band, f))
for name, x in (("band", d_band), ("rand", d_rand), ("decay", d_decay)):
    out[name + "/norms"] = resident_block_norms(x)

cache = PlanCache()
keep("band@band/fused", dist_multiply(d_band, d_band, cache, impl="fused"))
keep("band@band/fused2", dist_multiply(d_band, d_band, cache, impl="fused"))
keep("band@band/ref", dist_multiply(d_band, d_band, cache, impl="ref"))
keep("rand@band/fused", dist_multiply(d_rand, d_band, cache, impl="fused"))
keep("band@band/allgather", dist_multiply(d_band, d_band, cache, exchange="allgather"))
keep("band@band/bf16", dist_multiply(d_band, d_band, cache, impl="fused", precision=BF16))
keep("band@band/adaptive", dist_multiply(d_band, d_band, cache, impl="fused",
                                         precision=Precision("adaptive", 5.0)))
stats["multiply_cache"] = [cache.hits, cache.misses, cache.stats()["by_kind"]]

fro2 = float(np.sum(out["decay/norms"] ** 2))
for tau_rel in meta["taus"]:
    tau = tau_rel * fro2
    for prec in meta["precisions"]:
        p = {"fp32": None, "bf16": BF16, "adaptive": Precision("adaptive")}[prec]
        tag = f"delta/{prec}/{tau_rel}"
        c, err = dist_spamm(d_decay, d_decay, tau, cache, impl="fused", precision=p)
        exe = cache.peek(cache.last_plan_key)[1]
        stats[tag] = dict(err=err, task_count=np.asarray(cache.last_task_count).tolist(),
                          exchange=exe.last_exchange)
        keep(tag, c)
    tag = f"delta-ref/fp32/{tau_rel}"
    c, err = dist_spamm(d_decay, d_decay, tau, cache, impl="ref")
    stats[tag] = dict(err=err, task_count=np.asarray(cache.last_task_count).tolist())
    keep(tag, c)
    tag = f"replan/fp32/{tau_rel}"
    c, err = dist_spamm(d_decay, d_decay, tau, cache, impl="fused", method="replan")
    stats[tag] = dict(err=err, task_count=np.asarray(cache.last_task_count).tolist())
    keep(tag, c)
stats["final_cache"] = [cache.hits, cache.misses, cache.stats()["by_kind"]]

for placement, exchange in (("morton", "p2p"), ("random", "p2p"), ("morton", "allgather")):
    plan = make_spgemm_plan(band.coords, band.coords, 8, meta["bs"], placement=placement,
                            exchange=exchange)
    c = unshard_result(plan, dist_spgemm(plan, band.data, band.data, mesh), band.shape, meta["bs"])
    out[f"spgemm/{placement}/{exchange}"] = np.asarray(c.data)
np.savez(sys.argv[2], **out)
print("STATS " + json.dumps(stats))
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    meta = json.dumps(dict(bs=BS, taus=TAUS, precisions=PRECISIONS))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(tmp / "inputs.npz"), str(tmp / "out.npz"), meta],
        env=env, capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("STATS ")][0]
    out = dict(np.load(tmp / "out.npz"))
    return inputs, out, json.loads(line[len("STATS "):])


@pytest.fixture(scope="module")
def port(jax_run):
    inputs = jax_run[0]
    mesh = make_worker_mesh(P, "cpu")
    m = dict(
        band=BSMatrix.from_dense(inputs["band"], BS, device="cpu"),
        rand=BSMatrix.from_dense(inputs["rand"], BS, device="cpu"),
        decay=BSMatrix.from_dense(inputs["decay"], BS, prune_tol=1e-6, device="cpu"),
    )
    d = {k: scatter(v, mesh) for k, v in m.items()}
    return mesh, m, d


def _same_structure(c, out, tag):
    assert np.array_equal(c.coords, out[tag + "/coords"])
    assert np.array_equal(c.owner, out[tag + "/owner"])
    assert np.array_equal(c.slot, out[tag + "/slot"])
    assert c.cap == int(out[tag + "/cap"])


def _close(c, out, tag, a, b):
    _same_structure(c, out, tag)
    t = spgemm_symbolic(a.coords, b.coords)
    tol = gemm_tolerance(a.data.numpy(), b.data.numpy(), t.a_idx, t.b_idx, t.c_idx, t.num_out)
    # a pruned product holds a subset of the full product's blocks
    rows = np.searchsorted(morton_encode(*t.c_coords.T), morton_encode(*c.coords.T))
    assert_blocks_within(c.gather().data.float().numpy(), out[tag + "/data"], tol[rows])


def test_scatter_and_convert_equal_jax_resident_matrix(jax_run, port):
    _, out, _ = jax_run
    mesh, m, d = port
    x = d["band"]
    y = distmatrix_from_arrays(x.shape, BS, *(out["band_resident/" + f] for f in
                                             ("coords", "owner", "slot", "cap", "store")),
                               mesh=mesh)
    assert torch.equal(y.store, x.store)
    assert np.array_equal(y.owner, x.owner) and np.array_equal(y.slot, x.slot) and y.cap == x.cap
    back = distmatrix_from_arrays(mesh=mesh, **distmatrix_to_arrays(x))
    assert torch.equal(back.store, x.store) and torch.equal(back.gather().data, m["band"].data)
    for name in ("band", "rand", "decay"):
        assert np.array_equal(resident_block_norms(d[name]), resident_block_norms(d[name], PlanCache()))
        np.testing.assert_allclose(resident_block_norms(d[name]), out[name + "/norms"], rtol=1e-6)


def test_dist_multiply_matches_jax_and_single_device(jax_run, port):
    _, out, stats = jax_run
    mesh, m, d = port
    cache = PlanCache()
    single = multiply(m["band"], m["band"])
    for tag, kw in (("fused", dict()), ("fused2", dict()), ("ref", dict(impl="ref")),
                    ("allgather", dict(exchange="allgather")), ("bf16", dict(precision=BF16)),
                    ("adaptive", dict(precision=Precision("adaptive", 5.0)))):
        c = dist_multiply(d["band"], d["band"], cache, **kw)
        if tag in ("bf16", "adaptive"):
            _same_structure(c, out, f"band@band/{tag}")
            # rounded the same way in both packages: the same products
            a16 = m["band"].data.to(torch.bfloat16).float()
            t = spgemm_symbolic(m["band"].coords, m["band"].coords)
            tol = gemm_tolerance(a16.numpy(), a16.numpy(), t.a_idx, t.b_idx, t.c_idx, t.num_out)
            assert_blocks_within(c.gather().data.numpy(), out[f"band@band/{tag}/data"], tol)
        else:
            _close(c, out, f"band@band/{tag}", m["band"], m["band"])
            # fp32: every engine sums each block's tasks in the single-device order
            assert torch.equal(c.gather().data, single.data), tag
    c = dist_multiply(d["rand"], d["band"], cache)
    _close(c, out, "rand@band/fused", m["rand"], m["band"])
    assert torch.equal(c.gather().data, multiply(m["rand"], m["band"]).data)
    hits, misses, by_kind = stats["multiply_cache"]
    assert (cache.hits, cache.misses) == (hits, misses)
    assert cache.stats()["by_kind"] == by_kind


@pytest.mark.parametrize("tau_rel", TAUS)
@pytest.mark.parametrize("prec", PRECISIONS)
def test_dist_spamm_delta_matches_jax(jax_run, port, tau_rel, prec):
    _, out, stats = jax_run
    mesh, m, d = port
    fro2 = float(np.sum(out["decay/norms"] ** 2))
    p = {"fp32": None, "bf16": BF16, "adaptive": Precision("adaptive")}[prec]
    tag = f"delta/{prec}/{tau_rel}"
    want = stats[tag]
    for norms in (out["decay/norms"], None):  # the JAX norms, then the port's own
        cache = PlanCache()
        c, err = dist_spamm(d["decay"], d["decay"], tau_rel * fro2, cache, precision=p,
                            a_norms=norms, b_norms=norms)
        np.testing.assert_allclose(err, want["err"], rtol=1e-12 if norms is not None else 1e-6)
        assert cache.last_task_count.tolist() == want["task_count"]
        exe = cache.peek(cache.last_plan_key)[1]
        assert exe.last_exchange == want["exchange"]
        _same_structure(c, out, tag)
        if prec == "fp32":
            _close(c, out, tag, m["decay"], m["decay"])
        else:
            ref = out[tag + "/data"]
            got = c.gather().data.numpy()
            np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())
    # the bound holds against the float64 product
    exact = m["decay"].to_dense().astype(np.float64)
    dense = c.gather().to_dense().astype(np.float64)
    t = spgemm_symbolic(m["decay"].coords, m["decay"].coords)
    na = np.linalg.norm(m["decay"].data.double().numpy(), axis=(1, 2))
    rounding = 1e-5 * BS * float((na[t.a_idx] * na[t.b_idx]).sum())
    assert np.linalg.norm(exact @ exact - dense) <= err + rounding


@pytest.mark.parametrize("tau_rel", TAUS)
def test_dist_spamm_staged_and_replan_match_jax(jax_run, port, tau_rel):
    _, out, stats = jax_run
    mesh, m, d = port
    fro2 = float(np.sum(out["decay/norms"] ** 2))
    norms = out["decay/norms"]
    for tag, kw in ((f"delta-ref/fp32/{tau_rel}", dict(impl="ref")),
                    (f"replan/fp32/{tau_rel}", dict(method="replan"))):
        cache = PlanCache()
        c, err = dist_spamm(d["decay"], d["decay"], tau_rel * fro2, cache, a_norms=norms,
                            b_norms=norms, **kw)
        np.testing.assert_allclose(err, stats[tag]["err"], rtol=1e-12)
        assert cache.last_task_count.tolist() == stats[tag]["task_count"]
        _close(c, out, tag, m["decay"], m["decay"])
    # the fused delta path sums the kept tasks in the staged path's order
    c_f, _ = dist_spamm(d["decay"], d["decay"], tau_rel * fro2, PlanCache(), a_norms=norms,
                        b_norms=norms)
    c_s, _ = dist_spamm(d["decay"], d["decay"], tau_rel * fro2, PlanCache(), impl="ref",
                        a_norms=norms, b_norms=norms)
    assert torch.equal(c_f.store, c_s.store)


def test_plan_cache_replays_like_jax(jax_run, port):
    _, out, stats = jax_run
    mesh, m, d = port
    cache = PlanCache()
    for tag, kw in (("fused", dict()), ("fused2", dict()), ("ref", dict(impl="ref")),
                    ("rand", None), ("allgather", dict(exchange="allgather")),
                    ("bf16", dict(precision=BF16)),
                    ("adaptive", dict(precision=Precision("adaptive", 5.0)))):
        if kw is None:
            dist_multiply(d["rand"], d["band"], cache)
        else:
            dist_multiply(d["band"], d["band"], cache, **kw)
    fro2 = float(np.sum(out["decay/norms"] ** 2))
    before = fused_leaf.launches
    for tau_rel in TAUS:
        for prec in PRECISIONS:
            p = {"fp32": None, "bf16": BF16, "adaptive": Precision("adaptive")}[prec]
            dist_spamm(d["decay"], d["decay"], tau_rel * fro2, cache, precision=p)
        dist_spamm(d["decay"], d["decay"], tau_rel * fro2, cache, impl="ref")
        dist_spamm(d["decay"], d["decay"], tau_rel * fro2, cache, method="replan")
    hits, misses, by_kind = stats["final_cache"]
    assert (cache.hits, cache.misses) == (hits, misses)
    assert cache.stats()["by_kind"] == by_kind
    assert fused_leaf.launches == before  # the CPU takes the plain version


@pytest.mark.parametrize("placement,exchange", [("morton", "p2p"), ("random", "p2p"),
                                                ("morton", "allgather")])
def test_dist_spgemm_unshard_matches_jax(jax_run, port, placement, exchange):
    _, out, _ = jax_run
    mesh, m, _ = port
    a = m["band"]
    plan = make_spgemm_plan(a.coords, a.coords, P, BS, placement=placement, exchange=exchange)
    for impl in ("fused", "ref"):
        c = unshard_result(plan, dist_spgemm(plan, a.data, a.data, impl=impl), a.shape, BS)
        assert np.array_equal(c.coords, plan.c_coords)
        t = plan.tasks
        tol = gemm_tolerance(a.data.numpy(), a.data.numpy(), t.a_idx, t.b_idx, t.c_idx, t.num_out)
        assert_blocks_within(c.data.numpy(), out[f"spgemm/{placement}/{exchange}"], tol)
        assert torch.equal(c.data, multiply(a, a).data)


def test_entry_points_refuse_what_is_not_ported(port):
    mesh, m, d = port
    # the drivers' observers are ported: they ride on the plan cache
    from repro_torch.obs import EventLog, HealthPolicy, Tracer

    cache, tr, lg = PlanCache(), Tracer(sync=False), EventLog()
    _, st = dist_sp2_purify(d["band"], 10, -1.0, 1.0, cache=cache, max_iter=2, tracer=tr, log=lg,
                            health=HealthPolicy())
    assert cache.tracer is tr and cache.event_log is lg and st.health["iterations"] >= 1
    with pytest.raises(ValueError):
        dist_multiply(d["band"], d["band"], impl="ref", precision=BF16)
    with pytest.raises(ValueError):
        dist_spamm(d["band"], d["band"], 0.1, method="replan", precision=Precision("adaptive"))
