"""The port's resident drivers against the JAX package's on 8 workers.

``dist_inv_chol`` (recursive and batched leaves),
``dist_localized_inverse_factorization``, ``dist_sp2_purify`` (exact and
SpAMM, leaf and hierarchical truncation), ``dist_lanczos_bounds`` with its
Gershgorin fallback, and ``dist_sqrt_inv_pipeline``.  The JAX side runs
once per module in a subprocess with 8 host devices; the port runs the same
numpy inputs in this process on ``make_worker_mesh(8, device="cpu")``.

Held to:

* exactly: structures (coords, owner, slot), iteration counts, SP2 branch
  sequences, nnzb histories, stop reasons and the plan-cache hits and
  misses of every iteration;
* bit for bit: the batched leaf factors, given the same input (both run
  the same float64 numpy lapack), and the port's batched path against its
  own recursive path;
* within tolerances: residual and idempotency histories to 1e-4 relative
  plus 1e-6 absolute (iterates round in another order from the first
  multiply on, and the differences compound over the iterations); factors
  and density matrices to 1e-5 absolute (elements of order 1); the
  pipeline's D also to 1e-4 against a float64 eigendecomposition of the
  generalized problem.

The stopping tolerances sit above the fp32 floors, where a stop or a
branch decided by rounding could differ between the packages.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro_torch.core import BSMatrix, inv_chol  # noqa: E402
from repro_torch.core.distributed import make_worker_mesh  # noqa: E402
from repro_torch.dist import (  # noqa: E402
    PlanCache,
    dist_inv_chol,
    dist_lanczos_bounds,
    dist_localized_inverse_factorization,
    dist_sp2_purify,
    dist_sqrt_inv_pipeline,
    resident_block_norms,
    scatter,
)
from repro_torch.dist import purify as pur  # noqa: E402

P = 8
N_OCC = 40  # of the SP2 Hamiltonian (n 128)
PIPE_OCC = 20  # of the pipeline's (n 64)
HIST_RTOL, HIST_ATOL = 1e-4, 1e-6
VAL_ATOL = 1e-5

# exact multiplies with leaf truncation, SpAMM with hierarchical truncation
SP2_RUNS = {
    "exact_leaf": dict(trunc_method="leaf"),
    "spamm_hier": dict(spamm_tau=1e-6),
}
SP2_KW = dict(idem_tol=1e-4, trunc_tau=1e-5)
# truncation and SpAMM on a well-conditioned S; exact multiplies on an
# ill-conditioned one (cond 3.0e4), whose histories agree to cond(A) u
INV_RUNS = {
    "refine": dict(tol=1e-5, max_iter=40, trunc_tau=1e-6, spamm_tau=1e-7),
    "ill": dict(tol=1e-3, max_iter=60),
}
U = 2.0**-24  # fp32 unit roundoff
PIPE_KW = dict(tol=1e-5, idem_tol=1e-4, trunc_tau=1e-6, spamm_tau=1e-7)


def _banded(n, h, seed):
    r = np.random.default_rng(seed)
    a = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        lo, hi = max(0, i - h), min(n, i + h + 1)
        a[i, lo:hi] = r.standard_normal(hi - lo)
    return a


def _spd(n, h, seed):
    d = _banded(n, h, seed)
    return (d @ d.T + n * np.eye(n, dtype=np.float32)).astype(np.float32)


def _block_diagonal_spd(n, bs, seed):
    r = np.random.default_rng(seed)
    a = np.zeros((n, n), dtype=np.float32)
    for lo in range(0, n, bs):
        k = min(bs, n - lo)
        g = r.standard_normal((k, k))
        a[lo:lo + k, lo:lo + k] = g @ g.T + k * np.eye(k)
    return a


def _inputs() -> dict:
    r = np.random.default_rng(3)
    h = np.zeros((128, 128), dtype=np.float32)
    for i in range(128):
        lo, hi = max(0, i - 3), min(128, i + 4)
        h[i, lo:hi] = 0.2 * r.standard_normal(hi - lo)
    h = (h + h.T) / 2 + np.diag(np.linspace(-1, 1, 128)).astype(np.float32)
    rng = np.random.default_rng(7)
    hm = 0.2 * rng.standard_normal((64, 64)).astype(np.float32)
    b = _banded(64, 3, 6)
    return dict(
        pow2=_spd(64, 4, 3), nonpow2=_spd(56, 5, 4), single=_spd(16, 3, 5),
        blockdiag=_block_diagonal_spd(60, 8, 8), s=_spd(64, 4, 2),
        ill=(b @ b.T + 1e-3 * np.eye(64, dtype=np.float32)).astype(np.float32),
        h=h.astype(np.float32),
        h_pipe=((hm + hm.T) / 2 + np.diag(np.linspace(-1, 1, 64))).astype(np.float32),
    )


_BS = dict(pow2=8, nonpow2=8, single=16, blockdiag=8)

_JAX_SCRIPT = r"""
import json, sys
import numpy as np, jax
from repro.core import BSMatrix
from repro.core.distributed import make_worker_mesh
from repro.dist import (PlanCache, scatter, dist_inv_chol, dist_localized_inverse_factorization,
                        dist_sp2_purify, dist_lanczos_bounds, dist_sqrt_inv_pipeline)
from repro.dist import purify as pur

assert jax.device_count() == 8, jax.device_count()
inp = dict(np.load(sys.argv[1]))
meta = json.loads(sys.argv[3])
out, stats = {}, {}
mesh = make_worker_mesh(8)

def keep(name, x):
    out[name + "/coords"] = np.asarray(x.coords)
    out[name + "/owner"] = np.asarray(x.owner)
    out[name + "/slot"] = np.asarray(x.slot)
    out[name + "/data"] = np.asarray(x.gather().data).astype(np.float32)

def rows(per_iter):
    return [[r["cache_hits"], r["cache_misses"], r["nnzb"]] for r in per_iter]

for name, bs in meta["bs"].items():
    keep("invchol/" + name, dist_inv_chol(scatter(BSMatrix.from_dense(inp[name], bs), mesh), PlanCache()))

S = BSMatrix.from_dense(inp["s"], 8)
for name, kw in meta["inv_runs"].items():
    a = BSMatrix.from_dense(inp["ill" if name == "ill" else "s"], 8)
    cache = PlanCache()
    z, st = dist_localized_inverse_factorization(scatter(a, mesh), cache, **kw)
    keep("inv/" + name, z)
    stats["inv/" + name] = dict(iterations=st.iterations, residuals=st.residual_history,
                                final=st.factorization_residual, nnzb=st.nnzb_history,
                                rows=rows(st.per_iter))
    z, st = dist_localized_inverse_factorization(scatter(a, mesh), cache, **kw)
    stats["inv/" + name]["second_rows"] = rows(st.per_iter)

F = BSMatrix.from_dense(inp["h"], 16)
w = np.linalg.eigvalsh(inp["h"].astype(np.float64))
lmin, lmax = float(w.min()) - 0.05, float(w.max()) + 0.05
for name, kw in meta["sp2_runs"].items():
    d, st = dist_sp2_purify(F, meta["nocc"], lmin, lmax, mesh, cache=PlanCache(), **kw,
                            **meta["sp2_kw"])
    out["sp2/" + name + "/dense"] = np.asarray(d.to_dense())
    stats["sp2/" + name] = dict(iterations=st.iterations, traces=st.trace_history,
                                idems=st.idempotency_history, nnzb=st.nnzb_history,
                                rows=rows(st.per_iter),
                                spamm_err=[r["spamm_err"] for r in st.per_iter])

dI = scatter(BSMatrix.from_dense(inp["ill"], 8), mesh)
stats["lanczos"] = list(dist_lanczos_bounds(dI, PlanCache(), steps=15))
def broken(f, cache, steps, seed):
    raise pur.LanczosDivergence("injected")
real, pur._lanczos_ritz = pur._lanczos_ritz, broken
stats["lanczos_fallback"] = list(dist_lanczos_bounds(dI, PlanCache(), steps=15))
pur._lanczos_ritz = real

H = BSMatrix.from_dense(inp["h_pipe"], 8)
pc = PlanCache()
for tag in ("pipe", "pipe2"):
    D, pst = dist_sqrt_inv_pipeline(S, H, meta["pipe_occ"], mesh, cache=pc, **meta["pipe_kw"])
    out[tag + "/dense"] = np.asarray(D.to_dense())
    stats[tag] = dict(bounds=list(pst.bounds), sp2_iterations=pst.purify.iterations,
                      traces=pst.purify.trace_history, idems=pst.purify.idempotency_history,
                      inv_iterations=pst.inverse.iterations,
                      residuals=pst.inverse.residual_history,
                      inv_rows=rows(pst.inverse.per_iter), sp2_rows=rows(pst.purify.per_iter),
                      congruence=[pst.congruence["cache_hits"], pst.congruence["cache_misses"]],
                      back=[pst.back_transform["cache_hits"], pst.back_transform["cache_misses"]])
np.savez(sys.argv[2], **out)
print("STATS " + json.dumps(stats))
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("drivers")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    meta = json.dumps(dict(bs=_BS, inv_runs=INV_RUNS, sp2_runs=SP2_RUNS, sp2_kw=SP2_KW,
                           nocc=N_OCC, pipe_occ=PIPE_OCC, pipe_kw=PIPE_KW))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(tmp / "inputs.npz"), str(tmp / "out.npz"), meta],
        env=env, capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("STATS ")][0]
    return inputs, dict(np.load(tmp / "out.npz")), json.loads(line[len("STATS "):])


@pytest.fixture(scope="module")
def mesh():
    return make_worker_mesh(P, "cpu")


def _bs(x, bs):
    return BSMatrix.from_dense(x, bs, device="cpu")


def _rows(per_iter):
    return [[r["cache_hits"], r["cache_misses"], r["nnzb"]] for r in per_iter]


def _close_hist(got, want):
    np.testing.assert_allclose(got, want, rtol=HIST_RTOL, atol=HIST_ATOL)


def _same(x, out, tag, exact=False, atol=VAL_ATOL):
    assert np.array_equal(x.coords, out[tag + "/coords"]), tag
    assert np.array_equal(x.owner, out[tag + "/owner"]), tag
    assert np.array_equal(x.slot, out[tag + "/slot"]), tag
    got = x.gather().data.numpy()
    if exact:
        assert np.array_equal(got, out[tag + "/data"]), tag
    else:
        np.testing.assert_allclose(got, out[tag + "/data"], atol=atol)


@pytest.mark.parametrize("case", ["pow2", "nonpow2", "single"])
def test_dist_inv_chol_matches_jax_and_single_device(jax_run, mesh, case):
    inp, out, _ = jax_run
    a = _bs(inp[case], _BS[case])
    z = dist_inv_chol(scatter(a, mesh), PlanCache())
    _same(z, out, "invchol/" + case)
    ref = inv_chol(a)
    assert np.array_equal(z.coords, ref.coords)
    np.testing.assert_allclose(z.gather().data.numpy(), ref.data.numpy(), atol=VAL_ATOL)
    zd = z.gather().to_dense().astype(np.float64)
    resid = np.linalg.norm(np.eye(a.shape[0]) - zd.T @ a.to_dense().astype(np.float64) @ zd)
    assert resid < 1e-4


def test_dist_inv_chol_batched_leaves_bit_identical(jax_run, mesh):
    inp, out, _ = jax_run
    a = _bs(inp["blockdiag"], 8)  # 8 block rows, the last one partial: two leaf shapes
    z = dist_inv_chol(scatter(a, mesh), PlanCache())
    _same(z, out, "invchol/blockdiag", exact=True)  # the same numpy lapack on the same input
    # the recursion scatters each leaf on its own, so only the placement differs
    z_rec = dist_inv_chol(scatter(a, mesh), PlanCache(), batch_leaves=False)
    assert np.array_equal(z_rec.coords, z.coords)
    assert torch.equal(z_rec.gather().data, z.gather().data)


@pytest.mark.parametrize("name", list(INV_RUNS))
def test_dist_inverse_factorization_matches_jax(jax_run, mesh, name):
    inp, out, stats = jax_run
    want = stats["inv/" + name]
    a = _bs(inp["ill" if name == "ill" else "s"], 8)
    cache = PlanCache()
    z, st = dist_localized_inverse_factorization(scatter(a, mesh), cache, **INV_RUNS[name])
    assert st.iterations == want["iterations"]
    assert st.nnzb_history == want["nnzb"]
    assert _rows(st.per_iter) == want["rows"]
    if name == "ill":
        cond = np.linalg.cond(inp["ill"].astype(np.float64))
        np.testing.assert_allclose(st.residual_history, want["residuals"], rtol=0,
                                   atol=cond * U)
        _same(z, out, "inv/" + name, atol=cond * U * float(np.abs(out["inv/ill/data"]).max()))
    else:
        _close_hist(st.residual_history, want["residuals"])
        _same(z, out, "inv/" + name)
    assert st.stop_reason == "converged" and st.factorization_residual <= INV_RUNS[name]["tol"]
    # the repeated solve replays every iteration from the plan cache, as in JAX
    _, st2 = dist_localized_inverse_factorization(scatter(a, mesh), cache, **INV_RUNS[name])
    assert _rows(st2.per_iter) == want["second_rows"]
    assert all(r[1] == 0 for r in want["second_rows"])


@pytest.mark.parametrize("name", list(SP2_RUNS))
def test_dist_sp2_purify_matches_jax(jax_run, mesh, name):
    inp, out, stats = jax_run
    want = stats["sp2/" + name]
    w = np.linalg.eigvalsh(inp["h"].astype(np.float64))
    lmin, lmax = float(w.min()) - 0.05, float(w.max()) + 0.05
    d, st = dist_sp2_purify(_bs(inp["h"], 16), N_OCC, lmin, lmax, mesh, cache=PlanCache(),
                            **SP2_RUNS[name], **SP2_KW)
    assert st.iterations == want["iterations"]
    branches = [t > N_OCC for t in st.trace_history]
    assert branches == [t > N_OCC for t in want["traces"]]
    assert st.nnzb_history == want["nnzb"]
    assert _rows(st.per_iter) == want["rows"]
    _close_hist(st.trace_history, want["traces"])
    _close_hist(st.idempotency_history, want["idems"])
    np.testing.assert_allclose([r["spamm_err"] for r in st.per_iter], want["spamm_err"],
                               rtol=1e-5, atol=1e-12)
    dense = d.to_dense()
    np.testing.assert_allclose(dense, out["sp2/" + name + "/dense"], atol=VAL_ATOL)
    assert abs(np.trace(dense.astype(np.float64)) - N_OCC) < 0.05


def test_dist_sp2_purify_takes_a_resident_operand(jax_run, mesh):
    inp, out, stats = jax_run
    w = np.linalg.eigvalsh(inp["h"].astype(np.float64))
    lmin, lmax = float(w.min()) - 0.05, float(w.max()) + 0.05
    f = _bs(inp["h"], 16)
    d_host, st_host = dist_sp2_purify(f, N_OCC, lmin, lmax, mesh, **SP2_KW)
    d_res, st_res = dist_sp2_purify(scatter(f, mesh), N_OCC, lmin, lmax, **SP2_KW)
    assert st_res.iterations == st_host.iterations
    np.testing.assert_allclose(d_res.to_dense(), d_host.to_dense(), atol=VAL_ATOL)


def test_dist_lanczos_bounds_and_gershgorin_fallback(jax_run, mesh, monkeypatch):
    inp, out, stats = jax_run
    d = scatter(_bs(inp["ill"], 8), mesh)
    lo, hi = dist_lanczos_bounds(d, PlanCache(), steps=15)
    np.testing.assert_allclose([lo, hi], stats["lanczos"], rtol=1e-4, atol=1e-5)
    wi = np.linalg.eigvalsh(inp["ill"].astype(np.float64))
    spread = wi.max() - wi.min()
    assert hi >= wi.max() - 0.05 * spread and lo <= wi.min() + 0.05 * spread

    def broken(f, cache, steps, seed):
        raise pur.LanczosDivergence("injected")

    monkeypatch.setattr(pur, "_lanczos_ritz", broken)
    cache = PlanCache()
    fb = dist_lanczos_bounds(d, cache, steps=15)
    assert fb == pur._spectral_bounds_from_norms(d.coords, resident_block_norms(d, cache))
    np.testing.assert_allclose(fb, stats["lanczos_fallback"], rtol=1e-6)


def test_dist_sqrt_inv_pipeline_matches_jax_and_float64(jax_run, mesh):
    inp, out, stats = jax_run
    s, h = _bs(inp["s"], 8), _bs(inp["h_pipe"], 8)
    pc = PlanCache()
    for tag in ("pipe", "pipe2"):
        want = stats[tag]
        d, pst = dist_sqrt_inv_pipeline(s, h, PIPE_OCC, mesh, cache=pc, **PIPE_KW)
        assert pst.inverse.iterations == want["inv_iterations"]
        assert pst.purify.iterations == want["sp2_iterations"]
        assert [t > PIPE_OCC for t in pst.purify.trace_history] == \
            [t > PIPE_OCC for t in want["traces"]]
        assert _rows(pst.inverse.per_iter) == want["inv_rows"]
        assert _rows(pst.purify.per_iter) == want["sp2_rows"]
        assert [pst.congruence["cache_hits"], pst.congruence["cache_misses"]] == want["congruence"]
        assert [pst.back_transform["cache_hits"],
                pst.back_transform["cache_misses"]] == want["back"]
        np.testing.assert_allclose(pst.bounds, want["bounds"], rtol=1e-4)
        _close_hist(pst.inverse.residual_history, want["residuals"])
        _close_hist(pst.purify.idempotency_history, want["idems"])
        np.testing.assert_allclose(d.to_dense(), out[tag + "/dense"], atol=VAL_ATOL)
    # the second solve replays from the cache: no miss in refinement or congruence
    assert all(r[1] == 0 for r in stats["pipe2"]["inv_rows"])
    assert stats["pipe2"]["congruence"][1] == 0
    # D against the float64 generalized eigenproblem H C = S C E
    s64, h64 = inp["s"].astype(np.float64), inp["h_pipe"].astype(np.float64)
    L = np.linalg.cholesky(s64)
    Li = np.linalg.inv(L)
    _, v = np.linalg.eigh(Li @ h64 @ Li.T)
    c = Li.T @ v[:, :PIPE_OCC]
    d64 = d.to_dense().astype(np.float64)
    assert np.abs(d64 - c @ c.T).max() < 1e-4
    assert abs(np.trace(d64 @ s64) - PIPE_OCC) < 1e-3


def test_drivers_need_a_mesh_and_refuse_what_is_not_ported(jax_run, mesh):
    inp = jax_run[0]
    s, h = _bs(inp["s"], 8), _bs(inp["h_pipe"], 8)
    with pytest.raises(ValueError):
        dist_sqrt_inv_pipeline(s, h, PIPE_OCC)
    with pytest.raises(ValueError):
        dist_sp2_purify(h, PIPE_OCC, -2.0, 2.0)
    ds = scatter(s, mesh)
    with pytest.raises(ValueError):
        dist_sqrt_inv_pipeline(ds, h, PIPE_OCC, make_worker_mesh(4, "cpu"))
    # the observers are ported: each driver attaches them to its plan cache
    from repro_torch.obs import EventLog, HealthPolicy, Tracer

    for driver in (lambda **kw: dist_sqrt_inv_pipeline(ds, h, PIPE_OCC, max_iter=2, **kw),
                   lambda **kw: dist_sp2_purify(ds, PIPE_OCC, -2.0, 2.0, max_iter=2, **kw),
                   lambda **kw: dist_localized_inverse_factorization(ds, max_iter=2, **kw)):
        cache, tr, lg = PlanCache(), Tracer(sync=False), EventLog()
        _, st = driver(cache=cache, tracer=tr, log=lg, health=HealthPolicy())
        assert cache.tracer is tr and cache.event_log is lg
        assert tr.spans and lg.events_of("run_start")
        health = [st.inverse.health, st.purify.health] if hasattr(st, "purify") else [st.health]
        assert all(x is not None and x["iterations"] >= 1 for x in health)
