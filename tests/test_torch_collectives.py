"""The port's resident collectives against the JAX package's on 8 workers.

Mirrors the collective cases of tests/test_dist.py (add, trace and
Frobenius norm, leaf and hierarchical truncation with their edge cases) and
the transpose, quadrant-slice and assemble cases of
tests/test_dist_inverse.py.  The JAX side runs once per module in a
subprocess with 8 host devices; the port runs the same numpy inputs in this
process on ``make_worker_mesh(8, device="cpu")``.

Held to:

* structure exactly — coords, owner, slot, cap, kept sets, the exchange
  offsets of every planned gather, plan-cache hits and misses by kind;
* gathers, transposes, slices, assembly and truncation compaction bit for
  bit (they copy blocks);
* ``dist_add`` within one fp32 rounding of ``|alpha a| + |beta b|`` per
  element (both round alpha*a and beta*b, then their sum, to fp32);
* trace and squared Frobenius norm within ``k u sum |x_i|``, the
  worst-case difference of summing k fp32 terms in two orders (the port
  sums per-block partials in stack order, the JAX package per device then
  over devices).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro_torch.core import BSMatrix, add, submatrix, truncate  # noqa: E402
from repro_torch.core.distributed import make_worker_mesh  # noqa: E402
from repro_torch.core.truncate import truncate_hierarchical  # noqa: E402
from repro_torch.dist import (  # noqa: E402
    PlanCache,
    dist_add,
    dist_assemble2x2,
    dist_frobenius_norm,
    dist_scale,
    dist_submatrix,
    dist_trace,
    dist_transpose,
    dist_truncate,
    dist_truncate_hierarchical,
    dist_zeros,
    scatter,
    transpose_permutation,
)
from repro_torch.dist.collectives import _structure_key  # noqa: E402

P = 8
FP32_ULP = 2.0**-23  # one rounding of fp32, relative
QUADS = [(0, 4, 0, 4), (0, 4, 4, 8), (4, 8, 0, 4), (4, 8, 4, 8)]


def _banded(n, h, seed):
    r = np.random.default_rng(seed)
    a = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        lo, hi = max(0, i - h), min(n, i + h + 1)
        a[i, lo:hi] = r.standard_normal(hi - lo)
    return a


def _inputs() -> dict:
    spd = _banded(64, 4, 2)
    return dict(
        a=_banded(192, 12, 1),
        b=_banded(192, 5, 2),
        t=_banded(96, 8, 1),
        s=(spd @ spd.T + 64 * np.eye(64, dtype=np.float32)).astype(np.float32),
        single=np.full((16, 16), 0.5, np.float32),
        random_owner=np.random.default_rng(3).integers(0, P, 10_000).astype(np.int32),
    )


_JAX_SCRIPT = r"""
import json, sys
import numpy as np, jax
from repro.core import BSMatrix
from repro.core.distributed import make_worker_mesh
from repro.dist import (PlanCache, scatter, dist_add, dist_trace, dist_frobenius_norm,
                        dist_truncate, dist_truncate_hierarchical, dist_transpose,
                        dist_submatrix, dist_assemble2x2, dist_zeros)
from repro.dist.collectives import _structure_key

assert jax.device_count() == 8, jax.device_count()
inp = dict(np.load(sys.argv[1]))
out, stats = {}, {}
mesh = make_worker_mesh(8)

def keep(name, x):
    out[name + "/coords"] = np.asarray(x.coords)
    out[name + "/owner"] = np.asarray(x.owner)
    out[name + "/slot"] = np.asarray(x.slot)
    out[name + "/cap"] = np.asarray(x.cap)
    out[name + "/data"] = np.asarray(x.gather().data).astype(np.float32)

A = BSMatrix.from_dense(inp["a"], 16)
B = BSMatrix.from_dense(inp["b"], 16)
dA, dB = scatter(A, mesh), scatter(B, mesh)
dAr = scatter(A, mesh, owner=inp["random_owner"][:A.nnzb])
cache = PlanCache()
for tag, (x, y, al, be) in {"add": (dA, dB, 2.0, -0.5), "add2": (dA, dB, -1.0, 3.0),
                            "add_r": (dAr, dB, 0.3, 1.7), "add_self": (dA, dA, 1.0, -1.0)}.items():
    keep(tag, dist_add(x, y, al, be, cache))
    exe = cache.peek(("add", _structure_key(x), _structure_key(y)))
    vp = exe._verify_plan
    stats[tag] = dict(a_offsets=list(map(int, vp["a_offsets"])),
                      b_offsets=list(map(int, vp["b_offsets"])))
    out[tag + "/idx_a"] = vp["idx_a"]
    out[tag + "/idx_b"] = vp["idx_b"]
stats["trace"] = [dist_trace(dA, cache), dist_trace(dAr, cache), dist_trace(dB, cache)]
stats["fro"] = [dist_frobenius_norm(dA, cache), dist_frobenius_norm(dAr, cache)]
tau = float(np.median(np.asarray(A.block_norms())) * 2)
stats["tau"] = tau
keep("trunc", dist_truncate(dA, tau, cache))
keep("trunc_r", dist_truncate(dAr, tau, cache))
stats["trunc_all"] = dist_truncate(dA, A.frobenius_norm() * 1.01, cache).nnzb
ds = scatter(BSMatrix.from_dense(inp["single"], 16), mesh)
stats["trunc_single"] = [dist_truncate(ds, 1e-6, cache).nnzb, dist_truncate(ds, 1e6, cache).nnzb]
info = {}
keep("htrunc", dist_truncate_hierarchical(dA, tau * 1.5, cache, stats=info))
stats["htrunc"] = [int(info["nodes_visited"]), np.asarray(info["kept"]).tolist()]
info = {}
dist_truncate_hierarchical(dA, 0.0, cache, stats=info)
stats["htrunc_zero"] = [int(info["nodes_visited"]), len(info["kept"])]

T = BSMatrix.from_dense(inp["t"], 8)
dT = scatter(T, mesh)
keep("t", dist_transpose(dT, cache))
keep("tt", dist_transpose(dist_transpose(dT, cache), cache))
dTr = scatter(T, mesh, owner=inp["random_owner"][:T.nnzb])
keep("t_r", dist_transpose(dTr, cache))
exe = cache.peek(("transpose", _structure_key(dTr)))
stats["t_r_offsets"] = list(map(int, exe._verify_plan["offsets"]))
keep("t_scaled", dist_transpose(dTr, cache).scale(-2.5))

S = BSMatrix.from_dense(inp["s"], 8)
dS = scatter(S, mesh)
quads = [dist_submatrix(dS, *q, cache) for q in [(0, 4, 0, 4), (0, 4, 4, 8), (4, 8, 0, 4), (4, 8, 4, 8)]]
for i, q in enumerate(quads):
    keep(f"quad{i}", q)
keep("asm", dist_assemble2x2(*quads, 4, cache))
z = dist_zeros(quads[1].shape, 8, mesh)
keep("asm_zero", dist_assemble2x2(quads[0], z, dist_zeros(quads[2].shape, 8, mesh), quads[3], 4, cache))
stats["cache"] = [cache.hits, cache.misses, cache.stats()["by_kind"]]
np.savez(sys.argv[2], **out)
print("STATS " + json.dumps(stats))
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(tmp / "inputs.npz"), str(tmp / "out.npz")],
        env=env, capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("STATS ")][0]
    return inputs, dict(np.load(tmp / "out.npz")), json.loads(line[len("STATS "):])


@pytest.fixture(scope="module")
def port(jax_run):
    inp = jax_run[0]
    mesh = make_worker_mesh(P, "cpu")
    m = dict(a=BSMatrix.from_dense(inp["a"], 16, device="cpu"),
             b=BSMatrix.from_dense(inp["b"], 16, device="cpu"),
             t=BSMatrix.from_dense(inp["t"], 8, device="cpu"),
             s=BSMatrix.from_dense(inp["s"], 8, device="cpu"),
             single=BSMatrix.from_dense(inp["single"], 16, device="cpu"))
    d = {k: scatter(v, mesh) for k, v in m.items()}
    d["a_r"] = scatter(m["a"], mesh, owner=inp["random_owner"][: m["a"].nnzb])
    d["t_r"] = scatter(m["t"], mesh, owner=inp["random_owner"][: m["t"].nnzb])
    return mesh, m, d


def _same_structure(x, out, tag):
    assert np.array_equal(x.coords, out[tag + "/coords"]), tag
    assert np.array_equal(x.owner, out[tag + "/owner"]), tag
    assert np.array_equal(x.slot, out[tag + "/slot"]), tag
    assert x.cap == int(out[tag + "/cap"]), tag


def _identical(x, out, tag):
    _same_structure(x, out, tag)
    assert np.array_equal(x.gather().data.numpy(), out[tag + "/data"]), tag


ADDS = {"add": ("a", "b", 2.0, -0.5), "add2": ("a", "b", -1.0, 3.0),
        "add_r": ("a_r", "b", 0.3, 1.7), "add_self": ("a", "a", 1.0, -1.0)}


@pytest.mark.parametrize("tag", list(ADDS))
def test_dist_add_matches_jax_and_single_device(jax_run, port, tag):
    _, out, stats = jax_run
    mesh, m, d = port
    x, y, al, be = ADDS[tag]
    cache = PlanCache()
    c = dist_add(d[x], d[y], al, be, cache)
    _same_structure(c, out, tag)
    exe = cache.peek(("add", _structure_key(d[x]), _structure_key(d[y])))
    assert list(exe._a_offsets) == stats[tag]["a_offsets"]
    assert list(exe._b_offsets) == stats[tag]["b_offsets"]
    assert np.array_equal(exe._gather_a._gidx.numpy(), out[tag + "/idx_a"])
    assert np.array_equal(exe._gather_b._gidx.numpy(), out[tag + "/idx_b"])
    # one fp32 rounding of |alpha a| + |beta b| per element
    ref = add(d[x].gather(), d[y].gather(), al, be)
    assert np.array_equal(ref.coords, c.coords)
    bound = np.abs(add(d[x].gather(), d[y].gather(), abs(al), 0.0).data.numpy())
    bound += np.abs(add(d[x].gather(), d[y].gather(), 0.0, abs(be)).data.numpy())
    got = c.gather().data.numpy()
    assert np.all(np.abs(got - out[tag + "/data"]) <= 2 * FP32_ULP * bound)
    assert np.all(np.abs(got - ref.data.numpy()) <= 2 * FP32_ULP * bound)
    # a second coefficient pair reuses the executable
    h, mi = cache.hits, cache.misses
    dist_add(d[x], d[y], -al, be, cache)
    assert (cache.hits - h, cache.misses - mi) == (1, 0)


def test_dist_reductions_match_jax_and_do_not_depend_on_the_layout(jax_run, port):
    _, out, stats = jax_run
    mesh, m, d = port
    cache = PlanCache()
    tr = [dist_trace(d["a"], cache), dist_trace(d["a_r"], cache), dist_trace(d["b"], cache)]
    fro = [dist_frobenius_norm(d["a"], cache), dist_frobenius_norm(d["a_r"], cache)]
    # the worst-case bound of summing k fp32 terms in two orders: k u sum |x_i|
    for got, want, x in zip(tr, stats["trace"], ("a", "a_r", "b")):
        diag = np.abs(np.diag(m[x[0]].to_dense()).astype(np.float64))
        assert abs(got - want) <= diag.size * FP32_ULP * diag.sum()
    sq = (m["a"].to_dense().astype(np.float64) ** 2).sum()
    for got, want in zip(fro, stats["fro"]):
        assert abs(got**2 - want**2) <= m["a"].nnzb * 256 * FP32_ULP * sq
    # summed in stack order: the same bits whatever worker holds a block
    assert tr[0] == tr[1] and fro[0] == fro[1]
    np.testing.assert_allclose(tr[0], m["a"].trace(), rtol=1e-6)
    np.testing.assert_allclose(fro[0], m["a"].frobenius_norm(), rtol=1e-6)
    assert dist_scale(d["a"], 2.0).gather().data.equal(m["a"].data * 2.0)


@pytest.mark.parametrize("tag,which", [("trunc", "a"), ("trunc_r", "a_r")])
def test_dist_truncate_matches_jax_and_single_device(jax_run, port, tag, which):
    inp, out, stats = jax_run
    mesh, m, d = port
    t = dist_truncate(d[which], stats["tau"], PlanCache())
    _identical(t, out, tag)
    ref = truncate(m["a"], stats["tau"])
    assert t.nnzb == ref.nnzb < m["a"].nnzb
    assert np.array_equal(t.coords, ref.coords)
    assert torch.equal(t.gather().data, ref.data)


def test_dist_truncate_edge_cases(jax_run, port):
    _, out, stats = jax_run
    mesh, m, d = port
    cache = PlanCache()
    assert dist_truncate(d["a"], m["a"].frobenius_norm() * 1.01, cache).nnzb == stats["trunc_all"] == 0
    single = [dist_truncate(d["single"], 1e-6, cache).nnzb, dist_truncate(d["single"], 1e6, cache).nnzb]
    assert single == stats["trunc_single"] == [1, 0]
    assert dist_truncate(d["a"], 0.0, cache) is d["a"]


def test_dist_truncate_hierarchical_matches_jax(jax_run, port):
    _, out, stats = jax_run
    mesh, m, d = port
    info = {}
    tau = stats["tau"] * 1.5
    t = dist_truncate_hierarchical(d["a"], tau, PlanCache(), stats=info)
    _identical(t, out, "htrunc")
    assert [int(info["nodes_visited"]), info["kept"].tolist()] == stats["htrunc"]
    ref = truncate_hierarchical(m["a"], tau)
    assert np.array_equal(t.coords, ref.coords) and t.nnzb < m["a"].nnzb
    err = np.linalg.norm(m["a"].to_dense().astype(np.float64) - t.gather().to_dense())
    assert err <= tau * (1 + 1e-6)
    info = {}
    assert dist_truncate_hierarchical(d["a"], 0.0, PlanCache(), stats=info) is d["a"]
    assert [info["nodes_visited"], len(info["kept"])] == stats["htrunc_zero"]


def test_dist_transpose_matches_jax_and_round_trips(jax_run, port):
    _, out, stats = jax_run
    mesh, m, d = port
    cache = PlanCache()
    t = dist_transpose(d["t"], cache)
    _identical(t, out, "t")
    assert np.array_equal(t.gather().to_dense(), m["t"].to_dense().T)
    assert np.array_equal(t.coords, m["t"].transpose().coords)
    tt = dist_transpose(t, cache)
    _identical(tt, out, "tt")
    assert np.array_equal(tt.owner, d["t"].owner) and np.array_equal(tt.slot, d["t"].slot)
    assert torch.equal(tt.store, d["t"].store)
    h, mi = cache.hits, cache.misses
    dist_transpose(d["t"], cache)
    assert (cache.hits - h, cache.misses - mi) == (1, 0)


def test_dist_transpose_inherits_a_skewed_cut_without_exchange(jax_run, port):
    _, out, stats = jax_run
    mesh, m, d = port
    cache = PlanCache()
    t = dist_transpose(d["t_r"], cache)
    _identical(t, out, "t_r")
    perm = transpose_permutation(d["t_r"].coords)
    assert np.array_equal(t.owner, d["t_r"].owner[perm])
    exe = cache.peek(("transpose", _structure_key(d["t_r"])))
    assert list(exe._offsets) == stats["t_r_offsets"] == []
    assert exe.sent_blocks.sum() == 0
    _identical(t.scale(-2.5), out, "t_scaled")


def test_dist_quadrant_slice_and_assemble_match_jax(jax_run, port):
    _, out, stats = jax_run
    mesh, m, d = port
    cache = PlanCache()
    quads = [dist_submatrix(d["s"], *q, cache) for q in QUADS]
    for i, (q, rng) in enumerate(zip(quads, QUADS)):
        _identical(q, out, f"quad{i}")
        ref = submatrix(m["s"], *rng)
        assert np.array_equal(q.coords, ref.coords) and torch.equal(q.gather().data, ref.data)
    r = dist_assemble2x2(*quads, 4, cache)
    _identical(r, out, "asm")
    # slice + glue moved no block between workers
    assert np.array_equal(r.owner, d["s"].owner) and torch.equal(r.gather().data, m["s"].data)
    z01 = dist_zeros(quads[1].shape, 8, mesh)
    z10 = dist_zeros(quads[2].shape, 8, mesh)
    _identical(dist_assemble2x2(quads[0], z01, z10, quads[3], 4, cache), out, "asm_zero")


def test_collectives_plan_cache_counts_match_jax(jax_run, port):
    inp, out, stats = jax_run
    mesh, m, d = port
    cache = PlanCache()
    for x, y, al, be in ADDS.values():
        dist_add(d[x], d[y], al, be, cache)
    dist_trace(d["a"], cache), dist_trace(d["a_r"], cache), dist_trace(d["b"], cache)
    dist_frobenius_norm(d["a"], cache), dist_frobenius_norm(d["a_r"], cache)
    tau = stats["tau"]
    dist_truncate(d["a"], tau, cache), dist_truncate(d["a_r"], tau, cache)
    dist_truncate(d["a"], m["a"].frobenius_norm() * 1.01, cache)
    dist_truncate(d["single"], 1e-6, cache), dist_truncate(d["single"], 1e6, cache)
    dist_truncate_hierarchical(d["a"], tau * 1.5, cache)
    dist_truncate_hierarchical(d["a"], 0.0, cache)
    dist_transpose(d["t"], cache)
    dist_transpose(dist_transpose(d["t"], cache), cache)
    dist_transpose(d["t_r"], cache), dist_transpose(d["t_r"], cache)
    quads = [dist_submatrix(d["s"], *q, cache) for q in QUADS]
    dist_assemble2x2(*quads, 4, cache)
    dist_assemble2x2(quads[0], dist_zeros(quads[1].shape, 8, mesh),
                     dist_zeros(quads[2].shape, 8, mesh), quads[3], 4, cache)
    hits, misses, by_kind = stats["cache"]
    assert (cache.hits, cache.misses) == (hits, misses)
    assert cache.stats()["by_kind"] == by_kind
