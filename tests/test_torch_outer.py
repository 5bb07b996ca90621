"""The port's outer-product schedule against the JAX package's.

``make_outer_plan``, ``plan_outer_stats`` and ``choose_schedule`` are numpy
in both packages and are held equal array for array in this process.  The
JAX package's ``dist_spgemm_outer`` needs one device per worker, so it runs
once per module in a subprocess with 8 host devices (``impl="ref"``); the
port runs the same numpy inputs here on ``make_worker_mesh(P, "cpu")``,
where ``block_spmm`` takes its plain version.

Held to: plans, stats and schedule choices exactly; C blocks within
``gemm_tolerance`` (1e-5 of the summed ``||A_t||_F ||B_t||_F`` of each
block's tasks), against the JAX package and against the port's own p2p
multiply of the same operands, since the three sum each block's products
in different orders.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from helpers import banded_matrix, random_block_matrix  # noqa: E402
from repro.core import outer as jouter  # noqa: E402
from repro_torch.core import outer as touter  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    OuterSpgemmExecutable,
    dist_spgemm,
    dist_spgemm_outer,
    make_worker_mesh,
    outer_accumulate_table,
    shard_stores,
    unshard_result,
)
from repro_torch.core.schedule import make_spgemm_plan  # noqa: E402
from repro_torch.kernels import block_spmm  # noqa: E402
from torch_parity import assert_blocks_within, gemm_tolerance  # noqa: E402

BS = 8


def _cases() -> dict:
    """name -> (a_coords, b_coords, a_data, b_data, nparts)."""
    rng = np.random.default_rng(5)
    out = {}
    for name, m in (("banded", banded_matrix(128, 12, BS, seed=0)),
                    ("random", random_block_matrix(128, BS, 0.3, seed=1))):
        data = np.asarray(m.data)
        for P in (3, 8):
            out[f"{name}_p{P}"] = (m.coords, m.coords, data, data, P)
    # two C blocks over three workers: one worker owns no C block
    diag = np.array([[0, 0], [1, 1]])
    d = rng.standard_normal((2, BS, BS)).astype(np.float32)
    out["no_c_block"] = (diag, diag, d, d, 3)
    # A's only block column is 0, B's only block row is 1: no task at all
    a, b = np.array([[0, 0], [1, 0]]), np.array([[1, 0], [1, 1]])
    out["empty"] = (a, b, d, rng.standard_normal((2, BS, BS)).astype(np.float32), 3)
    return out


_JAX_SCRIPT = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.core.outer import make_outer_plan
from repro.core.distributed import dist_spgemm_outer, make_worker_mesh

assert jax.device_count() == 8, jax.device_count()
inp = dict(np.load(sys.argv[1]))
out = {}
for name in sorted({k.split("/")[0] for k in inp}):
    a, b, ad, bd = (inp[f"{name}/{k}"] for k in ("a", "b", "ad", "bd"))
    P = int(inp[f"{name}/P"])
    plan = make_outer_plan(a, b, P, ad.shape[1])
    out[name] = np.asarray(dist_spgemm_outer(plan, jnp.asarray(ad), jnp.asarray(bd),
                                             make_worker_mesh(P), impl="ref"))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_outer(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("outer")
    flat = {}
    for name, (a, b, ad, bd, P) in _cases().items():
        flat.update({f"{name}/a": a, f"{name}/b": b, f"{name}/ad": ad, f"{name}/bd": bd,
                     f"{name}/P": np.array(P)})
    np.savez(tmp / "in.npz", **flat)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(tmp / "in.npz"),
                           str(tmp / "out.npz")], env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(tmp / "out.npz"))


def _assert_plans_equal(got, want):
    for f in dataclasses.fields(want):
        x, y = getattr(want, f.name), getattr(got, f.name)
        if f.name == "tasks":
            for k in ("a_idx", "b_idx", "c_idx", "c_coords"):
                assert np.array_equal(getattr(x, k), getattr(y, k)), k
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        elif isinstance(x, dict):
            assert x.keys() == y.keys(), f.name
            for k in x:
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), (f.name, k)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("name", ["banded_p3", "banded_p8", "random_p3", "random_p8",
                                  "no_c_block", "empty"])
def test_outer_plan_stats_and_choice_match_jax(name):
    a, b, ad, _, P = _cases()[name]
    got, want = touter.make_outer_plan(a, b, P, BS), jouter.make_outer_plan(a, b, P, BS)
    _assert_plans_equal(got, want)
    assert touter.plan_outer_stats(got) == jouter.plan_outer_stats(want)
    kind, _, stats = touter.choose_schedule(a, b, P, BS)
    jkind, _, jstats = jouter.choose_schedule(a, b, P, BS)
    assert (kind, stats) == (jkind, jstats)


@given(nparts=st.integers(2, 9), density=st.floats(0.1, 0.6), seed=st.integers(0, 20))
@settings(max_examples=15, deadline=None)
def test_outer_partials_reach_owner_exactly_once_like_jax(nparts, density, seed):
    """The port's plan equals the JAX package's, and every (producer,
    C-block) partial reaches its owner exactly once — locally or through
    exactly one send slot — so the accumulate table has one column entry per
    partial and none twice."""
    a = random_block_matrix(96, 8, density, seed)
    if a.nnzb == 0:
        return
    plan = touter.make_outer_plan(a.coords, a.coords, nparts, 8)
    _assert_plans_equal(plan, jouter.make_outer_plan(a.coords, a.coords, nparts, 8))
    deliveries = np.zeros(plan.c_coords.shape[0], dtype=int)
    produced = np.zeros(plan.c_coords.shape[0], dtype=int)
    for src in range(nparts):
        g = plan.partial_c_global[src][plan.partial_valid[src]]
        np.add.at(produced, g, 1)
        np.add.at(deliveries, g[plan.c_owner[g] == src], 1)
        for d in plan.offsets:
            cnt = plan.send_count[d][src]
            np.add.at(deliveries, plan.partial_c_global[src][plan.send[d][src][:cnt]], 1)
    assert np.array_equal(deliveries, produced)
    table = outer_accumulate_table(plan)
    zero_row = plan.acc_cap
    assert int((table != zero_row).sum()) == int(produced.sum())


def _port_run(name, impl="auto"):
    a, b, ad, bd, P = _cases()[name]
    plan = touter.make_outer_plan(a, b, P, BS)
    mesh = make_worker_mesh(P, "cpu")
    c = dist_spgemm_outer(plan, torch.tensor(ad), torch.tensor(bd), mesh, impl=impl)
    return plan, c


@pytest.mark.parametrize("name", ["banded_p3", "banded_p8", "random_p3", "random_p8",
                                  "no_c_block", "empty"])
def test_dist_spgemm_outer_matches_jax_and_the_p2p_multiply(jax_outer, name):
    a, b, ad, bd, P = _cases()[name]
    plan, c = _port_run(name)
    want = jax_outer[name]
    assert c.shape == want.shape and c.dtype == torch.float32
    t = plan.tasks
    if t.num_out == 0:  # no task, no C block: the padded stores are zeros
        assert not c.any() and not want.any()
        return
    tol = gemm_tolerance(ad, bd, t.a_idx, t.b_idx, t.c_idx, t.num_out)
    got = unshard_result(plan, c, (128, 128), BS)
    ref = unshard_result(plan, torch.from_numpy(want), (128, 128), BS)
    assert np.array_equal(got.coords, t.c_coords)
    assert_blocks_within(got.data.numpy(), ref.data.numpy(), tol)
    # the owner-computes multiply of the same operands
    p2p = make_spgemm_plan(a, b, P, BS)
    ap, bp = torch.tensor(ad), torch.tensor(bd)
    c2 = unshard_result(p2p, dist_spgemm(p2p, ap, bp, make_worker_mesh(P, "cpu")), (128, 128), BS)
    assert np.array_equal(c2.coords, got.coords)
    assert_blocks_within(got.data.numpy(), c2.data.numpy(), tol)
    # padding slots of the C stores stay zero
    assert not c[torch.from_numpy(~plan.c_store_valid)].any()


def test_outer_executable_is_one_launch_repeatable_and_ref_equal():
    """On the CPU ``"auto"`` takes the plain version and launches nothing;
    ``"ref"`` computes the same bits; a second call repeats them; the
    kernel route raises off the card instead of falling back."""
    plan, c = _port_run("random_p8")
    a, b, ad, bd, P = _cases()["random_p8"]
    mesh = make_worker_mesh(P, "cpu")
    stores = shard_stores(plan, torch.tensor(ad), torch.tensor(bd))
    before = block_spmm.launches
    exe = OuterSpgemmExecutable(plan, mesh)
    assert torch.equal(exe(*stores), c) and torch.equal(exe(*stores), c)
    assert torch.equal(OuterSpgemmExecutable(plan, mesh, impl="ref")(*stores), c)
    assert block_spmm.launches == before
    with pytest.raises(ValueError):
        OuterSpgemmExecutable(plan, mesh, impl="kernel")(*stores)
    with pytest.raises(ValueError):
        OuterSpgemmExecutable(plan, mesh, impl="fused")
    with pytest.raises(Exception, match="mesh"):
        OuterSpgemmExecutable(plan, make_worker_mesh(P - 1, "cpu"))


def test_accumulate_sums_each_slot_in_acc_idx_order():
    """The accumulate equals a sequential sum over each worker's ``acc_idx``
    positions in ascending order — the reference's segment_sum — bit for bit."""
    plan, c = _port_run("banded_p8")
    a, b, ad, bd, P = _cases()["banded_p8"]
    mesh = make_worker_mesh(P, "cpu")
    exe = OuterSpgemmExecutable(plan, mesh)
    partials = exe.partials(*shard_stores(plan, torch.tensor(ad), torch.tensor(bd)))
    buf = torch.cat([partials, *exe.exchange(partials)], dim=1)
    want = torch.zeros_like(c)
    for p in range(P):
        for k, slot in enumerate(plan.acc_idx[p]):
            if slot < plan.c_cap:
                want[p, slot] += buf[p, k]
    assert torch.equal(c, want)
    assert len(plan.offsets) > 1  # the exchange ran several rounds
