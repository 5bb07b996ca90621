"""The port's fused leaf engine (plain version) against the JAX package's.

The JAX side runs its jnp/segment-sum reference and its Pallas kernel in
interpret mode on one worker's operands; the port's engine takes all
workers at once, with a leading worker axis.  Values agree within
``torch_parity.gemm_tolerance`` (rel 1e-5: the packages sum in other
orders); inside the port, fused and staged plain versions agree bit for bit
in fp32, and the mixed-precision errors stay within their analytic bounds.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.kernels.fused_leaf as jfl  # noqa: E402
import repro.kernels.precision as jprec  # noqa: E402
from repro.kernels.ops import fused_block_spmm as j_fused_ops  # noqa: E402
import repro_torch.kernels.fused_leaf as tfl  # noqa: E402
import repro_torch.kernels.precision as tprec  # noqa: E402
from repro_torch.kernels import block_spmm as tbsp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from torch_parity import assert_blocks_within, gemm_tolerance  # noqa: E402


def _problem(seed, P=3, T=30, cap=6, rounds=2, cap_u=5, bs=(16, 16, 16), num_out=7,
             empty=(2,), dtype=np.float32):
    """Random fused-engine operands for P workers, host numpy, with sorted task_c
    (rows in ``empty`` get no task) and a trailing trash slot ``num_out`` for
    two padded tasks per worker."""
    rng = np.random.default_rng(seed)
    bm, bk, bn = bs
    R = max(rounds, 1)
    cu = cap_u if rounds else 1
    d = dict(
        a_store=rng.standard_normal((P, cap, bm, bk)).astype(dtype),
        b_store=rng.standard_normal((P, cap, bk, bn)).astype(dtype),
        a_recv=rng.standard_normal((P, R, cu, bm, bk)).astype(dtype),
        b_recv=rng.standard_normal((P, R, cu, bk, bn)).astype(dtype),
        num_out=num_out, cap=cap, cap_u=cu, rounds=rounds,
    )
    rows = np.setdiff1d(np.arange(num_out), empty)
    for x in ("a", "b"):
        src = rng.integers(0, rounds + 1, (P, T + 2))
        off = np.where(src == 0, rng.integers(0, cap, (P, T + 2)), rng.integers(0, cu, (P, T + 2)))
        d[f"{x}_src"], d[f"{x}_off"] = src.astype(np.int32), off.astype(np.int32)
    c = np.sort(rng.choice(rows, (P, T)), axis=1) if T else np.zeros((P, 0), np.int64)
    d["task_c"] = np.concatenate([c, np.full((P, 2), num_out)], axis=1).astype(np.int32)
    d["low"] = rng.random((P, T + 2)) < 0.5
    return d


def _port_args(d, dtype=torch.float32):
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dtype)  # noqa: E731
    i = lambda x: torch.from_numpy(np.asarray(x, np.int64))  # noqa: E731
    run_ptr = i(tfl.fused_task_runs(d["task_c"], d["num_out"]))
    return (t(d["a_store"]), t(d["a_recv"]), t(d["b_store"]), t(d["b_recv"]),
            i(d["a_src"]), i(d["a_off"]), i(d["b_src"]), i(d["b_off"]), run_ptr, d["num_out"])


def _jax_ref(d, p, *, c=None, low=None, adaptive=False, interpret=False):
    """The JAX package's fused engine on worker p (trash row included, sliced off)."""
    args = [jnp.asarray(d[k][p]) for k in ("a_store", "a_recv", "b_store", "b_recv")]
    idx = [jnp.asarray(d[k][p]) for k in ("a_src", "a_off", "b_src", "b_off")]
    c = jnp.asarray(d["task_c"][p] if c is None else c)
    lo = None if low is None else jnp.asarray(low.astype(np.int32))
    if interpret:
        out = j_fused_ops(*args, *idx, c, d["num_out"] + 1, low=lo, adaptive=adaptive,
                          interpret=True)
    else:
        out = jfl.fused_block_spmm_ref(*args, *idx, c, lo, num_out=d["num_out"] + 1,
                                       adaptive=adaptive)
    return np.asarray(out)[: d["num_out"]]


def _staged(d, p):
    """Worker p's operands as the staged path lays them out: concatenated
    ``[own | recv rounds]`` buffers and linear indices."""
    cat = {}
    for x in ("a", "b"):
        store, recv = d[f"{x}_store"][p], d[f"{x}_recv"][p]
        cat[x] = np.concatenate([store, recv.reshape(-1, *recv.shape[2:])])
        src, off = d[f"{x}_src"][p], d[f"{x}_off"][p]
        cat[f"{x}_lin"] = np.where(src == 0, off, d["cap"] + (src - 1) * d["cap_u"] + off)
    return cat


def _tolerance(d, p, keep=None):
    cat = _staged(d, p)
    n = d["task_c"].shape[1] - 2
    sel = np.arange(n) if keep is None else np.nonzero(keep[:n])[0]
    return gemm_tolerance(cat["a"], cat["b"], cat["a_lin"][sel], cat["b_lin"][sel],
                          d["task_c"][p][sel], d["num_out"])


@pytest.mark.parametrize("bs", [(16, 16, 16), (24, 24, 24), (16, 32, 8)])
def test_plain_version_matches_jax_reference(bs):
    d = _problem(1, bs=bs)
    got = tfl.fused_block_spmm_ref(*_port_args(d)).numpy()
    assert got.shape == (3, d["num_out"], bs[0], bs[2])
    for p in range(3):
        assert_blocks_within(got[p], _jax_ref(d, p), _tolerance(d, p))
    assert not got[:, 2].any()  # the row no task writes is zero


def test_plain_version_matches_pallas_kernel_interpret():
    d = _problem(2, P=2, T=12, num_out=5, empty=())
    got = tfl.fused_block_spmm_ref(*_port_args(d)).numpy()
    for p in range(2):
        assert_blocks_within(got[p], _jax_ref(d, p, interpret=True), _tolerance(d, p))


def test_fused_plain_bit_identical_to_staged_plain():
    d = _problem(3, P=4)
    fused = tfl.fused_block_spmm_ref(*_port_args(d))
    # the staged plain version over the concatenated buffers, one flat task
    # list over the workers (as repro_torch.core.distributed lays it out)
    cats = [_staged(d, p) for p in range(4)]
    L = cats[0]["a"].shape[0]
    n = d["task_c"].shape[1] - 2
    flat = lambda k: np.concatenate([p * L + cats[p][k][:n] for p in range(4)])  # noqa: E731
    c = np.concatenate([p * d["num_out"] + d["task_c"][p][:n] for p in range(4)])
    a_all = torch.from_numpy(np.concatenate([x["a"] for x in cats]))
    b_all = torch.from_numpy(np.concatenate([x["b"] for x in cats]))
    staged = tops.block_spmm(a_all, b_all, flat("a_lin"), flat("b_lin"), c, 4 * d["num_out"],
                             impl="ref")
    assert torch.equal(fused.reshape(staged.shape), staged)


def test_masked_tasks_contribute_nothing_even_mid_run():
    d = _problem(4, P=3, T=40)
    rng = np.random.default_rng(9)
    on = rng.random(d["task_c"].shape) < 0.6
    on[:, 1:4] = [False, True, False]  # masks inside the first runs
    args = _port_args(d)
    got = tfl.fused_block_spmm_ref(*args, on=torch.from_numpy(on))
    all_on = tfl.fused_block_spmm_ref(*args, on=torch.ones(on.shape, dtype=torch.bool))
    assert torch.equal(all_on, tfl.fused_block_spmm_ref(*args))
    for p in range(3):
        keep = on[p]
        # the same sum with the off tasks dropped from the list
        dd = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in d.items()}
        sel = np.concatenate([np.nonzero(keep[:-2])[0], [len(keep) - 2, len(keep) - 1]])
        for k in ("a_src", "a_off", "b_src", "b_off", "task_c"):
            dd[k] = d[k][p : p + 1, sel]
        for k in ("a_store", "a_recv", "b_store", "b_recv"):
            dd[k] = d[k][p : p + 1]
        dropped = tfl.fused_block_spmm_ref(*_port_args(dd))[0]
        assert torch.equal(got[p], dropped)
        # the JAX package's trash-row redirect gives the same sums
        c_redirect = np.where(keep, d["task_c"][p], d["num_out"])
        assert_blocks_within(got[p].numpy(), _jax_ref(d, p, c=c_redirect), _tolerance(d, p, keep))


@pytest.mark.parametrize("mode", ["bf16", "adaptive"])
def test_mixed_precision_within_analytic_bound(mode):
    d = _problem(5, P=2, T=40)
    args = list(_port_args(d))
    exact = tfl.fused_block_spmm_ref(*args).double()
    low = torch.from_numpy(d["low"])
    if mode == "bf16":
        for i in range(4):
            args[i] = args[i].to(torch.bfloat16)
        got = tfl.fused_block_spmm_ref(*args)
        low_np = np.ones_like(d["low"])
    else:
        got = tfl.fused_block_spmm_ref(*args, low=low, adaptive=True)
        low_np = d["low"]
        for p in range(2):  # the JAX package rounds the same elements the same way
            assert_blocks_within(got[p].numpy(), _jax_ref(d, p, low=d["low"][p], adaptive=True),
                                 _tolerance(d, p))
    n = d["task_c"].shape[1] - 2
    for p in range(2):
        cat = _staged(d, p)
        na = np.linalg.norm(cat["a"].astype(np.float64), axis=(1, 2))[cat["a_lin"][:n]]
        nb = np.linalg.norm(cat["b"].astype(np.float64), axis=(1, 2))[cat["b_lin"][:n]]
        bound = tprec.ROUND2_BOUND * float((na * nb)[low_np[p, :n]].sum())
        err = float(torch.linalg.norm((got[p].double() - exact[p]).flatten()))
        assert 0 < err <= bound + 1e-5 * float((na * nb).sum()), (err, bound)


def test_no_rounds_and_empty_runs():
    d = _problem(6, P=2, T=10, rounds=0, num_out=6, empty=(0, 5))
    got = tfl.fused_block_spmm_ref(*_port_args(d)).numpy()
    for p in range(2):
        assert_blocks_within(got[p], _jax_ref(d, p), _tolerance(d, p))
    assert not got[:, [0, 5]].any()
    e = _problem(7, P=2, T=0, num_out=3, empty=())
    assert not tfl.fused_block_spmm_ref(*_port_args(e)).any()


def test_dispatch_takes_the_plain_version_on_the_cpu():
    d = _problem(8)
    tfl.launches = 0
    got = tops.fused_block_spmm(*_port_args(d))
    assert torch.equal(got, tfl.fused_block_spmm_ref(*_port_args(d)))
    assert tfl.launches == 0
    with pytest.raises(ValueError):  # the kernel itself refuses a CPU tensor
        tfl.fused_block_spmm_cuda(*_port_args(d))


def test_task_runs_and_hazard_equal_reference():
    rng = np.random.default_rng(10)
    for c in (np.array([0, 0, 1, 3, 3]), np.array([0, 2, 1, 3]), np.array([4]), np.zeros(0, int),
              np.sort(rng.integers(0, 9, 50)), rng.integers(0, 9, 50)):
        assert tfl.first_accumulation_hazard(c) == jfl.first_accumulation_hazard(c)
    runs = tfl.fused_task_runs(np.array([[0, 0, 2, 5, 5], [1, 1, 1, 1, 5]]), 5)
    assert runs.tolist() == [[0, 2, 2, 3, 3, 3], [0, 0, 4, 4, 4, 4]]
    with pytest.raises(ValueError):
        tfl.fused_task_runs(np.array([[0, 2, 1]]), 3)


def test_precision_policy_and_low_mask_equal_reference():
    rng = np.random.default_rng(11)
    assert tprec.ROUND2_BOUND == jprec.ROUND2_BOUND and tprec.EPS_BF16 == jprec.EPS_BF16
    for mode, tau in (("fp32", 0.0), ("bf16", 0.0), ("adaptive", 0.3)):
        assert tprec.Precision(mode, tau).key() == jprec.Precision(mode, tau).key()
    na, nb = rng.random(20), rng.random(15)
    a_idx, b_idx = rng.integers(0, 20, 200), rng.integers(0, 15, 200)
    eligible = rng.random(200) < 0.7
    for budget in (0.0, 1e-3, 0.05, 10.0):
        for el in (None, eligible):
            mt, st = tprec.low_precision_task_mask(na, nb, a_idx, b_idx, budget, eligible=el)
            mj, sj = jprec.low_precision_task_mask(na, nb, a_idx, b_idx, budget, eligible=el)
            assert np.array_equal(mt, mj) and st == sj
