"""The port's scheduler against the JAX package's: every plan array equal.

``repro_torch.core.schedule`` is the JAX package's numpy module carried
over, so placement, exchange rounds, task layouts, the fused ``(src, off)``
decomposition and the byte accounting must agree exactly, for every mode.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import repro.core.schedule as js  # noqa: E402
import repro.core.spgemm as jsp  # noqa: E402
import repro_torch.core.schedule as ts  # noqa: E402
import repro_torch.core.spgemm as tsp  # noqa: E402
from torch_parity import structures  # noqa: E402

STRUCTURES = structures()


def _equal(x, y, where: str):
    if isinstance(x, np.ndarray):
        assert isinstance(y, np.ndarray) and x.dtype == y.dtype, where
        assert x.shape == y.shape and np.array_equal(x, y), where
    elif isinstance(x, dict):
        assert isinstance(y, dict) and list(x) == list(y), where
        for k in x:
            _equal(x[k], y[k], f"{where}[{k!r}]")
    elif isinstance(x, (list, tuple)):
        assert type(x) is type(y) and len(x) == len(y), where
        for i, (u, v) in enumerate(zip(x, y)):
            _equal(u, v, f"{where}[{i}]")
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            _equal(getattr(x, f.name), getattr(y, f.name), f"{where}.{f.name}")
    else:
        assert x == y, (where, x, y)


def _plans(na, nb, nparts, **kw):
    a, b = STRUCTURES[na], STRUCTURES[nb]
    return (ts.make_spgemm_plan(a.coords, b.coords, nparts, a.bs, **kw),
            js.make_spgemm_plan(a.coords, b.coords, nparts, a.bs, **kw))


CASES = [
    ("banded", "banded", 8, dict()),
    ("banded", "banded", 3, dict(placement="random", seed=4)),
    ("banded", "banded", 8, dict(exchange="allgather")),
    ("random", "banded", 5, dict()),
    ("seq_exp_decay", "seq_exp_decay", 8, dict(align_subtrees=False)),
    ("seq_random_offdiag", "seq_banded", 4, dict(placement="random", exchange="allgather")),
    ("spd_banded", "spd_banded", 1, dict()),
    ("banded", "banded", 16, dict()),  # more workers than some structures have blocks per row
]


@pytest.mark.parametrize("na,nb,nparts,kw", CASES, ids=[f"{c[0]}-{c[1]}-P{c[2]}-{i}" for i, c in enumerate(CASES)])
def test_plans_equal_array_for_array(na, nb, nparts, kw):
    port, ref = _plans(na, nb, nparts, **kw)
    _equal(port, ref, "plan")
    _equal(ts.plan_stats(port), js.plan_stats(ref), "plan_stats")
    _equal(ts.plan_worker_bytes(port), js.plan_worker_bytes(ref), "plan_worker_bytes")
    _equal(ts.plan_byte_provenance(port), js.plan_byte_provenance(ref), "plan_byte_provenance")


@pytest.mark.parametrize("seed", [0, 1])
def test_pinned_owners_and_pruned_tasks(seed):
    a = STRUCTURES["banded"]
    rng = np.random.default_rng(seed)
    nparts = 6
    a_owner = rng.integers(0, nparts, a.nnzb).astype(np.int32)
    b_owner = np.sort(rng.integers(0, nparts, a.nnzb)).astype(np.int32)
    full_t = tsp.spgemm_symbolic(a.coords, a.coords)
    full_j = jsp.spgemm_symbolic(a.coords, a.coords)
    keep = rng.random(full_t.num_tasks) < 0.5
    pruned_t = tsp._prune_tasks(full_t, keep)
    pruned_j = jsp._prune_tasks(full_j, keep)
    _equal(pruned_t, pruned_j, "pruned tasks")
    kw = dict(a_owner=a_owner, b_owner=b_owner)
    for tasks_t, tasks_j in ((None, None), (pruned_t, pruned_j)):
        port = ts.make_spgemm_plan(a.coords, a.coords, nparts, a.bs, tasks=tasks_t, **kw)
        ref = js.make_spgemm_plan(a.coords, a.coords, nparts, a.bs, tasks=tasks_j, **kw)
        _equal(port, ref, "plan")
        _equal(ts.plan_stats(port), js.plan_stats(ref), "plan_stats")


def test_partitions_and_fetch_plans_equal():
    a = STRUCTURES["seq_exp_decay"]
    rng = np.random.default_rng(3)
    w = rng.random(a.nnzb) * 5
    align = ts.subtree_boundaries(a.coords)
    _equal(align, js.subtree_boundaries(a.coords), "subtree_boundaries")
    assert ts.subtree_boundaries(a.coords[::-1]) is None
    for nparts in (1, 3, 7):
        for weights, al in ((None, None), (w, None), (w, align), (None, align)):
            _equal(ts.partition_morton(a.nnzb, nparts, weights, align=al),
                   js.partition_morton(a.nnzb, nparts, weights, align=al), "partition_morton")
        _equal(ts.partition_random(a.nnzb, nparts, seed=nparts),
               js.partition_random(a.nnzb, nparts, seed=nparts), "partition_random")
    owner = js.partition_morton(a.nnzb, 4)
    slot_t, stores_t = ts._owner_slots(owner, 4)
    slot_j, stores_j = js._owner_slots(owner, 4)
    _equal((slot_t, stores_t), (slot_j, stores_j), "_owner_slots")
    needs = [np.unique(rng.integers(0, a.nnzb, 30)) for _ in range(4)]
    ft = ts.plan_fetch(owner, slot_t, needs, 4)
    fj = js.plan_fetch(owner, slot_j, needs, 4)
    _equal(ft, fj, "plan_fetch")
    offsets, send_pad, _, recv_pos = ft
    for dev in range(4):
        for g in needs[dev]:
            assert (ts.local_fetch_index(owner, slot_t, offsets, send_pad, recv_pos, 9, g, dev)
                    == js.local_fetch_index(owner, slot_j, offsets, send_pad, recv_pos, 9, g, dev))


def test_split_local_indices_equal():
    rng = np.random.default_rng(5)
    caps = [4, 0, 7, 2]
    idx = rng.integers(0, 10 + sum(caps), (3, 40))
    _equal(ts.split_local_indices(idx, 10, caps), js.split_local_indices(idx, 10, caps),
           "split_local_indices")
    src, off = ts.split_local_indices(idx, 10, caps)
    starts = np.concatenate([[0], 10 + np.cumsum([0] + caps[:-1])])
    assert np.array_equal(np.where(src == 0, off, starts[src] + off), idx)


def test_bad_pinned_owner_maps_raise():
    from repro_torch.analysis.errors import PlanError

    a = STRUCTURES["banded"]
    with pytest.raises(PlanError):
        ts.make_spgemm_plan(a.coords, a.coords, 4, a.bs, a_owner=np.zeros(3, np.int32),
                            b_owner=np.zeros(a.nnzb, np.int32))
    with pytest.raises(PlanError):
        ts.make_spgemm_plan(a.coords, a.coords, 4, a.bs, a_owner=np.full(a.nnzb, 4, np.int32),
                            b_owner=np.zeros(a.nnzb, np.int32))
