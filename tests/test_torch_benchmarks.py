"""The port's benchmark mirrors (``benchmarks/torch_*.py``) against the JAX package's.

* the port's copy of the structure generators equals the reference's array
  for array, at the reference's sizes and at a scaled block size;
* each mirror, run on the CPU at a tiny size, writes a file with every key
  of the reference's BENCH file (plus ``meta.card`` and ``meta.commit``);
* the reference's ``benchmarks/history.py`` reads a port-written file into
  the same metric names as ``benchmarks/torch_history.py``.
"""

import contextlib
import importlib
import json
import os
import pathlib
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "benchmarks"))

import torch_spamm_sequences as tss  # noqa: E402


@contextlib.contextmanager
def _xla_flags_kept():
    """Import a reference benchmark without keeping the 8-device ``XLA_FLAGS``
    it sets at import: this process's JAX must keep seeing one device."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def _reference(name):
    with _xla_flags_kept():
        return importlib.import_module(name)


def _same(ref, port):
    assert np.array_equal(ref.coords, port.coords)
    assert np.array_equal(np.asarray(ref.data), port.data.numpy())
    assert (ref.shape, ref.bs) == (port.shape, port.bs)


FAMILIES = ("banded", "exp-decay", "random-offdiag")


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n,bs", [(1024, 16), (512, 32)])
def test_generators_equal_the_reference(monkeypatch, family, n, bs):
    ss = _reference("spamm_sequences")
    monkeypatch.setattr(ss, "BS", bs)  # the reference's generators read the module's BS
    p = tss.family_params(bs)
    ref = {"banded": lambda: ss.banded(n, p["banded"]),
           "exp-decay": lambda: ss.exp_decay(n, rate=p["exp_decay"]),
           "random-offdiag": lambda: ss.random_offdiag(n, density=p["random_offdiag"])}[family]()
    _same(ref, tss.raw_sequences(n, bs, device="cpu")[family])
    assert tss.family_params(16) == dict(banded=24, exp_decay=0.08, random_offdiag=0.08)
    assert tss.family_params(128) == dict(banded=192, exp_decay=0.01, random_offdiag=0.08)


@pytest.mark.parametrize("n", [256, 512])
def test_sp2_sequences_equal_the_reference(n, one_thread):
    ref = _reference("dist_balance").sequences(n)
    port = tss.sequences(n, device="cpu")
    assert list(ref) == list(port) == list(FAMILIES)
    for k in FAMILIES:
        _same(ref[k], port[k])
    f = port["banded"]
    assert np.allclose(tss.eig_bounds(f), _reference("dist_balance").eig_bounds(ref["banded"]))


def _keytree(x, path=""):
    out = set()
    if isinstance(x, dict):
        for k, v in x.items():
            out.add(f"{path}/{k}")
            out |= _keytree(v, f"{path}/{k}")
    elif isinstance(x, list):
        for v in x:
            if isinstance(v, dict):
                out |= _keytree(v, path + "[]")
    return out


# mirror -> (reference BENCH file, written name, tiny sizes patched over ``sizes``)
TINY = {
    "torch_dist_balance": ("BENCH_balance.json", "balance", (128, 16, 6)),
    "torch_locality": ("BENCH_locality.json", "locality", (128, 16, 6)),
    "torch_trace_overhead": ("BENCH_trace.json", "trace", (64, 16, 1, 1)),
    "torch_kernel_micro": ("BENCH_kernel.json", "kernel",
                           dict(bs=16, T=16, spg_n=256, spg_bs=32, row_T=8, row_nout=4,
                                engine_T=16)),
    "torch_dist_purify": (None, "purify", (128, 32, 40)),
    "torch_dist_inverse": (None, "inverse", (64, 16)),
    "torch_spamm_sequences": (None, "spamm", (128, 16)),
}


@pytest.fixture
def one_thread():
    """The mirrors run thousands of tiny torch ops: with every test worker's
    intra-op pool spinning on the same cores they run tens of times slower."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_mirror(name, tmp_path, monkeypatch):
    mod = importlib.import_module(name)
    sizes = TINY[name][2]
    monkeypatch.setattr(mod, "sizes", lambda args: sizes)
    out = tmp_path / f"BENCH_{TINY[name][1]}_torch.json"
    assert mod.main(["--device", "cpu", "--smoke", "--out", str(out)]) == 0
    return json.loads(out.read_text()), str(out)


@pytest.mark.parametrize("name", sorted(TINY))
def test_mirror_writes_the_reference_key_tree(name, tmp_path, monkeypatch, one_thread):
    data, path = _run_mirror(name, tmp_path, monkeypatch)
    meta = data["meta"]
    assert meta["card"] == "cpu" and meta["commit"] and meta["size"] == "smoke"
    ref_file = TINY[name][0]
    if ref_file is not None:
        want = _keytree(json.loads((ROOT / ref_file).read_text()))
        # the port's memory meter reads the card's allocator where the JAX
        # package's read jax's
        want = {k.replace("/memory/jax", "/memory/cuda") for k in want}
        missing = want - _keytree(data)
        assert not missing, sorted(missing)
    port_hist = importlib.import_module("torch_history")
    entries = port_hist.entries_from_bench_json(path, ts=1.0, commit="x")
    assert entries and all(e["meta"]["card"] == "cpu" for e in entries)
    if ref_file is not None:
        # the reference's extractor reads the port's file into the same names
        ref_hist = _reference("history")
        ref_entries = ref_hist.entries_from_bench_json(path, ts=1.0, commit="x")
        assert [(e["bench"], e["config"]) for e in ref_entries] == \
            [(e["bench"], e["config"]) for e in entries]
        for r, p in zip(ref_entries, entries):
            assert set(r["metrics"]) == set(p["metrics"]) - {"engines_bit_identical"}
            assert all(r["metrics"][k] == p["metrics"][k] for k in r["metrics"])
