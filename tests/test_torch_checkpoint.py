"""The port's checkpoints: mirrors of ``tests/test_checkpoint.py`` (round trip,
torn write, clean-up with async saves, bitwise restart), and what a mutable
tensor adds: an async save snapshots the state before the caller changes it
in place, and a bf16 state round-trips bit for bit."""

import json
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import reduced_config
from repro_torch.data import TokenPipeline
from repro_torch.models import model as model_mod
from repro_torch.tree import tree_leaves


def _state():
    return {
        "params": {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(4),
                   "layers": [{"q": torch.full((2, 2), 3.0)}]},
        "opt": {"mu": {"w": torch.zeros((3, 4)), "b": torch.zeros(4)},
                "count": torch.tensor(7, dtype=torch.int32)},
        "step": torch.tensor(42, dtype=torch.int32),
    }


def _assert_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_roundtrip(tmp_path):
    s = _state()
    save_checkpoint(str(tmp_path), 42, s)
    restored, step = restore_checkpoint(str(tmp_path), s)
    assert step == 42
    _assert_equal(s, restored)
    manifest = json.loads((tmp_path / "step_00000042" / "MANIFEST.json").read_text())
    assert "params/layers/0/q" in manifest["keys"] and manifest["step"] == 42


def test_torn_write_ignored(tmp_path):
    s = _state()
    save_checkpoint(str(tmp_path), 1, s)
    # simulate a crash mid-save: step dir without manifest
    torn = tmp_path / "step_00000002"
    torn.mkdir()
    (torn / "arrays.npz").write_bytes(b"garbage")
    assert latest_step(str(tmp_path)) == 1
    restored, step = restore_checkpoint(str(tmp_path), s)
    assert step == 1


def test_manager_gc_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    s = _state()
    for step in [1, 2, 3, 4]:
        mgr.save(step, s)
    mgr.wait()
    mgr._gc()
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(tmp_path) if n.startswith("step_")
    )
    assert steps == [3, 4]


def test_async_save_keeps_the_snapshot_taken_at_save(tmp_path):
    """``torch.Tensor.numpy`` shares a CPU tensor's memory: the snapshot must copy."""
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    s = _state()
    want = [t.clone() for t in tree_leaves(s)]
    mgr.save(5, s)
    for t in tree_leaves(s):  # the caller moves on and changes its state in place
        t.add_(1)
    mgr.wait()
    restored, _ = mgr.restore_latest(s)
    for x, y in zip(tree_leaves(restored), want):
        assert torch.equal(x, y)


def test_bf16_state_round_trips_exactly(tmp_path):
    s = _state()
    s["params"]["w"] = torch.randn(3, 4).to(torch.bfloat16)
    s["opt"]["master"] = {"w": torch.randn(3, 4)}
    save_checkpoint(str(tmp_path), 3, s)
    with np.load(tmp_path / "step_00000003" / "arrays.npz") as z:
        assert z["params/w"].dtype == np.float32
    restored, _ = restore_checkpoint(str(tmp_path), s)
    _assert_equal(s, restored)


def test_restore_rejects_another_shape(tmp_path):
    s = _state()
    save_checkpoint(str(tmp_path), 1, s)
    s["params"]["b"] = torch.ones(5)
    with pytest.raises(ValueError, match="params/b"):
        restore_checkpoint(str(tmp_path), s)


def test_restart_is_bitwise_identical(tmp_path):
    """Train 6 steps straight vs train 3 + checkpoint + restore + 3 more."""
    cfg = reduced_config("qwen2-0.5b")
    pipe = TokenPipeline(cfg, batch=4, seq=16, seed=0)
    step_fn = model_mod.make_train_step(cfg, compute_dtype=torch.float32)

    def run(state, start, n):
        for i in range(start, start + n):
            state, _ = step_fn(state, pipe.global_batch(i))
        return state

    straight = run(model_mod.init_train_state(cfg, seed=0, device="cpu"), 0, 6)

    s1 = run(model_mod.init_train_state(cfg, seed=0, device="cpu"), 0, 3)
    save_checkpoint(str(tmp_path), 3, s1)
    restored, st = restore_checkpoint(str(tmp_path), s1)
    assert st == 3
    resumed = run(restored, 3, 3)
    _assert_equal(straight, resumed)
