"""The port's training runtime: mirrors of ``tests/test_fault_tolerance.py``
(retries, exhaustion, straggler, injected failures, restart from a
checkpoint) and the training CLI on the CPU, killed and resumed."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.data import TokenPipeline
from repro_torch.models import model as model_mod
from repro_torch.runtime import StragglerDetector, TrainLoop, run_with_retries
from repro_torch.tree import tree_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _assert_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert torch.equal(x, y)


def test_run_with_retries_recovers():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return 42

    failures = []
    out = run_with_retries(flaky, max_retries=5, on_failure=lambda k, e: failures.append(k))
    assert out == 42 and len(failures) == 2


def test_run_with_retries_exhausts():
    def dead():
        raise RuntimeError("permanent")

    with pytest.raises(RuntimeError):
        run_with_retries(dead, max_retries=2)


def test_straggler_detector():
    det = StragglerDetector(alpha=0.5, threshold=2.0)
    for _ in range(5):
        assert not det.observe(1.0)
    assert det.observe(5.0)  # 5x ewma
    assert det.events == 1
    # ewma not poisoned by the straggler
    assert det.ewma == pytest.approx(1.0)


def test_train_loop_with_injected_failures(tmp_path):
    cfg = reduced_config("qwen2-0.5b")
    pipe = TokenPipeline(cfg, batch=4, seq=16, seed=0)
    inner = model_mod.make_train_step(cfg, compute_dtype=torch.float32)
    fail_at = {"steps": {2, 5}}

    def flaky_step(state, batch):
        step = int(state["step"])
        if step in fail_at["steps"]:
            fail_at["steps"].discard(step)
            raise RuntimeError(f"injected failure at step {step}")
        return inner(state, batch)

    loop = TrainLoop(flaky_step, pipe, str(tmp_path), ckpt_every=4, max_retries=2)
    state = model_mod.init_train_state(cfg, seed=0, device="cpu")
    state, hist = loop.run(state, 0, 8, log_every=100, log=lambda *_: None)
    assert loop.retries == 2
    assert len(hist) == 8 and len(loop.step_seconds) == 8
    # continuation after retries matches failure-free run exactly
    clean = model_mod.init_train_state(cfg, seed=0, device="cpu")
    for i in range(8):
        clean, _ = inner(clean, pipe.global_batch(i))
    _assert_equal(clean, state)


def test_train_loop_restart_from_checkpoint(tmp_path):
    cfg = reduced_config("olmo-1b")
    pipe = TokenPipeline(cfg, batch=4, seq=16, seed=1)
    step = model_mod.make_train_step(cfg, compute_dtype=torch.float32)
    # first run: 6 steps, checkpoint every 3
    loop1 = TrainLoop(step, pipe, str(tmp_path), ckpt_every=3)
    s0 = model_mod.init_train_state(cfg, seed=0, device="cpu")
    s1, _ = loop1.run(s0, 0, 6, log_every=100, log=lambda *_: None)
    # "crash" and restart: a new loop resumes from the committed checkpoint
    loop2 = TrainLoop(step, pipe, str(tmp_path), ckpt_every=3)
    s2, start = loop2.resume_or_init(model_mod.init_train_state(cfg, seed=0, device="cpu"))
    assert start == 6
    _assert_equal(s1, s2)


def test_train_loop_resumed_mid_run_ends_bit_identical(tmp_path):
    """The step-4 checkpoint of an 8-step run, resumed by a new loop, ends
    where the uninterrupted run ended."""
    cfg = reduced_config("qwen2-0.5b")
    pipe = TokenPipeline(cfg, batch=2, seq=16, seed=0)
    step = model_mod.make_train_step(cfg, lr_peak=1e-3, warmup=1, total_steps=8)
    quiet = dict(log_every=100, log=lambda *_: None)
    straight, _ = TrainLoop(step, pipe, str(tmp_path / "a"), ckpt_every=4).run(
        model_mod.init_train_state(cfg, seed=0, device="cpu"), 0, 8, **quiet)
    first = TrainLoop(step, pipe, str(tmp_path / "b"), ckpt_every=4)
    first.run(model_mod.init_train_state(cfg, seed=0, device="cpu"), 0, 4, **quiet)
    loop = TrainLoop(step, pipe, str(tmp_path / "b"), ckpt_every=4)
    state, start = loop.resume_or_init(model_mod.init_train_state(cfg, seed=1, device="cpu"))
    assert start == 4
    resumed, _ = loop.run(state, start, 4, **quiet)
    _assert_equal(straight, resumed)
    assert sorted(os.listdir(tmp_path / "b")) == ["step_00000004", "step_00000008"]


def test_train_cli_runs_and_resumes_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen2-0.5b", "--reduced",
           "--device", "cpu", "--steps", "4", "--batch", "2", "--seq", "16",
           "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    first = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert first.returncode == 0, first.stderr
    assert "arch=qwen2-0.5b params=" in first.stdout and "steps 0..4" in first.stdout
    assert "done: loss" in first.stdout and "retries=0" in first.stdout
    again = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert again.returncode == 0, again.stderr
    assert "resumed from checkpoint at step 4" in again.stdout and "steps 4..8" in again.stdout
