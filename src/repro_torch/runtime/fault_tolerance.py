"""Fault tolerance and straggler detection for the training loop.

Port of the JAX package's ``repro/runtime/fault_tolerance.py``:

* **step retry** (:func:`run_with_retries`): a transient failure (a
  ``RuntimeError``: a lost link, a device error, an allocation that failed)
  retries the step on the same state.  The train step modifies no state it
  is given (:mod:`repro_torch.models.model`) and the data pipeline is
  stateless, so the retried step is the step that failed.
* **checkpoint/restart** (:class:`TrainLoop`): periodic async checkpoints and
  a resume from the latest manifest; a restarted run continues bitwise
  identically.
* **straggler detection** (:class:`StragglerDetector`): a step-time EWMA with
  a multiplicative threshold; the signal is surfaced and counted.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from ..checkpoint import CheckpointManager, latest_step
from ..obs.timing import Stopwatch
from ..tree import tree_map

__all__ = ["run_with_retries", "StragglerDetector", "TrainLoop"]


def run_with_retries(fn: Callable, *args, max_retries: int = 3, on_failure=None):
    """Run fn; retry on transient failure (deterministic step => safe)."""
    for attempt in range(max_retries + 1):
        try:
            return fn(*args)
        except RuntimeError as e:  # the transient class (CUDA and allocator errors too)
            if attempt == max_retries:
                raise
            if on_failure is not None:
                on_failure(attempt, e)
    raise AssertionError("unreachable")


@dataclasses.dataclass
class StragglerDetector:
    """EWMA step-time monitor: flags steps slower than ``threshold`` x EWMA."""

    alpha: float = 0.1
    threshold: float = 2.0
    ewma: float | None = None
    events: int = 0

    def observe(self, dt: float) -> bool:
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = dt > self.threshold * self.ewma
        if slow:
            self.events += 1
        # don't poison the EWMA with the straggler sample
        self.ewma = self.ewma if slow else (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow


class TrainLoop:
    """Checkpointed, restartable, straggler-aware outer loop.

    ``step_seconds`` keeps each step's wall time (the step and a host read of
    its loss, which waits for the card), in the order run.
    """

    def __init__(
        self,
        train_step,
        pipeline,
        ckpt_dir: str,
        *,
        ckpt_every: int = 50,
        keep: int = 3,
        max_retries: int = 3,
    ):
        self.train_step = train_step
        self.pipeline = pipeline
        self.manager = CheckpointManager(ckpt_dir, keep=keep)
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.straggler = StragglerDetector()
        self.retries = 0
        self.step_seconds: list[float] = []

    def resume_or_init(self, state_like_or_init):
        """``(state, start step)``: the latest checkpoint restored into the
        given state's shape, types and devices, or the given state and 0."""
        step = latest_step(self.manager.directory)
        if step is not None:
            state, step = self.manager.restore_latest(state_like_or_init)
            return tree_map(lambda t, like: t.to(like.device), state, state_like_or_init), step
        return state_like_or_init, 0

    def run(self, state, start_step: int, num_steps: int, log_every: int = 10, log=print):
        """Steps ``start_step .. start_step + num_steps - 1`` from the pipeline's
        batches: ``(final state, one float dict of metrics a step)``.

        A checkpoint is saved after every ``ckpt_every``-th step and after the
        last (once: the reference writes the same state twice when the two
        coincide), and every save has been written when it returns.
        """
        metrics_hist, saved = [], None
        for step in range(start_step, start_step + num_steps):
            batch = self.pipeline.global_batch(step)
            sw = Stopwatch()

            def attempt():
                return self.train_step(state, batch)

            def on_failure(k, e):
                self.retries += 1
                log(f"[retry {k}] step {step}: {e}")

            state, metrics = run_with_retries(
                attempt, max_retries=self.max_retries, on_failure=on_failure
            )
            metrics = {k: float(v) for k, v in metrics.items()}  # waits for the step
            dt = sw.elapsed()
            self.step_seconds.append(dt)
            if self.straggler.observe(dt):
                log(f"[straggler] step {step} took {dt:.3f}s (ewma {self.straggler.ewma:.3f}s)")
            metrics_hist.append(metrics)
            if step % log_every == 0:
                log(f"step {step} loss {metrics['loss']:.4f} ({dt*1e3:.0f} ms)")
            if (step + 1) % self.ckpt_every == 0:
                self.manager.save(step + 1, state)
                saved = step + 1
        if saved != start_step + num_steps:  # the last step's state, unless just saved
            self.manager.save(start_step + num_steps, state)
        self.manager.wait()
        return state, metrics_hist
