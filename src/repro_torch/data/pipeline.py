"""Deterministic, stateless, shardable synthetic data pipeline.

A copy of the JAX package's ``repro/data/pipeline.py`` (pure numpy), so the
port imports nothing of it and every batch equals the JAX package's array
for array; the train step moves a batch to the card.

Every batch is a pure function of ``(seed, step)`` via a counter-based RNG,
which gives the fault-tolerance properties the runtime needs for free:

* **skip-ahead resume**: restarting at step N just asks for batch N — no
  iterator state to checkpoint, bitwise-identical continuation (tested).
* **host sharding**: each host materializes only its slice of the global
  batch (``host_slice``); slices are disjoint by construction.
* **elasticity**: a different host count re-slices the same global batch.

Token streams are Zipf-distributed (realistic embedding-gather skew);
modality stubs (audio frames / vision patches) are seeded Gaussians.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..configs.base import ArchConfig

__all__ = ["TokenPipeline"]


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    cfg: ArchConfig
    batch: int
    seq: int
    seed: int = 0
    zipf_a: float = 1.2

    def _rng(self, step: int, stream: int = 0) -> np.random.Generator:
        return np.random.Generator(
            np.random.Philox(key=self.seed, counter=[0, 0, int(stream), int(step)])
        )

    def _tokens(self, rng, shape) -> np.ndarray:
        z = rng.zipf(self.zipf_a, size=shape)
        return ((z - 1) % self.cfg.vocab_size).astype(np.int32)

    def global_batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        if cfg.frontend == "audio_stub":
            rng = self._rng(step)
            return {
                "frames": rng.standard_normal(
                    (self.batch, self.seq, cfg.frontend_dim), dtype=np.float32
                ),
                "labels": self._tokens(self._rng(step, 1), (self.batch, self.seq)),
            }
        if cfg.frontend == "vision_stub":
            rng = self._rng(step)
            return {
                "patches": rng.standard_normal(
                    (self.batch, cfg.num_patches, cfg.d_model), dtype=np.float32
                ).astype(np.float32),
                "tokens": self._tokens(
                    self._rng(step, 1), (self.batch, self.seq - cfg.num_patches)
                ),
            }
        return {"tokens": self._tokens(self._rng(step), (self.batch, self.seq))}

    def host_slice(
        self, step: int, host_id: int, num_hosts: int
    ) -> dict[str, np.ndarray]:
        """This host's rows of the global batch (disjoint, covering)."""
        assert self.batch % num_hosts == 0, (self.batch, num_hosts)
        per = self.batch // num_hosts
        g = self.global_batch(step)
        return {k: v[host_id * per : (host_id + 1) * per] for k, v in g.items()}
