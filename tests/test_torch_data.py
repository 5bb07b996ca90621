"""The port's token pipeline: every batch equal to the JAX package's array for
array (every architecture's frontend, reduced and full configs, host
slices), and mirrors of ``tests/test_data.py``."""

import dataclasses

import numpy as np
import pytest

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.data import TokenPipeline


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batches_equal_the_jax_packages(arch, reduced):
    pytest.importorskip("jax")
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced_config as jax_reduced_config
    from repro.data import TokenPipeline as JaxTokenPipeline

    cfg = reduced_config(arch) if reduced else get_config(arch)
    jcfg = jax_reduced_config(arch) if reduced else jax_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    seq = 64 if reduced else 1024
    ours = TokenPipeline(cfg, batch=4, seq=seq, seed=3)
    theirs = JaxTokenPipeline(jcfg, batch=4, seq=seq, seed=3)
    for step in (0, 1, 17):
        got, want = ours.global_batch(step), theirs.global_batch(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k], want[k])
    for h in range(2):
        got, want = ours.host_slice(5, h, 2), theirs.host_slice(5, h, 2)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


# --- mirrors of tests/test_data.py -------------------------------------------


def test_deterministic_and_distinct():
    cfg = reduced_config("olmo-1b")
    p = TokenPipeline(cfg, batch=8, seq=32, seed=1)
    a = p.global_batch(5)
    b = p.global_batch(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])  # same step = same data
    c = p.global_batch(6)
    assert not np.array_equal(a["tokens"], c["tokens"])  # steps differ


def test_skip_ahead_equals_sequential():
    cfg = reduced_config("olmo-1b")
    p = TokenPipeline(cfg, batch=4, seq=16, seed=2)
    seq = [p.global_batch(i)["tokens"] for i in range(5)]
    # "resume at 3" without replaying 0..2
    np.testing.assert_array_equal(p.global_batch(3)["tokens"], seq[3])


def test_host_slices_partition_global_batch():
    cfg = reduced_config("olmo-1b")
    p = TokenPipeline(cfg, batch=8, seq=16, seed=3)
    g = p.global_batch(0)["tokens"]
    parts = [p.host_slice(0, h, 4)["tokens"] for h in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), g)


def test_tokens_in_vocab():
    for arch in ["olmo-1b", "hubert-xlarge", "paligemma-3b"]:
        cfg = reduced_config(arch)
        p = TokenPipeline(cfg, batch=4, seq=32, seed=0)
        b = p.global_batch(0)
        for k, v in b.items():
            if v.dtype == np.int32:
                assert v.min() >= 0 and v.max() < cfg.vocab_size


def test_modality_stubs():
    cfg = reduced_config("hubert-xlarge")
    b = TokenPipeline(cfg, batch=2, seq=16, seed=0).global_batch(0)
    assert b["frames"].shape == (2, 16, cfg.frontend_dim)
    cfg = reduced_config("paligemma-3b")
    b = TokenPipeline(cfg, batch=2, seq=16, seed=0).global_batch(0)
    assert b["patches"].shape == (2, cfg.num_patches, cfg.d_model)
    assert b["tokens"].shape == (2, 16 - cfg.num_patches)
