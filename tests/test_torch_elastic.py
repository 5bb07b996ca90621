"""Elastic resharding of a train state across meshes: the port against the JAX package.

The port's ranks are 8 gloo processes (``run_on_mesh(device="cpu")``) that
build the ``(data 2, model 4)``, ``(data 4, model 2)`` and ``(data 8)`` meshes
in turn over one pool and move a reduced olmo-1b train state along them
with ``reshard_state``, then put a checkpoint restored with
``checkpoint/manager.py`` on the last.  The JAX package runs its own
``reshard_state`` along the same meshes in an 8-device subprocess, at the
same time, and reports the shape of device 0's shard of every leaf.  Values
are moved, never computed: the tolerance is zero.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import torch_mesh_ranks as ranks  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

ARCH = "olmo-1b"
MESHES = [((2, 4), ("data", "model")), ((4, 2), ("data", "model")), ((8,), ("data",))]

_JAX_SCRIPT = r"""
import pickle, sys
import numpy as np, jax
from jax.sharding import Mesh
from repro.configs import reduced_config
from repro.models import model as model_mod, transformer
from repro.runtime.elastic import reshard_state
from repro.sharding.rules import MeshCtx

assert jax.device_count() == 8
meshes = pickle.load(open(sys.argv[1], "rb"))
cfg = reduced_config("olmo-1b")
state = model_mod.init_train_state(jax.random.key(0), cfg)
axes = transformer.param_axes(cfg)
out = []
for shape, names in meshes:
    ctx = MeshCtx(mesh=Mesh(np.array(jax.devices()).reshape(shape), names))
    state = reshard_state(state, None, ctx, axes)
    # device 0's shard of every leaf (mesh coordinate 0 on every axis)
    out.append(jax.tree.map(lambda x: np.empty(
        next(s.data.shape for s in x.addressable_shards if s.device == jax.devices()[0]),
        np.int8), state))
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    with open(tmp / "meshes.pkl", "wb") as f:
        pickle.dump(MESHES, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    cfg = reduced_config(ARCH)
    state = tmodel.init_train_state(cfg, seed=0, device="cpu")
    save_checkpoint(str(tmp / "ckpt"), 0, state)
    with subprocess.Popen([sys.executable, "-c", _JAX_SCRIPT, str(tmp / "meshes.pkl"),
                           str(tmp / "out.pkl")], env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True) as proc:
        try:
            port = tmesh.run_on_mesh(ranks.elastic_body, (8,), ("pool",), device="cpu",
                                     args=(cfg, state, MESHES, str(tmp / "ckpt")))
            _, err = proc.communicate(timeout=600)
        finally:
            proc.kill()
    assert proc.returncode == 0, err[-4000:]
    with open(tmp / "out.pkl", "rb") as f:
        jax_shards = pickle.load(f)
    return cfg, port, jax_shards


@pytest.mark.parametrize("step", range(len(MESHES)), ids=[str(m[0]) for m in MESHES])
def test_reshard_state_is_bit_identical_and_laid_out_by_its_specs(runs, step):
    """After each move every rank's state gathers back to the original bit for
    bit, and every local block's shape and layout are its spec's."""
    _, port, _ = runs
    for rank in port:
        r = rank[step]
        assert r["mesh"] == list(MESHES[step][0])
        assert r["bit_identical"]
        assert r["wrong"] == []
        assert r["sharded"] > 0  # the FSDP axis and the model axis shard something


@pytest.mark.parametrize("step", range(len(MESHES)), ids=[str(m[0]) for m in MESHES])
def test_local_blocks_are_the_jax_packages_shards(runs, step):
    """Rank 0's block of every leaf has the shape of the JAX package's shard on
    device 0 (the JAX tree's per-layer slices, through ``convert``)."""
    cfg, port, jax_shards = runs
    want = convert.train_state_from_arrays(jax_shards[step], cfg, device="cpu")
    got = port[0][step]["local_shapes"]
    paths = {}

    def walk(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{path}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{path}/{i}")
        else:
            paths[path] = tuple(tree.shape)

    walk(want)
    assert paths.keys() == got.keys()
    assert {p: got[p] for p in paths} == paths


def test_a_restored_checkpoint_goes_onto_a_mesh_bit_identical(runs):
    _, port, _ = runs
    assert all(rank[-1]["restored_bit_identical"] for rank in port)
    assert np.all([len(rank) == len(MESHES) + 1 for rank in port])
