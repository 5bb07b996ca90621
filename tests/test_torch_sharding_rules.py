"""The port's sharding-rule arithmetic (``repro_torch.sharding``) against the JAX package's.

The reference's five rule cases (``tests/test_sharding_rules.py``) with a
duck-typed ctx, then every parameter of all ten archs at full width on the
16 x 16 and 2 x 16 x 16 production meshes: the port's spec of each leaf
equals the reference's ``spec_tree`` over ``transformer.abstract_params``
with its stacked ``"layers"`` entry dropped, and one device's bytes are
equal.  Nothing is allocated: the reference's tree is ``jax.eval_shape``'s,
the port's fake tensors.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch.mesh import production_mesh_axes  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.sharding import (  # noqa: E402
    DEFAULT_RULES,
    MeshCtx,
    logical_to_spec,
    shard_bytes,
    shard_shape,
    spec_tree,
)


class _Ctx:
    """Duck-typed ctx with arbitrary axis sizes (no devices needed)."""

    def __init__(self, sizes, rules=None):
        self._sizes = sizes
        self.rule_map = dict(DEFAULT_RULES)
        if rules:
            self.rule_map.update(rules)

    @property
    def axis_sizes(self):
        return self._sizes


def test_divisible_dims_shard():
    ctx = _Ctx({"data": 16, "model": 16})
    assert logical_to_spec(ctx, (8192, 29568), ("embed", "mlp")) == ("data", "model")


def test_non_divisible_dims_replicate():
    ctx = _Ctx({"data": 16, "model": 16})
    # qwen2-0.5b attention: 14 heads on a 16-way model axis -> replicated
    assert logical_to_spec(ctx, (896, 14, 64), ("embed", "heads", None)) == ("data", None, None)
    # qwen2-72b: 64 heads shard cleanly
    assert logical_to_spec(ctx, (8192, 64, 128), ("embed", "heads", None)) == (
        "data", "model", None)
    # vocab 504 (hubert) not divisible -> replicated
    assert logical_to_spec(ctx, (1280, 504), ("embed", "vocab")) == ("data", None)


def test_axes_used_once():
    ctx = _Ctx({"data": 16, "model": 16})
    # both dims map to model: only the first gets it
    assert logical_to_spec(ctx, (64, 128), ("heads", "mlp")) == ("model", None)


def test_multi_axis_batch():
    ctx = _Ctx({"pod": 2, "data": 16, "model": 16})
    assert logical_to_spec(ctx, (256, 4096), ("batch", "seq")) == (("pod", "data"), None)
    # batch=1 (long_500k): falls back to replicated
    assert logical_to_spec(ctx, (1, 4096), ("batch", "seq")) == (None, None)


@pytest.mark.parametrize("arch", ["qwen2-72b", "kimi-k2-1t-a32b", "mamba2-370m",
                                  "recurrentgemma-9b"])
def test_spec_tree_covers_all_arch_params(arch):
    ctx = _Ctx({"data": 16, "model": 16})
    cfg = get_config(arch)
    params = tmodel.abstract_train_state(cfg)["params"]
    specs = spec_tree(ctx, params, ttf.param_axes(cfg))
    leaves, spec_leaves = _leaves(params), _leaves(specs, spec=True)
    assert len(leaves) == len(spec_leaves)
    # every big tensor (>= 8M elements) must be sharded on at least one axis
    for p, s in zip(leaves, spec_leaves):
        if math.prod(p.shape) >= (1 << 23):
            assert any(e is not None for e in s), (tuple(p.shape), s)


def test_mesh_ctx_and_shard_arithmetic():
    ctx = MeshCtx.of(production_mesh_axes(multi_pod=True))
    assert ctx.axis_sizes == {"pod": 2, "data": 16, "model": 16}
    assert MeshCtx.of(production_mesh_axes()).axis_sizes == {"data": 16, "model": 16}
    ctx2 = ctx.with_rules(embed=())
    assert ctx2.rule_map["embed"] == () and ctx.rule_map["embed"] == ("data",)
    spec = logical_to_spec(ctx, (256, 8192, 64), ("batch", "embed", "heads"))
    assert spec == (("pod", "data"), None, "model")  # data is taken by the batch
    assert shard_shape(ctx, (256, 8192, 64), spec) == (8, 8192, 4)
    assert shard_bytes(ctx, (256, 8192, 64), spec, 2) == 8 * 8192 * 4 * 2


# --- every parameter of every arch against the reference ------------------------


def _leaves(tree, spec: bool = False):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], spec)]
    if isinstance(tree, list) or (isinstance(tree, tuple) and not spec):
        return [x for v in tree for x in _leaves(v, spec)]
    return [tree]


def _ref_by_path(cfg, sizes):
    """``{path: (shape, spec)}`` of the reference's parameters on a mesh of ``sizes``,
    in the port's per-layer layout (the stacked ``"layers"`` dim and spec entry
    dropped)."""
    params, axes = jtf.abstract_params(cfg)
    specs = jrules.spec_tree(_Ctx(sizes), params, axes)
    flat_p = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_s = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    pattern = cfg.block_pattern
    periods = cfg.num_layers // len(pattern)
    out = {}
    for (path, p), s in zip(flat_p, flat_s, strict=True):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        s = tuple(s) + (None,) * (len(p.shape) - len(tuple(s)))
        if keys[0] == "blocks":
            j = int(keys[1][1:])
            assert s[0] is None  # the rules map "layers" to no mesh axis
            for i in range(periods):
                out[("layers", i * len(pattern) + j, *keys[2:])] = (tuple(p.shape[1:]), s[1:])
        elif keys[0] == "tail":
            out[("layers", periods * len(pattern) + keys[1], *keys[2:])] = (tuple(p.shape), s)
        else:
            out[tuple(keys)] = (tuple(p.shape), s)
    return out


def _port_by_path(params, specs, prefix=()):
    if isinstance(params, dict):
        return {k: v for key in params
                for k, v in _port_by_path(params[key], specs[key], prefix + (key,)).items()}
    if isinstance(params, list):
        return {k: v for i, p in enumerate(params)
                for k, v in _port_by_path(p, specs[i], prefix + (i,)).items()}
    return {prefix: (tuple(params.shape), specs)}


def _spec_bytes(sizes, shape, spec, itemsize):
    div = 1
    for entry in spec:
        for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
            div *= sizes[a]
    return math.prod(shape) // div * itemsize


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_param_spec_and_device_bytes_equal_the_reference(arch, multi_pod):
    sizes = production_mesh_axes(multi_pod)
    cfg = get_config(arch)
    params = tmodel.abstract_train_state(cfg)["params"]
    ctx = MeshCtx.of(sizes)
    got = _port_by_path(params, spec_tree(ctx, params, ttf.param_axes(cfg)))
    want = _ref_by_path(j_get_config(arch), sizes)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k
    port_bytes = sum(shard_bytes(ctx, shape, spec, 4) for shape, spec in got.values())
    ref_params = jtf.abstract_params(j_get_config(arch))[0]
    ref_specs = jrules.spec_tree(_Ctx(sizes), *jtf.abstract_params(j_get_config(arch)))
    ref_bytes = sum(_spec_bytes(sizes, p.shape, tuple(s), np.dtype(p.dtype).itemsize)
                    for p, s in zip(jax.tree.leaves(ref_params), jax.tree.leaves(
                        ref_specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)),
                        strict=True))
    assert port_bytes == ref_bytes
