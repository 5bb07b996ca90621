"""The streamed parameter draw: ``transformer.init_params(..., dtype=, keep=)``.

A full-width kimi-k2 layer is about 77 GB in fp32, so neither one process
nor a rank can draw the whole fp32 tree and cast or cut it after.  The
draw goes leaf by leaf in one generator order, each leaf cut (``keep``)
and cast (``dtype``) as it is drawn.  Here, on reduced configs: the bf16
draw equals ``cast_params`` of the fp32 tree bit for bit; each gloo
rank's kept blocks under the prefill, decode and train rules equal the
blocks ``reshard_state`` cuts from the whole tree (rank bodies:
``tests/torch_mesh_ranks.py``); and the default call's tree is the tree
drawn before the draw streamed (its digest, from torch's CPU generator,
was taken on that tree).
"""

import hashlib

import pytest
import torch

import torch_mesh_ranks as ranks
from repro_torch.configs import reduced_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as tmodel
from repro_torch.models import transformer
from repro_torch.tree import tree_paths

#: (arch, seed) -> the first 16 hex digits of the sha256 over every leaf's path
#: and bytes, in ``tree_paths`` order, of ``init_params(reduced, seed, "cpu")``
#: as drawn before the streamed draw existed
DEFAULT_DIGESTS = {("kimi-k2-1t-a32b", 5): "479b7ac599fd2aad",
                   ("recurrentgemma-9b", 6): "8184baa736cb2708",
                   ("mamba2-370m", 7): "21ef3ee36c959a3f"}
ARCHS = [a for a, _ in DEFAULT_DIGESTS]


def _digest(tree) -> str:
    h = hashlib.sha256()
    for path, t in tree_paths(tree):
        h.update(path.encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("arch,seed", list(DEFAULT_DIGESTS))
def test_default_draw_is_unchanged(arch, seed):
    cfg = reduced_config(arch)
    whole = transformer.init_params(cfg, seed=seed, device="cpu")
    assert _digest(whole) == DEFAULT_DIGESTS[(arch, seed)]
    # a keep that cuts and casts nothing: the same tree
    kept = transformer.init_params(cfg, seed=seed, device="cpu", keep=lambda path, t, dtype: t)
    assert _digest(kept) == DEFAULT_DIGESTS[(arch, seed)]


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_draw_equals_the_cast_tree(arch):
    cfg = reduced_config(arch)
    want = tree_paths(tmodel.cast_params(transformer.init_params(cfg, seed=11, device="cpu"),
                                         torch.bfloat16))
    got = tree_paths(transformer.init_params(cfg, seed=11, device="cpu", dtype=torch.bfloat16))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), path
    assert {t.dtype for _, t in got} == {torch.bfloat16}


def test_keep_sees_every_leaf_once_with_its_path():
    cfg = reduced_config("kimi-k2-1t-a32b")
    seen = []

    def keep(path, leaf, dtype):
        assert dtype is None
        seen.append(path)
        return leaf[:1].clone() if leaf.dim() else leaf

    got = transformer.init_params(cfg, seed=3, device="cpu", keep=keep)
    whole = transformer.init_params(cfg, seed=3, device="cpu")
    assert sorted("/".join(map(str, p)) for p in seen) == [p for p, _ in tree_paths(whole)]
    assert seen[0] == ("embed", "table") and ("layers", 0, "moe", "w1") in seen
    for (path, g), (_, w) in zip(tree_paths(got), tree_paths(whole)):
        assert torch.equal(g, w[:1] if w.dim() else w), path


@pytest.fixture(scope="module")
def rank_draws():
    cases = {arch: dict(cfg=reduced_config(arch), seed=20 + i) for i, arch in enumerate(ARCHS)}
    return tmesh.run_on_mesh(ranks.init_stream_body, (2, 2), ("data", "model"), device="cpu",
                             args=(cases,), timeout_s=600)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "train_4k"])
def test_rank_blocks_drawn_equal_the_whole_trees_blocks(rank_draws, arch, shape):
    for rank in rank_draws:
        assert rank[arch][(shape, "None")], (shape, "fp32")
        assert rank[arch][(shape, "torch.bfloat16")], (shape, "bf16")
