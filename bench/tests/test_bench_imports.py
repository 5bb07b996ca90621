"""Nothing under bench/ imports JAX or the JAX package; the reference imports nothing of the port."""

import ast

import pytest

from bench.run import forbidden_modules
from bench.tests.tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted((ROOT / "bench").rglob("*.py"))


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    tops = {name.split(".")[0] for name in _imported(path)}
    assert not tops & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "bench" / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = set(_imported(path))
    assert "repro_torch" not in {name.split(".")[0] for name in names}
    assert not {n for n in names if n.startswith("bench.")} - {"bench.reference.blocksparse"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import types

    import bench.run

    fake = dict.fromkeys(["repro_torch", "repro_torch.dist", "jax_like", "reprox", "numpy"])
    monkeypatch.setattr(bench.run, "sys", types.SimpleNamespace(modules=fake))
    assert forbidden_modules() == []
    fake.update(dict.fromkeys(["repro.core", "jaxlib.xla_client"]))
    assert forbidden_modules() == ["jaxlib", "repro"]
