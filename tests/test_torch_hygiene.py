"""The port stands alone: it imports neither JAX nor the JAX package, and it
never runs on the CPU unless asked to."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")

_BLOCKED_IMPORT = r'''
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {forbidden!r}:
            raise ImportError(f"blocked import of {{name}}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(n.split(".")[0] in {forbidden!r} for n in sys.modules), "forbidden module loaded"
print(len(names))
'''


def test_every_module_imports_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = _BLOCKED_IMPORT.format(forbidden=set(FORBIDDEN))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 79  # every module of the package was walked


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


# the port's benchmarks run on the card's machine, which has no JAX; the one
# that times the port against the JAX package on the CPU is the exception
MIRRORS = sorted(p for p in (ROOT / "benchmarks").glob("torch_*.py")
                 if p.name != "torch_verify_speed.py")


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"] + MIRRORS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def test_benchmark_mirrors_import_with_jax_and_repro_blocked():
    head = _BLOCKED_IMPORT.format(forbidden=set(FORBIDDEN)).split("import repro_torch")[0]
    code = head + (
        f"sys.path.insert(0, {str(ROOT / 'benchmarks')!r})\n"
        f"for name in {[p.stem for p in MIRRORS]!r}:\n"
        "    importlib.import_module(name)\n"
        f"assert not any(n.split('.')[0] in {set(FORBIDDEN)!r} for n in sys.modules)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(MIRRORS) >= 10  # the eight mirrors, the shared helper, the kernel comparison


def test_constructors_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    from repro_torch.core import BSMatrix, identity

    with pytest.raises(RuntimeError, match="no CUDA device"):
        BSMatrix.from_dense(np.eye(8, dtype=np.float32), 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BSMatrix.zeros((8, 8), 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BSMatrix.from_blocks((8, 8), 4, np.zeros((1, 2)), np.ones((1, 4, 4), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BSMatrix.from_coo((8, 8), 4, [0], [1], [2.0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        identity(8, 4)
    assert BSMatrix.zeros((8, 8), 4, device="cpu").device.type == "cpu"


def test_worker_mesh_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    from repro_torch.core.distributed import make_worker_mesh

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_worker_mesh(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_worker_mesh(1, device="cuda")
    mesh = make_worker_mesh(4, device="cpu")
    assert (mesh.nparts, mesh.device.type) == (4, "cpu")


def test_plain_version_on_the_cpu_launches_nothing():
    from repro_torch.core import BSMatrix, multiply
    from repro_torch.kernels import block_spmm

    block_spmm.launches = 0
    a = BSMatrix.from_dense(np.random.default_rng(0).standard_normal((40, 40)).astype(np.float32),
                            8, device="cpu")
    c = multiply(a, a)
    np.testing.assert_allclose(c.to_dense(), a.to_dense() @ a.to_dense(), rtol=1e-4, atol=1e-4)
    assert block_spmm.launches == 0
