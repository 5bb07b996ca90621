"""Every ``examples/torch_*.py`` runs on the CPU and passes its own checks.

Each example holds its result against its oracle (the dense product, a
float64 eigendecomposition, the single-host driver, the prompt, a falling
loss) and exits non-zero on a failed check; here each runs as a subprocess
with ``--device cpu``, the training example for 20 steps into a temporary
checkpoint directory.  ``chip_smoke.py``'s ``examples`` phase runs them with
``--device cuda``.
"""

import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "purification", "distributed_spgemm", "distributed_purification",
            "distributed_inverse", "serve_lm", "train_lm")


def test_every_example_has_a_port_copy():
    ported = {p.stem.removeprefix("torch_") for p in (ROOT / "examples").glob("torch_*.py")}
    reference = {p.stem for p in (ROOT / "examples").glob("*.py") if not p.stem.startswith("torch_")}
    assert ported == reference == set(EXAMPLES)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(name, tmp_path):
    argv = [sys.executable, str(ROOT / "examples" / f"torch_{name}.py"), "--device", "cpu"]
    if name == "train_lm":
        argv += ["--steps", "20", "--ckpt-dir", str(tmp_path / "ckpt")]
    # one intra-op thread: the test workers share the cores, and the examples'
    # thousands of small torch ops run many times slower with every pool spinning
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1", TMPDIR=str(tmp_path))
    proc = subprocess.run(argv, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "FAILED" not in proc.stdout
