"""``python -m repro_torch.analysis``: line for line the JAX package's CLI, and JAX-free.

The plans equal the reference's array for array, so ``run_verify`` and
``run_selftest`` print exactly the reference's ``ok`` / ``FAIL`` / ``MISS``
lines; the whole CLI runs with every ``jax`` / ``repro`` import blocked, as
on the card's machine.
"""

import contextlib
import io
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("jax")

from repro.analysis import __main__ as jcli  # noqa: E402
from repro_torch.analysis import __main__ as tcli  # noqa: E402
from test_torch_hygiene import FORBIDDEN, _BLOCKED_IMPORT  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn()
    return rc, buf.getvalue().splitlines()


@pytest.mark.parametrize("name", ["run_verify", "run_selftest"])
def test_output_equals_the_reference_line_for_line(name):
    rc, got = _run(getattr(tcli, name))
    rc_want, want = _run(getattr(jcli, name))
    assert got == want
    assert rc == rc_want == 0
    assert len(got) == (24 if name == "run_verify" else len(tcli.CORRUPTIONS))


def test_structures_equal_the_reference():
    got, want = tcli._structures(), jcli._structures()
    assert list(got) == list(want)
    for k in got:
        assert (got[k] == want[k]).all(), k


def _blocked(argv: list[str]) -> subprocess.CompletedProcess:
    """``python -m repro_torch.analysis <argv>`` with jax / repro imports blocked."""
    head = _BLOCKED_IMPORT.format(forbidden=set(FORBIDDEN)).split("import repro_torch")[0]
    code = head + (
        "import runpy\n"
        f"sys.argv = ['python -m repro_torch.analysis'] + {argv!r}\n"
        "try:\n"
        "    runpy.run_module('repro_torch.analysis', run_name='__main__', alter_sys=True)\n"
        "except SystemExit as e:\n"
        f"    assert not any(n.split('.')[0] in {set(FORBIDDEN)!r} for n in sys.modules)\n"
        "    raise\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=300)


def test_selftest_exits_zero_with_jax_blocked():
    proc = _blocked(["--selftest"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1] == "analysis: clean"
    assert sum(ln.startswith("ok ") and "/P=" in ln for ln in lines) == 24
    assert sum(": caught as " in ln for ln in lines) == len(tcli.CORRUPTIONS)
    assert any(ln.startswith("lint: 0 finding(s)") for ln in lines)


def test_cli_exit_code_reports_a_lint_finding(tmp_path):
    (tmp_path / "mod.py").write_text("import time\nx = time.perf_counter()\n")
    proc = _blocked(["--lint-only", str(tmp_path)])
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "LINT mod.py:2: [perf-counter]" in proc.stdout
    assert proc.stdout.splitlines()[-1] == "analysis: 1 problem(s)"
