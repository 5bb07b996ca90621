"""The port's repo lint: clean on the port's tree, firing on the port's idioms.

Mirrors the lint tests of ``tests/test_analysis.py`` and ``tests/test_health.py``
in the port's forms: ``host-sync`` reads the run methods of the ``*Executable``
classes (``.item()``, ``.cpu()``, ``_to_numpy``, ``torch.cuda.synchronize``),
``plan-key-fields`` reads the ``_plan_key(kind, ...)`` helper, and
``device-transfer`` reads device->host fetches inside ``dist_*``.  The fixer
is held against the JAX package's fixer on the reference tests' sources.
"""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("jax")

from repro.analysis import lint as jlint  # noqa: E402
from repro_torch.analysis.lint import (  # noqa: E402
    Finding,
    fix_perf_counter_source,
    lint_file,
    lint_paths,
    load_baseline,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_lint_port_tree_clean():
    findings, waived = lint_paths()
    assert findings == [], "\n".join(str(f) for f in findings)
    keys = {f.key for f in waived}
    assert keys <= load_baseline()
    # the tracer's default clock and the sanctioned norm-table fetch
    assert {"obs/tracer.py::perf-counter", "dist/matrix.py::host-sync"} <= keys


def test_every_waiver_has_a_reason():
    lines = (PORT / "analysis" / "lint_baseline.txt").read_text().splitlines()
    for i, line in enumerate(lines):
        if line.strip() and not line.startswith("#"):
            assert i > 0 and lines[i - 1].startswith("#") and lines[i - 1].strip("# "), line


def _plan_key_source(drop: str = "") -> str:
    """The port's plan-key helper and its two callers, copied from
    ``dist/multiply.py`` (``drop`` removed from the helper's tuple)."""
    src = (PORT / "dist" / "multiply.py").read_text()
    tree = ast.parse(src)
    keep = [ast.get_source_segment(src, fn) for fn in tree.body
            if isinstance(fn, ast.FunctionDef)
            and fn.name in ("_plan_key", "multiply_plan_key", "spamm_delta_plan_key")]
    assert len(keep) == 3
    out = "\n\n".join(keep)
    if drop:
        assert drop in out
        out = out.replace(drop, "", 1)
    return out + "\n"


_OFFENDER = """
import time
from time import perf_counter

def slow():
    return time.perf_counter()


class NormsExecutable:
    def __init__(self, plan):
        self._sends = torch.from_numpy(plan.send).cpu()  # construction: allowed

    def __call__(self, store):
        n = store.sum().item()
        host = store.cpu()
        norms = _to_numpy(store)
        torch.cuda.synchronize()
        return n, host, norms


def dist_bad_collective(x):
    return x.store.cpu()


def innocent_helper(x):
    return x.store.cpu()
"""


def test_lint_rules_fire_on_the_ports_idioms(tmp_path):
    bad = tmp_path / "offender.py"
    bad.write_text(textwrap.dedent(_OFFENDER) + "\n" + _plan_key_source(drop="str(b.dtype),"))
    findings, _ = lint_paths([bad], baseline=set())
    rules = sorted({f.rule for f in findings})
    assert rules == ["device-transfer", "host-sync", "perf-counter", "plan-key-fields"]
    sync = [f for f in findings if f.rule == "host-sync"]
    assert sorted(m for f in sync for m in (".item()", ".cpu()", "_to_numpy()",
                                              "torch.cuda.synchronize()") if m in f.message) \
        == [".cpu()", ".item()", "_to_numpy()", "torch.cuda.synchronize()"]
    assert all("NormsExecutable.__call__" in f.message for f in sync)
    (key,) = [f for f in findings if f.rule == "plan-key-fields"]
    assert "kind" in key.message and "1 operand dtype" in key.message
    (xfer,) = [f for f in findings if f.rule == "device-transfer"]
    assert "dist_bad_collective" in xfer.message
    assert len([f for f in findings if f.rule == "perf-counter"]) == 2
    assert all(isinstance(f, Finding) and f.line > 0 for f in findings)
    # the baseline waives by path::rule key
    waiveall = {f.key for f in findings}
    clean, waived = lint_paths([bad], baseline=waiveall)
    assert clean == [] and len(waived) == len(findings)


def test_lint_silent_on_clean_code(tmp_path):
    home = tmp_path / "obs"
    home.mkdir()
    (home / "timing.py").write_text("from time import perf_counter\n")
    good = tmp_path / "good.py"
    good.write_text(textwrap.dedent("""
        class FineExecutable:
            def __init__(self, x):
                self._owner = torch.from_numpy(x.owner).to(x.device)
                self._host = x.store.cpu()

            def __call__(self, store):
                return store[self._owner].sum(dim=1)

        def dist_fine(a, cache):
            return exe(a.store)

        def host_key(a, b):
            return ("spgemm", a.structure_key, b.structure_key)
    """) + "\n" + _plan_key_source())
    findings, _ = lint_paths([tmp_path], baseline=set())
    assert findings == [], [str(f) for f in findings]


def test_host_sync_sees_the_norm_table_fetch():
    """The port's one executable that syncs does so only through ``_to_numpy``."""
    findings = lint_file(PORT / "dist" / "matrix.py", PORT)
    sync = [f for f in findings if f.rule == "host-sync"]
    assert len(sync) == 1 and "NormTableExecutable.__call__" in sync[0].message
    assert "_to_numpy()" in sync[0].message


def test_plan_key_rule_checks_the_ports_helper(tmp_path):
    # clean as it is; each mandatory field removed makes it fire
    assert not [f for f in lint_file(PORT / "dist" / "multiply.py", PORT)
                if f.rule == "plan-key-fields"]
    for drop in ("str(a.dtype),", "str(b.dtype),", "precision.key(),"):
        mod = tmp_path / "key.py"
        mod.write_text(_plan_key_source(drop=drop))
        hits = [f for f in lint_paths([mod], baseline=set())[0] if f.rule == "plan-key-fields"]
        assert len(hits) == 1, drop


def test_device_transfer_lint_fires(tmp_path):
    offender = tmp_path / "offender.py"
    offender.write_text(
        "import torch\n"
        "def dist_bad_collective(x, dev):\n"
        "    y = torch.as_tensor(x, device=dev)\n"
        "    z = torch.from_numpy(x).to(dev)\n"
        "    return _to_numpy(y), y.to(x.device), z.tolist()\n"
        "def innocent_helper(x, dev):\n"
        "    return torch.as_tensor(x, device=dev).cpu()\n"
    )
    findings, _ = lint_paths([offender], baseline=set())
    hits = [f for f in findings if f.rule == "device-transfer"]
    assert all("dist_bad_collective" in f.message for f in hits)
    assert sorted(f.line for f in hits) == [3, 4, 5, 5, 5]
    waived_findings, waived = lint_paths([offender], baseline={"offender.py::device-transfer"})
    assert [f for f in waived_findings if f.rule == "device-transfer"] == []
    assert len([f for f in waived if f.rule == "device-transfer"]) == 5


def _reference_fixable() -> str:
    """The snippet the JAX package's own fixer test rewrites (``tests/test_analysis.py``)."""
    tree = ast.parse((ROOT / "tests" / "test_analysis.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "_FIXABLE":
            return textwrap.dedent(node.value.args[0].value)
    raise AssertionError("tests/test_analysis.py defines no _FIXABLE")


_FIXABLE = _reference_fixable()


def _fix_sources():
    """What the fixer is held to the JAX package's fixer on: the reference
    tests' snippet, and every reference benchmark that times with
    ``time.perf_counter``."""
    out = {"test_analysis._FIXABLE": _FIXABLE}
    for path in sorted((ROOT / "benchmarks").glob("*.py")):
        src = path.read_text()
        if not path.name.startswith("torch_") and "perf_counter" in src:
            out[f"benchmarks/{path.name}"] = src
    return out


@pytest.mark.parametrize("name", sorted(_fix_sources()))
def test_fixer_equals_the_reference_fixer(name):
    src = _fix_sources()[name]
    want, n_want = jlint.fix_perf_counter_source(src)
    got, n = fix_perf_counter_source(src)
    assert n == n_want and n > 0
    assert got == want.replace("repro.obs.timing", "repro_torch.obs.timing")
    ast.parse(got)
    again, n2 = fix_perf_counter_source(got)
    assert n2 == 0 and again == got


def test_fixed_module_lints_clean(tmp_path):
    fixed, _ = fix_perf_counter_source(_FIXABLE)
    assert "from repro_torch.obs.timing import Stopwatch, wall_clock" in fixed
    mod = tmp_path / "mod.py"
    mod.write_text(fixed)
    findings, _ = lint_paths([mod], baseline=set())
    assert not [f for f in findings if f.rule == "perf-counter"]


def test_lint_fix_cli_flag(tmp_path):
    mod = tmp_path / "mod.py"
    mod.write_text(_FIXABLE)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--lint-only", "--fix", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "FIX" in proc.stdout, proc.stdout + proc.stderr
    fixed = mod.read_text()
    assert "perf_counter" not in fixed and "Stopwatch()" in fixed
