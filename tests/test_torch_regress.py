"""The port's benchmark trajectory store and regression gate.

Mirrors the regress tests of ``tests/test_health.py`` on
``repro_torch.obs.regress``, then holds it to the JAX package's
``repro.obs.regress`` on the repo's own ``BENCH_HISTORY.jsonl`` and
``benchmarks/torch_history.py`` to ``benchmarks/history.py`` on the repo's
reference ``BENCH_*.json`` files.
"""

import importlib
import pathlib
import sys

import pytest

pytest.importorskip("jax")

from repro.obs import regress as jregress  # noqa: E402
from repro_torch.obs.regress import (  # noqa: E402
    ENTRY_KEYS,
    HISTORY_FILENAME,
    TOLERANCES,
    append_history,
    check_history,
    load_history,
    trajectory_table,
)
from repro_torch.obs.regress import main as regress_main  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_BENCH = sorted(p.name for p in ROOT.glob("BENCH_*.json") if not p.stem.endswith("_torch"))


def _entry(bench="trace", config="smoke", commit="abc1234", **metrics):
    return dict(ts=1e9, commit=commit, bench=bench, config=config, metrics=metrics, meta={})


def _benchmarks(name):
    sys.path.insert(0, str(ROOT / "benchmarks"))
    return importlib.import_module(name)


def test_history_round_trip_and_envelope(tmp_path):
    assert HISTORY_FILENAME == "BENCH_HISTORY_torch.jsonl"
    assert ENTRY_KEYS == jregress.ENTRY_KEYS
    path = str(tmp_path / "hist.jsonl")
    assert load_history(path) == []  # missing file is an empty history
    append_history(path, _entry(overhead_pct=1.0))
    append_history(path, _entry(overhead_pct=1.2))
    back = load_history(path)
    assert len(back) == 2 and set(ENTRY_KEYS) <= back[0].keys()
    with pytest.raises(ValueError):
        append_history(path, dict(ts=1.0, commit="x"))  # missing keys
    with pytest.raises(ValueError):
        append_history(path, _entry(bit_identical=True))  # bool metric


def test_check_history_pass_and_fail():
    base = [_entry(overhead_pct=1.0), _entry(overhead_pct=1.1)]
    assert check_history(base) == []  # within abs_tol=2.0
    bad = base + [_entry(overhead_pct=4.0, commit="bad9999")]
    (v,) = check_history(bad)
    assert (v["bench"], v["metric"], v["commit"]) == ("trace", "overhead_pct", "bad9999")
    flip = [_entry(bit_identical=1.0), _entry(bit_identical=1.0), _entry(bit_identical=0.0)]
    assert [v["metric"] for v in check_history(flip)] == ["bit_identical"]
    assert check_history([_entry(overhead_pct=99.0)]) == []
    noisy = [_entry(overhead_pct=1.0), _entry(overhead_pct=50.0),
             _entry(overhead_pct=1.0), _entry(overhead_pct=1.2)]
    assert check_history(noisy) == []


def test_port_metrics_gate_in_their_direction():
    # an SCF replay that misses once, a flipped engine identity, a slower resident SP2
    cases = [("inverse", "replay_misses", 0.0, 1.0), ("kernel", "engines_bit_identical", 1.0, 0.0),
             ("purify", "resident_speedup", 4.0, 1.0), ("spamm", "bound_ok", 1.0, 0.0)]
    for bench, metric, good, bad in cases:
        hist = [_entry(bench=bench, **{metric: good}), _entry(bench=bench, **{metric: good}),
                _entry(bench=bench, commit="bad", **{metric: bad})]
        assert [v["metric"] for v in check_history(hist)] == [metric], (bench, metric)
        assert check_history(hist[:2]) == []
    # the reference's tolerances are the port's, unchanged
    for bench, specs in jregress.TOLERANCES.items():
        for metric, spec in specs.items():
            assert TOLERANCES[bench][metric] == type(TOLERANCES[bench][metric])(**vars(spec))


def test_regress_cli_exit_codes(tmp_path, capsys):
    path = str(tmp_path / "hist.jsonl")
    append_history(path, _entry(overhead_pct=1.0, bit_identical=1.0))
    append_history(path, _entry(overhead_pct=1.1, bit_identical=1.0))
    assert regress_main(["--history", path, "--check"]) == 0
    assert "clean" in capsys.readouterr().out
    append_history(path, _entry(overhead_pct=9.9, commit="bad9999", bit_identical=1.0))
    assert regress_main(["--history", path, "--check"]) == 1
    out = capsys.readouterr().out
    assert "overhead_pct" in out and "bad9999" in out
    assert regress_main(["--history", path, "--list"]) == 0


def test_the_repos_history_gates_as_in_the_reference():
    path = str(ROOT / "BENCH_HISTORY.jsonl")
    entries = load_history(path)
    assert entries and entries == jregress.load_history(path)
    assert check_history(entries) == jregress.check_history(entries)
    assert trajectory_table(entries) == jregress.trajectory_table(entries)


@pytest.mark.parametrize("name", REF_BENCH)
def test_history_extractor_equals_the_reference(name):
    port, ref = _benchmarks("torch_history"), _benchmarks("history")
    path = str(ROOT / name)
    got = port.entries_from_bench_json(path, ts=123.0, commit="fixed")
    want = ref.entries_from_bench_json(path, ts=123.0, commit="fixed")
    assert got == want and got
