"""A whole run of a small cell on the CPU: the chip check left out, everything else as on the card.

And the faults a cell can have, planted under the timed path one by one:
``correct`` has to come out false for each.
"""

import io
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from bench import run as bench_run
from bench.tests.tiny import ROOT, make_root

SEED = 2**31 + 29


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def run_cell(root, workload, trace=False, seconds=0.3, seed=SEED):
    out, err = io.StringIO(), io.StringIO()
    rc = bench_run.run(workload, seed, seconds, trace, root=root, device="cpu",
                       t0=time.perf_counter(), out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, [json.loads(x) for x in lines], err.getvalue().strip().splitlines()


@pytest.mark.parametrize("workload", ["tiny_band.resident", "tiny_random.resident"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_run_on_the_cpu(root, workload, trace):
    rc, lines, err = run_cell(root, workload, trace)
    assert rc == 0 and len(lines) == 2
    detail, last = lines
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(last)[-1] == "checks"
    assert last["correct"] is True and last["failed"] == 0 and last["attempted"] == detail["calls"] >= 1
    assert set(last["checks"]) == {"structure_mismatch", "value_gap"}
    want = [f"check {k} = {v['value']!r} (limit {v['limit']!r})" for k, v in last["checks"].items()]
    assert err[-2:] == want
    split = detail["setup_split"]
    assert list(split) == ["start_s", "structure_s", "program_import_s", "draw_s", "scatter_s",
                           "warm_call_0_s", "warm_call_1_s", "other_s"]
    assert sum(split.values()) == pytest.approx(detail["setup_s"])
    assert {"build_s", "verify_s", "misses"} <= set(detail["counters_at_setup"])
    assert set(detail["compared"]) == {f"call_{detail['calls'] - 1}", f"call_{detail['kept_call']}_held"}
    if trace:
        # on the CPU no device operation is traced: the device's metrics read nothing
        assert set(last["metrics"]) == {"plan_misses", "plan_build_s", "plan_verify_s"}
        assert last["metrics"]["plan_misses"]["value"] == 0
        assert "breakdown" in last and last["device"]["window_s"] > 0
    else:
        assert set(last["metrics"]) == {"setup_s", "multiply_s", "multiply_p90_s"}
        assert last["metrics"]["multiply_p90_s"]["value"] >= last["metrics"]["multiply_s"]["value"] * 0.5


def _drop_half(real):
    def fused(*args, on=None, **kw):
        a_src = args[4]
        half = torch.arange(a_src.shape[1], device=a_src.device)[None].expand_as(a_src) % 2 == 0
        return real(*args, on=half if on is None else on & half, **kw)
    return fused


def _alter_one(real):
    def fused(*args, **kw):
        out = real(*args, **kw)
        p = 0
        k = int(args[8][p].diff().argmax())  # the deepest run of worker 0
        out[p, k, 0, 0] += 1e-3 * float(torch.linalg.matrix_norm(out[p, k]))
        return out
    return fused


def _unchanged(real):
    return lambda a, b, cache=None, **kw: a


def _no_exchange(real):
    return lambda store, offsets, sends, *a, **kw: torch.zeros_like(real(store, offsets, sends, *a, **kw))


FAULTS = {
    "state_returned_unchanged": ("repro_torch.dist", "dist_multiply", _unchanged),
    "half_the_tasks_left_out": ("repro_torch.kernels.ops", "fused_block_spmm", _drop_half),
    "exchange_between_workers_left_out": ("repro_torch.core.distributed", "_exchange_stack", _no_exchange),
    "one_answer_altered_where_produced": ("repro_torch.kernels.ops", "fused_block_spmm", _alter_one),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", ["tiny_band.resident", "tiny_random.resident"])
def test_a_fault_under_the_timed_path_is_not_correct(root, monkeypatch, fault, workload):
    import importlib

    module, name, make = FAULTS[fault]
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, make(getattr(mod, name)))
    rc, lines, err = run_cell(root, workload)
    assert rc == 0
    last = lines[-1]
    assert last["correct"] is False and last["failed"] >= 1, last["checks"]


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_run.main(["--workload", "band_t1r1.resident", "--seed", "1", "--seconds", "1"]) != 0
    out, err = capsys.readouterr()
    assert out == "" and "CUDA" in err


def test_the_benchmark_alone_gives_no_result(tmp_path):
    alone = tmp_path / "alone"
    shutil.copytree(ROOT / "bench", alone / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", alone / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "bench/run.py", "--workload", "band_t1r1.resident",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=alone, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
