"""BENCHMARK.json against the benchmark's contract, and every file it names found by name."""

import json
import re

import pytest

from bench import manifest
from bench.tests.tiny import ROOT, TINY, make_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}

M = manifest.load_manifest(ROOT)


def test_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(M["command"]) <= 32 and all(TEXT.match(w) for w in M["command"])
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    for word in M["command"][1:]:
        assert any(word == p or word.startswith(p + "/") for p in M["paths"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


def test_run_seconds_fits_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_well_formed(kind):
    names = [e["name"] for e in M[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    assert 1 <= len(M["configs"]) <= 24
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"] == f"bench/configs/{c['name']}.json"
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert set(c["reduced"]) == set(cfg["published"])


def test_workloads():
    assert 1 <= len(M["workloads"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(M["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"] for m in M["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16 and 1 <= len(M["per_layer"]) <= 128
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in SOURCES_E2E and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("workload", [w["name"] for w in M["workloads"]])
def test_each_cell_reports_enough(workload):
    e2e = manifest.metrics_of(M, workload, "end_to_end")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert manifest.metrics_of(M, workload, "per_layer")


@pytest.mark.parametrize("workload", [w["name"] for w in M["workloads"]])
def test_each_cell_found_by_name(workload):
    parts = manifest.resolve(workload, ROOT)
    assert parts["config"]["name"] == parts["entry"]["config"]
    assert parts["traffic"]["name"] == parts["entry"]["traffic"]
    assert callable(parts["family"].structure) and callable(parts["driver"].Driver)
    assert set(parts["limits"]) == {"structure_mismatch", "value_gap"}
    for entry, read in parts["end_to_end"] + parts["per_layer"]:
        assert callable(read), entry["name"]


FAMILY = """
import numpy as np

from bench.structure import Structure, band_coords, morton_sort


def structure(config):
    n, bs = config["n"], config["leaf"]
    nb = -(-n // bs)
    diag = band_coords(nb, 0)
    row = np.stack([np.zeros(nb, np.int64), np.arange(nb)], 1)
    codes = np.unique(np.concatenate([c[:, 0] * nb + c[:, 1] for c in (diag, row, row[:, ::-1])]))
    coords = np.stack([codes // nb, codes % nb], 1)
    return Structure(n, bs, coords[morton_sort(coords)],
                     lambda r, c: (r == c) | (r < bs) | (c < bs))
"""

DRIVER = """
import time

import torch

from bench.reference.blocksparse import product, product_tasks
from bench.reference.compare import compare
from bench.structure import draw_values
from bench.workload import Answer, dtype_of


class Driver:
    def __init__(self, config, traffic, structure, seed, device, cache=None):
        self.config, self.structure, self.seed = config, structure, seed
        self.device, self.dtype = torch.device(device), dtype_of(config)
        self.traffic = traffic

    def setup(self):
        from repro_torch.core import BSMatrix, SymbolicCache, multiply

        t = time.perf_counter()
        s = self.structure
        values = draw_values(s, self.seed, self.device, self.dtype)
        self.a = BSMatrix(shape=(s.n, s.n), bs=s.bs, coords=s.coords, data=values)
        self.cache, self.multiply = SymbolicCache(), multiply
        self.call()
        return dict(draw_and_warm_s=time.perf_counter() - t)

    def call(self):
        return self.multiply(self.a, self.a, cache=self.cache)

    def answer(self, c):
        return Answer(c.coords, lambda idx: c.data[torch.from_numpy(idx)])

    def counters(self):
        return dict(hits=self.cache.hits, misses=self.cache.misses, build_s=self.cache.build_s,
                    verify_s=self.cache.verify_s)

    def release(self):
        self.a = None

    def judge(self, answers, control=False):
        s = self.structure
        values = draw_values(s, self.seed, self.device, self.dtype)
        tasks = product_tasks(s.coords, s.coords)
        want = product(values, values, tasks)
        work = dict(tasks=tasks.num_tasks, bs=s.bs, a_blocks=s.nnzb, c_blocks=tasks.num_out,
                    dtype=self.config["dtype"])
        return work, {k: compare(tasks.c_coords, want, a.coords, a.blocks, held=a.held)
                      for k, a in answers.items()}
"""


def test_a_cell_added_as_files_only_is_found_and_runs(tmp_path):
    """A configuration of a new family, a mix with a new driver, and a metric,
    each added as new files plus entries: found by name, run, and judged."""
    import io
    import time

    from bench import run as bench_run

    root = make_root(tmp_path)
    for path in (ROOT / "bench").rglob("*"):
        if path.is_file() and "tests" not in path.parts and "__pycache__" not in path.parts:
            assert (root / path.relative_to(ROOT)).read_bytes() == path.read_bytes()
    bench = root / "bench"
    (bench / "families" / "arrow.py").write_text(FAMILY)
    (bench / "drivers" / "single_square.py").write_text(DRIVER)
    (bench / "metrics" / "calls_made.py").write_text("def read(run):\n    return len(run.durations)\n")
    (bench / "traffic" / "single.json").write_text(json.dumps(
        dict(name="single", driver="single_square", kept_call_below=4, held_blocks=8)))
    (bench / "configs" / "tiny_arrow.json").write_text(json.dumps(
        dict(name="tiny_arrow", family="arrow", n=512, leaf=32, dtype="float32")))
    limits = json.loads((bench / "limits" / "band_t1r1.resident.json").read_text())
    (bench / "limits" / "tiny_arrow.single.json").write_text(json.dumps(limits))
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append(dict(name="tiny_arrow", source="a test size", file="bench/configs/tiny_arrow.json",
                             reduced=[], why="a test size"))
    m["workloads"].append(dict(name="tiny_arrow.single", config="tiny_arrow", traffic="single",
                               chips=1, why="a test size"))
    m["per_layer"].append(dict(name="calls_made", unit="count", better="higher", source="host_clock",
                               layer="device", moves="multiply_s", workloads=["tiny_arrow.single",
                                                                               "tiny_band.resident"]))
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    for name in TINY:
        parts = manifest.resolve(f"{name}.resident", root)
        assert parts["config"]["n"] == TINY[name]["n"]
        names = [e["name"] for e, _ in parts["per_layer"]]
        assert ("calls_made" in names) == (name == "tiny_band")
    parts = manifest.resolve("tiny_arrow.single", root)
    assert parts["family"].structure(parts["config"]).nnzb == 16 + 2 * 15
    for trace in (False, True):
        out, err = io.StringIO(), io.StringIO()
        rc = bench_run.run("tiny_arrow.single", 2**31 + 77, 0.2, trace, root=root, device="cpu",
                           t0=time.perf_counter(), out=out, err=err)
        detail, last = (json.loads(x) for x in out.getvalue().strip().splitlines())
        assert rc == 0 and last["correct"] is True and last["attempted"] >= 4
        assert "draw_and_warm_s" in detail["setup_split"]
        if trace:
            assert last["metrics"]["calls_made"]["value"] == last["attempted"]
            assert last["metrics"]["plan_misses"]["value"] == 0
