"""``BENCHMARK.json`` and the files it names, found by name.

A cell's configuration is the file its entry in ``configs`` names
(``bench/configs/<config>.json``); the configuration's ``family`` is the
module that makes its structure (``bench/families/<family>.py``).  Its
traffic mix is ``bench/traffic/<traffic>.json``, whose ``driver`` is the
module that sets the program up and sends one call
(``bench/drivers/<driver>.py``).  Its limits are ``bench/limits/<cell>.json``
and each metric's reader ``bench/metrics/<metric>.py``.  Adding a cell, a
configuration, a family, a mix, a driver or a metric is adding files and
entries: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = "bench"


def load_manifest(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for entry in manifest["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_path(manifest: dict, name: str, root: Path = ROOT) -> Path:
    for entry in manifest["configs"]:
        if entry["name"] == name:
            return Path(root) / entry["file"]
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic_path(name: str, root: Path = ROOT) -> Path:
    return Path(root) / BENCH / "traffic" / f"{name}.json"


def limits_path(workload: str, root: Path = ROOT) -> Path:
    return Path(root) / BENCH / "limits" / f"{workload}.json"


def module_path(kind: str, name: str, root: Path = ROOT) -> Path:
    """``bench/<kind>/<name>.py``: a family, a driver or a metric's reader."""
    return Path(root) / BENCH / kind / f"{name}.py"


def load_module(kind: str, name: str, root: Path = ROOT):
    """The module ``bench/<kind>/<name>.py`` of the checkout at ``root``."""
    path = module_path(kind, name, root)
    if not path.is_file():
        raise KeyError(f"no {kind} module {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metrics_of(manifest: dict, workload: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that this cell reports."""
    return [m for m in manifest[kind] if workload in m.get("workloads", [workload])]


def load_reader(name: str, root: Path = ROOT):
    """The ``read(run)`` function of ``bench/metrics/<name>.py``."""
    return load_module("metrics", name, root).read


def resolve(workload: str, root: Path = ROOT) -> dict:
    """Everything one cell is made of: its entry, configuration, structure
    family, traffic mix, driver, limits, and the readers of its metrics."""
    manifest = load_manifest(root)
    entry = cell(manifest, workload)
    config = _load_json(config_path(manifest, entry["config"], root))
    traffic = _load_json(traffic_path(entry["traffic"], root))
    return dict(
        entry=entry,
        config=config,
        family=load_module("families", config["family"], root),
        traffic=traffic,
        driver=load_module("drivers", traffic["driver"], root),
        limits=_load_json(limits_path(workload, root))["limits"],
        end_to_end=[(m, load_reader(m["name"], root)) for m in metrics_of(manifest, workload, "end_to_end")],
        per_layer=[(m, load_reader(m["name"], root)) for m in metrics_of(manifest, workload, "per_layer")],
    )
