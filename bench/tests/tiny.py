"""A copy of the benchmark with small cells added as files only, for runs on the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: small members of both families: leaf 32, 2 workers, the square across the workers' boundary
TINY = {
    "tiny_band": dict(family="banded", n=1024, half_bandwidth=100, workers=2, leaf=32,
                      dtype="float32", control="tf32"),
    "tiny_random": dict(family="random_blocks", n=1024, half_bandwidth=60, square=200,
                        square_seed=0, workers=2, leaf=32, dtype="float32", control="tf32"),
}


def make_root(tmp: Path) -> Path:
    """``BENCHMARK.json`` and ``bench/`` copied to ``tmp``, and for each of :data:`TINY`
    a configuration, a limits file and a cell on the ``resident`` mix, added as new
    files and new entries: no file that was copied is edited but the manifest."""
    root = Path(tmp) / "checkout"
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    limits = json.loads((ROOT / "bench" / "limits" / "band_t1r1.resident.json").read_text())
    for name, cfg in TINY.items():
        (root / "bench" / "configs" / f"{name}.json").write_text(
            json.dumps(dict(name=name, **cfg)))
        (root / "bench" / "limits" / f"{name}.resident.json").write_text(json.dumps(limits))
        manifest["configs"].append(dict(name=name, source="a test size", file=f"bench/configs/{name}.json",
                                        reduced=[], why="a test size"))
        manifest["workloads"].append(dict(name=f"{name}.resident", config=name, traffic="resident",
                                          chips=1, why="a test size"))
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root
