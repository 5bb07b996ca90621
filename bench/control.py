"""The control and the program's readings for a cell's limits, seed by seed, in one process.

    python bench/control.py --workload <cell> --seeds 11 12 13 ...

For each seed: the cell's set-up and one more call through the program's
timed path (one plan cache for all seeds, since the structure is the
seed's alike), then the driver's judge: the plain reference in float64, and
the control, the reference computed in the configuration's ``control``
precision and put in the program's place (for float32 with TF32 off:
TF32, operands rounded to 10 mantissa bits, sums in float32).  One JSON line a seed, then one with the
program's largest and the control's smallest reading of each number: the
lower and upper readings a limit is set between.  The benchmark's own runs
do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]


def readings(workload: str, seeds, *, root: Path = ROOT, device: str = "cuda", out=None) -> dict:
    import torch

    from bench import manifest
    from bench.run import _environment

    out = out or sys.stdout
    _environment(Path(root))
    parts = manifest.resolve(workload, Path(root))
    structure = parts["family"].structure(parts["config"])
    cache, rows = None, []
    for seed in seeds:
        driver = parts["driver"].Driver(parts["config"], parts["traffic"], structure, seed, device,
                                        cache=cache)
        driver.setup()
        cache = driver.cache
        c = driver.call()
        if device == "cuda":
            torch.cuda.synchronize()
        answers = {"program": driver.answer(c)}
        del c
        driver.release()
        _, res = driver.judge(answers, control=True)
        row = dict(seed=seed, **res)
        rows.append(row)
        print(json.dumps(row), file=out, flush=True)
    names = rows[0]["program"].keys()
    summary = dict(workload=workload, seeds=list(seeds),
                   program_max={k: max(r["program"][k] for r in rows) for k in names},
                   control_min={k: min(r["control"][k] for r in rows) for k in names},
                   limits=parts["limits"])
    print(json.dumps(summary), file=out, flush=True)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    readings(args.workload, args.seeds)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
