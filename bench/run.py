"""Run one cell of ``BENCHMARK.json`` once on the card.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the structure from the configuration's family, then the
mix's driver: CUDA start, the kernels built on a checkout's first run and
loaded, the inputs drawn from the seed on the card, the layout on the
workers, the warm calls with the plan build and verification), then a
closed loop of the driver's calls for ``--seconds``, each ending in
``torch.cuda.synchronize()``, then the driver's comparison with the plain
reference: the last call's result whole, and a sample of blocks of one
early call, held through the window.  With ``--trace 1`` the window runs under ``torch.profiler`` and
the line carries the per-layer metrics; otherwise the end-to-end ones.

Standard output: one line of detail (the set-up's split, the calls, the
card's name and power limit), then the result as the last line.  Standard error ends with each number compared, beside its limit.
Exits 3 without a result where the card or the cards the cell asks for are
missing, and 4 where a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

_T0 = __import__("time").perf_counter()  # set-up is taken from here

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]  # the checkout's root and the port, not bench/

#: top-level modules that no run may load: JAX and the JAX package
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def _environment(root: Path) -> None:
    """The tile autotuner's cache a file under this side's own temporary
    directory that holds nothing, so that nothing in ``HOME`` changes which
    engine runs.  The port's kernels are built into and loaded from
    ``build/repro_torch_kernels`` in the checkout (``repro_torch.kernels.build``),
    at a path fixed by the source's hash, so only a checkout's first run builds."""
    tune = Path(tempfile.gettempdir()) / "repro-bench-autotune-none.json"
    tune.unlink(missing_ok=True)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(tune)


def card_line(torch) -> dict:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        out = []
    return dict(name=torch.cuda.get_device_name(0), nvidia_smi=out[:1])


def run(workload: str, seed: int, seconds: float, trace: bool, *, root: Path = ROOT,
        device: str = "cuda", t0: float = _T0, marks: dict | None = None, out=None, err=None) -> int:
    """One run of the cell ``workload``; prints its lines and returns the exit code.

    ``marks`` are the seconds of steps taken before the call, as ``main`` takes them."""
    out, err = out or sys.stdout, err or sys.stderr
    from bench import manifest
    from bench.trace_reader import summarize

    _environment(Path(root))
    parts = manifest.resolve(workload, Path(root))
    import numpy as np
    import torch

    from bench.workload import hold

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    traffic = parts["traffic"]
    marks = dict(marks or {})
    split = dict(start_s=time.perf_counter() - t0 - sum(marks.values()), **marks)
    t = time.perf_counter()
    structure = parts["family"].structure(parts["config"])
    split["structure_s"] = time.perf_counter() - t
    driver = parts["driver"].Driver(parts["config"], traffic, structure, seed, device)
    split.update(driver.setup())
    at_setup = driver.counters()
    setup_s = time.perf_counter() - t0
    split["other_s"] = setup_s - sum(split.values())

    rng = np.random.default_rng(seed)
    kept_index = int(rng.integers(0, traffic["kept_call_below"]))
    span = torch.profiler.record_function if trace else (lambda name: contextlib.nullcontext())
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities) if trace else contextlib.nullcontext()
    durations, kept, c = [], None, None
    at_window = driver.counters()
    with profiler as prof:
        with span("bench.window"):
            start = time.perf_counter()
            while True:
                c = None  # the previous result is dropped before the next call
                t = time.perf_counter()
                with span("bench.call"):
                    c = driver.call()
                with span("bench.sync"):
                    sync()
                end = time.perf_counter()
                durations.append(end - t)
                if len(durations) - 1 == kept_index:
                    with span("bench.hold"):
                        kept = hold(driver.answer(c), traffic["held_blocks"], rng)
                if end - start >= seconds:
                    break
    window_s = end - start
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    at_end = driver.counters()
    summary = None
    if trace:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                summary = summarize(json.load(f))

    # the comparison: the program's state freed, the inputs drawn again
    answers = {f"call_{len(durations) - 1}": driver.answer(c)}
    if kept is not None:
        answers[f"call_{kept_index}_held"] = kept
    del c, kept
    driver.release()
    work, results = driver.judge(answers)
    limits = parts["limits"]
    checks = {k: dict(value=max(r[k] for r in results.values()), limit=limits[k]) for k in limits}
    failed = sum(any(not r[k] <= limits[k] for k in limits) for r in results.values())
    correct = failed == 0

    record = types.SimpleNamespace(
        durations=durations, window_s=window_s, setup_s=setup_s, peak_bytes=peak,
        trace=summary, counters=dict(setup=at_setup, window_start=at_window, window_end=at_end),
        work=work,
    )
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for entry, read in parts[kind]:
        value = read(record)
        if value is not None:
            metrics[entry["name"]] = dict(value=value, unit=entry["unit"])
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(0) if cuda else "cpu",
               count=parts["entry"]["chips"], memory_peak_bytes=peak)
    if summary is not None:
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
    ordered = sorted(durations)
    call_s = dict(min=ordered[0], median=ordered[len(ordered) // 2], max=ordered[-1],
                  first_20=sum(durations[:20]) / len(durations[:20]),
                  last_20=sum(durations[-20:]) / len(durations[-20:]))
    detail = dict(workload=workload, seed=seed, calls=len(durations), window_s=window_s, call_s=call_s,
                  kept_call=kept_index if kept_index < len(durations) else None,
                  setup_s=setup_s, setup_split=split, counters_at_setup=at_setup, compared=results,
                  card=card_line(torch) if cuda else None)
    loaded = forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {', '.join(loaded)}", file=err, flush=True)
        return 4
    line = dict(correct=correct, attempted=len(durations), failed=failed, metrics=metrics, device=dev)
    if summary is not None:
        line["breakdown"] = dict(device_ops=summary.top("device_ops"), idle_gaps=summary.top("idle_gaps"))
    line["checks"] = checks
    print(json.dumps(detail), file=out, flush=True)
    for name, chk in checks.items():
        print(f"check {name} = {chk['value']!r} (limit {chk['limit']!r})", file=err, flush=True)
    print(json.dumps(line), file=out, flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t = time.perf_counter()
    import torch

    from bench import manifest

    marks = dict(torch_import_s=time.perf_counter() - t)
    t = time.perf_counter()
    chips = manifest.cell(manifest.load_manifest(ROOT), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    marks["cuda_check_s"] = time.perf_counter() - t
    return run(args.workload, args.seed, args.seconds, bool(args.trace), marks=marks)


if __name__ == "__main__":
    raise SystemExit(main())
