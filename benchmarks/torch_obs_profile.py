"""Where the observatory's main-thread time goes on the warm resident pipeline.

Runs ``benchmarks/torch_trace_overhead.py``'s pipeline (``dist_sqrt_inv_pipeline``
on 8 workers from the all-on-worker-0 layout, ``chip_smoke._hamiltonian``'s
banded problem) with its ``full_observatory(sync=False)`` and splits the
main thread's extra time by observer, two ways:

* **entry points**: each observer entry point (tracer spans, counters and
  gauges, the dispatch annotation, the memory meter, the locality ledger, the
  health monitor, the event log) is wrapped in a ``perf_counter`` pair that
  counts only its outermost call, so nothing is counted twice; the wrapper
  adds about 0.2 us a call;
* **cProfile**: the cumulative time of every observer function entered from
  a caller that is not an observer (cProfile slows small Python functions
  several times over; it ranks the callers, the entry points time them).

Each observed run ends with one ``LocalityLedger.summary()``, the read that
resolves the ledger's deferred per-worker accounts and lineage, so the
locality figure counts what a user of the ledger pays for, not only its
per-dispatch part (listed apart as ``locality_read_ms``).  The pipeline's
plan cache is warm and one observed run fills the observers' per-plan
caches first, as the overhead gate's rounds find them.
``IterationScope`` and ``timed_into`` run with the observers off as well
and are listed apart.  ``--src`` imports ``repro_torch`` from another copy
of the package (an older tree unpacked with ``git archive``), so two trees
are split by the same script.  The host code is the card's, so the split
holds on the CPU; the wall clock of a shared CPU is noisy, so compare
trees within one call.  It runs on the card unless ``--device cpu`` is given.

Run:  python benchmarks/torch_obs_profile.py [--device cpu] [--n 1024 --bs 16 --runs 5]
      [--src OTHER/src] [--out FILE.json]
"""

from __future__ import annotations

import argparse
import cProfile
import gc
import json
import os
import pstats
import sys
import time

import torch_bench  # noqa: F401  (puts this tree's src on the path)

#: (module, owner, attribute names, observer) of every observer entry point
ENTRY_POINTS = (
    ("repro_torch.obs.tracer", "Tracer", ("span", "instant", "counter", "gauge", "sync"),
     "tracer"),
    ("repro_torch.obs.tracer", "Span", ("__enter__", "__exit__"), "tracer"),
    ("repro_torch.obs.tracer", "_SpanHandle", ("__enter__", "__exit__"), "tracer"),
    ("repro_torch.obs.tracer", "Counter", ("add",), "tracer"),
    ("repro_torch.obs.tracer", "Gauge", ("set",), "tracer"),
    ("repro_torch.dist.multiply", None, ("_annotate_spgemm_dispatch",), "tracer"),
    ("repro_torch.dist.multiply", None, ("_note_dispatch_memory",), "memory"),
    ("repro_torch.obs.memory", "MemoryMeter", ("note_bytes", "note_matrix", "note_plan"),
     "memory"),
    ("repro_torch.dist.multiply", None, ("_note_dispatch_locality",), "locality"),
    ("repro_torch.obs.locality", "LocalityLedger",
     ("note_dispatch", "snapshot", "delta", "summary", "moved_blocks"), "locality"),
    ("repro_torch.obs.locality", None, ("locality_iteration",), "locality"),
    ("repro_torch.obs.health", "HealthMonitor", ("observe", "maybe_refit"), "health"),
    ("repro_torch.obs.log", "EventLog", ("info", "debug", "warn", "emit"), "log"),
    ("repro_torch.obs.timing", "timed_into", ("__enter__", "__exit__"), "shared"),
    ("repro_torch.obs.timing", "IterationScope", ("__enter__", "__exit__", "annotate", "row"),
     "shared"),
)


def wrap_entry_points(acc: dict) -> None:
    """Replace every entry point by a timing wrapper adding into ``acc[label]``."""
    import importlib

    depth = [0]

    def wrap(owner, name, label):
        f = owner.__dict__[name] if isinstance(owner, type) else getattr(owner, name)

        def timed(*a, **k):
            if depth[0]:
                return f(*a, **k)
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return f(*a, **k)
            finally:
                n, s = acc.get(label, (0, 0.0))
                acc[label] = (n + 1, s + time.perf_counter() - t0)
                depth[0] -= 1

        setattr(owner, name, timed)

    for mod_name, cls, names, observer in ENTRY_POINTS:
        mod = importlib.import_module(mod_name)
        owner = getattr(mod, cls, None) if cls else mod
        if owner is None:  # a tree without this class
            continue
        for name in names:
            if name in (owner.__dict__ if isinstance(owner, type) else vars(owner)):
                wrap(owner, name, (observer, f"{cls or mod_name.rsplit('.', 1)[1]}.{name}"))


def profile_split(stats: pstats.Stats, runs: int) -> dict:
    """cProfile: cumulative seconds a run of each observer function entered
    from a non-observer caller, by observer."""
    observer_of = {}
    for mod_name, cls, names, observer in ENTRY_POINTS:
        for name in names:
            observer_of[(mod_name.rsplit(".", 1)[1] + ".py", name)] = observer
    helpers = {"_annotate_spgemm_dispatch", "_note_dispatch_memory", "_note_dispatch_locality",
               "_plan_obs_static"}

    def label(k):
        fname = os.path.basename(k[0])
        if "/obs/" in k[0].replace(os.sep, "/"):
            return fname[:-3] if fname[:-3] in ("tracer", "memory", "locality", "health",
                                                "log") else "shared"
        if k[2] in helpers:
            return observer_of.get(("multiply.py", k[2]), "tracer")
        return None

    out: dict = {}
    for k, v in stats.stats.items():
        obs = label(k)
        if obs is None:
            continue
        for caller, cv in v[4].items():
            if label(caller) is None:
                fn = f"{os.path.basename(k[0])}:{k[2]}"
                out.setdefault(obs, {})[fn] = out.get(obs, {}).get(fn, 0.0) + cv[3] / runs
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--bs", type=int, default=16)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--src", default=None, help="import repro_torch from this directory")
    ap.add_argument("--out", default=None, help="write the split as JSON here")
    args = ap.parse_args(argv)
    if args.src:
        sys.path.insert(0, os.path.abspath(args.src))
    import numpy as np

    import torch_trace_overhead as tto
    from repro_torch.core.distributed import make_worker_mesh
    from repro_torch.dist import PlanCache, scatter

    dev = torch_bench.device(args.device)
    mesh = make_worker_mesh(tto.P, dev)
    s, ham, nocc = tto.problem(args.n, args.bs, device=dev, card=True)
    d_s = scatter(s, mesh, owner=np.zeros(s.nnzb, dtype=np.int32))
    d_h = scatter(ham, mesh, owner=np.zeros(ham.nnzb, dtype=np.int32))
    cache = PlanCache(max_entries=4096)

    def run(observed: bool):
        cache.tracer = cache.event_log = cache.memory_meter = cache.locality_ledger = None
        kw = tto.full_observatory(sync=False) if observed else {}
        installed = {key: kw.pop(key).install(cache) for key in ("memory", "locality")
                     if key in kw}
        tto.run_once(d_s, d_h, nocc, mesh, cache, **kw)
        if "locality" in installed:
            installed["locality"].summary()  # the deferred work, once a run
        return kw

    run(False)
    run(False)
    run(True)  # the observers' per-plan caches, as the gate's rounds find them
    import repro_torch

    print(f"repro_torch from {os.path.dirname(repro_torch.__file__)}; n={args.n} bs={args.bs} "
          f"nnzb(S)={s.nnzb} runs={args.runs} (card: {torch_bench.card_line(dev)})")

    prof = cProfile.Profile()
    for _ in range(args.runs):
        prof.enable()
        run(True)
        prof.disable()
    by_fn = profile_split(pstats.Stats(prof), args.runs)

    acc: dict = {}
    wrap_entry_points(acc)
    gc.collect()
    main_cpu = []
    for _ in range(args.runs):
        gc.disable()
        c0 = time.thread_time()
        kw = run(True)
        main_cpu.append(time.thread_time() - c0)
        gc.enable()
    tr = kw["tracer"]
    entry = {}
    for (observer, fn), (calls, sec) in acc.items():
        entry.setdefault(observer, {})[fn] = dict(calls=calls / args.runs,
                                                  ms=sec / args.runs * 1e3)
    payload = dict(
        meta=dict(n=args.n, bs=args.bs, runs=args.runs, device=str(dev),
                  card=torch_bench.card_line(dev), src=os.path.dirname(repro_torch.__file__)),
        observed_main_cpu_ms=sorted(t * 1e3 for t in main_cpu),
        spans=len(tr.spans), instants=len(tr.instants), counter_events=len(tr._counter_events),
        entry_points_ms={o: sum(v["ms"] for v in fns.values()) for o, fns in entry.items()},
        entry_points=entry,
        locality_read_ms=sum(v["ms"] for fn, v in entry.get("locality", {}).items()
                             if fn in ("LocalityLedger.summary", "LocalityLedger.moved_blocks")),
        cprofile_ms={o: sum(fns.values()) * 1e3 for o, fns in by_fn.items()},
        cprofile={o: {fn: t * 1e3 for fn, t in fns.items()} for o, fns in by_fn.items()},
    )
    print(f"observed run: main-thread CPU {sorted(round(t * 1e3, 1) for t in main_cpu)} ms; "
          f"{payload['spans']} spans, {payload['instants']} instants, "
          f"{payload['counter_events']} counter events a run")
    print(f"{'observer':10s} {'entry points ms/run':>20s} {'cProfile ms/run':>16s}")
    for o in ("tracer", "locality", "memory", "health", "log", "shared"):
        print(f"{o:10s} {payload['entry_points_ms'].get(o, 0.0):20.3f} "
              f"{payload['cprofile_ms'].get(o, 0.0):16.3f}")
    print(f"{'':10s} (locality: {payload['locality_read_ms']:.3f} ms of it in the read, "
          f"LocalityLedger.summary)")
    own = sum(v for o, v in payload["entry_points_ms"].items() if o != "shared")
    print(f"{'observers':10s} {own:20.3f} "
          f"{sum(v for o, v in payload['cprofile_ms'].items() if o != 'shared'):16.3f}")
    for o, fns in sorted(entry.items()):
        top = sorted(fns.items(), key=lambda kv: -kv[1]["ms"])[:4]
        print(f"  {o}: " + ", ".join(f"{fn} {v['ms']:.2f} ms ({v['calls']:.0f} calls)"
                                     for fn, v in top))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(payload, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
