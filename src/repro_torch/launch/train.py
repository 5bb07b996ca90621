"""End-to-end training entry point: checkpointed, restartable, straggler-aware.

Port of the JAX package's ``repro/launch/train.py``, with its flags and
summary lines.  Runs any of the ten architectures (reduced or full config)
on the card unless ``--device cpu`` is asked for::

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --batch 4 --seq 1024 --steps 8 --dtype bfloat16
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --reduced \\
      --steps 200 --batch 8 --seq 64 --device cpu

Run the same command again after killing it: it resumes from the last
committed checkpoint, bitwise identically (stateless data pipeline).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from ..configs import get_config, reduced_config
from ..core.matrix import resolve_device
from ..data import TokenPipeline
from ..models import model as model_mod
from ..runtime.fault_tolerance import TrainLoop
from ..tree import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    dev = resolve_device(args.device)
    pipe = TokenPipeline(cfg, batch=args.batch, seq=args.seq, seed=args.seed)
    step_fn = model_mod.make_train_step(
        cfg,
        compute_dtype=getattr(torch, args.dtype),
        lr_peak=args.lr,
        warmup=max(args.steps // 10, 1),
        total_steps=args.steps,
        grad_accum=args.grad_accum,
    )

    loop = TrainLoop(step_fn, pipe, args.ckpt_dir, ckpt_every=args.ckpt_every)
    init = model_mod.init_train_state(cfg, seed=args.seed, device=dev)
    state, start = loop.resume_or_init(init)
    if start:
        print(f"resumed from checkpoint at step {start}")
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    print(f"arch={cfg.name} params={n_params/1e6:.2f}M steps {start}..{start + args.steps}")
    state, hist = loop.run(state, start, args.steps)
    print(
        f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}; "
        f"retries={loop.retries} stragglers={loop.straggler.events}"
    )


if __name__ == "__main__":
    main()
