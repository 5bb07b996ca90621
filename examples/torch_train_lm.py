"""End-to-end LM training with checkpoint/restart on the PyTorch port (reduced olmo-1b).

The port's copy of ``examples/train_lm.py``: trains a reduced config through
the full stack (data pipeline -> train step -> TrainLoop with retries,
straggler detection and background checkpoints).  Kill it mid-run and re-run:
it resumes from the last committed checkpoint.  The loss must fall; a failed
check exits non-zero.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--device cpu] [--steps 300]
"""

import argparse
import os
import shutil
import tempfile

import torch

from repro_torch.configs import reduced_config
from repro_torch.data import TokenPipeline
from repro_torch.models import model as model_mod
from repro_torch.runtime import TrainLoop


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--fresh", action="store_true", help="wipe checkpoints first")
    args = ap.parse_args(argv)
    if args.fresh:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    cfg = reduced_config("olmo-1b")
    pipe = TokenPipeline(cfg, batch=16, seq=64, seed=0)
    step = model_mod.make_train_step(cfg, compute_dtype=torch.float32, lr_peak=3e-3, warmup=20,
                                     total_steps=args.steps)
    loop = TrainLoop(step, pipe, args.ckpt_dir, ckpt_every=100)
    state, start = loop.resume_or_init(model_mod.init_train_state(cfg, seed=0, device=args.device))
    if start:
        print(f"[resume] continuing from step {start}")
    state, hist = loop.run(state, start, args.steps, log_every=25)
    print(
        f"loss: {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} over "
        f"{len(hist)} steps on {args.device} (retries={loop.retries}, "
        f"stragglers={loop.straggler.events})"
    )
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise SystemExit("FAILED: model did not learn")


if __name__ == "__main__":
    main()
