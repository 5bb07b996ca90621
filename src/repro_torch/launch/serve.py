"""Batched decode: greedy generation over a KV cache.

Port of the JAX package's ``repro/launch/serve.py``.  Runs on the card
unless ``--device cpu`` is asked for::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --batch 4 --prompt-len 8 --gen 32
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_config, reduced_config
from ..core.matrix import resolve_device
from ..models import model as model_mod
from ..models import transformer
from ..obs.timing import Stopwatch

__all__ = ["generate"]

@torch.inference_mode()
def generate(cfg, params, prompts: np.ndarray, gen: int, *, dtype=torch.float32, device="cuda",
             return_logits: bool = False):
    """prompts: ``[B, P]`` int.  Greedy decode; the prompt is fed token by token.

    Returns the ``[B, P + gen]`` token array, and with ``return_logits`` also
    the logits of every step, ``[B, P + gen - 1, vocab]`` fp32 on the device
    (step ``t`` consumed token ``t`` and predicts token ``t + 1``).
    """
    dev = resolve_device(device)
    B, P = prompts.shape
    max_len = P + gen
    cache = transformer.init_cache(cfg, B, max_len, dtype, device=dev)
    serve = model_mod.make_serve_step(cfg, compute_dtype=dtype)
    prompts_t = torch.from_numpy(np.asarray(prompts, dtype=np.int64)).to(dev)
    tok = prompts_t[:, :1]
    out, steps = [tok], []
    for pos in range(max_len - 1):
        logits, cache = serve(params, cache, tok, pos)
        if return_logits:
            steps.append(logits[:, 0].float())
        if pos + 1 < P:
            tok = prompts_t[:, pos + 1:pos + 2]  # teacher-force the prompt
        else:
            tok = torch.argmax(logits[:, 0], dim=-1)[:, None]  # greedy
        out.append(tok)
    seqs = torch.cat(out, dim=1).cpu().numpy()
    if return_logits:
        return seqs, torch.stack(steps, dim=1)
    return seqs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if cfg.kind == "encoder":
        raise SystemExit("encoder archs have no decode step")
    dev = resolve_device(args.device)
    params = transformer.init_params(cfg, seed=args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))

    sw = Stopwatch()
    seqs = generate(cfg, params, prompts, args.gen, device=dev)
    dt = sw.elapsed()
    total_tokens = args.batch * (args.prompt_len + args.gen)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"arch={cfg.name} device={name} generated {seqs.shape} in {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s)")
    print("first sequence:", seqs[0].tolist())


if __name__ == "__main__":
    main()
