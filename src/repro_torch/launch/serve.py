"""Batched decode: greedy generation over a KV cache.

Port of the JAX package's ``repro/launch/serve.py``.  Runs on the card
unless ``--device cpu`` is asked for::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --batch 4 --prompt-len 8 --gen 32

:func:`generate` keeps the reference's signature (one device, no ``ctx``).
On a mesh, :func:`generate_on_mesh` drives ``make_serve_step(cfg, ctx)``
greedily on every rank; :func:`greedy_tokens` takes the argmax of
vocab-sharded logits as a local max and index followed by one gather over
the vocab's mesh axes.
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
from ..sharding import rules

__all__ = ["generate", "generate_on_mesh", "greedy_tokens"]

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


def greedy_tokens(ctx, logits) -> torch.Tensor:
    """The argmax over the vocab of a ``DTensor`` of logits ``[B, 1, vocab]``
    (the first index of the largest value, as ``torch.argmax``), ``[B, 1]``
    int64 on every rank.

    Each rank takes the max and its index over its vocab block; one gather
    over the vocab's mesh axes brings every block's (value, index) pair, and
    the first largest wins.  A second gather over the batch's axes brings
    every row."""
    spec = rules.spec_of(ctx, logits)
    local = logits.to_local()[:, 0].float()  # [B_l, V_l]
    idx = local.argmax(-1)
    best = local.gather(-1, idx[:, None])[:, 0]
    vocab_axes = rules.mesh_axes(spec[2])
    if vocab_axes:
        part = 0
        for a in vocab_axes:
            part = part * ctx.axis_sizes[a] + rules.axis_index(ctx, a)
        idx = idx + part * local.shape[-1]
        # (value, index) in float64: exact for every index below 2**53
        pairs = rules.all_gather(ctx, torch.stack([best.double(), idx.double()], -1)[:, None],
                                 vocab_axes, dim=1)  # [B_l, parts, 2]
        win = pairs[..., 0].argmax(-1)  # the first part holding the largest value
        idx = pairs[..., 1].gather(1, win[:, None])[:, 0].long()
    if spec[0] is not None:
        idx = rules.all_gather(ctx, idx, spec[0], dim=0)
    return idx[:, None]


@torch.inference_mode()
def generate_on_mesh(ctx, cfg, params, prompts: np.ndarray, gen: int, *, dtype=torch.float32,
                     device="cuda", return_logits: bool = False):
    """:func:`generate` on a mesh: every rank calls it with its ``DTensor``
    parameters (:func:`repro_torch.runtime.elastic.reshard_state`) and the same
    prompts; every rank returns the ``[B, P + gen]`` tokens.

    The cache is sharded by ``ctx``'s rules (:func:`transformer.init_cache`),
    the steps are ``make_serve_step(cfg, ctx)``'s, and the next token is
    :func:`greedy_tokens`'.  ``return_logits`` adds this rank's block of every
    step's logits, ``[B_l, P + gen - 1, vocab_l]`` fp32.
    """
    dev = resolve_device(device)
    B, P = prompts.shape
    max_len = P + gen
    cache = transformer.init_cache(cfg, B, max_len, dtype, device=dev, ctx=ctx)
    serve = model_mod.make_serve_step(cfg, ctx, compute_dtype=dtype)
    prompts_t = torch.from_numpy(np.asarray(prompts, dtype=np.int64)).to(dev)
    tok = prompts_t[:, :1]
    out, steps = [tok], []
    for pos in range(max_len - 1):
        logits, cache = serve(params, cache, tok, pos)
        if return_logits:
            steps.append(logits.to_local()[:, 0].float())
        if pos + 1 < P:
            tok = prompts_t[:, pos + 1:pos + 2]  # teacher-force the prompt
        else:
            tok = greedy_tokens(ctx, logits)
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
