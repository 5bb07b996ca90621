"""Batched serving on the PyTorch port: greedy decode with a KV cache (reduced qwen2).

The port's copy of ``examples/serve_lm.py``: seeded random weights, four
prompts of 8 tokens, 24 new tokens each; then the hybrid recurrentgemma
(RG-LRU + local attention), whose recurrent layers keep state caches.  The
generated sequences must keep their prompts; a failed check exits non-zero.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""

import argparse
import time

import numpy as np

from repro_torch.configs import reduced_config
from repro_torch.launch.serve import generate
from repro_torch.models import transformer


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    dev = ap.parse_args(argv).device

    cfg = reduced_config("qwen2-0.5b")
    params = transformer.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    B, P, G = 4, 8, 24
    prompts = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)

    t0 = time.perf_counter()
    seqs = generate(cfg, params, prompts, G, device=dev)
    dt = time.perf_counter() - t0
    check(seqs.shape == (B, P + G), f"shape {seqs.shape}")
    check((seqs[:, :P] == prompts).all(), "prompt must be preserved")
    check(((seqs >= 0) & (seqs < cfg.vocab_size)).all(), "a token outside the vocabulary")
    print(f"generated {B}x{P + G} tokens in {dt:.2f}s on {dev}")
    for i, s in enumerate(seqs[:2]):
        print(f"seq {i}: prompt={s[:P].tolist()} -> gen={s[P:].tolist()}")

    # hybrid (recurrent + local attention) serving exercises state caches
    cfg2 = reduced_config("recurrentgemma-9b")
    params2 = transformer.init_params(cfg2, seed=1, device=dev)
    seqs2 = generate(cfg2, params2, prompts[:2], 8, device=dev)
    check(seqs2.shape == (2, P + 8) and (seqs2[:, :P] == prompts[:2]).all(),
          "recurrentgemma: prompt must be preserved")
    print(f"recurrentgemma reduced decode ok: {seqs2.shape}")


if __name__ == "__main__":
    main()
