"""Perf hillclimbing: re-run a dry-run cell under a named variant and diff the terms.

Port of the JAX package's ``repro/launch/hillclimb.py``.  Each variant
encodes one hypothesis; :data:`VARIANTS` is the reference's table.  Those
that change what one card runs go through :func:`repro_torch.launch.dryrun.lower_cell`:
``accum*`` (microbatches), ``remat_*``, ``kv_int8``, ``moe_cf*`` and
``bf16master``.  The rest change only how work is split across cards —
sequence parallelism (``sp*``), gradients pinned to the parameter sharding
(``gradrs``, ``bf16_rs*``) and the decode MoE's token dispatch
(``token_dispatch``) — and are recorded as ``needs_multi_card``: they wait
for the multi-card slice, and nothing is faked for them.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch qwen2-72b \\
      --shape train_4k --variant accum4 --out results/hillclimb_torch
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from .dryrun import lower_cell

__all__ = ["VARIANTS", "MULTI_CARD", "run_variant"]

VARIANTS = {
    # H-accum: FSDP re-gathers weights once per microbatch; collective term
    # should scale ~linearly with grad_accum.
    "baseline": {},
    "accum8": dict(grad_accum=8),
    "accum4": dict(grad_accum=4),
    "accum2": dict(grad_accum=2),
    "accum1": dict(grad_accum=1),
    # H-remat: 'dots' keeps matmul outputs, removing recompute flops at the
    # cost of activation memory (useful_flops_ratio up, memory term up).
    "remat_dots": dict(cfg_overrides={"remat": "dots"}),
    "remat_none": dict(cfg_overrides={"remat": "none"}),
    # H-sp: Megatron-style sequence parallelism — residual stream sharded
    # over the model axis between blocks.
    "sp": dict(rules_override={"seq": ("model",)}),
    # H-kv8: int8 KV cache halves decode cache bytes; scales applied to
    # logits, never to the cache.
    "kv_int8": dict(kv_dtype=torch.int8),
    # H-cf: MoE capacity factor (dispatch padding waste vs drop rate).
    "moe_cf1": dict(cfg_overrides={"moe_capacity_factor": 1.0}),
    "moe_cf2": dict(cfg_overrides={"moe_capacity_factor": 2.0}),
    # H-bf16: bf16 params + fp32 master -> bf16 weight-grad reductions.
    "bf16master": dict(train_opts={"param_dtype": "bf16"}),
    # H-rs: pin grads to param sharding -> reduce-scatter instead of AR.
    "gradrs": dict(train_opts={"grad_reshard": True}),
    "bf16_rs": dict(train_opts={"param_dtype": "bf16", "grad_reshard": True}),
    "bf16_rs_accum4": dict(train_opts={"param_dtype": "bf16", "grad_reshard": True},
                           grad_accum=4),
    "bf16_rs_accum1": dict(train_opts={"param_dtype": "bf16", "grad_reshard": True},
                           grad_accum=1),
    # H-dispatch: decode MoE moves tokens, not expert weights.
    "token_dispatch": dict(),
    # combos
    "sp_accum4": dict(grad_accum=4, rules_override={"seq": ("model",)}),
    "sp_accum1": dict(grad_accum=1, rules_override={"seq": ("model",)}),
    "sp_accum2": dict(grad_accum=2, rules_override={"seq": ("model",)}),
    "sp_accum4_dots": dict(grad_accum=4, rules_override={"seq": ("model",)},
                           cfg_overrides={"remat": "dots"}),
}

#: variants whose hypothesis is about splitting work across cards
MULTI_CARD = frozenset(k for k in VARIANTS if k.startswith(("sp", "gradrs", "bf16_rs"))
                       or k == "token_dispatch")


def run_variant(arch: str, shape, variant: str, multi_pod: bool = False, *,
                cfg_overrides=None) -> dict:
    """The dry-run record of ``arch`` x ``shape`` under ``variant``;
    ``cfg_overrides`` (a reduced config's, say) apply beneath the variant's.
    ``multi_pod`` only labels the record's mesh, as in :func:`lower_cell`."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if variant in MULTI_CARD:
        return {"arch": arch, "shape": getattr(shape, "name", shape),
                "mesh": "2x16x16" if multi_pod else "16x16", "variant": variant,
                "status": "needs_multi_card",
                "why": "the variant changes how work is split across cards; "
                       "it waits for the multi-card slice"}
    kw = dict(VARIANTS[variant])
    if cfg_overrides:
        base = {k: v for k, v in cfg_overrides.items()
                if not (k == "grad_accum" and "grad_accum" in kw)}
        kw["cfg_overrides"] = {**base, **kw.get("cfg_overrides", {})}
    if "train_opts" in kw:
        topts = dict(kw["train_opts"])
        if topts.get("param_dtype") == "bf16":
            topts["param_dtype"] = torch.bfloat16
        kw["train_opts"] = topts
    rec = lower_cell(arch, shape, multi_pod, **kw)
    rec["variant"] = variant
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", required=True, choices=sorted(VARIANTS))
    ap.add_argument("--out", default="results/hillclimb_torch")
    args = ap.parse_args(argv)
    rec = run_variant(args.arch, args.shape, args.variant)
    os.makedirs(args.out, exist_ok=True)
    fn = f"{args.arch}__{args.shape}__{args.variant}.json"
    with open(os.path.join(args.out, fn), "w") as f:
        json.dump(rec, f, indent=1)
    if rec["status"] == "ok":
        print(f"[{args.variant}] {args.arch}|{args.shape}: compute={rec['compute_term_s']:.3f}s "
              f"memory={rec['memory_term_s']:.3f}s useful={rec['useful_flops_ratio']:.2f} "
              f"frac={rec['roofline_fraction']:.3f} peak={rec['peak_bytes_card'] / 2**30:.1f}GiB")
    else:
        print(f"[{args.variant}] {rec['status']}: {rec.get('error', rec.get('why'))}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
