"""Architecture registry: one module per assigned architecture (a copy of the JAX package's, so the port imports nothing of it)."""

from __future__ import annotations

import importlib

from .base import SHAPES, ArchConfig, ShapeSpec

ARCH_IDS = [
    "qwen2-72b",
    "qwen2-0.5b",
    "olmo-1b",
    "stablelm-1.6b",
    "kimi-k2-1t-a32b",
    "qwen3-moe-235b-a22b",
    "hubert-xlarge",
    "paligemma-3b",
    "recurrentgemma-9b",
    "mamba2-370m",
]


def get_config(name: str) -> ArchConfig:
    mod = importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}"
    )
    return mod.CONFIG


def reduced_config(name: str) -> ArchConfig:
    """Smoke-test variant: same family/topology, tiny dims (CPU-runnable)."""
    import dataclasses

    cfg = get_config(name)
    heads = min(cfg.num_heads, 4) if cfg.num_heads else 0
    kv = min(cfg.num_kv_heads, heads) if cfg.num_kv_heads else 0
    pat_len = len(cfg.block_pattern)
    layers = max(2 * pat_len, 4)
    if pat_len > 1:
        layers = pat_len + 2  # one full period + remainder coverage
    return dataclasses.replace(
        cfg,
        num_layers=layers,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16 if cfg.num_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        num_experts=min(cfg.num_experts, 8),
        top_k=min(cfg.top_k, 2),
        d_inner=128 if cfg.d_inner else 0,
        ssm_heads=4 if cfg.ssm_heads else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        window=16 if cfg.window else 0,
        frontend_dim=32 if cfg.frontend_dim else 0,
        num_patches=4 if cfg.num_patches else 0,
        remat="none",
        grad_accum=1,
        moe_capacity_factor=8.0,  # ~dropless at smoke scale (parity tests)
    )


__all__ = ["ARCH_IDS", "get_config", "reduced_config", "ArchConfig", "SHAPES", "ShapeSpec"]
