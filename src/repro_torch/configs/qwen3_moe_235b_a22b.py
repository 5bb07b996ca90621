"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-*; hf]: MoE 128 experts top-8."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe", num_layers=94, d_model=4096,
    num_heads=64, num_kv_heads=4, head_dim=128, d_ff=1536,
    vocab_size=151936, mlp_act="silu", norm="rmsnorm",
    num_experts=128, top_k=8, rope_theta=1e6, grad_accum=4,
)
