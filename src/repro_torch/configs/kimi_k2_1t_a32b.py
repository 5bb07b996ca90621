"""Kimi K2 1T-A32B [arXiv:2501.kimi2; unverified]: MoE 384 experts top-8.

Assigned table prescribes GQA kv=8 (not MLA); expert d_ff=2048.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe", num_layers=61, d_model=7168,
    num_heads=64, num_kv_heads=8, head_dim=112, d_ff=2048,
    vocab_size=163840, mlp_act="silu", norm="rmsnorm",
    num_experts=384, top_k=8, rope_theta=5e4, grad_accum=8,
)
