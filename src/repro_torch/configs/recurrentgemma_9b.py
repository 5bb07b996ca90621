"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427; unverified].

Pattern 1:2 — (rec, rec, local-attn) repeating; RG-LRU recurrence; local
attention window 2048; MQA kv=1.  Sub-quadratic: long_500k runs.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid", num_layers=38, d_model=4096,
    num_heads=16, num_kv_heads=1, head_dim=256, d_ff=12288,
    vocab_size=256000, mlp_act="geglu", norm="rmsnorm",
    tie_embeddings=True, block_pattern=("rec", "rec", "local"),
    window=2048, rope_theta=1e4, sub_quadratic=True, grad_accum=4,
)
