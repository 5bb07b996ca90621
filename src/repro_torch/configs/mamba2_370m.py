"""Mamba2-370M [arXiv:2405.21060; unverified]: attention-free SSD.

d_inner = 2*d_model, headdim 64 -> 32 ssm heads; d_state 128.
Sub-quadratic: long_500k runs (O(1) decode state).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm", num_layers=48, d_model=1024,
    num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=50280,
    norm="rmsnorm", tie_embeddings=True, block_pattern=("ssm",),
    positions="none", d_inner=2048, ssm_heads=32, ssm_state=128,
    sub_quadratic=True,
)
