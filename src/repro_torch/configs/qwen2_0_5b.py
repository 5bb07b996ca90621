"""Qwen2-0.5B [arXiv:2407.10671; hf]: dense, GQA kv=2, QKV bias, tied embeds."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b", family="dense", num_layers=24, d_model=896,
    num_heads=14, num_kv_heads=2, head_dim=64, d_ff=4864,
    vocab_size=151936, qkv_bias=True, mlp_act="silu", norm="rmsnorm",
    tie_embeddings=True, rope_theta=1e6,
)
