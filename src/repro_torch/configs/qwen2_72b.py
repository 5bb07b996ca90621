"""Qwen2-72B [arXiv:2407.10671; hf]: dense, GQA kv=8, QKV bias."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b", family="dense", num_layers=80, d_model=8192,
    num_heads=64, num_kv_heads=8, head_dim=128, d_ff=29568,
    vocab_size=152064, qkv_bias=True, mlp_act="silu", norm="rmsnorm",
    rope_theta=1e6, grad_accum=16,
)
