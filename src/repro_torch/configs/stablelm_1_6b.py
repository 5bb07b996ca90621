"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b; unverified]: dense, LayerNorm."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b", family="dense", num_layers=24, d_model=2048,
    num_heads=32, num_kv_heads=32, d_ff=5632, vocab_size=100352,
    mlp_act="silu", norm="layernorm", rope_theta=1e4,
)
