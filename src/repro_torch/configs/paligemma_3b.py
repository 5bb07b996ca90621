"""PaliGemma-3B [arXiv:2407.07726; hf]: SigLIP (stubbed) + Gemma decoder.

Prefix-LM attention: image patches + prompt attend bidirectionally, suffix
is causal.  input_specs() provides precomputed patch embeddings.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b", family="vlm", num_layers=18, d_model=2048,
    num_heads=8, num_kv_heads=1, head_dim=256, d_ff=16384,
    vocab_size=257216, mlp_act="geglu", norm="rmsnorm",
    tie_embeddings=True, rope_theta=1e4, frontend="vision_stub",
    num_patches=256,
)
