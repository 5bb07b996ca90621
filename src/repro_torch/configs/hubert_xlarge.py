"""HuBERT-XLarge [arXiv:2106.07447; unverified]: encoder-only audio backbone.

Modality frontend (conv feature extractor) is a STUB: input_specs() provides
precomputed 512-d frame embeddings (per assignment spec).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio", num_layers=48, d_model=1280,
    num_heads=16, num_kv_heads=16, d_ff=5120, vocab_size=504,
    mlp_act="gelu", norm="layernorm", kind="encoder",
    positions="sinusoidal", frontend="audio_stub", frontend_dim=512,
)
