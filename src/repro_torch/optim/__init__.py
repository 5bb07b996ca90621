"""The optimizer: AdamW, global-norm clipping, the cosine schedule, int8 gradient compression."""

from .adamw import adamw_init, adamw_update, clip_by_global_norm, cosine_lr
from .compress import compress_grads, decompress_grads, error_feedback_update

__all__ = [
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "cosine_lr",
    "compress_grads",
    "decompress_grads",
    "error_feedback_update",
]
