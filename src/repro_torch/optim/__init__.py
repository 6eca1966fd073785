"""Optimizer substrate: AdamW, LR schedules, gradient compression with
error feedback, on dicts of tensors keyed by the parameters' dotted
names."""

from .adamw import AdamWConfig, adamw_init, adamw_update, clip_by_global_norm
from .compress import (
    compress_grads,
    compressed_grad_transform,
    decompress_grads,
    init_error_feedback,
)
from .schedule import constant, warmup_cosine

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "compress_grads",
    "compressed_grad_transform",
    "decompress_grads",
    "init_error_feedback",
    "constant",
    "warmup_cosine",
]
