"""Learning-rate schedules (warmup + cosine / constant), read at a step
counter held as a tensor: the scale is an f32 tensor on its device."""

from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant"]


def warmup_cosine(step: torch.Tensor, *, warmup: int = 1000, total: int = 100_000,
                  min_ratio: float = 0.1) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    progress = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * progress))
    return warm * cos


def constant(step: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(step, dtype=torch.float32)
