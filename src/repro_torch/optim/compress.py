"""Gradient compression: int8 quantisation with error feedback.

Each gradient leaf is quantised to int8 with a per-leaf scale, and the
quantisation residual is kept in an error-feedback buffer that is added
back into the next step's gradient, which keeps the cumulative applied
gradient unbiased.  On one device the round trip stands where the data-
parallel collective would sit between its two halves (it arrives with
sharding).  Leaves are dicts of tensors keyed by the parameters' dotted
names; ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

import torch

__all__ = ["init_error_feedback", "compress_grads", "decompress_grads",
           "compressed_grad_transform"]


def init_error_feedback(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _quantise(g: torch.Tensor):
    scale = torch.clamp(g.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_grads(grads: dict, error_buf: dict):
    """``(int8 codes, f32 scales, new error buffer)``, each keyed as
    ``grads``."""
    qs, scales, errs = {}, {}, {}
    for k, g in grads.items():
        g32 = g.float() + error_buf[k]
        q, scale = _quantise(g32)
        qs[k], scales[k] = q, scale
        errs[k] = g32 - q.float() * scale
    return qs, scales, errs


def decompress_grads(qs: dict, scales: dict) -> dict:
    return {k: q.float() * scales[k] for k, q in qs.items()}


def compressed_grad_transform(grads: dict, error_buf: dict):
    """Round-trip compress/decompress; returns ``(grads', new_error)``."""
    qs, scales, errs = compress_grads(grads, error_buf)
    return decompress_grads(qs, scales), errs
