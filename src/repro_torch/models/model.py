"""Public model facade: build / init / apply for any registered arch."""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..core.util import resolve_device
from . import transformer
from .layers import COMPUTE_DTYPE, param_tree

__all__ = ["init_params", "abstract_params", "input_specs", "Model"]


init_params = transformer.init_params


def abstract_params(cfg: ModelConfig):
    """The parameter tree on the ``meta`` device: every leaf's shape and
    dtype without allocating (the dry-run path)."""
    return param_tree(transformer.Transformer(cfg, "meta"))


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *, per_host: int | None = None):
    """``meta`` tensors standing for every model input of a cell.

    train/prefill: full-sequence batch.  decode: one new token plus the
    KV/SSM cache of ``seq_len`` (``init_cache`` on ``meta``).
    """
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": _meta((b, s), i32)}
        if cfg.family == "vlm":
            # stub vision frontend: precomputed patch embeddings (1/4 of
            # the span is vision, matching dynamic-resolution image packing)
            n_vis = max(s // 4, 16)
            batch["tokens"] = _meta((b, s - n_vis), i32)
            batch["vision_embeds"] = _meta((b, n_vis, cfg.d_model), COMPUTE_DTYPE)
        if cfg.family == "encdec":
            # stub audio frontend: precomputed frame embeddings, 2x the
            # target length (speech-to-text ratio)
            batch["src_embeds"] = _meta((b, min(2 * s, 8192), cfg.d_model), COMPUTE_DTYPE)
        return batch
    batch = {
        "token": _meta((b, 1), i32),
        "cache": transformer.init_cache(cfg, b, s, device="meta"),
        "cache_len": _meta((), i32),
    }
    if cfg.family == "encdec":
        batch["memory"] = _meta((b, 1024, cfg.d_model), COMPUTE_DTYPE)
    return batch


class Model:
    """Thin OO wrapper used by examples and the serving loop.  ``params``
    is the :class:`~.transformer.Transformer` that :meth:`init` returns
    (or its ``param_tree``).  ``device=None`` is the card, and raises
    without one; pass ``"cpu"`` to run on the host."""

    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator) -> transformer.Transformer:
        """Parameters on this model's device, drawn from ``generator``
        (which must live on the same device type: torch raises otherwise)."""
        return init_params(generator, self.cfg).to(self.device)

    def loss(self, params, batch):
        return transformer.forward_train(params, self.cfg, batch)

    def logits(self, params, batch):
        return transformer.forward_logits(params, self.cfg, batch)

    def init_cache(self, batch: int, max_len: int):
        return transformer.init_cache(self.cfg, batch, max_len, device=self.device)

    def decode_step(self, params, token, cache, cache_len: int, memory=None):
        return transformer.decode_step(params, self.cfg, token, cache, cache_len,
                                       memory=memory)
