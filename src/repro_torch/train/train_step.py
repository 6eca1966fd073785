"""Train / serve step builders.

``make_train_step`` returns ``(state, batch) -> (state, metrics)``: the
gradients of ``forward_train`` by autograd (each layer rematerialised,
``models.transformer.REMAT_POLICY``), accumulated over microbatches in
f32 as ``g / n_micro``, optionally passed through the int8 compression
round trip with error feedback, then the AdamW update at the warmup +
cosine learning-rate scale read at the step counter *before* the update
(so the first step moves no parameter: its scale is 0).

The state is ``{"params": Transformer, "opt": {"mu", "nu", "step"}[,
"error_feedback"]}``: the moments and the error buffer are dicts keyed
by the parameters' dotted names.  The step updates the state in place
and returns it; at full width the state is four times the model's size.

A sharded state (DTensor leaves, placed by ``launch.sharding``'s
``state_shardings``, with the batch placed by ``batch_shardings``) runs
the same step on every rank of its mesh: plain tensors that the model
makes (positions, masks) count as replicated, each gradient is
redistributed to its parameter's placements (the data-parallel
reduction) before the compression and the update, and the metrics come
back as plain tensors, whole on every rank.

``make_serve_step`` returns the decode step used by the inference
shapes, ``make_prefill_step`` the prefill; both run on placed (DTensor)
parameters as the train step does.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..models import transformer
from ..models.layers import tree_leaves
from ..optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    compressed_grad_transform,
    init_error_feedback,
    warmup_cosine,
)

__all__ = ["TrainConfig", "init_train_state", "make_train_step",
           "make_serve_step", "make_prefill_step"]


@dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    grad_compression: bool = False
    warmup_steps: int = 200
    total_steps: int = 10_000


def init_train_state(generator: torch.Generator, cfg, train_cfg: TrainConfig) -> dict:
    """Parameters drawn from ``generator`` on its device, zero moments, a
    zero step and (with compression) a zero error buffer."""
    params = transformer.init_params(generator, cfg)
    named = dict(params.named_parameters())
    state = {"params": params, "opt": adamw_init(named)}
    if train_cfg.grad_compression:
        state["error_feedback"] = init_error_feedback(named)
    return state


def _grads(loss: torch.Tensor, named: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """d loss / d leaf for every leaf; zeros for a leaf the loss does not
    reach (as ``jax.grad`` gives)."""
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else _at(g, p)
            for (k, p), g in zip(named.items(), grads)}


def _at(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient at its parameter's placements: partial sums
    reduced, replicated ones sliced."""
    if isinstance(g, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _whole(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def _placed(params):
    """Inside, plain tensors count as replicated when ``params`` (a
    module or a tree) holds DTensors: the model's own positions and
    masks meet sharded activations."""
    leaves = params.parameters() if isinstance(params, torch.nn.Module) else tree_leaves(params)
    sharded = any(isinstance(p, DTensor) for p in leaves)
    return implicit_replication() if sharded else contextlib.nullcontext()


def make_train_step(cfg, train_cfg: TrainConfig):
    """Build the train step for model config ``cfg``."""

    def train_step(state: dict, batch: dict):
        named = dict(state["params"].named_parameters())
        with _placed(state["params"]):
            return _step(state, batch, named)

    def _step(state: dict, batch: dict, named: dict):
        n_micro = train_cfg.microbatches
        if n_micro > 1:
            rows = batch["tokens"].shape[0]
            if rows % n_micro:
                raise ValueError(f"batch of {rows} rows does not split into {n_micro} "
                                 f"microbatches")
            size = rows // n_micro
            grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for k, p in named.items()}
            loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            for i in range(n_micro):
                micro = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                micro_loss, _ = transformer.forward_train(state["params"], cfg, micro)
                with torch.no_grad():
                    for k, g in _grads(micro_loss, named).items():
                        grads[k] = grads[k] + g.float() / n_micro
                    loss = loss + micro_loss / n_micro
            metrics = {"xent": _whole(loss)}
        else:
            loss, metrics = transformer.forward_train(state["params"], cfg, batch)
            grads = _grads(loss, named)
            loss = loss.detach()
            metrics = {k: _whole(v.detach()) for k, v in metrics.items()}

        if train_cfg.grad_compression:
            grads, state["error_feedback"] = compressed_grad_transform(
                grads, state["error_feedback"])

        lr_scale = warmup_cosine(
            state["opt"]["step"],
            warmup=train_cfg.warmup_steps,
            total=train_cfg.total_steps,
        )
        _, _, opt_metrics = adamw_update(train_cfg.optimizer, named, grads, state["opt"],
                                         lr_scale)
        return state, {"loss": _whole(loss), **metrics,
                       **{k: _whole(v) for k, v in opt_metrics.items()}}

    return train_step


def make_serve_step(cfg):
    """Decode step: (params, token, cache, cache_len[, memory]) -> ..."""

    def serve_step(params, token, cache, cache_len, memory=None):
        with _placed(params):
            return transformer.decode_step(params, cfg, token, cache, cache_len,
                                           memory=memory)

    return serve_step


def make_prefill_step(cfg):
    """Prefill: full forward returning last-position logits."""

    def prefill_step(params, batch):
        with _placed(params):
            logits, _ = transformer.forward_logits(params, cfg, batch)
            return logits[:, -1]

    return prefill_step
