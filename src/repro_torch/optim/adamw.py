"""AdamW, written out: no ``torch.optim``.

The JAX package's arithmetic, on dicts of tensors keyed by the
parameters' dotted names (a :class:`~..models.transformer.Transformer`'s
``named_parameters``): the global-norm clip inside the update, bias
correction as ``(mu / b1c) / (sqrt(nu / b2c) + eps)``, and ``p - lr *
(update + wd * p)`` in f32, cast back to the parameter's dtype.  The
moments are f32 dicts with the parameters' keys and the step counter an
int32 scalar tensor, so the state saves in the JAX package's checkpoint
format (:mod:`..train.checkpoint`).

``torch.optim.AdamW`` is not this update: it orders the operations
otherwise, and keeps neither the global norm nor a state that the JAX
package can load.  At full width the parameters, the gradients and the
two moments are one model's size each, so :func:`adamw_update` writes
the parameters and the moments in place, one leaf at a time.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.layers import path_key

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm", "global_norm"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params: dict[str, torch.Tensor]) -> dict:
    """Zero f32 moments shaped as ``params`` and a zero int32 step, on the
    parameters' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    step_device = next(iter(params.values())).device if params else None
    return {
        "mu": {k: zeros(p) for k, p in params.items()},
        "nu": {k: zeros(p) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=step_device),
    }


def global_norm(grads: dict[str, torch.Tensor]) -> torch.Tensor:
    """The f32 L2 norm over every leaf, summed leaf by leaf in the JAX
    package's leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(grads[k].float()))
                          for k in sorted(grads, key=path_key)))


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float):
    """``(grads scaled to a global norm of at most max_norm, the norm)``;
    the scaled leaves are f32, as the JAX package's product with an f32
    scale promotes them."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return {k: g.float() * scale for k, g in grads.items()}, gn


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict[str, torch.Tensor],
                 grads: dict[str, torch.Tensor], state: dict, lr_scale=1.0):
    """One AdamW step; returns ``(params, state, metrics)``.

    ``params``, ``state["mu"]``, ``state["nu"]`` and ``state["step"]`` are
    updated in place and returned; the gradients are clipped leaf by leaf
    as they are used (the same products as :func:`clip_by_global_norm`,
    without a second copy of the gradients)."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    state["step"].add_(1)
    step = state["step"].float()
    b1c = 1.0 - cfg.b1 ** step
    b2c = 1.0 - cfg.b2 ** step
    lr = cfg.lr * lr_scale
    for k in sorted(params, key=path_key):
        p, mu, nu = params[k], state["mu"][k], state["nu"][k]
        g = grads[k].float() * scale
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        update = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        p32 = p.float()
        p.copy_((p32 - lr * (update + cfg.weight_decay * p32)).to(p.dtype))
    return params, state, {"grad_norm": gnorm}
