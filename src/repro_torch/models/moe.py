"""Mixture-of-Experts FFN: shared experts + routed top-k experts.

Dispatch is sort-based with a static per-expert capacity: tokens are
ranked within their chosen expert by a stable sort, tokens past capacity
are dropped into an overflow row (GShard/Switch discipline), and expert
FFNs run as one batched product over the expert dimension; the combine is
a gate-weighted scatter-add back to the tokens.  The router is
softmax-then-top-k with the Switch load-balancing auxiliary loss.

This is the JAX package's gather path; its expert-parallel ``shard_map``
path needs a mesh and comes with the sharding slice.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import _disable_current_modes

from .layers import MLP, Params, swiglu

__all__ = ["MoE", "route", "route_tape", "router_probs", "moe_apply"]

#: the route tape of the layer this thread is running, if any
_tape = threading.local()


class MoE(Params):
    def __init__(self, cfg, stack: int | None, device):
        super().__init__(stack, device)
        m = cfg.moe
        d = cfg.d_model
        self.add("router", (d, m.n_experts))
        self.add("w_gate", (m.n_experts, d, m.d_expert_ff))
        self.add("w_up", (m.n_experts, d, m.d_expert_ff))
        self.add("w_down", (m.n_experts, m.d_expert_ff, d))
        if m.n_shared:
            self.shared = MLP(d, (m.d_shared_ff or m.d_expert_ff) * m.n_shared, stack, device)


def _capacity(n_tokens: int, cfg) -> int:
    m = cfg.moe
    cap = int(n_tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, cap + (-cap % 8))


def router_probs(params, xt):
    """The router's softmax probabilities ``(T, E)`` in f32 of the tokens
    ``xt`` ``(T, d)``."""
    return torch.softmax((xt @ params["router"].to(xt.dtype)).float(), dim=-1)


def route(params, xt, cfg):
    """The router: softmax probabilities ``(T, E)`` in f32 of the tokens
    ``xt`` ``(T, d)``, and each token's top-k experts ``(T, k)``."""
    probs = router_probs(params, xt)
    # top-k by a stable descending sort: of equal probabilities the lower
    # expert id comes first, as in ``jax.lax.top_k`` (bf16 router logits tie)
    expert_ids = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, : cfg.moe.top_k]
    return probs, expert_ids


@contextlib.contextmanager
def route_tape(experts: list, replay: bool):
    """Inside, every ``moe_apply`` of this thread takes its probabilities
    from :func:`router_probs` and its experts from :func:`route` (the
    experts recorded in ``experts``) or, with ``replay``, from ``experts``
    in the same order, :func:`route` not called.  A recomputing layer
    (the transformer's remat) thereby takes the forward's routes,
    whatever :func:`route` (or a hook in its place) would choose now.
    :func:`route` runs outside autograd and unseen by dispatch modes, so
    the forward saves the tensors and makes the calls that the recompute
    makes (a selective checkpoint replays saved outputs by call order)."""
    prev = getattr(_tape, "active", None)
    _tape.active = (experts, replay, [0])
    try:
        yield
    finally:
        _tape.active = prev


def _routed(params, xt, cfg):
    tape = getattr(_tape, "active", None)
    if tape is None:
        return route(params, xt, cfg)
    experts, replay, at = tape
    probs = router_probs(params, xt)
    if replay:
        ids = experts[at[0]]
        at[0] += 1
    else:
        with torch.no_grad(), _disable_current_modes():
            ids = route(params, xt, cfg)[1]
        experts.append(ids)
    return probs, ids


def moe_apply(params, x, cfg):
    """x: (b, s, d) -> (y, aux_loss)."""
    m = cfg.moe
    b, s, d = x.shape
    dtype = x.dtype
    n_tokens = b * s
    xt = x.reshape(n_tokens, d)

    probs, expert_ids = _routed(params, xt, cfg)
    gate_vals = probs.gather(1, expert_ids)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(dim=0)
    ce = F.one_hot(expert_ids[:, 0], m.n_experts).float().mean(dim=0)
    aux = m.n_experts * torch.sum(me * ce) * m.router_aux_weight

    # ---- sort-based dispatch with static capacity ---- #
    cap = _capacity(n_tokens, cfg)
    n_slots = m.n_experts * cap
    flat_expert = expert_ids.reshape(-1)  # (T*k,)
    flat_token = torch.arange(n_tokens, device=x.device).repeat_interleave(m.top_k)
    flat_gate = gate_vals.reshape(-1)

    se, order = torch.sort(flat_expert, stable=True)
    stok, sgate = flat_token[order], flat_gate[order]
    # rank of each entry within its expert
    pos = torch.arange(se.shape[0], device=x.device) - torch.searchsorted(se, se, side="left")
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, n_slots)  # overflow row

    # token index per (expert, capacity) slot; padded slots -> row n_tokens
    slot_token = torch.full((n_slots + 1,), n_tokens, dtype=torch.long, device=x.device)
    slot_token[slot] = torch.where(keep, stok, n_tokens)
    slot_token = slot_token[:n_slots]
    slot_gate = torch.zeros(n_slots + 1, dtype=torch.float32, device=x.device)
    slot_gate[slot] = torch.where(keep, sgate, 0.0)
    slot_gate = slot_gate[:n_slots]

    x_pad = torch.cat([xt, xt.new_zeros(1, d)])
    xe = x_pad[slot_token].reshape(m.n_experts, cap, d)
    g = torch.bmm(xe, params["w_gate"].to(dtype))
    u = torch.bmm(xe, params["w_up"].to(dtype))
    h = F.silu(g.float()).to(dtype) * u
    ye = torch.bmm(h, params["w_down"].to(dtype))

    # combine: scatter-add expert outputs back to tokens, gate-weighted
    ye_flat = ye.reshape(n_slots, d) * slot_gate[:, None].to(dtype)
    y = x.new_zeros(n_tokens + 1, d).index_add_(0, slot_token, ye_flat)[:n_tokens]

    if m.n_shared:
        y = y + _shared_experts(params, xt, dtype)
    return y.reshape(b, s, d), aux


def _shared_experts(params, xt, dtype):
    sh = params["shared"]
    return swiglu(xt, sh["w_gate"].to(dtype), sh["w_up"].to(dtype), sh["w_down"].to(dtype))
