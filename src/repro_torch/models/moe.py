"""Mixture-of-Experts FFN: shared experts + routed top-k experts.

Dispatch is sort-based with a static per-expert capacity: tokens are
ranked within their chosen expert by a stable sort, tokens past capacity
are dropped into an overflow row (GShard/Switch discipline), and expert
FFNs run as one batched product over the expert dimension; the combine is
a gate-weighted scatter-add back to the tokens.  The router is
softmax-then-top-k with the Switch load-balancing auxiliary loss.

Under a sharding policy with a ``model`` axis and a batch that divides
the data axes, :func:`moe_apply` takes the expert-parallel path
instead: every model shard routes its data shard's tokens to its own
slice of the experts (:func:`ep_shard`), and the shards' partial outputs
are summed.  On DTensors that sum is one all-reduce over the ``model``
ranks; on plain tensors (one process, a logical mesh) the shards run one
after another.  Where a DTensor input falls through to the gather path,
each rank runs it whole on replicated local tensors.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils._python_dispatch import _disable_current_modes

from . import sharding_policy
from .layers import MLP, Params, swiglu, tree_map

__all__ = ["MoE", "route", "route_tape", "router_probs", "moe_apply", "ep_shard"]

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
    """x: (b, s, d) -> (y, aux_loss).

    Two implementations:

    * **EP path** (a policy with a ``model`` axis, and a batch that the
      data axes divide): activations are replicated over the ``model``
      axis, so each model shard routes the *local* token block to its
      **own** expert slice and the only collective is one sum over
      ``model`` for the combine.
    * **gather path** (no policy / tiny batches): sort-based capacity
      dispatch in plain tensor code; on DTensors every rank runs it on
      its inputs replicated (:func:`_moe_gather_replicated`).
    """
    policy = sharding_policy._POLICY
    if policy is not None and policy.get("model"):
        dp = policy.get("batch")
        dp_size = 1
        if dp:
            for a in (dp if isinstance(dp, tuple) else (dp,)):
                dp_size *= policy["sizes"].get(a, 1)
        if dp_size > 1 and x.shape[0] % dp_size == 0:
            if isinstance(x, DTensor):
                return _moe_ep_shardmap(params, x, cfg, policy)
            return _moe_ep_serial(params, x, cfg, policy, dp_size)
    return _moe_gather(params, x, cfg)


def _moe_gather(params, x, cfg):
    if isinstance(x, DTensor):
        return _moe_gather_replicated(params, x, cfg)
    m = cfg.moe
    b, s, d = x.shape
    n_tokens = b * s
    xt = x.reshape(n_tokens, d)
    expert_ids, gate_vals, aux = _gates(params, xt, cfg)
    cap = _capacity(n_tokens, cfg)
    slot_token, slot_gate = _dispatch(expert_ids, gate_vals, m.n_experts, cap)
    y = _experts(xt, slot_token, slot_gate, params["w_gate"], params["w_up"],
                 params["w_down"], cap)
    if m.n_shared:
        y = y + _shared_experts(params, xt, x.dtype)
    return y.reshape(b, s, d), aux


def _moe_gather_replicated(params, x, cfg):
    """The gather path on DTensors: every rank runs it whole on its
    inputs gathered (replicated) as local tensors, and the output comes
    back replicated.  The routing's sort, rank within an expert and slot
    scatter are data-dependent integer work that DTensor has no sharding
    rule for; on replicated inputs every rank computes the same output
    and the same gradients, so each local gradient is the whole one."""
    mesh = x.device_mesh
    whole = (Replicate(),) * mesh.ndim

    def local(t):
        return t.redistribute(mesh, whole).to_local() if isinstance(t, DTensor) else t

    y, aux = _moe_gather(tree_map(local, params), local(x), cfg)
    return DTensor.from_local(y, mesh, whole), DTensor.from_local(aux, mesh, whole)


def _gates(params, xt, cfg):
    """Each token's top-k experts ``(T, k)``, their renormalised gates
    ``(T, k)`` in f32, and the Switch load-balancing aux loss."""
    m = cfg.moe
    probs, expert_ids = _routed(params, xt, cfg)
    gate_vals = probs.gather(1, expert_ids)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=0)
    ce = F.one_hot(expert_ids[:, 0], m.n_experts).float().mean(dim=0)
    aux = m.n_experts * torch.sum(me * ce) * m.router_aux_weight
    return expert_ids, gate_vals, aux


def _dispatch(expert_ids, gate_vals, n_experts: int, cap: int):
    """Sort-based dispatch with static capacity: the token and the gate
    of each of the ``n_experts * cap`` (expert, rank) slots.  Entries are
    ranked within their expert by a stable sort; entries past ``cap`` or
    of an expert id ``>= n_experts`` (another shard's) go to an overflow
    row, and empty slots hold token ``T`` (a zero row) with gate 0."""
    n_tokens, top_k = expert_ids.shape
    dev = expert_ids.device
    n_slots = n_experts * cap
    flat_token = torch.arange(n_tokens, device=dev).repeat_interleave(top_k)
    se, order = torch.sort(expert_ids.reshape(-1), stable=True)
    stok, sgate = flat_token[order], gate_vals.reshape(-1)[order]
    # rank of each entry within its expert
    pos = torch.arange(se.shape[0], device=dev) - torch.searchsorted(se, se, side="left")
    keep = (pos < cap) & (se < n_experts)
    slot = torch.where(keep, se * cap + pos, n_slots)  # overflow row
    slot_token = torch.full((n_slots + 1,), n_tokens, dtype=torch.long, device=dev)
    slot_token[slot] = torch.where(keep, stok, n_tokens)
    slot_gate = torch.zeros(n_slots + 1, dtype=torch.float32, device=dev)
    slot_gate[slot] = torch.where(keep, sgate, 0.0)
    return slot_token[:n_slots], slot_gate[:n_slots]


def _experts(xt, slot_token, slot_gate, wg, wu, wd, cap: int):
    """The expert FFNs as one batched product over the expert dimension,
    then the combine: a gate-weighted scatter-add back to the tokens."""
    n_tokens, d = xt.shape
    dtype = xt.dtype
    x_pad = torch.cat([xt, xt.new_zeros(1, d)])
    xe = x_pad[slot_token].reshape(-1, cap, d)
    g = torch.bmm(xe, wg.to(dtype))
    u = torch.bmm(xe, wu.to(dtype))
    h = F.silu(g.float()).to(dtype) * u
    ye = torch.bmm(h, wd.to(dtype))
    ye_flat = ye.reshape(-1, d) * slot_gate[:, None].to(dtype)
    return xt.new_zeros(n_tokens + 1, d).index_add_(0, slot_token, ye_flat)[:n_tokens]


def _shared_experts(params, xt, dtype):
    sh = params["shared"]
    return swiglu(xt, sh["w_gate"].to(dtype), sh["w_up"].to(dtype), sh["w_down"].to(dtype))


# --------------------------------------------------------------------- #
# expert-parallel path
# --------------------------------------------------------------------- #
def _padded_experts(n_experts: int, n_model: int) -> tuple[int, int]:
    """The expert stack padded up to a multiple of the model-axis size,
    and each shard's slice of it."""
    e_pad = -(-n_experts // n_model) * n_model
    return e_pad, e_pad // n_model


def ep_shard(xb, router, wg, wu, wd, shard: int, n_model: int, cfg):
    """Model shard ``shard``'s part of the EP block on its data shard's
    tokens ``xb`` ``(b_loc, s, d)``: ``(y, aux)``, ``y`` the gate-weighted
    output of the tokens routed to experts ``[shard * e_loc, (shard + 1) *
    e_loc)`` of the stack padded to a multiple of ``n_model`` (zero
    elsewhere), ``aux`` the load-balancing loss of the block's tokens
    (the same on every model shard).  ``router`` is the whole router;
    ``wg``, ``wu``, ``wd`` are the shard's ``e_loc`` experts."""
    m = cfg.moe
    b_loc, s, d = xb.shape
    t_loc = b_loc * s
    xt = xb.reshape(t_loc, d)
    _, e_loc = _padded_experts(m.n_experts, n_model)
    expert_ids, gate_vals, aux = _gates({"router": router}, xt, cfg)
    # shard-local expert slice; entries of other shards go past its end
    e_lo = shard * e_loc
    mine = (expert_ids >= e_lo) & (expert_ids < e_lo + e_loc)
    local_e = torch.where(mine, expert_ids - e_lo, e_loc)
    cap = _capacity(t_loc, cfg)
    slot_token, slot_gate = _dispatch(local_e, gate_vals, e_loc, cap)
    y = _experts(xt, slot_token, slot_gate, wg, wu, wd, cap)  # local gather
    return y.reshape(b_loc, s, d), aux


def _expert_stacks(params, n_experts: int, n_model: int) -> list:
    """``w_gate``, ``w_up``, ``w_down`` zero-padded to the padded stack."""
    e_pad, _ = _padded_experts(n_experts, n_model)
    out = []
    for name in ("w_gate", "w_up", "w_down"):
        w = params[name]
        if e_pad != n_experts:
            w = torch.cat([w, w.new_zeros(e_pad - n_experts, *w.shape[1:])])
        out.append(w)
    return out


def _moe_ep_serial(params, x, cfg, policy, dp_size: int):
    """The EP path on plain tensors: every (data, model) shard's
    :func:`ep_shard` in turn, the model shards' outputs summed (the
    combine) and the data shards' aux averaged."""
    m = cfg.moe
    b, s, d = x.shape
    n_model = policy["sizes"].get(policy["model"], 1)
    _, e_loc = _padded_experts(m.n_experts, n_model)
    stacks = _expert_stacks(params, m.n_experts, n_model)
    ys, auxs = [], []
    for xb in x.split(b // dp_size):
        y = None
        for shard in range(n_model):
            sl = slice(shard * e_loc, (shard + 1) * e_loc)
            y_s, aux_s = ep_shard(xb, params["router"], *(w[sl] for w in stacks), shard,
                                  n_model, cfg)
            y = y_s if y is None else y + y_s
            if shard == 0:
                auxs.append(aux_s)
        ys.append(y)
    y = torch.cat(ys)
    aux = torch.stack(auxs).mean()
    if m.n_shared:
        y = y + _shared_experts(params, x.reshape(b * s, d), x.dtype).reshape(b, s, d)
    return y, aux


class _SumOverGroup(torch.autograd.Function):
    """All-reduce (sum) over a process group whose backward is the
    identity: each rank's gradient of the sum is its own."""

    @staticmethod
    def forward(ctx, t, group):
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _local(w, mesh, placements, grad_placements):
    """``w``'s local tensor at ``placements`` (a plain ``w`` as is); its
    gradient reaches ``w`` as a DTensor at ``grad_placements``."""
    if not isinstance(w, DTensor):
        return w
    return w.redistribute(mesh, placements).to_local(grad_placements=grad_placements)


def _moe_ep_shardmap(params, x, cfg, policy):
    """The EP path on DTensors: this rank's :func:`ep_shard` on its
    local tokens and expert slice, then the combine, one all-reduce over
    the ``model`` ranks.

    Gradients: the local tokens and the whole router are partial sums
    over the ranks that share them; the combine's backward is the
    identity (the transpose of the JAX package's ``psum`` inside
    ``shard_map``); aux is summed over every rank at ``1 / ranks``
    each, so that each data shard's aux counts once in its mean."""
    m = cfg.moe
    b, s, d = x.shape
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    dp = policy["batch"]
    dp_axes = dp if isinstance(dp, tuple) else (dp,)
    model_axis = policy["model"]
    n_model = mesh.size(names.index(model_axis))
    shard = mesh.get_local_rank(model_axis)
    e_pad, e_loc = _padded_experts(m.n_experts, n_model)

    n = len(names)
    x_at = tuple(Shard(0) if a in dp_axes else Replicate() for a in names)
    xb = x.redistribute(mesh, x_at).to_local(
        grad_placements=tuple(Shard(0) if a in dp_axes else Partial() for a in names))
    router = _local(params["router"], mesh, (Replicate(),) * n, (Partial(),) * n)
    if e_pad == m.n_experts:
        # the shard's slice is its local block of the expert dim
        at = tuple(Shard(0) if a == model_axis else Replicate() for a in names)
        grad_at = tuple(Shard(0) if a == model_axis else Partial() for a in names)
        ws = [_local(params[k], mesh, at, grad_at) for k in ("w_gate", "w_up", "w_down")]
    else:
        # the stack does not divide: every rank holds all of it and
        # slices the padded stack
        full = {k: _local(params[k], mesh, (Replicate(),) * n, (Partial(),) * n)
                for k in ("w_gate", "w_up", "w_down")}
        sl = slice(shard * e_loc, (shard + 1) * e_loc)
        ws = [w[sl] for w in _expert_stacks(full, m.n_experts, n_model)]

    y_loc, aux_loc = ep_shard(xb, router, *ws, shard, n_model, cfg)
    y_loc = _SumOverGroup.apply(y_loc, mesh.get_group(model_axis))
    y = DTensor.from_local(y_loc, mesh, x_at)
    aux_loc = aux_loc / mesh.size()
    for a in names:
        aux_loc = _SumOverGroup.apply(aux_loc, mesh.get_group(a))
    aux = DTensor.from_local(aux_loc, mesh, (Replicate(),) * n)

    if m.n_shared:
        y = y + _shared_experts(params, x.reshape(b * s, d), x.dtype).reshape(b, s, d)
    return y, aux
