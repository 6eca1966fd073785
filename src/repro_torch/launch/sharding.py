"""Sharding rules: parameters, optimizer states, batches, caches.

Layout strategy (see DESIGN.md §6):

* **FSDP x TP**: every weight is sharded over the batch axes
  (('pod','data')) on its d_model-ish dimension *and* over ``model`` on
  its heads/ffn/expert dimension.
* **EP**: MoE expert dim shards over ``model``.
* **Context parallelism**: decode caches with batch < data-axis size
  (long_500k) shard the *sequence* dimension of the KV cache / the state
  dimension of SSM states over ``data`` instead.
* Every rule is divisibility-guarded: a dimension that does not divide by
  the axis size is replicated instead (e.g. granite's kv=1 MQA heads fall
  back to sharding head_dim).

A rule gives a *spec*: one entry per tensor dimension, each an axis name,
a tuple of names or ``None``, read from the mesh's axis names and sizes
alone (a :class:`~.mesh.AbstractMesh` will do).  A :class:`NamedSharding`
pairs a spec with its mesh; on a :class:`DeviceMesh` its
:attr:`~NamedSharding.placements` are DTensor placements, one per mesh
dimension: ``Shard(d)`` on each mesh axis of more than one rank that
tensor dimension ``d`` names, ``Replicate()`` on the others.  Parameters are keyed by their
dotted ``state_dict`` names (the JAX package's tree paths with dots).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from ..models.sharding_policy import placements_of
from .mesh import axis_sizes, data_axes

__all__ = [
    "NamedSharding",
    "guarded_spec",
    "named_leaves",
    "param_shardings",
    "state_shardings",
    "batch_shardings",
    "cache_shardings",
]


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def guarded_spec(mesh, shape, proposed) -> tuple:
    """Drop proposed axes that do not divide the dimension size."""
    out = []
    for dim, axis in zip(shape, proposed):
        if axis is not None and dim % _axis_size(mesh, axis) == 0 and dim > 0:
            out.append(axis)
        else:
            out.append(None)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (a :class:`DeviceMesh`, or an
    :class:`~.mesh.AbstractMesh` for the layout alone)."""

    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements_of(self.spec, axis_sizes(self.mesh))

    def place(self, x) -> DTensor:
        """``x`` (a tensor or an array, whole on every rank, or a DTensor,
        gathered first) as a DTensor of this layout on the mesh's device;
        each rank keeps its shard."""
        if isinstance(x, DTensor):
            x = x.full_tensor()
        return distribute_tensor(torch.as_tensor(x).detach(), self.mesh, self.placements)


def named_leaves(tree) -> dict:
    """The leaves of a module (``named_parameters``) or of a tree of
    dicts and lists, by dotted name."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            out[prefix] = node
            return
        for k, v in items:
            walk(v, f"{prefix}.{k}" if prefix else str(k))

    walk(tree, "")
    return out


# --------------------------------------------------------------------- #
# parameter rules
# --------------------------------------------------------------------- #
def _param_rule(path: str, shape, mesh, fsdp, ep_only: bool = False) -> tuple:
    """Sharding for one parameter leaf, dispatched on name + rank.

    Stage parameters carry a leading layer axis (never sharded); the rules
    below give the spec for the *trailing* dims and are left-padded.
    ``ep_only``: keep the model axis for MoE experts only; everything else
    is FSDP-sharded with no tensor parallelism (for MoE models whose
    d_model is too small to amortise TP all-reduces).
    """
    name = path.split(".")[-1]
    is_moe = ".moe." in path and "shared" not in path

    def pad(spec_tail):
        return (None,) * (len(shape) - len(spec_tail)) + tuple(spec_tail)

    if name in ("embed",):
        # vocab over `model` so logits stay (b@dp, s, V@model) and the
        # softmax/xent reduce is a small all-reduce over `model`.  d is
        # deliberately NOT sharded: a d@data embed table propagates
        # feature-sharding into the activations and kills data
        # parallelism.
        tail = ("model", None)
    elif name == "unembed":
        tail = (None, "model")
    elif name == "router":
        tail = (fsdp, None)
    elif name in ("wq",):
        tail = (fsdp, "model", None)
    elif name in ("wk", "wv"):
        # kv heads may be too few to shard (MQA) — guard falls back; try
        # sharding head_dim instead when kv-dim sharding is impossible.
        kv = shape[-2]
        if kv % _axis_size(mesh, "model") == 0:
            tail = (fsdp, "model", None)
        else:
            tail = (fsdp, None, "model")
    elif name == "wo":
        tail = ("model", None, fsdp)
    elif name in ("w_gate", "w_up"):
        tail = ("model", fsdp, None) if is_moe else (fsdp, "model")
    elif name == "w_down":
        tail = ("model", None, fsdp) if is_moe else ("model", fsdp)
    elif name == "wq_a" or name == "wkv_a":
        tail = (fsdp, None)
    elif name in ("wq_b", "wk_b", "wv_b"):
        tail = (None, "model", None)
    elif name == "in_proj":
        tail = (fsdp, "model")
    elif name == "out_proj":
        tail = ("model", fsdp)
    elif name == "conv_w":
        tail = (None, "model")
    elif name in ("conv_b", "dt_bias", "D"):
        tail = ("model",)
    elif name == "x_proj":
        tail = ("model", None)
    elif name == "dt_proj":
        tail = (None, "model")
    elif name == "A_log":
        # mamba1: (..., d_in, state) — shard d_in;  mamba2: (..., nh) —
        # shard the head dim.  d_in is always >= 512 in real configs.
        if len(shape) >= 2 and shape[-2] >= 512:
            tail = ("model", None)
        else:
            tail = ("model",)
    else:  # norms, scales, small vectors -> replicated
        return (None,) * len(shape)

    if ep_only and not is_moe:
        # strip tensor parallelism: any 'model' entry becomes replicated
        tail = tuple(None if a == "model" else a for a in tail)
    return guarded_spec(mesh, shape, pad(tail))


def param_shardings(params, mesh, strategy: str = "fsdp_tp") -> dict:
    """:class:`NamedSharding` of every leaf of ``params`` (a module, or a
    tree or dict of tensors, ``meta`` ones included), by dotted name.

    ``strategy='fsdp_tp'`` (default): weights sharded FSDP over the batch
    axes x TP over ``model``.  ``'fsdp_ep'``: TP kept for the MoE experts
    only.  ``'pure_fsdp'``: no tensor parallelism — each weight's largest
    dimension that divides the device count is sharded over *every* mesh
    axis (small tensors stay replicated).
    """
    leaves = named_leaves(params)
    if strategy == "pure_fsdp":
        all_axes = tuple(axis_sizes(mesh))
        fsdp = all_axes if len(all_axes) > 1 else all_axes[0]
        n = _axis_size(mesh, fsdp)

        def one(path, leaf):
            spec = [None] * len(leaf.shape)
            for i, d in sorted(enumerate(leaf.shape), key=lambda t: -t[1]):
                if d > 0 and d % n == 0:
                    spec[i] = fsdp
                    break
            return NamedSharding(mesh, tuple(spec))

        return {k: one(k, v) for k, v in leaves.items()}

    if strategy not in ("fsdp_tp", "fsdp_ep"):
        raise ValueError(f"unknown sharding strategy {strategy!r}")
    fsdp = data_axes(mesh)
    fsdp = fsdp if len(fsdp) > 1 else fsdp[0]
    ep_only = strategy == "fsdp_ep"
    return {k: NamedSharding(mesh, _param_rule(k, v.shape, mesh, fsdp, ep_only=ep_only))
            for k, v in leaves.items()}


def state_shardings(state: dict, mesh) -> dict:
    """Train state: params + AdamW moments inherit the param layout
    (ZeRO); the step counter is replicated."""
    out = {"params": param_shardings(state["params"], mesh)}
    if "opt" in state:
        out["opt"] = {
            "mu": param_shardings(state["opt"]["mu"], mesh),
            "nu": param_shardings(state["opt"]["nu"], mesh),
            "step": NamedSharding(mesh, ()),
        }
    if "error_feedback" in state:
        out["error_feedback"] = param_shardings(state["error_feedback"], mesh)
    return out


# --------------------------------------------------------------------- #
# batch / cache rules
# --------------------------------------------------------------------- #
def batch_shardings(batch: dict, mesh) -> dict:
    """Training / prefill batches: leading batch dim over the DP axes."""
    dp = data_axes(mesh)
    dp = dp if len(dp) > 1 else dp[0]
    return {k: NamedSharding(mesh, guarded_spec(
        mesh, v.shape, (dp,) + (None,) * (len(v.shape) - 1)))
        for k, v in batch.items()}


def cache_shardings(cache, mesh, batch_size: int):
    """Decode caches (the tree of ``transformer.init_cache``, ``None``
    entries kept).

    Layout per leaf (layer-stacked): (L, b, S, heads, hd) for KV caches,
    (L, b, ...) for SSM states.  If the batch divides the DP axes, shard
    batch; otherwise (long-context, batch=1) shard the sequence axis of KV
    caches / the widest state axis of SSM states over ``data``
    (context parallelism).
    """
    dp = data_axes(mesh)
    dp = dp if len(dp) > 1 else dp[0]
    dp_size = _axis_size(mesh, dp)
    batch_fits = batch_size % dp_size == 0 and batch_size >= dp_size

    def one(leaf):
        shape = leaf.shape
        spec = [None] * len(shape)
        if len(shape) >= 2:
            if batch_fits:
                spec[1] = dp
            elif len(shape) >= 3:
                # context parallel: shard the largest non-batch axis
                spec[2] = "data"
            # shard heads/feature dim over model where possible
            if len(shape) >= 4:
                spec[3] = "model"
        return NamedSharding(mesh, guarded_spec(mesh, shape, spec))

    def walk(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return one(node)

    return walk(cache)

