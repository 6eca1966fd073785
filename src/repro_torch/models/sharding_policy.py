"""Activation-sharding policy.

DTensor's propagation alone can settle in poor layouts (feature-sharded
activations with a replicated batch, say).  The model pins the layout at
a few anchor points: it calls :func:`constrain` with logical axis names
and the launcher installs the physical mapping:

    batch  -> ('pod', 'data')     model -> 'model'      None -> replicated

``constrain`` redistributes a DTensor, and its gradient, to that
layout.  When no policy is installed (the CPU unit tests), or on a plain
tensor (one device, as the drivers run), it is a no-op.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

_POLICY: dict | None = None


def axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size, in mesh order, of a ``DeviceMesh`` or of a mesh
    given by ``.axis_names`` and ``.shape`` (name -> size), as
    ``launch.mesh.AbstractMesh`` and the JAX package's ``Mesh`` give them."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def set_policy_from_mesh(mesh, *, sequence_parallel: bool = False,
                         strategy: str = "fsdp_tp") -> None:
    sizes = axis_sizes(mesh)
    names = tuple(sizes)
    if strategy == "pure_fsdp":
        batch = names if len(names) > 1 else (names[0] if names else None)
        set_policy(batch, None, sizes)
        return
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    batch = batch_axes if len(batch_axes) > 1 else (batch_axes[0] if batch_axes else None)
    model = "model" if "model" in names else None
    set_policy(batch, model, sizes, sequence_parallel=sequence_parallel)


def set_policy(batch_axes, model_axis, axis_sizes: dict, *,
               sequence_parallel: bool = False) -> None:
    global _POLICY
    _POLICY = {
        "batch": batch_axes,
        "model": model_axis,
        # 'seq' maps the logical sequence dim of the residual stream onto
        # the model axis (Megatron sequence parallelism): the per-layer TP
        # output all-reduce becomes all-gather + reduce-scatter and every
        # elementwise/norm op runs on 1/TP of the tokens.
        "seq": model_axis if sequence_parallel else None,
        "sizes": dict(axis_sizes),
    }


def clear_policy() -> None:
    global _POLICY
    _POLICY = None


def _axis_size(axis, sizes) -> int:
    n = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        n *= sizes.get(a, 1)
    return n


def guarded_dims(shape, dims: tuple) -> tuple:
    """The physical axis of each dimension of a tensor of ``shape`` under
    the policy: ``dims``' logical names mapped, and replicated (``None``)
    where the dimension does not divide by the axis size."""
    sizes = _POLICY["sizes"]
    spec = []
    for d, size in zip(dims, shape):
        axis = _POLICY.get(d) if d else None
        if axis is None:
            spec.append(None)
            continue
        # divisibility guard: replicate when the dim does not divide
        spec.append(axis if size % _axis_size(axis, sizes) == 0 else None)
    return tuple(spec)


def placements_of(spec, sizes: dict) -> tuple:
    """The DTensor placements of ``spec`` (one axis name, tuple of names
    or ``None`` per tensor dimension) on a mesh of axis ``sizes`` (name ->
    size, in mesh order): one per mesh axis, ``Shard(d)`` where tensor dim
    ``d`` names the axis (alone or in a tuple), else ``Replicate()``.  A
    shard over an axis of size 1 is the whole tensor: it is placed as
    ``Replicate()``, which every operator propagates."""
    out = []
    for name, size in sizes.items():
        hit = [d for d, a in enumerate(spec) if a == name or (isinstance(a, tuple) and name in a)]
        out.append(Shard(hit[0]) if hit and size > 1 else Replicate())
    return tuple(out)


def heads_mesh_dim(mesh, n_heads: int) -> int | None:
    """The mesh dimension of the policy's ``model`` axis, over which ``n_heads``
    heads split evenly, or ``None`` (no policy, no such axis, or heads
    that do not divide it)."""
    axis = (_POLICY or {}).get("model")
    names = mesh.mesh_dim_names
    if axis not in names:
        return None
    dim = names.index(axis)
    return dim if n_heads % mesh.size(dim) == 0 else None


class _Pin(torch.autograd.Function):
    """``x`` redistributed to ``placements``, and its gradient too: the
    transpose of JAX's ``with_sharding_constraint`` constrains the
    cotangent alike.  Without it a gradient keeps whatever layout its
    producer left (a partial sum over ``model``), and DTensor would
    replicate the next weight rather than reduce it."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        if isinstance(grad, DTensor) and tuple(grad.placements) != ctx.placements:
            grad = grad.redistribute(grad.device_mesh, ctx.placements)
        return grad, None


def constrain(x, dims: tuple):
    """dims entries: 'batch' | 'seq' | 'model' | None per tensor dimension."""
    if _POLICY is None or not isinstance(x, DTensor):
        return x
    placements = placements_of(guarded_dims(x.shape, dims), axis_sizes(x.device_mesh))
    if placements == tuple(x.placements):
        return x
    return _Pin.apply(x, placements)
