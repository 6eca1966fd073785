"""Per-device cost of what a PyTorch function dispatches.

The counterpart of the JAX package's HLO cost model (``hlo_cost.py``):
:func:`count_ops` runs a function under a dispatch mode and counts, as
seen by one device,

* **FLOPs**, by the formulas of ``torch.utils.flop_counter`` (those
  ``FlopCounterMode`` counts with; an op with no formula is decomposed
  first where it can be, as ``FlopCounterMode`` does);
* **bytes**: every op's result bytes (view ops move nothing and count
  nothing), plus the bytes of the function's tensor inputs, read once.
  Eager PyTorch does not fuse: every op writes its result to memory, so
  these bytes exceed XLA's post-fusion figure (the fusions' results
  only), and they are what the eager port really moves;
* **collective bytes by kind**: the result bytes of each collective op
  (``_c10d_functional``, ``c10d``, DTensor's all-to-all), counted once,
  as the reference counts them;
* **temp bytes**: the peak of the live bytes of the storages made inside
  the function (each storage tracked until it is freed, autograd's saved
  tensors included).

There is no loop trip-count correction.  XLA's cost analysis counts a
``while`` body once, which the reference corrects by the loop's trip
count; the port runs its layer loop in Python (``_run_stage``), so every
layer's ops are dispatched, and counted, one by one.

**DTensors.**  A dispatch mode sees an op on DTensors at the global
level.  :class:`OpCounter` leaves such an op to DTensor and counts the
ops DTensor then dispatches on the local shards, with the collectives
its redistributions issue: the counts are one device's, which dividing
a global count by the device count is not wherever a dimension is
replicated.

**Meshes of device type cpu.**  DTensor moves a shard from one tensor
dimension to another on a ``cpu`` mesh by an all-gather and a chunk
(gloo has no all-to-all).  Inside :class:`OpCounter`, that move on meta
tensors (the dry run's) is issued as the all-to-all that a ``cuda``
mesh issues (``torch.ops._dtensor.shard_dim_alltoall``, whose meta
kernel needs no communication), so it counts as one all-to-all of its
result's bytes; on tensors that hold data the fallback stands.
"""

from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field

import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

__all__ = ["OpCost", "OpCounter", "count_ops", "tensor_bytes"]

#: op-name fragments of the collectives, by the reference's kinds
_COLLECTIVE_KINDS = (
    ("all_gather", "all-gather"), ("allgather", "all-gather"),
    ("reduce_scatter", "reduce-scatter"),
    ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
    ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
    ("broadcast", "broadcast"),
)
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d", "_dtensor")


@dataclass
class OpCost:
    flops: float = 0.0
    bytes_written: float = 0.0
    input_bytes: float = 0.0
    output_bytes: float = 0.0
    temp_bytes: float = 0.0
    collective_bytes: dict = field(default_factory=dict)
    per_collective_ops: int = 0
    n_ops: int = 0

    @property
    def hbm_bytes(self) -> float:
        """Bytes moved: every result written, every input read once."""
        return self.bytes_written + self.input_bytes

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of a tree of dicts, lists, tuples and modules (a
    module's parameters and buffers), DTensors as their local shards."""
    out = []
    for leaf in tree_leaves(tree, is_leaf=lambda x: isinstance(x, nn.Module)):
        if isinstance(leaf, nn.Module):
            out += _tensors([*leaf.parameters(), *leaf.buffers()])
        elif isinstance(leaf, DTensor):
            out.append(leaf.to_local())
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def tensor_bytes(tree) -> int:
    """Bytes of the distinct tensors of ``tree`` (DTensors: the local
    shard's)."""
    seen, total = set(), 0
    for t in _tensors(tree):
        if id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


def _collective_kind(func) -> str | None:
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return None
    name = func.__name__
    for frag, kind in _COLLECTIVE_KINDS:
        if frag in name:
            return kind
    return None


class OpCounter(TorchDispatchMode):
    """Inside, every local op is counted into :attr:`cost` (see the
    module's docstring); ``inputs`` are the tensors read once."""

    def __init__(self, inputs=()):
        super().__init__()
        self.cost = OpCost()
        tensors = _tensors(inputs)
        self.cost.input_bytes = tensor_bytes(tensors)
        self._inputs = {t.untyped_storage()._cdata for t in tensors}
        self._live: dict[int, int] = {}
        self._live_bytes = 0

    def _free(self, key: int, nbytes: int) -> None:
        if self._live.pop(key, None) is not None:
            self._live_bytes -= nbytes

    def _track(self, out) -> None:
        """Count ``out``'s result bytes and follow its new storages."""
        cost = self.cost
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            cost.bytes_written += t.numel() * t.element_size()
            storage = t.untyped_storage()
            key = storage._cdata
            if key in self._live or key in self._inputs:
                continue
            nbytes = storage.nbytes()
            self._live[key] = nbytes
            self._live_bytes += nbytes
            weakref.finalize(storage, self._free, key, nbytes)
        cost.temp_bytes = max(cost.temp_bytes, self._live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation working out an output's
            # shape: no device runs it
            return func(*args, **kwargs)
        if any(t is not torch.Tensor and t is not nn.Parameter for t in types):
            # a subclass (DTensor, an async collective's wrapper): its
            # dispatch runs the local ops, which come back through here
            return NotImplemented
        packet = func._overloadpacket
        if packet not in flop_registry and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in tree_leaves(out)):
            return out  # a fake input made for the propagation
        cost = self.cost
        cost.n_ops += 1
        if packet in flop_registry:
            cost.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        kind = _collective_kind(func)
        if kind is not None:
            nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(out)
                         if isinstance(t, torch.Tensor))
            cost.collective_bytes[kind] = cost.collective_bytes.get(kind, 0.0) + nbytes
            cost.per_collective_ops += 1
        if kind is not None or not (func.is_view or func.namespace == "_c10d_functional"):
            self._track(out)
        return out


@contextlib.contextmanager
def _alltoall_on_meta():
    """DTensor's shard-to-shard move on a ``cpu`` mesh issued as the
    all-to-all of a ``cuda`` mesh, for meta tensors (see the module's
    docstring)."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import placement_types

    orig = getattr(placement_types, "shard_dim_alltoall", None)
    if orig is None:
        yield
        return

    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        if mesh.device_type != "cpu" or not input.is_meta:
            return orig(input, gather_dim, shard_dim, mesh, mesh_dim)
        group = funcol._resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, funcol._group_or_group_name(group))

    placement_types.shard_dim_alltoall = shard_dim_alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = orig


def count_ops(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), cost)``: the call's :class:`OpCost` as one
    device sees it, its tensor arguments read once and the tensors it
    returns as its output bytes."""
    counter = OpCounter((args, kwargs))
    with _alltoall_on_meta(), counter:
        out = fn(*args, **kwargs)
    counter._live = {}  # storages freed from here on are not followed
    counter.cost.output_bytes = tensor_bytes(out)
    return out, counter.cost
