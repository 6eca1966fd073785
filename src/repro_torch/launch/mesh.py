"""Production meshes, as ``torch.distributed`` device meshes.

Single pod: (data=16, model=16) = 256 ranks.
Multi-pod:  (pod=2, data=16, model=16) = 512 ranks; the leading ``pod``
axis crosses the data-center interconnect, so only data-parallel traffic
(gradient all-reduce, optionally int8-compressed) lands on it.

A mesh spans the ranks of the default process group, which
:func:`init_process_group` starts: NCCL on the card (one rank per card;
without a card it raises), gloo when the caller asks for the CPU.  The
drivers run one rank, a 1x1 mesh.  :class:`AbstractMesh` holds a mesh's
axis names and sizes without ranks, which is all the sharding rules read
(:mod:`.sharding`), so the production meshes' layouts can be computed on
one process.

Defined as functions (never module-level constants): importing this
module touches no device and no process group.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..models.sharding_policy import axis_sizes

__all__ = ["DP_AXES", "AbstractMesh", "axis_sizes", "data_axes", "init_process_group",
           "make_host_mesh", "make_production_mesh"]

DP_AXES = ("pod", "data")  # gradient/batch axes when multi-pod


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, no ranks: ``.axis_names`` and
    ``.shape`` (name -> size), as the JAX package's ``Mesh`` exposes them."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def init_process_group(world_size: int = 1, rank: int = 0, *, device=None,
                       store_path: str | None = None) -> None:
    """Start the default process group of ``world_size`` ranks, this one
    ``rank``: NCCL when ``device`` is the card (``None`` means the card),
    gloo for ``"cpu"``.  The ranks meet in a ``FileStore`` at
    ``store_path`` (one file, shared by every rank; no TCP port), which
    one rank alone may leave out.  A group already started must be of
    ``world_size`` ranks and the same backend; it is kept."""
    dev = torch.device("cuda" if device is None else device)
    backend = {"cuda": "nccl", "cpu": "gloo"}.get(dev.type)
    if backend is None:
        raise ValueError(f"no process-group backend for device {dev}")
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_backend()) != (world_size, backend):
            raise RuntimeError(f"a {dist.get_backend()} process group of "
                               f"{dist.get_world_size()} ranks is already running, not a "
                               f"{backend} one of {world_size}")
        return
    if backend == "nccl":
        if not (torch.cuda.is_available() and dist.is_nccl_available()):
            raise RuntimeError("NCCL on the card is not available; pass device='cpu' "
                               "for gloo ranks on the host")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if store_path is None:
        if world_size != 1:
            raise ValueError("several ranks need a store_path to meet at")
        store = dist.HashStore()
    else:
        store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> DeviceMesh:
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a process group of {n} ranks; "
                           "start it with init_process_group")
    have = dist.get_world_size()
    if have < n:
        raise RuntimeError(f"need {n} ranks, have {have}")
    if have > n:
        raise RuntimeError(f"a {shape} mesh spans all {have} ranks of the group, not {n}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1) -> DeviceMesh:
    """Small (data, model) mesh over the group's ranks (tests, drivers)."""
    return _mesh((data, model), ("data", "model"))


def data_axes(mesh):
    """The batch/FSDP axes present in a mesh (('pod','data') or ('data',))."""
    return tuple(a for a in DP_AXES if a in axis_sizes(mesh))
