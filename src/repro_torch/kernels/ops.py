"""Launch plumbing shared by the kernel wrappers, and the launch meter.

Every wrapper checks its operands with :func:`check_keys`, takes the plain
PyTorch version (:mod:`.ref`) for tensors on the CPU, and otherwise calls
:func:`launch`, which runs the C entry point on the current stream and
raises on a launch error.  There is no fallback: a CUDA tensor is served by
the kernel or the call raises.

The meter is a plain integer per kernel: a wrapper adds one to its count
where it launches its kernel and nowhere else (CPU calls do not count), so
a run can show that the main path went through every kernel.
"""

from __future__ import annotations

import torch

from . import build

__all__ = [
    "KERNELS",
    "check_keys",
    "launch",
    "largest_launches",
    "launch_counts",
    "launch_shapes",
    "note_launch",
    "reset_launch_counts",
]

KERNELS = (
    "sorted_member", "join_bounds", "rle_expand", "merge_sorted_unique",
    "fused_join_dedup",
)

_KEY_TYPES = {torch.int32: "i32", torch.int64: "i64"}
_launches: dict[str, int] = dict.fromkeys(KERNELS, 0)
_largest: dict[str, dict[str, int]] = {k: {} for k in KERNELS}
#: launches per distinct operand lengths, per kernel
_shapes: dict[str, dict[tuple, int]] = {k: {} for k in KERNELS}
#: the bound C function of each (entry, key type), with its library
_entries: dict[tuple[str, torch.dtype], tuple] = {}


def note_launch(kernel: str, **shape: int) -> None:
    """Count one launch of ``kernel``; ``shape`` names its operand
    lengths (the largest launch's are kept, by their sum)."""
    _launches[kernel] += 1
    key = tuple(shape.items())
    _shapes[kernel][key] = _shapes[kernel].get(key, 0) + 1
    if sum(shape.values()) > sum(_largest[kernel].values()):
        _largest[kernel] = dict(shape)


def launch_counts() -> dict[str, int]:
    """Launches per kernel since the last reset."""
    return dict(_launches)


def largest_launches() -> dict[str, dict[str, int]]:
    """Operand lengths of each kernel's largest launch since the last
    reset."""
    return {k: dict(v) for k, v in _largest.items()}


def launch_shapes(kernel: str) -> list[tuple[dict[str, int], int]]:
    """Each distinct set of operand lengths ``kernel`` launched with since
    the last reset, and how many times, in the order first seen."""
    return [(dict(key), n) for key, n in _shapes[kernel].items()]


def reset_launch_counts() -> None:
    for k in KERNELS:
        _launches[k] = 0
        _largest[k] = {}
        _shapes[k] = {}


def check_keys(op: str, *tensors: torch.Tensor) -> None:
    """Key operands: 1-D, contiguous, one dtype (int32 or int64), one
    device.  Raises on anything else."""
    first = tensors[0]
    if first.dtype not in _KEY_TYPES:
        raise TypeError(f"{op}: keys must be int32 or int64, got {first.dtype}")
    for t in tensors:
        if t.dim() != 1:
            raise ValueError(f"{op}: expected 1-D keys, got shape {tuple(t.shape)}")
        if t.dtype != first.dtype:
            raise TypeError(f"{op}: mixed key types {first.dtype} / {t.dtype}")
        if t.device != first.device:
            raise ValueError(f"{op}: operands on {first.device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: operands must be contiguous")


def launch(kernel: str, entry: str, dtype: torch.dtype,
           device: torch.device, *args) -> None:
    """Run C entry ``<entry>_<i32|i64>`` of ``kernel``'s library on the
    current stream of ``device``; raise if the launch was refused.

    The bound C function is kept per (entry, key type), the stream is read
    as a raw pointer (``torch.cuda.current_stream`` builds a Python object
    per call), and the current device is switched only when the tensors lie
    on another one."""
    bound = _entries.get((entry, dtype))
    if bound is None:
        lib = build.library(kernel)
        bound = _entries[(entry, dtype)] = (lib, getattr(lib, f"{entry}_{_KEY_TYPES[dtype]}"))
    lib, fn = bound
    if device.type != "cuda":
        raise ValueError(f"{kernel}: the kernel takes CUDA tensors, got {device}")
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{kernel}: launch of {entry} failed: {msg} ({err})")
