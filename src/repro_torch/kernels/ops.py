"""Launch plumbing shared by the kernel wrappers, the launch meter, and
the kernel facade with its registry meter.

Every wrapper checks its operands with :func:`check_keys`, takes the plain
PyTorch version (:mod:`.ref`) for tensors on the CPU, and otherwise calls
:func:`launch`, which runs the C entry point on the current stream and
raises on a launch error.  There is no fallback: a CUDA tensor is served by
the kernel or the call raises.

The launch meter is a plain integer per kernel: a wrapper adds one to its
count where it launches its kernel and nowhere else (CPU calls do not
count), so a run can show that the main path went through every kernel.

The facade (:func:`member`, :func:`anti_join_mask`, :func:`expand_rle`,
:func:`group_spans`, :func:`join_dedup`, :func:`merge_unique`) is the
counterpart of the TPU package's ``kernels/ops.py``: each function calls
its wrapper and, on a card, meters the call in the metrics registry under
``kernels.<op>.calls``, ``kernels.<op>.elements`` and the cross-op total
``kernels.kernel_launches``; :func:`meter`, :func:`launch_count` and
:func:`meter_reset` read and reset that scope.
"""

from __future__ import annotations

import torch

from ..obs import get_registry
from . import build

__all__ = [
    "KERNELS",
    "anti_join_mask",
    "check_keys",
    "expand_rle",
    "group_spans",
    "join_dedup",
    "launch",
    "launch_count",
    "largest_launches",
    "launch_counts",
    "launch_shapes",
    "member",
    "merge_unique",
    "meter",
    "meter_reset",
    "note_launch",
    "note_tuning",
    "reset_launch_counts",
    "tuning_counts",
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
#: the launch-path tuner's sweeps (``tune.py``): how many, their launches
#: (left out of the kernels' counts) and their wall in seconds
_tuning: dict[str, float] = {"sweeps": 0, "launches": 0, "seconds": 0.0}
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


def note_tuning(launches: int, seconds: float) -> None:
    """Count one sweep of the launch-path tuner: its ``launches`` and its
    wall, ``seconds``."""
    _tuning["sweeps"] += 1
    _tuning["launches"] += launches
    _tuning["seconds"] += seconds


def tuning_counts() -> dict[str, float]:
    """The tuner's sweeps since the last reset: ``sweeps``, ``launches``
    and ``seconds`` (their launches are not in :func:`launch_counts`)."""
    return dict(_tuning)


def reset_launch_counts() -> None:
    _tuning.update(sweeps=0, launches=0, seconds=0.0)
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


# --------------------------------------------------------------------- #
# the facade and its registry meter
# --------------------------------------------------------------------- #
#: the metrics-registry scope of facade traffic
_SCOPE = "kernels."


def metered(op: str, n: int, operand: torch.Tensor) -> None:
    """Meter one call of ``op`` over ``n`` elements when ``operand`` lies
    on a card (CPU calls run the plain version and are not metered)."""
    if operand.device.type == "cpu":
        return
    reg = get_registry()
    reg.counter(f"{_SCOPE}{op}.calls").inc()
    reg.counter(f"{_SCOPE}{op}.elements").inc(int(n))
    reg.counter(f"{_SCOPE}kernel_launches").inc()


def meter() -> dict[str, dict[str, int]]:
    """Per-op facade traffic since the last reset, ``{op: {"calls",
    "elements"}}``, ops never called left out."""
    out: dict[str, dict[str, int]] = {}
    for name, val in get_registry().snapshot(_SCOPE).items():
        rest = name[len(_SCOPE):]
        if "." not in rest:
            continue  # the scope-level total
        op, field = rest.rsplit(".", 1)
        if field not in ("calls", "elements"):
            continue
        out.setdefault(op, {"calls": 0, "elements": 0})[field] = int(val)
    return {op: m for op, m in out.items() if m["calls"]}


def launch_count() -> int:
    """Metered kernel calls since the last ``kernels.`` reset."""
    return int(get_registry().snapshot(_SCOPE).get(f"{_SCOPE}kernel_launches", 0))


def meter_reset() -> None:
    """Zero the ``kernels.`` registry scope only."""
    get_registry().reset(_SCOPE)


def member(a: torch.Tensor, b_sorted: torch.Tensor) -> torch.Tensor:
    """``out[i] = a[i] in b_sorted`` (the semi-join filter)."""
    from .sorted_member import sorted_member

    metered("member", a.numel(), a)
    return sorted_member(a, b_sorted)


def anti_join_mask(new: torch.Tensor, old_sorted: torch.Tensor) -> torch.Tensor:
    """Mask of ``new`` elements not in ``old_sorted`` (the dedup test of
    Algorithm 6)."""
    return ~member(new, old_sorted)


def expand_rle(run_values: torch.Tensor, run_counts: torch.Tensor,
               total: int) -> torch.Tensor:
    """Unfold an RLE leaf meta-constant into ``total`` constants."""
    from .rle_expand import rle_expand

    metered("expand_rle", int(total), run_values)
    return rle_expand(run_values, run_counts, int(total))


def group_spans(l_keys: torch.Tensor, r_sorted: torch.Tensor):
    """Per-left-key ``[lo, hi)`` spans in the sorted right keys (the
    cross-join group locator of Algorithm 5)."""
    from .join_bounds import join_bounds

    metered("group_spans", l_keys.numel(), l_keys)
    return join_bounds(l_keys, r_sorted)


def join_dedup(l_keys: torch.Tensor, l_payload: torch.Tensor,
               r_keys_sorted: torch.Tensor, r_payload: torch.Tensor, *,
               capacity: int):
    """Span probe, gather, sort and dedup in one launch; see
    :func:`repro_torch.kernels.fused.fused_join_dedup`."""
    from .fused import fused_join_dedup

    metered("join_dedup", l_keys.numel(), l_keys)
    return fused_join_dedup(l_keys, l_payload, r_keys_sorted, r_payload, capacity)


def merge_unique(buf: torch.Tensor, fresh: torch.Tensor):
    """Sorted-unique merge of ``fresh`` into ``buf`` in one launch; see
    :func:`repro_torch.kernels.fused.merge_sorted_unique`."""
    from .fused import merge_sorted_unique

    metered("merge_unique", fresh.numel(), fresh)
    return merge_sorted_unique(buf, fresh)
