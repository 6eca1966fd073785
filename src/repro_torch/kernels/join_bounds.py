"""Join bounds — the cross-join span probe.

Port of ``repro/kernels/join_bounds.py::join_bounds`` (TPU body
``_bounds_kernel``) as the hand-written CUDA kernel ``csrc/join_bounds.cu``,
by one of three paths (:data:`PATHS`) that :func:`route` picks by the
numbers of keys (on a card through the tuner, :mod:`.tune`): for many, the key span of the right keys cut into
equal buckets, an exact table of where each bucket starts built per
call, and both bounds of a left key read from its one bucket; for fewer,
a thread per left key searching all of the right keys; for very few, a
warp per left key searching both bounds 16 ways a step.
"""

from __future__ import annotations

import torch

from . import ops, ref

__all__ = ["PATHS", "join_bounds", "join_bounds_by", "route"]

#: spans are int32, as on the TPU
_MAX_RIGHT = 2**31 - 1
#: right keys per bucket when evenly spread (the kernel counts a bucket of
#: up to 64 bytes of keys without a search)
KEYS_PER_BUCKET = 4
#: calls with at most WARP_KEYS left keys take the warp path, with at
#: most THREAD_KEYS the thread path, with more the table: set from
#: ``chip_smoke.py``'s path sweep and, for WARP_KEYS, the CMat run's own
#: launch of 10,000 keys against 3 M, where ``r`` is cold in L2 and the
#: warp's 6 steps beat the thread's 40 dependent loads (PERF.md)
WARP_KEYS = 1 << 14
THREAD_KEYS = 1 << 18
#: the kernel's paths, by the ``tbits`` that selects each search path
PATHS = ("table", "warp", "thread")
_SEARCH_TBITS = {"warp": -1, "thread": -2}


def route(n: int, m: int, dtype: torch.dtype | None = None, device=None) -> str:
    """The path of :data:`PATHS` that a call with ``n`` left and ``m``
    right keys takes: an empty right side the warp path; on a card
    (``device`` a CUDA device) the path the tune cache picks for ``dtype``
    and the two sides' size buckets (:func:`.tune.get_blocks`, swept once
    on a miss); elsewhere the hand-set rule (``tune.DEFAULTS``: at most
    :data:`WARP_KEYS` left keys the warp path, at most
    :data:`THREAD_KEYS` the thread path, more the table)."""
    from . import tune

    if not m:
        return "warp"
    if device is not None and torch.device(device).type == "cuda":
        return tune.get_blocks("join_bounds", dtype, n, m=m, device=device)["path"]
    return tune.default_blocks("join_bounds", n)["path"]


def _check(l_keys: torch.Tensor, r_sorted: torch.Tensor) -> None:
    ops.check_keys("join_bounds", l_keys, r_sorted)
    if r_sorted.shape[0] > _MAX_RIGHT:
        raise ValueError(f"join_bounds: {r_sorted.shape[0]} right rows overflow int32 spans")


def join_bounds(l_keys: torch.Tensor, r_sorted: torch.Tensor):
    """``(lo, hi)`` int32 spans of each left key in the sorted right keys:
    ``lo[i] = #{r < l[i]}``, ``hi[i] = #{r <= l[i]}``.  Raises when the
    right side has 2^31 rows or more.  CPU tensors take the plain version;
    any other device launches the kernel or raises."""
    _check(l_keys, r_sorted)
    if l_keys.is_cpu:
        return ref.join_bounds(l_keys, r_sorted)
    return _launch(l_keys, r_sorted,
                   route(l_keys.shape[0], r_sorted.shape[0], l_keys.dtype, l_keys.device))


def join_bounds_by(l_keys: torch.Tensor, r_sorted: torch.Tensor, path: str, *,
                   meter: bool = True):
    """:func:`join_bounds` on the card by the named path of :data:`PATHS`,
    whatever the sizes: every path gives the same spans, so that each can
    be held against the plain version and timed against the others.
    ``meter=False`` leaves the launch out of the launch meter (the tuner's
    sweep)."""
    _check(l_keys, r_sorted)
    if path not in PATHS:
        raise ValueError(f"join_bounds: no path {path!r}; one of {PATHS}")
    if l_keys.is_cpu:
        raise ValueError("join_bounds: the kernel's paths run on the card only")
    return _launch(l_keys, r_sorted, path, meter)


def _launch(l_keys: torch.Tensor, r_sorted: torch.Tensor, path: str, meter: bool = True):
    n, m = l_keys.shape[0], r_sorted.shape[0]
    # lo and hi as two allocations (each starts on a 16-byte boundary for
    # the kernel's vector stores): on the card's host two allocations cost
    # less than one and two views of it
    dev = l_keys.device
    lo = torch.empty(n, dtype=torch.int32, device=dev)
    hi = torch.empty(n, dtype=torch.int32, device=dev)
    if path == "table":
        # 2^tbits buckets: about m / 4, never more than the left keys; the
        # table holds their starts and the number of keys below the padding
        # (scratch: referenced until the launch is queued)
        tbits = (max(min(-(-m // KEYS_PER_BUCKET), n), 1) - 1).bit_length()
        table = torch.empty((1 << tbits) + 2, dtype=torch.int32, device=dev)
    else:
        tbits, table = _SEARCH_TBITS[path], None
    if n:
        ops.launch(
            "join_bounds", "repro_join_bounds", l_keys.dtype, dev,
            l_keys.data_ptr(), n, r_sorted.data_ptr(), m, lo.data_ptr(), hi.data_ptr(),
            None if table is None else table.data_ptr(), tbits,
        )
        if meter:
            ops.note_launch("join_bounds", n=n, m=m)
    return lo, hi
