"""Join bounds — the cross-join span probe.

Port of ``repro/kernels/join_bounds.py::join_bounds`` (TPU body
``_bounds_kernel``) as the hand-written CUDA kernel ``csrc/join_bounds.cu``:
one thread per left key, a lower and an upper binary search over the sorted
right keys.
"""

from __future__ import annotations

import torch

from . import ops, ref

__all__ = ["join_bounds"]

#: spans are int32, as on the TPU
_MAX_RIGHT = 2**31 - 1


def join_bounds(l_keys: torch.Tensor, r_sorted: torch.Tensor):
    """``(lo, hi)`` int32 spans of each left key in the sorted right keys:
    ``lo[i] = #{r < l[i]}``, ``hi[i] = #{r <= l[i]}``.  Raises when the
    right side has 2^31 rows or more.  CPU tensors take the plain version;
    any other device launches the kernel or raises."""
    ops.check_keys("join_bounds", l_keys, r_sorted)
    n, m = l_keys.shape[0], r_sorted.shape[0]
    if m > _MAX_RIGHT:
        raise ValueError(f"join_bounds: {m} right rows overflow int32 spans")
    if l_keys.device.type == "cpu":
        return ref.join_bounds(l_keys, r_sorted)
    lo = torch.empty(n, dtype=torch.int32, device=l_keys.device)
    hi = torch.empty(n, dtype=torch.int32, device=l_keys.device)
    if n:
        ops.launch(
            "join_bounds", "repro_join_bounds", l_keys.dtype, l_keys.device,
            l_keys.data_ptr(), n, r_sorted.data_ptr(), m,
            lo.data_ptr(), hi.data_ptr(),
        )
        ops.note_launch("join_bounds", n=n, m=m)
    return lo, hi
