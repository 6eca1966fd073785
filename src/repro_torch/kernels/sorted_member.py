"""Sorted membership — the semi-join filter and dedup anti-join test.

Port of ``repro/kernels/sorted_member.py::sorted_member`` (TPU body
``_member_kernel``) as the hand-written CUDA kernel
``csrc/sorted_member.cu``: one thread per element of ``a``, binary search
over ``b_sorted``.
"""

from __future__ import annotations

import torch

from . import ops, ref

__all__ = ["sorted_member"]


def sorted_member(a: torch.Tensor, b_sorted: torch.Tensor) -> torch.Tensor:
    """``out[i] = a[i] in b_sorted`` (bool); ``b_sorted`` ascending, same
    key type (int32 or int64) and device as ``a``.  CPU tensors take the
    plain version; any other device launches the kernel or raises."""
    ops.check_keys("sorted_member", a, b_sorted)
    if a.device.type == "cpu":
        return ref.sorted_member(a, b_sorted)
    n, m = a.shape[0], b_sorted.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=a.device)
    if n:
        ops.launch(
            "sorted_member", "repro_sorted_member", a.dtype, a.device,
            a.data_ptr(), n, b_sorted.data_ptr(), m, out.data_ptr(),
        )
        ops.note_launch("sorted_member", n=n, m=m)
    return out
