"""Sorted membership — the semi-join filter and dedup anti-join test.

Port of ``repro/kernels/sorted_member.py::sorted_member`` (TPU body
``_member_kernel``) as the hand-written CUDA kernel
``csrc/sorted_member.cu``: the key span of ``b_sorted`` cut into equal
buckets, a table of where each bucket starts in ``b_sorted`` built per call,
and each probe's bucket read from it by arithmetic, then searched.
"""

from __future__ import annotations

import torch

from . import ops, ref

__all__ = ["sorted_member"]

#: keys of ``b_sorted`` per bucket when evenly spread (at most 32 bytes of
#: int64 keys, which the kernel reads without a search)
KEYS_PER_BUCKET = 4


def sorted_member(a: torch.Tensor, b_sorted: torch.Tensor) -> torch.Tensor:
    """``out[i] = a[i] in b_sorted`` (bool); ``b_sorted`` ascending, same
    key type (int32 or int64) and device as ``a``.  CPU tensors take the
    plain version; any other device launches the kernel or raises."""
    ops.check_keys("sorted_member", a, b_sorted)
    if a.device.type == "cpu":
        return ref.sorted_member(a, b_sorted)
    n, m = a.shape[0], b_sorted.shape[0]
    out = torch.empty_like(a, dtype=torch.bool)
    if n == 0:
        return out
    if m >= 2**31:
        raise ValueError(f"sorted_member: {m} keys in b; the kernel takes fewer than 2**31")
    tbits, start = 0, None
    if m:  # 2^tbits buckets: about m / 4, never more than the probes
        tbits = (min(-(-m // KEYS_PER_BUCKET), n) - 1).bit_length()
        start = torch.empty((1 << tbits) + 1, dtype=torch.int32, device=a.device)
    ops.launch(
        "sorted_member", "repro_sorted_member", a.dtype, a.device,
        a.data_ptr(), n, b_sorted.data_ptr(), m, out.data_ptr(),
        None if start is None else start.data_ptr(), tbits,
    )
    if m:
        ops.note_launch("sorted_member", n=n, m=m)
    else:  # nothing to search: counted, never the largest launch
        ops.note_launch("sorted_member")
    return out
