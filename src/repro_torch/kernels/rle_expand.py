"""RLE expansion — leaf unfolds and join pair enumeration.

Port of ``repro/kernels/rle_expand.py::rle_expand`` (TPU body
``_rle_kernel``) as the hand-written CUDA kernel ``csrc/rle_expand.cu``: one
block per 16 KB tile of output, which finds its first run by one warp search
over the inclusive run ends and gives every output its run by a max-scan of
run starts in shared memory.
"""

from __future__ import annotations

import torch

from . import ops, ref

__all__ = ["rle_expand"]


def rle_expand(values: torch.Tensor, counts: torch.Tensor, total: int):
    """Expand runs into ``total`` elements: ``values[k]`` repeated
    ``counts[k]`` times, in order.  ``total`` must equal ``counts.sum()``
    (host-known: meta-constant lengths are part of the representation).
    CPU tensors take the plain version; any other device launches the
    kernel or raises."""
    ops.check_keys("rle_expand", values)
    if counts.dim() != 1 or counts.shape[0] != values.shape[0]:
        raise ValueError("rle_expand: counts must match values in length")
    if counts.device != values.device:
        raise ValueError("rle_expand: values and counts on different devices")
    if counts.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"rle_expand: integer counts expected, got {counts.dtype}")
    if values.device.type == "cpu":
        return ref.rle_expand(values, counts, total)
    r = values.shape[0]
    if r >= 2**31:
        raise ValueError(f"rle_expand: {r} runs; the kernel takes fewer than 2**31")
    if total == 0 or r == 0:
        return torch.zeros(0, dtype=values.dtype, device=values.device)
    # inclusive run ends; a dtype argument costs a cast even on int64 counts
    ends = counts.cumsum(0) if counts.dtype == torch.int64 else counts.cumsum(0, dtype=torch.int64)
    out = torch.empty(total, dtype=values.dtype, device=values.device)
    ops.launch(
        "rle_expand", "repro_rle_expand", values.dtype, values.device,
        values.data_ptr(), ends.data_ptr(), r, out.data_ptr(), total,
    )
    ops.note_launch("rle_expand", runs=r, total=total)
    return out
