"""Sorted-buffer merge — the fused round tail's fold into ``FactBuffers``.

Port of ``repro/kernels/fused.py::merge_sorted_unique`` (``_merge_impl``,
TPU body ``_merge_kernel``) as the hand-written CUDA kernels
``csrc/merge_sorted_unique.cu``: a rank launch, a ``torch.cumsum`` of the
keep flags, and a scatter launch.  The result goes to a second buffer of
the same capacity (``out``), never over ``buf``; :class:`FactBuffers`
holds such a pair per predicate and swaps them after each merge.

``fused_join_dedup`` (the TPU module's other kernel) is not ported yet: no
engine of the reference calls it, and its 16-bit pair pack cannot carry
the dictionary ids of a full-size KB.
"""

from __future__ import annotations

import torch

from . import ops, ref

__all__ = ["merge_sorted_unique"]


def merge_sorted_unique(buf: torch.Tensor, fresh: torch.Tensor,
                        out: torch.Tensor | None = None,
                        count: int | None = None):
    """Merge ascending ``fresh`` codes into the sorted-unique,
    sentinel-padded ``buf`` (sentinel = the key type's max), dropping
    duplicates and cutting to ``len(buf)``.

    Returns ``(merged, count, n_new)`` as the TPU kernel does: ``count``
    is the uncapped unique total and ``n_new`` the values not already in
    ``buf`` (int64 tensors of shape ``(1,)``).  ``merged`` is ``out``
    when given (same shape and type as ``buf``, a different buffer),
    else a new tensor.  ``count``, when the caller keeps it, is the
    number of codes ``buf`` holds; only the launch meter records it (the
    kernel finds it by itself).  CPU tensors take the plain version; any
    other device launches the kernels or raises."""
    ops.check_keys("merge_sorted_unique", buf, fresh)
    if out is not None:
        if out.shape != buf.shape or out.dtype != buf.dtype or out.device != buf.device:
            raise ValueError("merge_sorted_unique: out must match buf")
        if not out.is_contiguous():
            raise ValueError("merge_sorted_unique: out must be contiguous")
        if out.data_ptr() == buf.data_ptr() and buf.numel():
            raise ValueError("merge_sorted_unique: out must not alias buf")
    if buf.device.type == "cpu":
        return ref.merge_sorted_unique(buf, fresh, out)
    dev = buf.device
    cap, nf = buf.shape[0], fresh.shape[0]
    if out is None:
        out = torch.empty_like(buf)
    keep = torch.empty(nf, dtype=torch.int32, device=dev)
    rank = torch.empty(nf, dtype=torch.int64, device=dev)
    stats = torch.empty(2, dtype=torch.int64, device=dev)
    ops.launch(
        "merge_sorted_unique", "repro_merge_rank", buf.dtype, dev,
        buf.data_ptr(), cap, fresh.data_ptr(), nf,
        keep.data_ptr(), rank.data_ptr(),
    )
    kcum = torch.cumsum(keep, 0, dtype=torch.int64)
    ops.launch(
        "merge_sorted_unique", "repro_merge_scatter", buf.dtype, dev,
        buf.data_ptr(), cap, fresh.data_ptr(), nf, keep.data_ptr(),
        rank.data_ptr(), kcum.data_ptr(), out.data_ptr(), stats.data_ptr(),
    )
    shape = {"cap": cap, "fresh": nf}
    if count is not None:
        shape["count"] = count
    ops.note_launch("merge_sorted_unique", **shape)
    return out, stats[0:1], stats[1:2]
