"""Fused join-dedup and sorted-buffer merge — the two kernels of the
TPU module ``repro/kernels/fused.py``.

* :func:`fused_join_dedup` ports ``fused_join_dedup`` (TPU body
  ``_fused_join_dedup_kernel``) as ``csrc/fused_join_dedup.cu``: one
  memset and one cooperative launch (spans, their scan and the pairs'
  emit, a four-pass radix sort, unique and compaction), then one read of
  the pair total.  Its codes are the 16-bit-halves pairs of the
  distributed engine's ``pack_pairs``; its output folds into an int32
  :class:`FactBuffers`.
* :func:`merge_sorted_unique` ports ``merge_sorted_unique``
  (``_merge_impl``, TPU body ``_merge_kernel``) as
  ``csrc/merge_sorted_unique.cu``: one merge-path pass over both inputs
  with a decoupled look-back, one launch (two when the caller does not
  know how many codes ``buf`` holds).  The result goes to a second buffer
  of the same capacity (``out``), never over ``buf``; :class:`FactBuffers`
  holds such a pair per predicate and swaps them after each merge.
"""

from __future__ import annotations

import ctypes

import torch

from . import ops, ref

__all__ = ["fused_join_dedup", "merge_sorted_unique", "scratch_words"]

#: spans are int32, as on the TPU
_MAX_RIGHT = 2**31 - 1
#: the kernel sorts int32 positions
_MAX_CAPACITY = 2**30
#: the scratch layout of ``csrc/fused_join_dedup.cu`` (``layout``): rows per
#: look-back tile, positions per sort unit, digit bins and passes
_ROW_TILE = 2048
_UNIT = 4096
_BINS = 256
_PASSES = 4
#: merged positions per tile of the merge kernel (256 threads x 31 int32
#: or 15 int64 items), and its scratch words before the per-tile ones
_MERGE_TILE = {torch.int32: 256 * 31, torch.int64: 256 * 15}
_MERGE_WORDS = 4


def scratch_words(n: int, capacity: int) -> int:
    """int64 words of the join kernel's scratch for ``n`` left rows and
    ``capacity`` codes: four words, a status word per row tile and per
    sort unit, the digit counts of each unit for each pass, and two code
    buffers (the last three on 16-byte boundaries)."""
    def a16(x):
        return -(-x // 16) * 16

    units = -(-capacity // _UNIT)
    size = 8 * (4 + -(-n // _ROW_TILE) + units)
    for part in (4 * _PASSES * _BINS * units, 4 * capacity, 4 * capacity):
        size = a16(size) + part
    return -(-size // 8)


def fused_join_dedup(l_keys: torch.Tensor, l_payload: torch.Tensor,
                     r_keys_sorted: torch.Tensor, r_payload: torch.Tensor,
                     capacity: int):
    """Join ``l`` against sorted ``r`` on key and return the deduplicated
    packed pairs ``(l_payload << 16) | (r_payload & 0xFFFF)``, all int32.

    Returns ``(out, count, total)``: ``out`` is ``(capacity,)`` int32,
    sorted unique, padded with int32 max; ``count`` the number of unique
    codes kept (int32, shape ``(1,)``); ``total`` the exact number of
    pairs before the cut and the dedup, read once to the host.  When
    ``total > capacity`` only the first ``capacity`` pairs in left-major
    order were kept: regrow ``capacity`` to at least ``total`` and call
    again.  CPU tensors take the plain version; any other device launches
    the kernel or raises."""
    ops.check_keys("fused_join_dedup", l_keys, l_payload, r_keys_sorted, r_payload)
    if l_keys.dtype != torch.int32:
        raise TypeError("fused_join_dedup: keys and payloads must be int32")
    n, m = l_keys.shape[0], r_keys_sorted.shape[0]
    if l_payload.shape[0] != n or r_payload.shape[0] != m:
        raise ValueError("fused_join_dedup: payloads must match their keys in length")
    if not 0 <= capacity <= _MAX_CAPACITY:
        raise ValueError(f"fused_join_dedup: capacity {capacity} outside [0, {_MAX_CAPACITY}]")
    if m > _MAX_RIGHT:
        raise ValueError(f"fused_join_dedup: {m} right rows overflow int32 spans")
    if l_keys.device.type == "cpu":
        return ref.fused_join_dedup(l_keys, l_payload, r_keys_sorted, r_payload, capacity)
    dev = l_keys.device
    if capacity == 0:  # nothing to hold, and a total of 0, as on the TPU
        return (torch.empty(0, dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev), 0)
    out = torch.empty(capacity, dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    # scratch stays referenced until the call returns (the entry reads the
    # total after the launch): a tensor freed earlier could hand its memory
    # to the next allocation while the kernel runs
    words = scratch_words(n, capacity)
    scratch = torch.empty(words, dtype=torch.int64, device=dev)
    total = ctypes.c_int64()
    ops.launch(
        "fused_join_dedup", "repro_fused_join_dedup", torch.int32, dev,
        l_keys.data_ptr(), l_payload.data_ptr(), n, r_keys_sorted.data_ptr(),
        r_payload.data_ptr(), m, capacity, out.data_ptr(), count.data_ptr(),
        scratch.data_ptr(), words, ctypes.addressof(total),
    )
    # the pairs emitted are part of the launch's size: a join of two large
    # sides that matches nothing is not the largest launch
    ops.note_launch("fused_join_dedup", n=n, m=m, capacity=capacity,
                    pairs=min(total.value, capacity))
    return out, count, total.value


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
    number of codes ``buf`` holds: the kernel then skips finding it
    (one launch instead of two).  It must lie in ``[0, len(buf)]``; on
    the CPU it must equal the number of non-sentinel codes in ``buf``,
    while the card trusts it unchecked (checking would cost a host sync):
    a wrong ``count`` there gives a wrong merge.
    CPU tensors take the plain version; any other device launches the
    kernel or raises."""
    ops.check_keys("merge_sorted_unique", buf, fresh)
    if out is not None:
        if out.shape != buf.shape or out.dtype != buf.dtype or out.device != buf.device:
            raise ValueError("merge_sorted_unique: out must match buf")
        if not out.is_contiguous():
            raise ValueError("merge_sorted_unique: out must be contiguous")
        if out.data_ptr() == buf.data_ptr() and buf.numel():
            raise ValueError("merge_sorted_unique: out must not alias buf")
    cap, nf = buf.shape[0], fresh.shape[0]
    if count is not None and not 0 <= count <= cap:
        raise ValueError(f"merge_sorted_unique: count {count} outside [0, {cap}]")
    if buf.is_cpu:
        if count is not None and count != int((buf != ref.sentinel(buf.dtype)).sum()):
            raise ValueError(f"merge_sorted_unique: buf does not hold {count} codes")
        return ref.merge_sorted_unique(buf, fresh, out)
    dev = buf.device
    if out is None:
        out = torch.empty_like(buf)
    # the totals, the kernel's words and one status word per tile
    words = _MERGE_WORDS + -(-(cap + nf) // _MERGE_TILE[buf.dtype])
    scratch = torch.empty(words, dtype=torch.int64, device=dev)
    ops.launch(
        "merge_sorted_unique", "repro_merge_sorted_unique", buf.dtype, dev,
        buf.data_ptr(), cap, -1 if count is None else count, fresh.data_ptr(), nf,
        out.data_ptr(), scratch.data_ptr(), words,
    )
    shape = {"cap": cap, "fresh": nf}
    if count is not None:
        shape["count"] = count
    ops.note_launch("merge_sorted_unique", **shape)
    return out, scratch[0:1], scratch[1:2]
