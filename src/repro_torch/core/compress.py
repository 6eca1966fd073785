"""Algorithm 2 (``compress``), vectorised over tensors.

The paper appends each lexicographically-sorted substitution to an open
meta-substitution whenever every column stays non-decreasing, creating a
fresh meta-substitution otherwise.  With a single open candidate this is
exactly *run segmentation*: walk the sorted rows, and cut a new segment at
every position where **any** column decreases.  Sorting keys first on the
column with the fewest distinct values maximises run-length encoding.

The sort is a chain of stable sorts from the least significant key up
(``np.lexsort`` has no torch counterpart); the segment boundaries come to
the host once per call as one index list, and every segment's leaves are
made in one batch.  A call is the span ``compress.rows`` with the
children ``compress.sort``, ``compress.segments`` and ``compress.leaves``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..obs import span
from .columns import ColumnStore

__all__ = [
    "compress_grouped",
    "compress_rows",
    "fewest_distinct_first",
    "lexsort",
    "segment_breaks",
    "sort_for_compression",
]


def lexsort(keys) -> torch.Tensor:
    """Permutation sorting by ``keys`` with the **last** key primary, as
    ``np.lexsort``: successive stable sorts from the first key up."""
    keys = list(keys)
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        _, idx = torch.sort(k[perm], stable=True)
        perm = perm[idx]
    return perm


def fewest_distinct_first(rows: torch.Tensor) -> list[int]:
    """Column order by distinct-value count (stable on ties); one host
    read per column (the size of its unique set)."""
    n_distinct = [torch.unique(rows[:, j]).numel() for j in range(rows.shape[1])]
    return [int(j) for j in np.argsort(n_distinct, kind="stable")]


def sort_for_compression(rows: torch.Tensor) -> torch.Tensor:
    """Lexicographically sort rows, keying first on the column with the
    fewest distinct values (paper §3)."""
    if rows.shape[0] <= 1:
        return rows
    order = fewest_distinct_first(rows)
    perm = lexsort(rows[:, j] for j in reversed(order))
    return rows[perm]


def segment_breaks(rows: torch.Tensor) -> torch.Tensor:
    """Boolean tensor marking rows that start a new segment (row 0
    included): a break occurs where any column strictly decreases."""
    n = rows.shape[0]
    breaks = torch.zeros(n, dtype=torch.bool, device=rows.device)
    if n == 0:
        return breaks
    breaks[0] = True
    if n > 1:
        breaks[1:] = (rows[1:] < rows[:-1]).any(dim=1)
    return breaks


def compress_rows(
    rows: torch.Tensor, store: ColumnStore, presorted: bool = False
) -> list[tuple[tuple[int, ...], int]]:
    """Compress an ``(n, k)`` row set into meta-substitutions: one
    ``(column_ids, length)`` entry per segment."""
    n = rows.shape[0]
    if n == 0:
        return []
    with span("compress.rows", rows=n, arity=rows.shape[1]) as sp:
        if not presorted:
            with span("compress.sort"):
                rows = sort_for_compression(rows)
        with span("compress.segments"):
            starts = torch.nonzero(segment_breaks(rows)).flatten().tolist()
            ends = starts[1:] + [n]
        sp.set(segments=len(starts))
        with span("compress.leaves"):
            return _segment_leaves(rows, list(zip(starts, ends)), store)


def _segment_leaves(rows: torch.Tensor, segments, store: ColumnStore):
    """``(column_ids, length)`` per ``[s, e)`` row segment: one leaf per
    segment and column, created segment by segment in one batch
    (:meth:`ColumnStore.new_leaves` over the rows laid out column by
    column)."""
    n, k = rows.shape
    flat = rows.t().contiguous().reshape(-1)  # column j at [j * n, (j + 1) * n)
    ids = store.new_leaves(
        flat,
        [j * n + s for s, _ in segments for j in range(k)],
        [e - s for s, e in segments for _ in range(k)],
    )
    return [
        (tuple(ids[i * k: (i + 1) * k]), e - s) for i, (s, e) in enumerate(segments)
    ]


def compress_grouped(
    group_starts: np.ndarray,
    group_ends: np.ndarray,
    rows: torch.Tensor,
    store: ColumnStore,
) -> list[list[tuple[tuple[int, ...], int]]]:
    """Compress ``rows`` independently within each ``[start, end)`` group
    (host index arrays); ``rows`` must be sorted within each group.  Used
    by ``xjoin``: each right-hand key group is compressed once and its
    meta-constants shared by every matching left row."""
    n, k = rows.shape
    breaks = segment_breaks(rows)
    if len(group_starts):
        breaks[torch.as_tensor(group_starts, device=rows.device)] = True
    seg_start_idx = torch.nonzero(breaks).flatten().cpu().numpy()
    seg_end_idx = np.append(seg_start_idx[1:], n)
    group_of_seg = np.searchsorted(group_starts, seg_start_idx, side="right") - 1
    out: list[list[tuple[tuple[int, ...], int]]] = [
        [] for _ in range(len(group_starts))
    ]
    segments, owner = [], []
    for s, e, g in zip(seg_start_idx.tolist(), seg_end_idx.tolist(),
                       group_of_seg.tolist()):
        if g < 0 or s >= group_ends[g]:
            continue  # segment not covered by any group
        segments.append((s, min(e, int(group_ends[g]))))
        owner.append(g)
    for g, item in zip(owner, _segment_leaves(rows, segments, store)):
        out[g].append(item)
    return out
