"""Vectorised multi-column set operations over torch tensors.

These replace the paper's priority-queue merge loops with data-parallel
sorted-array primitives.  Membership goes through the ``sorted_member``
kernel (:mod:`repro_torch.kernels`) on a card and its plain version on the
CPU; everything else is plain tensor code on the tensors' own device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import sorted_member as _member_kernel

__all__ = [
    "factorize_rows",
    "first_occurrence_mask",
    "merge_sorted_rows",
    "merge_sorted_unique",
    "multicol_member",
    "resolve_device",
    "segment_counts",
    "sorted_member",
    "synchronize",
    "unique_rows",
]

_I64 = torch.int64


def resolve_device(device: torch.device | str | None) -> torch.device:
    """The engines' device: ``None`` means the card, and there is no
    silent drop to the CPU — a missing card raises.  Pass ``"cpu"``
    explicitly to run on the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the host"
        )
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work, so a host wall covers it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sorted_member(a: torch.Tensor, b_sorted: torch.Tensor) -> torch.Tensor:
    """Membership of each element of ``a`` in the sorted 1-D ``b_sorted``."""
    return _member_kernel(a.contiguous(), b_sorted.contiguous())


def _packable(rows: torch.Tensor) -> bool:
    """Pairs of dictionary-range ids (``0 <= id < 2**31``): one host
    sync for both bounds."""
    lo, hi = torch.aminmax(rows)
    lo, hi = torch.stack([lo, hi]).tolist()
    return lo >= 0 and hi < 2**31


def factorize_rows(*row_sets: torch.Tensor) -> list[torch.Tensor]:
    """Jointly factorize several ``(n_i, k)`` row sets into int64 codes
    such that two rows (from any set) get equal codes iff they are equal
    (codes are order-consistent with lexicographic row order, not
    necessarily dense).

    Pairs of dictionary-range ids take the packing fast path — ``(a <<
    32) | b`` preserves equality and lexicographic order and skips the
    row-unique sort."""
    k = row_sets[0].shape[1] if row_sets[0].dim() == 2 else 1
    sizes = [r.shape[0] for r in row_sets]
    stacked = torch.cat([r if r.dim() == 2 else r.reshape(-1, 1) for r in row_sets])
    if stacked.shape[0] == 0:
        return [torch.zeros(n, dtype=_I64, device=stacked.device) for n in sizes]
    if k == 0:
        codes = torch.zeros(stacked.shape[0], dtype=_I64, device=stacked.device)
    elif k == 1:
        codes = stacked[:, 0]
    elif k == 2 and _packable(stacked):
        codes = (stacked[:, 0] << 32) | stacked[:, 1]
    else:
        _, codes = torch.unique(stacked, dim=0, return_inverse=True)
    codes = codes.to(_I64)
    return list(torch.split(codes, sizes))


def multicol_member(a_rows: torch.Tensor, b_rows: torch.Tensor,
                    member=sorted_member) -> torch.Tensor:
    """Boolean mask: which rows of ``a_rows`` occur in ``b_rows``.
    ``member`` is the sorted-membership test (the flat oracle passes the
    plain version so that it never runs a hand kernel)."""
    n = a_rows.shape[0]
    if n == 0 or b_rows.shape[0] == 0:
        return torch.zeros(n, dtype=torch.bool, device=a_rows.device)
    if a_rows.dim() == 2 and a_rows.shape[1] == 1:
        a_rows, b_rows = a_rows[:, 0], b_rows[:, 0]
    if a_rows.dim() == 1:
        return member(a_rows.contiguous(), torch.sort(b_rows).values)
    codes_a, codes_b = factorize_rows(a_rows, b_rows)
    return member(codes_a.contiguous(), torch.sort(codes_b).values)


def unique_rows(rows: torch.Tensor, return_inverse: bool = False):
    """Lexicographically sorted unique rows of an ``(n, k)`` block, with
    the packed-int64 fast path of :func:`factorize_rows` for k <= 2."""
    n, k = rows.shape
    if k == 1:
        u, inv = torch.unique(rows[:, 0], return_inverse=True)
        out = u.reshape(-1, 1)
        return (out, inv) if return_inverse else out
    if k == 2 and n and _packable(rows):
        codes = (rows[:, 0].to(_I64) << 32) | rows[:, 1].to(_I64)
        u, inv = torch.unique(codes, return_inverse=True)
        out = torch.stack([u >> 32, u & 0xFFFFFFFF], dim=1).to(rows.dtype)
        return (out, inv) if return_inverse else out
    if n == 0:
        out = rows[:0]
        inv = torch.zeros(0, dtype=_I64, device=rows.device)
        return (out, inv) if return_inverse else out
    out, inv = torch.unique(rows, dim=0, return_inverse=True)
    return (out, inv.reshape(-1)) if return_inverse else out


def merge_sorted_unique(old: torch.Tensor, fresh: torch.Tensor) -> torch.Tensor:
    """Positional merge of sorted-unique ``fresh`` values into the
    sorted-unique ``old`` (``fresh`` disjoint from ``old``) — plain tensor
    code, used by :class:`~repro_torch.core.dedup.DedupIndex`; the fused
    tail folds through the ``merge_sorted_unique`` kernel in
    :class:`~repro_torch.kernels.buffers.FactBuffers`."""
    if fresh.shape[0] == 0:
        return old
    if old.shape[0] == 0:
        return fresh
    dest = torch.searchsorted(old, fresh) + torch.arange(
        fresh.shape[0], device=fresh.device
    )
    out = torch.empty(old.shape[0] + fresh.shape[0], dtype=old.dtype,
                      device=old.device)
    taken = torch.zeros(out.shape[0], dtype=torch.bool, device=old.device)
    taken[dest] = True
    out[dest] = fresh
    out[~taken] = old
    return out


def merge_sorted_rows(
    old: torch.Tensor,
    fresh: torch.Tensor,
    codes_old: torch.Tensor,
    codes_fresh: torch.Tensor,
) -> torch.Tensor:
    """Row-block analogue of :func:`merge_sorted_unique`: positionally
    merge lex-sorted-unique, disjoint ``fresh`` rows into lex-sorted-
    unique ``old`` rows, placed by jointly order-consistent row codes."""
    if fresh.shape[0] == 0:
        return old
    if old.shape[0] == 0:
        return fresh
    dest = torch.searchsorted(codes_old, codes_fresh) + torch.arange(
        fresh.shape[0], device=fresh.device
    )
    out = torch.empty((old.shape[0] + fresh.shape[0], old.shape[1]),
                      dtype=old.dtype, device=old.device)
    taken = torch.zeros(out.shape[0], dtype=torch.bool, device=old.device)
    taken[dest] = True
    out[dest] = fresh
    out[~taken] = old
    return out


def segment_counts(mask: torch.Tensor, lengths: list[int]) -> list[int]:
    """True entries of ``mask`` in each consecutive segment of the given
    host ``lengths`` — one host read for all segments (in place of an
    ``any()`` / ``all()`` read per segment)."""
    if not lengths:
        return []
    if len(lengths) == 1:
        return [int(mask.sum())]
    csum = torch.zeros(mask.shape[0] + 1, dtype=_I64, device=mask.device)
    torch.cumsum(mask, 0, out=csum[1:])
    bounds = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=bounds[1:])
    at = csum[torch.from_numpy(bounds).to(mask.device)]
    return (at[1:] - at[:-1]).tolist()


def first_occurrence_mask(codes: torch.Tensor) -> torch.Tensor:
    """Mask of positions that are the first occurrence of their value."""
    n = codes.shape[0]
    mask = torch.zeros(n, dtype=torch.bool, device=codes.device)
    if n == 0:
        return mask
    sorted_codes, order = torch.sort(codes, stable=True)
    is_first = torch.ones(n, dtype=torch.bool, device=codes.device)
    is_first[1:] = sorted_codes[1:] != sorted_codes[:-1]
    mask[order] = is_first
    return mask
