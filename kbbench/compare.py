"""The comparisons that decide ``correct``: the program's output against
the plain reference's, as counts of what differs (each held to 0)."""

from __future__ import annotations

import torch

__all__ = ["fact_mismatches"]


def _codes(rows: torch.Tensor) -> torch.Tensor:
    """Exact int64 codes of id rows of arity 1 or 2 (ids below 2**31)."""
    if not rows.numel():
        return torch.zeros(0, dtype=torch.int64, device=rows.device)
    rows = rows.reshape(rows.shape[0], -1).to(torch.int64)
    if rows.shape[1] == 1:
        return rows[:, 0]
    if rows.shape[1] != 2:
        raise ValueError("facts of arity 1 or 2 only")
    return (rows[:, 0] << 32) | rows[:, 1]


def _in(a: torch.Tensor, b_sorted: torch.Tensor) -> torch.Tensor:
    if not b_sorted.numel():
        return torch.zeros_like(a, dtype=torch.bool)
    pos = torch.searchsorted(b_sorted, a).clamp_(max=b_sorted.numel() - 1)
    return b_sorted[pos] == a


def fact_mismatches(got: dict, want: dict) -> int:
    """Facts in one closure and not the other, summed over every
    predicate of either, plus every duplicate row ``got`` holds."""
    out = 0
    for pred in set(got) | set(want):
        g = got.get(pred)
        w = want.get(pred)
        dev = (w if w is not None else g).device
        g = torch.zeros(0, dtype=torch.int64, device=dev) if g is None else _codes(g.to(dev))
        w = torch.zeros(0, dtype=torch.int64, device=dev) if w is None else _codes(w)
        gu, wu = torch.unique(g), torch.unique(w)
        out += g.numel() - gu.numel()
        out += int((~_in(gu, wu)).sum()) + int((~_in(wu, gu)).sum())
    return out

