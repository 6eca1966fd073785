"""Row-set helpers of the maintained row index (the index itself is not
ported yet; see ``ROADMAP.md`` queue 1 item 7)."""

from __future__ import annotations

import torch

from ..core.util import multicol_member, unique_rows

__all__ = ["merge_rows", "setdiff_rows"]


def merge_rows(a: torch.Tensor | None, b: torch.Tensor) -> torch.Tensor:
    """Sorted-unique union of two row sets (``a`` may be absent)."""
    if a is None or a.shape[0] == 0:
        return b
    return unique_rows(torch.cat([a, b]))


def setdiff_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rows of ``a`` not occurring in ``b``."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        return a
    return a[~multicol_member(a, b)]
