"""The explicit-restore step of Delete/Rederive (the rest of DRed is not
ported yet; see ``ROADMAP.md`` queue 1 item 7)."""

from __future__ import annotations

import torch

from ..core.util import multicol_member

__all__ = ["explicit_restores"]


def explicit_restores(
    missing: dict[str, torch.Tensor], explicit: dict[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """Overdeleted rows that are still explicit facts — they come back
    without any derivability probe (the first rederivation step)."""
    out: dict[str, torch.Tensor] = {}
    for pred, miss in missing.items():
        present = explicit.get(pred)
        if present is None or present.shape[0] == 0 or miss.shape[0] == 0:
            continue
        back = miss[multicol_member(miss, present)]
        if back.shape[0]:
            out[pred] = back
    return out
