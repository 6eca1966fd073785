"""Update batches: normalisation and the clamp against the explicit set,
the contract every maintenance engine shares (the incremental store itself
is not ported yet; see ``ROADMAP.md`` queue 1 item 7)."""

from __future__ import annotations

import torch

from ..core.util import multicol_member, unique_rows
from .index import merge_rows

__all__ = ["effective_updates", "normalise_batch"]


def normalise_batch(batch) -> dict[str, torch.Tensor]:
    """Canonical update batch: sorted-unique ``(n, arity)`` int64 CPU rows
    per predicate (numpy arrays or tensors in), empty predicates dropped."""
    out: dict[str, torch.Tensor] = {}
    for pred, rows in (batch or {}).items():
        rows = torch.as_tensor(rows).to("cpu", torch.int64)
        if rows.dim() == 1:
            rows = rows.reshape(-1, 1)
        if rows.shape[0]:
            out[pred] = unique_rows(rows)
    return out


def effective_updates(
    explicit: dict[str, torch.Tensor],
    adds: dict[str, torch.Tensor],
    dels: dict[str, torch.Tensor],
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """Clamp a normalised batch against the explicit set and update it in
    place (``E := (E \\ dels) ∪ adds``).

    Returns ``(eff_adds, eff_dels)``: deletions of non-explicit facts and
    additions of already-explicit facts are dropped, so batches are
    idempotent."""
    eff_dels: dict[str, torch.Tensor] = {}
    for pred, rows in dels.items():
        present = explicit.get(pred)
        if present is None or present.shape[0] == 0:
            continue
        rows = rows[multicol_member(rows, present)]
        if rows.shape[0]:
            eff_dels[pred] = rows
            explicit[pred] = present[~multicol_member(present, rows)]
    eff_adds: dict[str, torch.Tensor] = {}
    for pred, rows in adds.items():
        present = explicit.get(pred)
        if present is not None and present.shape[0]:
            rows = rows[~multicol_member(rows, present)]
        if rows.shape[0]:
            eff_adds[pred] = rows
            explicit[pred] = merge_rows(present, rows)
    return eff_adds, eff_dels
