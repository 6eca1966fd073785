"""Flat reference evaluator: answers a query by joining unfolded tensors.

The correctness oracle for the compressed executor (differential tests,
``chip_smoke.py``'s query phase) and the "answer on the flat store"
baseline.  It reuses the flat engine's match/join primitives over plain
per-predicate ``(n, arity)`` tensors — i.e. it requires the fully
unfolded materialisation the compressed path avoids — and, like that
engine, runs plain PyTorch operations only, never a hand kernel.
"""

from __future__ import annotations

import torch

from ..core.flat import _join, _match_flat
from .ast import Query

__all__ = ["answer_flat"]

_I64 = torch.int64


def answer_flat(query: Query, facts: dict[str, torch.Tensor]) -> torch.Tensor:
    """Sorted unique answers of ``query`` over flat fact tensors, on
    their device."""
    device = next((r.device for r in facts.values()), torch.device("cpu"))
    L = None
    for atom in query.body:
        rows = facts.get(atom.predicate)
        if rows is None or rows.shape[0] == 0:
            return _empty(query, device)
        T = _match_flat(atom, rows)
        if T is None:
            return _empty(query, device)
        if not T.vars:
            continue  # all-constant atom: satisfied, adds no bindings
        L = T if L is None else _join(L, T)
        if L.rows.shape[0] == 0:
            return _empty(query, device)
    if query.is_ask:
        return torch.zeros((1, 0), dtype=_I64, device=device)
    idx = [L.vars.index(v) for v in query.projection]
    return torch.unique(L.rows[:, idx], dim=0)


def _empty(query: Query, device) -> torch.Tensor:
    return torch.zeros((0, len(query.projection)), dtype=_I64, device=device)
