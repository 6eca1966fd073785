"""Duplicate elimination (Algorithm 6), vectorised over tensors.

Same semantics as the reference: all candidate meta-facts of a predicate
are unfolded once into a row block, ``first_occurrence_mask`` removes
duplicates within the round, a sorted-membership test (the
``sorted_member`` kernel) against the current materialisation — or against
a persistent sorted index — removes facts already in ``M``, and survivors
are re-expressed with the paper's ``shuffle`` so that fully-novel
meta-facts keep their (shared) columns untouched.  Per-candidate survivor
counts come to the host in one read per predicate.  Each predicate's
three steps are the spans ``dedup.unfold`` (args ``rows``, and ``leaves``
and ``slices``: the leaf parts gathered and the slices they merged into),
``dedup.mask`` and ``dedup.split``.
"""

from __future__ import annotations

import torch

from ..obs import span
from .columns import ColumnStore
from .joins import split_survivors
from .metafacts import FactStore, MetaFact
from .util import (
    factorize_rows,
    first_occurrence_mask,
    merge_sorted_unique,
    segment_counts,
    sorted_member,
)

__all__ = ["DedupIndex", "elim_dup"]

_I64 = torch.int64


class DedupIndex:
    """Persistent per-predicate sorted fact index (speed for memory).

    Keeps each predicate's facts as a sorted packed-int64 tensor: arity-1
    facts use the id itself, arity-2 packs ``(a << 32) | b`` (ids below
    2^31, as the dictionary guarantees).  Higher arities fall back to
    joint factorisation per round (``fresh_mask`` returns None)."""

    def __init__(self):
        self._packed: dict[str, torch.Tensor] = {}

    @staticmethod
    def pack(rows: torch.Tensor) -> torch.Tensor | None:
        if rows.shape[1] == 1:
            return rows[:, 0].to(_I64).contiguous()
        if rows.shape[1] == 2:
            return (rows[:, 0].to(_I64) << 32) | rows[:, 1].to(_I64)
        return None  # arity > 2: caller falls back

    def seed(self, pred: str, rows: torch.Tensor) -> None:
        packed = self.pack(rows)
        if packed is not None:
            existing = self._packed.get(pred)
            merged = packed if existing is None else torch.cat([existing, packed])
            self._packed[pred] = torch.unique(merged)

    def fresh_mask(self, pred: str, rows: torch.Tensor) -> torch.Tensor | None:
        """keep-mask (not-in-index AND first occurrence); None = fallback."""
        packed = self.pack(rows)
        if packed is None:
            return None
        index = self._packed.get(pred)
        if index is None or index.shape[0] == 0:
            not_in = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
        else:
            not_in = ~sorted_member(packed, index)
        keep = not_in & first_occurrence_mask(packed)
        # survivors are distinct and absent from the index: merge them in
        # by position instead of re-sorting the whole index
        survivors = torch.sort(packed[keep]).values
        if survivors.shape[0]:
            self._packed[pred] = (
                survivors if index is None else merge_sorted_unique(index, survivors)
            )
        return keep

    def nbytes(self) -> int:
        return sum(int(a.numel() * a.element_size()) for a in self._packed.values())


def elim_dup(
    candidates: dict[str, list[tuple[tuple[int, ...], int]]],
    facts: FactStore,
    store: ColumnStore,
    round_tag: int,
    inplace_splits: bool = False,
    index=None,
    fresh_counts: dict[str, list[int]] | None = None,
) -> list[MetaFact]:
    """Return meta-facts for every candidate fact not already in ``M``.

    ``candidates`` maps predicate -> list of (column ids, length).  With
    ``index`` (a :class:`DedupIndex` or ``FactBuffers``) the anti-join
    runs against the persistent sorted index instead of re-unfolding
    ``M`` each round.  With ``fresh_counts``, each candidate group's
    survivor count is appended to ``fresh_counts[pred]`` in candidate
    order (provenance attribution; the counts are host ints already)."""
    delta: list[MetaFact] = []
    for pred, cand in candidates.items():
        if not cand:
            continue
        arity = len(cand[0][0])
        if arity == 0:
            continue
        with span("dedup.unfold") as sp:
            leaves0, slices0 = store.n_gathered_leaves, store.n_gathered_slices
            cols = [
                store.unfold_cat([c[j] for c, _ in cand])
                for j in range(arity)
            ]
            rows = torch.stack(cols, dim=1)
            sp.set(rows=rows.shape[0], leaves=store.n_gathered_leaves - leaves0,
                   slices=store.n_gathered_slices - slices0)

        with span("dedup.mask"):
            keep = index.fresh_mask(pred, rows) if index is not None else None
            if keep is None:
                m_rows = facts.unfold_pred(pred)
                if m_rows.shape[0] and m_rows.shape[1] != arity:
                    raise ValueError(f"arity mismatch for {pred}")
                if m_rows.shape[0]:
                    codes_new, codes_m = factorize_rows(rows, m_rows)
                    not_in_m = ~sorted_member(codes_new, torch.sort(codes_m).values)
                else:
                    codes_new = factorize_rows(rows)[0]
                    not_in_m = torch.ones(rows.shape[0], dtype=torch.bool,
                                          device=rows.device)
                keep = not_in_m & first_occurrence_mask(codes_new)

        with span("dedup.split", items=len(cand)) as sp:
            kept = segment_counts(keep, [length for _, length in cand])
            if fresh_counts is not None:
                fresh_counts.setdefault(pred, []).extend(kept)
            # each distinct column id is split once (a head like ``P(x, x)``
            # repeats one id)
            for item in split_survivors(store, cand, keep, kept, inplace_splits):
                if item is not None:
                    delta.append(MetaFact(pred, item[0], item[1], round_tag))
            sp.set(survivors=sum(kept))
    return delta
