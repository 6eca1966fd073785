"""Meta-facts and the fact store ``M`` (with semi-naive round tags).

A meta-fact ``P(a1, ..., an)`` pairs a predicate with ``n`` meta-constants
of equal unfolding length; it represents the ``length`` ordinary facts read
off positionally from the unfoldings of its columns.  Meta-facts are host
metadata; their columns' payloads live in the :class:`ColumnStore`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .columns import ColumnStore

__all__ = ["FactStore", "MetaFact", "flat_repr_size"]


@dataclass
class MetaFact:
    predicate: str
    columns: tuple[int, ...]  # meta-constant ids
    length: int
    round: int = 0  # semi-naive round in which it was derived
    mf_id: int = -1  # store-assigned lineage id (-1 = not yet stored)

    @property
    def arity(self) -> int:
        return len(self.columns)


class FactStore:
    """Per-predicate lists of meta-facts, tagged by derivation round.

    During round ``r``: ``delta(pred)`` holds the facts derived in the
    previous round (tag ``r``), ``old(pred)`` those derived before it,
    ``all(pred)`` their union (Algorithm 1's ``M \\ Delta`` bookkeeping).
    """

    def __init__(self, store: ColumnStore):
        self.store = store
        self._facts: dict[str, list[MetaFact]] = {}
        self.current_round = 0
        self._next_mf_id = 0

    # ------------------------------------------------------------------ #
    def add(self, mf: MetaFact) -> None:
        if mf.mf_id < 0:
            mf.mf_id = self._next_mf_id
            self._next_mf_id += 1
        self._facts.setdefault(mf.predicate, []).append(mf)

    def predicates(self):
        return self._facts.keys()

    def replace(self, pred: str, facts: list[MetaFact]) -> None:
        self._facts[pred] = facts

    def all(self, pred: str) -> list[MetaFact]:
        return self._facts.get(pred, [])

    def delta(self, pred: str) -> list[MetaFact]:
        r = self.current_round
        return [mf for mf in self._facts.get(pred, []) if mf.round == r]

    def old(self, pred: str) -> list[MetaFact]:
        r = self.current_round
        return [mf for mf in self._facts.get(pred, []) if mf.round < r]

    def has_delta(self) -> bool:
        r = self.current_round
        return any(
            mf.round == r for lst in self._facts.values() for mf in lst
        )

    # ------------------------------------------------------------------ #
    # unfolding / statistics
    # ------------------------------------------------------------------ #
    def unfold_pred(self, pred: str, which: str = "all") -> torch.Tensor:
        """Unfold all meta-facts of a predicate into an ``(n, arity)``
        tensor."""
        facts = getattr(self, which)(pred)
        if not facts:
            return torch.zeros((0, 1), dtype=torch.int64, device=self.store.device)
        cols = [
            self.store.unfold_cat([mf.columns[j] for mf in facts])
            for j in range(facts[0].arity)
        ]
        return torch.stack(cols, dim=1)

    def n_meta_facts(self) -> int:
        return sum(len(v) for v in self._facts.values())

    def n_facts(self) -> int:
        """Number of represented facts (with multiplicity)."""
        return sum(mf.length for lst in self._facts.values() for mf in lst)

    def freeze(self):
        """Snapshot view for query answering.

        After freezing, the meta-facts and every node currently in the
        column store must not be redefined; query evaluation allocates
        only scratch nodes above the freeze mark and releases them."""
        from .frozen import FrozenFacts

        return FrozenFacts(self)

    def to_dict(self) -> dict[str, torch.Tensor]:
        """Unfold the whole store into flat per-predicate fact tensors
        (lexicographically sorted, duplicates removed)."""
        out = {}
        for pred in self._facts:
            out[pred] = torch.unique(self.unfold_pred(pred), dim=0)
        return out

    # ------------------------------------------------------------------ #
    # representation-size metric (paper Section 4)
    # ------------------------------------------------------------------ #
    def meta_repr_size(self) -> int:
        """``||M||`` = sum over predicates of ``1 + arity * #meta-facts``."""
        total = 0
        for lst in self._facts.values():
            if not lst:
                continue
            total += 1 + lst[0].arity * len(lst)
        return total

    def mu_repr_size(self, adaptive: bool = True) -> int:
        """``||mu||`` over meta-constants reachable from the store."""
        roots = [c for lst in self._facts.values() for mf in lst for c in mf.columns]
        reach = self.store.reachable(roots)
        return sum(self.store.repr_size(c, adaptive) for c in reach)

    def total_repr_size(self, adaptive: bool = True) -> int:
        """``||<M, mu>||`` (``adaptive=False`` = paper-exact accounting)."""
        return self.meta_repr_size() + self.mu_repr_size(adaptive)

    def mu_stats(self) -> dict:
        """avg/max unfolding length and max depth of reachable meta-constants."""
        roots = [c for lst in self._facts.values() for mf in lst for c in mf.columns]
        reach = self.store.reachable(roots)
        if not reach:
            return {"avg_len": 0.0, "max_len": 0, "max_depth": 0, "n_meta_constants": 0}
        lens = [self.store.length(c) for c in reach]
        depth = max(self.store.depth(c) for c in reach)
        return {
            "avg_len": float(sum(lens) / len(lens)),
            "max_len": int(max(lens)),
            "max_depth": int(depth),
            "n_meta_constants": len(reach),
        }


def flat_repr_size(facts: dict[str, torch.Tensor]) -> int:
    """``||I||`` of a flat dataset: sum of ``1 + arity * m_i`` (paper §4)."""
    total = 0
    for rows in facts.values():
        if rows.shape[0] == 0:
            continue
        total += 1 + rows.shape[1] * rows.shape[0]
    return total
