"""Maintained flat row index over the materialisation.

The incremental store keeps, per predicate, the **sorted unique flat
rows** of the current materialisation, as int64 ``(n, arity)`` tensors on
the store's device, in lexicographic order (first column primary, the
order ``unique_rows`` hands out):

* membership probes (is an overdelete candidate materialised? is a
  derived candidate fresh?) are one ``sorted_member`` call over row codes,
* derivation-count columns align positionally with the rows, so count
  updates are ``index_add_`` at positions found by ``join_bounds``,
* :meth:`RowIndex.to_dict` seeds :class:`~repro_torch.core.frozen.FrozenFacts`
  snapshots at freeze time.

Row codes come from :func:`~repro_torch.core.util.factorize_rows`, which
keeps lexicographic order, so the stored rows' codes are ascending and
need no sort.  Mutations return the alignment information (the sort
permutation on insert, the keep mask on remove) so callers can permute or
mask parallel columns.
"""

from __future__ import annotations

import torch

from ..core.util import factorize_rows, multicol_member, sorted_member, unique_rows
from ..kernels import join_bounds
from ..obs.memory import split_owned_backed

__all__ = ["RowIndex", "merge_rows", "setdiff_rows"]

_I64 = torch.int64


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


class RowIndex:
    """Per-predicate sorted unique ``(n, arity)`` row tensors on one
    device."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._rows: dict[str, torch.Tensor] = {}
        self._empty = torch.zeros((0, 1), dtype=_I64, device=device)

    def seed(self, pred: str, rows: torch.Tensor) -> None:
        self._rows[pred] = unique_rows(rows.to(device=self.device, dtype=_I64))

    def seed_sorted(self, pred: str, rows: torch.Tensor) -> None:
        """Adopt rows that are already sorted-unique."""
        self._rows[pred] = rows.to(device=self.device, dtype=_I64)

    def predicates(self):
        return self._rows.keys()

    def rows(self, pred: str) -> torch.Tensor:
        return self._rows.get(pred, self._empty)

    def n_rows(self, pred: str) -> int:
        return int(self.rows(pred).shape[0])

    def _codes(self, pred: str, q: torch.Tensor):
        """Order-consistent codes of the stored rows (ascending, as the
        rows are sorted unique) and of ``q``."""
        return factorize_rows(self.rows(pred), q)

    def member_mask(self, pred: str, q: torch.Tensor) -> torch.Tensor:
        """Which rows of ``q`` are present."""
        rows = self.rows(pred)
        if q.shape[0] == 0 or rows.shape[0] == 0 or rows.shape[1] != q.shape[1]:
            return torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
        codes_r, codes_q = self._codes(pred, q)
        return sorted_member(codes_q, codes_r)

    def positions(self, pred: str, q: torch.Tensor) -> torch.Tensor:
        """Index of each row of ``q`` in the stored rows (int64).  Every
        row of ``q`` must be present (probe with :meth:`member_mask`
        first)."""
        if q.shape[0] == 0:
            return torch.zeros(0, dtype=_I64, device=self.device)
        codes_r, codes_q = self._codes(pred, q)
        lo, _ = join_bounds(codes_q.contiguous(), codes_r.contiguous())
        return lo.to(_I64)

    def add(self, pred: str, q: torch.Tensor) -> torch.Tensor:
        """Insert rows (unique and absent).  Returns the sort permutation
        of ``cat(old_rows, q)`` so aligned columns can be permuted
        identically: ``q``'s rows are placed by their codes' ranks among
        the stored rows (``join_bounds``), no full sort."""
        q = q.to(device=self.device, dtype=_I64)
        old = self._rows.get(pred)
        if old is None or old.shape[0] == 0:
            if q.shape[0] == 0:
                self._rows[pred] = q
                return torch.zeros(0, dtype=_I64, device=self.device)
            (codes_q,) = factorize_rows(q)
            perm = torch.sort(codes_q).indices
            self._rows[pred] = q[perm]
            return perm
        n_old, n_q = old.shape[0], q.shape[0]
        codes_old, codes_q = factorize_rows(old, q)
        q_sorted, q_order = torch.sort(codes_q)
        lo, _ = join_bounds(q_sorted.contiguous(), codes_old.contiguous())
        dest = lo.to(_I64) + torch.arange(n_q, dtype=_I64, device=self.device)
        perm = torch.empty(n_old + n_q, dtype=_I64, device=self.device)
        taken = torch.zeros(n_old + n_q, dtype=torch.bool, device=self.device)
        taken[dest] = True
        perm[dest] = n_old + q_order
        perm[~taken] = torch.arange(n_old, dtype=_I64, device=self.device)
        self._rows[pred] = torch.cat([old, q])[perm]
        return perm

    def remove(self, pred: str, q: torch.Tensor) -> torch.Tensor:
        """Remove rows.  Returns the keep mask over the previous stored
        rows so aligned columns can be masked identically."""
        rows = self.rows(pred)
        if rows.shape[0] == 0 or q.shape[0] == 0:
            keep = torch.ones(rows.shape[0], dtype=torch.bool, device=self.device)
        else:
            codes_r, codes_q = self._codes(pred, q)
            keep = ~sorted_member(codes_r, torch.sort(codes_q).values)
        self._rows[pred] = rows[keep]
        return keep

    def to_dict(self) -> dict[str, torch.Tensor]:
        return {p: r.clone() for p, r in self._rows.items() if r.shape[0]}

    def views(self) -> dict[str, torch.Tensor]:
        """The non-empty stored rows without a copy: the index replaces a
        predicate's tensor on every mutation and never writes into it, so
        a holder of these sees the rows as of this call."""
        return {p: r for p, r in self._rows.items() if r.shape[0]}

    # ------------------------------------------------------------------ #
    def nbytes(self) -> int:
        return sum(int(r.numel() * r.element_size()) for r in self._rows.values())

    def memory_report(self) -> dict[str, int]:
        """Owned rows vs rows that view a larger block, counted once."""
        owned, backed = split_owned_backed(self._rows.values())
        return {
            "rows_bytes": owned,
            "rows_snapshot_backed_bytes": backed,
            "n_predicates": len(self._rows),
        }
