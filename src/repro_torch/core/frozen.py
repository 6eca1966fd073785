"""Sorted row snapshots (the ``SortedRows`` core of a frozen fact store).

:class:`SortedRows` holds sorted, duplicate-free ``(n, arity)`` rows plus
lazy per-column sort orders with binary-searched equality slices.  The
engine keeps one per predicate for constant-bound scans of the ``old``
partition (see ``CMatEngine``).  The slices are located with the
``join_bounds`` kernel.  ``FrozenFacts``, the query-time view, belongs to
the query slice of the port.
"""

from __future__ import annotations

import torch

from ..kernels import join_bounds
from ..obs.memory import tensor_nbytes

__all__ = ["SortedRows"]


class SortedRows:
    """Sorted, duplicate-free ``(n, arity)`` rows + lazy per-column sort
    orders for binary-searched equality slices."""

    def __init__(self, rows: torch.Tensor):
        self.rows = rows
        self._col_order: dict[int, torch.Tensor] = {}
        self._sorted_col: dict[int, torch.Tensor] = {}

    @property
    def nbytes(self) -> int:
        """Resident bytes: rows plus any lazily built per-column orders."""
        total = tensor_nbytes(self.rows)
        total += sum(tensor_nbytes(a) for a in self._col_order.values())
        total += sum(tensor_nbytes(a) for a in self._sorted_col.values())
        return total

    def col_order(self, pos: int) -> torch.Tensor:
        """Stable argsort of the rows on column ``pos``."""
        order = self._col_order.get(pos)
        if order is None:
            order = torch.sort(self.rows[:, pos], stable=True).indices
            self._col_order[pos] = order
        return order

    def sorted_col(self, pos: int) -> torch.Tensor:
        col = self._sorted_col.get(pos)
        if col is None:
            col = self.rows[:, pos][self.col_order(pos)].contiguous()
            self._sorted_col[pos] = col
        return col

    def _span(self, pos: int, value: int) -> tuple[int, int]:
        col = self.sorted_col(pos)
        key = torch.full((1,), value, dtype=col.dtype, device=col.device)
        lo, hi = join_bounds(key, col)
        lo, hi = torch.cat([lo, hi]).tolist()
        return lo, hi

    def count_eq(self, pos: int, value: int) -> int:
        """Exact number of rows with ``col[pos] == value``."""
        lo, hi = self._span(pos, value)
        return hi - lo

    def eq_slice(self, pos: int, value: int) -> torch.Tensor:
        """Rows with ``col[pos] == value`` — one binary search + a gather."""
        lo, hi = self._span(pos, value)
        return self.rows[self.col_order(pos)[lo:hi]]

    def match_atom(self, atom) -> torch.Tensor:
        """Rows matching an atom's constants / repeated variables,
        anchored on the most selective constant; residual constraints
        filter the candidate slice only."""
        const_pos = [
            (pos, t) for pos, t in enumerate(atom.terms) if isinstance(t, int)
        ]
        if const_pos:
            best_pos, best_val = min(
                const_pos, key=lambda pt: self.count_eq(pt[0], pt[1])
            )
            rows = self.eq_slice(best_pos, best_val)
        else:
            best_pos = -1
            rows = self.rows
        mask = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
        for pos, value in const_pos:
            if pos != best_pos:
                mask &= rows[:, pos] == value
        vars_ = atom.variables()
        first_pos = {v: atom.terms.index(v) for v in vars_}
        for pos, t in enumerate(atom.terms):
            if isinstance(t, str) and pos != first_pos[t]:
                mask &= rows[:, pos] == rows[:, first_pos[t]]
        return rows[mask]
