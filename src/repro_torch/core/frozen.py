"""Frozen post-materialisation snapshot of a :class:`FactStore`.

Materialisation is a preprocessing step so that queries can later be
answered by lookup.  :class:`FrozenFacts` is the read side of that
contract, served to the :mod:`repro_torch.query` package: once the
fixpoint is reached the store is frozen and

* the meta-facts and the mu-mapping below the freeze mark are never
  redefined again (query-time splits always copy, ``inplace=False``),
* per-predicate **sorted dedup snapshots** are built lazily and cached
  (each column unfolds through the ``rle_expand`` kernel), so repeated
  queries never re-unpack the same columns,
* cheap selectivity statistics (fact counts, RLE-run distinct estimates,
  exact constant frequencies once a snapshot exists) feed the query
  planner without forcing any unfolding.

Everything a query allocates lives above :meth:`ColumnStore.mark` and is
reclaimed with :meth:`ColumnStore.release` after the answers are
extracted, so the store does not grow across a query stream.

:class:`SortedRows` is the reusable core of a snapshot: sorted unique
rows plus lazy per-column sort orders whose equality slices are located
with the ``join_bounds`` kernel.  Besides backing :class:`FrozenFacts`
the engine keeps one per predicate for constant-bound scans of the
``old`` partition (see ``CMatEngine``).
"""

from __future__ import annotations

import torch

from ..kernels import join_bounds
from ..obs.memory import register_reporter, split_owned_backed, tensor_is_backed, tensor_nbytes
from .metafacts import FactStore
from .util import unique_rows

__all__ = ["FrozenFacts", "SortedRows"]

_I64 = torch.int64


class SortedRows:
    """Sorted, duplicate-free ``(n, arity)`` rows + lazy per-column sort
    orders for binary-searched equality slices."""

    def __init__(self, rows: torch.Tensor):
        self.rows = rows
        self._col_order: dict[int, torch.Tensor] = {}
        self._sorted_col: dict[int, torch.Tensor] = {}

    @property
    def n_rows(self) -> int:
        return int(self.rows.shape[0])

    @property
    def nbytes(self) -> int:
        """Resident bytes: rows plus any lazily built per-column orders."""
        total = tensor_nbytes(self.rows)
        total += sum(tensor_nbytes(a) for a in self._col_order.values())
        total += sum(tensor_nbytes(a) for a in self._sorted_col.values())
        return total

    @property
    def snapshot_backed(self) -> bool:
        """True when ``rows`` views a larger block (seeded rows cut from
        one buffer) rather than owning its storage; such bytes are
        reported apart, so a block is counted once."""
        return tensor_is_backed(self.rows)

    def memory_report(self) -> dict[str, int]:
        """obs.memory reporter: ``sum(parts) == self.nbytes``.  Lazily
        built orders are always owned; only ``rows`` can be backed."""
        owned, backed = split_owned_backed((self.rows,))
        lazy = sum(tensor_nbytes(a) for a in self._col_order.values())
        lazy += sum(tensor_nbytes(a) for a in self._sorted_col.values())
        return {
            "rows_bytes": owned,
            "rows_snapshot_backed_bytes": backed,
            "lazy_order_bytes": lazy,
        }

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


class FrozenFacts:
    """Read-only view over a materialised fact store + lazy flat indexes,
    on the store's device."""

    def __init__(
        self,
        facts: FactStore,
        seed_rows: dict[str, torch.Tensor] | None = None,
        *,
        pin_meta: bool = False,
    ):
        self.facts = facts
        self.store = facts.store
        self.freeze_mark = self.store.mark()
        self._sorted: dict[str, SortedRows] = {}
        self._n_rows: dict[str, int] = {}
        # pinning: capture the per-predicate meta-fact lists now, so later
        # ``facts`` edits (incremental applies) do not leak post-freeze
        # facts into this snapshot
        self._pinned_mfs: dict[str, list] | None = (
            {p: list(facts.all(p)) for p in facts.predicates()}
            if pin_meta
            else None
        )
        #: cells unfolded while *building* snapshots (a one-time warm-up
        #: cost, reported apart from per-query work)
        self.snapshot_cells = 0
        register_reporter("frozen", self)
        if seed_rows:
            # pre-built sorted unique rows: freezing then costs nothing
            for pred, rows in seed_rows.items():
                self._sorted[pred] = SortedRows(rows)

    # ------------------------------------------------------------------ #
    # compressed access
    # ------------------------------------------------------------------ #
    @property
    def pinned(self) -> bool:
        """True when the meta-fact lists were captured at freeze time."""
        return self._pinned_mfs is not None

    def predicates(self):
        if self._pinned_mfs is not None:
            return list(self._pinned_mfs)
        return self.facts.predicates()

    def meta_facts(self, pred: str):
        if self._pinned_mfs is not None:
            return self._pinned_mfs.get(pred, [])
        return self.facts.all(pred)

    def arity(self, pred: str) -> int:
        mfs = self.meta_facts(pred)
        return mfs[0].arity if mfs else 0

    def n_rows(self, pred: str) -> int:
        """Represented fact count (with multiplicity), host only."""
        cached = self._n_rows.get(pred)
        if cached is None:
            cached = sum(mf.length for mf in self.meta_facts(pred))
            self._n_rows[pred] = cached
        return cached

    def approx_distinct(self, pred: str, pos: int) -> int:
        """Upper-bound distinct-value estimate for one argument position:
        the total RLE run count of that column, host only."""
        total = 0
        for mf in self.meta_facts(pred):
            total += self.store.n_runs(mf.columns[pos])
        return max(total, 1)

    # ------------------------------------------------------------------ #
    # sorted dedup snapshots (lazy, cached)
    # ------------------------------------------------------------------ #
    def sorted_rows(self, pred: str) -> SortedRows:
        """The predicate's snapshot: its meta-facts unfolded and deduped
        into lexicographically sorted unique rows (``(0, 1)`` when it has
        none)."""
        sr = self._sorted.get(pred)
        if sr is None:
            mfs = self.meta_facts(pred)
            if mfs:
                unfolded = torch.stack(
                    [
                        self.store.unfold_cat([mf.columns[j] for mf in mfs])
                        for j in range(mfs[0].arity)
                    ],
                    dim=1,
                )
            else:
                unfolded = torch.zeros((0, 1), dtype=_I64, device=self.store.device)
            self.snapshot_cells += int(unfolded.numel())
            sr = SortedRows(unique_rows(unfolded))
            self._sorted[pred] = sr
        return sr

    def snapshot(self, pred: str) -> torch.Tensor:
        """Sorted, duplicate-free ``(n, arity)`` rows of a predicate."""
        return self.sorted_rows(pred).rows

    def has_snapshot(self, pred: str) -> bool:
        return pred in self._sorted

    def snapshot_resident_bytes(self) -> int:
        """Bytes *owned* by the sorted snapshots built so far (rows that
        view a larger block are reported by
        :meth:`snapshot_backed_bytes`)."""
        return sum(
            sum(sr.memory_report()[k] for k in ("rows_bytes", "lazy_order_bytes"))
            for sr in self._sorted.values()
        )

    def snapshot_backed_bytes(self) -> int:
        """Bytes of snapshot rows that view a larger block."""
        return sum(
            sr.memory_report()["rows_snapshot_backed_bytes"]
            for sr in self._sorted.values()
        )

    def memory_report(self) -> dict[str, int]:
        """obs.memory reporter, aggregated over the built snapshots."""
        merged = {
            "snapshots_bytes": 0,
            "snapshots_snapshot_backed_bytes": 0,
            "n_snapshots": len(self._sorted),
        }
        for sr in self._sorted.values():
            parts = sr.memory_report()
            merged["snapshots_bytes"] += parts["rows_bytes"] + parts["lazy_order_bytes"]
            merged["snapshots_snapshot_backed_bytes"] += parts["rows_snapshot_backed_bytes"]
        return merged

    def col_order(self, pred: str, pos: int) -> torch.Tensor:
        """Stable argsort of the snapshot on column ``pos``."""
        return self.sorted_rows(pred).col_order(pos)

    def sorted_col(self, pred: str, pos: int) -> torch.Tensor:
        return self.sorted_rows(pred).sorted_col(pos)

    def count_eq(self, pred: str, pos: int, value: int) -> int:
        """Exact number of snapshot rows with ``col[pos] == value`` (one
        ``join_bounds`` launch and one host read)."""
        return self.sorted_rows(pred).count_eq(pos, value)

    def eq_slice(self, pred: str, pos: int, value: int) -> torch.Tensor:
        """Snapshot rows with ``col[pos] == value``: touches only the
        matching rows (one ``join_bounds`` launch + a gather)."""
        return self.sorted_rows(pred).eq_slice(pos, value)

    # ------------------------------------------------------------------ #
    def selectivity(self, pred: str, pos: int, value: int) -> float:
        """Estimated fraction of rows with ``col[pos] == value``: exact
        when a snapshot already exists, else the uniform 1/distinct
        estimate over RLE runs (never forces an unfold)."""
        n = self.n_rows(pred)
        if n == 0:
            return 0.0
        if self.has_snapshot(pred):
            return self.count_eq(pred, pos, value) / max(
                self.snapshot(pred).shape[0], 1
            )
        return 1.0 / self.approx_distinct(pred, pos)
